"""The benchmark of the PyTorch and CUDA port (``futuresdr_tpu_torch``):
``python3 -m sdrbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>``.
See ``sdrbench/README.md``."""
