"""futuresdr_tpu_torch — the PyTorch/CUDA port of futuresdr_tpu.

The JAX package ``futuresdr_tpu`` is the reference; this package runs the
same streams on PyTorch tensors on a CUDA device, with the reference's TPU
kernels rewritten by hand for Hopper (``csrc/``). It imports nothing of JAX
or of the reference package. Module paths and public names follow the
reference (``ops/stages.py``, ``tpu/kernel_block.py``, ``Pipeline``,
``TpuKernel``, …).

Float32 routes stay float32: TF32 is switched off for matmuls and cuDNN
convolutions at import.
"""

import torch

from .config import config
from .log import logger
from .runtime import (AsyncScheduler, BlockPolicy, ConnectError, Flowgraph,
                      FlowgraphCancelled, FlowgraphError, ItemTag, Kernel, Mocker, Runtime,
                      Tag, ThreadedScheduler, TpbScheduler, WorkIo, message_handler)
from .types import Pmt

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

__all__ = ["config", "logger", "AsyncScheduler", "BlockPolicy", "ConnectError",
           "Flowgraph", "FlowgraphCancelled", "FlowgraphError", "ItemTag", "Kernel",
           "Mocker", "Tag", "ThreadedScheduler", "TpbScheduler", "WorkIo",
           "Pmt", "Runtime", "message_handler", "blocks", "convert", "dsp", "hw", "ops",
           "runtime", "tpu", "types"]
