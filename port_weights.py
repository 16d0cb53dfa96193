#!/usr/bin/env python3
"""Convert the JAX package's pretrained MCLDNN weights into the port's.

Loads ``futuresdr_tpu/models/weights/mcldnn_v1`` (an orbax checkpoint) through
``futuresdr_tpu.models.modrec.load_pretrained`` on the CPU, maps the flax tree
onto the port's ``MCLDNN`` state dict (``futuresdr_tpu_torch.convert.
mcldnn_from_flax``) and writes it as ``futuresdr_tpu_torch/models/weights/
mcldnn_v1.npz`` (float32 arrays keyed by state-dict name), with a copy of
``mcldnn_v1.json``. The port reads only those two files. Run it again whenever
the reference's checkpoint, the port's ``MCLDNN`` or the conversion changes
(``tests/test_torch_mcldnn.py`` fails until then):

    python3 port_weights.py

This tool imports JAX and the JAX package on the CPU; the port never does.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

import numpy as np

NAME = "mcldnn_v1"
REPO = Path(__file__).resolve().parent
SRC_DIR = REPO / "futuresdr_tpu" / "models" / "weights"
DST_DIR = REPO / "futuresdr_tpu_torch" / "models" / "weights"


def main() -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from futuresdr_tpu.models.modrec import load_pretrained
    from futuresdr_tpu_torch.convert import mcldnn_from_flax

    _, params = load_pretrained(NAME)
    state = {k: v.numpy() for k, v in
             mcldnn_from_flax(jax.tree_util.tree_map(np.asarray, params)).items()}
    DST_DIR.mkdir(parents=True, exist_ok=True)
    dst = DST_DIR / f"{NAME}.npz"
    np.savez(dst, **state)
    shutil.copyfile(SRC_DIR / f"{NAME}.json", DST_DIR / f"{NAME}.json")
    n = sum(v.size for v in state.values())
    print(f"wrote {dst.relative_to(REPO)}: {len(state)} arrays, {n} float32 values")
    return 0


if __name__ == "__main__":
    sys.exit(main())
