"""The ``ctrl`` message grammar of the device blocks.

From ``futuresdr_tpu/tpu/frames.py`` the port has only :func:`parse_ctrl`,
which ``TpuKernel``'s ``ctrl`` handler reads its retunes with. The
device-frame plane of that module (``TpuH2D``, ``TpuStage``,
``TpuMergeStage``, ``TpuD2H``) is ROADMAP Queue 1 item 5.
"""

from __future__ import annotations

import numpy as np

from ..types import Pmt

__all__ = ["parse_ctrl"]


def parse_ctrl(p: Pmt):
    """``{"stage": <name-or-index>, <param>: <value>, …}`` → ``(stage, params)``.

    Raises on malformed input (the caller answers ``Pmt.invalid_value()``).
    ``Pmt.map`` wraps list elements as Pmt (VecPmt); they are unwrapped here."""
    d = dict(p.to_map())
    stage = d.pop("stage").value
    if not isinstance(stage, str):
        stage = int(stage)
    params = {}
    for k, v in d.items():
        val = v.value
        if isinstance(val, (list, tuple)):
            val = [e.value if isinstance(e, Pmt) else e for e in val]
            params[k] = np.asarray(val)
        elif isinstance(val, np.ndarray):
            params[k] = val
        elif isinstance(val, (float, np.floating)):
            params[k] = float(val)        # genuine numerics normalize to float
        else:
            params[k] = val               # ints/bools/strs pass through untouched
    return stage, params
