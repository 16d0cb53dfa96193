"""Checkpoint and resume: trees of tensors and arrays, and block state.

The counterpart of ``futuresdr_tpu/utils/checkpoint.py``, built on the port's
carry snapshots on disk (``utils/snapshot.py``: an ``.npz`` written by atomic
rename, a crc32 over every leaf and the metadata). :func:`save_pytree` writes
nested dicts, lists and tuples of tensors, numpy arrays and scalars (a model's
``state_dict()`` and an optimizer's among them); :func:`load_pytree` reads them
back, bit for bit, each tensor on the device of its counterpart in ``like``
(else on the CPU). The tree's structure rides as JSON in the file's metadata,
never as a pickle: a checkpoint cannot run code on restore.
:func:`save_flowgraph_state` and :func:`load_flowgraph_state` snapshot every
block that has ``state_dict()``/``load_state_dict()``.
"""

from __future__ import annotations

import base64
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..log import logger
from .snapshot import read_snapshot, write_snapshot

__all__ = ["save_pytree", "load_pytree", "save_flowgraph_state", "load_flowgraph_state"]

log = logger("checkpoint")


def _flatten(obj: Any, path: str, arrays: List[np.ndarray]) -> Any:
    """``obj`` as a JSON-able spec; arrays and tensors go to ``arrays``."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, bytes):
        return {"__t__": "bytes", "v": base64.b64encode(obj).decode()}
    if isinstance(obj, complex):
        return {"__t__": "complex", "re": obj.real, "im": obj.imag}
    if isinstance(obj, np.generic):
        return _flatten(obj.item(), path, arrays)
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        bf16 = t.dtype == torch.bfloat16
        arrays.append((t.view(torch.int16) if bf16 else t).cpu().numpy().copy())
        return {"__t__": "tensor", "k": len(arrays) - 1, "bf16": bf16}
    if isinstance(obj, np.ndarray):
        if obj.dtype == object:
            raise TypeError(f"entry {path!r} is an object-dtype array; only numeric and "
                            f"bool dtypes are checkpointable")
        arrays.append(np.array(obj, copy=True))
        return {"__t__": "nd", "k": len(arrays) - 1}
    if isinstance(obj, (list, tuple)):
        items = [_flatten(v, f"{path}[{i}]", arrays) for i, v in enumerate(obj)]
        return {"__t__": "tuple" if isinstance(obj, tuple) else "list", "v": items}
    if isinstance(obj, dict):
        return {"__t__": "dict",
                "v": [[_flatten(k, path, arrays), _flatten(v, f"{path}.{k}", arrays)]
                      for k, v in obj.items()]}
    raise TypeError(f"entry {path!r} has unserializable type {type(obj).__name__}; "
                    f"use scalars, arrays, tensors and containers")


def _unflatten(spec: Any, arrays, like: Any = None) -> Any:
    if not isinstance(spec, dict):
        return spec
    t = spec["__t__"]
    if t == "bytes":
        return base64.b64decode(spec["v"])
    if t == "complex":
        return complex(spec["re"], spec["im"])
    if t == "nd":
        return np.asarray(arrays[spec["k"]])
    if t == "tensor":
        v = torch.from_numpy(np.array(arrays[spec["k"]], copy=True))
        if spec.get("bf16"):
            v = v.view(torch.bfloat16)
        return v.to(like.device) if isinstance(like, torch.Tensor) else v
    if t in ("list", "tuple"):
        likes = like if isinstance(like, (list, tuple)) and len(like) == len(spec["v"]) \
            else [None] * len(spec["v"])
        out = [_unflatten(v, arrays, lk) for v, lk in zip(spec["v"], likes)]
        return tuple(out) if t == "tuple" else out
    if t == "dict":
        out = {}
        for k, v in spec["v"]:
            key = _unflatten(k, arrays)
            lk = like.get(key) if isinstance(like, dict) else None
            out[key] = _unflatten(v, arrays, lk)
        return out
    raise ValueError(f"unknown spec tag {t!r}")


def save_pytree(path: str, tree: Any) -> None:
    """Write ``tree`` to the file ``path`` (an ``.npz``). Raises when the
    write fails."""
    arrays: List[np.ndarray] = []
    spec = _flatten(tree, "$", arrays)
    path = os.path.abspath(path)
    if not write_snapshot(path, 0, arrays, meta={"tree": spec}):
        raise OSError(f"checkpoint write to {path} failed")


def load_pytree(path: str, like: Optional[Any] = None) -> Any:
    """The tree saved at ``path``: tensors come back as tensors (on the
    device of the same entry of ``like``, else the CPU), arrays as numpy
    arrays. Raises when the file is absent or fails its integrity check."""
    got = read_snapshot(os.path.abspath(path))
    if got is None or not got[2] or "tree" not in got[2]:
        raise FileNotFoundError(f"no valid checkpoint at {path}")
    _seq, leaves, meta = got
    return _unflatten(meta["tree"], leaves, like)


def save_flowgraph_state(fg, path: str) -> None:
    """Snapshot every block that has ``state_dict()``, by instance name."""
    states: Dict[str, Any] = {}
    for bid in range(len(fg)):
        try:
            blk = fg.wrapped(bid)
        except Exception:                     # noqa: BLE001 — a removed id
            continue
        if hasattr(blk.kernel, "state_dict"):
            states[blk.instance_name] = blk.kernel.state_dict()
    save_pytree(path, states)
    log.info("saved %d block states to %s", len(states), path)


def load_flowgraph_state(fg, path: str) -> int:
    """Give every block with ``load_state_dict()`` its saved state; returns
    how many blocks took one."""
    states = load_pytree(path)
    n = 0
    for bid in range(len(fg)):
        try:
            blk = fg.wrapped(bid)
        except Exception:                     # noqa: BLE001 — a removed id
            continue
        if blk.instance_name in states and hasattr(blk.kernel, "load_state_dict"):
            blk.kernel.load_state_dict(states[blk.instance_name])
            n += 1
    return n
