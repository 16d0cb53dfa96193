"""Carry snapshots on disk: the port's copy of
``futuresdr_tpu/utils/snapshot.py``, reduced to what the kernels'
``checkpoint_dir`` persistence uses (``tpu/kernel_block.py``).

* **atomic rename**: a reader sees the old or the new snapshot, never a
  torn one (``os.replace`` of a temp file named by the process id);
* **crc32 integrity**: a crc32 over every leaf's bytes (and the metadata)
  is stored beside them and checked on load; a corrupted file reads as
  absent;
* **signature-keyed file names**: :func:`snapshot_signature` hashes the
  owner's name with the pipeline's stage names and input dtype, so a reused
  name over another pipeline maps to another file;
* **one serialized writer**: :func:`persist_executor` is the process's one
  worker thread for every snapshot write and purge, so writes land newest
  last and a purge queued after a write wins.

The file is numpy's ``.npz``: the leaves as ``leaf0``, ``leaf1``, … (host
arrays, complex64 included), ``_seq``, ``_n``, ``_crc`` and an optional JSON
``_meta``, so a snapshot does not depend on the torch version. Writes are
best effort: a failed write only narrows the restore window.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..log import logger

__all__ = ["snapshot_signature", "sanitize_name", "snapshot_crc", "write_snapshot",
           "read_snapshot", "persist_executor"]

log = logger("utils.snapshot")

_persist_pool = None
_persist_pool_lock = threading.Lock()


def persist_executor():
    """The process's one-worker executor for snapshot writes and purges
    (first in, first out), off the caller's dispatch and drain thread."""
    global _persist_pool
    if _persist_pool is None:
        with _persist_pool_lock:
            if _persist_pool is None:
                from concurrent.futures import ThreadPoolExecutor
                _persist_pool = ThreadPoolExecutor(max_workers=1,
                                                   thread_name_prefix="fsdr-persist")
    return _persist_pool


def sanitize_name(name: str) -> str:
    """``name`` with every character a file name may not safely hold
    replaced by ``_``."""
    return "".join(c if c.isalnum() or c in "-_." else "_" for c in str(name))


def snapshot_signature(pipeline, name: str) -> str:
    """Ten hex characters keying ``name`` with the pipeline's stage names and
    input dtype (a fan-out or DAG pipeline without ``stages`` by its type)."""
    stages = getattr(pipeline, "stages", ())
    sig = "|".join(str(getattr(s, "name", "?")) for s in stages) or type(pipeline).__name__
    return hashlib.sha1(
        f"{name}|{sig}|{np.dtype(pipeline.in_dtype)}".encode()).hexdigest()[:10]


def snapshot_crc(leaves) -> int:
    crc = 0
    for leaf in leaves:
        crc = zlib.crc32(np.ascontiguousarray(np.asarray(leaf)).tobytes(), crc)
    return crc & 0xFFFFFFFF


def write_snapshot(path: str, seq: int, leaves,
                   meta: Optional[Dict[str, Any]] = None) -> bool:
    """Write one snapshot to ``path`` (atomic rename, crc32-stamped, with an
    optional JSON ``meta``); False, logged, on any failure."""
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        lv = [np.asarray(leaf) for leaf in leaves]
        arrs = {f"leaf{i}": a for i, a in enumerate(lv)}
        crc_over = list(lv)
        if meta:
            arrs["_meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8).copy()
            crc_over.append(arrs["_meta"])
        with open(tmp, "wb") as f:
            np.savez(f, _seq=np.int64(seq), _n=np.int64(len(lv)),
                     _crc=np.uint32(snapshot_crc(crc_over)), **arrs)
        os.replace(tmp, path)
        return True
    except Exception as e:                             # noqa: BLE001 — best effort
        log.warning("snapshot persist %s @%d failed (%r)", path, seq, e)
        return False


def read_snapshot(path: str) -> Optional[Tuple[int, List[np.ndarray],
                                               Optional[Dict[str, Any]]]]:
    """``(seq, leaves, meta)`` of the snapshot at ``path``; None when it is
    absent, unreadable or fails its crc32 (logged)."""
    if not path or not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            n = int(z["_n"])
            seq = int(z["_seq"])
            crc = int(z["_crc"])
            leaves = [z[f"leaf{i}"] for i in range(n)]
            meta = None
            crc_over = list(leaves)
            if "_meta" in z.files:
                crc_over.append(z["_meta"])
                meta = json.loads(bytes(z["_meta"].tobytes()).decode())
        if crc != snapshot_crc(crc_over):
            log.warning("persisted snapshot %s failed its integrity check: ignored", path)
            return None
        return seq, leaves, meta
    except Exception as e:                             # noqa: BLE001 — a bad file
        log.warning("persisted snapshot %s unreadable (%r): ignored", path, e)
        return None
