"""Zero-copy ingest: frames of externally owned buffers skip the ring-exit
copy.

The port's copy of ``futuresdr_tpu/ops/ingest.py``. A streamed kernel copies
each frame out of its input ring before ``consume()`` (the H2D reads it
later, and the writer reuses consumed space). When the frame's memory is
owned outside the flowgraph (a capture an offline source replays, a dlpack
import, a shared mapping), nobody overwrites it behind the transfer and the
copy buys nothing. This module is the ownership registry that makes
skipping it sound: the owner registers the buffer (:func:`register`), the
kernel looks each frame up (:func:`lookup`, by the numpy base chain) and, on
a hit, ships the frame from the registered memory, holding the buffer's
handle (``retain``/``release``, the arena's protocol) until the frame's
group has drained. The owner learns the buffer is free again from
:attr:`IngestBuffer.pinned` or an ``on_idle`` callback.

The fast path engages only where it is free and safe:

* the buffer is registered and read-only (``register`` clears the
  writeable flag; a writable frame never matches);
* the wire's host encode aliases its input (the f32 pairs view): a
  quantizing wire writes a fresh payload anyway (deferred consume covers
  it);
* on a card, the buffer is page-locked: ``register`` calls
  ``cudaHostRegister`` on it (``cudaHostUnregister`` once the registry and
  every frame have let it go), because a copy from pageable memory is not
  asynchronous; a buffer that cannot be page-locked takes the copying path.

Everything else takes the copying path, with the same bits.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..log import logger

__all__ = ["IngestBuffer", "register", "unregister", "lookup", "note_zero_copy",
           "reset", "stats", "from_dlpack", "zero_copy_frames"]

log = logger("ops.ingest")

_lock = threading.Lock()
_registry: Dict[int, "IngestBuffer"] = {}
#: frames staged zero-copy since the last :func:`reset`
zero_copy_frames = 0


class IngestBuffer:
    """The refcounted handle of one registered buffer. The registry holds
    one count; every staged frame adds one until its group drains. At the
    registry-only count the owner may reclaim the memory (``pinned`` is
    False, ``on_idle`` fires); at zero the page lock, if any, is undone."""

    __slots__ = ("root", "name", "on_idle", "page_locked", "_rc", "_lock")

    def __init__(self, root: np.ndarray, name: str = "",
                 on_idle: Optional[Callable[["IngestBuffer"], None]] = None):
        self.root = root
        self.name = name
        self.on_idle = on_idle
        self.page_locked = False
        self._rc = 1                      # the registry's reference
        self._lock = threading.Lock()

    def retain(self) -> "IngestBuffer":
        with self._lock:
            self._rc += 1
        return self

    def release(self) -> None:
        cb = None
        unlock = False
        with self._lock:
            if self._rc > 0:
                self._rc -= 1
                if self._rc == 1 and self.on_idle is not None:
                    cb = self.on_idle
                unlock = self._rc == 0 and self.page_locked
                if unlock:
                    self.page_locked = False
        if unlock:
            _unlock(self.root)
        if cb is not None:
            try:
                cb(self)
            except Exception as e:         # noqa: BLE001 — an observer only
                log.warning("ingest on_idle callback failed: %r", e)

    @property
    def pinned(self) -> bool:
        """True while a staged frame still holds the buffer (the owner must
        not reclaim or rewrite it)."""
        with self._lock:
            return self._rc > 1

    @property
    def refcount(self) -> int:
        with self._lock:
            return self._rc


def _root_of(a: np.ndarray) -> np.ndarray:
    """The owning array at the end of the numpy base chain."""
    while isinstance(getattr(a, "base", None), np.ndarray):
        a = a.base
    return a


def _lock_pages(root: np.ndarray) -> bool:
    """Page-lock ``root``'s memory for asynchronous copies (a card only)."""
    if not torch.cuda.is_available() or root.nbytes == 0:
        return False
    try:
        torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(
            root.ctypes.data, root.nbytes, 0))
        return True
    except Exception as e:                 # noqa: BLE001 — take the copy path
        log.warning("ingest: cudaHostRegister of %d B failed (%r); its frames "
                    "will be copied", root.nbytes, e)
        return False


def _unlock(root: np.ndarray) -> None:
    try:
        torch.cuda.check_error(torch.cuda.cudart().cudaHostUnregister(root.ctypes.data))
    except Exception as e:                 # noqa: BLE001 — teardown only
        log.warning("ingest: cudaHostUnregister failed: %r", e)


def register(arr: np.ndarray, name: str = "",
             on_idle: Optional[Callable[[IngestBuffer], None]] = None) -> IngestBuffer:
    """Register an externally owned buffer for zero-copy ingest: ``arr``,
    or any view of it, handed to a device kernel as a frame skips the
    ring-exit copy on aliasing wires. Clears the writeable flag on the root
    (nobody may write it while registered; a write now raises instead of
    corrupting a frame in flight) and, where CUDA is available, page-locks
    it. Registering the same root twice returns the first handle."""
    root = _root_of(np.asarray(arr))
    with _lock:
        got = _registry.get(id(root))
        if got is not None:
            return got
        try:
            root.setflags(write=False)
        except ValueError:
            pass          # a foreign-owned view (dlpack) may refuse
        h = IngestBuffer(root, name=name, on_idle=on_idle)
        h.page_locked = _lock_pages(root)
        _registry[id(root)] = h
        return h


def unregister(handle: IngestBuffer) -> None:
    """Drop the registry's reference. Frames staged already keep theirs:
    the buffer must stay valid until :attr:`IngestBuffer.pinned` is False."""
    with _lock:
        _registry.pop(id(handle.root), None)
    handle.release()


def lookup(frame: np.ndarray) -> Optional[IngestBuffer]:
    """The registered handle behind ``frame``, or None when the frame is
    not registered or is writable (then the ownership contract cannot
    hold, and the frame is copied)."""
    if not _registry or frame.flags.writeable:
        return None
    root = _root_of(frame)
    with _lock:
        return _registry.get(id(root))


def note_zero_copy(n: int = 1) -> None:
    """Count ``n`` frames staged through the zero-copy path."""
    global zero_copy_frames
    with _lock:
        zero_copy_frames += n


def from_dlpack(capsule_owner) -> np.ndarray:
    """Import another framework's host buffer through dlpack
    (``np.from_dlpack``) and register it; returns the registered,
    read-only numpy view."""
    arr = np.from_dlpack(capsule_owner)
    register(arr)
    return arr


def reset() -> None:
    """Drop every registration (tests)."""
    global zero_copy_frames
    with _lock:
        handles = list(_registry.values())
        _registry.clear()
        zero_copy_frames = 0
    for h in handles:
        h.release()


def stats() -> dict:
    with _lock:
        return {"registered": len(_registry),
                "pinned": sum(1 for h in _registry.values() if h.pinned),
                "zero_copy_frames": zero_copy_frames}
