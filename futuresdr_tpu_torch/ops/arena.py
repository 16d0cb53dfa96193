"""Host staging arena: a size-classed pool of recycled pinned host buffers.

The port's own copy of ``futuresdr_tpu/ops/arena.py`` (``StagingArena``,
``ArenaBuffer``). A streamed frame crosses the host twice: into a pinned
buffer for its H2D, and out of a pinned buffer after its D2H. Allocating
those buffers anew every frame costs the drain loop a pinned allocation per
transfer; the arena hands back warm, already-pinned buffers after the first
lap of the in-flight window.

Ownership is explicit: every holder keeps a reference (:meth:`ArenaBuffer.retain`
/ :meth:`ArenaBuffer.release`), and a buffer goes back to its size class's
free list at refcount zero. A transfer that reads or writes the buffer
records its CUDA event on it (:meth:`ArenaBuffer.record`); a pooled buffer
is handed out again only once that event has completed, so a release right
after an H2D is started never lets the next frame overwrite bytes the copy
engine has not read yet.

Size classes are powers of two (4 KiB at least), so a frame-size change does
not fragment the pool; the pool is bounded (``host_arena_mb``): past the cap
a released buffer is dropped to the allocator instead of pooled.
:meth:`StagingArena.stats` keeps plain counters, and the always-on
Prometheus families ``fsdr_arena_hits_total``, ``fsdr_arena_misses_total``,
``fsdr_arena_pinned_bytes`` and ``fsdr_arena_pooled_bytes`` mirror them.

:class:`GroupAlloc` and :class:`PackedAlloc` hand a wire encode its output
buffers out of the arena (``Wire.encode_into``), the latter as views into one
packed transfer buffer (the coalesced uplink, ``ops/xfer.PackedLayout``).

Config: ``host_arena`` (default on; ``FUTURESDR_TPU_HOST_ARENA=0`` gives a
fresh buffer per transfer), ``host_arena_mb`` (the byte cap). There is one
pinned arena for the card and one plain one for the CPU (:func:`arena`).
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..telemetry import prom as _prom

from ..config import config

__all__ = ["ArenaBuffer", "StagingArena", "arena", "reset_arena", "arena_stats",
           "GroupAlloc", "PackedAlloc"]

_MIN_CLASS = 12                       # 4 KiB floor: below it pooling is noise


def _shape(shape) -> tuple:
    return (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(shape)


def _class_of(nbytes: int) -> int:
    """Size-class exponent: smallest power of two ≥ nbytes (≥ 4 KiB)."""
    return max(_MIN_CLASS, int(nbytes - 1).bit_length()) if nbytes > 1 \
        else _MIN_CLASS



# the arena's families (always on: a take, not a sample)
_HITS = _prom.counter(
    "fsdr_arena_hits_total", "arena takes served from a recycled buffer")
_MISSES = _prom.counter(
    "fsdr_arena_misses_total", "arena takes that allocated a fresh buffer")
_PINNED = _prom.gauge(
    "fsdr_arena_pinned_bytes", "bytes of arena buffers currently checked out")
_POOLED = _prom.gauge(
    "fsdr_arena_pooled_bytes", "bytes of arena buffers idle in the pool")

class ArenaBuffer:
    """One pooled buffer: a flat uint8 host tensor (pinned when its arena
    pins) with a numpy view, an explicit refcount and the CUDA event of the
    last copy that touched it.

    Created at refcount 1 (the taker owns that reference). Other holders
    call :meth:`retain` and balance it with :meth:`release`; the buffer
    returns to its arena's free list only when the count reaches zero.
    ``release`` past zero is a no-op: a double release must never recycle a
    buffer some other holder still uses."""

    __slots__ = ("tensor", "base", "_arena", "_cls", "_rc", "_lock", "_event")

    def __init__(self, arena: "StagingArena", cls: int):
        self.tensor = torch.empty(1 << cls, dtype=torch.uint8, pin_memory=arena.pin)
        self.base = self.tensor.numpy()
        self._arena = arena
        self._cls = cls
        self._rc = 1
        self._lock = threading.Lock()
        self._event = None

    @property
    def nbytes(self) -> int:
        return self.base.nbytes

    def array(self, shape, dtype) -> np.ndarray:
        """A leading view of the buffer as ``shape``/``dtype`` (must fit)."""
        dt = np.dtype(dtype)
        shape = _shape(shape)
        n = math.prod(shape) * dt.itemsize
        if n > self.base.nbytes:
            raise ValueError(f"{shape} {dt} ({n} B) does not fit a {self.base.nbytes} B buffer")
        return self.base[:n].view(dt).reshape(shape)

    def record(self, event) -> None:
        """The CUDA event of the latest copy that reads or writes the buffer:
        the buffer is not handed out again before it has completed."""
        self._event = event

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def retain(self) -> "ArenaBuffer":
        with self._lock:
            if self._rc <= 0:
                raise RuntimeError("retain() of an already-recycled buffer")
            self._rc += 1
        return self

    def release(self) -> None:
        with self._lock:
            if self._rc <= 0:
                return
            self._rc -= 1
            if self._rc:
                return
        self._arena._recycle(self)


class StagingArena:
    """The pool: per-size-class free lists, bounded by ``max_bytes``.
    ``pin``: pinned host memory (needs CUDA); the CPU tests pass ``False``."""

    def __init__(self, max_bytes: int = 256 << 20, pin: bool = True):
        self.max_bytes = int(max_bytes)
        self.pin = bool(pin)
        self._free: Dict[int, List[ArenaBuffer]] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.pinned_bytes = 0         # checked out
        self.peak_pinned_bytes = 0    # the most ever checked out at once
        self.pooled_bytes = 0         # idle in the pool

    def take(self, nbytes: int) -> ArenaBuffer:
        """Check out a buffer of capacity ≥ nbytes (refcount 1): a pooled one
        whose last copy has completed, else a fresh one."""
        cls = _class_of(int(nbytes))
        buf = None
        hit = False
        with self._lock:
            lst = self._free.get(cls)
            for i in range(len(lst) if lst else 0):
                if lst[i].ready():
                    buf = lst.pop(i)
                    self.pooled_bytes -= buf.nbytes
                    self.hits += 1
                    hit = True
                    break
            else:
                self.misses += 1
        if buf is None:
            buf = ArenaBuffer(self, cls)
        else:
            buf._rc = 1
            buf._event = None
        with self._lock:
            self.pinned_bytes += buf.nbytes
            self.peak_pinned_bytes = max(self.peak_pinned_bytes, self.pinned_bytes)
            pinned, pooled = self.pinned_bytes, self.pooled_bytes
        (_HITS if hit else _MISSES).inc()
        _PINNED.set(pinned)
        _POOLED.set(pooled)
        return buf

    def take_array(self, shape, dtype) -> Tuple[np.ndarray, ArenaBuffer]:
        """``(array view, owning buffer)`` for a fresh-content buffer."""
        dt = np.dtype(dtype)
        shape = _shape(shape)
        buf = self.take(math.prod(shape) * dt.itemsize)
        return buf.array(shape, dt), buf

    def copy_in(self, a: np.ndarray) -> Tuple[np.ndarray, ArenaBuffer]:
        """Copy ``a`` into an arena buffer: ``(its view, the buffer)``."""
        v, buf = self.take_array(a.shape, a.dtype)
        np.copyto(v, a)
        return v, buf

    def _recycle(self, buf: ArenaBuffer) -> None:
        with self._lock:
            self.pinned_bytes -= buf.nbytes
            if self.pooled_bytes + buf.nbytes <= self.max_bytes:
                self._free.setdefault(buf._cls, []).append(buf)
                self.pooled_bytes += buf.nbytes
            # else: past the cap, dropped to the allocator
            pinned, pooled = self.pinned_bytes, self.pooled_bytes
        _PINNED.set(pinned)
        _POOLED.set(pooled)

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "pinned_bytes": self.pinned_bytes,
                    "peak_pinned_bytes": self.peak_pinned_bytes,
                    "pooled_bytes": self.pooled_bytes,
                    "classes": {1 << c: len(l) for c, l in sorted(self._free.items()) if l}}


_arenas: Dict[bool, StagingArena] = {}
_arena_lock = threading.Lock()


def arena(pin: bool = True) -> Optional[StagingArena]:
    """The process-global arena, pinned (for a card) or plain (``pin=False``,
    for the CPU), or None when ``host_arena`` is off (callers then allocate
    a buffer per transfer)."""
    with _arena_lock:
        got = _arenas.get(bool(pin))
        if got is None and config().host_arena:
            got = _arenas[bool(pin)] = StagingArena(int(config().host_arena_mb) << 20,
                                                    pin=pin)
        return got


def reset_arena() -> None:
    """Drop the process arenas (tests, config re-reads); the next
    :func:`arena` call reads the config again."""
    with _arena_lock:
        _arenas.clear()


def arena_stats() -> Optional[dict]:
    """The pinned arena's :meth:`StagingArena.stats` (None when it was never
    used)."""
    a = _arenas.get(True)
    return a.stats() if a is not None else None


class GroupAlloc:
    """A dispatch group's allocator for ``Wire.encode_into``: records every
    buffer it hands out (:attr:`handles`, which the caller owns and
    releases), and ``temp()`` buffers, scratch the encode drops with
    :meth:`drop_temps` before it returns."""

    __slots__ = ("arena", "handles", "_temps")

    def __init__(self, arena: StagingArena):
        self.arena = arena
        self.handles: List[ArenaBuffer] = []
        self._temps: List[ArenaBuffer] = []

    def __call__(self, shape, dtype) -> np.ndarray:
        v, buf = self.arena.take_array(shape, dtype)
        self.handles.append(buf)
        return v

    def temp(self, shape, dtype) -> np.ndarray:
        v, buf = self.arena.take_array(shape, dtype)
        self._temps.append(buf)
        return v

    def drop_temps(self) -> None:
        for b in self._temps:
            b.release()
        self._temps.clear()

    def temps_only(self) -> "_TempsOnly":
        """An allocator whose every buffer is a temp of this one: for
        intermediates (a frame's encode before it is stacked) that must not
        outlive the group's encode."""
        return _TempsOnly(self)

    def release(self) -> None:
        """Release every buffer handed out (and any temp left)."""
        self.drop_temps()
        for b in self.handles:
            b.release()
        self.handles.clear()


class _TempsOnly:
    """See :meth:`GroupAlloc.temps_only`: everything is scratch, owned and
    dropped by the parent."""

    __slots__ = ("_parent",)

    def __init__(self, parent: GroupAlloc):
        self._parent = parent

    def __call__(self, shape, dtype) -> np.ndarray:
        return self._parent.temp(shape, dtype)

    def temp(self, shape, dtype) -> np.ndarray:
        return self._parent.temp(shape, dtype)

    def drop_temps(self) -> None:
        pass                                # the parent owns the temps


class PackedAlloc(GroupAlloc):
    """A :class:`GroupAlloc` whose payloads are views into one packed
    transfer buffer (``ops/xfer.PackedLayout``): ``__call__`` hands out the
    next unfilled layout slot of the requested shape and dtype, so a
    quantizing encode writes its payload at its packed offset and coalescing
    costs no payload copy. A request no slot matches falls back to a plain
    take; :meth:`finish` (``PackedLayout.pack``) copies such parts, and bare
    ones like the scale, into their slots. ``handles[0]`` holds the packed
    buffer."""

    __slots__ = ("layout", "packed", "_filled")

    def __init__(self, arena: StagingArena, layout):
        super().__init__(arena)
        self.layout = layout
        self.packed, buf = arena.take_array((layout.nbytes,), np.uint8)
        self.handles.append(buf)
        self._filled = [False] * len(layout.slots)

    def __call__(self, shape, dtype) -> np.ndarray:
        sh = _shape(shape)
        dt = np.dtype(dtype)
        for i, (ssh, sdt, off, nb) in enumerate(self.layout.slots):
            if not self._filled[i] and ssh == sh and sdt == dt:
                self._filled[i] = True
                return self.packed[off:off + nb].view(dt).reshape(sh)
        return super().__call__(shape, dtype)

    def finish(self, parts) -> np.ndarray:
        """Settle the packed buffer for shipping: copy in every part not
        written through a slot view, zero the alignment gaps, and return the
        packed uint8 array (backed by ``handles[0]``)."""
        return self.layout.pack(parts, self.packed)
