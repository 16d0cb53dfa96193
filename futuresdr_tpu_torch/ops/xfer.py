"""Host ↔ device transfers.

The counterpart of ``futuresdr_tpu/ops/xfer.py``. On a CUDA device each
transfer goes through pinned host memory (the staging arena of
``ops/arena.py``, or a buffer page-locked by ``ops/ingest.py``) on a side copy
stream (one for H2D, one for D2H, per device) and is ordered against the
compute stream with a CUDA event, so frame t+1's H2D and frame t−1's D2H
overlap frame t's compute. The event is recorded on the arena buffer, which
the pool hands out again only once the copy has completed. complex64 moves
natively; the wire formats of ``ops/wire.py`` decide what crosses.

A transfer moves a tuple of **parts** (a wire's payload and scale, each with a
leading ``[K]`` axis for a megabatch group, or one packed uint8 buffer): one
copy a part, each a **start** (:data:`starts_total`). :class:`PackedLayout` is
the offset table that packs a group's parts into one buffer (the coalesced
uplink: one start a group), unpacked on the device by
:meth:`PackedLayout.unpack_torch` inside the program's graph.

:data:`bytes_total`, :data:`starts_total` and :data:`retries_total` count each
direction's (``"h2d"``, ``"d2h"``) bytes, copies started and retried
attempts, counted where a transfer starts, on every device, read as
``cuda_kernels.launches`` is (:func:`reset_bytes`, then run, then read). The
same counts also feed the always-on Prometheus families
``fsdr_xfer_bytes_total``, ``fsdr_xfer_transfers_total`` (one a transfer),
``fsdr_xfer_starts_total`` and ``fsdr_retries_total`` by direction, and each
transfer's dwell, from its start to its landing as the caller sees it, the
``fsdr_xfer_seconds`` histogram; with tracing on it is also an ``H2D`` or
``D2H`` span (``cat="tpu"``). The dwell is host time: the H2D's ends where
the caller orders its stream after the copy (no wait on the card), the
D2H's where the caller has waited on the copy's event, which it does in any
case before it reads the data.

Retries: a transfer's start runs inside :func:`_with_retry`. An error
:func:`classify_transfer_error` calls transient (an injected link fault, a
transient ``runtime/faults.py`` site, an error message naming a transient
cause) is retried with jittered exponential backoff (``xfer_backoff``) up to
``xfer_retries`` times within ``xfer_deadline`` seconds; anything else, and
CUDA's sticky errors above all, raises at once, and an exhausted budget
raises :class:`TransferError`. :func:`set_fake_link` models a rate-limited,
optionally faulty link for tests.

Staging rule (the reference's ``h2d_needs_staging``): a frame handed to a
transfer may be a view of a ring slot the producer overwrites as soon as it
is consumed, so it is first copied into memory of its own before the caller
may consume. On the CPU a host buffer is a plain array: no pinning and no
events, and every transfer copies.
"""

from __future__ import annotations

import math
import random as _random
import threading
import time
import warnings
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import config
from ..log import logger
from ..telemetry import prom as _prom
from ..telemetry.spans import recorder as _trace_recorder
from .arena import ArenaBuffer, arena

__all__ = ["HostBuffer", "host_buffer", "to_device", "to_host", "start_device_transfer",
           "start_device_transfer_parts", "start_host_transfer", "start_host_transfer_parts",
           "torch_dtype", "bytes_total", "starts_total", "retries_total", "reset_bytes",
           "TransferError", "FakeLinkFault", "classify_transfer_error", "set_fake_link",
           "fake_link", "PackedLayout"]

log = logger("ops.xfer")
_trace = _trace_recorder()

# the link plane's families (always on: updates a transfer, not a sample)
_XFER_BYTES = _prom.counter(
    "fsdr_xfer_bytes_total", "bytes started on the host-device link", ("direction",))
_XFER_TRANSFERS = _prom.counter(
    "fsdr_xfer_transfers_total", "transfers started on the host-device link",
    ("direction",))
_XFER_STARTS = _prom.counter(
    "fsdr_xfer_starts_total",
    "physical per-buffer copy starts on the host-device link", ("direction",))
_XFER_HIST = _prom.histogram(
    "fsdr_xfer_seconds",
    "host-device transfer duration, start to landing as the caller sees it "
    "(fake link: the modeled wire window)", ("direction",))
_RETRIES = _prom.counter(
    "fsdr_retries_total", "transient host-device transfer retries", ("direction",))
_BYTES = {d: _XFER_BYTES.labels(direction=d) for d in ("h2d", "d2h")}
_TRANSFERS = {d: _XFER_TRANSFERS.labels(direction=d) for d in ("h2d", "d2h")}
_STARTS = {d: _XFER_STARTS.labels(direction=d) for d in ("h2d", "d2h")}
_HIST = {d: _XFER_HIST.labels(direction=d) for d in ("h2d", "d2h")}
_RETRY = {d: _RETRIES.labels(direction=d) for d in ("h2d", "d2h")}

Device = Union[str, torch.device]

_streams_lock = threading.Lock()
_streams: Dict[Tuple[str, str], "torch.cuda.Stream"] = {}

#: bytes each direction has carried since the last :func:`reset_bytes`
bytes_total: Dict[str, int] = {"h2d": 0, "d2h": 0}
#: copies started (one a part; a packed group is one)
starts_total: Dict[str, int] = {"h2d": 0, "d2h": 0}
#: transfer attempts retried after a transient error
retries_total: Dict[str, int] = {"h2d": 0, "d2h": 0}
_bytes_lock = threading.Lock()


def _tally(direction: str, n: int, starts: int) -> None:
    with _bytes_lock:
        bytes_total[direction] += int(n)
        starts_total[direction] += int(starts)
    _BYTES[direction].inc(int(n))
    _TRANSFERS[direction].inc()
    _STARTS[direction].inc(int(starts))


def _span_bounds_ns(t0_ns: int, service: float, deadline: float) -> tuple:
    """``(start_ns, end_ns)`` of a transfer span, clamped to the fake link's
    modeled wire occupancy when one exists: the span starts when the wire
    begins servicing these bytes and ends at the landing deadline (a
    ``finish()`` called late must not stretch the lane's busy interval)."""
    end = time.perf_counter_ns()
    if deadline:
        dl = int(deadline * 1e9)       # perf_counter and perf_counter_ns share
        if t0_ns < dl < end:           # one epoch
            end = dl
    start = t0_ns
    if service:
        sv = int(service * 1e9)
        if t0_ns < sv:
            start = min(sv, end)
    return start, end


def _note_landed(direction: str, t0_ns: int, service: float, deadline: float,
                 nbytes: int) -> None:
    """Bill one transfer's dwell: the histogram always, the span with
    tracing on."""
    s, e = _span_bounds_ns(t0_ns, service, deadline)
    _HIST[direction].observe((e - s) * 1e-9)
    if _trace.enabled:
        _trace.complete("tpu", "H2D" if direction == "h2d" else "D2H", s, end_ns=e,
                        args={"bytes": nbytes})


def reset_bytes() -> None:
    """Set both directions' byte, start and retry counts to 0."""
    with _bytes_lock:
        for d in (bytes_total, starts_total, retries_total):
            for k in d:
                d[k] = 0


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def _copy_stream(device: torch.device, direction: str) -> "torch.cuda.Stream":
    key = (str(device), direction)
    with _streams_lock:
        s = _streams.get(key)
        if s is None:
            s = torch.cuda.Stream(device=device)
            _streams[key] = s
        return s


# ---------------------------------------------------------------------------
# retries: transient against fatal, backoff under a deadline
# ---------------------------------------------------------------------------

class TransferError(RuntimeError):
    """A transfer failed for good: a cause that is not transient, the retry
    budget (``xfer_retries``) or the deadline (``xfer_deadline``) spent."""


class FakeLinkFault(RuntimeError):
    """A transient fault of the seeded fake link (:func:`set_fake_link`)."""


#: lowercase substrings marking an error as worth retrying: gRPC-style
#: retryable codes and socket transients (the reference's list)
_TRANSIENT_MARKERS = ("unavailable", "resource_exhausted", "deadline_exceeded",
                      "aborted", "connection reset", "temporarily",
                      "try again", "timed out")
#: CUDA's sticky errors: the context is lost, so a retry cannot succeed, and
#: they are never retried even when their text holds a transient marker ("the
#: launch timed out and was terminated")
_FATAL_MARKERS = ("illegal memory access", "unspecified launch failure",
                  "device-side assert", "illegal instruction", "misaligned address",
                  "uncorrectable ecc", "invalid program counter",
                  "hardware stack error", "launch timed out", "cuda error: unknown error")


def classify_transfer_error(e: BaseException) -> bool:
    """True when ``e`` is transient (worth a retry): fake-link faults,
    transient injected faults (``runtime/faults.py``) and errors naming a
    transient cause. A :class:`TransferError` and CUDA's sticky errors are
    fatal."""
    if isinstance(e, FakeLinkFault):
        return True
    if isinstance(e, TransferError):
        return False
    transient = getattr(e, "transient", None)     # InjectedFault carries it
    if transient is not None:
        return bool(transient)
    msg = str(e).lower()
    if any(m in msg for m in _FATAL_MARKERS):
        return False
    return any(m in msg for m in _TRANSIENT_MARKERS)


#: jitter of the backoff, apart from the fault draws: it moves the retries in
#: time and never changes their count
_jitter_rng = _random.Random(0x5FDB7)


def _with_retry(direction: str, attempt_fn):
    """Run one transfer attempt with transient errors retried: jittered
    exponential backoff from ``xfer_backoff`` within ``xfer_retries`` retries
    and ``xfer_deadline`` seconds. ``attempt_fn`` must be idempotent (it
    re-queues the same copies from the same host memory)."""
    t0 = time.perf_counter()
    try:
        return attempt_fn()              # the common case reads no config
    except Exception as e:               # noqa: BLE001 — classified below
        err = e
    c = config()
    retries, backoff, deadline_s = int(c.xfer_retries), float(c.xfer_backoff), \
        float(c.xfer_deadline)
    attempt = 0
    while True:
        attempt += 1
        if not classify_transfer_error(err):
            raise err
        pause = min(backoff * (1 << (attempt - 1)), 1.0)
        pause *= 0.5 + _jitter_rng.random()
        out_of_budget = attempt > retries
        past_deadline = deadline_s > 0 and time.perf_counter() - t0 + pause > deadline_s
        if out_of_budget or past_deadline:
            raise TransferError(
                f"{direction} transfer failed after {attempt} attempt(s) "
                f"({'retry budget' if out_of_budget else 'deadline'} "
                f"exhausted): {err!r}") from err
        with _bytes_lock:
            retries_total[direction] += 1
        _RETRY[direction].inc()
        log.warning("%s transfer attempt %d failed transiently (%r): "
                    "retrying in %.1f ms", direction, attempt, err, pause * 1e3)
        time.sleep(pause)
        try:
            return attempt_fn()
        except Exception as e:           # noqa: BLE001 — classified above
            err = e


_faults_mod = None


def _check_injected(direction: str) -> None:
    """Raise any armed fault for this crossing: the fake link's own seeded
    faults, then the ``h2d``/``d2h`` and ``link`` sites of
    ``runtime/faults.py``."""
    link = _fake_link
    if link is not None:
        link.maybe_fault(direction)
    global _faults_mod
    if _faults_mod is None:              # ops must not import runtime at load
        from ..runtime import faults as _fm
        _faults_mod = _fm
    p = _faults_mod.plan()
    if p.armed():
        p.maybe(direction)
        p.maybe("link")


# ---------------------------------------------------------------------------
# the fake link
# ---------------------------------------------------------------------------

class _FakeLink:
    """A rate-limited, optionally faulty link for tests.

    Each direction is a serial wire: a transfer of ``nbytes`` occupies it for
    ``nbytes/rate`` seconds from when it frees up; ``reserve`` at the start
    returns ``(service start, landing deadline)`` and ``finish()`` sleeps out
    the rest. ``fault_rate``/``fault_seed`` add seeded faults: each start
    draws from a per-direction stream (``runtime/faults.SiteInjector``) and
    raises a transient :class:`FakeLinkFault` on a hit, so the same seed and
    transfer sequence give the same faults and the same retry count."""

    def __init__(self, h2d_bps: Optional[float], d2h_bps: Optional[float],
                 fault_rate: float = 0.0, fault_seed: int = 0):
        from ..runtime.faults import SiteInjector
        self.h2d_bps = h2d_bps
        self.d2h_bps = d2h_bps
        self._lock = threading.Lock()
        self._busy = {"h2d": 0.0, "d2h": 0.0}
        self.fault_rate = float(fault_rate or 0.0)
        self.fault_seed = int(fault_seed)
        self._injectors = {
            d: SiteInjector(f"link:{d}", self.fault_rate, self.fault_seed,
                            max_faults=None, transient=True)
            for d in ("h2d", "d2h")}

    @property
    def faults(self):
        """``{direction: fired}``."""
        return {d: inj.fired for d, inj in self._injectors.items()}

    def maybe_fault(self, direction: str) -> None:
        if not self.fault_rate:
            return
        from ..runtime.faults import InjectedFault
        try:
            self._injectors[direction].check()
        except InjectedFault as e:
            raise FakeLinkFault(f"injected fake-link fault on {direction} (#{e.seq}, "
                                f"seed {self.fault_seed})") from e

    def reserve(self, direction: str, nbytes: int) -> tuple:
        rate = self.h2d_bps if direction == "h2d" else self.d2h_bps
        if not rate:
            return (0.0, 0.0)
        with self._lock:
            start = max(time.perf_counter(), self._busy[direction])
            self._busy[direction] = start + nbytes / rate
            return (start, self._busy[direction])


_fake_link: Optional[_FakeLink] = None


def set_fake_link(h2d_bps: Optional[float] = None, d2h_bps: Optional[float] = None,
                  fault_rate: float = 0.0, fault_seed: int = 0):
    """Install (with no arguments: remove) a fake link on every transfer of
    this module; returns the previous one. For tests: a rate-limited link
    and seeded transient faults, deterministic on any device."""
    global _fake_link
    prev = _fake_link
    _fake_link = _FakeLink(h2d_bps, d2h_bps, fault_rate, fault_seed) \
        if (h2d_bps or d2h_bps or fault_rate) else None
    return prev


def fake_link() -> Optional[_FakeLink]:
    return _fake_link


def _reserve(direction: str, nbytes: int) -> tuple:
    return _fake_link.reserve(direction, nbytes) if _fake_link else (0.0, 0.0)


def _wait_deadline(deadline: float) -> None:
    """Wait out a fake-link deadline: sleep to ~1.5 ms short of it, then
    spin (a plain sleep overshoots by milliseconds)."""
    if not deadline:
        return
    while True:
        d = deadline - time.perf_counter()
        if d <= 0:
            return
        time.sleep(d - 0.0015 if d > 0.0015 else 0.0)


# ---------------------------------------------------------------------------
# host buffers
# ---------------------------------------------------------------------------

class HostBuffer:
    """The host side of one transfer: ``array`` (numpy) and ``tensor``
    (torch) views of the same memory, pinned for a CUDA device (an arena
    buffer, or a pinned tensor of its own with the arena off), a plain array
    on the CPU. :meth:`release` hands an arena buffer back to the pool, which
    reuses it once the copy recorded on it has completed."""

    __slots__ = ("array", "tensor", "handle")

    def __init__(self, tensor: torch.Tensor, handle: Optional[ArenaBuffer] = None):
        self.tensor = tensor
        self.array = tensor.numpy()
        self.handle = handle

    def release(self) -> None:
        if self.handle is not None:
            self.handle.release()
            self.handle = None


def host_buffer(shape, dtype, device: Device) -> HostBuffer:
    """A host buffer of ``shape`` and numpy or torch ``dtype`` for a
    transfer to or from ``device``."""
    tdt = dtype if isinstance(dtype, torch.dtype) else torch_dtype(dtype)
    if torch.device(device).type == "cpu":
        return HostBuffer(torch.empty(shape, dtype=tdt))
    ar = arena()
    if ar is None:
        return HostBuffer(torch.empty(shape, dtype=tdt, pin_memory=True))
    n = math.prod(shape) * tdt.itemsize
    buf = ar.take(n)
    return HostBuffer(buf.tensor[:n].view(tdt).view(shape), buf)


def _host_tensor(p) -> torch.Tensor:
    if isinstance(p, torch.Tensor):
        return p
    a = np.asarray(p)
    if not a.flags.c_contiguous:
        a = np.ascontiguousarray(a)          # (which makes a 0-d array 1-d)
    if a.flags.writeable:
        return torch.from_numpy(a)
    # a registered ingest buffer is read-only by contract (ops/ingest.py);
    # the transfer only reads it
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(a)


# ---------------------------------------------------------------------------
# H2D
# ---------------------------------------------------------------------------

def start_device_transfer_parts(parts: Sequence, device: Device,
                                out: Optional[Sequence[torch.Tensor]] = None,
                                handles: Sequence[ArenaBuffer] = ()
                                ) -> Callable[[], Tuple[torch.Tensor, ...]]:
    """Begin the H2D of a tuple of host parts (numpy arrays or CPU tensors:
    a wire's parts, a packed buffer, a ``[K, frame]`` group), one copy each,
    into ``out`` (a compiled program's slot inputs, one a part, of as many
    elements each) or new tensors; returns ``finish() -> tuple of
    tensors``, which orders the caller's current stream after the copies.

    ``handles``: the arena buffers behind the parts; the transfer records
    its event on them and releases them once the copies are queued (the
    arena recycles a buffer only after its event). The start, the injected
    faults of ``runtime/faults.py`` included, runs under the retry policy.
    ``finish._wire`` is the fake link's ``(service, deadline)`` window."""
    device = torch.device(device)
    host = [_host_tensor(p) for p in parts]
    nbytes = sum(t.numel() * t.element_size() for t in host)
    _tally("h2d", nbytes, len(host))
    if out is not None and len(out) != len(host):
        raise ValueError(f"{len(host)} parts for {len(out)} destinations")

    if device.type == "cpu":
        def attempt():
            _check_injected("h2d")
            if out is None:
                return tuple(t.clone() for t in host)
            for o, t in zip(out, host):
                o.view(t.shape).copy_(t)
            return tuple(out)
    else:
        side = _copy_stream(device, "h2d")

        def attempt():
            _check_injected("h2d")
            with torch.cuda.stream(side):
                dsts = []
                for i, t in enumerate(host):
                    dst = torch.empty(t.shape, dtype=t.dtype, device=device) \
                        if out is None else out[i]
                    dst.view(t.shape).copy_(t, non_blocking=True)
                    dsts.append(dst)
                done = torch.cuda.Event()
                done.record(side)
            return tuple(dsts), done

    try:
        got = _with_retry("h2d", attempt)
    except BaseException:
        for h in handles:
            h.release()
        raise
    service, deadline = _reserve("h2d", nbytes)
    t0 = time.perf_counter_ns()

    if device.type == "cpu":
        for h in handles:                   # the copies are done
            h.release()

        def finish_cpu():
            _wait_deadline(deadline)
            _note_landed("h2d", t0, service, deadline, nbytes)
            return got

        finish_cpu._wire = (service, deadline)
        return finish_cpu
    dsts, done = got
    for h in handles:
        h.record(done)
        h.release()

    def finish() -> Tuple[torch.Tensor, ...]:
        _wait_deadline(deadline)
        cur = torch.cuda.current_stream(device)
        cur.wait_event(done)
        _note_landed("h2d", t0, service, deadline, nbytes)
        if out is None:
            for d in dsts:
                d.record_stream(cur)
        return dsts

    finish._wire = (service, deadline)
    return finish


def start_device_transfer(arr: np.ndarray, device: Device) -> Callable[[], torch.Tensor]:
    """Begin an H2D of one host array; returns ``finish() -> tensor``. The
    array is copied into a host buffer of its own before this returns, so
    the caller may reuse its memory at once."""
    a = np.asarray(arr)
    buf = host_buffer(a.shape, a.dtype, device)
    buf.array[...] = a
    handles = (buf.handle,) if buf.handle is not None else ()
    fin = start_device_transfer_parts((buf.tensor,), device, handles=handles)

    def finish() -> torch.Tensor:
        return fin()[0]

    finish._wire = fin._wire
    return finish


# ---------------------------------------------------------------------------
# D2H
# ---------------------------------------------------------------------------

def start_host_transfer_parts(parts: Sequence[torch.Tensor]
                              ) -> Callable[[], Tuple[np.ndarray, ...]]:
    """Begin the D2H of a tuple of device tensors (a program's output parts,
    after the work queued so far on the current stream), one copy each, all
    started now; returns ``finish() -> tuple of np.ndarray``, which blocks
    until the copies land. The arrays live in host buffers the caller hands
    back with ``finish.release()`` once it has copied the data out.
    ``finish._wire`` is the fake link's window."""
    parts = tuple(parts)
    nbytes = sum(t.numel() * t.element_size() for t in parts)
    _tally("d2h", nbytes, len(parts))
    dev = parts[0].device if parts else torch.device("cpu")

    if dev.type == "cpu":
        def attempt():
            _check_injected("d2h")
            return tuple(t.detach().clone() for t in parts), None, ()
    else:
        side = _copy_stream(dev, "d2h")

        def attempt():
            _check_injected("d2h")
            side.wait_stream(torch.cuda.current_stream(dev))
            bufs = [host_buffer(t.shape, t.dtype, dev) for t in parts]
            with torch.cuda.stream(side):
                for b, t in zip(bufs, parts):
                    b.tensor.copy_(t, non_blocking=True)
                done = torch.cuda.Event()
                done.record(side)
            for t in parts:
                t.record_stream(side)
            for b in bufs:
                if b.handle is not None:
                    b.handle.record(done)
            return tuple(b.tensor for b in bufs), done, bufs

    hosts, done, bufs = _with_retry("d2h", attempt)
    service, deadline = _reserve("d2h", nbytes)
    t0 = time.perf_counter_ns()

    def finish() -> Tuple[np.ndarray, ...]:
        if done is not None:
            done.synchronize()
        _wait_deadline(deadline)
        _note_landed("d2h", t0, service, deadline, nbytes)
        return tuple(h.numpy() for h in hosts)

    def release() -> None:
        for b in bufs:
            b.release()

    finish.release = release
    finish._wire = (service, deadline)
    return finish


def start_host_transfer(t: torch.Tensor) -> Callable[[], np.ndarray]:
    """Begin a D2H of one tensor (after the work queued so far on the
    current stream), a ``[K, n]`` group in one copy; returns ``finish() ->
    np.ndarray``, which blocks until the copy lands. The array lives in a
    host buffer the caller hands back with ``finish.release()`` once it has
    copied the data out."""
    fin = start_host_transfer_parts((t,))

    def finish() -> np.ndarray:
        return fin()[0]

    finish.release = fin.release
    finish._wire = fin._wire
    return finish


def to_device(arr: np.ndarray, device: Device) -> torch.Tensor:
    """Blocking-safe H2D: the tensor is ready on the current stream."""
    return start_device_transfer(arr, device)()


def to_host(t: torch.Tensor) -> np.ndarray:
    """D2H into a numpy array of its own."""
    finish = start_host_transfer(t)
    a = finish().copy()
    finish.release()
    return a


# ---------------------------------------------------------------------------
# the coalesced uplink
# ---------------------------------------------------------------------------

class PackedLayout:
    """The offset table of one dispatch group's coalesced H2D buffer.

    A quantizing wire ships several parts a frame (payload and scale, each
    K-stacked in a megabatch group), each its own copy. ``PackedLayout``
    fixes the byte layout that packs every part of a group into one uint8
    buffer: slot ``i`` holds part ``i``'s bytes at a 64-byte-aligned offset
    (``ALIGN``; it keeps every typed view of the buffer aligned). The host
    writes payloads in place (``ops/arena.PackedAlloc``); the device recovers
    the parts with :meth:`unpack_torch`, slices and dtype views of the slot's
    input buffer inside the program's graph, so the group costs one H2D
    start. The layout is a pure function of the wire and the frame shape
    (probed from an encode of zeros), so packer and unpacker agree."""

    ALIGN = 64
    __slots__ = ("slots", "nbytes")

    def __init__(self, slots, nbytes):
        self.slots = tuple(slots)     # (shape, dtype, offset, nbytes) each
        self.nbytes = int(nbytes)

    @classmethod
    def from_parts(cls, parts) -> "PackedLayout":
        """The layout of a concrete part tuple (shapes and dtypes as shipped)."""
        slots, off = [], 0
        for p in parts:
            p = np.asarray(p)
            slots.append((tuple(p.shape), np.dtype(p.dtype), off, int(p.nbytes)))
            off += -(-max(p.nbytes, 1) // cls.ALIGN) * cls.ALIGN
        return cls(slots, off)

    @classmethod
    def probe(cls, wire, frame_size: int, in_dtype, k: int = 1):
        """The layout of ``wire``'s encode of a ``frame_size`` frame (``k >
        1``: every part gains a leading ``[k]`` axis), or ``None`` when the
        wire ships one part (nothing to coalesce)."""
        parts = [np.asarray(p) for p in wire.encode_host(np.zeros(frame_size, dtype=in_dtype))]
        if len(parts) < 2:
            return None
        if k > 1:
            parts = [np.broadcast_to(p, (int(k),) + p.shape) for p in parts]
        return cls.from_parts(parts)

    @property
    def key(self):
        """Hashable identity (the program cache key)."""
        return self.slots

    def pack(self, parts, out: np.ndarray) -> np.ndarray:
        """Copy every part not already in its slot into ``out`` (a
        ``(nbytes,)`` uint8 buffer) and zero the alignment gaps, so the
        shipped bytes are a function of the parts alone."""
        if out.nbytes < self.nbytes:
            raise ValueError(f"a {out.nbytes} B buffer for a {self.nbytes} B layout")
        end = 0
        for p, (sh, dt, off, nb) in zip(parts, self.slots):
            p = np.asarray(p)
            if end < off:
                out[end:off] = 0
            view = out[off:off + nb].view(dt).reshape(sh)
            if not np.shares_memory(view, p):
                view[...] = p
            end = off + nb
        if end < self.nbytes:
            out[end:self.nbytes] = 0
        return out

    def unpack_torch(self, buf: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The parts of a packed uint8 tensor, as slices viewed in each
        part's dtype: no copy, so inside a graph capture they are views of
        the slot's input buffer."""
        parts = []
        for sh, dt, off, nb in self.slots:
            seg = buf[off:off + nb]
            if dt != np.uint8:
                seg = seg.view(torch_dtype(dt))
            parts.append(seg.reshape(sh))
        return tuple(parts)
