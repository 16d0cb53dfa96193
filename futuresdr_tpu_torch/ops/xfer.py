"""Host ↔ device transfers.

The counterpart of ``futuresdr_tpu/ops/xfer.py`` (``to_device``, ``to_host``,
``start_device_transfer``, ``start_device_transfer_parts``,
``start_host_transfer``). On a CUDA device each transfer goes through a
pinned host buffer from the staging arena (``ops/arena.py``) on a side copy
stream (one for H2D, one for D2H, per device) and is ordered against the
compute stream with a CUDA event, so frame t+1's H2D and frame t−1's D2H
overlap frame t's compute. The event is recorded on the arena buffer, which
the pool hands out again only once the copy has completed. complex64 moves
natively (the reference's float-pair shim for its TPU link is not needed),
so a dispatch group of K frames is one ``[K, frame]`` buffer and one copy
each way: the reference's per-wire-part lists have one part here.

:data:`bytes_total` tallies the bytes each direction carries (``"h2d"``,
``"d2h"``), counted where a transfer starts, on every device: the port's
counterpart of the reference's ``fsdr_xfer_bytes_total`` counter without its
Prometheus layer, read as ``cuda_kernels.launches`` is
(:func:`reset_bytes`, then run, then read).

Staging rule (the reference's ``h2d_needs_staging``): a frame handed to a
transfer may be a view of a ring slot the producer overwrites as soon as it
is consumed, so it is first copied into a :class:`HostBuffer` of its own
before the caller may consume. On the CPU a host buffer is a plain array:
no pinning and no events.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from .arena import ArenaBuffer, arena

__all__ = ["HostBuffer", "host_buffer", "to_device", "to_host", "start_device_transfer",
           "start_device_transfer_parts", "start_host_transfer", "torch_dtype",
           "bytes_total", "reset_bytes"]

Device = Union[str, torch.device]

_streams_lock = threading.Lock()
_streams: Dict[Tuple[str, str], "torch.cuda.Stream"] = {}

#: bytes each direction has carried since the last :func:`reset_bytes`
bytes_total: Dict[str, int] = {"h2d": 0, "d2h": 0}
_bytes_lock = threading.Lock()


def _tally(direction: str, n: int) -> None:
    with _bytes_lock:
        bytes_total[direction] += int(n)


def reset_bytes() -> None:
    """Set both directions' byte counts to 0."""
    with _bytes_lock:
        for k in bytes_total:
            bytes_total[k] = 0


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
    n = int(np.prod(shape)) * tdt.itemsize
    buf = ar.take(n)
    return HostBuffer(buf.tensor[:n].view(tdt).view(shape), buf)


def start_device_transfer_parts(buf: HostBuffer, device: Device,
                                out: Optional[torch.Tensor] = None
                                ) -> Callable[[], torch.Tensor]:
    """Begin the H2D of a filled host buffer, a dispatch group's
    ``[K, frame]`` frames in one copy, into ``out`` (a compiled program's
    input slot, of as many elements) or a new tensor; returns ``finish() ->
    tensor``, which orders the caller's current stream after the copy. The
    buffer is the transfer's from here on: it is released as soon as the
    copy is queued and recycled once the copy has completed."""
    device = torch.device(device)
    _tally("h2d", buf.tensor.numel() * buf.tensor.element_size())
    if device.type == "cpu":
        if out is None:
            t = buf.tensor                  # a buffer of its own, never the ring
            return lambda: t
        out.view(buf.tensor.shape).copy_(buf.tensor)
        return lambda: out
    side = _copy_stream(device, "h2d")
    with torch.cuda.stream(side):
        dst = torch.empty(buf.tensor.shape, dtype=buf.tensor.dtype, device=device) \
            if out is None else out
        dst.view(buf.tensor.shape).copy_(buf.tensor, non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
    if buf.handle is not None:
        buf.handle.record(done)
    buf.release()

    def finish() -> torch.Tensor:
        cur = torch.cuda.current_stream(device)
        cur.wait_event(done)
        if out is None:
            dst.record_stream(cur)
        return dst

    return finish


def start_device_transfer(arr: np.ndarray, device: Device) -> Callable[[], torch.Tensor]:
    """Begin an H2D of one host array; returns ``finish() -> tensor``. The
    array is copied into a host buffer of its own before this returns, so
    the caller may reuse its memory at once."""
    a = np.asarray(arr)
    buf = host_buffer(a.shape, a.dtype, device)
    buf.array[...] = a
    return start_device_transfer_parts(buf, device)


def start_host_transfer(t: torch.Tensor) -> Callable[[], np.ndarray]:
    """Begin a D2H of ``t`` (after the work queued so far on the current
    stream), a ``[K, n]`` group in one copy; returns ``finish() ->
    np.ndarray``, which blocks until the copy lands. The array lives in a
    host buffer the caller hands back with ``finish.release()`` once it has
    copied the data out."""
    _tally("d2h", t.numel() * t.element_size())
    if t.device.type == "cpu":
        host = t.detach().clone()

        def finish_cpu() -> np.ndarray:
            return host.numpy()

        finish_cpu.release = lambda: None
        return finish_cpu
    side = _copy_stream(t.device, "d2h")
    side.wait_stream(torch.cuda.current_stream(t.device))
    buf = host_buffer(t.shape, t.dtype, t.device)
    with torch.cuda.stream(side):
        buf.tensor.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
    t.record_stream(side)
    if buf.handle is not None:
        buf.handle.record(done)

    def finish() -> np.ndarray:
        done.synchronize()
        return buf.array

    finish.release = buf.release
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
