"""Host ↔ device transfers.

The counterpart of ``futuresdr_tpu/ops/xfer.py`` (``to_device``, ``to_host``,
``start_device_transfer``, ``start_host_transfer``). On a CUDA device each
transfer goes through a pinned host staging buffer on a side copy stream
(one for H2D, one for D2H, per device) and is ordered against the compute
stream with a CUDA event, so frame t+1's H2D and frame t−1's D2H overlap
frame t's compute. complex64 moves natively (the reference's float-pair shim
for its TPU link is not needed).

Staging rule (the reference's ``h2d_needs_staging``): ``torch.from_numpy``
shares memory with its array, and a frame handed to a transfer may be a view
of a ring slot the producer overwrites as soon as it is consumed. So every
H2D first copies the frame into a buffer of its own — the pinned staging
buffer on CUDA, a fresh tensor on the CPU — before the caller may consume.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Tuple, Union

import numpy as np
import torch

__all__ = ["to_device", "to_host", "start_device_transfer", "start_host_transfer",
           "torch_dtype"]

Device = Union[str, torch.device]

_streams_lock = threading.Lock()
_streams: Dict[Tuple[str, str], "torch.cuda.Stream"] = {}


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


def start_device_transfer(arr: np.ndarray, device: Device) -> Callable[[], torch.Tensor]:
    """Begin an H2D of one host array; returns ``finish() -> tensor``, which
    orders the caller's current stream after the copy. The array is copied
    into its own staging buffer before this returns, so the caller may reuse
    its memory at once."""
    device = torch.device(device)
    a = np.asarray(arr)
    if device.type == "cpu":
        t = torch.from_numpy(a.copy())      # never alias the caller's buffer
        return lambda: t
    staging = torch.empty(a.shape, dtype=torch_dtype(a.dtype), pin_memory=True)
    staging.numpy()[...] = a
    side = _copy_stream(device, "h2d")
    with torch.cuda.stream(side):
        dst = torch.empty(a.shape, dtype=staging.dtype, device=device)
        dst.copy_(staging, non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)

    def finish() -> torch.Tensor:
        cur = torch.cuda.current_stream(device)
        cur.wait_event(done)
        dst.record_stream(cur)
        return dst

    return finish


def start_host_transfer(t: torch.Tensor) -> Callable[[], np.ndarray]:
    """Begin a D2H of ``t`` (after the work queued so far on the current
    stream); returns ``finish() -> np.ndarray``, which blocks until the copy
    lands."""
    if t.device.type == "cpu":
        host = t.detach().clone()
        return lambda: host.numpy()
    side = _copy_stream(t.device, "d2h")
    side.wait_stream(torch.cuda.current_stream(t.device))
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    with torch.cuda.stream(side):
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
    t.record_stream(side)

    def finish() -> np.ndarray:
        done.synchronize()
        return host.numpy()

    return finish


def to_device(arr: np.ndarray, device: Device) -> torch.Tensor:
    """Blocking-safe H2D: the tensor is ready on the current stream."""
    return start_device_transfer(arr, device)()


def to_host(t: torch.Tensor) -> np.ndarray:
    """D2H into a numpy array of its own."""
    return start_host_transfer(t)()
