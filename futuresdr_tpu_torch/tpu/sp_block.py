"""SpKernel: a flowgraph block whose per-frame compute is time-sharded over a
mesh axis.

The counterpart of ``futuresdr_tpu/tpu/sp_block.py``: a stream block that
splits each frame over the devices of a mesh axis and runs a sequence-parallel
operator (:mod:`futuresdr_tpu_torch.parallel.stream_sp`) on it, the halos
crossing by peer copies. With a one-device axis it is the operator on one
device: the same flowgraph runs on one card or on several by changing the
mesh.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Deque, Optional

import numpy as np
import torch

from ..parallel.stream_sp import place, to_host
from ..runtime.kernel import Kernel
from ..telemetry.spans import recorder as _trace_recorder

_trace = _trace_recorder()

__all__ = ["SpKernel"]


class SpKernel(Kernel):
    """Stream block running ``sharded_fn`` (e.g. ``parallel.sp_fir_fft_mag2(...)``)
    over ``mesh`` a frame; the frame is split over ``axis``, the output
    gathered to the host.

    With ``init_carry``, ``sharded_fn`` is the cross-frame form ``fn(carry,
    x) -> (carry, y)`` (e.g. ``parallel.sp_fir_stream``): the previous
    frame's global tail stays on the device and feeds shard 0, so the
    sharded stream equals a single-device streaming stage across frames
    (:meth:`state_dict` holds it). A frame-local ``fn(x) -> y`` restarts the
    filter history at each frame edge.

    Tail contract: a final partial frame below ``frame_size`` is dropped at
    EOS (a sharded frame cannot shrink without changing the shards' shapes;
    ``TpuKernel`` and ``PpKernel`` zero-pad and emit the valid prefix)."""

    BLOCKING = True

    def __init__(self, sharded_fn: Callable, mesh, in_dtype, out_dtype,
                 frame_size: int, ratio: float = 1.0, axis: str = "sp",
                 frames_in_flight: int = 2, init_carry: Optional[Callable] = None):
        super().__init__()
        self.mesh = mesh
        self.axis = axis
        self._fn = sharded_fn
        self._stateful = init_carry is not None
        self._carry = init_carry(in_dtype) if self._stateful else None
        n_dev = len(mesh.line(axis))
        if frame_size % n_dev:
            raise ValueError(f"frame {frame_size} must divide by the {n_dev} devices "
                             f"of axis {axis!r}")
        self.frame_size = int(frame_size)
        self.out_frame = int(frame_size * ratio)
        self.depth = int(frames_in_flight)
        self._inflight: Deque = deque()
        self._pending: Optional[np.ndarray] = None
        self.input = self.add_stream_input("in", in_dtype, min_items=frame_size)
        self.output = self.add_stream_output(
            "out", out_dtype, min_items=self.out_frame,
            min_buffer_size=(self.depth + 1) * self.out_frame * np.dtype(out_dtype).itemsize)

    def state_dict(self) -> dict:
        """The cross-frame carry (empty for a frame-local operator)."""
        return {} if self._carry is None else {"carry": self._carry.detach().cpu().clone()}

    def load_state_dict(self, d: dict) -> None:
        if "carry" in d and self._carry is not None:
            self._carry = torch.as_tensor(d["carry"]).to(self._carry.device)

    def _dispatch(self, frame: np.ndarray) -> None:
        # the sharded operator's launch as this thread sees it (tracing on)
        t0 = _trace.now() if _trace.enabled else 0
        x = place(torch.from_numpy(frame), self.mesh, self.axis)
        if self._stateful:
            self._carry, y = self._fn(self._carry, x)
        else:
            y = self._fn(x)
        self._inflight.append(y)
        if t0:
            _trace.complete("tpu", "compute", t0, args={"frame": len(frame)})

    async def work(self, io, mio, meta):
        if self._pending is not None:
            out = self.output.slice()
            k = min(len(out), len(self._pending))
            out[:k] = self._pending[:k]
            self.output.produce(k)
            self._pending = self._pending[k:] if k < len(self._pending) else None
            if self._pending is not None:
                return
        inp = self.input.slice()
        while len(self._inflight) < self.depth and len(inp) >= self.frame_size:
            self._dispatch(np.array(inp[:self.frame_size]))
            self.input.consume(self.frame_size)
            inp = self.input.slice()
        eos = self.input.finished()
        if self._inflight and (len(self._inflight) >= self.depth or eos):
            result = to_host(self._inflight.popleft()).reshape(-1)
            out = self.output.slice()
            k = min(len(out), len(result))
            out[:k] = result[:k]
            self.output.produce(k)
            if k < len(result):
                self._pending = result[k:].copy()
            io.call_again = True
            return
        if eos and not self._inflight and self._pending is None:
            # a partial tail below one frame cannot shard: dropped at EOS
            if self.input.available():
                self.input.consume(self.input.available())
            io.finished = True
