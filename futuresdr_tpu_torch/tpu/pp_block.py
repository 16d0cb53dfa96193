"""PpKernel: a flowgraph block whose per-frame compute is a GPipe pipeline over
a mesh's ``pp`` axis.

The counterpart of ``futuresdr_tpu/tpu/pp_block.py``, the sibling of
:class:`~.sp_block.SpKernel` for pipeline parallelism: each device of the axis
owns one stage's weights, a frame is cut into microbatches that stream through
the stages with a peer copy a hop (:func:`futuresdr_tpu_torch.parallel.make_pp_pipeline`).
The frame crosses the link in the wire's parts (``ops/wire.py``), decoded and
encoded on the device.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Deque, Optional, Sequence

import numpy as np
import torch

from ..ops.wire import resolve_wire
from ..parallel.pipeline_pp import make_pp_pipeline, stage_slice, tree_map
from ..runtime.kernel import Kernel
from ..telemetry.spans import recorder as _trace_recorder

_trace = _trace_recorder()

__all__ = ["PpKernel"]


def _check_stage_leading(stage_params, n_stages: int) -> None:
    """Every leaf must lead with exactly ``n_stages``: a larger multiple
    would silently leave stages unused."""
    bad = []

    def visit(leaf):
        shape = tuple(np.shape(leaf))
        if not shape or shape[0] != n_stages:
            bad.append(shape)
        return leaf

    tree_map(visit, stage_params)
    if bad:
        raise ValueError(f"stage_params leaves must lead with n_stages={n_stages}; "
                         f"got leaf shape {bad[0]}")


class PpKernel(Kernel):
    """Stream → microbatched pipeline over ``mesh[axis]`` → stream.

    - ``apply_stage(params_one_stage, x) -> y``: one stage; input and output
      share shape and dtype;
    - ``stage_params``: leaves with a leading ``n_stages`` axis, stage s's row
      placed on the axis's device s;
    - ``micro_shape``: one microbatch's shape; a frame carries ``n_micro`` of
      them, ``frame_size = n_micro · prod(micro_shape)`` items.

    Frames are independent. Tail contract: a final partial frame is
    zero-padded and only its valid prefix is emitted (``TpuKernel``'s)."""

    BLOCKING = True

    def __init__(self, apply_stage: Callable, stage_params, mesh, in_dtype,
                 out_dtype, micro_shape: Sequence[int], n_micro: int,
                 axis: str = "pp", frames_in_flight: int = 2, wire=None):
        super().__init__()
        self.mesh = mesh
        self.axis = axis
        self._devs = mesh.line(axis)
        self.n_stages = len(self._devs)
        self.micro_shape = tuple(int(m) for m in micro_shape)
        self.n_micro = int(n_micro)
        self.frame_size = self.n_micro * int(np.prod(self.micro_shape))
        self.wire = resolve_wire(wire, self._devs[0].type)
        self._in_dt = np.dtype(in_dtype)
        self._out_dt = np.dtype(out_dtype)
        self._fn = make_pp_pipeline(apply_stage, self.n_stages, self.n_micro, mesh, axis)
        self.update_params(stage_params)
        self.depth = int(frames_in_flight)
        self._inflight: Deque = deque()          # (encoded output parts, valid)
        self._pending: Optional[np.ndarray] = None
        self.input = self.add_stream_input("in", in_dtype, min_items=self.frame_size)
        self.output = self.add_stream_output(
            "out", out_dtype, min_items=self.frame_size,
            min_buffer_size=(self.depth + 1) * self.frame_size * np.dtype(out_dtype).itemsize)

    def update_params(self, stage_params) -> None:
        """Swap the pipeline's weights between frames (frames already
        dispatched finish with the old ones)."""
        _check_stage_leading(stage_params, self.n_stages)
        self._W = [stage_slice(stage_params, s, d) for s, d in enumerate(self._devs)]

    def _dispatch(self, frame: np.ndarray, valid: int) -> None:
        # spans (tracing on): the host encode, the pipeline's launch as this
        # thread sees it, and (in work) the host decode, all cat="tpu"
        dev = self._devs[0]
        t0 = _trace.now() if _trace.enabled else 0
        host = self.wire.encode_host(frame)
        if t0:
            _trace.complete("tpu", "encode", t0, args={"wire": self.wire.name})
        parts = tuple(torch.from_numpy(np.ascontiguousarray(p)).to(dev, non_blocking=True)
                      for p in host)
        t0 = _trace.now() if _trace.enabled else 0
        x = self.wire.decode_torch(parts, self._in_dt).reshape((self.n_micro,)
                                                               + self.micro_shape)
        y = self._fn(self._W, x).reshape(-1)
        self._inflight.append((self.wire.encode_torch(y), valid))
        if t0:
            _trace.complete("tpu", "compute", t0,
                            args={"stages": self.n_stages, "micro": self.n_micro})

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
            self._dispatch(np.array(inp[:self.frame_size]), self.frame_size)
            self.input.consume(self.frame_size)
            inp = self.input.slice()
        eos = self.input.finished()
        if eos and 0 < len(inp) < self.frame_size and len(self._inflight) < self.depth:
            frame = np.zeros(self.frame_size, dtype=self._in_dt)
            frame[:len(inp)] = inp
            self._dispatch(frame, len(inp))
            self.input.consume(len(inp))
            inp = self.input.slice()
        if self._inflight and (len(self._inflight) >= self.depth or eos
                               or len(inp) < self.frame_size):
            parts, valid = self._inflight.popleft()
            raw = tuple(p.cpu().numpy() for p in parts)
            t0 = _trace.now() if _trace.enabled else 0
            result = self.wire.decode_host(raw, self._out_dt).reshape(-1)[:valid]
            if t0:
                _trace.complete("tpu", "decode", t0,
                                args={"wire": self.wire.name, "items": len(result)})
            out = self.output.slice()
            k = min(len(out), len(result))
            out[:k] = result[:k]
            self.output.produce(k)
            if k < len(result):
                self._pending = result[k:].copy()
            io.call_again = True
            return
        if eos and not self._inflight and self._pending is None \
                and not self.input.available():
            io.finished = True
