"""TpuKernel: a stage pipeline as one flowgraph block.

The counterpart of ``futuresdr_tpu/tpu/kernel_block.py:TpuKernel``, cut to
its core. Each ``work`` call:

1. emits output that did not fit downstream last time;
2. stages full frames from the input ring: each frame is copied into a
   pinned staging buffer and its H2D starts on the copy stream
   (``ops/xfer.py``), so the ring slot can be consumed at once;
3. runs :meth:`Pipeline.fn` on the device for each staged frame, carry
   chained frame to frame, and starts the result's D2H;
4. drains the oldest frame in flight and emits it, in order.

At most ``frames_in_flight`` frames are staged or computing at once. At EOS a
partial frame is zero-padded to the frame size and only the outputs of its
whole ``frame_multiple`` prefix are emitted, so the block emits exactly as
many items as the JAX ``TpuKernel`` does for the same input. A retune goes
through :meth:`apply_retune` → :meth:`Pipeline.update_stage` between frames.

Not in this slice (ROADMAP): wire codecs, megabatch K, carry
checkpoint/replay, credit autotuning, frame lineage and CUDA-graph replay.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, List, Optional, Sequence

import numpy as np
import torch

from ..ops import xfer
from ..ops.stages import Pipeline, Stage
from ..runtime.kernel import Kernel
from ..runtime.tag import ItemTag, rebase_tags
from .instance import TpuInstance, instance

__all__ = ["TpuKernel", "rebase_frame_tags", "emit_with_tags"]

def rebase_frame_tags(tags: Sequence[ItemTag], pipeline: Pipeline,
                      out_valid: int) -> List[ItemTag]:
    """Remap frame-relative tag indices through the pipeline's rate change,
    clamped into the valid output window."""
    if out_valid <= 0:
        return []
    r = pipeline.ratio
    return [ItemTag(min(t.index * r.numerator // r.denominator, out_valid - 1), t.tag)
            for t in tags]


def emit_with_tags(output, data: np.ndarray, tags: Sequence[ItemTag]) -> tuple:
    """Write as much of ``data`` as the output accepts, with ``tags`` at their
    positions; returns ``(pending_data, pending_tags)`` for the unwritten
    tail (``(None, [])`` when everything fit)."""
    out = output.slice()
    k = min(len(out), len(data))
    out[:k] = data[:k]
    for t in tags:
        if t.index < k:
            output.add_tag(t.index, t.tag)
    output.produce(k)
    if k < len(data):
        return data[k:].copy(), rebase_tags(tags, k)
    return None, []


class TpuKernel(Kernel):
    """Runs ``Pipeline(stages, in_dtype)`` over the stream, frame by frame,
    on ``inst.device``."""

    BLOCKING = True

    def __init__(self, stages: Sequence[Stage], in_dtype,
                 frame_size: Optional[int] = None,
                 inst: Optional[TpuInstance] = None,
                 frames_in_flight: Optional[int] = None):
        super().__init__()
        self.inst = inst or instance()
        self.pipeline = Pipeline(stages, in_dtype)
        fs = frame_size or self.inst.frame_size
        m = self.pipeline.frame_multiple
        self.frame_size = max(m, (fs // m) * m)
        self.out_frame = self.pipeline.out_items(self.frame_size)
        self.depth = max(1, int(frames_in_flight or self.inst.frames_in_flight))
        self._fn = self.pipeline.fn()
        self._carry = None
        # serializes the carry between this block's thread and apply_retune
        self._carry_lock = threading.Lock()
        # H2D started: (finish, valid_in, frame tags)
        self._staged: Deque[tuple] = deque()
        # computed, D2H riding: (finish, valid_out, rebased tags)
        self._inflight: Deque[tuple] = deque()
        self._pending_out: Optional[np.ndarray] = None
        self._pending_tags: List[ItemTag] = []
        self.frames_dispatched = 0
        self.input = self.add_stream_input("in", in_dtype, min_items=self.frame_size)
        self.output = self.add_stream_output(
            "out", self.pipeline.out_dtype, min_items=self.out_frame,
            min_buffer_size=(self.depth + 1) * self.out_frame *
            np.dtype(self.pipeline.out_dtype).itemsize)

    async def init(self, mio, meta):
        dev = self.inst.device
        self._staged.clear()
        self._inflight.clear()
        self._pending_out, self._pending_tags = None, []
        # warm the device path (library plans, kernel builds) off the hot
        # path, then start from a fresh carry
        x = torch.zeros(self.frame_size, dtype=xfer.torch_dtype(self.pipeline.in_dtype),
                        device=dev)
        _, y = self._fn(self.pipeline.init_carry(dev), x)
        xfer.to_host(y)
        with self._carry_lock:
            self._carry = self.pipeline.init_carry(dev)
            self.frames_dispatched = 0

    def apply_retune(self, stage, **params) -> int:
        """Carry surgery between frames (the reference's retune entry point),
        e.g. ``apply_retune(0, taps=new_taps)``: frames already dispatched
        keep the old parameters, every later frame sees the new ones. Safe to
        call from another thread while the flowgraph runs. Returns the number
        of frames dispatched before the surgery, i.e. the first frame that
        sees it."""
        with self._carry_lock:
            if self._carry is None:
                raise RuntimeError("retune before init")
            self._carry = self.pipeline.update_stage(self._carry, stage, **params)
            return self.frames_dispatched

    def _stage(self, frame: np.ndarray, valid_in: int, tags) -> None:
        self._staged.append((xfer.start_device_transfer(frame, self.inst.device),
                             valid_in, tuple(tags)))

    def _stage_available_input(self):
        """Stage every full frame the depth allows, and the zero-padded tail
        frame at EOS; returns ``(remaining input slice, eos)``."""
        inp = self.input.slice()
        while len(self._staged) + len(self._inflight) < self.depth and \
                len(inp) >= self.frame_size:
            # the transfer copies the frame out of the ring before consume()
            self._stage(inp[:self.frame_size], self.frame_size,
                        self.input.tags(self.frame_size))
            self.input.consume(self.frame_size)
            inp = self.input.slice()
        eos = self.input.finished()
        if eos and 0 < len(inp) < self.frame_size and \
                len(self._staged) + len(self._inflight) < self.depth:
            n = len(inp)
            frame = np.zeros(self.frame_size, dtype=self.pipeline.in_dtype)
            frame[:n] = inp
            # items past the last frame_multiple boundary cannot give whole
            # outputs and are dropped at EOS (the streaming frame contract)
            self._stage(frame, n - n % self.pipeline.frame_multiple,
                        self.input.tags(n))
            self.input.consume(n)
            inp = self.input.slice()
        return inp, eos

    def _launch_staged(self) -> None:
        """Compute each staged frame (oldest first) and start its D2H."""
        while self._staged:
            finish, valid_in, tags = self._staged.popleft()
            x = finish()
            with self._carry_lock:
                self._carry, y = self._fn(self._carry, x)
                self.frames_dispatched += 1
            valid_out = min(self.pipeline.out_items(valid_in), self.out_frame)
            self._inflight.append((xfer.start_host_transfer(y), valid_out,
                                   rebase_frame_tags(tags, self.pipeline, valid_out)))

    async def work(self, io, mio, meta):
        # 1. flush output that did not fit last time
        if self._pending_out is not None:
            self._pending_out, self._pending_tags = emit_with_tags(
                self.output, self._pending_out, self._pending_tags)
            if self._pending_out is not None:
                return  # downstream full; its consume() wakes us

        # 2. stage input (each H2D starts now), 3. compute and start the D2H
        inp, eos = self._stage_available_input()
        self._launch_staged()

        # 4. drain the oldest frame: when the pipe is full, when no full frame
        #    waits (flush for latency), or at EOS
        if self._inflight and (len(self._inflight) >= self.depth
                               or len(inp) < self.frame_size or eos):
            finish, valid_out, tags = self._inflight.popleft()
            result = finish()[:valid_out]
            self._pending_out, self._pending_tags = emit_with_tags(
                self.output, result, tags)
            io.call_again = True
            return

        if eos and not self._inflight and not self._staged and \
                self._pending_out is None and len(inp) == 0:
            io.finished = True
