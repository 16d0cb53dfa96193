"""The device-frame plane: H2D/D2H blocks and device-resident stage blocks.

The counterpart of ``futuresdr_tpu/tpu/frames.py``. Frames travel between
blocks over in-place ports (``runtime/buffer/circuit.py``) as whole device
tensors:

    ... stream → TpuH2D → TpuStage → TpuStage → TpuD2H → stream ...

``TpuH2D`` cuts the sample stream into frames and uploads them through the
pinned staging arena (``ops/xfer.py``); ``TpuStage`` maps a device frame to a
device frame through a compiled :class:`~futuresdr_tpu_torch.ops.stages.Pipeline`,
so frames stay on the card between stages; ``TpuMergeStage`` joins one frame
from each of K inputs; ``TpuD2H`` brings results back into the stream. For a
single chain :class:`~futuresdr_tpu_torch.tpu.TpuKernel` is one block; the
frame plane is for stages that stay separate blocks (a fan-out of device
consumers, a merge, a retune of one stage). The device-chain pass
(``runtime/devchain.py``) runs a whole frame-plane region as one program.

Tags ride the plane: ``TpuH2D`` takes each frame's stream tags
(frame-relative indices), they travel with the frame, each stage block
rebases them through its rate (:func:`rebase_frame_tags`) and ``TpuD2H``
emits them at the rebased positions (:func:`emit_with_tags`).

Frames cross the link in a wire format (``wire``, ``ops/wire.py``; None
reads config ``tpu_wire_format``, whose ``auto`` is f32 on the CPU and sc16
on a card): ``TpuH2D`` encodes on the host into the staging arena, ships the
parts and decodes on the device; ``TpuD2H`` encodes on the device, ships the
parts and decodes on the host. The device-chain pass fuses a region only
when its ends agree on the wire.
"""

from __future__ import annotations

from collections import deque
from fractions import Fraction
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..log import logger
from ..ops import xfer
from ..ops.arena import GroupAlloc, StagingArena, arena
from ..ops.stages import MergeStage, Pipeline, Stage
from ..ops.wire import resolve_wire
from ..runtime.kernel import Kernel, message_handler
from ..runtime.tag import ItemTag, rebase_tags
from ..types import Pmt
from .instance import TpuInstance, instance

__all__ = ["TpuH2D", "TpuStage", "TpuMergeStage", "TpuD2H", "rebase_frame_tags",
           "emit_with_tags", "parse_ctrl"]

log = logger("tpu.frames")

def parse_ctrl(p: Pmt):
    """``{"stage": <name-or-index>, <param>: <value>, …}`` → ``(stage, params)``.

    Raises on malformed input (the caller answers ``Pmt.invalid_value()``).
    ``Pmt.map`` wraps list elements as Pmt (VecPmt); they are unwrapped here."""
    d = dict(p.to_map())
    stage = d.pop("stage").value
    if not isinstance(stage, str):
        stage = int(stage)
    params = {}
    for k, v in d.items():
        val = v.value
        if isinstance(val, (list, tuple)):
            val = [e.value if isinstance(e, Pmt) else e for e in val]
            params[k] = np.asarray(val)
        elif isinstance(val, np.ndarray):
            params[k] = val
        elif isinstance(val, (float, np.floating)):
            params[k] = float(val)        # genuine numerics normalize to float
        else:
            params[k] = val               # ints/bools/strs pass through untouched
    return stage, params


def rebase_frame_tags(tags: Sequence[ItemTag], pipeline, out_valid: int) -> List[ItemTag]:
    """Remap frame-relative tag indices through ``pipeline.ratio`` (out =
    in · ratio), clamped into the valid output window."""
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


def _numpy_dtype(t: torch.Tensor) -> np.dtype:
    return torch.empty(0, dtype=t.dtype).numpy().dtype


class TpuH2D(Kernel):
    """Sample stream → device frames. Each full frame is encoded out of the
    ring into pinned arena buffers (for the f32 wire the encode is the copy)
    and its H2D started at once; frames the queue bound (``max_inflight``,
    default 8) does not admit yet wait with their copies started (one frame
    of read-ahead beyond the bound), so a frame's upload rides under the
    downstream stages' work. A landed frame is decoded on the device as it
    is handed downstream. A partial frame at EOS is zero-padded before its
    encode, with its valid count."""

    BLOCKING = True

    def __init__(self, dtype, frame_size: Optional[int] = None,
                 inst: Optional[TpuInstance] = None,
                 max_inflight: Optional[int] = None, wire=None):
        super().__init__()
        self.inst = inst or instance()
        self.wire = resolve_wire(wire, self.inst.device.type)
        cuda = self.inst.device.type == "cuda"
        self._arena = arena(pin=cuda) or StagingArena(0, pin=cuda)
        self.frame_size = frame_size or self.inst.frame_size
        self.max_inflight = 8 if max_inflight is None else max_inflight
        # an explicit bound pins a fused chain's credits (devchain.py)
        self._depth_explicit = max_inflight is not None
        self.stage_ahead = 1 if self.max_inflight > 1 else 0
        self.dtype = np.dtype(dtype)
        self._staged = deque()             # (h2d finish, valid, tags)
        self.input = self.add_stream_input("in", dtype, min_items=self.frame_size)
        self.output = self.add_inplace_output("out")

    def _stage(self, frame: np.ndarray, valid: int, tags) -> None:
        if len(frame) < self.frame_size:
            padded = np.zeros(self.frame_size, dtype=self.dtype)
            padded[:len(frame)] = frame
            frame = padded
        alloc = GroupAlloc(self._arena)
        if self.wire.encode_may_alias(self.dtype):
            parts = self.wire.encode_host(frame)      # views of the ring slot
        else:
            parts = self.wire.encode_into(frame, alloc)
        staged = []
        for p in parts:
            p = np.asarray(p)
            if not any(np.shares_memory(p, h.base) for h in alloc.handles):
                d = alloc(p.shape, p.dtype)            # into pinned memory
                d[...] = p
                p = d
            staged.append(p)
        self._staged.append((xfer.start_device_transfer_parts(
            staged, self.inst.device, handles=alloc.handles), valid, tuple(tags)))

    async def work(self, io, mio, meta):
        inp = self.input.slice()
        sent = 0

        def room() -> int:
            return self.max_inflight + self.stage_ahead \
                - self.output.queue_depth() - len(self._staged)

        # stage: start the upload of every frame the queue bound allows
        while len(inp) >= self.frame_size and room() > 0:
            self._stage(inp[:self.frame_size], self.frame_size,
                        self.input.tags(self.frame_size))
            self.input.consume(self.frame_size)
            inp = self.input.slice()
        eos = self.input.finished()
        if eos and 0 < len(inp) < self.frame_size and room() > 0:
            self._stage(inp, len(inp), self.input.tags(len(inp)))
            self.input.consume(len(inp))
            inp = self.input.slice()
        # launch: hand landed uploads to the frame plane, oldest first
        while self._staged and self.output.queue_depth() < self.max_inflight:
            finish, valid, tags = self._staged.popleft()
            self.output.put_full(self.wire.decode_torch(finish(), self.dtype), valid, tags)
            sent += 1
        if eos and len(inp) == 0 and not self._staged:
            io.finished = True
        elif sent and len(inp) >= self.frame_size:
            io.call_again = True
        # a full queue parks the block: the consumer's get_full() wakes it


class TpuStage(Kernel):
    """Device frame → device frame through a compiled stage pipeline.

    The program is compiled at the first frame, whose length fixes the
    frame size (:meth:`Pipeline.compile`: one CUDA graph on a card). A
    call copies the frame into the graph's input and hands downstream a
    clone of its output buffer, which the next replay overwrites: the
    clone is the frame's own memory for as long as any reader holds it,
    at the cost of one device copy of the output a frame and hop (the fused
    chain of ``runtime/devchain.py`` has no hops to pay it on).

    A ``ctrl`` message port takes :class:`TpuKernel`'s retune grammar; a
    retune that arrives before the first frame is validated at once and
    applied the moment the carry exists."""

    BLOCKING = True

    def __init__(self, stages: Sequence[Stage], in_dtype,
                 inst: Optional[TpuInstance] = None):
        super().__init__()
        self.inst = inst or instance()
        self.pipeline = Pipeline(stages, in_dtype)
        self._compiled = None
        self._carry = None
        self._dispatches = 0
        self._pending_ctrl: List[tuple] = []   # ctrl before the first frame
        self.input = self.add_inplace_input("in")
        self.output = self.add_inplace_output("out")

    def extra_metrics(self) -> dict:
        return {"dispatches": self._dispatches}

    @message_handler(name="ctrl")
    async def ctrl_handler(self, io, mio, meta, p):
        try:
            stage, params = parse_ctrl(p)
            if self._carry is None:
                self.pipeline.update_stage(None, stage, _validate_only=True, **params)
                self._pending_ctrl.append((stage, params))
            else:
                self._carry = self.pipeline.update_stage(self._carry, stage, **params)
        except Exception as e:                 # noqa: BLE001 — a bad request
            log.warning("ctrl update rejected: %r", e)
            return Pmt.invalid_value()
        return Pmt.ok()

    def _compile(self, n: int) -> None:
        if n % self.pipeline.frame_multiple:
            raise ValueError(f"frame {n} is not a multiple of "
                             f"{self.pipeline.frame_multiple}")
        self._compiled, self._carry = self.pipeline.compile(n, self.inst.device)
        for stage, params in self._pending_ctrl:
            try:
                self._carry = self.pipeline.update_stage(self._carry, stage, **params)
            except Exception as e:             # noqa: BLE001 — validated only now
                log.warning("queued ctrl update rejected: %r", e)
        self._pending_ctrl.clear()

    async def work(self, io, mio, meta):
        while True:
            item = self.input.get_full()
            if item is None:
                break
            frame, valid, tags = item
            if self._compiled is None:
                self._compile(frame.shape[0])
            self._carry, y = self._compiled(self._carry, frame)
            self._dispatches += 1
            fm = self.pipeline.frame_multiple
            out_valid = self.pipeline.out_items(valid - valid % fm)
            self.output.put_full(y, out_valid,
                                 rebase_frame_tags(tags, self.pipeline, out_valid))
        if self.input.finished() and len(self.input) == 0:
            io.finished = True


class _TagRatio:
    """Rate shim for :func:`rebase_frame_tags` (it reads only ``.ratio``)."""

    __slots__ = ("ratio",)

    def __init__(self, ratio):
        self.ratio = ratio


class TpuMergeStage(Kernel):
    """Device frame fan-in: K in-place inputs (``in0`` … ``in{K-1}``) joined
    into one output by a :class:`MergeStage`, then ``post_stages``.

    * The block waits until every input holds a frame, then joins one frame
      from each.
    * Stream tags ride the primary input ``in0``, rebased through the merge
      and post rates; the other inputs' tags are dropped.
    * EOS as ``blocks.Combine``: once any input is finished and drained, the
      block finishes.

    The merge program runs eagerly (its K inputs are frames of other
    blocks' streams, so there is no one input buffer for a graph to own),
    one call a frame; a ``ctrl`` port addresses ``[merge] + post_stages``
    as :class:`TpuStage`'s does."""

    BLOCKING = True

    def __init__(self, merge: MergeStage, post_stages: Sequence[Stage] = (),
                 inst: Optional[TpuInstance] = None):
        super().__init__()
        if not isinstance(merge, MergeStage):
            raise TypeError(f"TpuMergeStage needs a MergeStage, got {merge!r}")
        self.inst = inst or instance()
        self.merge = merge
        self.post = list(post_stages)
        #: ctrl addressing surface (update_stage reads .stages)
        self.stages = [merge] + self.post
        self._fn = None
        self._carry = None
        self._post_pipe: Optional[Pipeline] = None
        self._tag_ratio = None
        self._dispatches = 0
        self._pending_ctrl: List[tuple] = []
        self.inputs = [self.add_inplace_input(f"in{i}") for i in range(merge.k)]
        self.input = self.inputs[0]
        self.output = self.add_inplace_output("out")

    def extra_metrics(self) -> dict:
        return {"dispatches": self._dispatches}

    # reads only the duck-typed ``.stages``
    update_stage = Pipeline.update_stage

    @message_handler(name="ctrl")
    async def ctrl_handler(self, io, mio, meta, p):
        try:
            stage, params = parse_ctrl(p)
            if self._carry is None:
                self.update_stage(None, stage, _validate_only=True, **params)
                self._pending_ctrl.append((stage, params))
            else:
                self._carry = self.update_stage(self._carry, stage, **params)
        except Exception as e:                 # noqa: BLE001 — a bad request
            log.warning("ctrl update rejected: %r", e)
            return Pmt.invalid_value()
        return Pmt.ok()

    def _compile(self, frames) -> None:
        dts = {_numpy_dtype(f) for f in frames}
        if len(dts) != 1:
            raise ValueError(f"merge inputs disagree on dtype: {dts}")
        in_dt = dts.pop()
        merge, post = self.merge, self.post
        for f in frames:
            if f.shape[0] % merge.frame_multiple:
                raise ValueError(f"merge input frame {f.shape[0]} is not a multiple "
                                 f"of {merge.frame_multiple}")
        mid_dt = np.dtype(merge.out_dtype) if merge.out_dtype is not None else in_dt
        self._post_pipe = Pipeline(list(post), mid_dt, optimize=False)
        self._tag_ratio = _TagRatio(merge.ratio * self._post_pipe.ratio)

        def fn(carries, xs):
            c, v = merge.fn(carries[0], xs)
            new = [c]
            for i, s in enumerate(post):
                c, v = s.fn(carries[1 + i], v)
                new.append(c)
            return tuple(new), v

        self._fn = fn
        dev = torch.device(self.inst.device)
        self._carry = (merge.init_carry(in_dt, dev),) + self._post_pipe.init_carry(dev)
        for stage, params in self._pending_ctrl:
            try:
                self._carry = self.update_stage(self._carry, stage, **params)
            except Exception as e:             # noqa: BLE001 — validated only now
                log.warning("queued ctrl update rejected: %r", e)
        self._pending_ctrl.clear()

    def _out_valid(self, valids, frames) -> int:
        # the merge's own contract first (TpuStage's valid - valid % multiple)
        step = int(np.lcm(self.merge.frame_multiple, self.merge.ratio.denominator))
        if self.merge.mode == "equal":
            # index-aligned joins: the shortest input bounds the output
            n = min(valids) // step * step
        else:
            # concat lays whole frames end to end: a partial input frame has
            # no valid-prefix form, so concat joins emit full frames only
            # (the fused path applies the same rule, DagPipeline.concat_sinks)
            if any(v < f.shape[0] for v, f in zip(valids, frames)):
                return 0
            n = sum(valids) // step * step
        n = int(Fraction(n) * self.merge.ratio)
        pp = self._post_pipe
        return pp.out_items(n - n % pp.frame_multiple)

    async def work(self, io, mio, meta):
        while all(len(p) for p in self.inputs):
            items = [p.get_full() for p in self.inputs]
            frames = tuple(it[0] for it in items)
            valids = [it[1] for it in items]
            if self._fn is None:
                self._compile(frames)
            self._carry, y = self._fn(self._carry, frames)
            self._dispatches += 1
            out_valid = self._out_valid(valids, frames)
            tags = rebase_frame_tags(items[0][2], self._tag_ratio, out_valid)
            self.output.put_full(y, out_valid, tags)
        if any(p.finished() and len(p) == 0 for p in self.inputs):
            io.finished = True


class TpuD2H(Kernel):
    """Device frames → sample stream, the frame plane's one sync point. A
    frame is encoded on the device in the wire format, its parts shipped and
    decoded on the host.
    Read-ahead drain: the D2H of every frame waiting in the queue, up to
    ``read_ahead`` (default the instance's frames in flight), is started
    before the oldest is waited on; ``read_ahead=0`` drains serially (take
    one, wait for it). Frames beyond the bound stay queued, so the
    producer's in-flight gate still parks it."""

    BLOCKING = True

    def __init__(self, dtype, inst: Optional[TpuInstance] = None,
                 read_ahead: Optional[int] = None, wire=None):
        super().__init__()
        self.inst = inst or instance()
        self.wire = resolve_wire(wire, self.inst.device.type)
        self.read_ahead = max(1, read_ahead if read_ahead is not None
                              else self.inst.frames_in_flight)
        self.dtype = np.dtype(dtype)
        self.input = self.add_inplace_input("in")
        self.output = self.add_stream_output("out", dtype)
        self._pending: Optional[np.ndarray] = None
        self._pending_tags: List[ItemTag] = []
        self._inflight = deque()                  # (finish, valid, tags)

    async def work(self, io, mio, meta):
        if self._pending is not None:
            self._pending, self._pending_tags = emit_with_tags(
                self.output, self._pending, self._pending_tags)
            if self._pending is not None:
                return              # downstream full; its consume() wakes us
        while len(self._inflight) < self.read_ahead:
            item = self.input.get_full()
            if item is None:
                break
            frame, valid, tags = item
            self._inflight.append((xfer.start_host_transfer_parts(
                self.wire.encode_torch(frame.reshape(-1))), valid, tags))
        if self._inflight:
            finish, valid, tags = self._inflight.popleft()
            host = self.wire.decode_host(finish(), self.dtype).reshape(-1)[:valid]
            self._pending, self._pending_tags = emit_with_tags(self.output, host, tags)
            finish.release()
            io.call_again = True
            return
        if self.input.finished() and len(self.input) == 0 \
                and self._pending is None and not self._inflight:
            io.finished = True
