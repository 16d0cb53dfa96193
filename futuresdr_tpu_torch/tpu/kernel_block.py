"""TpuKernel: a stage pipeline as one flowgraph block.

The counterpart of ``futuresdr_tpu/tpu/kernel_block.py:TpuKernel``, cut to
its core. Frames go to the device in dispatch groups of K frames
(``frames_per_dispatch``, megabatch K). Each ``work`` call:

1. emits output that did not fit downstream last time;
2. copies full frames out of the input ring into the next rows of the
   current group's pinned staging buffer (``ops/xfer.py``, recycled by the
   arena of ``ops/arena.py``), so each ring slot can be consumed at once; a
   full group starts its H2D on the copy stream, one copy for K frames;
3. replays the compiled program (:meth:`Pipeline.compile`, one CUDA graph
   for the K frames, carry chained) for each staged group and starts the
   result's D2H. The H2D lands in, and the D2H reads, the program's slot
   the group holds, one slot for each group the credits allow in flight,
   so nothing is copied on the card around the replay;
4. drains the oldest group in flight and emits its frames, in order.

At most ``credits`` groups are staged or computing at once: the budget of a
:class:`CreditController`, pinned by an explicit ``frames_in_flight`` or by
config ``tpu_inflight`` > 0, else adaptive around the seed
``tpu_frames_in_flight``. A partial group is zero-padded only at EOS (padding
mid-stream would run the pad through every later frame's carry); the pad
frames' outputs are dropped. A partial last frame is zero-padded to the
frame size and only the outputs of its whole ``frame_multiple`` prefix are
emitted, so the block emits exactly as many items as the JAX ``TpuKernel``
does for the same input. A retune goes through :meth:`apply_retune` →
:meth:`Pipeline.update_stage` between dispatch groups, from another thread
or through the ``ctrl`` message port (``{"stage": …, <param>: …}``, the
reference's grammar, e.g. over the REST control port); the program copies
the changed leaves into its carry buffers before its next replay.

Not in this slice (ROADMAP): wire codecs, carry checkpoint/replay, the
autotuned K and credit seed, the codec worker pool and frame lineage.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, List, Optional, Sequence

import numpy as np

from ..config import config
from ..ops import xfer
from ..ops.stages import Pipeline, Stage
from ..log import logger
from ..runtime.kernel import Kernel, message_handler
from ..runtime.tag import ItemTag, rebase_tags
from ..types import Pmt
from .frames import parse_ctrl
from .instance import TpuInstance, instance

__all__ = ["TpuKernel", "CreditController", "rebase_frame_tags", "emit_with_tags"]

log = logger("tpu.kernel_block")


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


class CreditController:
    """Adaptive in-flight credit budget for the streamed drain loop.

    Replaces the static ``frames_in_flight`` window with runtime credits:
    seeded by the ``autotune_streamed`` pick (or config), BOUNDED
    (``[lo, hi]``) and HYSTERETIC (at most ±1 per observation window, and a
    shrink needs two consecutive slack windows). Signals, all O(1) per
    dispatch, collected by ``TpuKernel._launch_staged``:

    * **grow** — the up-link idled between consecutive dispatch groups'
      modeled wire windows (the ``_wire`` attribute of the H2D finishes —
      populated under a fake/measured link) while the credit budget was the
      binding constraint (staged work waited on a full in-flight window):
      one more credit lets one more frame's wire time ride under compute.
    * **shrink** — the window never came within 2 credits of the budget for
      two consecutive windows and was never credit-limited: the budget is
      oversized; shrink toward what steady state actually uses (each unused
      credit is a frame of latency and device memory for nothing).
    * **rollback** — every grow is a PROBE: the next window's dispatch rate
      must improve by >5% or the grow reverts, and growing backs off
      EXPONENTIALLY on consecutive rollbacks (4, 8, 16 … windows). Wire
      idle that extra credits cannot cure (synchronous CPU compute pacing
      the loop, a genuinely host-bound cycle) — or that is just measurement
      noise on a loaded host — therefore cannot ratchet the budget up and
      hold latency hostage.

    Without a wire-window signal (a real backend with no fake link) the
    controller holds the seed — autotune's measured pick — rather than
    guessing from noise. An EXPLICIT depth (per-kernel ``frames_in_flight``
    argument or config ``tpu_inflight`` > 0) pins the budget entirely:
    ``adaptive=False`` makes every note a no-op, so depth=1 A/B baselines
    keep their strictly-serial contract.

    The port's copy of the reference's controller, word for word; the port
    has no link model, so its H2D finishes carry no wire window and the
    budget only holds or shrinks (and the port has no autotuned seed)."""

    __slots__ = ("credits", "lo", "hi", "adaptive", "window",
                 "_prev_deadline", "_idle_s", "_limited", "_max_seen",
                 "_count", "_slack_windows", "_grow_windows", "_t0",
                 "_probe", "_hold", "_rollbacks")

    def __init__(self, seed: int, adaptive: bool, lo: int = 2,
                 hi: Optional[int] = None, window: int = 16):
        seed = max(1, int(seed))
        self.credits = seed
        self.adaptive = bool(adaptive) and seed > 1
        self.lo = min(lo, seed)
        # headroom is deliberately TIGHT (+2): the seed is autotune's
        # measured pick, adaptation is fine-tuning around it — and on a
        # loaded host, rate noise wins enough probes that a generous cap
        # would ratchet latency up for nothing
        self.hi = seed if not self.adaptive else \
            (hi if hi is not None else min(16, seed + 2))
        self.window = int(window)
        self._prev_deadline = 0.0
        self._idle_s = 0.0
        self._limited = False
        self._max_seen = 0
        self._count = 0
        self._slack_windows = 0
        self._grow_windows = 0       # consecutive idle+limited windows seen
        self._probe = None           # (credits before grow, rate before grow)
        self._hold = 0               # windows to skip growing after a rollback
        self._rollbacks = 0          # consecutive rollbacks (backoff exponent)
        self._t0 = time.perf_counter()

    def note_dispatch(self, wire: Optional[tuple], inflight: int) -> None:
        """One dispatch group launched: fold in its H2D wire window and the
        in-flight occupancy after the launch."""
        if not self.adaptive:
            return
        if wire:
            service, deadline = wire
            if deadline:
                if self._prev_deadline and service > self._prev_deadline:
                    self._idle_s += service - self._prev_deadline
                if deadline > self._prev_deadline:
                    self._prev_deadline = deadline
        if inflight > self._max_seen:
            self._max_seen = inflight
        self._count += 1
        if self._count >= self.window:
            self._tick()

    def note_limited(self) -> None:
        """Staged work is waiting because the in-flight window is full."""
        if self.adaptive:
            self._limited = True

    def _tick(self) -> None:
        span = max(time.perf_counter() - self._t0, 1e-9)
        rate = self._count / span          # dispatch groups per second
        if self._probe is not None:
            # last window grew the budget as a probe: keep it only if the
            # dispatch rate CLEARLY improved (>5% — under that, host-load
            # noise wins more probes than real wins do) — idle the extra
            # credit cannot cure must not ratchet the budget (and its
            # latency) up; consecutive rollbacks back off exponentially
            prev_credits, prev_rate = self._probe
            self._probe = None
            if rate < prev_rate * 1.05:
                self.credits = prev_credits
                self._hold = min(32, 4 << self._rollbacks)
                self._rollbacks += 1
            else:
                self._rollbacks = 0
        if self._hold > 0:
            self._hold -= 1
            self._grow_windows = 0
        elif self._limited and self._idle_s > 0.02 * span \
                and self.credits < self.hi:
            # hysteresis on the grow side too: one noisy window must not
            # trigger a probe (each probe costs a window at the new budget)
            self._grow_windows += 1
            if self._grow_windows >= 2:
                self._probe = (self.credits, rate)
                self.credits += 1
                self._grow_windows = 0
            self._slack_windows = 0
        elif not self._limited and self._max_seen <= self.credits - 2:
            self._grow_windows = 0
            self._slack_windows += 1
            if self._slack_windows >= 2 and self.credits > self.lo:
                self.credits -= 1
                self._slack_windows = 0
        else:
            self._slack_windows = 0
            self._grow_windows = 0
        self._count = 0
        self._idle_s = 0.0
        self._limited = False
        self._max_seen = 0
        self._t0 = time.perf_counter()


class TpuKernel(Kernel):
    """Runs ``Pipeline(stages, in_dtype)`` over the stream on
    ``inst.device``, ``frames_per_dispatch`` frames a dispatch (default
    config ``tpu_frames_per_dispatch``; 0 means 1)."""

    BLOCKING = True

    def __init__(self, stages: Sequence[Stage], in_dtype,
                 frame_size: Optional[int] = None,
                 inst: Optional[TpuInstance] = None,
                 frames_in_flight: Optional[int] = None,
                 frames_per_dispatch: Optional[int] = None):
        super().__init__()
        self.inst = inst or instance()
        self.pipeline = Pipeline(stages, in_dtype)
        fs = frame_size or self.inst.frame_size
        m = self.pipeline.frame_multiple
        self.frame_size = max(m, (fs // m) * m)
        self.out_frame = self.pipeline.out_items(self.frame_size)
        self.k_batch = max(1, int(frames_per_dispatch or config().tpu_frames_per_dispatch))
        self.depth = max(1, int(frames_in_flight or self.inst.frames_in_flight))
        adaptive = frames_in_flight is None
        if adaptive and config().tpu_inflight > 0:
            self.depth, adaptive = int(config().tpu_inflight), False
        self._credits = CreditController(self.depth, adaptive=adaptive)
        self._fn = None               # the compiled program, built in init
        self._carry = None
        # serializes the carry between this block's thread and apply_retune
        self._carry_lock = threading.Lock()
        # the group being filled: its [K, frame] host buffer and one
        # (valid_in, frame tags) per real frame in it
        self._group: Optional[xfer.HostBuffer] = None
        self._accum: List[tuple] = []
        # the program's slots no group holds: a group takes one at its H2D
        # and frees it once its D2H has landed and been emitted
        self._free_slots: Deque[int] = deque()
        # H2D started: (finish, metas, slot)
        self._staged: Deque[tuple] = deque()
        # replayed, D2H riding: (finish, one (valid_out, rebased tags) a
        # frame, slot)
        self._inflight: Deque[tuple] = deque()
        self._pending_out: Optional[np.ndarray] = None
        self._pending_tags: List[ItemTag] = []
        self.frames_dispatched = 0
        self.input = self.add_stream_input("in", in_dtype, min_items=self.frame_size)
        self.output = self.add_stream_output(
            "out", self.pipeline.out_dtype, min_items=self.out_frame,
            min_buffer_size=(self.depth * self.k_batch + 1) * self.out_frame *
            np.dtype(self.pipeline.out_dtype).itemsize)

    async def init(self, mio, meta):
        self._staged.clear()
        self._inflight.clear()
        if self._group is not None:
            self._group.release()
        self._group, self._accum = None, []
        self._free_slots = deque(range(self._credits.hi))
        self._pending_out, self._pending_tags = None, []
        with self._carry_lock:
            if self._fn is None:
                # the warm-up (kernel builds, library plans, lazy tables) and
                # the capture happen here, off the hot path; one input and
                # output slot for each group the credits may keep in flight
                self._fn, self._carry = self.pipeline.compile(
                    self.frame_size, self.inst.device, k=self.k_batch,
                    slots=self._credits.hi)
            else:
                # a re-run starts from a fresh carry, which the program copies
                # into its buffers at the first dispatch
                self._carry = self.pipeline.init_carry(self.inst.device)
            self.frames_dispatched = 0

    @message_handler(name="ctrl")
    async def ctrl_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        """Runtime stage control: ``{"stage": <name-or-index>, <param>:
        <value>, …}`` lands in :meth:`apply_retune` and is answered
        ``Pmt.ok()`` once the surgery is done; frames already dispatched
        keep the old values. Malformed input, an unknown stage or parameter
        and a message before ``init`` are answered ``Pmt.invalid_value()``
        (the runtime's init barrier answers pre-init calls itself)."""
        try:
            stage, params = parse_ctrl(p)
            if "interior_precision" in params:
                log.warning("ctrl %r: interior-precision retunes wait for ROADMAP "
                            "Queue 1 item 7 (precision and tuning)", p)
                return Pmt.invalid_value()
            self.apply_retune(stage, **params)
        except Exception as e:                 # noqa: BLE001 — a bad request
            log.warning("ctrl update rejected: %r", e)
            return Pmt.invalid_value()
        return Pmt.ok()

    def apply_retune(self, stage, **params) -> int:
        """Carry surgery between dispatch groups (the reference's retune
        entry point), e.g. ``apply_retune(0, taps=new_taps)``: frames
        already dispatched keep the old parameters, every later frame sees
        the new ones. Safe to call from another thread while the flowgraph
        runs. Returns the number of frames dispatched before the surgery,
        i.e. the first frame that sees it."""
        with self._carry_lock:
            if self._carry is None:
                raise RuntimeError("retune before init")
            self._carry = self.pipeline.update_stage(self._carry, stage, **params)
            return self.frames_dispatched

    def _stage(self, frame: np.ndarray, valid_in: int, tags) -> None:
        """Copy one frame (a full one, or the zero-padded EOS tail) out of the
        ring into the next row of the group's staging buffer, so the caller
        may consume it at once; a full group ships."""
        if self._group is None:
            self._group = xfer.host_buffer((self.k_batch, self.frame_size),
                                           self.pipeline.in_dtype, self.inst.device)
        row = self._group.array[len(self._accum)]
        n = len(frame)
        row[:n] = frame
        row[n:] = 0
        self._accum.append((valid_in, tuple(tags)))
        if len(self._accum) == self.k_batch:
            self._flush_accum()

    def _flush_accum(self) -> None:
        """Start the group's H2D into a free slot of the program, one copy
        for its K frames. The rows of a partial group (EOS only) past its
        last frame are zeroed; their outputs are dropped at drain."""
        group, metas = self._group, tuple(self._accum)
        self._group, self._accum = None, []
        group.array[len(metas):] = 0
        slot = self._free_slots.popleft()
        self._staged.append((xfer.start_device_transfer_parts(
            group, self.inst.device, out=self._fn.inputs[slot]), metas, slot))

    def _stage_available_input(self):
        """Stage every full frame the credits allow, and the zero-padded tail
        frame and the partial group at EOS; returns ``(remaining input
        slice, eos)``."""
        budget = self._credits.credits
        inp = self.input.slice()
        while len(self._staged) + len(self._inflight) < budget and \
                len(inp) >= self.frame_size:
            self._stage(inp[:self.frame_size], self.frame_size,
                        self.input.tags(self.frame_size))
            self.input.consume(self.frame_size)
            inp = self.input.slice()
        eos = self.input.finished()
        if eos and 0 < len(inp) < self.frame_size and \
                len(self._staged) + len(self._inflight) < budget:
            n = len(inp)
            # items past the last frame_multiple boundary cannot give whole
            # outputs and are dropped at EOS (the streaming frame contract)
            self._stage(inp, n - n % self.pipeline.frame_multiple, self.input.tags(n))
            self.input.consume(n)
            inp = self.input.slice()
        if eos and self._accum and len(inp) == 0:
            self._flush_accum()
        return inp, eos

    def _launch_staged(self) -> None:
        """Replay the program for each staged group (oldest first) and start
        its D2H, within the credit budget."""
        while self._staged and len(self._inflight) < self._credits.credits:
            finish, metas, slot = self._staged.popleft()
            finish()                    # the replay waits for the H2D
            with self._carry_lock:
                self._carry, y = self._fn.dispatch(slot, self._carry)
                self.frames_dispatched += len(metas)
            out_metas = []
            for valid_in, tags in metas:
                valid_out = min(self.pipeline.out_items(valid_in), self.out_frame)
                out_metas.append((valid_out, rebase_frame_tags(tags, self.pipeline,
                                                               valid_out)))
            self._inflight.append((xfer.start_host_transfer(y), out_metas, slot))
            self._credits.note_dispatch(None, len(self._inflight))
        if self._staged and len(self._inflight) >= self._credits.credits:
            self._credits.note_limited()

    def _drain_one(self) -> None:
        """Emit the oldest group's frames. Every frame but a group's last
        real one is whole, so their valid outputs are one prefix of the
        group's flattened ``[K, out]`` result."""
        finish, out_metas, slot = self._inflight.popleft()
        flat = finish().reshape(-1)
        tags = [ItemTag(t.index + i * self.out_frame, t.tag)
                for i, (_, ts) in enumerate(out_metas) for t in ts]
        self._pending_out, self._pending_tags = emit_with_tags(
            self.output, flat[:sum(v for v, _ in out_metas)], tags)
        finish.release()
        self._free_slots.append(slot)

    async def work(self, io, mio, meta):
        # 1. flush output that did not fit last time
        if self._pending_out is not None:
            self._pending_out, self._pending_tags = emit_with_tags(
                self.output, self._pending_out, self._pending_tags)
            if self._pending_out is not None:
                return  # downstream full; its consume() wakes us

        # 2. stage input (each full group's H2D starts now), 3. replay and
        #    start the D2H
        inp, eos = self._stage_available_input()
        self._launch_staged()

        # 4. drain the oldest group: when the credits are used up, when no
        #    full frame waits (flush for latency), or at EOS
        if self._inflight and (len(self._inflight) >= self._credits.credits
                               or len(inp) < self.frame_size or eos):
            self._drain_one()
            io.call_again = True
            return

        if eos and not self._inflight and not self._staged and not self._accum and \
                self._pending_out is None and len(inp) == 0:
            io.finished = True
