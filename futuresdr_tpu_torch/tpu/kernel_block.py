"""TpuKernel: a stage pipeline as one flowgraph block.

The counterpart of ``futuresdr_tpu/tpu/kernel_block.py:TpuKernel``. Frames go
to the device in dispatch groups of K frames (``frames_per_dispatch``,
megabatch K), encoded in a wire format (``wire``, ``ops/wire.py``: f32,
bf16, sc16 or sc8; ``None`` reads config ``tpu_wire_format``, whose ``auto``
is f32 on the CPU and sc16 on a card). Each ``work`` call:

1. emits output that did not fit downstream last time;
2. encodes full frames out of the input ring into the rows of the current
   group's parts in the staging arena (``ops/arena.py``, pinned on a card;
   for the f32 wire the encode is the ring-exit copy itself), so each ring
   slot can be consumed at once; a full group starts its H2D on the copy
   stream (``ops/xfer.py``): one copy a part, or one for the whole group
   when the parts are packed (``tpu_coalesce``, :class:`~futuresdr_tpu_torch.ops.xfer.PackedLayout`);
3. replays the compiled wired program (:meth:`Pipeline.compile` with the
   wire: one CUDA graph for the K frames, carry chained, the wire's decode
   in front and its encode behind, a packed group unpacked inside it) for
   each staged group and starts the D2H of the output's parts. The H2D
   lands in, and the D2H reads, the program's slot the group holds, one
   slot for each group the credits and ``stage_ahead`` allow, so nothing is
   copied on the card around the replay;
4. lands the oldest group in flight, decodes it on the host and emits its
   frames, in order.

The host codec can ride a worker pool (``ops/codec_pool.py``,
``host_codec_workers``): a wire whose encode aliases the frame (f32) starts
its H2D on an encode worker after the ring-exit copy; a quantizing wire at K
= 1 encodes on a worker straight out of the ring slot, ``consume()``
deferred until the worker has read it (``tpu_deferred_consume``); every
group's landing and host decode runs on a decode worker. A frame of a
registered read-only buffer (``ops/ingest.py``) skips the ring-exit copy on
an aliasing wire at K = 1 (``tpu_zero_copy_ingest``).

At most ``credits`` groups are in flight (computing or landing), and
``stage_ahead`` more may be staged: the budget of a
:class:`CreditController`, pinned by an explicit ``frames_in_flight`` or by
config ``tpu_inflight`` > 0, else adaptive around the seed
``tpu_frames_in_flight``. A partial group is zero-padded only at EOS
(padding mid-stream would run the pad through every later frame's carry);
the pad frames' outputs are dropped. A partial last frame is zero-padded to
the frame size before its encode and only the outputs of its whole
``frame_multiple`` prefix are emitted, so the block emits exactly as many
items as the JAX ``TpuKernel`` does for the same input. A retune goes
through :meth:`apply_retune` → :meth:`Pipeline.update_stage` between
dispatch groups, from another thread or through the ``ctrl`` message port
(``{"stage": …, <param>: …}``, the reference's grammar, e.g. over the REST
control port); the program copies the changed leaves into its carry buffers
before its next replay.

A wire switch (:meth:`apply_wire_retune`, or the :class:`WireController`
under ``tpu_adaptive_wire``) lands at the next quiescent group boundary:
staging pauses until nothing is staged or in flight, then the kernel takes
the new wire's program, one a (wire, layout), cached, all sharing one set of
static carry buffers, so the state carries over with no copy and switching
back to a wire used before captures nothing.

Faults: the ``dispatch`` site of ``runtime/faults.py`` is checked before
each replay, the transfer sites inside the transfers' retries, the ``carry``
site at a checkpoint's commit. What a fault that is not retried does is the
block's failure policy (``runtime/block.py``).

Recovery (the ``restart`` policy): the program is a function of (carry,
frames) alone, so a restart need not lose the groups in flight. Every
``checkpoint_every`` groups (config ``tpu_checkpoint_every``, 1) the kernel
copies its carry to the host right behind the replay that wrote it, on the
compute stream (:meth:`Pipeline.snapshot_carry`: a later replay overwrites
the static carry buffers, so the copy must be in stream order), and commits
it once that group's outputs have drained; the two newest commits are kept.
Every shipped group's host parts (the arena rows, a packed buffer, a
registered ingest buffer's views; a deferred encode's payload, never the
ring slot) stay in a replay log, their buffers retained, until a committed
checkpoint covers them. :meth:`recover` restores the newest valid
checkpoint (its structure, shapes and dtypes; a corrupted one falls back to
the older) through the program's ``_load`` into the very static buffers the
kernels read and write (no new capture), then re-ships the logged groups
after it through the same programs, under the normal in-flight budget: the
output is the unfailed run's bit for bit. Groups whose outputs had already
been emitted replay for their carry only. Retunes and wire switches are
logged against the group they first reached and applied again there; a
retune that lands inside a replay window waits for its end
(:meth:`warn_retune_in_replay`). With ``checkpoint_dir`` set each commit is
also written to disk (``utils/snapshot.py``) and a new process's kernel
resumes from it. Checkpointing runs only where a restart can use it (an
explicit ``checkpoint_every=``, a ``restart`` policy on the kernel or in the
config, a restartable fused chain): a default run pays one falsy check a
dispatch. Recovery covers injected faults and errors that leave the CUDA
context usable; CUDA's sticky errors stay fatal (:meth:`recover` declines
them), and a fresh ``init`` then forfeits the window, counted
(``fsdr_frames_forfeited_total`` in :meth:`extra_metrics`, beside
``fsdr_frames_replayed_total``).

:class:`TpuFanoutKernel` and :class:`TpuDagKernel` run a
:class:`~futuresdr_tpu_torch.ops.stages.FanoutPipeline` or
:class:`~futuresdr_tpu_torch.ops.stages.DagPipeline` the same way, one output
port a branch or sink: the staging, K, credits, slots and wire are
:class:`TpuKernel`'s, and only the result side (a D2H of a branch's parts,
the landing, the emit and the tag rebase) works a branch at a time. The
device-chain pass (``runtime/devchain.py``) builds them, and fused linear
chains as plain :class:`TpuKernel`s; their recovery is :class:`TpuKernel`'s
over the flat composed carry.

Precision and tuning (``ops/precision.py``, ``tpu/autotune.py``): with
``interior_precision`` (default config ``interior_precision``, ``off``) the
pipeline is replaced by its SNR-budgeted lowering at construction, and the
``ctrl`` message ``{"stage": …, "interior_precision": mode}`` re-plans one
stage (:meth:`apply_precision_retune`), landing at the next quiescent
group boundary like a wire switch. The streamed-pick cache seeds the credit
budget (its ``inflight``), the adaptive wire's start (``wire``), and the
hand kernels' plans (``pallas_blocks``, installed at construction); each
init records the applied precision mode there.

Not in this slice (ROADMAP): frame lineage.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Deque, List, Optional, Sequence

import numpy as np

from ..config import config
from ..ops import codec_pool as _codec_mod
from ..ops import ingest as _ingest_mod
from ..ops import xfer
from ..ops.arena import ArenaBuffer, GroupAlloc, PackedAlloc, StagingArena, arena
from ..ops.stages import Pipeline, Stage
from ..ops.wire import WIRE_FORMATS, get_wire, resolve_wire
from ..log import logger
from ..runtime import faults as _faults
from ..runtime.kernel import Kernel, message_handler
from ..runtime.tag import ItemTag
from ..types import Pmt
from ..utils import snapshot as _snapshot
from .frames import emit_with_tags, parse_ctrl, rebase_frame_tags
from .instance import TpuInstance, instance

__all__ = ["TpuKernel", "TpuFanoutKernel", "TpuDagKernel", "CreditController",
           "WireController", "rebase_frame_tags", "emit_with_tags"]

log = logger("tpu.kernel_block")


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


class WireController:
    """Mid-stream adaptive wire-format policy (opt-in: ``tpu_adaptive_wire``).

    Sits next to :class:`CreditController` in the drain loop and watches two
    live signals, both O(1) amortized per dispatch group:

    * **signal quality** — a strided sample of each staged frame's float
      components (peak + mean power). From it the controller PREDICTS the
      quantization SNR each ladder format would give the current signal:
      a uniform quantizer with step ``Δ = peak/qmax`` contributes
      ``Δ²/12`` noise power, so ``snr = p_mean / (Δ²/12)`` — the same
      model ``ops/wire.measure_snr_db`` verifies empirically.
    * **link occupancy** — the modeled wire windows the transfer plane
      attaches to each H2D finish (``_wire = (start, deadline)``, populated
      under a fake/measured link): the busy fraction of the inter-dispatch
      span. No wire signal (a real backend with no link model) reads as
      idle, so the controller can only ever WIDEN there — it will not
      chase throughput it cannot observe.

    Decisions are HYSTERETIC, mirroring the credit controller: windowed
    (``window`` dispatch groups per evaluation), two consecutive windows
    must agree before a switch is proposed, and a holdoff follows every
    switch so the ladder cannot oscillate. The policy:

    * WIDEN (toward f32) when the ACTIVE format's predicted SNR falls
      below the budget — the signal's dynamic range outgrew the wire.
    * NARROW (toward sc8) only when the link is BUSY (occupancy above
      ``occupancy_bar``) and the narrower format's predicted SNR clears
      the budget plus a safety margin — bytes are the bottleneck and the
      signal has headroom to spare.

    The controller only PROPOSES; the kernel applies the switch at a
    quiescent dispatch-group boundary (``_maybe_switch_wire``) so no
    in-flight frame ever spans two programs.

    The port's copy of the reference's controller, word for word; the port
    has no link model, so without a fake link the occupancy reads idle and
    the controller only widens."""

    LADDER = ("f32", "sc16", "sc8")      # widest → narrowest
    QMAX = {"sc16": 32767.0, "sc8": 127.0}

    __slots__ = ("budget_db", "margin_db", "window", "holdoff",
                 "occupancy_bar", "_peak", "_power", "_nstat", "_busy_s",
                 "_count", "_vote", "_votes", "_hold", "_t0",
                 "last_snr_db")

    def __init__(self, budget_db: float, window: int = 16,
                 holdoff: int = 4, margin_db: float = 6.0,
                 occupancy_bar: float = 0.92):
        self.budget_db = float(budget_db)
        self.margin_db = float(margin_db)
        self.window = int(window)
        self.holdoff = int(holdoff)           # windows muted after a switch
        self.occupancy_bar = float(occupancy_bar)
        self.reset()

    def reset(self) -> None:
        self._peak = 0.0
        self._power = 0.0
        self._nstat = 0
        self._busy_s = 0.0
        self._count = 0
        self._vote = None            # format the current streak argues for
        self._votes = 0              # consecutive windows agreeing on it
        self._hold = 0
        self._t0 = time.perf_counter()
        self.last_snr_db = float("inf")   # the deciding window's active SNR

    # -- signal feeds --------------------------------------------------------
    def observe_frame(self, frame: np.ndarray) -> None:
        """Fold a strided sample of one staged frame's float components
        (≤512 points — the stats cost must vanish next to the encode)."""
        x = np.asarray(frame)
        if x.dtype.kind == "c":
            x = x.view(np.float64 if x.dtype == np.complex128
                       else np.float32)
        elif x.dtype.kind != "f":
            return                   # int passthrough: no quantization story
        x = x.reshape(-1)
        if not x.size:
            return
        s = np.abs(x[::max(1, x.size // 512)].astype(np.float32))
        peak = float(s.max())
        if peak > self._peak:
            self._peak = peak
        self._power += float(np.mean(np.square(s)))
        self._nstat += 1

    def note_dispatch(self, wire: Optional[tuple]) -> None:
        """Fold one dispatch group's H2D wire window (same tuple the credit
        controller reads)."""
        if wire:
            start, deadline = wire
            if deadline and deadline > start:
                self._busy_s += deadline - start
        self._count += 1

    # -- prediction ----------------------------------------------------------
    def predicted_snr_db(self, fmt: str) -> float:
        """The windowed signal's predicted SNR under ``fmt`` (inf for exact
        formats or when no stats accumulated)."""
        qmax = self.QMAX.get(fmt)
        if qmax is None or self._nstat == 0 or self._peak <= 0.0:
            return float("inf")
        p_mean = self._power / self._nstat
        if p_mean <= 0.0:
            return float("inf")
        delta = self._peak / qmax
        return 10.0 * float(np.log10(p_mean / (delta * delta / 12.0)))

    # -- decision ------------------------------------------------------------
    def propose(self, current: str) -> Optional[str]:
        """Evaluate at window boundaries; the target format after two
        agreeing windows, else None. Callers apply the switch themselves
        (at a quiescent boundary) — a returned proposal arms the holdoff."""
        if self._count < self.window or current not in self.LADDER:
            return None
        span = max(time.perf_counter() - self._t0, 1e-9)
        occupancy = min(1.0, self._busy_s / span)
        want = None
        pos = self.LADDER.index(current)
        self.last_snr_db = self.predicted_snr_db(current)
        if self.last_snr_db < self.budget_db and pos > 0:
            want = self.LADDER[pos - 1]                  # widen
        elif occupancy >= self.occupancy_bar and pos + 1 < len(self.LADDER) \
                and self.predicted_snr_db(self.LADDER[pos + 1]) \
                >= self.budget_db + self.margin_db:
            want = self.LADDER[pos + 1]                  # narrow
        # window bookkeeping (stats are per-window, votes persist across)
        self._peak = 0.0
        self._power = 0.0
        self._nstat = 0
        self._busy_s = 0.0
        self._count = 0
        self._t0 = time.perf_counter()
        if self._hold > 0:
            self._hold -= 1
            self._vote, self._votes = None, 0
            return None
        if want is None or want != self._vote:
            self._vote, self._votes = want, (1 if want else 0)
            return None
        self._votes += 1
        if self._votes < 2:
            return None
        self._vote, self._votes = None, 0
        self._hold = self.holdoff
        return want


class _Group:
    """One dispatch group being filled: the arena allocation (``alloc``) of
    its parts, ``dests`` (one array a part, ``[K, …]`` at K > 1, the rows
    the frames' encodes write), or ``parts`` already final (a zero-copy
    frame's views of its registered buffer), one ``(valid_in, tags)`` a real
    frame, the ingest handles it holds until it drains, and the frames whose
    encode waits for a codec worker (``(row, frame, event)``)."""

    __slots__ = ("alloc", "dests", "parts", "metas", "held", "deferred")

    def __init__(self, alloc, dests, parts=None):
        self.alloc = alloc
        self.dests = dests
        self.parts = parts
        self.metas: List[tuple] = []
        self.held: List = []
        self.deferred: List[tuple] = []


class _RowAlloc:
    """``Wire.encode_into``'s allocator for row ``i`` of a group: a payload
    request lands in that row of the part whose frame shape and dtype it
    asks for, so the encode writes the group's buffer directly; temps come
    from the group's allocation."""

    __slots__ = ("_group", "_row", "_k", "_taken")

    def __init__(self, group: _Group, row: int, k: int):
        self._group, self._row, self._k = group, row, k
        self._taken = set()

    def __call__(self, shape, dtype) -> np.ndarray:
        sh = (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(shape)
        dt = np.dtype(dtype)
        for j, d in enumerate(self._group.dests):
            if j in self._taken:
                continue
            row = d[self._row, ...] if self._k > 1 else d
            if row.shape == sh and row.dtype == dt:
                self._taken.add(j)
                return row
        return self._group.alloc.temp(sh, dt)

    def temp(self, shape, dtype) -> np.ndarray:
        return self._group.alloc.temp(shape, dtype)

    def drop_temps(self) -> None:
        self._group.alloc.drop_temps()


class _Dispatch:
    """One shipped dispatch group from its H2D to its drain: the H2D's
    ``get_fin``, one ``(valid_in, tags)`` a real frame, the program slot it
    holds and the program (``fn``) and ``wire`` it was shipped under, the
    ingest handles it holds, its sequence number, ``drop`` for a replayed
    group whose outputs were emitted before the fault (it replays for the
    carry only), and once replayed its ``land`` and ``out_metas``."""

    __slots__ = ("get_fin", "metas", "slot", "held", "seq", "drop", "fn", "wire",
                 "land", "out_metas")

    def __init__(self, get_fin, metas, slot, held, seq, drop, fn, wire):
        self.get_fin = get_fin
        self.metas = metas
        self.slot = slot
        self.held = held
        self.seq = seq
        self.drop = drop
        self.fn = fn
        self.wire = wire
        self.land = None
        self.out_metas = None


#: CUDA's sticky errors (``ops/xfer.py``): the context is lost and nothing
#: in the process can recover on it
_STICKY = xfer._FATAL_MARKERS


class TpuKernel(Kernel):
    """Runs ``Pipeline(stages, in_dtype)`` over the stream on
    ``inst.device``, ``frames_per_dispatch`` frames a dispatch (default
    config ``tpu_frames_per_dispatch``; 0 means 1), across the link in
    ``wire``'s format, with a carry checkpoint every ``checkpoint_every``
    dispatch groups (default config ``tpu_checkpoint_every``, taken only
    where a restart can use it; an explicit value always is)."""

    BLOCKING = True

    def __init__(self, stages: Sequence[Stage], in_dtype,
                 frame_size: Optional[int] = None,
                 inst: Optional[TpuInstance] = None,
                 frames_in_flight: Optional[int] = None,
                 frames_per_dispatch: Optional[int] = None, wire=None,
                 checkpoint_every: Optional[int] = None,
                 interior_precision: Optional[str] = None, _pipeline=None):
        super().__init__()
        self.inst = inst or instance()
        # ``_pipeline``: a pipeline built already (the device-chain pass's
        # composed chain, or a fan-out/DAG pipeline of the subclasses)
        self.pipeline = _pipeline if _pipeline is not None else Pipeline(stages, in_dtype)
        self._apply_interior_precision(interior_precision)
        self._apply_pallas_blocks()
        fs = frame_size or self.inst.frame_size
        m = self.pipeline.frame_multiple
        self.frame_size = max(m, (fs // m) * m)
        self.out_frame = self.pipeline.out_items(self.frame_size)
        self.k_batch = max(1, int(frames_per_dispatch or config().tpu_frames_per_dispatch))
        # an explicit K (even 1) is not replaced by a fused region's cached pick
        self._k_explicit = frames_per_dispatch is not None
        self.depth = max(1, int(frames_in_flight or self.inst.frames_in_flight))
        self._depth_explicit = frames_in_flight is not None
        # the codec on both link crossings: decode and encode run inside the
        # compiled program, the host halves in _stage and _decode_group
        self.wire = resolve_wire(wire, self.inst.device.type)
        self._init_hostpath()
        self._fn = None               # the current wire's program, built in init
        self._programs: dict = {}     # (wire, layout) -> program, sharing one carry
        self._carry = None
        # serializes the carry between this block's thread and apply_retune
        self._carry_lock = threading.Lock()
        self._group: Optional[_Group] = None   # the group being filled
        # the program's slots no group holds: a group takes one at its H2D
        # and frees it once its D2H has landed and been emitted
        self._free_slots: Deque[int] = deque()
        # H2D started, then (popped under the carry lock) replayed with its
        # D2H riding: one _Dispatch each
        self._staged: Deque[_Dispatch] = deque()
        self._inflight: Deque[_Dispatch] = deque()
        self._pending_out: Optional[np.ndarray] = None
        self._pending_tags: List[ItemTag] = []
        self.frames_dispatched = 0
        self.dispatches = 0           # program replays (one a dispatch group)
        self._init_recovery_state(checkpoint_every)
        self.input = self.add_stream_input("in", self.pipeline.in_dtype,
                                           min_items=self.frame_size)
        self._add_outputs()

    # -- precision and tuning --------------------------------------------------
    def _sig(self, pipeline=None):
        """The streamed-pick cache's key object of this kernel's chain."""
        p = pipeline if pipeline is not None else self.pipeline
        return p if getattr(p, "n_branches", 0) else p.stages

    def _apply_interior_precision(self, interior_precision=None) -> None:
        """Replace the pipeline by its interior-precision lowering
        (``ops/precision.py``), calibrated on this kernel's device before
        anything derives from the pipeline; ``off`` (the default) keeps the
        pipeline object. A calibration that fails leaves the float32
        pipeline, with a warning."""
        from ..ops import precision as _precision
        self._base_pipeline = self.pipeline
        self._precision_mode = str(interior_precision if interior_precision is not None
                                   else config().interior_precision or "off")
        self._precision_overrides: dict = {}
        self._precision_plan = None
        self._precision_switch = None          # (pipeline, plan, mode) pending
        self.precision_switches = 0
        if self._precision_mode in ("", "off"):
            self._precision_mode = "off"
            return
        self._precision_overrides = _precision.parse_overrides(
            config().interior_precision_overrides)
        try:
            self.pipeline, self._precision_plan = _precision.plan_interior_precision(
                self.pipeline, mode=self._precision_mode,
                overrides=self._precision_overrides, device=self.inst.device)
        except (RuntimeError, ValueError) as e:
            log.warning("%s: interior-precision lowering failed (%r): staying float32",
                        type(self).__name__, e)
            self.pipeline, self._precision_plan = self._base_pipeline, None

    def _apply_pallas_blocks(self) -> None:
        """Install the kernel plans a sweep recorded for this chain on this
        card (the cache's ``pallas_blocks`` axis), before anything compiles;
        with none recorded the plans stay the rules' (or what is installed)."""
        from ..ops.cuda_kernels import set_tuned_plans
        from .autotune import cached_pallas_blocks, platform_of
        from .kernel_tune import device_key
        plans = cached_pallas_blocks(self._sig(), self.pipeline.in_dtype,
                                     platform_of(self.inst), device_key(self.inst.device))
        if plans:
            set_tuned_plans(plans)
            log.info("%s: kernel plans from the cached sweep: %s", type(self).__name__,
                     sorted(plans))

    def _note_precision(self) -> None:
        """Publish the applied plan under this kernel's name and record the
        applied mode in the cache (an off kernel only corrects an existing
        stamp, it creates no entry)."""
        from ..ops import precision as _precision
        from .autotune import cached_interior_precision, platform_of, \
            record_interior_precision
        name = self.meta.instance_name or type(self).__name__
        if self._precision_plan is not None:
            _precision.note_plan(name, self._precision_plan)
        sig, plat = self._sig(self._base_pipeline), platform_of(self.inst)
        mode = self._precision_mode
        if mode != "off" or cached_interior_precision(
                sig, self.pipeline.in_dtype, plat) is not None:
            record_interior_precision(sig, self.pipeline.in_dtype, plat, mode)

    def apply_precision_retune(self, stage, precision) -> None:
        """Re-plan one stage's interior precision (the ``ctrl`` verb
        ``{"stage": <name or index>, "interior_precision": off|auto|bf16|int8}``)
        from the pristine pipeline with the stage pinned; on an ``off``
        kernel every other stage is pinned ``off``, so only the named one
        changes. A program change: before ``init`` it replaces the pipeline;
        after, it lands at the next quiescent group boundary
        (:meth:`_apply_precision_program`). A retune that changes nothing
        keeps the program. Raises on an unknown mode, stage or an ambiguous
        name (overrides are keyed by name)."""
        from ..ops import precision as _precision
        prec = str(precision)
        if prec not in _precision.MODES:
            raise ValueError(f"interior_precision retune {prec!r}: expected "
                             f"off|auto|bf16|int8")
        base = self._base_pipeline
        names = [s.name for s in base.stages]
        if isinstance(stage, str):
            if stage not in names:
                raise KeyError(f"no stage named {stage!r} in {names}")
            name = stage
        else:
            idx = int(stage)
            if not 0 <= idx < len(names):
                raise KeyError(f"stage index {idx} out of range ({len(names)} stages)")
            name = names[idx]
        if names.count(name) > 1:
            raise KeyError(f"stage name {name!r} is ambiguous (appears "
                           f"{names.count(name)}x): overrides are keyed by name")
        with self._carry_lock:
            overrides = dict(self._precision_overrides)
            if self._precision_mode == "off":
                for n in names:
                    overrides.setdefault(n, "off")
            overrides[name] = prec
            mode = self._precision_mode if self._precision_mode != "off" else "auto"
            new_pipe, plan = _precision.plan_interior_precision(
                base, mode=mode, overrides=overrides, device=self.inst.device)
            self._precision_overrides = overrides
            if new_pipe.frame_multiple != self.pipeline.frame_multiple:
                raise ValueError("a lowering must keep the pipeline's frame multiple")
            if new_pipe is self.pipeline:
                log.info("%s: interior precision %s=%s changes nothing",
                         self.meta.instance_name or type(self).__name__, name, prec)
                self._precision_switch = None
                return
            if self._fn is None:
                self.pipeline, self._precision_plan = new_pipe, plan
                self._precision_mode = mode
                return
            self._precision_switch = (new_pipe, plan, mode)

    def _apply_precision_program(self) -> None:
        """Take a pending precision retune at a quiescent boundary: capture
        the new pipeline's program (its own static carry buffers; a new
        incarnation's program cache), carry the live state over leaf by
        leaf (a narrowing leaf cast from the old value, a widening one taken
        from the pristine parameters, so a float32 program never carries
        frozen bf16 values), and, with checkpoints on, commit the converted
        carry as the only restore point: a checkpoint holds a lowered
        carry's dtypes, and one of the old program would not fit."""
        pipe, plan, mode = self._precision_switch
        self._precision_switch = None
        from ..ops.stages import _leaves, _rebuild
        template = pipe.init_carry(self.inst.device)
        old, tmpl = _leaves(self._carry), _leaves(template)
        widened = 0
        if len(old) == len(tmpl) and all(a.shape == b.shape for a, b in zip(old, tmpl)):
            conv = []
            for a, b in zip(old, tmpl):
                if a.dtype == b.dtype:
                    conv.append(a)
                elif b.element_size() > a.element_size():
                    conv.append(b)
                    widened += 1
                else:
                    conv.append(a.to(b.dtype))
            new = _rebuild(template, iter(conv))
        else:
            log.warning("%s: the precision retune changed the carry's structure: "
                        "streaming state reset", self.meta.instance_name)
            new = template
        with self._carry_lock:
            self.pipeline, self._precision_plan, self._precision_mode = pipe, plan, mode
            self._programs, self._fn, self._carry = {}, None, None
            self._fn = self._program_for(self.wire, self._packed)
            self._carry = new
        self.precision_switches += 1
        if widened:
            log.info("%s: the precision retune took %d widened parameter leaf(s) from "
                     "the build-time values: send runtime parameter retunes again",
                     self.meta.instance_name, widened)
        if self._ckpt_every:
            fetches, spec = self.pipeline.snapshot_carry(self._carry)
            floor = self._seq - 1
            self._pending_ckpts.clear()
            self._ckpts.clear()
            self._ckpts.append((floor, [f() for f in fetches], spec))
            with self._rlog_lock:
                while self._rlog and self._rlog[0][0] <= floor:
                    for h in self._rlog.popleft()[3]:
                        h.release()
            self._retune_log.clear()
            self._wire_log.clear()
            self._wire_floor_fmt = self.wire.name
        self._note_precision()

    def _maybe_switch_precision(self) -> None:
        """Apply a pending precision retune once nothing is staged, in
        flight, being filled, waiting for a deferred consume or replaying."""
        if self._staged or self._inflight or self._group is not None or \
                self._pending_consume is not None or self._replay_queue or \
                self._replay_pending():
            return
        self._apply_precision_program()

    def _switch_pending(self) -> bool:
        return self._wire_switch_target is not None or self._precision_switch is not None

    def _add_outputs(self) -> None:
        self.output = self.add_stream_output(
            "out", self.pipeline.out_dtype, min_items=self.out_frame,
            min_buffer_size=(self.depth * self.k_batch + 1) * self.out_frame *
            np.dtype(self.pipeline.out_dtype).itemsize)

    # -- the host data path ---------------------------------------------------
    def _init_hostpath(self) -> None:
        """The host data path's state (the reference's ``_init_hostpath``):
        the staging arena, the codec pool, the credit controller (an explicit
        depth or config ``tpu_inflight`` > 0 pins it), ``stage_ahead``, and
        everything that follows from the wire (:meth:`_derive_wire_paths`)
        and the adaptive wire controller."""
        cuda = self.inst.device.type == "cuda"
        # with the arena off, a zero-capacity arena: a fresh buffer a group
        self._arena = arena(pin=cuda) or StagingArena(0, pin=cuda)
        self._codec_pool = _codec_mod.pool()
        adaptive = not self._depth_explicit
        if adaptive and config().tpu_inflight > 0:
            self.depth, adaptive = int(config().tpu_inflight), False
        elif adaptive:
            # the seed: the cached autotune_streamed pick's depth
            from .autotune import cached_streamed_pick, platform_of
            pick = cached_streamed_pick(self._sig(), self.pipeline.in_dtype,
                                        platform_of(self.inst))
            if pick and pick.get("inflight"):
                self.depth = int(pick["inflight"])
                log.info("%s: in-flight credit seed %d from the cached autotune pick",
                         type(self).__name__, self.depth)
        self._credits = CreditController(self.depth, adaptive=adaptive)
        # one group staged beyond the in-flight budget, so its H2D rides
        # under the previous group's compute (depth 1 stays strictly serial)
        self.stage_ahead = 1 if self.depth > 1 else 0
        self._ingest_frames = 0
        self._staged_frames = 0
        self._pending_consume = None   # (event, items) of a deferred consume()
        self._derive_wire_paths()
        self._init_wirectl()

    def _derive_wire_paths(self) -> None:
        """Everything that follows from the wire: the packed layout, the
        encode offload (a pool, and an encode that aliases the frame, whose
        ring-exit copy is paid anyway), zero-copy ingest (aliasing wires) and
        deferred consume (a pool, a quantizing wire, K = 1)."""
        c = config()
        alias = self.wire.encode_may_alias(self.pipeline.in_dtype)
        self._resolve_packed()
        self._encode_offload = self._codec_pool is not None and alias
        self._ingest_enabled = bool(c.tpu_zero_copy_ingest) and alias
        self._deferred_consume = (self._codec_pool is not None and not alias
                                  and self.k_batch == 1 and bool(c.tpu_deferred_consume))
        parts = self.wire.encode_host(np.zeros(self.frame_size, self.pipeline.in_dtype))
        self._part_specs = [(np.shape(p), np.asarray(p).dtype) for p in parts]
        if hasattr(self.pipeline, "part_counts"):
            self._part_counts = self.pipeline.part_counts(self.wire)

    def _resolve_packed(self) -> None:
        """The coalesced uplink's layout for the current wire, frame and K
        (None for a one-part wire, and with ``tpu_coalesce`` off)."""
        self._packed = None
        if config().tpu_coalesce:
            self._packed = xfer.PackedLayout.probe(self.wire, self.frame_size,
                                                   self.pipeline.in_dtype, k=self.k_batch)

    def _init_wirectl(self) -> None:
        """Arm the adaptive wire controller (``tpu_adaptive_wire``, off by
        default). It stays off when the wire is off its f32/sc16/sc8 ladder
        or the input is not float or complex; armed, it starts at the wire
        the cached ``autotune_streamed`` pick measured fastest (the cache's
        ``wire`` axis), where one is on the ladder."""
        self._wire_switch_target = None
        self._wire_switches = 0
        #: (first frame dispatched under it, wire name), one a wire in use
        self.wire_history = [(0, self.wire.name)]
        # (first group shipped under it, wire) a switch, pruned at the
        # committed-checkpoint floor like the replay log; the wire in effect
        # at that floor; and the switches a recovery applies again at their
        # groups
        self._wire_log: Deque[tuple] = deque()
        self._wire_floor_fmt = self.wire.name
        self._replay_wire_switches: Deque[tuple] = deque()
        self._wirectl = None
        if not config().tpu_adaptive_wire:
            return
        if self.wire.name not in WireController.LADDER or \
                np.dtype(self.pipeline.in_dtype).kind not in "fc":
            log.info("%s: adaptive wire off (wire %s, in dtype %s off the f32/sc16/sc8 "
                     "ladder)", type(self).__name__, self.wire.name,
                     np.dtype(self.pipeline.in_dtype))
            return
        self._wirectl = WireController(float(config().tpu_wire_snr_budget_db))
        from .autotune import cached_wire_start, platform_of
        fmt = cached_wire_start(self._sig(), self.pipeline.in_dtype, platform_of(self.inst))
        if fmt and fmt != self.wire.name and fmt in WireController.LADDER:
            log.info("%s: the adaptive wire starts at %s (cached autotune pick; built %s)",
                     type(self).__name__, fmt, self.wire.name)
            self.wire = get_wire(fmt)
            self._derive_wire_paths()
            self.wire_history = [(0, fmt)]
            self._wire_floor_fmt = fmt

    def _adopt_credit_mode(self, adaptive: bool) -> None:
        """Re-arm the credit controller after construction: a fused device
        chain passes its members' depth explicitly, but may adapt unless a
        member pinned its own (a config ``tpu_inflight`` pin always wins)."""
        if config().tpu_inflight > 0:
            adaptive = False
        self._credits = CreditController(self.depth, adaptive=adaptive)

    def extra_metrics(self) -> dict:
        # codec workers insert into the replay log: read it under its lock
        with self._rlog_lock:
            replay_frames = sum(len(e[2]) for e in self._rlog)
        return {"frame_size": self.frame_size,
                "wire": self.wire.name,
                "frames_per_dispatch": self.k_batch,
                "frames_dispatched": self.frames_dispatched,
                "dispatches": self.dispatches,
                "inflight_credits": self._credits.credits,
                # the uplink plane: H2D starts a dispatch group (1 when
                # packed), the zero-copy share of the staged frames, the
                # deferred consume and the adaptive wire
                "uplink_coalesced": int(self._packed is not None),
                "h2d_starts_per_frame": (1 if self._packed is not None
                                         else len(self._part_specs)),
                "ingest_zero_copy_frac": (self._ingest_frames / self._staged_frames
                                          if self._staged_frames else 0.0),
                "deferred_consume": int(self._deferred_consume),
                "adaptive_wire": int(self._wirectl is not None),
                "wire_switches": self._wire_switches,
                "interior_precision": self._precision_mode,
                "interior_lowered": (self._precision_plan.lowered
                                     if self._precision_plan is not None else 0),
                "precision_switches": self.precision_switches,
                # recovery: the active cadence (0 = off), the newest
                # committed checkpoint, the frames the replay log holds,
                # and the frames replayed and forfeited by restarts
                "checkpoint_every": self._ckpt_every,
                "checkpoint_seq": self._ckpts[-1][0] if self._ckpts else -1,
                "replay_log_frames": replay_frames,
                "fsdr_frames_replayed_total": self.frames_replayed,
                "fsdr_frames_forfeited_total": self.frames_forfeited,
                "checkpoints_rejected": self.checkpoints_rejected}

    def _n_slots(self) -> int:
        return self._credits.hi + self.stage_ahead

    def _program_for(self, wire, packed):
        """The wired program of ``(wire, packed)``, built once: every program
        of this kernel shares the first one's static carry buffers."""
        key = (wire.name, None if packed is None else packed.key)
        fn = self._programs.get(key)
        if fn is None:
            share = getattr(self._fn, "carry", None)
            fn, carry = self.pipeline.compile(
                self.frame_size, self.inst.device, k=self.k_batch, slots=self._n_slots(),
                wire=wire, packed=packed, carry=share)
            if self._carry is None:
                self._carry = carry
            self._programs[key] = fn
        return fn

    def _quiesce(self) -> None:
        """Wait out this kernel's codec-worker tasks and pending transfers
        (their errors already surfaced, or a restart supersedes them), so
        none still writes a slot, reads a ring slot or inserts into the
        replay log after a re-init or a recovery; a deferred consume lands
        (its frame was staged and logged)."""
        try:
            self._settle_deferred_consume()
        except Exception:                  # noqa: BLE001
            pass
        for d in self._staged:
            if d.get_fin is not None:
                try:
                    d.get_fin()
                except Exception:          # noqa: BLE001
                    pass
        for d in self._inflight:
            try:
                d.land[0]()
            except Exception:              # noqa: BLE001
                pass

    def _drop_window(self) -> None:
        """Forget every staged and in-flight group (after :meth:`_quiesce`):
        their landings' host buffers and ingest handles go back."""
        for d in self._inflight:
            d.land[1]()
        for d in itertools.chain(self._staged, self._inflight):
            for h in d.held:
                h.release()
        self._staged.clear()
        self._inflight.clear()
        self._free_slots = deque(range(self._n_slots()))

    async def init(self, mio, meta):
        # a fresh incarnation drops the previous one's groups; their input
        # was consumed, so they are forfeited and counted (a restart goes
        # through recover() instead where a checkpoint allows)
        self._quiesce()
        forfeit = sum(len(d.metas) for d in itertools.chain(self._staged, self._inflight)
                      if not d.drop)
        forfeit += sum(len(e[2]) for e in self._replay_queue if not e[4])
        if self._group is not None:
            forfeit += len(self._group.metas)
        if forfeit:
            self.frames_forfeited += forfeit
            log.warning("%s: a fresh init forfeits %d frame(s) in flight",
                        self.meta.instance_name or type(self).__name__, forfeit)
        self._drop_window()
        if self._group is not None:
            if self._group.alloc is not None:
                self._group.alloc.release()
            for h in self._group.held:
                h.release()
        self._group = None
        self._pending_out, self._pending_tags = None, []
        self._recovery_reset()
        self._ckpt_every = self._resolve_ckpt_every()
        with self._carry_lock:
            if self._fn is None:
                # the warm-up (kernel builds, library plans, lazy tables) and
                # the capture happen here, off the hot path
                self._fn = self._program_for(self.wire, self._packed)
            else:
                # a re-run starts from a fresh carry, which the program copies
                # into its buffers at the first dispatch
                self._carry = self.pipeline.init_carry(self.inst.device)
            self.frames_dispatched = 0
            self.dispatches = 0
        if self._ckpt_every:
            # the fresh-init sentinel: a fault before the first commit
            # restores the initial carry and replays from group 0
            self._ckpts.append((-1, None, None))
        self._note_precision()

    @message_handler(name="ctrl")
    async def ctrl_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        """Runtime stage control: ``{"stage": <name-or-index>, <param>:
        <value>, …}`` lands in :meth:`apply_retune` and is answered
        ``Pmt.ok()`` once the surgery is done; frames already dispatched
        keep the old values. ``{"stage": …, "interior_precision": mode}``
        alone is a precision retune (:meth:`apply_precision_retune`).
        Malformed input, an unknown stage, parameter or mode and a message
        before ``init`` are answered ``Pmt.invalid_value()`` (the runtime's
        init barrier answers pre-init calls itself)."""
        try:
            stage, params = parse_ctrl(p)
            if set(params) == {"interior_precision"}:
                self.apply_precision_retune(stage, params["interior_precision"])
                return Pmt.ok()
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
        i.e. the first frame that sees it.

        With checkpoints on, the surgery is logged against the first group
        it reaches, so a recovery whose restore point lies before it applies
        it again at that group. Inside a replay window it waits for the
        window's end (the replayed groups dispatch with the parameters they
        first had, and the surgery lands where it lands "now" in the
        recovered stream), after it was checked on a copy of the carry."""
        with self._carry_lock:
            if self._carry is None:
                raise RuntimeError("retune before init")
            if self._replay_pending():
                self.pipeline.update_stage(self._carry, stage, **params)   # validate
                self.warn_retune_in_replay()
                entry = (self._replay_high + 1, stage, dict(params))
                self._replay_retunes.append(entry)
                if self._ckpt_every:
                    self._retune_log.append(entry)
                return self.frames_dispatched
            self._carry = self.pipeline.update_stage(self._carry, stage, **params)
            if self._ckpt_every:
                # groups dispatch in order under this lock: the next one is
                # the first to see the new parameters
                self._retune_log.append((self._next_seq, stage, dict(params)))
            return self.frames_dispatched

    def _apply_replay_retunes(self, seq: int) -> None:
        """Apply the logged surgery due at group ``seq`` (under the carry
        lock, before its dispatch)."""
        while self._replay_retunes and self._replay_retunes[0][0] <= seq:
            _, stage, params = self._replay_retunes.popleft()
            try:
                self._carry = self.pipeline.update_stage(self._carry, stage, **params)
            except Exception as e:         # noqa: BLE001 — it was checked when accepted
                log.warning("%s: replayed retune @%d failed (%r): the recovered output "
                            "may differ from that group on", self.meta.instance_name,
                            seq, e)

    def _replay_pending(self) -> int:
        """Frames of the active replay window not yet drained (0 = no window;
        a drained window is disarmed)."""
        if self._replay_high < 0:
            return 0
        # list() copies each deque in one step: a retune from another thread
        # reads them while this kernel's thread moves groups along
        pending = sum(len(e[2]) for e in list(self._replay_queue))
        pending += sum(len(d.metas) for d in list(self._staged) + list(self._inflight)
                       if d.seq <= self._replay_high)
        if pending == 0:
            self._replay_high = -1
        return pending

    def warn_retune_in_replay(self) -> int:
        """Log a retune that landed inside an active replay window (it is
        deferred to the window's end, so the recovered output stays the
        unfailed run's); returns the replayed frames still pending (0 = no
        window)."""
        pending = self._replay_pending()
        if pending:
            log.warning("%s: ctrl retune landed inside an active replay window: "
                        "deferred to the post-replay boundary (group %d), so the %d "
                        "replayed frame(s) still in flight dispatch with their original "
                        "parameters and the recovered output stays bit-identical",
                        self.meta.instance_name or type(self).__name__,
                        self._replay_high + 1, pending)
        return pending

    # -- wire switches --------------------------------------------------------
    def apply_wire_retune(self, fmt: str) -> None:
        """Ask for a mid-stream wire switch (the adaptive controller takes
        the same path). It lands at the next quiescent dispatch-group
        boundary (:meth:`_maybe_switch_wire`): no frame in flight spans two
        wire programs. Safe to call from another thread."""
        fmt = str(fmt)
        if fmt not in WIRE_FORMATS:
            raise ValueError(f"unknown wire format {fmt!r} "
                             f"(expected one of {sorted(WIRE_FORMATS)})")
        self._wire_switch_target = None if fmt == self.wire.name else fmt

    def _apply_wire_program(self, fmt: str, replay: bool = False) -> None:
        """Swap the wire and everything derived from it, and take its
        program (cached, or captured now sharing the carry buffers). Runs at
        a group boundary: a live switch with nothing staged or in flight, a
        recovery's (``replay``) before it re-ships the first group logged
        under ``fmt`` (each group dispatches on the program it was shipped
        to). The carry does not depend on the wire, so it carries over as it
        is."""
        if fmt == self.wire.name:
            return
        old = self.wire.name
        self.wire = get_wire(fmt)
        self._derive_wire_paths()
        with self._carry_lock:
            self._fn = self._program_for(self.wire, self._packed)
        if replay:
            return
        self._wire_switches += 1
        self.wire_history.append((self.frames_dispatched, fmt))
        log.info("%s: wire switched %s -> %s at frame %d",
                 self.meta.instance_name or type(self).__name__, old, fmt,
                 self.frames_dispatched)

    def _maybe_switch_wire(self) -> None:
        """Collect the controller's proposal, then apply a pending switch
        once nothing is staged, in flight, being filled or waiting for a
        deferred consume. While a switch waits, staging pauses and ``work``
        drains toward the boundary."""
        if self._wire_switch_target is None:
            if self._wirectl is None or self._replay_pending():
                return                  # the controller waits out a replay
            tgt = self._wirectl.propose(self.wire.name)
            if tgt is None:
                return
            self._wire_switch_target = tgt
            log.info("%s: adaptive wire proposes %s -> %s (snr %.1f dB, budget %.1f dB)",
                     self.meta.instance_name or type(self).__name__, self.wire.name, tgt,
                     self._wirectl.last_snr_db, self._wirectl.budget_db)
        if self._staged or self._inflight or self._group is not None or \
                self._pending_consume is not None or self._replay_queue or \
                self._replay_wire_switches:
            return
        tgt, self._wire_switch_target = self._wire_switch_target, None
        if tgt is not None and tgt != self.wire.name:
            if self._ckpt_every:
                # nothing is staged: the next group shipped is the first
                # under the new wire
                self._wire_log.append((self._seq, tgt))
            self._apply_wire_program(tgt)

    # -- staging --------------------------------------------------------------
    def _new_group(self) -> _Group:
        """An empty group with its part buffers taken from the arena: views
        into one packed buffer when the uplink coalesces."""
        k = self.k_batch
        if self._packed is not None:
            alloc = PackedAlloc(self._arena, self._packed)
        else:
            alloc = GroupAlloc(self._arena)
        lead = (k,) if k > 1 else ()
        dests = [alloc(lead + tuple(sh), dt) for sh, dt in self._part_specs]
        return _Group(alloc, dests)

    def _encode_row(self, g: _Group, i: int, frame: np.ndarray) -> None:
        """Encode one frame into row ``i`` of the group's parts. An aliasing
        wire's encode is a view of the frame, so this is the ring-exit copy;
        a quantizing wire writes its payload in place (``encode_into``) and
        its scale is copied in."""
        k = self.k_batch
        if self.wire.encode_may_alias(frame.dtype):
            parts = self.wire.encode_host(frame)
        else:
            parts = self.wire.encode_into(frame, _RowAlloc(g, i, k))
        for d, p in zip(g.dests, parts):
            row = d[i, ...] if k > 1 else d
            p = np.asarray(p)
            if not np.shares_memory(row, p):
                row[...] = p

    def _stage(self, frame: np.ndarray, valid_in: int, tags, deferred=None) -> None:
        """Queue one frame (a full one, or the zero-padded EOS tail) into the
        group being filled and encode it now, so the caller may consume its
        ring slot at once, or, with ``deferred`` (an event), on the codec
        worker that ships the group, which sets the event once it has read
        the slot. A full group ships."""
        self._staged_frames += 1
        if self._wirectl is not None:
            self._wirectl.observe_frame(frame)
        g = self._group
        if g is None:
            zc = self._zero_copy(frame)
            if zc is not None:
                # the registered buffer is the staging copy: the group ships
                # the wire's views of it and holds it until it drains
                g = _Group(None, None, parts=self.wire.encode_host(frame))
                g.held.append(zc)
            else:
                g = self._new_group()
            self._group = g
        i = len(g.metas)
        if g.parts is None:
            if deferred is not None:
                g.deferred.append((i, frame, deferred))
            else:
                self._encode_row(g, i, frame)
        g.metas.append((valid_in, tuple(tags)))
        if len(g.metas) == self.k_batch:
            self._flush_accum()

    def _zero_copy(self, frame: np.ndarray):
        """The retained ingest handle when ``frame`` may ship from its
        registered buffer without a copy (K = 1, an aliasing wire, a
        registered read-only buffer, page-locked on a card), else None."""
        if not self._ingest_enabled or self.k_batch != 1:
            return None
        h = _ingest_mod.lookup(frame)
        if h is None or (self.inst.device.type == "cuda" and not h.page_locked):
            return None
        self._ingest_frames += 1
        _ingest_mod.note_zero_copy()
        return h.retain()

    def _ship(self, g: _Group, out, seq: int, metas: tuple) -> object:
        """Encode what waits for this thread, settle the group's parts (a
        partial group's pad rows zeroed, the packed buffer's gaps), log them
        for replay when checkpoints are on (before the H2D, which may fail),
        and start their H2D into the slot's input ``out``; returns the
        transfer's ``finish``."""
        try:
            for i, frame, _ev in g.deferred:
                self._encode_row(g, i, frame)
        finally:
            for _i, _frame, ev in g.deferred:
                ev.set()       # the ring slot has been read: consume() may run
        if g.parts is not None:
            if self._ckpt_every:
                self._rlog_insert(seq, tuple(g.parts), metas, g.held)
            return xfer.start_device_transfer_parts(g.parts, self.inst.device, out=out)
        n = len(g.metas)
        if n < self.k_batch:
            for d in g.dests:
                d[n:] = 0
        alloc = g.alloc
        parts = (alloc.finish(g.dests),) if isinstance(alloc, PackedAlloc) else g.dests
        alloc.drop_temps()
        handles, alloc.handles = list(alloc.handles), []
        if self._ckpt_every:
            self._rlog_insert(seq, tuple(parts), metas, handles)
        return xfer.start_device_transfer_parts(parts, self.inst.device, out=out,
                                                handles=handles)

    def _flush_accum(self) -> None:
        """Ship the group being filled into a free slot of the program as
        the next group in sequence: its H2D starts here, or on an encode
        worker when the pool takes the encode (an aliasing wire's offload, a
        deferred consume's in-place encode). The rows of a partial group
        (EOS only) past its last frame are zeroed; their outputs are dropped
        at drain."""
        g, self._group = self._group, None
        slot = self._free_slots.popleft()
        seq, self._seq = self._seq, self._seq + 1
        metas = tuple(g.metas)
        d = _Dispatch(None, metas, slot, g.held, seq, False, self._fn, self.wire)
        self._staged.append(d)
        out = self._fn.inputs[slot]
        pool = self._codec_pool
        if pool is not None and (self._encode_offload or g.deferred):
            try:
                fut = pool.submit_encode(self._ship, g, out, seq, metas)
            except BaseException:
                for _i, _f, ev in g.deferred:
                    ev.set()
                raise
            d.get_fin = fut.result
        else:
            fin = self._ship(g, out, seq, metas)
            d.get_fin = lambda: fin        # noqa: E731

    def _stage_deferred(self, frame: np.ndarray, tags) -> None:
        """Stage a quantizing K = 1 frame with no ring-exit copy: the codec
        worker encodes the live ring slot in place, and ``consume()`` waits
        (:meth:`_settle_deferred_consume`) until it has read it, so the
        writer never overwrites a frame in flight."""
        ev = threading.Event()
        self._pending_consume = (ev, self.frame_size)
        self._stage(frame, self.frame_size, tags, deferred=ev)

    def _settle_deferred_consume(self) -> None:
        """Land a deferred consume: wait for the worker's read of the slot,
        then advance the reader (at most one consume is ever deferred)."""
        if self._pending_consume is None:
            return
        ev, n = self._pending_consume
        ev.wait()
        self._pending_consume = None
        self.input.consume(n)

    def _room(self, budget: int) -> bool:
        return len(self._staged) + len(self._inflight) < budget

    def _restage(self, seq: int, parts, metas, handles, drop: bool) -> None:
        """Ship one logged group again into a free slot, on the program of
        the wire it was first shipped under (the logged switches up to it
        are applied first)."""
        while self._replay_wire_switches and self._replay_wire_switches[0][0] <= seq:
            self._apply_wire_program(self._replay_wire_switches.popleft()[1], replay=True)
        slot = self._free_slots.popleft()
        # the log keeps its own count; the transfer takes and releases one
        arena_hs = [h.retain() for h in handles if isinstance(h, ArenaBuffer)]
        d = _Dispatch(None, metas, slot, (), seq, drop, self._fn, self.wire)
        self._staged.append(d)
        fin = xfer.start_device_transfer_parts(parts, self.inst.device,
                                               out=self._fn.inputs[slot], handles=arena_hs)
        d.get_fin = lambda: fin            # noqa: E731

    def _stage_available_input(self):
        """Stage, within the credits and ``stage_ahead``, the groups a
        recovery queued for replay first, then every full frame, and the
        zero-padded tail frame and the partial group at EOS; returns
        ``(remaining input slice, eos)``."""
        self._settle_deferred_consume()
        budget = self._credits.credits + self.stage_ahead
        if self._replay_queue or self._replay_wire_switches:
            while self._replay_queue and self._room(budget):
                self._restage(*self._replay_queue.popleft())
            if self._replay_queue:
                # new input follows the replayed groups in sequence
                return self.input.slice(), self.input.finished()
            # the switches after the last replayed group (the live wire)
            while self._replay_wire_switches:
                self._apply_wire_program(self._replay_wire_switches.popleft()[1],
                                         replay=True)
        if self._wirectl is not None or self._wire_switch_target is not None:
            self._maybe_switch_wire()
        if self._precision_switch is not None:
            self._maybe_switch_precision()
        inp = self.input.slice()
        # a pending switch pauses staging, but a part-filled group keeps
        # filling to its flush (padding mid-stream would corrupt the carry)
        while self._room(budget) and (not self._switch_pending()
                                      or self._group is not None):
            # the last deferred consume of a cycle stays pending into the next
            # work call, so the worker's encode overlaps the dispatch below
            self._settle_deferred_consume()
            inp = self.input.slice()
            if len(inp) < self.frame_size:
                break
            tags = self.input.tags(self.frame_size)
            frame = inp[:self.frame_size]
            if self._deferred_consume:
                self._stage_deferred(frame, tags)
            else:
                self._stage(frame, self.frame_size, tags)
                self.input.consume(self.frame_size)
            inp = self.input.slice()
        eos = self.input.finished()
        if eos and 0 < len(inp) < self.frame_size and self._pending_consume is None \
                and self._room(budget):
            n = len(inp)
            frame = np.zeros(self.frame_size, dtype=self.pipeline.in_dtype)
            frame[:n] = inp
            # items past the last frame_multiple boundary cannot give whole
            # outputs and are dropped at EOS (the streaming frame contract)
            self._stage(frame, n - n % self.pipeline.frame_multiple, self.input.tags(n))
            self.input.consume(n)
            inp = self.input.slice()
        if eos and self._group is not None and len(inp) == 0:
            self._flush_accum()
        if self._pending_consume is not None:
            # the deferred frame is staged but still in the slice
            inp = inp[self._pending_consume[1]:]
        return inp, eos

    # -- dispatch and drain ---------------------------------------------------
    def _launch_staged(self) -> None:
        """Replay the program for each staged group (oldest first) and start
        its D2H, within the credit budget; the carry checkpoint, where one is
        due, is copied right behind the replay."""
        fplan = _faults.plan()
        while self._staged and len(self._inflight) < self._credits.credits:
            if fplan.armed():
                fplan.maybe("dispatch", self.meta.instance_name)
            d = self._staged[0]
            fin = d.get_fin()               # the encode worker's start, joined
            fin()                           # the replay waits for the H2D
            with self._carry_lock:
                self._staged.popleft()
                if self._replay_retunes:
                    self._apply_replay_retunes(d.seq)
                self._carry, y = d.fn.dispatch(d.slot, self._carry)
                self._next_seq = d.seq + 1
                if self._ckpt_every and (d.seq + 1) % self._ckpt_every == 0:
                    self._start_ckpt(d.seq)
                self.frames_dispatched += len(d.metas)
                self.dispatches += 1
            d.land, d.out_metas = self._start_result_d2h(y, d.metas, d.wire)
            self._inflight.append(d)
            self._credits.note_dispatch(getattr(fin, "_wire", None), len(self._inflight))
            if self._wirectl is not None:
                self._wirectl.note_dispatch(getattr(fin, "_wire", None))
        if self._staged and len(self._inflight) >= self._credits.credits:
            self._credits.note_limited()

    def _out_metas(self, metas) -> list:
        out_metas = []
        for valid_in, tags in metas:
            valid_out = min(self.pipeline.out_items(valid_in), self.out_frame)
            out_metas.append((valid_out, rebase_frame_tags(tags, self.pipeline, valid_out)))
        return out_metas

    def _start_result_d2h(self, y, metas, wire) -> tuple:
        """Start the D2H of a replay's output parts; returns ``(landing, one
        (valid_out, rebased tags) a frame)``."""
        out_metas = self._out_metas(metas)
        return self._landing([xfer.start_host_transfer_parts(y)], out_metas, wire), out_metas

    def _landing(self, fins, out_metas, wire):
        """A group's landing: ``land()`` waits for its D2H(s) and decodes
        (:meth:`_decode_group`), on a decode worker from now on when the
        pool is on; ``land.release`` hands the host buffers back once the
        payload has been emitted."""
        def land():
            return self._decode_group([None if f is None else f() for f in fins],
                                      out_metas, wire)

        pool = self._codec_pool
        if pool is not None:
            fut = pool.submit_decode(land)
            joined = fut.result
        else:
            joined = land

        def release():
            for f in fins:
                if f is not None:
                    f.release()

        return joined, release

    def _decode_rows(self, raw, n_valid, out_dtype, wire) -> np.ndarray:
        """Decode one landed output (a tuple of parts, ``[K, …]`` at K > 1)
        into the flat valid prefix of its frames: every frame but a group's
        last real one is whole, so the frames' valid outputs are one prefix
        of the flattened rows. A one-part wire decodes the stack at once (a
        view for f32); a scaled wire decodes frame by frame, each with its
        own scale."""
        if self.k_batch == 1:
            return wire.decode_host(raw, out_dtype).reshape(-1)[:n_valid[0]]
        total = sum(n_valid)
        if len(raw) == 1:
            return wire.decode_host(raw, out_dtype).reshape(-1)[:total]
        rows = [wire.decode_host(tuple(p[i] for p in raw), out_dtype)[:v]
                for i, v in enumerate(n_valid)]
        return np.concatenate(rows) if rows else np.empty(0, out_dtype)

    def _decode_group(self, raws, out_metas, wire) -> np.ndarray:
        (raw,) = raws
        return self._decode_rows(raw, [v for v, _ in out_metas],
                                 self.pipeline.out_dtype, wire)

    def _release_group(self, slot, held) -> None:
        self._free_slots.append(slot)
        for h in held:
            h.release()

    def _drain_one(self) -> None:
        """Emit the oldest group's frames, decoded on the host (a replayed
        group emitted before the fault emits nothing), then mark it
        drained."""
        d = self._inflight.popleft()
        land, release = d.land
        flat = land()
        if not d.drop:
            tags = [ItemTag(t.index + i * self.out_frame, t.tag)
                    for i, (_, ts) in enumerate(d.out_metas) for t in ts]
            self._pending_out, self._pending_tags = emit_with_tags(self.output, flat, tags)
        release()
        self._release_group(d.slot, d.held)
        self._note_drained(d.seq)

    def _idle(self, inp) -> bool:
        return (not self._inflight and not self._staged and self._group is None
                and self._pending_consume is None and not self._replay_queue
                and len(inp) == 0)

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
        #    full frame waits (flush for latency), at EOS, or toward a
        #    pending wire switch
        if self._inflight and (len(self._inflight) >= self._credits.credits
                               or len(inp) < self.frame_size or eos
                               or self._switch_pending()):
            self._drain_one()
            io.call_again = True
            return

        if eos and self._idle(inp) and self._pending_out is None:
            io.finished = True
            # the stream ended cleanly: a later run starts fresh, and the
            # persisted checkpoint, complete state now, goes
            self._recovery_reset(purge_disk=True)

    # -- carry checkpoints and replay -----------------------------------------
    def _init_recovery_state(self, checkpoint_every) -> None:
        """The recovery state (the module docstring), shared by every kernel
        class: the configured cadence, the replay log, the 2-deep ring of
        committed checkpoints, the pending snapshots and the replay queue."""
        c = config()
        self._ckpt_cadence = max(0, int(checkpoint_every if checkpoint_every is not None
                                        else c.tpu_checkpoint_every))
        self._ckpt_explicit = checkpoint_every is not None
        # the active cadence, resolved again at every init
        self._ckpt_every = self._ckpt_cadence if self._ckpt_explicit else 0
        self._seq = 0                    # the next group's sequence number
        self._next_seq = 0               # the next group to dispatch
        self._drained_seq = -1           # the newest group drained
        # (seq, host parts, metas, retained handles) a group not yet covered
        # by a committed checkpoint; codec workers insert out of band
        self._rlog: Deque[tuple] = deque()
        self._rlog_lock = threading.Lock()
        self._rlog_dropped = 0
        d = str(c.checkpoint_dir or "")
        self._ckpt_dir = os.path.expanduser(d) if d else ""
        # the newest commit not yet on disk: at most one write queued
        self._persist_lock = threading.Lock()
        self._persist_box = None
        self._persist_queued = False
        # committed (seq, host leaves, spec), newest last; (-1, None, None)
        # is the fresh-init sentinel
        self._ckpts: Deque[tuple] = deque(maxlen=2)
        # (seq, fetches, spec) snapshots started, not yet committed
        self._pending_ckpts: Deque[tuple] = deque()
        # (seq, parts, metas, handles, drop) groups a recovery re-ships
        self._replay_queue: Deque[tuple] = deque()
        self._replay_high = -1           # the newest replayed group (-1: none)
        # (seq, stage, params) a retune; the ones a recovery applies again
        self._retune_log: Deque[tuple] = deque()
        self._replay_retunes: Deque[tuple] = deque()
        self.frames_replayed = 0
        self.frames_forfeited = 0
        self.checkpoints_rejected = 0    # candidates a restore found invalid

    def _resolve_ckpt_every(self) -> int:
        """The cadence of this incarnation: the configured one where a
        restart can read a checkpoint (an explicit ``checkpoint_every``, a
        restartable fused chain, a ``restart`` policy on the kernel or in
        the config), else 0."""
        if not self._ckpt_cadence:
            return 0
        if self._ckpt_explicit or getattr(self, "_dc_restartable", False):
            return self._ckpt_cadence
        if getattr(getattr(self, "policy", None), "on_error", None) == "restart":
            return self._ckpt_cadence
        if str(config().block_policy) == "restart":
            return self._ckpt_cadence
        return 0

    def _start_ckpt(self, seq: int) -> None:
        """Start the host copy of the carry after group ``seq`` (under the
        carry lock, right behind its replay); committed once ``seq`` has
        drained. A failed snapshot only narrows the restore window."""
        try:
            fetches, spec = self.pipeline.snapshot_carry(self._carry)
        except Exception as e:             # noqa: BLE001
            log.warning("%s: carry snapshot @%d failed (%r): skipped",
                        self.meta.instance_name, seq, e)
            return
        self._pending_ckpts.append((seq, fetches, spec))

    def _rlog_insert(self, seq: int, parts: tuple, metas: tuple, handles) -> None:
        """Log one shipped group in sequence order (codec workers finish out
        of order), retaining its buffers while it is logged. Past the cap
        (``64 + 4·(depth + stage_ahead + checkpoint_every)`` groups: commits
        that stopped) the oldest are dropped, and a recovery then declines a
        checkpoint the log no longer reaches."""
        for h in handles:
            h.retain()
        dropped = False
        with self._rlog_lock:
            entry = (seq, parts, metas, tuple(handles))
            if not self._rlog or self._rlog[-1][0] < seq:
                self._rlog.append(entry)
            else:
                i = next((i for i, e in enumerate(self._rlog) if e[0] > seq), len(self._rlog))
                self._rlog.insert(i, entry)
            cap = 64 + 4 * (self.depth + self.stage_ahead + self._ckpt_every)
            while len(self._rlog) > cap:
                for h in self._rlog.popleft()[3]:
                    h.release()
                self._rlog_dropped += 1
                dropped = self._rlog_dropped == 1
        if dropped:
            log.warning("%s: the replay log exceeded its cap (checkpoints not "
                        "committing?): dropping the oldest; a restart may now forfeit",
                        self.meta.instance_name)

    def _materialize(self, seq: int, fetches) -> Optional[list]:
        try:
            return [f() for f in fetches]
        except Exception as e:             # noqa: BLE001 — narrows the window only
            log.warning("%s: carry snapshot @%d dropped (%r)", self.meta.instance_name,
                        seq, e)
            return None

    def _note_drained(self, seq: int) -> None:
        """Group ``seq``'s outputs are on the host: commit every snapshot it
        covers (the ``carry`` fault site may corrupt a candidate) and prune
        the replay log, the retune log and the wire log back to the older of
        the two kept checkpoints, so a corrupted newest one can still fall
        back."""
        if seq > self._drained_seq:
            self._drained_seq = seq
        if not self._ckpt_every:
            return
        fplan = _faults.plan()
        while self._pending_ckpts and self._pending_ckpts[0][0] <= seq:
            s, fetches, spec = self._pending_ckpts.popleft()
            leaves = self._materialize(s, fetches)
            if leaves is None:
                continue
            if fplan.armed():
                try:
                    fplan.maybe("carry", self.meta.instance_name)
                except _faults.InjectedFault as e:
                    log.warning("%s: checkpoint @%d corrupted by an injected fault "
                                "(%r)", self.meta.instance_name, s, e)
                    leaves = [np.zeros(int(np.size(x)) + 1, np.uint8) for x in leaves] \
                        or [np.zeros(1, np.uint8)]
            if self._ckpts and self._ckpts[-1][0] >= s:
                continue                     # a replay's commit of a covered group
            self._ckpts.append((s, leaves, spec))
            self._persist_ckpt(s, leaves)
            if len(self._ckpts) >= 2:
                floor = self._ckpts[0][0]
                with self._rlog_lock:
                    while self._rlog and self._rlog[0][0] <= floor:
                        for h in self._rlog.popleft()[3]:
                            h.release()
                while self._retune_log and self._retune_log[0][0] <= floor:
                    self._retune_log.popleft()
                # the wire is not in the carry: keep the one in effect at
                # the floor
                while self._wire_log and self._wire_log[0][0] <= floor:
                    self._wire_floor_fmt = self._wire_log.popleft()[1]

    def _recovery_reset(self, purge_disk: bool = False) -> None:
        """Drop every checkpoint and replay record (a fresh incarnation, or
        a stream that ended cleanly), releasing what the log retained;
        ``purge_disk`` (a clean end only) also removes the persisted
        checkpoint, which a re-init must keep (a new process resumes from
        it)."""
        self._seq = 0
        self._next_seq = 0
        self._drained_seq = -1
        with self._rlog_lock:
            for e in self._rlog:
                for h in e[3]:
                    h.release()
            self._rlog.clear()
        self._ckpts.clear()
        self._pending_ckpts.clear()
        self._replay_queue.clear()
        self._replay_high = -1
        self._retune_log.clear()
        self._replay_retunes.clear()
        self._wire_log.clear()
        self._replay_wire_switches.clear()
        self._wire_floor_fmt = self.wire.name
        self._wire_switch_target = None
        if self._wirectl is not None:
            self._wirectl.reset()
        if purge_disk and self._ckpt_dir:
            path = self._ckpt_file()

            def purge():
                try:
                    os.unlink(path)
                except OSError:
                    pass

            # behind any write still queued on the one persistence worker
            self._persist_submit(purge)

    # -- checkpoints on disk (config checkpoint_dir) ----------------------------
    def _ckpt_file(self) -> Optional[str]:
        """This kernel's snapshot file: its instance name and a hash of its
        pipeline's signature (``utils/snapshot.py``), so a new process with
        the same flowgraph finds it and another pipeline under the same name
        does not."""
        if not self._ckpt_dir:
            return None
        name = self.meta.instance_name or type(self).__name__
        h = _snapshot.snapshot_signature(self.pipeline, name)
        return os.path.join(self._ckpt_dir,
                            f"{_snapshot.sanitize_name(name)}-{h}.ckpt.npz")

    def _persist_submit(self, fn) -> None:
        """Run a write or purge on the one persistence worker (inline with
        the codec pool off)."""
        if self._codec_pool is None:
            fn()
        else:
            _snapshot.persist_executor().submit(fn)

    def _persist_ckpt(self, seq: int, leaves) -> None:
        """Write one committed checkpoint under ``checkpoint_dir``, best
        effort, off this thread; a slow disk skips to the newest commit."""
        path = self._ckpt_file()
        if not path:
            return
        name = self.meta.instance_name
        with self._persist_lock:
            self._persist_box = (seq, leaves)
            if self._persist_queued:
                return                       # the queued write takes the newest
            self._persist_queued = True

        def write():
            with self._persist_lock:
                item, self._persist_box = self._persist_box, None
                self._persist_queued = False
            if item is not None and not _snapshot.write_snapshot(path, *item):
                log.warning("%s: checkpoint persist @%d failed", name, item[0])

        self._persist_submit(write)

    def _load_disk_ckpt(self) -> Optional[tuple]:
        """``(seq, leaves)`` of the persisted checkpoint; None when absent,
        unreadable or failing its crc32."""
        got = _snapshot.read_snapshot(self._ckpt_file() or "")
        return None if got is None else got[:2]

    def _device_lost(self, err) -> bool:
        """Is the CUDA context gone (a sticky error)? Nothing in this
        process can recover on it."""
        if any(m in str(err).lower() for m in _STICKY):
            return True
        if self.inst.device.type == "cuda":
            try:
                import torch
                torch.cuda.synchronize(self.inst.device)
            except Exception as e:         # noqa: BLE001 — the context is lost
                log.error("%s: the device is unusable (%r)", self.meta.instance_name, e)
                return True
        return False

    async def recover(self, err) -> bool:
        """Recover from ``err`` without losing the groups in flight: restore
        the newest valid committed checkpoint and queue every logged group
        after it for replay (those already emitted replay for their carry
        only); the output is the unfailed run's bit for bit. False (the
        caller then re-inits, forfeiting) with checkpoints off, with no
        valid checkpoint the log reaches, or on a lost CUDA context. A
        kernel that has dispatched nothing takes a persisted checkpoint
        (``checkpoint_dir``) first. Host state (the group being filled,
        output not yet emitted) was never lost and stays."""
        if not self._ckpt_every or not self._ckpts:
            return False
        if self._device_lost(err):
            log.error("%s: not recovering from a sticky CUDA error (%r)",
                      self.meta.instance_name, err)
            return False
        self._quiesce()
        fresh = self.pipeline.init_carry(self.inst.device)
        spec = self.pipeline.carry_spec(fresh)
        if self._seq == 0 and not self._rlog and self._ckpt_dir:
            disk = self._load_disk_ckpt()
            if disk is not None:
                seq_d, leaves_d = disk
                if self.pipeline.carry_matches(leaves_d, spec, fresh):
                    self._drop_window()
                    with self._carry_lock:
                        self._carry = self.pipeline.restore_carry(leaves_d, spec,
                                                                  self.inst.device)
                    self._pending_ckpts.clear()
                    self._replay_queue.clear()
                    self._replay_retunes.clear()
                    self._replay_wire_switches.clear()
                    self._wire_switch_target = None
                    # the disk carry is this incarnation's pre-stream restore
                    # point from now on
                    self._ckpts.clear()
                    self._ckpts.append((-1, [np.asarray(x) for x in leaves_d], spec))
                    log.info("%s: restored the carry persisted at group %d (%s) "
                             "after %r", self.meta.instance_name, seq_d,
                             self._ckpt_file(), err)
                    return True
                log.warning("%s: the persisted checkpoint does not fit the carry "
                            "(pipeline changed?): ignored", self.meta.instance_name)
        chosen, invalid = None, set()
        for seq, leaves, lspec in reversed(list(self._ckpts)):
            if leaves is None:               # the fresh-init sentinel
                if not self._rlog or self._rlog[0][0] == 0:
                    chosen = (seq, None, None)
                    break
                invalid.add(seq)
                continue
            if not self.pipeline.carry_matches(leaves, lspec, fresh):
                log.warning("%s: checkpoint @%d failed its integrity check: falling "
                            "back to the previous one", self.meta.instance_name, seq)
                invalid.add(seq)
                continue
            if self._rlog and self._rlog[0][0] > seq + 1:
                log.warning("%s: checkpoint @%d is not contiguous with the replay log "
                            "(from %d)", self.meta.instance_name, seq, self._rlog[0][0])
                invalid.add(seq)
                continue
            chosen = (seq, leaves, lspec)
            break
        if invalid:
            self.checkpoints_rejected += len(invalid)
            # a rejected candidate never becomes a later recovery's fallback
            self._ckpts = deque((c for c in self._ckpts if c[0] not in invalid), maxlen=2)
        if chosen is None:
            return False
        seq, leaves, lspec = chosen
        self._drop_window()
        with self._carry_lock:
            # new tensors: the program copies them into its static carry
            # buffers before its next replay (no new capture)
            self._carry = fresh if leaves is None else \
                self.pipeline.restore_carry(leaves, lspec, self.inst.device)
            self._next_seq = seq + 1
            # the surgery after the restore point, again at its groups
            self._replay_retunes = deque(e for e in self._retune_log if e[0] > seq)
        # the wire of the first replayed group, and the switches after it
        self._wire_switch_target = None
        fmt = self._wire_floor_fmt
        for s, f in self._wire_log:
            if s <= seq + 1:
                fmt = f
        self._replay_wire_switches = deque((s, f) for s, f in self._wire_log if s > seq + 1)
        self._apply_wire_program(fmt, replay=True)
        if self._wirectl is not None:
            self._wirectl.reset()
        self._pending_ckpts.clear()
        self._replay_queue.clear()
        replayed = 0
        with self._rlog_lock:
            entries = list(self._rlog)
        for s, parts, metas, handles in entries:
            if s <= seq:
                continue
            self._replay_queue.append((s, parts, metas, handles, s <= self._drained_seq))
            self._replay_high = max(self._replay_high, s)
            replayed += len(metas)
        self.frames_replayed += replayed
        log.info("%s: restored the carry checkpoint @%d, replaying %d frame(s) after %r",
                 self.meta.instance_name, seq, replayed, err)
        return True


class _PathRatio:
    """Rate shim for :func:`rebase_frame_tags` (it reads only ``.ratio``):
    one branch's or sink's tag ratio."""

    __slots__ = ("ratio",)

    def __init__(self, ratio):
        self.ratio = ratio


class TpuFanoutKernel(TpuKernel):
    """One dispatch driving N branch stream outputs: the block form of
    :class:`~futuresdr_tpu_torch.ops.stages.FanoutPipeline`. The input frame
    crosses the link once, the producer runs once, and branch ``j``'s result
    streams out of ``outputs[j]`` (ports ``out0`` … ``out{N-1}``).

    Staging, megabatch K, credits, program slots and the wire are
    :class:`TpuKernel`'s, unchanged: the input crosses the link once, and
    each branch encodes its own output; the result side (one D2H of a
    branch's parts, the landing, the emit and the tag rebase through the
    branch's own rate) works a branch at a time.
    :meth:`retire_branch` drops a branch whose reader detached while the
    others keep streaming; the device-chain drive loop calls it. Run as a
    plain actor block, the block event loop cannot tell which output's
    reader detached, so the first one to detach finishes the whole block,
    as in the reference."""

    def __init__(self, fanout, frame_size: Optional[int] = None,
                 inst: Optional[TpuInstance] = None,
                 frames_in_flight: Optional[int] = None,
                 frames_per_dispatch: Optional[int] = None, wire=None,
                 checkpoint_every: Optional[int] = None,
                 interior_precision: Optional[str] = None):
        nb = fanout.n_branches
        self._pendings: List[Optional[np.ndarray]] = [None] * nb
        self._pending_tags_n: List[List[ItemTag]] = [[] for _ in range(nb)]
        self._branch_done = [False] * nb
        super().__init__((), fanout.in_dtype, frame_size=frame_size, inst=inst,
                         frames_in_flight=frames_in_flight,
                         frames_per_dispatch=frames_per_dispatch, wire=wire,
                         checkpoint_every=checkpoint_every,
                         interior_precision=interior_precision, _pipeline=fanout)

    def _add_outputs(self) -> None:
        fo = self.pipeline
        self.out_frames = [fo.branch_out_items(j, self.frame_size)
                           for j in range(fo.n_branches)]
        self.outputs = [
            self.add_stream_output(
                f"out{j}", fo.out_dtypes[j], min_items=of,
                min_buffer_size=(self.depth * self.k_batch + 1) * of *
                np.dtype(fo.out_dtypes[j]).itemsize)
            for j, of in enumerate(self.out_frames)]
        self.output = self.outputs[0]

    async def init(self, mio, meta):
        nb = self.pipeline.n_branches
        self._pendings = [None] * nb
        self._pending_tags_n = [[] for _ in range(nb)]
        self._branch_done = [False] * nb
        await super().init(mio, meta)

    def retire_branch(self, j: int) -> None:
        """Stop emitting branch ``j`` (its reader detached): its frames are
        dropped from now on and the other branches keep streaming. Once every
        branch is retired, the next ``work`` finishes the block."""
        self._branch_done[j] = True
        self._pendings[j] = None
        self._pending_tags_n[j] = []

    def extra_metrics(self) -> dict:
        m = super().extra_metrics()
        m["branches"] = self.pipeline.n_branches
        m["branches_live"] = sum(not d for d in self._branch_done)
        return m

    def _start_result_d2h(self, ys, metas, wire) -> tuple:
        """One D2H a live branch, of its slice of the flat output parts
        (:meth:`FanoutPipeline.part_counts`); one ``(valid_out, rebased
        tags)`` a branch a frame, each branch's tags rebased through its tag
        ratio (a DAG's primary chain through a merge), a sink past a
        ``concat`` merge emitting full frames only."""
        fo = self.pipeline
        tag_ratios = getattr(fo, "tag_ratios", None) or fo.path_ratios
        concat = getattr(fo, "concat_sinks", None)
        out_metas = []
        for valid_in, tags in metas:
            per_branch = []
            for j in range(fo.n_branches):
                valid_out = min(fo.branch_out_items(j, valid_in), self.out_frames[j])
                if concat and concat[j] and valid_in < self.frame_size:
                    valid_out = 0
                per_branch.append((valid_out, rebase_frame_tags(
                    tags, _PathRatio(tag_ratios[j]), valid_out)))
            out_metas.append(per_branch)
        fins, off = [], 0
        for j, n in enumerate(self._part_counts):
            fins.append(None if self._branch_done[j]
                        else xfer.start_host_transfer_parts(ys[off:off + n]))
            off += n
        return self._landing(fins, out_metas, wire), out_metas

    def _decode_group(self, raws, out_metas, wire) -> list:
        """Each live branch's flat valid outputs (None for a retired one)."""
        return [None if raw is None else
                self._decode_rows(raw, [pb[j][0] for pb in out_metas],
                                  self.pipeline.out_dtypes[j], wire)
                for j, raw in enumerate(raws)]

    def _drain_branches(self) -> None:
        """Land the oldest group and emit it into every live branch (a
        replayed group emitted before the fault emits nothing), then mark it
        drained."""
        d = self._inflight.popleft()
        land, release = d.land
        flats = land()
        if not d.drop:
            for j, flat in enumerate(flats):
                if flat is None or self._branch_done[j]:
                    continue
                tags = [ItemTag(t.index + i * self.out_frames[j], t.tag)
                        for i, pb in enumerate(d.out_metas) for t in pb[j][1]]
                self._pendings[j], self._pending_tags_n[j] = emit_with_tags(
                    self.outputs[j], flat, tags)
        release()
        self._release_group(d.slot, d.held)
        self._note_drained(d.seq)

    async def work(self, io, mio, meta):
        nb = self.pipeline.n_branches
        # 1. output that did not fit last time; park while any live branch
        #    is blocked downstream (its consume() wakes us)
        blocked = False
        for j in range(nb):
            if not self._branch_done[j] and self._pendings[j] is not None:
                self._pendings[j], self._pending_tags_n[j] = emit_with_tags(
                    self.outputs[j], self._pendings[j], self._pending_tags_n[j])
                blocked = blocked or self._pendings[j] is not None
        if blocked:
            return
        if all(self._branch_done):
            io.finished = True               # every reader detached
            return

        # 2. stage, 3. replay and start the D2Hs (TpuKernel's)
        inp, eos = self._stage_available_input()
        self._launch_staged()

        # 4. drain the oldest group into every live branch
        if self._inflight and (len(self._inflight) >= self._credits.credits
                               or len(inp) < self.frame_size or eos
                               or self._switch_pending()):
            self._drain_branches()
            io.call_again = True
            return

        if eos and self._idle(inp) and all(p is None for p in self._pendings):
            io.finished = True
            self._recovery_reset(purge_disk=True)


class TpuDagKernel(TpuFanoutKernel):
    """One dispatch driving a device DAG's sinks: the block form of
    :class:`~futuresdr_tpu_torch.ops.stages.DagPipeline` (nested fan-out,
    fan-in through a merge, the diamond). Sink ``j`` streams out of
    ``outputs[j]`` in the DAG's node order; tags crossing a merge follow the
    primary chain (the pipeline's ``tag_ratios``). Everything else is
    :class:`TpuFanoutKernel`'s. The reference compiles its K > 1 DAG
    programs without carry donation (an XLA aliasing choice changed a
    sink's rounding there); a CUDA graph's static carry buffers are written
    once a replay at every K, so there is nothing to turn off here."""
