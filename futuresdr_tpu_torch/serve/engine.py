"""ServeEngine: N concurrent sessions of one receiver chain, one dispatch a
frame time.

The port of ``futuresdr_tpu/serve/engine.py``. A fused ``Pipeline``,
``FanoutPipeline`` or ``DagPipeline`` computes one session a dispatch on the
streamed path; the engine serves N sessions running the same chain through a
single per-frame dispatch, the pipeline built once per slot bucket with a
leading session axis:

* ``torch.func.vmap`` over the inputs and the flat carry: the carry of each
  lane keeps the linear layout, so ``update_stage`` addressing and the
  snapshot surface (``snapshot_carry``/``carry_matches``/``restore_carry``)
  work per slot; the hand kernels run under vmap through their custom ops,
  ``fir``, ``fir_fft`` and ``rotator`` as one launch of their lane forms
  (``ops/cuda_kernels.py``);
* ragged admission: a fixed-capacity slot axis, inactive lanes masked by an
  ``active`` vector, so sessions join, leave and stall with no new capture
  of a resident bucket (``self.compiles`` counts the builds);
* paged carries: each lane's carry lives in a page pool indexed by the
  :class:`~.slots.SlotTable`'s lane→page permutation; the program gathers
  each lane's page, substitutes the fresh template on ``fresh`` lanes, steps,
  and scatters back, so a join is a page-map edit and eviction reads one page;
* the overlapped step: a group launched at step t rides async
  ``start_device_transfer`` H2D and ``start_host_transfer`` D2H, governed by
  ``tpu/kernel_block.CreditController``; committed carries advance only when
  a group's D2H lands, and a failed drain re-queues every uncommitted group's
  frames;
* slot buckets from ``tpu/autotune.autotune_serve``'s cache; evict/readmit
  and durable snapshots on the checkpoint leaf contract; per-tenant fair
  credits; per-session fault isolation; the SLO shedding ladder and its
  brownout levers (megabatch K, or the interior lowered to bf16 or int8 by
  ``ops/precision.plan_interior_precision``).

**The program on a card** (:func:`build_slot_program`): one CUDA graph per
(capacity, k) captures gather, vmapped chain (k frames one after another),
masked merge and scatter, as ``CompiledPipeline`` captures a chain: an eager
warm-up on a high-priority side stream, then the capture under the process's
capture lock. ``page_map``, ``fresh``, ``active`` and the batch are static
device buffers written with ``copy_`` (or the H2D itself) before each replay;
the page pool is a static buffer the replay rewrites in place, and after each
replay the engine keeps a copy of it as the group's output pages, so the
committed pool stays apart from the speculative head at any in-flight depth
and a rollback re-seeds the static pool from the committed copy. On the CPU
the program is the same function run eagerly, out of place.

Masking: inactive lanes ride the program with zero input rows, and their
computed carries are discarded by a ``where(active, new, old)`` merge, so a
stalled lane's carry is bit-frozen; an active lane's carry is what the bare
program computes. The batch is assembled straight into the transfer's pinned
host buffer (``ops/xfer.host_buffer``, the arena's), so a frame time copies
each frame once on the host before the H2D.

Telemetry (``telemetry/``): each frame's submit→result latency feeds
``fsdr_e2e_latency_seconds{source="serve:<app>"}`` (:attr:`ServeEngine.e2e_hist`
is that child); each bucket's build is a compile of ``serve:<app>`` with
reason ``serve_bucket`` on the profile plane (:attr:`ServeEngine.compile_seconds`
keeps each build's seconds from the same window), which also bills every
session-frame as one unit of the one-lane program's analytic cost; the
engine attaches to the doctor's serve watchdog (:meth:`ServeEngine.watch_sample`,
detached by :meth:`ServeEngine.shutdown`); each step calls the fleet's tick
(one falsy check with no peers); 1 frame in ``lineage_stride`` carries a
lineage trace id. With tracing on a step records its batch assembly as
``encode``, the program call as ``compute`` and the fan-back as ``decode``
(``cat="tpu"``; the transfers record their own ``H2D``/``D2H``), and the
whole group as one ``serve_step`` span (``cat="serve"``), launch to commit.
:attr:`ServeEngine.spans` (``None``, or a list the caller sets) also keeps
the host intervals of each group's H2D, compute and D2H as ``(lane, t0, t1)``
tuples, read by :func:`overlap_report`.

**The slot axis over devices** (``shard_devices=D > 1``, config
``serve_shard_devices``): a bucket whose capacity divides by D splits its lanes
into D contiguous blocks, device ``slot // (capacity // D)`` serving lane
``slot % (capacity // D)`` of its block (:meth:`ServeEngine.slot_device`). Each
device holds its slice of the page pool (:class:`ShardedPool`) and its own slot
program (one CUDA graph a device, :class:`ShardedSlotProgram`); a group's batch,
masks and page map are split a device on the host and placed synchronously,
and each device's outputs come back by their own D2H, so no lane's data crosses
a device. The :class:`~.slots.SlotTable` binds page p to lane p (both the
lowest free), so every lane's page lives on its own device; the launch checks
it. A bucket that does not divide by D stays unsharded on the first device, and
growth across that boundary lays the pool out again. Evict, readmit, retunes and
persistence address pages as before. Every session's stream is bit-equal to the
unsharded engine's. More devices than exist are refused (``make_mesh``), unless
config ``virtual_devices`` lists logical devices.
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..log import logger
from ..ops import xfer
from ..ops.stages import _capture_lock, _from_spec, _leaves, _no_automatic_gc, _rebuild
from ..parallel.mesh import on_device
from ..runtime import faults as _faults
from ..telemetry import fleet as _fleet
from ..telemetry import journal as _journal
from ..telemetry import lineage as _lineage
from ..telemetry import profile as _profile
from ..telemetry import prom as _prom
from ..telemetry.doctor import E2E_LATENCY as _E2E_LATENCY
from ..telemetry.spans import recorder as _trace_recorder
from .credits import TenantCreditController
from .overload import LATENCY_RUNG as _LATENCY_RUNG
from .overload import ShedLadder
from .persist import SessionStore
from .slots import ServeDraining, ServeFull, ServeOverload, Session, SlotTable

__all__ = ["ServeEngine", "ServeFull", "ServeDraining", "ServeOverload",
           "SlotProgram", "ShardedSlotProgram", "ShardedPool", "build_slot_program",
           "default_buckets", "overlap_report", "drain_all_apps", "install_sigterm_drain"]

log = logger("serve.engine")
_trace = _trace_recorder()

# per-tenant Prometheus families: every family carries {app, tenant}
_SESSIONS = _prom.gauge(
    "fsdr_serve_sessions", "live serving sessions per state", ("app", "tenant", "state"))
_FRAMES = _prom.counter(
    "fsdr_serve_frames_total", "frames dispatched through the serving plane",
    ("app", "tenant"))
_DISPATCHES = _prom.counter(
    "fsdr_serve_dispatches_total",
    "batched serving dispatches (one per step with >= 1 active lane)", ("app",))
_RETIRED = _prom.counter(
    "fsdr_serve_retired_total", "sessions retired by a per-session fault (slot-isolated)",
    ("app", "tenant"))
_EVICTIONS = _prom.counter(
    "fsdr_serve_evictions_total", "session carries evicted to the host", ("app", "tenant"))
_REJECTS = _prom.counter(
    "fsdr_serve_rejects_total", "frame submissions refused by the per-tenant credit guard",
    ("app", "tenant"))
_LATENCY = _prom.histogram(
    "fsdr_serve_latency_seconds", "submit -> decoded-result latency per frame",
    ("app", "tenant"))
_SHED = _prom.counter(
    "fsdr_serve_shed_total",
    "overload/drain shedding actions by the serving engine "
    "(reason: admission | evict | brownout | drain)", ("app", "tenant", "reason"))
_SHED_LEVEL = _prom.gauge(
    "fsdr_serve_shed_level",
    "current shedding-ladder rung (0 ok, 1 admission, 2 evict, 3 brownout)", ("app",))
_RESUMED = _prom.counter(
    "fsdr_serve_resumed_total",
    "sessions re-admitted from durable snapshots by a fresh incarnation", ("app", "tenant"))

#: the host-interval lanes of :attr:`ServeEngine.spans`
PIPELINE_LANES = ("H2D", "compute", "D2H")


def default_buckets() -> tuple:
    """The slot-bucket ladder when neither the caller nor the autotune cache
    gives one: config ``serve_buckets`` ("1,2,4,…"), else powers of two to
    64."""
    from ..config import config
    spec = str(config().serve_buckets or "").strip()
    if spec:
        try:
            out = sorted({int(x) for x in spec.replace(";", ",").split(",") if x.strip()})
            if out and all(b > 0 for b in out):
                return tuple(out)
        except ValueError:
            log.warning("bad serve_buckets spec %r — using the default ladder", spec)
    return (1, 2, 4, 8, 16, 32, 64)


def _host_leaf(t: torch.Tensor) -> np.ndarray:
    """One device leaf as a host array of its own, in the snapshot leaf
    contract (a bfloat16 leaf as its int16 bits)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return xfer.to_host(t.contiguous())


def _mask(m: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return m.reshape((m.shape[0],) + (1,) * (like.dim() - 1))


def _slot_step(pipeline, template: list, k: int):
    """The slot program as a function of tensors:

        step(pages, page_map, fresh, x, active) -> (pages', outs)

    ``pages`` the flat pool leaves ``[C, …]``; ``outs`` a tuple, one
    ``[C, out]`` (``[C, k, out]``) a sink. Shared by the eager CPU program
    and the CUDA graph's capture."""
    tree = pipeline.init_carry("cpu")          # the carry's structure
    lane_fn = torch.func.vmap(pipeline.fn())
    multi = bool(getattr(pipeline, "n_branches", 0))

    def gather(pages, page_map, fresh):
        out = []
        for P, t in zip(pages, template):
            c = P.index_select(0, page_map)
            out.append(torch.where(_mask(fresh, c), t.unsqueeze(0), c))
        return out

    def lane_step(leaves, x, active):
        new_c, y = lane_fn(_rebuild(tree, iter(leaves)), x)
        merged = [torch.where(_mask(active, n), n, o)
                  for n, o in zip(_leaves(new_c), leaves)]
        return merged, (y if multi else (y,))

    def step(pages, page_map, fresh, x, active):
        c = gather(pages, page_map, fresh)
        if k <= 1:
            c, outs = lane_step(c, x, active)
        else:
            cols = None
            for j in range(k):
                c, ys = lane_step(c, x[:, j], active[:, j])
                cols = [[y] for y in ys] if cols is None else \
                    [col + [y] for col, y in zip(cols, ys)]
            outs = tuple(torch.stack(col, dim=1) for col in cols)
        return [P.index_copy(0, page_map, v) for P, v in zip(pages, c)], outs

    return step


class SlotProgram:
    """:func:`build_slot_program`'s program for one (capacity, k):
    ``prog(pages, page_map, fresh, x, active) -> (pages', outs)``, every pool
    leaf with a leading ``[capacity]`` page axis, ``page_map`` the lane→page
    permutation (int64), ``fresh`` and ``active`` bool (``active`` ``[C, k]``
    for k > 1), ``x`` ``[C, frame]`` (``[C, k, frame]``).

    On a card it replays one CUDA graph: the page pool is a static buffer
    (:attr:`pool`) the replay rewrites in place, and the returned pages are a
    copy of it taken after the replay (the group's output pages, which later
    replays do not touch). Pages other than those the last call returned are
    copied into the static pool first. ``outs`` are the graph's static output
    buffers (the next replay overwrites them; ``clone_outputs=True`` returns
    copies). :attr:`inputs` are the static ``(x, active, page_map, fresh)``
    buffers: a caller may write them itself (an H2D straight into them) and
    pass them back. :attr:`launches` holds the hand kernels' launches a
    replay makes. On the CPU the program is the eager function."""

    def __init__(self, pipeline, capacity: int, k: int, frame_size: int, device):
        from ..ops.xfer import torch_dtype
        self.capacity, self.k, self.frame_size = int(capacity), int(k), int(frame_size)
        self.device = torch.device(device)
        self.template = [t.clone() for t in _leaves(pipeline.init_carry(self.device))]
        self._step = _slot_step(pipeline, self.template, self.k)
        self.launches: dict = {}
        self.captured = self.device.type == "cuda"
        lead = (self.capacity,) if self.k <= 1 else (self.capacity, self.k)
        self._holds = None
        if self.captured:
            self.inputs = (torch.zeros(lead + (self.frame_size,),
                                       dtype=torch_dtype(pipeline.in_dtype), device=self.device),
                           torch.zeros(lead, dtype=torch.bool, device=self.device),
                           torch.arange(self.capacity, dtype=torch.int64, device=self.device),
                           torch.zeros(self.capacity, dtype=torch.bool, device=self.device))
            self.pool = [t.unsqueeze(0).repeat((self.capacity,) + (1,) * t.dim())
                         for t in self.template]
            self._capture()

    def _capture(self) -> None:
        from ..ops import cuda_kernels
        x, act, pmap, fresh = self.inputs
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device, priority=-1)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._step([p.clone() for p in self.pool], pmap, fresh, x, act)
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with _capture_lock, _no_automatic_gc(), cuda_kernels.capturing() as counts:
            try:
                with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                    new, outs = self._step(self.pool, pmap, fresh, x, act)
                    for P, n in zip(self.pool, new):
                        P.copy_(n)
            except RuntimeError as e:
                raise RuntimeError(f"build_slot_program: the CUDA graph capture of the "
                                   f"capacity-{self.capacity} slot program failed: {e}") from e
        self._graph, self.outs = graph, outs
        self.launches = {name: n for name, n in counts.items() if n}

    def __call__(self, pages, page_map, fresh, x, active, clone_outputs: bool = False):
        if not self.captured:
            return self._step(pages, page_map, fresh, x, active)
        from ..ops import cuda_kernels
        if pages is not self._holds:
            for P, p in zip(self.pool, pages):
                P.copy_(p)
        for dst, src in zip(self.inputs, (x, active, page_map, fresh)):
            if src is not dst:
                dst.copy_(src)
        self._graph.replay()
        for name, n in self.launches.items():
            cuda_kernels.launches[name] += n
        new = [P.clone() for P in self.pool]
        self._holds = new
        outs = tuple(o.clone() for o in self.outs) if clone_outputs else self.outs
        return new, outs


class ShardedPool:
    """A page pool split over devices: ``parts[d]`` holds the flat leaves of
    pages ``[d·per, (d+1)·per)`` on device d."""

    __slots__ = ("parts", "per")

    def __init__(self, parts: list, per: int):
        self.parts, self.per = parts, int(per)

    def rows(self, page: int) -> list:
        d, i = divmod(int(page), self.per)
        return [P[i] for P in self.parts[d]]

    def with_page(self, page: int, leaves: list) -> "ShardedPool":
        d, i = divmod(int(page), self.per)
        new = []
        for P, v in zip(self.parts[d], leaves):
            P = P.clone()
            P[i] = v.to(P.device)
            new.append(P)
        return ShardedPool(self.parts[:d] + [new] + self.parts[d + 1:], self.per)


class _GatherFinish:
    """The D2H finishes of one sink's D shards as one: the host rows
    concatenated in device order."""

    _wire = None

    def __init__(self, fins: list):
        self._fins = fins

    def __call__(self) -> np.ndarray:
        return np.concatenate([np.asarray(f()) for f in self._fins])

    def release(self) -> None:
        for f in self._fins:
            f.release()


class ShardedSlotProgram:
    """The slot program of a bucket sharded over ``devices``: one
    :class:`SlotProgram` of ``capacity // D`` lanes a device (on a card each
    its own CUDA graph, built and replayed under its card).
    ``prog(pool, page_map, fresh, x, active) -> (pool', outs)`` takes the
    group's host arrays (``x`` ``[C, frame]`` or ``[C, k, frame]``), splits
    them a device and places them synchronously; ``pool`` is a
    :class:`ShardedPool`, and ``outs`` a tuple, a sink, of the D devices'
    outputs."""

    def __init__(self, pipeline, capacity: int, k: int, frame_size: int, devices):
        self.capacity, self.k = int(capacity), int(k)
        self.devices = [torch.device(d) for d in devices]
        self.per = self.capacity // len(self.devices)
        self.programs = []
        for d in self.devices:
            with on_device(d):
                self.programs.append(SlotProgram(pipeline, self.per, k, frame_size, d))
        self.captured = self.programs[0].captured
        self.launches = {}
        for p in self.programs:
            for name, n in p.launches.items():
                self.launches[name] = self.launches.get(name, 0) + n

    def __call__(self, pool: ShardedPool, page_map, fresh, x, active,
                 clone_outputs: bool = False):
        page_map, fresh, x, active = (np.asarray(a) for a in (page_map, fresh, x, active))
        parts, outs = [], []
        for i, (prog, d) in enumerate(zip(self.programs, self.devices)):
            lo, hi = i * self.per, (i + 1) * self.per
            local = page_map[lo:hi] - lo
            if local.size and (local.min() < 0 or local.max() >= self.per):
                raise RuntimeError("ShardedSlotProgram: a lane's carry page lives on "
                                   "another device (the slot table binds page p to "
                                   "lane p)")
            args = [torch.from_numpy(np.ascontiguousarray(a)).to(d) for a in
                    (local.astype(np.int64), fresh[lo:hi], x[lo:hi], active[lo:hi])]
            with on_device(d):
                new, o = prog(pool.parts[i], *args, clone_outputs=clone_outputs)
            parts.append(new)
            outs.append(o)
        return ShardedPool(parts, self.per), tuple(list(col) for col in zip(*outs))


def build_slot_program(pipeline, capacity: int, k: int, frame_size: int,
                       device) -> SlotProgram:
    """Build the paged, lane-batched serving step of ``pipeline`` for one
    page-pool capacity (:class:`SlotProgram`):

        step(pages, page_map, fresh, x, active) -> (pages', outs)

    ``page_map`` is the lane→page permutation of ``[0, capacity)`` the
    :class:`~.slots.SlotTable` keeps (a duplicate page would make the
    scatter's result order-undefined); ``fresh`` flags lanes admitted since
    the last dispatch, whose gathered page is replaced by the chain's
    init-carry template inside the program. ``k > 1`` is the megabatch form:
    the k frames of each lane one after another, ``active`` a per-frame mask
    (a lane's frames pack at the front). Inactive lanes keep their old
    carry; fresh lanes scatter the template back. On a card (``device``) one
    CUDA graph (capacity, k). Shared with ``tpu/autotune.autotune_serve``, so
    the measured program is the served one."""
    return SlotProgram(pipeline, capacity, k, frame_size, device)


def overlap_report(spans: Sequence[tuple], names: Sequence[str] = PIPELINE_LANES) -> dict:
    """Overlap of a run's H2D, compute and D2H host intervals (``spans``:
    ``(lane, t0, t1)`` tuples, :attr:`ServeEngine.spans`): ``ratio = union
    of all lanes / sum of the intervals``, 1.0 when they ran one after
    another; each lane's count and busy seconds."""
    def union(iv):
        total, cur_s, cur_e = 0.0, None, 0.0
        for s, e in sorted(iv):
            if cur_s is None or s > cur_e:
                if cur_s is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            elif e > cur_e:
                cur_e = e
        return total + (cur_e - cur_s if cur_s is not None else 0.0)

    per = {n: [(s, e) for lane, s, e in spans if lane == n] for n in names}
    all_iv = [iv for v in per.values() for iv in v]
    total = sum(e - s for s, e in all_iv)
    u = union(all_iv)
    return {"sum_s": total, "union_s": u, "ratio": (u / total) if total else 1.0,
            "lanes": {n: {"spans": len(iv), "busy_s": union(iv)} for n, iv in per.items()}}


class _DispatchGroup:
    """One launched, uncommitted dispatch: the batch bookkeeping assembled at
    step t, the output pages the program produced, the pending D2H
    finishes. Committed oldest first; a failed drain rolls the whole chain
    back (each younger group derived its pages from this one's)."""

    __slots__ = ("capacity", "k", "lanes", "n_frames", "batch", "active", "fresh",
                 "page_map", "fresh_lanes", "new_pages", "fins", "wire", "step_tids",
                 "t_step")

    def __init__(self, capacity: int, k: int, lanes: list, batch, active, fresh,
                 page_map, fresh_lanes: frozenset, step_tids=(), t_step: int = 0):
        self.capacity = capacity
        self.k = k
        self.lanes = lanes            # (session, lane, popped, trace ids) tuples
        self.step_tids = step_tids    # the lineage-sampled frames of the group
        self.t_step = t_step          # the serve_step span's start (0: tracing off)
        self.n_frames = sum(len(ln[2]) for ln in lanes)
        self.batch = batch
        self.active = active
        self.fresh = fresh
        self.page_map = page_map
        self.fresh_lanes = fresh_lanes
        self.new_pages = None         # set by launch
        self.fins = None              # pending D2H finishes, one a sink
        self.wire = None              # the H2D's (service, deadline) window


class ServeEngine:
    """Multi-tenant serving front-end over one compiled receiver program.

    Host-driven: a serving loop calls :meth:`step` once a frame time; the
    REST session plane (``serve/api.py``) and any thread may ``admit``/
    ``submit``/``evict``/``close`` concurrently. ``device`` (or ``inst``, a
    ``tpu/instance.TpuInstance``) places the pool and the programs: the card
    by default, the CPU only when asked (``device="cpu"``).
    """

    def __init__(self, pipeline, frame_size: Optional[int] = None, app: str = "serve",
                 inst=None, buckets: Optional[Sequence[int]] = None,
                 queue_frames: Optional[int] = None, frames_per_dispatch: int = 1,
                 persist_dir: Optional[str] = None, persist_every: Optional[int] = None,
                 slo_ms: Optional[float] = None, shard_devices: Optional[int] = None,
                 inflight: Optional[int] = None, device=None):
        from ..config import config
        from ..tpu.instance import TpuInstance, instance
        c = config()
        sd = int(shard_devices if shard_devices is not None else c.serve_shard_devices or 0)
        self.pipeline = pipeline
        self._base_pipeline = pipeline     # the pre-brownout program's pipeline
        self.app = str(app)
        if inst is None:
            inst = TpuInstance(device) if device is not None else instance()
        self.inst = inst
        self.device = torch.device(inst.device)
        # the slot axis over devices (module docstring): refused loudly when
        # more devices are asked for than exist
        self._shard_d = max(1, sd)
        self._shard_mesh = None
        self._shard_devs: list = []
        if self._shard_d > 1:
            from ..shard.data import shard_mesh
            self._shard_mesh = shard_mesh(self._shard_d, device=self.device)
            self._shard_devs = self._shard_mesh.line(self._shard_mesh.axis_names[0])
        self.k_batch = max(1, int(frames_per_dispatch))
        m = pipeline.frame_multiple
        fs = frame_size or c.tpu_frame_size
        self.frame_size = max(m, (fs // m) * m)
        self._multi = bool(getattr(pipeline, "n_branches", 0))
        tuned = buckets is None
        if tuned:
            buckets = self._cached_buckets()
        self.buckets = tuple(sorted({int(b) for b in buckets})) if buckets \
            else default_buckets()
        #: programs keyed (capacity, k, pipeline tag): churn never adds one
        self._programs: Dict[tuple, SlotProgram] = {}
        self.compiles = 0                 # program builds (captures on a card)
        #: seconds each build took (its capture on a card), keyed as
        #: _programs: the profile plane's compile window of the build
        self.compile_seconds: Dict[tuple, float] = {}
        start_cap = self.buckets[0]
        if tuned:
            # the cache's page-pool pick (serve_pages) seeds the pool, so a
            # restart reaches its steady capacity with one build (the
            # reference tests the caller's argument after replacing it with
            # the cached ladder, and never reads this pick)
            start_cap = self._cached_pages() or start_cap
        self.table = SlotTable(start_cap)
        self._fresh = None                # the fresh one-lane carry leaves
        self._spec = None                 # its carry spec (the snapshot treedef)
        #: the committed page pool: one carry page a slot, indexed by the
        #: table's lane→page permutation; advances only when a group lands
        self._pages = self._stacked_fresh(self.table.capacity)
        #: the speculative head: the newest launched group's output pages
        self._head_pages = self._pages
        #: lanes admitted since their first dispatch (fresh-template lanes)
        self._fresh_lanes: set = set()
        per_slot = int(queue_frames if queue_frames is not None else c.serve_queue_frames)
        self._queue_frames = max(1, per_slot)
        self.credits = TenantCreditController(self._queue_frames * self.table.capacity)
        from ..tpu.kernel_block import CreditController
        depth = max(1, int(inflight if inflight is not None else c.serve_inflight))
        self._depth = depth
        self._flight = CreditController(depth, adaptive=depth > 1)
        self._inflight: Deque = deque()   # launched, uncommitted groups
        #: step lock (always taken before _lock): steppers hold it across
        #: launch and drain, page surgery takes it and drains first
        self._step_lock = threading.RLock()
        #: state lock: table and queues only, never across a program call
        self._lock = threading.RLock()
        self._ticking = False
        self._retired_keep = max(0, int(c.serve_retired_keep))
        self._retired: List[str] = []
        self.steps = 0                    # step() calls (idle ones too)
        self.dispatches = 0               # steps that launched the program
        self.frames = 0                   # session-frames dispatched
        self._gauge_cache: Dict[tuple, object] = {}
        self._warmed: set = set()
        # per-frame submit→result latency of every lane, on the streamed
        # kernels' family
        self._e2e_hist = _E2E_LATENCY.labels(source=f"serve:{self.app}")
        # the live roofline's unit is one session-frame: the one-lane
        # program's analytic cost, counted when the plane is read
        pipe, fs = pipeline, self.frame_size

        def lane_cost():
            from ..utils.roofline import program_cost
            return program_cost(pipe, fs)

        from ..utils.roofline import dominant_dtype
        self._prof = _profile.register(f"serve:{self.app}", cost_thunk=lane_cost,
                                       dtype=dominant_dtype(pipe.stages))
        #: None, or a deque of (lane, t0, t1) host intervals of each group's
        #: H2D, compute and D2H (:func:`overlap_report`); set it to record
        self.spans: Optional[Deque] = None
        d = persist_dir if persist_dir is not None else c.serve_persist_dir
        d = str(d or "")
        self._store = SessionStore(d, self.app, pipeline) if d else None
        self._persist_every = max(0, int(persist_every if persist_every is not None
                                         else c.serve_persist_every))
        self._steps_since_persist = 0
        self._draining = False
        self._drained = False
        self._slo_ms = float(slo_ms if slo_ms is not None else c.serve_slo_ms)
        self._ladder = ShedLadder.from_config()
        self._brownout = str(c.serve_brownout or "off")
        bp = str(c.serve_brownout_precision or "bf16")
        self._brownout_prec = bp if bp in ("bf16", "int8") else "bf16"
        self._brownout_active = False
        self._low_pipe = None
        self._pipe_tag = "base"
        self._base_dt = None
        self._lat_recent: Deque[float] = deque(maxlen=128)   # seconds
        self._step_stamps: Deque[float] = deque(maxlen=32)   # busy-step times
        self.restored_sessions = 0
        self.shed_evictions = 0
        # the doctor's serve watchdog holds the engine by weakref, so an
        # engine that is dropped detaches itself
        self._doctor_token = None
        try:
            from ..telemetry import doctor as _doctor
            self._doctor_token = _doctor.doctor().attach_serve(self)
        except Exception as e:             # noqa: BLE001 — observability only
            log.warning("%s: doctor attach failed: %r", self.app, e)
        if self._store is not None:
            self._restore_persisted()

    # -- carry plumbing --------------------------------------------------------
    def _fresh_carry(self) -> list:
        """The fresh one-lane carry, flat leaves on the engine's device."""
        if self._fresh is None:
            carry = self.pipeline.init_carry(self.device)
            self._fresh = _leaves(carry)
            self._spec = self.pipeline.carry_spec(carry)
        return self._fresh

    def _fresh_tree(self):
        self._fresh_carry()
        return _from_spec(self._spec, iter(self._fresh))

    def _stacked_fresh(self, capacity: int):
        """A pool of ``capacity`` fresh pages, laid out for that capacity."""
        return self._layout([t.unsqueeze(0).repeat((capacity,) + (1,) * t.dim())
                             for t in self._fresh_carry()], capacity)

    def _shard_ok(self, capacity: int) -> bool:
        """Does a bucket of this capacity split over the slot-axis devices?"""
        return self._shard_d > 1 and capacity % self._shard_d == 0

    def slot_device(self, slot: int) -> tuple:
        """The ``(device index, lane)`` a slot addresses under the slot-axis
        sharding (``(0, slot)`` unsharded)."""
        if not self._shard_ok(self.table.capacity):
            return (0, int(slot))
        per = self.table.capacity // self._shard_d
        return (int(slot) // per, int(slot) % per)

    def _layout(self, leaves: list, capacity: int):
        """Global pool leaves ``[capacity, …]`` laid out for ``capacity``: a
        :class:`ShardedPool` over the devices when the bucket shards (each
        block copied to its device), else the leaves on the engine's device."""
        if not self._shard_ok(capacity):
            return [P.to(self.device) for P in leaves]
        per = capacity // self._shard_d
        return ShardedPool([[P[i * per:(i + 1) * per].to(d, copy=True) for P in leaves]
                            for i, d in enumerate(self._shard_devs)], per)

    def _global(self, pool) -> list:
        """A pool's leaves ``[capacity, …]`` on the engine's device."""
        if not isinstance(pool, ShardedPool):
            return pool
        return [torch.cat([part[j].to(self.device) for part in pool.parts])
                for j in range(len(pool.parts[0]))]

    def _rows(self, pool, page: int) -> list:
        if isinstance(pool, ShardedPool):
            return pool.rows(page)
        return [P[page] for P in pool]

    def _set_page(self, page: int, leaves: list) -> None:
        """Write one page of the committed pool (readmit, restore, retune) at
        a quiescent boundary; the head re-syncs to the committed pool."""
        assert not self._inflight, "page write with groups in flight"
        if isinstance(self._pages, ShardedPool):
            self._pages = self._pages.with_page(page, leaves)
        else:
            new = []
            for P, v in zip(self._pages, leaves):
                P = P.clone()
                P[page] = v.to(P.device)
                new.append(P)
            self._pages = new
        self._head_pages = self._pages

    def _page_leaves(self, page: int) -> tuple:
        """One committed page as host leaves and the carry spec (the
        ``snapshot_carry`` leaf contract, which ``carry_matches`` and
        ``restore_carry`` read)."""
        self._fresh_carry()
        return [_host_leaf(t) for t in self._rows(self._pages, page)], self._spec

    def _fresh_host_leaves(self) -> tuple:
        """The fresh template as host leaves: what a still-fresh lane's page
        holds after its first ride (its page bits are stale until then)."""
        return [_host_leaf(t) for t in self._fresh_carry()], self._spec

    def _session_leaves(self, s: Session) -> tuple:
        if s.slot is not None and s.slot in self._fresh_lanes:
            return self._fresh_host_leaves()
        return self._page_leaves(s.page)

    @property
    def _k_eff(self) -> int:
        """The megabatch K this step runs at: 1 under an active "k" brownout."""
        if self._brownout_active and self._brownout == "k":
            return 1
        return self.k_batch

    @property
    def e2e_hist(self):
        """The per-frame submit→result latency of this app's lanes: the
        ``fsdr_e2e_latency_seconds{source="serve:<app>"}`` child (a log2
        histogram)."""
        return self._e2e_hist

    def _program(self, capacity: int, k: Optional[int] = None) -> SlotProgram:
        k = self.k_batch if k is None else int(k)
        key = (capacity, k, self._pipe_tag)
        prog = self._programs.get(key)
        if prog is None:
            # the build (its capture on a card) is a compile window: the
            # doctor reads a slow one as "compiling", never as a wedge
            with _profile.compiling(f"serve:{self.app}", "serve_bucket",
                                    f"cap={capacity},k={k},frame={self.frame_size},"
                                    f"pipe={self._pipe_tag}") as win:
                if self._shard_ok(capacity):
                    prog = ShardedSlotProgram(self.pipeline, capacity, k, self.frame_size,
                                              self._shard_devs)
                else:
                    prog = build_slot_program(self.pipeline, capacity, k, self.frame_size,
                                              self.device)
            self.compile_seconds[key] = win.seconds
            self._programs[key] = prog
            self.compiles += 1
            log.info("%s: built serving program for slot bucket %d (k=%d, %s; resident "
                     "buckets: %s)", self.app, capacity, k, self._pipe_tag,
                     self.resident_buckets())
        return prog

    def resident_buckets(self) -> List[int]:
        return sorted({cap for cap, _k, _t in self._programs})

    def _cached_buckets(self) -> Optional[tuple]:
        try:
            from ..tpu.autotune import cached_serve_buckets, platform_of
            got = cached_serve_buckets(self.pipeline, self.pipeline.in_dtype,
                                       platform_of(self.device))
            return tuple(got) if got else None
        except Exception:                  # noqa: BLE001 — ladder seed only
            return None

    def _cached_pages(self) -> Optional[int]:
        """The autotune cache's page-pool capacity, honoured only when it is
        a rung of this engine's ladder."""
        try:
            from ..tpu.autotune import cached_serve_pages, platform_of
            got = cached_serve_pages(self.pipeline, self.pipeline.in_dtype,
                                     platform_of(self.device))
            return int(got) if got and int(got) in self.buckets else None
        except Exception:                  # noqa: BLE001 — pool seed only
            return None

    # -- occupancy / bucket growth ---------------------------------------------
    @property
    def capacity(self) -> int:
        return self.table.capacity

    def _grow_to_fit(self) -> None:
        """At a quiescent boundary with no free slot: grow the pool to the
        next bucket (fresh tail pages, the table's permutation extended, the
        credit budget re-sized). Resident programs stay; the new capacity
        builds once, on its first dispatch."""
        cur = self.table.capacity
        bigger = [b for b in self.buckets if b > cur]
        if not bigger:
            raise ServeFull(f"{self.app}: at the largest slot bucket ({cur}); "
                            f"admission refused")
        cap = bigger[0]
        fresh = [t.unsqueeze(0).repeat((cap - cur,) + (1,) * t.dim())
                 for t in self._fresh_carry()]
        # a new capacity may split over the devices in another way (or not
        # at all): the grown pool is laid out again
        self._pages = self._layout([torch.cat([P, e]) for P, e in
                                    zip(self._global(self._pages), fresh)], cap)
        self._head_pages = self._pages
        self.table.grow(cap)
        self.credits.set_total(self._queue_frames * cap)
        log.info("%s: page pool grew %d -> %d (active %d)", self.app, cur, cap,
                 self.table.active)

    # -- session lifecycle -----------------------------------------------------
    def _refuse_admission(self, tenant: str) -> None:
        if self._draining:
            _SHED.inc(app=self.app, tenant=tenant, reason="drain")
            _journal.emit("serve", "refuse", app=self.app, tenant=tenant, reason="drain")
            raise ServeDraining(f"{self.app}: draining — admission refused")
        if self._ladder.level >= 1:
            _SHED.inc(app=self.app, tenant=tenant, reason="admission")
            _journal.emit("serve", "refuse", app=self.app, tenant=tenant,
                          reason="overload", rung=self._ladder.rung)
            raise ServeOverload(f"{self.app}: overloaded (shed rung "
                                f"{self._ladder.rung}) — admission refused")

    def admit(self, tenant: str = "default", sid: Optional[str] = None) -> Session:
        """Join: claim a lane and bind it a page with a fresh carry; a
        host-side page-map edit (the template is substituted inside the next
        dispatch). Only pool growth quiesces the in-flight window. Raises
        :class:`ServeFull` past the largest bucket, :class:`ServeDraining`
        while draining, :class:`ServeOverload` while the ladder sheds."""
        while True:
            with self._lock:
                self._refuse_admission(tenant)
                if self.table.get(sid) is not None:
                    raise ValueError(f"session id {sid!r} already exists")
                if self.table.free_slots():
                    s = Session(tenant, sid)
                    slot = self.table.admit(s)
                    self._fresh_lanes.add(slot)
                    self.credits.register(s.tenant)
                    _journal.emit("serve", "page-admit", app=self.app, session=s.sid,
                                  tenant=s.tenant, slot=slot, page=s.page)
                    self._refresh_gauges()
                    return s
            with self._step_lock:
                self._drain_inflight(0)
                with self._lock:
                    if not self.table.free_slots():
                        self._grow_to_fit()

    def readmit(self, sid: str) -> Session:
        """Re-admit an evicted session: its host carry snapshot, checked by
        ``carry_matches`` against the fresh template, restored into a page
        bit for bit. A page write, so the in-flight window drains first."""
        with self._step_lock:
            self._drain_inflight(0)
            with self._lock:
                self._refuse_admission(self._session(sid).tenant)
                s = self._session(sid)
                if s.state != "evicted" or s.carry_leaves is None:
                    raise ValueError(f"session {sid!r} is not evicted (state={s.state})")
                if not self.pipeline.carry_matches(s.carry_leaves, s.carry_treedef,
                                                   self._fresh_tree()):
                    raise ValueError(f"session {sid!r}: evicted carry fails the pipeline "
                                     f"contract check")
                if not self.table.free_slots():
                    self._grow_to_fit()
                slot = self.table.admit(s)
                restored = self.pipeline.restore_carry(s.carry_leaves, s.carry_treedef,
                                                       self.device)
                self._set_page(s.page, _leaves(restored))
                s.carry_leaves = None
                s.carry_treedef = None
                s.stall_steps = 0
                _journal.emit("serve", "readmit", app=self.app, session=s.sid,
                              tenant=s.tenant, slot=slot, page=s.page)
                self._refresh_gauges()
                return s

    def adopt(self, sid: str, tenant: str, leaves: list, spec, frames_in: int = 0,
              frames_out: int = 0) -> Session:
        """Register an evicted session carried over from elsewhere (another
        engine's eviction, or a JAX engine's through
        ``convert.session_from_jax``): host ``leaves`` and their carry
        ``spec``, checked by ``carry_matches`` now; :meth:`readmit` restores
        it."""
        with self._lock:
            if self.table.get(sid) is not None:
                raise ValueError(f"session id {sid!r} already exists")
            if not self.pipeline.carry_matches(leaves, spec, self._fresh_tree()):
                raise ValueError(f"session {sid!r}: carry fails the pipeline contract check")
            s = Session(tenant, sid)
            s.state = "evicted"
            s.carry_leaves, s.carry_treedef = list(leaves), spec
            s.frames_in, s.frames_out = int(frames_in), int(frames_out)
            self.table.sessions[s.sid] = s
            self.credits.register(s.tenant)
            _journal.emit("serve", "adopt", app=self.app, session=s.sid, tenant=s.tenant)
            self._refresh_gauges()
            return s

    def evict(self, sid: str) -> Session:
        """Snapshot the session's page to the host and free its lane; queued
        input stays queued. :meth:`readmit` restores it bit for bit."""
        with self._step_lock:
            self._drain_inflight(0)
            return self._evict_quiesced(sid)

    def _evict_quiesced(self, sid: str) -> Session:
        with self._lock:
            s = self._session(sid)
            if s.state != "active":
                raise ValueError(f"session {sid!r} not active (state={s.state})")
            leaves, spec = self._session_leaves(s)
            s.carry_leaves = leaves
            s.carry_treedef = spec
            self._fresh_lanes.discard(s.slot)
            self.table.release_slot(s)
            s.state = "evicted"
            if self._store is not None:
                self._persist_session(s)
            _EVICTIONS.inc(app=self.app, tenant=s.tenant)
            _journal.emit("serve", "evict", app=self.app, session=s.sid, tenant=s.tenant,
                          stall_steps=s.stall_steps)
            self._refresh_gauges()
            return s

    def close(self, sid: str) -> None:
        """Leave: release the lane and forget the session."""
        with self._lock:
            s = self._session(sid)
            self.credits.release(s.tenant, len(s.pending))
            s.pending.clear()
            if s.slot is not None:
                self._fresh_lanes.discard(s.slot)
            self.table.forget(s)
            s.state = "closed"
            if self._store is not None:
                self._store.purge(s.sid)
            if not self._tenant_live(s.tenant):
                self.credits.unregister(s.tenant)
            _journal.emit("serve", "close", app=self.app, session=s.sid, tenant=s.tenant)
            self._refresh_gauges()

    def _tenant_live(self, tenant: str) -> bool:
        return any(o.tenant == tenant and o.state in ("active", "evicted")
                   for o in self.table.sessions.values())

    def _retire(self, s: Session, err: BaseException) -> None:
        """Per-session fault isolation: the faulted session's slot is masked
        off and released; siblings' carries and outputs are untouched."""
        self.credits.release(s.tenant, len(s.pending))
        s.pending.clear()
        if s.slot is not None:
            self._fresh_lanes.discard(s.slot)
        self.table.release_slot(s)
        s.state = "retired"
        s.error = repr(err)
        if self._store is not None:
            self._store.purge(s.sid)
        if not self._tenant_live(s.tenant):
            self.credits.unregister(s.tenant)
        self._retired.append(s.sid)
        while len(self._retired) > self._retired_keep:
            old = self.table.get(self._retired.pop(0))
            if old is not None and old.state == "retired":
                self.table.forget(old)
        _RETIRED.inc(app=self.app, tenant=s.tenant)
        _journal.emit("serve", "retire", app=self.app, session=s.sid, tenant=s.tenant,
                      error=repr(err))
        log.warning("%s: session %s (tenant %s) retired by %r — siblings unaffected",
                    self.app, s.sid, s.tenant, err)
        self._refresh_gauges()

    def _session(self, sid: str) -> Session:
        s = self.table.get(sid)
        if s is None:
            raise KeyError(f"no session {sid!r}")
        return s

    # -- the data plane --------------------------------------------------------
    def submit(self, sid: str, frame: np.ndarray) -> bool:
        """Queue one input frame for ``sid``; False (backpressure) when the
        tenant's fair credit share is spent."""
        with self._lock:
            s = self._session(sid)
            if s.state in ("retired", "closed"):
                raise ValueError(f"session {sid!r} is {s.state}")
            frame = np.asarray(frame)
            if frame.shape != (self.frame_size,):
                raise ValueError(f"frame shape {frame.shape} != ({self.frame_size},)")
            if not self.credits.try_acquire(s.tenant):
                _REJECTS.inc(app=self.app, tenant=s.tenant)
                return False
            s.pending.append((np.ascontiguousarray(frame, dtype=self.pipeline.in_dtype),
                              time.perf_counter_ns()))
            s.frames_in += 1
            return True

    def results(self, sid: str) -> list:
        """Drain the session's decoded results (oldest first)."""
        with self._lock:
            s = self._session(sid)
            out, s.out = list(s.out), type(s.out)()
            return out

    def step(self) -> int:
        """One frame-time dispatch: every active lane with pending frames
        rides one program call (one H2D of the batch, one replay, one D2H a
        sink), up to K frames a lane at ``frames_per_dispatch`` K. The group
        commits when its D2H lands; with ``serve_inflight > 1`` up to that
        many groups ride at once. Returns the session-frames launched; an
        idle step first commits everything in flight, then returns 0."""
        # the fleet's hook: one falsy check with no peers configured, else a
        # refresh of this host's fleet gauges at poll cadence
        if _fleet._tick_state is not None:
            _fleet.tick()
        with self._step_lock:
            g = self._assemble()
            if g is None:
                self._drain_inflight(0)
                with self._lock:
                    if self._ladder.level:
                        self._overload_tick(idle=True)
                return 0
            try:
                self._launch(g)
            except Exception:
                # a failed transfer or program call re-queues the popped
                # frames in order; the head never advanced
                self._rollback([g], reset_head=False)
                raise
            self._inflight.append(g)
            self._flight.note_dispatch(g.wire, len(self._inflight))
            n = g.n_frames
            self._drain_inflight(self._depth_limit() - 1)
            return n

    def _depth_limit(self) -> int:
        if self._ladder.level >= _LATENCY_RUNG:
            return 1
        return max(1, int(self._flight.credits))

    def _assemble(self) -> Optional[_DispatchGroup]:
        """Pop up to K pending frames an occupied lane into the batch,
        snapshot the page map and the fresh lanes and clear the fresh bits
        (rollback restores them). None on an idle step."""
        with self._lock:
            C = self.table.capacity
            K = self._k_eff
            fplan = _faults.plan()
            lanes: List[tuple] = []
            batch = active = None
            # the batch assembly is the serving path's encode lane
            t_step = _trace.now() if _trace.enabled else 0
            step_tids: List[int] = []      # the lineage-sampled frames
            for s in self.table.occupants():
                if not s.pending:
                    s.stall_steps += 1
                    continue
                if batch is None:
                    shape = (C, self.frame_size) if K == 1 else (C, K, self.frame_size)
                    batch_buf = xfer.host_buffer(shape, self.pipeline.in_dtype, self.device)
                    batch = batch_buf.array
                    active = np.zeros((C,) if K == 1 else (C, K), dtype=bool)
                if fplan.armed():
                    try:
                        fplan.maybe("work", s.sid)
                        fplan.maybe("dispatch", s.sid)
                    except _faults.InjectedFault as e:
                        self._retire(s, e)
                        continue
                popped = []
                tids = []
                for j in range(min(K, len(s.pending))):
                    entry = s.pending.popleft()
                    self.credits.release(s.tenant)
                    if K == 1:
                        batch[s.slot] = entry[0]
                        active[s.slot] = True
                    else:
                        batch[s.slot, j] = entry[0]
                        active[s.slot, j] = True
                    popped.append(entry)
                    tid = _lineage.tracer().sample()
                    if tid:
                        _lineage.tracer().stamp(tid, "ingest", entry[1])
                        step_tids.append(tid)
                    tids.append(tid)
                s.stall_steps = 0
                lanes.append((s, s.slot, popped, tids))
            self.steps += 1
            if not lanes:
                if batch is not None:             # every busy lane retired
                    batch_buf.release()
                return None
            batch[~active] = 0                    # idle lanes ride zero rows
            if t_step:
                _trace.complete("tpu", "encode", t_step,
                                args={"sessions": len(lanes), "capacity": C})
            for tid in step_tids:
                _lineage.tracer().stamp(tid, "encode")
            fresh = np.zeros((C,), dtype=bool)
            for lane in self._fresh_lanes:
                if lane < C:
                    fresh[lane] = True
            g = _DispatchGroup(C, K, lanes, batch_buf, active, fresh,
                               np.asarray(self.table.page_of_lane, dtype=np.int64),
                               frozenset(self._fresh_lanes), step_tids, t_step)
            self._fresh_lanes.clear()
            return g

    def _launch(self, g: _DispatchGroup) -> None:
        """Launch one group outside the state lock: program lookup or build,
        the H2Ds, the program call on the speculative head, the D2H starts.
        Advancing the head is the last effect, so a failure anywhere leaves
        the chain as it was."""
        C, K = g.capacity, g.k
        try:
            prog = self._program(C, K)
        except BaseException:
            g.batch.release()
            raise
        if isinstance(prog, ShardedSlotProgram):
            self._launch_sharded(g, prog)
            return
        # at depth 1 the previous group's D2H has landed before this H2D
        # starts, so the transfers write the graph's static inputs directly
        dst = prog.inputs if (getattr(prog, "captured", False) and self._depth == 1) \
            else (None,) * 4
        t_h2d = time.perf_counter()
        # the batch's pinned buffer goes to its transfer, which releases it
        fins = [xfer.start_device_transfer_parts(
            (g.batch.tensor,), self.device, out=None if dst[0] is None else (dst[0],),
            handles=(g.batch.handle,) if g.batch.handle is not None else ())]
        fins += [self._start_h2d(a, d) for a, d in zip((g.active, g.page_map, g.fresh),
                                                        dst[1:])]
        x, act, pmap, fresh = fins[0]()[0], *(f() for f in fins[1:])
        g.wire = getattr(fins[0], "_wire", None)
        for tid in g.step_tids:
            _lineage.tracer().stamp(tid, "H2D")
        t_c = _trace.now() if _trace.enabled else 0
        t0 = time.perf_counter()
        new_pages, outs = prog(self._head_pages, pmap, fresh, x, act,
                               clone_outputs=self._depth > 1)
        t1 = time.perf_counter()
        if t_c:
            # the replay's launch as this thread sees it (asynchronous on a
            # card: nothing here waits for it)
            _trace.complete("tpu", "compute", t_c,
                            args={"capacity": C, "active_lanes": len(g.lanes)})
        for tid in g.step_tids:
            _lineage.tracer().stamp(tid, "dispatch")
        self._warmed.add((C, K, self._pipe_tag))
        g.fins = [xfer.start_host_transfer(o) for o in outs]
        if self.spans is not None:
            svc, dl = g.wire or (0.0, 0.0)
            self.spans.append(("H2D", svc, dl) if dl else ("H2D", t_h2d, t0))
            self.spans.append(("compute", t0, t1))
        g.new_pages = new_pages
        self._head_pages = new_pages

    def _launch_sharded(self, g: _DispatchGroup, prog: ShardedSlotProgram) -> None:
        """Launch a group on a sharded bucket: the host arrays split a device
        and placed synchronously (the batch's pinned buffer goes back once
        its rows are on the devices), a D2H a device and sink."""
        t_h2d = time.perf_counter()
        t_c = _trace.now() if _trace.enabled else 0
        try:
            batch = g.batch.array
            new_pages, outs = prog(self._head_pages, g.page_map, g.fresh, batch, g.active,
                                   clone_outputs=self._depth > 1)
        finally:
            g.batch.release()
        t1 = time.perf_counter()
        if t_c:
            _trace.complete("tpu", "compute", t_c,
                            args={"capacity": g.capacity, "active_lanes": len(g.lanes),
                                  "devices": self._shard_d})
        for tid in g.step_tids:
            _lineage.tracer().stamp(tid, "dispatch")
        self._warmed.add((g.capacity, g.k, self._pipe_tag))
        g.fins = [_GatherFinish([xfer.start_host_transfer(o) for o in col]) for col in outs]
        if self.spans is not None:
            self.spans.append(("compute", t_h2d, t1))
        g.new_pages = new_pages
        self._head_pages = new_pages

    def _start_h2d(self, arr: np.ndarray, dst: Optional[torch.Tensor] = None):
        """Start one H2D of a group launch (through a pinned buffer), into
        ``dst`` or a new tensor; returns its finish thunk, whose ``_wire`` is
        the fake link's window."""
        if dst is None:
            return xfer.start_device_transfer(arr, self.device)
        buf = xfer.host_buffer(arr.shape, arr.dtype, self.device)
        buf.array[...] = arr
        fin = xfer.start_device_transfer_parts(
            (buf.tensor,), self.device, out=(dst,),
            handles=(buf.handle,) if buf.handle is not None else ())

        def finish() -> torch.Tensor:
            return fin()[0]

        finish._wire = fin._wire
        return finish

    def _drain_inflight(self, keep: int) -> None:
        """Commit in-flight groups oldest first until at most ``keep`` remain
        (step lock held, state lock not held across the D2H wait). A failed
        wait rolls back every uncommitted group."""
        keep = max(0, int(keep))
        while len(self._inflight) > keep:
            if keep:
                self._flight.note_limited()
            g = self._inflight[0]
            try:
                t0 = time.perf_counter()
                host = []
                for f in g.fins:
                    host.append(np.array(f(), copy=True))
                    f.release()
                for tid in g.step_tids:
                    _lineage.tracer().stamp(tid, "D2H")
                if self.spans is not None:
                    svc, dl = getattr(g.fins[0], "_wire", None) or (0.0, 0.0)
                    self.spans.append(("D2H", svc, dl) if dl
                                      else ("D2H", t0, time.perf_counter()))
            except Exception:
                doomed = list(self._inflight)
                self._inflight.clear()
                self._rollback(doomed, reset_head=True)
                raise
            self._inflight.popleft()
            self._commit(g, host)

    def _rollback(self, groups: list, reset_head: bool) -> None:
        """Re-queue every frame of the given uncommitted groups at the front
        of their queues (youngest group first), re-take their credits and
        restore their fresh bits; ``reset_head`` re-roots the chain at the
        committed pool."""
        with self._lock:
            for g in reversed(groups):
                for f in g.fins or ():            # their pinned buffers go back
                    f.release()
                for s, _lane, popped, _tids in g.lanes:
                    if s.state not in ("active", "evicted"):
                        continue
                    s.pending.extendleft(reversed(popped))
                    self.credits.reacquire(s.tenant, len(popped))
                self._fresh_lanes |= g.fresh_lanes
            if reset_head:
                self._head_pages = self._pages

    def _commit(self, g: _DispatchGroup, host: list) -> None:
        """Land one finished group: the committed pool advances to its
        pages, results fan back a session, latency, persistence and the
        ladder run. A session that left while its group flew is skipped."""
        end = time.perf_counter_ns()
        t_dec = _trace.now() if _trace.enabled else 0
        K = g.k
        with self._lock:
            self._pages = g.new_pages
            self.dispatches += 1
            dispatched = 0
            for s, lane, popped, tids in g.lanes:
                if not (s.state == "active" and s.slot == lane):
                    continue
                for j, (_, t_sub) in enumerate(popped):
                    rows = [h[lane] if K == 1 else h[lane, j] for h in host]
                    s.out.append(tuple(rows) if self._multi else rows[0])
                    s.frames_out += 1
                    lat = (end - t_sub) * 1e-9
                    s.last_latency_s = lat
                    self._lat_recent.append(lat)
                    _LATENCY.observe(lat, app=self.app, tenant=s.tenant)
                    self._e2e_hist.observe(lat)
                    tid = tids[j]
                    if tid:
                        lin = _lineage.tracer()
                        lin.stamp(tid, "decode", end)
                        lin.stamp(tid, "emit", end)
                        lin.finish(tid, source=f"serve:{self.app}", session=s.sid,
                                   tenant=s.tenant)
                        self._e2e_hist.exemplar(lat, tid)
                    _FRAMES.inc(app=self.app, tenant=s.tenant)
                    dispatched += 1
            self.frames += dispatched
            _DISPATCHES.inc(app=self.app)
            self._step_stamps.append(time.monotonic())
            if self._persist_every and self._store is not None:
                self._steps_since_persist += 1
                if self._steps_since_persist >= self._persist_every:
                    self._steps_since_persist = 0
                    self._persist_all()
            self._overload_tick()
            # the live roofline's unit: one session-frame
            self._prof.dispatch(dispatched, t=time.monotonic())
        if t_dec:
            _trace.complete("tpu", "decode", t_dec, args={"frames": dispatched})
        if g.t_step:
            _trace.complete("serve", "serve_step", g.t_step,
                            args={"sessions": len(g.lanes), "frames": dispatched,
                                  "capacity": g.capacity})

    # -- lane-addressed retunes ------------------------------------------------
    def retune(self, sid: str, stage, **params) -> Session:
        """Apply ``update_stage`` to one session's page at its next quiescent
        boundary (journaled ``serve/lane-retune``); siblings keep their bits.
        KeyError for an unknown session, ValueError for a non-active session,
        a bad stage address or a refused update."""
        with self._step_lock:
            self._drain_inflight(0)
            with self._lock:
                s = self._session(sid)
                if s.state != "active":
                    raise ValueError(f"session {sid!r} not active (state={s.state})")
                page = s.page
                if s.slot in self._fresh_lanes:
                    lane = self._fresh_tree()       # never dispatched: the template
                else:
                    self._fresh_carry()
                    lane = _from_spec(self._spec, iter(self._rows(self._pages, page)))
                try:
                    new = self.pipeline.update_stage(lane, stage, **params)
                except KeyError as e:
                    raise ValueError(f"retune of {sid!r}: {e}") from e
                self._set_page(page, _leaves(new))
                self._fresh_lanes.discard(s.slot)
                _journal.emit("serve", "lane-retune", app=self.app, session=s.sid,
                              tenant=s.tenant, slot=s.slot, page=page, stage=str(stage),
                              params=sorted(params))
                return s

    # -- durable session state ---------------------------------------------------
    def _base_leaf_dtypes(self) -> list:
        """The base pipeline's host leaf dtypes: every durable snapshot is
        written in them, whatever the live program runs at."""
        if self._base_dt is None:
            self._base_dt = [np.dtype(_host_leaf(t).dtype) for t in
                             _leaves(self._base_pipeline.init_carry("cpu"))]
        return self._base_dt

    def _persist_session(self, s: Session, sync: bool = False) -> None:
        """Queue one session's durable snapshot (state lock held), in the
        base pipeline's leaf dtypes."""
        meta = {"sid": s.sid, "tenant": s.tenant, "frames_in": s.frames_in,
                "frames_out": s.frames_out}
        dts = self._base_leaf_dtypes()
        fresh_lane = s.slot is not None and (
            s.slot in self._fresh_lanes or any(s.slot in g.fresh_lanes
                                               for g in self._inflight))
        if s.state == "active" and fresh_lane:
            snap = self._fresh_host_leaves()[0]
        elif s.state == "active" and s.slot is not None:
            snap = self._page_leaves(s.page)[0]
        elif s.state == "evicted" and s.carry_leaves is not None:
            snap = list(s.carry_leaves)
        else:
            return

        def fetch(_snap=snap, _dts=dts):
            raw = [np.asarray(a) for a in _snap]
            if len(raw) == len(_dts):
                raw = [_to_base(a, dt) for a, dt in zip(raw, _dts)]
            return raw

        self._store.save(s.sid, fetch, meta, sync=sync)

    def _persist_all(self, sync: bool = False) -> int:
        n = 0
        for s in self.table.sessions.values():
            if s.state in ("active", "evicted"):
                self._persist_session(s)
                n += 1
        if sync and n and self._store is not None:
            self._store.flush()
        return n

    def flush_persist(self) -> None:
        """Barrier: every snapshot queued before this call is on disk after it."""
        if self._store is not None:
            self._store.flush()

    def _restore_persisted(self) -> None:
        """A new engine of the same app and pipeline re-admits every
        persisted session bit for bit (``carry_matches``-checked); corrupted
        or mismatched files are skipped one session at a time; sessions past
        the largest bucket stay on disk."""
        records = self._store.load_all()
        if not records:
            return
        skipped = 0
        with self._lock:
            template = self._fresh_tree()
            for r in records:
                if self.table.get(r["sid"]) is not None:
                    continue
                if not self.pipeline.carry_matches(r["leaves"], self._spec, template):
                    log.warning("%s: persisted session %s fails the carry contract — "
                                "skipped", self.app, r["sid"])
                    skipped += 1
                    continue
                if not self.table.free_slots():
                    try:
                        self._grow_to_fit()
                    except ServeFull:
                        log.warning("%s: persisted sessions exceed the largest slot "
                                    "bucket — left on disk", self.app)
                        break
                s = Session(r["tenant"], r["sid"])
                self.table.admit(s)
                restored = self.pipeline.restore_carry(r["leaves"], self._spec, self.device)
                self._set_page(s.page, _leaves(restored))
                s.frames_in = r["frames_in"]
                s.frames_out = r["frames_out"]
                self.credits.register(s.tenant)
                self.restored_sessions += 1
                _RESUMED.inc(app=self.app, tenant=s.tenant)
            self._refresh_gauges()
        if self.restored_sessions:
            _journal.emit("serve", "restore", app=self.app,
                          sessions=self.restored_sessions, skipped=skipped)
            try:
                with self._lock:
                    self._warm_current_bucket()
            except Exception as e:         # noqa: BLE001 — a failed warm-up
                log.warning("%s: restore warm-up failed: %r", self.app, e)

    def _warm_current_bucket(self) -> None:
        """Build the current capacity's program and run one all-masked
        dispatch (nothing active, nothing fresh: the pool's pages come back
        unchanged and are discarded), so a restored engine is ready before
        traffic arrives."""
        C, K = self.table.capacity, self._k_eff
        key = (C, K, self._pipe_tag)
        if key in self._warmed:
            return
        prog = self._program(C, K)
        shape = (C, self.frame_size) if K == 1 else (C, K, self.frame_size)
        host = (np.asarray(self.table.page_of_lane, dtype=np.int64), np.zeros(C, dtype=bool),
                np.zeros(shape, dtype=self.pipeline.in_dtype),
                np.zeros((C,) if K == 1 else (C, K), dtype=bool))
        if isinstance(prog, ShardedSlotProgram):
            _pages, outs = prog(self._pages, *host)
            outs = [o for col in outs for o in col]
        else:
            _pages, outs = prog(self._pages, *[xfer.to_device(a, self.device)
                                               for a in host])
        for o in outs:
            xfer.to_host(o)
        self._warmed.add(key)

    # -- graceful lifecycle ----------------------------------------------------
    def drain(self, pump: bool = True, timeout: float = 30.0, persist: bool = True) -> dict:
        """Graceful shutdown: refuse new admissions, finish in-flight groups
        and queued frames (``pump=True`` steps the engine here), persist all
        live lanes, report drained. Idempotent."""
        with self._lock:
            self._draining = True
        _journal.emit("serve", "drain", app=self.app, timeout_s=float(timeout),
                      persist=bool(persist))
        pumped = 0
        deadline = (time.monotonic() + float(timeout)) if timeout else None
        if pump:
            while True:
                if deadline is not None and time.monotonic() > deadline:
                    log.warning("%s: drain timed out with frames still queued", self.app)
                    break
                got = self.step()
                pumped += got
                if not got:
                    break
        persisted = 0
        if persist and self._store is not None:
            with self._step_lock:
                self._drain_inflight(0)
                with self._lock:
                    if self._brownout_active:
                        self._set_brownout(False)
                    persisted = self._persist_all(sync=True)
        with self._lock:
            leftover = sum(len(s.pending) for s in self.table.sessions.values())
            self._drained = True
            report = {"app": self.app, "draining": True, "drained": True,
                      "frames_drained": pumped, "pending_frames": leftover,
                      "sessions_persisted": persisted,
                      "sessions": len(self.table.sessions)}
        _journal.emit("serve", "drained", app=self.app, frames_drained=pumped,
                      sessions_persisted=persisted, pending_frames=leftover)
        return report

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def drained(self) -> bool:
        return self._drained

    def retry_after_s(self) -> int:
        """``Retry-After`` seconds for a 503, from the measured step rate:
        about one queue depth's drain time, in [1, 30]. Lock-free (the REST
        error path calls it while a step may hold the locks)."""
        stamps = list(self._step_stamps)
        qf = self._queue_frames
        if len(stamps) >= 2 and stamps[-1] > stamps[0]:
            rate = (len(stamps) - 1) / (stamps[-1] - stamps[0])
            est = qf / max(rate, 1e-3)
        else:
            est = 1.0
        return int(min(30, max(1, math.ceil(est))))

    def health(self) -> dict:
        """Liveness and readiness for ``/healthz`` and ``/readyz``: ready when
        the current bucket's program has dispatched (or nothing is admitted)
        and the engine is not draining. Lock-free."""
        key = (self.table.capacity, self._k_eff, self._pipe_tag)
        active = self.table.active
        compiled = active == 0 or key in self._warmed
        return {"ready": bool(compiled and not self._draining), "compiled": bool(compiled),
                "draining": self._draining, "drained": self._drained,
                "shed_level": self._ladder.level, "shed_rung": self._ladder.rung,
                "active": active, "capacity": self.table.capacity}

    # -- SLO-aware overload control --------------------------------------------
    def _overload_tick(self, idle: bool = False) -> None:
        """One ladder observation (lock held): queue pressure against the
        watermarks, the rolling p99 against ``serve_slo_ms`` (skipped on idle
        ticks). Rung 2 evicts the most stalled sessions, rung 3 engages the
        brownout lever; recovery unwinds a rung at a time."""
        if self._ticking:
            return
        p99_ms = None
        if self._slo_ms and self._lat_recent and not idle:
            p99_ms = float(np.quantile(np.asarray(self._lat_recent), 0.99)) * 1e3
        prev = self._ladder.level
        lvl = self._ladder.observe(self.credits.pressure(), p99_ms, self._slo_ms)
        if lvl == prev:
            return
        _SHED_LEVEL.set(float(lvl), app=self.app)
        _journal.emit("serve", "shed-rung", app=self.app, level=lvl, prev=prev,
                      rung=self._ladder.rung, pressure=round(self.credits.pressure(), 4),
                      p99_ms=round(p99_ms, 3) if p99_ms is not None else None)
        self._ticking = True
        try:
            if lvl > prev:
                log.warning("%s: overload ladder escalated to rung %d (%s)", self.app, lvl,
                            self._ladder.rung)
                if lvl >= 2:
                    self._shed_stalled()
                if lvl >= 3 and self._brownout != "off":
                    self._set_brownout(True)
            else:
                if lvl < 3 and self._brownout_active:
                    self._set_brownout(False)
        finally:
            self._ticking = False

    def _shed_stalled(self) -> None:
        """Rung 2: evict the most stalled sessions (no queued input, most
        inputless steps first), at most a quarter of the active lanes."""
        cands = sorted((s for s in self.table.occupants()
                        if s.stall_steps >= 1 and not s.pending),
                       key=lambda s: -s.stall_steps)
        for s in cands[:max(1, self.table.active // 4)]:
            try:
                self.evict(s.sid)
            except (KeyError, ValueError) as e:
                log.warning("%s: shed-evict of %s failed: %r", self.app, s.sid, e)
                continue
            self.shed_evictions += 1
            _SHED.inc(app=self.app, tenant=s.tenant, reason="evict")

    def _set_brownout(self, on: bool) -> None:
        """Rung 3 (config ``serve_brownout``, default off): ``"k"`` drops the
        megabatch K to 1; ``"precision"`` serves the interior lowered to
        ``serve_brownout_precision`` (bf16, or the int8 rung). Each form
        builds its program once; release reuses the base programs."""
        if on == self._brownout_active:
            return
        if self._brownout == "precision":
            self._drain_inflight(0)
            if not self._apply_precision_brownout(on):
                return
        self._brownout_active = on
        _journal.emit("serve", "brownout", app=self.app, engaged=bool(on),
                      lever=self._brownout)
        if on:
            _SHED.inc(app=self.app, tenant="-", reason="brownout")
        log.warning("%s: brownout lever (%s) %s", self.app, self._brownout,
                    "ENGAGED" if on else "released")

    def _apply_precision_brownout(self, on: bool) -> bool:
        """Swap the served pipeline between the base and the lowered form,
        converting the pool leaf by leaf (and evicted sessions' host
        leaves); False, logged, when nothing lowers or the carries differ."""
        prev_pipe = self.pipeline
        if on:
            if self._low_pipe is None:
                try:
                    from ..ops import precision as _precision
                    low, _plan = _precision.plan_interior_precision(
                        self._base_pipeline, mode=self._brownout_prec, device=self.device)
                except Exception as e:                 # noqa: BLE001
                    log.warning("%s: precision brownout plan failed (%r) — lever "
                                "disabled", self.app, e)
                    return False
                if low is self._base_pipeline:
                    log.warning("%s: precision brownout lowers nothing — lever disabled",
                                self.app)
                    return False
                self._low_pipe = low
            target, tag = self._low_pipe, self._brownout_prec
        else:
            target, tag = self._base_pipeline, "base"
        if target is self.pipeline:
            self._pipe_tag = tag
            return True
        self.pipeline = target
        self._fresh = None
        new_fresh = self._fresh_carry()
        pages = self._global(self._pages)
        if len(new_fresh) != len(pages) or any(
                tuple(a.shape[1:]) != tuple(b.shape) for a, b in zip(pages, new_fresh)):
            log.warning("%s: precision brownout carry trees mismatch — lever disabled",
                        self.app)
            self.pipeline = prev_pipe
            self._fresh = None
            self._fresh_carry()
            return False
        self._pages = self._layout([P if P.dtype == t.dtype else P.to(t.dtype)
                                    for P, t in zip(pages, new_fresh)], self.table.capacity)
        self._head_pages = self._pages
        lane_dts = [np.dtype(_host_leaf(t).dtype) for t in new_fresh]
        for s in self.table.sessions.values():
            if s.state == "evicted" and s.carry_leaves is not None and \
                    len(s.carry_leaves) == len(lane_dts):
                s.carry_leaves = [_to_base(a, dt) for a, dt in zip(s.carry_leaves, lane_dts)]
                s.carry_treedef = self._spec
        self._pipe_tag = tag
        return True

    # -- observability ---------------------------------------------------------
    def _refresh_gauges(self) -> None:
        counts: Dict[tuple, int] = {}
        for s in self.table.sessions.values():
            counts[(s.tenant, s.state)] = counts.get((s.tenant, s.state), 0) + 1
        for key in set(self._gauge_cache) | set(counts):
            tenant, state = key
            _SESSIONS.set(float(counts.get(key, 0)), app=self.app, tenant=tenant,
                          state=state)
            self._gauge_cache[key] = True

    def tenant_latency_ms(self, tenant: str, q: float = 0.99) -> Optional[float]:
        v = _LATENCY.labels(app=self.app, tenant=tenant).quantile(q)
        return None if v is None else v * 1e3

    def watch_sample(self) -> Optional[dict]:
        """The doctor's serve-watchdog probe: monotonic ``frames`` and the
        queued ``pending`` frames, or None while the state lock is busy (a
        step or a bucket build in flight is progress)."""
        if not self._lock.acquire(timeout=0.05):
            return None
        try:
            stuck = sorted((s for s in self.table.occupants() if s.pending),
                           key=lambda s: -len(s.pending))
            return {"app": self.app, "frames": self.frames,
                    "pending": sum(len(s.pending) for s in self.table.occupants()),
                    "draining": self._draining, "capacity": self.table.capacity,
                    "active": self.table.active, "shed_level": self._ladder.level,
                    "stuck_sessions": [s.sid for s in stuck[:4]]}
        finally:
            self._lock.release()

    def shutdown(self) -> None:
        """Detach from the doctor's watchdog. Does not drain: call
        :meth:`drain` first for a graceful handoff."""
        if self._doctor_token is not None:
            try:
                from ..telemetry import doctor as _doctor
                _doctor.doctor().detach_serve(self._doctor_token)
            except Exception:              # noqa: BLE001 — observability only
                pass
            self._doctor_token = None

    def describe(self) -> dict:
        """The app view served by ``GET /api/serve/{app}/``."""
        with self._lock:
            tenants = self.table.tenants()
            return {
                "app": self.app, "frame_size": self.frame_size,
                "frames_per_dispatch": self.k_batch, "buckets": list(self.buckets),
                "capacity": self.table.capacity,
                "resident_buckets": self.resident_buckets(), "compiles": self.compiles,
                "active": self.table.active,
                "pages": {"free": self.table.free_slots(),
                          "fresh_lanes": len(self._fresh_lanes)},
                "overlap": {"depth": int(self._flight.credits),
                            "in_flight": len(self._inflight)},
                "sessions": len(self.table.sessions), "steps": self.steps,
                "dispatches": self.dispatches, "frames": self.frames,
                "credit_total": self.credits.total,
                "credit_fair_share": self.credits.fair_share(),
                "draining": self._draining, "drained": self._drained,
                "device": str(self.device),
                # the slot axis over devices: its width and whether the
                # current bucket's lanes split over it
                "shard": ({"devices": self._shard_d,
                           "sharded": self._shard_ok(self.table.capacity),
                           "lanes_per_device": (self.table.capacity // self._shard_d
                                                if self._shard_ok(self.table.capacity)
                                                else self.table.capacity)}
                          if self._shard_d > 1 else None),
                "shed": {**self._ladder.view(), "slo_ms": self._slo_ms or None,
                         "brownout": self._brownout,
                         "brownout_active": self._brownout_active,
                         "evictions": self.shed_evictions,
                         "pressure": round(self.credits.pressure(), 4),
                         "tenant_pressure": self.credits.tenant_pressure()},
                "persist": ({"dir": self._store._dir, "every": self._persist_every,
                             "restored_sessions": self.restored_sessions}
                            if self._store is not None else None),
                "tenants": {t: {"sessions": n, "credits_used": self.credits.used(t),
                                "p99_ms": self.tenant_latency_ms(t)}
                            for t, n in sorted(tenants.items())},
            }

    def session_view(self, sid: str) -> dict:
        with self._lock:
            v = self._session(sid).view()
            if self._shard_d > 1 and v.get("slot") is not None:
                v["device"], v["device_lane"] = self.slot_device(v["slot"])
        t = v["tenant"]
        v["tenant_p50_ms"] = self.tenant_latency_ms(t, 0.5)
        v["tenant_p99_ms"] = self.tenant_latency_ms(t, 0.99)
        return v


def _to_base(a, dt: np.dtype) -> np.ndarray:
    """A host leaf in dtype ``dt``: a bfloat16 leaf travels as its int16 bits
    and converts through float32."""
    a = np.asarray(a)
    if a.dtype == dt:
        return a
    if a.dtype == np.int16 and dt != np.int16:          # bf16 bits -> float
        return torch.from_numpy(a.copy()).view(torch.bfloat16).float().numpy().astype(dt)
    if dt == np.int16:                                   # float -> bf16 bits
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(
            torch.bfloat16).view(torch.int16).numpy()
    return a.astype(dt)


# ---------------------------------------------------------------------------
# SIGTERM drain hook (rolling restarts)
# ---------------------------------------------------------------------------

_sigterm_installed = False
_sigterm_lock = threading.Lock()


def drain_all_apps(timeout: float = 30.0) -> Dict[str, dict]:
    """Drain every registered serving app (refuse admissions, finish
    in-flight groups, persist all lanes): the SIGTERM hook's body."""
    from . import api as _api
    out: Dict[str, dict] = {}
    for name, eng in _api.apps().items():
        try:
            out[name] = eng.drain(timeout=timeout)
        except Exception as e:                         # noqa: BLE001 — one bad app
            out[name] = {"app": name, "error": repr(e)}    # must not block the rest
            log.error("drain of %s failed: %r", name, e)
    return out


def install_sigterm_drain(timeout: float = 30.0) -> bool:
    """Install a SIGTERM handler that drains every registered serving app on
    a background thread, then chains the previous handler (the default one
    re-raised). Idempotent; False off the main thread."""
    global _sigterm_installed
    import signal
    with _sigterm_lock:
        if _sigterm_installed:
            return True
        try:
            prev = signal.getsignal(signal.SIGTERM)

            def on_term(signum, frame):
                def run():
                    drain_all_apps(timeout=timeout)
                    if callable(prev):
                        try:
                            prev(signum, frame)
                        except Exception:              # noqa: BLE001
                            pass
                    elif prev == signal.SIG_DFL:
                        try:
                            signal.signal(signal.SIGTERM, signal.SIG_DFL)
                            os.kill(os.getpid(), signal.SIGTERM)
                        except Exception:              # noqa: BLE001
                            pass

                threading.Thread(target=run, name="fsdr-serve-drain", daemon=True).start()

            signal.signal(signal.SIGTERM, on_term)
        except ValueError:
            return False
        _sigterm_installed = True
        return True
