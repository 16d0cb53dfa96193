"""Data-sharded device plane: one fused program, D independent stream lanes.

The counterpart of ``futuresdr_tpu/shard/data.py`` (``shard/plan.py`` mode
``data``). The megabatch dispatch's ``[K, frame]`` rows gain a leading device
axis, ``[D, K, frame]``: device d runs its own compiled program of the
unchanged pipeline (one CUDA graph a device, captured on that device's card;
on the CPU the eager chain) over row d, with its own carry. No stage
communicates: the mesh's count of cross-shard transfers (:func:`collective_ops`,
which in the reference reads the compiled HLO) stays 0, and row d is bit-equal
to the D = 1 program fed row d at the same K.

:class:`ShardRunner` is the host drive loop with the recovery contract: a
whole-mesh carry snapshot through the pipeline's own ``snapshot_carry`` /
``carry_matches`` / ``restore_carry`` (one carry a device), and a bounded
replay log a shard of the exact host rows, so a recovered run is bit-equal to
an unfailed one.

Telemetry: the runner's programs are one compile window (``warmup``) on the
profile plane; it registers one entry under its name (a unit is one
lane-frame, D·K a group) and each device's program its per-device entry
(``<name>@dev<d>``, ``fsdr_mfu_device``; a unit is one call of K frames).
With tracing on a group records a ``compute`` span and one ``shard:d<d>``
span a device (``cat="shard"``, the doctor's shard lanes); 1 group in
``lineage_stride`` carries a lineage trace id; the journal records
``checkpoint-commit``, ``recover`` and ``replay``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..log import logger
from ..parallel.mesh import on_device
from ..runtime import faults as _faults
from ..telemetry import journal as _journal
from ..telemetry import lineage as _lineage
from ..telemetry import profile as _profile
from ..telemetry.spans import recorder as _trace_recorder
from .plan import AXIS, ShardPlan, note_plan, plan_shard

__all__ = ["ShardedProgram", "ShardRunner", "shard_pipeline", "collective_ops",
           "shard_mesh"]

log = logger("shard.data")
_trace = _trace_recorder()


def shard_mesh(n_devices: int, axis: str = AXIS, device=None):
    """A one-axis mesh over the first ``n_devices`` devices of
    ``visible_devices(device)`` (refused when fewer exist)."""
    from ..parallel.mesh import make_mesh
    return make_mesh((axis,), shape=(int(n_devices),), device=device)


def collective_ops(prog_or_mesh) -> List[str]:
    """The kinds of cross-shard transfer a program's mesh has counted since
    its last ``reset_counts()`` (empty: every stage stayed on its shard)."""
    mesh = getattr(prog_or_mesh, "mesh", prog_or_mesh)
    return sorted(k for k, n in mesh.transfers.items() if n)


class ShardedProgram:
    """A fused pipeline over a one-axis mesh as D independent stream lanes
    (``plan.applied == "data"``).

    The slice of the ``Pipeline`` surface the drive loops need
    (``in_dtype``, ``out_dtype``, ``ratio``, ``frame_multiple``, ``stages``,
    ``init_carry``, ``out_items``, the snapshot trio) with a device axis: a
    whole-mesh carry is a list of D carries, one on each device, and a batch
    is ``[D, frame]`` or ``[D, K, frame]`` host rows (or a list of D
    tensors). The wrapped pipeline object is untouched."""

    def __init__(self, pipeline, plan: Optional[ShardPlan] = None,
                 n_devices: Optional[int] = None, name: str = "shard", device=None):
        self.pipeline = pipeline
        self.plan = plan if plan is not None else plan_shard(
            pipeline, mode="data", n_devices=n_devices, device=device)
        if not self.plan.active:
            raise ValueError("ShardedProgram needs an active data plan (use "
                             "shard_pipeline(), which returns the pipeline object "
                             "unchanged for shard=off / D=1)")
        self.name = str(name)
        self.n_devices = self.plan.n_devices
        self.axis = self.plan.axis
        self.mesh = shard_mesh(self.n_devices, self.axis,
                               device if device is not None else self.plan.device)
        self.devices = self.mesh.line(self.axis)
        self._programs: Dict[tuple, list] = {}
        self.in_dtype = pipeline.in_dtype
        self.out_dtype = pipeline.out_dtype
        self.ratio = pipeline.ratio
        self.frame_multiple = pipeline.frame_multiple
        self.stages = pipeline.stages
        note_plan(self.name, self.plan)

    def init_carry(self) -> list:
        """D fresh carries, carry d on device d."""
        return [self.pipeline.init_carry(d) for d in self.devices]

    def compile(self, frame_size: int, k: int = 1, wire=None,
                program: Optional[str] = None):
        """One compiled program a device for ``frame_size``-sample frames, k
        a dispatch (``Pipeline.compile`` on each device: a CUDA graph a
        device on a card, captured under that card). Returns ``(fn,
        carries)``: ``fn(carries, x) -> (carries, ys)``, ``x`` host rows
        ``[D, frame]`` (``[D, K, frame]``) or D tensors, or wired a tuple of
        the wire's parts with the device axis leading; ``ys`` D outputs, one
        on each device. Programs are built once a (frame, k, wire). Each
        device's program is the profile plane's ``<program>@dev<d>`` entry
        (default the sharded program's name); with ``program`` given the
        caller holds the compile window."""
        if frame_size % self.frame_multiple:
            raise ValueError(f"frame_size {frame_size} is not a multiple of "
                             f"{self.frame_multiple}")
        from ..ops.wire import get_wire
        w = None if wire is None else get_wire(wire)
        key = (int(frame_size), int(k), None if w is None else w.name)
        built = self._programs.get(key)
        if built is None:
            built = []
            for i, d in enumerate(self.devices):
                with on_device(d):
                    built.append(self.pipeline.compile(
                        frame_size, d, k=k, wire=w, program=program or self.name,
                        reason=None if program else "warmup", profile_device=str(i)))
            self._programs[key] = built
        fns = [fn for fn, _c in built]
        wired = w is not None

        def run(carries, *xs):
            out_c, ys = [], []
            for i, (fn, c, d) in enumerate(zip(fns, carries, self.devices)):
                if wired:
                    arg = tuple(_row(p, i, d) for p in xs)
                else:
                    arg = _row(xs[0], i, d)
                with on_device(d):
                    c, y = fn(c, arg)
                out_c.append(c)
                ys.append(y)
            return out_c, ys

        return run, [c for _fn, c in built]

    def out_items(self, in_items: int) -> int:
        return self.pipeline.out_items(in_items)

    # -- whole-mesh snapshot: the pipeline's own surface, a device at a time --
    def snapshot_carry(self, carries):
        """``(fetches, spec)`` of every device's carry: the fetches of
        device 0's leaves, then device 1's, …; ``spec`` is ``(D, the
        pipeline's spec)``."""
        fetches, spec = [], None
        for c in carries:
            f, spec = self.pipeline.snapshot_carry(c)
            fetches.extend(f)
        return fetches, (self.n_devices, spec)

    def carry_matches(self, leaves, spec, template) -> bool:
        if not (isinstance(spec, tuple) and len(spec) == 2 and spec[0] == self.n_devices):
            return False
        per = len(leaves) // self.n_devices if self.n_devices else 0
        if per * self.n_devices != len(leaves):
            return False
        return all(self.pipeline.carry_matches(leaves[d * per:(d + 1) * per], spec[1], t)
                   for d, t in enumerate(template))

    def restore_carry(self, leaves, spec) -> list:
        """The whole-mesh carry of a snapshot, carry d on device d."""
        per = len(leaves) // self.n_devices
        return [self.pipeline.restore_carry(leaves[d * per:(d + 1) * per], spec[1], dev)
                for d, dev in enumerate(self.devices)]


def _row(x, i: int, dev: torch.device) -> torch.Tensor:
    """Row ``i`` of a batch (host array, tensor, or a list of D tensors) on
    ``dev``: the placement of one shard's input, not a cross-shard copy."""
    if isinstance(x, (list, tuple)):
        t = x[i]
    elif isinstance(x, torch.Tensor):
        t = x[i]
    else:
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(x)[i]))
    return t.to(dev)


def rows_to_host(ys) -> np.ndarray:
    """D outputs (tensors, or tuples of them from a wired program) as one
    host array ``[D, …]`` (a tuple of arrays for a wired program)."""
    if isinstance(ys[0], tuple):
        return tuple(np.stack([y[j].cpu().numpy() for y in ys]) for j in range(len(ys[0])))
    return np.stack([y.cpu().numpy() for y in ys])


def shard_pipeline(pipeline, mode: Optional[str] = None, n_devices: Optional[int] = None,
                   frame_size: Optional[int] = None, name: str = "shard", device=None):
    """Plan, then apply: ``off`` or a one-device resolution returns the same
    pipeline object; an active data plan a :class:`ShardedProgram`; an active
    model plan a :class:`~futuresdr_tpu_torch.shard.model.ModelShardedProgram`."""
    plan = plan_shard(pipeline, mode=mode, n_devices=n_devices, frame_size=frame_size,
                      device=device)
    if not plan.active:
        return pipeline
    if plan.applied == "model":
        from .model import ModelShardedProgram
        return ModelShardedProgram(pipeline, plan, name=name, device=device)
    return ShardedProgram(pipeline, plan, name=name, device=device)


class ShardRunner:
    """Host drive loop of a data-sharded program: a dispatch a group, the
    whole-mesh carry checkpoint and a replay log a shard.

    :meth:`run_group` dispatches one group over all D shards (``[D, K,
    frame]`` in, ``[D, K, out]`` out): ``dispatches`` counts groups, never
    groups × D. Recovery:

    * every ``checkpoint_every``-th committed group snapshots the whole-mesh
      carry (a ring of 2) through the pipeline's ``snapshot_carry``;
    * each shard's rows ride a bounded replay log until a committed
      checkpoint covers their group (the exact host bytes);
    * :meth:`recover` restores the newest snapshot that passes
      ``carry_matches`` (a corrupt one is evicted for the previous one, or a
      fresh carry when none is left) and re-dispatches the logged window,
      whose outputs were already emitted: a recovered run is bit-equal to an
      unfailed one.

    The fault site is ``dispatch`` under the runner's name
    (``runtime/faults.py``), polled before a group launches.
    ``checkpoint_every=0`` turns recovery off and free: no snapshots, no log."""

    def __init__(self, prog: ShardedProgram, frame_size: int, k: int = 1,
                 checkpoint_every: int = 1, name: Optional[str] = None):
        self.prog = prog
        self.frame_size = int(frame_size)
        self.k = max(1, int(k))
        self.checkpoint_every = max(0, int(checkpoint_every))
        self.name = str(name if name is not None else prog.name)
        pipe, fs = prog.pipeline, self.frame_size

        def lane_cost():
            from ..utils.roofline import program_cost
            return program_cost(pipe, fs)

        from ..utils.roofline import dominant_dtype
        # the aggregate entry: a unit is one lane-frame (D·K a group)
        self._prof = _profile.register(self.name, cost_thunk=lane_cost,
                                       dtype=dominant_dtype(pipe.stages))
        with _profile.compiling(self.name, "warmup",
                                f"D={prog.n_devices},frame={self.frame_size},k={self.k}"):
            self._fn, self._carries = prog.compile(self.frame_size, self.k, program=self.name)
        self._template = prog.init_carry()   # shape and dtype contract of a match
        self.seq = 0
        self.dispatches = 0
        self.replayed = 0
        self._ckpts: deque = deque(maxlen=2)           # (seq, leaves, spec)
        self._rlog: Dict[int, deque] = {d: deque() for d in range(prog.n_devices)}
        self._lock = threading.Lock()
        self._note()

    def _note(self) -> None:
        note_plan(self.name, self.prog.plan, extra={
            "dispatches": self.dispatches,
            "frames_per_shard": self.seq * self.k,
            "replayed_groups": self.replayed,
            "checkpoint_seq": (self._ckpts[-1][0] if self._ckpts else None),
            "replay_log_depth": max((len(q) for q in self._rlog.values()), default=0),
        })

    def _norm_rows(self, rows) -> np.ndarray:
        rows = np.asarray(rows)
        D, K = self.prog.n_devices, self.k
        if K == 1 and rows.ndim == 2:
            rows = rows[:, None, :]
        if rows.shape != (D, K, self.frame_size):
            raise ValueError(f"rows {rows.shape} != {(D, K, self.frame_size)}")
        return np.ascontiguousarray(rows, dtype=self.prog.in_dtype)

    def _dispatch(self, rows: np.ndarray, seq: int, replay: bool, tid: int = 0) -> np.ndarray:
        t0 = _trace.now() if _trace.enabled else 0
        x = rows[:, 0, :] if self.k == 1 else rows
        if tid:
            _lineage.tracer().stamp(tid, "H2D")
        self._carries, ys = self._fn(self._carries, x)
        if tid:
            _lineage.tracer().stamp(tid, "dispatch")
        out = rows_to_host(ys)
        if tid:
            _lineage.tracer().stamp(tid, "D2H")
        self.dispatches += 1
        self._prof.dispatch(self.prog.n_devices * self.k, t=time.monotonic())
        if t0:
            _trace.complete("tpu", "compute", t0,
                            args={"devices": self.prog.n_devices, "seq": seq,
                                  "replay": replay})
            for d in range(self.prog.n_devices):
                _trace.complete("shard", f"shard:d{d}", t0,
                                args={"seq": seq, "frames": self.k, "runner": self.name})
        return out if self.k > 1 else out[:, None]

    def _checkpoint(self) -> None:
        """Snapshot the whole-mesh carry now (the group's outputs already
        drained), then prune every shard's log to the previous snapshot, so a
        corrupt newest one still has a replayable window behind it."""
        fins, spec = self.prog.snapshot_carry(self._carries)
        self._ckpts.append((self.seq, [f() for f in fins], spec))
        _journal.emit("shard", "checkpoint-commit", runner=self.name, seq=int(self.seq))
        floor = self._ckpts[0][0] if len(self._ckpts) > 1 else 0
        for q in self._rlog.values():
            while q and q[0][0] <= floor:
                q.popleft()

    def run_group(self, rows) -> np.ndarray:
        """Dispatch one group (host rows ``[D, K, frame]``, ``[D, frame]`` at
        K = 1) and return the host output ``[D, K, out]``. Raises the
        injected fault (site ``dispatch:<name>``) before any state moves; the
        caller recovers with :meth:`recover`."""
        with self._lock:
            rows = self._norm_rows(rows)
            _faults.maybe("dispatch", self.name)
            # one sampled lineage trace a group (the runner's unit of
            # dispatch); replayed groups dispatch with none
            tid = _lineage.tracer().sample()
            if tid:
                _lineage.tracer().stamp(tid, "ingest")
            seq = self.seq + 1
            if self.checkpoint_every:
                for d in range(self.prog.n_devices):
                    self._rlog[d].append((seq, rows[d].copy()))
            out = self._dispatch(rows, seq, replay=False, tid=tid)
            self.seq = seq
            if self.checkpoint_every and seq % self.checkpoint_every == 0:
                self._checkpoint()
            if tid:
                lin = _lineage.tracer()
                lin.stamp(tid, "emit")
                lin.finish(tid, source=f"shard:{self.name}")
            self._note()
            return out

    def recover(self) -> int:
        """Restore the newest valid whole-mesh snapshot and replay every
        logged group above it, a shard's rows each; returns the number of
        groups replayed."""
        with self._lock:
            restore_seq, restored = 0, None
            while self._ckpts:
                seq, leaves, spec = self._ckpts[-1]
                if self.prog.carry_matches(leaves, spec, self._template):
                    restored = (seq, leaves, spec)
                    break
                log.warning("%s: evicting corrupt checkpoint candidate seq=%d",
                            self.name, seq)
                self._ckpts.pop()
            if restored is not None:
                restore_seq, leaves, spec = restored
                self._carries = self.prog.restore_carry(leaves, spec)
            else:
                self._carries = self.prog.init_carry()
            seqs = sorted({s for q in self._rlog.values() for s, _ in q if s > restore_seq})
            for seq in seqs:
                rows = np.stack([next(r for s, r in self._rlog[d] if s == seq)
                                 for d in range(self.prog.n_devices)])
                self._dispatch(rows, seq, replay=True)
            self.replayed += len(seqs)
            self.seq = max(self.seq, restore_seq + len(seqs))
            _journal.emit("shard", "recover", runner=self.name,
                          checkpoint_seq=int(restore_seq), replayed=len(seqs),
                          fresh_init=restored is None)
            if seqs:
                _journal.emit("shard", "replay", runner=self.name, groups=len(seqs),
                              high_seq=int(self.seq))
            log.info("%s: recovered at seq=%d, replayed %d group(s)", self.name,
                     restore_seq, len(seqs))
            self._note()
            return len(seqs)
