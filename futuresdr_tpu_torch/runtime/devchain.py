"""Device-graph fusion: a device-plane region as one dispatch a frame.

The port's copy of ``futuresdr_tpu/runtime/devchain.py``. At every launch
the supervisor calls :func:`find_device_chains`; each region it returns —

* a linear frame-plane run ``TpuH2D → TpuStage* → TpuD2H``, or adjacent
  ``TpuKernel`` blocks over stream edges (whose hops each cross the link
  both ways a frame),
* a fan-out ``producer run → broadcast → N branch runs`` on either plane,
* a general DAG on the frame plane (nested fan-out, fan-in through a
  ``TpuMergeStage``, the diamond ``broadcast → branches → merge``) or a
  nested fan-out of ``TpuKernel``s —

runs as one fused block: a :class:`~futuresdr_tpu_torch.tpu.TpuKernel` over
the concatenated stage lists, or a
:class:`~futuresdr_tpu_torch.tpu.kernel_block.TpuFanoutKernel` /
:class:`~futuresdr_tpu_torch.tpu.kernel_block.TpuDagKernel` over a
:class:`~futuresdr_tpu_torch.ops.stages.FanoutPipeline` /
:class:`~futuresdr_tpu_torch.ops.stages.DagPipeline`, composed with
``optimize=False`` so each member's stages stay as they were. On a card the
fused program is one CUDA-graph replay a dispatch group: k dispatches a frame
become 1, and a fan-out's input crosses the link once. The fused block works
the region's own boundary ports (the first member's stream input, each sink's
stream output), so buffers, tags and backpressure are the live flowgraph's;
:func:`run_devchain_task` answers the supervisor for every member (init
barrier, ``Terminate``, one ``BlockDone`` each), and a metrics bridge keeps
``metrics()`` and the REST ``describe``/``metrics`` routes reporting the
original blocks.

Member boundaries carry an identity stage (:func:`_boundary_stage`), where
the reference stashes the boundary frame in the carry to pin XLA's fusion:
the port runs each stage's own kernels in either mode, so the fence computes
nothing; it keeps the stage indices and carry slots those of the reference,
which the ``ctrl`` translation addresses. A fused region is therefore bit
for bit the per-hop run wherever both run the same kernels on the same
shapes; the fused program runs a dispatch's K frames one after another, so
K does not change them.

Refusals (the region stays on the per-hop path, logged at debug level):

* a member whose ports are wired to a message edge, unless it carries
  ``devchain_static = True``;
* members on different ``TpuInstance`` objects (for a fan-out or a DAG, one
  such member declines the whole region);
* a broadcast whose edges do not all open fusable runs, a merge with an
  input from outside the region, an ``equal`` merge fed at different rates,
  a region whose sink feeds host blocks that loop back into it;
* a first-member frame size that is not a multiple of the composed frame
  multiple, or a ``TpuD2H`` whose dtype is not the composed output's;
* a stage block holding mid-stream state from an earlier run;
* a per-kernel ``devchain = False``, or ``FSDR_NO_DEVCHAIN=1`` (everything
  declines; a script can compare both modes in one process);
* a member with an ``isolate`` policy, its own or a config
  ``block_isolate_groups`` group (one member of a fused program cannot
  retire alone); ``restart`` members fuse;
* everything, while the process default ``block_policy`` is ``isolate``, or
  a ``work`` fault site, or a block-addressed ``dispatch:<name>`` or
  ``carry:<name>`` site is armed (the fused kernel polls the bare sites
  under its own name, so such a campaign would go quiet).

* ends whose wire formats differ: a frame-plane region's ``TpuH2D`` and
  each of its ``TpuD2H`` sinks, or any two ``TpuKernel`` members, must agree
  (the fused kernel runs the region on the first member's wire, and only its
  ends cross the link).

A fused region with a ``restart`` member restarts in place: the fused
kernel checkpoints its composed carry (``_dc_restartable``), and on a work
error the drive loop recovers it from the checkpoint and replays its groups
bit for bit, or, where no checkpoint serves, re-inits it, out of that
member's restart budget; each attempt is reported under the member's name.
The native CPU pass, ``fastchain.py``, runs before this one, as in the
reference: a host stream block it fuses is not seen here.

A ``ctrl`` retune addressed to a fused member (``handle.call(member,
"ctrl", …)``) becomes carry surgery on the fused pipeline between
dispatches, at the member's stage range; a ``TpuStage``'s queued pre-launch
``ctrl`` is applied to the fused carry at compile. Other ports answer
``Pmt.invalid_value()``.

Telemetry: a fused run records one ``devchain`` span (its members, frames,
dispatches and K; a fan-out's branches and a DAG's sinks with the items
each carried) for the doctor's report, and each restart attempt journals a
``devchain``/``restart`` event; the fused kernel's own spans are
:class:`~futuresdr_tpu_torch.tpu.TpuKernel`'s.

Known divergence from the per-hop path, as in the reference: at EOS the
composed frame contract applies once, so a final partial frame may yield up
to one frame multiple fewer items than the hops do.
"""

from __future__ import annotations

import asyncio
import os
from fractions import Fraction
from typing import List, Sequence

import numpy as np

from ..log import logger
from ..telemetry import journal as _tel_journal
from ..telemetry.spans import recorder as _trace_recorder
from . import faults as _faults
from .block import fusion_degraded, policy_allows_fusion
from .inbox import (Call, Callback, Initialize, StreamInputDone, StreamOutputDone,
                    Terminate)
from .work_io import WorkIo

__all__ = ["DevChain", "find_device_chains", "run_devchain_task",
           "shed_devchain_bridge", "devchain_enabled"]

log = logger("runtime.devchain")
_trace = _trace_recorder()


def devchain_enabled() -> bool:
    """The pass's switch, read at every launch so a script can compare the
    fused and per-hop paths in one process: ``FSDR_NO_DEVCHAIN`` set to
    anything turns it off, and so do an ``isolate`` process default and the
    fault campaigns fused mode would quietly disarm (module docstring)."""
    if os.environ.get("FSDR_NO_DEVCHAIN"):
        return False
    plan = _faults.plan()
    if fusion_degraded(("work",), allow_restart=True) or \
            plan.has_named_site("dispatch") or plan.has_named_site("carry"):
        log.info("devchain: a failure policy or fault campaign declines fusion")
        return False
    return True


class DevChain(list):
    """A fusable region, members in topological order. ``kind`` is
    ``"frames"`` or ``"kernels"``. A linear run is the member list alone; a
    fan-out also carries ``producer`` and ``branches`` (the flat list is
    ``producer + branches[0] + …``); a DAG carries ``nodes`` (per member, the
    indices of the members feeding it, a merge's in port order), ``sinks``
    and ``node_ratios`` (each member's output rate against the region
    input)."""

    def __init__(self, members, kind: str, producer=None, branches=None,
                 nodes=None, sinks=None, node_ratios=None):
        super().__init__(members)
        self.kind = kind
        self.producer = producer
        self.branches = branches
        self.nodes = nodes
        self.sinks = sinks
        self.node_ratios = node_ratios

    @property
    def fanout(self) -> bool:
        return self.branches is not None

    @property
    def dag(self) -> bool:
        return self.nodes is not None


class _FwdCtrl:
    """A Call/Callback to an interior member, forwarded into the drive
    loop's inbox (carry surgery happens on the drive thread)."""

    __slots__ = ("idx", "msg")

    def __init__(self, idx: int, msg):
        self.idx = idx
        self.msg = msg


def _member_ratio(k) -> Fraction:
    pipe = getattr(k, "pipeline", None)
    return pipe.ratio if pipe is not None else Fraction(1, 1)


def _member_fused_stages(m) -> list:
    """The member → stage-list map that the finder's DAG check and
    :func:`_build_fused_dag` share: ``[merge] + post`` for a merge block,
    the pipeline's stages for a stage block or kernel, none for the H2D and
    D2H endpoints."""
    from ..tpu.frames import TpuMergeStage
    if type(m) is TpuMergeStage:
        return [m.merge] + list(m.post)
    p = getattr(m, "pipeline", None)
    return list(p.stages) if p is not None else []


def find_device_chains(fg) -> List[DevChain]:
    """The maximal fusable device-plane regions of ``fg`` (module docstring)."""
    if not devchain_enabled():
        return []
    from ..ops.stages import DagPipeline, Pipeline
    from ..tpu.frames import TpuD2H, TpuH2D, TpuMergeStage, TpuStage
    from ..tpu.kernel_block import TpuKernel

    msg_touched = {id(e.src) for e in fg.message_edges} | \
                  {id(e.dst) for e in fg.message_edges}
    s_out: dict = {}
    s_in: dict = {}
    for e in fg.stream_edges:
        s_out.setdefault(id(e.src), []).append(e)
        s_in.setdefault(id(e.dst), []).append(e)
    i_out: dict = {}
    i_in: dict = {}
    for e in fg.inplace_edges:
        i_out.setdefault(id(e.src), []).append(e)
        i_in.setdefault(id(e.dst), []).append(e)

    def member_ok(k) -> bool:
        if getattr(k, "devchain", True) is False:
            return False
        # a wired ctrl means retunes synchronized to another block's stream;
        # the fused chain batches frames in flight, so it declines
        if id(k) in msg_touched and not getattr(k, "devchain_static", False):
            return False
        if not policy_allows_fusion(k, restartable=True):
            log.debug("devchain refuses %s: isolate failure policy", k)
            return False
        return True

    claimed: set = set()
    chains: List[DevChain] = []

    def in_dtype_of(first, kind):
        return first.dtype if kind == "frames" else first.pipeline.in_dtype

    def _wires_agree(members, ends, what) -> bool:
        """The region's link ends share one wire format."""
        if len({m.wire.name for m in ends}) != 1:
            log.debug("devchain refuses %s%s: wire mismatch (%s)", what, members,
                      [m.wire.name for m in ends])
            return False
        return True

    def _close(members, kind) -> None:
        first, last = members[0], members[-1]
        if not _wires_agree(members, [first, last] if kind == "frames" else members, ""):
            return
        if len({id(m.inst) for m in members}) != 1:
            log.debug("devchain refuses %s: mismatched TpuInstances", members)
            return
        stages = [s for m in members for s in _member_fused_stages(m)]
        composed = Pipeline(stages, in_dtype_of(first, kind), optimize=False)
        if first.frame_size % composed.frame_multiple:
            log.debug("devchain refuses %s: frame %d not a multiple of the composed "
                      "contract %d", members, first.frame_size, composed.frame_multiple)
            return
        if kind == "frames" and np.dtype(composed.out_dtype) != np.dtype(last.dtype):
            log.debug("devchain refuses %s: D2H dtype %s != composed %s",
                      members, last.dtype, composed.out_dtype)
            return
        claimed.update(id(m) for m in members)
        chains.append(DevChain(members, kind))

    def _close_fanout(producer, branches, kind) -> None:
        members = list(producer) + [m for br in branches for m in br]
        first = producer[0]
        ends = [first] + [br[-1] for br in branches] if kind == "frames" else members
        if not _wires_agree(members, ends, "fan-out "):
            return
        if len({id(m.inst) for m in members}) != 1:
            log.debug("devchain refuses fan-out %s: mismatched TpuInstances", members)
            return
        prod_stages = [s for m in producer for s in _member_fused_stages(m)]
        in_dtype = in_dtype_of(first, kind)
        fm = 1
        for br in branches:
            br_stages = [s for m in br for s in _member_fused_stages(m)]
            path = Pipeline(prod_stages + br_stages, in_dtype, optimize=False)
            fm = int(np.lcm(fm, path.frame_multiple))
            if kind == "frames" and np.dtype(path.out_dtype) != np.dtype(br[-1].dtype):
                log.debug("devchain refuses fan-out %s: D2H dtype %s != composed %s",
                          members, br[-1].dtype, path.out_dtype)
                return
        if first.frame_size % fm:
            log.debug("devchain refuses fan-out %s: frame %d not a multiple of the "
                      "composed contract %d", members, first.frame_size, fm)
            return
        claimed.update(id(m) for m in members)
        chains.append(DevChain(members, kind, producer=list(producer),
                               branches=[list(br) for br in branches]))

    def _host_cycle(members) -> bool:
        """A data path (stream or in-place edges) that leaves the region and
        comes back into it through host blocks. Message edges do not count:
        their inboxes are unbounded and ctrl applies between dispatches."""
        member_ids = {id(m) for m in members}
        adj: dict = {}
        for e in fg.stream_edges + fg.inplace_edges:
            adj.setdefault(id(e.src), []).append(e.dst)
        stack = [d for m in members for d in adj.get(id(m), [])
                 if id(d) not in member_ids]
        seen: set = set()
        while stack:
            b = stack.pop()
            if id(b) in seen:
                continue
            seen.add(id(b))
            for d in adj.get(id(b), []):
                if id(d) in member_ids:
                    return True
                stack.append(d)
        return False

    def _topo(n, node_inputs):
        """Kahn's order over the region's nodes; None on a cycle."""
        indeg = [0] * n
        cons: List[list] = [[] for _ in range(n)]
        for i, ins in enumerate(node_inputs):
            for j in ins:
                indeg[i] += 1
                cons[j].append(i)
        order = [i for i in range(n) if indeg[i] == 0]
        qi = 0
        while qi < len(order):
            for c in cons[order[qi]]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    order.append(c)
            qi += 1
        return order if len(order) == n else None

    def _close_dag(members, node_inputs, kind) -> None:
        first = members[0]
        if len({id(m.inst) for m in members}) != 1:
            log.debug("devchain refuses DAG %s: mismatched TpuInstances", members)
            return
        try:
            dag = DagPipeline([(_member_fused_stages(m), node_inputs[i])
                               for i, m in enumerate(members)],
                              in_dtype_of(first, kind), optimize=False)
        except ValueError as e:
            log.debug("devchain refuses DAG %s: %s", members, e)
            return
        ends = [first] + [members[i] for i in dag.sinks] if kind == "frames" else members
        if not _wires_agree(members, ends, "DAG "):
            return
        if first.frame_size % dag.frame_multiple:
            log.debug("devchain refuses DAG %s: frame %d not a multiple of the "
                      "composed contract %d", members, first.frame_size,
                      dag.frame_multiple)
            return
        if kind == "frames":
            for j, i in enumerate(dag.sinks):
                if np.dtype(dag.out_dtypes[j]) != np.dtype(members[i].dtype):
                    log.debug("devchain refuses DAG %s: D2H dtype %s != composed %s",
                              members, members[i].dtype, dag.out_dtypes[j])
                    return
        claimed.update(id(m) for m in members)
        chains.append(DevChain(members, kind, nodes=list(node_inputs),
                               sinks=list(dag.sinks), node_ratios=list(dag.node_ratios)))

    def _classify(node_inputs) -> str:
        if any(len(ins) > 1 for ins in node_inputs):
            return "dag"
        cons = [0] * len(node_inputs)
        for ins in node_inputs:
            for j in ins:
                cons[j] += 1
        multi = [i for i, c in enumerate(cons) if c > 1]
        if not multi:
            return "linear"
        return "fanout" if len(multi) == 1 else "dag"

    def _split_fanout(members, node_inputs):
        """A single-broadcast tree as ``(producer, branches)``."""
        n = len(members)
        cons: List[list] = [[] for _ in range(n)]
        for i, ins in enumerate(node_inputs):
            for j in ins:
                cons[j].append(i)
        b = next(i for i in range(n) if len(cons[i]) > 1)
        producer, cur = [], 0
        while True:
            producer.append(members[cur])
            if cur == b:
                break
            cur = cons[cur][0]
        branches = []
        for head in cons[b]:
            br, cur = [], head
            while True:
                br.append(members[cur])
                if not cons[cur]:
                    break
                cur = cons[cur][0]
            branches.append(br)
        return producer, branches

    def _chain_order(members, node_inputs):
        nxt = {}
        for i, ins in enumerate(node_inputs):
            for j in ins:
                nxt[j] = i
        out, cur = [members[0]], 0
        while cur in nxt:
            cur = nxt[cur]
            out.append(members[cur])
        return out

    def _close_region(members, node_inputs, kind) -> None:
        shape = _classify(node_inputs)
        if _host_cycle(members):
            log.debug("devchain refuses %s region %s: cycle through host edges",
                      shape, members)
            return
        if shape == "linear":
            if len(members) >= 2:
                _close(_chain_order(members, node_inputs), kind)
        elif shape == "fanout":
            _close_fanout(*_split_fanout(members, node_inputs), kind)
        else:
            _close_dag(members, node_inputs, kind)

    kernels = [b.kernel for b in fg._blocks if b is not None]

    # ---- frame-plane regions: the DAG rooted at a TpuH2D ---------------------
    def _grow_frame_dag(root):
        """Forward closure of ``root`` over in-place edges, in topological
        order, or None when a reachable consumer refuses."""
        members, idx = [root], {id(root): 0}
        qi = 0
        while qi < len(members):
            cur = members[qi]
            qi += 1
            if type(cur) is TpuD2H:
                continue                 # sinks end the plane
            outs = i_out.get(id(cur), [])
            if not outs:
                log.debug("devchain refuses region at %s: dangling device node %s",
                          root, cur)
                return None
            for e in outs:
                nxt = e.dst
                if id(nxt) in idx:
                    continue
                if type(nxt) not in (TpuStage, TpuMergeStage, TpuD2H) \
                        or id(nxt) in claimed or not member_ok(nxt):
                    log.debug("devchain refuses region at %s: consumer %s", root, nxt)
                    return None
                if type(nxt) in (TpuStage, TpuMergeStage) and nxt._carry is not None:
                    # mid-stream state from an earlier run: the per-hop path
                    # resumes it, a fused fresh carry would not
                    log.debug("devchain refuses region at %s: %s carries mid-stream "
                              "state", root, nxt)
                    return None
                if type(nxt) is TpuD2H and (i_out.get(id(nxt)) or not s_out.get(id(nxt))):
                    log.debug("devchain refuses region at %s: D2H %s must exit to "
                              "the stream plane", root, nxt)
                    return None
                idx[id(nxt)] = len(members)
                members.append(nxt)
        node_inputs: List[list] = []
        for m in members:
            if m is root:
                node_inputs.append([])
                continue
            ins = i_in.get(id(m), [])
            if type(m) is TpuMergeStage:
                by_port = {}
                for e in ins:
                    if e.dst_port in by_port:
                        log.debug("devchain refuses region at %s: merge port %s "
                                  "wired twice", root, e.dst_port)
                        return None
                    by_port[e.dst_port] = e.src
                srcs = []
                for i in range(m.merge.k):
                    src = by_port.get(f"in{i}")
                    if src is None:
                        log.debug("devchain refuses region at %s: merge input in%d "
                                  "unwired", root, i)
                        return None
                    srcs.append(src)
            else:
                if len(ins) != 1:
                    log.debug("devchain refuses region at %s: %s has %d inputs",
                              root, m, len(ins))
                    return None
                srcs = [ins[0].src]
            if any(id(src) not in idx for src in srcs):
                log.debug("devchain refuses region at %s: %s takes an input from "
                          "outside the region", root, m)
                return None
            node_inputs.append([idx[id(src)] for src in srcs])
        order = _topo(len(members), node_inputs)
        if order is None:
            log.debug("devchain refuses region at %s: cyclic in-place graph", root)
            return None
        remap = {old: new for new, old in enumerate(order)}
        return ([members[i] for i in order],
                [[remap[j] for j in node_inputs[i]] for i in order])

    for k in kernels:
        if type(k) is not TpuH2D or id(k) in claimed or not member_ok(k):
            continue
        if len(s_in.get(id(k), [])) != 1 or not i_out.get(id(k)):
            continue                     # an unwired H2D
        region = _grow_frame_dag(k)
        if region is not None and len(region[0]) >= 2:
            _close_region(region[0], region[1], "frames")

    # ---- TpuKernel regions over stream edges (out-trees: stream ports have
    # one writer, so fan-in rides the frame plane's merge block) -------------
    def _kernel_ok(k) -> bool:
        # exact type: a fan-out or DAG kernel drives its own sinks
        return (type(k) is TpuKernel and id(k) not in claimed and member_ok(k)
                and not i_out.get(id(k)) and not i_in.get(id(k)))

    def _follows(a, b) -> bool:
        return (_kernel_ok(b) and len(s_in.get(id(b), [])) == 1
                and id(b.inst) == id(a.inst) and b.wire.name == a.wire.name)

    def _will_extend(src, k) -> bool:
        outs = s_out.get(id(src), [])
        if len(outs) == 1:
            return _follows(src, k)
        return all(_follows(src, e.dst) for e in outs)

    def _is_head(k) -> bool:
        ups = s_in.get(id(k), [])
        return not (len(ups) == 1 and _kernel_ok(ups[0].src)
                    and _will_extend(ups[0].src, k))

    def _grow_kernel_tree(root):
        """Forward closure of ``root`` over stream edges. A branch ends at a
        consumer that does not follow; a broadcast with any such consumer
        ends the region at its owner, whose port still serves every reader
        (the fusable branches are heads of their own)."""
        members, idx = [root], {id(root): 0}
        node_inputs: List[list] = [[]]
        qi = 0
        while qi < len(members):
            cur = members[qi]
            qi += 1
            outs = s_out.get(id(cur), [])
            if len(outs) == 1:
                nxt = outs[0].dst
                if not _follows(cur, nxt) or id(nxt) in idx:
                    continue
                idx[id(nxt)] = len(members)
                members.append(nxt)
                node_inputs.append([idx[id(cur)]])
            elif len(outs) > 1:
                if any(not _follows(cur, e.dst) or id(e.dst) in idx for e in outs):
                    log.debug("devchain region at %s ends at %s: a broadcast "
                              "consumer is not fusable", root, cur)
                    continue
                for e in outs:
                    idx[id(e.dst)] = len(members)
                    members.append(e.dst)
                    node_inputs.append([idx[id(cur)]])
        return members, node_inputs

    for k in kernels:
        if not _kernel_ok(k) or not _is_head(k):
            continue
        members, node_inputs = _grow_kernel_tree(k)
        if len(members) >= 2:
            _close_region(members, node_inputs, "kernels")
    return chains


# ---------------------------------------------------------------------------
# the fused block and the metrics bridge
# ---------------------------------------------------------------------------

def _boundary_stage():
    """The member-boundary fence: an identity stage (module docstring)."""
    from ..ops.stages import Stage, _stateless

    def fn(carry, x):
        return carry, x

    return Stage(fn, _stateless, name="devchain_boundary")


def _members_pinned_depth(members) -> bool:
    """Did a member pin its in-flight depth (``frames_in_flight``,
    ``max_inflight``)? The fused kernel's credits then stay pinned."""
    return any(getattr(m, "_depth_explicit", False) for m in members)


def _depth_and_k(chain: "DevChain", first, sig, in_dtype):
    """The fused kernel's depth and K: the first member's (a frame-plane
    region takes the H2D's queue bound and the config K). With K left to
    the config and config ``tpu_frames_per_dispatch`` at 0 (auto), a region
    that ``autotune_streamed`` tuned launches with its cached K (the
    reference's ``_resolve_k_batch``; ``sig`` is the region's stage list or
    fan-out/DAG pipeline, the fences ignored by the cache's keys)."""
    from ..config import config
    if chain.kind == "frames":
        depth, k_batch = first.max_inflight, None
    else:
        depth, k_batch = first.depth, first.k_batch
    if (k_batch is None or (k_batch == 1 and not getattr(first, "_k_explicit", False))) and \
            int(config().tpu_frames_per_dispatch) == 0:
        from ..tpu.autotune import cached_frames_per_dispatch, platform_of
        k = cached_frames_per_dispatch(sig, in_dtype, platform_of(first.inst))
        if k and k > 1:
            log.info("devchain: frames_per_dispatch=%d from the cached autotune pick", k)
            k_batch = k
    return depth, k_batch


def _steal_ports(fused, first, tails) -> None:
    """The fused kernel works the region's own boundary ports."""
    fused._stream_inputs = [first.input]
    fused.input = first.input
    fused._stream_outputs = [t.output for t in tails]
    fused.output = tails[0].output
    if hasattr(fused, "outputs"):
        fused.outputs = [t.output for t in tails]


def _build_fused(chain: DevChain):
    """One kernel over the region: a :class:`TpuKernel` over the linear
    composition, or a fan-out or DAG kernel (:func:`_build_fused_fanout`,
    :func:`_build_fused_dag`)."""
    from ..ops.stages import Pipeline
    from ..tpu.kernel_block import TpuKernel

    if chain.dag:
        return _build_fused_dag(chain)
    if chain.fanout:
        return _build_fused_fanout(chain)
    members = list(chain)
    first, last = members[0], members[-1]
    in_dtype = first.dtype if chain.kind == "frames" else first.pipeline.in_dtype
    # frame-plane runs fence the H2D and D2H edges too, kernel runs only the
    # boundaries between members (the reference's fence layout)
    fence_edges = chain.kind == "frames"
    has_pipes = any(getattr(m, "pipeline", None) is not None for m in members)
    stages: list = []
    slices: list = []        # a member's (start, stop) in the composed list
    seen = 0
    if fence_edges and has_pipes:
        stages.append(_boundary_stage())
    for m in members:
        p = getattr(m, "pipeline", None)
        if p is None:
            slices.append((len(stages), len(stages)))
            continue
        if seen:
            stages.append(_boundary_stage())
        slices.append((len(stages), len(stages) + len(p.stages)))
        stages.extend(p.stages)
        seen += 1
    if fence_edges and has_pipes:
        stages.append(_boundary_stage())
    depth, k_batch = _depth_and_k(chain, first, stages, in_dtype)
    composed = Pipeline(stages, in_dtype, optimize=False)
    fused = TpuKernel((), in_dtype, frame_size=first.frame_size, inst=first.inst,
                      frames_in_flight=depth, frames_per_dispatch=k_batch,
                      wire=first.wire, _pipeline=composed)
    if fused.frame_size != first.frame_size:
        raise ValueError(f"devchain: fused frame {fused.frame_size} != "
                         f"{first.frame_size}")
    fused._adopt_credit_mode(not _members_pinned_depth(members))
    _steal_ports(fused, first, [last])
    fused.meta.instance_name = f"devchain[{type(first).__name__}…x{len(members)}]"
    fused._dc_slices = slices
    return fused


def _build_fused_fanout(chain: DevChain):
    """One :class:`TpuFanoutKernel` over the region's composed fan-out,
    working the producer's input port and each branch tail's output port.
    Every member boundary has a fence, and the producer → branches boundary
    always has one."""
    from ..ops.stages import FanoutPipeline
    from ..tpu.kernel_block import TpuFanoutKernel

    producer, branches = chain.producer, chain.branches
    first = producer[0]
    fence_edges = chain.kind == "frames"
    in_dtype = first.dtype if chain.kind == "frames" else first.pipeline.in_dtype
    slices: list = []

    def walk(seg_members, base, lead, trail):
        stages, seen = [], 0
        if lead:
            stages.append(_boundary_stage())
        for m in seg_members:
            p = getattr(m, "pipeline", None)
            if p is None:
                slices.append((base + len(stages), base + len(stages)))
                continue
            if seen:
                stages.append(_boundary_stage())
            slices.append((base + len(stages), base + len(stages) + len(p.stages)))
            stages.extend(p.stages)
            seen += 1
        if trail and (seen or not lead):
            stages.append(_boundary_stage())
        return stages

    p_stages = walk(producer, 0, lead=fence_edges, trail=True)
    base = len(p_stages)
    branch_lists = []
    for br in branches:
        has_pipes = any(getattr(m, "pipeline", None) is not None for m in br)
        b_stages = walk(br, base, lead=False, trail=fence_edges and has_pipes)
        branch_lists.append(b_stages)
        base += len(b_stages)
    fanout = FanoutPipeline(p_stages, branch_lists, in_dtype, optimize=False)
    depth, k_batch = _depth_and_k(chain, first, fanout, in_dtype)
    fused = TpuFanoutKernel(fanout, frame_size=first.frame_size, inst=first.inst,
                            frames_in_flight=depth, frames_per_dispatch=k_batch,
                            wire=first.wire)
    if fused.frame_size != first.frame_size:
        raise ValueError(f"devchain: fused frame {fused.frame_size} != "
                         f"{first.frame_size}")
    fused._adopt_credit_mode(not _members_pinned_depth(list(chain)))
    _steal_ports(fused, first, [br[-1] for br in branches])
    fused.meta.instance_name = (f"devchain[{type(first).__name__}…x{len(chain)}"
                                f"⇉{len(branches)}]")
    fused._dc_slices = slices
    return fused


def _build_fused_dag(chain: DevChain):
    """One :class:`TpuDagKernel` over the region's DAG, working the root's
    input port and each sink's output port. Every member but a kernel-plane
    sink gets a trailing fence (the reference's layout)."""
    from ..ops.stages import DagPipeline
    from ..tpu.kernel_block import TpuDagKernel

    members = list(chain)
    first = members[0]
    in_dtype = first.dtype if chain.kind == "frames" else first.pipeline.in_dtype
    sink_set = set(chain.sinks)
    slices: list = []
    nodes: list = []
    off = 0
    for i, m in enumerate(members):
        sl = _member_fused_stages(m)
        stages = list(sl)
        if not (chain.kind == "kernels" and i in sink_set):
            stages.append(_boundary_stage())
        slices.append((off, off + len(sl)))
        off += len(stages)
        nodes.append((stages, chain.nodes[i]))
    dag = DagPipeline(nodes, in_dtype, optimize=False)
    depth, k_batch = _depth_and_k(chain, first, dag, in_dtype)
    fused = TpuDagKernel(dag, frame_size=first.frame_size, inst=first.inst,
                         frames_in_flight=depth, frames_per_dispatch=k_batch,
                         wire=first.wire)
    if fused.frame_size != first.frame_size:
        raise ValueError(f"devchain: fused frame {fused.frame_size} != "
                         f"{first.frame_size}")
    fused._adopt_credit_mode(not _members_pinned_depth(members))
    tails = [members[i] for i in chain.sinks]
    _steal_ports(fused, first, tails)
    fused.meta.instance_name = (f"devchain[{type(first).__name__}…x{len(members)}"
                                f"⋈{len(tails)}]")
    fused._dc_slices = slices
    return fused


def _port_name(kernel, port):
    """A Call/Callback port (PortId, index or name) as a handler name."""
    from ..types import PortId
    pid = port.id if isinstance(port, PortId) else port
    if isinstance(pid, int):
        names = kernel.message_input_names()
        return names[pid] if 0 <= pid < len(names) else None
    return pid


def _apply_stage_update(fused, idx: int, stage, params: dict) -> None:
    """Translate member ``idx``'s stage address (name or index) into the
    fused pipeline's and retune there (``TpuKernel.apply_retune``); raises
    on a bad address."""
    start, stop = fused._dc_slices[idx]
    if isinstance(stage, str):
        hits = [j for j in range(start, stop) if fused.pipeline.stages[j].name == stage]
        if not hits:
            raise KeyError(f"no stage named {stage!r} in fused member {idx}")
        if len(hits) > 1:
            raise KeyError(f"stage name {stage!r} is ambiguous")
        j = hits[0]
    else:
        j = start + int(stage)
        if not start <= j < stop:
            raise KeyError(f"stage index {stage} out of member range")
    fused.apply_retune(j, **params)


def _apply_ctrl(fused, member_kernels, idx: int, port, p):
    """A ``ctrl`` retune addressed to fused member ``idx``; other ports
    answer invalid, as the member would for an unknown handler."""
    from ..tpu.frames import parse_ctrl
    from ..types import Pmt
    k = member_kernels[idx]
    if _port_name(k, port) != "ctrl" or "ctrl" not in k.message_input_names():
        return Pmt.invalid_value()
    try:
        stage, params = parse_ctrl(p)
        _apply_stage_update(fused, idx, stage, params)
    except Exception as e:                             # noqa: BLE001 — a bad request
        log.warning("devchain ctrl rejected: %r", e)
        return Pmt.invalid_value()
    return Pmt.ok()


def shed_devchain_bridge(kernel) -> None:
    """Restore a kernel's own ``extra_metrics`` where a fused run's bridge
    was installed (the supervisor calls it for every per-hop block)."""
    if not hasattr(kernel, "_dc_base_extra"):
        return
    base = kernel._dc_base_extra
    if base is None:
        try:
            del kernel.extra_metrics
        except AttributeError:
            pass
    else:
        kernel.extra_metrics = base
    del kernel._dc_base_extra


def _chain_rates(chain: DevChain) -> list:
    """Per member (flat order): ``(kernel, in-rate, out-rate, branch)``
    against the region input. ``branch`` is None for linear chains and
    producers, else the branch index; a DAG reads its node rates, a merge's
    in-rate is the tuple of its ports' rates, and ``branch`` is the one sink
    a member reaches (None where it reaches several)."""
    if chain.dag:
        n = len(chain)
        cons: list = [[] for _ in range(n)]
        for i, ins in enumerate(chain.nodes):
            for j in ins:
                cons[j].append(i)
        reach = [set() for _ in range(n)]
        for pos, sk in enumerate(chain.sinks):
            reach[sk].add(pos)
        for i in range(n - 1, -1, -1):
            for c in cons[i]:
                reach[i] |= reach[c]
        out = []
        for i, m in enumerate(chain):
            ins = chain.nodes[i]
            if not ins:
                r_in = Fraction(1, 1)
            elif len(ins) == 1:
                r_in = chain.node_ratios[ins[0]]
            else:
                r_in = tuple(chain.node_ratios[j] for j in ins)
            branch = next(iter(reach[i])) if len(reach[i]) == 1 else None
            out.append((m, r_in, chain.node_ratios[i], branch))
        return out
    out = []
    r_in = Fraction(1, 1)
    for m in (chain.producer if chain.fanout else list(chain)):
        r_out = r_in * _member_ratio(m)
        out.append((m, r_in, r_out, None))
        r_in = r_out
    if chain.fanout:
        r_boundary = r_in
        for j, br in enumerate(chain.branches):
            r_in = r_boundary
            for m in br:
                r_out = r_in * _member_ratio(m)
                out.append((m, r_in, r_out, j))
                r_in = r_out
    return out


def _set_member_counters(m, boundary, items: int, r_in, r_out: Fraction) -> None:
    if isinstance(r_in, tuple):                 # a merge: a rate a port
        for p, r in zip(m.stream_inputs, r_in):
            if id(p) not in boundary:
                p.items_consumed = int(items * r)
    else:
        for p in m.stream_inputs:
            if id(p) not in boundary:           # boundary counters are live
                p.items_consumed = int(items * r_in)
    for p in m.stream_outputs:
        if id(p) not in boundary:
            p.items_produced = int(items * r_out)


def _boundary_ports(fused) -> set:
    outs = getattr(fused, "outputs", None) or [fused.output]
    return {id(fused.input)} | {id(o) for o in outs}


def _bridge_extra(fused, branch) -> dict:
    out = dict(fused_devchain=True, devchain_frames=fused.frames_dispatched,
               devchain_dispatches=fused.dispatches, frames_per_dispatch=fused.k_batch)
    if branch is not None:
        out["devchain_branch"] = branch
    return out


def _install_bridge(chain: DevChain, fused) -> None:
    """Each original block keeps reporting its own item counters, derived
    from the fused kernel's frame count through its rate, plus
    ``fused_devchain`` and the fused dispatch counts (and ``devchain_branch``
    for a branch or single-sink member)."""
    boundary = _boundary_ports(fused)
    for m, r_in, r_out, branch in _chain_rates(chain):
        if not hasattr(m, "_dc_base_extra"):
            m._dc_base_extra = getattr(m, "extra_metrics", None)
        base_extra = m._dc_base_extra

        def extra(m=m, r_in=r_in, r_out=r_out, branch=branch, base_extra=base_extra):
            _set_member_counters(m, boundary, fused.frames_dispatched * fused.frame_size,
                                 r_in, r_out)
            return dict((base_extra() if callable(base_extra) else {}),
                        **_bridge_extra(fused, branch))

        m.extra_metrics = extra


def _freeze_bridge(chain: DevChain, fused) -> None:
    """Swap the live bridge for the final numbers once the run is over, so
    the members stop holding the fused kernel (its graphs and buffers)."""
    boundary = _boundary_ports(fused)
    for m, r_in, r_out, branch in _chain_rates(chain):
        _set_member_counters(m, boundary, fused.frames_dispatched * fused.frame_size,
                             r_in, r_out)
        base_extra = getattr(m, "_dc_base_extra", None)
        snap = dict((base_extra() if callable(base_extra) else {}),
                    **_bridge_extra(fused, branch))
        m.extra_metrics = (lambda s=snap: dict(s))


# ---------------------------------------------------------------------------
# the supervisor protocol for every member, and the fused drive loop
# ---------------------------------------------------------------------------

async def _next_msg(inbox):
    """The next inbox message; None on a bare notify (the start signal)."""
    msg = inbox.try_recv()
    if msg is not None:
        return msg
    await inbox.wait()
    inbox.take_pending()
    return inbox.try_recv()


async def run_devchain_task(members: Sequence, chain: DevChain, fg_inbox,
                            scheduler) -> None:
    """Answer the supervisor for ``members`` (WrappedKernels) while the
    fused kernel drives the region: the init barrier for each member (the
    fused program compiles inside it, on a pool thread), the drive loop on
    a thread of its own against the region's boundary ports, then one
    ``BlockDone`` a member with the counters bridged. A fused kernel that
    fails to build or compile ends the flowgraph with its error; one that
    fails to run restarts in place where a member has a ``restart`` policy
    (out of that member's budget), else ends it too."""
    from ..types import Pmt
    from .runtime import BlockDoneMsg, BlockErrorMsg, InitializedMsg

    def _finish_all():
        for b in members:
            fg_inbox.send(BlockDoneMsg(b.id, b))

    def _error_out(e):
        log.error("devchain failed (%r)", e)
        fg_inbox.send(BlockErrorMsg(members[0].id, e))
        for b in members[1:]:
            fg_inbox.send(BlockDoneMsg(b.id, b))

    for b in members:
        while True:
            msg = await _next_msg(b.inbox)
            if isinstance(msg, Initialize):
                break
            if isinstance(msg, Terminate):
                _finish_all()
                return
            if isinstance(msg, Callback):
                msg.reply.set(Pmt.invalid_value())
    member_kernels = [b.kernel for b in members]
    # the first member with a restart policy lends the fused kernel its
    # budget, its backoff and its name in the restart decisions
    pol_member = next((b for b in members if b.policy.on_error == "restart"), None)
    try:
        fused = _build_fused(chain)
        # checkpoint the composed carry when the region can restart
        fused._dc_restartable = pol_member is not None
        # compile off the supervisor's loop, as a blocking block's init runs
        await scheduler.spawn_blocking(
            lambda: asyncio.run(fused.init(fused.mio, fused.meta)))
        # a TpuStage's ctrl queued before launch lands on the fused carry
        for idx, k in enumerate(member_kernels):
            for stage, params in getattr(k, "_pending_ctrl", ()):
                try:
                    _apply_stage_update(fused, idx, stage, params)
                except Exception as e:                 # noqa: BLE001 — as the member
                    log.warning("queued ctrl update rejected: %r", e)
            if getattr(k, "_pending_ctrl", None):
                k._pending_ctrl.clear()
        _install_bridge(chain, fused)
    except Exception as e:                             # noqa: BLE001 — reported
        _error_out(e)
        return
    for b in members:
        fg_inbox.send(InitializedMsg(b.id))

    # The drive loop merges the inboxes whose ports the fused kernel works:
    # the region input's (member 0) and each sink's; produce/consume wake-ups
    # land there, the buffers having been bound to those inboxes.
    if chain.dag:
        tail_idx = list(chain.sinks)
    elif chain.fanout:
        tail_idx, off = [], len(chain.producer)
        for br in chain.branches:
            off += len(br)
            tail_idx.append(off - 1)
    else:
        tail_idx = [len(members) - 1]
    tail_set = set(tail_idx)
    multi_out = chain.fanout or chain.dag

    async def watch(b, idx):
        """An interior member's inbox: forward its ctrl calls to the drive
        loop; Terminate reaches the drive loop on its own."""
        while True:
            msg = await _next_msg(b.inbox)
            if isinstance(msg, (Call, Callback)):
                members[0].inbox.send(_FwdCtrl(idx, msg))
            if isinstance(msg, Terminate):
                return

    watchers = [asyncio.ensure_future(watch(b, i)) for i, b in enumerate(members)
                if i != 0 and i not in tail_set]
    first_ib = members[0].inbox
    drive_ibs = [first_ib] + [members[i].inbox for i in tail_idx]
    member_of_ib = {id(first_ib): 0}
    branch_of_ib = {}
    for j, i in enumerate(tail_idx):
        member_of_ib[id(members[i].inbox)] = i
        branch_of_ib[id(members[i].inbox)] = j

    async def _drive():
        io = WorkIo()
        kernel = fused

        async def _restart_fused(err):
            """Recover the fused kernel after a work error, retrying out of
            the policy member's budget: the checkpoint replay, else a
            forfeiting init. None on success, else the exception that ended
            the region."""
            while pol_member is not None and \
                    pol_member.restarts < pol_member.policy.max_restarts:
                await pol_member._note_restart(err, fg_inbox, phase="work")
                _tel_journal.emit("devchain", "restart", region=kernel.meta.instance_name,
                                  attempt=pol_member.restarts, error=repr(err))
                try:
                    if await kernel.recover(err):
                        log.info("devchain %s recovered in place from its composed "
                                 "carry's checkpoint", kernel.meta.instance_name)
                    else:
                        await kernel.init(kernel.mio, kernel.meta)
                    return None
                except Exception as e2:                # noqa: BLE001 — another attempt
                    log.warning("devchain restart attempt failed (%r)", e2)
                    err = e2
            return err

        def ctrl(idx, msg):
            res = _apply_ctrl(kernel, member_kernels, idx, msg.port, msg.data)
            if isinstance(msg, Callback):
                msg.reply.set(res)

        while True:
            for ib in drive_ibs:
                io.call_again = ib.take_pending() or io.call_again
            for ib in drive_ibs:
                while True:
                    msg = ib.try_recv()
                    if msg is None:
                        break
                    if isinstance(msg, _FwdCtrl):
                        ctrl(msg.idx, msg.msg)
                    elif isinstance(msg, (Call, Callback)):
                        ctrl(member_of_ib[id(ib)], msg)
                    elif isinstance(msg, StreamInputDone):
                        kernel.input.set_finished()
                        io.call_again = True
                    elif isinstance(msg, StreamOutputDone):
                        if multi_out:
                            # one sink's reader detached: retire that sink,
                            # the others keep streaming
                            kernel.retire_branch(branch_of_ib[id(ib)])
                            io.call_again = True
                        else:
                            io.finished = True
                    elif isinstance(msg, Terminate):
                        io.finished = True
            if io.finished:
                break
            if not io.call_again:
                waits = [asyncio.ensure_future(ib.wait()) for ib in drive_ibs]
                await asyncio.wait(waits, return_when=asyncio.FIRST_COMPLETED)
                for w in waits:
                    if not w.done():
                        w.cancel()
                continue
            io.reset()
            try:
                await kernel.work(io, kernel.mio, kernel.meta)
            except Exception as e:                     # noqa: BLE001 — the policy's
                terminal = await _restart_fused(e)
                if terminal is not None:
                    raise terminal
                io.reset()
                io.call_again = True                   # look at the ports again

    def _eos_ports():
        for o in (getattr(fused, "outputs", None) or [fused.output]):
            o.notify_finished()
        fused.input.notify_finished()

    error = None
    t_chain = _trace.now()
    try:
        await scheduler.spawn_blocking(lambda: asyncio.run(_drive()))
    except Exception as e:                             # noqa: BLE001 — reported
        error = e
    for w in watchers:
        w.cancel()
    try:
        _eos_ports()
    except Exception as e:                             # noqa: BLE001 — reported
        error = error or e
    _freeze_bridge(chain, fused)
    if error is not None:
        _error_out(error)
        return
    if _trace.enabled:
        # one span for the whole fused run; a fan-out names each branch and a
        # DAG each sink, so the doctor's report says which carried the output
        span_args = {"members": len(members),
                     "frames": fused.frames_dispatched,
                     "dispatches": fused.dispatches,
                     "frames_per_dispatch": fused.k_batch,
                     "per_member": {b.instance_name: fused.frames_dispatched
                                    for b in members}}
        if chain.fanout or chain.dag:
            span_args["branches" if chain.fanout else "sinks"] = [
                {("branch" if chain.fanout else "sink"): j,
                 "tail": members[i].instance_name,
                 **({"members": len(chain.branches[j])} if chain.fanout else {}),
                 "items_out": fused.frames_dispatched * fused.out_frames[j],
                 "retired": bool(fused._branch_done[j])}
                for j, i in enumerate(tail_idx)]
            if chain.dag:
                span_args["merges"] = sum(1 for ins in chain.nodes if len(ins) > 1)
        _trace.complete("devchain", f"devchain[{members[0].instance_name}…x{len(members)}]",
                        t_chain, args=span_args)
    _finish_all()
