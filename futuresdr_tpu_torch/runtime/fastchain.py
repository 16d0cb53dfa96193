"""Native fast-chain substitution: run whole pipes of stream blocks in C++.

A copy of ``futuresdr_tpu/runtime/fastchain.py`` over the port's own host C++
(``csrc/host/fastchain.cpp`` and ``csrc/host/fir_valign.h``, copies of the
files in ``native/``), built by ``ops/_build.load_host`` on first use with
``g++ -O3 -march=native`` and bound with :class:`ctypes.CDLL`, so the native
loop runs without the interpreter lock. A failed build raises with the
compiler's output: there is no silent way back to the actor path, and the
opt-outs are the explicit environment variables below.
:func:`fastchain_available` reports which path runs, :func:`avx512_built`
whether the AVX-512 FIR kernels were compiled in.

Reference role: ``src/runtime/scheduler/flow.rs:265-442`` — the reference's
FlowScheduler exists because per-work-call executor overhead dominates when
blocks forward tiny chunks (its ``perf/null_rand`` regime, and the north-star
``perf/fir/fir.rs:49-95`` grid that interleaves CopyRands with 64-tap FIRs).
Python's asyncio actor loop costs ~10 µs per ``work()`` call there; no amount
of scheduling fixes that floor. This module takes the reference's answer one
step further on the runtime side: a maximal source-rooted TREE whose members
are all native-capable (NullSource/Head/Copy/CopyRand/NullSink/VectorSource/
VectorSink, FileSource (≤256 MB RAM snapshot) and bounded FileSink (≤256 MB,
one-shot flush), plus the DSP set: plain/decimating/rational-resampling Fir
over f32/c64 with f32/c64 taps, QuadratureDemod, and — with the explicit
``fastchain_static = True`` opt-in, because their live retune handlers cannot
reach a fused chain — XlatingFir, sample-mode Agc, the fxpt-NCO SignalSource,
Delay, and Throttle), with no message or inplace edges, is lifted out of the
actor plane entirely and executed by ``csrc/host/fastchain.cpp`` — one C++
thread round-robining the whole tree over plain ring buffers (one pinned
flow.rs worker that owns every block of the pipe). Stages carry their own
output item size, so dtype-changing members (complex FIR → f32 demod) fuse
too. Since the v3 protocol, an output port wired to SEVERAL edges fuses as a
broadcast ring: every consumer sees every item with its own read index — the
actor runtime's 1-writer→N-reader port-group semantics — and a finished
consumer's slot is released so an early-finishing Head branch cannot wedge
its siblings (the actor runtime likewise drops a finished reader). Leaves
must all be sinks; each collecting sink's capacity derives from its own
source→sink path.

The substitution is transparent to the supervisor protocol: the chain task
answers the init barrier for each member, watches for Terminate (the native
loop honors a stop flag), and reports per-member BlockDone with item counters
filled in, so describe/metrics/REST see the same flowgraph. Opt out with
``FSDR_NO_NATIVE=1`` (everything native) or ``FSDR_NO_FASTCHAIN=1`` (just this).

Known divergences from the actor path (the reference's list, which holds here
as well):

- NullSink with a ``count`` consumes EXACTLY ``count`` items natively; the
  actor path may overshoot by up to one work window (``n_received > count``).
- FIR outputs match numpy to float32 rounding (~1e-6 relative), not
  bit-exactly: the native kernel accumulates taps in ascending order while
  ``np.convolve`` routes through BLAS dot. Copy-class chains stay bit-exact.
- CopyRand chunk SIZES come from a different RNG (stress pattern equivalent,
  per-chunk split not identical); data content is identical either way.
- After a fused run, kernel-visible state is written back (``Head.remaining``,
  ``VectorSource._pos/_round``, ``NullSink.n_received``); FIR history and the
  demod's last-sample carry are NOT (the chain ran to completion — a fused
  flowgraph is not resumable mid-stream, same as the reference's drained
  executors).
- Callbacks (``handle.call``) addressed to a fused member are answered with
  ``Pmt.invalid_value()`` — a fused chain is static. This is why
  handler-bearing blocks (XlatingFir's ``freq``, Agc's ``gain_lock``/
  ``reference_power``) require the ``fastchain_static`` opt-in to fuse at all.
- A fused FileSink writes its file once at the END of the run (a mid-run
  Terminate still flushes what was consumed; the file is created at stage
  build for actor-init parity); the actor path streams writes incrementally.
- A fused FileSource emits a launch-time SNAPSHOT of the file; bytes appended
  after launch are not seen (the actor path would read them).
"""

from __future__ import annotations

import asyncio
import ctypes
import os
from typing import List, Optional, Sequence

from ..log import logger
from ..telemetry.spans import recorder as _trace_recorder
from .inbox import Callback, Initialize, Terminate

__all__ = ["find_native_chains", "run_chain_task", "fastchain_available",
           "avx512_built", "library", "shed_metrics_bridge"]

log = logger("runtime.fastchain")
_trace = _trace_recorder()

# stage kinds — keep in sync with csrc/host/fastchain.cpp
(FC_NULL_SOURCE, FC_HEAD, FC_COPY, FC_COPY_RAND, FC_NULL_SINK,
 FC_VEC_SOURCE, FC_VEC_SINK, FC_FIR_FF, FC_FIR_CF, FC_FIR_CC,
 FC_QUAD_DEMOD, FC_XLATING, FC_AGC, FC_RESAMPLE, FC_SIG,
 FC_DELAY, FC_THROTTLE) = range(17)


def _resample_m_hi(total: int, interp: int, decim: int) -> int:
    """Single-sourced from dsp.kernels (the C mirror lives in fastchain.cpp)."""
    from ..dsp.kernels import poly_resample_m_hi
    return poly_resample_m_hi(total, interp, decim)


# the native chain's inter-stage ring, in items
RING_ITEMS = 1 << 16

_FIR_KINDS = (FC_FIR_FF, FC_FIR_CF, FC_FIR_CC, FC_XLATING)


class _FcStage(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int32), ("isz_out", ctypes.c_int32),
                ("p0", ctypes.c_int64), ("p1", ctypes.c_int64),
                ("f0", ctypes.c_double), ("data", ctypes.c_void_p)]


_lib = None


def library() -> ctypes.CDLL:
    """The typed fast-chain library, built on first use. Raises with the
    compiler's output if the build fails, or if the library speaks another
    ABI than this module's."""
    from ..ops import _build
    lib = _build.load_host("fastchain", gil=False)
    if not getattr(lib, "_fsdr_typed", False):
        i64, i32p, i64p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), \
            ctypes.POINTER(ctypes.c_int64)
        lib.fsdr_fastchain_run_v3.restype = i64
        lib.fsdr_fastchain_run_v3.argtypes = [
            ctypes.POINTER(_FcStage), ctypes.c_int32, i32p, i64, i32p, i64p, i64p,
            i64p, i64p]
        lib.fsdr_fastchain_abi.restype = i64
        lib.fsdr_fastchain_avx512.restype = i64
        if lib.fsdr_fastchain_abi() != 9:
            raise RuntimeError("csrc/host/fastchain.cpp speaks ABI "
                               f"{lib.fsdr_fastchain_abi()}, runtime/fastchain.py 9")
        lib._fsdr_typed = True
    return lib


def _opted_out() -> bool:
    """``FSDR_NO_FASTCHAIN`` or ``FSDR_NO_NATIVE`` is set (read on every
    call, so one process can A/B the two paths)."""
    return bool(os.environ.get("FSDR_NO_FASTCHAIN")
                or os.environ.get("FSDR_NO_NATIVE"))


def _load() -> Optional[ctypes.CDLL]:
    """The library, or None where an opt-out is set."""
    global _lib
    if _opted_out():
        return None
    if _lib is None:
        _lib = library()
    return _lib


def fastchain_available() -> bool:
    """True where launches fuse native chains: the library is built and no
    opt-out is set."""
    return _load() is not None


def avx512_built() -> bool:
    """Whether the library was compiled with the AVX-512 FIR kernels (the
    CPU has AVX-512F); False also where the fast chain is off."""
    lib = _load()
    return bool(lib is not None and lib.fsdr_fastchain_avx512())


def shed_metrics_bridge(kernel) -> None:
    """Restore a kernel's pre-fusion ``extra_metrics`` if a fused run's bridge
    is installed. The supervisor calls this for every ACTOR-path block at
    launch: a kernel that fused in a previous flowgraph must shed the stale
    bridge, or every metrics() read would stomp the live port counters with
    the old fused run's frozen values. Owns the ``_fc_base_extra`` stash
    convention together with ``_bridge`` below — keep install and uninstall
    in this module."""
    if not hasattr(kernel, "_fc_base_extra"):
        return
    base = kernel._fc_base_extra
    if base is None:
        try:
            del kernel.extra_metrics
        except AttributeError:
            pass
    else:
        kernel.extra_metrics = base
    del kernel._fc_base_extra


def _native_stage(kernel) -> Optional[tuple]:
    """(kind, p0, p1, f0, data|None) for natively runnable kernels; None
    otherwise.

    Central registry rather than per-class methods: the chain driver owns the
    exact semantics it re-implements, so a behavioral change to one of these
    blocks must be mirrored HERE or the kernel dropped from the registry."""
    import math

    import numpy as np

    from ..blocks.dsp import Agc, Fir, QuadratureDemod, SignalSource, \
        XlatingFir
    from ..blocks.io import FileSink, FileSource
    from ..blocks.stream import Copy, Delay, Head, StreamDuplicator, Throttle
    from ..blocks.vector import CopyRand, NullSink, NullSource, VectorSink, \
        VectorSource
    from ..dsp.kernels import DecimatingFirFilter, FirFilter, \
        PolyphaseResamplingFir

    if type(kernel) is NullSource:
        return (FC_NULL_SOURCE, 0, 0, 0.0, None)
    if type(kernel) is Head:
        return (FC_HEAD, int(kernel.remaining), 0, 0.0, None)
    if type(kernel) is Copy:
        return (FC_COPY, 0, 0, 0.0, None)
    if type(kernel) is StreamDuplicator:
        # N output ports all carrying every input item = exactly one
        # broadcast ring with the union of the ports' consumers; the actor
        # block's lockstep forward (min over outputs) is the ring's
        # min_tail. The finder special-cases its multi-port shape.
        return (FC_COPY, 0, 0, 0.0, None)
    if type(kernel) is CopyRand:
        if int(kernel.max_copy) < 1:
            return None                # let the actor path raise its ValueError
        return (FC_COPY_RAND, int(kernel.max_copy), int(kernel._seed), 0.0,
                None)
    if type(kernel) is NullSink:
        return (FC_NULL_SINK,
                -1 if kernel.count is None else int(kernel.count), 0, 0.0,
                None)
    if type(kernel) is VectorSource:
        period = len(kernel.items)
        if period == 0 or int(kernel.repeat) < 0 or kernel._pos or kernel._round:
            return None                # degenerate/pre-consumed: actor path
        if period * int(kernel.repeat) >= 2 ** 62:
            return None                # int64 budget overflow: actor path
        # data materialized ONCE in run_chain_task — this predicate runs
        # several times per launch and must not copy the vector
        return (FC_VEC_SOURCE, period * int(kernel.repeat), period, 0.0, None)
    if type(kernel) is VectorSink:
        if kernel._chunks:
            return None                # already holds data: actor path
        return (FC_VEC_SINK, -1, 0, 0.0, None)  # capacity bound resolved per chain
    if type(kernel) is FileSink:
        # bounded chains only (same rule as VectorSink): the native sink
        # collects into RAM and the final sync writes the file in one shot —
        # a mid-run Terminate still flushes what was consumed, but an
        # UNBOUNDED fused sink would buffer forever, so those stay streaming
        # on the actor path
        if kernel._f is not None or kernel.n_written:
            return None                # already open/written: actor path
        return (FC_VEC_SINK, -1, 0, 0.0, None)
    if type(kernel) is FileSource:
        # replayed as a cyclic vector source over a one-shot RAM snapshot of
        # the file (np.fromfile at build — NOT a memmap: a file truncated
        # mid-run would SIGBUS the process through a map, where the actor
        # path ends the stream gracefully). Semantics otherwise match
        # the actor path: floor-division drops a trailing partial item,
        # repeat loops the whole file, and a missing/empty/oversized file
        # stays on the actor path. p0/p1 here are PROVISIONAL — _build_stages
        # re-derives them from the bytes actually snapshotted, so a file that
        # grows between launch and build cannot desynchronize the sink bound.
        if kernel._f is not None or kernel.output.dtype is None:
            return None                # already open / untyped: actor path
        try:
            size = os.path.getsize(kernel.path)
        except OSError:
            return None
        if size > (256 << 20):
            return None                # RAM snapshot too big: actor streams it
        period = size // kernel.output.dtype.itemsize
        if period == 0:
            return None
        return (FC_VEC_SOURCE, -1 if kernel.repeat else period, period, 0.0,
                None)
    if type(kernel) is Fir:
        core = kernel.core
        if isinstance(core, DecimatingFirFilter):
            if core.fir._hist is not None or core._phase != 0:
                return None            # mid-stream state: actor path
            taps, decim = core.fir.taps, int(core.decim)
        elif isinstance(core, FirFilter):
            if core._hist is not None:
                return None
            taps, decim = core.taps, 1
        elif isinstance(core, PolyphaseResamplingFir):
            if core._hist is not None or core._m or core._consumed:
                return None            # mid-stream state: actor path
            if core.poly.dtype != np.float32 or \
                    kernel.input.dtype not in (np.float32, np.complex64):
                return None
            # one input's output burst must fit the out ring with headroom,
            # or the C driver's space-limited consume gets stuck at k=0
            # forever
            if _resample_m_hi(1, int(core.interp), int(core.decim)) \
                    > RING_ITEMS // 2:
                return None
            return (FC_RESAMPLE, int(core.K),
                    int(core.interp) | (int(core.decim) << 32), 0.0,
                    core.poly)         # [interp, K] row-major f32
        else:
            return None
        port_dt = kernel.input.dtype
        if port_dt == np.float32 and taps.dtype == np.float32:
            kind = FC_FIR_FF
        elif port_dt == np.complex64 and taps.dtype == np.float32:
            kind = FC_FIR_CF
        elif port_dt == np.complex64 and taps.dtype == np.complex64:
            kind = FC_FIR_CC
        else:
            return None                # f64 taps compute in f64 on the actor
        if not (1 <= len(taps) <= 1 << 14):
            return None
        # linear-phase (palindromic, even-length) f32 taps take the folded
        # kernel: half the multiplies, and the fold's ADDs issue beside the
        # FMAs — bit 32 of p1 flags it (low word stays the decimation)
        sym = (kind in (FC_FIR_FF, FC_FIR_CF) and len(taps) % 2 == 0
               and np.array_equal(taps, taps[::-1]))
        return (kind, len(taps), decim | (int(sym) << 32), 0.0, taps)
    if type(kernel) is QuadratureDemod:
        if complex(kernel._last) != 1.0:
            return None                # mid-stream carry: actor path
        return (FC_QUAD_DEMOD, 0, 0, float(kernel.gain), None)
    if type(kernel) is XlatingFir:
        # A fused chain is STATIC: the xlating block's live `freq` handler
        # could not retune it (the chain watcher answers Callbacks with
        # invalid_value), so a block with runtime handlers only fuses when the
        # user explicitly promises not to use them (silently ignoring
        # handle.call(freq) would be a behavioral regression, not a fast path)
        if not getattr(kernel, "fastchain_static", False):
            return None
        fir = kernel.fir               # always a DecimatingFirFilter
        if fir.fir._hist is not None or fir._phase != 0 \
                or kernel.rotator._phase != 0.0:
            return None                # mid-stream state: actor path
        taps = fir.fir.taps
        if taps.dtype != np.float32 or kernel.input.dtype != np.complex64 \
                or not (1 <= len(taps) <= 1 << 14):
            return None
        sym = len(taps) % 2 == 0 and np.array_equal(taps, taps[::-1])
        return (FC_XLATING, len(taps),
                int(fir.decim) | (int(sym) << 32),
                float(kernel.rotator.phase_inc), taps)
    if type(kernel) is Delay:
        # static opt-in: Delay has a live new_value handler a fused chain
        # cannot service (the same rule as every handler-bearing block)
        if not getattr(kernel, "fastchain_static", False):
            return None
        return (FC_DELAY, int(kernel._pad), int(kernel._skip), 0.0, None)
    if type(kernel) is Throttle:
        # static opt-in: Throttle has a live rate retune handler a fused
        # chain cannot service; the native stage reproduces the actor's
        # budget math (elapsed*rate - sent) against the monotonic clock
        if not getattr(kernel, "fastchain_static", False):
            return None
        if kernel._t0 is not None or not (kernel.rate > 0) \
                or not math.isfinite(kernel.rate):
            # mid-stream anchor / degenerate rate (inf·elapsed → NaN budget:
            # the actor path raises on it; the fused loop must not hang)
            return None
        return (FC_THROTTLE, 0, 0, float(kernel.rate), None)
    if type(kernel) is SignalSource:
        # same static opt-in rule: SignalSource has live freq/amplitude
        # handlers a fused chain cannot service. Only the fxpt NCO fuses —
        # its wrapping-u32 phase schedule is integer, so the native ramp is
        # BIT-exact vs the Python block (the float-accumulator variant would
        # drift differently and stays on the actor path).
        if not getattr(kernel, "fastchain_static", False):
            return None
        if kernel.nco != "fxpt":
            return None
        wf = {"sin": 0, "cos": 1, "complex": 2, "square": 3}[kernel.waveform]
        dt = kernel.output.dtype
        if dt not in (np.float32, np.complex64) or \
                (wf == 2) != (dt == np.complex64):
            return None
        params = np.array([kernel.amplitude, kernel.offset], dtype=np.float64)
        packed = (int(kernel._inc_i) & 0xFFFFFFFF) \
            | ((int(kernel._phase_i) & 0xFFFFFFFF) << 32)
        # two's-complement wrap: a start phase with the high bit set would
        # overflow ctypes' c_int64 otherwise; C recovers the words
        # with unsigned casts either way
        if packed >= 1 << 63:
            packed -= 1 << 64
        return (FC_SIG, wf, packed, 0.0, params)
    if type(kernel) is Agc:
        # same static opt-in as XlatingFir: Agc has live gain_lock /
        # reference_power handlers a fused chain cannot service
        if not getattr(kernel, "fastchain_static", False):
            return None
        if kernel.mode != "sample" or kernel.locked:
            return None                # block mode / locked: actor path
        dt = kernel.input.dtype
        if dt not in (np.float32, np.complex64):
            return None
        # params block [reference, rate, max_gain, gain]: the C stage reads
        # it AND writes the live gain back into slot 3 (post-run write-back
        # of kernel.gain, live visibility meanwhile)
        params = np.array([kernel.reference, kernel.rate, kernel.max_gain,
                           kernel.gain], dtype=np.float64)
        return (FC_AGC, int(dt == np.complex64), 0, 0.0, params)
    return None


def _sink_bound_specs(specs) -> Optional[int]:
    """Exact item count a chain's sink receives (None = unbounded): walk the
    stage specs in order, capping at every finite source/Head/sink budget and
    applying each stage's rate transform (Copy/CopyRand/plain-FIR/demod are
    count-preserving; a decimating FIR with fresh phase yields ceil(n/decim),
    chunk-invariantly — `dsp/kernels.py:70-81`)."""
    bound = None
    for spec in specs:
        if spec is None:
            return None
        kind, p0, p1 = spec[0], spec[1], spec[2]
        if kind == FC_VEC_SOURCE:
            bound = None if p0 < 0 else p0   # p0 < 0 = infinite cyclic
        elif kind == FC_HEAD:
            bound = p0 if bound is None else min(bound, p0)
        elif kind == FC_NULL_SINK and p0 >= 0:
            bound = p0 if bound is None else min(bound, p0)
        elif kind in _FIR_KINDS and bound is not None:
            decim = p1 & 0xFFFFFFFF          # high bits carry the sym flag
            if decim > 1:
                bound = -(-bound // decim)
        elif kind == FC_RESAMPLE and bound is not None:
            bound = _resample_m_hi(bound, p1 & 0xFFFFFFFF, p1 >> 32)
        elif kind == FC_DELAY and bound is not None:
            bound = p0 + max(0, bound - p1)   # pad + post-skip passthrough
    return bound


class NativeTree(list):
    """Fusable kernels in topological order. ``in_ring[i]`` is the index of
    the member whose output ring member i consumes (-1 = the tree's single
    source). A ring consumed by several members BROADCASTS: every consumer
    sees every item with its own read index — the same semantics the actor
    runtime gives one output port wired to several edges
    (`runtime/buffer/circular.py:108`, 1 writer → N readers). A plain linear
    chain is the degenerate tree ``in_ring = [-1, 0, 1, ...]``."""

    def __init__(self, members, in_ring):
        super().__init__(members)
        self.in_ring = list(in_ring)


def _tree_path(in_ring, i) -> List[int]:
    """Stage indices from the source down to (and including) stage i."""
    path = []
    while i >= 0:
        path.append(i)
        i = in_ring[i]
    return path[::-1]


def find_native_chains(fg) -> List[NativeTree]:
    """Maximal source-rooted TREES of native-capable kernels in ``fg``.

    A member must: be native-capable, touch no message or inplace edges, have
    every stream port wired (an output port wired to several edges becomes a
    broadcast ring), and every leaf must be a no-output sink — so no tags can
    enter the tree and no Python block shares its buffers. Returns a
    ``NativeTree`` per fusable source (linear chains included). The library
    is built, or raises, only where a tree is found: a flowgraph with nothing
    to fuse never needs the host compiler."""
    if _opted_out():
        return []
    # fault-tolerance degrade: the C++ chain can neither
    # restart/isolate one member nor hit the per-block work injection site —
    # a process-default restart/isolate policy or an armed work-fault
    # campaign keeps every block on the Python actor path
    from .block import fusion_degraded
    if fusion_degraded(("work",)):
        return []
    msg_touched = {id(e.src) for e in fg.message_edges} | \
                  {id(e.dst) for e in fg.message_edges}
    inp_touched = {id(e.src) for e in fg.inplace_edges} | \
                  {id(e.dst) for e in fg.inplace_edges}
    out_edges: dict = {}
    in_deg: dict = {}
    for e in fg.stream_edges:
        out_edges.setdefault(id(e.src), []).append(e)
        in_deg[id(e.dst)] = in_deg.get(id(e.dst), 0) + 1

    # one spec per kernel per launch: eligible(), _tree_dtypes and the
    # per-sink bound walks would otherwise rebuild specs O(sinks × depth)
    # times (FIR specs scan their whole tap vector for symmetry)
    spec_memo: dict = {}

    def spec_of(k):
        if id(k) not in spec_memo:
            spec_memo[id(k)] = _native_stage(k)
        return spec_memo[id(k)]

    from ..blocks.stream import StreamDuplicator

    from .block import policy_allows_fusion

    def eligible(k) -> bool:
        if not policy_allows_fusion(k):
            return False      # restart/isolate needs per-block actor supervision
        if type(k) is StreamDuplicator:
            # EVERY output port must be wired, or the fused path would
            # silently run a graph the actor path rejects (an unwired port's
            # work() raises there) — the substitution must stay invisible
            wired = {e.src_port for e in out_edges.get(id(k), [])}
            if wired != {p.name for p in k.stream_outputs}:
                return False
        elif len(k.stream_outputs) > 1:
            return False
        return (spec_of(k) is not None
                and id(k) not in msg_touched and id(k) not in inp_touched
                and len(k.stream_inputs) <= 1
                and (not k.stream_outputs
                     or len(out_edges.get(id(k), [])) >= 1)
                and in_deg.get(id(k), 0) == len(k.stream_inputs))

    from ..blocks.io import FileSink
    from ..blocks.vector import VectorSink

    trees = []
    for k in (b.kernel for b in fg._blocks if b is not None):
        if not (eligible(k) and not k.stream_inputs and k.stream_outputs):
            continue                                   # tree roots: sources
        members, inr, ok = [k], [-1], True
        seen = {id(k)}
        frontier = [(k, 0)]
        while frontier and ok:
            cur, ci = frontier.pop()
            for e in out_edges.get(id(cur), []):
                nxt = e.dst
                if id(nxt) in seen or not eligible(nxt):
                    ok = False         # a leaf that is not a fusable sink, a
                    break              # merge, or a cycle: the tree cannot fuse
                seen.add(id(nxt))
                members.append(nxt)
                inr.append(ci)
                if nxt.stream_outputs:
                    frontier.append((nxt, len(members) - 1))
        if not ok or len(members) < 2:
            continue
        dts = _tree_dtypes(members, inr, spec_of)
        if dts is None:
            continue                   # an edge's item width is unresolvable
        ok = True
        for i, m in enumerate(members):
            if m.stream_outputs or type(m) not in (VectorSink, FileSink):
                continue
            bound = _sink_bound_specs(
                [spec_of(members[j]) for j in _tree_path(inr, i)])
            if bound is None:
                ok = False             # unbounded into a collecting sink
                break
            if type(m) is FileSink and \
                    bound * dts[i].itemsize > (256 << 20):
                # the fused sink buffers the WHOLE bounded output in RAM
                # before the one-shot flush; large bounded files stream
                # O(ring) on the actor path instead (same 256 MB gate as
                # the FileSource snapshot)
                ok = False
                break
        if ok:
            trees.append(NativeTree(members, inr))
    if trees:
        _load()            # raises with the compiler's output: no silent fallback
    return trees


def _tree_dtypes(members, in_ring, spec_of=_native_stage) -> Optional[list]:
    """Per-stage OUT dtype (sinks: their input dtype). None if unresolvable.

    A producer's dtype comes from its output port or, if untyped, its
    consumers' input ports — every consumer of a broadcast ring must agree
    (the C ring has ONE item width). Width conservation through
    width-preserving stages is enforced per consumer edge: an UNTYPED
    pass-through (Copy(None)) between a c64 edge and an f32 edge would
    otherwise fuse and make the C driver memcpy 8-byte items into a 4-byte
    ring (a heap overflow). Only stages whose kind
    legitimately changes the item width (quad demod) may differ."""
    n = len(members)
    cons: List[List[int]] = [[] for _ in range(n)]
    for i in range(1, n):
        cons[in_ring[i]].append(i)
    dts: list = [None] * n
    for i, k in enumerate(members):
        if not k.stream_outputs:
            continue
        dt = k.stream_outputs[0].dtype
        for j in cons[i]:
            dst_dt = members[j].stream_inputs[0].dtype
            if dst_dt is None:
                continue
            if dt is None:
                dt = dst_dt
            elif dst_dt != dt:
                return None
        if dt is None:
            return None
        dts[i] = dt
    for i in range(1, n):
        if not members[i].stream_outputs:
            dts[i] = dts[in_ring[i]]
    for i in range(1, n):
        if not members[i].stream_outputs:
            continue
        spec = spec_of(members[i])
        if spec is not None and spec[0] != FC_QUAD_DEMOD \
                and dts[in_ring[i]].itemsize != dts[i].itemsize:
            return None
    return dts


async def run_chain_task(members: Sequence, fg_inbox, scheduler,
                         in_ring: Optional[Sequence[int]] = None) -> None:
    """Impersonate ``members`` (WrappedKernels) at the supervisor protocol level
    while the native driver runs the chain: answer the init barrier per member,
    watch for Terminate, then report per-member BlockDone with counters.

    ``in_ring`` is the tree topology from ``NativeTree`` (None = linear chain)."""
    inr = (list(in_ring) if in_ring is not None
           else [-1] + list(range(len(members) - 1)))
    from .runtime import BlockDoneMsg, BlockErrorMsg, InitializedMsg
    from ..types import Pmt

    def _finish_all():
        for b in members:
            fg_inbox.send(BlockDoneMsg(b.id, b))

    async def _next_msg(inbox):
        """Next inbox message, parking on the coalescing notifier. Returns None
        on a bare notify (the supervisor's start signal is a notify with no
        message)."""
        msg = inbox.try_recv()
        if msg is not None:
            return msg
        await inbox.wait()
        inbox.take_pending()
        return inbox.try_recv()

    # ---- init barrier for every member --------------------------------------
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
        fg_inbox.send(InitializedMsg(b.id))

    # ---- start signal ---------------------------------------------------------
    # Do NOT run (or send BlockDone) before the supervisor releases the barrier:
    # each block must emit exactly one of Initialized/BlockError/BlockDone
    # before the start notify, or a fast chain's BlockDones double-decrement the
    # barrier counter and init failures elsewhere stop propagating from start()
    # (`runtime.rs:380-429` contract; actor blocks park the same way).
    while True:
        msg = await _next_msg(members[0].inbox)
        if isinstance(msg, Terminate):
            _finish_all()
            return
        if isinstance(msg, Callback):
            msg.reply.set(Pmt.invalid_value())
        if msg is None:
            break                       # bare notify = the start signal

    import numpy as np

    def _build_stages():
        """Everything that can raise (allocation, int64 bounds) — called inside
        the guarded region below so a failure becomes BlockError, not a
        silently dead task and a hung supervisor."""
        lib = _load()
        n = len(members)
        kernels = [b.kernel for b in members]
        # per-stage OUT dtypes (find_native_chains guarantees resolvability):
        # dts[i] sizes stage i's output ring (sinks: their input = the sink
        # buffer) — deriving them separately corrupted memory when the sink
        # port was untyped
        dts = _tree_dtypes(kernels, inr)
        stages = (_FcStage * n)()
        keepalive = []                 # numpy buffers the C side points into
        sink_bufs = {}                 # sink stage idx → collect buffer
        agc_params = {}                # member idx → live params block
        from ..blocks.io import FileSink, FileSource
        # ONE _native_stage pass; FileSource budgets are then corrected from
        # the bytes actually snapshotted, and the sink bound derives from the
        # SAME corrected specs — a file growing between launch and build can
        # no longer desynchronize the VectorSink capacity from the source
        # budget
        specs = [list(_native_stage(b.kernel)) for b in members]
        datas: list = [spec[4] for spec in specs]
        for i, b in enumerate(members):
            kind = specs[i][0]
            if kind == FC_VEC_SOURCE:
                if type(b.kernel) is FileSource:
                    # one-shot RAM snapshot (NOT a memmap: truncation mid-run
                    # would SIGBUS through a map; the ≤256 MB gate is in the
                    # registry)
                    snap = np.fromfile(b.kernel.path, dtype=dts[0])
                    if len(snap) == 0:
                        raise ValueError(
                            f"{b.kernel.path} emptied between launch and build")
                    specs[i][2] = len(snap)
                    specs[i][1] = -1 if b.kernel.repeat else len(snap)
                    datas[i] = snap
                else:
                    datas[i] = np.ascontiguousarray(b.kernel.items)
            elif kind in _FIR_KINDS or kind == FC_RESAMPLE:
                datas[i] = np.ascontiguousarray(datas[i])  # taps / poly
                # (the resampler's poly is a .T view — never hand C a stride)
            elif kind == FC_AGC:
                agc_params[i] = datas[i]  # C writes the live gain into slot 3
        # per-sink bounds over each sink's own source→sink path (a tree can
        # hold several collecting sinks)
        bounds = {i: _sink_bound_specs([specs[j] for j in _tree_path(inr, i)])
                  for i in range(n) if specs[i][0] == FC_VEC_SINK}
        for i, b in enumerate(members):
            if specs[i][0] == FC_VEC_SINK and type(b.kernel) is FileSink:
                # actor-init parity: FileSink.init opens "wb" (creates/
                # truncates the file even if the run later terminates early)
                # — and doing it HERE, inside the guarded build, surfaces an
                # unwritable path as BlockError exactly like the actor path's
                # init failure
                open(b.kernel.path, "wb").close()
        for i, b in enumerate(members):
            kind, p0, p1, f0, _ = specs[i]
            data = datas[i]
            if kind == FC_VEC_SINK:
                buf = np.empty(int(bounds[i]), dtype=dts[i])
                sink_bufs[i] = buf
                data, p0 = buf, int(bounds[i])
            ptr = None
            if data is not None:
                keepalive.append(data)
                ptr = data.ctypes.data_as(ctypes.c_void_p)
            isz = int(dts[i].itemsize)
            stages[i] = _FcStage(kind, isz, p0, p1, f0, ptr)
        return lib, stages, keepalive, sink_bufs, agc_params

    try:
        lib, stages, keepalive, sink_bufs, agc_params = _build_stages()
    except Exception as e:                              # noqa: BLE001
        log.error("fastchain stage build failed (%r)", e)
        fg_inbox.send(BlockErrorMsg(members[0].id, e))
        for b in members[1:]:
            fg_inbox.send(BlockDoneMsg(b.id, b))
        return
    n = len(members)
    per_in = (ctypes.c_int64 * n)()
    per_out = (ctypes.c_int64 * n)()
    per_calls = (ctypes.c_int64 * n)()
    per_ns = (ctypes.c_int64 * n)()
    stop = ctypes.c_int32(0)

    # live metrics bridge: the native driver updates the shared counter arrays
    # DURING the run, so /metrics/ and handle.metrics() observe a fused chain
    # in flight exactly like actor-run blocks (work_calls = chunks moved);
    # consumed/produced are tracked separately so rate-changing stages
    # (decimating FIR) report honest per-port counts
    def _bridge(i, b):
        k = b.kernel
        # stash the PRE-FUSION extra_metrics exactly once: re-running the
        # same flowgraph re-bridges, and chaining off the previous bridge
        # would re-apply the prior run's counters after refresh() (stale
        # values win) while pinning every prior run's ctypes arrays alive
        if not hasattr(k, "_fc_base_extra"):
            k._fc_base_extra = getattr(k, "extra_metrics", None)
        base_extra = k._fc_base_extra

        def refresh():
            b.work_calls = int(per_calls[i])
            for p in k.stream_outputs:
                p.items_produced = int(per_out[i])
            for p in k.stream_inputs:
                p.items_consumed = int(per_in[i])
            if hasattr(k, "n_received") and k.stream_inputs:
                k.n_received = int(per_in[i])       # NullSink contract
        k.extra_metrics = lambda: (refresh() or dict(
            (base_extra() if callable(base_extra) else {}), fused_native=True,
            busy_ns=int(per_ns[i])))
        return refresh

    refreshers = [_bridge(i, b) for i, b in enumerate(members)]

    # Inbox watchers, one per member: Terminate (broadcast to every member)
    # sets the native stop flag; Callbacks to ANY fused member are answered
    # with invalid_value instead of hanging the caller (fused blocks have no
    # handlers — the same answer an actor block gives for an unknown port).
    async def watch(b):
        while True:
            msg = await _next_msg(b.inbox)
            if isinstance(msg, Terminate):
                stop.value = 1
                return
            if isinstance(msg, Callback):
                msg.reply.set(Pmt.invalid_value())

    watchers = [asyncio.ensure_future(watch(b)) for b in members]

    def _cancel_watchers():
        for w in watchers:
            w.cancel()

    try:
        inr_arr = (ctypes.c_int32 * n)(*inr)
        t_chain = _trace.now()
        rc = await scheduler.spawn_blocking(
            lambda: lib.fsdr_fastchain_run_v3(stages, n, inr_arr, RING_ITEMS,
                                              ctypes.byref(stop), per_in,
                                              per_out, per_calls, per_ns))
    except Exception as e:                              # noqa: BLE001
        _cancel_watchers()
        log.error("fastchain failed (%r)", e)
        fg_inbox.send(BlockErrorMsg(members[0].id, e))
        for b in members[1:]:
            fg_inbox.send(BlockDoneMsg(b.id, b))
        return
    _cancel_watchers()
    # one span for the whole native run; per-member chunk/busy counters ride in
    # args (the same numbers the extra_metrics bridge above serves live), so a
    # trace shows WHERE a fused chain's time went without per-chunk callbacks
    # crossing the C++ boundary
    _trace.complete(
        "fastchain", f"chain[{members[0].instance_name}…x{n}]", t_chain,
        args={"members": n,
              "chunks": {b.instance_name: int(per_calls[i])
                         for i, b in enumerate(members)},
              "busy_ns": {b.instance_name: int(per_ns[i])
                          for i, b in enumerate(members)}})
    if rc < 0:
        e = RuntimeError(f"fastchain returned {rc} (malformed chain)")
        fg_inbox.send(BlockErrorMsg(members[0].id, e))
        for b in members[1:]:
            fg_inbox.send(BlockDoneMsg(b.id, b))
        return

    # ---- final counter sync (the live bridge stays installed) ----------------
    for r in refreshers:
        r()
    # kernel-state write-back: post-run attribute reads (Head.remaining,
    # VectorSource position) match what the actor path would have left behind
    from ..blocks.stream import Head
    from ..blocks.vector import VectorSource
    for i, b in enumerate(members):
        k = b.kernel
        if type(k) is Head:
            k.remaining = max(0, int(k.remaining) - int(per_out[i]))
        elif type(k) is VectorSource and len(k.items):
            k._round, k._pos = divmod(int(per_out[i]), len(k.items))
        elif i in agc_params:
            k.gain = float(agc_params[i][3])   # final feedback state
        elif stages[i].kind == FC_SIG:
            from ..dsp import fxpt
            # same wrap-advance the actor work() applies per chunk
            k._phase_i = fxpt.advance_u32(k._phase_i, k._inc_i,
                                          int(per_out[i]))
    flush_errors = {}                  # sink stage idx → OSError
    for si, buf in sink_bufs.items():
        from ..blocks.io import FileSink
        sk = members[si].kernel
        got = buf[:int(per_in[si])]
        if type(sk) is FileSink:
            try:
                # one-shot flush of the collected items — same bytes the
                # actor path would have streamed out incrementally
                got.tofile(sk.path)
                sk.n_written = int(per_in[si])
            except OSError as e:       # disk full / path vanished mid-run:
                # surface like an actor write failure — but keep flushing the
                # OTHER sinks of the tree first (each streams independently
                # on the actor path; one full disk must not drop its
                # siblings' data), and never hang the supervisor by dying
                # before the done/error messages
                flush_errors[si] = e
        else:
            sk._chunks = [got]
    if flush_errors:
        for si, e in flush_errors.items():
            fg_inbox.send(BlockErrorMsg(members[si].id, e))
        for i, b in enumerate(members):
            if i not in flush_errors:
                fg_inbox.send(BlockDoneMsg(b.id, b))
        return
    del keepalive
    _finish_all()
