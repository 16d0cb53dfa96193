"""Streaming stages on PyTorch tensors: the port's unit of composition.

The counterpart of ``futuresdr_tpu/ops/stages.py``. A :class:`Stage` is a
function ``(carry, frame) -> (carry, out)`` on tensors; streaming state
(filter history, carried taps) is the explicit carry, a tuple of tensors on
the stage's device, so frame t+1 chains on frame t's carry with no host sync.
A :class:`Pipeline` runs a chain of stages per frame: :meth:`Pipeline.fn`
is the eager per-frame function, :meth:`Pipeline.compile` the program a
streamed dispatch replays (one CUDA graph for ``k`` chained frames on a card,
:class:`CompiledPipeline`; the eager chain on the CPU). The graph shapes,
:class:`FanoutPipeline` (a producer chain broadcast into branch chains) and
:class:`DagPipeline` (nodes in topological order, fan-in through a
:class:`MergeStage`), present the same surface with one output a branch or
sink and compile the same way, into one graph with one static output buffer
a sink.

Carry trees have the same leaves, shapes and dtypes as the JAX stages on the
CPU, so a carry converts across (``convert.carry_from_numpy``).

Each kernel-backed stage offers the interior-precision hook ``lower`` (the
planner in ``ops/precision.py``): ``bf16`` everywhere, and the ``int8`` rung
of the FIR family (:func:`fir_stage`'s banded int8 matmul, the polyphase
decimator's int8 shifted matvec), real taps only.

Ported so far: the north-star spectrum chain, :func:`fir_stage`
(overlap-save and ``impl="pallas"``, the hand-written ``fir`` kernel),
:func:`fft_stage`, :func:`mag2_stage` and :func:`fir_fft_stage` (the fused
``fir_fft`` kernel); and the FM front end, the polyphase decimating
:func:`fir_stage` routes (``impl="pallas"`` on the ``poly_fir`` kernel),
:func:`resample_stage`, :func:`rotator_stage` (``rotator`` kernel),
:func:`quad_demod_stage` (``quad_demod`` kernel), :func:`xlating_fir_stage`
and :func:`decimate_stage`; and the PFB channelizer,
:func:`channelizer_stage` (``impl="pallas"``, the hand-written ``pfb``
kernel), with the other single-chain stages: :func:`fftshift_stage`,
:func:`log10_stage`, :func:`apply_stage`, :func:`moving_avg_stage`,
:func:`agc_stage` and :func:`lora_demod_stage`.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from dataclasses import dataclass
from fractions import Fraction
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..telemetry import profile as _profile
from . import cuda_kernels
from .xfer import torch_dtype

__all__ = ["Stage", "Pipeline", "CompiledPipeline", "EagerProgram", "MergeStage",
           "FanoutPipeline", "DagPipeline", "apply_merge_stage", "add_merge_stage",
           "interleave_merge_stage", "concat_merge_stage", "fir_stage",
           "fft_stage", "mag2_stage", "fir_fft_stage", "resample_stage", "rotator_stage",
           "quad_demod_stage", "xlating_fir_stage", "decimate_stage", "fftshift_stage", "log10_stage",
           "apply_stage", "channelizer_stage", "lora_demod_stage", "agc_stage",
           "moving_avg_stage"]

@dataclass
class Stage:
    """One streaming stage.

    ``fn(carry, x) -> (carry, y)``: for an input frame of n items it returns
    ``n * ratio`` items. ``init_carry(dtype, device)`` builds the carry for a
    stream of numpy ``dtype`` on ``device``.
    """

    fn: Callable[[Any, torch.Tensor], Tuple[Any, torch.Tensor]]
    init_carry: Callable[[np.dtype, torch.device], Any]
    ratio: Fraction = Fraction(1, 1)
    out_dtype: Optional[np.dtype] = None          # None = same as input
    frame_multiple: int = 1                       # input frame must divide this
    name: str = "stage"
    lti: Optional[Tuple[np.ndarray, int, int, str]] = None  # (taps, decim, fft_len, impl)
    update: Optional[Callable[..., Any]] = None   # host-side ``(carry, **params) -> carry``
    lower: Optional[Callable[[str], Optional["Stage"]]] = None
    #   interior-precision hook (ops/precision.py): this stage rebuilt at the
    #   given precision ("bf16"; "int8" where the stage declares it), or None
    compute_dtype: str = "f32"                    # "f32" | "bf16" | "int8": the
    #   dominant accumulation type (utils/roofline.py keys the peak on it)
    cost: Optional[Callable[[int, np.dtype], Tuple[float, float]]] = None
    #   (n input items, input dtype) -> (bytes, operations): the least the
    #   stage must move and compute (utils/roofline.py); None = in + out bytes
    route: Optional[Tuple[Optional[str], Optional[str], Optional[str]]] = None
    #   (impl, fft_impl, precision) pins; LTI merging keeps them only when both agree
    history: int = 0
    #   > 0: the carry's last leaf is the stream's last ``history`` input
    #   samples and its other leaves are parameters a frame leaves alone (an
    #   input-history window: the FIR, fir_fft, the PFB); shard/model.py
    #   gives such a stage the previous span's tail as its carry

    def __repr__(self):
        return f"Stage({self.name}, ratio={self.ratio})"


@dataclass
class MergeStage:
    """A fan-in stage: ``fn(carry, xs) -> (carry, y)`` joins a ``k``-tuple
    of frames into one, the merge node of a :class:`DagPipeline` and of
    ``tpu/frames.TpuMergeStage``. ``mode="equal"``: every input arrives at
    the same path rate, and n items an input give ``n * ratio`` items;
    ``mode="concat"``: the rates may differ, and the output is ``sum(n_i) *
    ratio`` items. Stream tags crossing a merge ride input 0 (the primary
    input). ``frame_multiple`` is each input's requirement."""

    fn: Callable[[Any, Tuple[torch.Tensor, ...]], Tuple[Any, torch.Tensor]]
    init_carry: Callable[[np.dtype, torch.device], Any]
    k: int
    mode: str = "equal"                           # "equal" | "concat"
    ratio: Fraction = Fraction(1, 1)
    out_dtype: Optional[np.dtype] = None          # None = same as input
    frame_multiple: int = 1                       # per-input requirement
    name: str = "merge"
    update: Optional[Callable[..., Any]] = None

    def __post_init__(self):
        if self.mode not in ("equal", "concat"):
            raise ValueError(f"merge mode must be equal or concat, got {self.mode!r}")
        if self.k < 2:
            raise ValueError("a merge needs >= 2 inputs")

    def __repr__(self):
        return f"MergeStage({self.name}, k={self.k}, mode={self.mode})"


def apply_merge_stage(f: Callable[..., torch.Tensor], k: int, out_dtype=None,
                      name: str = "merge") -> MergeStage:
    """Elementwise k-way join ``y = f(x_0, …, x_{k-1})`` over equal-length
    inputs (``mode="equal"``, ratio 1)."""

    def fn(carry, xs):
        return carry, f(*xs)

    return MergeStage(fn, _stateless, k, "equal", Fraction(1, 1), out_dtype, 1, name)


def add_merge_stage(k: int, name: str = "add_merge") -> MergeStage:
    """Elementwise sum of k equal-rate inputs, added left to right."""

    def fn(carry, xs):
        y = xs[0]
        for x in xs[1:]:
            y = y + x
        return carry, y

    return MergeStage(fn, _stateless, k, "equal", Fraction(1, 1), None, 1, name)


def interleave_merge_stage(k: int, name: str = "interleave") -> MergeStage:
    """Item-interleave k equal-rate inputs: ``y[i·k + j] = x_j[i]``."""

    def fn(carry, xs):
        return carry, torch.stack(xs, dim=1).reshape(-1)

    return MergeStage(fn, _stateless, k, "equal", Fraction(k, 1), None, 1, name)


def concat_merge_stage(k: int, name: str = "concat_merge") -> MergeStage:
    """Frame-concatenate k inputs, whose rates may differ: ``y = x_0 ++ … ++
    x_{k-1}`` a frame."""

    def fn(carry, xs):
        return carry, torch.cat(xs)

    return MergeStage(fn, _stateless, k, "concat", Fraction(1, 1), None, 1, name)


def _stateless(dtype, device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


class Pipeline:
    """A fused chain of stages run frame by frame on one device."""

    def __init__(self, stages: Sequence[Stage], in_dtype, optimize: bool = True):
        self.in_dtype = np.dtype(in_dtype)
        self.stages = (_merge_lti(list(stages), self.in_dtype)
                       if optimize else list(stages))
        dtype = self.in_dtype
        fm = 1                      # required input-frame multiple
        r = Fraction(1, 1)          # cumulative rate in front of each stage
        for s in self.stages:
            need = Fraction(s.frame_multiple, 1) / r
            fm = int(np.lcm(fm, need.numerator))
            r *= s.ratio
            fm = int(np.lcm(fm, r.denominator))   # integral intermediate frame sizes
            if s.out_dtype is not None:
                dtype = np.dtype(s.out_dtype)
        self.frame_multiple = fm
        self.ratio = r
        self.out_dtype = dtype
        self._fn = None
        self._wired_fns: dict = {}

    def init_carry(self, device) -> tuple:
        """The initial carries of every stage, on ``device``."""
        device = torch.device(device)
        dtype = self.in_dtype
        carries = []
        for s in self.stages:
            carries.append(s.init_carry(dtype, device))
            if s.out_dtype is not None:
                dtype = np.dtype(s.out_dtype)
        return tuple(carries)

    def fn(self):
        """The per-frame function ``(carries, x) -> (carries, y)``."""
        if self._fn is None:
            stages = self.stages

            def run(carries, x):
                new_c = []
                for s, c in zip(stages, carries):
                    c, x = s.fn(c, x)
                    new_c.append(c)
                return tuple(new_c), x

            self._fn = run
        return self._fn

    def wired_fn(self, wire, k: int = 1, packed=None):
        """The chain with the wire's device decode in front and its encode
        behind: ``run(carries, *in_parts) -> (carries, out_parts)`` (a
        multi-output pipeline encodes each output and concatenates their
        parts, :meth:`FanoutPipeline.part_counts` gives the split). ``k >
        1``: every part has a leading ``[k]`` axis and the k frames run one
        after another, carry chained, each decoded and encoded with its own
        scale (the reference's ``lax.scan``). ``packed`` (an
        ``ops/xfer.PackedLayout``): ``run(carries, buf)`` on one uint8 buffer
        that :meth:`PackedLayout.unpack_torch` slices into the parts first.
        Cached per ``(wire, k, layout)``, the reference's ``wired_fn`` and
        ``packed_wired_fn``."""
        from .wire import get_wire
        wire = get_wire(wire)
        key = (wire.name, int(k), None if packed is None else packed.key)
        cache = self._wired_fns
        if key in cache:
            return cache[key]
        inner, in_dt, w = self.fn(), self.in_dtype, wire

        def run(carries, *parts):
            carries, y = inner(carries, w.decode_torch(parts, in_dt))
            if isinstance(y, tuple):
                return carries, tuple(q for yb in y for q in w.encode_torch(yb))
            return carries, w.encode_torch(y)

        if k > 1:
            one = run

            def run(carries, *parts):
                cols = None
                for i in range(k):
                    carries, ys = one(carries, *(p[i] for p in parts))
                    cols = [[y] for y in ys] if cols is None else \
                        [c + [y] for c, y in zip(cols, ys)]
                return carries, tuple(torch.stack(c) for c in cols)

        if packed is not None:
            parts_fn, lay = run, packed

            def run(carries, buf):
                return parts_fn(carries, *lay.unpack_torch(buf))

        cache[key] = run
        return run

    def compile(self, frame_size: int, device, donate: bool = True, k: int = 1,
                slots: int = 1, wire=None, packed=None, carry=None,
                program: Optional[str] = None, reason: Optional[str] = "warmup",
                profile_device: Optional[str] = None):
        """The per-dispatch program for ``frame_size``-sample frames on
        ``device``, ``k`` frames a call: returns ``(fn, carry)`` with
        ``fn(carry, x) -> (carry, y)``, ``x`` of shape ``[frame_size]`` (k =
        1) or ``[k, frame_size]``, the k frames chained through the carry,
        ``y`` of shape ``[out]`` or ``[k, out]``. The counterpart of the
        reference's ``jax.jit`` in ``compile`` and its k-frame ``lax.scan``
        in ``wired_fn(k)``.

        ``wire`` (an ``ops/wire.py`` format) compiles the wired form, the
        reference's ``compile_wired``: ``x`` is the tuple of the wire's
        parts and ``y`` the tuple of the output's encoded parts, decode and
        encode inside the program (:meth:`wired_fn`); ``packed`` (an
        ``ops/xfer.PackedLayout``) makes ``x`` one uint8 buffer of
        ``packed.nbytes``, unpacked inside the program. ``wire=None`` is the
        plain program on the stream's own dtype. ``carry``: static carry
        buffers to share with another program of this pipeline at the same
        frame and ``k`` (a program for another wire), so a switch between
        them copies no state.

        On a CUDA device ``fn`` is a :class:`CompiledPipeline`: one
        ``torch.cuda.CUDAGraph`` replay a call, its carry a set of static
        device buffers the replay updates in place (the port's donation;
        ``donate=False`` returns a copy instead), and ``slots`` input and
        output buffers, one graph each, for a streamed caller's dispatch
        groups in flight. A capture that fails raises: nothing runs eagerly
        in its place. On the CPU ``fn`` is an :class:`EagerProgram`, the
        eager chain looped over the k frames.

        The profile plane (``telemetry/profile.py``) bills the capture under
        ``program`` (default the pipeline's class name) and ``reason`` (the
        plane's vocabulary: ``warmup``, ``reinit``, ``recover``, …; on the
        CPU the eager program's construction stands in for the capture;
        ``reason=None`` leaves the first capture to a window the caller
        holds, as the streamed kernels do; ``profile_device`` registers a
        sharded program's per-device entry, ``program@dev<label>``), a
        recapture for a changed carry as ``reinit``, and registers the
        program's analytic cost (``utils/roofline.program_cost``, one unit a
        dispatch of ``k`` frames); a call ``fn(carry, x)`` bills one unit. A
        streamed caller that replays slots (``fn.dispatch``) bills its own
        dispatch groups."""
        if frame_size % self.frame_multiple:
            raise ValueError(f"frame_size {frame_size} is not a multiple of "
                             f"{self.frame_multiple}")
        device = torch.device(device)
        name = str(program or type(self).__name__)
        if device.type == "cuda":
            fn = CompiledPipeline(self, frame_size, device, k, donate, slots,
                                  wire=wire, packed=packed, carry=carry,
                                  program=name, reason=reason,
                                  profile_device=profile_device)
            return fn, fn.carry
        with _profile.compiling(name, reason, _program_sig(frame_size, wire, k)) \
                if reason is not None else contextlib.nullcontext():
            fn = EagerProgram(self, frame_size, k, slots, wire=wire, packed=packed,
                              program=name, profile_device=profile_device)
        return fn, (self.init_carry(device) if carry is None else carry)

    def out_items(self, in_items: int) -> int:
        q = Fraction(in_items) * self.ratio
        if q.denominator != 1:
            raise ValueError(f"{in_items} input items give a fractional output")
        return int(q)

    # -- carry checkpoints (the device kernels' recovery) ----------------------
    # The program is a function of (carry, frame) alone, so a snapshot of the
    # carry after group N and a replay of groups N+1… from their host staging
    # copies give the unfailed run's output bit for bit.

    def snapshot_carry(self, carry):
        """Start a host copy of ``carry``: ``(fetches, spec)``, one zero-arg
        function a leaf giving its host array, and the carry's structure with
        each leaf's shape and dtype. A card leaf is copied into pinned memory
        on the current stream, now: after the work queued so far (the replay
        that wrote it) and before any queued later, so the copy is the carry
        of this point of the stream even though a later replay overwrites
        the static buffer it was read from (``CompiledPipeline``); a fetch
        waits for its copy's event. bfloat16 leaves travel as their int16
        bits (numpy has no bfloat16)."""
        fetches = []
        for t in _leaves(carry):
            t = t.detach()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            if t.device.type == "cuda":
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(t.device))   # the leaf's card

                def fetch(host=host, done=done):
                    done.synchronize()
                    return host.numpy().copy()
            else:
                def fetch(v=t.clone().numpy()):
                    return v
            fetches.append(fetch)
        return fetches, _carry_spec(carry)

    def carry_spec(self, carry):
        """``carry``'s structure with each leaf's shape and dtype (what
        :meth:`snapshot_carry` returns beside the fetches)."""
        return _carry_spec(carry)

    def carry_matches(self, leaves, spec, template) -> bool:
        """Does a snapshot (host ``leaves`` and the ``spec`` taken with them)
        fit the live carry ``template``: the same structure, and each leaf's
        shape and dtype? The restore's integrity check, which rejects a
        corrupted candidate (the ``carry`` fault site)."""
        if spec != _carry_spec(template):
            return False
        want = _leaves(template)
        if len(leaves) != len(want):
            return False
        for a, t in zip(leaves, want):
            a = np.asarray(a)
            if a.shape != tuple(t.shape) or a.dtype != _host_dtype(t.dtype):
                return False
        return True

    def restore_carry(self, leaves, spec, device):
        """The carry of a snapshot as tensors on ``device`` (new tensors: a
        compiled program copies them into its static buffers before its next
        replay, ``CompiledPipeline._load``, with no new capture)."""
        out = []
        for a, (_shape, dt) in zip(leaves, _spec_leaves(spec)):
            t = torch.from_numpy(np.array(a, copy=True))
            if dt == str(torch.bfloat16):
                t = t.view(torch.bfloat16)
            out.append(t.to(device))
        return _from_spec(spec, iter(out))

    def update_stage(self, carries, stage, _validate_only: bool = False, **params):
        """Apply a stage's ``update`` hook to its slot in ``carries`` (by
        post-merge index or stage ``name``); returns the new carries tuple.
        Frames already computed keep the old parameters, later frames see
        the new ones. ``_validate_only`` resolves the stage and checks its
        hook without touching ``carries`` (which may be None): a caller that
        queues an update before its carry exists rejects a bad address at
        once."""
        if isinstance(stage, str):
            hits = [i for i, s in enumerate(self.stages) if s.name == stage]
            if not hits:
                raise KeyError(
                    f"no stage named {stage!r} in {[s.name for s in self.stages]}")
            if len(hits) > 1:
                raise KeyError(f"stage name {stage!r} is ambiguous (indices {hits})")
            idx = hits[0]
        else:
            idx = int(stage)
            if not 0 <= idx < len(self.stages):
                raise KeyError(f"stage index {idx} out of range "
                               f"({len(self.stages)} stages)")
        s = self.stages[idx]
        if s.update is None:
            raise ValueError(f"stage {s.name!r} has no runtime-update hook")
        if _validate_only:
            return carries
        carries = list(carries)
        carries[idx] = s.update(carries[idx], **params)
        return tuple(carries)


class FanoutPipeline:
    """``producer stages → N branch stage chains`` as one program with one
    output a branch: the producer runs once a frame and every branch reads
    its output inside the program.

    Duck-types the :class:`Pipeline` surface the device blocks read
    (``in_dtype``, ``stages``, ``frame_multiple``, ``init_carry``, ``fn``,
    ``compile``, ``update_stage``), with the single-output fields given a
    branch: ``out_dtypes[j]``, ``path_ratios[j]`` (producer·branch rate),
    :meth:`branch_out_items`. ``stages`` is the flat concatenation (producer,
    then the branches in order), which is also the carry layout, so
    ``update_stage`` addresses it as a linear pipeline's. The wired form
    (:meth:`Pipeline.wired_fn`) decodes the input once and encodes each
    branch's output; :meth:`part_counts` splits its flat part tuple. The
    reference's XLA donation mask has no counterpart (a CUDA graph's static
    carry buffers are the port's donation)."""

    def __init__(self, producer_stages: Sequence[Stage],
                 branch_stage_lists: Sequence[Sequence[Stage]], in_dtype,
                 optimize: bool = True):
        if not branch_stage_lists or len(branch_stage_lists) < 2:
            raise ValueError("FanoutPipeline needs >= 2 branches "
                             "(use Pipeline for linear chains)")
        self.in_dtype = np.dtype(in_dtype)
        # the caller's lists before any merge (a tuned pick is also recorded
        # under them, tpu/autotune.py)
        self.raw_stage_lists = (list(producer_stages), [list(b) for b in branch_stage_lists])
        self.producer = Pipeline(list(producer_stages), in_dtype, optimize=optimize)
        self.branches = [Pipeline(list(bs), self.producer.out_dtype, optimize=optimize)
                         for bs in branch_stage_lists]
        self.stages = list(self.producer.stages)
        for b in self.branches:
            self.stages.extend(b.stages)
        fm = self.producer.frame_multiple
        for b in self.branches:
            path = Pipeline(self.producer.stages + b.stages, in_dtype, optimize=False)
            fm = int(np.lcm(fm, path.frame_multiple))
        self.frame_multiple = fm
        self.path_ratios = [self.producer.ratio * b.ratio for b in self.branches]
        self.out_dtypes = [b.out_dtype for b in self.branches]
        self.n_branches = len(self.branches)
        # the linear surface: total items out an input item, branch 0's dtype
        self.ratio = sum(self.path_ratios, Fraction(0, 1))
        self.out_dtype = self.out_dtypes[0]
        self._fn = None
        self._wired_fns: dict = {}

    def branch_out_items(self, branch: int, in_items: int) -> int:
        q = Fraction(in_items) * self.path_ratios[branch]
        if q.denominator != 1:
            raise ValueError(f"{in_items} input items give a fractional output "
                             f"on branch {branch}")
        return int(q)

    def out_items(self, in_items: int) -> int:
        """Items out of every branch together for ``in_items`` inputs."""
        q = Fraction(in_items) * self.ratio
        if q.denominator != 1:
            raise ValueError(f"{in_items} input items give a fractional output")
        return int(q)

    def init_carry(self, device) -> tuple:
        """Flat carries, producer then each branch, matching ``stages``."""
        out = list(self.producer.init_carry(device))
        for b in self.branches:
            out.extend(b.init_carry(device))
        return tuple(out)

    def fn(self):
        """``run(carries, x) -> (carries, (y_0, …, y_{N-1}))``."""
        if self._fn is None:
            n_p = len(self.producer.stages)
            pfn = self.producer.fn()
            bfns = [b.fn() for b in self.branches]
            sizes = [len(b.stages) for b in self.branches]

            def run(carries, x):
                pc, mid = pfn(tuple(carries[:n_p]), x)
                new_c, outs, off = list(pc), [], n_p
                for bf, sz in zip(bfns, sizes):
                    bc, y = bf(tuple(carries[off:off + sz]), mid)
                    new_c.extend(bc)
                    outs.append(y)
                    off += sz
                return tuple(new_c), tuple(outs)

            self._fn = run
        return self._fn

    def part_counts(self, wire) -> tuple:
        """Wire parts a branch in the wired form's flat output (a quantizing
        wire ships payload and scale, f32 and bf16 one part)."""
        from .wire import get_wire
        wire = get_wire(wire)
        return tuple(wire.part_count(dt) for dt in self.out_dtypes)

    def in_part_count(self, wire) -> int:
        from .wire import get_wire
        return get_wire(wire).part_count(self.in_dtype)

    # they read only the duck-typed surface above
    compile = Pipeline.compile
    wired_fn = Pipeline.wired_fn
    update_stage = Pipeline.update_stage
    # the flat carry (producer, then branches or nodes) checkpoints as one
    snapshot_carry = Pipeline.snapshot_carry
    carry_spec = Pipeline.carry_spec
    carry_matches = Pipeline.carry_matches
    restore_carry = Pipeline.restore_carry


class DagPipeline:
    """A stage DAG as one program whose outputs are its sinks.

    ``nodes`` is a sequence of ``(stage_list, input_ids)`` in topological
    order: node 0 is the root (``input_ids == []``) and reads the program
    input; every other node lists the nodes feeding it (all of lower index).
    A node with several inputs starts with a :class:`MergeStage` of as many
    inputs; plain stages follow it. The sinks (nodes no node consumes, in
    index order) are the outputs. A node read by several nodes is computed
    once.

    Each sink ``j`` has ``path_ratios[j]`` (output items an input item; a
    ``concat`` merge sums its inputs') and ``tag_ratios[j]`` (the tag-index
    map along the primary chain: a merge adds only its own ``ratio``, since
    tags ride input 0). An ``equal`` merge whose inputs arrive at different
    rates raises ``ValueError``. ``concat_sinks[j]`` says whether sink j's
    path crosses a ``concat`` merge (a partial frame cannot be expressed as
    a valid prefix there, so such sinks emit full frames only).

    Duck-types :class:`FanoutPipeline`'s surface, ``stages`` being the flat
    node-order concatenation and the carry layout."""

    def __init__(self, nodes, in_dtype, optimize: bool = False):
        if not nodes:
            raise ValueError("DagPipeline needs at least one node")
        self.in_dtype = np.dtype(in_dtype)
        self.raw_nodes = [(list(sl), tuple(int(j) for j in inputs))
                          for sl, inputs in nodes]
        consumed: dict = {}
        for i, (_sl, inputs) in enumerate(self.raw_nodes):
            if i == 0:
                if inputs:
                    raise ValueError("node 0 is the root and takes the "
                                     "program input (input_ids must be [])")
            elif not inputs:
                raise ValueError(f"node {i} has no inputs (one root only)")
            for j in inputs:
                if not 0 <= j < i:
                    raise ValueError(f"node {i} input {j} violates topological order")
                consumed[j] = consumed.get(j, 0) + 1
        self.sinks = [i for i in range(len(self.raw_nodes)) if i not in consumed]
        self._nodes: list = []           # (stages, inputs, carry offset)
        self.stages: list = []
        fm = 1
        node_r: list = []                # per node: output rate an input item
        node_dt: list = []               # per node: output dtype
        node_tag_r: list = []            # per node: primary-chain tag map
        for i, (sl, inputs) in enumerate(self.raw_nodes):
            stages = list(sl)
            if len(inputs) > 1:
                if not stages or not isinstance(stages[0], MergeStage):
                    raise ValueError(f"node {i} joins {len(inputs)} inputs but does "
                                     f"not start with a MergeStage")
                m = stages[0]
                if m.k != len(inputs):
                    raise ValueError(f"node {i}: MergeStage k={m.k} != "
                                     f"{len(inputs)} inputs")
                in_rs = [node_r[j] for j in inputs]
                in_dts = {np.dtype(node_dt[j]) for j in inputs}
                if len(in_dts) != 1:
                    raise ValueError(f"node {i}: merge inputs disagree on dtype "
                                     f"({sorted(str(d) for d in in_dts)})")
                for r_i in in_rs:
                    need = Fraction(m.frame_multiple, 1) / r_i
                    fm = int(np.lcm(fm, need.numerator))
                if m.mode == "equal":
                    if len(set(in_rs)) != 1:
                        raise ValueError(f"node {i}: equal-mode merge rate contract "
                                         f"violated (input path rates {in_rs})")
                    r = in_rs[0] * m.ratio
                else:
                    r = sum(in_rs, Fraction(0, 1)) * m.ratio
                fm = int(np.lcm(fm, r.denominator))
                dt = np.dtype(m.out_dtype) if m.out_dtype is not None else in_dts.pop()
                tag_r = node_tag_r[inputs[0]] * m.ratio
                rest = stages[1:]
            else:
                r = node_r[inputs[0]] if inputs else Fraction(1, 1)
                dt = np.dtype(node_dt[inputs[0]]) if inputs else self.in_dtype
                tag_r = node_tag_r[inputs[0]] if inputs else Fraction(1, 1)
                m = None
                rest = stages
            if any(isinstance(s, MergeStage) for s in rest):
                raise ValueError(f"node {i}: a MergeStage may only be a multi-input "
                                 f"node's first stage")
            if optimize and rest:
                rest = _merge_lti(rest, dt)
            for s in rest:
                need = Fraction(s.frame_multiple, 1) / r
                fm = int(np.lcm(fm, need.numerator))
                r *= s.ratio
                tag_r *= s.ratio
                fm = int(np.lcm(fm, r.denominator))
                if s.out_dtype is not None:
                    dt = np.dtype(s.out_dtype)
            node_r.append(r)
            node_dt.append(dt)
            node_tag_r.append(tag_r)
            final = ([m] if m is not None else []) + list(rest)
            self._nodes.append((final, tuple(inputs), len(self.stages)))
            self.stages.extend(final)
        self.frame_multiple = fm
        self.node_ratios = list(node_r)
        self.node_dtypes = list(node_dt)
        self.n_branches = len(self.sinks)
        self.path_ratios = [node_r[s] for s in self.sinks]
        self.tag_ratios = [node_tag_r[s] for s in self.sinks]
        self.out_dtypes = [node_dt[s] for s in self.sinks]
        crossed = []
        for i, (_sl, inputs) in enumerate(self.raw_nodes):
            c = any(crossed[j] for j in inputs)
            first = self._nodes[i][0][0] if self._nodes[i][0] else None
            if isinstance(first, MergeStage) and first.mode == "concat":
                c = True
            crossed.append(c)
        self.concat_sinks = [crossed[s] for s in self.sinks]
        self.ratio = sum(self.path_ratios, Fraction(0, 1))
        self.out_dtype = self.out_dtypes[0]
        self._fn = None
        self._wired_fns: dict = {}

    def init_carry(self, device) -> tuple:
        """Flat carries in node order, matching ``stages``."""
        device = torch.device(device)
        carries = []
        for stages, inputs, _off in self._nodes:
            dt = self.in_dtype if not inputs else np.dtype(self.node_dtypes[inputs[0]])
            for s in stages:
                carries.append(s.init_carry(dt, device))
                if s.out_dtype is not None:
                    dt = np.dtype(s.out_dtype)
        return tuple(carries)

    def fn(self):
        """``run(carries, x) -> (carries, (y_sink0, …))``: a node read by
        several nodes is computed once; a merge node reads its inputs as one
        tuple."""
        if self._fn is None:
            nodes, sinks = self._nodes, self.sinks

            def run(carries, x):
                new_c = list(carries)
                vals: list = [None] * len(nodes)
                for i, (stages, inputs, off) in enumerate(nodes):
                    if not inputs:
                        v = x
                    elif len(inputs) == 1:
                        v = vals[inputs[0]]
                    else:
                        v = tuple(vals[j] for j in inputs)
                    for si, s in enumerate(stages):
                        c, v = s.fn(carries[off + si], v)
                        new_c[off + si] = c
                    vals[i] = v
                return tuple(new_c), tuple(vals[s] for s in sinks)

            self._fn = run
        return self._fn

    branch_out_items = FanoutPipeline.branch_out_items
    out_items = FanoutPipeline.out_items
    part_counts = FanoutPipeline.part_counts
    in_part_count = FanoutPipeline.in_part_count
    compile = Pipeline.compile
    wired_fn = Pipeline.wired_fn
    update_stage = Pipeline.update_stage
    # the flat carry (producer, then branches or nodes) checkpoints as one
    snapshot_carry = Pipeline.snapshot_carry
    carry_spec = Pipeline.carry_spec
    carry_matches = Pipeline.carry_matches
    restore_carry = Pipeline.restore_carry


def _chain_k(run, k: int):
    """``run`` over the ``k`` frames of ``x[k, n]``, the carry chained
    frame to frame, the outputs stacked ``[k, out]`` (each output of a
    multi-output program apart); ``run`` itself at k = 1."""
    if k == 1:
        return run

    def run_k(carries, x):
        ys = []
        for i in range(k):
            carries, y = run(carries, x[i])
            ys.append(y)
        if isinstance(ys[0], tuple):
            return carries, tuple(torch.stack(col) for col in zip(*ys))
        return carries, torch.stack(ys)

    return run_k


def _leaves(tree) -> list:
    """The tensors of a carry tree (tuples and lists of tensors), in order."""
    if isinstance(tree, (tuple, list)):
        return [t for sub in tree for t in _leaves(sub)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from ``leaves``
    (an iterator)."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(sub, leaves) for sub in tree)
    return next(leaves)


def _carry_spec(tree):
    """``tree``'s structure with each leaf as ``(shape, dtype name)``."""
    if isinstance(tree, (tuple, list)):
        return tuple(_carry_spec(sub) for sub in tree)
    return (tuple(tree.shape), str(tree.dtype))


def _is_spec_leaf(spec) -> bool:
    return len(spec) == 2 and isinstance(spec[1], str)


def _spec_leaves(spec) -> list:
    """The ``(shape, dtype name)`` leaves of a :func:`_carry_spec`."""
    if _is_spec_leaf(spec):
        return [spec]
    return [leaf for sub in spec for leaf in _spec_leaves(sub)]


def _from_spec(spec, leaves):
    """A carry of ``spec``'s structure, its leaves taken in order from
    ``leaves`` (an iterator)."""
    if _is_spec_leaf(spec):
        return next(leaves)
    return tuple(_from_spec(sub, leaves) for sub in spec)


def _host_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a snapshot holds a leaf of ``dtype`` in."""
    if dtype == torch.bfloat16:
        return np.dtype(np.int16)
    return torch.empty(0, dtype=dtype).numpy().dtype


def _clone(tree):
    return _rebuild(tree, (t.clone() for t in _leaves(tree)))


def _same_layout(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and a.device == b.device


# one capture at a time in the process: torch.cuda.graph synchronizes the
# device and empties the allocator's cache as it begins
_capture_lock = threading.Lock()


@contextlib.contextmanager
def _no_automatic_gc():
    """Hold off the garbage collector's automatic passes (in every thread)
    while graphs are captured: a pass that frees unreachable objects owning
    CUDA resources (graphs, events, pinned memory) runs their finalizers
    on whichever thread allocated last, and a freeing call that synchronizes
    the device invalidates the capture. torch.cuda.graph collects once
    itself before each capture begins."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class CompiledPipeline:
    """:meth:`Pipeline.compile`'s program on a CUDA device.

    One ``torch.cuda.CUDAGraph`` a slot runs the ``k`` frames of a dispatch
    through every stage, carry chained, from the slot's input buffer
    (:attr:`inputs`) into its output buffer (:attr:`outputs`), and writes
    the new carry into the static buffers of :attr:`carry`, which every
    slot shares (after the last stage, so no leaf is read after the buffer
    it aliases has been overwritten; a leaf a stage passes through is the
    buffer itself and is not copied). The slots' graphs share one memory
    pool: they are replayed one at a time, on one stream.

    A :class:`FanoutPipeline` or :class:`DagPipeline` compiles the same way:
    its graph writes one static output buffer a branch or sink, and
    :attr:`outputs` holds a tuple of them a slot.

    A streamed caller keeps one slot a dispatch group in flight:
    :meth:`dispatch` replays the slot's graph on what its H2D put in the
    slot's input, and the slot's output is read by its D2H; the slot is
    reused only once that D2H has landed. A call ``fn(carry, x)`` copies
    ``x`` into slot 0's input, replays it and returns a copy of its output,
    so the caller may hold it across calls.

    A carry other than :attr:`carry` (the result of
    :meth:`Pipeline.update_stage`, a fresh ``init_carry``) is written into
    the static buffers with ``copy_`` on the current stream before the
    replay, leaf by leaf where it differs: frames replayed before keep the
    old values. A leaf whose shape, dtype or device changed makes the
    program capture again; :attr:`captures` counts the captures.

    Capture follows PyTorch's recipe: an eager warm-up on a side stream (a
    high-priority one, never a transfer's copy stream) with a copy of the
    carry first (it builds the kernels, the library plans
    and every table a stage makes on first use, whose host copies a capture
    forbids), then the slots' captures. :attr:`launches` holds the hand
    kernels' launches a replay makes (``cuda_kernels.capturing``); each
    replay adds them to ``cuda_kernels.launches``.

    Each capture is billed to the profile plane under :attr:`program` (the
    first with the caller's reason, a recapture as ``reinit``), with its
    warm-up; nothing inside the captured region records telemetry (it would
    run once, at capture)."""

    def __init__(self, pipeline: Pipeline, frame_size: int, device: torch.device,
                 k: int = 1, donate: bool = True, slots: int = 1, wire=None,
                 packed=None, carry=None, program: str = "Pipeline",
                 reason: Optional[str] = "warmup", profile_device: Optional[str] = None):
        self.pipeline = pipeline
        self.program = str(program)
        self.frame_size = int(frame_size)
        self.k = int(k)
        self.device = device
        self.donate = donate
        self.wire, self.packed = wire, packed
        self.captures = 0
        self.launches: dict = {}
        self.carry = pipeline.init_carry(device) if carry is None else carry
        self._program = _program(pipeline, self.k, wire, packed)
        self.inputs = [_slot_input(pipeline, self.frame_size, self.k, wire, packed, device)
                       for _ in range(int(slots))]
        self.prof = _register_cost(self.program, pipeline, self.frame_size, wire, self.k,
                                   profile_device)
        self._capture(reason, _program_sig(self.frame_size, wire, self.k))

    def _capture(self, reason: Optional[str], signature: str) -> None:
        if reason is None:              # the caller's compile window covers it
            self._capture_graphs()
            return
        with _profile.compiling(self.program, reason, signature):
            self._capture_graphs()

    def _capture_graphs(self) -> None:
        program = self._program
        cur = torch.cuda.current_stream(self.device)
        # torch.cuda.Stream hands out the streams of a pool, round robin: a
        # copy stream of ops/xfer.py (the normal-priority pool) may be the
        # very stream another thread is capturing on, and its copies and
        # events would then land in that capture. Captures take theirs from
        # the high-priority pool, which nothing else in the port uses.
        side = torch.cuda.Stream(self.device, priority=-1)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            program(_clone(self.carry), self.inputs[0])
        cur.wait_stream(side)
        graphs, outputs, pool = [], [], None
        with _capture_lock, _no_automatic_gc(), cuda_kernels.capturing() as counts:
            for x in self.inputs:
                graph = torch.cuda.CUDAGraph()
                try:
                    with torch.cuda.graph(graph, pool=pool, stream=side,
                                          capture_error_mode="thread_local"):
                        new, y = program(self.carry, x)
                        self._write_carry(new)
                except RuntimeError as e:
                    raise RuntimeError(
                        f"Pipeline.compile: the CUDA graph capture of "
                        f"{[st.name for st in self.pipeline.stages]} failed (a stage "
                        f"that syncs with the host, or copies host memory, inside "
                        f"its fn cannot be captured): {e}") from e
                pool = graph.pool()
                graphs.append(graph)
                outputs.append(y)
        self._graphs, self.outputs = graphs, outputs
        self.launches = {name: n // len(graphs) for name, n in counts.items() if n}
        self.captures += 1

    def _write_carry(self, new) -> None:
        """Copy the new carry into the static buffers, inside the capture."""
        static = _leaves(self.carry)
        new = _leaves(new)
        if len(new) != len(static):
            raise ValueError("a stage changed the structure of its carry")
        owned = {t.untyped_storage().data_ptr() for t in static}
        # a new leaf that shares memory with a static buffer (other than
        # being that buffer) is cloned first, so no copy below overwrites
        # what a later copy still reads
        new = [n if n is s or n.untyped_storage().data_ptr() not in owned else n.clone()
               for n, s in zip(new, static)]
        for n, s in zip(new, static):
            if n is not s:
                if not _same_layout(n, s):
                    raise ValueError(f"a stage changed a carry leaf from "
                                     f"{tuple(s.shape)} {s.dtype} to "
                                     f"{tuple(n.shape)} {n.dtype} within a frame")
                s.copy_(n)

    def _load(self, carry) -> None:
        """Make ``carry`` the program's state before the next replay."""
        new, static = _leaves(carry), _leaves(self.carry)
        if len(new) == len(static) and all(
                n is s or _same_layout(n, s) for n, s in zip(new, static)):
            for n, s in zip(new, static):
                if n is not s:
                    s.copy_(n)
            return
        # a leaf changed shape, dtype or device: new buffers, a new capture
        ids = {id(t) for t in static}
        self.carry = _rebuild(carry, (n if id(n) in ids else n.clone() for n in new))
        self._capture("reinit", "carry:" + ",".join(
            f"{tuple(t.shape)}{str(t.dtype).replace('torch.', '')}" for t in _leaves(self.carry)))

    def dispatch(self, slot: int, carry):
        """Replay ``slot``'s graph on its input buffer: ``(carry, y)``, ``y``
        the slot's output buffer, which its next replay overwrites."""
        if carry is not self.carry:
            self._load(carry)
        self._graphs[slot].replay()
        for name, n in self.launches.items():
            cuda_kernels.launches[name] += n
        return (self.carry if self.donate else _clone(self.carry)), self.outputs[slot]

    def __call__(self, carry, x):
        dst = self.inputs[0]
        for d, t in (zip(dst, x) if isinstance(dst, tuple) else ((dst, x),)):
            if t.shape != d.shape:
                raise ValueError(f"compiled for input {tuple(d.shape)}, "
                                 f"got {tuple(t.shape)}")
            d.copy_(t)
        carry, y = self.dispatch(0, carry)
        self.prof.dispatch(t=time.monotonic())
        if isinstance(y, tuple):
            return carry, tuple(t.clone() for t in y)
        return carry, y.clone()


def _program_sig(frame_size: int, wire, k: int) -> str:
    """A program's shape signature, as the profile plane's compile records
    name it."""
    return f"frame={int(frame_size)},wire={getattr(wire, 'name', 'none')},k={int(k)}"


def _register_cost(name: str, pipeline, frame_size: int, wire, k: int,
                   profile_device: Optional[str] = None):
    """Register ``name``'s analytic cost with the profile plane, lazily
    (counted when the plane is read): one unit is one dispatch of ``k``
    frames; ``profile_device`` makes it a sharded program's per-device
    entry."""
    def cost():
        from ..utils.roofline import program_cost
        return program_cost(pipeline, frame_size, wire=wire, k=k)

    from ..utils.roofline import dominant_dtype
    return _profile.register(name, cost_thunk=cost, dtype=dominant_dtype(pipeline.stages),
                             device=profile_device)


def _program(pipeline, k: int, wire, packed):
    """``run(carry, inp)``: the chain over one slot input, a tensor (plain)
    or a tuple of part tensors (wired, :meth:`Pipeline.wired_fn`)."""
    if wire is None:
        return _chain_k(pipeline.fn(), k)
    wired = pipeline.wired_fn(wire, k, packed)
    return lambda carry, inp: wired(carry, *inp)


def _slot_input(pipeline, frame_size: int, k: int, wire, packed, device):
    """One slot's static input: a ``[frame]`` (``[k, frame]``) tensor of the
    stream's dtype, or, wired, a tuple of the wire's parts for it (their
    shapes probed from an encode of zeros, with the ``[k]`` axis), or one
    uint8 tensor of ``packed.nbytes``."""
    lead = (k,) if k > 1 else ()
    if wire is None:
        return torch.zeros(lead + (frame_size,), dtype=torch_dtype(pipeline.in_dtype),
                           device=device)
    if packed is not None:
        return (torch.zeros(packed.nbytes, dtype=torch.uint8, device=device),)
    parts = wire.encode_host(np.zeros(frame_size, dtype=pipeline.in_dtype))
    return tuple(torch.zeros(lead + np.shape(p), dtype=torch_dtype(np.asarray(p).dtype),
                             device=device) for p in parts)


class EagerProgram:
    """:meth:`Pipeline.compile`'s program on the CPU: the eager chain looped
    over the ``k`` frames of a call, with :class:`CompiledPipeline`'s slot
    interface (``inputs``, :meth:`dispatch`) for a streamed caller; wired,
    the same decode, chain and encode as the compiled program."""

    def __init__(self, pipeline: Pipeline, frame_size: int, k: int = 1, slots: int = 1,
                 wire=None, packed=None, program: str = "Pipeline",
                 profile_device: Optional[str] = None):
        self.program = str(program)
        self._run = _program(pipeline, k, wire, packed)
        self.inputs = [_slot_input(pipeline, frame_size, k, wire, packed, "cpu")
                       for _ in range(int(slots))]
        self.prof = _register_cost(self.program, pipeline, frame_size, wire, k, profile_device)

    def dispatch(self, slot: int, carry):
        return self._run(carry, self.inputs[slot])

    def __call__(self, carry, x):
        out = self._run(carry, x)
        self.prof.dispatch(t=time.monotonic())
        return out


def _merge_lti(stages: Sequence[Stage], in_dtype) -> list:
    """Collapse runs of adjacent LTI FIR stages into one FIR with the
    convolved taps (zero-stuffed by the first decimation, the noble
    identity). On a real stream each FIR takes ``.real`` at its boundary, so
    complex-tap runs merge only where the stream is complex."""
    out: list = []
    dtype = np.dtype(in_dtype)
    out_dtypes: list = []               # stream dtype ENTERING each stage in `out`
    for s in stages:
        if s.lti is not None and out and out[-1].lti is not None:
            t1, d1, fl1, im1 = out[-1].lti
            t2, d2, fl2, im2 = s.lti
            p1 = (out[-1].route or (None, None, None))[1:]
            p2 = (s.route or (None, None, None))[1:]
            complex_stream = bool(np.issubdtype(out_dtypes[-1], np.complexfloating))
            if p1 != p2 or (not complex_stream
                            and not (np.isrealobj(t1) and np.isrealobj(t2))):
                out.append(s)
                out_dtypes.append(dtype)
                if s.out_dtype is not None:
                    dtype = np.dtype(s.out_dtype)
                continue
            if d1 == 1:
                taps = np.convolve(t1, t2)
            else:
                up = np.zeros((len(t2) - 1) * d1 + 1, dtype=np.result_type(t1, t2))
                up[::d1] = t2
                taps = np.convolve(t1, up)
            impl = "os" if "os" in (im1, im2) else \
                ("pallas" if im1 == im2 == "pallas" else
                 ("poly" if im1 == im2 == "poly" else "auto"))
            out[-1] = fir_stage(taps, decim=d1 * d2, fft_len=max(fl1, fl2),
                                name=f"{out[-1].name}*{s.name}", impl=impl,
                                fft_impl=p1[0], precision=p1[1])
        else:
            out.append(s)
            out_dtypes.append(dtype)
            if s.out_dtype is not None:
                dtype = np.dtype(s.out_dtype)
    return out


# ---------------------------------------------------------------------------
# stage factories
# ---------------------------------------------------------------------------

_FFT_IMPLS = (None, "auto", "mxu", "xla")
_FFT_PRECISIONS = (None, "f32", "bf16")


def _check_fft_pins(impl, precision) -> None:
    """The JAX package's FFT route pins (``impl``: its matmul DFT or XLA's
    FFT; ``precision``: its matmul precision) are accepted and all map onto
    ``torch.fft`` in float32, the route the JAX package takes off the TPU."""
    if impl not in _FFT_IMPLS:
        raise ValueError(f"fft impl must be one of {_FFT_IMPLS}, got {impl!r}")
    if precision not in _FFT_PRECISIONS:
        raise ValueError(f"fft precision must be one of {_FFT_PRECISIONS}, "
                         f"got {precision!r}")


def _on(carry_leaf: torch.Tensor, arr: np.ndarray) -> torch.Tensor:
    """A host array as a tensor on the device of ``carry_leaf``."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(carry_leaf.device)


def fir_stage(taps, decim: int = 1, fft_len: int = 8192, name: str = "fir",
              impl: str = "auto", fft_impl: Optional[str] = None,
              precision: Optional[str] = None) -> Stage:
    """FIR (+ decimation by slicing) as a streaming stage.

    ``impl="os"`` (and ``"auto"``) filters by FFT overlap-save: the frame is
    cut into ``2L``-sample blocks with hop ``L`` (``fft_len/2``, doubled
    until it is ≥ ``2·n_taps``) and filtered in the frequency domain
    with ``torch.fft``. ``impl="pallas"`` runs the hand-written direct-form
    ``fir`` kernel (:func:`cuda_kernels.fir_continue`) with the taps read
    from the carry, so a retune reaches it. ``"auto"`` picks overlap-save on
    every device in this slice, as the JAX package does off the TPU.

    A decimating filter with ``impl="poly"``, ``impl="pallas"``, or
    ``impl="auto"`` and ``n_taps <= 32·decim`` takes the polyphase route
    (:func:`_poly_decim_fir_stage`), which computes at the decimated rate.

    Carry: ``(H, taps_f32, tail[L])``; ``H`` is the half spectrum on a real
    stream with real taps and no ``fft_impl="mxu"`` pin, else the full one.
    ``update(taps=…)`` swaps the filter (same tap count) with frames in
    flight. ``precision="bf16"`` runs the ``fir`` kernel's bf16 mode; on the
    overlap-save route the FFTs stay float32 (``torch.fft`` has no bf16
    complex transform; the JAX package's FFTs off the TPU ignore the pin too).
    ``precision="int8"`` (real taps) runs the convolution as a banded matmul
    over ``Bq``-sample tiles, each with its left neighbour (:func:`_int8_banded_fir`),
    both operands absmax-quantized to int8 on the device; the carry is the
    float32 stage's, leaf for leaf. ``lower(p)`` rebuilds the stage at ``p``.
    """
    if impl not in ("auto", "os", "pallas", "poly"):
        raise ValueError(f"impl must be auto, os, pallas or poly, got {impl!r}")
    taps = np.asarray(taps)
    nt = len(taps)
    if impl == "poly" or (impl == "pallas" and decim > 1) \
            or (impl == "auto" and decim > 1 and nt <= 32 * decim):
        return _poly_decim_fir_stage(taps, decim, fft_len, name, impl,
                                     precision=precision)
    built_real = np.isrealobj(taps)
    if precision == "int8":
        if not built_real:
            raise ValueError("precision='int8' requires real taps")
        _check_fft_pins(fft_impl, None)
    else:
        _check_fft_pins(fft_impl, precision)
    if impl == "pallas" and not (built_real and nt >= 2):
        raise ValueError("impl='pallas' requires >= 2 real taps "
                         "(complex taps: use the overlap-save route)")
    L = fft_len // 2
    while L < 2 * nt:                   # hop must comfortably exceed the tap overlap
        L *= 2
    fft_len = 2 * L
    # the int8 tile: a power of two dividing L that covers the tap overlap
    # in one left-neighbour tile (Bq >= nt - 1)
    Bq = min(L, 128)
    while Bq < nt - 1:
        Bq *= 2

    def _spectra(t):
        full = np.fft.fft(np.concatenate([t, np.zeros(fft_len - nt)])
                          ).astype(np.complex64)
        half = np.fft.rfft(np.concatenate([np.real(t), np.zeros(fft_len - nt)])
                           ).astype(np.complex64)
        return full, half

    H, Hr = _spectra(taps)

    def fn(carry, x):
        Hc, tt, tail = carry
        if precision == "int8":
            ext8 = torch.cat([tail[L - Bq:], x])
            if x.is_complex():
                y = torch.complex(_int8_banded_fir(ext8.real, tt, nt, Bq),
                                  _int8_banded_fir(ext8.imag, tt, nt, Bq))
            else:
                y = _int8_banded_fir(ext8, tt, nt, Bq)
            y = y.to(x.dtype)
            if decim > 1:
                y = y[::decim]
            # frames are L-multiples: the new tail is the frame's last L samples
            return (Hc, tt, x[x.shape[0] - L:].clone()), y
        ext = torch.cat([tail, x])                   # [(S+1)·L], S = n // L
        if impl == "pallas":
            y = cuda_kernels.fir_continue(ext[L - (nt - 1):L], x, tt,
                                          precision=precision)
        else:
            rows = ext.reshape(-1, L)
            blocks = torch.cat([rows[:-1], rows[1:]], dim=1)    # [S, 2L]
            if x.is_complex():
                spec = torch.fft.fft(blocks, dim=1) * Hc[None, :]
                seg = torch.fft.ifft(spec, dim=1)[:, L:]
            elif Hc.shape[0] == fft_len:
                spec = torch.fft.fft(blocks.to(torch.complex64), dim=1) * Hc[None, :]
                seg = torch.fft.ifft(spec, dim=1)[:, L:].real
            else:
                spec = torch.fft.rfft(blocks, dim=1) * Hc[None, :]
                seg = torch.fft.irfft(spec, n=fft_len, dim=1)[:, L:]
            y = seg.reshape(-1).to(x.dtype)
        if decim > 1:
            y = y[::decim]
        return (Hc, tt, ext[ext.shape[0] - L:]), y

    def init_carry(dtype, device):
        dt = np.dtype(dtype)
        use_full = np.issubdtype(dt, np.complexfloating) or fft_impl == "mxu"
        dev = torch.device(device)
        return (torch.from_numpy(H if use_full else Hr).to(dev),
                torch.from_numpy(np.real(taps).astype(np.float32)).to(dev),
                torch.zeros(L, dtype=torch_dtype(dt), device=dev))

    def update(carry, taps=None):
        """Swap the filter with frames in flight: same tap count, new
        response; the spectrum keeps the carry's layout (full or half), the
        history is kept."""
        if taps is None:
            return carry
        new = np.asarray(taps)
        if len(new) != nt:
            raise ValueError(
                f"tap swap must keep the tap count ({nt}); got {len(new)} — "
                f"rebuild the stage for a different filter length")
        if np.iscomplexobj(new) and built_real:
            raise ValueError(
                "stage was built with real taps; swapping to complex taps "
                "requires rebuilding the stage")
        Hc_old, _tt, tail = carry
        full, half = _spectra(new)
        Hn = full if Hc_old.shape[0] == fft_len else half
        return (_on(tail, Hn), _on(tail, np.real(new).astype(np.float32)), tail)

    def _lower(p: str) -> Optional[Stage]:
        if p == "bf16" or (p == "int8" and built_real):
            return fir_stage(taps, decim=decim, fft_len=fft_len, name=name, impl=impl,
                             fft_impl=fft_impl, precision=p)
        return None

    def cost(n, dt):
        e = dt.itemsize
        if impl == "pallas" and precision != "int8":
            return _roofline().kernel_cost("fir", n=n, nt=nt, complex=e == 8)
        b = n * e + (n // decim) * e + 4 * nt
        if precision == "int8":              # the banded int8 product a plane
            return b, 2 * (e // 4) * 2 * Bq * n
        return b, (e // 4) * n * (10 * np.log2(2 * L) + 6)   # FFT, product, IFFT

    return Stage(fn, init_carry, Fraction(1, decim), None, int(np.lcm(L, decim)),
                 name, lti=(taps, decim, fft_len, impl), update=update,
                 lower=_lower, compute_dtype=_compute_dtype(precision),
                 cost=cost, route=(impl, fft_impl, precision), history=L)


def _roofline():
    from ..utils import roofline
    return roofline


def _compute_dtype(precision: Optional[str]) -> str:
    return precision if precision in ("bf16", "int8") else "f32"


def _quantize(v: torch.Tensor):
    """Symmetric int8 quantization on the device: ``(round(v / s), s)`` with
    ``s = max(absmax(v), 1e-30) / 127`` a float32 scalar tensor (no host
    read, so a CUDA graph can capture it); ``torch.round`` rounds half to
    even, as the JAX package's ``jnp.round``."""
    s = torch.clamp_min(v.abs().max(), 1e-30) / 127.0
    return torch.round(v / s).to(torch.int8), s


def _int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of int8 matrices with an exact int32 accumulator:
    ``torch._int_mm`` (cuBLASLt's int8 GEMM on a card). On a card it needs
    more than 16 rows, so a shorter ``a`` is padded with zero rows (exact),
    and K and N multiples of 8, else it raises."""
    if a.device.type == "cuda":
        if a.shape[1] % 8 or b.shape[1] % 8:
            raise ValueError(f"int8 matmul {tuple(a.shape)} @ {tuple(b.shape)}: "
                             f"cuBLASLt needs K and N multiples of 8")
        m = a.shape[0]
        if m <= 16:
            a = torch.cat([a, a.new_zeros((17 - m, a.shape[1]))])
            return torch._int_mm(a.contiguous(), b)[:m]
    return torch._int_mm(a.contiguous(), b)


def _int8_banded_fir(ext8: torch.Tensor, tt: torch.Tensor, nt: int, Bq: int) -> torch.Tensor:
    """The int8 rung of :func:`fir_stage` on one real plane: ``ext8`` is
    ``Bq`` history samples and the frame. With ``T[j, i] = taps[Bq + i − j]``
    (zero out of range), tile s's output is ``y[s·Bq + i] = Σ_j
    ext8[s·Bq + j]·T[j, i]``: one ``[S, 2Bq] @ [2Bq, Bq]`` int8 product with
    int32 accumulation, dequantized by the two scales."""
    jj = torch.arange(2 * Bq, device=tt.device)[:, None]
    ii = torch.arange(Bq, device=tt.device)[None, :]
    kk = Bq + ii - jj
    T = torch.where((kk >= 0) & (kk < nt), tt[torch.clamp(kk, 0, nt - 1)],
                    torch.zeros((), dtype=tt.dtype, device=tt.device))
    Tq, sw = _quantize(T)
    q, sx = _quantize(ext8)
    rq = q.reshape(-1, Bq)                               # [S+1, Bq]
    blk = torch.cat([rq[:-1], rq[1:]], dim=1)            # [S, 2Bq]
    acc = _int8_mm(blk, Tq)
    return acc.reshape(-1).to(torch.float32) * (sx * sw)


def fft_stage(n: int, direction: str = "forward", shift: bool = False,
              normalize: bool = False, window=None,
              impl: Optional[str] = None,
              precision: Optional[str] = None) -> Stage:
    """Batched frame FFT: the frame reshaped ``[-1, n]``, transformed along
    rows with ``torch.fft``. ``window``: a name or array applied per row
    before a forward FFT. ``impl``/``precision`` are the JAX package's route
    pins; they map onto ``torch.fft`` (see :func:`_check_fft_pins`)."""
    _check_fft_pins(impl, precision)
    if direction not in ("forward", "inverse"):
        raise ValueError(f"direction must be forward or inverse, got {direction!r}")
    if window is not None:
        from ..dsp.windows import get_window
        window = np.asarray(window, dtype=np.float32) if not isinstance(window, str) \
            else get_window(window, n).astype(np.float32)
    windows = {}                     # device -> window tensor

    def fn(carry, x):
        f = x.reshape(-1, n)
        if direction == "forward":
            if window is not None:
                w = windows.get(f.device)
                if w is None:
                    w = windows[f.device] = torch.from_numpy(window).to(f.device)
                f = f * w[None, :]
            y = torch.fft.fft(f.to(torch.complex64), dim=1)
        else:
            y = torch.fft.ifft(f.to(torch.complex64), dim=1) * n
        if normalize:
            y = y / float(np.sqrt(n))
        if shift:
            y = torch.fft.fftshift(y, dim=1)
        return carry, y.reshape(-1).to(torch.complex64)

    def _lower(p: str) -> Optional[Stage]:
        if p != "bf16":
            return None
        return fft_stage(n, direction, shift, normalize, window, impl=impl,
                         precision="bf16")

    def cost(k, dt):
        return k * dt.itemsize + 8 * k, 5 * k * np.log2(n)

    return Stage(fn, _stateless, Fraction(1, 1), np.complex64, n, f"fft{n}",
                 lower=_lower, compute_dtype=_compute_dtype(precision), cost=cost,
                 route=(impl, None, precision))


def fir_fft_stage(taps, n_fft: int, name: Optional[str] = None,
                  precision: Optional[str] = None) -> Stage:
    """Fused FIR → FFT stage on the hand-written ``fir_fft`` kernel
    (:func:`cuda_kernels.fir_fft`): the same output as
    ``Pipeline([fir_stage(taps), fft_stage(n_fft)])`` without the filtered
    stream reaching device memory. Real taps, ``2 <= n_taps <= n_fft``.
    Carry: ``(taps_f32, tail[n_taps − 1])``; ``update(taps=…)`` swaps the
    taps with no rebuild. ``precision="bf16"`` runs the kernel's bf16 mode;
    there is no int8 form (the JAX package's has none either)."""
    if precision == "int8":
        raise ValueError("fir_fft_stage has no int8 form (its lower hook declines "
                         "the rung): use precision='bf16' or None")
    if precision not in (None, "f32", "bf16"):
        raise ValueError(f"precision must be None, 'f32' or 'bf16', got {precision!r}")
    taps = np.asarray(taps)
    nt = len(taps)
    n_fft = int(n_fft)
    if not (np.isrealobj(taps) and 2 <= nt <= n_fft):
        raise ValueError("fir_fft_stage requires real taps with 2 <= n_taps <= n_fft")
    name = name or f"fir_fft{n_fft}"

    def fn(carry, x):
        tt, tail = carry
        y = cuda_kernels.fir_fft(tail, x, tt, n_fft, precision=precision)
        # frames are >= n_fft >= nt samples: the new history is the frame's
        # own last nt-1 samples
        return (tt, x[x.shape[0] - (nt - 1):]), y

    def init_carry(dtype, device):
        dev = torch.device(device)
        return (torch.from_numpy(np.real(taps).astype(np.float32)).to(dev),
                torch.zeros(nt - 1, dtype=torch_dtype(dtype), device=dev))

    def update(carry, taps=None):
        """Runtime tap swap (same count; real — the kernel takes real taps)."""
        if taps is None:
            return carry
        new = np.asarray(taps)
        if len(new) != nt:
            raise ValueError(
                f"tap swap must keep the tap count ({nt}); got {len(new)} — "
                f"rebuild the stage for a different filter length")
        if np.iscomplexobj(new):
            raise ValueError("fir_fft_stage taps must stay real")
        _tt, tail = carry
        return (_on(tail, new.astype(np.float32)), tail)

    def _lower(p: str) -> Optional[Stage]:
        if p != "bf16":
            return None
        return fir_fft_stage(taps, n_fft, name=name, precision="bf16")

    def cost(k, dt):
        return _roofline().kernel_cost("fir_fft", n=k, nt=nt, n_fft=n_fft,
                                       complex=dt.itemsize == 8)

    return Stage(fn, init_carry, Fraction(1, 1), np.complex64, n_fft, name,
                 update=update, lower=_lower, compute_dtype=_compute_dtype(precision),
                 cost=cost, route=("pallas", None, precision), history=nt - 1)


def mag2_stage() -> Stage:
    def fn(carry, x):
        if x.is_complex():
            return carry, (x.real * x.real + x.imag * x.imag).to(torch.float32)
        return carry, (x * x).to(torch.float32)

    def cost(n, dt):
        return n * dt.itemsize + 4 * n, (3 if dt.itemsize == 8 else 1) * n

    return Stage(fn, _stateless, Fraction(1, 1), np.float32, 1, "mag2", cost=cost)


# ---------------------------------------------------------------------------
# the FM front end: polyphase decimation, resampling, rotator, demod
# ---------------------------------------------------------------------------

def _as_dtype(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``y`` cast to the stream's dtype; a real stream keeps the real part."""
    if y.is_complex() and not dtype.is_complex:
        y = y.real
    return y.to(dtype)


def _tail(hist: torch.Tensor, x: torch.Tensor, H: int) -> torch.Tensor:
    """The last ``H`` samples of ``hist ++ x`` as a tensor of its own, never a
    view of the frame (a later frame may reuse the frame's buffer)."""
    n = x.shape[0]
    if n >= H:
        return x[n - H:].clone()
    return torch.cat([hist, x])[n:]


def _phasor(ph: torch.Tensor) -> torch.Tensor:
    """``exp(i·ph)`` of a float32 phase, complex64."""
    return torch.complex(torch.cos(ph), torch.sin(ph))


def _shifted_matvec(ext: torch.Tensor, W: torch.Tensor, m: int, nq: int,
                    precision: Optional[str] = None) -> torch.Tensor:
    """``y = Σ_{r=0..m} rows[m−r : m−r+nq] @ W[r]`` with
    ``rows = ext.reshape(-1, D)`` (a view): the shifted-row polyphase
    accumulation as m+1 matmuls, nothing materialized. Float32 runs at full
    precision (TF32 is off); ``precision="bf16"`` rounds real operands to
    bfloat16 and accumulates their exact products in float32 (complex
    operands stay float32, as in the JAX package off the TPU);
    ``precision="int8"`` (real weights) takes :func:`_int8_shifted_matvec`,
    a complex stream a plane at a time."""
    D = W.shape[1]
    rows = ext.reshape(-1, D)
    if precision == "int8" and not W.is_complex():
        if rows.is_complex():
            return torch.complex(_int8_shifted_matvec(rows.real, W, m, nq),
                                 _int8_shifted_matvec(rows.imag, W, m, nq))
        return _int8_shifted_matvec(rows, W, m, nq)
    if precision == "bf16" and not (rows.is_complex() or W.is_complex()):
        rows = rows.to(torch.bfloat16).to(torch.float32)
        W = W.to(torch.bfloat16).to(torch.float32)
    else:
        dt = torch.promote_types(rows.dtype, W.dtype)
        rows, W = rows.to(dt), W.to(dt)
    y = rows[m:m + nq] @ W[0]
    for r in range(1, m + 1):
        y = y + rows[m - r:m - r + nq] @ W[r]
    return y


def _int8_shifted_matvec(rows: torch.Tensor, W: torch.Tensor, m: int,
                         nq: int) -> torch.Tensor:
    """The int8 rung of :func:`_shifted_matvec` on one real plane: both
    operands absmax-quantized to int8 on the device (the float32 ``W`` of
    the carry quantized here, so the carry is the float32 stage's), every
    shifted MAC an int8 × int8 product, dequantized once. The products are
    taken in float32 on the integer values: each is below 2^14 and every
    partial sum of at most ``(m+1)·D ≤ 1,040`` of them below 2^24, so float32
    (TF32 off) holds the int32 accumulator exactly, in any order. A
    matrix-vector product (N = 1, K = D) has no cuBLASLt int8 form."""
    if (m + 1) * W.shape[1] > 1040:
        raise ValueError(f"int8 shifted matvec: {(m + 1) * W.shape[1]} terms a sum "
                         f"exceed float32's exact integer range (1,040)")
    Wq, sw = _quantize(W)
    rq, sx = _quantize(rows)
    Wf, rf = Wq.to(torch.float32), rq.to(torch.float32)
    acc = rf[m:m + nq] @ Wf[0]
    for r in range(1, m + 1):
        acc = acc + rf[m - r:m - r + nq] @ Wf[r]
    return acc * (sx * sw)


def _poly_decim_weights(taps: np.ndarray, D: int, m: int) -> np.ndarray:
    """``taps`` as the shifted-row weight matrix ``W[r, s] = taps[r·D − s]``
    (zero out of range), so ``y[q] = Σ_r rows[q+m−r] · W[r]``."""
    nt = len(taps)
    W = np.zeros((m + 1, D), taps.dtype)
    for r in range(m + 1):
        for s in range(D):
            t = r * D - s
            if 0 <= t < nt:
                W[r, s] = taps[t]
    return W


def _poly_decim_fir_stage(taps: np.ndarray, decim: int, fft_len: int, name: str,
                          impl: str, precision: Optional[str] = None) -> Stage:
    """Decimating FIR as m+1 shifted matvecs over the stride-D row matrix:
    ``y[q] = Σ_t taps[t]·x[q·D − t] = Σ_{r=0..m} rows[q+m−r] · W[r]`` with
    ``rows[j, s] = ext[j·D + s]`` and ``W[r, s] = taps[r·D − s]``: n_taps/D
    MACs per input, at the decimated rate.

    ``impl="pallas"`` runs real weights on the hand-written ``poly_fir``
    kernel (a complex stream in one pass); complex weights, and every other
    impl, take :func:`_shifted_matvec`. Carry ``(W, hist[m·D])``; ``W`` is
    bfloat16 under ``precision="bf16"`` (real taps). ``update(taps=…)`` swaps
    the filter (same tap count, no real→complex swap). ``precision="int8"``
    (real taps) runs :func:`_int8_shifted_matvec` on either impl (the kernel
    has no int8 mode), the carried ``W`` staying float32."""
    if precision not in (None, "f32", "bf16", "int8"):
        raise ValueError(f"precision must be None, 'f32', 'bf16' or 'int8', "
                         f"got {precision!r}")
    D = int(decim)
    nt = len(taps)
    built_real = np.isrealobj(taps)
    if precision == "int8" and not built_real:
        raise ValueError("precision='int8' requires real taps")
    m = max(1, -(-(nt - 1) // D))       # history rows so windows never underflow
    H = m * D

    def fn(carry, x):
        W, hist = carry
        if impl == "pallas" and not W.is_complex() and precision != "int8":
            y = cuda_kernels.poly_fir(hist, x.contiguous(), W, precision=precision)
        else:
            y = _shifted_matvec(torch.cat([hist, x]), W, m, x.shape[0] // D,
                                precision=precision)
        return (W, _tail(hist, x, H)), _as_dtype(y, x.dtype)

    def _weights(t, complex_stream: bool, device) -> torch.Tensor:
        # a real stream takes .real at the stage boundary: bake that in
        teff = t if complex_stream else np.real(t)
        teff = teff.astype(np.complex64 if np.iscomplexobj(teff) else np.float32)
        W = torch.from_numpy(_poly_decim_weights(teff, D, m))
        if precision == "bf16" and not W.is_complex():
            W = W.to(torch.bfloat16)            # carried weights: half the bytes
        return W.to(device)

    def init_carry(dtype, device):
        dt = np.dtype(dtype)
        dev = torch.device(device)
        return (_weights(taps, np.issubdtype(dt, np.complexfloating), dev),
                torch.zeros(H, dtype=torch_dtype(dt), device=dev))

    def update(carry, taps=None):
        """Swap the filter with frames in flight: same tap count; the weights
        are rebuilt with the real/complex treatment of the stream."""
        if taps is None:
            return carry
        new = np.asarray(taps)
        if len(new) != nt:
            raise ValueError(
                f"tap swap must keep the tap count ({nt}); got {len(new)} — "
                f"rebuild the stage for a different filter length")
        if np.iscomplexobj(new) and built_real:
            raise ValueError(
                "stage was built with real taps; swapping to complex taps "
                "requires rebuilding the stage")
        _w_old, hist = carry
        return (_weights(new, hist.is_complex(), hist.device), hist)

    def _lower(p: str) -> Optional[Stage]:
        if p not in ("bf16", "int8") or not built_real:
            return None
        return _poly_decim_fir_stage(taps, D, fft_len, name, impl, precision=p)

    def cost(n, dt):
        return _roofline().kernel_cost("poly_fir", n=n, m=m, D=D, complex=dt.itemsize == 8,
                                       w_bytes=2 if precision == "bf16" else 4)

    return Stage(fn, init_carry, Fraction(1, D), None, D, name,
                 lti=(taps, D, fft_len, impl), update=update, lower=_lower,
                 compute_dtype=_compute_dtype(precision), cost=cost,
                 route=(impl, None, precision))


def resample_stage(interp: int, decim: int, taps=None, fft_len: int = 8192,
                   name: str = "resample", impl: str = "poly") -> Stage:
    """Rational I/D resampler.

    ``impl="poly"`` (default): the polyphase form, outputs grouped by phase
    and contracted against the phase-tap tensor ``W[m+1, D, I]`` with
    :func:`_shifted_matvec` (m+1 ``[nq, D]·[D, I]`` matmuls).
    ``impl="pallas"``: the same factorization in the hand-written
    ``poly_fir`` kernel with the 3-D ``W``. ``impl="stuff"``: zero-stuff ×I,
    overlap-save lowpass, ↓D; complex taps force it. Default taps:
    ``kaiser_lowpass(0.5/r·0.8, 0.1/r)·I``, ``r = max(I, D)``."""
    from math import gcd

    if impl not in ("poly", "stuff", "pallas"):
        raise ValueError(f"impl must be poly, stuff or pallas, got {impl!r}")
    g = gcd(int(interp), int(decim))
    I, D = int(interp) // g, int(decim) // g
    if taps is None:
        from ..dsp import firdes
        r = max(I, D)
        taps = firdes.kaiser_lowpass(0.5 / r * 0.8, 0.1 / r) * I
    taps = np.asarray(taps)
    if np.iscomplexobj(taps):
        impl = "stuff"

    if impl == "stuff":
        inner = fir_stage(taps, decim=1, fft_len=fft_len, name=f"{name}_fir")
        L = inner.frame_multiple                   # hop of the overlap-save core

        def stuff_fn(carry, x):
            up = torch.zeros(x.shape[0] * I, dtype=x.dtype, device=x.device)
            up[::I] = x
            carry, y = inner.fn(carry, up)
            if D > 1:
                y = y[::D].contiguous()
            return carry, y

        # frame n must satisfy: n·I divisible by the overlap-save hop L and by D
        mult = int(np.lcm(L // np.gcd(I, L), D // np.gcd(I, D)))
        return Stage(stuff_fn, inner.init_carry, Fraction(I, D), None, mult, name)

    # output j = Σ_t taps[p_j + I·t]·x[s_j − t], p_j = (j·D) mod I, s_j = ⌊j·D/I⌋;
    # outputs of residue r = j mod I share phase p_r and land on stride-D
    # offsets q·D + c_r, so W[a, s, r] = phase_r[a·D + c_r − s] and
    # y[:, r] = Σ_a rows[m−a : m−a+nq] @ W[a, :, r]
    T = len(taps)
    Kmax = -(-T // I)                   # taps per phase
    ftaps = taps.astype(np.float32)
    c_off = [(r_ * D) // I for r_ in range(I)]
    m = max(1, -(-(Kmax - 1) // D))     # history rows so windows never underflow
    H = m * D
    W_np = np.zeros((m + 1, D, I), np.float32)    # [row shift, col, phase]
    for r_ in range(I):
        phase = ftaps[(r_ * D) % I::I]
        for a in range(m + 1):
            for s in range(D):
                k = a * D + c_off[r_] - s
                if 0 <= k < len(phase):
                    W_np[a, s, r_] = phase[k]
    weights = {}                        # device -> W on that device

    def fn(carry, x):
        hist = carry
        W = weights.get(x.device)
        if W is None:
            W = weights[x.device] = torch.from_numpy(W_np).to(x.device)
        if impl == "pallas":
            y = cuda_kernels.poly_fir(hist, x.contiguous(), W)       # [nq, I]
        else:
            y = _shifted_matvec(torch.cat([hist, x]), W, m, x.shape[0] // D)
        return _tail(hist, x, H), _as_dtype(y.reshape(-1), x.dtype)

    def init_carry(dtype, device):
        return torch.zeros(H, dtype=torch_dtype(dtype), device=torch.device(device))

    def cost(n, dt):
        return _roofline().kernel_cost("poly_fir", n=n, m=m, D=D, I=I,
                                       complex=dt.itemsize == 8)

    return Stage(fn, init_carry, Fraction(I, D), None, D, name, cost=cost,
                 route=(("pallas", None, None) if impl == "pallas" else None))


def decimate_stage(decim: int) -> Stage:
    """Keep every ``decim``-th sample."""
    def fn(carry, x):
        return carry, x[::decim].contiguous()

    return Stage(fn, _stateless, Fraction(1, decim), None, decim, f"decim{decim}")


def rotator_stage(phase_inc: float, name: str = "rotator", impl: str = "xla") -> Stage:
    """Complex rotator ``y[t] = x[t]·exp(i·(ph0 + inc·t))`` with the phase
    carried from frame to frame (reduced mod 2π).

    Carry ``(ph0, inc)``, float32 scalars; the increment rides the carry, so
    ``update(phase_inc=…)`` retunes the next frame with phase continuity.
    ``impl="pallas"`` runs the hand-written ``rotator`` kernel, which reads
    both scalars on the device and writes the next phase, one launch a
    frame; ``"xla"`` (default) the same ramp in PyTorch ops. A real stream
    keeps the real part of the product, as in the JAX package."""
    if impl not in ("xla", "pallas"):
        raise ValueError(f"impl must be xla or pallas, got {impl!r}")

    def fn(carry, x):
        ph0, inc = carry
        n = x.shape[0]
        if impl == "pallas":
            y, new = cuda_kernels.rotator(x.to(torch.complex64).contiguous(), ph0, inc)
        else:
            ph = ph0 + inc * torch.arange(n, dtype=torch.float32, device=x.device)
            y = x * _phasor(ph)
            new = torch.remainder(ph0 + inc * n, 2 * np.pi)
        return (new, inc), _as_dtype(y, x.dtype)

    def init_carry(dtype, device):
        dev = torch.device(device)
        return (torch.zeros((), dtype=torch.float32, device=dev),
                torch.tensor(float(phase_inc), dtype=torch.float32, device=dev))

    def update(carry, phase_inc=None):
        if phase_inc is None:
            return carry
        ph0, _inc = carry
        return (ph0, torch.tensor(float(phase_inc), dtype=torch.float32,
                                  device=ph0.device))

    def cost(n, dt):
        return _roofline().kernel_cost("rotator", n=n)

    return Stage(fn, init_carry, Fraction(1, 1), None, 1, name, update=update, cost=cost,
                 route=(("pallas", None, None) if impl == "pallas" else None))


def quad_demod_stage(gain: float = 1.0, impl: str = "xla") -> Stage:
    """FM discriminator ``gain·angle(x[t]·conj(x[t−1]))`` with a one-sample
    carry (starting at 1+0j). ``impl="pallas"`` runs the hand-written
    ``quad_demod`` kernel (complex64 streams), which also writes the next
    carry; on either route the carry is a tensor of its own, never a view
    of the frame."""
    if impl not in ("xla", "pallas"):
        raise ValueError(f"impl must be xla or pallas, got {impl!r}")

    def fn(carry, x):
        if impl == "pallas":
            y, last = cuda_kernels.quad_demod(carry, x.contiguous(), gain)
            return last, y
        prev = torch.cat([carry.reshape(1), x[:-1]])
        y = gain * torch.angle(x * torch.conj(prev))
        return x[-1].clone(), y.to(torch.float32)

    def init_carry(dtype, device):
        return torch.ones((), dtype=torch_dtype(dtype), device=torch.device(device))

    def cost(n, dt):
        return _roofline().kernel_cost("quad_demod", n=n)

    return Stage(fn, init_carry, Fraction(1, 1), np.float32, 1, "quad_demod", cost=cost,
                 route=(("pallas", None, None) if impl == "pallas" else None))


def xlating_fir_stage(taps, phase_inc: float, decim: int,
                      name: str = "xlating") -> Stage:
    """Frequency-translating decimating FIR as one stage, the rotator folded
    into the filter:

        y[q] = Σ_t h[t]·e^{jθ(qD−t)}·x[qD−t] = e^{jθDq} · Σ_t (h[t]e^{−jθt})·x[qD−t]

    so the filter runs with complex taps ``h[t]e^{−jθt}`` on
    :func:`_shifted_matvec` (plain matmuls, as in the JAX package) and only a
    residual rotator at the decimated rate remains.

    Carry ``(W c64, base f32, ph0, inc_d, th_hi, th_lo, hist)``: the exact θ
    rides as a float32 hi/lo pair, so ``update(taps=…)`` rebuilds the
    weights at the exact θ; ``update(phase_inc=…)`` swaps the weights and the
    residual increment at once, the phase staying continuous."""
    D = int(decim)
    base0 = np.real(np.asarray(taps)).astype(np.float32)
    nt = len(base0)
    m = max(1, -(-(nt - 1) // D))
    H = m * D

    def _weights(base: np.ndarray, theta: float) -> np.ndarray:
        ct = (base * np.exp(-1j * theta * np.arange(nt))).astype(np.complex64)
        return _poly_decim_weights(ct, D, m)

    def _theta_split(theta: float):
        hi = np.float32(theta)
        return hi, np.float32(theta - float(hi))

    def _f32(v, device) -> torch.Tensor:
        return torch.tensor(float(np.float32(v)), dtype=torch.float32, device=device)

    def fn(carry, x):
        W, base, ph0, inc_d, th_hi, th_lo, hist = carry
        nq = x.shape[0] // D
        y = _shifted_matvec(torch.cat([hist, x]), W, m, nq)
        ph = ph0 + inc_d * torch.arange(nq, dtype=torch.float32, device=x.device)
        y = y * _phasor(ph)
        ph_new = torch.remainder(ph0 + inc_d * nq, 2 * np.pi)
        return (W, base, ph_new, inc_d, th_hi, th_lo, _tail(hist, x, H)), \
            _as_dtype(y, x.dtype)

    def init_carry(dtype, device):
        dev = torch.device(device)
        hi, lo = _theta_split(float(phase_inc))
        return (torch.from_numpy(_weights(base0, float(phase_inc))).to(dev),
                torch.from_numpy(base0.copy()).to(dev),
                torch.zeros((), dtype=torch.float32, device=dev),
                _f32(float(phase_inc) * D, dev), _f32(hi, dev), _f32(lo, dev),
                torch.zeros(H, dtype=torch_dtype(dtype), device=dev))

    def update(carry, phase_inc=None, taps=None):
        W, base, ph0, inc_d, th_hi, th_lo, hist = carry
        dev = hist.device
        nbase = base.cpu().numpy().astype(np.float32)
        if taps is not None:
            new = np.asarray(taps)
            if len(new) != nt:
                raise ValueError(f"tap swap must keep the tap count ({nt}); "
                                 f"got {len(new)}")
            if np.iscomplexobj(new):
                raise ValueError("xlating stage taps are the REAL base lowpass; "
                                 "the translation rides phase_inc")
            nbase = new.astype(np.float32)
            base = torch.from_numpy(nbase.copy()).to(dev)
        if phase_inc is not None:
            theta = float(phase_inc)
            hi, lo = _theta_split(theta)
            inc_d, th_hi, th_lo = _f32(theta * D, dev), _f32(hi, dev), _f32(lo, dev)
        else:
            theta = float(th_hi) + float(th_lo)
        W = torch.from_numpy(_weights(nbase, theta)).to(dev)
        return (W, base, ph0, inc_d, th_hi, th_lo, hist)

    return Stage(fn, init_carry, Fraction(1, D), None, D, name, update=update)


# ---------------------------------------------------------------------------
# the PFB channelizer and the other single-chain stages
# ---------------------------------------------------------------------------

def fftshift_stage(n: int) -> Stage:
    def fn(carry, x):
        return carry, torch.fft.fftshift(x.reshape(-1, n), dim=1).reshape(-1)

    return Stage(fn, _stateless, Fraction(1, 1), None, n, "fftshift")


def log10_stage(scale: float = 10.0, floor: float = 1e-20) -> Stage:
    def fn(carry, x):
        return carry, (scale * torch.log10(torch.clamp_min(x, floor))).to(torch.float32)

    return Stage(fn, _stateless, Fraction(1, 1), np.float32, 1, "log10")


def apply_stage(f: Callable[[torch.Tensor], torch.Tensor], out_dtype=None,
                name: str = "apply") -> Stage:
    """Arbitrary elementwise function of the frame tensor (1:1)."""

    def fn(carry, x):
        return carry, f(x)

    return Stage(fn, _stateless, Fraction(1, 1), out_dtype, 1, name)


def _pfb_matmul(hist: torch.Tensor, x: torch.Tensor, Hc: torch.Tensor) -> torch.Tensor:
    """The channelizer's ``matmul`` route: the windows stack
    ``windows[s, k, c] = rows[s + K−1−k, c]`` over the commutated rows, the
    branch MAC as one einsum with the ``[N, K]`` taps, then ``ifft·N`` across
    branches. Returns ``[t, N]`` complex64."""
    N, K = Hc.shape
    t = x.shape[0] // N
    rows = torch.cat([hist, x]).to(torch.complex64).reshape(-1, N).flip(1)
    windows = torch.stack([rows[K - 1 - k:K - 1 - k + t] for k in range(K)], dim=1)
    v = torch.einsum("tkc,ck->tc", windows, Hc.to(torch.complex64))
    return torch.fft.ifft(v, dim=1) * N


def channelizer_stage(n_channels: int, taps=None, name: str = "channelizer",
                      impl: str = "auto", precision: Optional[str] = None) -> Stage:
    """Critically sampled PFB analysis bank: frames of t·N complex samples →
    t·N outputs, channel-interleaved (``[t, N]`` flattened; feed a
    ``StreamDeinterleaver(N)`` to split). Channel ``c`` carries the band
    centred at ``c/N`` of the input rate.

    ``impl="matmul"``: :func:`_pfb_matmul` (windows stack, einsum, then
    ``torch.fft.ifft·N``). ``impl="pallas"``: the hand-written ``pfb`` kernel
    (:func:`cuda_kernels.pfb`), branch MAC and IDFT in one kernel, so the
    branch bank never reaches device memory. ``impl="auto"`` takes the kernel
    when the carry lies on a CUDA device and the ``matmul`` route on the CPU —
    the counterpart of the JAX package's "pallas on the TPU backend".
    ``precision="bf16"`` carries the branch taps in bfloat16; the kernel then
    runs its bf16 mode, the ``matmul`` route computes in float32 with the
    bf16 taps (as the JAX package's matmul route does off the TPU).

    Carry ``(branch [N, K], hist [(K−1)·N])``, leaf for leaf the JAX stage's;
    ``update(taps=…)`` swaps the prototype (same K) with frames in flight.
    """
    if impl not in ("auto", "matmul", "pallas"):
        raise ValueError(f"impl must be auto, matmul or pallas, got {impl!r}")
    if precision == "int8":
        raise ValueError("channelizer_stage has no int8 form (its lower hook declines "
                         "the rung; the JAX stage computes float32 under it): use "
                         "precision='bf16' or None")
    if precision not in (None, "f32", "bf16"):
        raise ValueError(f"precision must be None, 'f32' or 'bf16', got {precision!r}")
    N = int(n_channels)
    if taps is None:
        from ..blocks.pfb import pfb_default_taps
        taps = pfb_default_taps(N)
    taps = np.asarray(taps, dtype=np.float32)
    K = -(-len(taps) // N)
    H = (K - 1) * N
    use_kernel = impl == "pallas"

    def _branch(t: np.ndarray, device) -> torch.Tensor:
        padded = np.zeros(K * N, dtype=np.float32)
        padded[:len(t)] = t
        b = torch.from_numpy(np.ascontiguousarray(padded.reshape(K, N).T))   # [N, K]
        if precision == "bf16":
            b = b.to(torch.bfloat16)            # carried taps: half the bytes
        return b.to(device)

    def fn(carry, x):
        Hc, hist = carry
        if use_kernel or (impl == "auto" and Hc.device.type == "cuda"):
            y = cuda_kernels.pfb(hist.to(torch.complex64),
                                 x.to(torch.complex64).contiguous(), Hc.t(),
                                 precision=precision)
        else:
            y = _pfb_matmul(hist, x, Hc)
        return (Hc, _tail(hist, x, H)), y.reshape(-1)

    def init_carry(dtype, device):
        dev = torch.device(device)
        return (_branch(taps, dev), torch.zeros(H, dtype=torch_dtype(dtype), device=dev))

    def update(carry, taps=None):
        """Swap the prototype with frames in flight: the same taps a branch
        (K), real; the history is kept."""
        if taps is None:
            return carry
        new = np.asarray(taps)
        if np.iscomplexobj(new) or -(-len(new) // N) != K:
            raise ValueError(f"tap swap must keep {K} real taps a branch "
                             f"({(K - 1) * N + 1}..{K * N} taps); got {len(new)} — "
                             f"rebuild the stage for a different prototype")
        Hc, hist = carry
        return (_branch(new.astype(np.float32), Hc.device), hist)

    def _lower(p: str) -> Optional[Stage]:
        if p != "bf16":
            return None
        return channelizer_stage(N, taps, name, impl=impl, precision="bf16")

    def cost(n, dt):
        return _roofline().kernel_cost("pfb", n=n, N=N, K=K,
                                       tap_bytes=2 if precision == "bf16" else 4)

    return Stage(fn, init_carry, Fraction(1, 1), np.complex64, N, name, update=update,
                 lower=_lower, compute_dtype=_compute_dtype(precision), cost=cost,
                 route=(impl, None, precision), history=H)


def lora_demod_stage(sf: int, name: str = "lora_demod") -> Stage:
    """LoRa dechirp + batched FFT + argmax: frames of k·2^sf complex chips →
    k int32 symbol values."""
    n = 1 << sf
    k_idx = np.arange(n)
    ph = 2 * np.pi * ((k_idx * k_idx) / (2 * n) + k_idx * (-0.5))
    down = np.exp(-1j * ph).astype(np.complex64)    # conj(upchirp)
    chirps = {}                                     # device -> downchirp tensor

    def fn(carry, x):
        d = chirps.get(x.device)
        if d is None:
            d = chirps[x.device] = torch.from_numpy(down).to(x.device)
        spec = torch.fft.fft(x.reshape(-1, n) * d[None, :], dim=1).abs()
        return carry, torch.argmax(spec, dim=1).to(torch.int32)

    return Stage(fn, _stateless, Fraction(1, n), np.int32, n, name)


def agc_stage(reference: float = 1.0, rate: float = 0.1, block: int = 256,
              max_gain: float = 65536.0) -> Stage:
    """Block-floating AGC: the mean magnitude of each ``block`` samples drives
    the gain, ``g ← clip(g + rate·(reference − m·g), 0, max_gain)``, one step
    a block (a loop over the frame's blocks, as the JAX stage's ``lax.scan``);
    each block is scaled by its updated gain. Carry: the running gain."""

    def fn(carry, x):
        xb = x.reshape(-1, block)
        mags = xb.abs().mean(dim=1)
        g, gains = carry, []
        for m in mags:
            g = torch.clamp(g + rate * (reference - m * g), 0.0, max_gain)
            gains.append(g)
        gains = torch.stack(gains) if gains else mags
        return g, (xb * gains[:, None]).reshape(-1).to(x.dtype)

    def init_carry(dtype, device):
        return torch.ones((), dtype=torch.float32, device=torch.device(device))

    return Stage(fn, init_carry, Fraction(1, 1), None, block, "agc")


def moving_avg_stage(frame_len: int, decay: float = 0.1) -> Stage:
    """EMA across rows of ``frame_len`` items (spectrum smoothing), carried
    across frames: ``c ← c·(1 − decay) + row·decay``, one step a row, each
    row's output the updated ``c``. Carry: the EMA."""

    def fn(carry, x):
        c, outs = carry, []
        for row in x.reshape(-1, frame_len):
            c = c * (1.0 - decay) + row * decay
            outs.append(c)
        return c, (torch.stack(outs).reshape(-1) if outs else x[:0].to(torch.float32))

    def init_carry(dtype, device):
        return torch.zeros(frame_len, dtype=torch.float32, device=torch.device(device))

    return Stage(fn, init_carry, Fraction(1, 1), np.float32, frame_len, "moving_avg")
