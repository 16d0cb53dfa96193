"""Interior precision on the CPU against the JAX package: the planner's
verdicts, the lowered outputs, the int8 rungs, and the kernel's retune and
checkpoint contract (the port's counterparts of ``tests/test_precision.py``).

The same seeded numpy inputs go through ``futuresdr_tpu.ops.precision`` and
``futuresdr_tpu_torch.ops.precision``. Tolerances:

* verdicts: equal, stage by stage (accumulation, edge, the refusal's reason
  class), and the same number lowered;
* a lowered output against the float32 one: 37 dB (the reference's own
  ``auto`` chain tolerance), the int8 rungs 25 dB (the reference's);
* a lowered output against the JAX package's lowered output: 37 dB, the
  ``fir_fft`` bf16 rung 40 dB and the PFB's 54.5 dB (ROADMAP Queue 3's bf16
  floors of the kernels against their plain versions);
* the int8 rungs against the JAX package's: equal accumulators (outputs
  within the dequantizing product's rounding, 1e-6 of the peak), or an
  entry off by at most one step (1/127 of the peak) where a float32 quotient
  rounds to the other integer, in at most 1% of the entries.
"""

import re
import time
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from futuresdr_tpu.ops import precision as JP
from futuresdr_tpu.ops import stages as J
from futuresdr_tpu_torch import Kernel
from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
from futuresdr_tpu_torch.config import config
from futuresdr_tpu_torch.ops import precision as TP
from futuresdr_tpu_torch.ops import stages as T
from futuresdr_tpu_torch.runtime import Flowgraph, Runtime
from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
from futuresdr_tpu_torch.tpu.autotune import (cached_interior_precision,
                                              record_interior_precision)
from futuresdr_tpu_torch.types import Pmt
from tests.test_torch_ctrl_port import _gated_source

torch.set_num_threads(1)

CPU = TpuInstance("cpu")
HANN64 = (np.hanning(64) / np.hanning(64).sum()).astype(np.float32)
HANN128 = (np.hanning(128) / np.hanning(128).sum()).astype(np.float32)
HANN32 = (np.hanning(32) / np.hanning(32).sum()).astype(np.float32)


@pytest.fixture(autouse=True)
def _clean_cache():
    """The streamed-pick cache and the published plans are the process's:
    leave them as found."""
    import importlib
    at = importlib.import_module("futuresdr_tpu_torch.tpu.autotune")
    yield
    at._streamed_cache.clear()
    TP.clear_plans()


def _frames(n, seed=0, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        return ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) / np.sqrt(2)).astype(dtype)
    return rng.standard_normal(n).astype(dtype)


def _snr(ref, got) -> float:
    return TP.snr_db(np.asarray(ref), np.asarray(got))


# ---------------------------------------------------------------------------
# the chains, built in either package
# ---------------------------------------------------------------------------

def _noise(M, name, snr_db, phase=0.0):
    """An identity stage whose bf16 candidate adds a fixed noise vector at
    ``snr_db`` under unit power (``tests/test_precision.py``'s vehicle)."""
    eps = 10.0 ** (-snr_db / 20.0)
    if M is J:
        def lfn(c, x):
            i = jnp.arange(x.shape[0], dtype=jnp.float32)
            n = jnp.sin(12.9898 * i + phase)
            n = n / jnp.sqrt(jnp.mean(n * n))
            return c, x + eps * n.astype(x.dtype)

        def lower(p):
            return None if p != "bf16" else J.Stage(
                lfn, lambda d: jnp.zeros(()), Fraction(1, 1), None, 1, name,
                compute_dtype="bf16")
        return J.Stage(lambda c, x: (c, x), lambda d: jnp.zeros(()), Fraction(1, 1), None,
                       1, name, lower=lower)

    def tfn(c, x):
        i = torch.arange(x.shape[0], dtype=torch.float32, device=x.device)
        n = torch.sin(12.9898 * i + phase)
        n = n / torch.sqrt(torch.mean(n * n))
        return c, x + eps * n.to(x.dtype)

    def tlower(p):
        return None if p != "bf16" else T.Stage(tfn, T._stateless, Fraction(1, 1), None, 1,
                                                name, compute_dtype="bf16")
    return T.Stage(lambda c, x: (c, x), T._stateless, Fraction(1, 1), None, 1, name,
                   lower=tlower)


_JIT_STAGES: dict = {}


def _jitted(s):
    """A JAX stage (and its lowered forms, built once each) with ``fn``
    under ``jax.jit``: the same arithmetic, compiled once a shape instead of
    interpreting the Pallas kernel op by op on every eager call."""
    from dataclasses import replace
    low, rungs = s.lower, {}

    def lower(p):
        if p not in rungs:
            c = low(p)
            rungs[p] = None if c is None else _jitted(c)
        return rungs[p]

    return replace(s, fn=jax.jit(s.fn), lower=None if low is None else lower)


def _merge(M):
    if M is J:
        return J.MergeStage(lambda c, xs: (c, xs[0] + xs[1]), lambda d: jnp.zeros(()), k=2,
                            name="sum")
    return T.MergeStage(lambda c, xs: (c, xs[0] + xs[1]), T._stateless, k=2, name="sum")


def _chain(M, name):
    if name == "spectrum":
        return M.Pipeline([M.fir_stage(HANN64, fft_len=2048, name="fir"),
                           M.fft_stage(2048)], np.complex64)
    if name == "spectrum_mag2":
        return M.Pipeline([M.fir_stage(HANN64, fft_len=2048, name="fir"),
                           M.fft_stage(2048), M.mag2_stage()], np.complex64)
    if name == "decim_noise":
        return M.Pipeline([M.fir_stage(HANN128, decim=16, name="dec"),
                           _noise(M, "nz", 50.0)], np.complex64)
    if name == "fanout":
        return M.FanoutPipeline([M.fir_stage(HANN32, name="prod")],
                                [[M.fft_stage(256)], [M.mag2_stage()]], np.complex64)
    if name == "dag":
        return M.DagPipeline([([M.fir_stage(np.hanning(16).astype(np.float32) / 8,
                                            name="prod")], []),
                              ([M.fft_stage(256)], [0]),
                              ([M.fft_stage(256, direction="inverse")], [0]),
                              ([_merge(M)], [1, 2])], np.complex64)
    if name == "pfb":
        return M.Pipeline([M.channelizer_stage(64, impl="matmul", name="pfb"),
                           M.mag2_stage()], np.complex64)
    if name == "fir_fft":
        if M is T:
            ff = T.fir_fft_stage(HANN64, 2048, name="ff")
        else:
            ff = _JIT_STAGES.get("ff") or _JIT_STAGES.setdefault(
                "ff", _jitted(J.fir_fft_stage(HANN64, 2048, name="ff")))
        return M.Pipeline([ff, M.mag2_stage()], np.complex64)
    raise ValueError(name)


MODES = {"auto": dict(mode="auto", budget_db=40.0), "auto200": dict(mode="auto", budget_db=200.0),
         "bf16": dict(mode="bf16"), "int8": dict(mode="int8"),
         "override": dict(mode="bf16", overrides={"fir": "off"})}
CASES = [("spectrum", m) for m in MODES] + \
    [("spectrum_mag2", "int8")] + \
    [("decim_noise", m) for m in ("auto", "auto200", "bf16", "int8")] + \
    [(c, m) for c in ("fanout", "dag", "pfb", "fir_fft") for m in ("auto", "bf16")]


def _cls(reason):
    return None if reason is None else re.split("[<:]", reason)[0]


def _verdicts(plan):
    return [(e.stage, e.node, e.index, e.accum, e.edge, _cls(e.declined)) for e in plan.edges]


def _plans(chain, mode):
    jl, jplan = JP.plan_interior_precision(_chain(J, chain), **MODES[mode])
    tp = _chain(T, chain)
    tl, tplan = TP.plan_interior_precision(tp, device="cpu", **MODES[mode])
    return tp, tl, tplan, jl, jplan


@pytest.mark.parametrize("chain,mode", CASES)
def test_planner_makes_the_reference_verdicts(chain, mode):
    _tp, _tl, tplan, _jl, jplan = _plans(chain, mode)
    assert _verdicts(tplan) == _verdicts(jplan)
    assert tplan.lowered == jplan.lowered
    assert tplan.declined_e2e == jplan.declined_e2e
    # the measured SNRs agree (the same math on the same frames; inf where
    # exact) within 0.5 dB; the fir_fft bf16 rung within 1.5 dB: its twiddles
    # stay float32 in the port's kernel, the JAX kernel rounds its DFT matrix
    tol = 1.5 if chain == "fir_fft" else 0.5
    for te, je in zip(tplan.edges, jplan.edges):
        for a, b in ((te.accum_snr_db, je.accum_snr_db), (te.edge_snr_db, je.edge_snr_db)):
            assert (a is None) == (b is None)
            if a is not None and np.isfinite(b):
                assert a == pytest.approx(b, abs=tol)


def test_off_returns_the_same_object():
    p = _chain(T, "spectrum")
    low, plan = TP.plan_interior_precision(p, mode="off", device="cpu")
    assert low is p and plan.mode == "off" and plan.lowered == 0
    assert TP.plan_interior_precision(p, device="cpu")[0] is p     # config default: off
    with pytest.raises(ValueError):
        TP.plan_interior_precision(p, mode="int4", device="cpu")
    assert TP.parse_overrides("fir=off;fft2048=bf16") == {"fir": "off", "fft2048": "bf16"}
    with pytest.raises(ValueError):
        TP.parse_overrides("fir=fp8")


def _run_t(pipe, x, frame):
    c, outs = pipe.init_carry("cpu"), []
    fn = pipe.fn()
    for i in range(0, len(x), frame):
        c, y = fn(c, torch.from_numpy(x[i:i + frame]))
        outs.append(y)
    if isinstance(outs[0], tuple):
        return [np.concatenate([o[j].numpy() for o in outs]) for j in range(len(outs[0]))]
    return [np.concatenate([o.numpy() for o in outs])]


def _run_j(pipe, x, frame):
    fn, c = pipe.fn(), pipe.init_carry()
    outs = []
    for i in range(0, len(x), frame):
        c, y = fn(c, jnp.asarray(x[i:i + frame]))
        outs.append(y)
    if isinstance(outs[0], tuple):
        return [np.concatenate([np.asarray(o[j]) for o in outs]) for j in range(len(outs[0]))]
    return [np.concatenate([np.asarray(o) for o in outs])]


@pytest.mark.parametrize("chain,mode,floor", [
    ("spectrum", "auto", 37.0), ("fanout", "auto", 37.0), ("dag", "bf16", 37.0),
    ("fir_fft", "bf16", 40.0), ("pfb", "bf16", 54.5)])
def test_lowered_outputs_hold_against_float32_and_the_reference(chain, mode, floor):
    tp, tl, tplan, jl, _jplan = _plans(chain, mode)
    assert tplan.lowered >= 1
    x = _frames(4 * 4096, seed=3)
    ref = _run_t(tp, x, 4096)
    got = _run_t(tl, x, 4096)
    jgot = _run_j(jl, x, 4096)
    for r, g, j in zip(ref, got, jgot):
        assert _snr(r, g) >= 37.0
        assert _snr(j, g) >= floor


def test_auto_plan_clears_the_end_to_end_floor():
    _tp, _tl, plan, _jl, jplan = _plans("spectrum", "auto")
    assert plan.lowered == 2 and not plan.declined_e2e
    assert plan.e2e_snr_db >= 40.0 - 10 * np.log10(plan.lowered)
    assert plan.min_snr_db is not None and plan.min_snr_db >= 40.0
    assert plan.e2e_snr_db == pytest.approx(jplan.e2e_snr_db, abs=0.01)


@pytest.mark.parametrize("phases,declined", [((1.0, 1.0, 1.0, 1.0), True), ((1.0, 40.7), False)])
def test_end_to_end_guard_as_the_reference(phases, declined):
    """Coherent noise in four stages composes past the incoherent allowance
    and the plan rolls back; independent noise in two stays inside it."""
    budget = 60.0
    tp = T.Pipeline([_noise(T, f"n{i}", budget + 3.0, ph) for i, ph in enumerate(phases)],
                    np.float32)
    jp = J.Pipeline([_noise(J, f"n{i}", budget + 3.0, ph) for i, ph in enumerate(phases)],
                    np.float32)
    tl, plan = TP.plan_interior_precision(tp, mode="auto", budget_db=budget, device="cpu")
    _jl, jplan = JP.plan_interior_precision(jp, mode="auto", budget_db=budget)
    assert plan.declined_e2e is declined is jplan.declined_e2e
    assert (tl is tp) is declined
    assert _verdicts(plan) == _verdicts(jplan)


# ---------------------------------------------------------------------------
# the int8 rungs
# ---------------------------------------------------------------------------

def _int8_pair(decim, impl, n=4 * 4096, seed=31):
    taps = HANN64 if decim == 1 else HANN128
    x = _frames(n, seed=seed)
    t_f32 = T.Pipeline([T.fir_stage(taps, decim=decim, impl=impl)], np.complex64)
    t8 = T.Pipeline([T.fir_stage(taps, decim=decim, impl=impl, precision="int8")],
                    np.complex64)
    j8 = J.Pipeline([J.fir_stage(taps, decim=decim, impl=impl, precision="int8")],
                    np.complex64)
    return x, _run_t(t_f32, x, 4096)[0], _run_t(t8, x, 4096)[0], _run_j(j8, x, 4096)[0]


@pytest.mark.parametrize("decim,impl", [(1, "auto"), (16, "poly"), (16, "pallas")])
def test_int8_rungs_match_the_reference(decim, impl):
    """The banded int8 matmul (decim 1) and the int8 shifted matvec
    (decim 16, on either impl: the kernel has no int8 mode) against the JAX
    package's: equal, or off by at most one accumulator step where a
    quotient rounds to the other integer, in at most 1% of the entries; and
    the quantization band against float32 (25 dB, the reference's)."""
    _x, f32, got, ref = _int8_pair(decim, impl)
    assert _snr(f32, got) >= 25.0
    diff = np.abs(got - ref)
    peak = float(np.max(np.abs(ref)))
    # equal accumulators differ only by the dequantizing product's rounding
    # (a few float32 ulps of the peak); a differing accumulator by at least
    # one step of it, at most one step of the output's 127 levels
    stepped = diff > 1e-6 * peak
    assert np.count_nonzero(stepped) <= 0.01 * diff.size
    assert float(np.max(diff, initial=0.0)) <= peak / 127.0


def test_int8_carry_is_the_float32_stages():
    """The int8 rungs quantize on the device: their carries are the float32
    stages' leaf for leaf (the brownout and checkpoint contract)."""
    for mk in (lambda p: T.fir_stage(HANN64, precision=p),
               lambda p: T.fir_stage(HANN128, decim=16, impl="poly", precision=p)):
        a = T._leaves(T.Pipeline([mk(None)], np.complex64).init_carry("cpu"))
        b = T._leaves(T.Pipeline([mk("int8")], np.complex64).init_carry("cpu"))
        assert [(t.shape, t.dtype) for t in a] == [(t.shape, t.dtype) for t in b]
    low, plan = TP.plan_interior_precision(_chain(T, "spectrum_mag2"), mode="int8",
                                           device="cpu")
    assert {s.name: s.compute_dtype for s in low.stages}["fir"] == "int8"
    assert TP.pallas_stage_count(low, device="cpu") == 0
    assert TP.dominant_compute_dtype(low) == "int8"


def test_lowered_poly_fir_carries_bf16_weights():
    p = T.Pipeline([T.fir_stage(HANN128, decim=16, name="dec")], np.complex64)
    low, plan = TP.plan_interior_precision(p, mode="bf16", device="cpu")
    assert plan.lowered == 1
    assert torch.bfloat16 in {t.dtype for t in T._leaves(low.init_carry("cpu"))}


# ---------------------------------------------------------------------------
# the kernel: retune and checkpoints
# ---------------------------------------------------------------------------

def _kernel_run(x, frame, stages=None, **kw):
    fg = Flowgraph()
    tk = TpuKernel(stages or list(_chain(T, "spectrum").stages), np.complex64,
                   frame_size=frame, inst=CPU, **kw)
    snk = VectorSink(np.complex64)
    fg.connect(VectorSource(x), tk, snk)
    Runtime().run(fg)
    return np.asarray(snk.items()), tk


def test_kernel_off_bit_identical_and_auto_within_budget():
    x = _frames(1 << 15, seed=11)
    y_default, _ = _kernel_run(x, 8192)
    y_off, tk_off = _kernel_run(x, 8192, interior_precision="off")
    np.testing.assert_array_equal(y_default, y_off)
    assert tk_off._precision_plan is None
    assert tk_off.extra_metrics()["interior_precision"] == "off"
    y_auto, tk = _kernel_run(x, 8192, interior_precision="auto")
    assert tk._precision_plan.lowered == 2 and tk.extra_metrics()["interior_lowered"] == 2
    assert _snr(y_off, y_auto) >= 37.0
    hit = [v for v in TP.plans_report().values() if v["mode"] == "auto"]
    assert hit and hit[-1]["lowered"] == 2


def test_precision_retune_preinit_scopes_to_named_stage():
    tk = TpuKernel(list(_chain(T, "spectrum").stages), np.complex64, frame_size=8192,
                   inst=CPU, interior_precision="off")
    tk.apply_precision_retune("fft2048", "bf16")
    d = {e.stage: e for e in tk._precision_plan.edges}
    assert d["fft2048"].accum == "bf16"
    assert d["fir"].accum == "f32" and d["fir"].edge == "f32" and d["fir"].declined == "override"
    with pytest.raises(ValueError):
        tk.apply_precision_retune("fir", "fp8")
    with pytest.raises(KeyError):
        tk.apply_precision_retune("nope", "bf16")


def test_precision_retune_rejects_ambiguous_name():
    stages = [T.fir_stage(HANN32, name="f"), T.mag2_stage(), T.fir_stage(HANN32, name="f")]
    tk = TpuKernel(stages, np.complex64, frame_size=8192, inst=CPU)
    with pytest.raises(KeyError, match="ambiguous"):
        tk.apply_precision_retune("f", "bf16")


def test_noop_retune_keeps_off_mode_and_program():
    tk = TpuKernel(list(_chain(T, "spectrum").stages), np.complex64, frame_size=8192,
                   inst=CPU, interior_precision="off")
    pipe = tk.pipeline
    tk.apply_precision_retune("fir", "off")
    assert tk.pipeline is pipe and tk._precision_mode == "off"
    assert tk.extra_metrics()["interior_precision"] == "off"
    assert tk._precision_overrides["fir"] == "off"


def _wait(cond, timeout=30.0):
    t0 = time.perf_counter()
    while not cond() and time.perf_counter() - t0 < timeout:
        time.sleep(0.01)
    assert cond()


def test_widening_retune_restores_pristine_parameters():
    """A mid-stream ``ctrl`` retune bf16 → off lands at a quiescent boundary
    (every frame emitted once, in order), recaptures once, and takes the
    widened weight leaf from the pristine float32 build, never an upcast of
    its bf16 values."""
    n = 1 << 16
    x = _frames(n, seed=41)
    fg = Flowgraph()
    src = _gated_source(Kernel, x)
    tk = TpuKernel([T.fir_stage(HANN128, decim=16, name="dec")], np.complex64,
                   frame_size=8192, inst=CPU, frames_in_flight=2, interior_precision="bf16")
    snk = VectorSink(np.complex64)
    fg.connect(src, tk, snk)
    running = Runtime().start(fg)
    src.release(n // 4)
    _wait(lambda: len(snk.items()) == n // 64)
    r = running.handle.call_sync(tk, "ctrl", Pmt.map({"stage": "dec",
                                                      "interior_precision": "off"}))
    assert r == Pmt.ok()
    src.release(n)
    running.wait_sync()
    assert len(snk.items()) == n // 16
    assert tk.precision_switches == 1 and tk._precision_mode == "bf16"
    ref = {t.numpy().tobytes() for t in T._leaves(tk._base_pipeline.init_carry("cpu"))
           if t.dtype == torch.float32 and t.dim() == 2}
    got = [t for t in T._leaves(tk._carry) if t.dim() == 2]
    assert got and all(t.dtype == torch.float32 and t.numpy().tobytes() in ref for t in got)


def test_kernel_init_corrects_stale_precision_axis():
    stages = list(_chain(T, "spectrum").stages)
    record_interior_precision(stages, np.complex64, "cpu", "bf16")
    _y, tk = _kernel_run(_frames(1 << 14, seed=43), 8192, stages=stages,
                         interior_precision="off")
    assert cached_interior_precision(stages, np.complex64, "cpu") == "off"
    other = [T.fir_stage(HANN32, name="solo")]
    _kernel_run(_frames(1 << 14, seed=43), 8192, stages=other, interior_precision="off")
    assert cached_interior_precision(other, np.complex64, "cpu") is None


def _stream(pipe, x, frame, c=None):
    c = pipe.init_carry("cpu") if c is None else c
    fn, outs = pipe.fn(), []
    for i in range(0, len(x), frame):
        c, y = fn(c, torch.from_numpy(x[i:i + frame]))
        outs.append(y.numpy())
    return outs, c


def test_lowered_checkpoint_replay_bit_identical():
    frame = 8192
    x = _frames(4 * frame, seed=9)
    p = T.Pipeline([T.fir_stage(HANN128, decim=16, name="dec"), T.fft_stage(256)],
                   np.complex64)
    low, _plan = TP.plan_interior_precision(p, mode="bf16", device="cpu")
    ref, _ = _stream(low, x, frame)
    first, c = _stream(low, x[:2 * frame], frame)
    fetches, spec = low.snapshot_carry(c)
    leaves = [f() for f in fetches]
    assert low.carry_matches(leaves, spec, low.init_carry("cpu"))
    rest, _ = _stream(low, x[2 * frame:], frame, low.restore_carry(leaves, spec, "cpu"))
    np.testing.assert_array_equal(np.concatenate(first + rest), np.concatenate(ref))


def test_mismatched_dtype_checkpoint_rejected():
    p = T.Pipeline([T.fir_stage(HANN128, decim=16, name="dec")], np.complex64)
    low, _plan = TP.plan_interior_precision(p, mode="bf16", device="cpu")
    _outs, c = _stream(p, _frames(8192), 8192)
    fetches, spec = p.snapshot_carry(c)
    leaves = [f() for f in fetches]
    assert p.carry_matches(leaves, spec, p.init_carry("cpu"))
    assert not low.carry_matches(leaves, spec, low.init_carry("cpu"))


def test_retuned_kernel_checkpoints_the_lowered_carry():
    """With checkpoints on, a precision switch commits the converted carry
    as the only restore point: a checkpoint holds a lowered carry's dtypes,
    and one of the old program would not fit the new one."""
    tk = TpuKernel([T.fir_stage(HANN128, decim=16, name="dec")], np.complex64,
                   frame_size=8192, inst=CPU, checkpoint_every=1)
    n = 6 * 8192
    fg = Flowgraph()
    src = _gated_source(Kernel, _frames(n, seed=5))
    snk = VectorSink(np.complex64)
    fg.connect(src, tk, snk)
    running = Runtime().start(fg)
    src.release(2 * 8192)
    _wait(lambda: len(snk.items()) == 2 * 8192 // 16)
    tk.apply_precision_retune("dec", "bf16")
    src.release(3 * 8192)
    _wait(lambda: tk.precision_switches == 1)
    seq, leaves, spec = tk._ckpts[0]
    assert seq == 1 and "bfloat16" in str(spec)
    assert tk.pipeline.carry_matches(leaves, spec, tk.pipeline.init_carry("cpu"))
    src.release(n)
    running.wait_sync()
    assert len(snk.items()) == n // 16


# ---------------------------------------------------------------------------
# the ladder's mechanics, declines and stage counts, as the reference's
# ---------------------------------------------------------------------------

def test_non_float_edges_decline():
    """An integer edge (a symbol stream) passes through untouched."""
    sym = T.Stage(lambda c, x: (c, (x.abs() > 0.5).to(torch.int32)), T._stateless,
                  Fraction(1, 1), np.int32, 1, "slice")
    widen = T.Stage(lambda c, x: (c, x.to(torch.float32) * 2.0), T._stateless,
                    Fraction(1, 1), np.float32, 1, "widen")
    _low, plan = TP.plan_interior_precision(T.Pipeline([sym, widen], np.float32),
                                            mode="bf16", device="cpu")
    d = {e.stage: e for e in plan.edges}
    assert d["slice"].declined == "non-float"
    assert d["slice"].accum == "f32" and d["slice"].edge == "f32"


def test_int8_ladder_reaches_declaring_stage(monkeypatch):
    """The int8 rung is tried first where a hook accepts it: a scale-by-2
    stage rebuilt at int8 as an exact integer op measures SNR ∞ on
    int8-exact inputs and is taken at the first rung."""
    def lower(prec):
        if prec not in ("int8", "bf16"):
            return None
        return T.Stage(lambda c, x: (c, (x.to(torch.int8) * 2).to(torch.float32)),
                       T._stateless, Fraction(1, 1), np.float32, 1, "dbl",
                       compute_dtype="bf16")

    dbl = T.Stage(lambda c, x: (c, x * 2.0), T._stateless, Fraction(1, 1), np.float32, 1,
                  "dbl", lower=lower)
    sink = T.Stage(lambda c, x: (c, x + 0.0), T._stateless, Fraction(1, 1), np.float32, 1,
                   "sink")

    def frames(in_dtype, frame, n, seed):
        rng = np.random.default_rng(seed)
        return [rng.integers(-50, 50, frame).astype(np.float32) for _ in range(n)]

    monkeypatch.setattr(TP, "_calib_frames", frames)
    _low, plan = TP.plan_interior_precision(T.Pipeline([dbl, sink], np.float32),
                                            mode="auto", budget_db=40.0, device="cpu")
    assert {e.stage: e for e in plan.edges}["dbl"].accum == "int8"


def test_partial_lowering_not_reported_declined():
    """A stage whose accumulation is refused but whose edge is lowered is
    lowered: no decline reason on it, the refusal readable as accum f32 and
    its SNR (the budget between the 48 dB rung and the ~55 dB edge)."""
    gain = T.Stage(lambda c, x: (c, x * 2.0), T._stateless, Fraction(1, 1), None, 1, "gain")
    _low, plan = TP.plan_interior_precision(
        T.Pipeline([_noise(T, "nz", 48.0), gain], np.float32), mode="auto",
        budget_db=52.0, device="cpu")
    nz = {e.stage: e for e in plan.edges}["nz"]
    assert nz.edge == "bf16" and nz.accum == "f32" and nz.declined is None
    assert nz.accum_snr_db == pytest.approx(48.0, abs=1.5)


@pytest.mark.parametrize("make", [
    lambda M: [M.fir_stage(HANN32, decim=16, impl="pallas", name="d"), M.fft_stage(256)],
    lambda M: [M.channelizer_stage(16, impl="matmul")],
    lambda M: [M.channelizer_stage(16, impl="pallas")],
    lambda M: [M.channelizer_stage(16)],
    lambda M: [M.fir_stage(HANN32[:16])],
    lambda M: [M.fir_fft_stage(HANN32, 256), M.mag2_stage()],
    lambda M: [M.fir_stage(HANN128, decim=16, impl="pallas", precision="int8")],
])
def test_pallas_stage_count_matches_the_reference(make):
    """On the CPU both packages count the stages that run a hand kernel the
    same: forced pins count, ``auto`` routes and int8 rungs do not."""
    for dt in (np.complex64, np.float32):
        if dt == np.float32 and "channelizer" in str(make(T)):
            continue
        assert TP.pallas_stage_count(T.Pipeline(make(T), dt), device="cpu") == \
            JP.pallas_stage_count(J.Pipeline(make(J), dt))
