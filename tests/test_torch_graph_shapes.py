"""The port's graph shapes against the JAX package's, on the CPU.

``MergeStage``'s four factories, ``FanoutPipeline`` and ``DagPipeline``
(``futuresdr_tpu_torch/ops/stages.py``) and their JAX counterparts run the
same seeded numpy frames, carry chained over 3 frames. The rate surfaces
(``branch_out_items``, ``path_ratios``, ``tag_ratios``, ``concat_sinks``,
``frame_multiple``) must be equal exactly; outputs are held at the
tolerances of ``tests/test_torch_stages.py`` for the ops they run: the
overlap-save FIR rtol 1e-4 / atol 1e-5 (and |x|² after it 1e-4 / 1e-4, the
square of an error of 1e-5 on values of order 1), the ``fir`` and
``poly_fir`` kernel routes (interpret-mode Pallas on the JAX side, the plain
versions on the port's) 1e-4 / 1e-5, and a rotator behind a FIR the FIR's.
The merges of exact inputs are exact up to float32 addition (rtol 1e-6). An
``equal`` merge fed at two rates raises ``ValueError`` in both packages. The
multi-output ``Pipeline.compile`` on the CPU (the eager program looped over
K frames) equals ``fn`` over chained frames at K = 1 and 4.
"""

from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

from futuresdr_tpu.dsp import firdes
from futuresdr_tpu.ops import stages as J
from futuresdr_tpu_torch.ops import stages as T

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

T1 = firdes.lowpass(0.25, 48).astype(np.float32)
T2 = firdes.lowpass(0.2, 32).astype(np.float32)
FRAME = 2048
FIR_TOL = dict(rtol=1e-4, atol=1e-5)


def _c64(rng, n):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


def _frames(seed, n=3, frame=FRAME):
    rng = np.random.default_rng(seed)
    return [_c64(rng, frame) for _ in range(n)]


def _run_jax(pipe, frames):
    fn = jax.jit(pipe.fn())
    carry = pipe.init_carry()
    outs = []
    for x in frames:
        carry, ys = fn(carry, jax.numpy.asarray(x))
        outs.append([np.asarray(y) for y in ys])
    return outs


def _run_port(pipe, frames):
    fn = pipe.fn()
    carry = pipe.init_carry("cpu")
    outs = []
    for x in frames:
        carry, ys = fn(carry, torch.from_numpy(x))
        outs.append([y.numpy() for y in ys])
    return outs


def _compare(jp, tp, frames, tols):
    assert tp.frame_multiple == jp.frame_multiple
    assert tp.path_ratios == jp.path_ratios
    assert [np.dtype(d) for d in tp.out_dtypes] == [np.dtype(d) for d in jp.out_dtypes]
    assert tp.n_branches == jp.n_branches
    for j in range(tp.n_branches):
        assert tp.branch_out_items(j, FRAME) == jp.branch_out_items(j, FRAME)
    ya, yb = _run_jax(jp, frames), _run_port(tp, frames)
    for fa, fb in zip(ya, yb):
        for a, b, tol in zip(fa, fb, tols):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_allclose(b, a, **tol)


# ---------------------------------------------------------------------------
# the merge factories
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("factory", ["add", "interleave", "concat", "apply"])
def test_merge_factories_match_jax(factory):
    rng = np.random.default_rng(3)
    k = 3
    frames = [tuple(_c64(rng, 512) for _ in range(k)) for _ in range(3)]

    def make(m):
        return {"add": lambda: m.add_merge_stage(k),
                "interleave": lambda: m.interleave_merge_stage(k),
                "concat": lambda: m.concat_merge_stage(k),
                "apply": lambda: m.apply_merge_stage(lambda a, b, c: a * b - c, k)}[factory]()

    jm, tm = make(J), make(T)
    assert (tm.k, tm.mode, tm.ratio, tm.frame_multiple, tm.out_dtype) == \
        (jm.k, jm.mode, jm.ratio, jm.frame_multiple, jm.out_dtype)
    jc, tc = jm.init_carry(np.complex64), tm.init_carry(np.complex64, torch.device("cpu"))
    for xs in frames:
        jc, a = jm.fn(jc, tuple(jax.numpy.asarray(x) for x in xs))
        tc, b = tm.fn(tc, tuple(torch.from_numpy(x) for x in xs))
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)


def test_merge_stage_rejects_one_input_and_an_unknown_mode():
    with pytest.raises(ValueError):
        T.add_merge_stage(1)
    with pytest.raises(ValueError):
        T.MergeStage(lambda c, xs: (c, xs[0]), T.add_merge_stage(2).init_carry, 2,
                     mode="zip")


# ---------------------------------------------------------------------------
# FanoutPipeline
# ---------------------------------------------------------------------------

def _fanout(m, impl="os"):
    return m.FanoutPipeline(
        [m.fir_stage(T1, fft_len=512, name="p")],
        [[m.fir_stage(T2, decim=4, fft_len=512, name="b1", impl=impl)],
         [m.mag2_stage()],
         [m.rotator_stage(0.2)]],
        np.complex64, optimize=False)


def test_fanout_pipeline_matches_jax():
    jp, tp = _fanout(J), _fanout(T)
    assert [s.name for s in tp.stages] == [s.name for s in jp.stages]
    assert tp.ratio == jp.ratio and tp.out_items(FRAME) == jp.out_items(FRAME)
    _compare(jp, tp, _frames(11), [FIR_TOL, dict(rtol=1e-4, atol=1e-4), FIR_TOL])


def test_fanout_pipeline_kernel_routes_match_jax():
    """The decimating branch on the ``poly_fir`` route (interpret-mode
    Pallas against the port's plain version)."""
    jp, tp = _fanout(J, "pallas"), _fanout(T, "pallas")
    _compare(jp, tp, _frames(12), [FIR_TOL, dict(rtol=1e-4, atol=1e-4), FIR_TOL])


def test_fanout_update_stage_addresses_the_flat_carry():
    jp, tp = _fanout(J), _fanout(T)
    carry = tp.init_carry("cpu")
    new = tp.update_stage(carry, "b1", taps=T2[::-1].copy())
    assert len(new) == len(carry) == len(jp.init_carry())
    assert new[0] is carry[0] and new[1] is not carry[1]
    assert tp.update_stage(None, "b1", _validate_only=True, taps=T2) is None
    with pytest.raises(KeyError):
        tp.update_stage(None, "nope", _validate_only=True)


def test_fanout_needs_two_branches():
    with pytest.raises(ValueError):
        T.FanoutPipeline([T.mag2_stage()], [[T.mag2_stage()]], np.complex64)


# ---------------------------------------------------------------------------
# DagPipeline
# ---------------------------------------------------------------------------

def _diamond(m, merge="add"):
    join = {"add": m.add_merge_stage(2), "interleave": m.interleave_merge_stage(2),
            "concat": m.concat_merge_stage(2)}[merge]
    b2 = m.rotator_stage(0.1, name="b2") if merge == "concat" else \
        m.fir_stage(T2, decim=4, fft_len=512, name="b2")
    return m.DagPipeline([
        ([m.fir_stage(T1, fft_len=512, name="p")], []),
        ([m.fir_stage(T2, decim=4, fft_len=512, name="b1")], [0]),
        ([b2], [0]),
        ([join, m.mag2_stage()], [1, 2]),
    ], np.complex64)


@pytest.mark.parametrize("merge", ["add", "interleave", "concat"])
def test_dag_diamond_matches_jax(merge):
    jp, tp = _diamond(J, merge), _diamond(T, merge)
    assert tp.sinks == jp.sinks == [3]
    assert tp.tag_ratios == jp.tag_ratios and tp.concat_sinks == jp.concat_sinks
    assert tp.node_ratios == jp.node_ratios
    _compare(jp, tp, _frames(13), [dict(rtol=1e-4, atol=1e-4)])


def test_dag_nested_fanout_matches_jax():
    """``p → {a → {c, d}, b}``: three sinks, a node read by two."""
    def make(m):
        return m.DagPipeline([
            ([m.fir_stage(T1, fft_len=512, name="p")], []),
            ([m.fir_stage(T2, fft_len=512, name="a")], [0]),
            ([m.mag2_stage()], [0]),
            ([m.fir_stage(T2, decim=4, fft_len=512, name="c")], [1]),
            ([m.mag2_stage()], [1]),
        ], np.complex64)

    jp, tp = make(J), make(T)
    assert tp.sinks == jp.sinks == [2, 3, 4]
    assert tp.tag_ratios == jp.tag_ratios == [1, Fraction(1, 4), 1]
    _compare(jp, tp, _frames(14), [dict(rtol=1e-4, atol=1e-4), FIR_TOL,
                                   dict(rtol=1e-4, atol=1e-4)])


@pytest.mark.parametrize("m", [J, T], ids=["jax", "port"])
def test_equal_merge_at_unequal_rates_raises(m):
    with pytest.raises(ValueError, match="rate contract"):
        m.DagPipeline([
            ([], []),
            ([m.fir_stage(T2, decim=4, fft_len=512)], [0]),
            ([m.rotator_stage(0.1)], [0]),
            ([m.add_merge_stage(2)], [1, 2]),
        ], np.complex64)


@pytest.mark.parametrize("bad", ["order", "root", "no_merge", "k"])
def test_dag_rejects_malformed_nodes(bad):
    nodes = {"order": [([], []), ([T.mag2_stage()], [2]), ([], [0])],
             "root": [([], [0])],
             "no_merge": [([], []), ([], [0]), ([], [0]), ([T.mag2_stage()], [1, 2])],
             "k": [([], []), ([], [0]), ([], [0]),
                   ([T.add_merge_stage(3)], [1, 2])]}[bad]
    with pytest.raises(ValueError):
        T.DagPipeline(nodes, np.complex64)


# ---------------------------------------------------------------------------
# the multi-output program on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 4])
def test_multi_output_compile_equals_fn(k):
    tp = _diamond(T, "add")
    fo = _fanout(T)
    for pipe in (tp, fo):
        frames = _frames(15, n=k * 2)
        fn, carry = pipe.compile(FRAME, "cpu", k=k)
        ref_c = pipe.init_carry("cpu")
        run = pipe.fn()
        refs = []
        for x in frames:
            ref_c, ys = run(ref_c, torch.from_numpy(x))
            refs.append(ys)
        for g in range(2):
            xs = frames[g * k:(g + 1) * k]
            x = torch.from_numpy(np.stack(xs)) if k > 1 else torch.from_numpy(xs[0])
            carry, ys = fn(carry, x)
            assert isinstance(ys, tuple) and len(ys) == pipe.n_branches
            for j, y in enumerate(ys):
                want = torch.stack([r[j] for r in refs[g * k:(g + 1) * k]]) if k > 1 \
                    else refs[g][j]
                assert torch.equal(y, want)
