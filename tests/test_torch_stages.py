"""The port's stages and pipelines against the JAX package's, on the CPU.

Each port stage (``futuresdr_tpu_torch/ops/stages.py``) and its JAX
counterpart run the same numpy frames, carry chained over >= 3 frames, at the
tolerances of ``tests/test_tpu_stages.py`` and ``tests/test_pallas.py``. The
JAX Pallas kernels run in interpret mode; the port's kernel wrappers run
their plain versions on CPU tensors.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from futuresdr_tpu.dsp import firdes
from futuresdr_tpu.ops import stages as J
from futuresdr_tpu_torch.convert import carry_from_numpy
from futuresdr_tpu_torch.ops import stages as T

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)


def _c64(rng, n):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


def _frames(rng, n_frames, frame, complex_stream=True):
    if complex_stream:
        return [_c64(rng, frame) for _ in range(n_frames)]
    return [rng.standard_normal(frame).astype(np.float32) for _ in range(n_frames)]


_JITTED = {}     # id(pipeline) -> (pipeline, jitted fn); holding the pipeline keeps ids unique


def _run_jax(pipe, frames, carry=None):
    if id(pipe) not in _JITTED:
        _JITTED[id(pipe)] = (pipe, jax.jit(pipe.fn()))
    fn = _JITTED[id(pipe)][1]
    carry = pipe.init_carry() if carry is None else carry
    outs = []
    for x in frames:
        carry, y = fn(carry, jax.numpy.asarray(x))
        outs.append(np.asarray(y))
    return carry, outs


def _run_port(pipe, frames, carry=None):
    fn = pipe.fn()
    carry = pipe.init_carry("cpu") if carry is None else carry
    outs = []
    for x in frames:
        carry, y = fn(carry, torch.from_numpy(x))
        outs.append(y.numpy())
    return carry, outs


def _pair(stages_of, in_dtype, frames, rtol, atol, jp=None):
    """Run the JAX and the port pipeline built by ``stages_of(module)`` (the
    JAX one given as ``jp`` where a test shares it) over ``frames`` and
    compare frame by frame; returns both pipelines."""
    jp = J.Pipeline(stages_of(J), in_dtype) if jp is None else jp
    tp = T.Pipeline(stages_of(T), in_dtype)
    assert tp.frame_multiple == jp.frame_multiple
    assert tp.out_dtype == jp.out_dtype
    _, ya = _run_jax(jp, frames)
    _, yb = _run_port(tp, frames)
    for a, b in zip(ya, yb):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)
    return jp, tp


def _leaves(tree):
    return [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(tree)]


# ---------------------------------------------------------------------------
# each stage against its JAX stage, >= 3 chained frames
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("complex_stream,complex_taps,impl", [
    (False, False, "os"), (True, False, "os"), (True, True, "os"),
    (False, True, "auto"), (True, False, "pallas"), (False, False, "pallas")])
def test_fir_stage_matches_jax(complex_stream, complex_taps, impl):
    rng = np.random.default_rng(1)
    taps = firdes.lowpass(0.2, 48).astype(np.float32)
    if complex_taps:
        taps = (taps * np.exp(1j * 0.3 * np.arange(48))).astype(np.complex64)
    frames = _frames(rng, 3, 2048, complex_stream)
    dtype = np.complex64 if complex_stream else np.float32
    _pair(lambda m: [m.fir_stage(taps, fft_len=512, impl=impl)], dtype, frames,
          rtol=1e-4, atol=1e-5)


def test_fir_stage_decimating_overlap_save_matches_jax():
    """Long taps with decimation stay on overlap-save (sliced output) under
    ``auto``, as in the JAX package."""
    rng = np.random.default_rng(8)
    taps = firdes.lowpass(0.1, 80).astype(np.float32)
    jp, tp = _pair(lambda m: [m.fir_stage(taps, decim=2, fft_len=512)], np.complex64,
                   _frames(rng, 3, 2048), rtol=1e-4, atol=1e-5)
    assert tp.ratio == jp.ratio and tp.out_items(2048) == 1024


@pytest.mark.parametrize("kw", [
    {}, {"direction": "inverse"}, {"window": "hann"}, {"shift": True},
    {"normalize": True}, {"window": "blackman", "shift": True, "normalize": True},
    {"impl": "xla", "precision": "f32"}])
def test_fft_stage_matches_jax(kw):
    rng = np.random.default_rng(2)
    frames = _frames(rng, 3, 1024)
    _pair(lambda m: [m.fft_stage(256, **kw)], np.complex64, frames,
          rtol=1e-3, atol=1e-3)


def test_fft_stage_of_real_stream_and_mag2_match_jax():
    rng = np.random.default_rng(3)
    _pair(lambda m: [m.fft_stage(128, window="hamming"), m.mag2_stage()], np.float32,
          _frames(rng, 3, 512, complex_stream=False), rtol=1e-3, atol=1e-3)
    _pair(lambda m: [m.mag2_stage()], np.complex64, _frames(rng, 3, 300),
          rtol=1e-6, atol=1e-6)
    _pair(lambda m: [m.mag2_stage()], np.float32,
          _frames(rng, 3, 300, complex_stream=False), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_fft,nt", [(128, 17), (256, 33)])
def test_fir_fft_stage_matches_jax(n_fft, nt):
    rng = np.random.default_rng(n_fft + nt)
    taps = rng.standard_normal(nt).astype(np.float32)
    _pair(lambda m: [m.fir_fft_stage(taps, n_fft)], np.complex64,
          _frames(rng, 3, 4 * n_fft), rtol=1e-3, atol=1e-2)


# ---------------------------------------------------------------------------
# the whole chain at small width
# ---------------------------------------------------------------------------

CHAIN_TAPS = firdes.lowpass(0.2, 64).astype(np.float32)


def _chain(m, route, fft_len=8192):
    if route == "fused":
        return [m.fir_fft_stage(CHAIN_TAPS, 256), m.mag2_stage()]
    return [m.fir_stage(CHAIN_TAPS, fft_len=fft_len, impl=route), m.fft_stage(256),
            m.mag2_stage()]


@functools.lru_cache(maxsize=None)
def _jax_chain(route, fft_len):
    """One JAX pipeline per chain, so the tests that run the same chain at
    the same frame share its compiled program (``_run_jax``)."""
    return J.Pipeline(_chain(J, route, fft_len=fft_len), np.complex64)


@pytest.mark.parametrize("route", ["os", "pallas", "fused"])
def test_spectrum_chain_matches_jax(route):
    """The north-star chain (64 taps, n_fft 256, 8192-sample frames)."""
    rng = np.random.default_rng(4)
    jp, tp = _pair(lambda m: _chain(m, route), np.complex64, _frames(rng, 3, 8192),
                   rtol=1e-3, atol=1e-2, jp=_jax_chain(route, 8192))
    for n in (8192, 3 * 8192):
        assert tp.out_items(n) == jp.out_items(n)


def test_pipeline_rate_math_matches_jax():
    taps = np.ones(16, dtype=np.float32)
    for m_stages in (lambda m: [m.fir_stage(taps, fft_len=128), m.fft_stage(64),
                                m.mag2_stage()],
                     lambda m: [m.fir_fft_stage(taps, 64), m.mag2_stage()]):
        jp = J.Pipeline(m_stages(J), np.complex64)
        tp = T.Pipeline(m_stages(T), np.complex64)
        assert (tp.frame_multiple, tp.ratio, tp.out_dtype) == \
            (jp.frame_multiple, jp.ratio, jp.out_dtype)
        assert tp.out_items(1024) == jp.out_items(1024)


def test_merge_lti_cascade_matches_jax():
    t1 = firdes.lowpass(0.3, 24).astype(np.float32)
    t2 = firdes.lowpass(0.2, 16).astype(np.float32)
    rng = np.random.default_rng(5)
    jp, tp = _pair(lambda m: [m.fir_stage(t1, fft_len=512), m.fir_stage(t2, fft_len=512)],
                   np.complex64, _frames(rng, 3, 2048), rtol=1e-4, atol=1e-5)
    assert len(tp.stages) == len(jp.stages) == 1
    assert tp.stages[0].name == jp.stages[0].name == "fir*fir"
    np.testing.assert_allclose(tp.stages[0].lti[0], jp.stages[0].lti[0], rtol=1e-6)
    # complex taps do not merge on a real stream, as in the JAX package
    ct = (t2 * np.exp(1j * 0.3 * np.arange(16))).astype(np.complex64)
    j2 = J.Pipeline([J.fir_stage(ct, fft_len=512), J.fir_stage(ct, fft_len=512)], np.float32)
    t2p = T.Pipeline([T.fir_stage(ct, fft_len=512), T.fir_stage(ct, fft_len=512)], np.float32)
    assert len(t2p.stages) == len(j2.stages) == 2


@pytest.mark.parametrize("route", ["os", "pallas", "fused"])
def test_tap_swap_through_update_stage_matches_jax(route):
    rng = np.random.default_rng(6)
    new_taps = firdes.lowpass(0.05, 64).astype(np.float32)
    frames = _frames(rng, 4, 8192)
    jp = _jax_chain(route, 8192)
    tp = T.Pipeline(_chain(T, route), np.complex64)
    ja, ya = _run_jax(jp, frames[:2])
    tb, yb = _run_port(tp, frames[:2])
    # host round trip: keeps the jitted JAX program's argument placement (an
    # updated leaf lands committed to its device and would recompile it)
    ja = jax.tree_util.tree_map(lambda a: jax.numpy.asarray(np.asarray(a)),
                                jp.update_stage(ja, 0, taps=new_taps))
    tb = tp.update_stage(tb, 0, taps=new_taps)
    _, ya2 = _run_jax(jp, frames[2:], ja)
    _, yb2 = _run_port(tp, frames[2:], tb)
    for a, b in zip(ya + ya2, yb + yb2):
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-2)
    with pytest.raises(ValueError):
        tp.update_stage(tb, 0, taps=new_taps[:10])        # tap count is fixed


@pytest.mark.parametrize("route", ["os", "pallas", "fused"])
def test_carry_converts_from_jax(route):
    """JAX runs 2 frames; its carry converts to the port's; both run on for
    2 more frames and agree."""
    rng = np.random.default_rng(7)
    frames = _frames(rng, 4, 8192)
    jp = _jax_chain(route, 8192)
    tp = T.Pipeline(_chain(T, route), np.complex64)
    ja, _ = _run_jax(jp, frames[:2])
    leaves = _leaves(ja)
    port_leaves = [t.numpy() for t in jax.tree_util.tree_leaves(tp.init_carry("cpu"))]
    assert [(a.shape, a.dtype) for a in leaves] == \
        [(b.shape, b.dtype) for b in port_leaves]
    tb = carry_from_numpy(tp, leaves, "cpu")
    _, ya = _run_jax(jp, frames[2:], ja)
    _, yb = _run_port(tp, frames[2:], tb)
    for a, b in zip(ya, yb):
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-2)
    with pytest.raises(ValueError):
        carry_from_numpy(tp, leaves[:-1], "cpu")


def test_carry_trees_match_jax_leaf_for_leaf():
    """Real and complex streams, full and half spectra, fused and stateless."""
    taps = firdes.lowpass(0.2, 32).astype(np.float32)
    for dtype in (np.float32, np.complex64):
        for mk in (lambda m: [m.fir_stage(taps)], lambda m: [m.fir_stage(taps, fft_impl="mxu")],
                   lambda m: [m.fir_fft_stage(taps, 128), m.mag2_stage()],
                   lambda m: [m.fft_stage(64)]):
            a = _leaves(J.Pipeline(mk(J), dtype).init_carry())
            b = [t.numpy() for t in jax.tree_util.tree_leaves(
                T.Pipeline(mk(T), dtype).init_carry("cpu"))]
            assert [(x.shape, x.dtype) for x in a] == [(x.shape, x.dtype) for x in b]
            for x, y in zip(a, b):
                np.testing.assert_allclose(y, x, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("make", [
    lambda: T.fir_stage(np.ones(8, np.complex64), decim=2, precision="int8"),
    lambda: T.fir_stage(np.ones(8, np.float32), precision="fp8"),
    lambda: T._shifted_matvec(torch.zeros(2400), torch.zeros(300, 4), 299, 1,
                              precision="int8"),
    lambda: T.fir_stage(np.ones(8, np.complex64), precision="int8"),
    lambda: T.fir_fft_stage(np.ones(8, np.float32), 64, precision="int8"),
    lambda: T.channelizer_stage(16, precision="int8"),
])
def test_routes_outside_the_slice_raise(make):
    """The int8 rung takes real taps only, and at most 1,040 terms a sum
    (float32's exact integer range); ``fir_fft_stage`` and
    ``channelizer_stage`` have no int8 form (nor do the JAX package's)."""
    with pytest.raises(ValueError):
        make()
