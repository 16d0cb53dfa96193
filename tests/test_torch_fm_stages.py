"""The port's FM front end against the JAX package's, on the CPU.

The three FM kernels' plain versions (``cuda_kernels.rotator_plain``,
``quad_demod_plain``, ``poly_fir_plain``, reached through the wrappers on CPU
tensors) against the JAX Pallas kernels in interpret mode, at the tolerances
of ``tests/test_pallas.py``; each new stage on both of its routes over >= 3
chained frames against its JAX stage; the polyphase routes and merges of
``tests/test_poly_decim_fir.py``; the resampler against
``scipy.signal.upfirdn``; the xlating retune of ``tests/test_retune.py``; and
both FM chains (the app's and the kernel-pinned unfolded one) at a reduced
frame. Inputs come from numpy with a seed.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from scipy import signal as sps

from futuresdr_tpu.apps.fm_receiver import front_end_stages as j_front_end
from futuresdr_tpu.dsp import firdes
from futuresdr_tpu.ops import stages as J
from futuresdr_tpu.ops import pallas_kernels as pk
from futuresdr_tpu_torch.apps.fm_receiver import front_end_stages as t_front_end
from futuresdr_tpu_torch.convert import carry_from_numpy
from futuresdr_tpu_torch.ops import cuda_kernels as ck
from futuresdr_tpu_torch.ops import stages as T

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

# The JAX kernels, still in interpret mode, each under one jit: one XLA
# program per shape (the complex cases' two planes share it), where an eager
# interpret-mode call compiles each of its operations apart.
pallas_rotator = jax.jit(pk.pallas_rotator, static_argnames=("block", "interpret"))
pallas_quad_demod = jax.jit(pk.pallas_quad_demod,
                            static_argnames=("gain", "block", "interpret"))
pallas_poly_fir = jax.jit(pk.pallas_poly_fir,
                          static_argnames=("block", "interpret", "precision"))


def _c64(rng, n):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


def _frames(rng, n_frames, frame, complex_stream=True):
    if complex_stream:
        return [_c64(rng, frame) for _ in range(n_frames)]
    return [rng.standard_normal(frame).astype(np.float32) for _ in range(n_frames)]


def _wrapped(d, gain):
    """A demod difference wrapped into (−π·gain, π·gain]: at Im z ≈ ±0 with
    Re z < 0, atan2 flips between +π and −π on a last-bit difference."""
    period = 2 * np.pi * gain
    return d - period * np.round(d / period)


_JITTED = {}     # id(pipeline) -> (pipeline, jitted fn); holding the pipeline keeps ids unique


def _run_jax(pipe, frames, carry=None):
    if id(pipe) not in _JITTED:
        _JITTED[id(pipe)] = (pipe, jax.jit(pipe.fn()))
    fn = _JITTED[id(pipe)][1]
    carry = pipe.init_carry() if carry is None else carry
    outs = []
    for x in frames:
        carry, y = fn(carry, jnp.asarray(x))
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


def _pair(stages_of, in_dtype, frames, rtol, atol, wrap_gain=None):
    jp, tp = J.Pipeline(stages_of(J), in_dtype), T.Pipeline(stages_of(T), in_dtype)
    assert (tp.frame_multiple, tp.ratio, tp.out_dtype) == \
        (jp.frame_multiple, jp.ratio, jp.out_dtype)
    _, ya = _run_jax(jp, frames)
    _, yb = _run_port(tp, frames)
    for a, b in zip(ya, yb):
        assert a.shape == b.shape and a.dtype == b.dtype
        if wrap_gain is not None:
            b = a + _wrapped(b - a, wrap_gain)
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)
    return jp, tp


def _leaves(tree):
    return [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(tree)]


def _port_leaves(carry):
    return [t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
            for t in jax.tree_util.tree_leaves(carry)]


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,block", [(1000, 1), (257, 2), (4096, None)])
def test_rotator_plain_matches_pallas_rotator(n, block):
    rng = np.random.default_rng(n)
    x = _c64(rng, n)
    ph0, inc = 0.3, 0.011
    ref = np.asarray(pallas_rotator(jnp.asarray(x), ph0, inc, block=block))
    got, ph_next = ck.rotator(torch.from_numpy(x), torch.tensor(ph0), torch.tensor(inc))
    got = got.numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert ph_next.shape == () and ph_next.item() == pytest.approx(
        np.remainder(ph0 + inc * n, 2 * np.pi), abs=1e-5)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)
    exact = x * np.exp(1j * (ph0 + inc * np.arange(n))).astype(np.complex64)
    np.testing.assert_allclose(got, exact, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("n,block", [(1000, 1), (129, 2), (3000, None)])
def test_quad_demod_plain_matches_pallas_quad_demod(n, block):
    rng = np.random.default_rng(n)
    x = _c64(rng, n)
    prev = np.complex64(0.7 - 0.2j)
    gain = 0.8
    ref = np.asarray(pallas_quad_demod(jnp.asarray(prev), jnp.asarray(x), gain,
                                       block=block))
    got, last = ck.quad_demod(torch.tensor(prev), torch.from_numpy(x), gain)
    got = got.numpy()
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(ref + _wrapped(got - ref, gain), ref, rtol=1e-4, atol=1e-5)
    assert last.shape == () and last.item() == x[-1]


@pytest.mark.parametrize("D,m,I,nq,complex_stream,precision", [
    (8, 7, None, 777, False, None),          # ragged against the kernel's tiles
    (4, 32, None, 1000, True, None),         # the FM channel filter's shape
    (4, 32, None, 300, True, "bf16"),
    (125, 2, 24, 50, False, None),           # the audio resampler's shape
    (125, 2, 24, 37, False, "bf16"),
    (5, 3, 3, 41, True, None),               # 3-D W on a complex stream
])
def test_poly_fir_plain_matches_pallas_poly_fir(D, m, I, nq, complex_stream, precision):
    rng = np.random.default_rng(D * 100 + nq)
    shape = (m + 1, D) if I is None else (m + 1, D, I)
    W = rng.standard_normal(shape).astype(np.float32)
    rows = rng.standard_normal((nq + m, D)).astype(np.float32)
    if complex_stream:
        rows = (rows + 1j * rng.standard_normal((nq + m, D))).astype(np.complex64)
        ref = (np.asarray(pallas_poly_fir(jnp.asarray(rows.real), jnp.asarray(W),
                                          precision=precision))
               + 1j * np.asarray(pallas_poly_fir(jnp.asarray(rows.imag), jnp.asarray(W),
                                                 precision=precision)))
    else:
        ref = np.asarray(pallas_poly_fir(jnp.asarray(rows), jnp.asarray(W),
                                         precision=precision))
    flat = torch.from_numpy(rows.reshape(-1))
    w = torch.from_numpy(W)
    if precision == "bf16":
        w = w.to(torch.bfloat16)             # the stage's carried bf16 weights
    got = ck.poly_fir(flat[:m * D], flat[m * D:], w, precision).numpy()
    assert got.shape == ref.shape and got.dtype == rows.dtype
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_poly_fir_plain_refuses_bad_shapes():
    x = torch.zeros(40)
    with pytest.raises(TypeError, match="real"):
        ck.poly_fir(torch.zeros(4, dtype=torch.complex64), x.to(torch.complex64),
                    torch.zeros(2, 4, dtype=torch.complex64))
    with pytest.raises(ValueError, match="multiple of D"):
        ck.poly_fir(torch.zeros(3), torch.zeros(10), torch.zeros(2, 3))
    with pytest.raises(ValueError, match="hist"):
        ck.poly_fir(torch.zeros(5), x, torch.zeros(2, 4))


# ---------------------------------------------------------------------------
# each new stage against its JAX stage, >= 3 chained frames
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_rotator_stage_matches_jax(impl):
    rng = np.random.default_rng(11)
    _pair(lambda m: [m.rotator_stage(-0.3, impl=impl)], np.complex64,
          _frames(rng, 3, 2000), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_quad_demod_stage_matches_jax(impl):
    rng = np.random.default_rng(12)
    gain = 250e3 / (2 * np.pi * 75e3)
    _pair(lambda m: [m.quad_demod_stage(gain, impl=impl)], np.complex64,
          _frames(rng, 3, 1500), rtol=1e-4, atol=1e-5, wrap_gain=gain)


@pytest.mark.parametrize("impl,decim,nt,complex_stream,precision", [
    ("poly", 4, 128, True, None), ("pallas", 4, 128, True, None),
    ("pallas", 3, 17, False, None), ("auto", 8, 64, False, None),
    ("poly", 4, 63, True, "bf16"), ("pallas", 4, 63, False, "bf16"),
])
def test_poly_decim_fir_stage_matches_jax(impl, decim, nt, complex_stream, precision):
    rng = np.random.default_rng(nt + decim)
    taps = firdes.lowpass(0.4 / decim, nt).astype(np.float32)
    dtype = np.complex64 if complex_stream else np.float32
    jp, tp = _pair(lambda m: [m.fir_stage(taps, decim=decim, impl=impl,
                                          precision=precision)],
                   dtype, _frames(rng, 3, 240 * decim, complex_stream),
                   rtol=1e-4, atol=1e-4)
    assert tp.frame_multiple == decim


def test_poly_decim_complex_taps_take_the_matvec_on_every_impl():
    rng = np.random.default_rng(13)
    taps = (firdes.lowpass(0.1, 32) * np.exp(0.2j * np.arange(32))).astype(np.complex64)
    for impl in ("poly", "pallas"):
        _pair(lambda m: [m.fir_stage(taps, decim=4, impl=impl)], np.complex64,
              _frames(rng, 3, 800), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("impl,complex_stream", [
    ("poly", False), ("pallas", False), ("pallas", True), ("stuff", True)])
def test_resample_stage_matches_jax(impl, complex_stream):
    rng = np.random.default_rng(14)
    dtype = np.complex64 if complex_stream else np.float32
    taps = (firdes.lowpass(0.4 / 5, 81) * 3).astype(np.float32)
    jp, tp = _pair(lambda m: [m.resample_stage(3, 5, taps, fft_len=256, impl=impl)],
                   dtype, _frames(rng, 3, 1280, complex_stream), rtol=1e-4, atol=1e-4)
    assert tp.out_items(1280) == 768


def test_resample_default_taps_are_the_audio_resampler():
    """24/125 with the default Kaiser taps: 4533 taps, m = 2, W [3, 125, 24]."""
    jst, tst = J.resample_stage(24, 125), T.resample_stage(24, 125, impl="pallas")
    tp = T.Pipeline([tst], np.float32)
    assert tst.frame_multiple == jst.frame_multiple == 125
    assert tp.init_carry("cpu")[0].shape == (250,)
    rng = np.random.default_rng(15)
    _pair(lambda m: [m.resample_stage(24, 125, impl="pallas")], np.float32,
          _frames(rng, 3, 1000, complex_stream=False), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("decim", [2, 5])
def test_decimate_stage_matches_jax(decim):
    rng = np.random.default_rng(16)
    jp, tp = _pair(lambda m: [m.decimate_stage(decim)], np.complex64,
                   _frames(rng, 3, 100), rtol=0, atol=0)
    assert tp.stages[0].name == jp.stages[0].name


def test_xlating_fir_stage_matches_jax():
    rng = np.random.default_rng(17)
    taps = firdes.lowpass(0.5 / 4 * 0.8, 128).astype(np.float32)
    _pair(lambda m: [m.xlating_fir_stage(taps, -2 * np.pi * 0.1, 4, name="tuner")],
          np.complex64, _frames(rng, 3, 2000), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# fir_stage decimation routes and merges (tests/test_poly_decim_fir.py)
# ---------------------------------------------------------------------------

def _run_stage(st, x, frame, dtype):
    fn, carry = st.fn, st.init_carry(dtype, "cpu")
    outs = []
    for i in range(0, len(x), frame):
        carry, y = fn(carry, torch.from_numpy(x[i:i + frame]))
        outs.append(y.numpy())
    return np.concatenate(outs)


@pytest.mark.parametrize("d_nt", [(2, 31), (4, 63), (8, 64), (3, 17), (25, 200)])
@pytest.mark.parametrize("impl", ["poly", "pallas"])
@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_poly_decim_matches_os(d_nt, impl, dtype):
    D, nt = d_nt
    rng = np.random.default_rng(D * 1000 + nt)
    taps = (rng.standard_normal(nt) * np.hanning(nt)).astype(np.float32)
    s_os = T.fir_stage(taps, decim=D, impl="os")
    s_po = T.fir_stage(taps, decim=D, impl=impl)
    assert s_po.frame_multiple == D
    frame = int(np.lcm(s_os.frame_multiple, s_po.frame_multiple))
    x = _frames(rng, 1, 3 * frame, dtype == np.complex64)[0]
    y_os = _run_stage(s_os, x, frame, dtype)
    y_po = _run_stage(s_po, x, frame, dtype)
    assert y_po.shape == y_os.shape
    assert np.abs(y_po - y_os).max() / max(1e-9, np.abs(y_os).max()) < 1e-5


def test_auto_routes_decim_to_poly():
    taps = np.hanning(64).astype(np.float32)
    assert T.fir_stage(taps, decim=8).frame_multiple == 8
    assert T.fir_stage(taps, decim=1).frame_multiple > 8
    assert T.fir_stage(np.ones(8192, np.float32), decim=2).frame_multiple > 2


@pytest.mark.parametrize("impl", ["poly", "pallas"])
def test_merge_preserves_forced_poly(impl):
    rng = np.random.default_rng(9)
    t1 = rng.standard_normal(120).astype(np.float32)
    t2 = rng.standard_normal(80).astype(np.float32)
    pipe = T.Pipeline([T.fir_stage(t1, decim=2, impl=impl),
                       T.fir_stage(t2, decim=1, impl=impl)], np.complex64)
    jpipe = J.Pipeline([J.fir_stage(t1, decim=2, impl=impl),
                        J.fir_stage(t2, decim=1, impl=impl)], np.complex64)
    assert len(pipe.stages) == len(jpipe.stages) == 1
    assert len(pipe.stages[0].lti[0]) > 32 * 2
    assert pipe.frame_multiple == jpipe.frame_multiple == 2
    assert pipe.stages[0].route[0] == impl


def test_poly_decim_merges_in_pipeline():
    rng = np.random.default_rng(5)
    t1 = rng.standard_normal(33).astype(np.float32)
    t2 = rng.standard_normal(21).astype(np.float32)
    pipe = T.Pipeline([T.fir_stage(t1, decim=4), T.fir_stage(t2, decim=2)], np.complex64)
    assert len(pipe.stages) == 1
    ref = T.Pipeline([T.fir_stage(t1, decim=4, impl="os"),
                      T.fir_stage(t2, decim=2, impl="os")], np.complex64, optimize=False)
    frame = int(np.lcm(pipe.frame_multiple, ref.frame_multiple))
    x = _c64(rng, 2 * frame)
    frames = [x[:frame], x[frame:]]
    _, ym = _run_port(pipe, frames)
    _, yr = _run_port(ref, frames)
    ym, yr = np.concatenate(ym), np.concatenate(yr)
    assert np.abs(ym - yr).max() / max(1e-9, np.abs(yr).max()) < 1e-4


def test_poly_tap_swap_matches_jax_and_refuses_what_jax_refuses():
    rng = np.random.default_rng(18)
    taps = firdes.lowpass(0.1, 64).astype(np.float32)
    t2 = firdes.lowpass(0.05, 64).astype(np.float32)
    frames = _frames(rng, 4, 400)
    jp = J.Pipeline([J.fir_stage(taps, decim=4, impl="pallas", name="f")], np.complex64)
    tp = T.Pipeline([T.fir_stage(taps, decim=4, impl="pallas", name="f")], np.complex64)
    ja, ya = _run_jax(jp, frames[:2])
    tb, yb = _run_port(tp, frames[:2])
    ja = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a)),
                                jp.update_stage(ja, "f", taps=t2))
    tb = tp.update_stage(tb, "f", taps=t2)
    _, ya2 = _run_jax(jp, frames[2:], ja)
    _, yb2 = _run_port(tp, frames[2:], tb)
    for a, b in zip(ya + ya2, yb + yb2):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="tap count"):
        tp.update_stage(tb, "f", taps=t2[:10])
    with pytest.raises(ValueError, match="complex"):
        tp.update_stage(tb, "f", taps=t2.astype(np.complex64))


# ---------------------------------------------------------------------------
# the resampler against scipy (tests/test_resample_stage.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["poly", "pallas", "stuff"])
def test_resample_stage_matches_upfirdn(impl):
    interp, decim = 3, 2
    taps = (firdes.lowpass(0.4 / 3, 97) * interp).astype(np.float32)
    pipe = T.Pipeline([T.resample_stage(interp, decim, taps, fft_len=512, impl=impl)],
                      np.float32)
    mult = pipe.frame_multiple
    n = mult * max(1, 4096 // mult)
    x = np.random.default_rng(0).standard_normal(4 * n).astype(np.float32)
    _, ys = _run_port(pipe, [x[i:i + n] for i in range(0, len(x), n)])
    y = np.concatenate(ys)
    assert len(y) == 4 * n * interp // decim
    ref = sps.upfirdn(taps, x, up=interp, down=decim)[:len(y)]
    np.testing.assert_allclose(y, ref, rtol=1e-3, atol=1e-3)


def test_resample_complex_taps_force_stuff():
    taps = (firdes.lowpass(0.1, 31) * np.exp(0.1j * np.arange(31))).astype(np.complex64)
    st = T.resample_stage(2, 3, taps, impl="pallas")
    assert st.route is None and st.frame_multiple != 3
    rng = np.random.default_rng(19)
    _pair(lambda m: [m.resample_stage(2, 3, taps, fft_len=256, impl="pallas")],
          np.complex64, _frames(rng, 3, st.frame_multiple * 2), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# xlating retunes (tests/test_retune.py)
# ---------------------------------------------------------------------------

def test_xlating_retune_matches_jax_through_both_updates():
    rng = np.random.default_rng(20)
    taps = firdes.lowpass(0.5 / 16 * 0.8, 128).astype(np.float32)
    t2 = firdes.lowpass(0.5 / 16 * 0.5, 128).astype(np.float32)
    theta, theta2 = -2 * np.pi * 100e3 / 1e6, -2 * np.pi * 250e3 / 1e6
    frames = _frames(rng, 5, 4096)
    jp = J.Pipeline([J.xlating_fir_stage(taps, theta, 16, name="tuner")], np.complex64)
    tp = T.Pipeline([T.xlating_fir_stage(taps, theta, 16, name="tuner")], np.complex64)
    ja, ya = _run_jax(jp, frames[:2])
    tb, yb = _run_port(tp, frames[:2])
    for kw in ({"phase_inc": theta2}, {"taps": t2}):
        ja = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a)),
                                    jp.update_stage(ja, "tuner", **kw))
        tb = tp.update_stage(tb, "tuner", **kw)
        ja, y1 = _run_jax(jp, frames[2:4], ja)
        tb, y2 = _run_port(tp, frames[2:4], tb)
        ya, yb = ya + y1, yb + y2
    # the residual ramp ph0 + inc_d·q reaches |ph| ≈ 2.6e3 rad (inc_d = 16·θ),
    # where one float32 ulp is 2.4e-4 rad: XLA:CPU contracts the ramp into an
    # FMA, the port rounds product and sum apart (as the Pallas kernel's
    # source reads), so frames after the first differ by up to a phase ulp
    for a, b in zip(ya, yb):
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-3)
    for a, b in zip(_leaves(ja), _port_leaves(tb)):
        assert a.shape == b.shape and a.dtype == b.dtype
    with pytest.raises(ValueError, match="REAL base"):
        tp.update_stage(tb, "tuner", taps=t2.astype(np.complex64) * 1j)
    with pytest.raises(ValueError, match="tap count"):
        tp.update_stage(tb, "tuner", taps=t2[:64])


def test_xlating_taps_update_preserves_exact_theta():
    """``update(taps=…)`` rebuilds the weights at the exact θ: bit-identical
    to a fresh stage at the same θ, and to the JAX package's weights."""
    theta = -2 * np.pi * 0.1234567891234
    taps = firdes.lowpass(0.1, 64).astype(np.float32)
    t2 = firdes.lowpass(0.05, 64).astype(np.float32)
    pipe = T.Pipeline([T.xlating_fir_stage(taps, theta, 4, name="x")], np.complex64)
    c = pipe.update_stage(pipe.init_carry("cpu"), "x", taps=t2)
    fresh = T.Pipeline([T.xlating_fir_stage(t2, theta, 4, name="x")],
                       np.complex64).init_carry("cpu")
    np.testing.assert_array_equal(c[0][0].numpy(), fresh[0][0].numpy())
    jfresh = J.Pipeline([J.xlating_fir_stage(t2, theta, 4, name="x")],
                        np.complex64).init_carry()
    np.testing.assert_array_equal(c[0][0].numpy(), np.asarray(jfresh[0][0]))
    hi, lo = float(c[0][4]), float(c[0][5])
    assert hi + lo == pytest.approx(theta, abs=1e-12)


def test_rotator_retune_matches_jax():
    rng = np.random.default_rng(21)
    frames = _frames(rng, 4, 1000)
    for impl in ("xla", "pallas"):
        jp = J.Pipeline([J.rotator_stage(0.05, name="rot", impl=impl)], np.complex64)
        tp = T.Pipeline([T.rotator_stage(0.05, name="rot", impl=impl)], np.complex64)
        ja, ya = _run_jax(jp, frames[:2])
        tb, yb = _run_port(tp, frames[:2])
        ja = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a)),
                                    jp.update_stage(ja, "rot", phase_inc=-0.7))
        tb = tp.update_stage(tb, "rot", phase_inc=-0.7)
        _, ya2 = _run_jax(jp, frames[2:], ja)
        _, yb2 = _run_port(tp, frames[2:], tb)
        for a, b in zip(ya + ya2, yb + yb2):
            np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-4)


def test_rotator_kernel_carry_matches_jax_across_a_retune():
    """The pallas route's carry comes from the ``rotator`` wrapper (the
    kernel writes it on the card): over five chained frames of ragged
    lengths, with a ``phase_inc`` retune after the second, each frame's
    output and the carried phase match the JAX stage in interpret mode."""
    rng = np.random.default_rng(27)
    frames = [_c64(rng, n) for n in (1000, 1001, 999, 1, 1000)]
    jp = J.Pipeline([J.rotator_stage(2.9, name="rot", impl="pallas")], np.complex64)
    tp = T.Pipeline([T.rotator_stage(2.9, name="rot", impl="pallas")], np.complex64)
    ja, tb = jp.init_carry(), tp.init_carry("cpu")
    for i, x in enumerate(frames):
        if i == 2:
            ja = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a)),
                                        jp.update_stage(ja, "rot", phase_inc=-0.7))
            tb = tp.update_stage(tb, "rot", phase_inc=-0.7)
        ja, (ya,) = _run_jax(jp, [x], ja)
        tb, (yb,) = _run_port(tp, [x], tb)
        np.testing.assert_allclose(yb, ya, rtol=1e-3, atol=1e-4)
        (jph, jinc), = ja
        (tph, tinc), = tb
        assert tph.shape == () and tph.dtype == torch.float32
        assert 0 <= float(tph) < 2 * np.pi
        assert float(tph) == pytest.approx(float(jph), abs=1e-5)
        assert float(tinc) == float(jinc)


# ---------------------------------------------------------------------------
# carries: leaf for leaf, and converted from the JAX package
# ---------------------------------------------------------------------------

def _fm_app_chain(m):
    return (j_front_end if m is J else t_front_end)(offset=100e3)


def _fm_kernel_chain(m, theta=-2 * np.pi * 100e3 / 1e6):
    return [m.rotator_stage(theta, name="tuner", impl="pallas"),
            m.fir_stage(firdes.lowpass(0.5 / 4 * 0.8, 128), decim=4, impl="pallas",
                        name="chan"),
            m.quad_demod_stage(250e3 / (2 * np.pi * 75e3), impl="pallas"),
            m.resample_stage(24, 125, impl="pallas")]


def _fm_plain_chain(m, theta=-2 * np.pi * 100e3 / 1e6):
    return [m.rotator_stage(theta, name="tuner"),
            m.fir_stage(firdes.lowpass(0.5 / 4 * 0.8, 128), decim=4, impl="poly",
                        name="chan"),
            m.quad_demod_stage(250e3 / (2 * np.pi * 75e3)),
            m.resample_stage(24, 125)]


@pytest.mark.parametrize("chain", ["app", "kernel", "bf16"])
def test_fm_carry_trees_match_jax_leaf_for_leaf(chain):
    taps = firdes.lowpass(0.1, 64).astype(np.float32)
    mk = {"app": _fm_app_chain, "kernel": _fm_kernel_chain,
          "bf16": lambda m: [m.fir_stage(taps, decim=4, impl="pallas",
                                         precision="bf16")]}[chain]
    a = _leaves(J.Pipeline(mk(J), np.complex64).init_carry())
    b = jax.tree_util.tree_leaves(T.Pipeline(mk(T), np.complex64).init_carry("cpu"))
    assert [x.shape for x in a] == [tuple(x.shape) for x in b]
    for x, y in zip(a, b):
        if x.dtype == ml_dtypes.bfloat16:
            assert y.dtype == torch.bfloat16
            np.testing.assert_array_equal(y.float().numpy(), x.astype(np.float32))
        else:
            assert x.dtype == y.numpy().dtype
            np.testing.assert_allclose(y.numpy(), x, rtol=1e-6, atol=1e-6)


def test_bf16_poly_carry_converts_from_jax():
    """A bf16 carried weight matrix converts bit for bit and both packages run
    on from it alike."""
    rng = np.random.default_rng(22)
    taps = firdes.lowpass(0.1, 64).astype(np.float32)
    frames = _frames(rng, 4, 400)
    jp = J.Pipeline([J.fir_stage(taps, decim=4, impl="pallas", precision="bf16")],
                    np.complex64)
    tp = T.Pipeline([T.fir_stage(taps, decim=4, impl="pallas", precision="bf16")],
                    np.complex64)
    ja, _ = _run_jax(jp, frames[:2])
    leaves = _leaves(ja)
    assert leaves[0].dtype == ml_dtypes.bfloat16
    tb = carry_from_numpy(tp, leaves, "cpu")
    assert tb[0][0].dtype == torch.bfloat16
    np.testing.assert_array_equal(tb[0][0].view(torch.uint16).numpy(),
                                  leaves[0].view(np.uint16))
    _, ya = _run_jax(jp, frames[2:], ja)
    _, yb = _run_port(tp, frames[2:], tb)
    for a, b in zip(ya, yb):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="leaf 0"):
        carry_from_numpy(tp, [leaves[0].astype(np.float32), leaves[1]], "cpu")


# ---------------------------------------------------------------------------
# both FM chains at a reduced frame
# ---------------------------------------------------------------------------

def _fm_iq(n, offset=100e3, fs=1e6):
    t = np.arange(n) / fs
    msg = np.sin(2 * np.pi * 1000.0 * t)
    return np.exp(1j * (2 * np.pi * 75e3 * np.cumsum(msg) / fs
                        + 2 * np.pi * offset * t)).astype(np.complex64)


@pytest.mark.parametrize("chain", ["app", "kernel", "plain"])
def test_fm_chain_matches_jax(chain):
    """3 frames of 8,000 samples of an FM tone at a 100 kHz offset: the
    audio agrees with the JAX chain to 1e-4 (unit-amplitude audio; both sides
    run the same float32 phase ramps)."""
    x = _fm_iq(3 * 8000)
    frames = [x[i * 8000:(i + 1) * 8000] for i in range(3)]
    mk = {"app": _fm_app_chain, "kernel": _fm_kernel_chain,
          "plain": _fm_plain_chain}[chain]
    jp, tp = _pair(mk, np.complex64, frames, rtol=0, atol=1e-4)
    assert tp.frame_multiple == 500 and tp.out_items(8000) == 384


def test_fm_app_chain_matches_kernel_chain():
    """The folded tuner (app) against the unfolded kernel chain after the
    filters' transient, at the reference's folded-vs-unfolded atol 5e-3."""
    x = _fm_iq(3 * 8000)
    frames = [x[i * 8000:(i + 1) * 8000] for i in range(3)]
    _, ya = _run_port(T.Pipeline(_fm_app_chain(T), np.complex64), frames)
    _, yk = _run_port(T.Pipeline(_fm_kernel_chain(T), np.complex64), frames)
    ya, yk = np.concatenate(ya), np.concatenate(yk)
    np.testing.assert_allclose(ya[100:], yk[100:], atol=5e-3)
