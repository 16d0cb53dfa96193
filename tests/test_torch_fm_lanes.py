"""The lane forms of ``poly_fir`` and ``quad_demod``, and the FM front end
served to many sessions, against the JAX package on the CPU.

The JAX package serves a batch of sessions through ``jax.vmap`` of its
receiver program (``futuresdr_tpu/serve/engine.py``), so a batch reaches its
Pallas kernels as ``jax.vmap`` of ``pallas_poly_fir`` and
``pallas_quad_demod``; the port runs the same batch as one launch of a lane
kernel (``poly_fir_lanes``, ``quad_demod_lanes`` in
``futuresdr_tpu_torch/ops/cuda_kernels.py``). On the CPU the port's lane
wrappers run their plain versions; the JAX side is ``jax.vmap`` of the Pallas
kernels in interpret mode, as ``tests/test_pallas.py`` runs them, each under
one ``jax.jit``. A complex lane runs on the JAX side as the stage's two real
passes. Inputs come from numpy with a seed. The CUDA kernels are held against
these plain versions, and bit for bit against one-stream launches, on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 28).

Tolerances, as ``tests/test_pallas.py`` and ``tests/test_torch_fm_stages.py``
state them for these kernels:

* ``poly_fir``: rtol 1e-4, atol 1e-4 (unit-variance data; the sums run in
  another order), in f32 and in bf16 mode, where both round samples and
  weights to bf16 and accumulate the exact products in f32;
* ``quad_demod``: rtol 1e-4, atol 1e-5 on the difference wrapped into
  ``(−π·gain, π·gain]`` (atan2 flips between ±π on a last-bit difference
  where ``Im z`` is about 0 and ``Re z < 0``);
* the served FM chain against the JAX FM stages: atol 1e-4 on the audio,
  the chain's tolerance in ``tests/test_torch_fm_stages.py`` (unit-amplitude
  audio; both sides run the same float32 phase ramps).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from futuresdr_tpu.dsp import firdes
from futuresdr_tpu.ops import pallas_kernels as pk
from futuresdr_tpu.ops import stages as J
from futuresdr_tpu_torch.ops import cuda_kernels as ck
from futuresdr_tpu_torch.ops import stages as T
from futuresdr_tpu_torch.serve import ServeEngine

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

L_MAX = 5
POLY_TOL = 1e-4
DEMOD_RTOL, DEMOD_ATOL = 1e-4, 1e-5
FM_ATOL = 1e-4
GAIN = 250e3 / (2 * np.pi * 75e3)
# the FM chain's two polyphase calls: (D, m, I, nq) of the channel filter and
# of the audio resampler (24/125, its default taps: m = 2)
POLY = {"channel": (4, 32, 1, 60), "resampler": (125, 2, 24, 4)}


def _c64(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _vmapped_poly_fir(precision, shared: bool):
    """The JAX serving plane's batch of ``pallas_poly_fir``: ``jax.vmap`` over
    the lanes' row matrices and, unless ``shared``, their weights."""
    def one(rows, W):
        return pk.pallas_poly_fir(rows, W, precision=precision)
    return jax.jit(jax.vmap(one, in_axes=(0, None if shared else 0)))


@functools.lru_cache(maxsize=None)
def _poly_case(kind: str, complex_stream: bool, shared: bool):
    """``L_MAX`` lanes of history, frame and weights (one W for every lane
    where ``shared``), each lane its own stream."""
    D, m, I, nq = POLY[kind]
    rng = np.random.default_rng(100 * D + m + 7 * complex_stream + 3 * shared)
    w_shape = (m + 1, D) if I == 1 else (m + 1, D, I)
    W = rng.standard_normal((1 if shared else L_MAX,) + w_shape).astype(np.float32)
    ext = _c64(rng, L_MAX, (m + nq) * D) if complex_stream else \
        rng.standard_normal((L_MAX, (m + nq) * D)).astype(np.float32)
    return ext, W


def _jax_poly_fir(ext, W, D, precision, shared):
    fn = _vmapped_poly_fir(precision, shared)
    w = jnp.asarray(W[0] if shared else W)

    def run(planes):
        return np.asarray(fn(jnp.asarray(planes.reshape(planes.shape[0], -1, D)), w))
    if np.iscomplexobj(ext):                       # the stage's two real passes
        return run(ext.real.copy()) + 1j * run(ext.imag.copy())
    return run(ext)


def _port_poly_args(ext, W, L, m, D, shared, precision):
    e = torch.from_numpy(ext[:L])
    w = torch.from_numpy(W[:1]).expand(L, *W.shape[1:]) if shared \
        else torch.from_numpy(W[:L])
    if precision == "bf16":
        w = w.to(torch.bfloat16)                   # the stage's carried bf16 weights
    return e[:, :m * D], e[:, m * D:], w


# (kind, complex stream, precision, shared W): both W in f32 with each lane's
# own W and one shared, complex and real streams; bf16 as the FM chain runs it
# (the channel filter's carried W a lane, the resampler's W shared)
POLY_CASES = [(k, c, None, s) for k in POLY for c in (True, False) for s in (False, True)] + \
    [("channel", True, "bf16", False), ("resampler", False, "bf16", True)]


@pytest.mark.parametrize("L", [1, 3, L_MAX])
@pytest.mark.parametrize("kind,complex_stream,precision,shared", POLY_CASES)
def test_poly_fir_lanes_matches_vmapped_pallas_poly_fir(kind, complex_stream, precision,
                                                        shared, L):
    """``poly_fir_lanes`` over L lanes against ``jax.vmap`` of
    ``pallas_poly_fir`` (interpret mode); a shared W goes to the port as one
    W expanded (stride 0)."""
    D, m, I, nq = POLY[kind]
    ext, W = _poly_case(kind, complex_stream, shared)
    ref = _jax_poly_fir(ext, W, D, precision, shared)
    hist, x, w = _port_poly_args(ext, W, L, m, D, shared, precision)
    got = ck.poly_fir_lanes(hist, x, w, precision).numpy()
    assert got.dtype == ext.dtype and got.shape == ((L, nq) if I == 1 else (L, nq, I))
    np.testing.assert_allclose(got, ref[:L], rtol=POLY_TOL, atol=POLY_TOL)


@pytest.mark.parametrize("kind,complex_stream,precision,shared", POLY_CASES)
def test_poly_fir_lanes_plain_equals_one_stream_calls(kind, complex_stream, precision, shared):
    """Each lane of the lane plain version equals the one-stream plain call on
    its row bit for bit (the kernels' contract, which the card checks on
    launches)."""
    D, m, I, nq = POLY[kind]
    ext, W = _poly_case(kind, complex_stream, shared)
    hist, x, w = _port_poly_args(ext, W, L_MAX, m, D, shared, precision)
    got = ck.poly_fir_lanes_plain(hist, x, w, precision)
    for i in range(L_MAX):
        assert torch.equal(got[i], ck.poly_fir_plain(hist[i], x[i], w[i], precision)), i


_vmapped_quad_demod = jax.jit(jax.vmap(lambda p, x: pk.pallas_quad_demod(p, x, GAIN)))


def _demod_case(n):
    rng = np.random.default_rng(n)
    return _c64(rng, L_MAX), _c64(rng, L_MAX, n)


@pytest.mark.parametrize("L", [1, 3, L_MAX])
@pytest.mark.parametrize("n", [300, 129])
def test_quad_demod_lanes_matches_vmapped_pallas_quad_demod(n, L):
    """``quad_demod_lanes`` over L lanes, each from its own carry sample,
    against ``jax.vmap`` of ``pallas_quad_demod`` (interpret mode); the next
    carries are each lane's last sample."""
    prev, x = _demod_case(n)
    ref = np.asarray(_vmapped_quad_demod(jnp.asarray(prev), jnp.asarray(x)))[:L]
    got, last = ck.quad_demod_lanes(torch.from_numpy(prev[:L]), torch.from_numpy(x[:L]), GAIN)
    got = got.numpy()
    assert got.dtype == np.float32 and got.shape == (L, n)
    period = 2 * np.pi * GAIN
    d = got - ref
    np.testing.assert_allclose(ref + d - period * np.round(d / period), ref,
                               rtol=DEMOD_RTOL, atol=DEMOD_ATOL)
    np.testing.assert_array_equal(last.numpy(), x[:L, -1])


def test_quad_demod_lanes_plain_equals_one_stream_calls():
    prev, x = (torch.from_numpy(a) for a in _demod_case(300))
    y, last = ck.quad_demod_lanes_plain(prev, x, GAIN)
    for i in range(L_MAX):
        yi, li = ck.quad_demod_plain(prev[i], x[i], GAIN)
        assert torch.equal(y[i], yi) and torch.equal(last[i], li), i
    y0, last0 = ck.quad_demod_lanes_plain(prev, x[:, :0], GAIN)
    assert y0.shape == (L_MAX, 0) and torch.equal(last0, prev)
    e, le = ck.quad_demod_lanes_plain(prev[:0], x[:0], GAIN)
    assert e.shape == (0, 300) and le.shape == (0,)


def test_lane_forms_refuse_bad_shapes():
    x = torch.zeros(2, 40, dtype=torch.complex64)
    with pytest.raises(TypeError, match="prev"):
        ck.quad_demod_lanes(torch.zeros(3, dtype=torch.complex64), x, 1.0)
    with pytest.raises(TypeError, match="W must be"):
        ck.poly_fir_lanes(torch.zeros(2, 4, dtype=torch.complex64), x, torch.zeros(3, 2, 4))
    with pytest.raises(ValueError, match="multiple of D"):
        ck.poly_fir_lanes(torch.zeros(2, 3, dtype=torch.complex64), x, torch.zeros(2, 2, 3))
    with pytest.raises(ValueError, match="hist"):
        ck.poly_fir_lanes(torch.zeros(2, 5, dtype=torch.complex64), x, torch.zeros(2, 2, 4))


# ---------------------------------------------------------------------------
# the FM front end served to many sessions
# ---------------------------------------------------------------------------

FS = 1e6
FRAME = 2000                      # a multiple of 4 × 125: 96 audio samples a frame
N_FRAMES = 6
# each session's station: (offset, tone); session 2 joins before frame 2,
# session 1 leaves after frame 3
STATIONS = ((100e3, 1000.0), (-150e3, 700.0), (300e3, 1300.0))
JOIN, LEAVE = {2: 2}, {1: 4}


def _fm_chain(m, theta=-2 * np.pi * 100e3 / FS):
    """``chip_smoke.py``'s ``fm_stages("kernel")``: the unfolded FM front end
    pinned to the hand kernels."""
    return [m.rotator_stage(theta, name="tuner", impl="pallas"),
            m.fir_stage(firdes.lowpass(0.5 / 4 * 0.8, 128), decim=4, impl="pallas",
                        name="chan"),
            m.quad_demod_stage(GAIN, impl="pallas"),
            m.resample_stage(24, 125, impl="pallas")]


def _feed():
    """The shared wideband feed: each station an FM-modulated tone at 75 kHz
    deviation at its offset, summed; frames of ``FRAME`` samples."""
    t = np.arange(N_FRAMES * FRAME) / FS
    x = np.zeros(t.shape, np.complex128)
    for off, tone in STATIONS:
        msg = np.sin(2 * np.pi * tone * t)
        x += np.exp(1j * (2 * np.pi * 75e3 * np.cumsum(msg) / FS + 2 * np.pi * off * t))
    x = x.astype(np.complex64)
    return [x[j * FRAME:(j + 1) * FRAME] for j in range(N_FRAMES)]


def _span(i):
    return range(JOIN.get(i, 0), LEAVE.get(i, N_FRAMES))


def _theta(i):
    return -2 * np.pi * STATIONS[i][0] / FS


def test_fm_front_end_served_to_many_sessions():
    """Three sessions of the FM kernel chain, each tuned to its own station by
    its own rotator increment (a lane retune at admission), share one
    wideband feed through the engine; one joins mid-stream and one leaves.
    Each session's audio equals its bare ``Pipeline`` (built at its offset)
    bit for bit, and the JAX package's FM stages per session at the chain's
    tolerance; the batch reached the lane forms through the vmap rules."""
    frames = _feed()
    eng = ServeEngine(T.Pipeline(_fm_chain(T), np.complex64), frame_size=FRAME,
                      app="fm_lanes", buckets=(4,), queue_frames=8, device="cpu")
    seen = []
    lane_plain, demod_plain = ck.poly_fir_lanes_plain, ck.quad_demod_lanes_plain

    def watch(name, fn):
        def call(*a, **k):
            seen.append((name, tuple(a[1].shape)))
            return fn(*a, **k)
        return call

    live, out = {}, {i: [] for i in range(len(STATIONS))}
    ck.poly_fir_lanes_plain = watch("poly_fir_lanes", lane_plain)
    ck.quad_demod_lanes_plain = watch("quad_demod_lanes", demod_plain)
    try:
        for j in range(N_FRAMES):
            for i in range(len(STATIONS)):
                if j == JOIN.get(i, 0):
                    live[i] = eng.admit(tenant=f"t{i}")
                    eng.retune(live[i].sid, "tuner", phase_inc=_theta(i))
                if j == LEAVE.get(i):
                    out[i] += eng.results(live[i].sid)
                    eng.close(live.pop(i).sid)
            for i, s in live.items():
                assert eng.submit(s.sid, frames[j])
            assert eng.step() == len(live)
            for i, s in live.items():
                out[i] += eng.results(s.sid)
    finally:
        ck.poly_fir_lanes_plain, ck.quad_demod_lanes_plain = lane_plain, demod_plain
    assert eng.compiles == 1 and eng.dispatches == N_FRAMES
    # every dispatch ran the four-lane batch through both lane forms: the
    # channel filter on [4, 2000], the demod on [4, 500], the resampler on [4, 500]
    assert seen.count(("poly_fir_lanes", (4, FRAME))) == N_FRAMES
    assert seen.count(("poly_fir_lanes", (4, FRAME // 4))) == N_FRAMES
    assert seen.count(("quad_demod_lanes", (4, FRAME // 4))) == N_FRAMES

    jp = J.Pipeline(_fm_chain(J), np.complex64)
    jfn = jax.jit(jp.fn())
    for i in range(len(STATIONS)):
        span = _span(i)
        assert len(out[i]) == len(span)
        bare = T.Pipeline(_fm_chain(T, _theta(i)), np.complex64)
        fn, carry = bare.compile(FRAME, "cpu", donate=False)
        jcarry = jax.tree_util.tree_map(
            np.asarray, jp.update_stage(jp.init_carry(), "tuner", phase_inc=_theta(i)))
        for got, j in zip(out[i], span):
            carry, want = fn(carry, torch.from_numpy(frames[j]))
            assert got.dtype == np.float32 and got.shape == (FRAME * 24 // 500,)
            assert np.array_equal(got, want.numpy()), (i, j)
            jcarry, jy = jfn(jcarry, jnp.asarray(frames[j]))
            jcarry = jax.tree_util.tree_map(np.asarray, jcarry)
            np.testing.assert_allclose(got, np.asarray(jy), rtol=0, atol=FM_ATOL)
