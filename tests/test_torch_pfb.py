"""The port's PFB channelizer and the last single-chain stages against the JAX
package's, on the CPU.

The ``pfb`` kernel's plain version (``cuda_kernels.pfb_plain``, reached through
the wrapper on CPU tensors) against the JAX ``pallas_pfb`` in interpret mode
at the shapes and tolerances of ``tests/test_precision.py`` and
``tests/test_pallas.py``; ``channelizer_stage`` on both routes over chained
frames against the JAX stage; its ``lower`` and ``update`` hooks and a carry
moved over from JAX mid-stream; the deinterleaved flowgraph against the JAX
host ``PfbChannelizer`` block; and ``fftshift``, ``log10``, ``apply``,
``moving_avg``, ``agc`` and ``lora_demod`` against their JAX stages. Inputs
come from numpy with a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import futuresdr_tpu as jfs
from futuresdr_tpu import blocks as jblocks
from futuresdr_tpu.blocks.pfb import pfb_default_taps as j_default_taps
from futuresdr_tpu.ops import stages as J
from futuresdr_tpu.ops.pallas_kernels import pallas_pfb
from futuresdr_tpu_torch import Flowgraph, Runtime
from futuresdr_tpu_torch.blocks import (PfbChannelizer, StreamDeinterleaver, VectorSink,
                                        VectorSource, pfb_default_taps)
from futuresdr_tpu_torch.convert import carry_from_numpy
from futuresdr_tpu_torch.ops import cuda_kernels as ck
from futuresdr_tpu_torch.ops import stages as T
from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)


def _c64(rng, n):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


def _snr_db(got, ref):
    err = float(np.mean(np.abs(got - ref) ** 2))
    return 10 * np.log10(float(np.mean(np.abs(ref) ** 2)) / max(err, 1e-30))


def _flat(rows, K, N):
    """``(hist, x)`` of the flat stream whose commutated rows are ``rows``:
    ``rows[s, c] = ext[s·N + N−1−c]``."""
    ext = np.ascontiguousarray(rows[:, ::-1]).reshape(-1)
    return torch.from_numpy(ext[:(K - 1) * N].copy()), torch.from_numpy(ext[(K - 1) * N:].copy())


def _pfb_pair(t, K, N, seed, precision=None, block=None, taps_scale=1.0):
    """(port plain output, JAX Pallas output) on one random input."""
    rng = np.random.default_rng(seed)
    taps = (rng.standard_normal((K, N)) * taps_scale).astype(np.float32)
    rows = (rng.standard_normal((t + K - 1, N))
            + 1j * rng.standard_normal((t + K - 1, N))).astype(np.complex64)
    ref = np.asarray(pallas_pfb(jnp.asarray(rows), jnp.asarray(taps), block=block,
                                precision=precision))
    hist, x = _flat(rows, K, N)
    got = ck.pfb(hist, x, torch.from_numpy(taps), precision).numpy()
    assert got.shape == ref.shape == (t, N) and got.dtype == ref.dtype
    return got, ref


# ---------------------------------------------------------------------------
# the kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,block", [(37, 8), (64, 64), (200, 256), (1, 4), (300, 512)])
def test_pfb_plain_matches_pallas_pfb(t, block):
    """The shapes of test_precision.py (ragged tails included) and
    test_pallas.py's t = 300 with a block larger than the workload."""
    got, ref = _pfb_pair(t, 4, 16, seed=t, block=block)
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("t,K,N", [(50, 1, 16), (40, 3, 5), (33, 4, 24)])
def test_pfb_plain_single_tap_and_non_power_of_two(t, K, N):
    """K = 1 (an empty history) and channel counts that are not powers of two
    (the kernel's direct-DFT branch)."""
    got, ref = _pfb_pair(t, K, N, seed=100 + N)
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)


def test_pfb_plain_bf16_matches_pallas_bf16_and_stays_in_band():
    """bf16 against the JAX kernel's bf16 (rows, taps, v and the cos/sin
    matrices rounded, products accumulated in float32): >= 100 dB (measured
    ~147 dB; the sums differ in order only); and against float32 >= 35 dB
    (the band of test_precision.py)."""
    got, ref = _pfb_pair(512, 4, 32, seed=2, precision="bf16", taps_scale=0.25)
    assert _snr_db(got, ref) >= 100.0
    f32, _ = _pfb_pair(512, 4, 32, seed=2, taps_scale=0.25)
    assert _snr_db(got, f32) >= 35.0


def test_pfb_plain_takes_transposed_and_bf16_taps():
    """The stage passes its [N, K] carry transposed, in bf16 under
    precision='bf16': both give the contiguous f32 result."""
    rng = np.random.default_rng(5)
    K, N, t = 3, 8, 20
    hc = rng.standard_normal((N, K)).astype(np.float32)
    hist, x = torch.from_numpy(_c64(rng, (K - 1) * N)), torch.from_numpy(_c64(rng, t * N))
    ref = ck.pfb_plain(hist, x, torch.from_numpy(np.ascontiguousarray(hc.T)))
    torch.testing.assert_close(ck.pfb(hist, x, torch.from_numpy(hc).t()), ref)
    hb = torch.from_numpy(hc).to(torch.bfloat16)
    torch.testing.assert_close(ck.pfb(hist, x, hb.t()),
                               ck.pfb_plain(hist, x, hb.float().t().contiguous()))


def test_pfb_wrapper_rejects_bad_shapes():
    taps = torch.ones(3, 8)
    with pytest.raises(ValueError, match="multiple of N"):
        ck.pfb(torch.zeros(16, dtype=torch.complex64), torch.zeros(12, dtype=torch.complex64),
               taps)
    with pytest.raises(ValueError, match="hist"):
        ck.pfb(torch.zeros(8, dtype=torch.complex64), torch.zeros(16, dtype=torch.complex64),
               taps)
    with pytest.raises(TypeError, match="complex64"):
        ck.pfb(torch.zeros(16), torch.zeros(16), taps)


# ---------------------------------------------------------------------------
# channelizer_stage against the JAX stage
# ---------------------------------------------------------------------------

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


def _leaves(tree):
    return [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("impl", ["matmul", "pallas"])
@pytest.mark.parametrize("N,taps_seed", [(16, 3), (64, None)])
def test_channelizer_stage_matches_jax_over_chained_frames(impl, N, taps_seed):
    """N = 16 with a random 56-tap prototype (K = 4, the last branch padded)
    and PFB-64 with the default 768-tap prototype (K = 12); 3 chained frames
    of 32 rows, rtol and atol 2e-3 of the reference tests."""
    rng = np.random.default_rng(N)
    taps = None if taps_seed is None else \
        np.random.default_rng(taps_seed).standard_normal(56).astype(np.float32)
    jp = J.Pipeline([J.channelizer_stage(N, taps, impl=impl)], np.complex64)
    tp = T.Pipeline([T.channelizer_stage(N, taps, impl=impl)], np.complex64)
    assert (tp.frame_multiple, tp.ratio, tp.out_dtype) == \
        (jp.frame_multiple, jp.ratio, jp.out_dtype)
    frames = [_c64(rng, 32 * N) for _ in range(3)]
    jc, ya = _run_jax(jp, frames)
    tc, yb = _run_port(tp, frames)
    for a, b in zip(ya, yb):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(b, a, rtol=2e-3, atol=2e-3)
    for a, b in zip(_leaves(jc), [t.numpy() for t in jax.tree_util.tree_leaves(tc)]):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_channelizer_routes_agree_and_auto_takes_matmul_on_the_cpu(monkeypatch):
    """pallas vs matmul at >= 80 dB (test_precision.py's bar); on the CPU
    ``auto`` takes the matmul route and never reaches the kernel wrapper."""
    rng = np.random.default_rng(13)
    frames = [_c64(rng, 4096) for _ in range(3)]
    _, ym = _run_port(T.Pipeline([T.channelizer_stage(16, impl="matmul")], np.complex64),
                      frames)
    _, yp = _run_port(T.Pipeline([T.channelizer_stage(16, impl="pallas")], np.complex64),
                      frames)
    assert _snr_db(np.concatenate(yp), np.concatenate(ym)) >= 80.0

    def refuse(*a, **k):
        raise AssertionError("auto reached the pfb kernel on the CPU")

    monkeypatch.setattr(ck, "pfb", refuse)
    _, ya = _run_port(T.Pipeline([T.channelizer_stage(16)], np.complex64), frames)
    np.testing.assert_array_equal(np.concatenate(ya), np.concatenate(ym))


@pytest.mark.parametrize("impl", ["matmul", "pallas"])
def test_channelizer_bf16_matches_jax_bf16(impl):
    """precision='bf16' carries bf16 branch taps (the same bits as JAX's); the
    pallas route runs the kernel's bf16 mode, the matmul route float32 with
    the bf16 taps, in both packages."""
    rng = np.random.default_rng(21)
    frames = [_c64(rng, 32 * 16) for _ in range(3)]
    jp = J.Pipeline([J.channelizer_stage(16, impl=impl, precision="bf16")], np.complex64)
    tp = T.Pipeline([T.channelizer_stage(16, impl=impl, precision="bf16")], np.complex64)
    jc, ya = _run_jax(jp, frames)
    tc, yb = _run_port(tp, frames)
    branch = tc[0][0]
    assert branch.dtype == torch.bfloat16 and tuple(branch.shape) == (16, 12)
    np.testing.assert_array_equal(branch.float().numpy(),
                                  np.asarray(jc[0][0]).astype(np.float32))
    assert _snr_db(np.concatenate(yb), np.concatenate(ya)) >= 100.0


def test_channelizer_lower_hook():
    st = T.channelizer_stage(16, impl="matmul")
    low = st.lower("bf16")
    assert low is not None and low.route == ("matmul", None, "bf16")
    assert low.init_carry(np.complex64, "cpu")[0].dtype == torch.bfloat16
    assert st.lower("int8") is None
    with pytest.raises(ValueError, match="int8"):
        T.channelizer_stage(16, precision="int8")


@pytest.mark.parametrize("precision", [None, "bf16"])
def test_channelizer_carry_moves_over_from_jax_mid_stream(precision):
    """Two frames through JAX, its carry converted with carry_from_numpy, two
    more through the port: the same as JAX running all four."""
    rng = np.random.default_rng(31)
    frames = [_c64(rng, 32 * 16) for _ in range(4)]
    jp = J.Pipeline([J.channelizer_stage(16, impl="pallas", precision=precision)],
                    np.complex64)
    tp = T.Pipeline([T.channelizer_stage(16, impl="pallas", precision=precision)],
                    np.complex64)
    jc, ya = _run_jax(jp, frames)
    jc2, _ = _run_jax(jp, frames[:2])
    carry = carry_from_numpy(tp, _leaves(jc2), "cpu")
    _, yb = _run_port(tp, frames[2:], carry)
    for a, b in zip(ya[2:], yb):
        np.testing.assert_allclose(b, a, rtol=2e-3, atol=2e-3)


def test_channelizer_tap_swap_matches_jax_with_the_new_prototype():
    """update(taps=…) after two frames: the third frame equals the JAX stage
    built with the new prototype, fed the port's history."""
    rng = np.random.default_rng(41)
    N = 16
    taps_a = rng.standard_normal(64).astype(np.float32)
    taps_b = rng.standard_normal(60).astype(np.float32)     # same K = 4
    frames = [_c64(rng, 32 * N) for _ in range(3)]
    tp = T.Pipeline([T.channelizer_stage(N, taps_a, impl="pallas")], np.complex64)
    carry, _ = _run_port(tp, frames[:2])
    carry = tp.update_stage(carry, 0, taps=taps_b)
    _, (got,) = _run_port(tp, frames[2:], carry)
    jp = J.Pipeline([J.channelizer_stage(N, taps_b, impl="matmul")], np.complex64)
    jcarry = (jp.init_carry()[0][0], jnp.asarray(carry[0][1].numpy()))
    _, (ref,) = _run_jax(jp, frames[2:], (jcarry,))
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)
    with pytest.raises(ValueError, match="taps a branch"):
        tp.update_stage(carry, 0, taps=taps_b[:40])


def test_default_taps_match_jax():
    for n in (4, 16, 64):
        np.testing.assert_array_equal(pfb_default_taps(n), j_default_taps(n))
    assert len(pfb_default_taps(64)) == 768


# ---------------------------------------------------------------------------
# the deinterleaved flowgraph against the host PfbChannelizer block
# ---------------------------------------------------------------------------

def _jax_block_outputs(x, N, taps):
    fg = jfs.Flowgraph()
    src = jblocks.VectorSource(x)
    chan = jblocks.PfbChannelizer(N, taps)
    sinks = [jblocks.VectorSink(np.complex64) for _ in range(N)]
    fg.connect_stream(src, "out", chan, "in")
    for i, s in enumerate(sinks):
        fg.connect_stream(chan, f"out{i}", s, "in")
    jfs.Runtime().run(fg)
    return [s.items() for s in sinks]


@pytest.mark.parametrize("N,impl", [(4, "pallas"), (16, "auto")])
def test_deinterleaved_flowgraph_matches_jax_pfb_block(N, impl):
    """VectorSource -> TpuKernel(channelizer) -> StreamDeinterleaver(N) -> N
    VectorSinks on the port's runtime against the JAX host block (and the
    port's copy of it) on the same input, at test_tpu_stages.py's rtol 1e-3 /
    atol 1e-4. The stream ends in a partial frame."""
    taps = pfb_default_taps(N)
    rng = np.random.default_rng(8)
    x = _c64(rng, 4 * 1024 + 3 * N + 1)
    fg = Flowgraph()
    kern = TpuKernel([T.channelizer_stage(N, taps, impl=impl)], np.complex64,
                     frame_size=1024, inst=TpuInstance("cpu"))
    dein = StreamDeinterleaver(np.complex64, N)
    sinks = [VectorSink(np.complex64) for _ in range(N)]
    fg.connect(VectorSource(x), kern, dein)
    for i, s in enumerate(sinks):
        fg.connect_stream(dein, f"out{i}", s, "in")
    Runtime().run(fg)

    host = Flowgraph()
    chan = PfbChannelizer(N, taps)
    hsinks = [VectorSink(np.complex64) for _ in range(N)]
    host.connect(VectorSource(x), chan)
    for i, s in enumerate(hsinks):
        host.connect_stream(chan, f"out{i}", s, "in")
    Runtime().run(host)

    ref = _jax_block_outputs(x, N, taps)
    for c in range(N):
        got = sinks[c].items()
        assert len(got) == len(x) // N == len(ref[c]) == len(hsinks[c].items())
        np.testing.assert_allclose(got, ref[c], rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(hsinks[c].items(), ref[c], rtol=1e-5, atol=1e-6)


def test_channelizer_routes_tone_to_its_channel():
    """A tone at channel 3's centre lands in output 3 with >= 100x the power
    of any other (test_dsp_blocks.py's bar), through the stage."""
    N, c = 8, 3
    x = np.exp(1j * 2 * np.pi * (c / N) * np.arange(1 << 14)).astype(np.complex64)
    _, (y,) = _run_port(T.Pipeline([T.channelizer_stage(N, impl="pallas")], np.complex64),
                        [x])
    powers = np.mean(np.abs(y.reshape(-1, N)[64:]) ** 2, axis=0)
    assert np.argmax(powers) == c and powers[c] > 100 * np.delete(powers, c).max()


# ---------------------------------------------------------------------------
# the other single-chain stages
# ---------------------------------------------------------------------------

def _pair(jstages, tstages, in_dtype, frames, rtol, atol):
    jp, tp = J.Pipeline(jstages, in_dtype), T.Pipeline(tstages, in_dtype)
    assert (tp.frame_multiple, tp.ratio, tp.out_dtype) == \
        (jp.frame_multiple, jp.ratio, jp.out_dtype)
    _, ya = _run_jax(jp, frames)
    _, yb = _run_port(tp, frames)
    for a, b in zip(ya, yb):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", ["ones", "noise"])
def test_moving_avg_stage_matches_jax_over_chained_frames(case):
    """test_tpu_stages.py's case (ones, decay 0.5: converges to 1) and
    squared noise at decay 0.3, 4 chained frames of 4 rows."""
    rng = np.random.default_rng(51)
    if case == "ones":
        frames, decay = [np.ones(256, np.float32) for _ in range(4)], 0.5
    else:
        frames = [rng.standard_normal(256).astype(np.float32) ** 2 for _ in range(4)]
        decay = 0.3
    _pair([J.moving_avg_stage(64, decay=decay)], [T.moving_avg_stage(64, decay=decay)],
          np.float32, frames, 1e-6, 1e-6)
    if case == "ones":
        _, y = _run_port(T.Pipeline([T.moving_avg_stage(64, decay)], np.float32), frames)
        assert abs(y[-1][-64:].mean() - 1.0) < 1e-3


def test_fftshift_log10_and_apply_match_jax():
    rng = np.random.default_rng(52)
    frames = [_c64(rng, 4 * 128) for _ in range(3)]
    _pair([J.fftshift_stage(128), J.apply_stage(lambda v: v * 2.0),
           J.mag2_stage(), J.log10_stage()],
          [T.fftshift_stage(128), T.apply_stage(lambda v: v * 2.0),
           T.mag2_stage(), T.log10_stage()],
          np.complex64, frames, 1e-5, 1e-5)
    # the floor: XLA forms log10 as ln(x)/ln(10), a last-bit apart from torch
    zeros = [np.zeros(64, np.float32)]
    _pair([J.log10_stage(20.0, 1e-12)], [T.log10_stage(20.0, 1e-12)],
          np.float32, zeros, 1e-6, 0)


def test_agc_stage_matches_jax():
    """test_tpu_stages.py's case: a 0.01-amplitude tone, rate 5, 64-sample
    blocks, 4096-sample frames; the gain converges to 100."""
    x = (0.01 * np.exp(1j * 2 * np.pi * 0.01 * np.arange(32768))).astype(np.complex64)
    frames = list(x.reshape(-1, 4096))
    _pair([J.agc_stage(reference=1.0, rate=5.0, block=64)],
          [T.agc_stage(reference=1.0, rate=5.0, block=64)],
          np.complex64, frames, 1e-5, 1e-6)
    _, y = _run_port(T.Pipeline([T.agc_stage(reference=1.0, rate=5.0, block=64)],
                                np.complex64), frames)
    assert abs(np.abs(y[-1][-1024:]).mean() - 1.0) < 0.05


def test_lora_demod_stage_matches_jax():
    from futuresdr_tpu.models.lora.phy import _upchirp
    sf, n = 7, 1 << 7
    symbols = np.array([0, 17, 64, 127, 3, 99], dtype=np.int64)
    sig = np.concatenate([_upchirp(n, int(s)) for s in symbols]).astype(np.complex64)
    rng = np.random.default_rng(53)
    noisy = (sig + 0.3 * _c64(rng, len(sig))).astype(np.complex64)
    for x in (sig, noisy):
        _pair([J.lora_demod_stage(sf)], [T.lora_demod_stage(sf)], np.complex64, [x], 0, 0)
    _, (y,) = _run_port(T.Pipeline([T.lora_demod_stage(sf)], np.complex64), [sig])
    np.testing.assert_array_equal(y, symbols)
