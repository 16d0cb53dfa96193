"""The port's kernel plain versions against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain versions (``*_plain`` in
``futuresdr_tpu_torch/ops/cuda_kernels.py``); the JAX kernels run in interpret
mode, as ``tests/test_pallas.py`` runs them. Inputs come from numpy with a
seed. The CUDA kernels themselves are held against the plain versions on the
card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal as sps

from futuresdr_tpu.ops import pallas_kernels as pk
from futuresdr_tpu_torch.ops import cuda_kernels as ck

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

# The JAX kernels, still in interpret mode, each under one jit: one XLA
# program per shape, where an eager interpret-mode call compiles each of its
# operations apart (about twice the time).
pallas_fir = jax.jit(pk.pallas_fir, static_argnames=("block", "interpret", "precision"))
pallas_fir_continue = jax.jit(pk.pallas_fir_continue, static_argnames=("block", "precision"))
pallas_fir_fft = jax.jit(pk.pallas_fir_fft,
                         static_argnames=("n_fft", "block", "interpret", "precision"))


def _c64(rng, n):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


def _snr_db(got, ref):
    err = float(np.mean(np.abs(got - ref) ** 2))
    return 10 * np.log10(float(np.mean(np.abs(ref) ** 2)) / max(err, 1e-30))


@pytest.mark.parametrize("nt", [16, 24, 64])
def test_fir_plain_matches_pallas_fir(nt):
    rng = np.random.default_rng(nt)
    taps = rng.standard_normal(nt).astype(np.float32)
    x = rng.standard_normal(8192).astype(np.float32)
    ref = np.asarray(pallas_fir(jnp.asarray(x), taps, block=2048))
    got = ck.fir(torch.from_numpy(x), torch.from_numpy(taps)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, sps.lfilter(taps, 1.0, x), rtol=1e-4, atol=1e-4)


def test_fir_plain_block_boundaries():
    """Outputs at the JAX kernel's block boundaries read the previous block's
    tail; the port's tile-free plain version must give the same."""
    taps = np.ones(8, np.float32)
    x = np.arange(4096 * 3, dtype=np.float32)
    ref = np.asarray(pallas_fir(jnp.asarray(x), taps, block=4096))
    got = ck.fir(torch.from_numpy(x), torch.from_numpy(taps)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("nt,complex_stream,n", [(16, True, 4096), (24, True, 3000),
                                                 (64, False, 5000), (64, True, 2048)])
def test_fir_continue_plain_matches_pallas(nt, complex_stream, n):
    rng = np.random.default_rng(nt + n)
    taps = rng.standard_normal(nt).astype(np.float32)
    if complex_stream:
        hist, x = _c64(rng, nt - 1), _c64(rng, n)
    else:
        hist = rng.standard_normal(nt - 1).astype(np.float32)
        x = rng.standard_normal(n).astype(np.float32)
    ref = np.asarray(pallas_fir_continue(jnp.asarray(hist), jnp.asarray(x), taps,
                                         block=1024))
    got = ck.fir_continue(torch.from_numpy(hist), torch.from_numpy(x),
                          torch.from_numpy(taps)).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_fir_continue_plain_bf16_matches_pallas_bf16():
    """bf16 mode rounds samples and taps to bf16 and accumulates their
    (exact) products in f32, as the JAX kernel does: the two agree to f32
    summation-order rounding (atol 1e-4 on unit-variance data)."""
    rng = np.random.default_rng(7)
    taps = rng.standard_normal(64).astype(np.float32)
    hist, x = _c64(rng, 63), _c64(rng, 4096)
    ref = np.asarray(pallas_fir_continue(jnp.asarray(hist), jnp.asarray(x), taps,
                                         block=1024, precision="bf16"))
    got = ck.fir_continue(torch.from_numpy(hist), torch.from_numpy(x),
                          torch.from_numpy(taps), precision="bf16").numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    f32 = ck.fir_continue(torch.from_numpy(hist), torch.from_numpy(x),
                          torch.from_numpy(taps)).numpy()
    assert np.max(np.abs(got - f32)) > 1e-4          # the bf16 mode really rounds


@pytest.mark.parametrize("n_fft,nt,rows,block", [(128, 17, 7, 3), (256, 33, 5, 2),
                                                 (256, 17, 9, 4)])
def test_fir_fft_plain_matches_pallas_fir_fft(n_fft, nt, rows, block):
    rng = np.random.default_rng(n_fft + nt + rows)
    taps = rng.standard_normal(nt).astype(np.float32)
    hist, x = _c64(rng, nt - 1), _c64(rng, n_fft * rows)
    ref = np.asarray(pallas_fir_fft(jnp.asarray(hist), jnp.asarray(x),
                                    jnp.asarray(taps), n_fft, block=block))
    got = ck.fir_fft(torch.from_numpy(hist), torch.from_numpy(x),
                     torch.from_numpy(taps), n_fft).numpy()
    assert got.dtype == np.complex64 and got.shape == ref.shape
    assert _snr_db(got, ref) >= 80.0
    filt = sps.lfilter(taps, 1.0, np.concatenate([hist, x]))[nt - 1:]
    comp = np.fft.fft(filt.reshape(-1, n_fft), axis=1).reshape(-1)
    assert _snr_db(got, comp) >= 80.0


def test_fir_fft_plain_real_stream_matches_pallas():
    rng = np.random.default_rng(11)
    taps = rng.standard_normal(33).astype(np.float32)
    hist = rng.standard_normal(32).astype(np.float32)
    x = rng.standard_normal(256 * 4).astype(np.float32)
    ref = np.asarray(pallas_fir_fft(jnp.asarray(hist), jnp.asarray(x),
                                    jnp.asarray(taps), 256, block=2))
    got = ck.fir_fft(torch.from_numpy(hist), torch.from_numpy(x),
                     torch.from_numpy(taps), 256).numpy()
    assert _snr_db(got, ref) >= 80.0


def test_fir_fft_plain_bf16_against_pallas_bf16():
    """bf16 mode: the JAX kernel also rounds its DFT matrix to bf16, the
    port keeps its twiddles in f32, so the two agree to bf16 rounding:
    SNR >= 40 dB between them, each >= 40 dB from the f32 result."""
    rng = np.random.default_rng(12)
    taps = rng.standard_normal(33).astype(np.float32)
    # the shapes of the (256, 33, 5, 2) case above, whose f32 program this
    # reuses
    hist, x = _c64(rng, 32), _c64(rng, 256 * 5)
    args = (jnp.asarray(hist), jnp.asarray(x), jnp.asarray(taps), 256)
    ref_bf = np.asarray(pallas_fir_fft(*args, block=2, precision="bf16"))
    ref_32 = np.asarray(pallas_fir_fft(*args, block=2))
    t = (torch.from_numpy(hist), torch.from_numpy(x), torch.from_numpy(taps), 256)
    got_bf = ck.fir_fft(*t, precision="bf16").numpy()
    assert _snr_db(got_bf, ref_bf) >= 40.0
    assert _snr_db(got_bf, ref_32) >= 40.0
    assert _snr_db(got_bf, ck.fir_fft(*t).numpy()) < 80.0     # it really rounds


def test_fir_fft_plain_non_power_of_two():
    """Any n_fft, as the JAX stage accepts: the plain version's DFT with the
    mod-N phase index against numpy."""
    rng = np.random.default_rng(13)
    taps = rng.standard_normal(20).astype(np.float32)
    hist, x = _c64(rng, 19), _c64(rng, 300 * 3)
    got = ck.fir_fft(torch.from_numpy(hist), torch.from_numpy(x),
                     torch.from_numpy(taps), 300).numpy()
    filt = sps.lfilter(taps, 1.0, np.concatenate([hist, x]))[19:]
    assert _snr_db(got, np.fft.fft(filt.reshape(-1, 300), axis=1).reshape(-1)) >= 80.0


@pytest.mark.parametrize("bad", ["rows", "taps", "hist", "dtype", "precision"])
def test_wrappers_reject_bad_arguments(bad):
    x = torch.zeros(256, dtype=torch.complex64)
    hist = torch.zeros(15, dtype=torch.complex64)
    taps = torch.ones(16)
    if bad == "rows":
        x = torch.zeros(250, dtype=torch.complex64)
    elif bad == "taps":
        taps = torch.ones(300)
    elif bad == "hist":
        hist = torch.zeros(3, dtype=torch.complex64)
    elif bad == "dtype":
        x = torch.zeros(256, dtype=torch.float64)
    with pytest.raises((ValueError, TypeError)):
        ck.fir_fft(hist, x, taps, 256, precision="int4" if bad == "precision" else None)
