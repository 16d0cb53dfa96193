"""The lane forms of the port's FIR kernels against the JAX package's serving plane.

The JAX package serves a batch of sessions through ``jax.vmap`` of its
Pallas kernels (``futuresdr_tpu/serve/engine.py``); the port runs the same
batch as one launch of a lane kernel (``fir_lanes``, ``fir_fft_lanes`` in
``futuresdr_tpu_torch/ops/cuda_kernels.py``). On the CPU the port's lane
wrappers run their plain versions; the JAX side is ``jax.vmap`` of
``pallas_fir_continue`` and ``pallas_fir_fft`` in interpret mode, as
``tests/test_pallas.py`` runs them, each under one ``jax.jit``. Per-lane taps,
histories and frames come from numpy with a seed. The CUDA kernels are held
against these plain versions, and bit for bit against one-stream launches,
on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 28).

Tolerances, as ``tests/test_pallas.py`` states them for each kernel:

* ``fir``: rtol 1e-4, atol 1e-4 (unit-variance data; the sums run in
  another order), in f32 and in bf16 mode, where both round samples and
  taps to bf16 and accumulate the exact products in f32;
* ``fir_fft``: an SNR of at least 80 dB against the JAX kernel in f32; in
  bf16 mode at least 40 dB, since the JAX kernel also rounds its DFT matrix
  to bf16 and the port keeps its twiddles in f32 (``tests/test_torch_kernels.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from futuresdr_tpu.ops import pallas_kernels as pk
from futuresdr_tpu_torch.ops import cuda_kernels as ck

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

N, NT = 512, 17                  # a lane's frame and taps (serve_ab's 17-tap FIR)
N_FFT = 128                      # fir_fft: 4 rows of 128 a lane
L_MAX = 5
FIR_TOL = 1e-4
FFT_SNR_DB = {None: 80.0, "bf16": 40.0}


def _vmapped(kernel: str, precision):
    """The JAX serving plane's batch of ``kernel``: ``jax.vmap`` over the
    lanes of hist, x and taps, under one ``jax.jit``."""
    if kernel == "fir":
        def one(h, x, t):
            return pk.pallas_fir_continue(h, x, t, block=N, precision=precision)
    else:
        def one(h, x, t):
            return pk.pallas_fir_fft(h, x, t, N_FFT, block=2, precision=precision)
    return jax.jit(jax.vmap(one))


def _case(complex_stream: bool, seed: int):
    """``L_MAX`` lanes of hist, x and taps, each lane its own."""
    rng = np.random.default_rng(seed)

    def stream(*shape):
        if complex_stream:
            return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) \
                .astype(np.complex64)
        return rng.standard_normal(shape).astype(np.float32)
    return (stream(L_MAX, NT - 1), stream(L_MAX, N),
            rng.standard_normal((L_MAX, NT)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _reference(kernel: str, complex_stream: bool, precision, state: str):
    """The case's inputs and the JAX batch's output over all ``L_MAX`` lanes
    (lanes are independent, so its first L rows are the L-lane batch's).
    ``state``: "own" (per-lane taps and histories), "zero" (zero histories),
    "shared" (lane 0's taps in every lane)."""
    hist, x, taps = _case(complex_stream, 22 + 2 * complex_stream + (kernel == "fir"))
    if state == "zero":
        hist = np.zeros_like(hist)
    elif state == "shared":
        taps = np.repeat(taps[:1], L_MAX, axis=0)
    y = np.asarray(_vmapped(kernel, precision)(jnp.asarray(hist), jnp.asarray(x),
                                               jnp.asarray(taps)))
    return hist, x, taps, y


def _snr_db(got, ref):
    err = float(np.mean(np.abs(got - ref) ** 2))
    return 10 * np.log10(float(np.mean(np.abs(ref) ** 2)) / max(err, 1e-30))


def _port_args(hist, x, taps, L, state):
    h, xx = torch.from_numpy(hist[:L]), torch.from_numpy(x[:L])
    t = torch.from_numpy(taps[:1]).expand(L, -1) if state == "shared" \
        else torch.from_numpy(taps[:L])
    return (None if state == "zero" else h), xx, t


def _cases(states):
    """(L, complex_stream, precision, state): every lane count, stream kind
    and precision with each lane's own taps and history; the other states at
    L = 3 in f32."""
    own = [(L, c, p, "own") for L in (1, 3, L_MAX) for c in (True, False)
           for p in (None, "bf16")]
    return own + [(3, c, None, s) for s in states for c in (True, False)]


@pytest.mark.parametrize("L,complex_stream,precision,state", _cases(("zero", "shared")))
def test_fir_lanes_matches_vmapped_pallas_fir(L, complex_stream, precision, state):
    """``fir_lanes`` over L lanes of 512 samples against ``jax.vmap`` of
    ``pallas_fir_continue``; zero histories go to the port as ``hist=None``
    and shared taps as one row expanded (stride 0)."""
    hist, x, taps, ref = _reference("fir", complex_stream, precision, state)
    got = ck.fir_lanes(*_port_args(hist, x, taps, L, state), precision).numpy()
    assert got.dtype == ref.dtype and got.shape == (L, N)
    np.testing.assert_allclose(got, ref[:L], rtol=FIR_TOL, atol=FIR_TOL)


@pytest.mark.parametrize("L,complex_stream,precision,state", _cases(("shared",)))
def test_fir_fft_lanes_matches_vmapped_pallas_fir_fft(L, complex_stream, precision, state):
    """``fir_fft_lanes`` over L lanes of 4 rows of 128 against ``jax.vmap``
    of ``pallas_fir_fft``, lane by lane."""
    hist, x, taps, ref = _reference("fir_fft", complex_stream, precision, state)
    got = ck.fir_fft_lanes(*_port_args(hist, x, taps, L, state), N_FFT, precision).numpy()
    assert got.dtype == np.complex64 and got.shape == (L, N)
    for lane in range(L):
        assert _snr_db(got[lane], ref[lane]) >= FFT_SNR_DB[precision], lane


@pytest.mark.parametrize("kernel", ["fir", "fir_fft"])
def test_lanes_equal_one_stream_calls(kernel):
    """Each lane of the lane form equals the one-stream wrapper on its row
    bit for bit (the kernels' contract, which the card checks on launches)."""
    hist, x, taps, _ = _reference(kernel, True, None, "own")
    h, xx, t = (torch.from_numpy(a) for a in (hist, x, taps))
    if kernel == "fir":
        got = ck.fir_lanes(h, xx, t)
        per = [ck.fir_continue(h[i], xx[i], t[i]) for i in range(L_MAX)]
    else:
        got = ck.fir_fft_lanes(h, xx, t, N_FFT)
        per = [ck.fir_fft(h[i], xx[i], t[i], N_FFT) for i in range(L_MAX)]
    assert torch.equal(got, torch.stack(per))
