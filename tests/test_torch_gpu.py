"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA card (the kernels have no CPU
mode). This file imports no JAX, so it runs on a machine without it:
``python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q``.
"""

import numpy as np
import pytest
import torch

from futuresdr_tpu_torch.ops import cuda_kernels as ck


def _c64(rng, n):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda:0")


def _rel_err(got, ref):
    return ((got - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("complex_stream", [True, False])
def test_fir_kernel_matches_plain_on_card(cuda_device, precision, complex_stream):
    rng = np.random.default_rng(21)
    n, nt = (1 << 18) + 777, 64
    taps = torch.from_numpy(rng.standard_normal(nt).astype(np.float32)).to(cuda_device)
    if complex_stream:
        hist, x = _c64(rng, nt - 1), _c64(rng, n)
    else:
        hist = rng.standard_normal(nt - 1).astype(np.float32)
        x = rng.standard_normal(n).astype(np.float32)
    h, xx = torch.from_numpy(hist).to(cuda_device), torch.from_numpy(x).to(cuda_device)
    before = ck.launches["fir"]
    got = ck.fir_continue(h, xx, taps, precision)
    torch.cuda.synchronize()
    assert ck.launches["fir"] == before + 1
    assert _rel_err(got, ck.fir_continue_plain(h, xx, taps, precision)) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("n_fft,nt,rows", [(2048, 64, 128), (128, 17, 7), (1000, 33, 5)])
def test_fir_fft_kernel_matches_plain_on_card(cuda_device, precision, n_fft, nt, rows):
    rng = np.random.default_rng(22)
    taps = torch.from_numpy(rng.standard_normal(nt).astype(np.float32)).to(cuda_device)
    h = torch.from_numpy(_c64(rng, nt - 1)).to(cuda_device)
    x = torch.from_numpy(_c64(rng, n_fft * rows)).to(cuda_device)
    before = ck.launches["fir_fft"]
    got = ck.fir_fft(h, x, taps, n_fft, precision)
    torch.cuda.synchronize()
    assert ck.launches["fir_fft"] == before + 1
    assert _rel_err(got, ck.fir_fft_plain(h, x, taps, n_fft, precision)) <= 1e-4


@pytest.mark.gpu
def test_empty_frames_launch_nothing(cuda_device):
    taps = torch.ones(16, device=cuda_device)
    hist = torch.zeros(15, dtype=torch.complex64, device=cuda_device)
    x = torch.zeros(0, dtype=torch.complex64, device=cuda_device)
    before = dict(ck.launches)
    assert ck.fir_continue(hist, x, taps).shape == (0,)
    assert ck.fir_fft(hist, x, taps, 256).shape == (0,)
    assert ck.launches == before


@pytest.mark.gpu
def test_kernel_wrappers_reject_non_contiguous_tensors(cuda_device):
    x = torch.zeros(4096, dtype=torch.complex64, device=cuda_device)[::2]
    taps = torch.ones(16, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ck.fir(x, taps)
