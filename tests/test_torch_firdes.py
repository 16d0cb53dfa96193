"""The port's ``dsp/firdes.py`` designs against the JAX package's:
``tests/test_dsp.py``'s highpass, bandpass, Hilbert and Remez cases on the
port, and ``tests/test_remez.py``'s designs through ``firdes.remez``. Every
design's taps equal the JAX package's bit for bit (both are the same host
numpy arithmetic)."""

import numpy as np
import pytest
import torch
from scipy import signal as sps

from futuresdr_tpu.dsp import firdes as jfirdes
from futuresdr_tpu_torch.dsp import firdes

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

#: (design, arguments): every firdes design at the JAX package's test shapes
DESIGNS = [
    ("lowpass", (0.125, 101, "hamming")),
    ("lowpass", (0.2, 64, "blackman")),
    ("highpass", (0.25, 101)),
    ("highpass", (0.1, 63, "hann")),
    ("bandpass", (0.1, 0.2, 128)),
    ("bandpass", (0.05, 0.2, 64)),
    ("bandstop", (0.1, 0.2, 129)),
    ("hilbert", (65,)),
    ("hilbert", (31, "blackman")),
    ("root_raised_cosine", (8, 4, 0.35)),
    ("kaiser_lowpass", (0.1, 0.05, 60.0)),
    ("remez", (64, [0, 0.1, 0.15, 0.5], [1, 0])),
    ("remez", (63, [(0, 0.2), (0.25, 0.5)], [1, 0], [1, 10])),
]


@pytest.mark.parametrize("name,args", DESIGNS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(DESIGNS)])
def test_design_equals_the_jax_package(name, args):
    got, want = getattr(firdes, name)(*args), getattr(jfirdes, name)(*args)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,args", [("highpass", (0.25, 100)),
                                       ("bandstop", (0.1, 0.2, 128)),
                                       ("hilbert", (64,))])
def test_odd_length_designs_refuse_an_even_length(name, args):
    with pytest.raises(ValueError, match="odd"):
        getattr(firdes, name)(*args)
    with pytest.raises(ValueError, match="odd"):
        getattr(jfirdes, name)(*args)


def test_highpass_response():
    taps = firdes.highpass(0.25, 101)
    w, h = sps.freqz(taps, fs=1.0)
    gain = np.abs(h)
    assert gain[w < 0.2].max() < 0.01
    assert gain[w > 0.3].min() > 0.97


def test_bandpass_response():
    taps = firdes.bandpass(0.1, 0.2, 128)
    w, h = sps.freqz(taps, fs=1.0)
    gain = np.abs(h)
    inband = gain[(w > 0.12) & (w < 0.18)]
    assert inband.min() > 0.9
    assert gain[w < 0.06].max() < 0.02
    assert gain[w > 0.24].max() < 0.02


def test_bandstop_response():
    taps = firdes.bandstop(0.1, 0.2, 129)
    w, h = sps.freqz(taps, fs=1.0)
    gain = np.abs(h)
    assert gain[(w > 0.13) & (w < 0.17)].max() < 0.05
    assert gain[w < 0.05].min() > 0.95
    assert gain[w > 0.26].min() > 0.95


def test_hilbert_quadrature():
    h = firdes.hilbert(65)
    n = np.arange(1000)
    x = np.cos(2 * np.pi * 0.1 * n)
    y = sps.lfilter(h, 1.0, x)[200:800]
    ref = np.sin(2 * np.pi * 0.1 * (n - 32))[200:800]
    assert np.corrcoef(y, ref)[0, 1] > 0.99


def test_remez_design():
    taps = firdes.remez(64, [0, 0.1, 0.15, 0.5], [1, 0])
    w, h = sps.freqz(taps, fs=1.0)
    gain = np.abs(h)
    assert gain[w < 0.08].min() > 0.95
    assert gain[w > 0.17].max() < 0.05


# tests/test_remez.py's symmetric designs (firdes.remez designs types I and
# II): (name, n_taps, bands, desired, weights)
REMEZ_MATRIX = [
    ("lowpass_odd", 63, [(0, 0.2), (0.25, 0.5)], [1, 0], [1, 1]),
    ("lowpass_even", 64, [(0, 0.2), (0.25, 0.5)], [1, 0], [1, 1]),
    ("highpass_odd", 61, [(0, 0.18), (0.24, 0.5)], [0, 1], [1, 1]),
    ("bandpass_odd", 81, [(0, 0.08), (0.12, 0.22), (0.27, 0.5)], [0, 1, 0], [1, 1, 1]),
    ("bandpass_wts", 75, [(0, 0.1), (0.15, 0.3), (0.35, 0.5)], [0, 1, 0], [10, 1, 10]),
    ("multiband", 101, [(0, 0.06), (0.1, 0.16), (0.2, 0.28), (0.33, 0.5)], [1, 0, 1, 0],
     [1, 1, 1, 1]),
]


def _inband_err(h1, h2, bands, worN=8192):
    w, H1 = sps.freqz(h1, worN=worN, fs=1.0)
    _, H2 = sps.freqz(h2, worN=worN, fs=1.0)
    mask = np.zeros(len(w), bool)
    for f0, f1 in bands:
        mask |= (w >= f0) & (w <= f1)
    return np.abs(np.abs(H1) - np.abs(H2))[mask].max()


@pytest.mark.parametrize("name,nt,bands,des,wts", REMEZ_MATRIX,
                         ids=[c[0] for c in REMEZ_MATRIX])
def test_remez_matrix_equals_the_jax_package_and_scipy(name, nt, bands, des, wts):
    got = firdes.remez(nt, bands, des, weight=wts)
    np.testing.assert_array_equal(got, jfirdes.remez(nt, bands, des, weight=wts))
    flat = [e for b in bands for e in b]
    hs = sps.remez(nt, flat, des, weight=wts, fs=1.0)
    assert _inband_err(hs, got, bands) < 2e-5


@pytest.mark.parametrize("n_taps,bands,des", [
    (63, [0, 0.1, 0.15, 0.5], [1, 0]),
    (64, [0, 0.1, 0.15, 0.5], [1, 0]),
    (65, [0, 0.2, 0.25, 0.5], [1, 0]),
    (81, [0, 0.08, 0.12, 0.2, 0.24, 0.5], [0, 1, 0]),
    (55, [0, 0.15, 0.2, 0.5], [0, 1]),
])
def test_remez_matches_scipy_response(n_taps, bands, des):
    mine = firdes.remez(n_taps, bands, des)
    np.testing.assert_array_equal(mine, jfirdes.remez(n_taps, bands, des))
    ref = sps.remez(n_taps, np.asarray(bands), des, fs=1.0)
    assert _inband_err(mine, ref, np.asarray(bands).reshape(-1, 2)) < 2e-4


def test_remez_weighted_design():
    mine = firdes.remez(63, [0, 0.1, 0.15, 0.5], [1, 0], weight=[1, 10])
    _, h = sps.freqz(mine, fs=1.0, worN=2048)
    w = np.linspace(0, 0.5, 2048)
    stop = np.abs(h)[w > 0.16]
    passband = np.abs(h)[w < 0.09]
    assert stop.max() < 0.3 * np.abs(passband - 1).max() + 1e-3


def test_remez_linear_phase_symmetry():
    h = firdes.remez(63, [0, 0.1, 0.15, 0.5], [1, 0])
    np.testing.assert_allclose(h, h[::-1], atol=1e-10)


def test_remez_kind_is_the_jax_packages():
    """``kind`` is accepted and, as in the JAX package, the design stays
    symmetric."""
    got = firdes.remez(63, [(0.05, 0.45)], [1], kind="hilbert")
    np.testing.assert_array_equal(got, jfirdes.remez(63, [(0.05, 0.45)], [1],
                                                     kind="hilbert"))
    np.testing.assert_allclose(got, got[::-1], atol=1e-10)
