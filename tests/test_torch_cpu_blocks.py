"""The port's CPU blocks against the JAX package's, through ``Mocker``.

``Fir`` (plain, decimating and rational resampling), ``Fft`` and its
``fft_size`` handler, ``XlatingFir`` and its ``freq`` handler,
``QuadratureDemod``, ``MovingAvg`` and ``Apply``: each block of the apps'
CPU paths runs the same seeded input, in two chunks so the carries cross a
call, through ``Mocker`` in both packages. The port copies the reference's
numpy code, so the bar is 1e-6 absolute.
"""

import numpy as np
import pytest
import torch

import futuresdr_tpu as jfs
from futuresdr_tpu import blocks as jblocks
import futuresdr_tpu_torch as tfs
from futuresdr_tpu_torch import Mocker, Pmt
from futuresdr_tpu_torch import blocks as tblocks
from futuresdr_tpu_torch.dsp import firdes

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

ATOL = 1e-6


def _signal(n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return (x if np.dtype(dtype).kind == "c" else x.real).astype(dtype)


def _run(pkg, block, chunks, out_items, between=None):
    """``block`` over ``chunks`` (one ``run`` each, the carry kept) in the
    package ``pkg``; ``between(m, i, pmt)`` is called before chunk ``i``
    with the package's ``Pmt``."""
    m = pkg.Mocker(block)
    m.init_output("out", out_items)
    m.init()
    for i, c in enumerate(chunks):
        if between is not None:
            between(m, i, pkg.Pmt)
        m.input("in", c)
        m.run()
    m.deinit()
    return m.output("out").copy()


def _both(make, chunks, out_items, between=None):
    got = _run(tfs, make(tblocks), chunks, out_items, between)
    ref = _run(jfs, make(jblocks), chunks, out_items, between)
    assert got.dtype == ref.dtype
    assert len(got) == len(ref) > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    return got


TAPS = firdes.lowpass(0.1, 48)


@pytest.mark.parametrize("decim,interp,dtype", [(1, 1, np.float32), (4, 1, np.complex64),
                                                (5, 1, np.float32), (125, 24, np.float32),
                                                (3, 2, np.complex64)])
def test_fir_matches_jax(decim, interp, dtype):
    x = _signal(20_011, dtype, seed=decim + interp)
    chunks = [x[:7_003], x[7_003:]]
    _both(lambda b: b.Fir(TAPS, dtype=dtype, decim=decim, interp=interp), chunks,
          len(x) * interp // decim + 16)


def test_fir_builder_resampling_matches_jax():
    x = _signal(30_000, np.complex64, seed=3)
    _both(lambda b: b.FirBuilder.resampling(3, 8), [x[:11_000], x[11_000:]], 12_000)
    _both(lambda b: b.FirBuilder.decimating(4), [x[:11_000], x[11_000:]], 8_000)


@pytest.mark.parametrize("kw", [{}, {"shift": True, "normalize": True},
                                {"direction": "inverse"}, {"window": "hann"}])
def test_fft_matches_jax(kw):
    x = _signal(16 * 256 + 100, np.complex64, seed=5)
    _both(lambda b: b.Fft(256, **kw), [x[:5 * 256 + 30], x[5 * 256 + 30:]], len(x))


def test_fft_size_handler_matches_jax():
    x = _signal(8 * 512, np.complex64, seed=6)

    def retune(m, i, pmt):
        if i == 1:
            assert m.post("fft_size", pmt.usize(128)) == pmt.ok()
            assert m.post("fft_size", pmt.usize(0)) == pmt.invalid_value()

    got = _both(lambda b: b.Fft(512), [x[:4 * 512], x[4 * 512:]], len(x), retune)
    np.testing.assert_allclose(got[4 * 512:4 * 512 + 128], np.fft.fft(x[4 * 512:][:128]),
                               rtol=0, atol=1e-3)


def test_fft_size_handler_refuses_a_size_past_the_buffer():
    m = Mocker(tblocks.Fft(64))
    assert m.post("fft_size", Pmt.string("x")) == Pmt.invalid_value()
    assert m.post("fft_size", Pmt.usize(4096)) == Pmt.ok()   # no buffer to bound it


def test_xlating_fir_matches_jax():
    x = _signal(40_000, np.complex64, seed=7)
    _both(lambda b: b.XlatingFir(firdes.lowpass(0.1, 64), 4, 100e3, 1e6),
          [x[:13_001], x[13_001:]], 10_000)


def test_xlating_fir_freq_handler_matches_jax():
    x = _signal(40_000, np.complex64, seed=8)

    def retune(m, i, pmt):
        if i == 1:
            assert m.post("freq", pmt.f64(-150e3)) == pmt.ok()
            assert m.post("freq", pmt.string("x")) == pmt.invalid_value()

    _both(lambda b: b.XlatingFir(firdes.lowpass(0.1, 64), 4, 100e3, 1e6),
          [x[:20_000], x[20_000:]], 10_000, retune)


def test_quadrature_demod_matches_jax():
    t = np.arange(30_000)
    x = np.exp(1j * (0.3 * np.sin(2 * np.pi * t / 400) + 0.01 * t)).astype(np.complex64)
    got = _both(lambda b: b.QuadratureDemod(gain=2.5), [x[:10_007], x[10_007:]], len(x))
    np.testing.assert_allclose(got[1:], 2.5 * np.angle(x[1:] * np.conj(x[:-1])), atol=1e-5)


def test_moving_avg_matches_jax():
    x = np.abs(_signal(40 * 256 + 17, np.complex64, seed=9)).astype(np.float32)
    _both(lambda b: b.MovingAvg(256, width=3, decay=0.1), [x[:13 * 256 + 5], x[13 * 256 + 5:]],
          len(x))


def test_apply_matches_jax():
    x = _signal(10_000, np.complex64, seed=10)
    _both(lambda b: b.Apply(lambda v: (v.real ** 2 + v.imag ** 2), np.complex64, np.float32),
          [x[:3_333], x[3_333:]], len(x))


def test_apply_keeps_tags_and_fir_remaps_them():
    from futuresdr_tpu_torch.runtime.tag import ItemTag, Tag
    x = _signal(1000, np.float32)
    tags = [ItemTag(10, Tag("string", "a")), ItemTag(500, Tag("string", "b"))]
    m = Mocker(tblocks.Apply(lambda v: v, np.float32))
    m.input("in", x, tags)
    m.init_output("out", 1000)
    m.run()
    assert [(t.index, t.tag.value) for t in m.output_tags("out")] == [(10, "a"), (500, "b")]
    m = Mocker(tblocks.Fir(TAPS, decim=5))
    m.input("in", x, tags)
    m.init_output("out", 200)
    m.run()
    assert [t.index for t in m.output_tags("out")] == [2, 100]
