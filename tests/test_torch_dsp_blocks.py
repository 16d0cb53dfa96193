"""The port's DSP additions against the reference's cases and the JAX
package: ``dsp/fxpt.py`` (``tests/test_fxpt.py``), ``dsp/remez.py``
(``tests/test_remez.py``), ``ClockRecoveryMm`` over ``csrc/host/mm.cpp``
(``tests/test_mm_native.py``, ``tests/test_clock_recovery.py``), and the
cases of ``tests/test_dsp_blocks.py`` on ``SignalSource``, ``PfbSynthesizer``,
``Agc`` and ``Iir``. Then each block is held against the JAX block on the
same seeded input, bit for bit: the arithmetic is the same numpy (and the
same loop in C++ for the MM block).
"""


import numpy as np
import pytest
import torch
from scipy import signal as sps

from futuresdr_tpu_torch import Flowgraph, Mocker, Runtime
from futuresdr_tpu_torch.blocks import (Agc, ClockRecoveryMm, Head, Iir, PfbChannelizer,
                                        PfbSynthesizer, SignalSource, VectorSink,
                                        VectorSource)
from futuresdr_tpu_torch.dsp.fxpt import FixedPointPhase, i32_to_radians, phase_ramp_i32
from futuresdr_tpu_torch.dsp.remez import remez_exchange

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)


# ---- tests/test_fxpt.py -------------------------------------------------------

def test_wrap_semantics():
    # -2^31 <-> -pi, 0 <-> 0, 2^31-1 <-> pi - eps
    assert FixedPointPhase(0.0).value == 0
    assert FixedPointPhase(-np.pi).value == -(2 ** 31)
    assert FixedPointPhase(np.pi).value == -(2 ** 31)     # pi folds to -pi
    p = FixedPointPhase(np.pi / 2)
    assert abs(p.to_radians() - np.pi / 2) < 1e-9
    # folding: 2pi + x == x
    assert FixedPointPhase(2 * np.pi + 0.3).value == FixedPointPhase(0.3).value


def test_advance_wraps_exactly():
    inc = FixedPointPhase.increment_for(0.25, 1.0)        # exactly 2^30
    assert inc == 2 ** 30
    p = FixedPointPhase(0.0)
    # 4 advances of 0.25 cycles = 1 cycle = back to start, exactly
    assert p.advance(inc, 4).value == 0
    assert abs(p.advance(inc, 2).to_radians()) in (0.0, np.pi)  # half cycle = ±pi
    # negative frequency wraps the other way
    inc_neg = FixedPointPhase.increment_for(-0.25, 1.0)
    assert p.advance(inc_neg, 4).value == 0
    # a NON-representable rate (0.3) still cancels its own quantization exactly:
    # chunked advance == one-shot advance, whatever the quantized inc is
    inc3 = FixedPointPhase.increment_for(0.3, 1.0)
    assert p.advance(inc3, 1000).value == \
        p.advance(inc3, 400).advance(inc3, 600).value


def test_phase_ramp_matches_scalar_advance():
    rng = np.random.default_rng(3)
    for _ in range(10):
        start = int(rng.integers(-2 ** 31, 2 ** 31))
        inc = int(np.int32(rng.integers(-2 ** 31, 2 ** 31)))
        n = int(rng.integers(1, 5000))
        ramp = phase_ramp_i32(start, inc, n)
        p = FixedPointPhase(raw=start)
        assert ramp[0] == p.value
        assert ramp[-1] == p.advance(inc, n - 1).value


def test_chunked_equals_oneshot():
    """Streaming chunk boundaries are invisible: the concatenated per-chunk ramps
    equal the one-shot ramp bit-for-bit."""
    inc = FixedPointPhase.increment_for(97_531.0, 1e6)
    one = phase_ramp_i32(1234, inc, 100_000)
    pieces, pos = [], 1234
    rng = np.random.default_rng(0)
    done = 0
    while done < 100_000:
        k = min(int(rng.integers(1, 7777)), 100_000 - done)
        pieces.append(phase_ramp_i32(pos, inc, k))
        pos = (pos + inc * k) & 0xFFFF_FFFF
        done += k
    np.testing.assert_array_equal(np.concatenate(pieces), one)


def test_long_run_drift_fxpt_vs_float():
    """After 10^8 samples the fxpt phase is EXACT (integer identity) while the
    float accumulator, stepped chunk-by-chunk as the float NCO does, has drifted
    by orders of magnitude more than one fxpt quantum."""
    freq, fs = 12_345.6789, 1e6
    n_total, chunk = 100_000_000, 65_536

    inc_i = FixedPointPhase.increment_for(freq, fs)
    # fxpt: O(1) exactness check — advance() IS the per-chunk update rule
    p = FixedPointPhase(0.0)
    n_chunks, rem = divmod(n_total, chunk)
    for _ in range(3):                     # spot-check a few chunk updates
        p = p.advance(inc_i, chunk)
    p_direct = FixedPointPhase(0.0).advance(inc_i, 3 * chunk)
    assert p == p_direct                   # chunked == one-shot, bit-exact
    final_fxpt = FixedPointPhase(0.0).advance(inc_i, n_total)
    expected = (inc_i * n_total) & 0xFFFF_FFFF
    assert np.uint32(final_fxpt.value & 0xFFFF_FFFF) == np.uint32(expected)

    # float32-precision accumulator (what a naive NCO state is), stepped per chunk
    inc_f = np.float32(2.0 * np.pi * freq / fs)
    ph = np.float32(0.0)
    for _ in range(n_chunks):
        ph = np.float32((ph + inc_f * chunk) % (2.0 * np.pi))
    ph = np.float32((ph + inc_f * rem) % (2.0 * np.pi))
    # ground truth in extended precision
    true_ph = float((int(n_total) * (2.0 * np.pi * freq / fs)) % (2.0 * np.pi))

    def circ_err(a, b):
        return abs((a - b + np.pi) % (2 * np.pi) - np.pi)

    float_err = circ_err(float(ph), true_ph)
    fxpt_err = circ_err(final_fxpt.to_radians(),
                        float((int(n_total) * (inc_i * np.pi / 2 ** 31)) % (2 * np.pi)))
    quantum = np.pi / 2 ** 31
    assert fxpt_err < 4 * quantum          # exact up to the radian conversion
    assert float_err > 1000 * quantum      # the float path has genuinely drifted
    assert float_err > 100 * fxpt_err if fxpt_err > 0 else True


def test_signal_source_fxpt_block():
    """SignalSource(nco='fxpt') streams the exact integer-phase waveform and the
    freq port retunes to the quantized frequency."""
    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import SignalSource, Head, VectorSink

    fs, f0, n = 48_000.0, 1_234.5, 20_000
    fg = Flowgraph()
    src = SignalSource("complex", f0, fs, nco="fxpt")
    head = Head(np.complex64, n)
    snk = VectorSink(np.complex64)
    fg.connect(src, head, snk)
    Runtime().run(fg)
    got = snk.items()
    assert len(got) == n
    inc = FixedPointPhase.increment_for(f0, fs)
    ref = np.exp(1j * i32_to_radians(phase_ramp_i32(0, inc, n))).astype(np.complex64)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    # the tone is where we asked (to fs/2^32 quantization)
    spec = np.abs(np.fft.fft(got * np.hanning(n)))
    peak = np.argmax(spec[:n // 2]) * fs / n
    assert abs(peak - f0) < 2 * fs / n


# ---- tests/test_remez.py ------------------------------------------------------

DESIGN_MATRIX = [
    ("lowpass_odd", 63, [(0, 0.2), (0.25, 0.5)], [1, 0], [1, 1], "bandpass"),
    ("lowpass_even", 64, [(0, 0.2), (0.25, 0.5)], [1, 0], [1, 1], "bandpass"),
    ("highpass_odd", 61, [(0, 0.18), (0.24, 0.5)], [0, 1], [1, 1], "bandpass"),
    ("bandpass_odd", 81, [(0, 0.08), (0.12, 0.22), (0.27, 0.5)], [0, 1, 0], [1, 1, 1], "bandpass"),
    ("bandpass_wts", 75, [(0, 0.1), (0.15, 0.3), (0.35, 0.5)], [0, 1, 0], [10, 1, 10], "bandpass"),
    ("multiband", 101, [(0, 0.06), (0.1, 0.16), (0.2, 0.28), (0.33, 0.5)], [1, 0, 1, 0], [1, 1, 1, 1], "bandpass"),
    ("hilbert_odd", 63, [(0.05, 0.45)], [1], [1], "hilbert"),
    ("hilbert_even", 64, [(0.05, 0.45)], [1], [1], "hilbert"),
    ("diff_odd", 45, [(0.02, 0.45)], [2], [1], "differentiator"),
    ("diff_even", 46, [(0.02, 0.48)], [1], [1], "differentiator"),
]


def _true_ripple(h, bands, des, wts, ftype, worN=200001):
    """Max weighted in-band deviation from the ideal response, densely sampled."""
    w, H = sps.freqz(h, worN=worN, fs=1.0)
    A = np.abs(H)
    worst = 0.0
    for (f0, f1), d, wt in zip(bands, des, wts):
        m = (w >= f0) & (w <= f1)
        if ftype == "differentiator":
            D = d * w[m]
            W = np.where(np.abs(D) > 1e-4, wt / np.maximum(np.abs(D), 1e-12), wt)
        else:
            D = np.full(m.sum(), d)
            W = np.full(m.sum(), wt)
        worst = max(worst, (W * np.abs(A[m] - D)).max())
    return worst


def _inband_err(h1, h2, bands, worN=8192):
    w, H1 = sps.freqz(h1, worN=worN, fs=1.0)
    _, H2 = sps.freqz(h2, worN=worN, fs=1.0)
    mask = np.zeros(len(w), bool)
    for f0, f1 in bands:
        mask |= (w >= f0) & (w <= f1)
    return np.abs(np.abs(H1) - np.abs(H2))[mask].max()


@pytest.mark.parametrize("name,nt,bands,des,wts,ftype", DESIGN_MATRIX,
                         ids=[c[0] for c in DESIGN_MATRIX])
def test_design_matrix_vs_scipy(name, nt, bands, des, wts, ftype):
    flat = [e for b in bands for e in b]
    hs = sps.remez(nt, flat, des, weight=wts, fs=1.0, type=ftype)
    hm = remez_exchange(nt, bands, des, weight=wts, filter_type=ftype)

    # in-band responses agree closely (both are grid-density-16 optima)
    assert _inband_err(hs, hm, bands) < 2e-5

    # equiripple quality within 5% of scipy at matched density (two different
    # discrete grids → two slightly different optima; the strict claim is below)
    rs = _true_ripple(hs, bands, des, wts, ftype)
    rm = _true_ripple(hm, bands, des, wts, ftype)
    assert rm <= rs * 1.05

    # at density 64 our optimum strictly beats scipy's density-16 design
    hm64 = remez_exchange(nt, bands, des, weight=wts, filter_type=ftype,
                          grid_density=64)
    rm64 = _true_ripple(hm64, bands, des, wts, ftype)
    assert rm64 <= rs * (1 + 1e-6)


@pytest.mark.parametrize("n_taps,bands,des", [
    (63, [0, 0.1, 0.15, 0.5], [1, 0]),            # type I lowpass
    (64, [0, 0.1, 0.15, 0.5], [1, 0]),            # type II lowpass
    (65, [0, 0.2, 0.25, 0.5], [1, 0]),
    (81, [0, 0.08, 0.12, 0.2, 0.24, 0.5], [0, 1, 0]),   # bandpass
    (55, [0, 0.15, 0.2, 0.5], [0, 1]),            # highpass-ish
])
def test_matches_scipy_response(n_taps, bands, des):
    mine = remez_exchange(n_taps, bands, des)
    ref = sps.remez(n_taps, np.asarray(bands), des, fs=1.0)
    bl = np.asarray(bands).reshape(-1, 2)
    # narrow-transition designs: the |H| gap is floored by scipy's own grid
    # discretization error (~1e-4); optimality is asserted in the matrix test
    assert _inband_err(mine, ref, bl) < 2e-4


def test_weighted_design():
    mine = remez_exchange(63, [0, 0.1, 0.15, 0.5], [1, 0], weight=[1, 10])
    _, h = sps.freqz(mine, fs=1.0, worN=2048)
    w = np.linspace(0, 0.5, 2048)
    stop = np.abs(h)[w > 0.16]
    passband = np.abs(h)[w < 0.09]
    # 10x stopband weight → stopband ripple ~10x smaller than passband ripple
    assert stop.max() < 0.3 * np.abs(passband - 1).max() + 1e-3


def test_linear_phase_symmetry():
    h = remez_exchange(63, [0, 0.1, 0.15, 0.5], [1, 0])
    np.testing.assert_allclose(h, h[::-1], atol=1e-10)


def test_antisymmetric_types():
    h3 = remez_exchange(63, [(0.05, 0.45)], [1], filter_type="hilbert")
    np.testing.assert_allclose(h3, -h3[::-1], atol=1e-10)
    h4 = remez_exchange(64, [(0.05, 0.45)], [1], filter_type="hilbert")
    np.testing.assert_allclose(h4, -h4[::-1], atol=1e-10)


def test_hilbert_quadrature():
    """A Hilbert design really does shift phase by ~90° with ~unit gain mid-band."""
    h = remez_exchange(101, [(0.05, 0.45)], [1], filter_type="hilbert")
    w, H = sps.freqz(h, worN=4096, fs=1.0)
    mid = (w > 0.1) & (w < 0.4)
    np.testing.assert_allclose(np.abs(H[mid]), 1.0, atol=2e-3)
    # amplitude is purely imaginary after delay compensation (antisymmetric taps)
    delay = (len(h) - 1) / 2
    Hc = H * np.exp(2j * np.pi * w * delay)
    assert np.abs(Hc.real)[mid].max() < 1e-8


def test_differentiator_slope():
    """Differentiator response follows |H| = 2π·f·gain/(2π) = gain·f scaled."""
    h = remez_exchange(45, [(0.02, 0.45)], [1], filter_type="differentiator")
    w, H = sps.freqz(h, worN=4096, fs=1.0)
    mid = (w > 0.05) & (w < 0.4)
    rel = np.abs(np.abs(H[mid]) / w[mid] - 1.0)
    assert rel.max() < 2e-3


# ---- tests/test_mm_native.py and tests/test_clock_recovery.py -----------------

def _run(x, force_py, omega=4.0, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("FSDR_NO_NATIVE", raising=False)
        if force_py:
            mp.setenv("FSDR_NO_NATIVE", "1")
        mp.setattr(ClockRecoveryMm, "_native", None)
        fg = Flowgraph()
        src = VectorSource(x)
        mm = ClockRecoveryMm(omega, omega_limit=0.1, **kw)
        snk = VectorSink(np.float32)
        fg.connect(src, mm, snk)
        Runtime().run(fg)
        used_native = bool(ClockRecoveryMm._native)
        return snk.items(), used_native


def test_native_matches_python_bitexact():
    rng = np.random.default_rng(7)
    sym = rng.choice([-1.0, 1.0], 30_000)
    x = np.repeat(sym, 4).astype(np.float32)
    x += 0.05 * rng.standard_normal(len(x)).astype(np.float32)
    y_py, _ = _run(x, force_py=True)
    y_nat, used_native = _run(x, force_py=False)
    if not used_native:
        pytest.skip("native library unavailable")
    assert len(y_py) == len(y_nat)
    np.testing.assert_array_equal(y_py, y_nat)


def test_native_recovers_symbols_with_clock_offset():
    rng = np.random.default_rng(1)
    sym = rng.choice([-1.0, 1.0], 5_000)
    # 2% clock offset: resample 4 sps to 4.08 sps
    up = np.repeat(sym, 4).astype(np.float32)
    t = np.arange(int(len(up) / 1.02)) * 1.02
    i = t.astype(int)
    x = (up[i] * (1 - (t - i)) + up[np.minimum(i + 1, len(up) - 1)] * (t - i)
         ).astype(np.float32)
    # loop gains sized for a 2% rate offset (the defaults assume ppm-scale drift)
    y, _ = _run(x, force_py=False, gain_omega=5e-3, gain_mu=0.1)
    # decisions after settling must track the symbol stream; acquisition may slip a
    # few symbols, so align at the best small lag
    settled = np.sign(y[500:4000])
    best = 0.0
    for lag in range(-8, 9):
        ref = sym[500 + lag:500 + lag + len(settled)]
        n = min(len(ref), len(settled))
        best = max(best, float(np.mean(settled[:n] == ref[:n])))
    assert best > 0.97, best


def test_mm_clock_recovery_extracts_symbols():
    rng = np.random.default_rng(0)
    sps = 8
    bits = rng.integers(0, 2, 500) * 2.0 - 1.0
    # rectangular pulses with a fractional timing offset
    wave = np.repeat(bits, sps).astype(np.float32)
    wave = np.concatenate([np.zeros(3, np.float32), wave])  # timing offset
    fg = Flowgraph()
    src = VectorSource(wave)
    mm = ClockRecoveryMm(omega=sps)
    snk = VectorSink(np.float32)
    fg.connect(src, mm, snk)
    Runtime().run(fg)
    got = np.sign(snk.items())
    assert len(got) > 400
    # recovered symbol decisions must match the bit sequence at some alignment
    best = 0
    for lag in range(4):
        g = got[lag:lag + 450]
        b = bits[:len(g)]
        best = max(best, float(np.mean(g == b)))
    assert best > 0.95, best


def test_sta_equalizer_tracks_drift():
    from futuresdr_tpu_torch.models.wlan import encode_frame, ofdm, coding
    from futuresdr_tpu_torch.models.wlan.phy import _parse_signal

    psdu = b"sta equalizer test payload!!" * 2
    frame = encode_frame(psdu, "qpsk_1_2")
    # slow channel drift over the frame: small growing phase slope
    drift = np.exp(1j * 2e-5 * np.arange(len(frame)) ** 1.0)
    rx = (frame * drift).astype(np.complex64)
    H = ofdm.estimate_channel(rx, 192)
    n_sym = -(-(16 + 8 * len(psdu) + 6) // 96)     # data symbols at qpsk_1_2
    spec = ofdm.ofdm_demodulate_symbols(rx[192 + 128 + 80:], n_sym)
    eq_ls = ofdm.equalize(spec, H, symbol_offset=1, algorithm="ls")
    eq_sta = ofdm.equalize(spec, H, symbol_offset=1, algorithm="sta")
    # both algorithms produce constellation points near QPSK; sta at least as tight
    def evm(eq):
        pts = eq.reshape(-1)
        ideal = (np.sign(pts.real) + 1j * np.sign(pts.imag)) / np.sqrt(2)
        return float(np.mean(np.abs(pts - ideal) ** 2))
    assert evm(eq_sta) <= evm(eq_ls) * 1.1


# ---- tests/test_dsp_blocks.py, its cases on the blocks this slice adds ---------

def test_signal_source_tone():
    fs, f = 48000.0, 1000.0
    fg = Flowgraph()
    src = SignalSource("complex", f, fs)
    head = Head(np.complex64, 4096)
    snk = VectorSink(np.complex64)
    fg.connect(src, head, snk)
    Runtime().run(fg)
    x = snk.items()
    assert len(x) == 4096
    spec = np.abs(np.fft.fft(x * np.hanning(len(x))))
    fpeak = np.fft.fftfreq(len(x), 1 / fs)[np.argmax(spec)]
    assert abs(fpeak - f) < fs / len(x)


def test_pfb_chain_channelize_synthesize():
    """Analysis → synthesis should approximately reconstruct (within filter delay)."""
    n_chan = 4
    n = 1 << 12
    rng = np.random.default_rng(5)
    x = np.exp(1j * 2 * np.pi * 0.07 * np.arange(n)).astype(np.complex64)
    fg = Flowgraph()
    src = VectorSource(x)
    chan = PfbChannelizer(n_chan)
    synth = PfbSynthesizer(n_chan)
    snk = VectorSink(np.complex64)
    fg.connect_stream(src, "out", chan, "in")
    for i in range(n_chan):
        fg.connect_stream(chan, f"out{i}", synth, f"in{i}")
    fg.connect_stream(synth, "out", snk, "in")
    Runtime().run(fg)
    y = snk.items()
    assert len(y) > n // 2
    # reconstructed tone should dominate at the same frequency
    w = 2048
    spec = np.abs(np.fft.fft(y[256:256 + w] * np.hanning(w)))
    peak = np.fft.fftfreq(w)[np.argmax(spec)]
    assert abs(abs(peak) - 0.07) < 2e-3


def test_agc_converges():
    x = (0.01 * np.exp(1j * 2 * np.pi * 0.01 * np.arange(30000))).astype(np.complex64)
    m = Mocker(Agc(reference=1.0, adjustment_rate=2e-2))
    m.input("in", x)
    m.init_output("out", len(x))
    m.run()
    y = m.output("out")
    assert abs(np.abs(y[-1000:]).mean() - 1.0) < 0.05


def test_agc_block_mode():
    x = (0.01 * np.exp(1j * 2 * np.pi * 0.01 * np.arange(60000))).astype(np.complex64)
    m = Mocker(Agc(reference=1.0, adjustment_rate=2e-2, mode="block"))
    m.input("in", x)
    m.init_output("out", len(x))
    m.run()
    y = m.output("out")
    assert abs(np.abs(y[-1000:]).mean() - 1.0) < 0.05


def test_iir_block():
    b, a = sps.butter(2, 0.3)
    data = np.random.default_rng(6).standard_normal(10_000).astype(np.float32)
    m = Mocker(Iir(b, a, np.float32))
    m.input("in", data)
    m.init_output("out", len(data))
    m.run()
    np.testing.assert_allclose(m.output("out"),
                               sps.lfilter(b, a, data).astype(np.float32), rtol=1e-3, atol=1e-4)


# ---- the port against the JAX package -----------------------------------------

def _mock(kernel, x, n_out, finish=True):
    m = Mocker(kernel)
    m.input("in", x)
    if finish:
        m.input_finished("in")
    m.init_output("out", n_out)
    m.run()
    return m


@pytest.mark.parametrize("waveform", ["sin", "cos", "complex", "square"])
@pytest.mark.parametrize("nco", ["fxpt", "float"])
def test_signal_source_equals_the_jax_block(waveform, nco):
    """Both NCOs and every waveform, read in uneven windows: the same samples
    and the same phase state as the JAX package's block."""
    from futuresdr_tpu.blocks import SignalSource as JSignalSource
    from futuresdr_tpu.runtime.mocker import Mocker as JMocker
    outs = []
    for Blk, Mk in ((SignalSource, Mocker), (JSignalSource, JMocker)):
        blk = Blk(waveform, 12_345.6, 250e3, amplitude=0.7, offset=0.05, nco=nco)
        got = []
        for n in (1000, 37, 4096):
            m = Mk(blk)
            m.init_output("out", n)
            m.init()
            m.run()
            got.append(m.output("out").copy())
        outs.append((np.concatenate(got), blk._phase_i, blk._phase))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1:] == outs[1][1:]


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_iir_equals_the_jax_block(dtype):
    from futuresdr_tpu.blocks import Iir as JIir
    from futuresdr_tpu.runtime.mocker import Mocker as JMocker
    b, a = sps.butter(3, 0.2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(5_000)
    if dtype == np.complex64:
        x = x + 1j * rng.standard_normal(5_000)
    x = x.astype(dtype)
    got = _mock(Iir(b, a, dtype), x, len(x)).output("out")
    jm = JMocker(JIir(b, a, dtype))
    jm.input("in", x)
    jm.input_finished("in")
    jm.init_output("out", len(x))
    jm.run()
    np.testing.assert_array_equal(got, jm.output("out"))


@pytest.mark.parametrize("mode", ["sample", "block"])
@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_agc_equals_the_jax_block(mode, dtype):
    from futuresdr_tpu.blocks import Agc as JAgc
    from futuresdr_tpu.runtime.mocker import Mocker as JMocker
    rng = np.random.default_rng(8)
    x = 0.02 * rng.standard_normal(20_000)
    if dtype == np.complex64:
        x = x + 0.02j * rng.standard_normal(20_000)
    x = x.astype(dtype)
    blk = Agc(dtype, reference=0.5, adjustment_rate=1e-2, mode=mode)
    got = _mock(blk, x, len(x)).output("out")
    jblk = JAgc(dtype, reference=0.5, adjustment_rate=1e-2, mode=mode)
    jm = JMocker(jblk)
    jm.input("in", x)
    jm.input_finished("in")
    jm.init_output("out", len(x))
    jm.run()
    np.testing.assert_array_equal(got, jm.output("out"))
    assert blk.gain == jblk.gain


def test_pfb_synthesizer_equals_the_jax_block():
    """Channelize then synthesize in a flowgraph on both packages: the same
    samples bit for bit."""
    import futuresdr_tpu as J
    from futuresdr_tpu import blocks as jb
    from futuresdr_tpu_torch import blocks as tb
    x = (np.exp(2j * np.pi * 0.07 * np.arange(1 << 12))
         + 0.1 * np.random.default_rng(2).standard_normal(1 << 12)).astype(np.complex64)
    outs = []
    for b, F, R in ((tb, Flowgraph, Runtime), (jb, J.Flowgraph, J.Runtime)):
        fg = F()
        chan, synth, snk = b.PfbChannelizer(4), b.PfbSynthesizer(4), b.VectorSink(np.complex64)
        fg.connect_stream(b.VectorSource(x), "out", chan, "in")
        for i in range(4):
            fg.connect_stream(chan, f"out{i}", synth, f"in{i}")
        fg.connect_stream(synth, "out", snk, "in")
        R().run(fg)
        outs.append(snk.items())
    assert len(outs[0]) == len(x)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_clock_recovery_native_equals_the_jax_python_loop(monkeypatch):
    """The port's C++ MM loop against the JAX package's Python loop
    (``FSDR_NO_NATIVE=1`` around the JAX run only): the same symbols and the
    same timing state, bit for bit."""
    from futuresdr_tpu.blocks.dsp import ClockRecoveryMm as JMm
    from futuresdr_tpu.runtime.mocker import Mocker as JMocker
    rng = np.random.default_rng(12)
    x = np.repeat(rng.choice([-1.0, 1.0], 4_000), 4).astype(np.float32)
    x += 0.05 * rng.standard_normal(len(x)).astype(np.float32)
    monkeypatch.setattr(ClockRecoveryMm, "_native", None)
    blk = ClockRecoveryMm(4.0, omega_limit=0.1)
    assert ClockRecoveryMm._native
    got = _mock(blk, x, len(x)).output("out")
    monkeypatch.setenv("FSDR_NO_NATIVE", "1")
    monkeypatch.setattr(JMm, "_native", None)
    jblk = JMm(4.0, omega_limit=0.1)
    assert not JMm._native
    jm = JMocker(jblk)
    jm.input("in", x)
    jm.input_finished("in")
    jm.init_output("out", len(x))
    jm.run()
    np.testing.assert_array_equal(got, jm.output("out"))
    assert (blk.omega, blk.mu, blk._last, blk._last_d) == \
        (jblk.omega, jblk.mu, jblk._last, jblk._last_d)


def test_fxpt_and_remez_equal_the_jax_modules():
    from futuresdr_tpu.dsp import fxpt as jfxpt
    from futuresdr_tpu.dsp import remez as jremez
    from futuresdr_tpu_torch.dsp import fxpt
    inc = fxpt.FixedPointPhase.increment_for(1234.5, 48e3)
    assert inc == jfxpt.FixedPointPhase.increment_for(1234.5, 48e3)
    np.testing.assert_array_equal(fxpt.phase_ramp_i32(-7, inc, 999),
                                  jfxpt.phase_ramp_i32(-7, inc, 999))
    assert fxpt.advance_u32(123, inc, 10 ** 9) == jfxpt.advance_u32(123, inc, 10 ** 9)
    for args, ftype in (((63, [(0, 0.2), (0.25, 0.5)], [1, 0], [1, 1]), "bandpass"),
                        ((64, [(0.05, 0.45)], [1], [1]), "hilbert")):
        np.testing.assert_array_equal(remez_exchange(*args, filter_type=ftype),
                                      jremez.remez_exchange(*args, filter_type=ftype))


def test_mm_native_build_flags_keep_the_python_arithmetic():
    """``mm.cpp`` builds with ``-ffp-contract=off`` (an FMA would break the
    bit-equality with the Python loop by an ulp), the fast chain with
    ``-march=native`` and contraction."""
    from futuresdr_tpu_torch.ops import _build
    assert "-ffp-contract=off" in _build.host_flags("mm")
    assert "-march=native" in _build.host_flags("fastchain")
    assert "-ffp-contract=off" not in _build.host_flags("fastchain")
