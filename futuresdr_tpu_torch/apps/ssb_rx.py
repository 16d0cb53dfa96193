"""SSB receiver; the port's counterpart of ``examples/ssb_rx.py`` (reference:
``examples/ssb``: file replay, SSB product detector, audio).

The chain runs as blocks on the Seify file-replay driver (the path a live
SDR would take; ``hw/__init__.py`` ``FileDriver``)::

    SeifySource(driver=file) -> XlatingFir(BFO shift + analytic bandpass,
    decim) -> Apply(real) [product detector] -> Agc -> WavSink | AudioSink

The XlatingFir rotates the BFO to DC and applies a one-sided 300..3000 Hz
analytic bandpass, so only the chosen sideband survives; taking the real part
is the product detector, the block twin of ``models/misc.ssb_demodulate``.
``--audio`` plays through ``AudioSink`` (a soundcard backend, or
``blocks/audio.set_audio_backend``) instead of writing a WAV file.

With no ``--input``, a two-tone USB test transmission (700 + 1900 Hz) is
synthesized to a temporary file and demodulated back; the app then checks
that the recovered audio's spectrum peaks at those tones. Host numpy, as in
the reference.

Run: ``python -m futuresdr_tpu_torch.apps.ssb_rx --wav ssb.wav``
     ``python -m futuresdr_tpu_torch.apps.ssb_rx --input capture.cf32 --bfo 12000
     --sideband lsb``
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from ..blocks import Agc, Apply, AudioSink, SeifyBuilder, VectorSink, WavSink, XlatingFir
from ..runtime import Flowgraph, Runtime

__all__ = ["sideband_taps", "synthesize_usb", "run", "main", "TONES"]

TONES = (700.0, 1900.0)


def sideband_taps(fs: float, sideband: str, audio_bw: float,
                  n_taps: int = 257) -> np.ndarray:
    """Analytic (one-sided) bandpass selecting [300, audio_bw] Hz (USB) or its
    mirror (LSB) at baseband, applied after the XlatingFir's BFO rotation;
    the Hamming-windowed design of ``models/misc.ssb_demodulate``."""
    lo, hi = (300.0, audio_bw) if sideband == "usb" else (-audio_bw, -300.0)
    f1, f2 = sorted((lo / fs, hi / fs))
    k = np.arange(n_taps) - (n_taps - 1) / 2
    h = (np.exp(2j * np.pi * f2 * k) - np.exp(2j * np.pi * f1 * k)) / \
        (2j * np.pi * k + 1e-30)
    h[(n_taps - 1) // 2] = 2 * np.pi * (f2 - f1) / (2 * np.pi)
    h *= np.hamming(n_taps)
    return h.astype(np.complex64)


def synthesize_usb(fs: float, bfo: float, seconds: float, tones=TONES) -> np.ndarray:
    """A two-tone USB transmission at the BFO offset (the upper sideband only:
    analytic tones translated by the BFO), with seeded noise."""
    t = np.arange(int(fs * seconds)) / fs
    sig = sum(np.exp(2j * np.pi * (bfo + f) * t) for f in tones)
    sig = sig / np.abs(sig).max() * 0.5
    noise = (np.random.default_rng(9).standard_normal((len(t), 2)) @
             np.array([1, 1j])) * 0.01
    return (sig + noise).astype(np.complex64)


def run(path: str, rate: float = 256e3, bfo: float = 12e3, sideband: str = "usb",
        audio_bw: float = 3000.0, decim: int = 4, wav=None, audio: bool = False):
    """Demodulate the cf32 capture at ``path``; returns ``(audio, fs_audio)``,
    the samples the AGC emitted (also written to ``wav`` or played)."""
    fs_audio = rate / decim
    fg = Flowgraph()
    src = (SeifyBuilder()
           .args(f"driver=file,path={path},repeat=false,throttle=false")
           .sample_rate(rate).build_source())
    bp = XlatingFir(sideband_taps(rate, sideband, audio_bw), decim=decim,
                    offset_freq=bfo, sample_rate=rate)
    detector = Apply(lambda x: x.real.astype(np.float32) * 2.0, np.complex64, np.float32)
    agc = Agc(np.float32, reference=0.3, adjustment_rate=1e-2, mode="block")
    probe = VectorSink(np.float32)
    fg.connect(src, bp, detector, agc)
    if audio:
        fg.connect(agc, AudioSink(int(fs_audio)))
    else:
        fg.connect(agc, WavSink(wav or "ssb_audio.wav", int(fs_audio)))
    fg.connect_stream(agc, "out", probe, "in")       # the analysis tap
    Runtime().run(fg)
    return probe.items(), fs_audio


def dominant_tones(audio: np.ndarray, fs_audio: float, skip: int = 1024) -> np.ndarray:
    """The six strongest frequencies (Hz) of the audio after ``skip`` samples."""
    spec = np.abs(np.fft.rfft(audio[skip:] * np.hanning(len(audio) - skip)))
    freqs = np.fft.rfftfreq(len(audio) - skip, 1.0 / fs_audio)
    return freqs[np.argsort(spec)[-6:]]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="SSB receiver on the file-replay driver")
    p.add_argument("--input", default=None, help="cf32 IQ capture (default: "
                   "synthesize a two-tone USB test signal)")
    p.add_argument("--rate", type=float, default=256e3)
    p.add_argument("--bfo", type=float, default=12e3,
                   help="carrier offset of the SSB signal in the capture")
    p.add_argument("--sideband", choices=("usb", "lsb"), default="usb")
    p.add_argument("--audio-bw", type=float, default=3000.0)
    p.add_argument("--decim", type=int, default=4)
    p.add_argument("--wav", default=None, help="write the demodulated audio here")
    p.add_argument("--audio", action="store_true",
                   help="play through the soundcard (AudioSink) instead of a WAV")
    a = p.parse_args(argv)

    synthesized = a.input is None
    tmp_path = None
    if synthesized:
        fd, tmp_path = tempfile.mkstemp(suffix=".cf32")
        os.close(fd)
        synthesize_usb(a.rate, a.bfo, 0.6).tofile(tmp_path)
        a.input = tmp_path
        print(f"# no --input: synthesized two-tone USB test signal -> {a.input}")
    try:
        audio, fs_audio = run(a.input, a.rate, a.bfo, a.sideband, a.audio_bw, a.decim,
                              a.wav, a.audio)
    finally:
        if tmp_path is not None:
            try:
                os.unlink(tmp_path)
            except OSError:
                pass
    print(f"# demodulated {len(audio)} audio samples at {fs_audio:.0f} Hz")
    if len(audio) > 1024:
        top = dominant_tones(audio, fs_audio)
        print(f"# dominant audio tones (Hz, 50 Hz bins): "
              f"{sorted(set(round(f / 50) * 50 for f in top))}")
        if synthesized:
            missing = [w for w in TONES if not any(abs(f - w) <= 50 for f in top)]
            if missing:
                print(f"# expected tones {missing} missing from {sorted(top)}")
                return 1
            print("# loopback OK: both test tones recovered")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
