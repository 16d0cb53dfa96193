"""The port's CW, SSB and keyfob transceivers (``futuresdr_tpu_torch/models/
misc.py``) on the CPU: the cases of ``tests/test_misc_models.py`` (reference:
examples/cw, examples/ssb, examples/keyfob) on the port's copy; the keying,
the CW audio, the SSB product detector's audio and the OOK burst against the
JAX package's bit for bit and the decoded text and bits equal; and the
``cw_beacon`` app, its text decoded from its WAV file.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from futuresdr_tpu.models import misc as jmisc
from futuresdr_tpu_torch.models.misc import (text_to_morse_keying, decode_morse_keying,
                                             cw_modulate, cw_demodulate, ssb_demodulate,
                                             ook_modulate, ook_demodulate)

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def test_morse_keying_roundtrip():
    msg = "CQ CQ DE W2FBI K"
    keying = text_to_morse_keying(msg, 10)
    assert decode_morse_keying(keying, 10) == msg


def test_cw_audio_roundtrip():
    fs = 8000.0
    msg = "HELLO TPU"
    audio = cw_modulate(msg, 600.0, fs, wpm=25)
    assert cw_demodulate(audio, fs, wpm=25) == msg


def test_ssb_recovers_tone():
    fs = 48000.0
    n = 48000
    t = np.arange(n) / fs
    # a USB signal: carrier at +5 kHz offset, 1 kHz audio tone → component at 6 kHz
    iq = np.exp(2j * np.pi * (5000 + 1000) * t).astype(np.complex64)
    audio = ssb_demodulate(iq, fs, bfo_offset=5000.0, sideband="usb")
    seg = audio[2000:]
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    peak = np.fft.rfftfreq(len(seg), 1 / fs)[np.argmax(spec)]
    assert abs(peak - 1000.0) < 10.0


def test_keyfob_ook_roundtrip():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, 64).astype(np.uint8)
    fs, rate = 100_000.0, 2_000.0
    burst = ook_modulate(bits, fs, rate)
    env = burst + 0.05 * rng.random(len(burst)).astype(np.float32)
    got = ook_demodulate(env, fs, rate, 64)
    assert got is not None
    np.testing.assert_array_equal(got, bits)


def test_random_roundtrip_fuzz():
    """Seeded sweep: random CW texts and OOK bit patterns loop back exactly."""
    from futuresdr_tpu_torch.models.misc import (cw_demodulate, cw_modulate,
                                           ook_demodulate, ook_modulate)
    rng = np.random.default_rng(73)
    alphabet = "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 "
    for trial in range(6):
        text = "".join(alphabet[int(rng.integers(0, len(alphabet)))]
                       for _ in range(int(rng.integers(3, 16)))).strip() or "OK"
        wpm = float(rng.uniform(12, 30))
        audio = cw_modulate(text, tone_hz=600.0, fs=8000.0, wpm=wpm)
        audio = (audio + 0.05 * rng.standard_normal(len(audio))).astype(np.float32)
        assert cw_demodulate(audio, fs=8000.0, wpm=wpm) == " ".join(text.split())

        bits = rng.integers(0, 2, int(rng.integers(8, 64))).astype(np.uint8)
        env = ook_modulate(bits, fs=48000.0, bit_rate=2000.0)
        env = (env + 0.05 * rng.standard_normal(len(env))).astype(np.float32)
        got = ook_demodulate(env, fs=48000.0, bit_rate=2000.0, n_bits=len(bits))
        np.testing.assert_array_equal(got, bits)


# ---- the port against the JAX package, bit for bit ----

def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("seed", range(3))
def test_cw_equals_the_jax_package(seed):
    """Seeded texts and speeds: the keying and the CW audio bit for bit, and
    the same text decoded from the noisy audio."""
    rng = np.random.default_rng(600 + seed)
    text = "".join("ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 /=?"[int(rng.integers(0, 40))]
                   for _ in range(int(rng.integers(3, 20))))
    dot = int(rng.integers(5, 40))
    assert _same(text_to_morse_keying(text, dot), jmisc.text_to_morse_keying(text, dot))
    wpm, tone = float(rng.uniform(12, 30)), float(rng.uniform(400, 900))
    audio = cw_modulate(text, tone, 8000.0, wpm)
    assert _same(audio, jmisc.cw_modulate(text, tone, 8000.0, wpm))
    noisy = (audio + 0.05 * rng.standard_normal(len(audio))).astype(np.float32)
    assert cw_demodulate(noisy, 8000.0, wpm) == jmisc.cw_demodulate(noisy, 8000.0, wpm)
    k = (rng.random(4000) < 0.5).astype(np.float32)
    assert decode_morse_keying(k, dot) == jmisc.decode_morse_keying(k, dot)


@pytest.mark.parametrize("sideband", ["usb", "lsb"])
def test_ssb_equals_the_jax_package(sideband):
    """The product detector's audio of a noisy two-tone signal, bit for bit."""
    rng = np.random.default_rng(610)
    fs = 48000.0
    t = np.arange(24000) / fs
    iq = (np.exp(2j * np.pi * 6000 * t) + 0.5 * np.exp(2j * np.pi * 3700 * t)
          + 0.05 * (rng.standard_normal(len(t)) + 1j * rng.standard_normal(len(t))))
    iq = iq.astype(np.complex64)
    got = ssb_demodulate(iq, fs, 5000.0, sideband)
    assert _same(got, jmisc.ssb_demodulate(iq, fs, 5000.0, sideband))


def test_ook_equals_the_jax_package():
    """The keyfob burst bit for bit and the same bits from a noisy envelope."""
    rng = np.random.default_rng(620)
    bits = rng.integers(0, 2, 48).astype(np.uint8)
    burst = ook_modulate(bits, 100_000.0, 2_000.0)
    assert _same(burst, jmisc.ook_modulate(bits, 100_000.0, 2_000.0))
    env = (burst + 0.1 * rng.standard_normal(len(burst))).astype(np.float32)
    got = ook_demodulate(env, 100_000.0, 2_000.0, 48)
    assert np.array_equal(got, jmisc.ook_demodulate(env, 100_000.0, 2_000.0, 48))
    assert np.array_equal(got, bits)


# ---- the app ----

def test_cw_beacon_app_main(tmp_path):
    """``apps/cw_beacon.py``'s ``main()`` as ``tests/test_examples.py`` runs
    the reference's (``HI --wav <tmp>/cw.wav``): the WAV written, the text
    decoded from it, exit 0."""
    wav = tmp_path / "cw.wav"
    res = subprocess.run([sys.executable, "-m", "futuresdr_tpu_torch.apps.cw_beacon", "HI",
                          "--wav", str(wav)], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert wav.stat().st_size > 44 and res.stdout.splitlines()[-1].strip() == "HI"


def test_cw_beacon_app_run_decodes_the_wav_file(tmp_path):
    """``run()`` at the app's default text: the WAV holds the keyed tone as
    16-bit PCM (``WavSink`` truncates to a step of 1/32767 of the JAX
    package's audio), and the text comes back from the file."""
    from futuresdr_tpu_torch.apps.cw_beacon import FS, read_wav, run
    text = "CQ CQ DE FUTURESDR TPU K"
    path, decoded = run(text, str(tmp_path / "beacon.wav"))
    assert decoded == text
    pcm = read_wav(path)
    want = jmisc.cw_modulate(text, 600.0, FS, 20.0)
    assert len(pcm) == len(want) and np.abs(pcm - want).max() <= 1 / 32767
