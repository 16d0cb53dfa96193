"""The port's ZigBee (``futuresdr_tpu_torch/models/zigbee``) on the CPU: the
cases of ``tests/test_zigbee.py`` on the port's copy and runtime; the chip
table, CRC, MAC framing and O-QPSK modulator against the JAX package's bit for
bit, and every timing mode's demodulation equal (the Mueller-Müller loop's
float32 arithmetic included); the receiver over seeded cuts of the stream
(where the port departs from the reference); and the loopback app's
``main()``.
"""

import asyncio
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from futuresdr_tpu.models import zigbee as jzb
from futuresdr_tpu_torch.models.zigbee import (CHIP_SEQUENCES, modulate_frame,
                                               demodulate_stream, mac_frame, mac_deframe,
                                               crc16_802154)
from futuresdr_tpu_torch.models.zigbee import ZigbeeReceiver, phy

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def test_chip_table_distances():
    """All 16 sequences must be mutually far apart (DSSS property)."""
    pm = CHIP_SEQUENCES.astype(np.int8) * 2 - 1
    g = pm @ pm.T
    off_diag = g - np.diag(np.diag(g))
    assert (np.diag(g) == 32).all()
    assert np.abs(off_diag).max() <= 8


def test_crc_known_behavior():
    assert crc16_802154(b"") == 0x0000
    c1 = crc16_802154(b"\x01\x02\x03")
    assert 0 <= c1 <= 0xFFFF
    assert c1 != crc16_802154(b"\x01\x02\x04")


def test_mac_roundtrip():
    m = mac_frame(b"zigbee payload", seq=7)
    assert mac_deframe(m) == b"zigbee payload"
    bad = bytearray(m)
    bad[4] ^= 0x10
    assert mac_deframe(bytes(bad)) is None


def test_loopback_clean():
    psdu = mac_frame(b"hello 802.15.4")
    sig = modulate_frame(psdu)
    frames = demodulate_stream(np.concatenate(
        [np.zeros(333, np.complex64), sig, np.zeros(200, np.complex64)]))
    assert len(frames) == 1
    assert frames[0] == psdu
    assert mac_deframe(frames[0]) == b"hello 802.15.4"


def test_loopback_noise_and_phase():
    rng = np.random.default_rng(0)
    psdu = mac_frame(bytes(range(40)))
    sig = modulate_frame(psdu)
    sig = np.concatenate([np.zeros(100, np.complex64), sig, np.zeros(100, np.complex64)])
    sig = sig * np.exp(1j * 1.234)                      # arbitrary phase rotation
    sig = (sig + 0.1 * (rng.standard_normal(len(sig))
                        + 1j * rng.standard_normal(len(sig)))).astype(np.complex64)
    frames = demodulate_stream(sig)
    assert len(frames) == 1 and frames[0] == psdu


def test_multiple_frames():
    parts = []
    psdus = [mac_frame(f"frame {i}".encode(), seq=i) for i in range(3)]
    for p in psdus:
        parts += [modulate_frame(p), np.zeros(300, np.complex64)]
    frames = demodulate_stream(np.concatenate(parts))
    assert frames == psdus


def test_mm_timing_mode_realtime_with_drift():
    """Block-vectorized Mueller-Muller mode (VERDICT r1 item 10): 20 drifting-clock
    frames decode, and throughput clears the 4 Mchip/s real-time bar."""
    import time
    rng = np.random.default_rng(0)
    frames = [bytes(rng.integers(0, 256, 20, dtype=np.uint8).tolist())
              for _ in range(20)]
    parts = []
    for f in frames:
        parts.append(np.zeros(200, np.complex64))
        parts.append(modulate_frame(f))
    parts.append(np.zeros(200, np.complex64))
    sig = np.concatenate(parts)
    ppm = 50
    t_new = np.arange(int(len(sig) / (1 + ppm * 1e-6))) * (1 + ppm * 1e-6)
    i = np.clip(t_new.astype(int), 0, len(sig) - 2)
    fr = t_new - i
    x = ((1 - fr) * sig[i] + fr * sig[i + 1]).astype(np.complex64)
    x = x + 0.02 * (rng.standard_normal(len(x))
                    + 1j * rng.standard_normal(len(x))).astype(np.complex64)
    t0 = time.perf_counter()
    got = demodulate_stream(x, timing="mm")
    rate = len(x) / (time.perf_counter() - t0) / 1e6
    n_ok = sum(1 for f in frames if f in got)
    assert n_ok >= 18, f"only {n_ok}/20 frames decoded under 50ppm drift"
    import os
    if os.environ.get("FSDR_PERF_ASSERT"):    # wall-clock: opt-in (flaky on shared CI)
        assert rate > 2.0, f"MM mode too slow: {rate:.2f} Msps"  # 5+ typical


def test_coherent_demod_clean_and_impaired():
    """Coherent burst-synchronized RX: clean, CFO within pull-in, phase, noise."""
    psdu = mac_frame(b"coherent zigbee!")
    sig = np.concatenate([np.zeros(100, np.complex64), modulate_frame(psdu),
                          np.zeros(100, np.complex64)])
    rng = np.random.default_rng(0)
    assert demodulate_stream(sig, timing="coherent") == [psdu]
    for cfo, namp in ((0.004, 0.15), (-0.003, 0.25), (0.006, 0.3)):
        x = sig * np.exp(1j * (0.7 + cfo * np.arange(len(sig))))
        x = (x + namp * (rng.standard_normal(len(x))
                         + 1j * rng.standard_normal(len(x))) / np.sqrt(2)
             ).astype(np.complex64)
        assert demodulate_stream(x, timing="coherent") == [psdu], (cfo, namp)


def test_coherent_beats_discriminator_at_low_snr():
    """The coherent matched receiver's raison d'etre: at ~0 dB SNR it still
    decodes every burst while the discriminator paths (which square the noise)
    have collapsed. Deterministic seeds."""
    psdu = mac_frame(b"snr sweep payload")
    base = np.concatenate([np.zeros(80, np.complex64), modulate_frame(psdu),
                           np.zeros(80, np.complex64)])
    rng = np.random.default_rng(42)
    namp = 0.9
    wins = {"phase": 0, "coherent": 0}
    for _ in range(10):
        n = (rng.standard_normal(len(base))
             + 1j * rng.standard_normal(len(base))) / np.sqrt(2)
        x = (base * np.exp(1j * 0.4) + namp * n).astype(np.complex64)
        for m in wins:
            wins[m] += demodulate_stream(x, timing=m) == [psdu]
    assert wins["coherent"] >= 8, wins
    assert wins["phase"] <= 3, wins       # discriminator collapsed here


def test_coherent_multi_burst():
    """Several bursts with distinct payloads and per-burst phases in one stream."""
    rng = np.random.default_rng(5)
    parts, sent = [], []
    for i in range(4):
        psdu = mac_frame(f"burst {i}".encode() * (i + 1))
        sent.append(psdu)
        burst = modulate_frame(psdu) * np.exp(1j * rng.uniform(0, 2 * np.pi))
        parts += [np.zeros(150 + 31 * i, np.complex64), burst.astype(np.complex64)]
    parts.append(np.zeros(150, np.complex64))
    sig = np.concatenate(parts)
    sig = (sig + 0.1 * (rng.standard_normal(len(sig))
                        + 1j * rng.standard_normal(len(sig))) / np.sqrt(2)
           ).astype(np.complex64)
    assert demodulate_stream(sig, timing="coherent") == sent


def test_iq_delay_block():
    """IqDelay (`iq_delay.rs` role): the Q rail is delayed by `delay` samples
    relative to I, seeded with zeros, streaming across work() windows."""
    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
    from futuresdr_tpu_torch.models.zigbee import IqDelay

    rng = np.random.default_rng(0)
    x = (rng.standard_normal(10000) + 1j * rng.standard_normal(10000)
         ).astype(np.complex64)
    fg = Flowgraph()
    snk = VectorSink(np.complex64)
    fg.connect(VectorSource(x), IqDelay(delay=2), snk)
    Runtime().run(fg)
    y = np.asarray(snk.items())
    assert len(y) == len(x)
    np.testing.assert_allclose(y.real, x.real, atol=0)
    np.testing.assert_allclose(y.imag[:2], 0.0)
    np.testing.assert_allclose(y.imag[2:], x.imag[:-2], atol=0)


def test_random_payload_roundtrip_fuzz():
    """Seeded sweep over random payload lengths/content and timing modes."""
    from futuresdr_tpu_torch.models.zigbee import (demodulate_stream, mac_deframe,
                                             mac_frame, modulate_frame)
    rng = np.random.default_rng(154)
    for trial in range(8):
        timing = ("phase", "mm", "coherent")[int(rng.integers(0, 3))]
        n_pay = int(rng.integers(1, 100))
        payload = rng.integers(0, 256, n_pay).astype(np.uint8).tobytes()
        sig = modulate_frame(mac_frame(payload, seq=trial))
        x = np.concatenate([np.zeros(int(rng.integers(64, 600)), np.complex64),
                            sig, np.zeros(256, np.complex64)])
        x = (x * np.exp(1j * float(rng.uniform(0, 6.28)))
             + 0.05 * (rng.standard_normal(len(x))
                       + 1j * rng.standard_normal(len(x)))).astype(np.complex64)
        got = [mac_deframe(ps) for ps in demodulate_stream(x, timing=timing)]
        assert payload in got, (trial, timing, n_pay)


def test_mm_acquisition_survives_noise_only_prefix():
    """Regression (r5 campaign batch 12, offset 2112168 — the fourth
    finding): the Mueller-Müller loop adapted its clock on the noise-only
    prefix (random discriminator angles), occasionally wrecking acquisition
    so badly that a clean σ=0.05 frame produced ZERO candidates while the
    phase and coherent paths both recovered it. Low-energy blocks now freeze
    the loop (no step/phase adaptation), so acquisition starts from nominal
    timing at the burst. This is the exact campaign draw."""
    from futuresdr_tpu_torch.models.zigbee import (demodulate_stream, mac_deframe,
                                             mac_frame, modulate_frame)
    rng = np.random.default_rng(154 + 2112168)
    payload = None
    for trial in range(8):                     # trial 7 is the failing draw
        timing = ("phase", "mm", "coherent")[int(rng.integers(0, 3))]
        n_pay = int(rng.integers(1, 100))
        payload = rng.integers(0, 256, n_pay).astype(np.uint8).tobytes()
        sig = modulate_frame(mac_frame(payload, seq=trial))
        x = np.concatenate([np.zeros(int(rng.integers(64, 600)), np.complex64),
                            sig, np.zeros(256, np.complex64)])
        x = (x * np.exp(1j * float(rng.uniform(0, 6.28)))
             + 0.05 * (rng.standard_normal(len(x))
                       + 1j * rng.standard_normal(len(x)))).astype(np.complex64)
        if trial == 7:
            assert timing == "mm"
            got = [mac_deframe(ps) for ps in demodulate_stream(x, timing="mm")]
            assert payload in got

    # the gate must hold at ANY burst duty cycle (a first-cut
    # quantile gate collapsing when the burst covers <10% of the capture):
    # a ~5% duty frame in a long idle capture, and an all-signal capture
    # where adaptation must still run
    rng = np.random.default_rng(9)
    payload = bytes(range(50))
    sig = modulate_frame(mac_frame(payload))
    x = np.concatenate([np.zeros(90_000, np.complex64), sig,
                        np.zeros(8_000, np.complex64)])
    x = (x + 0.05 * (rng.standard_normal(len(x))
                     + 1j * rng.standard_normal(len(x)))).astype(np.complex64)
    assert payload in [mac_deframe(ps)
                       for ps in demodulate_stream(x, timing="mm")]
    x2 = (sig + 0.05 * (rng.standard_normal(len(sig))
                        + 1j * rng.standard_normal(len(sig)))
          ).astype(np.complex64)
    assert payload in [mac_deframe(ps)
                       for ps in demodulate_stream(x2, timing="mm")]


def test_mm_dual_start_phase_covers_pull_in_range():
    """Regression (r5 campaign batch 13, offset 5528176 — the fifth finding):
    with adaptation frozen during the noise prefix, the MM loop's INITIAL
    phase persists to the burst, and its pull-in range is only ~a quarter
    chip — one draw's default start produced chips too poor for the SFD scan
    while every start ≥1.5 samples recovered the frame. The mm path now runs
    two half-chip-spaced starts (one is always within pull-in). Exact
    campaign draw."""
    from futuresdr_tpu_torch.models.zigbee import (demodulate_stream, mac_deframe,
                                             mac_frame, modulate_frame)
    rng = np.random.default_rng(154 + 5528176)
    for trial in range(4):
        timing = ("phase", "mm", "coherent")[int(rng.integers(0, 3))]
        n_pay = int(rng.integers(1, 100))
        payload = rng.integers(0, 256, n_pay).astype(np.uint8).tobytes()
        sig = modulate_frame(mac_frame(payload, seq=trial))
        x = np.concatenate([np.zeros(int(rng.integers(64, 600)), np.complex64),
                            sig, np.zeros(256, np.complex64)])
        x = (x * np.exp(1j * float(rng.uniform(0, 6.28)))
             + 0.05 * (rng.standard_normal(len(x))
                       + 1j * rng.standard_normal(len(x)))).astype(np.complex64)
        if trial == 3:
            assert timing == "mm"
            got = [mac_deframe(ps) for ps in demodulate_stream(x, timing="mm")]
            assert payload in got


# ---- the port against the JAX package, bit for bit ----

def test_codecs_and_modulator_equal_the_jax_package():
    """The chip table, CRC16, MAC framing (and deframing of corrupted MPDUs)
    and the O-QPSK baseband, bit for bit, on seeded payloads of 0 to 116
    bytes."""
    assert np.array_equal(CHIP_SEQUENCES, jzb.CHIP_SEQUENCES)
    rng = np.random.default_rng(154)
    for n in (0, 1, 17, 60, 116):
        payload = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert crc16_802154(payload) == jzb.crc16_802154(payload)
        seq = int(rng.integers(0, 256))
        psdu = mac_frame(payload, seq)
        assert psdu == jzb.mac_frame(payload, seq)
        bad = bytearray(psdu)
        bad[int(rng.integers(0, len(bad)))] ^= 1 << int(rng.integers(0, 8))
        assert mac_deframe(bytes(bad)) == jzb.mac_deframe(bytes(bad))
        sig, want = modulate_frame(psdu), jzb.modulate_frame(psdu)
        assert sig.dtype == want.dtype == np.complex64
        assert np.array_equal(sig.view(np.uint64), want.view(np.uint64))


@pytest.mark.parametrize("timing", ["phase", "mm", "coherent"])
def test_demodulation_equals_the_jax_package(timing):
    """A noisy train of four frames with a carrier phase and a 30 ppm clock
    offset: every timing mode gives the JAX package's PSDUs (the
    Mueller-Müller loop keeps the reference's float32 promotion), the frames
    sent, in the order they were sent. The reference's order is its
    search's: the two Mueller-Müller starts are scanned one after the other,
    and here the second finds frame 2 after the first found frame 3 (ROADMAP
    Queue 3)."""
    rng = np.random.default_rng(155)
    parts, sent = [], []
    for i in range(4):
        psdu = mac_frame(rng.integers(0, 256, int(rng.integers(5, 60)),
                                      dtype=np.uint8).tobytes(), i)
        sent.append(psdu)
        parts += [np.zeros(int(rng.integers(100, 600)), np.complex64), modulate_frame(psdu)]
    sig = np.concatenate(parts + [np.zeros(300, np.complex64)])
    t = np.arange(int(len(sig) / (1 + 30e-6))) * (1 + 30e-6)
    i = np.clip(t.astype(int), 0, len(sig) - 2)
    x = ((1 - (t - i)) * sig[i] + (t - i) * sig[i + 1]) * np.exp(1j * 0.9)
    x = (x + 0.1 * (rng.standard_normal(len(x))
                    + 1j * rng.standard_normal(len(x)))).astype(np.complex64)
    got, want = demodulate_stream(x, timing=timing), jzb.demodulate_stream(x, timing=timing)
    assert sorted(got) == sorted(want)
    assert got == sent
    assert (want != sent) == (timing == "mm")


def test_iq_delay_equals_the_jax_package():
    """``IqDelay`` in a flowgraph of each package: the same samples, bit for
    bit."""
    from futuresdr_tpu import Flowgraph as JFlowgraph, Runtime as JRuntime
    from futuresdr_tpu.blocks import VectorSink as JSink, VectorSource as JSource
    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
    from futuresdr_tpu_torch.models.zigbee import IqDelay

    rng = np.random.default_rng(156)
    x = (rng.standard_normal(5000) + 1j * rng.standard_normal(5000)).astype(np.complex64)
    fg, snk = Flowgraph(), VectorSink(np.complex64)
    fg.connect(VectorSource(x), IqDelay(delay=3), snk)
    Runtime().run(fg)
    jfg, jsnk = JFlowgraph(), JSink(np.complex64)
    jfg.connect(JSource(x), jzb.IqDelay(delay=3), jsnk)
    JRuntime().run(jfg)
    got, want = np.asarray(snk.items()), np.asarray(jsnk.items())
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64))


# ---- the receiver however the stream is cut ----

class _Input:
    """The receiver's stream input, one piece of the stream at a time."""

    def __init__(self):
        self.buf, self.fin = np.zeros(0, np.complex64), False

    def slice(self):
        return self.buf

    def consume(self, n):
        self.buf = self.buf[n:]

    def finished(self):
        return self.fin

    def available(self):
        return len(self.buf)


class _Io:
    call_again = finished = False


class _Mio:
    def __init__(self):
        self.posts = []

    def post(self, port, p):
        self.posts.append(p)


def _drive(rx, pieces):
    """``rx.work()`` once a piece, the pieces in order: what a flowgraph
    does when its buffer hands the receiver the stream in these stretches."""
    rx.input = _Input()
    mio = _Mio()
    for i, piece in enumerate(pieces):
        rx.input.buf, rx.input.fin = piece, i == len(pieces) - 1
        asyncio.run(rx.work(_Io(), mio, None))
    return rx, mio.posts


@pytest.mark.parametrize("timing", ["phase", "mm", "coherent"])
@pytest.mark.parametrize("seed", [0, 1])
def test_receiver_decodes_each_frame_once_however_the_stream_is_cut(seed, timing):
    """Six frames of 1 to 116 payload bytes with the transmitter's 2,000-sample
    gap, noise 0.1 (the loopback app's), cut into seeded stretches of 1,024 to
    16,384 samples: the port's receiver posts every payload once, in order,
    in each timing mode. The reference's keeps a tail of 5,120 samples, so a frame longer than
    that (about 20 bytes) that a cut crosses is whole in no window: over the
    same pieces it loses frames (ROADMAP Queue 3)."""
    rng = np.random.default_rng(seed)
    sent = [rng.integers(0, 256, int(rng.integers(1, 117)), dtype=np.uint8).tobytes()
            for _ in range(6)]
    x = np.concatenate([np.concatenate([modulate_frame(mac_frame(pl, i)),
                                        np.zeros(2000, np.complex64)])
                        for i, pl in enumerate(sent)])
    x = (x + 0.1 * (rng.standard_normal(len(x))
                    + 1j * rng.standard_normal(len(x)))).astype(np.complex64)
    cuts = np.random.default_rng(seed + 100)
    pieces, pos = [], 0
    while pos < len(x):
        c = int(cuts.integers(1024, 16384))
        pieces.append(x[pos:pos + c])
        pos += c
    rx, posts = _drive(ZigbeeReceiver(timing=timing), pieces)
    assert rx.frames == sent and [p.to_blob() for p in posts] == sent
    ref, _ = _drive(jzb.ZigbeeReceiver(timing=timing), pieces)
    assert len(ref.frames) < len(sent) and all(f in sent for f in ref.frames)
    assert max(len(modulate_frame(mac_frame(pl))) for pl in sent) > ref.OVERLAP


def test_coherent_takes_a_long_frame_that_starts_on_an_odd_sample():
    """The coherent mode detects on even lags. A 108-byte frame at noise 0.1
    that starts on an odd sample of the window (seed 1's last frame, where a
    cut left the receiver's window) is taken by the port, which moves to the
    odd lag beside the even one; the reference, one sample off and with no
    carrier tracking, loses its last nibbles (ROADMAP Queue 3)."""
    rng = np.random.default_rng(1)
    sent = [rng.integers(0, 256, int(rng.integers(1, 117)), dtype=np.uint8).tobytes()
            for _ in range(6)]
    x = np.concatenate([np.concatenate([modulate_frame(mac_frame(pl, i)),
                                        np.zeros(2000, np.complex64)])
                        for i, pl in enumerate(sent)])
    x = (x + 0.1 * (rng.standard_normal(len(x))
                    + 1j * rng.standard_normal(len(x)))).astype(np.complex64)
    start = len(x) - 2000 - len(modulate_frame(mac_frame(sent[5], 5)))
    assert len(sent[5]) == 108
    for lo in (start - 6957, start - 3507):
        assert [mac_deframe(p) for p in demodulate_stream(x[lo:], timing="coherent")] \
            == [sent[5]]
        assert jzb.demodulate_stream(x[lo:], timing="coherent") == []


def test_receiver_tail_holds_the_longest_frame():
    """The receiver's tail holds a frame of the largest PSDU, 127 bytes."""
    assert len(modulate_frame(bytes(127))) <= ZigbeeReceiver().OVERLAP
    assert ZigbeeReceiver().OVERLAP >= len(phy.modulate_frame(bytes(127))) + 5120 - 4


# ---- the app ----

def test_loopback_app_main():
    """``apps/zigbee_loopback.py``'s ``main()`` as ``tests/test_examples.py``
    runs the reference's (``--frames 2``): both payloads decoded, exit 0."""
    res = subprocess.run([sys.executable, "-m", "futuresdr_tpu_torch.apps.zigbee_loopback",
                          "--frames", "2"], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "decoded 2/2 MPDUs" in res.stdout


def test_loopback_app_run_takes_every_frame():
    """``run()`` at the reference's defaults: the four payloads, in order."""
    from futuresdr_tpu_torch.apps.zigbee_loopback import run
    sent, got, seconds = run()
    assert got == sent and len(sent) == 4 and seconds > 0
