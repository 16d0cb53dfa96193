"""The port's ADS-B (``futuresdr_tpu_torch/models/adsb``) on the CPU: the
cases of ``tests/test_adsb.py`` (published Mode S test vectors, the 1090 MHz
riddle's, and a PPM loopback through the detector, demodulator and tracker)
on the port's copy and runtime; the PPM modulator against the JAX package's
bit for bit, the detector's bits, the decoded messages, CPR solutions and the
tracker's aircraft (time injected) equal; the receiver over seeded cuts of
the stream; and the ``adsb_rx`` app.
"""

import asyncio
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from futuresdr_tpu.models import adsb as jadsb
from futuresdr_tpu.models.adsb import decoder as jdecoder
from futuresdr_tpu_torch.models.adsb import (modulate_frame, detect_and_demodulate, crc24,
                                             decode_frame, Tracker, cpr_global_decode,
                                             build_df17_frame)
from futuresdr_tpu_torch.models.adsb import AdsbReceiver, decoder

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def hex_to_bits(h: str) -> np.ndarray:
    v = bytes.fromhex(h)
    return np.unpackbits(np.frombuffer(v, np.uint8)).astype(np.uint8)


# well-known public test frames
CALLSIGN_FRAME = "8D4840D6202CC371C32CE0576098"     # KLM1023
POS_EVEN = "8D40621D58C382D690C8AC2863A7"           # lat 52.2572, lon 3.9194
POS_ODD = "8D40621D58C386435CC412692AD6"
VELOCITY_FRAME = "8D485020994409940838175B284F"     # 159 kt, trk 182.88, -832 fpm


def test_crc_validates_real_frames():
    for h in (CALLSIGN_FRAME, POS_EVEN, POS_ODD, VELOCITY_FRAME):
        assert crc24(hex_to_bits(h)) == 0
    bad = hex_to_bits(CALLSIGN_FRAME)
    bad[40] ^= 1
    assert crc24(bad) != 0


def test_decode_callsign():
    m = decode_frame(hex_to_bits(CALLSIGN_FRAME))
    assert m.crc_ok
    assert m.icao == 0x4840D6
    assert m.callsign == "KLM1023"


def test_decode_position_pair():
    me = decode_frame(hex_to_bits(POS_EVEN))
    mo = decode_frame(hex_to_bits(POS_ODD))
    assert me.crc_ok and mo.crc_ok
    assert me.cpr is not None and me.cpr[0] == 0
    assert mo.cpr is not None and mo.cpr[0] == 1
    assert me.altitude_ft == 38000
    pos = cpr_global_decode(me.cpr, mo.cpr, most_recent_odd=False)
    assert pos is not None
    lat, lon = pos
    assert abs(lat - 52.2572) < 0.001
    assert abs(lon - 3.9194) < 0.001


def test_decode_velocity():
    m = decode_frame(hex_to_bits(VELOCITY_FRAME))
    assert m.crc_ok
    assert abs(m.ground_speed_kt - 159.20) < 0.5
    assert abs(m.track_deg - 182.88) < 0.5
    assert m.vertical_rate_fpm == -832


def test_ppm_loopback_with_noise():
    rng = np.random.default_rng(0)
    frame_bits = hex_to_bits(CALLSIGN_FRAME)
    sig = modulate_frame(frame_bits, amplitude=1.0)
    stream = np.concatenate([
        0.05 * rng.random(500).astype(np.float32), sig + 0.05 * rng.random(len(sig)).astype(np.float32),
        0.05 * rng.random(300).astype(np.float32)])
    frames = detect_and_demodulate(stream)
    assert len(frames) == 1
    start, bits = frames[0]
    assert 495 <= start <= 505
    np.testing.assert_array_equal(bits, frame_bits)


def test_tracker_integration():
    tr = Tracker()
    for h in (CALLSIGN_FRAME,):
        tr.update(decode_frame(hex_to_bits(h)), now=0.0)
    ac = tr.aircraft[0x4840D6]
    assert ac.callsign == "KLM1023"
    tr.update(decode_frame(hex_to_bits(POS_EVEN)), now=1.0)
    tr.update(decode_frame(hex_to_bits(POS_ODD)), now=2.0)
    ac2 = tr.aircraft[0x40621D]
    assert ac2.lat is not None and abs(ac2.lat - 52.2572) < 0.01
    assert ac2.altitude_ft == 38000
    # expiry
    tr.update(decode_frame(hex_to_bits(VELOCITY_FRAME)), now=100.0)
    assert 0x4840D6 not in tr.aircraft


def test_build_frame_roundtrip():
    me = np.zeros(56, np.uint8)
    me[:5] = [0, 0, 1, 0, 0]     # TC 4: identification
    frame = build_df17_frame(0xABCDEF, me)
    assert crc24(frame) == 0
    m = decode_frame(frame)
    assert m.crc_ok and m.icao == 0xABCDEF and m.type_code == 4


def test_cpr_nl_table_edges():
    from futuresdr_tpu_torch.models.adsb.decoder import _cpr_nl
    assert _cpr_nl(0.0) == 59
    assert _cpr_nl(87.0) == 2
    assert _cpr_nl(-87.0) == 2
    assert _cpr_nl(88.5) == 1
    assert _cpr_nl(10.0) == 59           # interior of the NL=59 zone
    assert _cpr_nl(86.0) == 3            # near-polar interior still formula-driven
    assert _cpr_nl(45.0) == 42


def test_noisy_burst_train_exact_once():
    """Interrogation standard: 10 DF17 bursts in a noisy magnitude stream
    decode exactly once each, all CRC-valid, in order."""
    rng = np.random.default_rng(6)
    sent = [0xABC000 + i for i in range(10)]
    parts = []
    for i, icao in enumerate(sent):
        me = rng.integers(0, 2, 56).astype(np.uint8)
        parts += [np.zeros(300 + 41 * i, np.float32),
                  modulate_frame(build_df17_frame(icao, me))]
    parts.append(np.zeros(400, np.float32))
    mag = np.concatenate(parts)
    mag = (mag + 0.12 * np.abs(rng.standard_normal(len(mag)))).astype(np.float32)
    decoded = detect_and_demodulate(mag)
    msgs = [m for _, b in decoded
            if (m := decode_frame(b)) is not None and m.crc_ok]
    assert [m.icao for m in msgs] == sent


def _hexbits(h):
    v = int(h, 16)
    n = len(h) * 4
    return np.array([(v >> (n - 1 - i)) & 1 for i in range(n)], dtype=np.uint8)


def _df11_frame(icao):
    """Parity-consistent DF11 acquisition squitter for the given address."""
    from futuresdr_tpu_torch.models.adsb.decoder import crc24
    head = np.zeros(32, dtype=np.uint8)
    head[0:5] = [0, 1, 0, 1, 1]                     # DF=11
    head[8:32] = [(icao >> (23 - i)) & 1 for i in range(24)]
    rem = crc24(np.concatenate([head, np.zeros(24, np.uint8)]))
    return np.concatenate([head, np.array([(rem >> (23 - i)) & 1
                                           for i in range(24)], np.uint8)])


def test_surveillance_replies_published_vectors():
    """DF4/DF5 surveillance replies (published pyModeS vectors): altitude and
    squawk decode, with the ICAO recovered from the AP parity overlay."""
    m = decode_frame(_hexbits("2000171806A983"))
    assert m.df == 4 and m.altitude_ft == 36000 and m.icao_derived
    assert m.icao == 0x4CA7E8
    m = decode_frame(_hexbits("2A00516D492B80"))
    assert m.df == 5 and m.squawk == "0356" and m.icao_derived


def test_df11_all_call_roundtrip():
    """A parity-consistent DF11 acquisition squitter validates and yields the
    announced ICAO; a corrupted one fails the CRC gate."""
    icao = 0x4840D6
    frame = _df11_frame(icao)
    m = decode_frame(frame)
    assert m.df == 11 and m.crc_ok and m.icao == icao and not m.icao_derived
    bad = frame.copy(); bad[40] ^= 1
    assert not decode_frame(bad).crc_ok


def test_tracker_gates_derived_icao():
    """AP-overlay (unverified) addresses must never create aircraft — only
    update ones already acquired through a CRC-checked frame."""
    from futuresdr_tpu_torch.models.adsb.decoder import Tracker
    t = Tracker()
    alt = decode_frame(_hexbits("2000171806A983"))          # DF4, derived icao
    assert t.update(alt, now=0.0) is None and not t.aircraft
    # acquire via a valid DF11, then the DF4 altitude applies
    assert t.update(decode_frame(_df11_frame(alt.icao)), now=1.0) is not None
    ac = t.update(alt, now=2.0)
    assert ac is not None and ac.altitude_ft == 36000
    # identity reply fills the squawk on the same aircraft-acquisition rule
    sq = decode_frame(_hexbits("2A00516D492B80"))
    assert t.update(sq, now=3.0) is None                    # unknown icao: gated


def test_receiver_block_mode_s_surveillance():
    """Streamed DF11 acquisition then DF4 altitude updates the tracker; an
    AP-overlay reply for an unknown aircraft is gated (not posted, not counted)."""
    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import VectorSource
    from futuresdr_tpu_torch.models.adsb import AdsbReceiver
    from futuresdr_tpu_torch.models.adsb.phy import modulate_frame

    icao = 0x4CA7E8
    df11 = _df11_frame(icao)
    parts = [np.zeros(400, np.float32)]
    for bits in (_hexbits("2A00516D492B80"),    # DF5, unknown icao: gated
                 df11, _hexbits("2000171806A983")):
        parts += [modulate_frame(bits, amplitude=2.0), np.zeros(300, np.float32)]
    rx = AdsbReceiver()
    fg = Flowgraph()
    fg.connect_stream(VectorSource(np.concatenate(parts).astype(np.float32)),
                      "out", rx, "in")
    Runtime().run(fg)
    assert rx.n_frames == 2
    assert rx.tracker.aircraft[icao].altitude_ft == 36000
    assert 0x510AF9 not in rx.tracker.aircraft


def test_cpr_local_decode_with_reference():
    """Receiver-site-aided single-message position (canonical 1090-riddle
    vectors): the even frame with a nearby reference reproduces the global-pair
    solution; a ref_pos-equipped tracker gets a position from ONE message."""
    from futuresdr_tpu_torch.models.adsb.decoder import Tracker, cpr_local_decode
    me = decode_frame(_hexbits(POS_EVEN))
    lat, lon = cpr_local_decode(me.cpr, 52.25, 3.92)
    assert abs(lat - 52.2572021) < 1e-6 and abs(lon - 3.9193725) < 1e-6
    mo = decode_frame(_hexbits(POS_ODD))
    lat, lon = cpr_local_decode(mo.cpr, 52.25, 3.92)
    assert abs(lat - 52.2657801) < 1e-6 and abs(lon - 3.9389125) < 1e-6

    t = Tracker(ref_pos=(52.25, 3.92))
    ac = t.update(me, now=0.0)
    assert ac.lat is not None and abs(ac.lat - 52.2572021) < 1e-6
    t2 = Tracker()                       # without a reference: needs the pair
    assert t2.update(me, now=0.0).lat is None


def test_cpr_local_decode_guards():
    """Local decode wraps longitude to [-180, 180) and the tracker rejects
    local solutions landing beyond the 180 NM unambiguity range of the site
    (zone-corner decodes; aliasing by a whole zone is undetectable from one
    message — that is inherent to receiver-aided CPR)."""
    from futuresdr_tpu_torch.models.adsb.decoder import (Tracker, cpr_local_decode,
                                                   _dist_nm)
    lat, lon = cpr_local_decode((0, 60000, 1500), 45.0, 179.98)
    assert -180.0 <= lon < 180.0
    # a site whose zone estimate throws the solution >180 NM out: rejected
    me = decode_frame(_hexbits(POS_EVEN))
    ref = (48.6, -2.0)
    cand = cpr_local_decode(me.cpr, *ref)
    assert _dist_nm(*cand, *ref) > 180.0          # the guard's trigger condition
    t = Tracker(ref_pos=ref)
    assert t.update(me, now=0.0).lat is None, "out-of-range local CPR accepted"


def test_random_frame_train_fuzz():
    """Seeded sweep: random DF17 trains with interleaved surveillance replies
    decode exactly once each through the magnitude-stream receiver."""
    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import VectorSource
    from futuresdr_tpu_torch.models.adsb import AdsbReceiver, build_df17_frame
    from futuresdr_tpu_torch.models.adsb.phy import modulate_frame

    rng = np.random.default_rng(1090)
    icaos = [int(rng.integers(1, 1 << 24)) for _ in range(4)]
    parts = [np.zeros(300, np.float32)]
    n_expected = 0
    for i in range(10):
        icao = icaos[int(rng.integers(0, len(icaos)))]
        if rng.integers(0, 4) == 0:
            bits = _df11_frame(icao)
        else:
            me = rng.integers(0, 2, 56).astype(np.uint8)
            bits = build_df17_frame(icao, me)
        parts += [modulate_frame(bits, amplitude=2.0),
                  np.zeros(int(rng.integers(250, 800)), np.float32)]
        n_expected += 1
    sig = np.concatenate(parts)
    sig = (sig + 0.08 * np.abs(rng.standard_normal(len(sig)))).astype(np.float32)
    rx = AdsbReceiver()
    fg = Flowgraph()
    fg.connect_stream(VectorSource(sig), "out", rx, "in")
    Runtime().run(fg)
    assert rx.n_frames == n_expected, (rx.n_frames, n_expected)


# ---- the port against the JAX package ----

def _frames(rng, n):
    """``n`` frames: DF17 with random ME fields and DF11 all-calls, seeded."""
    out = []
    for _ in range(n):
        icao = int(rng.integers(1, 1 << 24))
        out.append(_df11_frame(icao) if rng.integers(0, 4) == 0 else
                   build_df17_frame(icao, rng.integers(0, 2, 56).astype(np.uint8)))
    return out


def _fields(m):
    return None if m is None else dataclasses.asdict(m)


def test_modulator_detector_and_decoder_equal_the_jax_package():
    """Seeded DF17 and DF11 frames: ``build_df17_frame`` and CRC24 equal, the
    PPM magnitude at two amplitudes bit for bit, and over a noisy stream the
    same detections (start, bits) and the same decoded messages, field for
    field, as the JAX package's."""
    rng = np.random.default_rng(1090)
    frames = _frames(rng, 12)
    for f in frames:
        assert crc24(f) == jdecoder.crc24(f)
    me = rng.integers(0, 2, 56).astype(np.uint8)
    assert np.array_equal(build_df17_frame(0xABCDEF, me), jadsb.build_df17_frame(0xABCDEF, me))
    parts = [np.zeros(300, np.float32)]
    for i, f in enumerate(frames):
        amp = 1.0 + (i % 2)
        sig, want = modulate_frame(f, amplitude=amp), jadsb.modulate_frame(f, amplitude=amp)
        assert sig.dtype == want.dtype and np.array_equal(sig.view(np.uint32),
                                                          want.view(np.uint32))
        parts += [sig, np.zeros(int(rng.integers(250, 800)), np.float32)]
    x = np.concatenate(parts)
    x = (x + 0.08 * np.abs(rng.standard_normal(len(x)))).astype(np.float32)
    got, want = detect_and_demodulate(x), jadsb.detect_and_demodulate(x)
    assert len(got) == len(frames) == len(want)
    for (s, b), (js, jb) in zip(got, want):
        assert s == js and np.array_equal(b, jb)
    assert [_fields(decode_frame(b)) for _, b in got] == \
        [_fields(jdecoder.decode_frame(b)) for _, b in want]
    for hexs in ("2000171806A983", "2A00516D492B80", CALLSIGN_FRAME, POS_EVEN, POS_ODD,
                 VELOCITY_FRAME):
        bits = _hexbits(hexs)
        assert _fields(decode_frame(bits)) == _fields(jdecoder.decode_frame(bits))


def test_cpr_and_tracker_equal_the_jax_package():
    """Global and local CPR on the published pair and on seeded positions
    fields, and a tracker fed the same messages at injected times (expiry
    included): the same solutions and the same aircraft."""
    me, mo = decode_frame(_hexbits(POS_EVEN)), decode_frame(_hexbits(POS_ODD))
    for odd in (False, True):
        assert cpr_global_decode(me.cpr, mo.cpr, odd) == \
            jdecoder.cpr_global_decode(me.cpr, mo.cpr, odd)
    rng = np.random.default_rng(1091)
    for _ in range(20):
        cpr = (int(rng.integers(0, 2)), int(rng.integers(0, 1 << 17)),
               int(rng.integers(0, 1 << 17)))
        ref = (float(rng.uniform(-80, 80)), float(rng.uniform(-180, 180)))
        assert decoder.cpr_local_decode(cpr, *ref) == jdecoder.cpr_local_decode(cpr, *ref)
    for lat in np.linspace(-89.9, 89.9, 37):
        assert decoder._cpr_nl(float(lat)) == jdecoder._cpr_nl(float(lat))
    hexes = [CALLSIGN_FRAME, POS_EVEN, POS_ODD, VELOCITY_FRAME, "2000171806A983",
             "2A00516D492B80"]
    msgs = [_hexbits(h) for h in hexes] + [_df11_frame(0x4CA7E8), _hexbits("2000171806A983")]
    for ref_pos in (None, (52.25, 3.92)):
        tr, jtr = Tracker(ref_pos=ref_pos), jdecoder.Tracker(ref_pos=ref_pos)
        for i, bits in enumerate(msgs + [_hexbits(VELOCITY_FRAME)]):
            now = 100.0 if i == len(msgs) else float(i)
            ac, jac = tr.update(decode_frame(bits), now=now), \
                jtr.update(jdecoder.decode_frame(bits), now=now)
            assert _fields(ac) == _fields(jac)
        assert {k: _fields(v) for k, v in tr.aircraft.items()} == \
            {k: _fields(v) for k, v in jtr.aircraft.items()}


# ---- the receiver however the stream is cut ----

class _Input:
    """The receiver's stream input, one piece of the stream at a time."""

    def __init__(self):
        self.buf, self.fin = np.zeros(0, np.float32), False

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


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_receiver_decodes_each_frame_once_however_the_stream_is_cut(seed):
    """Sixteen DF17 and DF11 frames in a noisy magnitude stream (0.08, the
    fuzz test's) cut into seeded stretches of 512 to 4,096 samples: each
    message posted once, in order, by the port's receiver and by the
    reference's alike."""
    rng = np.random.default_rng(seed)
    frames = _frames(rng, 16)
    parts = [np.zeros(300, np.float32)]
    for f in frames:
        parts += [modulate_frame(f, amplitude=2.0),
                  np.zeros(int(rng.integers(250, 800)), np.float32)]
    x = np.concatenate(parts)
    x = (x + 0.08 * np.abs(rng.standard_normal(len(x)))).astype(np.float32)
    cuts = np.random.default_rng(seed + 100)
    pieces, pos = [], 0
    while pos < len(x):
        c = int(cuts.integers(512, 4096))
        pieces.append(x[pos:pos + c])
        pos += c
    want = [decode_frame(f).icao for f in frames]
    rx, posts = _drive(AdsbReceiver(), pieces)
    assert rx.n_frames == len(frames)
    assert [p.to_map()["icao"].to_int() for p in posts] == want
    ref, jposts = _drive(jadsb.AdsbReceiver(), pieces)
    assert ref.n_frames == len(frames)
    assert [p.to_map()["icao"].to_int() for p in jposts] == want


# ---- the app ----

def test_adsb_rx_app_main():
    """``apps/adsb_rx.py``'s ``main()`` with no arguments, as
    ``tests/test_examples.py`` runs the reference's: six frames decoded (the
    foreign DF5 gated), KLM1023 named, exit 0; ``--file`` refuses with a
    clear error until ``blocks/io.FileSource`` is ported."""
    res = subprocess.run([sys.executable, "-m", "futuresdr_tpu_torch.apps.adsb_rx"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "decoded 6 frames" in res.stdout and "callsign=KLM1023" in res.stdout
    res = subprocess.run([sys.executable, "-m", "futuresdr_tpu_torch.apps.adsb_rx",
                          "--file", "capture.f32"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 2 and "FileSource" in res.stderr


def test_adsb_rx_app_run_tracks_the_published_aircraft():
    """``run()``: the stream synthesized by the port equals the reference
    example's frames through the JAX package's modulator; every CRC-checked
    message tracked, the position of 40621D the published odd frame's within
    1e-6 (``test_cpr_local_decode_with_reference``) and the even one's within
    0.01 (``test_tracker_integration``)."""
    from futuresdr_tpu_torch.apps.adsb_rx import SYNTH_FRAMES, run, synth_stream
    rng = np.random.default_rng(0)
    parts = []
    for f in SYNTH_FRAMES:
        bits = _df11_frame(f) if isinstance(f, int) else _hexbits(f)
        parts += [0.03 * rng.random(1000).astype(np.float32), jadsb.modulate_frame(bits)]
    parts.append(0.03 * rng.random(500).astype(np.float32))
    assert np.array_equal(synth_stream(), np.concatenate(parts))
    rx, seconds = run()
    assert rx.n_frames == 6 and seconds > 0
    ac = rx.tracker.aircraft
    assert ac[0x4840D6].callsign == "KLM1023"
    assert abs(ac[0x40621D].lat - 52.2657801) < 1e-6 and abs(ac[0x40621D].lon - 3.9389125) < 1e-6
    assert abs(ac[0x40621D].lat - 52.2572) < 0.01 and ac[0x40621D].altitude_ft == 38000
    assert abs(ac[0x485020].ground_speed_kt - 159.20) < 0.5
    assert ac[0x4CA7E8].altitude_ft == 36000 and 0x510AF9 not in ac
