"""The port's Rattlegram (``futuresdr_tpu_torch/models/rattlegram``) on the
CPU: the cases of ``tests/test_rattlegram_fec.py`` (BCH(255,71), the CRCs,
OSD, the systematic polar code and its list decoder) and of
``tests/test_rattlegram.py`` (the OFDM audio modem, its metadata and its
blocks) on the port's copy and runtime; the encoders and the modulator
against the JAX package's bit for bit (float32 FFTs included) and the
decoders' results equal; the receiver over seeded cuts of the stream; and
the ``rattlegram_loopback`` and ``modem_ota`` apps.

Golden strategy of the FEC cases: every codec is validated by TWO independent
constructions (polynomial long-division vs generator-matrix product for BCH;
LFSR bit-shift spec vs numpy mod for parity; CRC residue-zero property for the
polar CRC aid) plus noisy-channel roundtrips.
"""

import asyncio
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from futuresdr_tpu.models import rattlegram as jrg
from futuresdr_tpu.models.rattlegram import fec as jfec
from futuresdr_tpu.models.rattlegram import modem as jmodem
from futuresdr_tpu.models.rattlegram import polar as jpolar
from futuresdr_tpu_torch.models.rattlegram import fec, polar
from futuresdr_tpu_torch.models.rattlegram import mls, Modem, ModemParams, modulate, demodulate
from futuresdr_tpu_torch.models.rattlegram import ModemReceiver, modem

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# BCH
# ---------------------------------------------------------------------------

def _lfsr_parity(data_bits):
    """Independent spec implementation: the reference's shift-register division
    (`bch.rs:62-85`) — MSB-first LFSR with the generator's low coefficients."""
    g = fec.bch_genpoly()            # ascending coeffs, g[184] = leading 1
    np_ = fec.BCH_NP
    # register holds the remainder, MSB (x^183) first
    reg = np.zeros(np_, np.uint8)
    gen = g[::-1][1:]                # descending, drop leading x^184 term
    for bit in data_bits:
        fb = bit ^ reg[0]
        reg = np.roll(reg, -1)
        reg[-1] = 0
        if fb:
            reg ^= gen
    return reg


def test_bch_genpoly_structure():
    g = fec.bch_genpoly()
    assert len(g) == 185 and g[0] == 1 and g[-1] == 1
    # generator divides x^255 - 1 (codeword polynomial property)
    x255 = np.zeros(256, np.uint8)
    x255[0] = x255[255] = 1
    r = x255.copy()
    gd = g[::-1]
    for i in range(255 - 184 + 1):
        if r[i]:
            r[i:i + 185] ^= gd
    assert not r.any(), "g(x) must divide x^255 + 1"


def test_bch_parity_two_constructions_agree():
    rng = np.random.default_rng(7)
    G = fec.bch_generator_matrix()
    for _ in range(16):
        data = rng.integers(0, 2, 71).astype(np.uint8)
        par_poly = fec.bch_parity(data)
        par_mat = ((data @ G) & 1)[71:]
        par_lfsr = _lfsr_parity(data)
        np.testing.assert_array_equal(par_poly, par_mat)
        np.testing.assert_array_equal(par_poly, par_lfsr)


def test_bch_min_distance_sample():
    """Random nonzero codewords weigh ≥ the designed distance 47."""
    rng = np.random.default_rng(8)
    G = fec.bch_generator_matrix()
    for _ in range(32):
        d = rng.integers(0, 2, 71).astype(np.uint8)
        if not d.any():
            continue
        w = int(((d @ G) & 1).sum())
        assert w >= 47, w


# ---------------------------------------------------------------------------
# CRCs
# ---------------------------------------------------------------------------

def test_crc32_residue_zero():
    """Appending the CRC32 LSB-first makes the bitwise residue zero — the property the
    polar decoder's path selection relies on (`polar.rs:219-228`)."""
    rng = np.random.default_rng(9)
    for n in (1, 7, 85, 128):
        msg = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        crc = fec.crc32_rattlegram(msg)
        bits = np.concatenate([fec.bytes_to_le_bits(msg, 8 * n),
                               ((crc >> np.arange(32)) & 1).astype(np.uint8)])
        assert fec.crc32_bits(bits) == 0


def test_crc16_known_relation():
    # reflected CRC with init 0: crc(b"") == 0 and linearity over zero-padding prefix
    assert fec.crc16_rattlegram(b"") == 0
    assert fec.crc16_rattlegram(b"\x00" * 8) == 0
    a = fec.crc16_rattlegram(b"\x01")
    assert 0 < a < (1 << 16)


# ---------------------------------------------------------------------------
# MLS / scrambler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("poly,period", [(0b10001001, 127), (0b100101011, 255),
                                         (0b100101010001, 2047)])
def test_mls_full_period(poly, period):
    bits = fec.mls_bits(poly, 2 * period)
    pm = bits.astype(np.int32) * 2 - 1
    # maximal length: period-n autocorrelation is -1 off-peak over one period
    seq = pm[:period]
    for lag in (1, 7, 31):
        assert abs(int(seq @ np.roll(seq, lag))) <= 1


def test_xorshift32_sequence():
    x = fec.Xorshift32()
    first = [x.next() for _ in range(3)]
    assert first[0] == 723471715          # published xorshift32 seed-2463534242 stream
    y = fec.Xorshift32()
    assert [y.next() for _ in range(3)] == first


# ---------------------------------------------------------------------------
# OSD
# ---------------------------------------------------------------------------

def _noisy_soft(cw, n_flips, rng, weak=16, strong=96):
    soft = np.where(cw > 0, -strong, strong).astype(np.int16)
    flip = rng.choice(255, n_flips, replace=False)
    soft[flip] = np.sign(-soft[flip]) * weak
    return np.clip(soft, -127, 127).astype(np.int8)


def test_osd_clean_and_weak_errors():
    rng = np.random.default_rng(10)
    G = fec.bch_generator_matrix().astype(np.int8)
    data = rng.integers(0, 2, 71).astype(np.uint8)
    cw = (data @ fec.bch_generator_matrix()) & 1
    hard, conf = fec.osd_decode(np.where(cw > 0, -64, 64).astype(np.int8), G)
    assert np.array_equal(hard, cw) and conf
    for n_err in (8, 24, 40):
        ok = 0
        for t in range(8):
            r = np.random.default_rng(100 + t)
            hard, _ = fec.osd_decode(_noisy_soft(cw, n_err, r), G)
            ok += np.array_equal(hard, cw)
        assert ok >= 7, (n_err, ok)


def test_osd_output_is_codeword():
    """Whatever the channel does, OSD must emit a valid codeword of the code."""
    rng = np.random.default_rng(11)
    G = fec.bch_generator_matrix()
    H_rows = G  # systematic G: parity check via re-encoding the data part
    soft = rng.integers(-100, 100, 255).astype(np.int8)
    hard, _ = fec.osd_decode(soft, G.astype(np.int8))
    reenc = (hard[:71] @ G) & 1
    np.testing.assert_array_equal(reenc, hard)


# ---------------------------------------------------------------------------
# polar
# ---------------------------------------------------------------------------

def test_frozen_tables_info_counts():
    for words, k in ((polar.FROZEN_2048_712, 712), (polar.FROZEN_2048_1056, 1056),
                     (polar.FROZEN_2048_1392, 1392)):
        mask = polar.frozen_mask(words)
        assert mask.shape == (2048,)
        assert int((mask == 0).sum()) == k


@pytest.mark.parametrize("data_bits,nbytes", [(680, 85), (1024, 128), (1360, 170)])
def test_polar_systematic_roundtrip_clean(data_bits, nbytes):
    rng = np.random.default_rng(12)
    msg = bytes(rng.integers(0, 256, nbytes, dtype=np.uint8))
    code = polar.polar_encode(msg, data_bits)
    assert set(np.unique(code)) <= {-1, 1}
    # systematic property: data bits appear at the non-frozen positions
    mask = polar.frozen_mask(polar.FROZEN_BY_DATA_BITS[data_bits])
    info = np.nonzero(mask == 0)[0]
    bits = (code[info[:data_bits]] < 0).astype(np.uint8)
    assert fec.le_bits_to_bytes(bits) == msg
    dec, flips = polar.polar_decode((code * 96).astype(np.int8), data_bits)
    assert dec == msg and flips == 0


def test_polar_decode_with_bit_flips():
    rng = np.random.default_rng(13)
    msg = bytes(rng.integers(0, 256, 85, dtype=np.uint8))
    code = polar.polar_encode(msg, 680)
    for n_flips in (20, 50):
        for t in range(3):
            r = np.random.default_rng(300 + 10 * n_flips + t)
            soft = (code.astype(np.int16) * 48)
            flip = r.choice(2048, n_flips, replace=False)
            soft[flip] = -soft[flip] // 3
            dec, flips = polar.polar_decode(np.clip(soft, -127, 127).astype(np.int8),
                                            680)
            assert dec == msg, (n_flips, t)
            assert flips >= 0


def test_polar_decode_garbage_returns_none():
    rng = np.random.default_rng(14)
    soft = rng.integers(-127, 128, 2048).astype(np.int8)
    dec, flips = polar.polar_decode(soft, 680)
    assert dec is None and flips == -1


def test_polar_awgn_gain_over_hard():
    """List-32 + CRC must decode at an SNR where hard decisions alone are hopeless."""
    rng = np.random.default_rng(15)
    msg = bytes(rng.integers(0, 256, 85, dtype=np.uint8))
    code = polar.polar_encode(msg, 680).astype(np.float64)
    snr_db = 2.0                        # measured envelope: 6/6 at 2 dB Es/N0
    sigma = 10 ** (-snr_db / 20)
    rx = code + sigma * rng.standard_normal(2048)
    n_hard_errors = int(((rx < 0) != (code < 0)).sum())
    assert n_hard_errors > 50           # channel genuinely flips many bits
    soft = np.clip(rx * 32, -127, 127).astype(np.int8)
    dec, flips = polar.polar_decode(soft, 680)
    assert dec == msg
    assert flips > 0                    # decoder really corrected channel errors


def test_modem_receiver_multi_burst_exact_once():
    """Interrogation standard: 5 noisy audio bursts with varying gaps decode
    exactly once each, in time order, through the ModemReceiver block — one
    rx() per work() call used to drop every burst but one in a big chunk."""
    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import VectorSource
    from futuresdr_tpu_torch.models.rattlegram.modem import Modem, ModemReceiver

    m = Modem(payload_size=32)
    rng = np.random.default_rng(8)
    parts, sent = [], []
    for i in range(5):
        payload = f"rattle {i}".encode()
        sent.append(payload)
        parts += [np.zeros(2000 + 311 * i, np.float32), m.tx(payload)]
    parts.append(np.zeros(2500, np.float32))
    sig = np.concatenate(parts).astype(np.float32)
    sig = (sig + 0.01 * rng.standard_normal(len(sig))).astype(np.float32)
    fg = Flowgraph()
    fg.connect_stream(VectorSource(sig), "out",
                      (rx := ModemReceiver(payload_size=32)), "in")
    Runtime().run(fg)
    assert rx.frames == sent, rx.frames


def test_modem_receiver_delivers_retransmissions():
    """Identical payload sent three times must arrive three times — dedup is by
    burst POSITION (tail-overlap re-decodes), not payload content."""
    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import VectorSource
    from futuresdr_tpu_torch.models.rattlegram.modem import Modem, ModemReceiver

    m = Modem(payload_size=32)
    rng = np.random.default_rng(8)
    sig = np.concatenate([np.zeros(2000, np.float32), m.tx(b"same"),
                          np.zeros(3000, np.float32), m.tx(b"same"),
                          np.zeros(3000, np.float32), m.tx(b"same"),
                          np.zeros(2000, np.float32)]).astype(np.float32)
    sig = (sig + 0.01 * rng.standard_normal(len(sig))).astype(np.float32)
    fg = Flowgraph()
    fg.connect_stream(VectorSource(sig), "out",
                      (rx := ModemReceiver(payload_size=32)), "in")
    Runtime().run(fg)
    assert rx.frames == [b"same"] * 3, rx.frames


def test_corrupted_burst_does_not_eat_neighbors():
    """A CRC-failing burst in the middle of a train must not claim samples past
    its own correlation lobe — both neighbors still decode."""
    from futuresdr_tpu_torch.models.rattlegram.modem import Modem, demodulate_all

    m = Modem(payload_size=32)
    rng = np.random.default_rng(9)
    b0, b1, b2 = m.tx(b"first"), m.tx(b"corrupt-me"), m.tx(b"third")
    mid = b1.copy()
    mid[len(mid) // 3:] += 0.8 * rng.standard_normal(
        len(mid) - len(mid) // 3).astype(np.float32)
    sig = np.concatenate([np.zeros(1500, np.float32), b0,
                          np.zeros(1500, np.float32), mid,
                          np.zeros(1500, np.float32), b2,
                          np.zeros(1500, np.float32)]).astype(np.float32)
    got = [p.rstrip(b"\x00") for _, p in demodulate_all(sig, 32)]
    assert b"first" in got and b"third" in got, got


# ---- the modem ----


def test_mls_properties():
    seq = mls()                      # length 63
    assert len(seq) == 63
    pm = seq.astype(np.int8) * 2 - 1
    # ML sequences: near-perfect cyclic autocorrelation
    for lag in range(1, 63):
        assert abs(np.sum(pm * np.roll(pm, lag))) <= 1


def test_modem_clean_roundtrip():
    m = Modem(payload_size=64)
    audio = m.tx(b"rattle the speaker with data")
    got = m.rx(np.concatenate([np.zeros(1234, np.float32), audio,
                               np.zeros(500, np.float32)]))
    assert got == b"rattle the speaker with data"


def test_modem_noise_and_scale():
    rng = np.random.default_rng(0)
    m = Modem(payload_size=48)
    audio = 0.3 * m.tx(b"quiet but still decodable")
    audio = np.concatenate([np.zeros(777, np.float32), audio, np.zeros(100, np.float32)])
    audio = (audio + 0.01 * rng.standard_normal(len(audio))).astype(np.float32)
    assert m.rx(audio) == b"quiet but still decodable"


def test_modem_flowgraph_loopback():
    from futuresdr_tpu_torch import Flowgraph, Runtime, Pmt
    from futuresdr_tpu_torch.blocks import Apply
    from futuresdr_tpu_torch.models.rattlegram import ModemTransmitter, ModemReceiver

    rng = np.random.default_rng(3)
    fg = Flowgraph()
    tx = ModemTransmitter(payload_size=48)
    chan = Apply(lambda x: (0.5 * x + 0.01 * rng.standard_normal(len(x))
                            ).astype(np.float32), np.float32)
    rx = ModemReceiver(payload_size=48)
    fg.connect(tx, chan, rx)
    payloads = [f"acoustic packet {i}".encode() for i in range(3)]
    rt = Runtime()
    running = rt.start(fg)
    for p in payloads:
        rt.scheduler.run_coro_sync(running.handle.call(tx, "tx", Pmt.blob(p)))
    rt.scheduler.run_coro_sync(running.handle.call(tx, "tx", Pmt.finished()))
    running.wait_sync()
    assert rx.frames == payloads


def test_modem_rejects_garbage():
    m = Modem(payload_size=32)
    rng = np.random.default_rng(1)
    assert m.rx(rng.standard_normal(16000).astype(np.float32)) is None


def test_polar_fec_all_modes_loopback():
    """ModemParams(fec="polar") — the reference's actual pipeline (xorshift
    scramble → systematic polar with CRC32-aided SCL-32, `encoder.rs:162-180`)
    — loops back at every operation mode's payload capacity."""
    from futuresdr_tpu_torch.models.rattlegram import Modem, ModemParams
    rng = np.random.default_rng(0)
    for size in (85, 128, 170):                    # Mode16 / Mode15 / Mode14
        m = Modem(payload_size=size, params=ModemParams(fec="polar"))
        payload = (((np.arange(size) * 7 + 3) % 251).astype(np.uint8) + 1).tobytes()
        audio = m.tx(payload)
        x = np.concatenate([np.zeros(500, np.float32), audio,
                            np.zeros(500, np.float32)])
        x = (x + 0.02 * rng.standard_normal(len(x))).astype(np.float32)
        assert m.rx(x) == payload, size


def test_polar_fec_outdecodes_conv():
    """At noise where the K=7 conv path collapses, SCL-32 + CRC arbitration
    still decodes — the reason the reference ships polar."""
    from futuresdr_tpu_torch.models.rattlegram import Modem, ModemParams
    payload = b"polar fec over the audio modem!"
    wins = {"conv": 0, "polar": 0}
    for fec in wins:
        m = Modem(payload_size=85, params=ModemParams(fec=fec))
        for t in range(6):
            r2 = np.random.default_rng(100 + t)
            audio = m.tx(payload)
            x = np.concatenate([np.zeros(300, np.float32), audio,
                                np.zeros(300, np.float32)])
            x = (x + 0.1 * r2.standard_normal(len(x))).astype(np.float32)
            wins[fec] += m.rx(x) == payload
    assert wins["polar"] >= 5, wins
    assert wins["polar"] > wins["conv"], wins


def test_polar_fec_config_validation():
    """Config errors surface at build time: unknown fec names and payload sizes
    beyond the largest operation mode are rejected immediately."""
    from futuresdr_tpu_torch.models.rattlegram import Modem, ModemParams
    with pytest.raises(ValueError, match="fec"):
        ModemParams(fec="Polar")
    with pytest.raises(ValueError, match="170"):
        Modem(payload_size=200, params=ModemParams(fec="polar"))
    Modem(payload_size=200)                        # conv: any size is fine


def test_in_band_metadata_auto_rx():
    """In-band metadata (`encoder.rs:144-145` meta_data role): BPSK BCH(255,71)
    symbols carry callsign + operation mode, so the receiver sizes the polar
    decode from the air — no a-priori payload size."""
    from futuresdr_tpu_torch.models.rattlegram import Modem, ModemParams
    from futuresdr_tpu_torch.models.rattlegram.modem import (demodulate_auto, _base37,
                                                       _base37_str)
    for cs in ("N0CALL", "SP5WWP", "X", "DF9XYZ 1"):
        assert _base37_str(_base37(cs)) == cs.upper().rstrip()

    rng = np.random.default_rng(1)
    p = ModemParams(fec="polar")
    for size, pl in ((85, b"small"), (128, b"medium sized payload"),
                     (170, b"large payload rides mode 14")):
        m = Modem(payload_size=size, params=p, callsign="DF9XYZ")
        x = np.concatenate([np.zeros(300, np.float32), m.tx(pl),
                            np.zeros(300, np.float32)])
        x = (x + 0.05 * rng.standard_normal(len(x))).astype(np.float32)
        cs, got = demodulate_auto(x, p)      # NB: no size passed anywhere
        assert cs == "DF9XYZ" and got.rstrip(b"\x00") == pl, (size, cs)
        assert m.rx_auto(x) == ("DF9XYZ", pl)

    # config guards: metadata requires the polar pipeline (mode field)
    with pytest.raises(ValueError, match="polar"):
        Modem(payload_size=85, callsign="N0CALL")
    with pytest.raises(ValueError, match="polar"):
        demodulate_auto(np.zeros(4096, np.float32), ModemParams())
    # erasing HALF the metadata symbols still decodes — BCH(255,71) designed
    # distance 47 + OSD handles erasures; that robustness is the point
    m = Modem(payload_size=85, params=p, callsign="N0CALL")
    audio = m.tx(b"x")
    erased = audio.copy()
    erased[m.params.sym_len:3 * m.params.sym_len] = 0.0
    assert demodulate_auto(erased, p) is not None
    # but confidently-random metadata must fail the CRC16 gate, not pass garbage
    garbled = audio.copy()
    sl = m.params.sym_len
    garbled[sl:5 * sl] = 0.5 * rng.standard_normal(4 * sl).astype(np.float32)
    assert demodulate_auto(garbled, p) is None


def test_metadata_modem_fixed_rx_paths_still_work():
    """A callsign-equipped Modem's rx()/rx_all() skip the metadata symbols, so
    the fixed-size paths decode their own tx() too; callsign input validation
    rejects non-base37 characters and overlong signs."""
    from futuresdr_tpu_torch.models.rattlegram import Modem, ModemParams
    from futuresdr_tpu_torch.models.rattlegram.modem import _base37
    m = Modem(payload_size=85, params=ModemParams(fec="polar"), callsign="N0CALL")
    rng = np.random.default_rng(5)
    parts = [np.zeros(200, np.float32)]
    for pl in (b"first", b"second"):
        parts += [m.tx(pl), np.zeros(300, np.float32)]
    x = np.concatenate(parts)
    x = (x + 0.04 * rng.standard_normal(len(x))).astype(np.float32)
    # rx() decodes the strongest single burst; rx_all() returns both in order
    assert m.rx(x[:200 + m.burst_samples() + 200]) == b"first"
    assert [pl for _, pl in m.rx_all(x)] == [b"first", b"second"]

    with pytest.raises(ValueError, match="base-37|9 char"):
        _base37("LONGCALL10")
    with pytest.raises(ValueError, match="base-37"):
        _base37("٥")                       # non-ASCII digit must not pass


def test_auto_receiver_block_mixed_modes():
    """ModemReceiver(auto=True): one receiver block decodes senders of
    DIFFERENT operation modes from the stream, posting (callsign, payload)."""
    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import VectorSource
    from futuresdr_tpu_torch.models.rattlegram import (Modem, ModemParams,
                                                 ModemReceiver)
    rng = np.random.default_rng(9)
    p = ModemParams(fec="polar")
    small = Modem(payload_size=85, params=p, callsign="N0CALL")
    large = Modem(payload_size=170, params=p, callsign="SP5WWP")
    parts = [np.zeros(400, np.float32)]
    for m, pl in ((small, b"small mode burst"), (large, b"large mode burst"),
                  (small, b"small again")):
        parts += [m.tx(pl), np.zeros(500, np.float32)]
    x = np.concatenate(parts)
    x = (x + 0.04 * rng.standard_normal(len(x))).astype(np.float32)

    rx = ModemReceiver(params=p, auto=True)
    fg = Flowgraph()
    fg.connect_stream(VectorSource(x), "out", rx, "in")
    Runtime().run(fg)
    assert rx.frames == [("N0CALL", b"small mode burst"),
                         ("SP5WWP", b"large mode burst"),
                         ("N0CALL", b"small again")], rx.frames

    with pytest.raises(ValueError, match="polar"):
        ModemReceiver(auto=True)                  # conv params: rejected


def test_noise_symbol_prefix():
    """noise_symbols prepends squelch/AGC-opening symbols (`encoder.rs:308`)
    of comparable power that do not disturb sync or decoding."""
    from futuresdr_tpu_torch.models.rattlegram.modem import (ModemParams, demodulate,
                                                       modulate)
    p = ModemParams()
    payload = b"squelch opener".ljust(32, b"\x00")
    plain = modulate(payload, p)
    noisy = modulate(payload, p, noise_symbols=5)
    assert len(noisy) == len(plain) + 5 * p.sym_len
    pw_prefix = float(np.mean(noisy[:5 * p.sym_len] ** 2))
    pw_data = float(np.mean(plain ** 2))
    assert 0.3 * pw_data < pw_prefix < 3 * pw_data
    x = np.concatenate([np.zeros(400, np.float32), noisy,
                        np.zeros(200, np.float32)]).astype(np.float32)
    assert demodulate(x, 32, p) == payload


def test_random_config_roundtrip_fuzz():
    """Seeded sweep over random modem configs (fec, payload size/content,
    metadata, noise prefix): every combination loops back under mild noise."""
    from futuresdr_tpu_torch.models.rattlegram import Modem, ModemParams
    rng = np.random.default_rng(4096)
    for trial in range(12):
        fec = ("conv", "polar")[int(rng.integers(0, 2))]
        size = int(rng.integers(1, 171)) if fec == "polar" else int(rng.integers(1, 200))
        callsign = ("N0CALL" if fec == "polar" and rng.integers(0, 2) else None)
        m = Modem(payload_size=size, params=ModemParams(fec=fec), callsign=callsign)
        n_pay = int(rng.integers(1, size + 1))
        payload = (rng.integers(1, 256, n_pay).astype(np.uint8)).tobytes()
        audio = m.tx(payload)
        x = np.concatenate([np.zeros(int(rng.integers(50, 900)), np.float32),
                            audio, np.zeros(200, np.float32)])
        x = (x + 0.02 * rng.standard_normal(len(x))).astype(np.float32)
        if callsign:
            r = m.rx_auto(x)
            assert r is not None and r == (callsign, payload), (trial, fec, size)
        else:
            assert m.rx(x) == payload, (trial, fec, size, n_pay)


# ---- the port against the JAX package, bit for bit ----

def test_fec_equals_the_jax_package():
    """BCH generator polynomial, matrices and parity, the CRCs, MLS, xorshift
    and the OSD of noisy codewords on seeded inputs."""
    assert np.array_equal(fec.bch_genpoly(), jfec.bch_genpoly())
    for sys_ in (True, False):
        assert np.array_equal(fec.bch_generator_matrix(sys_), jfec.bch_generator_matrix(sys_))
    rng = np.random.default_rng(255)
    for _ in range(8):
        data = rng.integers(0, 2, fec.BCH_K).astype(np.uint8)
        assert np.array_equal(fec.bch_parity(data), jfec.bch_parity(data))
        b = rng.integers(0, 256, int(rng.integers(0, 64)), dtype=np.uint8).tobytes()
        assert fec.crc16_rattlegram(b) == jfec.crc16_rattlegram(b)
        assert fec.crc32_rattlegram(b) == jfec.crc32_rattlegram(b)
    for poly, n in ((0b10001001, 127), (0b100101011, 255)):
        assert np.array_equal(fec.mls_bits(poly, n), jfec.mls_bits(poly, n))
    assert np.array_equal(fec.Xorshift32().bytes(100), jfec.Xorshift32().bytes(100))
    gen = fec.bch_generator_matrix()
    for flips in (0, 8, 24):
        cw = gen[0] ^ gen[3]
        soft = np.where(cw > 0, -64, 64).astype(np.int8)
        idx = rng.choice(fec.BCH_N, flips, replace=False)
        soft[idx] = -np.sign(soft[idx]) * rng.integers(1, 30, flips)
        got, ok = fec.osd_decode(soft, gen)
        want, jok = jfec.osd_decode(soft, jfec.bch_generator_matrix())
        assert ok == jok and np.array_equal(got, want)


@pytest.mark.parametrize("data_bits", [680, 1024, 1360])
def test_polar_equals_the_jax_package(data_bits):
    """The systematic polar codeword bit for bit, and the list decoder's
    message and flip count on the same noisy int8 soft bits."""
    rng = np.random.default_rng(data_bits)
    msg = rng.integers(0, 256, data_bits // 8, dtype=np.uint8).tobytes()
    cw = polar.polar_encode(msg, data_bits)
    assert np.array_equal(cw, jpolar.polar_encode(msg, data_bits))
    rx = cw + 10 ** (-4.0 / 20) * rng.standard_normal(len(cw))     # Es/N0 4 dB
    soft = np.clip(rx * 32, -127, 127).astype(np.int8)
    got = polar.polar_decode(soft, data_bits)
    assert got == jpolar.polar_decode(soft, data_bits) and got[0] == msg and got[1] > 0


@pytest.mark.parametrize("fec_name,size,callsign", [("conv", 48, None), ("polar", 85, None),
                                                    ("polar", 170, "N0CALL")])
def test_modem_equals_the_jax_package(fec_name, size, callsign):
    """The audio burst (sync, metadata, payload symbols, noise prefix) bit
    for bit, and over a noisy, gained channel the same bursts, payloads and
    metadata from both packages' demodulators."""
    rng = np.random.default_rng(size)
    p, jp = ModemParams(fec=fec_name), jmodem.ModemParams(fec=fec_name)
    payload = rng.integers(1, 256, size - 3, dtype=np.uint8).tobytes()
    m = Modem(size, p, callsign=callsign)
    jm = jmodem.Modem(size, jp, callsign=callsign)
    audio, want = m.tx(payload), jm.tx(payload)
    assert audio.dtype == want.dtype == np.float32
    assert np.array_equal(audio.view(np.uint32), want.view(np.uint32))
    noisy = modulate(payload.ljust(size, b"\0"), p, callsign=callsign, noise_symbols=2)
    assert np.array_equal(noisy.view(np.uint32),
                          jmodem.modulate(payload.ljust(size, b"\0"), jp, callsign=callsign,
                                          noise_symbols=2).view(np.uint32))
    x = np.concatenate([np.zeros(700, np.float32), audio, np.zeros(900, np.float32), audio,
                        np.zeros(300, np.float32)])
    x = (0.4 * x + 0.03 * rng.standard_normal(len(x))).astype(np.float32)
    got = m.rx_all(x)
    assert got == jm.rx_all(x) and [pl for _, pl in got] == [payload] * 2
    if callsign:
        assert modem.demodulate_all_auto(x, p) == jmodem.demodulate_all_auto(x, jp)
        assert m.rx_auto(x) == jm.rx_auto(x) == (callsign, payload)
    else:
        assert demodulate(x, size, p) == jmodem.demodulate(x, size, jp)


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


def _cut(x, lo, hi, seed):
    cuts = np.random.default_rng(seed)
    pieces, pos = [], 0
    while pos < len(x):
        c = int(cuts.integers(lo, hi))
        pieces.append(x[pos:pos + c])
        pos += c
    return pieces


@pytest.mark.parametrize("seed", [0, 1])
def test_receiver_decodes_each_frame_once_however_the_stream_is_cut(seed):
    """Five bursts at the loopback app's width (48-byte payloads, the
    transmitter's 2,000-sample gap, half the gain, noise 0.01), one payload
    sent twice, cut into seeded stretches of 4 to 16 symbols (the receiver
    takes 4 at least): the port's receiver posts every burst once, in order,
    and so does the reference's."""
    rng = np.random.default_rng(seed)
    m = Modem(48)
    sent = [f"over-the-air text {i}".encode() for i in range(4)]
    sent.insert(2, sent[1])
    x = np.concatenate([np.concatenate([m.tx(pl), np.zeros(2000, np.float32)])
                        for pl in sent])
    x = (0.5 * x + 0.01 * rng.standard_normal(len(x))).astype(np.float32)
    sym = m.params.sym_len
    pieces = _cut(x, 4 * sym, 16 * sym, seed + 100)
    assert len(pieces) >= 5
    rx, posts = _drive(ModemReceiver(48), pieces)
    assert rx.frames == sent and [p.to_blob() for p in posts] == sent
    ref, _ = _drive(jrg.ModemReceiver(48), pieces)
    assert ref.frames == sent


def test_auto_receiver_decodes_each_frame_once_however_the_stream_is_cut():
    """``ModemReceiver(auto=True)`` over seeded cuts of senders of two
    operation modes: each (callsign, payload) once, in order."""
    rng = np.random.default_rng(7)
    p = ModemParams(fec="polar")
    small = Modem(85, p, callsign="N0CALL")
    large = Modem(170, p, callsign="SP5WWP")
    sent = [(small, b"small one"), (large, b"large one"), (small, b"small two")]
    x = np.concatenate([np.concatenate([m.tx(pl), np.zeros(1500, np.float32)])
                        for m, pl in sent])
    x = (x + 0.03 * rng.standard_normal(len(x))).astype(np.float32)
    pieces = _cut(x, 4 * p.sym_len, 16 * p.sym_len, 107)
    rx, _ = _drive(ModemReceiver(params=p, auto=True), pieces)
    assert rx.frames == [(m.callsign, pl) for m, pl in sent]


# ---- the apps ----

def _main(app, *args):
    return subprocess.run([sys.executable, "-m", f"futuresdr_tpu_torch.apps.{app}", *args],
                          cwd=REPO, capture_output=True, text=True, timeout=300)


def test_rattlegram_loopback_app_main():
    """``apps/rattlegram_loopback.py``'s ``main()`` as ``tests/test_examples.py``
    runs the reference's (``--messages 1 --payload-size 32``): exit 0."""
    res = _main("rattlegram_loopback", "--messages", "1", "--payload-size", "32")
    assert res.returncode == 0, res.stdout + res.stderr
    assert "decoded 1/1 payloads" in res.stdout


@pytest.mark.parametrize("args,line", [
    (["hello"], "decoded: b'hello'"),
    (["metadata in band", "--callsign", "N0CALL"], "decoded from N0CALL: b'metadata in band'")])
def test_modem_ota_app_main(args, line):
    """``apps/modem_ota.py``'s ``main()`` with the arguments
    ``tests/test_examples.py`` gives the reference's: the message decoded,
    with and without the callsign metadata, exit 0."""
    res = _main("modem_ota", *args)
    assert res.returncode == 0, res.stdout + res.stderr
    assert line in res.stdout


def test_rattlegram_apps_run():
    """``run()`` of both apps at their defaults: every loopback payload, and
    the over-the-air message with and without the metadata."""
    from futuresdr_tpu_torch.apps import modem_ota, rattlegram_loopback
    sent, got, seconds = rattlegram_loopback.run()
    assert got == sent and len(sent) == 3 and seconds > 0
    n, cs, payload = modem_ota.run()
    assert cs is None and payload == b"hello through the speaker" and n > 0
    assert modem_ota.run(callsign="N0CALL")[1:] == ("N0CALL", b"hello through the speaker")
