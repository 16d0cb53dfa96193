"""The port's M17 (``futuresdr_tpu_torch/models/m17``) on the CPU: the cases
of ``tests/test_m17.py`` on the port's copy and runtime; the codecs, frame
builders and modulator against the JAX package's bit for bit and the
demodulators' results equal; ``viterbi_decode_m17``'s long frames on the
device decoder (raising with no card where ``device`` is None, equal to the
JAX decoder and the numpy trellis on ``device="cpu"``); the receiver over
seeded cuts of the stream (where the port departs from the reference); and
the loopback app's ``main()``.
"""

import asyncio
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from futuresdr_tpu.models.m17 import blocks as jblocks
from futuresdr_tpu.models.m17 import codec as jcodec
from futuresdr_tpu.models.m17 import phy as jphy
from futuresdr_tpu_torch.models.m17 import (encode_callsign, decode_callsign, crc16_m17,
                                            golay24_encode, golay24_decode, conv_encode_m17,
                                            viterbi_decode_m17, Lsf, build_lsf_frame,
                                            modulate, demodulate_stream)
from futuresdr_tpu_torch.models.m17 import blocks, codec, phy

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def test_callsign_roundtrip():
    for cs in ["W2FBI", "SP5WWP", "N0CALL", "AB1CDE-9"]:
        assert decode_callsign(encode_callsign(cs)) == cs
    assert decode_callsign(encode_callsign("@ALL")) == "@ALL"


def test_crc16_m17_known_vectors():
    # vectors from the M17 spec §2.5.4
    assert crc16_m17(b"") == 0xFFFF
    assert crc16_m17(b"A") == 0x206E
    assert crc16_m17(b"123456789") == 0x772B


def test_golay_roundtrip_and_correction():
    rng = np.random.default_rng(0)
    for d in [0x000, 0xFFF, 0xABC, 0x123]:
        w = golay24_encode(d)
        assert golay24_decode(w) == d
        # up to 3 errors in the 23-bit part are corrected
        for n_err in (1, 2, 3):
            pos = rng.choice(23, n_err, replace=False)
            bad = w
            for p in pos:
                bad ^= 1 << (p + 1)
            assert golay24_decode(bad) == d


def test_conv_viterbi_m17():
    rng = np.random.default_rng(1)
    bits = np.concatenate([rng.integers(0, 2, 240), np.zeros(4)]).astype(np.uint8)
    coded = conv_encode_m17(bits)
    llrs = coded.astype(np.float64) * 2 - 1
    flip = rng.choice(len(llrs), 20, replace=False)
    llrs[flip] *= -1
    dec = viterbi_decode_m17(llrs, len(bits))
    np.testing.assert_array_equal(dec, bits)


def test_lsf_roundtrip():
    lsf = Lsf(dst="@ALL", src="SP5WWP", type_field=0x0005, meta=b"hello meta din")
    raw = lsf.to_bytes()
    assert len(raw) == 30
    back = Lsf.from_bytes(raw)
    assert back.dst == "@ALL" and back.src == "SP5WWP"
    assert back.type_field == 0x0005
    bad = bytearray(raw)
    bad[3] ^= 0xFF
    assert Lsf.from_bytes(bytes(bad)) is None


def test_4fsk_lsf_loopback():
    lsf = Lsf(dst="N0CALL", src="W2FBI")
    syms = build_lsf_frame(lsf)
    sig = modulate(syms)
    sig = np.concatenate([np.zeros(173, np.float32), sig, np.zeros(200, np.float32)])
    found = demodulate_stream(sig)
    assert len(found) == 1
    assert found[0].dst == "N0CALL" and found[0].src == "W2FBI"


def test_m17_flowgraph_loopback():
    import numpy as _np
    from futuresdr_tpu_torch import Flowgraph, Runtime, Pmt
    from futuresdr_tpu_torch.blocks import Apply
    from futuresdr_tpu_torch.models.m17 import M17Transmitter, M17Receiver

    rng = _np.random.default_rng(4)
    fg = Flowgraph()
    tx = M17Transmitter()
    chan = Apply(lambda x: (x + 0.05 * rng.standard_normal(len(x))
                            ).astype(_np.float32), _np.float32)
    rx = M17Receiver()
    fg.connect(tx, chan, rx)
    rt = Runtime()
    running = rt.start(fg)
    msgs = [{"dst": "@ALL", "src": "W2FBI", "meta": Pmt.blob(b"beacon 1 meta!")},
            {"dst": "N0CALL", "src": "SP5WWP", "meta": Pmt.blob(b"second beacon.")}]
    for m in msgs:
        r = rt.scheduler.run_coro_sync(running.handle.call(tx, "tx", Pmt.map(m)))
        assert r == Pmt.ok()
    rt.scheduler.run_coro_sync(running.handle.call(tx, "tx", Pmt.finished()))
    running.wait_sync()
    assert [(f.dst, f.src) for f in rx.frames] == [("@ALL", "W2FBI"),
                                                   ("N0CALL", "SP5WWP")]


def test_4fsk_loopback_noise():
    rng = np.random.default_rng(2)
    lsf = Lsf(dst="AB1CDE", src="SP5WWP")
    sig = modulate(build_lsf_frame(lsf))
    sig = sig + 0.1 * rng.standard_normal(len(sig)).astype(np.float32)
    found = demodulate_stream(sig)
    assert len(found) == 1 and found[0].src == "SP5WWP"


def test_stream_returns_frames_in_time_order():
    """Interrogation standard: 8 noisy bursts decode exactly once each, IN TIME
    ORDER — the per-phase sync search used to return them phase-major."""
    rng = np.random.default_rng(4)
    parts, sent = [], []
    for i in range(8):
        lsf = Lsf(src=f"N{i}CALL", dst="ALLCALL")
        sent.append(lsf.src)
        parts += [np.zeros(500 + 53 * i, np.float32),
                  modulate(build_lsf_frame(lsf)).astype(np.float32)]
    parts.append(np.zeros(600, np.float32))
    sig = np.concatenate(parts)
    sig = (sig + 0.08 * rng.standard_normal(len(sig))).astype(np.float32)
    got = [l.src for l in demodulate_stream(sig)]
    assert got == sent, got


def test_stream_mode_loopback():
    """Stream mode (`encoder.rs:226-289`): LSF + LICH-chunked payload frames
    with P2-punctured conv coding and EOS; two noisy transmissions decode
    exactly once each, in time order."""
    from futuresdr_tpu_torch.models.m17 import (Lsf, build_stream_frames, modulate,
                                          demodulate_payload_stream)
    rng = np.random.default_rng(4)
    lsf = Lsf(dst="SP5WWP", src="N0CALL")
    pl_a = b"M17 stream mode carries voice or data frames end to end!"
    pl_b = b"second transmission"
    parts = [np.zeros(400, np.float32)]
    for pl in (pl_a, pl_b):
        parts += [modulate(build_stream_frames(lsf, pl)).astype(np.float32),
                  np.zeros(700, np.float32)]
    x = np.concatenate(parts)
    x = (x + 0.08 * rng.standard_normal(len(x))).astype(np.float32)
    out = demodulate_payload_stream(x)
    assert len(out) == 2, len(out)
    for (l, p, complete), pl in zip(out, (pl_a, pl_b)):
        assert complete
        assert l is not None and l.src == "N0CALL" and l.dst == "SP5WWP"
        assert p[:len(pl)] == pl and len(p) % 16 == 0


def test_stream_mode_lsf_from_lich():
    """With the link-setup frame unusable (mid-LSF cut), the LSF reassembles
    from the six cycling Golay-protected LICH chunks, CRC-checked."""
    from futuresdr_tpu_torch.models.m17 import (Lsf, build_stream_frames, modulate,
                                          demodulate_payload_stream)
    rng = np.random.default_rng(5)
    lsf = Lsf(dst="SP5WWP", src="N0CALL")
    payload = bytes(range(112))                  # 7 frames: full LICH cycle
    sig = modulate(build_stream_frames(lsf, payload))
    x = np.concatenate([np.zeros(300, np.float32), sig.astype(np.float32),
                        np.zeros(300, np.float32)])
    x = (x + 0.06 * rng.standard_normal(len(x))).astype(np.float32)
    out = demodulate_payload_stream(x[300 + 1000:])
    assert len(out) == 1
    l, p, complete = out[0]
    assert complete and p[:len(payload)] == payload
    assert l is not None and l.src == "N0CALL" and l.dst == "SP5WWP"


def test_stream_mode_through_blocks():
    """Transmitter tx message with a payload blob → stream-mode frames →
    receiver posts the transmission with dst/src/payload."""
    from futuresdr_tpu_torch import Flowgraph, Runtime, Pmt
    from futuresdr_tpu_torch.blocks import Apply
    from futuresdr_tpu_torch.models.m17 import M17Receiver, M17Transmitter

    rng = np.random.default_rng(6)
    tx = M17Transmitter(src_callsign="N0CALL")
    chan = Apply(lambda v: (v + 0.05 * rng.standard_normal(len(v))
                            ).astype(np.float32), np.float32)
    rx = M17Receiver()
    fg = Flowgraph()
    fg.connect(tx, chan, rx)
    rt = Runtime()
    running = rt.start(fg)
    payload = b"hello from the stream path"
    rt.scheduler.run_coro_sync(running.handle.call(
        tx, "tx", Pmt.map({"dst": "@ALL", "payload": Pmt.blob(payload)})))
    rt.scheduler.run_coro_sync(running.handle.call(tx, "tx", Pmt.finished()))
    running.wait_sync()
    assert len(rx.transmissions) == 1, rx.transmissions
    l, p = rx.transmissions[0]
    assert l is not None and l.src == "N0CALL" and l.dst == "@ALL"
    assert p[:len(payload)] == payload


def test_stream_mode_rejects_truncated_group():
    """A window catching only the TAIL of a transmission (fn 2..) must not
    report a complete — and therefore silently corrupted — payload."""
    from futuresdr_tpu_torch.models.m17 import (Lsf, build_stream_frames, modulate,
                                          demodulate_payload_stream)
    lsf = Lsf(dst="SP5WWP", src="N0CALL")
    payload = bytes(range(64))                    # 4 frames
    sig = modulate(build_stream_frames(lsf, payload)).astype(np.float32)
    n_lsf = (8 + 184) * 10
    n_frame = (8 + 48 + 136) * 10
    # cut into frame 1: only fn 2,3 (incl. EOS) remain decodable
    x = sig[n_lsf + n_frame + n_frame // 2:]
    out = demodulate_payload_stream(np.concatenate([x, np.zeros(200, np.float32)]))
    assert all(not complete for _, _, complete in out), out


def test_random_stream_roundtrip_fuzz():
    """Seeded sweep over random M17 stream transmissions (payload length 1..96,
    random callsigns): exact loopback through the sample-domain receiver."""
    from futuresdr_tpu_torch.models.m17 import (Lsf, build_stream_frames, modulate,
                                          demodulate_payload_stream)
    rng = np.random.default_rng(1717)
    alphabet = "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
    for trial in range(8):
        src = "".join(alphabet[int(rng.integers(0, 36))] for _ in range(6))
        dst = "".join(alphabet[int(rng.integers(0, 36))] for _ in range(6))
        n_pay = int(rng.integers(1, 97))
        payload = rng.integers(0, 256, n_pay).astype(np.uint8).tobytes()
        lsf = Lsf(dst=dst, src=src)
        sig = modulate(build_stream_frames(lsf, payload)).astype(np.float32)
        x = np.concatenate([np.zeros(int(rng.integers(100, 800)), np.float32),
                            sig, np.zeros(300, np.float32)])
        x = (x + 0.05 * rng.standard_normal(len(x))).astype(np.float32)
        out = demodulate_payload_stream(x)
        assert len(out) == 1, (trial, len(out))
        l, p, complete = out[0]
        assert complete and l is not None and (l.src, l.dst) == (src, dst), trial
        assert p[:n_pay] == payload, trial


def test_stream_frame_ghost_inside_lsf_rejected():
    """Regression (r4 fuzz campaign): the LSF frame body can correlate > 0.9
    against the STREAM sync and pass the un-CRC'd Golay gate, injecting a ghost
    frame whose fn breaks contiguity (clean signal, (SQ8485->RHHIUD, 44 B)).
    Stream hits starting inside a decoded LSF span must be rejected."""
    from futuresdr_tpu_torch.models.m17 import (Lsf, build_stream_frames, modulate,
                                          demodulate_payload_stream)
    lsf = Lsf(dst="RHHIUD", src="SQ8485")
    payload = bytes(range(44))
    sig = modulate(build_stream_frames(lsf, payload)).astype(np.float32)
    for pad in (0, 784):
        x = np.concatenate([np.zeros(pad, np.float32), sig,
                            np.zeros(300, np.float32)])
        out = demodulate_payload_stream(x)
        assert len(out) == 1
        l, p, complete = out[0]
        assert complete and (l.src, l.dst) == ("SQ8485", "RHHIUD")
        assert p[:44] == payload


def test_misframed_ghost_does_not_suppress_eos_frame():
    """Regression (r5 fuzz campaign, offset 62682 trial 7): a misframed hit
    330 samples before the final frame correlated at saturation against the
    stream sync, passed the Golay gate, and decoded a mostly-consistent
    (shifted) codeword — under this exact noise draw it out-ranked the true
    EOS frame in the NMS and suppressed it, so the transmission never
    completed. Hits are now ranked by re-encode codeword agreement first
    (the true frame is exact; a shifted window never is)."""
    from futuresdr_tpu_torch.models.m17 import (Lsf, build_stream_frames, modulate,
                                          demodulate_payload_stream)
    rng = np.random.default_rng(1717 + 62682)
    alphabet = "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
    cfg = None
    for trial in range(8):
        src = "".join(alphabet[int(rng.integers(0, 36))] for _ in range(6))
        dst = "".join(alphabet[int(rng.integers(0, 36))] for _ in range(6))
        n_pay = int(rng.integers(1, 97))
        payload = rng.integers(0, 256, n_pay).astype(np.uint8).tobytes()
        sig = modulate(build_stream_frames(Lsf(dst=dst, src=src), payload)) \
            .astype(np.float32)
        pad = int(rng.integers(100, 800))
        x = np.concatenate([np.zeros(pad, np.float32), sig,
                            np.zeros(300, np.float32)])
        noise = 0.05 * rng.standard_normal(len(x))
        if trial == 7:
            cfg = (src, dst, n_pay, payload, (x + noise).astype(np.float32))
    src, dst, n_pay, payload, x = cfg
    out = demodulate_payload_stream(x)
    assert len(out) == 1
    l, p, complete = out[0]
    assert complete and (l.src, l.dst) == (src, dst)
    assert p[:n_pay] == payload


def test_chance_crc_ghost_lsf_cannot_suppress_stream_frames():
    """Regression (r5 fuzz campaign, offset 166156 — the practice's eighth
    finding): a stream-frame body decoded as a CRC16-VALID ghost LSF with
    garbage callsigns (one random decode in ~65k passes CRC by chance at
    campaign scale), and the LSF-interior guard then rejected the REAL frame
    fn=2 inside the ghost's span — an incomplete payload from a clean
    transmission. LSF candidates are now gated by re-encode codeword
    agreement (true ≥0.95, misframed chance-CRC ghosts ≤0.91), the same
    plausibility measure the stream-frame path ranks by."""
    from futuresdr_tpu_torch.models.m17 import (Lsf, build_stream_frames, modulate,
                                          demodulate_payload_stream)

    # the exact campaign draw, reproduced via the shifted-seed convention
    rng = np.random.default_rng(1717 + 166156)
    alphabet = "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
    src = "".join(alphabet[int(rng.integers(0, 36))] for _ in range(6))
    dst = "".join(alphabet[int(rng.integers(0, 36))] for _ in range(6))
    n_pay = int(rng.integers(1, 97))
    payload = rng.integers(0, 256, n_pay).astype(np.uint8).tobytes()
    sig = modulate(build_stream_frames(Lsf(dst=dst, src=src),
                                       payload)).astype(np.float32)
    x = np.concatenate([np.zeros(int(rng.integers(100, 800)), np.float32),
                        sig, np.zeros(300, np.float32)])
    x = (x + 0.05 * rng.standard_normal(len(x))).astype(np.float32)
    out = demodulate_payload_stream(x)
    assert len(out) == 1
    lsf, p, complete = out[0]
    assert complete and (lsf.src, lsf.dst) == (src, dst)
    assert p[:n_pay] == payload


# ---- the port against the JAX package, bit for bit ----

_ALPHABET = " ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-/."


def _callsign(rng, n=None):
    n = int(rng.integers(1, 10)) if n is None else n
    return "".join(_ALPHABET[1 + int(rng.integers(0, 39))] for _ in range(n))


def test_codecs_equal_the_jax_package():
    """Callsigns, CRC16, every Golay word (and seeded corruptions of them),
    the convolutional code, both punctures and LICH, on seeded inputs."""
    rng = np.random.default_rng(170)
    for _ in range(50):
        cs = _callsign(rng)
        assert encode_callsign(cs) == jcodec.encode_callsign(cs)
        v = int(rng.integers(0, 40 ** 9))
        assert decode_callsign(v) == jcodec.decode_callsign(v)
        data = rng.integers(0, 256, int(rng.integers(0, 40)), dtype=np.uint8).tobytes()
        assert crc16_m17(data) == jcodec.crc16_m17(data)
    words = [golay24_encode(d) for d in range(4096)]
    assert words == [jcodec.golay24_encode(d) for d in range(4096)]
    for w in rng.choice(words, 64):
        bad = int(w) ^ int(rng.integers(0, 1 << 24))
        assert golay24_decode(bad) == jcodec.golay24_decode(bad)
    bits = rng.integers(0, 2, 1000).astype(np.uint8)
    assert np.array_equal(conv_encode_m17(bits), jcodec.conv_encode_m17(bits))
    coded = conv_encode_m17(bits[:244])
    for p, jp, dp, jdp, n in ((codec.puncture_p1, jcodec.puncture_p1, codec.depuncture_p1,
                               jcodec.depuncture_p1, 488),
                              (codec.puncture_p2, jcodec.puncture_p2, codec.depuncture_p2,
                               jcodec.depuncture_p2, 296)):
        assert np.array_equal(p(coded[:n]), jp(coded[:n]))
        soft = rng.standard_normal(len(p(coded[:n])))
        assert np.array_equal(dp(soft, n), jdp(soft, n))
    lsf = Lsf(dst=_callsign(rng), src=_callsign(rng)).to_bytes()
    for i in range(6):
        lich = codec.lich_encode(lsf, i)
        assert np.array_equal(lich, jcodec.lich_encode(lsf, i))
        noisy = lich ^ (rng.random(96) < 0.02).astype(np.uint8)
        assert codec.lich_decode(noisy) == jcodec.lich_decode(noisy)


@pytest.mark.parametrize("seed", range(3))
def test_frames_and_modulation_equal_the_jax_package(seed):
    """The LSF and stream frames' symbols and the RRC 4FSK baseband, bit for
    bit, for seeded callsigns, meta fields and payloads of 1 to 200 bytes."""
    rng = np.random.default_rng(171 + seed)
    meta = rng.integers(0, 256, 14, dtype=np.uint8).tobytes()
    lsf = Lsf(dst=_callsign(rng), src=_callsign(rng), type_field=int(rng.integers(0, 1 << 16)),
              meta=meta)
    jlsf = jphy.Lsf(dst=lsf.dst, src=lsf.src, type_field=lsf.type_field, meta=meta)
    assert lsf.to_bytes() == jlsf.to_bytes()
    payload = rng.integers(0, 256, int(rng.integers(1, 201)), dtype=np.uint8).tobytes()
    for got, want in ((build_lsf_frame(lsf), jphy.build_lsf_frame(jlsf)),
                      (phy.build_stream_frames(lsf, payload),
                       jphy.build_stream_frames(jlsf, payload))):
        assert np.array_equal(got, want)
        sig, jsig = modulate(got), jphy.modulate(want)
        assert sig.dtype == jsig.dtype == np.float32
        assert np.array_equal(sig.view(np.uint32), jsig.view(np.uint32))


@pytest.mark.parametrize("seed", range(2))
def test_demodulators_equal_the_jax_package(seed):
    """A noisy stream of two beacons and a stream transmission: the same three
    LSFs (the transmission's own among them) and the same transmission (LSF,
    payload, complete) from both packages."""
    rng = np.random.default_rng(172 + seed)
    parts = [np.zeros(int(rng.integers(100, 800)), np.float32)]
    for i in range(3):
        lsf = Lsf(dst=_callsign(rng), src=_callsign(rng))
        if i % 2:
            pl = rng.integers(0, 256, int(rng.integers(1, 97)), dtype=np.uint8).tobytes()
            parts.append(modulate(phy.build_stream_frames(lsf, pl)))
        else:
            parts.append(modulate(build_lsf_frame(lsf)))
        parts.append(np.zeros(int(rng.integers(300, 900)), np.float32))
    x = np.concatenate(parts)
    x = (x + 0.08 * rng.standard_normal(len(x))).astype(np.float32)
    got, want = demodulate_stream(x), jphy.demodulate_stream(x)
    assert len(got) == 3 and [(g.dst, g.src, g.meta, g.type_field) for g in got] == \
        [(w.dst, w.src, w.meta, w.type_field) for w in want]
    got, want = phy.demodulate_payload_stream(x), jphy.demodulate_payload_stream(x)
    assert len(got) == 1 and got[0][2]

    def key(t):
        return (None if t[0] is None else t[0].to_bytes(), t[1], t[2])
    assert [key(g) for g in got] == [key(w) for w in want]


# ---- viterbi_decode_m17's long frames on the device decoder ----

def _punctured_llrs(rng, n_steps, sigma):
    """Soft bits of a random terminated frame of ``n_steps`` trellis steps at
    M17's P2 puncturing: BPSK ±1 with white noise of ``sigma``, zeros at the
    punctured places. Returns ``(llrs, bits)``."""
    bits = np.concatenate([rng.integers(0, 2, n_steps - 4), np.zeros(4)]).astype(np.uint8)
    coded = conv_encode_m17(bits)
    sent = codec.puncture_p2(coded).astype(np.float64) * 2 - 1
    sent += sigma * rng.standard_normal(len(sent))
    return codec.depuncture_p2(sent, len(coded)), bits


def test_long_frames_need_a_card_when_device_is_none(monkeypatch):
    """At 512 steps or more with ``device=None`` the decoder asks the broker
    for its card, which raises where there is none: no fallback to numpy.
    Below 512 steps it decodes on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    import importlib
    monkeypatch.setattr(importlib.import_module("futuresdr_tpu_torch.tpu.instance"),
                        "_instance", None)
    rng = np.random.default_rng(173)
    llrs, bits = _punctured_llrs(rng, 512, 0.3)
    with pytest.raises(RuntimeError, match="CUDA"):
        viterbi_decode_m17(llrs, 512)
    short, sbits = _punctured_llrs(rng, 511, 0.3)
    assert np.array_equal(viterbi_decode_m17(short, 511), sbits)


@pytest.mark.parametrize("n_steps", [512, 1023, 4096])
def test_long_frames_on_the_cpu_equal_the_jax_decoder(n_steps):
    """At 512, 1,023 and 4,096 steps (M17's P2 puncturing, noise σ 0.5),
    ``device="cpu"`` (the kernel's plain version) gives the bits of the JAX
    package's decoder, of its ``scan_viterbi`` and of the float64 numpy
    trellis, bit for bit."""
    from futuresdr_tpu.ops.viterbi import scan_viterbi as jscan
    rng = np.random.default_rng(174 + n_steps)
    llrs, bits = _punctured_llrs(rng, n_steps, 0.5)
    got = viterbi_decode_m17(llrs, n_steps, device="cpu")
    assert got.dtype == np.uint8 and len(got) == n_steps
    assert np.array_equal(got, jcodec.viterbi_decode_m17(llrs, n_steps))
    assert np.array_equal(got, jscan(np.asarray(llrs, np.float32), n_steps,
                                     *jcodec._M17_PREV))
    assert np.array_equal(got, codec._viterbi_numpy(llrs, n_steps))
    assert (got != bits).mean() < 0.01


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


def _train(seed, repeat):
    """Five transmissions, each a beacon or a stream transmission at random,
    with the transmitter's 40-symbol gap, noise 0.05 (the flowgraph test's),
    cut into seeded stretches of 64 to 1,200 symbols. ``repeat``: every beacon
    the same LSF and every stream transmission the same payload, as a beacon
    station or a retransmission sends them."""
    rng = np.random.default_rng(seed)
    parts, metas, payloads = [], [], []
    for i in range(5):
        if rng.integers(0, 2):
            meta = (b"same beacon" if repeat else f"beacon {i}".encode()).ljust(14)
            parts.append(modulate(build_lsf_frame(Lsf(dst="@ALL", src="N0CALL", meta=meta))))
            metas.append(meta)
        else:
            pl = b"same payload" if repeat else \
                rng.integers(0, 256, int(rng.integers(1, 97)), dtype=np.uint8).tobytes()
            parts.append(modulate(phy.build_stream_frames(Lsf(dst="SP5WWP", src="N0CALL"),
                                                          pl)))
            payloads.append(pl)
            metas.append(bytes(14))           # the transmission's own LSF
        parts.append(np.zeros(40 * phy.SPS, np.float32))
    x = np.concatenate(parts)
    x = (x + 0.05 * rng.standard_normal(len(x))).astype(np.float32)
    cuts = np.random.default_rng(seed + 1000)
    pieces, pos = [], 0
    while pos < len(x):
        c = int(cuts.integers(64 * phy.SPS, 1200 * phy.SPS))
        pieces.append(x[pos:pos + c])
        pos += c
    return metas, payloads, pieces


def _decoded(rx):
    return [f.meta for f in rx.frames], [p for _, p in rx.transmissions]


def _as_sent(got, sent):
    return len(got) == len(sent) and all(g[:len(s)] == s and len(g) % 16 == 0
                                         for g, s in zip(got, sent))


@pytest.mark.parametrize("seed,repeat", [(1, False), (3, True)])
def test_receiver_decodes_each_frame_once_however_the_stream_is_cut(seed, repeat):
    """The port's receiver posts every LSF and every stream transmission once,
    in the order sent, over a seeded cut of the stream, repeated frames
    included. Over the same pieces the reference's receiver, which keys its
    memory by content, drops every LSF alike to one posted before (the
    transmissions' own LSFs, the repeated beacons) and every repeated
    payload; at seed 1 it also loses the third transmission to a misframed
    ghost (ROADMAP Queue 3)."""
    metas, payloads, pieces = _train(seed, repeat)
    assert len(pieces) >= 5 and len(payloads) >= 3
    rx, posts = _drive(blocks.M17Receiver(), pieces)
    got_metas, got_payloads = _decoded(rx)
    assert got_metas == metas and _as_sent(got_payloads, payloads)
    assert len(posts) == len(metas) + len(payloads)
    ref, _ = _drive(jblocks.M17Receiver(), pieces)
    ref_metas, ref_payloads = _decoded(ref)
    assert ref_metas == list(dict.fromkeys(metas)) != metas
    if repeat:
        assert len(ref_payloads) == 1 < len(payloads)
    else:
        assert not _as_sent(ref_payloads, payloads)


def test_a_ghost_in_an_eos_frame_does_not_break_the_next_transmission():
    """Seed 1's train whole: a misframed hit 1,517 samples into the second
    transmission's EOS frame (fn 0, agreement 0.84) passes the reference's
    non-maximum suppression, whose window is three quarters of a frame, and
    opens a group that leaves the third transmission incomplete. The port's
    window is a whole frame less the guard: every transmission complete, as
    sent (ROADMAP Queue 3)."""
    _metas, payloads, pieces = _train(1, False)
    x = np.concatenate(pieces)
    got = phy.demodulate_payload_stream(x)
    assert all(c for _, _, c in got) and _as_sent([p for _, p, _ in got], payloads)
    ref = jphy.demodulate_payload_stream(x)
    assert [c for _, _, c in ref].count(False) == 1
    assert len(ref) == len(payloads) and not _as_sent([p for _, p, _ in ref], payloads)


# ---- the app ----

def test_loopback_app_main():
    """``apps/m17_loopback.py``'s ``main()`` as ``tests/test_examples.py``
    runs the reference's (``--frames 1``): every beacon and the stream
    transmission decoded, exit 0."""
    res = subprocess.run([sys.executable, "-m", "futuresdr_tpu_torch.apps.m17_loopback",
                          "--frames", "1"], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "decoded 2/2 LSFs" in res.stdout and "stream transmissions: 1" in res.stdout


def test_loopback_app_run_decodes_a_four_frame_transmission():
    """``run()`` with the reference's three beacons and a 64-byte payload (4
    stream frames): every beacon, then the transmission's LSF, and the
    payload."""
    from futuresdr_tpu_torch.apps.m17_loopback import run
    payload = bytes(range(64))
    metas, lsfs, transmissions, seconds = run(payload=payload)
    assert [f.meta for f in lsfs] == metas + [bytes(14)]
    assert len(transmissions) == 1 and transmissions[0][1] == payload
    assert (transmissions[0][0].src, transmissions[0][0].dst) == ("N0CALL", "SP5WWP")
    assert seconds > 0
