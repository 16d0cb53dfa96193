"""The port's WLAN receiver (``futuresdr_tpu_torch/models/wlan``) against the JAX
package's (``futuresdr_tpu/models/wlan``) on the CPU.

The host plane (scrambler, code, puncturing, interleaver, mapping, MAC,
channels, sync) is a copy and must give the reference's arrays exactly. The
device demod runs here on CPU tensors (``device="cpu"``) against the JAX
programs: the head at the reference's own bar (``tests/test_wlan.py``: atol
2e-4 on H, 2e-3 on the LLRs), the body at atol 2e-5 on LLRs that reach about
8 (measured: at most 2.4e-6; the two FFT libraries round differently in the
last bits of float32). Inputs are made by numpy from a seed.
"""

import os

import numpy as np
import pytest
import torch

from futuresdr_tpu.models import wlan as J
from futuresdr_tpu.models.wlan import coding as jcoding
from futuresdr_tpu.models.wlan import ofdm as jofdm
from futuresdr_tpu.models.wlan.jax_demod import demod_body_jax, demod_head_jax
from futuresdr_tpu_torch.models import wlan as W
from futuresdr_tpu_torch.models.wlan import coding, ofdm, phy
from futuresdr_tpu_torch.models.wlan.torch_demod import demod_body_torch, demod_head_torch
from futuresdr_tpu_torch.ops import viterbi as V

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

CPU = "cpu"
HEAD_H_ATOL = 2e-4
HEAD_LLR_ATOL = 2e-3
BODY_LLR_ATOL = 2e-5


def _noise(rng, x, sigma):
    return (x + sigma * (rng.standard_normal(len(x))
                         + 1j * rng.standard_normal(len(x)))).astype(np.complex64)


def _perf_stream(frames: int, payload: int = 256, snr_db: float = 25.0, seed: int = 0):
    """``perf/wlan.py``'s stream: ``frames`` QPSK-1/2 MPDUs of ``payload``
    random bytes, 300-sample gaps, white noise at ``snr_db``."""
    rng = np.random.default_rng(seed)
    mac = W.Mac()
    parts, sent = [], []
    for _ in range(frames):
        psdu = mac.frame(bytes(rng.integers(0, 256, payload, dtype=np.uint8)))
        sent.append(psdu)
        parts += [W.encode_frame(psdu, "qpsk_1_2"), np.zeros(300, np.complex64)]
    sig = np.concatenate(parts)
    sigma = np.sqrt(np.mean(np.abs(sig) ** 2) * 10 ** (-snr_db / 10) / 2)
    return _noise(rng, sig, sigma), sent


# ---------------------------------------------------------------------------
# the host plane: copies, equal to the reference
# ---------------------------------------------------------------------------

def test_coding_equals_the_reference():
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, 960).astype(np.uint8)
    assert np.array_equal(coding.scramble(bits, 0b1011101), jcoding.scramble(bits, 0b1011101))
    assert np.array_equal(coding.descramble(coding.scramble(bits, 93), 93), bits)
    coded = coding.conv_encode(bits)
    assert np.array_equal(coded, jcoding.conv_encode(bits))
    for rate in ("1/2", "2/3", "3/4"):
        p = coding.puncture(coded, rate)
        assert np.array_equal(p, jcoding.puncture(coded, rate))
        llrs = p.astype(np.float64) * 2 - 1
        assert np.array_equal(coding.depuncture(llrs, rate), jcoding.depuncture(llrs, rate))
    for n_cbps, n_bpsc in ((48, 1), (96, 2), (192, 4), (288, 6)):
        x = rng.integers(0, 2, 4 * n_cbps).astype(np.uint8)
        i = coding.interleave(x, n_cbps, n_bpsc)
        assert np.array_equal(i, jcoding.interleave(x, n_cbps, n_bpsc))
        assert np.array_equal(coding.deinterleave(i, n_cbps, n_bpsc), x)


@pytest.mark.parametrize("mod", ["bpsk", "qpsk", "qam16", "qam64"])
def test_map_demap_equal_the_reference(mod):
    rng = np.random.default_rng(2)
    n_bpsc = {"bpsk": 1, "qpsk": 2, "qam16": 4, "qam64": 6}[mod]
    bits = rng.integers(0, 2, 48 * n_bpsc).astype(np.uint8)
    sym = ofdm.map_bits(bits, mod)
    assert np.array_equal(sym, jofdm.map_bits(bits, mod))
    noisy = _noise(rng, sym, 0.05)
    llrs = ofdm.demap_llrs(noisy, mod)
    assert np.array_equal(llrs, jofdm.demap_llrs(noisy, mod))
    assert np.array_equal((llrs > 0).astype(np.uint8), bits)


def test_frames_sync_mac_and_channels_equal_the_reference():
    rng = np.random.default_rng(3)
    mac, jmac = W.Mac(), J.Mac()
    for mcs in W.MCS_TABLE:
        psdu = mac.frame(f"{mcs} frame".encode() * 3)
        assert psdu == jmac.frame(f"{mcs} frame".encode() * 3)
        assert np.array_equal(W.encode_frame(psdu, mcs), J.encode_frame(psdu, mcs))
    sig = np.concatenate([np.zeros(333, np.complex64), W.encode_frame(psdu, "qam64_3_4"),
                          np.zeros(200, np.complex64)])
    sig = _noise(rng, sig * np.exp(1j * 0.001 * np.arange(len(sig))), 0.02)
    starts = ofdm.detect_packets(sig)
    assert starts == jofdm.detect_packets(sig) and starts
    assert ofdm.sync_long(sig, starts[0]) == jofdm.sync_long(sig, starts[0])
    H = ofdm.estimate_channel(sig, 333 + 160)
    assert np.array_equal(H, jofdm.estimate_channel(sig, 333 + 160))
    assert mac.deframe(psdu) == b"qam64_3_4 frame" * 3
    bad = bytearray(psdu)
    bad[10] ^= 0xFF
    assert mac.deframe(bytes(bad)) is None and mac.crc_failures == 1
    from futuresdr_tpu.models.wlan import channels as jch
    from futuresdr_tpu_torch.models.wlan import channels
    assert channels.CHANNELS == jch.CHANNELS
    assert W.parse_channel("36") == jch.parse_channel("36") == 5180e6
    assert W.freq_to_channel(2484e6) == 14 and W.channel_to_freq(999) is None
    with pytest.raises(ValueError, match="channel"):
        W.parse_channel("x")


def test_native_viterbi_bit_equal_to_numpy(monkeypatch):
    """The C++ copy (``csrc/host/viterbi.cpp``) decodes bit-identically to the
    numpy trellis, ties included; ``FSDR_NO_NATIVE=1`` forces numpy."""
    monkeypatch.delenv("FSDR_NO_NATIVE", raising=False)
    if coding._native_lib() is None:
        pytest.skip("g++ could not build csrc/host/viterbi.cpp")
    rng = np.random.default_rng(0)
    for n in (24, 97, 511, 513, 3000):
        bits = rng.integers(0, 2, n).astype(np.uint8)
        bits[-6:] = 0
        llrs = coding.conv_encode(bits).astype(np.float64) * 2 - 1 \
            + 0.5 * rng.standard_normal(2 * n)
        for case in (llrs, np.zeros(2 * n), np.round(llrs)):
            native = coding.viterbi_decode(case, n)
            monkeypatch.setenv("FSDR_NO_NATIVE", "1")
            assert coding._native_lib() is None
            ref = coding.viterbi_decode(case, n)
            monkeypatch.delenv("FSDR_NO_NATIVE")
            assert np.array_equal(native, ref), n
        assert np.array_equal(coding.viterbi_decode(llrs, n), bits), n


def test_native_build_failure_falls_back_to_numpy_once(monkeypatch, caplog):
    """Where the library cannot build, the numpy trellis runs after one
    warning (a host route, never the device path)."""
    from futuresdr_tpu_torch.ops import _build
    monkeypatch.delenv("FSDR_NO_NATIVE", raising=False)
    monkeypatch.setattr(coding, "_NATIVE", None)

    def fail(name):
        raise RuntimeError("no compiler")
    monkeypatch.setattr(_build, "load_host", fail)
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, 64).astype(np.uint8)
    bits[-6:] = 0
    llrs = coding.conv_encode(bits).astype(np.float64) * 2 - 1
    with caplog.at_level("WARNING"):
        assert np.array_equal(coding.viterbi_decode(llrs, 64), bits)
        assert np.array_equal(coding.viterbi_decode(llrs, 64), bits)
    assert sum("did not build" in r.getMessage() for r in caplog.records) == 1


# ---------------------------------------------------------------------------
# the device demod on CPU tensors against the JAX programs
# ---------------------------------------------------------------------------

def _burst(mcs: str, n_sym: int, seed: int, cfo: float = 0.002):
    m = W.MCS_TABLE[mcs]
    rng = np.random.default_rng(seed)
    nbytes = (n_sym * m.n_dbps - 22) // 8
    sig = W.encode_frame(rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes(), mcs)
    sig = np.concatenate([np.zeros(100, np.complex64), sig, np.zeros(100, np.complex64)])
    sig = _noise(rng, sig * np.exp(1j * cfo * np.arange(len(sig))), 0.02)
    start = ofdm.detect_packets(sig)[0]
    _, lts, c = ofdm.sync_long(sig, start)
    return sig, lts, c, m


@pytest.mark.parametrize("cfo", [0.0, 0.003, -0.008])
def test_demod_head_matches_jax(cfo):
    psdu = W.Mac().frame(b"head path check" * 4)
    sig = np.concatenate([np.zeros(100, np.complex64), W.encode_frame(psdu, "bpsk_1_2")])
    start = ofdm.detect_packets(sig)[0]
    _, lts, _ = ofdm.sync_long(sig, start)
    head = sig[lts:lts + 208]
    Hj, lj = demod_head_jax(head, cfo)
    Ht, lt = demod_head_torch(head, cfo, CPU)
    assert Ht.dtype == np.complex64 and Ht.shape == (64,)
    assert lt.dtype == np.float32 and lt.shape == (48,)
    np.testing.assert_allclose(Ht, Hj, atol=HEAD_H_ATOL)
    np.testing.assert_allclose(lt, lj, atol=HEAD_LLR_ATOL)


@pytest.mark.parametrize("n_sym", [8, 37])
@pytest.mark.parametrize("mcs", ["bpsk_1_2", "qpsk_1_2", "qam16_1_2", "qam64_3_4"])
def test_demod_body_matches_jax(mcs, n_sym):
    sig, lts, c, m = _burst(mcs, n_sym, n_sym)
    H, _ = demod_head_torch(sig[lts:lts + 208], c, CPU)
    off = lts + 128 + 80
    body = sig[off:off + n_sym * 80]
    want = demod_body_jax(body, H, n_sym, 1, c, off - lts, m.modulation)
    got = demod_body_torch(body, H, n_sym, 1, c, off - lts, m.modulation, CPU)
    assert got.dtype == np.float32 and got.shape == (n_sym * 48 * m.n_bpsc,)
    np.testing.assert_allclose(got, want, atol=BODY_LLR_ATOL)


# ---------------------------------------------------------------------------
# decoding end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mcs", list(W.MCS_TABLE))
def test_every_mcs_loops_back(mcs):
    """Each MCS at two lengths: the long frame's body on the device (here the
    CPU tensors), the short one (n_sym < 8) on the host beside the device
    head; the decode equals the reference's."""
    for psdu, device_body in ((W.Mac().frame(f"port {mcs} ".encode() * 24), True),
                              (b"tiny!", False)):
        sig = np.concatenate([np.zeros(171, np.complex64), W.encode_frame(psdu, mcs),
                              np.zeros(64, np.complex64)])
        sig = (sig * np.exp(1j * 0.002 * np.arange(len(sig)))).astype(np.complex64)
        frames = W.decode_stream(sig, device=CPU)
        assert len(frames) == 1 and frames[0].psdu == psdu, mcs
        f, ref = frames[0], J.decode_stream(sig)[0]
        assert (f.mcs.name, f.start, f.n_symbols, f.seed_ok) == \
            (ref.mcs.name, ref.start, ref.n_symbols, ref.seed_ok)
        assert (f.n_symbols >= phy.BODY_DEVICE_MIN_SYMBOLS) == device_body
        assert W.decode_stream_batch(sig, device=CPU)[0].psdu == psdu


def test_decode_stream_batch_equals_decode_stream_on_the_perf_stream():
    """A 20-frame cut of ``perf/wlan.py``'s stream (seed 0, QPSK-1/2, 256-byte
    payloads, 300-sample gaps, 25 dB): the batched decoder (one decoder call
    over every detection, a 4096-step bucket) finds what the per-frame
    decoder and the reference find, every MAC FCS passes."""
    sig, sent = _perf_stream(20)
    stats = {}
    batched = W.decode_stream_batch(sig, device=CPU, stats=stats)
    per_frame = W.decode_stream(sig, device=CPU)
    assert [f.psdu for f in batched] == [f.psdu for f in per_frame] == sent
    assert [f.start for f in batched] == [f.start for f in J.decode_stream(sig)]
    assert all(W.payload_from_mpdu(f.psdu) is not None for f in batched)
    # the real frames' decoded bits come back, one byte a step of the bucket
    assert stats["bucket"] == 4096 and 20 <= stats["frames"] <= 32
    assert stats["d2h_bytes"] == 4096 * stats["frames"]


def test_viterbi_terminates_at_tail_not_pad():
    """The reference's regression (``tests/test_wlan.py``): decode exactly
    SERVICE+PSDU+tail, never into the scrambled pad."""
    rng = np.random.default_rng(5)
    for _ in range(6):
        rng.integers(0, 256, 1)
    rng.integers(0, 256, 195)
    psdu = rng.integers(0, 256, 195).astype(np.uint8).tobytes()
    x = np.concatenate([np.zeros(200, np.complex64), W.encode_frame(psdu, "qam16_3_4"),
                        np.zeros(200, np.complex64)])
    for decode in (W.decode_stream, W.decode_stream_batch):
        frames = decode(x, device=CPU)
        assert len(frames) == 1 and frames[0].psdu == psdu
    for mcs in ("qam16_3_4", "qam64_2_3", "qam64_3_4"):
        for n_pay in (185, 189, 195):
            p2 = rng.integers(0, 256, n_pay).astype(np.uint8).tobytes()
            x2 = np.concatenate([np.zeros(150, np.complex64), W.encode_frame(p2, mcs),
                                 np.zeros(150, np.complex64)])
            for decode in (W.decode_stream, W.decode_stream_batch):
                f2 = decode(x2, device=CPU)
                assert len(f2) == 1 and f2[0].psdu == p2, (mcs, n_pay)


def test_flowgraph_loopback_on_cpu_tensors():
    """``WlanEncoder → Apply(noise) → WlanDecoder(device="cpu")`` (the
    reference's ``loopback.rs:30-123``), through the app's ``run``."""
    from futuresdr_tpu_torch.apps import wlan_loopback
    V.reset_launches()
    sent, got = wlan_loopback.run(frames=5, noise=0.01, device=CPU, seed=7)
    assert got == sent
    assert V.launches == {"viterbi": 0}
    assert wlan_loopback.main(["--frames", "3", "--device", CPU]) == 0


def test_decoder_defaults_to_the_card(monkeypatch):
    """``WlanDecoder()`` and ``decode_stream*(device=None)`` ask the broker
    for the card, which raises without one: no silent CPU."""
    import importlib
    inst = importlib.import_module("futuresdr_tpu_torch.tpu.instance")
    monkeypatch.setattr(inst, "_instance", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sig, _ = _perf_stream(1)
    for call in (lambda: W.WlanDecoder(), lambda: W.decode_stream(sig),
                 lambda: W.decode_stream_batch(sig)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_no_backend_probe_in_the_port():
    """The reference routes by probing a JAX backend and falls back inside a
    bare ``except``; the port routes by ``device`` alone."""
    import futuresdr_tpu_torch.models.wlan as pkg
    root = os.path.dirname(pkg.__file__)
    for name in os.listdir(root):
        if name.endswith(".py"):
            text = open(os.path.join(root, name)).read()
            assert "backend_ready" not in text and "except Exception" not in text, name
