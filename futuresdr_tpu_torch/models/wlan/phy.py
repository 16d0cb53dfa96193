"""802.11a frame-level PHY: PSDU bytes ↔ baseband samples.

The counterpart of ``futuresdr_tpu/models/wlan/phy.py``: the reference WLAN
example's TX chain (``encoder.rs`` → ``mapper`` → ``prefix``, host numpy) and
RX chain (``sync_short``/``sync_long`` → FFT → ``frame_equalizer`` →
``decoder``) as frame-level functions, which the streaming blocks in
``blocks.py`` wrap.

Every decode function takes ``device``: None means the card (``tpu/instance.py``'s
broker, which raises without one); a ``torch.device`` (``"cpu"`` in the tests)
runs there. Packet detection, fine timing, the SIGNAL field's 24-bit decode
and the body of a frame under 8 symbols stay on the host, as in the reference;
the head of every frame (``torch_demod.demod_head_torch``) and a longer body
(``demod_body_torch``) run on ``device``. :func:`decode_frame` and
:func:`decode_stream` decode each frame's data with the host Viterbi
(``coding.viterbi_decode``); :func:`decode_stream_batch` decodes all of a
window's frames with one decoder launch on ``device`` (``ops/viterbi.py``:
the recursion and the traceback; only the decoded bits come back).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ...ops.viterbi import scan_viterbi_batch
from ...tpu.instance import resolve_device
from . import coding, ofdm
from .consts import MCS_TABLE, Mcs, N_DATA_CARRIERS, SYM_LEN
from .torch_demod import demod_body_torch, demod_head_torch

__all__ = ["encode_frame", "decode_frame", "decode_stream", "decode_stream_batch",
           "DecodedFrame", "bytes_to_bits", "bits_to_bytes", "BODY_DEVICE_MIN_SYMBOLS"]

#: a frame's body runs on the device from this many data symbols (the
#: reference's threshold); shorter bodies demodulate on the host
BODY_DEVICE_MIN_SYMBOLS = 8

SIGNAL_MCS = MCS_TABLE["bpsk_1_2"]


def bytes_to_bits(data: bytes) -> np.ndarray:
    """LSB-first bit unpacking (802.11 bit order)."""
    arr = np.frombuffer(data, dtype=np.uint8)
    return np.unpackbits(arr, bitorder="little").astype(np.uint8)


def bits_to_bytes(bits: np.ndarray) -> bytes:
    return np.packbits(bits.astype(np.uint8), bitorder="little").tobytes()


def _signal_field(mcs: Mcs, length: int) -> np.ndarray:
    """24-bit SIGNAL: RATE(4) + R(1) + LENGTH(12) + parity + 6 tail (Clause 17.3.4)."""
    bits = np.zeros(24, dtype=np.uint8)
    for i in range(4):
        bits[i] = (mcs.rate_bits >> (3 - i)) & 1
    for i in range(12):
        bits[5 + i] = (length >> i) & 1
    bits[17] = bits[:17].sum() % 2     # even parity
    return bits


def _parse_signal(bits: np.ndarray) -> Optional[tuple]:
    if bits[:18].sum() % 2 != 0:
        return None
    rate = 0
    for i in range(4):
        rate |= int(bits[i]) << (3 - i)
    length = 0
    for i in range(12):
        length |= int(bits[5 + i]) << i
    for mcs in MCS_TABLE.values():
        if mcs.rate_bits == rate:
            return mcs, length
    return None


def encode_frame(psdu: bytes, mcs_name: str = "qpsk_1_2",
                 scrambler_seed: int = 0b1011101) -> np.ndarray:
    """PSDU bytes → complex64 baseband frame (preamble + SIGNAL + DATA symbols)."""
    mcs = MCS_TABLE[mcs_name]
    length = len(psdu)

    # ---- SIGNAL symbol (BPSK 1/2, not scrambled) -----------------------------
    sig_coded = coding.conv_encode(_signal_field(mcs, length))
    sig_inter = coding.interleave(sig_coded, 48, 1)
    sig_sym = ofdm.map_bits(sig_inter, "bpsk").reshape(1, N_DATA_CARRIERS)

    # ---- DATA: SERVICE + PSDU + tail + pad -----------------------------------
    service = np.zeros(16, dtype=np.uint8)
    data_bits = np.concatenate([service, bytes_to_bits(psdu)])
    n_sym = -(-(len(data_bits) + 6) // mcs.n_dbps)
    padded = np.zeros(n_sym * mcs.n_dbps, dtype=np.uint8)
    padded[:len(data_bits)] = data_bits
    scrambled = coding.scramble(padded, scrambler_seed)
    scrambled[len(data_bits):len(data_bits) + 6] = 0      # zero the tail bits
    coded = coding.conv_encode(scrambled)
    punct = coding.puncture(coded, mcs.coding_rate)
    inter = coding.interleave(punct, mcs.n_cbps, mcs.n_bpsc)
    data_syms = ofdm.map_bits(inter, mcs.modulation).reshape(n_sym, N_DATA_CARRIERS)

    # ---- assemble ------------------------------------------------------------
    preamble = ofdm.make_preamble()
    signal_t = ofdm.ofdm_modulate(sig_sym, symbol_offset=0)
    data_t = ofdm.ofdm_modulate(data_syms, symbol_offset=1)
    return np.concatenate([preamble, signal_t, data_t]).astype(np.complex64)


@dataclass
class DecodedFrame:
    psdu: bytes
    mcs: Mcs
    start: int
    cfo: float
    n_symbols: int
    seed_ok: bool = True   # scrambler seed recovered from the SERVICE prefix.
    #   A correct decode matches its seed with P≈1; a GARBAGE decode matches
    #   some seed with P≈127/2^16≈0.2% (the gate's false-accept rate) — so
    #   seed_ok=False means parity-lucky garbage, essentially always
    snr_db: float = float("nan")   # LTS-repetition SNR estimate
    #   (`frame_equalizer.rs:64` snr() role)


def decode_frame(samples: np.ndarray, lts_start: int, cfo: float = 0.0,
                 device=None) -> Optional[DecodedFrame]:
    """Decode one frame given LTS timing (`frame_equalizer.rs` + `decoder` roles),
    its demod on ``device`` (None: the card), its Viterbi on the host."""
    p = _prepare_frame(samples, lts_start, cfo, resolve_device(device))
    if p is None:
        return None
    depunct, n_info_bits = p[0], p[1]
    decoded = coding.viterbi_decode(depunct, n_info_bits)
    return _finish_frame(decoded, *p[2:])


def _frame_end(lts_start: int, n_symbols: int) -> int:
    """Last sample of a decoded frame: LTS (128) + SIGNAL (80) + data symbols."""
    return lts_start + 128 + SYM_LEN * (1 + n_symbols)


def decode_stream(samples: np.ndarray, device=None) -> List[DecodedFrame]:
    """Full RX: detect (`sync_short`), align (`sync_long`), decode every frame.

    Detections whose sync resolves INSIDE an already-decoded frame's span are
    skipped — noise can re-trigger the plateau detector on one burst, and a
    false sync into the data region otherwise yields a duplicate or a
    parity-lucky garbage frame. Only frames whose scrambler seed was recovered
    (``seed_ok``) claim their span: a garbage decode with a bogus long length
    must not swallow the NEXT real burst's preamble."""
    dev = resolve_device(device)
    out: List[DecodedFrame] = []
    claimed_to = -1
    for start in ofdm.detect_packets(samples):
        r = ofdm.sync_long(samples, start)
        if r is None:
            continue
        data_start, lts_start, cfo = r
        if lts_start < claimed_to:
            continue
        frame = decode_frame(samples, lts_start, cfo, dev)
        if frame is not None and frame.seed_ok:
            # a frame whose SERVICE prefix matches no scrambler seed was
            # descrambled with a GUESS — its bytes are meaningless; dropping it
            # here equals the reference's seed-derivation + MAC-FCS rejection
            claimed_to = _frame_end(lts_start, frame.n_symbols)
            out.append(frame)
    return out


def _prepare_frame(samples: np.ndarray, lts_start: int, cfo: float, device):
    """Front half of decode_frame: everything up to the DATA Viterbi. Returns
    (mother-code llrs, n_info_bits, mcs, length) or None — n_info_bits is
    SERVICE+PSDU+tail (16 + 8·length + 6), the terminated-trellis decode
    length, NOT the padded n_sym·n_dbps (the pad stays scrambled; decoding
    into it corrupts the tail — see the comment at the return).

    CFO correction is applied only to the spans actually demodulated (LTS+SIGNAL,
    then the data symbols) — correcting the whole remaining stream per frame would
    make multi-frame decoding O(stream²)."""
    data_start = lts_start + 128
    if data_start + SYM_LEN > len(samples):
        return None
    head = samples[lts_start:data_start + SYM_LEN]
    # channel estimate + SIGNAL demap on the device (CFO applied there with
    # the lts_start phase reference)
    H, sig_llrs = demod_head_torch(head, cfo, device)
    sig_bits = coding.viterbi_decode(coding.deinterleave(sig_llrs, 48, 1), 24)
    parsed = _parse_signal(sig_bits)
    if parsed is None:
        return None
    mcs, length = parsed
    n_bits = 16 + 8 * length + 6
    n_sym = -(-n_bits // mcs.n_dbps)
    avail = (len(samples) - data_start - SYM_LEN) // SYM_LEN
    if n_sym > avail:
        return None
    off = data_start + SYM_LEN
    body = samples[off:off + n_sym * SYM_LEN]
    if n_sym >= BODY_DEVICE_MIN_SYMBOLS:
        # the whole body demod (CFO, batched FFT, equalize, CPE, demap) on the device
        llrs = demod_body_torch(body, H, n_sym, 1, cfo, off - lts_start, mcs.modulation,
                                device)
    else:
        if cfo != 0.0:
            body = body * np.exp(-1j * cfo * (np.arange(len(body))
                                              + (off - lts_start)))
        spec = ofdm.ofdm_demodulate_symbols(body, n_sym)
        eq = ofdm.equalize(spec, H, symbol_offset=1)
        llrs = ofdm.demap_llrs(eq.reshape(-1), mcs.modulation)
    deint = coding.deinterleave(llrs, mcs.n_cbps, mcs.n_bpsc)
    depunct = coding.depuncture(deint, mcs.coding_rate)
    # decode exactly SERVICE+PSDU+tail (n_bits), NOT the padded n_sym·n_dbps:
    # the pad bits after the tail stay SCRAMBLED (encode_frame zeroes only the
    # tail), so the trellis is terminated in state 0 at n_bits and nowhere
    # later — tracing back from state 0 at the padded length corrupted the
    # last bytes whenever the scrambled pad bits were nonzero (found by the
    # r4 seeded fuzz campaign; content/seed-dependent, clean-signal).
    return (depunct, n_bits, mcs, length, lts_start, cfo, n_sym,
            _lts_snr_db(samples, lts_start, cfo))


def _lts_snr_db(samples: np.ndarray, lts_start: int, cfo: float) -> float:
    """SNR from the two identical LTS repetitions (`frame_equalizer.rs:64`):
    their difference is pure noise, their mean power is signal + noise."""
    lts = samples[lts_start:lts_start + 128]
    if cfo != 0.0:
        lts = lts * np.exp(-1j * cfo * np.arange(128))
    l1, l2 = lts[:64], lts[64:]
    noise = float(np.mean(np.abs(l1 - l2) ** 2)) / 2 + 1e-20
    total = float(np.mean(np.abs(lts) ** 2))
    return 10.0 * math.log10(max(total - noise, 1e-20) / noise)


_SEED_TABLE: Optional[np.ndarray] = None   # [127, 16] keystream prefixes for seeds 1..127


def _finish_frame(decoded_bits: np.ndarray, mcs, length, lts_start, cfo,
                  n_sym, snr_db=float("nan")) -> Optional[DecodedFrame]:
    # the 16 SERVICE bits are zeros pre-scrambling: recover the TX seed by matching
    # the received prefix against all 127 keystream prefixes at once (the reference
    # derives it in closed form from the first 7 bits — equivalent, vectorized)
    global _SEED_TABLE
    if _SEED_TABLE is None:
        _SEED_TABLE = np.stack([coding._keystream(s)[:16] for s in range(1, 128)])
    match = np.nonzero((_SEED_TABLE == decoded_bits[None, :16]).all(axis=1))[0]
    seed = int(match[0]) + 1 if len(match) else 0b1011101
    descrambled = coding.descramble(decoded_bits, seed)
    psdu_bits = descrambled[16:16 + 8 * length]
    return DecodedFrame(bits_to_bytes(psdu_bits), mcs, lts_start, cfo, n_sym,
                        seed_ok=bool(len(match)), snr_db=snr_db)


def decode_stream_batch(samples: np.ndarray, device=None,
                        stats: Optional[dict] = None) -> List[DecodedFrame]:
    """Burst-batched RX: every detected frame's demod on ``device`` (None: the
    card) and all of their Viterbi decodes as ONE batched launch there
    (``ops/viterbi.scan_viterbi_batch``; ``stats`` receives its figures)."""
    dev = resolve_device(device)
    preps = []
    for start in ofdm.detect_packets(samples):
        r = ofdm.sync_long(samples, start)
        if r is None:
            continue
        _, lts_start, cfo = r
        p = _prepare_frame(samples, lts_start, cfo, dev)
        if p is not None:
            preps.append(p)
    if not preps:
        return []
    from .coding import _BM0, _BM1, _PREV_B, _PREV_S
    bits_list = scan_viterbi_batch([p[0] for p in preps], [p[1] for p in preps],
                                   _PREV_S, _PREV_B, _BM0, _BM1, dev, stats)
    # the seed check needs the Viterbi output, so the batch path applies the
    # span/dedup policy AFTER decoding (same semantics as decode_stream: only
    # seed_ok frames claim; detections inside a claimed span are dropped)
    out = []
    claimed_to = -1
    for p, bits in zip(preps, bits_list):
        lts_start = p[4]
        if lts_start < claimed_to:
            continue
        f = _finish_frame(bits, *p[2:])
        if f is not None and f.seed_ok:
            claimed_to = _frame_end(lts_start, f.n_symbols)
            out.append(f)
    return out
