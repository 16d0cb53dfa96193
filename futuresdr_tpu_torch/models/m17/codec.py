"""M17 protocol codecs: base-40 callsigns, CRC16, Golay(24,12), convolutional code.

Re-design of the reference M17 example's codec layer (``examples/m17/src/``: Golay/CRC/LSF
codec). Public M17 spec values: CRC16 poly 0x5935 init 0xFFFF; Golay(24,12) generator
0xC75; K=5 convolutional code with polynomials 0x19/0x17, P1/P2 puncturing.

The port's copy of ``futuresdr_tpu/models/m17/codec.py``, its arithmetic
unchanged, but for the long frames' route: ``viterbi_decode_m17`` sends a
frame of ``DEVICE_MIN_STEPS`` steps or more to the device decoder
(``ops/viterbi.scan_viterbi``, the hand kernel ``csrc/viterbi.cu`` on a card)
on the ``device`` it is given, with no fallback: ``None`` means the broker's
card, which raises without CUDA; ``"cpu"`` runs the kernel's plain version.
Shorter frames keep the numpy trellis, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["encode_callsign", "decode_callsign", "crc16_m17", "golay24_encode",
           "golay24_decode", "conv_encode_m17", "viterbi_decode_m17",
           "puncture_p1", "depuncture_p1", "puncture_p2", "depuncture_p2",
           "lich_encode", "lich_decode", "DEVICE_MIN_STEPS"]

_CHARSET = " ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-/."


def encode_callsign(cs: str) -> int:
    """Base-40 address encoding (M17 spec §2.3); '@ALL' broadcast = 0xFFFFFFFFFFFF."""
    if cs == "@ALL":
        return 0xFFFFFFFFFFFF
    v = 0
    for c in reversed(cs.upper()[:9]):
        idx = _CHARSET.find(c)
        if idx < 0:
            raise ValueError(f"invalid callsign char {c!r}")
        v = v * 40 + idx
    return v


def decode_callsign(v: int) -> str:
    if v == 0xFFFFFFFFFFFF:
        return "@ALL"
    out = []
    while v > 0:
        out.append(_CHARSET[v % 40])
        v //= 40
    return "".join(out)


def crc16_m17(data: bytes) -> int:
    """CRC-16 poly 0x5935, init 0xFFFF, no reflection (M17 spec §2.5.4)."""
    crc = 0xFFFF
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x5935) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


# ---- Golay(24,12): generator polynomial 0xC75 ---------------------------------------
def _golay_syndrome_table():
    """Map syndrome → correctable error pattern (≤3 bit errors in 23-bit Golay)."""
    H = {}
    for e in _error_patterns():
        s = _golay23_syndrome(e)
        if s not in H:
            H[s] = e
    return H


def _golay23_encode_word(d: int) -> int:
    """12 data bits → 23-bit codeword (systematic, data in high bits)."""
    g = 0xC75             # x^11 + x^10 + x^6 + x^5 + x^4 + x^2 + 1
    r = d << 11
    for i in range(22, 10, -1):
        if r & (1 << i):
            r ^= g << (i - 11)
    return (d << 11) | (r & 0x7FF)


def _golay23_syndrome(w: int) -> int:
    g = 0xC75
    r = w
    for i in range(22, 10, -1):
        if r & (1 << i):
            r ^= g << (i - 11)
    return r & 0x7FF


def _error_patterns():
    pats = [0]
    idx = list(range(23))
    for a in idx:
        pats.append(1 << a)
    for a in idx:
        for b in idx[a + 1:]:
            pats.append((1 << a) | (1 << b))
    for a in idx:
        for b in idx[a + 1:]:
            for c in idx[b + 1:]:
                pats.append((1 << a) | (1 << b) | (1 << c))
    return pats


_SYN_TABLE = None


def golay24_encode(data12: int) -> int:
    """12 bits → 24-bit extended Golay word (23-bit code + overall parity)."""
    w = _golay23_encode_word(data12 & 0xFFF)
    parity = bin(w).count("1") & 1
    return (w << 1) | parity


def golay24_decode(word24: int) -> Optional[int]:
    """Correct up to 3 bit errors; returns the 12 data bits or None."""
    global _SYN_TABLE
    if _SYN_TABLE is None:
        _SYN_TABLE = _golay_syndrome_table()
    w = (word24 >> 1) & 0x7FFFFF
    s = _golay23_syndrome(w)
    e = _SYN_TABLE.get(s)
    if e is None:
        return None
    return ((w ^ e) >> 11) & 0xFFF


# ---- K=5 convolutional code, polys 0x19 / 0x17 (M17 spec §2.4.2) ---------------------
_G1, _G2 = 0x19, 0x17
_NS = 16

_OUT = np.zeros((_NS, 2, 2), dtype=np.uint8)
_NXT = np.zeros((_NS, 2), dtype=np.int64)
for s in range(_NS):
    for b in range(2):
        reg = (b << 4) | s
        _OUT[s, b, 0] = bin(reg & _G1).count("1") & 1
        _OUT[s, b, 1] = bin(reg & _G2).count("1") & 1
        _NXT[s, b] = reg >> 1


_G1_KERNEL = np.array([(_G1 >> (4 - j)) & 1 for j in range(5)], dtype=np.uint8)
_G2_KERNEL = np.array([(_G2 >> (4 - j)) & 1 for j in range(5)], dtype=np.uint8)


def conv_encode_m17(bits: np.ndarray) -> np.ndarray:
    """K=5 rate-1/2 encode as two vectorized GF(2) convolutions."""
    bits = np.asarray(bits, dtype=np.uint8)
    a = np.convolve(bits, _G1_KERNEL)[:len(bits)] & 1
    b = np.convolve(bits, _G2_KERNEL)[:len(bits)] & 1
    out = np.empty(2 * len(bits), dtype=np.uint8)
    out[0::2] = a
    out[1::2] = b
    return out


def _m17_prev_tables():
    prev_tbl = [[] for _ in range(_NS)]
    for s in range(_NS):
        for b in range(2):
            prev_tbl[_NXT[s, b]].append((s, b))
    prev_s = np.array([[p[0][0], p[1][0]] for p in prev_tbl])
    prev_b = np.array([[p[0][1], p[1][1]] for p in prev_tbl])
    o = _OUT.astype(np.float64) * 2 - 1
    return prev_s, prev_b, o[prev_s, prev_b, 0], o[prev_s, prev_b, 1]


#: ``(prev_s, prev_b, bm0, bm1)``, each ``[16, 2]``: each next state's two
#: predecessor states and input bits, and their branch output bits in ±1
_M17_PREV = _m17_prev_tables()


#: frames of this many trellis steps or more go to the device decoder
DEVICE_MIN_STEPS = 512


def viterbi_decode_m17(llrs: np.ndarray, n_bits: int, device=None) -> np.ndarray:
    """Soft Viterbi over the K=5 code, vectorized over 16 states.

    A frame of ``DEVICE_MIN_STEPS`` steps or more runs on ``device``
    through ``ops/viterbi.scan_viterbi`` (``None``: the broker's card, which
    raises where there is none); a shorter one runs the numpy trellis on the
    host."""
    n_steps = min(len(llrs) // 2, n_bits)
    prev_s, prev_b, bm0, bm1 = _M17_PREV
    if n_steps >= DEVICE_MIN_STEPS:
        from ...ops.viterbi import scan_viterbi
        return scan_viterbi(np.asarray(llrs, np.float32), n_bits, prev_s, prev_b,
                            bm0, bm1, device=device)
    return _viterbi_numpy(llrs, n_bits)


def _viterbi_numpy(llrs: np.ndarray, n_bits: int) -> np.ndarray:
    """The numpy trellis in float64 at any length: the reference's host
    decoder, which the device route is held against."""
    n_steps = min(len(llrs) // 2, n_bits)
    prev_s, prev_b, bm0, bm1 = _M17_PREV
    lam = llrs[:2 * n_steps].reshape(n_steps, 2).astype(np.float64)
    metrics = np.full(_NS, -1e18)
    metrics[0] = 0.0
    src = np.empty((n_steps, _NS), dtype=np.int64)
    dec = np.empty((n_steps, _NS), dtype=np.uint8)
    for t in range(n_steps):
        cand = metrics[prev_s] + bm0 * lam[t, 0] + bm1 * lam[t, 1]
        pick = np.argmax(cand, axis=1)
        metrics = cand[np.arange(_NS), pick]
        src[t] = prev_s[np.arange(_NS), pick]
        dec[t] = prev_b[np.arange(_NS), pick]
    state = 0
    out = np.empty(n_steps, dtype=np.uint8)
    for t in range(n_steps - 1, -1, -1):
        out[t] = dec[t, state]
        state = src[t, state]
    return out[:n_bits]


# P1 puncture matrix for the LSF: 61-entry pattern keeping 46 bits, so the 488 coded
# LSF bits fit 368 transmitted bits (M17 spec §2.4.3): P1 = [1, (1,1,1,0)×15]
_P1 = np.array([1] + [1, 1, 1, 0] * 15, dtype=bool)


def puncture_p1(coded: np.ndarray) -> np.ndarray:
    mask = np.resize(_P1, len(coded))
    return coded[mask]


def depuncture_p1(llrs: np.ndarray, n_coded: int) -> np.ndarray:
    mask = np.resize(_P1, n_coded)
    full = np.zeros(n_coded, dtype=np.float64)
    pos = np.nonzero(mask)[0][:len(llrs)]
    full[pos] = llrs[:len(pos)]
    return full


# P2 puncture matrix for stream frames: drop every 12th bit, 296 coded
# (FN+payload+flush) → 272 transmitted (M17 spec §2.5.2, `encoder.rs` P2 role)
_P2 = np.array([1] * 11 + [0], dtype=bool)


def puncture_p2(coded: np.ndarray) -> np.ndarray:
    mask = np.resize(_P2, len(coded))
    return coded[mask]


def depuncture_p2(llrs: np.ndarray, n_coded: int) -> np.ndarray:
    mask = np.resize(_P2, n_coded)
    full = np.zeros(n_coded, dtype=np.float64)
    pos = np.nonzero(mask)[0][:len(llrs)]
    full[pos] = llrs[:len(pos)]
    return full


def lich_encode(lsf_bytes: bytes, index: int) -> np.ndarray:
    """One LICH chunk: 5 LSF bytes + (index << 5) byte → 4 Golay(24,12) words
    = 96 bits (`encoder.rs:232-249`)."""
    chunk = list(lsf_bytes[5 * index:5 * index + 5]) + [index << 5]
    words = [(chunk[0] << 4) | (chunk[1] >> 4),
             ((chunk[1] & 0x0F) << 8) | chunk[2],
             (chunk[3] << 4) | (chunk[4] >> 4),
             ((chunk[4] & 0x0F) << 8) | chunk[5]]
    out = np.zeros(96, dtype=np.uint8)
    for i, w in enumerate(words):
        g = golay24_encode(w)
        out[24 * i:24 * (i + 1)] = [(g >> (23 - j)) & 1 for j in range(24)]
    return out


def lich_decode(bits: np.ndarray):
    """96 LICH bits → (index, 5 LSF bytes) or None if any Golay word fails."""
    words = []
    for i in range(4):
        w = 0
        for j in range(24):
            w = (w << 1) | int(bits[24 * i + j])
        d = golay24_decode(w)
        if d is None:
            return None
        words.append(d)
    chunk = [words[0] >> 4, ((words[0] & 0xF) << 4) | (words[1] >> 8),
             words[1] & 0xFF, words[2] >> 4,
             ((words[2] & 0xF) << 4) | (words[3] >> 8), words[3] & 0xFF]
    # byte 5 is (index << 5): a nonzero low field or index > 5 is not a LICH —
    # this also rejects correlation sidelobes that Golay "corrects" into garbage
    if chunk[5] & 0x1F or (chunk[5] >> 5) > 5:
        return None
    return chunk[5] >> 5, bytes(chunk[:5])
