"""LoRa bit-plane coding: whitening, Hamming, diagonal interleaver, Gray mapping,
header, CRC16.

Re-design of the reference LoRa example's coding blocks (``examples/lora/src/``:
``GrayMapping``, ``Deinterleaver``, ``HammingDecoder``, ``HeaderDecoder``, ``Decoder`` —
a port of gr-lora_sdr). Vectorized nibble-plane operations.

The port's copy of ``futuresdr_tpu/models/lora/coding.py``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["whiten", "dewhiten", "hamming_encode", "hamming_decode",
           "hamming_violations", "interleave_block", "deinterleave_block", "gray",
           "degray", "crc16", "build_header", "parse_header"]


# ---- whitening: LFSR-generated byte sequence (gr-lora_sdr whitening table role) ------
def _whitening_seq(n: int) -> np.ndarray:
    seq = np.empty(n, dtype=np.uint8)
    state = 0xFF
    for i in range(n):
        seq[i] = state
        # x^8 + x^6 + x^5 + x^4 + 1 Galois LFSR step
        fb = ((state >> 7) ^ (state >> 5) ^ (state >> 4) ^ (state >> 3)) & 1
        state = ((state << 1) | fb) & 0xFF
    return seq


def whiten(data: bytes) -> bytes:
    seq = _whitening_seq(len(data))
    return bytes(np.frombuffer(data, np.uint8) ^ seq)


dewhiten = whiten   # XOR is its own inverse


# ---- Hamming codes over nibbles (cr ∈ 1..4 → codeword length 4+cr) -------------------
def hamming_encode(nibbles: np.ndarray, cr: int) -> np.ndarray:
    """[n] nibbles → [n] codewords of (4+cr) bits packed LSB-first in a uint8."""
    d = nibbles.astype(np.uint8)
    d0, d1, d2, d3 = d & 1, (d >> 1) & 1, (d >> 2) & 1, (d >> 3) & 1
    p0 = d0 ^ d1 ^ d2          # Hamming(7,4) parities
    p1 = d0 ^ d1 ^ d3
    p2 = d0 ^ d2 ^ d3
    p3 = d0 ^ d1 ^ d2 ^ d3 ^ p0 ^ p1 ^ p2   # overall parity for (8,4)
    cw = d.copy()
    if cr >= 1:
        cw = cw | (p0 << 4)
    if cr >= 2:
        cw = cw | (p1 << 5)
    if cr >= 3:
        cw = cw | (p2 << 6)
    if cr >= 4:
        cw = cw | (p3 << 7)
    return cw


def hamming_decode(codewords: np.ndarray, cr: int) -> np.ndarray:
    """Decode (4+cr)-bit codewords; cr≥3 corrects single bit errors."""
    cw = codewords.astype(np.uint8)
    d = cw & 0x0F
    if cr < 3:
        return d           # detect-only rates: data bits pass through
    d0, d1, d2, d3 = d & 1, (d >> 1) & 1, (d >> 2) & 1, (d >> 3) & 1
    p0, p1, p2 = (cw >> 4) & 1, (cw >> 5) & 1, (cw >> 6) & 1
    s0 = p0 ^ d0 ^ d1 ^ d2
    s1 = p1 ^ d0 ^ d1 ^ d3
    s2 = p2 ^ d0 ^ d2 ^ d3
    syn = s0 | (s1 << 1) | (s2 << 2)
    # syndrome → flip position in data nibble (0 if parity-bit error / no error)
    # data bit coverage: d0 in all → syn 111; d1 → 011; d2 → 101; d3 → 110
    flip = np.zeros_like(d)
    flip = np.where(syn == 0b111, 1 << 0, flip)
    flip = np.where(syn == 0b011, 1 << 1, flip)
    flip = np.where(syn == 0b101, 1 << 2, flip)
    flip = np.where(syn == 0b110, 1 << 3, flip)
    return (d ^ flip).astype(np.uint8)


def hamming_violations(codewords: np.ndarray, cr: int) -> np.ndarray:
    """Per-codeword count of failed parity checks — the arbitration metric for the
    receiver's symbol-timing-drift tracking (a wrong integer bin offset scrambles the
    codewords and lights up the parities; the true offset satisfies them)."""
    cw = codewords.astype(np.uint8)
    d = cw & 0x0F
    d0, d1, d2, d3 = d & 1, (d >> 1) & 1, (d >> 2) & 1, (d >> 3) & 1
    v = np.zeros(len(cw), dtype=np.int64)
    if cr >= 1:
        v += (((cw >> 4) & 1) != (d0 ^ d1 ^ d2)).astype(np.int64)
    if cr >= 2:
        v += (((cw >> 5) & 1) != (d0 ^ d1 ^ d3)).astype(np.int64)
    if cr >= 3:
        v += (((cw >> 6) & 1) != (d0 ^ d2 ^ d3)).astype(np.int64)
    if cr >= 4:
        p0, p1, p2 = (cw >> 4) & 1, (cw >> 5) & 1, (cw >> 6) & 1
        v += (((cw >> 7) & 1) !=
              (d0 ^ d1 ^ d2 ^ d3 ^ p0 ^ p1 ^ p2)).astype(np.int64)
    return v


# ---- diagonal interleaver (gr-lora_sdr `interleaver`/`deinterleaver` role) -----------
def interleave_block(codewords: np.ndarray, sf_app: int, cr: int) -> np.ndarray:
    """[sf_app] codewords of (4+cr) bits → [4+cr] symbol values of sf_app bits.

    Bit (i, j) of the output symbol j is codeword (i + j) mod sf_app's bit i — the LoRa
    diagonal shift that spreads each codeword over all symbols of the block.
    """
    n_sym = 4 + cr
    assert len(codewords) == sf_app
    bits = (codewords[:, None] >> np.arange(n_sym)[None, :]) & 1     # [sf_app, 4+cr]
    out = np.zeros(n_sym, dtype=np.int64)
    for j in range(n_sym):
        for i in range(sf_app):
            out[j] |= int(bits[(i + j) % sf_app, j]) << i
    return out


def deinterleave_block(symbols: np.ndarray, sf_app: int, cr: int) -> np.ndarray:
    n_sym = 4 + cr
    assert len(symbols) == n_sym
    cw = np.zeros(sf_app, dtype=np.uint8)
    for j in range(n_sym):
        for i in range(sf_app):
            bit = (int(symbols[j]) >> i) & 1
            cw[(i + j) % sf_app] |= bit << j
    return cw


# ---- Gray mapping (gr-lora_sdr `gray_mapping`/`gray_demap`) --------------------------
def gray(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.int64)
    return x ^ (x >> 1)


def degray(g: np.ndarray) -> np.ndarray:
    out = np.asarray(g, dtype=np.int64).copy()
    shift = 1
    while shift < 32:          # prefix-XOR inverse of the Gray map
        out ^= out >> shift
        shift <<= 1
    return out


# ---- CRC16 (CCITT, as LoRa payload CRC) ----------------------------------------------
def crc16(data: bytes, init: int = 0x0000) -> int:
    crc = init
    for byte in data:
        crc ^= byte << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


# ---- explicit header (gr-lora_sdr `header`/`header_decoder` role) --------------------
def build_header(length: int, cr: int, has_crc: bool) -> np.ndarray:
    """5 nibbles: len_hi, len_lo, flags(cr|crc), checksum (2 nibbles)."""
    n0 = (length >> 4) & 0xF
    n1 = length & 0xF
    n2 = ((cr & 0x7) << 1) | (1 if has_crc else 0)
    c4 = ((n0 >> 3) ^ (n0 >> 2) ^ (n0 >> 1) ^ n0) & 1
    c3 = ((n0 >> 3) ^ (n1 >> 3) ^ (n1 >> 2) ^ (n1 >> 1) ^ n2) & 1
    c2 = ((n0 >> 2) ^ (n1 >> 3) ^ n1 ^ (n2 >> 3) ^ (n2 >> 1)) & 1
    c1 = ((n0 >> 1) ^ (n1 >> 2) ^ n1 ^ (n2 >> 2) ^ (n2 >> 1) ^ n2) & 1
    c0 = (n0 ^ (n1 >> 1) ^ (n2 >> 3) ^ (n2 >> 2) ^ (n2 >> 1) ^ n2) & 1
    n3 = c4
    n4 = (c3 << 3) | (c2 << 2) | (c1 << 1) | c0
    return np.array([n0, n1, n2, n3, n4], dtype=np.uint8)


def parse_header(nibbles: np.ndarray):
    """Returns (length, cr, has_crc) or None on checksum failure."""
    ref = build_header(((int(nibbles[0]) << 4) | int(nibbles[1])),
                       (int(nibbles[2]) >> 1) & 0x7, bool(nibbles[2] & 1))
    if not np.array_equal(ref[3:5] & 0xF, np.asarray(nibbles[3:5]) & 0xF):
        return None
    length = (int(nibbles[0]) << 4) | int(nibbles[1])
    cr = (int(nibbles[2]) >> 1) & 0x7
    has_crc = bool(nibbles[2] & 1)
    return length, cr, has_crc
