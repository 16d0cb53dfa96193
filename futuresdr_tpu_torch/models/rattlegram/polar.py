"""Systematic polar code (N=2048) with list-32 successive-cancellation decoding.

Parity target: the aicodix payload code used by the reference's
``examples/rattlegram/src/polar.rs`` — a CRC32-aided systematic polar code at three
rates (frozen-set tables for 712/1056/1392 information bits), decoded by an SCL decoder
whose 32 list lanes are carried through saturating int8 lane vectors with explicit path
permutation "maps" at every rate-1 fork.

Re-design notes: the reference vectorizes lanes with i8x32 SIMD intrinsics unrolled per
tree level; here every node op is a numpy array op over the ``[…, 32]`` lane axis, and
the encoder's butterfly network is expressed as reshape-broadcast products over the full
codeword (the encoder is pure ±1 arithmetic). The port's copy of
``futuresdr_tpu/models/rattlegram/polar.py``.

Frozen-set tables are waveform spec constants (`util.rs:73-105`).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .fec import crc32_rattlegram, crc32_bits, bytes_to_le_bits, le_bits_to_bytes

__all__ = ["CODE_ORDER", "CODE_LEN", "LIST_LEN", "FROZEN_2048_712", "FROZEN_2048_1056",
           "FROZEN_2048_1392", "frozen_mask", "polar_encode", "polar_decode"]

CODE_ORDER = 11
CODE_LEN = 1 << CODE_ORDER
LIST_LEN = 32
MAX_BITS = 1360 + 32

FROZEN_2048_1392 = np.array([
    0xffffffff, 0xffffffff, 0xffffffff, 0xffffffff, 0xffffffff, 0xffffffff, 0x7fffffff,
    0x11f7fff, 0xffffffff, 0x7fffffff, 0x17ffffff, 0x117177f, 0x177f7fff, 0x1037f,
    0x1011f, 0x1, 0xffffffff, 0x177fffff, 0x77f7fff, 0x1011f, 0x1173fff, 0x10117,
    0x10117, 0x0, 0x117177f, 0x17, 0x3, 0x0, 0x1, 0x0, 0x0, 0x0, 0x7fffffff, 0x11f7fff,
    0x11717ff, 0x117, 0x17177f, 0x3, 0x1, 0x0, 0x1037f, 0x1, 0x1, 0x0, 0x1, 0x0, 0x0,
    0x0, 0x1011f, 0x1, 0x1, 0x0, 0x1, 0x0, 0x0, 0x0, 0x1, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0,
    0x0], np.uint64)

FROZEN_2048_1056 = np.array([
    0xffffffff, 0xffffffff, 0xffffffff, 0xffffffff, 0xffffffff, 0xffffffff, 0xffffffff,
    0x7fffffff, 0xffffffff, 0xffffffff, 0xffffffff, 0x7fffffff, 0xffffffff, 0x177fffff,
    0x177f7fff, 0x1017f, 0xffffffff, 0xffffffff, 0xffffffff, 0x177f7fff, 0x7fffffff,
    0x13f7fff, 0x1171fff, 0x117, 0x3fffffff, 0x11717ff, 0x7177f, 0x1, 0x1017f, 0x1, 0x1,
    0x0, 0xffffffff, 0x7fffffff, 0x7fffffff, 0x1171fff, 0x17ffffff, 0x7177f, 0x1037f,
    0x1, 0x77f7fff, 0x1013f, 0x10117, 0x1, 0x10117, 0x0, 0x0, 0x0, 0x1173fff, 0x10117,
    0x117, 0x0, 0x7, 0x0, 0x0, 0x0, 0x1, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0, 0x0], np.uint64)

FROZEN_2048_712 = np.array([
    0xffffffff, 0xffffffff, 0xffffffff, 0xffffffff, 0xffffffff, 0xffffffff, 0xffffffff,
    0xffffffff, 0xffffffff, 0xffffffff, 0xffffffff, 0xffffffff, 0xffffffff, 0xffffffff,
    0xffffffff, 0x177fffff, 0xffffffff, 0xffffffff, 0xffffffff, 0xffffffff, 0xffffffff,
    0xffffffff, 0x7fffffff, 0x11f7fff, 0xffffffff, 0x7fffffff, 0x1fffffff, 0x17177f,
    0x177fffff, 0x1037f, 0x1011f, 0x1, 0xffffffff, 0xffffffff, 0xffffffff, 0x7fffffff,
    0xffffffff, 0x1fffffff, 0x177fffff, 0x1077f, 0xffffffff, 0x177f7fff, 0x13f7fff,
    0x10117, 0x1171fff, 0x117, 0x7, 0x0, 0x7fffffff, 0x1173fff, 0x11717ff, 0x7, 0x3077f,
    0x1, 0x1, 0x0, 0x1013f, 0x1, 0x1, 0x0, 0x1, 0x0, 0x0, 0x0], np.uint64)

FROZEN_BY_DATA_BITS = {1360: FROZEN_2048_1392, 1024: FROZEN_2048_1056,
                       680: FROZEN_2048_712}


def frozen_mask(words: np.ndarray) -> np.ndarray:
    """u32-word frozen table → [CODE_LEN] uint8 mask (bit i = word i//32 bit i%32)."""
    bits = ((words[:, None].astype(np.uint64) >> np.arange(32)[None, :].astype(np.uint64))
            & 1).astype(np.uint8)
    return bits.reshape(-1)[:CODE_LEN]


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _butterfly(c: np.ndarray) -> np.ndarray:
    """Full polar transform in the ±1 domain: c[j] *= c[j+h] for h = 1, 2, …, N/2."""
    n = c.shape[0]
    h = 1
    while h < n:
        c = c.reshape(-1, 2 * h, *c.shape[1:])
        c[:, :h] *= c[:, h:2 * h]
        c = c.reshape(n, *c.shape[2:])
        h *= 2
    return c


def polar_encode(message: bytes, data_bits: int,
                 frozen: Optional[np.ndarray] = None) -> np.ndarray:
    """Systematic encode: message bytes (LSB-first bits) + CRC32 → ±1 int8 codeword.

    Two freeze-transform passes: in the ±1 domain the polar transform G satisfies
    G·G = I over GF(2), so transform → re-freeze → transform lands the information
    bits at the non-frozen codeword positions (`polar.rs:74-137`).
    """
    if frozen is None:
        frozen = FROZEN_BY_DATA_BITS[data_bits]
    mask = frozen_mask(np.asarray(frozen))
    n_info = int((1 - mask).sum())
    assert data_bits + 32 <= n_info <= MAX_BITS + (n_info - data_bits - 32)

    bits = bytes_to_le_bits(message, data_bits)
    crc = crc32_rattlegram(message[:data_bits // 8])
    crc_bits_arr = ((crc >> np.arange(32)) & 1).astype(np.uint8)
    mesg = np.concatenate([bits, crc_bits_arr])
    nrz = np.where(mesg > 0, -1, 1).astype(np.int8)

    v = np.ones(CODE_LEN, np.int8)
    info_pos = np.nonzero(mask == 0)[0]
    v[info_pos[:len(nrz)]] = nrz
    c = _butterfly(v)
    c = np.where(mask > 0, np.int8(1), c)
    return _butterfly(c)


# ---------------------------------------------------------------------------
# list decoder — saturating int8 lane vectors, [32] lane axis
# ---------------------------------------------------------------------------

def _qclip(a: np.ndarray) -> np.ndarray:
    return np.clip(a, -128, 127).astype(np.int8)


def _vqabs(a: np.ndarray) -> np.ndarray:
    return np.clip(np.abs(a.astype(np.int16)), 0, 127).astype(np.int8)


def _vsign(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.where(b > 0, a, np.where(b == 0, np.int8(0), _qclip(-a.astype(np.int16))))


def _prod(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """min-sum box-product: sign(a)·sign(b)·min(|a|, |b|), saturating."""
    return _vsign(np.minimum(_vqabs(a), _vqabs(b)),
                  _vsign(np.sign(a).astype(np.int8), b))


def _madd(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """hard-feedback add: clip(sign(a)·max(b, −127) + c)."""
    return _qclip(_vsign(np.maximum(b, np.int8(-127)), a).astype(np.int16)
                  + c.astype(np.int16))


def _qmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return _qclip(a.astype(np.int16) * b.astype(np.int16))


class _ListState:
    """Decoder workspace: soft[2N, 32], hard[N, 32], path metrics, fork maps."""

    def __init__(self, code: np.ndarray):
        n = CODE_LEN
        self.soft = np.zeros((2 * n, LIST_LEN), np.int8)
        self.soft[n:2 * n] = np.asarray(code, np.int8)[:, None]
        self.hard = np.zeros((n, LIST_LEN), np.int8)
        self.metric = np.full(LIST_LEN, 1000, np.int64)
        self.metric[0] = 0
        self.message: List[np.ndarray] = []    # one ±1 [32] lane vector per info bit
        self.maps: List[np.ndarray] = []       # the fork permutation at that bit


def _rate0(st: _ListState, hard_off: int, n: int) -> np.ndarray:
    """All-frozen subtree: hard = +1, penalize negative softs, identity map."""
    st.hard[hard_off:hard_off + n] = 1
    s = st.soft[n:2 * n].astype(np.int64)
    st.metric -= np.where(s < 0, s, 0).sum(axis=0)
    return np.arange(LIST_LEN, dtype=np.uint8)


def _rate1_leaf(st: _ListState, hard_off: int) -> np.ndarray:
    """Information leaf: fork every path on bit 0/1, keep the 32 best by metric."""
    sft = st.soft[1].astype(np.int64)
    fork = np.concatenate([st.metric, st.metric])
    fork[:LIST_LEN] -= np.where(sft < 0, sft, 0)
    fork[LIST_LEN:] += np.where(sft >= 0, sft, 0)
    perm = np.argsort(fork, kind="stable")[:LIST_LEN]
    st.metric = fork[perm]
    fmap = (perm % LIST_LEN).astype(np.uint8)
    hrd = np.where(perm < LIST_LEN, 1, -1).astype(np.int8)
    st.message.append(hrd)
    st.maps.append(fmap)
    st.hard[hard_off] = hrd
    return fmap


def _decode_node(st: _ListState, m: int, hard_off: int, frozen: np.ndarray) -> np.ndarray:
    """SC tree node over subtree size 2^m; returns the accumulated lane map.

    soft layout matches the reference: the level-m input lives at soft[n:2n]; children
    consume soft[n/2:n]. Rate-0 shortcut applies to all-frozen subtrees of size ≤ 32
    (the reference's unrolled decode_1..6 check halves at those levels only — larger
    all-frozen subtrees recurse, which matters for metric equivalence).
    """
    n = 1 << m
    if m == 0:
        if frozen[0]:
            return _rate0(st, hard_off, 1)
        return _rate1_leaf(st, hard_off)
    if m <= 5 and frozen.all():
        return _rate0(st, hard_off, n)

    h = n // 2
    st.soft[h:n] = _prod(st.soft[n:n + h], st.soft[n + h:2 * n])
    lmap = _decode_node(st, m - 1, hard_off, frozen[:h])
    st.soft[h:n] = _madd(st.hard[hard_off:hard_off + h],
                         st.soft[n:n + h][:, lmap],
                         st.soft[n + h:2 * n][:, lmap])
    rmap = _decode_node(st, m - 1, hard_off + h, frozen[h:])
    st.hard[hard_off:hard_off + h] = _qmul(
        st.hard[hard_off:hard_off + h][:, rmap], st.hard[hard_off + h:hard_off + n])
    return lmap[rmap]


def _list_decode(code: np.ndarray, mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (metric[32], mesg[count, 32] ±1) with lanes aligned to final paths."""
    st = _ListState(code)
    _decode_node(st, CODE_ORDER, 0, mask)
    count = len(st.message)
    mesg = np.stack(st.message)                  # [count, 32]
    acc = st.maps[count - 1]
    for i in range(count - 2, -1, -1):
        mesg[i] = mesg[i][acc]
        acc = st.maps[i][acc]
    return st.metric, mesg


def polar_decode(code_soft: np.ndarray, data_bits: int,
                 frozen: Optional[np.ndarray] = None) -> Tuple[Optional[bytes], int]:
    """List-decode ± soft codeword → (message bytes, bit-flip count) or (None, -1).

    CRC32 selects among the 32 surviving paths in metric order; the flip count vs the
    received hard decisions is the reported channel-error estimate (`polar.rs:186-253`).
    """
    if frozen is None:
        frozen = FROZEN_BY_DATA_BITS[data_bits]
    mask = frozen_mask(np.asarray(frozen))
    crc_bits = data_bits + 32
    code_soft = np.asarray(code_soft, np.int8)

    metric, mesg = _list_decode(code_soft, mask)

    # systematic re-encode: one freeze+butterfly pass over the ±1 lane vectors
    info_pos = np.nonzero(mask == 0)[0]
    full = np.ones((CODE_LEN, LIST_LEN), np.int8)
    full[info_pos[:mesg.shape[0]]] = mesg
    mess = _butterfly(full)
    mesg_sys = mess[info_pos[:crc_bits]]

    order = np.argsort(metric, kind="stable")
    best = -1
    for lane in order:
        bits = (mesg_sys[:, lane] < 0).astype(np.uint8)
        if crc32_bits(bits) == 0:
            best = int(lane)
            break
    if best < 0:
        return None, -1

    decoded = (mesg_sys[:data_bits, best] < 0).astype(np.uint8)
    received = (code_soft[info_pos[:data_bits]] < 0).astype(np.uint8)
    flips = int((decoded != received).sum())
    return le_bits_to_bytes(decoded), flips
