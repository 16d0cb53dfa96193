"""802.11 bit-plane coding: scrambler, K=7 convolutional code, puncturing, interleaving,
and a soft Viterbi decoder.

The port's copy of ``futuresdr_tpu/models/wlan/coding.py`` (the reference WLAN
example's ``Encoder`` and ``ViterbiDecoder``, ``examples/wlan/src/{encoder,
viterbi_decoder}.rs``). :func:`viterbi_decode` is a host route: the C++ ACS
loop (``csrc/host/viterbi.cpp``, built with ``g++`` on first use), else the
numpy trellis vectorized over the 64 states. The batched device decoder is
``ops/viterbi.py`` (the ACS recursion as a hand kernel), asked for by name.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ...log import logger

__all__ = ["scramble", "descramble", "conv_encode", "puncture", "depuncture",
           "interleave", "deinterleave", "viterbi_decode"]

# generator polynomials g0=133_o, g1=171_o (Clause 17.3.5.6)
_G0, _G1 = 0o133, 0o171
_K = 7
_NSTATES = 64


_KEYSTREAM_CACHE: dict = {}


def _keystream(seed: int) -> np.ndarray:
    """The x^7+x^4+1 additive scrambler's output is a 127-periodic keystream fully
    determined by the seed — precompute once and tile (vectorized scrambling)."""
    ks = _KEYSTREAM_CACHE.get(seed)
    if ks is None:
        out = np.empty(127, dtype=np.uint8)
        state = seed & 0x7F
        for i in range(127):
            fb = ((state >> 6) ^ (state >> 3)) & 1
            out[i] = fb
            state = ((state << 1) | fb) & 0x7F
        ks = out
        _KEYSTREAM_CACHE[seed] = ks
    return ks


def scramble(bits: np.ndarray, seed: int = 0b1011101) -> np.ndarray:
    """Additive scrambler x^7 + x^4 + 1 (Clause 17.3.5.5), keystream-vectorized."""
    ks = _keystream(seed)
    reps = -(-len(bits) // 127)
    return (bits ^ np.tile(ks, reps)[:len(bits)]).astype(np.uint8)


def descramble(bits: np.ndarray, seed: int = 0b1011101) -> np.ndarray:
    """Descrambling is the same operation (additive scrambler)."""
    return scramble(bits, seed)


# precomputed encoder output tables: for (state, input) → 2 output bits
_OUT0 = np.zeros((_NSTATES, 2), dtype=np.uint8)
_OUT1 = np.zeros((_NSTATES, 2), dtype=np.uint8)
_NEXT = np.zeros((_NSTATES, 2), dtype=np.int64)
for s in range(_NSTATES):
    for b in range(2):
        reg = (b << 6) | s            # shift register: newest bit at MSB
        _OUT0[s, b] = bin(reg & _G0).count("1") & 1
        _OUT1[s, b] = bin(reg & _G1).count("1") & 1
        _NEXT[s, b] = reg >> 1


# generator taps as convolution kernels (newest input at the shift-register MSB, so
# the kernel is the generator's bits reversed)
_G0_KERNEL = np.array([(_G0 >> (6 - j)) & 1 for j in range(7)], dtype=np.uint8)
_G1_KERNEL = np.array([(_G1 >> (6 - j)) & 1 for j in range(7)], dtype=np.uint8)


def conv_encode(bits: np.ndarray) -> np.ndarray:
    """Rate-1/2 convolutional encode; output interleaved [a0, b0, a1, b1, …].

    Convolutional coding IS a GF(2) convolution — one vectorized ``np.convolve`` per
    generator instead of the reference's per-bit shift-register loop."""
    bits = np.asarray(bits, dtype=np.uint8)
    a = np.convolve(bits, _G0_KERNEL)[:len(bits)] & 1
    b = np.convolve(bits, _G1_KERNEL)[:len(bits)] & 1
    out = np.empty(2 * len(bits), dtype=np.uint8)
    out[0::2] = a
    out[1::2] = b
    return out


_PUNCTURE = {
    "1/2": np.array([1, 1], dtype=bool),
    "2/3": np.array([1, 1, 1, 0], dtype=bool),
    "3/4": np.array([1, 1, 1, 0, 0, 1], dtype=bool),
}


def puncture(coded: np.ndarray, rate: str) -> np.ndarray:
    pat = _PUNCTURE[rate]
    mask = np.resize(pat, len(coded))
    return coded[mask]


def depuncture(llrs: np.ndarray, rate: str) -> np.ndarray:
    """Re-insert zero-LLR erasures at the punctured positions."""
    pat = _PUNCTURE[rate]
    per_block = int(pat.sum())
    n_blocks = -(-len(llrs) // per_block)
    mask = np.tile(pat, n_blocks)
    full = np.zeros(len(mask), dtype=np.float64)
    pos = np.nonzero(mask)[0][:len(llrs)]
    full[pos] = llrs
    return full[:2 * (len(full) // 2)]


_PERM_CACHE: dict = {}


def _interleaver_perms(n_cbps: int, n_bpsc: int):
    key = (n_cbps, n_bpsc)
    if key not in _PERM_CACHE:
        s = max(n_bpsc // 2, 1)
        k = np.arange(n_cbps)
        i = (n_cbps // 16) * (k % 16) + k // 16
        j = s * (i // s) + (i + n_cbps - (16 * i // n_cbps)) % s
        perm = np.empty(n_cbps, dtype=np.int64)
        perm[j] = k              # output position j takes input bit k
        _PERM_CACHE[key] = (perm, j)
    return _PERM_CACHE[key]


def interleave(bits: np.ndarray, n_cbps: int, n_bpsc: int) -> np.ndarray:
    """Two-permutation block interleaver (Clause 17.3.5.7), vectorized over all
    OFDM symbols at once."""
    perm, _ = _interleaver_perms(n_cbps, n_bpsc)
    return bits.reshape(-1, n_cbps)[:, perm].reshape(-1)


def deinterleave(vals: np.ndarray, n_cbps: int, n_bpsc: int) -> np.ndarray:
    _, j = _interleaver_perms(n_cbps, n_bpsc)
    out = np.empty_like(vals.reshape(-1, n_cbps))
    out[:, :] = vals.reshape(-1, n_cbps)[:, j]
    # out[blk, k] = vals[blk, j[k]] gives position k the bit that interleaving put at j[k]
    return out.reshape(-1)


# predecessor tables: for next-state t, the two (prev_state, input) candidates, plus
# the corresponding ±1 branch outputs — shared by the numpy and lax.scan decoders
def _build_prev_tables():
    prev_tbl = [[] for _ in range(_NSTATES)]
    for s in range(_NSTATES):
        for b in range(2):
            prev_tbl[_NEXT[s, b]].append((s, b))
    prev_s = np.array([[p[0][0], p[1][0]] for p in prev_tbl])   # [64, 2]
    prev_b = np.array([[p[0][1], p[1][1]] for p in prev_tbl])   # [64, 2]
    o0 = _OUT0.astype(np.float64) * 2 - 1
    o1 = _OUT1.astype(np.float64) * 2 - 1
    return prev_s, prev_b, o0[prev_s, prev_b], o1[prev_s, prev_b]


_PREV_S, _PREV_B, _BM0, _BM1 = _build_prev_tables()

log = logger("models.wlan.coding")

_NATIVE = None      # 0 = unavailable, PyDLL = ready
_native_lock = threading.Lock()


def _native_lib():
    """The C++ ACS loop (``csrc/host/viterbi.cpp``), built by
    ``ops/_build.load_host`` on first use; None where ``FSDR_NO_NATIVE=1`` asks
    for numpy, or (after one logged warning) where it cannot build or load."""
    global _NATIVE
    if os.environ.get("FSDR_NO_NATIVE"):
        return None
    with _native_lock:
        if _NATIVE is None:
            from ...ops import _build
            try:
                lib = _build.load_host("viterbi")
            except (OSError, RuntimeError) as e:
                log.warning("the Viterbi library did not build (%r): viterbi_decode "
                            "uses the numpy trellis", e)
                _NATIVE = 0
            else:
                lib.fsdr_viterbi_k7.argtypes = [ctypes.POINTER(ctypes.c_double),
                                                ctypes.c_int64,
                                                ctypes.POINTER(ctypes.c_uint8)]
                lib.fsdr_viterbi_k7.restype = ctypes.c_int
                _NATIVE = lib
    return _NATIVE or None


def viterbi_decode(llrs: np.ndarray, n_bits: int) -> np.ndarray:
    """Soft-decision Viterbi over the rate-1/2 mother code, on the host.

    ``llrs``: soft values for coded bits (positive ⇒ bit 1), length ≥ 2·n_bits.
    Terminated trellis (encoder assumed flushed with ≥6 tail zeros within n_bits).
    The C++ ACS loop where its library is built (bit-identical to the numpy
    trellis; ``FSDR_NO_NATIVE=1`` disables it), else the numpy trellis. The
    device decoder is ``ops/viterbi.py``'s ``scan_viterbi``.
    """
    n_steps = min(len(llrs) // 2, n_bits)
    lib = _native_lib()
    if lib is not None and n_steps > 0:
        lam = np.ascontiguousarray(llrs[:2 * n_steps], dtype=np.float64)
        out = np.empty(n_steps, dtype=np.uint8)
        rc = lib.fsdr_viterbi_k7(
            lam.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.c_int64(n_steps),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc == 0:
            return out[:n_bits]
    lam = llrs[:2 * n_steps].reshape(n_steps, 2).astype(np.float64)
    metrics = np.full(_NSTATES, -1e18)
    metrics[0] = 0.0
    decisions = np.empty((n_steps, _NSTATES), dtype=np.uint8)
    src = np.empty((n_steps, _NSTATES), dtype=np.int64)
    for t in range(n_steps):
        cand = metrics[_PREV_S] + _BM0 * lam[t, 0] + _BM1 * lam[t, 1]   # [64, 2]
        choice = np.argmax(cand, axis=1)
        metrics = cand[np.arange(_NSTATES), choice]
        src[t] = _PREV_S[np.arange(_NSTATES), choice]
        decisions[t] = _PREV_B[np.arange(_NSTATES), choice]

    # traceback from state 0 (the tail bits flush the trellis to state 0)
    state = 0
    out = np.empty(n_steps, dtype=np.uint8)
    for t in range(n_steps - 1, -1, -1):
        out[t] = decisions[t, state]
        state = src[t, state]
    return out[:n_bits]
