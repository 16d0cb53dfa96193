"""802.11a OFDM symbol processing: mapping, modulation, synchronization, equalization.

The port's copy of ``futuresdr_tpu/models/wlan/ofdm.py`` (host numpy): the
reference WLAN example's ``Mapper``/``Prefix``/``SyncShort``/``SyncLong``/
``FrameEqualizer`` blocks (``examples/wlan/src/``), frame-level and vectorized
(batched FFTs over all OFDM symbols at once). The device twin of the RX
demod is ``torch_demod.py``.
"""

from __future__ import annotations

import numpy as np

from .consts import (CP_LEN, DATA_CARRIERS, FFT_SIZE, LTS_FREQ, MODULATION_TABLES,
                     PILOT_CARRIERS, PILOT_POLARITY, PILOT_VALUES,
                     SYM_LEN, lts_time, sts_time)

__all__ = ["map_bits", "demap_llrs", "ofdm_modulate", "ofdm_demodulate_symbols",
           "make_preamble", "detect_packets", "sync_long", "estimate_channel",
           "equalize"]


def map_bits(bits: np.ndarray, modulation: str) -> np.ndarray:
    """Gray-coded constellation mapping; bits LSB-first per symbol."""
    table = MODULATION_TABLES[modulation]
    n_bpsc = int(np.log2(len(table)))
    groups = bits.reshape(-1, n_bpsc)
    idx = (groups * (1 << np.arange(n_bpsc))).sum(axis=1)
    return table[idx]


def demap_llrs(symbols: np.ndarray, modulation: str) -> np.ndarray:
    """Max-log soft demapping: LLR per bit, positive ⇒ bit 1. BPSK/QPSK use the
    closed-form max-log expressions; higher orders the vectorized distance matrix
    (64-point table — MXU-shaped on the TPU path)."""
    if modulation == "bpsk":
        return 4.0 * symbols.real
    if modulation == "qpsk":
        a = 4.0 / np.sqrt(2)
        out = np.empty((len(symbols), 2))
        out[:, 0] = a * symbols.real
        out[:, 1] = a * symbols.imag
        return out.reshape(-1)
    table = MODULATION_TABLES[modulation]
    n_bpsc = int(np.log2(len(table)))
    d = -np.abs(symbols[:, None] - table[None, :]) ** 2    # [n, M] log-likelihoods
    llrs = np.empty((len(symbols), n_bpsc))
    idx = np.arange(len(table))
    for b in range(n_bpsc):
        one = (idx >> b) & 1 == 1
        llrs[:, b] = d[:, one].max(axis=1) - d[:, ~one].max(axis=1)
    return llrs.reshape(-1)


def _carriers_to_spec(data_vals: np.ndarray, pilot_vals: np.ndarray) -> np.ndarray:
    """[n_sym, 48] data + [n_sym, 4] pilots → [n_sym, 64] spectra."""
    n_sym = data_vals.shape[0]
    spec = np.zeros((n_sym, FFT_SIZE), dtype=np.complex128)
    spec[:, DATA_CARRIERS % FFT_SIZE] = data_vals
    spec[:, PILOT_CARRIERS % FFT_SIZE] = pilot_vals
    return spec


def ofdm_modulate(data_symbols: np.ndarray, symbol_offset: int = 0) -> np.ndarray:
    """[n_sym, 48] constellation points → time samples with CP (batched IFFT).

    ``symbol_offset`` indexes the pilot-polarity sequence (0 = SIGNAL symbol).
    """
    n_sym = data_symbols.shape[0]
    pol = PILOT_POLARITY[(symbol_offset + np.arange(n_sym)) % len(PILOT_POLARITY)]
    pilots = PILOT_VALUES[None, :] * pol[:, None]
    spec = _carriers_to_spec(data_symbols, pilots)
    t = np.fft.ifft(spec, axis=1)
    with_cp = np.concatenate([t[:, -CP_LEN:], t], axis=1)     # [n_sym, 80]
    return with_cp.reshape(-1).astype(np.complex64)


def make_preamble() -> np.ndarray:
    """STS (160) + LTS (160) samples."""
    return np.concatenate([sts_time(), lts_time()])


def ofdm_demodulate_symbols(samples: np.ndarray, n_sym: int) -> np.ndarray:
    """Strip CPs and batch-FFT ``n_sym`` symbols: [n_sym, 64] spectra."""
    s = samples[:n_sym * SYM_LEN].reshape(n_sym, SYM_LEN)[:, CP_LEN:]
    return np.fft.fft(s, axis=1)


def detect_packets(samples: np.ndarray, threshold: float = 0.56,
                   min_run: int = 32) -> list:
    """Short-preamble detection via 16-lag autocorrelation plateau
    (`sync_short.rs` algorithm: |Σ x[n]·x*[n+16]| / Σ|x|² over a window)."""
    n = len(samples)
    if n < 160:
        return []
    prod = samples[:-16] * np.conj(samples[16:])
    corr = np.cumsum(prod)
    win = 48
    c = np.abs(corr[win:] - corr[:-win])
    power = np.cumsum(np.abs(samples) ** 2)
    p = power[win:len(c) + win] - power[:len(c)]
    metric = c / np.maximum(p, 1e-12)
    # suppress noise-only windows: the ratio is meaningless where there is no power
    floor = 1e-4 * float(p.max()) if len(p) else 0.0
    above = (metric > threshold) & (p > floor)
    # vectorized run-length extraction; only a QUALIFYING run consumes the preamble
    # span, so short spurious crossings never eat into a following plateau
    padded = np.concatenate([[False], above, [False]])
    d = np.diff(padded.astype(np.int8))
    run_starts = np.flatnonzero(d == 1)
    run_ends = np.flatnonzero(d == -1)
    starts = []
    skip_until = -1
    for s, e in zip(run_starts, run_ends):
        s = max(int(s), skip_until)     # a run extending past a skip window still counts
        if e - s >= min_run:
            starts.append(s)
            skip_until = int(e) + 160
    return starts


def sync_long(samples: np.ndarray, search_start: int, search_len: int = 320 + 224):
    """Fine timing via cross-correlation with the known LTS symbol; returns the index
    of the first data (SIGNAL) symbol and the coarse+fine CFO estimate
    (`sync_long.rs` role).

    The window must reach past BOTH LTS symbols even when detection fires early
    (the STS autocorrelation plateau can trigger ~100+ samples before the burst);
    a too-short window truncates the LTS2 peak and the cyclic-prefix ghost (64
    samples before LTS1, same spacing) wins the pairing — a deterministic
    64-sample mislock whose garbage SIGNAL can still pass parity."""
    lts = lts_time()
    ref = lts[32 + 64:32 + 128]            # one clean long symbol
    seg = samples[search_start:search_start + search_len]
    if len(seg) < 160:
        return None
    corr = np.correlate(seg, ref, mode="valid")
    mag = np.abs(corr)
    # the two LTS symbols give the two strongest peaks, 64 apart
    p1 = int(np.argmax(mag))
    mag2 = mag.copy()
    lo, hi = max(0, p1 - 8), min(len(mag2), p1 + 8)
    mag2[lo:hi] = 0
    p2 = int(np.argmax(mag2))
    first, second = sorted((p1, p2))
    if second - first != 64:
        # fall back: assume exact structure from the stronger peak
        first = p1 - 64 if p1 >= 64 and mag[p1 - 64] > 0.5 * mag[p1] else p1
        second = first + 64
    # CP-ghost guard: the pair (ghost, LTS1) is also 64 apart — if another
    # strong peak sits 64 AFTER `second`, the true pair is one symbol later
    while second + 64 < len(mag) and \
            mag[second + 64] > 0.8 * max(mag[first], 1e-12):
        first, second = second, second + 64
    # CFO from phase drift between the two long symbols
    a = seg[first:first + 64]
    b = seg[second:second + 64]
    if len(a) < 64 or len(b) < 64:
        return None                    # truncated at the stream edge
    cfo = np.angle(np.vdot(a, b)) / 64.0
    data_start = search_start + second + 64
    lts_start = search_start + first
    return data_start, lts_start, cfo


def estimate_channel(samples: np.ndarray, lts_start: int) -> np.ndarray:
    """Average the two LTS symbols and divide by the known sequence → H[64]."""
    s1 = np.fft.fft(samples[lts_start:lts_start + 64])
    s2 = np.fft.fft(samples[lts_start + 64:lts_start + 128])
    from .consts import carriers_to_grid
    ref = carriers_to_grid(LTS_FREQ)
    avg = (s1 + s2) / 2.0
    H = np.ones(FFT_SIZE, dtype=np.complex128)
    used = ref != 0
    H[used] = avg[used] / ref[used]
    return H


def equalize(spectra: np.ndarray, H: np.ndarray, symbol_offset: int = 0,
             algorithm: str = "ls") -> np.ndarray:
    """Channel equalization + residual common-phase-error correction from the four
    pilots (`frame_equalizer.rs` role; algorithms as in gr-ieee802-11's equalizer
    options). Returns [n_sym, 48] data-carrier symbols.

    - ``ls``: zero-forcing with the LTS least-squares estimate (static channel).
    - ``sta``: spectral-temporal averaging — the channel estimate is refined each
      symbol from the pilot observations, smoothed across adjacent subcarriers;
      tracks slow channel drift.
    """
    n_sym = spectra.shape[0]
    pol = PILOT_POLARITY[(symbol_offset + np.arange(n_sym)) % len(PILOT_POLARITY)]
    expected = PILOT_VALUES[None, :] * pol[:, None]
    p_idx = PILOT_CARRIERS % FFT_SIZE
    if algorithm == "ls":
        eq = spectra / H[None, :]
        pilots = eq[:, p_idx]
        cpe = np.angle((pilots * np.conj(expected)).sum(axis=1))
        eq = eq * np.exp(-1j * cpe)[:, None]
        return eq[:, DATA_CARRIERS % FFT_SIZE]
    if algorithm != "sta":
        raise ValueError(f"unknown equalizer algorithm {algorithm!r}")
    # STA: per-symbol pilot-driven channel refresh with subcarrier smoothing
    alpha = 0.5
    Ht = H.copy()
    out = np.empty((n_sym, len(DATA_CARRIERS)), dtype=np.complex128)
    used = np.sort(np.concatenate([DATA_CARRIERS, PILOT_CARRIERS])) % FFT_SIZE
    for s in range(n_sym):
        eq_s = spectra[s] / Ht
        pilots = eq_s[p_idx]
        cpe = np.angle((pilots * np.conj(expected[s])).sum())
        eq_s = eq_s * np.exp(-1j * cpe)
        # refresh: observed pilot channel (post-CPE), interpolated over used carriers
        obs = spectra[s, p_idx] * np.exp(-1j * cpe) / expected[s]
        upd = np.interp(used, p_idx[np.argsort(p_idx)],
                        obs[np.argsort(p_idx)].real) \
            + 1j * np.interp(used, p_idx[np.argsort(p_idx)],
                             obs[np.argsort(p_idx)].imag)
        Ht[used] = (1 - alpha) * Ht[used] + alpha * upd
        out[s] = eq_s[DATA_CARRIERS % FFT_SIZE]
    return out
