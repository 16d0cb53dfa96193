"""ADS-B / Mode S 1090ES: PPM modulation, preamble detection, demodulation.

Re-design of the reference ADS-B example (``examples/adsb/src/``: ``PreambleDetector``,
``Demodulator``): pulse-position modulation at 1 Mb/s, preamble pulses at 0/1/3.5/4.5 µs,
56- or 112-bit Mode S frames, processed on the magnitude stream at 2 Msps.
The port's copy of ``futuresdr_tpu/models/adsb/phy.py``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = ["SPS", "modulate_frame", "detect_and_demodulate"]

SPS = 2            # samples per µs (per bit: 2 chips = 2·SPS samples... chip = 0.5µs)

# preamble pulse pattern over 8 µs at 0.5 µs resolution (16 chips)
_PREAMBLE_CHIPS = np.zeros(16)
for pulse_us in (0.0, 1.0, 3.5, 4.5):
    _PREAMBLE_CHIPS[int(pulse_us * 2)] = 1.0


def modulate_frame(bits: np.ndarray, amplitude: float = 1.0) -> np.ndarray:
    """Mode S frame bits → magnitude samples (preamble + PPM payload) at 2 Msps."""
    chips = []
    for c in _PREAMBLE_CHIPS:
        chips.append(c)
    for b in bits:
        chips += ([1.0, 0.0] if b else [0.0, 1.0])
    return (amplitude * np.repeat(np.asarray(chips), 1)).astype(np.float32)


def detect_and_demodulate(mag: np.ndarray, threshold: float = 3.0
                          ) -> List[Tuple[int, np.ndarray]]:
    """Scan a magnitude stream; returns [(start_index, bits[56 or 112])].

    Correlates the preamble template and validates pulse/quiet structure
    (`preamble_detector.rs`), then integrates chip energies per bit (`demodulator.rs`).
    """
    n = len(mag)
    frames = []
    if n < 16 + 112 * 2:
        return frames
    tpl_on = np.flatnonzero(_PREAMBLE_CHIPS > 0)
    tpl_off = np.flatnonzero(_PREAMBLE_CHIPS == 0)
    noise = np.median(mag) + 1e-9
    # vectorized preamble metric over every start position
    limit = n - (16 + 112 * 2) + 1
    win = np.lib.stride_tricks.sliding_window_view(mag, 16)[:limit]
    on_min = win[:, tpl_on].min(axis=1)
    off_mean = win[:, tpl_off].mean(axis=1)
    cand = np.flatnonzero((on_min > threshold * noise)
                          & (on_min > 1.5 * (off_mean + 1e-12)))
    next_free = 0
    for start in cand:
        if start < next_free:
            continue
        bits_start = start + 16
        pairs = mag[bits_start:bits_start + 112 * 2].reshape(112, 2)
        bits = (pairs[:, 0] > pairs[:, 1]).astype(np.uint8)
        df = int((bits[0] << 4) | (bits[1] << 3) | (bits[2] << 2)
                 | (bits[3] << 1) | bits[4])
        n_bits = 112 if df >= 16 else 56
        frames.append((int(start), bits[:n_bits]))
        next_free = bits_start + n_bits * 2
    return frames
