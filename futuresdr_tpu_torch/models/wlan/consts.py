"""IEEE 802.11a/g/p OFDM PHY constants: the port's copy of
``futuresdr_tpu/models/wlan/consts.py``.

Re-design of the reference WLAN example's tables (``examples/wlan/src/lib.rs`` — MCS,
subcarrier layout, training sequences; itself a port of gr-ieee802-11). Values are from the
public 802.11 standard (Clause 17).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["FFT_SIZE", "CP_LEN", "SYM_LEN", "N_DATA_CARRIERS", "DATA_CARRIERS",
           "PILOT_CARRIERS", "PILOT_VALUES", "PILOT_POLARITY", "LTS_FREQ", "STS_FREQ",
           "lts_time", "sts_time", "Mcs", "MCS_TABLE", "MODULATION_TABLES"]

FFT_SIZE = 64
CP_LEN = 16
SYM_LEN = FFT_SIZE + CP_LEN          # 80 samples per OFDM symbol

# ---- subcarrier layout (Clause 17.3.5.10) -----------------------------------
# data carriers: -26..26 excluding 0 (DC) and pilots ±7, ±21
PILOT_CARRIERS = np.array([-21, -7, 7, 21])
DATA_CARRIERS = np.array([k for k in range(-26, 27)
                          if k != 0 and k not in (-21, -7, 7, 21)])
N_DATA_CARRIERS = len(DATA_CARRIERS)          # 48
PILOT_VALUES = np.array([1.0, 1.0, 1.0, -1.0])   # base pilot symbols

# pilot polarity sequence p_0..p_126 (Clause 17.3.5.10); first entry multiplies the
# SIGNAL symbol, subsequent entries the data symbols
PILOT_POLARITY = np.array([
    1, 1, 1, 1, -1, -1, -1, 1, -1, -1, -1, -1, 1, 1, -1, 1, -1, -1, 1, 1, -1, 1, 1, -1,
    1, 1, 1, 1, 1, 1, -1, 1, 1, 1, -1, 1, 1, -1, -1, 1, 1, 1, -1, 1, -1, -1, -1, 1, -1, 1,
    -1, -1, 1, -1, -1, 1, 1, 1, 1, 1, -1, -1, 1, 1, -1, -1, 1, -1, 1, -1, 1, 1, -1, -1, -1,
    1, 1, -1, -1, -1, -1, 1, -1, -1, 1, -1, 1, 1, 1, 1, -1, 1, -1, 1, -1, 1, -1, -1, -1,
    -1, -1, 1, -1, 1, 1, -1, 1, -1, 1, 1, 1, -1, -1, 1, -1, -1, -1, 1, 1, 1, -1, -1, -1,
    -1, -1, -1, -1,
])

# ---- long training sequence (freq domain, subcarriers -26..26) ---------------
LTS_FREQ_LIST = [
    1, 1, -1, -1, 1, 1, -1, 1, -1, 1, 1, 1, 1, 1, 1, -1, -1, 1, 1, -1, 1, -1, 1, 1, 1, 1,
    0,
    1, -1, -1, 1, 1, -1, 1, -1, 1, -1, -1, -1, -1, -1, 1, 1, -1, -1, 1, -1, 1, -1, 1, 1, 1, 1,
]
LTS_FREQ = np.array(LTS_FREQ_LIST, dtype=np.float64)          # index 0 ↔ carrier -26

# ---- short training sequence (freq domain, subcarriers -26..26) --------------
_sts = np.zeros(53, dtype=np.complex128)
_sts_idx = {-24: 1, -20: -1, -16: 1, -12: -1, -8: -1, -4: -1,
            4: -1, 8: -1, 12: 1, 16: 1, 20: 1, 24: 1}
for k, s in _sts_idx.items():
    _sts[k + 26] = np.sqrt(13.0 / 6.0) * s * (1 + 1j)
STS_FREQ = _sts


def carriers_to_grid(freq_m26_26: np.ndarray) -> np.ndarray:
    """Map subcarriers -26..26 onto the 64-bin fft grid (THE grid convention —
    every consumer of a -26..26 sequence must route through here)."""
    spec = np.zeros(FFT_SIZE, dtype=np.complex128)
    for i, k in enumerate(range(-26, 27)):
        spec[k % FFT_SIZE] = freq_m26_26[i]
    return spec


def _freq_to_time(freq_m26_26: np.ndarray) -> np.ndarray:
    """Map subcarriers -26..26 into a 64-bin spectrum and IFFT (one symbol)."""
    return np.fft.ifft(carriers_to_grid(freq_m26_26))


def sts_time() -> np.ndarray:
    """10 repetitions of the 16-sample short training symbol (160 samples)."""
    sym = _freq_to_time(STS_FREQ)
    return np.tile(sym[:16], 10).astype(np.complex64)


def lts_time() -> np.ndarray:
    """Long training: 32-sample CP + two 64-sample long symbols (160 samples)."""
    sym = _freq_to_time(LTS_FREQ.astype(np.complex128))
    return np.concatenate([sym[-32:], sym, sym]).astype(np.complex64)


# ---- modulation constellations (Clause 17.3.5.8, Gray-coded) -----------------
def _bpsk():
    return np.array([-1.0, 1.0], dtype=np.complex64)


def _qpsk():
    m = np.array([-1, 1]) / np.sqrt(2)
    pts = np.empty(4, dtype=np.complex64)
    for b in range(4):
        pts[b] = m[b & 1] + 1j * m[(b >> 1) & 1]
    return pts


def _qam16():
    lvl = np.array([-3, -1, 3, 1]) / np.sqrt(10)   # Gray order for bit pairs (b0 b1)
    pts = np.empty(16, dtype=np.complex64)
    for b in range(16):
        i = (b >> 0) & 0b11        # bits b0 b1 → I
        q = (b >> 2) & 0b11        # bits b2 b3 → Q
        pts[b] = lvl[i] + 1j * lvl[q]
    return pts


def _qam64():
    lvl = np.array([-7, -5, -1, -3, 7, 5, 1, 3]) / np.sqrt(42)  # Gray for 3 bits
    pts = np.empty(64, dtype=np.complex64)
    for b in range(64):
        i = b & 0b111
        q = (b >> 3) & 0b111
        pts[b] = lvl[i] + 1j * lvl[q]
    return pts


MODULATION_TABLES = {
    "bpsk": _bpsk(),
    "qpsk": _qpsk(),
    "qam16": _qam16(),
    "qam64": _qam64(),
}


@dataclass(frozen=True)
class Mcs:
    name: str
    modulation: str        # key into MODULATION_TABLES
    n_bpsc: int            # coded bits per subcarrier
    coding_rate: str       # "1/2" | "2/3" | "3/4"
    rate_bits: int         # SIGNAL field rate code
    mbps: float

    @property
    def n_cbps(self) -> int:
        return self.n_bpsc * N_DATA_CARRIERS

    @property
    def n_dbps(self) -> int:
        num, den = {"1/2": (1, 2), "2/3": (2, 3), "3/4": (3, 4)}[self.coding_rate]
        return self.n_cbps * num // den


MCS_TABLE = {
    "bpsk_1_2": Mcs("bpsk_1_2", "bpsk", 1, "1/2", 0b1101, 6.0),
    "bpsk_3_4": Mcs("bpsk_3_4", "bpsk", 1, "3/4", 0b1111, 9.0),
    "qpsk_1_2": Mcs("qpsk_1_2", "qpsk", 2, "1/2", 0b0101, 12.0),
    "qpsk_3_4": Mcs("qpsk_3_4", "qpsk", 2, "3/4", 0b0111, 18.0),
    "qam16_1_2": Mcs("qam16_1_2", "qam16", 4, "1/2", 0b1001, 24.0),
    "qam16_3_4": Mcs("qam16_3_4", "qam16", 4, "3/4", 0b1011, 36.0),
    "qam64_2_3": Mcs("qam64_2_3", "qam64", 6, "2/3", 0b0001, 48.0),
    "qam64_3_4": Mcs("qam64_3_4", "qam64", 6, "3/4", 0b0011, 54.0),
}
