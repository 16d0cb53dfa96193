"""ADS-B / Mode S receiver (reference: ``examples/adsb/``): PPM demod, CRC24,
DF17 decode (identification / CPR position / velocity), aircraft tracker.

The port's copy of ``futuresdr_tpu/models/adsb``: host numpy, driven by the
port's runtime."""

import numpy as np

from .phy import modulate_frame, detect_and_demodulate
from .decoder import (crc24, decode_frame, AdsbMessage, Tracker, Aircraft,
                      cpr_global_decode)
from .blocks import AdsbReceiver

__all__ = ["modulate_frame", "detect_and_demodulate", "crc24", "decode_frame",
           "AdsbMessage", "Tracker", "Aircraft", "cpr_global_decode",
           "build_df17_frame", "AdsbReceiver"]


def build_df17_frame(icao: int, me_bits: np.ndarray) -> np.ndarray:
    """TX helper for tests: DF17 header + ICAO + 56-bit ME + CRC24 parity."""
    bits = []
    for v, n in ((17, 5), (5, 3), (icao, 24)):
        bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]
    bits += [int(b) for b in me_bits]
    arr = np.array(bits, dtype=np.uint8)
    parity = crc24(np.concatenate([arr, np.zeros(24, np.uint8)]))
    pb = np.array([(parity >> (23 - i)) & 1 for i in range(24)], dtype=np.uint8)
    return np.concatenate([arr, pb])
