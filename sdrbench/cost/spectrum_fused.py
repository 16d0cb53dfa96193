"""The least work of one frame of the spectrum chain, counted from the
configuration and not from the program: n complex64 samples in, n float32
powers out.

- FIR, a real tap on a complex sample: 4 operations a tap a sample.
- FFT of N points: 5·N·log2(N) a block, n/N blocks.
- |x|²: 3 operations a sample.
- Bytes: the input read once (8n), the output written once (4n), the taps
  read once (4 a tap).
"""

from __future__ import annotations

import math


def frame(config: dict, n: int):
    """``(operations, bytes)`` of one n-sample frame."""
    chain = config["chain"]
    nt, N = int(chain["fir"]["n_taps"]), int(chain["n_fft"])
    ops = 4 * nt * n + 5 * n * math.log2(N) + 3 * n
    return ops, 8 * n + 4 * n + 4 * nt
