"""Fixed-bucket log2 histogram: the data type behind latency percentiles.

A reduced copy of ``futuresdr_tpu/telemetry/hist.py``: powers of two from
``2^lo_exp`` to ``2^hi_exp`` seconds (default ~1 µs … 128 s) plus an
overflow bucket; ``observe`` is one ``math.frexp`` and three adds under a
lock, and :meth:`Log2Hist.quantile` interpolates inside the winning bucket
(exact to within one bucket, a factor of 2). The reference's sampled observe
and lineage exemplars wait for the lineage plane (ROADMAP item 4b).
"""

from __future__ import annotations

import math
import threading
from typing import List, Optional, Sequence, Tuple

__all__ = ["Log2Hist", "log2_bounds", "quantile_from_buckets", "DEFAULT_LO_EXP",
           "DEFAULT_HI_EXP"]

DEFAULT_LO_EXP = -20
DEFAULT_HI_EXP = 7


def log2_bounds(lo_exp: int = DEFAULT_LO_EXP,
                hi_exp: int = DEFAULT_HI_EXP) -> Tuple[float, ...]:
    """Inclusive bucket upper bounds ``2^lo_exp … 2^hi_exp`` (no +Inf entry)."""
    if hi_exp <= lo_exp:
        raise ValueError(f"need hi_exp > lo_exp, got [{lo_exp}, {hi_exp}]")
    return tuple(2.0 ** e for e in range(lo_exp, hi_exp + 1))


class Log2Hist:
    """One fixed-bucket log2 histogram (one label child of a prom Histogram)."""

    __slots__ = ("lo_exp", "hi_exp", "bounds", "_lo", "_n", "_counts", "_sum",
                 "_count", "_lock")

    def __init__(self, lo_exp: int = DEFAULT_LO_EXP, hi_exp: int = DEFAULT_HI_EXP):
        self.lo_exp = lo_exp
        self.hi_exp = hi_exp
        self.bounds = log2_bounds(lo_exp, hi_exp)
        self._lo = self.bounds[0]
        self._n = len(self.bounds)
        self._counts = [0] * (self._n + 1)     # the bounds' buckets, then +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        # v in (2^(e-1), 2^e] lands in the bucket bounded by 2^e; negatives
        # and NaN (clock skew) are dropped by the one compare
        if not (v >= 0.0):
            return
        if v <= self._lo:
            i = 0
        else:
            m, e = math.frexp(v)
            i = min(e - self.lo_exp - (m == 0.5), self._n)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> Tuple[List[int], float, int]:
        """``(bucket_counts, sum, count)``, the last count the overflow."""
        with self._lock:
            return list(self._counts), self._sum, self._count

    def quantile(self, q: float) -> Optional[float]:
        """Estimated ``q``-quantile; None when empty."""
        counts, _s, total = self.snapshot()
        return quantile_from_buckets(counts, self.bounds, total, q)


def quantile_from_buckets(counts: Sequence[int], bounds: Sequence[float],
                          total: int, q: float) -> Optional[float]:
    """Bucket counts to a quantile: linear inside the winning bucket, the
    overflow clamped to the top bound."""
    if total <= 0:
        return None
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile out of range: {q}")
    target = q * total
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= target:
            if i >= len(bounds):
                return bounds[-1]
            lo = bounds[i - 1] if i > 0 else 0.0
            frac = (target - cum) / c
            return lo + max(0.0, min(1.0, frac)) * (bounds[i] - lo)
        cum += c
    for i in range(len(counts) - 1, -1, -1):
        if counts[i]:
            return bounds[min(i, len(bounds) - 1)]
    return None
