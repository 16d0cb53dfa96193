"""SLO-aware overload control for the serving plane: the shedding ladder.

The port's copy of ``futuresdr_tpu/serve/overload.py``.

An overloaded serving engine must degrade **in a documented order** instead
of falling over (docs/robustness.md "Serving-plane recovery"). The
:class:`ShedLadder` is a small hysteretic state machine the engine ticks
once per busy step with two signals:

* **queue pressure** — submitted-but-undispatched frames over the shared
  credit budget (``TenantCreditController.pressure``), against the
  ``serve_shed_hi``/``serve_shed_lo`` watermarks;
* **latency SLO** — the rolling p99 of submit→result latency against the
  ``serve_slo_ms`` deadline budget (0 = pressure-only).

Rungs, in escalation order (the engine acts on transitions):

| rung | name | action | resident numerics |
|---|---|---|---|
| 0 | ``ok`` | — | — |
| 1 | ``admission`` | NEW admissions refused (``ServeOverload`` → 503 + ``Retry-After``) | bit-exact |
| 2 | ``evict`` | most-stalled sessions evicted to host/disk, freeing lanes | bit-exact (evict/readmit is the bit-identical leaf contract) |
| 3 | ``brownout`` | optional lever (config ``serve_brownout``): drop megabatch K to 1, or retune interior precision to bf16 | documented loss (K-rounding / SNR-bounded) — **off by default** |

Escalation needs ``trip`` CONSECUTIVE unhealthy observations per rung;
recovery needs ``clear`` consecutive healthy observations per rung and
unwinds ONE rung at a time — the ladder never jumps from brownout straight
to open admission, so flapping load cannot oscillate the engine between
quality modes.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["ShedLadder", "RUNGS", "LATENCY_RUNG"]

#: rung names, index == level
RUNGS = ("ok", "admission", "evict", "brownout")

#: the rung from which the engine prefers per-frame LATENCY over
#: throughput levers: at/above it the overlapped step collapses its
#: in-flight window to depth 1 (each extra in-flight group is a whole
#: group-time of queueing delay — the same trade as the "k" brownout
#: lever, taken one rung earlier because pipelining depth, unlike K, is
#: bit-exact to unwind)
LATENCY_RUNG = 2


class ShedLadder:
    """Hysteretic overload ladder; see the module docstring for semantics."""

    def __init__(self, hi: float = 0.85, lo: float = 0.50,
                 trip: int = 3, clear: int = 8, max_level: int = 3):
        self.hi = float(hi)
        self.lo = float(lo)
        self.trip = max(1, int(trip))
        self.clear = max(1, int(clear))
        self.max_level = max(0, min(int(max_level), len(RUNGS) - 1))
        self.level = 0
        self.escalations = 0              # lifetime rung-up transitions
        self._bad = 0
        self._good = 0

    @classmethod
    def from_config(cls, max_level: int = 3) -> "ShedLadder":
        from ..config import config
        c = config()
        return cls(hi=c.serve_shed_hi, lo=c.serve_shed_lo, trip=c.serve_shed_trip,
                   clear=c.serve_shed_clear, max_level=max_level)

    @property
    def rung(self) -> str:
        return RUNGS[self.level]

    def observe(self, pressure: float, p99_ms: Optional[float],
                slo_ms: float) -> int:
        """One observation; returns the (possibly new) level.

        Unhealthy = pressure at/over the high watermark OR (with an SLO
        set) the rolling p99 over the deadline budget. Healthy = pressure
        at/under the LOW watermark AND the p99 back inside the SLO — the
        band between the watermarks holds the current rung (hysteresis).
        """
        slo_miss = bool(slo_ms) and p99_ms is not None and p99_ms > slo_ms
        over = pressure >= self.hi or slo_miss
        under = pressure <= self.lo and not slo_miss
        if over:
            self._good = 0
            self._bad += 1
            if self._bad >= self.trip and self.level < self.max_level:
                self.level += 1
                self.escalations += 1
                self._bad = 0
        elif under:
            self._bad = 0
            if self.level:
                self._good += 1
                if self._good >= self.clear:
                    self.level -= 1       # one rung at a time — in order
                    self._good = 0
        else:
            # between the watermarks: hold the rung, reset both streaks
            self._bad = 0
            self._good = 0
        return self.level

    def reset(self) -> None:
        self.level = 0
        self._bad = 0
        self._good = 0

    def view(self) -> dict:
        return {"level": self.level, "rung": self.rung,
                "hi": self.hi, "lo": self.lo,
                "trip": self.trip, "clear": self.clear,
                "escalations": self.escalations}
