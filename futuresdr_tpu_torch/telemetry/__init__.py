"""Telemetry: the Prometheus registry and the lifecycle event journal.

The port's reduced copy of ``futuresdr_tpu/telemetry``, the three modules
whose contracts the serving plane reads: :mod:`.prom` (counters, gauges,
histograms, the ``GET /metrics`` exposition), :mod:`.hist` (the log2
histogram behind its quantiles) and :mod:`.journal` (the event ring).
Spans, the doctor, the profile plane, lineage and the fleet plane wait for
ROADMAP item 4b.
"""

from . import hist, journal, prom
from .prom import Counter, Gauge, Histogram, Registry, counter, gauge, histogram, render_all

__all__ = ["hist", "journal", "prom", "Counter", "Gauge", "Histogram", "Registry",
           "counter", "gauge", "histogram", "render_all"]
