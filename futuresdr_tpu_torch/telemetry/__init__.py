"""Telemetry: span tracing (Perfetto/Chrome trace export) + Prometheus metrics.

The port's copy of ``futuresdr_tpu/telemetry``, standard library only:

* :mod:`.spans` — the thread-aware ring-buffer span recorder, gated by
  ``FUTURESDR_TPU_TRACE`` (off by default; when off a hook is one attribute
  check), drained as Chrome trace-event JSON for Perfetto.
* :mod:`.prom` — counters, gauges and histograms with the Prometheus text
  exposition (:mod:`.hist` holds the log2 histogram), always on; the
  control port's ``GET /metrics`` renders each block's ``metrics()`` dict
  into per-block families beside the registry.
* :mod:`.doctor` — the latency families, the stall watchdog, the flight
  recorder and bottleneck attribution over drained spans.
* :mod:`.lineage` — sampled per-frame flow records (Perfetto flow links,
  tail attribution, OpenMetrics exemplars).
* :mod:`.journal` — the bounded ring of lifecycle events behind
  ``GET /api/events/``.
* :mod:`.profile` — compile (CUDA-graph capture) observability and the
  live ``fsdr_mfu``/``fsdr_hbm_util`` gauges over the hand kernels'
  analytic costs (``utils/roofline.py``).
* :mod:`.fleet` — per-host pressure exports and the cross-host view.
"""

from . import hist, prom, spans
from .prom import (Counter, Gauge, Histogram, Registry, counter, gauge,
                   histogram, registry, render_all)
from .spans import (SpanEvent, SpanRecorder, chrome_trace, drain, enable,
                    enabled, export, overlap_report, recorder, union_ns)
from . import lineage  # noqa: E402 — after spans: flow links share its clock
from . import journal  # noqa: E402 — config-only dependency
from . import profile  # noqa: E402 — after prom/spans: the profile plane
from . import doctor  # noqa: E402 — after profile: doctor reads all four
from . import fleet  # noqa: E402 — after journal/prom: the cross-host plane

__all__ = [
    "spans", "prom", "hist", "doctor", "profile", "lineage", "journal",
    "fleet",
    "SpanRecorder", "SpanEvent", "recorder", "enable", "enabled", "drain",
    "chrome_trace", "export", "overlap_report", "union_ns",
    "Registry", "Counter", "Gauge", "Histogram", "registry", "counter",
    "gauge", "histogram", "render_all",
]
