"""Prometheus metrics: counters, gauges and histograms, and their text
exposition.

A reduced copy of ``futuresdr_tpu/telemetry/prom.py``: the process-global
:class:`Registry` with labelled :class:`Counter`, :class:`Gauge` and
:class:`Histogram` families (``telemetry/hist.py`` children) and
:func:`render_all`, the Prometheus text format v0.0.4 served on the control
port's ``GET /metrics``. Samples of a family render sorted by label values,
so the text does not depend on the order label sets were created. The
reference's per-block families and OpenMetrics exemplars wait for the rest
of the telemetry plane (ROADMAP item 4b).
"""

from __future__ import annotations

import math
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from .hist import Log2Hist, log2_bounds, quantile_from_buckets

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "counter", "gauge", "histogram",
           "render_all", "CONTENT_TYPE"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_NAME_FIX = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize_name(name: str) -> str:
    name = _NAME_FIX.sub("_", name)
    if not name or not _NAME_OK.match(name):
        name = "_" + name
    return name


def _escape_label(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _fmt_value(v: float) -> str:
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _sample_line(name: str, labels: Dict[str, object], value: float) -> str:
    if labels:
        lab = ",".join(f'{_sanitize_name(str(k))}="{_escape_label(v)}"'
                       for k, v in sorted(labels.items()))
        return f"{name}{{{lab}}} {_fmt_value(value)}"
    return f"{name} {_fmt_value(value)}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "", labelnames: Sequence[str] = ()):
        self.name = _sanitize_name(name)
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._vals: Dict[Tuple, float] = {}

    def _key(self, labels: Dict[str, object]) -> Tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(f"{self.name}: expected labels {self.labelnames}, "
                             f"got {tuple(labels)}")
        return tuple(labels[k] for k in self.labelnames)

    def get(self, **labels) -> float:
        with self._lock:
            return self._vals.get(self._key(labels), 0.0)

    def samples(self) -> List[Tuple[Dict[str, object], float]]:
        with self._lock:
            items = list(self._vals.items())
        return [(dict(zip(self.labelnames, k)), v) for k, v in items]

    def _head(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}"] if self.help else []
        lines.append(f"# TYPE {self.name} {self.kind}")
        return lines

    def render(self) -> List[str]:
        lines = self._head()
        samples = self.samples()
        if not samples and not self.labelnames:
            samples = [({}, 0.0)]      # an unlabelled metric exposes its zero
        samples.sort(key=lambda s: tuple(str(v) for v in s[0].values()))
        lines.extend(_sample_line(self.name, labels, v) for labels, v in samples)
        return lines


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        k = self._key(labels)
        with self._lock:
            self._vals[k] = self._vals.get(k, 0.0) + amount


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._vals[k] = float(value)



class Histogram(_Metric):
    """Log2-bucket histogram family: :meth:`labels` gives the bound
    :class:`~.hist.Log2Hist` child of one label set; the exposition is the
    cumulative ``_bucket{le=…}`` samples and ``_sum``/``_count`` a child."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._hists: Dict[Tuple, Log2Hist] = {}

    def labels(self, **labels) -> Log2Hist:
        k = self._key(labels)
        with self._lock:
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = Log2Hist()
            return h

    def observe(self, v: float, **labels) -> None:
        self.labels(**labels).observe(v)

    def quantile(self, q: float, **labels) -> Optional[float]:
        """One child's quantile, or, with no labels on a labelled family, the
        quantile of all children merged."""
        if labels or not self.labelnames:
            return self.labels(**labels).quantile(q)
        with self._lock:
            children = list(self._hists.values())
        merged, total = None, 0
        for h in children:
            counts, _s, n = h.snapshot()
            total += n
            merged = counts if merged is None else [a + b for a, b in zip(merged, counts)]
        return quantile_from_buckets(merged or [], log2_bounds(), total, q)

    def render(self) -> List[str]:
        lines = self._head()
        with self._lock:
            items = list(self._hists.items())
        items.sort(key=lambda kv: tuple(str(v) for v in kv[0]))
        for k, h in items:
            base = dict(zip(self.labelnames, k))
            counts, total_sum, total = h.snapshot()
            cum = 0
            for bound, c in zip(h.bounds, counts):
                cum += c
                lines.append(_sample_line(f"{self.name}_bucket",
                                          {**base, "le": _fmt_value(bound)}, cum))
            lines.append(_sample_line(f"{self.name}_bucket", {**base, "le": "+Inf"},
                                      total))
            lines.append(_sample_line(f"{self.name}_sum", base, total_sum))
            lines.append(_sample_line(f"{self.name}_count", base, total))
        return lines


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, labelnames: Sequence[str]):
        name = _sanitize_name(name)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, labelnames)
            elif not isinstance(m, cls) or m.labelnames != tuple(labelnames):
                raise ValueError(f"metric {name} re-registered with a different "
                                 f"type or label set")
            return m

    def counter(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = ()) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames)

    def render(self) -> str:
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + ("\n" if lines else "")


_registry = Registry()


def counter(name: str, help: str = "", labelnames: Sequence[str] = ()) -> Counter:
    return _registry.counter(name, help, labelnames)


def gauge(name: str, help: str = "", labelnames: Sequence[str] = ()) -> Gauge:
    return _registry.gauge(name, help, labelnames)


def histogram(name: str, help: str = "", labelnames: Sequence[str] = ()) -> Histogram:
    return _registry.histogram(name, help, labelnames)


def render_all() -> str:
    """The registry's exposition document."""
    return _registry.render()
