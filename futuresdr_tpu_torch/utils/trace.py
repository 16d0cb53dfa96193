"""Latency tracepoints: timestamped probes through the stream plane.

The port's copy of ``futuresdr_tpu/utils/trace.py``. Re-design of the reference perf harness's LTTng tracepoint blocks
(``perf/perf/src/lttng_sink.rs:1-60``, used by ``perf/null_rand_latency``): a
``LatencyProbeSource`` stamps wall-clock tags every ``granularity`` items; a matching
``LatencyProbeSink`` records (index, send_ts, recv_ts) so per-sample pipeline latency can
be analyzed without external tracers.
"""

from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np

from ..runtime.kernel import Kernel
from ..runtime.tag import Tag, filter_tags
from ..telemetry.doctor import E2E_LATENCY as _E2E_LATENCY

__all__ = ["LatencyProbeSource", "LatencyProbeSink", "latency_stats"]

_TAG_NAME = "latency_probe_ts"


class LatencyProbeSource(Kernel):
    """Pass-through that attaches a timestamp tag every ``granularity`` items."""

    def __init__(self, dtype, granularity: int = 32768):
        super().__init__()
        self.input = self.add_stream_input("in", dtype)
        self.output = self.add_stream_output("out", dtype)
        self.granularity = granularity
        self._next = 0          # absolute index of the next probe
        self._abs = 0

    async def work(self, io, mio, meta):
        inp = self.input.slice()
        out = self.output.slice()
        n = min(len(inp), len(out))
        if n > 0:
            out[:n] = inp[:n]
            while self._next < self._abs + n:
                self.output.add_tag(self._next - self._abs,
                                    Tag("f32", float(time.perf_counter()), _TAG_NAME))
                self._next += self.granularity
            self._abs += n
            self.input.consume(n)
            self.output.produce(n)
        if self.input.finished() and n == len(inp):
            io.finished = True
        elif n > 0 and n < len(inp):
            io.call_again = True


class LatencyProbeSink(Kernel):
    """Terminal consumer recording probe-tag arrival latencies."""

    def __init__(self, dtype):
        super().__init__()
        self.input = self.add_stream_input("in", dtype)
        self.records: List[Tuple[int, float, float]] = []   # (abs_index, sent, seen)
        self._abs = 0
        # every probe latency also feeds the doctor's e2e histogram
        # (telemetry/doctor.py), so `GET /metrics` and flight records carry
        # stream-plane percentiles without the raw records leaving the sink
        self._hist = _E2E_LATENCY.labels(source="latency_probe")

    async def work(self, io, mio, meta):
        inp = self.input.slice()
        n = len(inp)
        if n:
            now = time.perf_counter()
            for t in filter_tags(self.input.tags(), n):
                if t.tag.name == _TAG_NAME:
                    self.records.append((self._abs + t.index, t.tag.value, now))
                    self._hist.observe(max(0.0, now - t.tag.value))
            self._abs += n
            self.input.consume(n)
        if self.input.finished():
            io.finished = True


def latency_stats(records) -> dict:
    """Exact percentiles over raw probe records (p50/p95/p99 — the
    ``perf/latency.py`` CSV columns); the log2-bucket estimates of the same
    latencies live in the always-on ``fsdr_e2e_latency_seconds`` histogram."""
    if not records:
        return {"count": 0}
    lat = np.array([seen - sent for _, sent, seen in records])
    return {
        "count": len(lat),
        "mean_us": float(lat.mean() * 1e6),
        "p50_us": float(np.percentile(lat, 50) * 1e6),
        "p95_us": float(np.percentile(lat, 95) * 1e6),
        "p99_us": float(np.percentile(lat, 99) * 1e6),
        "max_us": float(lat.max() * 1e6),
    }
