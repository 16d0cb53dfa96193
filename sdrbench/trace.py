"""What the benchmark reads from ``torch.profiler``'s trace of a traced
segment: the card's busy time (the union of every kernel's, copy's and
memset's interval, so overlapping streams count once), the device
operations by name, and the longest idle gaps, each named by the
benchmark's span (call, wait) open on the host when it began."""

from __future__ import annotations

from collections import defaultdict
from typing import List, Tuple

TOP = 10


def _device(prof) -> list:
    """The device's operations as ``(start_ns, end_ns, name)``."""
    from torch.autograd import DeviceType
    return [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def _union(intervals: List[tuple]) -> List[Tuple[int, int]]:
    merged: List[list] = []
    for s, e, _ in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _host_at(spans: List[tuple], t: int) -> str:
    for name, s, e in spans:
        if s <= t < e:
            return name
    return "between spans"


def summarize(prof, spans: List[tuple], t0: int, t1: int) -> dict:
    """``busy_s``, ``device_ops`` (count), ``top`` ``[[name, seconds], ...]``,
    ``gaps`` ``[[host span, seconds], ...]`` and ``gaps_at`` (each gap's
    start, seconds after ``t0``) of the operations of a finished profile
    that start in ``[t0, t1)`` ns (the trace's clock, ``time.time_ns``), an
    operation's end clipped at ``t1``; ``outside`` counts the others.
    ``spans`` are the benchmark's ``(name, start_ns, end_ns)``."""
    every = _device(prof)
    dev = [(s, min(e, t1), name) for s, e, name in every if t0 <= s < t1]
    if not dev:
        raise RuntimeError(f"torch.profiler recorded no device activity inside the segment "
                           f"({len(every)} operations outside it)")
    merged = _union(dev)
    busy_ns = sum(e - s for s, e in merged)
    by_name: dict = defaultdict(int)
    for s, e, name in dev:
        by_name[name] += e - s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1])
                   for i in range(len(merged) - 1)), reverse=True)[:TOP]
    return {
        "busy_s": busy_ns * 1e-9,
        "device_ops": len(dev),
        "top": [[name, ns * 1e-9] for name, ns in top],
        "gaps": [[_host_at(spans, at), ns * 1e-9] for ns, at in gaps],
        "gaps_at": [(at - t0) * 1e-9 for _, at in gaps],
        "outside": len(every) - len(dev),
    }
