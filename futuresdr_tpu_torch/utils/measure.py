"""The marginal device rate of a streaming step: two run lengths, their difference.

The counterpart of ``futuresdr_tpu/utils/measure.py``. :func:`run_marginal`
runs ``step(carry, x) -> (carry, y)`` K times with the carry chained, at two
values of K, and reports the rate of the difference, so the fixed cost of a
launch and of the timing itself cancels. On a card the K steps are one CUDA
graph (captured once a K, warmed up eagerly before) between two CUDA events,
a checksum of every output summed inside it and checked finite on the host
after; the best of ``reps`` replays a K. On the CPU the K steps run eagerly
under ``time.perf_counter`` (a CPU rate is never a device metric).
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

import numpy as np
import torch

from ..ops.stages import _clone

__all__ = ["run_marginal", "run_marginal_retry", "default_k_pair", "scaled_k_pair"]


def _checksum(y) -> torch.Tensor:
    ys = y if isinstance(y, tuple) else (y,)
    acc = None
    for t in ys:
        s = (torch.view_as_real(t) if t.is_complex() else t).to(torch.float32).sum()
        acc = s if acc is None else acc + s
    return acc


def _run_k(step: Callable, carry, x, k: int):
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for _ in range(k):
        carry, y = step(carry, x)
        acc = acc + _checksum(y)
    return acc


def _time_k_card(step, carry0, x, k: int, reps: int) -> float:
    from ..ops import cuda_kernels as ck
    carry = _clone(carry0)
    # capture on the stream the warm-up ran on (its library workspaces), a
    # high-priority one no transfer's copy stream can be (ops/stages.py)
    side = torch.cuda.Stream(x.device, priority=-1)
    side.wait_stream(torch.cuda.current_stream(x.device))
    with torch.cuda.stream(side):           # kernel builds, library plans, tables
        _run_k(step, carry, x, 1)
    torch.cuda.current_stream(x.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # the hand kernels a replay launches count a replay, as a compiled
    # program's do (ops/stages.py CompiledPipeline)
    with ck.capturing() as counts, torch.cuda.graph(graph, stream=side):
        acc = _run_k(step, carry, x, k)

    def replay():
        graph.replay()
        for name, n in counts.items():
            ck.launches[name] += n

    replay()
    if not bool(torch.isfinite(acc)):
        raise RuntimeError(f"non-finite warm-up checksum {float(acc)} at K={k}")
    best = float("inf")
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        replay()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / 1e3)
    if not bool(torch.isfinite(acc)):
        raise RuntimeError(f"non-finite checksum {float(acc)} at K={k}")
    del graph
    return best


def _time_k_cpu(step, carry0, x, k: int, reps: int) -> float:
    acc = _run_k(step, _clone(carry0), x, 1)
    if not bool(torch.isfinite(acc)):
        raise RuntimeError(f"non-finite warm-up checksum {float(acc)} at K={k}")
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        acc = _run_k(step, _clone(carry0), x, k)
        checksum = float(acc)
        best = min(best, time.perf_counter() - t0)
        if not np.isfinite(checksum):
            raise RuntimeError(f"non-finite checksum {checksum} at K={k}")
    return best


def run_marginal(step: Callable, carry0, x: torch.Tensor,
                 k_pair: Tuple[int, int] = (16, 64), reps: int = 4) -> float:
    """Samples/s of ``step(carry, x) -> (carry, y)`` on ``x``'s device,
    ``x.numel()`` samples a step, marginal between the run lengths
    ``k_pair``. Raises ``RuntimeError`` when the longer run did not take
    measurably longer (retry with a larger pair: :func:`run_marginal_retry`)
    or a checksum is not finite."""
    k_lo, k_hi = k_pair
    if k_hi <= k_lo:
        raise ValueError(f"k_pair must be increasing, got {k_pair}")
    timer = _time_k_card if x.device.type == "cuda" else _time_k_cpu
    with torch.no_grad():
        times = {k: timer(step, carry0, x, k, reps) for k in (k_lo, k_hi)}
    if times[k_hi] <= times[k_lo]:
        raise RuntimeError(
            f"marginal ill-conditioned: K={k_hi} ran in {times[k_hi]:.6f}s vs "
            f"K={k_lo} in {times[k_lo]:.6f}s; increase k_pair or the frame size")
    return (k_hi - k_lo) * int(x.numel()) / (times[k_hi] - times[k_lo])


def default_k_pair(platform: str) -> Tuple[int, int]:
    """The run lengths: (16, 64) on a card (one CUDA graph a K: a launch
    costs a few µs, a 2^18 frame tens), (8, 16) on the CPU."""
    return (8, 16) if platform == "cpu" else (16, 64)


def scaled_k_pair(k_pair: Tuple[int, int], frame_items: int, platform: str,
                  min_lo_items: int = None) -> Tuple[int, int]:
    """Grow a pair so the shorter run covers at least ``min_lo_items``
    samples (2M on the CPU, 4M on a card: tens of µs of a card's time at the
    chains' rates, well above the events' resolution)."""
    if min_lo_items is None:
        min_lo_items = 2_000_000 if platform == "cpu" else 4_000_000
    scale = max(1, -(-min_lo_items // (k_pair[0] * max(1, frame_items))))
    return (k_pair[0] * scale, k_pair[1] * scale)


def run_marginal_retry(step: Callable, carry0, x, k_pair: Tuple[int, int] = (16, 64),
                       attempts: int = 3, grow: int = 2) -> float:
    """:func:`run_marginal`, the run lengths doubled after an ill-conditioned
    marginal, up to ``attempts`` tries."""
    last = None
    for _ in range(attempts):
        try:
            return run_marginal(step, carry0, x, k_pair)
        except RuntimeError as e:
            last = e
            k_pair = (k_pair[0] * grow, k_pair[1] * grow)
    raise last
