"""The kernel-plan sweep: each hand kernel timed under every plan it takes.

The counterpart of ``futuresdr_tpu/tpu/pallas_tune.py`` (whose sweep picks a
Pallas block shape per kernel and chip generation). Here a kernel's plan
(``ops/cuda_kernels.py``: ``fir_plan``, ``fir_fft_plan``, ``poly_fir_plan``,
``pfb_plan``) is chosen per call shape by a rule; :func:`sweep_plans` times
every layout the rule chooses between (:func:`cuda_kernels.plan_candidates`,
the rule's own pick among them) at the main paths' shapes, holds each against
the kernel's plain version, and returns the winners, which
``tpu/autotune.autotune_pallas_blocks`` records in the streamed-pick cache
(the ``pallas_blocks`` axis, keyed by :func:`device_key`) and installs
(:func:`cuda_kernels.set_tuned_plans`). ``rotator`` and ``quad_demod`` have
one layout each; the sweep times and records it.

The contract is the reference's:

- the rule's pick is always a candidate and wins ties within
  :data:`TIE_MARGIN` of its time, so a recorded winner never regresses it;
- a candidate that fails to launch or to match the plain version is left
  out with a warning and listed in the result's ``failures`` (the chip check
  fails on any);
- on the CPU the wrappers run their plain versions whatever the plan, so
  the ranking is a smoke of the sweep's loop, and :func:`device_key`
  (``"cpu"``) keeps those picks from a card.

Each candidate's time is one call's device time in a CUDA graph of
``reps`` calls over ``reps`` distinct inputs (``chip_smoke.py``'s phase 7
method); on the CPU the host time of the same calls. A candidate's first
call, which builds its kernel, is billed to the profile plane as a compile
of ``autotune`` with reason ``autotune``, which never counts toward a storm.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..log import logger
from ..ops import cuda_kernels as ck
from ..telemetry import profile as _profile

__all__ = ["TIE_MARGIN", "TOL", "SHAPES", "device_key", "sweep_plans"]

log = logger("tpu.kernel_tune")

#: a candidate within this factor of the rule's time is a tie: the rule stays
TIE_MARGIN = 0.98
#: max |kernel − plain| over max |plain| a candidate may read (chip_smoke's
#: phase 7 limits; quad_demod's is absolute, in radians·gain)
TOL = {"fir": 1e-5, "fir_fft": 1e-4, "rotator": 1e-5, "poly_fir": 1e-5,
       "quad_demod": 1e-5, "pfb": 1e-5}
#: the main paths' calls: (kernel, label, shape spec) — spectrum chain 2^18,
#: the A/B decimator, the FM front end at 512,000 (128,000 after the channel
#: filter), PFB-64 and PFB-2048 at 2^18
SHAPES = (
    ("fir", "spectrum c64 2^18, 64 taps", {"n": 1 << 18, "nt": 64}),
    ("fir_fft", "spectrum c64 2^18, 64 taps, n_fft 2048", {"n": 1 << 18, "nt": 64,
                                                           "n_fft": 2048}),
    ("poly_fir", "decimator c64 2^18, 128 taps, D 16", {"n": 1 << 18, "D": 16, "m": 8}),
    ("poly_fir", "FM channel c64 512,000, D 4", {"n": 512_000, "D": 4, "m": 32}),
    ("poly_fir", "FM resampler f32 128,000, 24/125", {"n": 128_000, "D": 125, "m": 2,
                                                      "I": 24, "real": True}),
    ("pfb", "PFB-64 c64 2^18", {"n": 1 << 18, "N": 64, "K": 12}),
    ("pfb", "PFB-2048 c64 2^18", {"n": 1 << 18, "N": 2048, "K": 12}),
    ("rotator", "FM tuner c64 512,000", {"n": 512_000}),
    ("quad_demod", "FM demod c64 128,000", {"n": 128_000}),
)


def device_key(device=None) -> str:
    """The cache key of a device: the card's name
    (``torch.cuda.get_device_name``), or ``"cpu"``."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(device)


def _workload(kernel: str, spec: dict, dev: torch.device, reps: int,
              gen: torch.Generator) -> Tuple[tuple, list, Callable, Callable]:
    """``(shape, args_list, call(plan, *args), plain(*args))`` of one sweep
    case: ``reps`` distinct inputs at the case's shape."""
    n_sm = ck._sm_count(dev) if dev.type == "cuda" else 132

    def c(k):
        return torch.randn(k, dtype=torch.complex64, generator=gen, device=dev)

    def r(*k):
        return torch.randn(*k, dtype=torch.float32, generator=gen, device=dev)

    n = spec["n"]
    if kernel == "fir":
        nt = spec["nt"]
        taps = r(nt)
        args = [(c(nt - 1), c(n)) for _ in range(reps)]
        return ((n, nt, 1, n_sm), args,
                lambda p, h, x: ck.fir_continue(h, x, taps, plan=p),
                lambda h, x: ck.fir_continue_plain(h, x, taps))
    if kernel == "fir_fft":
        nt, nf = spec["nt"], spec["n_fft"]
        taps = r(nt)
        args = [(c(nt - 1), c(n)) for _ in range(reps)]
        return ((nf, nt), args,
                lambda p, h, x: ck.fir_fft(h, x, taps, nf, plan=p),
                lambda h, x: ck.fir_fft_plain(h, x, taps, nf))
    if kernel == "poly_fir":
        D, m, I = spec["D"], spec["m"], spec.get("I", 1)
        real = spec.get("real", False)
        W = r(m + 1, D, I) if I > 1 else r(m + 1, D)
        mk = (lambda k: r(k)) if real else c
        args = [(mk(m * D), mk(n)) for _ in range(reps)]
        return ((m, D, I, n // D, int(not real), n_sm), args,
                lambda p, h, x: ck.poly_fir(h, x, W, plan=p),
                lambda h, x: ck.poly_fir_plain(h, x, W))
    if kernel == "pfb":
        N, K = spec["N"], spec["K"]
        taps = r(K, N)
        args = [(c((K - 1) * N), c(n)) for _ in range(reps)]
        return ((N, K, n // N, n_sm), args,
                lambda p, h, x: ck.pfb(h, x, taps, plan=p),
                lambda h, x: ck.pfb_plain(h, x, taps))
    if kernel == "rotator":
        ph0 = torch.tensor(1.25, device=dev)
        inc = torch.tensor(-0.6283185, device=dev)
        args = [(c(n),) for _ in range(reps)]
        return ((n,), args, lambda p, x: ck.rotator(x, ph0, inc)[0],
                lambda x: ck.rotator_plain(x, ph0, inc)[0])
    if kernel == "quad_demod":
        prev = c(1)[0].clone()
        args = [(c(n),) for _ in range(reps)]
        return ((n,), args, lambda p, x: ck.quad_demod(prev, x, 0.53)[0],
                lambda x: ck.quad_demod_plain(prev, x, 0.53)[0])
    raise ValueError(f"unknown kernel {kernel!r}")


def _err(kernel: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    g = got.detach().cpu().numpy().astype(np.complex128)
    f = ref.detach().cpu().numpy().astype(np.complex128)
    if g.shape != f.shape:
        return float("inf")
    if not g.size:
        return 0.0
    d = np.abs(g - f)
    if kernel == "quad_demod":               # atan2's ±π branch, absolute
        d = np.abs(np.angle(np.exp(1j * (g.real - f.real) / 0.53))) * 0.53
        return float(np.max(d))
    return float(np.max(d)) / max(float(np.max(np.abs(f))), 1e-30)


def _time(call: Callable, args_list: list, dev: torch.device, rounds: int = 5) -> float:
    """Seconds of one call: on a card the device time of one replay of a
    CUDA graph of every call over ``args_list``, median of ``rounds``; on
    the CPU the host time of the calls."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for a in args_list:
            call(*a)
        return (time.perf_counter() - t0) / len(args_list)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        call(*args_list[0])
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with ck.capturing():                      # a sweep's launches are not a path's
        with torch.cuda.graph(graph):
            outs = [call(*a) for a in args_list]
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / 1e3 / len(args_list))
    del graph, outs
    return statistics.median(times)


def sweep_plans(kernels: Optional[Sequence[str]] = None, device=None, reps: int = 20,
                shapes: Optional[Sequence[tuple]] = None, seed: int = 20) -> dict:
    """Time every candidate plan of each kernel at each shape of ``shapes``
    (default :data:`SHAPES`, filtered by ``kernels``) on ``device`` (default:
    the card; ``"cpu"`` runs the plain versions) and pick the winners.

    Returns ``{"winners": {kernel: {shape: plan}}, "matrix": {kernel:
    {shape: {plan: seconds}}}, "errors": {kernel: {shape: {plan: error}}},
    "labels": {(kernel, shape): label}, "failures": [(kernel, shape, plan,
    reason)], "device": device_key}``. A candidate whose error exceeds
    :data:`TOL` or that raises is a failure and is not timed."""
    if device is None:
        from .instance import instance
        device = instance().device
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    want = set(kernels) if kernels else None
    out = {"winners": {}, "matrix": {}, "errors": {}, "labels": {}, "failures": [],
           "device": device_key(dev)}
    for kernel, label, spec in (shapes or SHAPES):
        if want is not None and kernel not in want:
            continue
        shape, args_list, call, plain = _workload(kernel, spec, dev, reps, gen)
        out["labels"][(kernel, shape)] = label
        refs = [plain(*a) for a in args_list[:1]]
        cands = ck.plan_candidates(kernel, *shape)
        times, errs = {}, {}
        for p in cands:
            try:
                # a candidate's first call builds its kernel: a compile by
                # design, billed as "autotune" (never a storm)
                with _profile.compiling("autotune", "autotune", f"{kernel}:{label}:{p}"):
                    got = call(p, *args_list[0])
                err = _err(kernel, got, refs[0])
                errs[p] = err
                if not err <= TOL[kernel]:
                    raise ValueError(f"error {err:.3e} over {TOL[kernel]:g}")
                times[p] = _time(lambda *a, p=p: call(p, *a), args_list, dev)
            except (RuntimeError, ValueError, TypeError) as e:
                log.warning("plan sweep %s %s %s failed: %r", kernel, label, p, e)
                out["failures"].append((kernel, shape, p, repr(e)))
        out["matrix"].setdefault(kernel, {})[shape] = times
        out["errors"].setdefault(kernel, {})[shape] = errs
        if not times:
            continue
        rule = cands[0]
        best = min(times, key=times.get)
        if rule in times and best != rule and times[rule] * TIE_MARGIN <= times[best]:
            best = rule                          # a tie keeps the rule
        out["winners"].setdefault(kernel, {})[shape] = best
    return out
