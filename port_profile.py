#!/usr/bin/env python3
"""Where the streamed chains' time goes on one CUDA card.

Runs the port's streamed path, ``NullSource -> Head -> TpuKernel -> NullSink``,
under ``torch.profiler`` with CUDA activity only: the north-star chain
(64-tap FIR, 2048-point FFT, |x|^2; frame 2^18) once per route, the FM
front end (frame 512,000) once per chain, the app's (``front_end_stages``)
and the kernel chain (rotator, decimating FIR, demod, resampler on the hand
kernels), and the PFB-64 channelizer on the ``pfb`` kernel
(``channelizer_stage(64, impl="pallas")``, frame 2^18); 64 frames, 4 in
flight. For each it prints the wall time, the device-busy time
(the union of every kernel and copy interval on the card's timeline, so
overlapping streams count once), the idle share (1 - busy / wall) and the
device time by kernel or copy, with the card's name and power limit. The
first profiled run in a process also pays the profiler's start-up, so its
wall time and idle share read high.

Run from the repository root on a machine with one CUDA card and ``nvcc``:
``python3 port_profile.py``. Exits nonzero without CUDA.

``python3 port_profile.py --count [--root DIR]`` only counts the kernels one
resident 512,000-sample frame of the FM kernel chain launches, and of its
rotator stage alone (``chip_smoke.kernels_a_frame``), with
``futuresdr_tpu_torch`` imported from DIR, another checkout (say the parent
commit, unpacked with ``git archive``), so that two versions are compared.
"""

from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

N_TAPS = 64
N_FFT = 2048
FRAME = 1 << 18
FM_FRAME = 512_000
FRAMES = 64
IN_FLIGHT = 4
TOP = 8


def _stages(route: str, taps):
    from futuresdr_tpu_torch.ops.stages import (fft_stage, fir_fft_stage, fir_stage,
                                                mag2_stage)
    if route == "fused":
        return [fir_fft_stage(taps, N_FFT), mag2_stage()]
    return [fir_stage(taps, impl=route), fft_stage(N_FFT), mag2_stage()]


def _fm_stages(chain: str):
    from futuresdr_tpu_torch.apps.fm_receiver import front_end_stages
    from futuresdr_tpu_torch.dsp import firdes
    from futuresdr_tpu_torch.ops.stages import (fir_stage, quad_demod_stage,
                                                resample_stage, rotator_stage)
    if chain == "app":
        return front_end_stages(offset=100e3)
    return [rotator_stage(-2 * np.pi * 100e3 / 1e6, name="tuner", impl="pallas"),
            fir_stage(firdes.lowpass(0.5 / 4 * 0.8, 128), decim=4, impl="pallas"),
            quad_demod_stage(250e3 / (2 * np.pi * 75e3), impl="pallas"),
            resample_stage(24, 125, impl="pallas")]


def _pfb_stages():
    from futuresdr_tpu_torch.ops.stages import channelizer_stage
    return [channelizer_stage(64, impl="pallas")]


def _union_us(intervals) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def profile_route(stages, frame: int, dev) -> dict:
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import Head, NullSink, NullSource
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
    fg = Flowgraph()
    kern = TpuKernel(stages, np.complex64, frame_size=frame, inst=TpuInstance(dev),
                     frames_in_flight=IN_FLIGHT)
    snk = NullSink(kern.pipeline.out_dtype)
    fg.connect(NullSource(np.complex64), Head(np.complex64, FRAMES * frame), kern, snk)
    rt = Runtime()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rt.run(fg)
        wall_s = time.perf_counter() - t0
    rt.shutdown()
    if snk.n_received != kern.pipeline.out_items(FRAMES * frame):
        raise RuntimeError(f"NullSink got {snk.n_received} items")
    intervals, by_name = [], defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            intervals.append((e.time_range.start, e.time_range.end))
            by_name[e.name] += e.time_range.end - e.time_range.start
    if not intervals:
        raise RuntimeError("torch.profiler recorded no device activity")
    busy_us = _union_us(intervals)
    return {"wall_us": wall_s * 1e6, "busy_us": busy_us,
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]}


def count(card: str, dev) -> None:
    """Kernels a resident frame of the FM kernel chain and of its rotator
    stage, counted by ``chip_smoke.kernels_a_frame`` (this checkout's), on
    whichever ``futuresdr_tpu_torch`` is first on the path."""
    import futuresdr_tpu_torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", Path(__file__).resolve().parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from futuresdr_tpu_torch.ops.stages import rotator_stage
    frames = list(cs.fm_iq(3 * FM_FRAME, dev).split(FM_FRAME))
    root = Path(futuresdr_tpu_torch.__file__).resolve().parents[1]
    for label, stages in (("kernel chain", _fm_stages("kernel")),
                          ("rotator stage", [rotator_stage(-2 * np.pi * 100e3 / 1e6,
                                                           impl="pallas")])):
        names = cs.kernels_a_frame(stages, frames, dev)
        print(f"count fm {label} frame={FM_FRAME} ({root}): {len(names)} kernels a "
              f"frame [{card}]")
        for name in names:
            print(f"  {name[:100]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--count", action="store_true")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("port_profile: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 2
    from futuresdr_tpu_torch.dsp import firdes
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    if args.count:
        count(card, dev)
        return 0
    taps = firdes.lowpass(0.2, N_TAPS).astype(np.float32)
    runs = [(route, _stages(route, taps), FRAME) for route in ("os", "pallas", "fused")]
    runs += [(f"fm {chain}", _fm_stages(chain), FM_FRAME) for chain in ("app", "kernel")]
    runs.append(("pfb pallas", _pfb_stages(), FRAME))
    for label, stages, frame in runs:
        r = profile_route(stages, frame, dev)
        per_frame = 1.0 / (FRAMES + 1)          # + the kernel's warm-up frame
        print(f"profile {label} frame={frame}: wall {r['wall_us'] / 1e3:.1f} ms, device busy "
              f"{r['busy_us'] / 1e3:.2f} ms, idle share {1 - r['busy_us'] / r['wall_us']:.3f}; "
              f"per frame: wall {r['wall_us'] * per_frame:.1f} us, busy "
              f"{r['busy_us'] * per_frame:.1f} us [{card}]")
        for name, us in r["top"]:
            print(f"  {us * per_frame:9.2f} us/frame  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
