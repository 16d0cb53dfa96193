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
``python3 port_profile.py [--k 1,4]``, ``--k`` the frames a dispatch
(``TpuKernel(frames_per_dispatch=K)``) to run each chain at; every mode
streams on the f32 wire (the float32 link these profiles measured before
the wire codecs; the card's default wire is sc16). Exits nonzero without
CUDA.

``--root DIR`` imports ``futuresdr_tpu_torch`` from DIR, another checkout
(say the parent commit, unpacked with ``git archive`` under ``build/``), so
that two versions are compared on one card (parent, change, change, parent);
a package whose ``TpuKernel`` has no ``frames_per_dispatch`` runs at K = 1
only. The other modes:

- ``--split [--runs N]``: the host time of a streamed 2^18 frame of the
  spectrum chain (fused and pallas routes), split between its spans: the
  ring read, the staging copy and pinned allocation, the H2D start, the
  stages' host calls, the D2H start and wait, the emit into the output ring,
  ``TpuKernel.work``'s own lines and the asyncio hand-off (the streaming
  window less the time in ``work``); the median of N instrumented runs
  beside an uninstrumented run's wall a frame, which shows what the
  instrumentation costs. ``--wires f32,sc16`` splits each wire (default
  f32; a package without wires runs its float32 link), with the host
  encode and decode as spans of their own, and the spans the codec pool's
  workers run apart (``worker: …``, in parallel with the block's thread);
  ``--routes fused`` takes one route. The functions are wrapped by name (``SPLIT_SPANS``),
  so one script splits the parent and this checkout alike.
- ``--resident``: resident rates, eager and (where the package has
  ``Pipeline.compile``) compiled at each K, beside the card's time a frame.
- ``--slots [--runs N]``: the compiled dispatch with a device copy in and
  out against one graph per in-flight slot, on a bare transfer-and-replay
  loop (this checkout only).
- ``--count``: the kernels one resident 512,000-sample frame of the FM
  kernel chain launches, and of its rotator stage alone
  (``chip_smoke.kernels_a_frame``).
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import subprocess
import sys
import threading
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


def _kernel_kw(k: int, wire) -> dict:
    """``TpuKernel``'s K and wire arguments, each only where the imported
    package takes it (a parent without ``frames_per_dispatch`` runs K = 1, a
    parent without ``wire`` its float32 link)."""
    import inspect

    from futuresdr_tpu_torch.tpu import TpuKernel
    params = inspect.signature(TpuKernel.__init__).parameters
    kw = {"frames_per_dispatch": k} if k > 1 else {}
    if wire is not None and "wire" in params:
        kw["wire"] = wire
    return kw


def profile_route(stages, frame: int, dev, k: int = 1, profiled: bool = True,
                  wire="f32") -> dict:
    """One streamed run of ``FRAMES`` frames at ``k`` frames a dispatch
    (``k`` = 1 passes no ``frames_per_dispatch``, so a parent without it
    runs too); with ``profiled``, under ``torch.profiler``."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import Head, NullSink, NullSource
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
    fg = Flowgraph()
    kern = TpuKernel(stages, np.complex64, frame_size=frame, inst=TpuInstance(dev),
                     frames_in_flight=IN_FLIGHT, **_kernel_kw(k, wire))
    snk = NullSink(kern.pipeline.out_dtype)
    fg.connect(NullSource(np.complex64), Head(np.complex64, FRAMES * frame), kern, snk)
    rt = Runtime()
    prof = profile(activities=[ProfilerActivity.CUDA]) if profiled else None
    with prof if profiled else contextlib.nullcontext():
        t0 = time.perf_counter()
        rt.run(fg)
        wall_s = time.perf_counter() - t0
    rt.shutdown()
    if snk.n_received != kern.pipeline.out_items(FRAMES * frame):
        raise RuntimeError(f"NullSink got {snk.n_received} items")
    if not profiled:
        return {"wall_us": wall_s * 1e6}
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


# ---------------------------------------------------------------------------
# --split: the streamed wall of one frame, split between its host spans
# ---------------------------------------------------------------------------

# (module, attribute, bucket): every function of the streamed path timed by
# --split where the imported package has it (the names of the parent and of
# this checkout both; a missing one is skipped). Each span counts its own
# time without the spans it encloses, and only inside ``TpuKernel.work``.
SPLIT_SPANS = (
    ("futuresdr_tpu_torch.runtime.buffer", "StreamInput.slice", "ring read"),
    ("futuresdr_tpu_torch.runtime.buffer", "StreamInput.tags", "ring read"),
    ("futuresdr_tpu_torch.runtime.buffer", "StreamInput.consume", "ring read"),
    ("futuresdr_tpu_torch.runtime.buffer", "StreamInput.finished", "ring read"),
    ("futuresdr_tpu_torch.tpu.kernel_block", "TpuKernel._stage", "staging copy, pinned allocation"),
    ("futuresdr_tpu_torch.tpu.kernel_block", "TpuKernel._flush_accum",
     "staging copy, pinned allocation"),
    ("futuresdr_tpu_torch.ops.xfer", "start_device_transfer", "staging copy, pinned allocation"),
    ("futuresdr_tpu_torch.ops.xfer", "start_device_transfer_parts",
     "staging copy, pinned allocation"),
    ("futuresdr_tpu_torch.ops.xfer", "start_host_transfer", "D2H start, pinned allocation"),
    ("futuresdr_tpu_torch.ops.xfer", "start_host_transfer_parts",
     "D2H start, pinned allocation"),
    ("futuresdr_tpu_torch.tpu.kernel_block", "emit_with_tags", "emit into the ring"),
    ("futuresdr_tpu_torch.ops.stages", "CompiledPipeline.dispatch", "stages' host calls"),
    # the wire's host codec: the encode of a frame into its group's parts (for
    # the f32 wire the ring-exit copy itself) and the decode of a landed group
    ("futuresdr_tpu_torch.tpu.kernel_block", "TpuKernel._encode_row", "encode"),
    ("futuresdr_tpu_torch.tpu.kernel_block", "TpuKernel._decode_group", "decode"),
    ("futuresdr_tpu_torch.tpu.kernel_block", "TpuFanoutKernel._decode_group", "decode"),
    # the block's thread joining a codec worker's encode or landing
    ("concurrent.futures", "Future.result", "wait for a codec worker"),
)
# what the transfers' ``finish()`` closures cost, by the function that made them
SPLIT_FINISH = {"start_device_transfer": "H2D start", "start_device_transfer_parts": "H2D start",
                "start_host_transfer": "D2H wait", "start_host_transfer_parts": "D2H wait"}
# spans that run on the codec pool's workers as well (ops/codec_pool.py):
# there they count apart, under "worker: <bucket>", outside the block's thread
WORKER_BUCKETS = ("encode", "decode", "H2D start", "D2H wait",
                  "staging copy, pinned allocation", "D2H start, pinned allocation")


class _Spans:
    """Exclusive host time by bucket, on the thread running ``TpuKernel.work``."""

    def __init__(self):
        self.local = threading.local()
        self.totals = defaultdict(float)
        self.work_ns = 0
        self.first_ns = None
        self.last_ns = 0
        self.workers = False        # count spans on the codec workers too

    def enter(self, bucket) -> bool:
        stack = getattr(self.local, "stack", None)
        if not stack and bucket != "work":
            if bucket not in WORKER_BUCKETS or not self.workers or \
                    not threading.current_thread().name.startswith("fsdr-codec"):
                return False                    # outside TpuKernel.work
            bucket = "worker: " + bucket        # a codec worker's lane
        if stack is None:
            stack = self.local.stack = []
        now = time.perf_counter_ns()
        if stack:
            stack[-1][2] += now - stack[-1][1]  # the parent pauses
            if stack[0][0].startswith("worker: "):
                bucket = "worker: " + bucket
        stack.append([bucket, now, 0])
        return True

    def leave(self) -> None:
        stack = self.local.stack
        bucket, t0, acc = stack.pop()
        now = time.perf_counter_ns()
        self.totals[bucket] += acc + now - t0
        if stack:
            stack[-1][1] = now                  # the parent resumes
        elif not bucket.startswith("worker: "):
            self.work_ns += now - self._work_t0
            self.last_ns = now

    def wrap(self, fn, bucket, finish_bucket=None):
        spans = self

        @functools.wraps(fn)
        def timed(*a, **kw):
            if not spans.enter(bucket):
                return fn(*a, **kw)
            try:
                out = fn(*a, **kw)
            finally:
                spans.leave()
            return spans.wrap(out, finish_bucket) if finish_bucket else out
        return timed

    def wrap_work(self, fn):
        spans = self

        async def work(*a, **kw):
            now = time.perf_counter_ns()
            if spans.first_ns is None:
                spans.first_ns = now
            spans._work_t0 = now
            spans.enter("work")
            try:
                return await fn(*a, **kw)
            finally:
                spans.leave()
        return work


def _timed_streams(spans):
    """``torch.cuda.stream(s)`` whose block counts as the H2D start, or as
    the D2H start inside a host transfer."""
    import torch
    real = torch.cuda.stream

    class Timed:
        def __init__(self, s):
            self.ctx = real(s)
            stack = getattr(spans.local, "stack", None)
            self.bucket = "D2H start, pinned allocation" if stack and \
                stack[-1][0].removeprefix("worker: ").startswith("D2H") else "H2D start"

        def __enter__(self):
            self.on = spans.enter(self.bucket)
            return self.ctx.__enter__()

        def __exit__(self, *exc):
            r = self.ctx.__exit__(*exc)
            if self.on:
                spans.leave()
            return r
    return real, Timed


def split_route(stages, frame: int, dev, k: int, wire="f32") -> dict:
    """One streamed run of ``FRAMES`` frames with the host spans timed:
    µs per frame by bucket; the asyncio hand-off is the streaming window
    (first ``work`` call to last) less the time inside ``work``. Spans the
    codec pool's workers run count apart (``worker: …``): they overlap the
    block's thread."""
    import importlib

    import torch

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import Head, NullSink, NullSource
    from futuresdr_tpu_torch.ops import stages as st
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel, kernel_block
    spans, undo = _Spans(), []
    spans.workers = True

    def patch(owner, name, new):
        undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, new)

    for mod, attr, bucket in SPLIT_SPANS:
        owner = importlib.import_module(mod)
        *path, name = attr.split(".")
        for p in path:
            owner = getattr(owner, p, None)
        if hasattr(owner, name):
            patch(owner, name, spans.wrap(getattr(owner, name), bucket,
                                          SPLIT_FINISH.get(name)))
    patch(kernel_block.TpuKernel, "work", spans.wrap_work(kernel_block.TpuKernel.work))
    real_stream, timed = _timed_streams(spans)
    patch(torch.cuda, "stream", timed)
    # the stages' host calls: the eager per-frame function (a package
    # without Pipeline.compile; ``CompiledPipeline.dispatch`` above otherwise)
    patch(st.Pipeline, "fn", lambda self, _f=st.Pipeline.fn:
          spans.wrap(_f(self), "stages' host calls"))
    try:
        kern = TpuKernel(stages, np.complex64, frame_size=frame, inst=TpuInstance(dev),
                         frames_in_flight=IN_FLIGHT, **_kernel_kw(k, wire))
        snk = NullSink(kern.pipeline.out_dtype)
        fg = Flowgraph()
        fg.connect(NullSource(np.complex64), Head(np.complex64, FRAMES * frame), kern, snk)
        rt = Runtime()
        t0 = time.perf_counter_ns()
        rt.run(fg)
        wall_ns = time.perf_counter_ns() - t0
        rt.shutdown()
    finally:
        for owner, name, old in reversed(undo):
            setattr(owner, name, old)
    if snk.n_received != kern.pipeline.out_items(FRAMES * frame):
        raise RuntimeError(f"NullSink got {snk.n_received} items")
    window = spans.last_ns - spans.first_ns
    per = {b: ns / 1e3 / FRAMES for b, ns in spans.totals.items()}
    per["TpuKernel.work, its own lines"] = per.pop("work", 0.0)
    per["asyncio hand-off (window less work)"] = (window - spans.work_ns) / 1e3 / FRAMES
    return {"run_us": wall_ns / 1e3 / FRAMES, "window_us": window / 1e3 / FRAMES,
            "buckets": per}


def split(card: str, dev, ks, runs: int, wires=("f32",), routes=("fused", "pallas")) -> None:
    """The split of a streamed frame of the spectrum chain (the fused and
    pallas routes, 2^18) on each wire, median of ``runs`` runs per bucket,
    beside an uninstrumented run's wall per frame."""
    import statistics

    import futuresdr_tpu_torch
    from futuresdr_tpu_torch.dsp import firdes
    root = Path(futuresdr_tpu_torch.__file__).resolve().parents[1]
    taps = firdes.lowpass(0.2, N_TAPS).astype(np.float32)
    for route in routes:
        for wire in wires:
            for k in ks:
                _split_one(card, dev, root, route, wire, k, runs, taps)


def _split_one(card, dev, root, route, wire, k, runs, taps) -> None:
    """One route, wire and K of :func:`split`."""
    import statistics
    plain = []
    for _ in range(runs):
        r = profile_route(_stages(route, taps), FRAME, dev, k=k, profiled=False, wire=wire)
        plain.append(r["wall_us"] / FRAMES)
    got = [split_route(_stages(route, taps), FRAME, dev, k, wire) for _ in range(runs)]
    med = {b: statistics.median(g["buckets"].get(b, 0.0) for g in got)
           for b in sorted({b for g in got for b in g["buckets"]})}
    label = f"split {route} frame={FRAME} K={k} wire={wire}"
    print(f"{label} ({root}): run wall {statistics.median(plain):.1f} us/frame "
          f"uninstrumented, {statistics.median(g['run_us'] for g in got):.1f} "
          f"instrumented, streaming window "
          f"{statistics.median(g['window_us'] for g in got):.1f} (median of {runs}) "
          f"[{card}]")
    for b, us in sorted(med.items(), key=lambda kv: -kv[1]):
        print(f"  {us:9.1f} us/frame  {b}")


def _chip_smoke():
    """This checkout's ``chip_smoke.py`` as a module (its helpers drive
    whichever ``futuresdr_tpu_torch`` is first on the path)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", Path(__file__).resolve().parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _takes_k() -> bool:
    """Whether the imported ``TpuKernel`` takes ``frames_per_dispatch``."""
    import inspect

    from futuresdr_tpu_torch.tpu import TpuKernel
    return "frames_per_dispatch" in inspect.signature(TpuKernel.__init__).parameters


RESIDENT_CHAINS = ("spectrum pallas", "spectrum fused", "fm kernel", "fm app", "pfb pallas")


def _kernels_us(run) -> float:
    """The summed device time of every kernel and copy ``run()`` puts on the
    card, from ``torch.profiler`` (one call, after the caller's warm-up)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == DeviceType.CUDA)


def resident(card: str, dev, ks) -> None:
    """Resident input Msamples/s of each chain at each of chip_smoke.py's
    frames, eager and, where the package has ``Pipeline.compile``, compiled
    at each K, over the same 12 chained frames (``chip_smoke.cuda_ms``, the
    median of 5), each beside the card's time a frame for the same calls in
    the same run (``chip_smoke.card_ms``: the calls queued behind a device
    sleep, so the host's time is hidden) and the frame's device time as the
    sum of its kernels' and copies' times (``torch.profiler``)."""
    import torch

    import futuresdr_tpu_torch
    from futuresdr_tpu_torch.dsp import firdes
    from futuresdr_tpu_torch.ops.stages import Pipeline
    cs = _chip_smoke()
    root = Path(futuresdr_tpu_torch.__file__).resolve().parents[1]
    taps = firdes.lowpass(0.2, N_TAPS).astype(np.float32)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 40)
    n = cs.HOST_DISPATCHES * max(cs.HOST_K)
    for label, make, frames, _ in cs.host_chains(taps):
        if label not in RESIDENT_CHAINS:
            continue
        for f in frames:
            x_all = cs.host_input(label, n * f, gen, dev)
            xs = list(x_all.split(f))
            pipe = Pipeline(make(), np.complex64)
            runs = {}
            fn, state = pipe.fn(), [pipe.init_carry(dev)]

            def eager(fn=fn, state=state):
                c = state[0]
                for x in xs:
                    c, _ = fn(c, x)
                state[0] = c

            runs["eager"] = eager
            for k in ks if hasattr(pipe, "compile") else ():
                cfn, cstate = pipe.compile(f, dev, k=k)
                cstate = [cstate]

                def compiled(fn=cfn, state=cstate,
                             groups=list(x_all.view(-1, k, f)) if k > 1 else xs):
                    c = state[0]
                    for x in groups:
                        c, _ = fn(c, x)
                    state[0] = c

                runs[f"compiled K={k}"] = compiled
            row = {}
            for mode, run in runs.items():
                msps = n * f / (cs.cuda_ms(run, 5) * 1e-3) / 1e6
                row[mode] = (msps, cs.card_ms(run) * 1e3 / n, _kernels_us(run) / n)
            print(f"resident {label} frame={f} ({root.name}): " + ", ".join(
                f"{m} {msps:.1f} Msamples/s (card {us:.1f}, kernels {kus:.1f} us a frame)"
                for m, (msps, us, kus) in row.items()) + f" [{card}]")
            del x_all, xs, runs


SLOT_CHAINS = (("spectrum fused", 1 << 18), ("fm kernel", 512_000))


def slots(card: str, dev, rounds: int) -> None:
    """Two designs of the streamed dispatch, on a bare loop of ``FRAMES``
    frames with ``IN_FLIGHT`` in flight (pinned host frames in and out, the
    H2D and D2H on side streams, as ``ops/xfer.py`` runs them; no flowgraph):

    - "copy": one graph, a device copy in and a clone out (a call
      ``fn(carry, x)`` of ``Pipeline.compile``'s program);
    - "slots": one graph per in-flight slot, sharing the carry buffers
      (``compile(slots=IN_FLIGHT)``, as ``TpuKernel`` runs it): the H2D lands
      in the slot's input, the D2H reads the slot's output, and a slot is
      reused only after its D2H.

    Prints the host wall a frame of each, alternating over ``rounds`` rounds,
    and the largest difference between the two designs' last outputs."""
    import torch

    import futuresdr_tpu_torch
    from futuresdr_tpu_torch.dsp import firdes
    from futuresdr_tpu_torch.ops.stages import Pipeline
    cs = _chip_smoke()
    root = Path(futuresdr_tpu_torch.__file__).resolve().parents[1]
    taps = firdes.lowpass(0.2, N_TAPS).astype(np.float32)
    chains = {c[0]: c[1] for c in cs.host_chains(taps)}
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 41)
    cur = torch.cuda.current_stream(dev)
    h2d, d2h = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    for label, f in SLOT_CHAINS:
        pipe = Pipeline(chains[label](), np.complex64)
        one, _ = pipe.compile(f, dev)
        slotted, _ = pipe.compile(f, dev, slots=IN_FLIGHT)
        host_in = [cs.host_input(label, f, gen, dev).cpu().pin_memory()
                   for _ in range(IN_FLIGHT)]
        host_out = [torch.empty(tuple(one.outputs[0].shape), dtype=one.outputs[0].dtype,
                                pin_memory=True) for _ in range(IN_FLIGHT)]

        def loop(dispatch):
            """``dispatch(i, carry) -> (carry, y)`` for each frame; the host
            waits for slot i's last D2H before reusing it."""
            done, c = [None] * IN_FLIGHT, pipe.init_carry(dev)
            for t in range(FRAMES):
                i = t % IN_FLIGHT
                if done[i] is not None:
                    done[i].synchronize()
                c, y = dispatch(i, c)
                d2h.wait_stream(cur)
                with torch.cuda.stream(d2h):
                    host_out[i].copy_(y, non_blocking=True)
                    done[i] = torch.cuda.Event()
                    done[i].record(d2h)
                y.record_stream(d2h)
            torch.cuda.synchronize()

        def h2d_into(dst, i):
            with torch.cuda.stream(h2d):
                dst.copy_(host_in[i], non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(h2d)
            cur.wait_event(ev)

        def copy_dispatch(i, c):
            x = torch.empty(f, dtype=torch.complex64, device=dev)
            h2d_into(x, i)
            x.record_stream(cur)
            return one(c, x)

        def slot_dispatch(i, c):
            h2d_into(slotted.inputs[i], i)
            return slotted.dispatch(i, c)

        times = defaultdict(list)
        last = {}
        for r in range(rounds):
            order = (("copy", copy_dispatch), ("slots", slot_dispatch))
            for name, dispatch in order if r % 2 == 0 else order[::-1]:
                t0 = time.perf_counter()
                loop(dispatch)
                times[name].append((time.perf_counter() - t0) / FRAMES * 1e6)
                last[name] = torch.cat([h.clone() for h in host_out])
        diff = float((last["copy"] - last["slots"]).abs().max())
        print(f"slots {label} frame={f} ({root.name}): host wall a frame, {rounds} rounds: "
              + "; ".join(f"{n} {' / '.join(f'{t:.1f}' for t in ts)} us"
                          for n, ts in times.items())
              + f"; max |copy - slots| {diff:.3e} [{card}]")


def count(card: str, dev) -> None:
    """Kernels a resident frame of the FM kernel chain and of its rotator
    stage, counted by ``chip_smoke.kernels_a_frame`` (this checkout's), on
    whichever ``futuresdr_tpu_torch`` is first on the path."""
    import futuresdr_tpu_torch
    cs = _chip_smoke()
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
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--resident", action="store_true")
    ap.add_argument("--slots", action="store_true")
    ap.add_argument("--k", default="1", help="frames a dispatch, a comma list")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--wires", default="f32", help="--split: wire formats, a comma list")
    ap.add_argument("--routes", default="fused,pallas", help="--split: routes, a comma list")
    args = ap.parse_args()
    ks = [int(k) for k in args.k.split(",")]
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
    if not _takes_k():
        ks = [1]                # a package without megabatch K
    if args.split:
        split(card, dev, ks, args.runs, args.wires.split(","), args.routes.split(","))
        return 0
    if args.resident:
        resident(card, dev, ks)
        return 0
    if args.slots:
        slots(card, dev, args.runs)
        return 0
    import futuresdr_tpu_torch
    root = Path(futuresdr_tpu_torch.__file__).resolve().parents[1].name
    taps = firdes.lowpass(0.2, N_TAPS).astype(np.float32)
    runs = [(route, _stages(route, taps), FRAME) for route in ("os", "pallas", "fused")]
    runs += [(f"fm {chain}", _fm_stages(chain), FM_FRAME) for chain in ("app", "kernel")]
    runs.append(("pfb pallas", _pfb_stages(), FRAME))
    for (label, stages, frame), k in ((r, k) for r in runs for k in ks):
        r = profile_route(stages, frame, dev, k=k)
        per_frame = 1.0 / (FRAMES + 1)          # + the kernel's warm-up frame
        print(f"profile {label} frame={frame} K={k} ({root}): wall {r['wall_us'] / 1e3:.1f} ms, device busy "
              f"{r['busy_us'] / 1e3:.2f} ms, idle share {1 - r['busy_us'] / r['wall_us']:.3f}; "
              f"per frame: wall {r['wall_us'] * per_frame:.1f} us, busy "
              f"{r['busy_us'] * per_frame:.1f} us [{card}]")
        for name, us in r["top"]:
            print(f"  {us * per_frame:9.2f} us/frame  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
