#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``futuresdr_tpu_torch``) on one GPU.

Drives the port's main path, the north-star spectrum chain (complex64 frames
through a 64-tap FIR, a 2048-point FFT and |x|^2), through the entry points a
user calls, at full width:

1. the card's name and power limit (``nvidia-smi``);
2. the kernels' build from ``futuresdr_tpu_torch/csrc`` with ``nvcc``;
3. each kernel against its plain PyTorch version on the card, at the path's
   shapes and at ragged ones, f32 and bf16;
4. the device-resident chain in three routes (overlap-save FIR,
   ``fir_stage(impl="pallas")`` on the ``fir`` kernel, ``fir_fft_stage`` on
   the ``fir_fft`` kernel) at frames 2^18 and 2^20, carry chained over 8
   frames: the kernel routes match overlap-save, and 8 chained frames match
   one long frame;
5. the streamed flowgraph, ``NullSource -> Head -> TpuKernel -> NullSink``
   with 4 frames in flight, and ``VectorSource -> TpuKernel -> VectorSink``
   against the resident chain;
6. a tap retune mid-stream through ``TpuKernel.apply_retune``;
7. one JSON line with each kernel's launches on the main path (phases 4-6),
   its error against the plain version, and its time beside the plain
   version's, a PyTorch library call's and its bound;
8. the resident and streamed rate of each route beside the card.

Every phase passes or the script exits nonzero. The last line is
``{"ok": true, "device": {...}}``. Needs one CUDA card and the CUDA toolkit
(``nvcc``); run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

N_TAPS = 64
N_FFT = 2048
FRAMES = (1 << 18, 1 << 20)
N_CHAIN = 8                  # carry-chained frames per resident check
STREAM_FRAMES = 64           # frames through the streamed flowgraph
STREAM_RUNS = 3              # streamed runs per route (median)
IN_FLIGHT = 4
REPS = 20                    # timed repetitions (median)
SEED = 1234
DEVICE = "cuda:0"            # the one card

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, FP32 FLOP/s outside the
# tensor cores (the kernels' FP32 FMA path)
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12

# Kernel vs plain: max |kernel - plain| <= TOL * max |plain|. Both sum the
# taps in the same order; they differ by the kernel's fused multiply-adds
# (fir) and by FFT against DFT-matmul rounding (fir_fft).
TOL = {"fir": 1e-5, "fir_fft": 1e-4}
# Route agreement (fir kernel / fused kernel vs overlap-save via cuFFT) and
# chained-vs-long-frame, relative to the peak of the reference output.
ROUTE_TOL = 1e-4
CHAIN_TOL = 1e-5

REPLACES = {"fir": "futuresdr_tpu/ops/pallas_kernels.py:115",
            "fir_fft": "futuresdr_tpu/ops/pallas_kernels.py:408"}
SOURCES = {"fir": "futuresdr_tpu_torch/csrc/fir.cu",
           "fir_fft": "futuresdr_tpu_torch/csrc/fir_fft.cu"}


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def rel_err(got, ref) -> tuple:
    """``(max |got - ref|, that over max |ref|)`` in float64 on the host."""
    g = got.detach().cpu().numpy().astype(np.complex128)
    r = ref.detach().cpu().numpy().astype(np.complex128)
    err = float(np.max(np.abs(g - r))) if r.size else 0.0
    peak = float(np.max(np.abs(r))) if r.size else 0.0
    return err, err / max(peak, 1e-30)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def cuda_ms(fn, reps: int = 0) -> float:
    """Median time between CUDA events around ``fn()`` over ``reps`` runs:
    device time plus any wait for the host, the rate an eager caller gets."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps or REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, args_list, reps: int = 0) -> float:
    """Median device time of one ``fn(*args)`` call, without host overhead:
    the calls over every ``args`` in ``args_list`` are captured in one CUDA
    graph, and each timed replay runs behind a device sleep, so the host
    enqueues it before the device reaches it. Distinct inputs per call keep
    them out of L2 when ``args_list`` holds more than 50 MB."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm-up: library plans and handles
        for a in args_list[:2]:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn(*a) for a in args_list]
    times = []
    for _ in range(reps or REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / len(args_list))
    del graph, outs
    return statistics.median(times)


def randc(n: int, gen, dev):
    import torch
    return torch.randn(n, dtype=torch.complex64, generator=gen, device=dev)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_cases(dev):
    """(kernel, label, kernel call, plain call) at the path's shapes and at
    ragged ones."""
    import torch

    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    gen = torch.Generator(device=dev).manual_seed(SEED)
    frames, n_fft, nt = FRAMES, N_FFT, N_TAPS

    def real(n):
        return torch.randn(n, dtype=torch.float32, generator=gen, device=dev)

    cases = []
    for n in frames:
        x, hist, taps = randc(n, gen, dev), randc(nt - 1, gen, dev), real(nt)
        for prec in (None, "bf16"):
            cases.append(("fir", f"fir_continue c64 n={n} nt={nt} {prec or 'f32'}",
                          lambda x=x, h=hist, t=taps, p=prec: ck.fir_continue(h, x, t, p),
                          lambda x=x, h=hist, t=taps, p=prec: ck.fir_continue_plain(h, x, t, p)))
            cases.append(("fir_fft", f"fir_fft c64 n={n} nt={nt} n_fft={n_fft} {prec or 'f32'}",
                          lambda x=x, h=hist, t=taps, p=prec: ck.fir_fft(h, x, t, n_fft, p),
                          lambda x=x, h=hist, t=taps, p=prec: ck.fir_fft_plain(h, x, t, n_fft, p)))
        cases.append(("fir", f"fir c64 n={n} nt={nt} zero state",
                      lambda x=x, t=taps: ck.fir(x, t),
                      lambda x=x, t=taps: ck.fir_plain(x, t)))
    # ragged: a frame that is not a multiple of the tile, a real stream,
    # short taps, small and non-power-of-two transforms, ragged row counts
    xr, t17 = real(frames[0] + 1000), real(17)
    for prec in (None, "bf16"):
        cases.append(("fir", f"fir f32 n={frames[0] + 1000} nt=17 {prec or 'f32'}",
                      lambda p=prec: ck.fir(xr, t17, p),
                      lambda p=prec: ck.fir_plain(xr, t17, p)))
    for nf, ntt, rows, cplx in ((128, 17, 7, True), (1000, 33, 5, True),
                                (2047, 64, 3, True), (256, 64, 9, False)):
        x = randc(nf * rows, gen, dev) if cplx else real(nf * rows)
        hist = randc(ntt - 1, gen, dev) if cplx else real(ntt - 1)
        t = real(ntt)
        for prec in (None, "bf16"):
            cases.append(("fir_fft",
                          f"fir_fft {'c64' if cplx else 'f32'} n_fft={nf} nt={ntt} "
                          f"rows={rows} {prec or 'f32'}",
                          lambda x=x, h=hist, t=t, nf=nf, p=prec: ck.fir_fft(h, x, t, nf, p),
                          lambda x=x, h=hist, t=t, nf=nf, p=prec:
                          ck.fir_fft_plain(h, x, t, nf, p)))
    return cases


def phase_kernels(dev) -> dict:
    """Every case within its tolerance; returns the worst error per kernel."""
    import torch
    worst = {"fir": 0.0, "fir_fft": 0.0}
    for name, label, kern, plain in kernel_cases(dev):
        got = kern()
        ref = plain()
        check(got.shape == ref.shape and got.dtype == ref.dtype,
              f"{label}: kernel gives {tuple(got.shape)} {got.dtype}, plain "
              f"{tuple(ref.shape)} {ref.dtype}")
        check(bool(torch.isfinite(torch.view_as_real(got) if got.is_complex()
                                  else got).all()), f"{label}: non-finite output")
        err, rel = rel_err(got, ref)
        print(f"kernel {label}: max_abs_err {err:.3e} ({rel:.3e} of peak, tol {TOL[name]:g})")
        check(rel <= TOL[name], f"{label}: error {rel:.3e} of peak over {TOL[name]:g}")
        worst[name] = max(worst[name], err)
    return worst


# ---------------------------------------------------------------------------
# phases 4-6: the main path
# ---------------------------------------------------------------------------

def chain_stages(route: str, taps):
    from futuresdr_tpu_torch.ops.stages import (fft_stage, fir_fft_stage, fir_stage,
                                                mag2_stage)
    if route == "fused":
        return [fir_fft_stage(taps, N_FFT), mag2_stage()]
    return [fir_stage(taps, impl=route), fft_stage(N_FFT), mag2_stage()]


ROUTES = ("os", "pallas", "fused")
ROUTE_KERNEL = {"os": None, "pallas": "fir", "fused": "fir_fft"}


def run_resident(route, taps, frames, dev):
    """The chain over ``frames`` (a list of device tensors), carry chained."""
    import torch

    from futuresdr_tpu_torch.ops.stages import Pipeline
    pipe = Pipeline(chain_stages(route, taps), np.complex64)
    fn, carry = pipe.fn(), pipe.init_carry(dev)
    outs = []
    for x in frames:
        carry, y = fn(carry, x)
        outs.append(y)
    return torch.cat(outs)


def phase_resident(dev, taps) -> dict:
    """Routes agree, chained equals one long frame; returns Msps per
    (route, frame)."""
    import torch

    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    from futuresdr_tpu_torch.ops.stages import Pipeline
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rates, n_chain = {}, N_CHAIN
    for f in FRAMES:
        xs = [randc(f, gen, dev) for _ in range(n_chain)]
        ref = None
        for route in ROUTES:
            before = dict(ck.launches)
            chained = run_resident(route, taps, xs, dev)
            long_ = run_resident(route, taps, [torch.cat(xs)], dev)
            k = ROUTE_KERNEL[route]
            if k is not None:
                check(ck.launches[k] > before[k],
                      f"resident {route} frame={f}: kernel {k} was not launched")
            check(chained.shape == (n_chain * f,) and chained.dtype == torch.float32,
                  f"resident {route}: output {tuple(chained.shape)} {chained.dtype}")
            check(bool(torch.isfinite(chained).all()), f"resident {route}: non-finite")
            _, rel = rel_err(chained, long_)
            print(f"resident {route} frame={f}: {n_chain} chained vs one long frame "
                  f"{rel:.3e} of peak (tol {CHAIN_TOL:g})")
            check(rel <= CHAIN_TOL, f"resident {route} frame={f}: chained frames "
                                    f"differ from one long frame by {rel:.3e}")
            if ref is None:
                ref = chained
            else:
                _, rel = rel_err(chained, ref)
                print(f"resident {route} frame={f}: vs overlap-save {rel:.3e} of peak "
                      f"(tol {ROUTE_TOL:g})")
                check(rel <= ROUTE_TOL, f"resident {route} frame={f}: differs from "
                                        f"overlap-save by {rel:.3e}")
            pipe = Pipeline(chain_stages(route, taps), np.complex64)
            fn, state = pipe.fn(), [pipe.init_carry(dev)]

            def step(fn=fn, state=state, xs=xs):
                c = state[0]
                for x in xs:
                    c, _ = fn(c, x)
                state[0] = c

            ms = cuda_ms(step)
            rates[(route, f)] = n_chain * f / (ms * 1e-3) / 1e6
    return rates


def _stream_kernel(route, taps, frame, dev):
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
    return TpuKernel(chain_stages(route, taps), np.complex64, frame_size=frame,
                     inst=TpuInstance(dev), frames_in_flight=IN_FLIGHT)


def phase_streamed(dev, taps) -> dict:
    """NullSource -> Head -> TpuKernel -> NullSink per route (item count and
    rate), and VectorSource -> TpuKernel -> VectorSink against the resident
    chain; returns streamed Msps per route."""
    import torch

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import (Head, NullSink, NullSource, VectorSink,
                                            VectorSource)
    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    rates, frame = {}, FRAMES[0]
    n_items = STREAM_FRAMES * frame
    for route in ROUTES:
        runs = []
        for _ in range(STREAM_RUNS):
            before = dict(ck.launches)
            fg = Flowgraph()
            snk = NullSink(np.float32)
            fg.connect(NullSource(np.complex64), Head(np.complex64, n_items),
                       _stream_kernel(route, taps, frame, dev), snk)
            rt = Runtime()
            t0 = time.perf_counter()
            rt.run(fg)
            runs.append(time.perf_counter() - t0)
            rt.shutdown()
            check(snk.n_received == n_items,
                  f"streamed {route}: NullSink got {snk.n_received} items, want {n_items}")
            k = ROUTE_KERNEL[route]
            if k is not None:
                check(ck.launches[k] > before[k], f"streamed {route}: kernel {k} not launched")
        rates[route] = n_items / statistics.median(runs) / 1e6
        print(f"streamed {route}: {n_items} items through NullSource -> Head -> "
              f"TpuKernel -> NullSink in {', '.join(f'{t:.3f}' for t in runs)} s")

    # VectorSource -> TpuKernel -> VectorSink, with a partial last frame,
    # against the resident chain over the same zero-padded frames
    rng = np.random.default_rng(SEED + 2)
    tail = 3 * N_FFT + 100
    host = (rng.standard_normal(8 * frame + tail)
            + 1j * rng.standard_normal(8 * frame + tail)).astype(np.complex64)
    for route in ROUTES:
        kern = _stream_kernel(route, taps, frame, dev)
        fm = kern.pipeline.frame_multiple
        fg = Flowgraph()
        vsnk = VectorSink(np.float32)
        fg.connect(VectorSource(host), kern, vsnk)
        rt = Runtime()
        rt.run(fg)
        rt.shutdown()
        got = vsnk.items()
        want_n = 8 * frame + tail - tail % fm
        check(len(got) == want_n, f"vector {route}: {len(got)} items, want {want_n}")
        padded = np.zeros(9 * frame, np.complex64)
        padded[:len(host)] = host
        xs = [torch.from_numpy(padded[i * frame:(i + 1) * frame]).to(dev) for i in range(9)]
        ref = run_resident(route, taps, xs, dev)[:want_n]
        _, rel = rel_err(torch.from_numpy(got), ref)
        print(f"vector {route}: {len(got)} items, vs resident chain {rel:.3e} of peak")
        check(rel <= CHAIN_TOL, f"vector {route}: differs from the resident chain by {rel:.3e}")
    return rates


def phase_retune(dev, taps, taps2) -> None:
    """Swap the taps while frames stream; the output must equal the resident
    chain with the swap at the frame the kernel reports."""
    import torch

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
    from futuresdr_tpu_torch.ops.stages import Pipeline
    frame, n_frames = FRAMES[0], STREAM_FRAMES
    rng = np.random.default_rng(SEED + 3)
    host = (rng.standard_normal(n_frames * frame)
            + 1j * rng.standard_normal(n_frames * frame)).astype(np.complex64)
    for route in ("pallas", "fused"):
        kern = _stream_kernel(route, taps, frame, dev)
        fg = Flowgraph()
        vsnk = VectorSink(np.float32)
        fg.connect(VectorSource(host), kern, vsnk)
        rt = Runtime()
        running = rt.start(fg)
        deadline = time.monotonic() + 60
        while kern.frames_dispatched < 4:
            check(time.monotonic() < deadline, f"retune {route}: stream did not start")
            time.sleep(0.0005)
        at = kern.apply_retune(0, taps=taps2)
        running.wait_sync()
        rt.shutdown()
        check(0 < at < n_frames, f"retune {route}: landed at frame {at} of {n_frames}, "
                                 f"not mid-stream")
        pipe = Pipeline(chain_stages(route, taps), np.complex64)
        fn, carry = pipe.fn(), pipe.init_carry(dev)
        outs = []
        for i in range(n_frames):
            if i == at:
                carry = pipe.update_stage(carry, 0, taps=taps2)
            carry, y = fn(carry, torch.from_numpy(host[i * frame:(i + 1) * frame]).to(dev))
            outs.append(y)
        _, rel = rel_err(torch.from_numpy(vsnk.items()), torch.cat(outs))
        print(f"retune {route}: taps swapped at frame {at} of {n_frames}; vs resident "
              f"chain with the same swap {rel:.3e} of peak")
        check(rel <= CHAIN_TOL, f"retune {route}: differs by {rel:.3e}")


# ---------------------------------------------------------------------------
# phase 7: kernel timings beside their bounds
# ---------------------------------------------------------------------------

def kernel_timings(dev, n: int, taps_np) -> dict:
    """Kernel, plain and library device time and the bound of each kernel on
    the main path's call at frame ``n`` (complex64, 64 taps, N = 2048)."""
    import torch
    import torch.nn.functional as F

    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    nt, n_fft = N_TAPS, N_FFT
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    taps = torch.from_numpy(taps_np).to(dev)
    # REPS distinct frames per graph: 20 x 16 B x 2^18 = 84 MB > L2
    args = [(randc(nt - 1, gen, dev), randc(n, gen, dev)) for _ in range(REPS)]
    w = taps.flip(0).view(1, 1, nt).contiguous()   # conv1d correlates
    # library yardsticks, timed only here and never called by the port:
    # conv1d over the two float planes, then torch.fft for fir_fft
    planes = [(torch.view_as_real(torch.cat([h, x])).t().contiguous().unsqueeze(1),)
              for h, x in args]

    def lib_fir(p):
        return F.conv1d(p, w)

    def lib_fir_fft(p):
        y = F.conv1d(p, w)
        return torch.fft.fft(torch.complex(y[0, 0], y[1, 0]).view(-1, n_fft), dim=1)

    io_bytes = (n + nt - 1) * 8 + nt * 4 + n * 8
    work = {
        "fir": (lambda h, x: ck.fir_continue(h, x, taps),
                lambda h, x: ck.fir_continue_plain(h, x, taps), lib_fir,
                io_bytes, 4 * nt * n),
        "fir_fft": (lambda h, x: ck.fir_fft(h, x, taps, n_fft),
                    lambda h, x: ck.fir_fft_plain(h, x, taps, n_fft), lib_fir_fft,
                    io_bytes + n_fft * 8,
                    n * (4 * nt + 5 * int(np.log2(n_fft)))),
    }
    out = {}
    for name, (kern, plain, lib, nbytes, flops) in work.items():
        err, _ = rel_err(kern(*args[0]), plain(*args[0]))
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
        out[name] = {
            "ms": device_ms(kern, args), "plain_ms": device_ms(plain, args),
            "library_ms": device_ms(lib, planes),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": err,
        }
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a "
              "CUDA card", file=sys.stderr)
        return 2
    from futuresdr_tpu_torch.dsp import firdes
    from futuresdr_tpu_torch.ops import _build
    from futuresdr_tpu_torch.ops import cuda_kernels as ck

    # 1. the card
    card_line = card()
    print(card_line)
    dev = torch.device(DEVICE)

    # 2. build every kernel from the checkout's sources, nvcc runs in parallel
    t0 = time.perf_counter()
    paths = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s, "
          f"{', '.join(p.name for p in paths)} for sm_90a")

    # 3. kernels against their plain versions
    worst = phase_kernels(dev)

    # 4-6. the main path, launch counts read over exactly these phases
    taps = firdes.lowpass(0.2, N_TAPS).astype(np.float32)
    taps2 = firdes.lowpass(0.05, N_TAPS).astype(np.float32)
    ck.reset_launches()
    by_phase = {}
    resident = phase_resident(dev, taps)
    by_phase["resident"] = dict(ck.launches)
    streamed = phase_streamed(dev, taps)
    by_phase["streamed"] = {k: v - by_phase["resident"][k] for k, v in ck.launches.items()}
    phase_retune(dev, taps, taps2)
    torch.cuda.synchronize()
    main_launches = dict(ck.launches)
    by_phase["retune"] = {k: v - by_phase["resident"][k] - by_phase["streamed"][k]
                          for k, v in main_launches.items()}
    for k in main_launches:
        for phase, counts in by_phase.items():
            check(counts[k] > 0, f"kernel {k} was launched no time in the {phase} phase "
                                 f"of the main path")

    # 7. kernel timings at the streamed default frame, and at 2^20 for the record
    timings = {f: kernel_timings(dev, f, taps) for f in FRAMES}
    for f, t in timings.items():
        for k, v in t.items():
            print(f"timing {k} n={f}: kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms,"
                  f" library {v['library_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms "
                  f"({v['bound_by']}) [{card_line}]")
    line = {"kernels": []}
    for k in ("fir", "fir_fft"):
        t = timings[FRAMES[0]][k]
        line["kernels"].append({
            "name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
            "launches": main_launches[k],
            "launches_by_phase": {p: c[k] for p, c in by_phase.items()},
            "max_abs_err": max(worst[k], t["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(json.dumps(line))

    # 8. rates beside the card
    for route in ROUTES:
        for f in FRAMES:
            print(f"rate {route} resident frame={f}: {resident[(route, f)]:.1f} Msamples/s "
                  f"[{card_line}]")
        print(f"rate {route} streamed frame={FRAMES[0]} in-flight={IN_FLIGHT} "
              f"(median of {STREAM_RUNS}): {streamed[route]:.1f} Msamples/s [{card_line}]")
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
