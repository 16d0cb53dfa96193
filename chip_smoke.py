#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``futuresdr_tpu_torch``) on one GPU.

Drives the port's main path, the north-star spectrum chain (complex64 frames
through a 64-tap FIR, a 2048-point FFT and |x|^2), through the entry points a
user calls, at full width:

1. the card's name and power limit (``nvidia-smi``);
2. the kernels' build from ``futuresdr_tpu_torch/csrc`` with ``nvcc``;
3. each kernel against its plain PyTorch version on the card, at the path's
   shapes and at ragged ones, f32 and bf16, and at the edges of the
   ``fir``, ``fir_fft``, ``poly_fir`` and ``pfb`` tiling plans
   (``ops/cuda_kernels.py``);
4. the device-resident chain in three routes (overlap-save FIR,
   ``fir_stage(impl="pallas")`` on the ``fir`` kernel, ``fir_fft_stage`` on
   the ``fir_fft`` kernel) at frames 2^18 and 2^20, carry chained over 8
   frames: the kernel routes match overlap-save, and 8 chained frames match
   one long frame;
5. the streamed flowgraph, ``NullSource -> Head -> TpuKernel -> NullSink``
   with 4 frames in flight, and ``VectorSource -> TpuKernel -> VectorSink``
   against the resident chain;
6. a tap retune mid-stream through ``TpuKernel.apply_retune``;
7. one JSON line with each kernel's launches on its path (the spectrum chain
   in phases 4-6, the FM front end in phases 10-11), its error against the
   plain version, and its time beside the plain version's, a PyTorch library
   call's and its bound; each timing line also shows the call's time in
   PERF.md before the kernel's latest redesign, and for ``rotator`` and
   ``quad_demod`` two yardsticks: a kernel with no body on the same grid and
   a PyTorch copy of the same bytes;
8. the resident and streamed rate of each route beside the card.

The FM front end (``futuresdr_tpu_torch/apps/fm_receiver.py``: complex64 at
1 Msps, 100 kHz offset, 128-tap channel filter decimating by 4, FM gain
250e3/(2π·75e3), 24/125 audio resampler with its 4533 default taps), in two
chains: the app's (``front_end_stages``: xlating FIR, demod, resampler) and
the kernel chain (``rotator_stage``, ``fir_stage(decim=4)``,
``quad_demod_stage``, ``resample_stage``, each pinned to ``impl="pallas"``):

9. the ``rotator``, ``poly_fir`` and ``quad_demod`` kernels against their
   plain versions at the FM shapes, ragged ones, large phases and bf16; the
   views ``x[1:]`` (a head sample before the first 16-byte word) and
   ``x[:-1]``, 1-3 samples and one block's tile +- 1; the rotator's
   next phase equal to ``torch.remainder`` bit for bit, also beside +-π;
10. both chains resident at frames 512,000 and 4,096,000, carry chained over
    8 frames: the kernel chain matches the same chain on plain PyTorch ops,
    chained frames match one long frame, and the app chain matches the
    kernel chain after the filters' transient;
11. streamed: ``NullSource -> Head -> TpuKernel -> NullSink`` with 4 frames in
    flight per chain, ``build_flowgraph(VectorSource(fm), use_tpu=True,
    audio_path=…)`` with the WAV's tone at 1 kHz, and a mid-stream
    ``apply_retune("tuner", phase_inc=…)`` on both chains; then the kernels
    one resident frame of the kernel chain launches, by ``torch.profiler``,
    and of its ``rotator_stage`` alone, which must be one.

The PFB channelizer at PFB-64 (``channelizer_stage(64)`` with its default
768-tap prototype, K = 12 taps a branch), and the spectrum app:

12. the ``pfb`` kernel against its plain version at PFB-64 (t = 4096, f32 and
    bf16), at ragged t (1 and 37), at N = 5, 24, 1000, 1024, 2048 and 4096
    (from N = 1024 on, the channels staged 512 at a time), at K = 1, and in
    the plan's "v" layout (rows too wide to stage) forced at N = 2048 and
    1000; in bf16 also the kernel run in float32 mode on the same inputs,
    which must fall below the bf16 limit;
13. the channelizer resident on both routes (``matmul``: windows einsum and
    ``torch.fft.ifft``; ``pallas``: the ``pfb`` kernel) at frames 2^18 and
    2^21, carry chained over 8 frames: the routes agree at >= 80 dB, chained
    frames match one long frame, and a tone at channel 3's and channel 40's
    centre lands in its own output; the stage's default ``impl="auto"``
    launches the kernel and gives the ``pallas`` route's output, at PFB-64
    and at PFB-2048 (against ``matmul`` there);
14. streamed: ``NullSource -> Head -> TpuKernel -> NullSink`` with 4 frames in
    flight, ``VectorSource -> TpuKernel -> StreamDeinterleaver(64) -> 64
    VectorSinks`` against the resident chain and the host ``PfbChannelizer``
    block, and a prototype swap mid-stream through ``apply_retune``;
15. the spectrum app, ``apps/spectrum.py`` ``build_flowgraph(VectorSource(…),
    use_tpu=True, collect=True)`` at FFT_SIZE 2048 over 32,768-sample frames:
    the tone's bin, and the spectra against a float64 recomputation.

The host side of the main path (``Pipeline.compile``: one CUDA graph a
dispatch of K frames, the carry in static buffers; ``TpuKernel``'s
megabatch K, pinned staging arena and credits), on every chain above
(spectrum routes, spectrum app, FM app, kernel and plain chains, PFB-64 on
both routes) at the frames of their resident phases:

16. each chain compiled at K = 1 and 4 against the eager chain over three
    chained dispatches (CHAIN_TOL), one capture each, each replay adding
    its graph's launches to the counts; a retune through the compiled carry
    (FIR taps, the FM tuner's phase_inc, the PFB prototype) with no new
    capture, against the eager chain with the same retune; the resident
    rate of eager and compiled beside the card's time a frame;
17. streamed, ``VectorSource -> TpuKernel -> VectorSink`` at K = 4 against
    K = 1 (the same items, a partial last group at EOS), the streamed rate
    at each K, and the arena's takes from its pool against its allocations.

Every streamed phase runs through the compiled program and the arena, and
the ``kernels`` line counts the launches the replays made.

The message plane, the REST control port, the apps' ``main()`` and the
double-mapped circular buffer (``runtime/buffer/circular.py`` over
``csrc/host/ringbuf.cpp``, built with ``g++``; the script fails if it does
not build, so every streamed phase runs on it):

18. ``MessageSource -> MessageCopy -> MessageSink``, then ``handle.call``,
    ``post``, ``describe`` and ``metrics`` against a running streamed
    ``TpuKernel`` (the fused spectrum chain), its taps retuned through its
    ``ctrl`` port;
19. the FM app's card flowgraph (its default) with the Seify dummy radio (its tone at
    0.1·fs), the tuner at 75 kHz moved to 90 kHz by a POST of
    ``{"stage": "tuner", "phase_inc": θ}`` to the REST control port: the
    reply is ``Ok``, each audio frame's mean (the discriminator's DC level)
    is the gain's level for 25 kHz before and 10 kHz after within 2%, a
    malformed map is answered ``InvalidValue``; the round trip and the
    frames from the POST to the first retuned frame are printed;
20. both apps' ``main()`` as subprocesses: the FM receiver on the card (its
    default) with ``--wav`` and ``25000`` then ``q`` on stdin (exit 0, a WAV with audio),
    the spectrum app with ``--samples`` and ``--ws-port`` read by a
    standard-library websocket client (a 2048-float spectrum peaking at the
    dummy tone's bin);
21. the streamed spectrum fused chain at 2^18 and FM kernel chain at 512,000
    on the circular buffer and on the ring: bit-equal outputs, and the
    streamed input rates at K = 1 and 4 on each.

``python3 chip_smoke.py --stress N`` runs only phases 4 and 10 once, then the
streamed phases 5 and 11 N times each, each run under a stall watchdog that
prints every thread's stack, the pending asyncio tasks and the block inboxes
and rings before it exits.

Every phase passes or the script exits nonzero. The last line is
``{"ok": true, "device": {...}}``. Needs one CUDA card and the CUDA toolkit
(``nvcc``); run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import ctypes
import faulthandler
import json
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

N_TAPS = 64
N_FFT = 2048
FRAMES = (1 << 18, 1 << 20)
FIR_FFT_EDGE_N = (2, 16, 4096, 8192)   # fir_fft plan edges checked in phase 3
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
# (fir, poly_fir), by FFT against DFT-matmul rounding (fir_fft) and by the
# rotator's 2π reduction in double before its sincosf (~2e-7 of peak). quad_demod: max |kernel - plain| <= TOL in
# radians·gain, absolute, after wrapping atan2's ±π branch.
TOL = {"fir": 1e-5, "fir_fft": 1e-4, "rotator": 1e-5, "poly_fir": 1e-5,
       "quad_demod": 1e-5, "pfb": 1e-5}
# Route agreement (fir kernel / fused kernel vs overlap-save via cuFFT) and
# chained-vs-long-frame, relative to the peak of the reference output.
ROUTE_TOL = 1e-4
CHAIN_TOL = 1e-5

# FM front end (futuresdr_tpu_torch/apps/fm_receiver.py at its published width)
FM_RATE = 1e6
FM_OFFSET = 100e3
FM_FRAMES = (512_000, 4_096_000)
FM_CHAIN = 8                 # carry-chained frames per resident check
FM_STREAM_FRAMES = 64        # frames through the streamed flowgraph
FM_WAV_SAMPLES = 1_500_000   # input of the app's WAV run (the default frame)
FM_TRANSIENT = 200           # audio samples skipped before chain comparisons
# Tolerances, in audio units (the test tone's amplitude is 1):
# - kernel chain vs the same chain on plain PyTorch ops: the kernels repeat
#   the plain versions' arithmetic; only summation order and 1-ulp sincos /
#   atan2 differences remain;
# - chained frames vs one long frame at offset 0 (every carry chained, the
#   phase ramps exactly zero);
# - at the 100 kHz offset, chained vs long and app vs kernel chain differ by
#   the float32 phase ramp ph0 + inc·t, whose ulp grows with t: 0.03 rad at
#   t = 5e5 and 0.25 rad at t = 4e6. The reference's folded-vs-unfolded atol
#   5e-3 (tests/test_retune.py:322) holds at the 512,000 frame; the longer
#   frames get FM_PHASE_TOL.
FM_PLAIN_TOL = 1e-4
FM_CHAIN_TOL = 1e-4
FM_APP_TOL = 5e-3
FM_PHASE_TOL = 5e-2
FM_GAIN = 250e3 / (2 * np.pi * 75e3)

# PFB channelizer (channelizer_stage(64) with pfb_default_taps(64): K = 12)
PFB_N = 64
PFB_FRAMES = (1 << 18, 1 << 21)
PFB_CHAIN = 8                # carry-chained frames per resident check
PFB_STREAM_FRAMES = 64       # frames through the streamed flowgraph
PFB_VECTOR_FRAMES = 8        # frames through the deinterleaved flowgraph
PFB_TONE_CHANNELS = (3, 40)
PFB_WIDE_N = 2048            # auto at a width whose rows and taps are not staged
# bf16 kernel vs plain: the plain version rounds its cos/sin matrix to bf16,
# as the JAX kernel does, while the kernel keeps float32 twiddles, so the two
# are held by SNR. The limit lies between the bf16 kernel's reading against
# the plain version and the reading of the kernel in float32 mode (a bf16
# mode that did nothing) on the same inputs; phase 12 checks both sides. On
# an H100 80GB HBM3 the two read 57.6-59.3 dB and 51.4-51.8 dB (PFB-2048 and
# PFB-64).
PFB_BF16_SNR = 54.5
PFB_ROUTE_SNR = 80.0         # pallas vs matmul route (tests/test_precision.py)
PFB_TONE_RATIO = 100.0       # tone channel power over any other (test_dsp_blocks.py)
# deinterleaved flowgraph vs the host block: |got - ref| <= atol·peak + rtol·|ref|
# (tests/test_tpu_stages.py)
PFB_BLOCK_RTOL, PFB_BLOCK_ATOL = 1e-3, 1e-4

# the spectrum app (apps/spectrum.py at its FFT_SIZE 2048, frame 32,768)
SPEC_FRAMES = 64             # app frames streamed
SPEC_TONE = 0.3              # tone frequency, cycles/sample
# app output vs the float64 recomputation: in dB once the EMA has averaged
# 32 spectra (0.9^32 = 3% weight left on the first); before that a noise bin
# can sit near zero power, where float32 FFT rounding is large in dB, so the
# first 32 are held in power relative to each spectrum's peak.
SPEC_SETTLE = 32
SPEC_DB_TOL = 1e-3
SPEC_POWER_TOL = 1e-5

# the host side of the main path (phases 16-17): frames a dispatch compiled
# and streamed, chained dispatches per compiled check; compiled vs eager is
# held at CHAIN_TOL (the same kernels on the same inputs), a retune through
# the compiled carry too, and K = 4 streamed vs K = 1 streamed as well
HOST_K = (1, 4)
HOST_DISPATCHES = 3
# device sleep before a timed run of calls (~60 ms): the host enqueues them
# all before the card reaches the first, so the card's time is what is timed
HOST_SLEEP_CYCLES = 100_000_000

REPLACES = {"fir": "futuresdr_tpu/ops/pallas_kernels.py:115",
            "fir_fft": "futuresdr_tpu/ops/pallas_kernels.py:408",
            "rotator": "futuresdr_tpu/ops/pallas_kernels.py:535",
            "poly_fir": "futuresdr_tpu/ops/pallas_kernels.py:326",
            "quad_demod": "futuresdr_tpu/ops/pallas_kernels.py:597",
            "pfb": "futuresdr_tpu/ops/pallas_kernels.py:225"}
SOURCES = {k: f"futuresdr_tpu_torch/csrc/{k}.cu" for k in REPLACES}
# Each timed call's time in PERF.md's kernel table before the kernel's latest
# redesign (NVIDIA H100 80GB HBM3, 700.00 W), in ms, printed beside the time
# measured now.
EARLIER_MS = {
    ("fir", 1 << 18): 0.0087, ("fir", 1 << 20): 0.0241,
    ("fir_fft", 1 << 18): 0.0174, ("fir_fft", 1 << 20): 0.0517,
    ("rotator", 512_000): 0.0058, ("rotator", 4_096_000): 0.0254,
    ("poly_fir", 512_000): 0.0218, ("poly_fir", 4_096_000): 0.1066,
    ("poly_fir/channel", 512_000): 0.0139, ("poly_fir/resampler", 512_000): 0.0080,
    ("poly_fir/resampler", 4_096_000): 0.0298,
    ("quad_demod", 512_000): 0.0020, ("quad_demod", 4_096_000): 0.0068,
    ("pfb", 1 << 18): 0.0103, ("pfb", 1 << 21): 0.0391, ("pfb/N=2048", 1 << 18): 0.0474,
}
SPECTRUM_KERNELS = ("fir", "fir_fft")
FM_KERNELS = ("rotator", "poly_fir", "quad_demod")
PFB_KERNELS = ("pfb",)


# A kernel with no body, launched on a given grid: the cost of a launch alone,
# a yardstick for the FM kernels' timings. Built here beside the port's
# kernels; no library of the port holds it.
EMPTY_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int fsdr_empty(unsigned blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
"""


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


def snr_db(got, ref) -> float:
    """``10·log10(mean |ref|² / mean |got - ref|²)`` in float64 on the host."""
    g = got.detach().cpu().numpy().astype(np.complex128)
    r = ref.detach().cpu().numpy().astype(np.complex128)
    err = float(np.mean(np.abs(g - r) ** 2))
    return float(10 * np.log10(np.mean(np.abs(r) ** 2) / max(err, 1e-300)))


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
    # a tap set too long for padded spans: the plan takes one unpadded warp a block
    xl, hl, tl = randc(20_000, gen, dev), randc(17_999, gen, dev), real(18_000)
    cases.append(("fir", "fir_continue c64 n=20000 nt=18000 f32 (one unpadded warp)",
                  lambda: ck.fir_continue(hl, xl, tl),
                  lambda: ck.fir_continue_plain(hl, xl, tl)))
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
    # the plan's edges: one-pass and two-pass transforms, the largest rows
    # (8192 with 8192 taps falls back to the unpadded layout with the
    # twiddles read from device memory), the shortest and longest tap sets
    for nf in FIR_FFT_EDGE_N:
        for ntt in (2, nf):
            x, hist, t = randc(nf, gen, dev), randc(ntt - 1, gen, dev), real(ntt)
            for prec in (None, "bf16"):
                cases.append(("fir_fft", f"fir_fft c64 n_fft={nf} nt={ntt} rows=1 "
                                         f"{prec or 'f32'}",
                              lambda x=x, h=hist, t=t, nf=nf, p=prec: ck.fir_fft(h, x, t, nf, p),
                              lambda x=x, h=hist, t=t, nf=nf, p=prec:
                              ck.fir_fft_plain(h, x, t, nf, p)))
    return cases


def demod_err(got, ref) -> float:
    """max |got - ref| after wrapping the difference into (−π·gain, π·gain]:
    at Im z ≈ ±0 with Re z < 0, atan2 flips between +π and −π on a last-bit
    difference of its arguments."""
    period = 2 * np.pi * FM_GAIN
    d = got.detach().cpu().double() - ref.detach().cpu().double()
    d = d - period * (d / period).round()
    return float(d.abs().max()) if d.numel() else 0.0


def phase_kernels(dev, cases) -> dict:
    """Every case within its tolerance; returns the worst error per kernel."""
    import torch
    worst = {}
    for name, label, kern, plain in cases:
        got = kern()
        ref = plain()
        if name == "quad_demod":
            (got, last), (ref, ref_last) = got, ref
            check(last.item() == ref_last.item(), f"{label}: carry sample differs")
        if name == "rotator":
            (got, ph_next), (ref, ref_next) = got, ref
            check(ph_next.shape == ref_next.shape and ph_next.item() == ref_next.item(),
                  f"{label}: next phase {ph_next.item()!r}, torch.remainder gives "
                  f"{ref_next.item()!r}")
        check(got.shape == ref.shape and got.dtype == ref.dtype,
              f"{label}: kernel gives {tuple(got.shape)} {got.dtype}, plain "
              f"{tuple(ref.shape)} {ref.dtype}")
        check(bool(torch.isfinite(torch.view_as_real(got) if got.is_complex()
                                  else got).all()), f"{label}: non-finite output")
        if name == "quad_demod":
            err = rel = demod_err(got, ref)
            print(f"kernel {label}: max_abs_err {err:.3e} (wrapped, tol {TOL[name]:g})")
        elif name == "pfb" and label.endswith("bf16"):
            err, _ = rel_err(got, ref)
            snr = snr_db(got, ref)
            off = snr_db(kern.f32_mode(), ref)
            print(f"kernel {label}: max_abs_err {err:.3e}, {snr:.2f} dB against the "
                  f"plain version (min {PFB_BF16_SNR:g} dB); the kernel in f32 mode "
                  f"{off:.2f} dB (must fall below)")
            check(snr >= PFB_BF16_SNR, f"{label}: {snr:.2f} dB under {PFB_BF16_SNR:g}")
            check(off < PFB_BF16_SNR, f"{label}: the f32-mode kernel reads {off:.2f} dB, "
                                      f"the limit {PFB_BF16_SNR:g} cannot tell bf16 apart")
            worst[name] = max(worst.get(name, 0.0), err)
            continue
        else:
            err, rel = rel_err(got, ref)
            print(f"kernel {label}: max_abs_err {err:.3e} ({rel:.3e} of peak, "
                  f"tol {TOL[name]:g})")
        check(rel <= TOL[name], f"{label}: error {rel:.3e} over {TOL[name]:g}")
        worst[name] = max(worst.get(name, 0.0), err)
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


# ---------------------------------------------------------------------------
# phases 9-11: the FM front end
# ---------------------------------------------------------------------------

FM_THETA = -2 * np.pi * FM_OFFSET / FM_RATE


def fm_kernel_cases(dev):
    """(kernel, label, kernel call, plain call) for the three FM kernels at
    the FM chain's shapes (frame F in, F/4 after the channel filter), at
    ragged ones, at large phases and in bf16."""
    import torch

    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)

    def real(*shape):
        return torch.randn(*shape, dtype=torch.float32, generator=gen, device=dev)

    cases = []
    ph0 = torch.tensor(1.25, dtype=torch.float32, device=dev)
    inc = torch.tensor(FM_THETA, dtype=torch.float32, device=dev)
    # the FM frames, a ragged one, the views x[1:] (a head sample before the
    # first 16-byte word) and x[:-1], and the blocks' edges: 1-3 samples and
    # one tile +- 1 after a head
    rot_tile = ck.ROTATOR_TILE
    rot_x = [(f"n={n}", randc(n, gen, dev)) for n in FM_FRAMES + (FM_FRAMES[0] + 333,)]
    rot_x += [(f"n={n} x[1:]", randc(n + 1, gen, dev)[1:]) for n in FM_FRAMES]
    rot_x += [(f"n={n} x[:-1]", randc(n + 1, gen, dev)[:-1]) for n in (FM_FRAMES[0],)]
    rot_x += [(f"n={n} x[1:]", randc(n + 1, gen, dev)[1:])
              for n in (1, 2, 3, rot_tile, rot_tile + 1, rot_tile + 2)]
    rot_x += [(f"n={n}", randc(n, gen, dev)) for n in (1, 2, 3, rot_tile - 1, rot_tile + 1)]
    for label, x in rot_x:              # |ph| reaches 0.63·n rad
        n = x.shape[0]
        cases.append(("rotator", f"rotator c64 {label} |ph|<={abs(FM_THETA) * n:.3g}",
                      lambda x=x: ck.rotator(x, ph0, inc),
                      lambda x=x: ck.rotator_plain(x, ph0, inc)))
    # the carry beside +-pi, where the remainder's sign flips
    for p0 in (np.float32(np.pi) - 1e-6, np.float32(-np.pi) + 1e-6):
        p0t = torch.tensor(p0, dtype=torch.float32, device=dev)
        for label, x in [rot_x[0], next(c for c in rot_x if c[0] == "n=1")]:
            cases.append(("rotator", f"rotator c64 {label} ph0={p0:.7f}",
                          lambda x=x, p=p0t: ck.rotator(x, p, inc),
                          lambda x=x, p=p0t: ck.rotator_plain(x, p, inc)))
    prev = randc(1, gen, dev).reshape(())
    n4 = FM_FRAMES[0] // 4
    dem_tile = ck.QUAD_DEMOD_TILE
    dem_x = [(f"n={n}", randc(n, gen, dev))
             for n in (n4, FM_FRAMES[1] // 4, n4 + 77, 1, 2, 3, dem_tile - 1, dem_tile + 1)]
    dem_x += [(f"n={n} x[1:]", randc(n + 1, gen, dev)[1:])
              for n in (n4, FM_FRAMES[1] // 4, 1, 2, 3, dem_tile, dem_tile + 1, dem_tile + 2)]
    dem_x += [(f"n={n4} x[:-1]", randc(n4 + 1, gen, dev)[:-1])]
    for label, x in dem_x:
        cases.append(("quad_demod", f"quad_demod c64 {label}",
                      lambda x=x: ck.quad_demod(prev, x, FM_GAIN),
                      lambda x=x: ck.quad_demod_plain(prev, x, FM_GAIN)))
    # channel filter: D = 4, m = 32, complex; resampler: D = 125, I = 24, m = 2
    w2, w3 = real(33, 4), real(3, 125, 24)
    shapes = [("2-D D=4 m=32 c64", w2, FM_FRAMES[0] // 4, True),
              ("2-D D=4 m=32 c64", w2, FM_FRAMES[1] // 4, True),
              ("2-D D=4 m=32 c64 ragged", w2, FM_FRAMES[0] // 4 - 223, True),
              ("3-D D=125 I=24 m=2 f32", w3, FM_FRAMES[0] // 500, False),
              ("3-D D=125 I=24 m=2 f32", w3, FM_FRAMES[1] // 500, False),
              ("3-D D=125 I=24 m=2 c64 ragged", w3, 1021, True)]
    # the plans' tile edges: nq = 1 and one tile +- 1 of each tiling, D = 1,
    # an odd D, m = 1 (the gemm tiling at I = 1), I = 24 on a complex stream
    rows_tile = ck.poly_fir_plan(32, 4, 1, 1, True).rows
    gemm_tile = ck.poly_fir_plan(2, 125, 24, 1, True).rows
    shapes += [("2-D D=4 m=32 c64 edge", w2, nq, True)
               for nq in (1, rows_tile - 1, rows_tile + 1)]
    shapes += [("3-D D=125 I=24 m=2 c64 edge", w3, nq, True)
               for nq in (1, gemm_tile - 1, gemm_tile + 1, FM_FRAMES[1] // 500)]
    shapes += [("2-D D=1 m=63 f32", real(64, 1), 1001, False),
               ("2-D D=5 m=8 c64", real(9, 5), 777, True),
               ("2-D D=8 m=1 f32", real(2, 8), 1000, False)]
    for label, w, nq, cplx in shapes:
        m, D = w.shape[0] - 1, w.shape[1]
        hist = randc(m * D, gen, dev) if cplx else real(m * D)
        x = randc(nq * D, gen, dev) if cplx else real(nq * D)
        for prec in (None, "bf16"):
            ww = w.to(torch.bfloat16) if prec else w     # the stage carries bf16 W
            cases.append(("poly_fir", f"poly_fir {label} nq={nq} {prec or 'f32'}",
                          lambda h=hist, x=x, w=ww, p=prec: ck.poly_fir(h, x, w, p),
                          lambda h=hist, x=x, w=ww, p=prec: ck.poly_fir_plain(h, x, w, p)))
    return cases


def fm_iq(n: int, dev, offset: float = FM_OFFSET):
    """A 1 kHz tone, FM-modulated at 75 kHz deviation, at ``offset`` from the
    tuned frequency: complex64 on ``dev``, built in float64 on the device."""
    import torch
    t = torch.arange(n, dtype=torch.float64, device=dev) / FM_RATE
    msg = torch.sin(2 * np.pi * 1000.0 * t)
    ph = 2 * np.pi * 75e3 * torch.cumsum(msg, 0) / FM_RATE + 2 * np.pi * offset * t
    return torch.polar(torch.ones_like(ph), ph).to(torch.complex64)


def fm_stages(chain: str, offset: float = FM_OFFSET):
    """``app``: the shipped front end; ``kernel``: the unfolded chain pinned
    to the hand kernels; ``plain``: the same chain on plain PyTorch ops."""
    from futuresdr_tpu_torch.apps.fm_receiver import front_end_stages
    from futuresdr_tpu_torch.dsp import firdes
    from futuresdr_tpu_torch.ops.stages import (fir_stage, quad_demod_stage,
                                                resample_stage, rotator_stage)
    if chain == "app":
        return front_end_stages(FM_RATE, offset)
    k = chain == "kernel"
    return [rotator_stage(-2 * np.pi * offset / FM_RATE, name="tuner",
                          impl="pallas" if k else "xla"),
            fir_stage(firdes.lowpass(0.5 / 4 * 0.8, 128), decim=4,
                      impl="pallas" if k else "poly", name="chan"),
            quad_demod_stage(FM_GAIN, impl="pallas" if k else "xla"),
            resample_stage(24, 125, impl="pallas" if k else "poly")]


FM_CHAINS = ("app", "kernel", "plain")


def run_fm(chain, frames, dev, offset: float = FM_OFFSET):
    import torch

    from futuresdr_tpu_torch.ops.stages import Pipeline
    pipe = Pipeline(fm_stages(chain, offset), np.complex64)
    fn, carry = pipe.fn(), pipe.init_carry(dev)
    outs = []
    for x in frames:
        carry, y = fn(carry, x)
        outs.append(y)
    return torch.cat(outs)


def max_abs(a, b, skip: int = 0) -> float:
    return float((a[skip:].double() - b[skip:].double()).abs().max())


def phase_fm_resident(dev) -> dict:
    """Both chains at each FM frame, 8 frames chained; returns Msps per
    (chain, frame)."""
    import torch

    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    from futuresdr_tpu_torch.ops.stages import Pipeline
    rates = {}
    for f in FM_FRAMES:
        x = fm_iq(FM_CHAIN * f, dev)
        xs = list(x.split(f))
        before = dict(ck.launches)
        out = {c: run_fm(c, xs, dev) for c in FM_CHAINS}
        for k in FM_KERNELS:
            check(ck.launches[k] > before[k], f"fm resident frame={f}: {k} not launched")
        n_out = FM_CHAIN * f * 24 // 500
        for c, y in out.items():
            check(y.shape == (n_out,) and y.dtype == torch.float32,
                  f"fm resident {c}: output {tuple(y.shape)} {y.dtype}")
            check(bool(torch.isfinite(y).all()), f"fm resident {c}: non-finite")
        err = max_abs(out["kernel"], out["plain"])
        print(f"fm resident frame={f}: kernel chain vs plain-op chain {err:.3e} "
              f"(tol {FM_PLAIN_TOL:g})")
        check(err <= FM_PLAIN_TOL, f"fm frame={f}: kernel chain differs from the "
                                   f"plain-op chain by {err:.3e}")
        err = max_abs(out["app"], out["kernel"], FM_TRANSIENT)
        tol = FM_APP_TOL if f == FM_FRAMES[0] else FM_PHASE_TOL
        print(f"fm resident frame={f}: app chain vs kernel chain {err:.3e} after "
              f"{FM_TRANSIENT} samples (tol {tol:g})")
        check(err <= tol, f"fm frame={f}: app chain differs from the kernel chain "
                          f"by {err:.3e}")
        # chained vs one long frame: at offset 0 every carry is chained and
        # the phase ramps are exactly zero; at the real offset the long
        # frame's float32 ramp is coarser (FM_PHASE_TOL)
        x0 = fm_iq(FM_CHAIN * f, dev, offset=0.0)
        for c in ("app", "kernel"):
            err = max_abs(run_fm(c, list(x0.split(f)), dev, 0.0),
                          run_fm(c, [x0], dev, 0.0))
            print(f"fm resident {c} frame={f} offset 0: {FM_CHAIN} chained vs one "
                  f"long frame {err:.3e} (tol {FM_CHAIN_TOL:g})")
            check(err <= FM_CHAIN_TOL, f"fm {c} frame={f}: chained frames differ "
                                       f"from one long frame by {err:.3e}")
            if f == FM_FRAMES[0]:
                err = max_abs(out[c], run_fm(c, [x], dev))
                print(f"fm resident {c} frame={f} offset {FM_OFFSET:g}: chained vs "
                      f"one long frame {err:.3e} (tol {FM_PHASE_TOL:g})")
                check(err <= FM_PHASE_TOL, f"fm {c} frame={f}: chained frames differ "
                                           f"from one long frame by {err:.3e}")
        del x0
        for c in FM_CHAINS:
            pipe = Pipeline(fm_stages(c), np.complex64)
            fn, state = pipe.fn(), [pipe.init_carry(dev)]

            def step(fn=fn, state=state, xs=xs):
                cc = state[0]
                for xx in xs:
                    cc, _ = fn(cc, xx)
                state[0] = cc

            ms = cuda_ms(step)
            rates[(c, f)] = FM_CHAIN * f / (ms * 1e-3) / 1e6
        del x, xs, out
    return rates


def _fm_kernel_block(chain, frame, dev, depth=IN_FLIGHT):
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
    return TpuKernel(fm_stages(chain), np.complex64, frame_size=frame,
                     inst=TpuInstance(dev), frames_in_flight=depth)


def phase_fm_streamed(dev) -> dict:
    """NullSource -> Head(64 frames) -> TpuKernel -> NullSink per chain;
    returns streamed Msps per chain."""
    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import Head, NullSink, NullSource
    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    rates, frame = {}, FM_FRAMES[0]
    n_items = FM_STREAM_FRAMES * frame
    for chain in ("app", "kernel"):
        runs = []
        for _ in range(STREAM_RUNS):
            before = dict(ck.launches)
            fg = Flowgraph()
            snk = NullSink(np.float32)
            fg.connect(NullSource(np.complex64), Head(np.complex64, n_items),
                       _fm_kernel_block(chain, frame, dev), snk)
            rt = Runtime()
            t0 = time.perf_counter()
            rt.run(fg)
            runs.append(time.perf_counter() - t0)
            rt.shutdown()
            want = n_items * 24 // 500
            check(snk.n_received == want,
                  f"fm streamed {chain}: NullSink got {snk.n_received} items, want {want}")
            if chain == "kernel":
                for k in FM_KERNELS:
                    check(ck.launches[k] > before[k], f"fm streamed: {k} not launched")
        rates[chain] = n_items / statistics.median(runs) / 1e6
        print(f"fm streamed {chain}: {n_items} items through NullSource -> Head -> "
              f"TpuKernel -> NullSink in {', '.join(f'{t:.3f}' for t in runs)} s")
    return rates


def phase_fm_retune(dev) -> None:
    """apply_retune("tuner", phase_inc=…) while frames stream, on both chains:
    the audio equals the resident chain with the retune at the frame the
    kernel reports."""
    import torch

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
    from futuresdr_tpu_torch.ops.stages import Pipeline
    frame, n_frames = FM_FRAMES[0], 16
    host = fm_iq(n_frames * frame, dev).cpu().numpy()
    theta2 = -2 * np.pi * 150e3 / FM_RATE
    for chain in ("app", "kernel"):
        kern = _fm_kernel_block(chain, frame, dev)
        fg = Flowgraph()
        vsnk = VectorSink(np.float32)
        fg.connect(VectorSource(host), kern, vsnk)
        rt = Runtime()
        running = rt.start(fg)
        deadline = time.monotonic() + 60
        while kern.frames_dispatched < 4:
            check(time.monotonic() < deadline, f"fm retune {chain}: stream did not start")
            time.sleep(0.0005)
        at = kern.apply_retune("tuner", phase_inc=theta2)
        running.wait_sync()
        rt.shutdown()
        check(0 < at < n_frames, f"fm retune {chain}: landed at frame {at} of "
                                 f"{n_frames}, not mid-stream")
        pipe = Pipeline(fm_stages(chain), np.complex64)
        fn, carry = pipe.fn(), pipe.init_carry(dev)
        outs = []
        for i in range(n_frames):
            if i == at:
                carry = pipe.update_stage(carry, "tuner", phase_inc=theta2)
            carry, y = fn(carry, torch.from_numpy(host[i * frame:(i + 1) * frame]).to(dev))
            outs.append(y)
        got = torch.from_numpy(vsnk.items())
        ref = torch.cat(outs).cpu()
        check(got.shape == ref.shape, f"fm retune {chain}: {tuple(got.shape)} items, "
                                      f"want {tuple(ref.shape)}")
        err = max_abs(got, ref)
        print(f"fm retune {chain}: tuner retuned at frame {at} of {n_frames}; vs "
              f"resident chain with the same retune {err:.3e} (tol {CHAIN_TOL:g})")
        check(err <= CHAIN_TOL, f"fm retune {chain}: differs by {err:.3e}")


def kernels_a_frame(stages, frames, dev) -> list:
    """The kernels one resident frame launches on the card, by
    ``torch.profiler``: ``Pipeline(stages).fn`` over ``frames[:-1]`` to warm
    up, then the last frame profiled (copies and memsets not counted)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from futuresdr_tpu_torch.ops.stages import Pipeline
    pipe = Pipeline(stages, np.complex64)
    fn, carry = pipe.fn(), pipe.init_carry(dev)
    for x in frames[:-1]:
        carry, _ = fn(carry, x)
    torch.cuda.synchronize()
    # torch.cuda._sleep's spin_kernel marks a profile that recorded the card
    # at all: now and then CUPTI records nothing, which is not zero kernels
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1)
            fn(carry, frames[-1])
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
                 and not e.name.startswith(("Memcpy", "Memset"))]
        if any("spin_kernel" in n for n in names):
            return [n for n in names if "spin_kernel" not in n]
        print(f"profile: the profiler recorded no kernel, not even its marker "
              f"(attempt {attempt + 1} of 3)")
    raise SmokeError("the profiler recorded no kernel in 3 attempts")


def phase_fm_kernel_count(dev) -> None:
    """Kernels a frame of the FM kernel chain and of its rotator stage alone
    (``torch.profiler`` over one 512,000-sample frame): the stage launches
    one kernel a frame, which also writes the next phase."""
    from futuresdr_tpu_torch.ops.stages import rotator_stage
    frames = list(fm_iq(3 * FM_FRAMES[0], dev).split(FM_FRAMES[0]))
    counts = {}
    for label, stages in (("kernel chain", fm_stages("kernel")),
                          ("rotator stage", [rotator_stage(FM_THETA, name="tuner",
                                                           impl="pallas")])):
        names = kernels_a_frame(stages, frames, dev)
        counts[label] = len(names)
        short = [n.replace("void ", "").replace("(anonymous namespace)::", "")
                 .split("<")[0].split("(")[0] for n in names]
        print(f"profile fm {label} frame={FM_FRAMES[0]}: {len(names)} kernels a frame "
              f"({', '.join(short)})")
    check(counts["rotator stage"] == 1, f"rotator_stage(impl='pallas') launches "
                                        f"{counts['rotator stage']} kernels a frame, not 1")


def phase_fm_wav(dev, wav_path) -> float:
    """The app as a user builds it: ``build_flowgraph(VectorSource(iq),
    use_tpu=True, audio_path=…)``; returns the WAV's spectral peak in Hz."""
    import wave

    from futuresdr_tpu_torch import Runtime
    from futuresdr_tpu_torch.apps.fm_receiver import AUDIO_RATE, build_flowgraph
    from futuresdr_tpu_torch.blocks import VectorSource
    from futuresdr_tpu_torch.tpu import TpuInstance
    n = FM_WAV_SAMPLES
    iq = fm_iq(n, dev).cpu().numpy()
    fg, _, sink = build_flowgraph(VectorSource(iq), input_rate=FM_RATE,
                                  offset=FM_OFFSET, audio_path=str(wav_path),
                                  use_tpu=True, inst=TpuInstance(dev))
    Runtime().run(fg)
    want = (n - n % 500) * 24 // 500
    check(sink.n_written == want, f"fm wav: {sink.n_written} samples, want {want}")
    w = wave.open(str(wav_path), "rb")
    pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16).astype(np.float64)
    w.close()
    pcm = pcm[len(pcm) // 4:]                    # skip the transient
    spec = np.abs(np.fft.rfft(pcm * np.hanning(len(pcm))))
    peak = float(np.fft.rfftfreq(len(pcm), 1.0 / AUDIO_RATE)[np.argmax(spec[5:]) + 5])
    print(f"fm wav: {sink.n_written} samples at {AUDIO_RATE} Hz, spectral peak "
          f"{peak:.1f} Hz (want 1000 +- 20)")
    check(abs(peak - 1000.0) < 20.0, f"fm wav: tone at {peak:.1f} Hz, not 1 kHz")
    return peak


def start_empty_kernel(build_dir):
    """Start ``nvcc`` on ``EMPTY_CU`` into ``build_dir``, with the port's
    flags; returns a function that waits for it and gives the loaded
    library."""
    from futuresdr_tpu_torch.ops import _build
    build_dir.mkdir(parents=True, exist_ok=True)
    src = build_dir / "empty_launch.cu"
    so = build_dir / "libempty_launch.so"
    src.write_text(EMPTY_CU)
    proc = subprocess.Popen([_build._nvcc(), *_build.FLAGS, "-o", str(so), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish():
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"nvcc failed for the empty kernel:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.fsdr_empty.argtypes = [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]
        lib.fsdr_empty.restype = ctypes.c_int
        return lib
    return finish


def fm_kernel_timings(dev, f: int, empty_lib) -> dict:
    """Kernel, plain and library device time and the bound of each FM kernel
    on the kernel chain's calls at input frame ``f``: the rotator on ``f``
    samples, the channel ``poly_fir`` on ``f`` (D = 4, m = 32, complex64),
    the demod on ``f/4``, the resampler ``poly_fir`` on ``f/4`` (D = 125,
    I = 24, m = 2, float32). ``poly_fir``'s entry is its two calls per frame
    summed; ``calls`` keeps each."""
    import torch
    import torch.nn.functional as F

    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    n4 = f // 4
    ph0 = torch.tensor(1.25, dtype=torch.float32, device=dev)
    inc = torch.tensor(FM_THETA, dtype=torch.float32, device=dev)
    # the weights' values do not change the kernels' work: random, at the
    # shapes of the chain's W (channel [33, 4], resampler [3, 125, 24])
    w2 = torch.randn(33, 4, generator=gen, device=dev)
    w3 = torch.randn(3, 125, 24, generator=gen, device=dev)
    reps = REPS
    rot_args = [(randc(f, gen, dev),) for _ in range(reps)]
    chan_args = [(randc(128, gen, dev), randc(f, gen, dev)) for _ in range(reps)]
    dem_args = [(randc(1, gen, dev).reshape(()), randc(n4, gen, dev)) for _ in range(reps)]
    res_args = [(torch.randn(250, generator=gen, device=dev),
                 torch.randn(n4, generator=gen, device=dev)) for _ in range(reps)]
    # library yardsticks, timed here only and never called by the port:
    # conv1d over the row layout (in-channels D, kernel m+1, out-channels I)
    cw2 = w2.flip(0).t().unsqueeze(0).contiguous()            # [1, 4, 33]
    cw3 = w3.flip(0).permute(2, 1, 0).contiguous()            # [24, 125, 3]
    chan_lib = [(torch.view_as_real(torch.cat([h, x])).reshape(-1, 4, 2)
                 .permute(2, 1, 0).contiguous(),) for h, x in chan_args]
    res_lib = [(torch.cat([h, x]).reshape(-1, 125).t().unsqueeze(0).contiguous(),)
               for h, x in res_args]
    # yardsticks, timed here only and never called by the port: a kernel with
    # no body on the kernel's grid (256 threads a block, one block a tile),
    # and a PyTorch copy of the kernel's bytes (the complex frame; the demod's
    # real plane into float32)
    def empty(tile, n):
        def launch(*args):
            ck._raise_on(empty_lib.fsdr_empty(-(-n // tile), 256, ck._stream(args[-1])),
                         "empty")
        return launch

    yard = {
        "rotator": (empty(ck.ROTATOR_TILE, f), lambda x, y: y.copy_(x),
                    [(x, torch.empty_like(x)) for x, in rot_args]),
        "quad_demod": (empty(ck.QUAD_DEMOD_TILE, n4), lambda x, y: y.copy_(x.real),
                       [(x, torch.empty(n4, device=dev)) for _, x in dem_args]),
    }
    plan = {
        "rotator": (lambda x: ck.rotator(x, ph0, inc),
                    lambda x: ck.rotator_plain(x, ph0, inc), None, rot_args, None,
                    16 * f + 8, 8 * f),
        "quad_demod": (lambda p, x: ck.quad_demod(p, x, FM_GAIN),
                       lambda p, x: ck.quad_demod_plain(p, x, FM_GAIN), None,
                       dem_args, None, 12 * n4 + 16, 7 * n4),
        "poly_fir/channel": (lambda h, x: ck.poly_fir(h, x, w2),
                             lambda h, x: ck.poly_fir_plain(h, x, w2),
                             lambda p: F.conv1d(p, cw2), chan_args, chan_lib,
                             8 * (f + 128) + 4 * w2.numel() + 8 * n4,
                             4 * w2.numel() * n4),
        "poly_fir/resampler": (lambda h, x: ck.poly_fir(h, x, w3),
                               lambda h, x: ck.poly_fir_plain(h, x, w3),
                               lambda p: F.conv1d(p, cw3), res_args, res_lib,
                               4 * (n4 + 250) + 4 * w3.numel() + 4 * (n4 // 125) * 24,
                               2 * w3.numel() * (n4 // 125)),
    }
    out = {}
    for name, (kern, plain, lib, args, lib_args, nbytes, flops) in plan.items():
        got, ref = kern(*args[0]), plain(*args[0])
        if name == "quad_demod":
            err = demod_err(got[0], ref[0])
        elif name == "rotator":
            err, _ = rel_err(got[0], ref[0])
        else:
            err, _ = rel_err(got, ref)
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
        out[name] = {
            "ms": device_ms(kern, args), "plain_ms": device_ms(plain, args),
            "library_ms": device_ms(lib, lib_args) if lib else None,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": err}
        if name in yard:
            empty, copy, copy_args = yard[name]
            out[name].update(empty_ms=device_ms(empty, args),
                             copy_ms=device_ms(copy, copy_args))
    ch, rs = out.pop("poly_fir/channel"), out.pop("poly_fir/resampler")
    out["poly_fir"] = {k: ch[k] + rs[k] for k in ("ms", "plain_ms", "library_ms",
                                                   "bound_ms")}
    out["poly_fir"].update(
        max_abs_err=max(ch["max_abs_err"], rs["max_abs_err"]),
        bound_by=max(ch, rs, key=lambda c: c["bound_ms"])["bound_by"],
        calls={"channel": ch, "resampler": rs})
    return out


# ---------------------------------------------------------------------------
# phases 12-15: the PFB channelizer and the spectrum app
# ---------------------------------------------------------------------------

def pfb_branch(dev, precision=None, atten_db: float = 70.0, n: int = PFB_N):
    """The channelizer stage's carried taps for PFB-``n``, ``[N, K]``."""
    from futuresdr_tpu_torch.ops.stages import channelizer_stage
    from futuresdr_tpu_torch.blocks import pfb_default_taps
    st = channelizer_stage(n, pfb_default_taps(n, atten_db=atten_db),
                           precision=precision)
    return st.init_carry(np.complex64, dev)[0]


class _PfbCall:
    """A ``pfb`` call on fixed inputs; ``f32_mode()`` runs the kernel on the
    same inputs with its bf16 mode off."""

    def __init__(self, fn, hist, x, taps, precision):
        self.fn, self.args, self.precision = fn, (hist, x, taps), precision

    def __call__(self):
        return self.fn(*self.args, self.precision)

    def f32_mode(self):
        return self.fn(*self.args, None)


def pfb_kernel_cases(dev):
    """(kernel, label, kernel call, plain call) for ``pfb`` at PFB-64, ragged
    t, other channel counts and one tap a branch; the taps go in as the
    stage passes them, its ``[N, K]`` carry transposed."""
    import torch

    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    cases = []
    for n, t in ((PFB_N, PFB_FRAMES[0] // PFB_N), (PFB_WIDE_N, 64)):
        for prec in (None, "bf16"):
            hc = pfb_branch(dev, prec, n=n)
            K = hc.shape[1]
            hist, x = randc((K - 1) * n, gen, dev), randc(t * n, gen, dev)
            cases.append(("pfb", f"pfb PFB-{n} t={t} K={K} {prec or 'f32'}",
                          _PfbCall(ck.pfb, hist, x, hc.t(), prec),
                          _PfbCall(ck.pfb_plain, hist, x, hc.t(), prec)))
    for t, K, N in ((1, 12, 64), (37, 12, 64), (500, 12, 5), (300, 12, 24),
                    (64, 12, 1024), (9, 12, 4096), (7, 12, 1000), (300, 1, 64)):
        w = torch.randn(N, K, generator=gen, device=dev)
        hist, x = randc((K - 1) * N, gen, dev), randc(t * N, gen, dev)
        cases.append(("pfb", f"pfb t={t} K={K} N={N} f32",
                      lambda h=hist, x=x, w=w: ck.pfb(h, x, w.t()),
                      lambda h=hist, x=x, w=w: ck.pfb_plain(h, x, w.t())))
    # the "v" layout, which the plan keeps for rows too wide to stage, forced
    # at N = 2048 (radix 2) and N = 1000 (direct DFT)
    for N in (2048, 1000):
        t, K = 5, 12
        w = torch.randn(N, K, generator=gen, device=dev)
        hist, x = randc((K - 1) * N, gen, dev), randc(t * N, gen, dev)
        plan = ck.PfbPlan(False, 256, N, 1, 1, 1, 0, (), (), (), N, N, ck._NO_PAD, False,
                          8 * N)
        cases.append(("pfb", f"pfb t={t} K={K} N={N} f32 (v layout)",
                      lambda h=hist, x=x, w=w, p=plan, N=N, t=t: ck._launch_pfb(
                          h, x, w.t(), torch.empty((t, N), dtype=torch.complex64,
                                                   device=x.device), False, p),
                      lambda h=hist, x=x, w=w: ck.pfb_plain(h, x, w.t())))
    return cases


def pfb_stages(impl: str, atten_db: float = 70.0, n: int = PFB_N):
    from futuresdr_tpu_torch.blocks import pfb_default_taps
    from futuresdr_tpu_torch.ops.stages import channelizer_stage
    return [channelizer_stage(n, pfb_default_taps(n, atten_db=atten_db), impl=impl)]


PFB_IMPLS = ("matmul", "pallas")


def run_pfb(impl, frames, dev, n: int = PFB_N):
    import torch

    from futuresdr_tpu_torch.ops.stages import Pipeline
    pipe = Pipeline(pfb_stages(impl, n=n), np.complex64)
    fn, carry = pipe.fn(), pipe.init_carry(dev)
    outs = []
    for x in frames:
        carry, y = fn(carry, x)
        outs.append(y)
    return torch.cat(outs)


def tone_powers(y, n: int, skip: int = 16) -> np.ndarray:
    """Mean power of each channel of the interleaved output after ``skip``
    rows (past the prototype's K = 12 rows of transient)."""
    return (y.reshape(-1, n)[skip:].abs() ** 2).mean(dim=0).double().cpu().numpy()


def phase_pfb_resident(dev) -> dict:
    """Both routes at each frame, 8 frames chained; returns Msps per (route,
    frame)."""
    import torch

    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    from futuresdr_tpu_torch.ops.stages import Pipeline
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    rates = {}
    # the stage's default route on a carry on the card: the kernel
    for n, ref_impl in ((PFB_N, "pallas"), (PFB_WIDE_N, "matmul")):
        xs = [randc(PFB_FRAMES[0], gen, dev) for _ in range(2)]
        before = ck.launches["pfb"]
        got = run_pfb("auto", xs, dev, n)
        torch.cuda.synchronize()
        launched = ck.launches["pfb"] - before
        ref = run_pfb(ref_impl, xs, dev, n)
        check(launched == len(xs), f"pfb auto N={n}: {launched} kernel launches for "
                                   f"{len(xs)} frames")
        if ref_impl == "pallas":
            check(torch.equal(got, ref), f"pfb auto N={n}: differs from the pallas route")
            print(f"pfb auto N={n}: {launched} launches, equal to the pallas route")
        else:
            snr = snr_db(got, ref)
            print(f"pfb auto N={n}: {launched} launches, {snr:.1f} dB against the "
                  f"matmul route (min {PFB_ROUTE_SNR:g})")
            check(snr >= PFB_ROUTE_SNR, f"pfb auto N={n}: {snr:.1f} dB against matmul")
        del xs, got, ref
    for f in PFB_FRAMES:
        xs = [randc(f, gen, dev) for _ in range(PFB_CHAIN)]
        out = {}
        for impl in PFB_IMPLS:
            chained = run_pfb(impl, xs, dev)
            long_ = run_pfb(impl, [torch.cat(xs)], dev)
            check(chained.shape == (PFB_CHAIN * f,) and chained.dtype == torch.complex64,
                  f"pfb resident {impl}: output {tuple(chained.shape)} {chained.dtype}")
            check(bool(torch.isfinite(torch.view_as_real(chained)).all()),
                  f"pfb resident {impl}: non-finite")
            _, rel = rel_err(chained, long_)
            print(f"pfb resident {impl} frame={f}: {PFB_CHAIN} chained vs one long "
                  f"frame {rel:.3e} of peak (tol {CHAIN_TOL:g})")
            check(rel <= CHAIN_TOL, f"pfb resident {impl} frame={f}: chained frames "
                                    f"differ from one long frame by {rel:.3e}")
            out[impl] = chained
            del long_
        snr = snr_db(out["pallas"], out["matmul"])
        print(f"pfb resident frame={f}: pallas vs matmul route {snr:.1f} dB "
              f"(min {PFB_ROUTE_SNR:g})")
        check(snr >= PFB_ROUTE_SNR, f"pfb frame={f}: routes agree to {snr:.1f} dB only")
        del out
        for impl in PFB_IMPLS:
            pipe = Pipeline(pfb_stages(impl), np.complex64)
            fn, state = pipe.fn(), [pipe.init_carry(dev)]

            def step(fn=fn, state=state, xs=xs):
                c = state[0]
                for x in xs:
                    c, _ = fn(c, x)
                state[0] = c

            ms = cuda_ms(step)
            rates[(impl, f)] = PFB_CHAIN * f / (ms * 1e-3) / 1e6
        del xs
    # a tone at channel c's centre lands in output c
    n = torch.arange(PFB_FRAMES[0], dtype=torch.float64, device=dev)
    for c in PFB_TONE_CHANNELS:
        x = torch.polar(torch.ones_like(n), 2 * np.pi * (c / PFB_N) * n).to(torch.complex64)
        p = tone_powers(run_pfb("pallas", [x], dev), PFB_N)
        ratio = p[c] / np.delete(p, c).max()
        print(f"pfb tone at channel {c}: strongest output {int(np.argmax(p))}, "
              f"{ratio:.3g}x the next (min {PFB_TONE_RATIO:g})")
        check(int(np.argmax(p)) == c and ratio >= PFB_TONE_RATIO,
              f"pfb tone at channel {c}: output {int(np.argmax(p))}, ratio {ratio:.3g}")
    return rates


def _pfb_kernel_block(frame, dev, impl="pallas"):
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
    return TpuKernel(pfb_stages(impl), np.complex64, frame_size=frame,
                     inst=TpuInstance(dev), frames_in_flight=IN_FLIGHT)


def phase_pfb_streamed(dev) -> float:
    """NullSource -> Head -> TpuKernel -> NullSink (rate), then VectorSource ->
    TpuKernel -> StreamDeinterleaver(64) -> 64 VectorSinks against the
    resident chain and the host PfbChannelizer block; returns streamed Msps."""
    import torch

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import (Head, NullSink, NullSource, PfbChannelizer,
                                            StreamDeinterleaver, VectorSink,
                                            VectorSource, pfb_default_taps)
    frame = PFB_FRAMES[0]
    n_items = PFB_STREAM_FRAMES * frame
    runs = []
    for _ in range(STREAM_RUNS):
        fg = Flowgraph()
        snk = NullSink(np.complex64)
        fg.connect(NullSource(np.complex64), Head(np.complex64, n_items),
                   _pfb_kernel_block(frame, dev), snk)
        rt = Runtime()
        t0 = time.perf_counter()
        rt.run(fg)
        runs.append(time.perf_counter() - t0)
        rt.shutdown()
        check(snk.n_received == n_items,
              f"pfb streamed: NullSink got {snk.n_received} items, want {n_items}")
    rate = n_items / statistics.median(runs) / 1e6
    print(f"pfb streamed: {n_items} items through NullSource -> Head -> TpuKernel -> "
          f"NullSink in {', '.join(f'{t:.3f}' for t in runs)} s")

    # deinterleaved, ending in a partial frame
    rng = np.random.default_rng(SEED + 22)
    n_host = PFB_VECTOR_FRAMES * frame + 3 * PFB_N + 5
    host = (rng.standard_normal(n_host) + 1j * rng.standard_normal(n_host)).astype(np.complex64)
    fg = Flowgraph()
    dein = StreamDeinterleaver(np.complex64, PFB_N)
    sinks = [VectorSink(np.complex64) for _ in range(PFB_N)]
    fg.connect(VectorSource(host), _pfb_kernel_block(frame, dev), dein)
    for i, s in enumerate(sinks):
        fg.connect_stream(dein, f"out{i}", s, "in")
    Runtime().run(fg)
    got = np.stack([s.items() for s in sinks], axis=1)          # [t, N]
    t_out = n_host // PFB_N
    check(got.shape == (t_out, PFB_N), f"pfb vector: {got.shape}, want {(t_out, PFB_N)}")
    padded = np.zeros((PFB_VECTOR_FRAMES + 1) * frame, np.complex64)
    padded[:n_host] = host
    xs = [torch.from_numpy(padded[i * frame:(i + 1) * frame]).to(dev)
          for i in range(PFB_VECTOR_FRAMES + 1)]
    res = run_pfb("pallas", xs, dev)[:t_out * PFB_N].reshape(t_out, PFB_N)
    _, rel = rel_err(torch.from_numpy(got), res)
    print(f"pfb vector: {PFB_N} channels of {t_out} samples, vs resident chain "
          f"{rel:.3e} of peak (tol {CHAIN_TOL:g})")
    check(rel <= CHAIN_TOL, f"pfb vector: differs from the resident chain by {rel:.3e}")

    host_fg = Flowgraph()
    chan = PfbChannelizer(PFB_N, pfb_default_taps(PFB_N))
    hsinks = [VectorSink(np.complex64) for _ in range(PFB_N)]
    host_fg.connect(VectorSource(host), chan)
    for i, s in enumerate(hsinks):
        host_fg.connect_stream(chan, f"out{i}", s, "in")
    Runtime().run(host_fg)
    ref = np.stack([s.items() for s in hsinks], axis=1)
    check(ref.shape == got.shape, f"pfb host block: {ref.shape}, want {got.shape}")
    bound = PFB_BLOCK_ATOL * np.abs(ref).max() + PFB_BLOCK_RTOL * np.abs(ref)
    excess = float(np.max(np.abs(got.astype(np.complex128) - ref) - bound))
    err = float(np.max(np.abs(got.astype(np.complex128) - ref)))
    print(f"pfb vector vs host PfbChannelizer block: max_abs_err {err:.3e} "
          f"(rtol {PFB_BLOCK_RTOL:g}, atol {PFB_BLOCK_ATOL:g} of peak)")
    check(excess <= 0, f"pfb vector: differs from the host block beyond tolerance")
    return rate


def phase_pfb_retune(dev) -> None:
    """Swap the prototype (70 dB → 50 dB Kaiser, same K) while frames stream;
    the output must equal the resident chain with the swap at the frame the
    kernel reports."""
    import torch

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import VectorSink, VectorSource, pfb_default_taps
    from futuresdr_tpu_torch.ops.stages import Pipeline
    frame, n_frames = PFB_FRAMES[0], 16
    taps2 = pfb_default_taps(PFB_N, atten_db=50.0)
    rng = np.random.default_rng(SEED + 23)
    host = (rng.standard_normal(n_frames * frame)
            + 1j * rng.standard_normal(n_frames * frame)).astype(np.complex64)
    kern = _pfb_kernel_block(frame, dev)
    fg = Flowgraph()
    vsnk = VectorSink(np.complex64)
    fg.connect(VectorSource(host), kern, vsnk)
    rt = Runtime()
    running = rt.start(fg)
    deadline = time.monotonic() + 60
    while kern.frames_dispatched < 4:
        check(time.monotonic() < deadline, "pfb retune: stream did not start")
        time.sleep(0.0005)
    at = kern.apply_retune(0, taps=taps2)
    running.wait_sync()
    rt.shutdown()
    check(0 < at < n_frames, f"pfb retune: landed at frame {at} of {n_frames}")
    pipe = Pipeline(pfb_stages("pallas"), np.complex64)
    fn, carry = pipe.fn(), pipe.init_carry(dev)
    outs = []
    for i in range(n_frames):
        if i == at:
            carry = pipe.update_stage(carry, 0, taps=taps2)
        carry, y = fn(carry, torch.from_numpy(host[i * frame:(i + 1) * frame]).to(dev))
        outs.append(y)
    _, rel = rel_err(torch.from_numpy(vsnk.items()), torch.cat(outs))
    print(f"pfb retune: prototype swapped at frame {at} of {n_frames}; vs resident "
          f"chain with the same swap {rel:.3e} of peak")
    check(rel <= CHAIN_TOL, f"pfb retune: differs by {rel:.3e}")


def phase_spectrum_app(dev) -> float:
    """``build_flowgraph(VectorSource(tone), use_tpu=True, collect=True)``: the
    last spectrum's peak in the tone's bin, every spectrum against a float64
    recomputation (FFT, |x|², EMA, 10·log10); returns the streamed input
    Msamples/s."""
    import torch

    from futuresdr_tpu_torch import Runtime
    from futuresdr_tpu_torch.apps.spectrum import FFT_SIZE, build_flowgraph
    from futuresdr_tpu_torch.blocks import VectorSource
    from futuresdr_tpu_torch.tpu import TpuInstance
    fft = FFT_SIZE
    frame = max(16 * fft, 1 << 15)
    n = SPEC_FRAMES * frame
    rng = np.random.default_rng(SEED + 24)
    tone = (np.exp(2j * np.pi * SPEC_TONE * np.arange(n))
            + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)
    fg, sink = build_flowgraph(VectorSource(tone), use_tpu=True, collect=True,
                               inst=TpuInstance(dev))
    t0 = time.perf_counter()
    Runtime().run(fg)
    wall = time.perf_counter() - t0
    got = sink.items()
    check(got.shape == (n,) and got.dtype == np.float32,
          f"spectrum app: {got.shape} {got.dtype}, want ({n},) float32")
    check(bool(np.isfinite(got).all()), "spectrum app: non-finite output")
    peak = int(np.argmax(got[-fft:]))
    print(f"spectrum app: {n} samples, last spectrum peaks in bin {peak} "
          f"(want {round(SPEC_TONE * fft)})")
    check(peak == round(SPEC_TONE * fft), f"spectrum app: peak in bin {peak}")
    rows = torch.from_numpy(tone).to(dev).to(torch.complex128).reshape(-1, fft)
    p = torch.fft.fft(rows, dim=1).abs() ** 2
    c = torch.zeros(fft, dtype=torch.float64, device=dev)
    ema = []
    for r in p:
        c = c * (1.0 - 0.1) + r * 0.1
        ema.append(c)
    ema = torch.stack(ema)
    ref = 10 * torch.log10(torch.clamp_min(ema, 1e-20))
    got_db = torch.from_numpy(got).to(dev).double().reshape(-1, fft)
    err = float((got_db[SPEC_SETTLE:] - ref[SPEC_SETTLE:]).abs().max())
    head = (10 ** (got_db[:SPEC_SETTLE] / 10) - ema[:SPEC_SETTLE]).abs().amax(dim=1)
    rel = float((head / ema[:SPEC_SETTLE].amax(dim=1)).max())
    print(f"spectrum app vs float64 recomputation: max {err:.3e} dB after "
          f"{SPEC_SETTLE} spectra (tol {SPEC_DB_TOL:g}), {rel:.3e} of the peak power "
          f"before (tol {SPEC_POWER_TOL:g})")
    check(err <= SPEC_DB_TOL, f"spectrum app: differs by {err:.3e} dB")
    check(rel <= SPEC_POWER_TOL, f"spectrum app: first spectra differ by {rel:.3e}")
    return n / wall / 1e6


def pfb_timings(dev, n: int, n_ch: int = PFB_N) -> dict:
    """Kernel, plain and matmul-route device time and the bound of ``pfb`` at
    PFB-``n_ch`` on a frame of ``n`` samples."""
    import torch

    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    from futuresdr_tpu_torch.ops.stages import _pfb_matmul
    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    hc = pfb_branch(dev, n=n_ch)
    K = hc.shape[1]
    # REPS distinct frames per graph: 20 x 16 B x 2^18 = 84 MB > L2
    args = [(randc((K - 1) * n_ch, gen, dev), randc(n, gen, dev)) for _ in range(REPS)]
    nbytes = 8 * (K - 1) * n_ch + 16 * n + 4 * K * n_ch + 8 * n_ch
    flops = n * (4 * K + 5 * int(np.log2(n_ch)))

    def kern(h, x):
        return ck.pfb(h, x, hc.t())

    def plain(h, x):
        return ck.pfb_plain(h, x, hc.t())

    def lib(h, x):                  # the matmul route, timed here only
        return _pfb_matmul(h, x, hc)

    err, _ = rel_err(kern(*args[0]), plain(*args[0]))
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    return {"ms": device_ms(kern, args), "plain_ms": device_ms(plain, args),
            "library_ms": device_ms(lib, args), "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": err}


# ---------------------------------------------------------------------------
# phases 16-17: the host side of the main path (compiled replay, megabatch K,
# the pinned staging arena)
# ---------------------------------------------------------------------------

def host_chains(taps) -> list:
    """``(label, stages factory, frames, its hand kernels)`` of every chain
    the host phases drive, at the frames the rate phases use."""
    from futuresdr_tpu_torch.apps.spectrum import spectrum_stages
    return [("spectrum os", lambda: chain_stages("os", taps), FRAMES, ()),
            ("spectrum pallas", lambda: chain_stages("pallas", taps), FRAMES, ("fir",)),
            ("spectrum fused", lambda: chain_stages("fused", taps), FRAMES, ("fir_fft",)),
            ("spectrum app", lambda: spectrum_stages(N_FFT), (1 << 15,), ()),
            ("fm app", lambda: fm_stages("app"), FM_FRAMES, ()),
            ("fm kernel", lambda: fm_stages("kernel"), FM_FRAMES, FM_KERNELS),
            ("fm plain", lambda: fm_stages("plain"), FM_FRAMES, ()),
            ("pfb matmul", lambda: pfb_stages("matmul"), PFB_FRAMES, ()),
            ("pfb pallas", lambda: pfb_stages("pallas"), PFB_FRAMES, PFB_KERNELS)]


def host_input(label: str, n: int, gen, dev):
    return fm_iq(n, dev) if label.startswith("fm ") else randc(n, gen, dev)


def run_compiled(fn, carry, frames, k: int, pipe=None, retune=None):
    """``fn`` (from ``Pipeline.compile(k=k)``) over ``frames``, ``k`` a
    dispatch; ``retune = (frame, stage, params)`` goes through
    ``pipe.update_stage`` on the compiled carry before that frame's
    dispatch. Returns the outputs flattened."""
    import torch
    outs = []
    for d in range(len(frames) // k):
        if retune is not None and d * k == retune[0]:
            carry = pipe.update_stage(carry, retune[1], **retune[2])
        x = torch.stack(frames[d * k:(d + 1) * k]) if k > 1 else frames[d]
        carry, y = fn(carry, x)
        outs.append(y.reshape(-1))
    return torch.cat(outs)


def run_eager(pipe, frames, dev, retune=None):
    """``pipe.fn`` over ``frames``, carry chained, the same ``retune``."""
    import torch
    fn, carry = pipe.fn(), pipe.init_carry(dev)
    outs = []
    for i, x in enumerate(frames):
        if retune is not None and i == retune[0]:
            carry = pipe.update_stage(carry, retune[1], **retune[2])
        carry, y = fn(carry, x)
        outs.append(y.reshape(-1))
    return torch.cat(outs)


def card_ms(fn) -> float:
    """The card's time for ``fn()`` (a run of calls): its work queued behind
    a device sleep, so the host has enqueued all of it before the card
    starts; median of 5, ms."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOST_SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_compiled(dev, taps) -> dict:
    """Every chain at each of its frames: ``Pipeline.compile`` at K = 1 and
    4 against the eager chain over HOST_DISPATCHES chained dispatches
    (CHAIN_TOL of the peak), one capture each, each replay adding the
    launches its graph recorded; then the resident rate of the eager chain
    and of each compiled K over the same 12 frames beside the card's time
    for them. Returns ``{(label, frame): {mode: (Msps, card µs a frame)}}``."""
    import torch

    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    from futuresdr_tpu_torch.ops.stages import Pipeline
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    n_frames = HOST_DISPATCHES * max(HOST_K)
    rates = {}
    for label, make, frames, kernels in host_chains(taps):
        for f in frames:
            x_all = host_input(label, n_frames * f, gen, dev)
            xs = list(x_all.split(f))
            pipe = Pipeline(make(), np.complex64)
            ref = run_eager(pipe, xs, dev)
            eager, eager_state = pipe.fn(), [pipe.init_carry(dev)]

            def eager_step(fn=eager, state=eager_state, xs=xs):
                c = state[0]
                for x in xs:
                    c, _ = fn(c, x)
                state[0] = c

            modes = {"eager": eager_step}
            for k in HOST_K:
                fn, carry = pipe.compile(f, dev, k=k)
                for kern in kernels:
                    check(fn.launches.get(kern, 0) >= k, f"compiled {label} frame={f} "
                          f"K={k}: the graph holds no {kern} launch a frame")
                before = dict(ck.launches)
                got = run_compiled(fn, carry, xs[:HOST_DISPATCHES * k], k)
                torch.cuda.synchronize()
                added = {n: ck.launches[n] - before[n] for n in ck.launches}
                check(added == {n: HOST_DISPATCHES * fn.launches.get(n, 0) for n in added},
                      f"compiled {label} K={k}: replays added {added}, the graph "
                      f"holds {fn.launches}")
                check(fn.captures == 1, f"compiled {label} K={k}: {fn.captures} captures")
                check(bool(torch.isfinite(torch.view_as_real(got) if got.is_complex()
                                          else got).all()), f"compiled {label}: non-finite")
                _, rel = rel_err(got, ref[:got.shape[0]])
                print(f"compiled {label} frame={f} K={k}: {HOST_DISPATCHES} replays vs "
                      f"eager {rel:.3e} of peak (tol {CHAIN_TOL:g}), launches a replay "
                      f"{fn.launches}")
                check(rel <= CHAIN_TOL, f"compiled {label} frame={f} K={k}: differs from "
                                        f"eager by {rel:.3e}")
                state = [carry]
                # the dispatches' inputs as views of the one input tensor
                groups = list(x_all.view(-1, k, f)) if k > 1 else xs

                def step(fn=fn, state=state, groups=groups):
                    c = state[0]
                    for x in groups:
                        c, _ = fn(c, x)
                    state[0] = c

                modes[f"K={k}"] = step
            rates[(label, f)] = {
                m: (n_frames * f / (cuda_ms(run, 5) * 1e-3) / 1e6,
                    card_ms(run) * 1e3 / n_frames) for m, run in modes.items()}
            del x_all, xs, ref, modes
    return rates


def phase_compiled_retune(dev, taps) -> None:
    """A retune between dispatches through the compiled carry (the FIR taps,
    the FM tuner's phase_inc, the PFB prototype): no new capture, and the
    output equals the eager chain retuned at the same frame."""
    import torch

    from futuresdr_tpu_torch.blocks import pfb_default_taps
    from futuresdr_tpu_torch.dsp import firdes
    from futuresdr_tpu_torch.ops.stages import Pipeline
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    cases = [("spectrum pallas", 0, {"taps": firdes.lowpass(0.05, N_TAPS).astype(np.float32)}),
             ("spectrum fused", 0, {"taps": firdes.lowpass(0.05, N_TAPS).astype(np.float32)}),
             ("fm app", "tuner", {"phase_inc": -2 * np.pi * 150e3 / FM_RATE}),
             ("fm kernel", "tuner", {"phase_inc": -2 * np.pi * 150e3 / FM_RATE}),
             ("pfb pallas", 0, {"taps": pfb_default_taps(PFB_N, atten_db=50.0)})]
    chains = {label: (make, frames) for label, make, frames, _ in host_chains(taps)}
    for label, stage, params in cases:
        make, frames = chains[label]
        f = frames[0]
        xs = list(host_input(label, 4 * f, gen, dev).split(f))
        pipe = Pipeline(make(), np.complex64)
        fn, carry = pipe.compile(f, dev, k=2)
        got = run_compiled(fn, carry, xs, 2, pipe, retune=(2, stage, params))
        check(fn.captures == 1, f"compiled retune {label}: {fn.captures} captures")
        ref = run_eager(pipe, xs, dev, retune=(2, stage, params))
        _, rel = rel_err(got, ref)
        print(f"compiled retune {label} ({', '.join(params)}) at frame 2 of 4, K=2: "
              f"{fn.captures} capture, vs eager with the same retune {rel:.3e} of peak "
              f"(tol {CHAIN_TOL:g})")
        check(rel <= CHAIN_TOL, f"compiled retune {label}: differs by {rel:.3e}")


def _host_kernel_block(label, make, frame, dev, k):
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
    return TpuKernel(make(), np.complex64, frame_size=frame, inst=TpuInstance(dev),
                     frames_in_flight=IN_FLIGHT, frames_per_dispatch=k)


def phase_megabatch_streamed(dev, taps) -> dict:
    """The streamed chains at K = 4 against K = 1: ``VectorSource ->
    TpuKernel -> VectorSink`` over 11 frames and a partial one (the last
    group partial at EOS) gives the same items, equal at CHAIN_TOL; then
    ``NullSource -> Head -> TpuKernel -> NullSink`` at each K (median of
    STREAM_RUNS) and the arena's hits and misses. Returns streamed Msps per
    (label, frame, K)."""
    import torch

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import (Head, NullSink, NullSource, VectorSink,
                                            VectorSource)
    from futuresdr_tpu_torch.ops.arena import arena
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    rates = {}
    for label, make, frames, _ in host_chains(taps):
        if label in ("spectrum os", "spectrum app", "fm plain", "pfb matmul"):
            continue
        f = frames[0]
        host = host_input(label, 11 * f + f // 3 + 7, gen, dev).cpu().numpy()
        out = {}
        for k in HOST_K:
            kern = _host_kernel_block(label, make, f, dev, k)
            fg = Flowgraph()
            vsnk = VectorSink(kern.pipeline.out_dtype)
            fg.connect(VectorSource(host), kern, vsnk)
            rt = Runtime()
            rt.run(fg)
            rt.shutdown()
            out[k] = torch.from_numpy(vsnk.items())
            check(kern.frames_dispatched == 12, f"megabatch {label} K={k}: "
                  f"{kern.frames_dispatched} frames dispatched, want 12")
        check(out[4].shape == out[1].shape, f"megabatch {label}: K=4 gave "
              f"{tuple(out[4].shape)} items, K=1 {tuple(out[1].shape)}")
        _, rel = rel_err(out[4], out[1])
        print(f"megabatch {label} frame={f}: K=4 vs K=1 streamed, {out[1].shape[0]} items "
              f"each, {rel:.3e} of peak (tol {CHAIN_TOL:g})")
        check(rel <= CHAIN_TOL, f"megabatch {label}: K=4 differs from K=1 by {rel:.3e}")
        n_items = STREAM_FRAMES * f
        for k in HOST_K:
            runs = []
            for _ in range(STREAM_RUNS):
                kern = _host_kernel_block(label, make, f, dev, k)
                fg = Flowgraph()
                snk = NullSink(kern.pipeline.out_dtype)
                fg.connect(NullSource(np.complex64), Head(np.complex64, n_items), kern, snk)
                rt = Runtime()
                t0 = time.perf_counter()
                rt.run(fg)
                runs.append(time.perf_counter() - t0)
                rt.shutdown()
                want = kern.pipeline.out_items(n_items)
                check(snk.n_received == want, f"streamed {label} K={k}: NullSink got "
                                              f"{snk.n_received} items, want {want}")
            rates[(label, f, k)] = n_items / statistics.median(runs) / 1e6
    st = arena().stats()
    print(f"arena: {st['hits']} takes from the pool, {st['misses']} allocations, "
          f"{st['pooled_bytes']} B pooled")
    check(st["hits"] > st["misses"], "arena: fewer takes from the pool than allocations")
    return rates


# ---------------------------------------------------------------------------
# phases 18-21: the message plane, the REST control port, the apps' main()
# and the circular buffer
# ---------------------------------------------------------------------------

MSG_COUNT = 50               # messages through MessageSource -> Copy -> Sink
REST_OFFSETS = (75e3, 90e3)  # the FM tuner before and after the REST retune
REST_LEVEL_TOL = 0.02        # relative, on each frame's mean discriminator level
REST_FRAMES_BEFORE = 8       # frames streamed before the retune is sent
REST_FRAMES_AFTER = 12       # frames streamed after it
MAIN_TIMEOUT_S = 300         # each app's main() as a subprocess
SPECTRUM_MAIN_SAMPLES = 1 << 26
FM_MAIN_WAV_FRAMES = 2       # audio frames in the WAV before "q" is sent
CIRC_FRAMES = 6              # frames (and a partial one) of the bit-equality runs


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rest(url: str, body=None) -> tuple:
    """``(status, parsed JSON body, round-trip seconds)`` of one request."""
    import urllib.error
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="POST" if data else "GET",
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            raw, status = r.read(), r.status
    except urllib.error.HTTPError as e:
        raw, status = e.read(), e.code
    return status, json.loads(raw), time.perf_counter() - t0


def ws_first_frame(port: int, timeout: float) -> tuple:
    """Connect to a websocket server on ``port`` (retrying until it listens),
    do the RFC 6455 handshake and return the first frame's
    ``(opcode, payload)``."""
    import base64
    import hashlib
    import os
    import socket
    import struct

    def exact(sock, n):
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            check(bool(chunk), "websocket: server closed the connection")
            buf += chunk
        return buf

    deadline = time.monotonic() + timeout
    while True:
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=timeout)
            break
        except ConnectionRefusedError:
            check(time.monotonic() < deadline, f"websocket: nothing listens on {port}")
            time.sleep(0.05)
    with sock:
        key = base64.b64encode(os.urandom(16)).decode()
        sock.sendall((f"GET / HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\nUpgrade: websocket\r\n"
                      f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                      "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        head = b""
        while not head.endswith(b"\r\n\r\n"):
            head += exact(sock, 1)
        accept = base64.b64encode(hashlib.sha1(
            key.encode() + b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11").digest()).decode()
        check(head.startswith(b"HTTP/1.1 101") and accept.encode() in head,
              f"websocket: bad handshake {head!r}")
        b0, b1 = exact(sock, 2)
        n = b1 & 0x7F
        if n == 126:
            n, = struct.unpack("!H", exact(sock, 2))
        elif n == 127:
            n, = struct.unpack("!Q", exact(sock, 8))
        payload = exact(sock, n)
        mask = os.urandom(4)
        close = struct.pack("!H", 1000)
        sock.sendall(struct.pack("!BB", 0x88, 0x82) + mask
                     + bytes(c ^ mask[i % 4] for i, c in enumerate(close)))
        return b0 & 0x0F, payload


def phase_message_plane(dev, taps, taps2) -> dict:
    """``MessageSource -> MessageCopy -> MessageSink``, then the handle's
    ``call``, ``post``, ``describe`` and ``metrics`` against a running
    streamed ``TpuKernel`` (the fused spectrum chain at 2^18) on the card;
    returns the handle calls' round-trip seconds."""
    from futuresdr_tpu_torch import Flowgraph, Pmt, Runtime
    from futuresdr_tpu_torch.blocks import (Head, MessageCopy, MessageSink, MessageSource,
                                            NullSink, NullSource)
    fg = Flowgraph()
    src, cp, snk = MessageSource(Pmt.usize(7), 0.001, count=MSG_COUNT), MessageCopy(), \
        MessageSink()
    fg.connect_message(src, "out", cp, "in")
    fg.connect_message(cp, "out", snk, "in")
    Runtime().run(fg)
    check(snk.received == [Pmt.usize(7)] * MSG_COUNT,
          f"message plane: {len(snk.received)} messages, want {MSG_COUNT}")

    frame = FRAMES[0]
    kern = _stream_kernel("fused", taps, frame, dev)
    fg = Flowgraph()
    nsnk = NullSink(np.float32)
    fg.connect(NullSource(np.complex64), Head(np.complex64, 1 << 50), kern, nsnk)
    rt = Runtime()
    running = rt.start(fg)
    h = running.handle
    deadline = time.monotonic() + 60
    while kern.frames_dispatched < 4:
        check(time.monotonic() < deadline, "message plane: the stream did not start")
        time.sleep(0.001)
    t0 = time.perf_counter()
    r = h.call_sync(kern, "ctrl", Pmt.map({"stage": 0, "taps": taps2}))
    call_s = time.perf_counter() - t0
    check(r == Pmt.ok(), f"message plane: ctrl call answered {r!r}")
    h.post_sync(kern, "ctrl", Pmt.map({"stage": 0, "taps": taps}))
    bad = h.call_sync(kern, "ctrl", Pmt.map({"stage": "nope", "taps": taps}))
    check(bad == Pmt.invalid_value(), f"message plane: a bad stage answered {bad!r}")
    desc = h.describe_sync()
    names = [b.type_name for b in desc.blocks]
    check(names == ["NullSource", "Head", "TpuKernel", "NullSink"],
          f"message plane: describe gave {names}")
    check(desc.blocks[2].message_inputs == ["ctrl"] and desc.blocks[2].blocking,
          f"message plane: TpuKernel described as {desc.blocks[2]}")
    t0 = time.perf_counter()
    m = h.metrics_sync()
    metrics_s = time.perf_counter() - t0
    km = m["TpuKernel_2"]
    check(km["messages_handled"] == 3 and km["work_calls"] > 0
          and km["items_in"]["in"] >= 4 * frame,
          f"message plane: TpuKernel metrics {km}")
    running.stop_sync()
    rt.shutdown()
    check(nsnk.n_received > 0, "message plane: nothing reached the sink")
    print(f"message plane: {MSG_COUNT} messages through MessageSource -> MessageCopy -> "
          f"MessageSink; handle on a streamed TpuKernel: ctrl call {call_s * 1e3:.3f} ms, "
          f"metrics {metrics_s * 1e3:.3f} ms, {kern.frames_dispatched} frames dispatched")
    return {"call_ms": call_s * 1e3, "metrics_ms": metrics_s * 1e3}


def phase_rest_retune(dev, wav_path) -> dict:
    """The FM app's card flowgraph with the Seify dummy radio
    (unthrottled, its tone at 0.1·fs), tuner at 75 kHz, retuned to 90 kHz by
    a POST of ``{"stage": "tuner", "phase_inc": θ}`` to the REST control
    port. Each audio frame's mean is the discriminator's DC level, which the
    gain gives for the tone's offset from the tuner: 25 kHz before, 10 kHz
    after. Returns the round trip and the frames from the POST to the first
    frame at the new level."""
    import wave

    from futuresdr_tpu_torch import Pmt, Runtime
    from futuresdr_tpu_torch.apps.fm_receiver import SAMPLE_RATE, build_flowgraph
    from futuresdr_tpu_torch.runtime.ctrl_port import ControlPort
    from futuresdr_tpu_torch.tpu import TpuInstance
    before, after = REST_OFFSETS
    fg, tk, sink = build_flowgraph(None, input_rate=FM_RATE, offset=before,
                                   audio_path=str(wav_path), use_tpu=True,
                                   inst=TpuInstance(dev))
    rt = Runtime()
    cp = ControlPort(rt.handle, bind="127.0.0.1:0")
    cp.start()
    running = rt.start(fg)
    try:
        deadline = time.monotonic() + 120
        while tk.frames_dispatched < REST_FRAMES_BEFORE:
            check(time.monotonic() < deadline, "rest: the FM stream did not start")
            time.sleep(0.001)
        url = f"{cp.url}/api/fg/0/block/1/call/ctrl/"
        f0 = tk.frames_dispatched
        body = Pmt.map({"stage": "tuner", "phase_inc": -2 * np.pi * after / FM_RATE})
        status, reply, rtt = rest(url, body.to_json())
        check((status, reply) == (200, "Ok"), f"rest: retune answered {status} {reply!r}")
        status, bad, _ = rest(url, {"MapStrPmt": {"stage": {"String": "tuner"},
                                                  "phase_inc": {"String": "x"}}})
        check((status, bad) == (200, "InvalidValue"),
              f"rest: a malformed map answered {status} {bad!r}")
        status, bad, _ = rest(url, {"F64": 1.0})
        check(bad == "InvalidValue", f"rest: a non-map answered {bad!r}")
        while tk.frames_dispatched < f0 + REST_FRAMES_AFTER:
            check(time.monotonic() < deadline, "rest: the FM stream stopped")
            time.sleep(0.001)
        desc = rest(f"{cp.url}/api/fg/0/")[1]
        check([b["type_name"] for b in desc["blocks"]] ==
              ["SeifySource", "TpuKernel", "WavSink"], f"rest: fg described as {desc}")
    finally:
        running.stop_sync()
        cp.stop()
        rt.shutdown()
    with wave.open(str(wav_path), "rb") as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16) / 32767.0
    out_frame = tk.out_frame
    levels = pcm[:len(pcm) // out_frame * out_frame].reshape(-1, out_frame).mean(axis=1)
    gain = SAMPLE_RATE / (2 * np.pi * 75e3)
    want = [gain * 2 * np.pi * (0.1 * FM_RATE - off) / SAMPLE_RATE for off in REST_OFFSETS]
    near_new = [i for i, v in enumerate(levels)
                if i >= f0 and abs(v - want[1]) < abs(v - want[0])]
    check(bool(near_new), f"rest: no frame reached the new level {want[1]:.4f}: {levels}")
    f1 = near_new[0]
    old, new = levels[2:f0], levels[f1 + 2:]
    print(f"rest: tuner {before / 1e3:.0f} -> {after / 1e3:.0f} kHz by POST, round trip "
          f"{rtt * 1e3:.3f} ms; POST after frame {f0}, first frame at the new level "
          f"{f1} ({f1 - f0} frames later); DC level {np.median(old):.5f} before (want "
          f"{want[0]:.5f}), {np.median(new):.5f} after (want {want[1]:.5f}), "
          f"{len(levels)} frames")
    check(len(old) >= 4 and len(new) >= 4, f"rest: {len(old)} frames before the "
          f"retune and {len(new)} after it")
    for lv, w_ in ((old, want[0]), (new, want[1])):
        err = np.abs(lv - w_).max() / abs(w_)
        check(err <= REST_LEVEL_TOL, f"rest: DC level off by {err:.4f} of {w_:.5f} "
                                     f"(tol {REST_LEVEL_TOL})")
    return {"rtt_ms": rtt * 1e3, "frames": f1 - f0}


def phase_app_mains(wav_path) -> None:
    """Both apps' ``main()`` as a user starts them, each a subprocess under
    a timeout: the FM receiver on the card (its default) with ``--wav`` and ``25000`` then ``q``
    on its stdin (``q`` once the WAV holds audio), and the spectrum app with
    ``--samples`` and ``--ws-port`` read by a websocket client."""
    import os
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    cmd = [sys.executable, "-m", "futuresdr_tpu_torch.apps.fm_receiver",
           "--wav", str(wav_path)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    try:
        proc.stdin.write("25000\n")
        proc.stdin.flush()
        deadline = time.monotonic() + MAIN_TIMEOUT_S
        want_bytes = 44 + 2 * 12_576 * FM_MAIN_WAV_FRAMES
        while not (wav_path.exists() and wav_path.stat().st_size >= want_bytes):
            check(proc.poll() is None, f"fm main exited early ({proc.returncode})")
            check(time.monotonic() < deadline, "fm main: no audio in the WAV")
            time.sleep(0.05)
        proc.stdin.write("q\n")
        proc.stdin.flush()
        out, _ = proc.communicate(timeout=MAIN_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    size = wav_path.stat().st_size
    print(f"fm main: {' '.join(cmd[1:])} exited {proc.returncode} after "
          f"{time.perf_counter() - t0:.1f} s, WAV {size} bytes")
    check(proc.returncode == 0 and size > 44, f"fm main: exit {proc.returncode}, WAV "
                                              f"{size} bytes; output:\n{out[-4000:]}")

    port = free_port()
    cmd = [sys.executable, "-m", "futuresdr_tpu_torch.apps.spectrum", "--samples",
           str(SPECTRUM_MAIN_SAMPLES), "--ws-port", str(port)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env)
    try:
        opcode, payload = ws_first_frame(port, MAIN_TIMEOUT_S)
        out, _ = proc.communicate(timeout=MAIN_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    spec = np.frombuffer(payload, np.float32)
    peak = int(np.argmax(spec)) if len(spec) else -1
    print(f"spectrum main: {' '.join(cmd[1:])} exited {proc.returncode} after "
          f"{time.perf_counter() - t0:.1f} s; first websocket frame: opcode {opcode}, "
          f"{len(spec)} floats, peak bin {peak} (want {round(0.1 * N_FFT)})")
    check(proc.returncode == 0, f"spectrum main: exit {proc.returncode}:\n{out[-4000:]}")
    check(opcode == 2 and len(spec) == N_FFT and peak == round(0.1 * N_FFT),
          "spectrum main: the first spectrum is not the dummy tone's")


def phase_circular(dev, taps) -> dict:
    """The streamed chains on the circular buffer (the default) against the
    pure-Python ring: ``VectorSource -> TpuKernel -> VectorSink`` gives the
    same items bit for bit, then ``NullSource -> Head -> TpuKernel ->
    NullSink`` at K = 1 and 4 on each buffer (median of STREAM_RUNS, the
    buffers in turns). Returns input Msps per (chain, frame, K, buffer)."""
    import torch

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import (Head, NullSink, NullSource, VectorSink,
                                            VectorSource)
    from futuresdr_tpu_torch.runtime import default_buffer
    from futuresdr_tpu_torch.runtime.buffer.circular import CircularWriter
    from futuresdr_tpu_torch.runtime.buffer.ring import RingWriter
    check(default_buffer() is CircularWriter, "circular: not the default buffer")
    buffers = {"ring": RingWriter, "circular": CircularWriter}
    chains = [("spectrum fused", lambda: chain_stages("fused", taps), FRAMES[0]),
              ("fm kernel", lambda: fm_stages("kernel"), FM_FRAMES[0])]
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    rates = {}

    def connect(fg, blocks, cls):
        for a, b in zip(blocks, blocks[1:]):
            fg.connect_stream(a, a.stream_outputs[0].name, b, b.stream_inputs[0].name,
                              buffer=cls)

    for label, make, f in chains:
        host = host_input(label, CIRC_FRAMES * f + f // 3 + 5, gen, dev).cpu().numpy()
        outs = {}
        for name, cls in buffers.items():
            kern = _host_kernel_block(label, make, f, dev, 1)
            vsnk = VectorSink(kern.pipeline.out_dtype)
            fg = Flowgraph()
            connect(fg, [VectorSource(host), kern, vsnk], cls)
            rt = Runtime()
            rt.run(fg)
            rt.shutdown()
            check(type(kern.input.reader._w if cls is CircularWriter
                       else kern.input.reader._writer) is cls
                  and type(kern.output.writer) is cls,
                  f"circular: {label} did not run on the {name} buffer")
            outs[name] = vsnk.items()
        equal = outs["ring"].shape == outs["circular"].shape and \
            np.array_equal(outs["ring"], outs["circular"])
        print(f"circular {label} frame={f}: {len(outs['ring'])} items on the ring, "
              f"{len(outs['circular'])} on the circular buffer, bit-equal {equal}")
        check(equal, f"circular: {label} differs between the ring and the circular buffer")
        n_items = STREAM_FRAMES * f
        for k in HOST_K:
            runs = {name: [] for name in buffers}
            for i in range(STREAM_RUNS * 2):
                name = ("ring", "circular", "circular", "ring")[i % 4]
                if len(runs[name]) == STREAM_RUNS:
                    name = "circular" if name == "ring" else "ring"
                kern = _host_kernel_block(label, make, f, dev, k)
                snk = NullSink(kern.pipeline.out_dtype)
                fg = Flowgraph()
                connect(fg, [NullSource(np.complex64), Head(np.complex64, n_items), kern,
                             snk], buffers[name])
                rt = Runtime()
                t0 = time.perf_counter()
                rt.run(fg)
                runs[name].append(time.perf_counter() - t0)
                rt.shutdown()
                want = kern.pipeline.out_items(n_items)
                check(snk.n_received == want, f"circular: {label} K={k} on the {name} "
                                              f"buffer: {snk.n_received} items, want {want}")
            for name, ts in runs.items():
                rates[(label, f, k, name)] = n_items / statistics.median(ts) / 1e6
    return rates


# A phase that stalls past this many seconds dumps every thread's stack to
# stderr and ends the run (exit 1), inside the 1200 s a run may take.
WATCHDOG_S = 1100


# --stress N: each streamed phase's run that takes longer than this dumps
# every thread's stack, then (if the interpreter is free) every pending
# asyncio task's stack and the state of every block inbox and ring, and exits.
STRESS_STALL_S = 60


def _stall_report(what: str) -> None:
    """Print the pending asyncio tasks, block inboxes and rings, then exit."""
    import asyncio
    import gc
    import os

    from futuresdr_tpu_torch.runtime.block import WrappedKernel
    from futuresdr_tpu_torch.runtime.buffer.circular import CircularWriter
    from futuresdr_tpu_torch.runtime.buffer.ring import RingWriter
    from futuresdr_tpu_torch.tpu import TpuKernel
    err = sys.stderr
    print(f"chip_smoke: STALL in {what}; state of the live objects:", file=err)
    warnings.simplefilter("ignore")     # lazy torch attributes warn on isinstance
    gc.collect()
    for o in gc.get_objects():
        if isinstance(o, asyncio.Task) and not o.done():
            print(f"task {o.get_name()}:", file=err)
            o.print_stack(file=err)
        elif isinstance(o, WrappedKernel):
            ib, k = o.inbox, o.kernel
            extra = ""
            if isinstance(k, TpuKernel):
                extra = (f" staged {len(k._staged)} inflight {len(k._inflight)} "
                         f"pending_out {k._pending_out is not None} "
                         f"dispatched {k.frames_dispatched}")
            print(f"block {o.instance_name}: pending {ib._pending} queued "
                  f"{list(ib._q)} waiter {ib._waiter is not None} closed "
                  f"{ib.closed}{extra}", file=err)
        elif isinstance(o, RingWriter):
            print(f"ring {o.dtype} cap {o.capacity}: wpos {o._wpos} finished "
                  f"{o._finished} readers "
                  f"{[(r.pos, r.detached) for r in o._readers]}", file=err)
        elif isinstance(o, CircularWriter):
            lib = o._lib
            print(f"circular {o.dtype} cap {o.capacity}: wpos {lib.fsdr_ring_wpos(o._ring)} "
                  f"finished {o._finished} readers "
                  f"{[(lib.fsdr_ring_rpos(o._ring, r.idx), r.detached) for r in o._readers]}",
                  file=err)
    err.flush()
    os._exit(4)


def stress(dev, runs: int) -> None:
    """The streamed phases of the spectrum chain and the FM front end, each
    ``runs`` times after the resident phases (where a stall was once seen),
    each run under a ``STRESS_STALL_S`` watchdog."""
    import threading

    from futuresdr_tpu_torch.dsp import firdes
    taps = firdes.lowpass(0.2, N_TAPS).astype(np.float32)
    phase_resident(dev, taps)
    phase_fm_resident(dev)
    phases = (("spectrum streamed", lambda: phase_streamed(dev, taps)),
              ("fm streamed", lambda: phase_fm_streamed(dev)))
    t0 = time.perf_counter()
    for i in range(runs):
        for name, fn in phases:
            what = f"{name} run {i + 1}"
            faulthandler.dump_traceback_later(STRESS_STALL_S, exit=False)
            timer = threading.Timer(STRESS_STALL_S + 5, _stall_report, args=(what,))
            timer.daemon = True
            timer.start()
            try:
                fn()
            finally:
                timer.cancel()
                faulthandler.cancel_dump_traceback_later()
            print(f"stress: {what} passed ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"stress: {runs} runs of each streamed phase, no stall")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Chip smoke test of the port.")
    parser.add_argument("--stress", type=int, default=0, metavar="N",
                        help="only run the spectrum and FM streamed phases N "
                             "times each, each run under a stall watchdog")
    stress_runs = parser.parse_args(argv).stress
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
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
    empty_done = start_empty_kernel(_build.BUILD_DIR)
    paths = _build.build_all()
    empty_lib = empty_done()
    print(f"build: {time.perf_counter() - t0:.1f} s, "
          f"{', '.join(p.name for p in paths)} for sm_90a")
    # every streamed phase runs on the double-mapped circular buffer: its
    # library builds from csrc/host/ here, or the check fails (phase 21)
    from futuresdr_tpu_torch.runtime import default_buffer
    from futuresdr_tpu_torch.runtime.buffer import circular
    check(circular.available() and default_buffer() is circular.CircularWriter,
          "the circular buffer's library did not build: the streamed phases would run "
          "on the pure-Python ring")
    if stress_runs:
        stress(dev, stress_runs)
        return 0

    # 3, 9, 12. kernels against their plain versions
    worst = phase_kernels(dev, kernel_cases(dev) + fm_kernel_cases(dev)
                          + pfb_kernel_cases(dev))

    # 4-6. the spectrum chain, launch counts read over exactly these phases
    taps = firdes.lowpass(0.2, N_TAPS).astype(np.float32)
    taps2 = firdes.lowpass(0.05, N_TAPS).astype(np.float32)
    launches = {}
    by_phase = {}

    def path_phase(name, kernels, fn, *args):
        ck.reset_launches()
        result = fn(*args)
        torch.cuda.synchronize()
        by_phase[name] = {k: ck.launches[k] for k in kernels}
        for k in kernels:
            check(ck.launches[k] > 0, f"kernel {k} was launched no time in the {name} "
                                      f"phase of its path")
            launches[k] = launches.get(k, 0) + ck.launches[k]
        return result

    resident = path_phase("resident", SPECTRUM_KERNELS, phase_resident, dev, taps)
    streamed = path_phase("streamed", SPECTRUM_KERNELS, phase_streamed, dev, taps)
    path_phase("retune", SPECTRUM_KERNELS, phase_retune, dev, taps, taps2)

    # 10-11. the FM front end, its counts read over exactly its phases
    fm_resident = path_phase("fm_resident", FM_KERNELS, phase_fm_resident, dev)
    fm_streamed = path_phase("fm_streamed", FM_KERNELS, phase_fm_streamed, dev)
    path_phase("fm_retune", FM_KERNELS, phase_fm_retune, dev)
    phase_fm_kernel_count(dev)
    # the app as shipped reaches none of the kernels (xlating FIR on
    # matmuls, demod and resampler on their default routes)
    wav = _build.BUILD_DIR.parent / "fm_smoke.wav"
    phase_fm_wav(dev, wav)
    wav.unlink()

    # 13-14. the PFB channelizer, its counts read over exactly its phases
    pfb_resident = path_phase("pfb_resident", PFB_KERNELS, phase_pfb_resident, dev)
    pfb_streamed = path_phase("pfb_streamed", PFB_KERNELS, phase_pfb_streamed, dev)
    path_phase("pfb_retune", PFB_KERNELS, phase_pfb_retune, dev)
    # 15. the spectrum app (no hand kernel on its chain, as in the reference)
    spectrum_rate = phase_spectrum_app(dev)

    # 16-17. the host side: compiled replay against eager, retunes through
    #        the compiled carry, K = 4 streamed against K = 1
    all_kernels = SPECTRUM_KERNELS + FM_KERNELS + PFB_KERNELS
    compiled = path_phase("compiled", all_kernels, phase_compiled, dev, taps)
    path_phase("compiled_retune", all_kernels, phase_compiled_retune, dev, taps)
    megabatch = path_phase("megabatch", all_kernels, phase_megabatch_streamed, dev, taps)

    # 18. the message plane, and the handle on a streamed TpuKernel
    message = path_phase("message", ("fir_fft",), phase_message_plane, dev, taps, taps2)
    # 19. a ctrl retune over REST into the FM app's device chain (no hand
    #     kernel on the app's chain); 20. both apps' main() as subprocesses
    rest_wav = _build.BUILD_DIR.parent / "fm_rest.wav"
    rest_retune = phase_rest_retune(dev, rest_wav)
    rest_wav.unlink()
    main_wav = _build.BUILD_DIR.parent / "fm_main.wav"
    phase_app_mains(main_wav)
    main_wav.unlink()
    # 21. the circular buffer against the ring
    circ = path_phase("circular", ("fir_fft",) + FM_KERNELS, phase_circular, dev, taps)

    # 7. kernel timings at the streamed default frames, and the larger
    #    frames for the record
    timings = {f: kernel_timings(dev, f, taps) for f in FRAMES}
    fm_timings = {f: fm_kernel_timings(dev, f, empty_lib) for f in FM_FRAMES}
    pfb_t = {f: {"pfb": pfb_timings(dev, f)} for f in PFB_FRAMES}
    pfb_wide = {PFB_FRAMES[0]: {f"pfb/N={PFB_WIDE_N}": pfb_timings(dev, PFB_FRAMES[0],
                                                                 PFB_WIDE_N)}}
    rows = [(f, k, v) for f, t in timings.items() for k, v in t.items()]
    rows += [(f, k, v) for f, t in fm_timings.items() for k, v in t.items()]
    rows += [(f, k, v) for f, t in pfb_t.items() for k, v in t.items()]
    rows += [(f, k, v) for f, t in pfb_wide.items() for k, v in t.items()]
    rows += [(f, f"poly_fir/{c}", v) for f, t in fm_timings.items()
             for c, v in t["poly_fir"]["calls"].items()]
    for f, k, v in rows:
        lib = "none" if v["library_ms"] is None else f"{v['library_ms']:.4f} ms"
        before = EARLIER_MS.get((k, f))
        before = "" if before is None else f" (PERF.md before: {before:.4f} ms)"
        yard = "" if "copy_ms" not in v else (
            f", empty launch {v['empty_ms']:.4f} ms, copy of its bytes {v['copy_ms']:.4f} ms")
        print(f"timing {k} n={f}: kernel {v['ms']:.4f} ms{before}, plain "
              f"{v['plain_ms']:.4f} ms, library {lib}, bound {v['bound_ms']:.4f} ms "
              f"({v['bound_by']}){yard} [{card_line}]")
    line = {"kernels": []}
    first = {**timings[FRAMES[0]], **fm_timings[FM_FRAMES[0]], **pfb_t[PFB_FRAMES[0]]}
    for k in SPECTRUM_KERNELS + FM_KERNELS + PFB_KERNELS:
        t = first[k]
        line["kernels"].append({
            "name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
            "launches": launches[k],
            "launches_by_phase": {p: c[k] for p, c in by_phase.items() if k in c},
            "max_abs_err": max(worst[k], t["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **{y: t[y] for y in ("empty_ms", "copy_ms") if y in t}})
    print(json.dumps(line))

    # 8. rates beside the card
    for route in ROUTES:
        for f in FRAMES:
            print(f"rate {route} resident frame={f}: {resident[(route, f)]:.1f} Msamples/s "
                  f"[{card_line}]")
        print(f"rate {route} streamed frame={FRAMES[0]} in-flight={IN_FLIGHT} "
              f"(median of {STREAM_RUNS}): {streamed[route]:.1f} Msamples/s [{card_line}]")
    for chain in FM_CHAINS:
        for f in FM_FRAMES:
            print(f"rate fm {chain} resident frame={f}: {fm_resident[(chain, f)]:.1f} "
                  f"input Msamples/s [{card_line}]")
        if chain in fm_streamed:
            print(f"rate fm {chain} streamed frame={FM_FRAMES[0]} in-flight={IN_FLIGHT} "
                  f"(median of {STREAM_RUNS}): {fm_streamed[chain]:.1f} input "
                  f"Msamples/s [{card_line}]")
    for impl in PFB_IMPLS:
        for f in PFB_FRAMES:
            print(f"rate pfb {impl} resident frame={f}: {pfb_resident[(impl, f)]:.1f} "
                  f"input Msamples/s [{card_line}]")
    print(f"rate pfb pallas streamed frame={PFB_FRAMES[0]} in-flight={IN_FLIGHT} "
          f"(median of {STREAM_RUNS}): {pfb_streamed:.1f} input Msamples/s [{card_line}]")
    print(f"rate spectrum app streamed (FFT_SIZE 2048, frame 32768): "
          f"{spectrum_rate:.1f} input Msamples/s [{card_line}]")
    for (label, f), modes in compiled.items():
        print(f"rate {label} resident frame={f}: " + ", ".join(
            f"{m} {msps:.1f} Msamples/s (card {us:.1f} us a frame)"
            for m, (msps, us) in modes.items()) + f" [{card_line}]")
    for (label, f, k), msps in megabatch.items():
        print(f"rate {label} streamed frame={f} in-flight={IN_FLIGHT} K={k} (median of "
              f"{STREAM_RUNS}): {msps:.1f} input Msamples/s [{card_line}]")
    for (label, f, k, buf), msps in circ.items():
        print(f"rate {label} streamed frame={f} in-flight={IN_FLIGHT} K={k} buffer={buf} "
              f"(median of {STREAM_RUNS}): {msps:.1f} input Msamples/s [{card_line}]")
    print(f"rest: ctrl retune round trip {rest_retune['rtt_ms']:.3f} ms, "
          f"{rest_retune['frames']} frames from the POST to the first retuned frame; "
          f"handle ctrl call {message['call_ms']:.3f} ms, metrics "
          f"{message['metrics_ms']:.3f} ms [{card_line}]")
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
