#!/usr/bin/env python3
"""Host time per call of the port's kernel wrappers on one CUDA card.

The resident chains are host-bound at their small frames: a wrapper's
checks, plan and launch take longer on the host than its kernel on the card.
This times each wrapper from the host's clock at its main path's shape
(``fir`` and ``fir_fft`` at 2^18 with 64 taps and N = 2048; ``rotator``,
the channel and resampler ``poly_fir`` calls and ``quad_demod`` in the FM
chain at 512,000; ``pfb`` at PFB-64 on 2^18): 7 batches of 400 calls,
the card waited for after each batch only, and prints the least and the
median batch's time per call. Where the package has the
``fir_fft``, ``poly_fir``, ``fir`` and ``pfb`` plan functions, it also times
building a plan anew, which the wrappers' cache saves.

    python3 port_host.py [--root DIR]

``--root`` imports ``futuresdr_tpu_torch`` from DIR, another checkout (say
the parent commit, unpacked with ``git archive``), so that two versions are
compared on one card: run parent, change, change, parent. Prints one line
per wrapper with the card's name and power limit, then one JSON line.
Exits nonzero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

CALLS = 400                  # calls per batch: their host time, not the card's
BATCHES = 7


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def _host_us(fn):
    """(least, median) host µs per ``fn()`` call over ``BATCHES`` batches."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(BATCHES):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        per_call.append((time.perf_counter() - t0) / CALLS * 1e6)
        torch.cuda.synchronize()
    return min(per_call), statistics.median(per_call)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("port_host: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    from futuresdr_tpu_torch.ops import _build
    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    _build.build_all()
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)

    def c64(n):
        return torch.randn(n, 2, generator=gen, device=dev).view(torch.complex64)[:, 0]

    def f32(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    taps, h63, x18 = f32(64), c64(63), c64(1 << 18)
    ph0, inc = f32(1), f32(1)
    w_ch, w_rs = f32(33, 4), f32(3, 125, 24)
    h_ch, x_ch = c64(128), c64(512_000)
    h_rs, x_rs = f32(250), f32(128_000)
    prev, x_dm = c64(1).reshape(()), c64(128_000)
    pfb_taps, h_pfb = f32(12, 64), c64(11 * 64)
    wrappers = {
        "fir n=262144": lambda: ck.fir_continue(h63, x18, taps),
        "fir_fft n=262144": lambda: ck.fir_fft(h63, x18, taps, 2048),
        "rotator n=512000": lambda: ck.rotator(x_ch, ph0, inc),
        "poly_fir/channel n=512000": lambda: ck.poly_fir(h_ch, x_ch, w_ch),
        "quad_demod n=128000": lambda: ck.quad_demod(prev, x_dm, 1.0),
        "poly_fir/resampler n=128000": lambda: ck.poly_fir(h_rs, x_rs, w_rs),
        "pfb n=262144": lambda: ck.pfb(h_pfb, x18, pfb_taps),
    }
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = {
        "fir_fft_plan(2048, 64)": ("fir_fft_plan", (2048, 64)),
        "poly_fir_plan channel": ("poly_fir_plan", (32, 4, 1, 128_000, True, n_sm)),
        "poly_fir_plan resampler": ("poly_fir_plan", (2, 125, 24, 1024, False, n_sm)),
        "fir_plan(2^18, 64)": ("fir_plan", (1 << 18, 64, True, n_sm)),
        "pfb_plan(64, 12, 4096)": ("pfb_plan", (64, 12, 4096, n_sm)),
    }
    for label, (name, plan_args) in plans.items():
        fn = getattr(ck, name, None)
        if fn is not None:
            build = getattr(fn, "__wrapped__", fn)
            wrappers[f"{label}, built anew"] = lambda b=build, a=plan_args: b(*a)
    card = _card()
    out = {}
    for label, fn in wrappers.items():
        least, med = _host_us(fn)
        out[label] = {"least_us": least, "median_us": med}
        print(f"host {label}: {least:.2f} us least, {med:.2f} us median per call "
              f"[{card}]")
    print(json.dumps({"root": str(Path(ck.__file__).resolve().parents[2]),
                      "device": card, "host_us": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
