#!/usr/bin/env python3
"""Device time of the ``fir`` and ``pfb`` kernels and the ``fir_lanes`` and
``fir_fft_lanes`` lane forms under the layouts their plans can take, and of
``rotator`` beside its first design, at the main paths' shapes, on one CUDA
card.

``cuda_kernels.fir_plan`` and ``pfb_plan`` pick one layout per call; this
times the same call under the others the kernels take, so that PERF.md can
say what each step of a design buys: for ``fir`` (complex64, 64 taps, 2^18
and 2^20) warps a block, tiles a warp with one or two span buffers, and the
unpadded fallback; for ``pfb`` (PFB-64 at 2^18 and 2^21, PFB-2048 at 2^18,
K = 12) the rows a thread (R), the taps in shared memory instead of
registers, the unpadded layout with the twiddles read from device memory,
and the "v" layout (the first design's unstaged mode); ``rotator`` at
512,000 and 4,096,000 takes one fixed layout; the lane forms at the served
shapes and beside them (``fir_lanes`` at 64 and 256 × 512 with 17 taps,
16, 4 and 1 × 2^18 with 64; ``fir_fft_lanes`` at 16, 4, 2 and 1 × 2^18
and 64 × 2^14 with 64 taps and N = 2048) under every layout of
``cuda_kernels.plan_candidates``, the rule's first: the one-stream kernel's
layouts run on every lane, the lane the grid's y (for ``fir_fft_lanes`` the
twiddle table staged or read through L1).
Each time is the device time of one call in a CUDA graph over 20 distinct
inputs (``chip_smoke.device_ms``), with the error against the plain
version; with ``--rounds N`` every layout is timed N times, each round in
the reverse order of the last, and the median printed beside every round's
time.

    python3 port_plans.py [--first DIR] [--kernels fir,pfb,rotator,fir_lanes,fir_fft_lanes]
                          [--rounds N]

``--first DIR`` also times the first design of ``rotator``, built from
``DIR/futuresdr_tpu_torch/csrc/rotator.cu`` of a checkout before its
redesign (four 8-byte samples a thread, 256 apart; the carry's phase left to
the caller). Prints one line per layout with the card's name and power
limit, then one JSON line. Exits nonzero without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

KERNELS = ("fir", "pfb", "rotator", "fir_lanes", "fir_fft_lanes")
# the lane forms at their served shapes and beside them: (kernel, lanes, samples a
# lane, taps)
LANE_SHAPES = (("fir_lanes", 64, 512, 17), ("fir_lanes", 16, 1 << 18, 64),
               ("fir_lanes", 256, 512, 17), ("fir_lanes", 4, 1 << 18, 64),
               ("fir_lanes", 1, 1 << 18, 64),
               ("fir_fft_lanes", 16, 1 << 18, 64), ("fir_fft_lanes", 4, 1 << 18, 64),
               ("fir_fft_lanes", 2, 1 << 18, 64), ("fir_fft_lanes", 1, 1 << 18, 64),
               ("fir_fft_lanes", 64, 1 << 14, 64))


def first_rotator(root: Path, out: Path):
    """The first ``rotator`` kernel from ``root``, built with the port's
    flags into its own library under ``out``."""
    from futuresdr_tpu_torch.ops import _build
    out.mkdir(parents=True, exist_ok=True)
    so = out / "librotator-first.so"
    if subprocess.call([_build._nvcc(), *_build.FLAGS, "-o", str(so),
                        str(root / "futuresdr_tpu_torch" / "csrc" / "rotator.cu")]) != 0:
        raise RuntimeError("nvcc failed for the first rotator")
    lib = ctypes.CDLL(str(so))
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.fsdr_rotator.argtypes = [vp, vp, vp, vp, ll, vp]
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--first", type=Path, default=None, metavar="DIR")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="the kernels to time, comma-separated (default: all)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="times each layout this many times, in alternating order")
    opts = ap.parse_args()
    first_root, kernels, rounds = opts.first, opts.kernels.split(","), opts.rounds
    import torch
    if not torch.cuda.is_available():
        print("port_plans: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from futuresdr_tpu_torch.ops import _build
    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    _build.build_all()
    dev = torch.device("cuda:0")
    card = cs.card()
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 30)
    out = {}

    cases = []                      # (label, fn, args), timed after every check

    def report(label, fn, plain, args):
        got, ref = fn(*args[0]), plain(*args[0])
        rel = cs.rel_err(got[0] if isinstance(got, tuple) else got,
                         ref[0] if isinstance(ref, tuple) else ref)[1]
        out[label] = {"err": rel, "runs_us": []}
        cases.append((label, fn, args))

    nt = cs.N_TAPS
    taps = torch.randn(nt, generator=gen, device=dev)
    for n in cs.FRAMES if "fir" in kernels else ():
        args = [(cs.randc(nt - 1, gen, dev), cs.randc(n, gen, dev))
                for _ in range(cs.REPS)]
        plan = ck.fir_plan(n, nt, True, ck._sm_count(dev))
        tiles = -(-n // ck._FIR_WARP_OUTS)

        def fir_layout(warps, per_warp, bufs, span_shift=3):
            return ck.FirPlan(32 * warps, -(-tiles // (warps * per_warp)), span_shift, bufs,
                              ck._fir_smem(warps, bufs, nt, span_shift, 8))

        layouts = {"plan": plan, "1 warp a block": fir_layout(1, 1, 1),
                   "8 warps a block, 1 tile a warp": fir_layout(8, 1, 1),
                   "8 warps, 2 tiles a warp, 1 buffer": fir_layout(8, 2, 1),
                   "8 warps, 2 tiles a warp, 2 buffers": fir_layout(8, 2, 2),
                   "1 unpadded warp a block": fir_layout(1, 1, 1, ck._NO_PAD)}
        for name, p in layouts.items():
            report(f"fir n={n} {name} {tuple(p[:4])}",
                   lambda h, x, p=p: ck._launch_fir(h, x, taps, False, p),
                   lambda h, x: ck.fir_continue_plain(h, x, taps), args)

    pfb_cases = ((cs.PFB_N, cs.PFB_FRAMES[0]), (cs.PFB_N, cs.PFB_FRAMES[1]),
                 (cs.PFB_WIDE_N, cs.PFB_FRAMES[0]))
    for n_ch, n in pfb_cases if "pfb" in kernels else ():
        hc = cs.pfb_branch(dev, n=n_ch)
        K, t = hc.shape[1], n // n_ch
        args = [(cs.randc((K - 1) * n_ch, gen, dev), cs.randc(n, gen, dev))
                for _ in range(cs.REPS)]
        plan = ck.pfb_plan(n_ch, K, t, ck._sm_count(dev))

        def pfb_layout(**kw):
            p = plan._replace(**kw)
            p = p._replace(rows=p.groups * p.outs)
            return p._replace(smem=ck._pfb_smem(n_ch, K, p.rows, p.chunk, len(p.radices),
                                                p.pitch, p.tw_len if p.tw_staged else 0,
                                                p.k_regs))

        layouts = {"plan": plan}
        for outs in (1, 4, 8):
            if outs != plan.outs:
                layouts[f"R = {outs}"] = pfb_layout(outs=outs)
        layouts["taps in shared memory"] = pfb_layout(k_regs=0)
        layouts["unpadded, twiddles unstaged"] = pfb_layout(
            pad_shift=ck._NO_PAD, tw_staged=False,
            pitch=ck._pfb_pitch(n_ch, ck._NO_PAD, plan.radices))
        layouts["v layout"] = ck.PfbPlan(False, 256, n_ch, 1, 1, 1, 0, (), (), (), n_ch, n_ch,
                                         ck._NO_PAD, False, 8 * n_ch)
        for name, p in layouts.items():
            if p.smem > ck._MAX_SMEM:
                continue

            def kern(h, x, p=p):
                y = torch.empty((t, n_ch), dtype=torch.complex64, device=dev)
                return ck._launch_pfb(h, x, hc.t(), y, False, p)

            report(f"pfb PFB-{n_ch} n={n} {name} (R={p.outs}, rows={p.rows})", kern,
                   lambda h, x: ck.pfb_plain(h, x, hc.t()), args)
    first = first_rotator(first_root, _build.BUILD_DIR / "first") if first_root else None
    ph0 = torch.tensor(1.25, device=dev)
    inc = torch.tensor(cs.FM_THETA, dtype=torch.float32, device=dev)

    def rotator_first(x):
        y = torch.empty_like(x)
        ck._raise_on(first.fsdr_rotator(x.data_ptr(), ph0.data_ptr(), inc.data_ptr(),
                                        y.data_ptr(), x.shape[0], ck._stream(x)), "first")
        return y

    def rotator_plain(x):
        return ck.rotator_plain(x, ph0, inc)

    for n in cs.FM_FRAMES if "rotator" in kernels else ():
        args = [(cs.randc(n, gen, dev),) for _ in range(cs.REPS)]
        report(f"rotator n={n} kernel", lambda x: ck.rotator(x, ph0, inc),
               rotator_plain, args)
        if first:
            report(f"rotator n={n} first design", rotator_first, rotator_plain, args)
    for kernel, L, n, nt in LANE_SHAPES:
        if kernel not in kernels:
            continue
        t = torch.randn(L, nt, generator=gen, device=dev)
        args = [(cs.randc(L * (nt - 1), gen, dev).view(L, nt - 1),
                 cs.randc(L * n, gen, dev).view(L, n)) for _ in range(cs.REPS)]
        if kernel == "fir_lanes":
            shape = (L, n, nt, 1, ck._sm_count(dev))

            def kern(h, x, p, t=t):
                return ck.fir_lanes(h, x, t, plan=p)

            def plain(h, x, t=t):
                return ck.fir_lanes_plain(h, x, t)
        else:
            shape = (L, n, cs.N_FFT, nt, ck._sm_count(dev))

            def kern(h, x, p, t=t):
                return ck.fir_fft_lanes(h, x, t, cs.N_FFT, plan=p)

            def plain(h, x, t=t):
                return ck.fir_fft_lanes_plain(h, x, t, cs.N_FFT)
        for i, p in enumerate(ck.plan_candidates(kernel, *shape)):
            if kernel == "fir_lanes":
                fields = (f"threads={p.threads}, blocks={p.blocks} a lane, bufs={p.bufs}, "
                          f"span_shift={p.span_shift}")
            else:
                fields = (f"threads={p.threads}, span_shift={p.span_shift}, "
                          f"pad_shift={p.pad_shift}, tw_staged={p.tw_staged}")
            report(f"{kernel} {L}x{n} {'rule' if i == 0 else 'layout'} {i} ({fields}, "
                   f"smem={p.smem})", lambda h, x, p=p, kern=kern: kern(h, x, p), plain, args)
    # every layout once a round, the order reversed each round, so that a
    # drift of the card over the run reaches every layout alike
    for r in range(rounds):
        for label, fn, args in cases if r % 2 == 0 else cases[::-1]:
            out[label]["runs_us"].append(cs.device_ms(fn, args) * 1e3)
    for label, v in out.items():
        v["us"] = statistics.median(v["runs_us"])
        runs = " ".join(f"{t:.3f}" for t in v["runs_us"])
        print(f"layout {label}: {v['us']:.3f} us (median of {rounds}: {runs}), "
              f"{v['err']:.2e} of peak against the plain version [{card}]")
    print(json.dumps({"device": card, "layouts": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
