#!/usr/bin/env python3
"""Device time of the ``rotator_lanes`` and ``pfb_lanes`` kernels at the
served shapes on one CUDA card, with what bounds each.

``rotator_lanes`` is timed at 64 × 512 (serve_ab's sessions), 64 × 32,000
(the served FM tuner) and 16 × 2^18; ``pfb_lanes`` at PFB-64 (K = 12) on 16 ×
2^18 and 64 × 2^15 (the served channelizer, each lane's own taps passed as the
stage carries them, its ``[L, N, K]`` carry transposed) and on one lane of
2^21. Each call is checked against its plain version and each lane against
the one-stream launch on its row, bit for bit. Beside each time: the plan
that ran, its bound (``utils/roofline.kernel_cost``), a copy of its bytes
(``chip_smoke.copy_ms`` of this checkout: every input byte read once, every
output byte written once, in 16-byte words) and an empty launch on the same
grid (``chip_smoke.EMPTY_CU``).

    python3 port_lanes.py [--root DIR] [--breakdown] [--candidates] [--rounds N]

``--root`` imports ``futuresdr_tpu_torch`` from DIR, another checkout (say
the parent commit, unpacked with ``git archive`` under ``build/``), and
builds its ``csrc/``, so that two versions are compared on one card: run
parent, change, change, parent. ``--breakdown`` adds, for DIR's source,
``nvcc -Xptxas -v`` for every instantiation of ``rotator.cu`` and
``pfb.cu`` (registers, spills, shared memory, and the blocks an SM they
allow at the plan's threads and shared memory), and the device time of each
phase of ``pfb_lanes`` alone, each from a copy of ``pfb.cu`` cut by
``PFB_CUTS`` for the layout the plan ran (a cut that no longer applies
raises): the staging alone, the MAC alone, the IDFT alone (its last pass
into shared memory) and the store alone (the last pass's stores of whatever
shared memory holds, without its arithmetic). ``--candidates`` also times
each ``pfb_lanes`` call under every layout of ``cuda_kernels.plan_candidates``
(the sweep's), each checked bit for bit against the rule's. ``--rounds N``
times every case N times, each round in the reverse order of the last. Each
time is the device time of one call in a CUDA graph over 20 distinct inputs
(``chip_smoke.device_ms``). Prints one line a case with the card's name and
power limit, then one JSON line. Exits nonzero without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROTATOR_SHAPES = ((64, 512), (64, 32_000), (16, 1 << 18))
PFB_N, PFB_K = 64, 12
PFB_SHAPES = ((16, 1 << 18), (64, 1 << 15), (1, 1 << 21))

# The cuts of --breakdown, for each layout of the pfb kernel (the kernel's
# name): text replacements that leave one phase of a tile alone. "stage": the
# copies and their wait, then the block moves on; "mac": no copy is made, the
# taps' loads and the MAC run on whatever shared memory holds, no IDFT;
# "idft": no copy, no MAC, the passes run with the last one writing shared
# memory; "store": no copy, no MAC, no arithmetic pass, the last pass's stores
# of shared memory to y. ``k`` (taps a branch, at least 1) and in the walk,
# whose k is a constant, ``n`` (channels) are the runtime conditions the
# compiler cannot fold. Both layouts share the Stockham passes (``idft_pass``),
# so a phase's cut file is the union of every layout's cuts of that phase.
# Every layout the source defines must be cut: a replacement whose text is
# not in the source exactly once raises (an edit of the kernel moved it).
_NO_STAGE = ("    if (active) {\n      for (int r = g; r < span; r += groups) {",
             "    if (active && k < 0) {\n      for (int r = g; r < span; r += groups) {")
_NO_MAC = ("    if (active && c < n) {\n      // v[g R + r, c] = sum_kk",
           "    if (active && c < n && k < 0) {\n      // v[g R + r, c] = sum_kk")
_AFTER_MAC = ("    __syncthreads();                               // before buffer ch & 1 is "
              "staged again\n  }\n")
_LAST_STORE = ("        fsdr::stockham_bfly<RX, true, false>(src + row * pitch, "
               "y + (s0 + row) * n, psh,\n                                             tw, j, "
               "nb, ns);\n")
_STORE_ONLY = ("        const int kq = j & (ns - 1);\n"
               "#pragma unroll\n"
               "        for (int q = 0; q < RX; ++q) {\n"
               "          y[(s0 + row) * n + (j - kq) * RX + kq + q * ns] =\n"
               "              src[row * pitch + skew(j + q * nb, psh)];\n"
               "        }\n")
_INNER_PASS = ("        idft_pass_radix<false>(code, src, dst, y, s0, t, tr, n, pitch, psh, "
               "tw + tw_off, ns);\n        __syncthreads();\n")
_LAST_PASS = ("        idft_pass_radix<true>(code, src, dst, y, s0, t, tr, n, pitch, psh, "
              "tw + tw_off, ns);\n")
_W_WAIT = ("    mbar_wait(bars + j % kWalkStages, static_cast<unsigned>((j / kWalkStages) & 1));"
           "\n")
_W_TOP = "    const int top = s0 == 0 || q == q0 ? 0 : k - 1;"
_W_ISSUE = "  auto issue = [&](long long q) {\n"
_W_PASS0 = "    idft_pass_radix<false>(code0, s_v, s_w, y,"
_W_PASS1 = "      idft_pass_radix<true>(code1, s_w, s_v, y + lane * ys,"
_W_LAST_HALF = "    if (static_cast<int>(threadIdx.x) < half) {"
_W_NO_COPY = [(_W_ISSUE, _W_ISSUE + "    if (n > 0) return;\n"),
              (_W_WAIT, "    if (n < 0)\n" + _W_WAIT)]
_W_NO_MAC = [(_W_TOP, _W_TOP + "\n    if (n > 0) return;")]
_W_NO_PASS0 = [(_W_PASS0, "    if (n < 0)\n" + _W_PASS0)]
_W_NO_IDFT = _W_NO_PASS0 + [(_W_LAST_HALF, _W_LAST_HALF.replace("half)", "half && n < 0)"))]
PFB_CUTS = {
    "pfb_window_kernel": {
        "stage": [("    __syncthreads();\n    if (active && c < n) {\n      // v[g R + r, c]",
                   "    __syncthreads();\n    if (k > 0) return;\n    if (active && c < n) {\n"
                   "      // v[g R + r, c]")],
        "mac": [_NO_STAGE, (_AFTER_MAC, _AFTER_MAC + "  if (k > 0) return;\n")],
        "idft": [_NO_STAGE, _NO_MAC, (_LAST_PASS, _LAST_PASS.replace("<true>", "<false>"))],
        "store": [_NO_STAGE, _NO_MAC, (_LAST_STORE, _STORE_ONLY),
                  (_INNER_PASS, "        __syncthreads();\n")],
    },
    "pfb_walk_kernel": {
        "stage": [(_W_WAIT, _W_WAIT + "    if (n > 0) return;\n")] + _W_NO_IDFT,
        "mac": _W_NO_COPY + _W_NO_IDFT,
        "idft": _W_NO_COPY + _W_NO_MAC + [(_W_PASS1, _W_PASS1.replace("<true>", "<false>"))],
        "store": _W_NO_COPY + _W_NO_MAC + _W_NO_PASS0 + [(_LAST_STORE, _STORE_ONLY)],
    },
}
PHASES = ("stage", "mac", "idft", "store")


def cut_sources(src: Path, out_dir: Path) -> tuple:
    """``({phase: path}, layouts)``: the source cut to each phase alone in
    every layout of ``PFB_CUTS`` that it defines (``layouts``, the kernels'
    names). Raises where a replacement does not apply exactly once."""
    text = src.read_text()
    layouts = [d for d in PFB_CUTS if re.search(rf"^{d}\(", text, re.M)]
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name in PHASES:
        body = text
        cuts = list(dict.fromkeys(c for d in layouts for c in PFB_CUTS[d][name]))
        for old, new in cuts:
            if body.count(old) != 1:
                raise RuntimeError(f"breakdown: the {name} cut's text {old!r} is in {src} "
                                   f"{body.count(old)} times, not once")
            body = body.replace(old, new)
        paths[name] = out_dir / f"pfb_{name}.cu"
        paths[name].write_text(body)
    print(f"breakdown: cut pfb.cu's phases apart in {layouts}")
    return paths, layouts


def grid_of(kind: str, plan, L: int, n: int) -> tuple:
    """``(blocks, threads)`` a plan launches (either checkout's plans)."""
    if kind == "rotator_lanes":                     # a block of 256 threads a tile
        return max(1, -(-(n // 2) // 256)) * L, 256
    t = n // PFB_N
    if getattr(plan, "blocks", 0):                  # the walk's resident blocks
        return min(plan.blocks, L * -(-t // plan.rows)), plan.threads
    return -(-t // plan.rows) * L, plan.threads


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--breakdown", action="store_true")
    ap.add_argument("--candidates", action="store_true")
    ap.add_argument("--rounds", type=int, default=1)
    opts = ap.parse_args()
    root = Path(opts.root).resolve()
    here_dir = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    sys.path.insert(1, str(here_dir))
    import torch
    if not torch.cuda.is_available():
        print("port_lanes: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from futuresdr_tpu_torch.ops import _build
    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    from futuresdr_tpu_torch.utils.roofline import kernel_cost
    from port_poly import _card, _nvcc, blocks_per_sm, ptxas_report
    if Path(ck.__file__).resolve().parents[2] != root:
        raise RuntimeError(f"imported {ck.__file__}, not the package under {root}")
    _build.load("rotator")
    _build.load("pfb")
    dev = torch.device("cuda:0")
    card = _card()
    n_sm = ck._sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 26)
    work = root / "build" / "port_lanes"
    # the yardsticks are this checkout's (chip_smoke's EMPTY_CU), whichever
    # package --root names
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  here_dir / "chip_smoke.py")
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    yard = here.start_empty_kernel(work)()
    cases = []                   # (label, fn, args)
    out, plans = {}, {}

    def bound(nbytes, ops):
        t_bytes, t_ops = nbytes / cs.PEAK_BYTES * 1e3, ops / cs.PEAK_FP32 * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    def empty_us(blocks, threads, args):
        def fn(*_):
            ck._raise_on(yard.fsdr_empty(blocks, threads, ck._stream(args[0][0])), "empty")
        return cs.device_ms(fn, args) * 1e3

    def add(label, fn, args, kind, plan, L, n, nbytes, ops, io, extra):
        b_ms, b_by = bound(nbytes, ops)
        blocks, threads = grid_of(kind, plan, L, n)
        plans[label] = plan
        out[label] = {"plan": repr(plan), "bound_us": b_ms * 1e3, "bound_by": b_by,
                      "copy_us": here.copy_ms(yard, dev, *io) * 1e3,
                      "empty_us": empty_us(blocks, threads, args), "grid": [blocks, threads],
                      "runs_us": [], **extra}
        cases.append((label, fn, args))

    for L, n in ROTATOR_SHAPES:
        args = [(torch.randn(L, n, dtype=torch.complex64, generator=gen, device=dev),
                 torch.rand(L, generator=gen, device=dev) * 6,
                 (torch.rand(L, generator=gen, device=dev) - 0.5) * 0.4)
                for _ in range(cs.REPS)]
        x, ph0, inc = args[0]
        y, nxt = ck.rotator_lanes(x, ph0, inc)
        plan = ck.last_plans.get("rotator_lanes", getattr(ck, "_ROTATOR_PLAN", None))
        per = [ck.rotator(x[i], ph0[i], inc[i]) for i in range(L)]
        py, pn = ck.rotator_lanes_plain(x, ph0, inc)
        rel = cs.rel_err(y, py)[1]
        equal = torch.equal(y, torch.stack([p[0] for p in per])) and \
            torch.equal(nxt, torch.stack([p[1] for p in per]))
        if not equal or rel > cs.TOL["rotator"] or not torch.equal(nxt, pn):
            raise RuntimeError(f"rotator_lanes L={L} n={n}: bit-equal to the one-stream "
                               f"launches {equal}, {rel:.2e} from the plain version")
        nbytes, ops = kernel_cost("rotator", n=n)
        label = f"rotator_lanes {L} x {n}"
        add(label, lambda x, p, i: ck.rotator_lanes(x, p, i), args, "rotator_lanes", plan, L,
            n, L * nbytes, L * ops, (L * (8 * n + 8), L * (8 * n + 4)),
            {"err": rel, "lanes_bit_equal": True})
    hc = cs.pfb_branch(dev)                              # the PFB-64 prototype, [N, K]
    for L, n in PFB_SHAPES:
        taps = (hc * (1 + 0.1 * torch.randn(L, PFB_N, PFB_K, generator=gen, device=dev))
                ).contiguous().transpose(1, 2)
        args = [(torch.randn(L, (PFB_K - 1) * PFB_N, dtype=torch.complex64, generator=gen,
                             device=dev),
                 torch.randn(L, n, dtype=torch.complex64, generator=gen, device=dev))
                for _ in range(4 if n >= 1 << 21 else cs.REPS)]
        h0, x0 = args[0]
        got = ck.pfb_lanes(h0, x0, taps)
        plan = ck.last_plans["pfb_lanes"]
        per = torch.stack([ck.pfb(h0[i], x0[i], taps[i]) for i in range(L)])
        rel = cs.rel_err(got, ck.pfb_lanes_plain(h0, x0, taps))[1]
        if not torch.equal(got, per) or rel > cs.TOL["pfb"]:
            raise RuntimeError(f"pfb_lanes L={L} n={n}: bit-equal to the one-stream launches "
                               f"{torch.equal(got, per)}, {rel:.2e} from the plain version")
        nbytes, ops = kernel_cost("pfb_lanes", L=L, n=n, N=PFB_N, K=PFB_K)
        io = (L * (8 * (n + (PFB_K - 1) * PFB_N) + 4 * PFB_N * PFB_K), L * 8 * n)
        label = f"pfb_lanes {L} x {n}"
        add(label, lambda h, x, taps=taps: ck.pfb_lanes(h, x, taps), args, "pfb_lanes", plan,
            L, n, nbytes, ops, io, {"err": rel, "lanes_bit_equal": True})
        if opts.candidates:
            for i, p in enumerate(ck.plan_candidates("pfb_lanes", L, PFB_N, PFB_K,
                                                     n // PFB_N, n_sm)):
                def cand(h, x, taps=taps, p=p):
                    return ck.pfb_lanes(h, x, taps, plan=p)
                if not torch.equal(cand(h0, x0), got):
                    raise RuntimeError(f"pfb_lanes {L} x {n} candidate {p}: not bit-equal "
                                       f"to the rule's plan")
                add(f"{label} candidate {i}", cand, args, "pfb_lanes", p, L, n, nbytes, ops,
                    io, {})

    if opts.breakdown:
        csrc = root / "futuresdr_tpu_torch" / "csrc"
        cuts, cut_layouts = cut_sources(csrc / "pfb.cu", work)
        builds = [(csrc / "pfb.cu", work / "libpfb_v.so", ("-Xptxas", "-v")),
                  (csrc / "rotator.cu", work / "librotator_v.so", ("-Xptxas", "-v"))]
        builds += [(path, work / f"libpfb_{name}.so", ("-I", str(csrc)))
                   for name, path in cuts.items()]
        with ThreadPoolExecutor(len(builds)) as pool:       # one nvcc a build, all at once
            logs = list(pool.map(lambda b: _nvcc(*b), builds))
        regs = {**ptxas_report(logs[0]), **ptxas_report(logs[1])}
        for name, r in regs.items():
            print(f"ptxas {name}: {r}, blocks an SM at 256 threads "
                  f"{blocks_per_sm(r['registers'], 256, r['smem'])} [{card}]")
        libs = {name: ctypes.CDLL(str(work / f"libpfb_{name}.so")) for name in cuts}
        whole = _build._libs["pfb"]
        for label, fn, args in list(cases):
            if not label.startswith("pfb_lanes") or "candidate" in label:
                continue
            plan = plans[label]
            layout = "pfb_walk_kernel" if getattr(plan, "blocks", 0) else "pfb_window_kernel"
            if layout not in cut_layouts:
                raise RuntimeError(f"breakdown: {label} ran {layout}, which has no cut")
            kern = next((k for k in regs if layout in k and f"<{plan.k_regs}, {plan.outs}>" in k),
                        None)
            if kern is not None:
                r = regs[kern]
                out[label]["ptxas"] = {**r, "kernel": kern.split("(")[0],
                                       "blocks_per_sm": blocks_per_sm(
                                           r["registers"], plan.threads, plan.smem + r["smem"])}
            for name, lib in libs.items():
                def cut(h, x, lib=lib, fn=fn):
                    _build._libs["pfb"] = lib
                    try:
                        return fn(h, x)
                    finally:
                        _build._libs["pfb"] = whole
                cases.append((f"{label} [{name} alone]", cut, args))
                out[f"{label} [{name} alone]"] = {"runs_us": []}
    for r in range(opts.rounds):
        for label, fn, args in cases if r % 2 == 0 else cases[::-1]:
            out[label]["runs_us"].append(cs.device_ms(fn, args) * 1e3)
    for label, v in out.items():
        v["us"] = statistics.median(v["runs_us"])
        runs = " ".join(f"{t:.3f}" for t in v["runs_us"])
        extra = "".join(f", {k[:-3]} {v[k]:.3f} us" for k in ("bound_us", "copy_us", "empty_us")
                        if k in v)
        extra += f" ({v['bound_by']})" if "bound_by" in v else ""
        extra += f", grid {v['grid']}, plan {v['plan']}" if "plan" in v else ""
        extra += f", ptxas {v['ptxas']}" if "ptxas" in v else ""
        print(f"lanes {label}: {v['us']:.3f} us (median of {opts.rounds}: {runs}){extra} "
              f"[{card}]")
    print(json.dumps({"device": card, "root": str(root), "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
