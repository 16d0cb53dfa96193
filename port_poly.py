#!/usr/bin/env python3
"""Device time of the ``poly_fir`` kernel's two FM calls, in their lane forms
at the served shapes and one stream at the resident ones, on one CUDA card,
with what bounds each walk.

The served FM front end calls ``poly_fir_lanes`` twice a frame: the channel
filter (complex64, D = 4, m = 32, each lane's W) on ``[L, 32,000]`` and the
audio resampler (float32, D = 125, I = 24, m = 2, one W shared at stride 0)
on ``[L, 8,000]``. This times both at L = 16 and 64 sessions, and
``poly_fir`` one stream at the shapes of PERF.md's table (the channel filter
at 512,000, the resampler at 128,000 and 1,024,000 inputs, the decimator
D = 16, m = 8 at 2^18 and 4,096,000), each call checked against its plain
version and each lane against the one-stream launch on its row, bit for bit.
Beside each time: its plan, its bound (``utils/roofline.kernel_cost``, a
shared W read once) and a copy of its bytes (``chip_smoke.copy_ms`` of this
checkout: every input byte read once, every output byte written once, in
16-byte words).

    python3 port_poly.py [--root DIR] [--breakdown] [--candidates] [--rounds N]

``--root`` imports ``futuresdr_tpu_torch`` from DIR, another checkout (say
the parent commit, unpacked with ``git archive`` under ``build/``), and
builds its ``csrc/poly_fir.cu``, so that two versions are compared on one
card: run parent, change, change, parent. ``--breakdown`` adds, for DIR's
source, what bounds each lane walk: ``nvcc -Xptxas -v`` for every
instantiation (registers, spills, shared memory, and the blocks an SM they
allow at the plan's threads and shared memory), the instruction mix of each
loop of the FM instantiations in the SASS (``cuobjdump -sass``), and the
device time of the staging alone and of the MAC alone, each from a copy of
the source cut by ``STAGE_CUTS`` (the staging with the MAC gone; the MAC on
whatever shared memory holds, with the staging gone). ``--candidates``
also times each lane call under every layout of
``cuda_kernels.plan_candidates`` (the sweep's), each checked bit for bit
against the rule's. ``--rounds N`` times every case N times, each round in
the reverse order of the last. Each time is the device time of one call in a
CUDA graph over 20 distinct inputs (``chip_smoke.device_ms``). Prints one
line a case with the card's name and power limit, then one JSON line.
Exits nonzero without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

LANES = (16, 64)
FM_FRAME = 32_000                       # a served session's input samples a frame
# (label, m, D, I, complex, input samples) of the one-stream calls
ONE_STREAM = (("channel", 32, 4, 1, True, 512_000),
              ("resampler", 2, 125, 24, False, 128_000),
              ("resampler", 2, 125, 24, False, 1_024_000),
              ("decimator", 8, 16, 1, True, 1 << 18),
              ("decimator", 8, 16, 1, True, 4_096_000))

# The cuts of --breakdown: for each design of the "rows" and "gemm" kernels
# (the first one; the resident rows walk that replaced its "rows"; its gemm
# on a span with the rows reversed), text replacements that leave the staging alone (the MAC never
# runs, the copies and barriers stay) or the MAC alone (no copy is made, the
# MAC runs on whatever shared memory holds). A design whose text is not in the
# source is skipped.
STAGE_CUTS = {
    "rows, first design": {
        "stage": [("  __syncthreads();\n\n  const int lane = threadIdx.x % C;\n",
                   "  __syncthreads();\n  if (m >= 0) {\n    if (threadIdx.x == 0) {\n"
                   "      T v = s_x[1];\n      mac(v, v, s_w[1]);\n      y[q0] = v;\n"
                   "    }\n    return;\n  }\n  const int lane = threadIdx.x % C;\n")],
        "mac": [("  stage_span<T, BF16>(s_x, hist, x, q0 * D, (tq + m) * D, H, n,\n"
                 "                      [&](int k) { return k + pad * (k / RD); });\n"
                 "  for (int k = threadIdx.x; k < D * pw; k += blockDim.x) {\n"
                 "    const int s = k / pw, b = k - s * pw;\n"
                 "    s_w[k] = b <= m ? prep<BF16>(widen(W[(m - b) * D + s])) : 0.f;\n"
                 "  }\n", "")],
    },
    "gemm, first design": {
        "stage": [("\n  const int gn_count = (I + RN - 1) / RN;\n",
                   "\n  if (m >= 0) {\n    if (threadIdx.x == 0) {\n      T v = s_x[1];\n"
                   "      mac(v, v, s_w[1]);\n      y[q0 * I] = v;\n    }\n    return;\n"
                   "  }\n  const int gn_count = (I + RN - 1) / RN;\n")],
        "mac": [("  stage_w(s_w, W, J * I);\n"
                 "  stage_span<T, BF16>(s_x, hist, x, q0 * D, (tm + m) * D, H, n, "
                 "[](int k) { return k; });\n", "")],
    },
    "rows, resident walk": {
        "stage": [("    if (q < nq) {\n      const T* xt", "    if (q < nq && m < 0) {\n"
                   "      const T* xt")],
        "mac": [("  auto stage = [&](long long t, float* buf) {\n",
                 "  auto stage = [&](long long t, float* buf) {\n    if (m >= 0) return;\n")],
    },
    "gemm, rows reversed": {
        "stage": [("\n  const int gn_count = (I + RN - 1) / RN;\n",
                   "\n  if (m >= 0) {\n    if (threadIdx.x == 0) {\n      T v = s_x[1];\n"
                   "      mac(v, v, s_w[1]);\n      y[q0 * I] = v;\n    }\n    return;\n"
                   "  }\n  const int gn_count = (I + RN - 1) / RN;\n")],
        "mac": [("  stage_w(s_w, W, J * I);\n"
                 "  for (int k = threadIdx.x; k < rows * D; k += blockDim.x) {\n"
                 "    const int j = udiv(k, d_magic);\n"
                 "    stage_one(s_x + (rows - 1 - j) * D + (k - j * D), hist, x, q0 * D + k, H, "
                 "n);\n  }\n", "")],
    },
}


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def _nvcc(src: Path, so: Path, extra=()) -> str:
    """Build ``src`` with the port's flags (and ``extra``) into ``so``;
    returns the compiler's output, raises where it fails."""
    from futuresdr_tpu_torch.ops import _build
    so.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.FLAGS, *extra, "-o", str(so), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def _demangle(names):
    from futuresdr_tpu_torch.ops import _build
    tool = Path(_build._nvcc()).parent / "cu++filt"
    try:
        out = subprocess.run([str(tool) if tool.exists() else "c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60).stdout.splitlines()
        if len(out) != len(names):
            return {n: n for n in names}
        # "(bool)0" and "(int)8", as cu++filt writes template arguments: "false", "8"
        return {n: re.sub(r"\(int\)(-?\d+)", r"\1", d.replace("(bool)0", "false")
                          .replace("(bool)1", "true")) for n, d in zip(names, out)}
    except OSError:
        return {n: n for n in names}


def ptxas_report(log: str) -> dict:
    """``{kernel: {registers, spill_stores, spill_loads, smem, stack}}`` from
    ``-Xptxas -v``'s output."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            cur = m.group(1)
            out.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            out[cur].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers(?:, used \d+ barriers)?(?:, (\d+) bytes smem)?",
                      line)
        if m:
            out[cur].update(registers=int(m.group(1)), smem=int(m.group(2) or 0))
    names = _demangle(list(out))
    return {names[k]: v for k, v in out.items() if "registers" in v}


def blocks_per_sm(regs: int, threads: int, smem: int) -> int:
    """Resident blocks an H100 SM holds: 65,536 registers allotted 256 at a
    time a warp, 2,048 threads, 32 blocks, 233,472 bytes of shared memory
    with 1,024 reserved a block."""
    warps = -(-threads // 32)
    per_warp = -(-max(regs, 1) * 32 // 256) * 256
    by_regs = 65536 // (per_warp * warps)
    by_smem = 233_472 // (smem + 1024)
    return max(0, min(by_regs, by_smem, 2048 // (32 * warps), 32))


def sass_loops(so: Path, want) -> dict:
    """For each function whose demangled name contains one of ``want``: the
    instruction count by opcode of each loop that holds an FFMA (the range
    from a backward branch's target to the branch) and the function's
    length."""
    from futuresdr_tpu_torch.ops import _build
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True,
                          timeout=300).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*(.*?);",
                     line)
        if cur is not None and m:
            funcs[cur].append((int(m.group(1), 16), m.group(2), m.group(3)))
    names = _demangle(list(funcs))
    out = {}
    for raw, ins in funcs.items():
        name = names[raw]
        if not any(w in name for w in want):
            continue
        loops = []
        for addr, op, args in ins:
            t = re.search(r"0x([0-9a-f]+)", args)
            if not op.startswith("BRA") or not t or int(t.group(1), 16) > addr:
                continue
            start = int(t.group(1), 16)
            mix = {}
            for a, o, _ in ins:
                if start <= a <= addr:
                    mix[o.split(".")[0]] = mix.get(o.split(".")[0], 0) + 1
            if mix.get("FFMA"):
                loops.append({"start": start, "end": addr, "len": sum(mix.values()),
                              "mix": dict(sorted(mix.items(), key=lambda kv: -kv[1]))})
        out[name] = {"loops": loops, "function_len": len(ins)}
    return out


def cut_sources(src: Path, out_dir: Path) -> dict:
    """The source's two cuts for ``--breakdown``: ``{"stage": path, "mac":
    path}``, each with every design of ``STAGE_CUTS`` whose text the source
    holds cut."""
    text = src.read_text()
    found = [d for d, cut in STAGE_CUTS.items()
             if all(old in text for part in cut.values() for old, _ in part)]
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name in ("stage", "mac"):
        body = text
        for d in found:
            for old, new in STAGE_CUTS[d][name]:
                body = body.replace(old, new, 1)
        paths[name] = out_dir / f"poly_fir_{name}.cu"
        paths[name].write_text(body)
    print(f"breakdown: cut the staging from the MAC in {found or 'no design'}")
    return paths


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--breakdown", action="store_true")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--candidates", action="store_true")
    opts = ap.parse_args()
    root = Path(opts.root).resolve()
    sys.path.insert(0, str(root))
    sys.path.insert(1, str(Path(__file__).resolve().parent))
    import torch
    if not torch.cuda.is_available():
        print("port_poly: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from futuresdr_tpu_torch.ops import _build
    from futuresdr_tpu_torch.ops import cuda_kernels as ck
    from futuresdr_tpu_torch.utils.roofline import kernel_cost
    if Path(ck.__file__).resolve().parents[2] != root:
        raise RuntimeError(f"imported {ck.__file__}, not the package under {root}")
    _build.load("poly_fir")
    dev = torch.device("cuda:0")
    card = _card()
    n_sm = ck._sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 25)
    work = root / "build" / "port_poly"
    # the copy of a call's bytes is this checkout's yardstick (chip_smoke's
    # EMPTY_CU), whichever package --root names
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", Path(__file__).resolve().parent / "chip_smoke.py")
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    yard = here.start_empty_kernel(work)()
    copies = {}

    def copy_ms(in_bytes: int, out_bytes: int) -> float:
        if (in_bytes, out_bytes) not in copies:
            copies[in_bytes, out_bytes] = here.copy_ms(yard, dev, in_bytes, out_bytes)
        return copies[in_bytes, out_bytes]

    def bound(nbytes, ops):
        t_bytes, t_ops = nbytes / cs.PEAK_BYTES * 1e3, ops / cs.PEAK_FP32 * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    cases = []                   # (label, fn, args)
    out, plans = {}, {}

    def add(label, fn, args, plan, nbytes, ops, io_bytes, extra=None):
        b_ms, b_by = bound(nbytes, ops)
        plans[label] = (plan, "float2" if args[0][1].is_complex() else "float")
        out[label] = {"plan": repr(plan), "bound_us": b_ms * 1e3, "bound_by": b_by,
                      "copy_us": copy_ms(*io_bytes) * 1e3, "runs_us": [], **(extra or {})}
        cases.append((label, fn, args))

    def lane_case(kind, L):
        m, D, I = (32, 4, 1) if kind == "channel" else (2, 125, 24)
        cplx = kind == "channel"
        n = FM_FRAME if cplx else FM_FRAME // 4
        dtype = torch.complex64 if cplx else torch.float32
        w_shape = (m + 1, D) if I == 1 else (m + 1, D, I)
        W = torch.randn((L if cplx else 1,) + w_shape, generator=gen, device=dev)
        W = W.expand((L,) + w_shape)
        args = [(torch.randn(L, m * D, dtype=dtype, generator=gen, device=dev),
                 torch.randn(L, n, dtype=dtype, generator=gen, device=dev))
                for _ in range(cs.REPS)]
        return m, D, I, cplx, n, W, args

    for kind in ("channel", "resampler"):
        for L in LANES:
            m, D, I, cplx, n, W, args = lane_case(kind, L)
            h0, x0 = args[0]
            got = ck.poly_fir_lanes(h0, x0, W)
            per = torch.stack([ck.poly_fir(h0[i], x0[i], W[i].contiguous()) for i in range(L)])
            rel = cs.rel_err(got, ck.poly_fir_lanes_plain(h0, x0, W))[1]
            if not torch.equal(got, per) or rel > cs.TOL["poly_fir"]:
                raise RuntimeError(f"poly_fir_lanes {kind} L={L}: bit-equal to the "
                                   f"one-stream launches {torch.equal(got, per)}, {rel:.2e} "
                                   f"from the plain version")
            plan = ck.poly_fir_lanes_plan(L, m, D, I, n // D, cplx, n_sm)
            nbytes, ops = kernel_cost("poly_fir", n=n, m=m, D=D, I=I, complex=cplx)
            w_bytes = 4 * W[0].numel()
            shared = W.stride(0) == 0
            nbytes = L * nbytes - ((L - 1) * w_bytes if shared else 0)
            e = 8 if cplx else 4
            io = (L * (n + m * D) * e + (1 if shared else L) * w_bytes, L * n // D * I * e)
            add(f"lanes {kind} L={L}", lambda h, x, W=W: ck.poly_fir_lanes(h, x, W), args,
                plan, nbytes, L * ops, io, {"err": rel, "lanes_bit_equal": True})
            if not opts.candidates:
                continue
            for i, p in enumerate(ck.plan_candidates("poly_fir_lanes", L, m, D, I, n // D,
                                                     int(cplx), n_sm)):
                def cand(h, x, W=W, p=p):
                    return ck.poly_fir_lanes(h, x, W, plan=p)
                if not torch.equal(cand(h0, x0), got):
                    raise RuntimeError(f"poly_fir_lanes {kind} L={L} candidate {p}: not "
                                       f"bit-equal to the rule's plan")
                add(f"lanes {kind} L={L} candidate {i}", cand, args, p, nbytes, L * ops, io)
    for kind, m, D, I, cplx, n in ONE_STREAM:
        dtype = torch.complex64 if cplx else torch.float32
        W = torch.randn((m + 1, D) if I == 1 else (m + 1, D, I), generator=gen, device=dev)
        args = [(torch.randn(m * D, dtype=dtype, generator=gen, device=dev),
                 torch.randn(n, dtype=dtype, generator=gen, device=dev))
                for _ in range(cs.REPS)]
        rel = cs.rel_err(ck.poly_fir(*args[0], W), ck.poly_fir_plain(*args[0], W))[1]
        if rel > cs.TOL["poly_fir"]:
            raise RuntimeError(f"poly_fir {kind} n={n}: {rel:.2e} from the plain version")
        plan = ck.poly_fir_plan(m, D, I, n // D, cplx, n_sm)
        nbytes, ops = kernel_cost("poly_fir", n=n, m=m, D=D, I=I, complex=cplx)
        e = 8 if cplx else 4
        add(f"one stream {kind} n={n}", lambda h, x, W=W: ck.poly_fir(h, x, W), args, plan,
            nbytes, ops, ((n + m * D) * e + 4 * W.numel(), n // D * I * e), {"err": rel})

    if opts.breakdown:
        src = root / "futuresdr_tpu_torch" / "csrc" / "poly_fir.cu"
        cuts = cut_sources(src, work)
        builds = [(src, work / "libpoly_fir_v.so", ("-Xptxas", "-v"))] + [
            (path, work / f"libpoly_fir_{name}.so", ()) for name, path in cuts.items()]
        with ThreadPoolExecutor(len(builds)) as pool:       # one nvcc a build, all at once
            log = list(pool.map(lambda b: _nvcc(*b), builds))[0]
        regs = ptxas_report(log)
        for name, r in regs.items():
            print(f"ptxas {name}: {r} [{card}]")
        loops = sass_loops(work / "libpoly_fir_v.so",
                           ("poly_fir_rows<float2, false, float,",
                            "poly_fir_gemm<float, false, float,"))
        for name, v in loops.items():
            print(f"sass {name}: {v['function_len']} instructions")
            for lp in v["loops"]:
                print(f"sass   loop {lp['start']:#x}-{lp['end']:#x}: {lp['len']} "
                      f"instructions {lp['mix']}")
        libs = {name: ctypes.CDLL(str(work / f"libpoly_fir_{name}.so")) for name in cuts}
        whole = _build._libs["poly_fir"]
        for label, fn, args in list(cases):
            if not label.startswith("lanes") or "candidate" in label:
                continue
            plan, elt = plans[label]
            inst = (f"poly_fir_rows<{elt}, false, float, {plan.tile_rows}, {plan.ksplit}"
                    if plan.tiling == "rows" else
                    f"poly_fir_gemm<{elt}, false, float, {plan.tile_rows}, "
                    f"{plan.tile_phases}>" if plan.tile_rows > 1 else
                    f"poly_fir_gemm<{elt}, false, float, {plan.tile_phases}>")
            kern = next((k for k in sorted(regs, key=lambda k: "false>" in k) if inst in k),
                        None)
            if kern is not None:
                r = regs[kern]
                out[label]["ptxas"] = {**r, "kernel": inst, "blocks_per_sm": blocks_per_sm(
                    r["registers"], plan.threads, plan.smem + r["smem"])}
            for name, lib in libs.items():
                def cut(h, x, lib=lib, fn=fn):
                    _build._libs["poly_fir"] = lib
                    try:
                        return fn(h, x)
                    finally:
                        _build._libs["poly_fir"] = whole
                cases.append((f"{label} [{name} alone]", cut, args))
                out[f"{label} [{name} alone]"] = {"runs_us": []}
    for r in range(opts.rounds):
        for label, fn, args in cases if r % 2 == 0 else cases[::-1]:
            out[label]["runs_us"].append(cs.device_ms(fn, args) * 1e3)
    for label, v in out.items():
        v["us"] = statistics.median(v["runs_us"])
        runs = " ".join(f"{t:.3f}" for t in v["runs_us"])
        extra = "".join(f", {k} {v[k]:.3f} us" for k in ("bound_us", "copy_us") if k in v)
        extra += f" ({v['bound_by']})" if "bound_by" in v else ""
        extra += f", plan {v['plan']}" if "plan" in v else ""
        extra += f", ptxas {v['ptxas']}" if "ptxas" in v else ""
        print(f"poly {label}: {v['us']:.3f} us (median of {opts.rounds}: {runs}){extra} "
              f"[{card}]")
    print(json.dumps({"device": card, "root": str(root), "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
