#!/usr/bin/env python3
"""Device time of the port's lane kernels, and of the one-stream calls beside
them, at the served shapes on one CUDA card, with what bounds each: one
breakdown tool driven by one table (``KERNELS``), an entry a kernel.

* ``poly_fir``: the served FM front end's two ``poly_fir_lanes`` calls a
  frame, the channel filter (complex64, D = 4, m = 32, each lane's W) on
  ``[L, 32,000]`` and the audio resampler (float32, D = 125, I = 24, m = 2,
  one W shared at stride 0) on ``[L, 8,000]``, at L = 16 and 64; and
  ``poly_fir`` one stream at the channel filter's 512,000, the resampler's
  128,000 and 1,024,000 inputs and the decimator's (D = 16, m = 8) 2^18 and
  4,096,000.
* ``rotator_lanes``: 64 × 512 (serve_ab's sessions), 64 × 32,000 (the served
  FM tuner), 16 × 2^18.
* ``pfb_lanes``: PFB-64 (K = 12) on 16 × 2^18 and 64 × 2^15 (the served
  channelizer, each lane's taps as the stage carries them, its ``[L, N, K]``
  carry transposed) and one lane of 2^21.
* ``quad_demod_lanes``: the served FM demod on 16 and 64 × 8,000, and one
  lane of 128,000 and of 1,024,000 beside the one-stream ``quad_demod``
  launch on the same frames.

Each call is checked against its plain version and each lane against the
one-stream launch on its row, bit for bit. Beside each time: the plan or
layout that ran, its bound (``utils/roofline.kernel_cost``, a shared W read
once), a copy of its bytes (``chip_smoke.copy_ms`` of this checkout: every
input byte read once, every output byte written once, in 16-byte words) and,
where the entry knows its grid, an empty launch on that grid
(``chip_smoke.EMPTY_CU``).

    python3 port_lanes.py [--root DIR] [--kernels NAME,...] [--breakdown]
                          [--candidates] [--rounds N] [--same-sass DIR]

``--root`` imports ``futuresdr_tpu_torch`` from DIR, another checkout (say
the parent commit, unpacked with ``git archive`` under ``build/``), and
builds its ``csrc/``, so that two versions are compared on one card: run
parent, change, change, parent. ``--kernels`` takes a subset of the table.
``--breakdown`` adds, for DIR's sources: ``nvcc -Xptxas -v`` of every
instantiation (registers, spills, shared memory, and the blocks an SM they
allow at the plan's threads and shared memory), the instruction mix of each
loop of the entries' ``sass_loops`` (``cuobjdump -sass``), and the device
time of each phase of the entry alone. A phase is cut by its marker in the
source: the build with ``-DFSDR_CUT_<PHASE>`` runs that phase alone, and a
source that lacks one of its entry's markers, or whose cut build's SASS
equals the whole one's, raises. ``--candidates`` also times each lane call
under every layout of ``cuda_kernels.plan_candidates`` (the sweep's), each
checked bit for bit against the rule's. ``--rounds N`` times every case N
times, each round in the reverse order of the last. ``--same-sass DIR``
builds each entry's source of both checkouts with no marker defined and
compares their SASS function by function, the instructions alone (this is
how a marker is shown to leave the default build as it was). Each time is
the device time of one call in a CUDA graph over 20 distinct inputs
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
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, NamedTuple, Optional


class Case(NamedTuple):
    label: str
    fn: Callable
    args: list                     # the distinct inputs a timing's graph takes
    plan: object = None
    nbytes: int = 0                # the bound's bytes and operations
    ops: int = 0
    io: Optional[tuple] = None     # (input bytes, output bytes) of the copy
    grid: Optional[tuple] = None   # (blocks, threads) of the empty launch
    extra: Optional[dict] = None
    cut: bool = False              # timed phase by phase under --breakdown
    kernel: tuple = ()             # substrings naming its instantiation (ptxas)


class Kernel(NamedTuple):
    source: str                    # csrc/<source>.cu, the _build library's name
    phases: tuple                  # what --breakdown times alone: FSDR_CUT_<PHASE>
    cases: Callable                # cases(ctx) -> [Case]
    sass_loops: tuple = ()         # instantiations whose loops --breakdown lists


# ---------------------------------------------------------------------------
# the table's cases
# ---------------------------------------------------------------------------

POLY_LANES = (16, 64)
FM_FRAME = 32_000                       # a served session's input samples a frame
# (label, m, D, I, complex, input samples) of the one-stream poly_fir calls
POLY_ONE_STREAM = (("channel", 32, 4, 1, True, 512_000),
                   ("resampler", 2, 125, 24, False, 128_000),
                   ("resampler", 2, 125, 24, False, 1_024_000),
                   ("decimator", 8, 16, 1, True, 1 << 18),
                   ("decimator", 8, 16, 1, True, 4_096_000))
ROTATOR_SHAPES = ((64, 512), (64, 32_000), (16, 1 << 18))
PFB_N, PFB_K = 64, 12
PFB_SHAPES = ((16, 1 << 18), (64, 1 << 15), (1, 1 << 21))
QUAD_DEMOD_SHAPES = ((16, 8_000), (64, 8_000), (1, 128_000), (1, 1_024_000))


class Ctx(NamedTuple):
    torch: object
    cs: object                     # chip_smoke of --root
    ck: object                     # its cuda_kernels
    kernel_cost: Callable
    dev: object
    n_sm: int
    candidates: bool


def _gen(ctx, offset):
    return ctx.torch.Generator(device=ctx.dev).manual_seed(ctx.cs.SEED + offset)


def _poly_inst(plan, elt):
    if plan.tiling == "rows":
        return (f"poly_fir_rows<{elt}, false, float, {plan.tile_rows}, {plan.ksplit}",)
    if plan.tile_rows > 1:
        return (f"poly_fir_gemm<{elt}, false, float, {plan.tile_rows}, {plan.tile_phases}>",)
    return (f"poly_fir_gemm<{elt}, false, float, {plan.tile_phases}>",)


def poly_fir_cases(ctx):
    torch, cs, ck = ctx.torch, ctx.cs, ctx.ck
    gen, dev = _gen(ctx, 25), ctx.dev
    out = []
    for kind in ("channel", "resampler"):
        for L in POLY_LANES:
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
            h0, x0 = args[0]
            got = ck.poly_fir_lanes(h0, x0, W)
            per = torch.stack([ck.poly_fir(h0[i], x0[i], W[i].contiguous()) for i in range(L)])
            rel = cs.rel_err(got, ck.poly_fir_lanes_plain(h0, x0, W))[1]
            if not torch.equal(got, per) or rel > cs.TOL["poly_fir"]:
                raise RuntimeError(f"poly_fir_lanes {kind} L={L}: bit-equal to the "
                                   f"one-stream launches {torch.equal(got, per)}, {rel:.2e} "
                                   f"from the plain version")
            plan = ck.poly_fir_lanes_plan(L, m, D, I, n // D, cplx, ctx.n_sm)
            nbytes, ops = ctx.kernel_cost("poly_fir", n=n, m=m, D=D, I=I, complex=cplx)
            w_bytes = 4 * W[0].numel()
            shared = W.stride(0) == 0
            nbytes = L * nbytes - ((L - 1) * w_bytes if shared else 0)
            e = 8 if cplx else 4
            io = (L * (n + m * D) * e + (1 if shared else L) * w_bytes, L * n // D * I * e)
            elt = "float2" if cplx else "float"
            label = f"lanes {kind} L={L}"
            out.append(Case(label, lambda h, x, W=W: ck.poly_fir_lanes(h, x, W), args, plan,
                            nbytes, L * ops, io, None, {"err": rel, "lanes_bit_equal": True},
                            True, _poly_inst(plan, elt)))
            if not ctx.candidates:
                continue
            for i, p in enumerate(ck.plan_candidates("poly_fir_lanes", L, m, D, I, n // D,
                                                     int(cplx), ctx.n_sm)):
                def cand(h, x, W=W, p=p):
                    return ck.poly_fir_lanes(h, x, W, plan=p)
                if not torch.equal(cand(h0, x0), got):
                    raise RuntimeError(f"poly_fir_lanes {kind} L={L} candidate {p}: not "
                                       f"bit-equal to the rule's plan")
                out.append(Case(f"{label} candidate {i}", cand, args, p, nbytes, L * ops, io))
    for kind, m, D, I, cplx, n in POLY_ONE_STREAM:
        dtype = torch.complex64 if cplx else torch.float32
        W = torch.randn((m + 1, D) if I == 1 else (m + 1, D, I), generator=gen, device=dev)
        args = [(torch.randn(m * D, dtype=dtype, generator=gen, device=dev),
                 torch.randn(n, dtype=dtype, generator=gen, device=dev))
                for _ in range(cs.REPS)]
        rel = cs.rel_err(ck.poly_fir(*args[0], W), ck.poly_fir_plain(*args[0], W))[1]
        if rel > cs.TOL["poly_fir"]:
            raise RuntimeError(f"poly_fir {kind} n={n}: {rel:.2e} from the plain version")
        plan = ck.poly_fir_plan(m, D, I, n // D, cplx, ctx.n_sm)
        nbytes, ops = ctx.kernel_cost("poly_fir", n=n, m=m, D=D, I=I, complex=cplx)
        e = 8 if cplx else 4
        out.append(Case(f"one stream {kind} n={n}", lambda h, x, W=W: ck.poly_fir(h, x, W),
                        args, plan, nbytes, ops,
                        ((n + m * D) * e + 4 * W.numel(), n // D * I * e), None,
                        {"err": rel}))
    return out


def rotator_lanes_cases(ctx):
    torch, cs, ck = ctx.torch, ctx.cs, ctx.ck
    gen, dev = _gen(ctx, 26), ctx.dev
    out = []
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
        nbytes, ops = ctx.kernel_cost("rotator", n=n)
        out.append(Case(f"{L} x {n}", lambda x, p, i: ck.rotator_lanes(x, p, i), args, plan,
                        L * nbytes, L * ops, (L * (8 * n + 8), L * (8 * n + 4)),
                        (max(1, -(-(n // 2) // 256)) * L, 256),     # a block a tile
                        {"err": rel, "lanes_bit_equal": True}))
    return out


def pfb_lanes_cases(ctx):
    torch, cs, ck = ctx.torch, ctx.cs, ctx.ck
    gen, dev = _gen(ctx, 27), ctx.dev
    out = []
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
        nbytes, ops = ctx.kernel_cost("pfb_lanes", L=L, n=n, N=PFB_N, K=PFB_K)
        io = (L * (8 * (n + (PFB_K - 1) * PFB_N) + 4 * PFB_N * PFB_K), L * 8 * n)

        def grid(p):
            t = n // PFB_N
            if getattr(p, "blocks", 0):                 # the walk's resident blocks
                return min(p.blocks, L * -(-t // p.rows)), p.threads
            return -(-t // p.rows) * L, p.threads

        def inst(p):
            return (("pfb_walk_kernel<false>",) if getattr(p, "blocks", 0) else
                    ("pfb_window_kernel", f"<{p.k_regs}, {p.outs}>"))
        label = f"{L} x {n}"
        out.append(Case(label, lambda h, x, taps=taps: ck.pfb_lanes(h, x, taps), args, plan,
                        nbytes, ops, io, grid(plan), {"err": rel, "lanes_bit_equal": True},
                        True, inst(plan)))
        if not ctx.candidates:
            continue
        for i, p in enumerate(ck.plan_candidates("pfb_lanes", L, PFB_N, PFB_K, n // PFB_N,
                                                 ctx.n_sm)):
            def cand(h, x, taps=taps, p=p):
                return ck.pfb_lanes(h, x, taps, plan=p)
            if not torch.equal(cand(h0, x0), got):
                raise RuntimeError(f"pfb_lanes {label} candidate {p}: not bit-equal to the "
                                   f"rule's plan")
            out.append(Case(f"{label} candidate {i}", cand, args, p, nbytes, ops, io,
                            grid(p)))
    return out


def quad_demod_lanes_cases(ctx):
    torch, cs, ck = ctx.torch, ctx.cs, ctx.ck
    gen, dev = _gen(ctx, 28), ctx.dev
    gain = cs.FM_GAIN
    plan = ck._QUAD_DEMOD_PLAN               # its one layout, the lane the grid's y
    out = []
    for L, n in QUAD_DEMOD_SHAPES:
        args = [(torch.randn(L, dtype=torch.complex64, generator=gen, device=dev),
                 torch.randn(L, n, dtype=torch.complex64, generator=gen, device=dev))
                for _ in range(cs.REPS)]
        p0, x0 = args[0]
        y, last = ck.quad_demod_lanes(p0, x0, gain)
        per = [ck.quad_demod(p0[i], x0[i], gain) for i in range(L)]
        equal = torch.equal(y, torch.stack([p[0] for p in per])) and \
            torch.equal(last, torch.stack([p[1] for p in per]))
        err = cs.demod_err(y, ck.quad_demod_lanes_plain(p0, x0, gain)[0])
        if not equal or err > cs.TOL["quad_demod"]:
            raise RuntimeError(f"quad_demod_lanes L={L} n={n}: bit-equal to the one-stream "
                               f"launches {equal}, {err:.2e} from the plain version")
        nbytes, ops = ctx.kernel_cost("quad_demod", n=n)
        io = (8 * L * n + 8 * L, 4 * L * n + 8 * L)
        grid = (-(-n // plan.tile) * L, plan.threads)
        # PyTorch's strided copy of the real plane, the yardstick before
        strided = [(x, torch.empty(L, n, device=dev)) for _, x in args]
        extra = {"err": err, "lanes_bit_equal": True,
                 "strided_copy_us": cs.device_ms(lambda x, o: o.copy_(x.real), strided) * 1e3}
        out.append(Case(f"{L} x {n}", lambda p, x: ck.quad_demod_lanes(p, x, gain), args,
                        plan, L * nbytes, L * ops, io, grid, extra, True,
                        ("quad_demod_kernel",)))
        if L == 1:                       # the one-stream launch on the same frames
            one = [(p.reshape(()), x[0]) for p, x in args]
            err1 = cs.demod_err(ck.quad_demod(*one[0], gain)[0],
                                ck.quad_demod_plain(*one[0], gain)[0])
            out.append(Case(f"one stream n={n}", lambda p, x: ck.quad_demod(p, x, gain), one,
                            plan, nbytes, ops, io, grid, {"err": err1}, True,
                            ("quad_demod_kernel",)))
    return out


KERNELS = {
    "poly_fir": Kernel("poly_fir", ("stage", "mac"), poly_fir_cases,
                       ("poly_fir_rows<float2, false, float,",
                        "poly_fir_gemm<float, false, float,")),
    "rotator_lanes": Kernel("rotator", (), rotator_lanes_cases),
    "pfb_lanes": Kernel("pfb", ("stage", "mac", "idft", "store"), pfb_lanes_cases),
    "quad_demod_lanes": Kernel("quad_demod", ("load", "math", "store"),
                               quad_demod_lanes_cases),
}


def marker(phase: str) -> str:
    return f"FSDR_CUT_{phase.upper()}"


def missing_markers(text: str, phases) -> list:
    """The phases whose ``FSDR_CUT_<PHASE>`` no preprocessor conditional of
    ``text`` tests."""
    conds = "\n".join(re.findall(r"^\s*#\s*(?:if|ifdef|ifndef|elif)\b.*$", text, re.M))
    return [p for p in phases if not re.search(rf"\b{marker(p)}\b", conds)]


# ---------------------------------------------------------------------------
# builds, ptxas and SASS
# ---------------------------------------------------------------------------

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


def sass(so: Path) -> dict:
    """``{demangled function: [(address, opcode, operands)]}`` of a library's
    SASS (``cuobjdump -sass``)."""
    from futuresdr_tpu_torch.ops import _build
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+((?:@!?U?P\w+\s+)?[A-Z][A-Z0-9_.]*)\s*(.*?);",
                     line)
        if cur is not None and m:
            funcs[cur].append((int(m.group(1), 16), m.group(2), m.group(3).strip()))
    names = _demangle(list(funcs))
    return {names[k]: v for k, v in funcs.items()}


def sass_loops(code: dict, want) -> dict:
    """For each function whose name contains one of ``want``: the
    instruction count by opcode of each loop that holds an FFMA (the range
    from a backward branch's target to the branch) and the function's
    length."""
    out = {}
    for name, ins in code.items():
        if not any(w in name for w in want):
            continue
        loops = []
        for addr, op, args in ins:
            op = op.split()[-1]
            t = re.search(r"0x([0-9a-f]+)", args)
            if not op.startswith("BRA") or not t or int(t.group(1), 16) > addr:
                continue
            start = int(t.group(1), 16)
            mix = {}
            for a, o, _ in ins:
                if start <= a <= addr:
                    o = o.split()[-1].split(".")[0]
                    mix[o] = mix.get(o, 0) + 1
            if mix.get("FFMA"):
                loops.append({"start": start, "end": addr, "len": sum(mix.values()),
                              "mix": dict(sorted(mix.items(), key=lambda kv: -kv[1]))})
        out[name] = {"loops": loops, "function_len": len(ins)}
    return out


def same_sass(a: dict, b: dict) -> dict:
    """Function by function, whether two builds' instructions are the same
    (opcodes and operands; branch targets are addresses, so a moved
    instruction shows too)."""
    ins = {k: [(op, args) for _, op, args in v] for k, v in a.items()}
    other = {k: [(op, args) for _, op, args in v] for k, v in b.items()}
    common = sorted(set(ins) & set(other))
    return {"equal": [k for k in common if ins[k] == other[k]],
            "differ": [k for k in common if ins[k] != other[k]],
            "only_here": sorted(set(ins) - set(other)),
            "only_there": sorted(set(other) - set(ins))}


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--breakdown", action="store_true")
    ap.add_argument("--candidates", action="store_true")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--same-sass", default=None, metavar="DIR")
    opts = ap.parse_args()
    names = [k for k in opts.kernels.split(",") if k]
    unknown = [k for k in names if k not in KERNELS]
    if unknown:
        ap.error(f"unknown kernels {unknown} (the table has {list(KERNELS)})")
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
    if Path(ck.__file__).resolve().parents[2] != root:
        raise RuntimeError(f"imported {ck.__file__}, not the package under {root}")
    for name in names:
        _build.load(KERNELS[name].source)
    dev = torch.device("cuda:0")
    card = _card()
    work = root / "build" / "port_lanes"
    csrc = root / "futuresdr_tpu_torch" / "csrc"
    # the yardsticks are this checkout's (chip_smoke's EMPTY_CU), whichever
    # package --root names
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  here_dir / "chip_smoke.py")
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    yard = here.start_empty_kernel(work)()
    ctx = Ctx(torch, cs, ck, kernel_cost, dev, ck._sm_count(dev), opts.candidates)
    report = {"device": card, "root": str(root), "cases": {}}
    out = report["cases"]
    timed = []                               # (label, fn, args)
    copies = {}

    def copy_us(io):
        if io not in copies:
            copies[io] = here.copy_ms(yard, dev, *io) * 1e3
        return copies[io]

    def empty_us(blocks, threads, args):
        def fn(*_):
            ck._raise_on(yard.fsdr_empty(blocks, threads, ck._stream(args[0][-1])), "empty")
        return cs.device_ms(fn, args) * 1e3

    cases = {}
    for name in names:
        cases[name] = KERNELS[name].cases(ctx)
        for c in cases[name]:
            label = f"{name} {c.label}"
            v = {"plan": repr(c.plan), "runs_us": []}
            if c.nbytes or c.ops:
                t_bytes = c.nbytes / cs.PEAK_BYTES * 1e6
                t_ops = c.ops / cs.PEAK_FP32 * 1e6
                v.update(bound_us=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else "operations")
            if c.io:
                v["copy_us"] = copy_us(c.io)
            if c.grid:
                v["empty_us"] = empty_us(*c.grid, c.args)
                v["grid"] = list(c.grid)
            v.update(c.extra or {})
            out[label] = v
            timed.append((label, c.fn, c.args))

    if opts.same_sass:
        other = Path(opts.same_sass).resolve() / "futuresdr_tpu_torch" / "csrc"
        srcs = sorted({KERNELS[k].source for k in names})
        builds = [(d / f"{s}.cu", work / "sass" / tag / f"lib{s}.so", ())
                  for s in srcs for tag, d in (("here", csrc), ("there", other))]
        with ThreadPoolExecutor(len(builds)) as pool:       # one nvcc a build, all at once
            list(pool.map(lambda b: _nvcc(*b), builds))
        report["same_sass"] = {}
        for s in srcs:
            cmp = same_sass(sass(work / "sass" / "here" / f"lib{s}.so"),
                            sass(work / "sass" / "there" / f"lib{s}.so"))
            report["same_sass"][s] = cmp
            print(f"sass {s}.cu against {opts.same_sass}: {len(cmp['equal'])} functions "
                  f"equal, differ {cmp['differ']}, only here {cmp['only_here']}, only there "
                  f"{cmp['only_there']} [{card}]")

    if opts.breakdown:
        bd = work / "breakdown"
        srcs = {KERNELS[k].source: KERNELS[k] for k in names}
        builds = []
        for s, entry in srcs.items():
            missing = missing_markers((csrc / f"{s}.cu").read_text(), entry.phases)
            if missing:
                raise RuntimeError(f"breakdown: {csrc / s}.cu has no marker "
                                   f"{[marker(p) for p in missing]}")
            builds.append((csrc / f"{s}.cu", bd / f"lib{s}_v.so", ("-Xptxas", "-v")))
            builds += [(csrc / f"{s}.cu", bd / f"lib{s}_{p}.so", (f"-D{marker(p)}",))
                       for p in entry.phases]
        with ThreadPoolExecutor(len(builds)) as pool:       # one nvcc a build, all at once
            logs = dict(zip([b[1].name for b in builds], pool.map(lambda b: _nvcc(*b),
                                                                  builds)))
        regs = {}
        for s in srcs:
            regs.update(ptxas_report(logs[f"lib{s}_v.so"]))
        for k, r in regs.items():
            print(f"ptxas {k}: {r}, blocks an SM at 256 threads "
                  f"{blocks_per_sm(r['registers'], 256, r['smem'])} [{card}]")
        libs = {}
        for s, entry in srcs.items():
            whole = sass(bd / f"lib{s}_v.so")
            for p in entry.phases:
                cmp = same_sass(whole, sass(bd / f"lib{s}_{p}.so"))
                if not (cmp["differ"] or cmp["only_here"] or cmp["only_there"]):
                    raise RuntimeError(f"breakdown: {s}.cu built with -D{marker(p)} has the "
                                       f"whole build's SASS: the marker cuts nothing")
                libs[s, p] = ctypes.CDLL(str(bd / f"lib{s}_{p}.so"))
            if entry.sass_loops:
                for k, v in sass_loops(whole, entry.sass_loops).items():
                    print(f"sass {k}: {v['function_len']} instructions")
                    for lp in v["loops"]:
                        print(f"sass   loop {lp['start']:#x}-{lp['end']:#x}: {lp['len']} "
                              f"instructions {lp['mix']}")
        for name in names:
            entry = KERNELS[name]
            for c in cases[name]:
                if not c.cut or not entry.phases:
                    continue
                label = f"{name} {c.label}"
                kern = next((k for k in sorted(regs, key=lambda k: "false>" in k)
                             if all(w in k for w in c.kernel)), None) if c.kernel else None
                if kern is not None:
                    r = regs[kern]
                    threads = getattr(c.plan, "threads", 256)
                    out[label]["ptxas"] = {**r, "kernel": kern.split("(")[0],
                                           "blocks_per_sm": blocks_per_sm(
                                               r["registers"], threads,
                                               getattr(c.plan, "smem", 0) + r["smem"])}
                whole = _build._libs[entry.source]
                for p in entry.phases:
                    def cut(*a, lib=libs[entry.source, p], fn=c.fn, s=entry.source,
                            whole=whole):
                        _build._libs[s] = lib
                        try:
                            return fn(*a)
                        finally:
                            _build._libs[s] = whole
                    timed.append((f"{label} [{p} alone]", cut, c.args))
                    out[f"{label} [{p} alone]"] = {"runs_us": []}
    for r in range(opts.rounds):
        for label, fn, args in timed if r % 2 == 0 else timed[::-1]:
            out[label]["runs_us"].append(cs.device_ms(fn, args) * 1e3)
    for label, v in out.items():
        v["us"] = statistics.median(v["runs_us"])
        runs = " ".join(f"{t:.3f}" for t in v["runs_us"])
        extra = f", bound {v['bound_us']:.3f} us ({v['bound_by']})" if "bound_us" in v else ""
        extra += "".join(f", {k[:-3].replace('_', ' ')} {v[k]:.3f} us"
                         for k in ("copy_us", "strided_copy_us", "empty_us") if k in v)
        extra += f", grid {v['grid']}" if "grid" in v else ""
        extra += f", plan {v['plan']}" if "bound_us" in v else ""
        extra += f", ptxas {v['ptxas']}" if "ptxas" in v else ""
        print(f"{label}: {v['us']:.3f} us (median of {opts.rounds}: {runs}){extra} [{card}]")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
