#!/usr/bin/env python3
"""Device time of the ``fir`` and ``pfb`` kernels under the layouts their plans
can take, at the main paths' shapes, on one CUDA card.

``cuda_kernels.fir_plan`` and ``pfb_plan`` pick one layout per call; this
times the same call under the others the kernels take, so that PERF.md can
say what each step of a design buys: for ``fir`` (complex64, 64 taps, 2^18
and 2^20) warps a block, tiles a warp with one or two span buffers, and the
unpadded fallback; for ``pfb`` (PFB-64 at 2^18 and 2^21, PFB-2048 at 2^18,
K = 12) the rows a thread (R), the taps in shared memory instead of
registers, the unpadded layout with the twiddles read from device memory,
and the "v" layout (the first design's unstaged mode). Each time is the
median device time of one call in a CUDA graph over 20 distinct inputs
(``chip_smoke.device_ms``), with the error against the plain version.

    python3 port_plans.py

Prints one line per layout with the card's name and power limit, then one
JSON line. Exits nonzero without CUDA.
"""

from __future__ import annotations

import json
import sys


def main() -> int:
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

    def report(label, fn, plain, args):
        err, rel = cs.rel_err(fn(*args[0]), plain(*args[0]))
        ms = cs.device_ms(fn, args)
        out[label] = {"ms": ms, "rel_err": rel}
        print(f"layout {label}: {ms * 1e3:.2f} us, {rel:.2e} of peak against the plain "
              f"version [{card}]", flush=True)

    nt = cs.N_TAPS
    taps = torch.randn(nt, generator=gen, device=dev)
    for n in cs.FRAMES:
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

    for n_ch, n in ((cs.PFB_N, cs.PFB_FRAMES[0]), (cs.PFB_N, cs.PFB_FRAMES[1]),
                    (cs.PFB_WIDE_N, cs.PFB_FRAMES[0])):
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
    print(json.dumps({"device": card, "layouts": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
