"""Time the Viterbi decoder kernel against other sources of it, on the card.

    python3 port_viterbi.py [--other PATH.cu ...] [--rounds N]

Builds ``futuresdr_tpu_torch/csrc/viterbi.cu`` and each ``--other`` source
with the same C interface (``fsdr_viterbi``; a parent's, from a ``git
archive`` under ``build/``, or a variant of the design) with the port's
``nvcc`` flags into ``build/viterbi_ab/``, checks that every build gives
today's survivors and decoded bits on the same inputs, and times each on
802.11's 64-state and M17's 16-state trellis at 256 frames × 4,096 steps:
the recursion alone (no bits pointer) and with the traceback. Times are
device time a launch (CUDA events around 20 launches over 4 distinct
inputs, behind a device sleep), taken in turns: today, the others, the
others, today, for ``--rounds`` rounds. Prints the card's name and power
limit first. Needs a card; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from futuresdr_tpu_torch.models.m17 import codec  # noqa: E402
from futuresdr_tpu_torch.models.wlan import coding  # noqa: E402
from futuresdr_tpu_torch.ops import _build  # noqa: E402

BATCH, STEPS = 256, 4096
LAUNCHES = 20
INPUTS = 4
TRELLISES = {"802.11, 64 states": (coding._PREV_S, coding._PREV_B, coding._BM0, coding._BM1),
             "M17, 16 states": codec._M17_PREV}


def build(sources):
    """One library a source, all ``nvcc`` runs started together."""
    out_dir = REPO / "build" / "viterbi_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = [(src, out_dir / f"lib{i}.so",
              subprocess.Popen([_build._nvcc(), *_build.FLAGS, "-o", str(out_dir / f"lib{i}.so"),
                                str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                               text=True))
             for i, src in enumerate(sources)]
    libs = []
    for src, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {src}:\n{log}")
        lib = ctypes.CDLL(str(so))
        vp = ctypes.c_void_p
        lib.fsdr_viterbi.argtypes = [vp] * 8 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                                vp]
        lib.fsdr_viterbi.restype = ctypes.c_int
        libs.append(lib)
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="another viterbi.cu with the same C interface (repeatable)")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("port_viterbi.py needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    sources = [REPO / "futuresdr_tpu_torch" / "csrc" / "viterbi.cu"] + \
        [Path(p).resolve() for p in args.other]
    libs = build(sources)
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    for name, tables in TRELLISES.items():
        ps, pb, b0, b1 = (torch.from_numpy(np.ascontiguousarray(t, d)).to(dev)
                          for t, d in zip(tables, (np.int32, np.int32, np.float32, np.float32)))
        S = int(ps.shape[0])
        xs = [torch.from_numpy((rng.standard_normal((BATCH, STEPS, 2)) * 2)
                               .astype(np.float32)).to(dev) for _ in range(INPUTS)]
        steps = torch.full((BATCH,), STEPS, dtype=torch.int32, device=dev)
        surv = torch.zeros((BATCH, STEPS, 2 if S > 32 else 1), dtype=torch.int32, device=dev)
        bits = torch.zeros((BATCH, STEPS), dtype=torch.uint8, device=dev)

        def run(lib, x, with_bits):
            err = lib.fsdr_viterbi(x.data_ptr(), steps.data_ptr(), ps.data_ptr(),
                                   pb.data_ptr(), b0.data_ptr(), b1.data_ptr(),
                                   surv.data_ptr(), bits.data_ptr() if with_bits else None,
                                   BATCH, STEPS, S, stream)
            if err != 0:
                sys.exit(f"launch failed: cudaError {err}")

        want = None
        for src, lib in zip(sources, libs):
            run(lib, xs[0], True)
            torch.cuda.synchronize()
            got = (surv.clone(), bits.clone())
            if want is None:
                want = got
            elif not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                sys.exit(f"{src}: survivors or bits differ from today's kernel ({name})")

        def device_us(lib, with_bits):
            for x in xs:
                run(lib, x, with_bits)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(1_000_000)
            a.record()
            for k in range(LAUNCHES):
                run(lib, xs[k % INPUTS], with_bits)
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / LAUNCHES * 1e3

        order = list(range(len(libs)))
        turns = order + order[1:][::-1] + [0] if len(libs) > 1 else order
        times = {i: [] for i in order}
        for _ in range(args.rounds):
            for i in turns:
                times[i].append((device_us(libs[i], False), device_us(libs[i], True)))
        for i in order:
            label = "today" if i == 0 else str(sources[i])
            rec = ", ".join(f"{a:.1f}" for a, _ in times[i])
            full = ", ".join(f"{b:.1f}" for _, b in times[i])
            print(f"viterbi {name} {BATCH} x {STEPS}, {label}: recursion alone {rec} us; "
                  f"with the traceback {full} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
