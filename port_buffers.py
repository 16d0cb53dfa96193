#!/usr/bin/env python3
"""The port's two stream buffers side by side on one CUDA card's host.

Times the double-mapped circular buffer (``runtime/buffer/circular.py``, the
default) against the pure-Python ring (``runtime/buffer/ring.py``) in turns,
ring first in even pairs and circular first in odd ones:

- ``first``: a fresh 2^23-item float32 buffer (the capacity of a K = 4
  2^18 chain's output edge) created and written through twice, ms each:
  what a new region costs before and after its pages are in;
- ``copy``: one 2^18-item complex64 frame copied out of each buffer's
  storage (a 2^19-item buffer, the capacity a 2^18 frame's edge gets) into a
  pinned host buffer, 200 copies a run: the memory the storage sits in,
  with no runtime around it;
- ``host``: ``NullSource -> Head(2^26) -> Apply(copy) -> NullSink`` on the
  CPU, every edge on one buffer: the runtime's own data plane;
- ``streamed``, ``streamed4``: ``NullSource -> Head(64 frames) ->
  TpuKernel(fir_fft, |x|^2) -> NullSink`` at 2^18, K = 1 and K = 4, 4
  frames in flight, on ``cuda:0``: the streamed main path of
  ``chip_smoke.py`` phase 21.

Prints each run, then for each test and buffer the median and quartiles,
with the card's name and power limit and the kernel's transparent huge
page settings (``/sys/kernel/mm/transparent_hugepage``), then one JSON line.

    python3 port_buffers.py [--pairs N] [--tests first,copy,host,streamed,streamed4]
                            [--root DIR]

``--root`` imports ``futuresdr_tpu_torch`` from DIR, another checkout (say
the parent commit, unpacked with ``git archive``), so that two versions are
compared on one card: run parent, change, change, parent.

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

FRAME = 1 << 18
STREAM_FRAMES = 64
HOST_ITEMS = 1 << 26
COPIES = 200


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def _thp() -> str:
    base = Path("/sys/kernel/mm/transparent_hugepage")
    return ", ".join(f"{name}: {(base / name).read_text().strip()}"
                     for name in ("enabled", "shmem_enabled") if (base / name).exists())


def first_ms(cls, device) -> tuple:
    """ms to create a 2^23-item float32 buffer, to write it the first time
    and to write it again."""
    import numpy as np

    from futuresdr_tpu_torch.runtime.inbox import BlockInbox
    t0 = time.perf_counter()
    w = cls(np.float32, 1 << 23, BlockInbox())
    t1 = time.perf_counter()
    data = w._data[:1 << 23]
    data[:] = 1.0
    t2 = time.perf_counter()
    data[:] = 2.0
    t3 = time.perf_counter()
    return (t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3


def copy_gbps(cls, device) -> float:
    """GB/s of 2^18-item frame copies out of ``cls``'s storage into pinned
    memory."""
    import numpy as np
    import torch

    from futuresdr_tpu_torch.runtime.inbox import BlockInbox
    w = cls(np.complex64, 2 * FRAME, BlockInbox())
    w.add_reader(BlockInbox(), 0)
    w.slice()[:FRAME] = 1
    w.produce(FRAME)
    src = w._data[:FRAME]
    dst = torch.empty(FRAME, dtype=torch.complex64, pin_memory=device.type == "cuda").numpy()
    np.copyto(dst, src)
    t0 = time.perf_counter()
    for _ in range(COPIES):
        np.copyto(dst, src)
    return COPIES * src.nbytes / (time.perf_counter() - t0) / 1e9


def _connect(fg, blocks, cls):
    for a, b in zip(blocks, blocks[1:]):
        fg.connect_stream(a, a.stream_outputs[0].name, b, b.stream_inputs[0].name,
                          buffer=cls)


def host_msps(cls, device) -> float:
    import numpy as np

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import Apply, Head, NullSink, NullSource
    fg = Flowgraph()
    snk = NullSink(np.complex64)
    _connect(fg, [NullSource(np.complex64), Head(np.complex64, HOST_ITEMS),
                  Apply(lambda x: x, np.complex64), snk], cls)
    rt = Runtime()
    t0 = time.perf_counter()
    rt.run(fg)
    dt = time.perf_counter() - t0
    rt.shutdown()
    if snk.n_received != HOST_ITEMS:
        raise RuntimeError(f"host: {snk.n_received} items, want {HOST_ITEMS}")
    return HOST_ITEMS / dt / 1e6


def streamed_msps(cls, device, k: int = 1) -> float:
    import numpy as np

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import Head, NullSink, NullSource
    from futuresdr_tpu_torch.dsp import firdes
    from futuresdr_tpu_torch.ops.stages import fir_fft_stage, mag2_stage
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
    taps = firdes.lowpass(0.2, 64).astype(np.float32)
    kern = TpuKernel([fir_fft_stage(taps, 2048), mag2_stage()], np.complex64,
                     frame_size=FRAME, inst=TpuInstance(device), frames_in_flight=4,
                     frames_per_dispatch=k)
    n = STREAM_FRAMES * FRAME
    fg = Flowgraph()
    snk = NullSink(np.float32)
    _connect(fg, [NullSource(np.complex64), Head(np.complex64, n), kern, snk], cls)
    rt = Runtime()
    t0 = time.perf_counter()
    rt.run(fg)
    dt = time.perf_counter() - t0
    rt.shutdown()
    if snk.n_received != n:
        raise RuntimeError(f"streamed: {snk.n_received} items, want {n}")
    return n / dt / 1e6


TESTS = {"first": (first_ms, "ms (create, first write, second write)"),
         "copy": (copy_gbps, "GB/s"), "host": (host_msps, "Msamples/s"),
         "streamed": (streamed_msps, "input Msamples/s"),
         "streamed4": (lambda cls, device: streamed_msps(cls, device, 4),
                       "input Msamples/s")}


def _fmt(v) -> str:
    return " / ".join(f"{x:.1f}" for x in v) if isinstance(v, tuple) else f"{v:.1f}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--tests", default="first,copy,host,streamed,streamed4")
    p.add_argument("--root", default=None, help="import the package from DIR")
    p.add_argument("--device", default="cuda:0", help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    if a.root:
        sys.path.insert(0, str(Path(a.root).resolve()))
    import torch
    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("port_buffers: no CUDA card", file=sys.stderr)
        return 2
    from futuresdr_tpu_torch.runtime.buffer import circular
    from futuresdr_tpu_torch.runtime.buffer.ring import RingWriter
    if not circular.available():
        print("port_buffers: the circular buffer's library did not build", file=sys.stderr)
        return 1
    buffers = {"ring": RingWriter, "circular": circular.CircularWriter}
    card = _card() if device.type == "cuda" else f"{device} (no card)"
    print(f"{card}; transparent huge pages: {_thp()}")
    out = {}
    for test in a.tests.split(","):
        fn, unit = TESTS[test]
        fn(buffers["circular"], device)           # warm-up: builds, plans, pools
        runs = {name: [] for name in buffers}
        for i in range(a.pairs):
            order = ("ring", "circular") if i % 2 == 0 else ("circular", "ring")
            for name in order:
                runs[name].append(fn(buffers[name], device))
            print(f"{test} pair {i}: " + ", ".join(
                f"{name} {_fmt(runs[name][-1])}" for name in order) + f" {unit}")
        for name, vals in runs.items():
            cols = list(zip(*vals)) if isinstance(vals[0], tuple) else [vals]
            stats = []
            for col in cols:
                q = statistics.quantiles(col, n=4) if len(col) > 1 else [col[0]] * 3
                stats.append({"median": statistics.median(col), "q1": q[0], "q3": q[2]})
            print(f"{test} {name}: median " + " / ".join(f"{st['median']:.1f}" for st in stats)
                  + f" {unit}, quartiles " + " / ".join(
                      f"{st['q1']:.1f}-{st['q3']:.1f}" for st in stats)
                  + f", {len(vals)} runs [{card}]")
            out[f"{test}/{name}"] = {"stats": stats, "runs": vals, "unit": unit}
    print(json.dumps({"card": card, "thp": _thp(), "results": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
