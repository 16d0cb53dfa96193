"""Spectrum analyzer: the port's counterpart of ``futuresdr_tpu/apps/spectrum.py``.

Reference: ``examples/spectrum`` (seify source → Fft(2048) → |x|² →
MovingAvg → WebsocketSink). The compute chain runs either on CPU blocks
(``Fft``, ``Apply``, ``MovingAvg``, ``Apply``) or as one
:class:`~futuresdr_tpu_torch.tpu.TpuKernel` on the card (FFT, |x|², EMA with
decay 0.1, 10·log10 over frames of ``max(16·fft_size, 2^15)`` samples),
feeding a websocket for a GUI, a vector sink or a null sink. The default
source is the Seify dummy radio (a tone at 0.1·fs in noise).

Run: ``python -m futuresdr_tpu_torch.apps.spectrum --ws-port 9001`` (the
card), ``--cpu`` for the CPU blocks. ``--bf16`` lowers the device chain's
interior precision to bf16 (``ops/precision.py``: the FFT's rung is a
float32 transform on the card, its output edge is rounded through bf16; the
CPU blocks are not lowered); ``--autotune`` sweeps frame size and in-flight
depth on the card first (``tpu/autotune.autotune``) and runs at the pick.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np

from ..blocks import (Apply, Fft, Head, MovingAvg, NullSink, SeifyBuilder, VectorSink,
                      WebsocketSink)
from ..runtime import Flowgraph, Runtime
from ..tpu import TpuInstance, TpuKernel

__all__ = ["FFT_SIZE", "spectrum_stages", "build_flowgraph", "main"]

FFT_SIZE = 2048


def spectrum_stages(fft_size: int = FFT_SIZE):
    """The app's device chain: FFT, |x|², EMA (decay 0.1), 10·log10."""
    from ..ops import fft_stage, log10_stage, mag2_stage, moving_avg_stage
    return [fft_stage(fft_size), mag2_stage(),
            moving_avg_stage(fft_size, decay=0.1), log10_stage()]


def build_flowgraph(source=None, *, use_tpu: bool = True, fft_size: int = FFT_SIZE,
                    ws_port: Optional[int] = None, n_samples: Optional[int] = None,
                    collect: bool = False, inst: Optional[TpuInstance] = None,
                    interior_precision: Optional[str] = None):
    """``source → [Head] → chain → sink``; returns ``(flowgraph, sink)``: the
    ``WebsocketSink`` with ``ws_port`` (its ``bound_port`` is set once the
    flowgraph runs; 0 takes a free port), else a ``VectorSink``
    (``collect``) or a ``NullSink``. ``source=None`` is the Seify dummy
    radio; ``inst`` is the device of ``use_tpu`` (``None``: ``cuda:0``);
    ``interior_precision`` the device chain's (``None``: config)."""
    fg = Flowgraph()
    if source is None:
        source = SeifyBuilder().args("driver=dummy,throttle=false").build_source()
    last = source
    if n_samples:
        head = Head(np.complex64, n_samples)
        fg.connect(last, head)
        last = head
    if use_tpu:
        chain = TpuKernel(spectrum_stages(fft_size), np.complex64,
                          frame_size=max(16 * fft_size, 1 << 15), inst=inst,
                          interior_precision=interior_precision)
        fg.connect(last, chain)
        last = chain
    else:
        fft = Fft(fft_size)
        mag = Apply(lambda x: (x.real ** 2 + x.imag ** 2), np.complex64, np.float32)
        avg = MovingAvg(fft_size, width=3, decay=0.1)
        log = Apply(lambda x: 10.0 * np.log10(np.maximum(x, 1e-20)), np.float32)
        fg.connect(last, fft, mag, avg, log)
        last = log
    if ws_port is not None:
        sink = WebsocketSink(ws_port, np.float32, chunk_items=fft_size)
    elif collect:
        sink = VectorSink(np.float32)
    else:
        sink = NullSink(np.float32)
    fg.connect(last, sink)
    return fg, sink


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description="Spectrum analyzer (PyTorch/CUDA port)")
    p.add_argument("--args", default="driver=dummy,throttle=false")
    p.add_argument("--fft", type=int, default=FFT_SIZE)
    p.add_argument("--cpu", action="store_true", help="use CPU blocks instead of the card")
    p.add_argument("--ws-port", type=int, default=9001)
    p.add_argument("--samples", type=int, default=None)
    p.add_argument("--autotune", action="store_true",
                   help="sweep device frame sizes and in-flight depths before starting")
    p.add_argument("--bf16", action="store_true",
                   help="display-grade bf16 interior precision of the device chain "
                        "(fine for a waterfall, not for decoding)")
    a = p.parse_args(argv)
    inst = None
    if a.bf16 and a.cpu:
        print("note: --bf16 lowers only the device chain; this run uses the CPU "
              "blocks at full precision", file=sys.stderr)
    if a.autotune and not a.cpu:
        from ..tpu import autotune, instance
        inst = instance()
        frame, depth, grid = autotune(spectrum_stages(a.fft), np.complex64, inst=inst)
        inst.frame_size, inst.frames_in_flight = frame, depth
        print(f"autotuned: frame={frame} depth={depth} ({grid})")
    src = SeifyBuilder().args(a.args).build_source()
    fg, _ = build_flowgraph(src, use_tpu=not a.cpu, fft_size=a.fft,
                            ws_port=a.ws_port, n_samples=a.samples, inst=inst,
                            interior_precision="bf16" if a.bf16 else None)
    Runtime().run(fg)


if __name__ == "__main__":
    main()
