"""Broadcast FM receiver with interactive retuning: the port's counterpart of
``futuresdr_tpu/apps/fm_receiver.py``.

Reference: ``examples/fm-receiver/src/main.rs:83-155``: seify → freq-shift →
resampling FIR → quadrature demod → audio resampler, retuned at runtime. The
front end runs either on CPU blocks (``XlatingFir``, ``QuadratureDemod``,
the rational ``Fir``) or as one :class:`~futuresdr_tpu_torch.tpu.TpuKernel`
on the card (xlating FIR, discriminator, 24/125 resampler). The default
source is the Seify dummy radio. A retune goes to the ``XlatingFir``'s
``freq`` handler, or to the ``TpuKernel``'s ``ctrl`` port as
``{"stage": "tuner", "phase_inc": θ}``.

Run: ``python -m futuresdr_tpu_torch.apps.fm_receiver --wav out.wav`` (the
card), ``--cpu`` for the CPU blocks, and type a frequency offset in Hz (or
``q``).
"""

from __future__ import annotations

import sys
from math import gcd
from typing import Optional

import numpy as np

from ..blocks import (Fir, Head, NullSink, QuadratureDemod, SeifyBuilder, WavSink,
                      XlatingFir)
from ..dsp import firdes
from ..runtime import Flowgraph, Runtime
from ..tpu import TpuInstance, TpuKernel
from ..types import Pmt

__all__ = ["SAMPLE_RATE", "AUDIO_RATE", "front_end_stages", "build_flowgraph",
           "tuner_retune", "main"]

SAMPLE_RATE = 250_000       # after front-end decimation
AUDIO_RATE = 48_000


def front_end_stages(input_rate: float = 1_000_000.0, offset: float = 0.0):
    """The FM front end as a stage list: xlating FIR (tuner + channel filter,
    decimating to 250 ksps), FM discriminator, polyphase audio resampler to
    48 ksps."""
    from ..ops import quad_demod_stage, resample_stage, xlating_fir_stage
    decim = int(input_rate // SAMPLE_RATE)
    g = gcd(AUDIO_RATE, SAMPLE_RATE)
    return [
        xlating_fir_stage(firdes.lowpass(0.5 / decim * 0.8, 128),
                          -2 * np.pi * offset / input_rate, decim, name="tuner"),
        quad_demod_stage(SAMPLE_RATE / (2 * np.pi * 75e3)),
        resample_stage(AUDIO_RATE // g, SAMPLE_RATE // g),
    ]


def tuner_retune(offset: float, input_rate: float = 1_000_000.0) -> Pmt:
    """The ``ctrl`` message that moves the device chain's tuner to ``offset`` Hz."""
    return Pmt.map({"stage": "tuner", "phase_inc": -2 * np.pi * offset / input_rate})


def build_flowgraph(source=None, *, input_rate: float = 1_000_000.0,
                    offset: float = 0.0, audio_path: Optional[str] = None,
                    n_samples: Optional[int] = None, use_tpu: bool = True,
                    inst: Optional[TpuInstance] = None):
    """``source → [Head] → front end → WavSink or NullSink``; returns
    ``(flowgraph, retune block, sink)``. ``source=None`` is the Seify dummy
    radio; ``inst`` is the device of ``use_tpu`` (``None``: ``cuda:0``);
    ``use_tpu=False`` takes the CPU blocks."""
    fg = Flowgraph()
    if source is None:
        source = (SeifyBuilder().args("driver=dummy,throttle=false")
                  .sample_rate(input_rate).build_source())
    last = source
    if n_samples:
        head = Head(np.complex64, n_samples)
        fg.connect(last, head)
        last = head
    if use_tpu:
        chain = TpuKernel(front_end_stages(input_rate, offset), np.complex64, inst=inst)
        fg.connect(last, chain)
        retune = out_block = chain
    else:
        decim = int(input_rate // SAMPLE_RATE)
        g = gcd(AUDIO_RATE, SAMPLE_RATE)
        xlate = XlatingFir(firdes.lowpass(0.5 / decim * 0.8, 128), decim, offset,
                           input_rate)
        demod = QuadratureDemod(gain=SAMPLE_RATE / (2 * np.pi * 75e3))
        audio_resamp = Fir(firdes.kaiser_lowpass(0.4 * g / SAMPLE_RATE,
                                                 0.1 * g / SAMPLE_RATE)
                           * (AUDIO_RATE // g),
                           np.float32, decim=SAMPLE_RATE // g, interp=AUDIO_RATE // g)
        fg.connect(last, xlate, demod, audio_resamp)
        retune, out_block = xlate, audio_resamp
    sink = WavSink(audio_path, AUDIO_RATE) if audio_path else NullSink(np.float32)
    fg.connect(out_block, sink)
    return fg, retune, sink


def main(argv=None, stdin=None):
    """The receiver: starts the flowgraph, then reads frequency offsets in Hz
    from ``stdin`` (one a line) and retunes to each; ``q`` or end of input
    stops it."""
    import argparse
    p = argparse.ArgumentParser(description="FM receiver (PyTorch/CUDA port)")
    p.add_argument("--args", default="driver=dummy,throttle=false")
    p.add_argument("--freq", type=float, default=100.0e6)
    p.add_argument("--rate", type=float, default=1e6)
    p.add_argument("--wav", default=None, help="write audio to WAV")
    p.add_argument("--cpu", action="store_true", help="use CPU blocks instead of the card")
    a = p.parse_args(argv)
    stdin = stdin or sys.stdin
    src = (SeifyBuilder().args(a.args).frequency(a.freq).sample_rate(a.rate)
           .build_source())
    fg, retune, _ = build_flowgraph(src, input_rate=a.rate, audio_path=a.wav,
                                    use_tpu=not a.cpu)
    running = Runtime().start(fg)
    print("FM receiver running; type a frequency offset in Hz (or 'q'):", flush=True)
    try:
        for line in stdin:
            line = line.strip()
            if line in ("q", "quit", "exit"):
                break
            try:
                off = float(line)
            except ValueError:
                print("not a number", flush=True)
                continue
            if a.cpu:
                running.handle.post_sync(retune, "freq", off)
            else:
                running.handle.post_sync(retune, "ctrl", tuner_retune(off, a.rate))
    except KeyboardInterrupt:
        pass
    running.stop_sync()


if __name__ == "__main__":
    main()
