"""Spectrum analyzer on the port's compute plane.

The counterpart of ``futuresdr_tpu/apps/spectrum.py``: a 2048-point FFT,
|x|², an exponential moving average across spectra and 10·log10, run as one
:class:`~futuresdr_tpu_torch.tpu.TpuKernel` on the card over frames of
``max(16·fft_size, 2^15)`` samples.

Not ported yet (ROADMAP Queue 1 item 4, the apps' host surfaces): the Seify
dummy radio behind ``source=None``, the CPU block path behind
``use_tpu=False`` (``Fft``, ``Apply``, ``MovingAvg``), the websocket sink
behind ``ws_port`` and ``main()``, which needs all three.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..blocks import Head, NullSink, VectorSink
from ..runtime import Flowgraph
from ..tpu import TpuInstance, TpuKernel

__all__ = ["FFT_SIZE", "spectrum_stages", "build_flowgraph"]

FFT_SIZE = 2048

_ITEM = "ROADMAP Queue 1 item 4 (the apps' host surfaces)"


def spectrum_stages(fft_size: int = FFT_SIZE):
    """The app's device chain: FFT, |x|², EMA (decay 0.1), 10·log10."""
    from ..ops import fft_stage, log10_stage, mag2_stage, moving_avg_stage
    return [fft_stage(fft_size), mag2_stage(),
            moving_avg_stage(fft_size, decay=0.1), log10_stage()]


def build_flowgraph(source=None, *, use_tpu: bool = True, fft_size: int = FFT_SIZE,
                    ws_port: Optional[int] = None, n_samples: Optional[int] = None,
                    collect: bool = False, inst: Optional[TpuInstance] = None):
    """``source → [Head] → TpuKernel(spectrum chain) → VectorSink (collect) or
    NullSink``; returns ``(flowgraph, sink)``. ``inst`` is the device
    (``None``: ``cuda:0``)."""
    if source is None:
        raise NotImplementedError(f"spectrum with the Seify dummy source: {_ITEM}")
    if not use_tpu:
        raise NotImplementedError(f"spectrum on the CPU block path: {_ITEM}")
    if ws_port:
        raise NotImplementedError(f"spectrum to a websocket sink: {_ITEM}")
    fg = Flowgraph()
    last = source
    if n_samples:
        head = Head(np.complex64, n_samples)
        fg.connect(last, head)
        last = head
    chain = TpuKernel(spectrum_stages(fft_size), np.complex64,
                      frame_size=max(16 * fft_size, 1 << 15), inst=inst)
    sink = VectorSink(np.float32) if collect else NullSink(np.float32)
    fg.connect(last, chain, sink)
    return fg, sink
