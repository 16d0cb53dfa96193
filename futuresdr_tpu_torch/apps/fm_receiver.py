"""Broadcast FM receiver front end on the port's compute plane.

The counterpart of ``futuresdr_tpu/apps/fm_receiver.py``: tuner and channel
filter (one xlating FIR), FM discriminator and the 24/125 audio resampler,
run as one :class:`~futuresdr_tpu_torch.tpu.TpuKernel` on the card. A retune
goes through ``TpuKernel.apply_retune("tuner", phase_inc=θ)``.

Not ported yet (ROADMAP Queue 1 item 4): the Seify dummy radio behind
``source=None``, the CPU block path behind ``use_tpu=False`` (``XlatingFir``,
``QuadratureDemod``, the rational ``Fir``), and ``main()`` with its
ctrl-port retune, which waits for the message ports.
"""

from __future__ import annotations

from math import gcd
from typing import Optional

import numpy as np

from ..blocks import Head, NullSink, WavSink
from ..dsp import firdes
from ..runtime import Flowgraph
from ..tpu import TpuInstance, TpuKernel

__all__ = ["SAMPLE_RATE", "AUDIO_RATE", "front_end_stages", "build_flowgraph"]

SAMPLE_RATE = 250_000       # after front-end decimation
AUDIO_RATE = 48_000

_ITEM = "ROADMAP Queue 1 item 4 (FM receiver: Seify source, CPU block path)"


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


def build_flowgraph(source=None, *, input_rate: float = 1_000_000.0,
                    offset: float = 0.0, audio_path: Optional[str] = None,
                    n_samples: Optional[int] = None, use_tpu: bool = False,
                    inst: Optional[TpuInstance] = None):
    """``source → [Head] → TpuKernel(front end) → WavSink or NullSink``;
    returns ``(flowgraph, retune block, sink)``. ``inst`` is the device
    (``None``: ``cuda:0``)."""
    if source is None:
        raise NotImplementedError(f"fm_receiver with the Seify dummy source: {_ITEM}")
    if not use_tpu:
        raise NotImplementedError(f"fm_receiver on the CPU block path: {_ITEM}")
    fg = Flowgraph()
    last = source
    if n_samples:
        head = Head(np.complex64, n_samples)
        fg.connect(last, head)
        last = head
    chain = TpuKernel(front_end_stages(input_rate, offset), np.complex64, inst=inst)
    fg.connect(last, chain)
    sink = WavSink(audio_path, AUDIO_RATE) if audio_path else NullSink(np.float32)
    fg.connect(chain, sink)
    return fg, chain, sink
