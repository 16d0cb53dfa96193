"""Multi-channel LoRa RX: one wideband stream → per-channel receivers.

Re-design of the reference's ``rx_all_channels_eu.rs`` (PFB channelizer over the 8
EU868 125 kHz channels at 200 kHz spacing) and ``rx_meshtastic_all_channels.rs``:
a wideband source fans out through frequency-translating decimating FIRs (one per
channel — the `XlatingFir` front half of every receiver) into per-channel
``LoraReceiver`` blocks whose ``rx`` messages are tagged with the channel frequency.

The port's copy of ``futuresdr_tpu/models/lora/multichannel.py``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ...dsp import firdes
from ...runtime.flowgraph import Flowgraph
from ...runtime.kernel import Kernel, message_handler
from ...types import Pmt
from .blocks import LoraReceiver
from .phy import LoraParams

__all__ = ["EU868_CHANNELS_HZ", "ChannelTag", "build_multichannel_rx"]

# the 8 EU868 g1/g2 125 kHz LoRaWAN uplink channels (`rx_all_channels_eu.rs:49`)
EU868_CHANNELS_HZ: List[float] = [867.1e6, 867.3e6, 867.5e6, 867.7e6, 867.9e6,
                                  868.1e6, 868.3e6, 868.5e6]


class ChannelTag(Kernel):
    """Annotate ``rx`` messages with their channel frequency (map pass-through)."""

    def __init__(self, freq_hz: float):
        super().__init__()
        self.freq_hz = float(freq_hz)
        self.add_message_output("out")

    @message_handler(name="in")
    async def in_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        if p.is_finished():
            io.finished = True
            return Pmt.ok()
        try:
            d = p.to_map()
        except Exception:
            d = {"payload": p}
        d["freq"] = Pmt.f64(self.freq_hz)
        mio.post("out", Pmt.map(d))
        return Pmt.ok()


def build_multichannel_rx(source, sample_rate: float, center_hz: float,
                          params: LoraParams,
                          channels_hz: Optional[Sequence[float]] = None,
                          bandwidth_hz: float = 125e3,
                          fg: Optional[Flowgraph] = None,
                          use_channelizer: bool = False,
                          spacing_hz: Optional[float] = None):
    """Wire ``source`` (complex64 at ``sample_rate`` centered on ``center_hz``)
    into one LoRa RX per channel. Returns ``(fg, receivers, tags)``; connect each
    tag's ``out`` message port to your sink/forwarder.

    Two front-end shapes:

    - default: one frequency-translating decimating FIR per channel (the
      `XlatingFir` front half of every receiver); ``sample_rate`` must be an
      integer multiple of ``bandwidth_hz``.
    - ``use_channelizer=True``: ONE critically-sampled PFB channelizer splits
      the band, then a small arbitrary-rate resampler per channel brings the
      channel spacing down to the chip rate — the reference's actual
      `rx_all_channels_eu.rs:109-144` chain (channelizer → PfbArbResampler →
      receiver). Channels must sit on the ``sample_rate/N`` grid.
    """
    channels_hz = list(channels_hz if channels_hz is not None else EU868_CHANNELS_HZ)
    fg = fg or Flowgraph()
    receivers, tags = [], []

    if use_channelizer:
        from ...blocks import PfbArbResampler, PfbChannelizer
        if spacing_hz is None:
            # adjacent-channel default (the EU868 layout); pass spacing_hz
            # explicitly when the used channels skip grid slots
            assert len(channels_hz) >= 2, \
                "spacing cannot be inferred from one channel: pass spacing_hz"
            spacings = {round(b - a) for a, b in zip(sorted(channels_hz),
                                                     sorted(channels_hz)[1:])}
            assert len(spacings) == 1, "channels not uniformly spaced: " \
                                       "pass spacing_hz explicitly"
            spacing_hz = float(spacings.pop())
        spacing = float(spacing_hz)
        n_chan = int(round(sample_rate / spacing))
        assert abs(n_chan * spacing - sample_rate) < 1e-6, \
            "sample_rate must be an integer multiple of the channel spacing"
        from ...blocks import NullSink
        chan = PfbChannelizer(n_chan)
        fg.connect(source, chan)
        rate = bandwidth_hz / spacing              # e.g. 125/200 kHz = 0.625
        used = set()
        for f in channels_hz:
            slot = (f - center_hz) / spacing
            k = int(round(slot)) % n_chan
            assert abs(slot - round(slot)) < 1e-6, \
                f"channel {f} is off the {spacing:.0f} Hz grid around {center_hz}"
            assert k not in used, f"channel {f} collides on grid slot {k}"
            used.add(k)
            rs = PfbArbResampler(rate)
            rx = LoraReceiver(params)
            tag = ChannelTag(f)
            fg.connect_stream(chan, f"out{k}", rs, "in")
            fg.connect(rs, rx)
            fg.connect_message(rx, "rx", tag, "in")
            receivers.append(rx)
            tags.append(tag)
        for k in set(range(n_chan)) - used:        # terminate unused grid slots
            fg.connect_stream(chan, f"out{k}", NullSink(np.complex64), "in")
        return fg, receivers, tags

    from ...blocks import XlatingFir
    decim = int(round(sample_rate / bandwidth_hz))
    assert abs(decim * bandwidth_hz - sample_rate) < 1e-6, \
        "sample_rate must be an integer multiple of bandwidth_hz"
    taps = firdes.lowpass(0.5 / decim * 0.9, 8 * decim + 1).astype(np.float32)
    for f in channels_hz:
        xl = XlatingFir(taps, decim, f - center_hz, sample_rate)
        rx = LoraReceiver(params)
        tag = ChannelTag(f)
        fg.connect(source, xl, rx)
        fg.connect_message(rx, "rx", tag, "in")
        receivers.append(rx)
        tags.append(tag)
    return fg, receivers, tags
