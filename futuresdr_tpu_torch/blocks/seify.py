"""Hardware source/sink blocks over the HAL driver registry (a copy of
``futuresdr_tpu/blocks/seify.py``).

Reference: ``src/blocks/seify/{source,sink,builder,config}.rs``: ``#[blocking]`` blocks with
``freq``/``gain``/``sample_rate``/``cmd`` message ports (`seify/source.rs:53-56`), built via a
fluent ``Builder``. Multi-channel RX maps to multiple output ports.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..hw import Device
from ..log import logger
from ..runtime.kernel import Kernel, message_handler
from ..types import Pmt

__all__ = ["SeifySource", "SeifySink", "SeifyBuilder"]

log = logger("blocks.seify")


def _apply_cmd(driver, p: Pmt, channel: int = 0):
    """Apply a config map: {"freq": .., "gain": .., "sample_rate": ..} (seify Config)."""
    m = p.to_map()
    for k, v in m.items():
        val = v.to_float()
        if k in ("freq", "frequency"):
            driver.set_frequency(val, channel)
        elif k == "gain":
            driver.set_gain(val, channel)
        elif k in ("sample_rate", "rate"):
            driver.set_sample_rate(val, channel)
        else:
            log.warning("unknown cmd key %r", k)


class SeifySource(Kernel):
    """RX streamer (`seify/source.rs`): blocking reads on a dedicated thread."""

    BLOCKING = True

    def __init__(self, args: str = "driver=dummy", n_channels: int = 1,
                 frequency: Optional[float] = None, gain: Optional[float] = None,
                 sample_rate: Optional[float] = None):
        super().__init__()
        self.device = Device(args)
        d = self.device.driver
        if sample_rate is not None:
            d.set_sample_rate(sample_rate)
        if frequency is not None:
            d.set_frequency(frequency)
        if gain is not None:
            d.set_gain(gain)
        self.n_channels = n_channels
        self.outputs = [self.add_stream_output(f"out{i}" if n_channels > 1 else "out",
                                               np.complex64)
                        for i in range(n_channels)]

    @message_handler(name="freq")
    async def freq_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        try:
            self.device.driver.set_frequency(p.to_float())
        except Exception:
            return Pmt.invalid_value()
        return Pmt.ok()

    @message_handler(name="gain")
    async def gain_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        try:
            self.device.driver.set_gain(p.to_float())
        except Exception:
            return Pmt.invalid_value()
        return Pmt.ok()

    @message_handler(name="sample_rate")
    async def sample_rate_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        try:
            self.device.driver.set_sample_rate(p.to_float())
        except Exception:
            return Pmt.invalid_value()
        return Pmt.ok()

    @message_handler(name="cmd")
    async def cmd_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        try:
            _apply_cmd(self.device.driver, p)
        except Exception:
            return Pmt.invalid_value()
        return Pmt.ok()

    async def init(self, mio, meta):
        self.device.driver.activate_rx(tuple(range(self.n_channels)))

    async def deinit(self, mio, meta):
        self.device.driver.deactivate()

    async def work(self, io, mio, meta):
        # one slice a port, read once: the read is sized from the windows it
        # is written into (a second slice() can be longer once a reader has
        # consumed in between; the reference sizes it that way and can
        # overrun its first window, ROADMAP Queue 3)
        outs = [o.slice() for o in self.outputs]
        n = min((len(s) for s in outs), default=0)
        if n == 0:
            return
        data = self.device.driver.read(n)   # blocking; we're on a dedicated thread
        if data is None:                    # driver EOS (a non-repeating file replay)
            io.finished = True
            return
        k = len(data)
        for o, s in zip(self.outputs, outs):
            s[:k] = data
            o.produce(k)
        io.call_again = True


class SeifySink(Kernel):
    """TX streamer (`seify/sink.rs`)."""

    BLOCKING = True

    def __init__(self, args: str = "driver=dummy",
                 frequency: Optional[float] = None, gain: Optional[float] = None,
                 sample_rate: Optional[float] = None):
        super().__init__()
        self.device = Device(args)
        d = self.device.driver
        if sample_rate is not None:
            d.set_sample_rate(sample_rate)
        if frequency is not None:
            d.set_frequency(frequency)
        if gain is not None:
            d.set_gain(gain)
        self.input = self.add_stream_input("in", np.complex64)

    @message_handler(name="freq")
    async def freq_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        try:
            self.device.driver.set_frequency(p.to_float())
        except Exception:
            return Pmt.invalid_value()
        return Pmt.ok()

    @message_handler(name="cmd")
    async def cmd_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        try:
            _apply_cmd(self.device.driver, p)
        except Exception:
            return Pmt.invalid_value()
        return Pmt.ok()

    async def init(self, mio, meta):
        self.device.driver.activate_tx()

    async def deinit(self, mio, meta):
        self.device.driver.deactivate()

    async def work(self, io, mio, meta):
        inp = self.input.slice()
        if len(inp):
            written = self.device.driver.write(inp)
            self.input.consume(written)
        if self.input.finished() and self.input.available() == 0:
            io.finished = True


class SeifyBuilder:
    """Fluent builder (`seify/builder.rs`)."""

    def __init__(self, args: str = "driver=dummy"):
        self._args = args
        self._freq = None
        self._gain = None
        self._rate = None
        self._channels = 1

    def args(self, a: str) -> "SeifyBuilder":
        self._args = a
        return self

    def frequency(self, f: float) -> "SeifyBuilder":
        self._freq = f
        return self

    def gain(self, g: float) -> "SeifyBuilder":
        self._gain = g
        return self

    def sample_rate(self, r: float) -> "SeifyBuilder":
        self._rate = r
        return self

    def channels(self, n: int) -> "SeifyBuilder":
        self._channels = n
        return self

    def build_source(self) -> SeifySource:
        return SeifySource(self._args, self._channels, self._freq, self._gain, self._rate)

    def build_sink(self) -> SeifySink:
        return SeifySink(self._args, self._freq, self._gain, self._rate)
