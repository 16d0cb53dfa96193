"""Streaming ZigBee blocks (reference `examples/zigbee` chain: modulator |
ClockRecoveryMm → Demodulator → Mac).

The port's copy of ``futuresdr_tpu/models/zigbee/blocks.py`` on the port's runtime."""

from __future__ import annotations

from collections import deque
from typing import Deque, Optional

import numpy as np

from ...runtime.kernel import Kernel, message_handler
from ...types import Pmt
from .phy import SAMPLES_PER_CHIP, demodulate_stream, mac_deframe, mac_frame, modulate_frame

__all__ = ["IqDelay", "ZigbeeTransmitter", "ZigbeeReceiver"]


class IqDelay(Kernel):
    """Half-chip O-QPSK offset as a stream block (`iq_delay.rs` role): the
    imaginary rail is delayed by ``delay`` samples relative to the real rail
    (zeros seed the line). The reference wraps this in burst padding for its
    hardware TX framing; here the transmitter blocks own inter-burst gaps, so
    the delay is continuous."""

    def __init__(self, delay: int = 2):
        super().__init__()
        assert delay >= 0
        self.delay = int(delay)
        self._line = np.zeros(self.delay, np.float32)
        self.input = self.add_stream_input("in", np.complex64)
        self.output = self.add_stream_output("out", np.complex64)

    async def work(self, io, mio, meta):
        inp = self.input.slice()
        out = self.output.slice()
        n = min(len(inp), len(out))
        if n == 0:
            if self.input.finished() and self.input.available() == 0:
                io.finished = True
            return
        x = inp[:n]
        q = np.concatenate([self._line, x.imag.astype(np.float32)])
        out[:n] = x.real + 1j * q[:n]
        if self.delay:
            self._line = q[n:n + self.delay].copy()
        self.input.consume(n)
        self.output.produce(n)
        if self.input.finished() and self.input.available() == 0:
            io.finished = True
        elif len(inp) > n:
            io.call_again = True


class ZigbeeTransmitter(Kernel):
    """Message port ``tx`` (Blob payload) → O-QPSK baseband stream."""

    def __init__(self, gap_samples: int = 2000):
        super().__init__()
        self.gap = gap_samples
        self._pending: Deque[np.ndarray] = deque()
        self._current: Optional[np.ndarray] = None
        self._eos = False
        self._seq = 0
        self.output = self.add_stream_output("out", np.complex64)

    @message_handler(name="tx")
    async def tx_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        if p.is_finished():
            self._eos = True
            io.call_again = True
            return Pmt.ok()
        try:
            payload = p.to_blob()
        except Exception:
            return Pmt.invalid_value()
        psdu = mac_frame(payload, self._seq)
        self._seq = (self._seq + 1) & 0xFF
        burst = np.concatenate([modulate_frame(psdu),
                                np.zeros(self.gap, np.complex64)])
        self._pending.append(burst)
        io.call_again = True
        return Pmt.ok()

    async def work(self, io, mio, meta):
        out = self.output.slice()
        produced = 0
        while produced < len(out):
            if self._current is None:
                if not self._pending:
                    break
                self._current = self._pending.popleft()
            k = min(len(out) - produced, len(self._current))
            out[produced:produced + k] = self._current[:k]
            produced += k
            self._current = self._current[k:] if k < len(self._current) else None
        if produced:
            self.output.produce(produced)
        if self._eos and self._current is None and not self._pending:
            io.finished = True
        elif produced and (self._current is not None or self._pending):
            io.call_again = True


class ZigbeeReceiver(Kernel):
    """Baseband stream → validated payloads on ``rx``."""

    def __init__(self, chunk: Optional[int] = None, timing: str = "phase"):
        super().__init__()
        # the tail holds the longest frame (SHR, PHR and a 127-byte PSDU,
        # 64 chips a byte) and the reference's margin of 160 × 8 chips: the
        # reference keeps the margin alone, so a frame of more than about 20
        # bytes that a window boundary cuts is never whole in any window
        self.OVERLAP = ((4 + 1 + 1 + 127) * 64 + 160 * 8) * SAMPLES_PER_CHIP
        self.frames = []
        self.timing = timing        # "phase" | "mm" | "coherent" (phy.demodulate_stream)
        # coherent mode amortizes its FFT correlation + overlap over big chunks:
        # 256k chunks run ~7.9 Msps vs 4.2 at 32k (real-time at 2 Mchip/s x 4 sps)
        self.chunk = chunk or ((1 << 18) if timing == "coherent" else 1024)
        self._tail = np.zeros(0, np.complex64)
        self._seen_payloads: Deque[bytes] = deque(maxlen=16)
        self.input = self.add_stream_input("in", np.complex64,
                                           min_items=self.chunk)
        self.add_message_output("rx")

    async def work(self, io, mio, meta):
        inp = self.input.slice()
        n = len(inp)
        if n == 0:
            if self.input.finished():
                io.finished = True
            return
        buf = np.concatenate([self._tail, inp[:n]])
        for psdu in demodulate_stream(buf, timing=self.timing):
            payload = mac_deframe(psdu)
            if payload is None or psdu in self._seen_payloads:
                continue
            self._seen_payloads.append(psdu)
            self.frames.append(payload)
            mio.post("rx", Pmt.blob(payload))
        keep = min(len(buf), self.OVERLAP)
        self._tail = buf[len(buf) - keep:].copy()
        self.input.consume(n)
        if self.input.finished() and self.input.available() == 0:
            io.finished = True
