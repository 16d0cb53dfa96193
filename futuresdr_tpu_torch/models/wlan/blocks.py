"""Streaming WLAN blocks wrapping the frame-level PHY.

The counterpart of ``futuresdr_tpu/models/wlan/blocks.py``. The reference WLAN
example wires ~8 blocks (`examples/wlan/src/bin/loopback.rs:30-123`); here the TX
is one message→stream block (host numpy) and the RX one stream→message block
around the batched PHY: each window's frames demodulate on the device and share
one ACS launch there (``phy.decode_stream_batch``).
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Optional

import numpy as np

from ...runtime.kernel import Kernel, message_handler
from ...tpu.instance import resolve_device
from ...types import Pmt, PmtConversionError
from . import phy
from .mac import Mac

__all__ = ["WlanEncoder", "WlanDecoder"]


class WlanEncoder(Kernel):
    """Message port ``tx`` (Blob payload) → baseband sample stream with inter-frame
    gap (the reference's Mac → Encoder → Mapper → Prefix path)."""

    def __init__(self, mcs: str = "qpsk_1_2", gap_samples: int = 500,
                 use_mac: bool = True):
        super().__init__()
        self.mcs = mcs
        self.gap = gap_samples
        self.mac = Mac() if use_mac else None
        self._pending: Deque[np.ndarray] = deque()
        self._current: Optional[np.ndarray] = None
        self._eos = False
        self.output = self.add_stream_output("out", np.complex64)

    @message_handler(name="tx")
    async def tx_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        if p.is_finished():
            self._eos = True
            io.call_again = True
            return Pmt.ok()
        try:
            payload = p.to_blob()
        except PmtConversionError:
            return Pmt.invalid_value()
        psdu = self.mac.frame(payload) if self.mac else payload
        frame = phy.encode_frame(psdu, self.mcs)
        burst = np.concatenate([frame, np.zeros(self.gap, np.complex64)])
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


class WlanDecoder(Kernel):
    """Baseband stream → decoded payload messages on port ``rx`` (the reference's
    SyncShort → SyncLong → FFT → FrameEqualizer → Decoder path, batched) on
    ``device`` (None: the card; it raises without one)."""

    #: sample overlap kept between work windows so frames spanning the boundary survive
    OVERLAP = 4096

    def __init__(self, use_mac: bool = True, chunk: int = 1 << 16, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.mac = Mac() if use_mac else None
        self.chunk = chunk
        self.frames = []           # decoded PSDUs (or payloads with MAC)
        self._tail = np.zeros(0, np.complex64)
        self._tail_abs = 0         # absolute index of tail[0]
        self._seen_abs = set()     # absolute lts starts already decoded
        self.input = self.add_stream_input("in", np.complex64, min_items=1024)
        self.add_message_output("rx")

    async def work(self, io, mio, meta):
        inp = self.input.slice()
        n = len(inp)
        if n < self.chunk and not self.input.finished():
            return          # wait for a fuller window (upstream produce re-arms us)
        if n == 0:
            if self.input.finished():
                io.finished = True
            return
        buf = np.concatenate([self._tail, inp[:n]])
        base = self._tail_abs
        # burst-batched decode: every frame in the window shares one ACS launch
        for frame in phy.decode_stream_batch(buf, self.device):
            abs_lts = base + frame.start
            if abs_lts in self._seen_abs:
                continue
            self._seen_abs.add(abs_lts)
            psdu = frame.psdu
            if self.mac:
                payload = self.mac.deframe(psdu)
                if payload is None:
                    continue
                self.frames.append(payload)
                mio.post("rx", Pmt.blob(payload))
            else:
                self.frames.append(psdu)
                mio.post("rx", Pmt.blob(psdu))
        keep = min(len(buf), self.OVERLAP)
        self._tail = buf[len(buf) - keep:].copy()
        self._tail_abs = base + len(buf) - keep
        self._seen_abs = {a for a in self._seen_abs if a >= self._tail_abs - self.OVERLAP}
        self.input.consume(n)
        if self.input.finished() and self.input.available() == 0:
            io.finished = True
