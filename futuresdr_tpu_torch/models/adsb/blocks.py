"""Streaming ADS-B receiver block (reference `examples/adsb` block chain:
PreambleDetector → Demodulator → Decoder → Tracker, over message ports).

The port's copy of ``futuresdr_tpu/models/adsb/blocks.py`` on the port's runtime."""

from __future__ import annotations

import numpy as np

from ...runtime.kernel import Kernel
from ...types import Pmt
from .decoder import Tracker, decode_frame
from .phy import detect_and_demodulate

__all__ = ["AdsbReceiver"]


class AdsbReceiver(Kernel):
    """Magnitude stream (2 Msps) → decoded messages on ``rx`` + live tracker state."""

    OVERLAP = 1024

    def __init__(self, threshold: float = 3.0, ref_pos=None):
        super().__init__()
        self.threshold = threshold
        # ref_pos = receiver site (lat, lon): single-message local CPR decode
        self.tracker = Tracker(ref_pos=ref_pos)
        self.n_frames = 0
        self._tail = np.zeros(0, np.float32)
        self._tail_abs = 0
        self._seen = set()
        self.input = self.add_stream_input("in", np.float32, min_items=512)
        self.add_message_output("rx")

    async def work(self, io, mio, meta):
        inp = self.input.slice()
        n = len(inp)
        if n == 0:
            if self.input.finished():
                io.finished = True
            return
        buf = np.concatenate([self._tail, inp[:n]])
        base = self._tail_abs
        for start, bits in detect_and_demodulate(buf, self.threshold):
            abs_start = base + start
            if abs_start in self._seen:
                continue
            msg = decode_frame(bits)
            if msg is None or not (msg.crc_ok or msg.icao_derived):
                continue
            ac = self.tracker.update(msg)
            if msg.icao_derived and ac is None:
                # AP-overlay frames can't be CRC-verified: only surface them for
                # aircraft already acquired via a checked frame (tracker gate)
                continue
            self._seen.add(abs_start)
            self.n_frames += 1
            mio.post("rx", Pmt.map({
                "icao": msg.icao,
                "df": msg.df,
                "type_code": msg.type_code,
                **({"callsign": msg.callsign} if msg.callsign else {}),
                **({"altitude_ft": msg.altitude_ft}
                   if msg.altitude_ft is not None else {}),
                **({"squawk": msg.squawk} if msg.squawk is not None else {}),
            }))
        keep = min(len(buf), self.OVERLAP)
        self._tail = buf[len(buf) - keep:].copy()
        self._tail_abs = base + len(buf) - keep
        self._seen = {a for a in self._seen if a >= self._tail_abs - self.OVERLAP}
        self.input.consume(n)
        if self.input.finished() and self.input.available() == 0:
            io.finished = True
