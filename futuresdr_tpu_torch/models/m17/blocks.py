"""Streaming M17 blocks: LSF beacon transmitter and receiver.

Reference: the M17 example's encoder/decoder block chain (``examples/m17/src/``).
The port's copy of ``futuresdr_tpu/models/m17/blocks.py`` on the port's runtime.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, List, Optional

import numpy as np

from ...runtime.kernel import Kernel, message_handler
from ...types import Pmt
from .phy import (Lsf, SPS, _lsf_positions, _transmissions, build_lsf_frame,
                  build_stream_frames, modulate)

__all__ = ["M17Transmitter", "M17Receiver"]

# Two finds of one frame lie within half a frame of each other (sample phases,
# a symbol's slip); two frames sent lie a whole frame apart at least: an LSF
# and a stream frame each span 192 symbols.
_SAME = 192 * SPS // 2


def _seen(posted: List[int], at: int) -> bool:
    return any(abs(at - p) < _SAME for p in posted)


class M17Transmitter(Kernel):
    """Message port ``tx`` ({dst, src} map or Blob meta) → 4FSK baseband stream."""

    def __init__(self, src_callsign: str = "N0CALL", gap_symbols: int = 40):
        super().__init__()
        self.src_callsign = src_callsign
        self.gap = gap_symbols * SPS
        self._pending: Deque[np.ndarray] = deque()
        self._current: Optional[np.ndarray] = None
        self._eos = False
        self.output = self.add_stream_output("out", np.float32)

    @message_handler(name="tx")
    async def tx_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        if p.is_finished():
            self._eos = True
            io.call_again = True
            return Pmt.ok()
        try:
            m = p.to_map()
            lsf = Lsf(dst=m.get("dst", Pmt.string("@ALL")).to_str(),
                      src=m.get("src", Pmt.string(self.src_callsign)).to_str(),
                      meta=m["meta"].to_blob() if "meta" in m else bytes(14))
            payload = m["payload"].to_blob() if "payload" in m else None
        except Exception:
            return Pmt.invalid_value()
        # a payload selects stream mode (LSF + LICH-chunked payload frames);
        # without one this is the plain LSF beacon
        syms = (build_stream_frames(lsf, payload) if payload is not None
                else build_lsf_frame(lsf))
        wave = modulate(syms)
        self._pending.append(np.concatenate([wave, np.zeros(self.gap, np.float32)]))
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


class M17Receiver(Kernel):
    """4FSK baseband stream → decoded LSF beacons and stream transmissions on
    ``rx`` (payload transmissions carry a ``payload`` blob).

    ``max_payload_frames`` bounds a stream transmission's length (it sizes the
    inter-window overlap; `decoder.rs` streams unbounded because its state
    machine is per-frame — here the window must hold a whole transmission).

    Where the port departs from the reference: a frame is known again by its
    place in the stream, not by its content. The reference keys its memory
    by the LSF's bytes (and the transmission's payload), so a beacon that
    repeats itself, as beacons do, or a payload sent again, comes once and
    is then dropped while its key is remembered. Here each LSF and each
    transmission is posted once for each time it was sent, in order, however
    the stream is cut into windows.
    """

    def __init__(self, max_payload_frames: int = 16):
        super().__init__()
        n_stream = (8 + 48 + 136) * SPS
        self.OVERLAP = (8 + 184 + 16) * SPS + 200 + max_payload_frames * n_stream
        self.frames = []
        self.transmissions = []
        self._tail = np.zeros(0, np.float32)
        self._tail_abs = 0              # the stream index of the tail's first sample
        # the stream positions of the LSFs and of the transmissions' first
        # frames posted while they may still lie in the tail
        self._lsf_at: List[int] = []
        self._tx_at: List[int] = []
        self.input = self.add_stream_input("in", np.float32, min_items=64 * SPS)
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
        for pos, lsf, _agree in _lsf_positions(buf, SPS, content_dedup=False):
            if _seen(self._lsf_at, base + pos):
                continue
            self._lsf_at.append(base + pos)
            self.frames.append(lsf)
            mio.post("rx", Pmt.map({"dst": lsf.dst, "src": lsf.src,
                                    "meta": Pmt.blob(lsf.meta)}))
        for pos, lsf, payload, complete in _transmissions(buf, SPS):
            if not complete:
                # EOS not seen (still arriving) or fn-gapped (truncated by the
                # window or torn by noise): never surface a partial transmission
                continue
            if _seen(self._tx_at, base + pos):
                continue
            self._tx_at.append(base + pos)
            self.transmissions.append((lsf, payload))
            mio.post("rx", Pmt.map({
                **({"dst": lsf.dst, "src": lsf.src} if lsf else {}),
                "payload": Pmt.blob(payload)}))
        keep = min(len(buf), self.OVERLAP)
        self._tail = buf[len(buf) - keep:].copy()
        self._tail_abs = base + len(buf) - keep
        self._lsf_at = [a for a in self._lsf_at if a >= self._tail_abs - _SAME]
        self._tx_at = [a for a in self._tx_at if a >= self._tail_abs - _SAME]
        self.input.consume(n)
        if self.input.finished() and self.input.available() == 0:
            io.finished = True
