"""Streaming LoRa blocks wrapping the frame-level PHY (reference `examples/lora/src`
block chain: Modulator | FrameSync → FftDemod → GrayMapping → Deinterleaver →
HammingDecoder → HeaderDecoder → Decoder — collapsed into TX/RX blocks batched per frame).

The port's copy of ``futuresdr_tpu/models/lora/blocks.py``.
"""

from __future__ import annotations

from collections import deque
from dataclasses import replace
from typing import Deque, List, Optional, Tuple

import numpy as np

from ...runtime.kernel import Kernel, message_handler
from ...types import Pmt
from . import phy
from .phy import LoraParams

__all__ = ["LoraTransmitter", "LoraReceiver"]


class LoraTransmitter(Kernel):
    """Message port ``tx`` (Blob) → chirp baseband stream with inter-frame gaps."""

    def __init__(self, params: LoraParams = LoraParams(), gap_symbols: int = 4):
        super().__init__()
        self.params = params
        self.gap = gap_symbols * params.n
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
        except Exception:
            return Pmt.invalid_value()
        frame = phy.modulate_frame(payload, self.params)
        self._pending.append(np.concatenate([frame, np.zeros(self.gap, np.complex64)]))
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


class LoraReceiver(Kernel):
    """Chirp stream → decoded payload messages on ``rx`` (+ ``crc_ok`` flag in a map)."""

    def __init__(self, params: LoraParams = LoraParams(), max_payload: int = 256,
                 implicit_payload_len: Optional[int] = None):
        super().__init__()
        self.params = params
        # implicit-header frames carry no length field — the receiver must be
        # told (decoder.rs:36); required iff params.implicit_header
        self.implicit_payload_len = implicit_payload_len
        if params.implicit_header and (implicit_payload_len is None
                                       or implicit_payload_len < 0):
            raise ValueError("LoraReceiver with implicit_header params needs "
                             "implicit_payload_len >= 0")
        n = params.n
        # worst-case frame length in samples, for the inter-window overlap;
        # ldro payload blocks carry only sf-2 nibbles per column
        max_payload = max(max_payload, implicit_payload_len or 0)
        sf_app = params.sf - 2 if params.ldro_on else params.sf
        n_sym = 8 + (4 + params.cr) * (2 * (max_payload + 2) // sf_app + 2)
        self.OVERLAP = (params.n_preamble + 5 + params.n_null + n_sym) * n
        self.frames = []
        self.crc_flags = []
        self._tail = np.zeros(0, np.complex64)
        self._tail_abs = 0
        self._spans: List[Tuple[int, int]] = []    # decoded frames, stream positions
        self.input = self.add_stream_input("in", np.complex64, min_items=4 * n)
        self.add_message_output("rx")

    def _preamble_start(self, buf: np.ndarray, start: int) -> int:
        """Where the preamble of the frame detected at ``start`` (any of its
        up-chirps) begins in ``buf``: the sync word's two chirps sit the
        accepted id's nibbles times 8 bins off the preamble's bin, so
        ``start`` lies as many chirps before the preamble's end as the sync
        word lies after it (where no accepted id shows, the end of the run
        of chirps at the preamble's bin)."""
        p = self.params
        n, m = p.n, p.n_preamble
        k = min(m + 2, (len(buf) - start) // n)
        spec = np.abs(phy._dechirp_bins(buf[start:start + k * n], p))
        bins = np.argmax(spec, axis=1)
        c = int(bins[0])

        def near(b, bin_):
            return (int(b) - bin_) % n in (0, 1, 2, n - 2, n - 1)

        run = next((j for j in range(1, k) if not near(bins[j], c)), k)
        at = next((j for j in range(1, k - 1)
                   if any(near(bins[j], c + 8 * ((w >> 4) & 0xF))
                          and near(bins[j + 1], c + 8 * (w & 0xF)) for w in p.sync_words)),
                  run)
        return start - max(0, m - at) * n

    def _frames_in(self, buf: np.ndarray, base: int):
        """``(start, (payload, crc_ok, header))`` of each new frame in ``buf``
        (its first sample at stream position ``base``).

        Two departures from the reference's receiver, which takes each
        detection as it comes and skips one whose start falls in a half-symbol
        slot already decoded (ROADMAP Queue 3):

        * a detection can sit at any of a preamble's symbols, so windows cut
          at other places find one frame at starts a symbol or more apart,
          and a run of equal data symbols at a frame's end can pass for a
          preamble and its garbage header for a frame: a detection inside
          the span of a frame already decoded (its preamble's first sample,
          :meth:`_preamble_start`, to its last) is that frame again;
        * ``detect_frames`` skips a frame head's span after every detection.
          A detection that is no frame (it does not decode, or it lies in a
          decoded frame) would hide a preamble starting in that span, so the
          rest of the buffer is scanned again past it: from the end of the
          frame it lies in, or one symbol on."""
        p = self.params
        pending = list(phy.detect_frames(buf, p))
        while pending:
            start = pending.pop(0)
            at = base + start
            inside = [b for a, b in self._spans if a <= at < b]
            r = None if inside else phy.demodulate_frame(buf, start, p,
                                                         n_payload=self.implicit_payload_len)
            if r is None:
                rest = max(inside[0] - base, start + 1) if inside else start + p.n
                pending = sorted(set(pending)
                                 | {rest + s for s in phy.detect_frames(buf[rest:], p)})
                continue
            length, cr, has_crc = r[2]
            frame = len(phy.modulate_frame(r[0], replace(p, cr=cr, has_crc=has_crc)))
            first = base + self._preamble_start(buf, start)
            self._spans.append((first, first + frame))
            yield start, r

    def take(self, samples: np.ndarray) -> list:
        """The frames that ``samples``, the next stretch of the stream, let
        the receiver decode: ``[(payload, crc_ok), ...]`` (recorded in
        :attr:`frames` and :attr:`crc_flags`)."""
        buf = np.concatenate([self._tail, samples])
        base = self._tail_abs
        got = []
        for _start, (payload, crc_ok, _hdr) in self._frames_in(buf, base):
            self.frames.append(payload)
            self.crc_flags.append(crc_ok)
            got.append((payload, crc_ok))
        keep = min(len(buf), self.OVERLAP)
        self._tail = buf[len(buf) - keep:].copy()
        self._tail_abs = base + len(buf) - keep
        self._spans = [(a, b) for a, b in self._spans if b >= self._tail_abs]
        return got

    async def work(self, io, mio, meta):
        inp = self.input.slice()
        n = len(inp)
        if n == 0:
            if self.input.finished():
                io.finished = True
            return
        for payload, crc_ok in self.take(inp[:n]):
            mio.post("rx", Pmt.map({"payload": Pmt.blob(payload),
                                    "crc_ok": Pmt.bool_(crc_ok)}))
        self.input.consume(n)
        if self.input.finished() and self.input.available() == 0:
            io.finished = True
