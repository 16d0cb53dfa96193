"""Audio file sink: ``WavSink``, a copy of ``futuresdr_tpu/blocks/audio.py:WavSink``."""

from __future__ import annotations

import wave
from typing import Optional

import numpy as np

from ..runtime.kernel import Kernel

__all__ = ["WavSink"]


class WavSink(Kernel):
    """Write float32 samples to a 16-bit PCM WAV file."""

    def __init__(self, path: str, sample_rate: int, n_channels: int = 1):
        super().__init__()
        self.path = path
        self.sample_rate = int(sample_rate)
        self.n_channels = n_channels
        self._w: Optional[wave.Wave_write] = None
        self.input = self.add_stream_input("in", np.float32)
        self.n_written = 0

    async def init(self, mio, meta):
        self._w = wave.open(self.path, "wb")
        self._w.setnchannels(self.n_channels)
        self._w.setsampwidth(2)
        self._w.setframerate(self.sample_rate)

    async def deinit(self, mio, meta):
        if self._w:
            self._w.close()

    async def work(self, io, mio, meta):
        # the ring's slices stop at its wrap: drain until nothing is left, so
        # EOS never leaves the items past the wrap behind
        finished = self.input.finished()
        while True:
            inp = self.input.slice()
            if not len(inp):
                break
            pcm = np.clip(inp * 32767.0, -32768, 32767).astype(np.int16)
            self._w.writeframes(pcm.tobytes())
            self.n_written += len(inp)
            self.input.consume(len(inp))
        if finished:
            io.finished = True
