"""Audio blocks: WAV file source and sink, soundcard source and sink.

A copy of ``futuresdr_tpu/blocks/audio.py`` (reference: ``src/blocks/audio/``,
cpal ``AudioSink``/``AudioSource``, hound's WAV source and sink). WAV files go
through the standard library's ``wave``. The soundcard blocks open their
stream through the installed backend (:func:`set_audio_backend`) or, with
none installed, ``sounddevice``, imported only when a stream opens; without
either they raise at init unless built with ``allow_null=True``.
:class:`FakeAudioBackend` is an in-memory device: deterministic capture and
playback, so the blocks' stream loops run without a soundcard.
"""

from __future__ import annotations

import wave
from typing import Callable, List, Optional

import numpy as np

from ..log import logger
from ..runtime.kernel import Kernel

__all__ = ["WavSource", "WavSink", "AudioSource", "AudioSink",
           "FakeAudioBackend", "set_audio_backend"]

log = logger("blocks.audio")

_backend = None          # None → probe sounddevice at stream-open time


def set_audio_backend(backend) -> None:
    """Install a device backend (``None`` restores the sounddevice probe).

    A backend exposes ``open(kind, samplerate, channels) -> stream`` where
    ``kind`` is ``"input"``/``"output"`` and the stream duck-types the
    sounddevice API used here: ``start()``, ``stop()``, ``close()``,
    ``read(n) -> (frames[n, ch], overflowed)`` (input) and
    ``write(frames[n, ch])`` (output)."""
    global _backend
    _backend = backend


def _open_stream(kind: str, samplerate: int, channels: int):
    if _backend is not None:
        return _backend.open(kind, samplerate, channels)
    import sounddevice as sd
    cls = sd.InputStream if kind == "input" else sd.OutputStream
    return cls(samplerate=samplerate, channels=channels, dtype="float32")


class FakeAudioBackend:
    """Deterministic in-memory audio device (CI twin of a soundcard).

    - capture: ``capture_fn(n, channels) -> float32 [n, channels]`` supplies
      input frames (``None`` → silence); return an empty array for "no more".
    - playback: every written chunk is appended to :attr:`played`.
    """

    def __init__(self, capture_fn: Optional[Callable] = None):
        self.capture_fn = capture_fn
        self.played: List[np.ndarray] = []
        self.opened: List[str] = []

    def open(self, kind: str, samplerate: int, channels: int):
        self.opened.append(kind)
        return _FakeStream(self, kind, channels)

    def played_samples(self) -> np.ndarray:
        return (np.concatenate([p.reshape(-1) for p in self.played])
                if self.played else np.zeros(0, np.float32))


class _FakeStream:
    def __init__(self, backend: FakeAudioBackend, kind: str, channels: int):
        self._b = backend
        self._kind = kind
        self._ch = channels
        self.started = False

    def start(self):
        self.started = True

    def stop(self):
        self.started = False

    def close(self):
        pass

    def read(self, n: int):
        fn = self._b.capture_fn
        frames = (np.zeros((n, self._ch), np.float32) if fn is None
                  else np.asarray(fn(n, self._ch), np.float32))
        return frames, False

    def write(self, frames: np.ndarray):
        self._b.played.append(np.array(frames, np.float32, copy=True))


class WavSource(Kernel):
    """Stream float32 samples from a WAV file (`audio/wav file source`)."""

    def __init__(self, path: str, repeat: bool = False):
        super().__init__()
        self.path = path
        self.repeat = repeat
        self._w: Optional[wave.Wave_read] = None
        self.sample_rate = 0
        self.n_channels = 1
        self.output = self.add_stream_output("out", np.float32)

    async def init(self, mio, meta):
        self._w = wave.open(self.path, "rb")
        self.sample_rate = self._w.getframerate()
        self.n_channels = self._w.getnchannels()
        if self._w.getsampwidth() != 2:
            raise RuntimeError("WavSource supports 16-bit PCM only")

    async def deinit(self, mio, meta):
        if self._w:
            self._w.close()

    async def work(self, io, mio, meta):
        out = self.output.slice()
        want = len(out) // self.n_channels
        if want == 0:
            return
        raw = self._w.readframes(min(want, 1 << 15))
        if not raw:
            if self.repeat:
                self._w.rewind()
                io.call_again = True
                return
            io.finished = True
            return
        pcm = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
        out[:len(pcm)] = pcm
        self.output.produce(len(pcm))
        io.call_again = True


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


class AudioSource(Kernel):
    """Soundcard capture (cpal `AudioSource` role).

    Without an audio backend this **raises at init** (an SDR app capturing silence is a
    trap, not a fallback) unless constructed with ``allow_null=True``, which emits
    silence at real-time pace (CI / headless use)."""

    BLOCKING = True

    def __init__(self, sample_rate: int, n_channels: int = 1, allow_null: bool = False):
        super().__init__()
        self.sample_rate = int(sample_rate)
        self.n_channels = n_channels
        self.allow_null = allow_null
        self._stream = None
        self.output = self.add_stream_output("out", np.float32)

    async def init(self, mio, meta):
        try:
            self._stream = _open_stream("input", self.sample_rate,
                                        self.n_channels)
            self._stream.start()
        except Exception as e:
            if not self.allow_null:
                raise RuntimeError(
                    f"AudioSource: no audio backend ({e!r}); pass allow_null=True "
                    f"to emit silence instead") from e
            log.warning("no audio backend (%r): AudioSource emits silence", e)
            self._stream = None

    async def deinit(self, mio, meta):
        if self._stream is not None:
            self._stream.stop()
            self._stream.close()

    async def work(self, io, mio, meta):
        import asyncio
        out = self.output.slice()
        want = (len(out) // self.n_channels)
        if want == 0:
            return
        if self._stream is not None:
            frames, _ = self._stream.read(min(want, 4096))
            data = frames.reshape(-1)
            if len(data) == 0:
                # a real device blocks in read(); only a backend signalling
                # end-of-capture (FakeAudioBackend capture_fn exhausted)
                # returns empty — finish like a drained file source
                io.finished = True
                return
        else:
            # silence at roughly real-time pace
            n = min(want, self.sample_rate // 20)
            data = np.zeros(n * self.n_channels, np.float32)
            io.block_on(asyncio.sleep(n / self.sample_rate))
        out[:len(data)] = data
        self.output.produce(len(data))
        if self._stream is not None:
            io.call_again = True


class AudioSink(Kernel):
    """Soundcard playback (cpal `AudioSink` role).

    Without an audio backend this **raises at init** (an FM receiver that runs and plays
    nothing is a trap) unless constructed with ``allow_null=True``, which drops samples
    with a warning (CI / headless use)."""

    BLOCKING = True

    def __init__(self, sample_rate: int, n_channels: int = 1, allow_null: bool = False):
        super().__init__()
        self.sample_rate = int(sample_rate)
        self.n_channels = n_channels
        self.allow_null = allow_null
        self._stream = None
        # sub-frame remainder carried across work() calls: consuming a
        # wrap-capped or odd-length chunk is safe because channel identity is
        # absolute stream position mod n_channels — the dangling sample(s)
        # wait here for their partners instead of being dropped
        self._pend = np.zeros(0, np.float32)
        # short queue: at 48 kHz a 16 KiB float buffer is already 85 ms of audio —
        # real-time playback wants the low-latency profile by default
        self.input = self.add_stream_input("in", np.float32,
                                           preferred_buffer_size=16384)

    async def init(self, mio, meta):
        try:
            self._stream = _open_stream("output", self.sample_rate,
                                        self.n_channels)
            self._stream.start()
        except Exception as e:
            if not self.allow_null:
                raise RuntimeError(
                    f"AudioSink: no audio backend ({e!r}); pass allow_null=True "
                    f"to drop samples instead") from e
            log.warning("no audio backend (%r): AudioSink drops samples", e)
            self._stream = None

    async def deinit(self, mio, meta):
        if self._stream is not None:
            self._stream.stop()
            self._stream.close()

    async def work(self, io, mio, meta):
        inp = self.input.slice()
        if len(inp):
            if self._stream is not None:
                buf = np.concatenate([self._pend, inp]) if len(self._pend) \
                    else np.asarray(inp)
                k = len(buf) - len(buf) % self.n_channels
                if k:
                    self._stream.write(
                        buf[:k].reshape(-1, self.n_channels).copy())
                self._pend = buf[k:].copy()
            self.input.consume(len(inp))
        if self.input.finished():
            if self.input.available():
                # the readable slice was wrap-capped below what is buffered —
                # keep draining (we consumed above, so this always progresses)
                io.call_again = True
            else:
                io.finished = True       # a sub-frame _pend tail is dropped
