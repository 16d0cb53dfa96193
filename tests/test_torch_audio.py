"""The port's audio blocks (``blocks/audio.py``): the cases of
``tests/test_audio_device.py`` on the port, with ``FakeAudioBackend`` in the
soundcard's place so the blocks' stream loops run, then ``WavSource`` against
the JAX package's on the same WAV file, bit for bit. ``sounddevice`` is
installed nowhere the tests run; the blocks import it only when a stream
opens without a backend.
"""

import sys

import numpy as np
import pytest
import torch

from futuresdr_tpu_torch import Flowgraph, Runtime
from futuresdr_tpu_torch.blocks import AudioSink, AudioSource, Head, VectorSink, \
    VectorSource
from futuresdr_tpu_torch.blocks.audio import FakeAudioBackend, set_audio_backend

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)


@pytest.fixture
def fake_backend():
    b = FakeAudioBackend()
    set_audio_backend(b)
    yield b
    set_audio_backend(None)


def test_tone_to_audio_sink_captured(fake_backend):
    """Round-4 verdict item 7's done-criterion: tone → AudioSink → captured
    buffer asserted in a flowgraph test (the real write() path)."""
    fs = 8000
    t = np.arange(fs, dtype=np.float32) / fs
    tone = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    fg = Flowgraph()
    snk = AudioSink(fs)
    fg.connect(VectorSource(tone), snk)
    Runtime().run(fg)
    got = fake_backend.played_samples()
    np.testing.assert_array_equal(got, tone)
    assert fake_backend.opened == ["output"]
    assert snk._stream is not None                 # device path, not null path


def test_audio_source_captures_from_device(fake_backend):
    """AudioSource pulls frames from the device read() loop; a bounded capture
    drains into a VectorSink sample-exact."""
    fs = 8000
    n_total = 20_000
    src_data = np.linspace(-1, 1, n_total, dtype=np.float32)
    pos = [0]

    def capture(n, ch):
        a, b = pos[0], min(pos[0] + n, n_total)
        pos[0] = b
        return src_data[a:b].reshape(-1, 1)

    fake_backend.capture_fn = capture
    fg = Flowgraph()
    vs = VectorSink(np.float32)
    fg.connect(AudioSource(fs), Head(np.float32, 15_000), vs)
    Runtime().run(fg)
    np.testing.assert_array_equal(vs.items(), src_data[:15_000])


def test_audio_source_finishes_when_capture_exhausted(fake_backend):
    fs = 8000
    chunks = [np.ones((500, 1), np.float32), np.zeros((0, 1), np.float32)]

    def capture(n, ch):
        return chunks.pop(0) if chunks else np.zeros((0, ch), np.float32)

    fake_backend.capture_fn = capture
    fg = Flowgraph()
    vs = VectorSink(np.float32)
    fg.connect(AudioSource(fs), vs)
    Runtime().run(fg)                    # EOS from the device, not a Head
    assert len(vs.items()) == 500


def test_stereo_sink_preserves_interleaving(fake_backend):
    """Odd-length chunks mid-stream (CopyRand) must not flip L/R alignment:
    the sink consumes only whole frames and leaves the dangling sample for
    its partner (review regression)."""
    from futuresdr_tpu_torch.blocks import CopyRand
    fs = 4000
    inter = np.arange(1000, dtype=np.float32)      # L0 R0 L1 R1 …
    fg = Flowgraph()
    snk = AudioSink(fs, n_channels=2)
    fg.connect(VectorSource(inter), CopyRand(np.float32, max_copy=7, seed=3),
               snk)
    Runtime().run(fg)
    got = fake_backend.played_samples()
    np.testing.assert_array_equal(got, inter)
    # frames written as [n, 2]
    assert all(p.ndim == 2 and p.shape[1] == 2 for p in fake_backend.played)


def test_device_open_failure_raises_without_allow_null():
    """A backend whose open() fails must surface at init (trap, not silence).
    A failing stub is installed rather than clearing the backend: on a machine
    with a working soundcard, sounddevice would open a REAL stream and the
    unbounded source flowgraph would run forever (review)."""
    class NoDevice:
        def open(self, kind, samplerate, channels):
            raise RuntimeError("simulated absent device")

    set_audio_backend(NoDevice())
    try:
        fg = Flowgraph()
        fg.connect(AudioSource(8000), VectorSink(np.float32))
        with pytest.raises(Exception, match="audio backend"):
            Runtime().run(fg)
    finally:
        set_audio_backend(None)


def test_wav_source_equals_the_jax_block(tmp_path):
    """A WAV written by ``WavSink`` reads back through the port's
    ``WavSource`` as through the JAX package's, bit for bit (and within one
    quantization step of what was written)."""
    import futuresdr_tpu as J
    from futuresdr_tpu.blocks import VectorSink as JVectorSink
    from futuresdr_tpu.blocks import WavSource as JWavSource
    from futuresdr_tpu_torch.blocks import WavSink, WavSource
    path = str(tmp_path / "tone.wav")
    x = (0.6 * np.sin(2 * np.pi * 0.01 * np.arange(40_000))).astype(np.float32)
    fg = Flowgraph()
    fg.connect(VectorSource(x), WavSink(path, 16_000))
    Runtime().run(fg)
    fg = Flowgraph()
    src, snk = WavSource(path), VectorSink(np.float32)
    fg.connect(src, snk)
    Runtime().run(fg)
    jfg = J.Flowgraph()
    jsrc, jsnk = JWavSource(path), JVectorSink(np.float32)
    jfg.connect(jsrc, jsnk)
    J.Runtime().run(jfg)
    np.testing.assert_array_equal(snk.items(), jsnk.items())
    assert src.sample_rate == jsrc.sample_rate == 16_000
    assert np.abs(snk.items() - x).max() < 2.0 / 32768


def test_sounddevice_is_imported_only_when_a_stream_opens():
    """With no backend installed, building the soundcard blocks imports
    nothing; opening their stream tries ``sounddevice`` and, where it is not
    installed, raises at init (``allow_null`` emits silence instead)."""
    set_audio_backend(None)
    sys.modules.pop("sounddevice", None)
    AudioSink(8000)
    AudioSource(8000)
    assert "sounddevice" not in sys.modules
    try:
        import sounddevice  # noqa: F401
        return                      # a machine with a soundcard stack: nothing to refuse
    except (ImportError, OSError):
        pass
    fg = Flowgraph()
    fg.connect(VectorSource(np.zeros(100, np.float32)), AudioSink(8000))
    with pytest.raises(Exception, match="no audio backend"):
        Runtime().run(fg)
