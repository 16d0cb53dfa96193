"""The port's FM receiver in a flowgraph, on the CPU.

``build_flowgraph(VectorSource(iq), use_tpu=True, audio_path=…)`` recovers the
1 kHz tone of an FM-modulated test signal through ``WavSink`` (the check of
``tests/test_apps.py``); ``VectorSource → TpuKernel → VectorSink`` on the
kernel-pinned chain matches the JAX package's ``TpuKernel`` with an input
that is not a multiple of the 500-sample frame multiple; the 24/500 rate
change passes the ring at the default frame; and a mid-stream retune lands
as on the resident chain.
"""

import time
import wave

import numpy as np
import pytest
import torch

import futuresdr_tpu as jfs
from futuresdr_tpu import blocks as jblocks
from futuresdr_tpu.ops import stages as J
from futuresdr_tpu.tpu import TpuKernel as JaxTpuKernel
from futuresdr_tpu_torch import Flowgraph, Runtime
from futuresdr_tpu_torch.apps.fm_receiver import (AUDIO_RATE, build_flowgraph,
                                                  front_end_stages)
from futuresdr_tpu_torch.blocks import (Head, NullSink, NullSource, VectorSink,
                                        VectorSource, WavSink)
from futuresdr_tpu_torch.dsp import firdes
from futuresdr_tpu_torch.ops import stages as T
from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

CPU = TpuInstance("cpu")
FS = 1e6
OFFSET = 100e3
THETA = -2 * np.pi * OFFSET / FS


def _fm_iq(n, offset=0.0, tone=1000.0):
    t = np.arange(n) / FS
    msg = np.sin(2 * np.pi * tone * t)
    return np.exp(1j * (2 * np.pi * 75e3 * np.cumsum(msg) / FS
                        + 2 * np.pi * offset * t)).astype(np.complex64)


def _kernel_chain(m):
    return [m.rotator_stage(THETA, name="tuner", impl="pallas"),
            m.fir_stage(firdes.lowpass(0.5 / 4 * 0.8, 128), decim=4, impl="pallas",
                        name="chan"),
            m.quad_demod_stage(250e3 / (2 * np.pi * 75e3), impl="pallas"),
            m.resample_stage(24, 125, impl="pallas")]


def _peak_hz(pcm, rate):
    pcm = pcm[len(pcm) // 4:]                 # skip the transient
    spec = np.abs(np.fft.rfft(pcm * np.hanning(len(pcm))))
    return np.fft.rfftfreq(len(pcm), 1.0 / rate)[np.argmax(spec[5:]) + 5]


def _read_wav(path):
    w = wave.open(path, "rb")
    pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16).astype(np.float64)
    w.close()
    return pcm


def test_fm_receiver_recovers_the_tone_through_wav_sink(tmp_path):
    """The app's chain at the default frame (262,000 samples in, 12,576
    out) over an input that is not a multiple of the frame or of 500."""
    n = 1_500_123
    wav = str(tmp_path / "fm.wav")
    fg, retune, sink = build_flowgraph(VectorSource(_fm_iq(n, OFFSET)), offset=OFFSET,
                                       audio_path=wav, use_tpu=True, inst=CPU)
    assert retune.frame_size == 262_000 and retune.out_frame == 12_576
    Runtime().run(fg)
    assert sink.n_written == (n - n % 500) * 24 // 500
    pcm = _read_wav(wav)
    assert len(pcm) == sink.n_written
    assert abs(_peak_hz(pcm, AUDIO_RATE) - 1000.0) < 20.0


def test_fm_receiver_head_and_null_sink_count_items():
    n = 3 * 262_000 + 1_000
    fg, _, sink = build_flowgraph(VectorSource(_fm_iq(n + 5_000)), n_samples=n,
                                  use_tpu=True, inst=CPU)
    Runtime().run(fg)
    assert sink.n_received == n * 24 // 500


@pytest.mark.parametrize("kw", [{}, {"use_tpu": False}])
def test_fm_receiver_paths_outside_the_slice_raise(kw, monkeypatch):
    """The Seify dummy source and the CPU block path are ported (ROADMAP
    Queue 1 item 4) and build; what stays outside this machine is the card:
    the device path without one raises instead of falling back to the CPU."""
    import importlib
    source = None if not kw else VectorSource(np.zeros(1000, np.complex64))
    fg, retune, _ = build_flowgraph(source, inst=CPU, **({"use_tpu": True} | kw))
    assert type(retune).__name__ == ("XlatingFir" if kw else "TpuKernel")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(importlib.import_module("futuresdr_tpu_torch.tpu.instance"),
                        "_instance", None)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_flowgraph(source, use_tpu=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_flowgraph(source)        # the card is the default


def test_kernel_chain_flowgraph_matches_jax_tpu_kernel():
    frame = 8000
    data = _fm_iq(3 * frame + 1_234, OFFSET)
    fg = Flowgraph()
    snk = VectorSink(np.float32)
    kern = TpuKernel(_kernel_chain(T), np.complex64, frame_size=frame, inst=CPU)
    fg.connect(VectorSource(data), kern, snk)
    Runtime().run(fg)
    jfg = jfs.Flowgraph()
    jsnk = jblocks.VectorSink(np.float32)
    jfg.connect(jblocks.VectorSource(data),
                JaxTpuKernel(_kernel_chain(J), np.complex64, frame_size=frame), jsnk)
    jfs.Runtime().run(jfg)
    got, ref = snk.items(), jsnk.items()
    assert len(got) == len(ref) == (len(data) - len(data) % 500) * 24 // 500
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("depth", [1, 4])
def test_kernel_chain_null_head_counts_items(depth):
    n = 5 * 8000
    fg = Flowgraph()
    snk = NullSink(np.float32)
    kern = TpuKernel(_kernel_chain(T), np.complex64, frame_size=8000, inst=CPU,
                     frames_in_flight=depth)
    fg.connect(NullSource(np.complex64) >> Head(np.complex64, n) >> kern >> snk)
    Runtime().run(fg)
    assert snk.n_received == n * 24 // 500
    assert kern.frames_dispatched == 5


@pytest.mark.parametrize("chain", ["app", "kernel"])
def test_tuner_retune_mid_stream_matches_resident_chain(chain):
    """``apply_retune("tuner", phase_inc=…)`` between frames: the streamed
    audio equals the resident chain with the retune at the frame the kernel
    reports."""
    frame, n_frames = 8000, 12
    data = _fm_iq(n_frames * frame, OFFSET)
    theta2 = -2 * np.pi * 150e3 / FS

    def stages():
        return front_end_stages(offset=OFFSET) if chain == "app" else _kernel_chain(T)

    fg = Flowgraph()
    snk = VectorSink(np.float32)
    kern = TpuKernel(stages(), np.complex64, frame_size=frame, inst=CPU,
                     frames_in_flight=2)
    fg.connect(VectorSource(data), kern, snk)
    rt = Runtime()
    running = rt.start(fg)
    deadline = time.monotonic() + 30
    while kern.frames_dispatched < 1 and time.monotonic() < deadline:
        time.sleep(0.001)
    at = kern.apply_retune("tuner", phase_inc=theta2)
    running.wait_sync()
    rt.shutdown()
    assert 1 <= at <= n_frames
    pipe = T.Pipeline(stages(), np.complex64)
    fn, carry = pipe.fn(), pipe.init_carry("cpu")
    outs = []
    for i in range(n_frames):
        if i == at:
            carry = pipe.update_stage(carry, "tuner", phase_inc=theta2)
        carry, y = fn(carry, torch.from_numpy(data[i * frame:(i + 1) * frame]))
        outs.append(y.numpy())
    np.testing.assert_allclose(snk.items(), np.concatenate(outs), rtol=0, atol=1e-6)


def test_wav_sink_drains_the_ring_at_eos(tmp_path):
    """Items past the ring's wrap at EOS reach the file."""
    path = str(tmp_path / "t.wav")
    data = (0.5 * np.sin(2 * np.pi * 440 / 8000 * np.arange(100_003))).astype(np.float32)
    fg = Flowgraph()
    sink = WavSink(path, 8000)
    fg.connect(VectorSource(data), sink)
    Runtime().run(fg)
    assert sink.n_written == len(data)
    pcm = _read_wav(path)
    np.testing.assert_allclose(pcm / 32767.0, data, atol=1.0 / 32767)
