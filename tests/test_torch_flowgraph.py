"""The port's streamed path against the JAX package's, on the CPU.

``VectorSource -> TpuKernel -> VectorSink`` runs the same numpy stream
(ending in a partial frame) through the port's runtime and the JAX one: the
same item count and the same values at the chain's tolerance. The port's
runtime also counts ``NullSource -> Head -> TpuKernel -> NullSink``, applies a
retune mid-stream and turns a block error into a FlowgraphError.
"""

import asyncio
import time

import numpy as np
import pytest
import torch

import futuresdr_tpu as jfs
from futuresdr_tpu import blocks as jblocks
from futuresdr_tpu.ops import stages as J
from futuresdr_tpu.tpu import TpuKernel as JaxTpuKernel
from futuresdr_tpu_torch import Flowgraph, FlowgraphError, Kernel, Runtime
from futuresdr_tpu_torch.blocks import (Head, NullSink, NullSource, VectorSink,
                                        VectorSource)
from futuresdr_tpu_torch.dsp import firdes
from futuresdr_tpu_torch.ops import stages as T
from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

TAPS = firdes.lowpass(0.2, 64).astype(np.float32)
FRAME = 8192
CPU = TpuInstance("cpu")


def _chain(m, route):
    if route == "fused":
        return [m.fir_fft_stage(TAPS, 256), m.mag2_stage()]
    return [m.fir_stage(TAPS, fft_len=1024), m.fft_stage(256), m.mag2_stage()]


def _stream(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


def _run_port(stages, data, **kw):
    fg = Flowgraph()
    snk = VectorSink(np.float32)
    kern = TpuKernel(stages, np.complex64, frame_size=FRAME, inst=CPU, **kw)
    fg.connect(VectorSource(data), kern, snk)
    Runtime().run(fg)
    return snk.items(), kern


def _run_jax(stages, data):
    fg = jfs.Flowgraph()
    snk = jblocks.VectorSink(np.float32)
    fg.connect(jblocks.VectorSource(data), JaxTpuKernel(stages, np.complex64,
                                                        frame_size=FRAME), snk)
    jfs.Runtime().run(fg)
    return snk.items()


@pytest.mark.parametrize("route", ["os", "fused"])
def test_vector_flowgraph_matches_jax_tpu_kernel(route):
    """Three full frames and a partial one: the tail's whole frame_multiple
    prefix is emitted, the rest dropped, by both packages."""
    data = _stream(1, 3 * FRAME + 3 * 256 + 100)
    got, kern = _run_port(_chain(T, route), data)
    ref = _run_jax(_chain(J, route), data)
    fm = kern.pipeline.frame_multiple
    assert len(got) == len(ref) == len(data) - (len(data) - 3 * FRAME) % fm
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-2)


def test_null_head_flowgraph_counts_items():
    n = 5 * FRAME
    for depth in (1, 4):
        fg = Flowgraph()
        snk = NullSink(np.float32)
        kern = TpuKernel(_chain(T, "fused"), np.complex64, frame_size=FRAME, inst=CPU,
                         frames_in_flight=depth)
        fg.connect(NullSource(np.complex64) >> Head(np.complex64, n) >> kern >> snk)
        Runtime().run(fg)
        assert snk.n_received == n
        assert kern.frames_dispatched == 5


def test_retune_mid_stream_matches_resident_chain():
    """apply_retune swaps the taps between frames; the streamed output equals
    the resident chain with the swap at the frame the kernel reports."""
    n_frames = 12
    data = _stream(2, n_frames * FRAME)
    new_taps = firdes.lowpass(0.05, 64).astype(np.float32)
    fg = Flowgraph()
    snk = VectorSink(np.float32)
    kern = TpuKernel(_chain(T, "fused"), np.complex64, frame_size=FRAME, inst=CPU,
                     frames_in_flight=2)
    fg.connect(VectorSource(data), kern, snk)
    rt = Runtime()
    running = rt.start(fg)
    deadline = time.monotonic() + 30
    while kern.frames_dispatched < 1 and time.monotonic() < deadline:
        time.sleep(0.001)
    at = kern.apply_retune(0, taps=new_taps)
    running.wait_sync()
    rt.shutdown()
    assert 1 <= at <= n_frames
    pipe = T.Pipeline(_chain(T, "fused"), np.complex64)
    fn, carry = pipe.fn(), pipe.init_carry("cpu")
    outs = []
    for i in range(n_frames):
        if i == at:
            carry = pipe.update_stage(carry, 0, taps=new_taps)
        carry, y = fn(carry, torch.from_numpy(data[i * FRAME:(i + 1) * FRAME]))
        outs.append(y.numpy())
    np.testing.assert_allclose(snk.items(), np.concatenate(outs), rtol=1e-6, atol=1e-6)


def test_retune_before_init_raises():
    kern = TpuKernel(_chain(T, "os"), np.complex64, frame_size=FRAME, inst=CPU)
    with pytest.raises(RuntimeError):
        kern.apply_retune(0, taps=TAPS)


@pytest.mark.parametrize("phase", ["init", "work"])
def test_block_error_ends_the_flowgraph(phase):
    class Boom(Kernel):
        def __init__(self):
            super().__init__()
            self.input = self.add_stream_input("in", np.complex64)

        async def init(self, mio, meta):
            if phase == "init":
                raise ValueError("boom")

        async def work(self, io, mio, meta):
            raise ValueError("boom")

    fg = Flowgraph()
    fg.connect(NullSource(np.complex64), Boom())
    with pytest.raises(FlowgraphError, match="boom"):
        Runtime().run(fg)


def test_init_error_behind_a_slow_init_ends_the_flowgraph():
    """A block that fails in init while another is still initializing: the
    late Initialized report must not be booked as a block's end."""
    class Boom(Kernel):
        def __init__(self):
            super().__init__()
            self.input = self.add_stream_input("in", np.float32)

        async def init(self, mio, meta):
            raise ValueError("boom")

    class SlowInit(Kernel):
        BLOCKING = True                 # its own thread, as TpuKernel

        def __init__(self):
            super().__init__()
            self.input = self.add_stream_input("in", np.complex64)
            self.output = self.add_stream_output("out", np.float32)

        async def init(self, mio, meta):
            time.sleep(0.2)

    fg = Flowgraph()
    fg.connect(NullSource(np.complex64), SlowInit(), Boom())
    with pytest.raises(FlowgraphError, match="boom"):
        Runtime().run(fg)


@pytest.mark.parametrize("sink", ["null", "vector"])
def test_sink_drains_past_the_ring_wrap_when_eos_comes_with_the_last_items(sink):
    """The state of the streamed stall, forced: the writer's last items lie
    before and past the ring's wrap and its EOS is already in the sink's
    inbox when the sink wakes. One work call must drain both sides of the
    wrap and finish: the writer is done and wakes the sink no more."""
    from futuresdr_tpu_torch.runtime.buffer.ring import RingWriter
    from futuresdr_tpu_torch.runtime.inbox import BlockInbox
    from futuresdr_tpu_torch.runtime.work_io import WorkIo

    snk = NullSink(np.float32) if sink == "null" else VectorSink(np.float32)
    ring = RingWriter(np.float32, 8, BlockInbox())
    snk.input.reader = ring.add_reader(BlockInbox(), 0)
    ring.slice()[:6] = np.arange(6)
    ring.produce(6)
    snk.input.consume(6)                    # the reader sits 2 items before the wrap
    for part in (np.arange(6, 8), np.arange(8, 11)):
        out = ring.slice()                  # the writer's slices stop at the wrap too
        out[:len(part)] = part
        ring.produce(len(part))
    ring.notify_finished()
    snk.input.set_finished()                # StreamInputDone, taken in the same wake
    assert len(snk.input.slice()) == 2      # one slice reaches the wrap only
    io = WorkIo()
    asyncio.run(snk.work(io, None, snk.meta))
    assert io.finished
    assert snk.input.available() == 0
    if sink == "null":
        assert snk.n_received == 5
    else:
        np.testing.assert_array_equal(snk.items(), np.arange(6, 11, dtype=np.float32))
