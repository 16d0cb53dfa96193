"""The port's stream buffers: the double-mapped circular buffer beside the ring.

The cases of ``tests/test_buffers.py`` (round trip across the wrap,
broadcast, tag rebasing, a flowgraph on each backend) parametrised over the
pure-Python ``ring`` and the ``circular`` buffer over the port's own
``csrc/host/ringbuf.cpp``; the contiguous window across the wrap; the
capacity rounding (whole pages and whole items, at least the negotiated
capacity); the EOS drain on the circular buffer; the same flowgraph through
the JAX package's buffers; and a streamed ``TpuKernel`` on
``TpuInstance("cpu")`` with equal output on both buffers.
"""

import mmap

import numpy as np
import pytest
import torch

import futuresdr_tpu as jfs
from futuresdr_tpu import blocks as jblocks
from futuresdr_tpu_torch import Flowgraph, Runtime
from futuresdr_tpu_torch.blocks import (Apply, Head, NullSink, NullSource, VectorSink,
                                        VectorSource)
from futuresdr_tpu_torch.dsp import firdes
from futuresdr_tpu_torch.ops import stages as T
from futuresdr_tpu_torch.runtime import default_buffer, flowgraph
from futuresdr_tpu_torch.runtime.buffer import circular, negotiate_capacity
from futuresdr_tpu_torch.runtime.buffer.ring import RingWriter
from futuresdr_tpu_torch.runtime.inbox import BlockInbox
from futuresdr_tpu_torch.runtime.tag import ItemTag, Tag
from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

BACKENDS = {"ring": RingWriter, "circular": circular.CircularWriter}


@pytest.fixture(params=list(BACKENDS))
def backend(request):
    return BACKENDS[request.param]


def test_the_circular_buffer_builds_here_and_is_the_default():
    assert circular.available()
    assert default_buffer() is circular.CircularWriter
    try:        # the reference's process-wide setter
        assert default_buffer(RingWriter) is RingWriter
        fg = Flowgraph()
        src, snk = NullSource(np.float32), NullSink(np.float32)
        fg.connect(src, snk)
        fg.take_blocks()
        assert type(src.stream_outputs[0].writer) is RingWriter
    finally:
        flowgraph._DEFAULT_BUFFER[0] = None
    assert default_buffer() is circular.CircularWriter


def test_spsc_roundtrip_with_wrap(backend):
    wib, rib = BlockInbox(), BlockInbox()
    w = backend(np.float32, 1024, wib)
    r = w.add_reader(rib, 0)
    total = 10_000
    sent = np.arange(total, dtype=np.float32)
    got = []
    n_got = 0
    si = 0
    while n_got < total or si < total:
        s = w.slice()
        if si < total and len(s):
            k = min(len(s), total - si, 100)
            s[:k] = sent[si:si + k]
            w.produce(k)
            si += k
        rs = r.slice()
        if len(rs):
            k = min(len(rs), 37)
            got.append(rs[:k].copy())
            n_got += k
            r.consume(k)
    np.testing.assert_array_equal(np.concatenate(got), sent)


def test_broadcast_two_readers(backend):
    wib, r1ib, r2ib = BlockInbox(), BlockInbox(), BlockInbox()
    w = backend(np.int32, 256, wib)
    r1 = w.add_reader(r1ib, 0)
    r2 = w.add_reader(r2ib, 0)
    s = w.slice()
    n0 = min(100, len(s))
    s[:n0] = np.arange(n0)
    w.produce(n0)
    np.testing.assert_array_equal(r1.slice(), np.arange(n0))
    np.testing.assert_array_equal(r2.slice(), np.arange(n0))
    r1.consume(n0)
    # writer space limited by the slowest reader
    assert w.space_available() == w.capacity - n0


def test_tags_rebase_on_consume(backend):
    wib, rib = BlockInbox(), BlockInbox()
    w = backend(np.float32, 256, wib)
    r = w.add_reader(rib, 0)
    w.slice()[:50] = 0
    w.produce(50, [ItemTag(10, Tag("string", "a")), ItemTag(40, Tag("string", "b"))])
    assert [t.index for t in r.tags()] == [10, 40]
    r.consume(20)
    tags = r.tags()
    assert [t.index for t in tags] == [20]
    assert tags[0].tag.value == "b"


def test_consuming_more_than_available_raises(backend):
    w = backend(np.float32, 256, BlockInbox())
    r = w.add_reader(BlockInbox(), 0)
    w.produce(10)
    with pytest.raises(ValueError, match="more than available"):
        r.consume(11)


def test_detached_reader_frees_the_writer(backend):
    wib = BlockInbox()
    w = backend(np.float32, 256, wib)
    r = w.add_reader(BlockInbox(), 0)
    w.produce(w.space_available())
    assert w.space_available() == 0
    r.notify_finished()
    assert w.space_available() == w.capacity
    assert type(wib.try_recv()).__name__ == "StreamOutputDone"


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.complex64,
                                   np.dtype([("a", "<f4"), ("b", "<f4"), ("c", "<f4")])])
def test_circular_contiguous_across_wrap(dtype):
    """The double mapping gives one contiguous window across the wrap, also
    for an item size (12 bytes) that does not divide the page."""
    dtype = np.dtype(dtype)
    w = circular.CircularWriter(dtype, 4096 // dtype.itemsize, BlockInbox())
    r = w.add_reader(BlockInbox(), 0)
    cap = w.capacity
    assert (cap * dtype.itemsize) % mmap.PAGESIZE == 0
    w.produce(cap - 10)
    r.consume(cap - 10)
    s = w.slice()
    assert len(s) == cap              # the full capacity writable in one window
    raw = np.arange(100 * dtype.itemsize, dtype=np.uint8)
    s[:100] = raw.view(dtype)
    w.produce(100)
    rs = r.slice()
    assert len(rs) == 100
    np.testing.assert_array_equal(rs.view(np.uint8), raw)


@pytest.mark.parametrize("itemsize,windows", [(8, [2048]), (4, [1000, 7]), (12, [3]),
                                              (8, [262_000]), (4, [12_576])])
def test_capacity_rounding_holds_on_both_buffers(itemsize, windows):
    """Negotiation gives a multiple of the largest min_items (the ring's
    slices then never split a window at the wrap) and at least twice it;
    the circular buffer keeps at least that in a whole number of pages and
    of items."""
    dtype = np.dtype([("x", f"V{itemsize}")])
    cap = negotiate_capacity(itemsize, [1] + windows, [0])
    assert cap % max(windows) == 0 and cap >= 2 * max(windows)
    assert RingWriter(dtype, cap, BlockInbox()).capacity == cap
    c = circular.CircularWriter(dtype, cap, BlockInbox())
    assert c.capacity >= cap
    assert (c.capacity * itemsize) % mmap.PAGESIZE == 0
    assert c.capacity * itemsize == c._map.size


def _roundtrip(backend, data):
    fg = Flowgraph()
    src = VectorSource(data)
    cp = Apply(lambda x: x, np.float32)
    snk = VectorSink(np.float32)
    fg.connect_stream(src, "out", cp, "in", buffer=backend)
    fg.connect_stream(cp, "out", snk, "in", buffer=backend)
    Runtime().run(fg)
    assert type(cp.input.reader._w if backend is not RingWriter
                else cp.input.reader._writer) is backend
    return snk.items()


def test_flowgraph_roundtrip_on_backend(backend):
    data = np.random.default_rng(7).random(300_000).astype(np.float32)
    got = _roundtrip(backend, data)
    np.testing.assert_array_equal(got, data)
    fg = jfs.Flowgraph()
    snk = jblocks.VectorSink(np.float32)
    fg.connect(jblocks.VectorSource(data), jblocks.Apply(lambda x: x, np.float32), snk)
    jfs.Runtime().run(fg)
    np.testing.assert_array_equal(got, snk.items())


def test_default_edges_take_the_circular_buffer():
    fg = Flowgraph()
    src, snk = VectorSource(np.arange(10, dtype=np.float32)), VectorSink(np.float32)
    fg.connect(src, snk)
    Runtime().run(fg)
    assert isinstance(src.output.writer, circular.CircularWriter)
    np.testing.assert_array_equal(snk.items(), np.arange(10, dtype=np.float32))


def test_null_sink_drains_to_empty_at_eos_on_the_circular_buffer():
    """EOS arriving with the last items: the sink still counts every item."""
    n = 3 * 32768 + 123
    fg = Flowgraph()
    head, snk = Head(np.complex64, n), NullSink(np.complex64)
    fg.connect(NullSource(np.complex64), head, snk)
    Runtime().run(fg)
    assert isinstance(head.output.writer, circular.CircularWriter)
    assert snk.n_received == n


@pytest.mark.parametrize("k", [1, 2])
def test_streamed_tpu_kernel_equal_on_both_buffers(k):
    taps = firdes.lowpass(0.2, 64).astype(np.float32)
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(9 * 4096 + 777)
         + 1j * rng.standard_normal(9 * 4096 + 777)).astype(np.complex64)
    outs = []
    for backend in (RingWriter, circular.CircularWriter):
        fg = Flowgraph()
        src = VectorSource(x)
        kern = TpuKernel([T.fir_fft_stage(taps, 256), T.mag2_stage()], np.complex64,
                         frame_size=4096, inst=TpuInstance("cpu"), frames_per_dispatch=k)
        snk = VectorSink(np.float32)
        fg.connect_stream(src, "out", kern, "in", buffer=backend)
        fg.connect_stream(kern, "out", snk, "in", buffer=backend)
        Runtime().run(fg)
        assert type(kern.output.writer) is backend
        outs.append(snk.items())
    assert len(outs[0]) == len(outs[1]) == len(x) - len(x) % 256
    np.testing.assert_array_equal(outs[0], outs[1])
