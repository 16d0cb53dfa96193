"""The port's I/O blocks (``blocks/io.py``): the cases of
``tests/test_io_blocks.py`` not yet in ``tests/test_torch_io_blocks.py``
(file round trip, TCP pipe, in-process channels) and the UDP case of
``tests/test_transport.py``, each on a free local port; then ``FileSource``
and ``FileSink`` against the JAX package's on the same seeded data, bit for
bit, on the actor path and through the native fast chain.
"""

import socket
import time

import numpy as np
import pytest
import torch

from futuresdr_tpu_torch import Flowgraph, Pmt, Runtime
from futuresdr_tpu_torch.blocks import (BlobToUdp, ChannelSink, ChannelSource, Copy,
                                        FileSink, FileSource, Head, MessageBurst,
                                        TcpSink, TcpSource, UdpSource, VectorSink,
                                        VectorSource)
from futuresdr_tpu_torch.runtime.fastchain import find_native_chains

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_file_roundtrip(tmp_path):
    path = str(tmp_path / "samples.bin")
    data = np.random.default_rng(0).standard_normal(10_000).astype(np.float32)
    fg = Flowgraph()
    fg.connect(VectorSource(data), FileSink(path, np.float32))
    Runtime().run(fg)

    fg2 = Flowgraph()
    src = FileSource(path, np.float32)
    snk = VectorSink(np.float32)
    fg2.connect(src, snk)
    Runtime().run(fg2)
    np.testing.assert_array_equal(snk.items(), data)


def test_tcp_pipe():
    port = free_port()
    data = np.arange(20_000, dtype=np.float32)

    fg_rx = Flowgraph()
    tsrc = TcpSource("127.0.0.1", port, np.float32, listen=True)
    rsnk = VectorSink(np.float32)
    fg_rx.connect(tsrc, rsnk)
    rt_rx = Runtime()
    running_rx = rt_rx.start(fg_rx)

    fg_tx = Flowgraph()
    fg_tx.connect(VectorSource(data), TcpSink("127.0.0.1", port, np.float32))
    Runtime().run(fg_tx)

    running_rx.wait_sync()
    np.testing.assert_array_equal(rsnk.items(), data)


def test_channel_source_sink():
    q_in = None
    fg = Flowgraph()
    src = ChannelSource(np.float32)
    snk = ChannelSink(np.float32)
    fg.connect(src, snk)
    rt = Runtime()
    running = rt.start(fg)

    async def feed():
        await src.queue.put(np.arange(100, dtype=np.float32))
        await src.queue.put(np.arange(100, 200, dtype=np.float32))
        await src.queue.put(None)

    rt.scheduler.run_coro_sync(feed())
    running.wait_sync()

    chunks = []
    async def drain():
        while True:
            c = snk.queue.get_nowait()
            if c is None:
                return
            chunks.append(c)

    rt.scheduler.run_coro_sync(drain())
    np.testing.assert_array_equal(np.concatenate(chunks), np.arange(200, dtype=np.float32))


def test_udp_blob_to_udp_source():
    port = free_port()
    fg_rx = Flowgraph()
    src = UdpSource("127.0.0.1", port, np.uint8)
    head = Head(np.uint8, 3000)
    snk = VectorSink(np.uint8)
    fg_rx.connect(src, head, snk)
    rt = Runtime()
    running = rt.start(fg_rx)
    time.sleep(0.2)

    fg_tx = Flowgraph()
    burst = MessageBurst(Pmt.blob(bytes(range(100)) * 10), 3)
    udp = BlobToUdp("127.0.0.1", port)
    fg_tx.connect_message(burst, "out", udp, "in")
    Runtime().run(fg_tx)

    running.wait_sync()
    got = snk.items()
    assert len(got) == 3000
    np.testing.assert_array_equal(got[:100], np.arange(100, dtype=np.uint8))


def _jax_file_roundtrip(data, path_out, path_in, dtype, monkeypatch, repeat=False):
    """The JAX package's ``VectorSource -> FileSink`` then ``FileSource ->
    VectorSink`` on its actor path; the items read back."""
    import futuresdr_tpu as J
    from futuresdr_tpu import blocks as jb
    monkeypatch.setenv("FSDR_NO_FASTCHAIN", "1")
    fg = J.Flowgraph()
    fg.connect(jb.VectorSource(data), jb.FileSink(path_out, dtype))
    J.Runtime().run(fg)
    fg = J.Flowgraph()
    snk = jb.VectorSink(dtype)
    src = jb.FileSource(path_in, dtype, repeat=repeat)
    if repeat:
        fg.connect(src, jb.Head(dtype, 3 * len(data) + 5), snk)
    else:
        fg.connect(src, snk)
    J.Runtime().run(fg)
    monkeypatch.delenv("FSDR_NO_FASTCHAIN")
    return snk.items()


@pytest.mark.parametrize("native", [False, True], ids=["actor", "native"])
@pytest.mark.parametrize("dtype", [np.float32, np.complex64, np.int16])
def test_file_blocks_equal_the_jax_blocks(tmp_path, monkeypatch, native, dtype):
    """The file the port's ``FileSink`` writes holds the JAX ``FileSink``'s
    bytes, and the port's ``FileSource`` (with and without ``repeat``) reads
    what the JAX one reads; ``native`` runs the port's side as a fused chain
    (the reference's fused file stages: a RAM snapshot, a one-shot flush)."""
    rng = np.random.default_rng(5)
    data = (rng.standard_normal(30_001) * 1000).astype(dtype)
    if dtype == np.complex64:
        data = (data + 1j * rng.standard_normal(30_001)).astype(dtype)
    ref_out = str(tmp_path / "ref.bin")
    want = _jax_file_roundtrip(data, ref_out, ref_out, dtype, monkeypatch)
    want_rep = _jax_file_roundtrip(data, str(tmp_path / "ref2.bin"), ref_out, dtype,
                                   monkeypatch, repeat=True)
    if not native:
        monkeypatch.setenv("FSDR_NO_FASTCHAIN", "1")
    out = str(tmp_path / "port.bin")
    fg = Flowgraph()
    fg.connect(VectorSource(data), Head(dtype, len(data)), FileSink(out, dtype))
    assert len(find_native_chains(fg)) == int(native)
    Runtime().run(fg)
    assert open(out, "rb").read() == open(ref_out, "rb").read()
    for repeat, ref in ((False, want), (True, want_rep)):
        fg = Flowgraph()
        snk = VectorSink(dtype)
        src = FileSource(out, dtype, repeat=repeat)
        if repeat:
            fg.connect(src, Head(dtype, 3 * len(data) + 5), Copy(dtype), snk)
        else:
            fg.connect(src, Copy(dtype), snk)
        assert len(find_native_chains(fg)) == int(native)
        Runtime().run(fg)
        np.testing.assert_array_equal(snk.items(), ref)


def test_file_source_drops_a_trailing_partial_item(tmp_path):
    """A file whose size is not a multiple of the item size ends at the last
    whole item, as in the reference."""
    path = tmp_path / "odd.bin"
    path.write_bytes(np.arange(10, dtype=np.float32).tobytes() + b"\x01\x02")
    fg = Flowgraph()
    snk = VectorSink(np.float32)
    fg.connect(FileSource(str(path), np.float32), snk)
    Runtime().run(fg)
    np.testing.assert_array_equal(snk.items(), np.arange(10, dtype=np.float32))
