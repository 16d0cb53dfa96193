"""The port's rtl_tcp driver against the JAX package's.

The three cases of ``tests/test_rtl_tcp.py`` on the port (a ``SeifySource``
streaming from a mock rtl_tcp server, a non-RTL server refused, the server's
close finishing the flowgraph), and both packages' ``RtlTcpDriver`` given the
same server bytes: the greeting, an I/Q stream whose first chunk ends on an
odd byte followed by a lull longer than the socket's timeout, then the rest
and the close. Both must send the same command bytes and read bit-equal
samples, the lull as an empty read (not end of stream) and the close as
``None``.
"""

import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from futuresdr_tpu.hw.rtl_tcp import RtlTcpDriver as JaxRtlTcpDriver
from futuresdr_tpu_torch import Flowgraph, Pmt, Runtime
from futuresdr_tpu_torch.blocks import (Head, MessageSink, MessageSource, SeifySource,
                                        VectorSink)
from futuresdr_tpu_torch.hw import Device
from futuresdr_tpu_torch.hw.rtl_tcp import RtlTcpDriver

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)


class MockRtlTcpServer:
    """Speaks the rtl_tcp protocol: greeting, command recording, IQ streaming
    (``tests/test_rtl_tcp.py``'s mock)."""

    def __init__(self, n_samples: int = 100_000):
        self.n_samples = n_samples
        self.commands = []          # (cmd_id, param)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.addr = self.sock.getsockname()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        conn, _ = self.sock.accept()
        conn.sendall(b"RTL0" + struct.pack(">II", 5, 29))
        conn.settimeout(0.5)
        try:
            while len(self.commands) < 3:
                pkt = conn.recv(5)
                if len(pkt) == 5:
                    self.commands.append(struct.unpack(">BI", pkt))
        except socket.timeout:
            pass
        iq = (np.arange(2 * self.n_samples) % 256).astype(np.uint8).tobytes()
        try:
            conn.sendall(iq)
        except (BrokenPipeError, ConnectionResetError):
            pass
        conn.close()
        self.sock.close()


class ScriptedServer:
    """Plays ``script`` (``(bytes, pause_s)`` steps after the greeting) to
    each of ``n_clients`` connections in turn and records every byte each
    client sends."""

    def __init__(self, script, n_clients: int):
        self.script = script
        self.received = []
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(n_clients)
        self.port = self.sock.getsockname()[1]
        self.thread = threading.Thread(target=self._run, args=(n_clients,), daemon=True)
        self.thread.start()

    def _run(self, n_clients):
        for _ in range(n_clients):
            conn, _ = self.sock.accept()
            got = bytearray()
            self.received.append(got)

            def record(conn=conn, got=got):
                while True:
                    try:
                        chunk = conn.recv(4096)
                    except OSError:
                        return
                    if not chunk:
                        return
                    got.extend(chunk)

            rec = threading.Thread(target=record, daemon=True)
            rec.start()
            conn.sendall(b"RTL0" + struct.pack(">II", 5, 29))
            for data, pause in self.script:
                conn.sendall(data)
                time.sleep(pause)
            conn.shutdown(socket.SHUT_WR)
            rec.join(timeout=10)
            conn.close()
        self.sock.close()


def _expected(raw: bytes) -> np.ndarray:
    u = np.frombuffer(raw[:len(raw) // 2 * 2], np.uint8).astype(np.float32)
    u = (u - 127.5) / 127.5
    return (u[0::2] + 1j * u[1::2]).astype(np.complex64)


def _drive(cls, port: int, n: int = 4096):
    """Activate, retune once live, then read until end of stream; the reads
    as a list (an empty array is a read cut short by a lull)."""
    d = cls({"host": "127.0.0.1", "port": str(port), "rate": "2.4e6", "freq": "1e8",
             "gain": "28.0"})
    d.activate_rx()
    d._sock.settimeout(0.2)         # a lull shorter than the test, both drivers alike
    d.set_frequency(101e6)
    reads = []
    while True:
        x = d.read(n)
        if x is None:
            break
        reads.append(x)
    d.deactivate()
    return reads


def test_drivers_agree_on_the_same_server_bytes():
    rng = np.random.default_rng(21)
    raw = rng.integers(0, 256, 2 * 30_000 + 1, dtype=np.uint8).tobytes()
    split = 2 * 1000 + 1            # the first chunk ends on an odd byte
    script = [(raw[:split], 0.6), (raw[split:], 0.0)]
    server = ScriptedServer(script, 2)
    got = _drive(RtlTcpDriver, server.port)
    want = _drive(JaxRtlTcpDriver, server.port)
    server.thread.join(timeout=10)

    g, w = np.concatenate(got), np.concatenate(want)
    assert g.dtype == w.dtype == np.complex64
    assert g.tobytes() == w.tobytes()
    np.testing.assert_array_equal(g, _expected(raw))      # I/Q never swapped
    # the lull: a read that returned nothing, and was not end of stream
    assert any(len(x) == 0 for x in got) and any(len(x) == 0 for x in want)
    # the half pair at the lull's boundary was kept for the next read
    assert sum(map(len, got[:next(i for i, x in enumerate(got) if not len(x))])) == 1000

    assert server.received[0] == server.received[1]
    cmds = [struct.unpack(">BI", bytes(server.received[0][i:i + 5]))
            for i in range(0, len(server.received[0]), 5)]
    assert cmds == [(0x02, 2_400_000), (0x01, 100_000_000), (0x03, 1), (0x04, 280),
                    (0x01, 101_000_000)]


def test_agc_without_gain_and_a_latched_retune():
    """No gain: AGC on; a setter before activation latches, its value sent
    with the activation's commands."""
    server = ScriptedServer([(b"", 0.0)], 2)
    sent = []
    for cls in (RtlTcpDriver, JaxRtlTcpDriver):
        d = cls({"host": "127.0.0.1", "port": str(server.port)})
        d.set_sample_rate(1.024e6)          # no socket yet: latched
        d.activate_rx()
        assert d.read(16) is None           # the server closed: end of stream
        sent.append((d.tuner_type, d.tuner_gain_count))
        d.deactivate()
    server.thread.join(timeout=10)
    assert sent == [(5, 29), (5, 29)]
    assert server.received[0] == server.received[1] == (
        struct.pack(">BI", 0x02, 1_024_000) + struct.pack(">BI", 0x01, 100_000_000)
        + struct.pack(">BI", 0x08, 1))


def test_seify_source_streams_from_rtl_tcp():
    server = MockRtlTcpServer()
    n = 8192
    src = SeifySource(args=f"driver=rtl_tcp,host=127.0.0.1,port={server.addr[1]}",
                      sample_rate=2_400_000, frequency=100_000_000, gain=28.0)
    assert isinstance(src.device.driver, RtlTcpDriver)
    head = Head(np.complex64, n)
    snk = VectorSink(np.complex64)
    fg = Flowgraph()
    fg.connect(src, head, snk)
    Runtime().run(fg)
    server.thread.join(timeout=5)

    got = snk.items()
    assert len(got) == n
    u = (np.arange(2 * n) % 256).astype(np.float32)
    expect = ((u[0::2] - 127.5) / 127.5 + 1j * (u[1::2] - 127.5) / 127.5)
    np.testing.assert_allclose(got, expect.astype(np.complex64), atol=1e-6)

    cmds = {c for c, _ in server.commands}
    assert 0x02 in cmds, f"no sample-rate command, got {server.commands}"
    by_cmd = dict((c, p) for c, p in server.commands)
    assert by_cmd.get(0x02) == 2_400_000
    assert by_cmd.get(0x01) == 100_000_000


def test_rtl_tcp_rejects_non_rtl_server():
    """A server with the wrong magic is refused with a clear error."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.bind(("127.0.0.1", 0))
    sock.listen(1)
    addr = sock.getsockname()

    def bad_server():
        conn, _ = sock.accept()
        conn.sendall(b"HTTP" + bytes(8))
        conn.close()
        sock.close()

    t = threading.Thread(target=bad_server, daemon=True)
    t.start()
    d = Device(f"driver=rtl_tcp,host=127.0.0.1,port={addr[1]}").driver
    with pytest.raises(ConnectionError, match="not an rtl_tcp server"):
        d.activate_rx()
    t.join(timeout=5)


def test_rtl_tcp_server_disconnect_finishes_flowgraph():
    """Server closing the stream is EOS, not a busy-spin: the flowgraph finishes."""
    server = MockRtlTcpServer(n_samples=20_000)
    src = SeifySource(args=f"driver=rtl_tcp,host=127.0.0.1,port={server.addr[1]}",
                      sample_rate=1_000_000)
    snk = VectorSink(np.complex64)
    fg = Flowgraph()
    fg.connect(src, snk)
    Runtime().run(fg, timeout=60)         # returns only if EOS propagates
    got = snk.items()
    assert len(got) == 20_000             # the port reads once a port: nothing dropped
    np.testing.assert_array_equal(got, _expected(
        (np.arange(40_000) % 256).astype(np.uint8).tobytes()))


def test_a_silent_radio_blocks_its_own_thread_not_the_runtime():
    """``SeifySource`` is a blocking block: while its read waits on a silent
    server, a message pipeline of the same flowgraph runs to its end; the
    stream, sent in parts with pauses and an odd byte at a boundary, comes
    through whole, and the close ends it."""
    rng = np.random.default_rng(7)
    raw = rng.integers(0, 256, 2 * 5_000, dtype=np.uint8).tobytes()
    server = ScriptedServer([(b"", 2.0), (raw[:1001], 0.3), (raw[1001:], 0.0)], 1)
    src = SeifySource(args=f"driver=rtl_tcp,host=127.0.0.1,port={server.port}")
    snk = VectorSink(np.complex64)
    msnk = MessageSink()
    fg = Flowgraph()
    fg.connect(src, snk)
    fg.connect_message(MessageSource(Pmt.usize(1), 0.01, count=20), "out", msnk, "in")
    rt = Runtime()
    running = rt.start(fg)
    deadline = time.monotonic() + 1.5
    while len(msnk.received) < 20 and time.monotonic() < deadline:
        time.sleep(0.01)
    early = (len(msnk.received), len(snk.items()))
    running.wait_sync(timeout=60)
    server.thread.join(timeout=10)
    assert early == (20, 0), early      # the messages ran while the radio was silent
    np.testing.assert_array_equal(snk.items(), _expected(raw))
