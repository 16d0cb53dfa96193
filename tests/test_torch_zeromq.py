"""The port's ZeroMQ blocks: ``tests/test_transport.py::test_zmq_pub_sub_pipe``
and ``tests/test_distributed_wlan.py::test_wlan_over_zmq_between_runtimes``
on the port (its ``WlanEncoder`` and ``WlanDecoder`` on the CPU), the wire
format shared with the JAX package's blocks in both directions, and a
missing pyzmq failing the flowgraph at init with the import error. Every
address takes a port the OS found free.
"""

import socket
import sys
import time

import numpy as np
import pytest
import torch

import futuresdr_tpu as jfs
from futuresdr_tpu_torch import Flowgraph, FlowgraphError, Pmt, Runtime
from futuresdr_tpu_torch.blocks import (Apply, Head, PubSink, SubSource, Throttle,
                                        VectorSink, VectorSource)
from futuresdr_tpu_torch.models.wlan import WlanDecoder, WlanEncoder

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)


def _addr() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def _ramp_pipe(tx_pkg, rx_pkg):
    """A float32 ramp published by ``tx_pkg``'s PubSink, 20,000 items read by
    ``rx_pkg``'s SubSource; the items the receiver got."""
    # PUB/SUB slow-joiner: the SUB only completes its (re)connect some time
    # after the publisher binds, so the TX keeps publishing over wall time,
    # paced by a Throttle, repeating the ramp until the RX Head fills
    ramp = np.arange(10_000, dtype=np.float32)
    addr = _addr()
    b_rx, b_tx = rx_pkg.blocks, tx_pkg.blocks
    fg_rx = rx_pkg.Flowgraph()
    snk = b_rx.VectorSink(np.float32)
    fg_rx.connect(b_rx.SubSource(addr, np.float32), b_rx.Head(np.float32, 20_000), snk)
    rt_rx = rx_pkg.Runtime()
    running_rx = rt_rx.start(fg_rx)

    fg_tx = tx_pkg.Flowgraph()
    fg_tx.connect(b_tx.VectorSource(ramp, repeat=2000), b_tx.Throttle(np.float32, rate=2e5),
                  b_tx.PubSink(addr, np.float32))
    rt_tx = tx_pkg.Runtime()
    running_tx = rt_tx.start(fg_tx)
    running_rx.wait_sync()
    running_tx.stop_sync()
    return snk.items(), len(ramp)


def _contiguous(got, n_ramp):
    assert len(got) == 20_000
    # consecutive values differ by 1 (mod the ramp wrap)
    d = np.diff(got)
    assert np.all((d == 1) | (d == -(n_ramp - 1)))


def test_zmq_pub_sub_pipe():
    import futuresdr_tpu_torch as tfs
    _contiguous(*_ramp_pipe(tfs, tfs))


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_zmq_wire_matches_the_jax_blocks(direction):
    """A message is a slice's raw items in both packages, so either end may
    be the other package's."""
    import futuresdr_tpu_torch as tfs
    tx, rx = (tfs, jfs) if direction == "port_to_jax" else (jfs, tfs)
    _contiguous(*_ramp_pipe(tx, rx))


def test_wlan_over_zmq_between_runtimes():
    addr = _addr()
    rng = np.random.default_rng(0)

    # RX runtime: SUB → noisy channel → WLAN decoder
    fg_rx = Flowgraph()
    sub = SubSource(addr, np.complex64)
    chan = Apply(lambda x: (x + 0.01 * (rng.standard_normal(len(x))
                                        + 1j * rng.standard_normal(len(x)))
                            ).astype(np.complex64), np.complex64)
    dec = WlanDecoder(chunk=1 << 14, device="cpu")
    fg_rx.connect(sub, chan, dec)
    rt_rx = Runtime()
    running_rx = rt_rx.start(fg_rx)

    # TX runtime: encoder → throttle (outlive the ZMQ slow-joiner) → PUB
    fg_tx = Flowgraph()
    enc = WlanEncoder("qpsk_1_2", gap_samples=2000)
    fg_tx.connect(enc, Throttle(np.complex64, rate=3e5), PubSink(addr, np.complex64))
    rt_tx = Runtime()
    running_tx = rt_tx.start(fg_tx)

    payloads = [f"distributed frame {i}".encode() * 3 for i in range(6)]
    deadline = time.time() + 30
    # keep retransmitting until the receiver confirms every payload (PUB/SUB is
    # lossy during join; the set() comparison tolerates the resulting repeats)
    while time.time() < deadline and len(set(dec.frames)) < len(payloads):
        for p in payloads:
            assert running_tx.handle.call_sync(enc, "tx", Pmt.blob(p)) == Pmt.ok()
        time.sleep(1.0)
    got = set(dec.frames)
    running_tx.stop_sync()
    running_rx.stop_sync()
    # the MAC checked each frame's FCS: only intact payloads are in dec.frames
    assert set(payloads).issubset(got), f"missing: {set(payloads) - got}"
    assert got <= set(payloads)


@pytest.mark.parametrize("block", ["pub", "sub"])
def test_missing_pyzmq_fails_the_flowgraph_at_init(monkeypatch, block):
    """The package imports without pyzmq; a ZeroMQ block's init raises the
    import error, and the run fails with it."""
    monkeypatch.setitem(sys.modules, "zmq", None)       # import zmq raises
    fg = Flowgraph()
    if block == "pub":
        fg.connect(VectorSource(np.zeros(16, np.float32)), PubSink(_addr(), np.float32))
    else:
        fg.connect(SubSource(_addr(), np.float32), Head(np.float32, 16),
                   VectorSink(np.float32))
    with pytest.raises(FlowgraphError) as e:
        Runtime().run(fg, timeout=30)
    assert any(isinstance(x, ModuleNotFoundError) and "zmq" in str(x)
               for x in e.value.errors), e.value.errors
