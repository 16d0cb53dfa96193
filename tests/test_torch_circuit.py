"""The port's host-frame circuit (``runtime/buffer/circuit.py`` ``Circuit`` and
``Flowgraph.close_circuit``): the cases of ``tests/test_circuit.py`` on the
port (a zero-copy pipeline of mutating blocks, backpressure by the pool,
idempotent reconnection and the refused broadcast of a writable host frame),
then the same pipeline's frames against the JAX package's, bit for bit.
"""

import numpy as np
import torch

from futuresdr_tpu_torch import Flowgraph, Kernel, Runtime
from futuresdr_tpu_torch.runtime.buffer.circuit import Circuit

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)


class InplaceSource(Kernel):
    """Fills empty circuit frames with a ramp, n_frames times."""

    def __init__(self, circuit: Circuit, n_frames: int):
        super().__init__()
        self.circuit = circuit
        self.n_frames = n_frames
        self._sent = 0
        self.output = self.add_inplace_output("out", np.float32)

    async def work(self, io, mio, meta):
        while self._sent < self.n_frames:
            buf = self.circuit.get_empty()
            if buf is None:
                return          # wait: put_empty() notifies us
            buf[:] = np.arange(len(buf), dtype=np.float32) + self._sent
            self.output.put_full(buf, len(buf))
            self._sent += 1
        io.finished = True


class InplaceAdd(Kernel):
    """Mutates frames in place (+offset) and forwards them."""

    def __init__(self, offset: float):
        super().__init__()
        self.offset = offset
        self.input = self.add_inplace_input("in", np.float32)
        self.output = self.add_inplace_output("out", np.float32)

    async def work(self, io, mio, meta):
        while True:
            item = self.input.get_full()
            if item is None:
                break
            buf, n, _tags = item
            buf[:n] += self.offset
            self.output.put_full(buf, n)
        if self.input.finished() and len(self.input) == 0:
            io.finished = True


class InplaceSink(Kernel):
    """Checks frames and returns them to the circuit."""

    def __init__(self, circuit: Circuit):
        super().__init__()
        self.circuit = circuit
        self.received = []
        self.input = self.add_inplace_input("in", np.float32)

    async def work(self, io, mio, meta):
        while True:
            item = self.input.get_full()
            if item is None:
                break
            buf, n, _tags = item
            self.received.append(buf[:n].copy())
            self.circuit.put_empty(buf)
        if self.input.finished() and len(self.input) == 0:
            io.finished = True


def test_circuit_pipeline_zero_copy():
    circuit = Circuit(n_buffers=3, items_per_buffer=256, dtype=np.float32)
    fg = Flowgraph()
    src = InplaceSource(circuit, n_frames=50)
    add1 = InplaceAdd(10.0)
    add2 = InplaceAdd(100.0)
    snk = InplaceSink(circuit)
    fg.connect_inplace(src, "out", add1, "in")
    fg.connect_inplace(add1, "out", add2, "in")
    fg.connect_inplace(add2, "out", snk, "in")
    fg.close_circuit(circuit, src)
    Runtime().run(fg)
    assert len(snk.received) == 50
    for i, frame in enumerate(snk.received):
        np.testing.assert_array_equal(frame, np.arange(256, dtype=np.float32) + i + 110.0)


def test_circuit_backpressure():
    """With fewer buffers than frames, the source must recycle (backpressure works)."""
    circuit = Circuit(n_buffers=2, items_per_buffer=64, dtype=np.float32)
    fg = Flowgraph()
    src = InplaceSource(circuit, n_frames=20)
    snk = InplaceSink(circuit)
    fg.connect_inplace(src, "out", snk, "in")
    fg.close_circuit(circuit, src)
    Runtime().run(fg)
    assert len(snk.received) == 20


def test_inplace_reconnect_idempotent_and_mutable_broadcast_refused():
    """Re-materializing the same flowgraph re-connects the same peer — the
    port must not double-register it (frames would push twice and the
    broadcast guard would misfire on a single-reader circuit). A GENUINE
    broadcast of a writable host frame still refuses (mutable circuit frames
    are single-reader; immutable device-plane frames may broadcast)."""
    import numpy as np
    import pytest

    from futuresdr_tpu_torch.runtime.buffer.circuit import InplaceInput, InplaceOutput

    op, ip = InplaceOutput("out"), InplaceInput("in")
    op.connect(ip)
    op.connect(ip)                      # rerun of the same flowgraph
    buf = np.zeros(4, np.float32)
    op.put_full(buf, 4)                 # single reader: no raise, ONE frame
    assert len(ip) == 1 and op.queue_depth() == 1
    ip2 = InplaceInput("in2")
    op.connect(ip2)                     # genuine second consumer
    with pytest.raises(RuntimeError, match="single-reader"):
        op.put_full(buf, 4)
    buf.flags.writeable = False         # immutable frames broadcast fine
    op.put_full(buf, 4)
    assert len(ip) == 2 and len(ip2) == 1


def _classes(K):
    """This file's source, add and sink blocks on base class ``K``."""

    class Src(K):
        def __init__(self, circuit, n_frames):
            K.__init__(self)
            self.circuit, self.n_frames, self._sent = circuit, n_frames, 0
            self.output = self.add_inplace_output("out", np.float32)

        async def work(self, io, mio, meta):
            while self._sent < self.n_frames:
                buf = self.circuit.get_empty()
                if buf is None:
                    return
                buf[:] = np.sin(np.arange(len(buf), dtype=np.float32) * (self._sent + 1))
                self.output.put_full(buf, len(buf))
                self._sent += 1
            io.finished = True

    class Add(K):
        def __init__(self, offset):
            K.__init__(self)
            self.offset = np.float32(offset)
            self.input = self.add_inplace_input("in", np.float32)
            self.output = self.add_inplace_output("out", np.float32)

        async def work(self, io, mio, meta):
            while (item := self.input.get_full()) is not None:
                buf, n, _ = item
                buf[:n] = buf[:n] * np.float32(0.5) + self.offset
                self.output.put_full(buf, n)
            if self.input.finished() and len(self.input) == 0:
                io.finished = True

    class Snk(K):
        def __init__(self, circuit):
            K.__init__(self)
            self.circuit, self.received = circuit, []
            self.input = self.add_inplace_input("in", np.float32)

        async def work(self, io, mio, meta):
            while (item := self.input.get_full()) is not None:
                buf, n, _ = item
                self.received.append(buf[:n].copy())
                self.circuit.put_empty(buf)
            if self.input.finished() and len(self.input) == 0:
                io.finished = True

    return Src, Add, Snk


def _run_pipeline(pkg, n_buffers, n_frames, offsets):
    """A source -> adds -> sink circuit of ``pkg``'s blocks; its frames."""
    import importlib
    top = importlib.import_module(pkg)
    C = importlib.import_module(pkg + ".runtime.buffer.circuit").Circuit
    Src, Add, Snk = _classes(top.Kernel)
    circuit = C(n_buffers=n_buffers, items_per_buffer=128, dtype=np.float32)
    fg = top.Flowgraph()
    src = Src(circuit, n_frames)
    last = src
    for off in offsets:
        add = Add(off)
        fg.connect_inplace(last, "out", add, "in")
        last = add
    snk = Snk(circuit)
    fg.connect_inplace(last, "out", snk, "in")
    fg.close_circuit(circuit, src)
    top.Runtime().run(fg)
    return snk.received


def test_circuit_frames_equal_the_jax_package():
    port = _run_pipeline("futuresdr_tpu_torch", 2, 30, (1.5, -0.25, 8.0))
    ref = _run_pipeline("futuresdr_tpu", 2, 30, (1.5, -0.25, 8.0))
    assert len(port) == len(ref) == 30
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p, r)
