"""ZeroMQ transport blocks: host-to-host flowgraph distribution.

A copy of ``futuresdr_tpu/blocks/zeromq.py`` (reference:
``src/blocks/zeromq/{pub_sink,sub_source}.rs``, the reference's inter-process
distribution story, SURVEY §2.7): PUB/SUB sample streams between runtimes.
``zmq`` (pyzmq) is imported when a block is initialised, as in the
reference, never when the package is: without pyzmq the flowgraph fails at
its init barrier with the import error.
"""

from __future__ import annotations

import numpy as np

from ..log import logger
from ..runtime.kernel import Kernel

__all__ = ["PubSink", "SubSource"]

log = logger("blocks.zeromq")


class PubSink(Kernel):
    """Publish stream chunks on a ZMQ PUB socket (`zeromq/pub_sink.rs`): one
    message a contiguous slice of the input."""

    def __init__(self, address: str, dtype):
        super().__init__()
        self.address = address
        self._sock = None
        self.input = self.add_stream_input("in", dtype)

    async def init(self, mio, meta):
        import zmq
        self._sock = zmq.Context.instance().socket(zmq.PUB)
        self._sock.bind(self.address)

    async def deinit(self, mio, meta):
        if self._sock is not None:
            self._sock.close(linger=0)
            self._sock = None

    async def work(self, io, mio, meta):
        # the ring's slices stop at its wrap: send until nothing is left, so
        # items past the wrap that came with EOS are not left behind
        finished = self.input.finished()
        while True:
            inp = self.input.slice()
            if not len(inp):
                break
            self._sock.send(inp.tobytes(), copy=True)
            self.input.consume(len(inp))
        if finished:
            io.finished = True


class SubSource(Kernel):
    """Subscribe to a ZMQ stream (`zeromq/sub_source.rs`); a message's bytes
    that do not fit the output window wait for the next call, before any
    further message is received."""

    BLOCKING = True  # zmq recv blocks its own thread, like #[blocking] hardware blocks

    def __init__(self, address: str, dtype, timeout_ms: int = 100):
        super().__init__()
        self.address = address
        self.timeout_ms = timeout_ms
        self._sock = None
        self._tail = b""
        self.output = self.add_stream_output("out", dtype)

    async def init(self, mio, meta):
        import zmq
        self._sock = zmq.Context.instance().socket(zmq.SUB)
        self._sock.connect(self.address)
        self._sock.setsockopt(zmq.SUBSCRIBE, b"")
        self._sock.setsockopt(zmq.RCVTIMEO, self.timeout_ms)

    async def deinit(self, mio, meta):
        if self._sock is not None:
            self._sock.close(linger=0)
            self._sock = None

    async def work(self, io, mio, meta):
        import zmq
        out = self.output.slice()
        if len(out) == 0:
            return
        itemsize = self.output.dtype.itemsize
        if len(self._tail) < itemsize:
            try:
                data = self._sock.recv()
            except zmq.Again:
                io.call_again = True   # poll again (dedicated thread; cheap)
                return
            self._tail += data
        k = min(len(self._tail) // itemsize, len(out))
        if k:
            out[:k] = np.frombuffer(self._tail[:k * itemsize], dtype=self.output.dtype)
            self.output.produce(k)
        self._tail = self._tail[k * itemsize:]
        io.call_again = True
