"""Per-edge and per-port buffer sizing and choice, held against the JAX
package: ``tests/test_buffers.py``'s ``test_per_edge_buffer_size_override``
and ``test_preferred_buffer_size_port_hint`` on the port, then the same
graphs built in both packages, whose negotiated capacities must be equal on
the ring and on the double-mapped circular buffer; the broadcast conflict;
the output port's buffer class; a run through short queues; and the
latency profile's chain (``docs/performance.md``) through a ``TpuKernel``
on the CPU, sized by the rule in both packages.
"""

import numpy as np
import pytest
import torch

import futuresdr_tpu as jfs
from futuresdr_tpu import blocks as jblocks
from futuresdr_tpu.runtime import kernel as jkernel
from futuresdr_tpu.runtime.buffer import circular as jcircular
from futuresdr_tpu.runtime.buffer import ring as jring
from futuresdr_tpu.runtime.flowgraph import ConnectError as JConnectError
from futuresdr_tpu_torch import Flowgraph, Runtime
from futuresdr_tpu_torch import blocks
from futuresdr_tpu_torch.runtime import kernel
from futuresdr_tpu_torch.runtime.buffer import circular, ring
from futuresdr_tpu_torch.runtime.flowgraph import ConnectError

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

#: one namespace a package, so one graph builder serves both
PORT = dict(Flowgraph=Flowgraph, blocks=blocks, Kernel=kernel.Kernel,
            ring=ring.RingWriter, circular=circular.CircularWriter,
            ConnectError=ConnectError)
JAX = dict(Flowgraph=jfs.Flowgraph, blocks=jblocks, Kernel=jkernel.Kernel,
           ring=jring.RingWriter, circular=jcircular.CircularWriter,
           ConnectError=JConnectError)
BUFFERS = ("ring", "circular")


def _port_block(pkg, *, out=None, inp=None):
    """A float32 pass-through of ``pkg`` whose ports take ``out`` and ``inp``
    as keyword arguments of ``add_stream_output``/``add_stream_input``."""

    class _Block(pkg["Kernel"]):
        def __init__(self):
            super().__init__()
            self.input = self.add_stream_input("in", np.float32, **(inp or {}))
            self.output = self.add_stream_output("out", np.float32, **(out or {}))

        async def work(self, io, mio, meta):
            n = min(self.input.available(), self.output.space())
            self.output.slice()[:n] = self.input.slice()[:n]
            self.input.consume(n)
            self.output.produce(n)
            if self.input.finished() and not self.input.available():
                io.finished = True

    return _Block()


#: case -> (the middle block's port keywords, the keywords of the edge into
#: it, of the edge out of it), and the capacities in items the rule gives
#: the graph's three edges (elsewhere the config's 256 KiB of float32)
CASES = {
    "edge_override": (dict(), dict(buffer_size=16384), {}, [65536, 4096, 65536]),
    "input_preference": (dict(inp=dict(preferred_buffer_size=8192)), {}, {},
                         [65536, 2048, 65536]),
    # the smaller of the output's and the input's preferences wins
    "output_preference": (dict(out=dict(preferred_buffer_size=4096),
                               inp=dict(preferred_buffer_size=8192)), {}, {},
                          [65536, 2048, 1024]),
    "override_beats_preferences": (dict(out=dict(preferred_buffer_size=4096),
                                        inp=dict(preferred_buffer_size=8192)),
                                   dict(buffer_size=65536), dict(buffer_size=1 << 20),
                                   [65536, 16384, 262144]),
    "min_items_floor": (dict(inp=dict(min_items=8192)), dict(buffer_size=16384), {},
                        [65536, 16384, 65536]),
    "min_buffer_size_floor": (dict(out=dict(min_buffer_size=1 << 17)), {},
                              dict(buffer_size=1024), [65536, 65536, 32768]),
}


def _capacities(pkg, case: str, buffer: str):
    """NullSource -> Head -> the case's block -> NullSink on ``buffer``;
    the three edges' capacities once materialized."""
    ports, into, out_of, _ = CASES[case]
    b, cls = pkg["blocks"], pkg[buffer]
    fg = pkg["Flowgraph"]()
    src, head = b.NullSource(np.float32), b.Head(np.float32, 100_000)
    blk = _port_block(pkg, **ports)
    fg.connect_stream(src, "out", head, "in", buffer=cls)
    fg.connect_stream(head, "out", blk, "in", buffer=cls, **into)
    fg.connect_stream(blk, "out", b.NullSink(np.float32), "in", buffer=cls, **out_of)
    fg._materialize()
    writers = [o.stream_outputs[0].writer for o in (src, head, blk)]
    assert all(type(w) is cls for w in writers)
    return [w.capacity for w in writers]


def test_per_edge_buffer_size_override():
    """connect_stream(buffer_size=...) bounds the negotiated capacity."""
    fg = Flowgraph()
    src, head = blocks.NullSource(np.float32), blocks.Head(np.float32, 100_000)
    cp, snk = blocks.Copy(np.float32), blocks.NullSink(np.float32)
    fg.connect_stream(src, "out", head, "in")
    fg.connect_stream(head, "out", cp, "in", buffer_size=16384)
    fg.connect_stream(cp, "out", snk, "in")
    fg._materialize()
    small = head.stream_outputs[0].writer.capacity
    big = src.stream_outputs[0].writer.capacity
    assert small == 16384 // 4          # 4096 float32 items
    assert big > small                  # other edges keep the config default


def test_preferred_buffer_size_port_hint():
    """A port's preferred_buffer_size shortens its edge unless overridden."""
    fg = Flowgraph()
    src, head = blocks.NullSource(np.float32), blocks.Head(np.float32, 1000)
    snk = _port_block(PORT, inp=dict(preferred_buffer_size=8192))
    fg.connect_stream(src, "out", head, "in")
    fg.connect_stream(head, "out", snk, "in")
    fg._materialize()
    assert head.stream_outputs[0].writer.capacity == 8192 // 4


@pytest.mark.parametrize("buffer", BUFFERS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_capacities_equal_the_jax_package_and_the_rule(case, buffer):
    port = _capacities(PORT, case, buffer)
    assert port == _capacities(JAX, case, buffer)
    assert port == CASES[case][-1]


@pytest.mark.parametrize("pkg", [PORT, JAX], ids=["port", "jax"])
def test_conflicting_overrides_on_a_broadcast_output_raise(pkg):
    b = pkg["blocks"]
    fg = pkg["Flowgraph"]()
    head = b.Head(np.float32, 1000)
    fg.connect_stream(b.NullSource(np.float32), "out", head, "in")
    fg.connect_stream(head, "out", b.NullSink(np.float32), "in", buffer_size=16384)
    fg.connect_stream(head, "out", b.NullSink(np.float32), "in", buffer_size=32768)
    with pytest.raises(pkg["ConnectError"], match="buffer_size"):
        fg._materialize()


@pytest.mark.parametrize("buffer", BUFFERS)
def test_agreeing_overrides_size_one_broadcast_buffer(buffer):
    caps = []
    for pkg in (PORT, JAX):
        b = pkg["blocks"]
        fg = pkg["Flowgraph"]()
        head = b.Head(np.float32, 1000)
        fg.connect_stream(b.NullSource(np.float32), "out", head, "in")
        for _ in range(2):
            fg.connect_stream(head, "out", b.NullSink(np.float32), "in",
                              buffer=pkg[buffer], buffer_size=8192)
        fg._materialize()
        caps.append(head.stream_outputs[0].writer.capacity)
    assert caps == [2048, 2048]


@pytest.mark.parametrize("pkg", [PORT, JAX], ids=["port", "jax"])
def test_the_output_ports_buffer_class_yields_to_the_edges(pkg):
    """The writer class is the edge's, else the output port's, else the
    process default."""
    b = pkg["blocks"]
    fg = pkg["Flowgraph"]()
    src = b.NullSource(np.float32)
    wants_ring = _port_block(pkg, out=dict(buffer=pkg["ring"]))
    edge_wins = _port_block(pkg, out=dict(buffer=pkg["ring"]))
    head = b.Head(np.float32, 1000)
    fg.connect(src, head)
    fg.connect_stream(head, "out", wants_ring, "in")
    fg.connect_stream(wants_ring, "out", edge_wins, "in")
    fg.connect_stream(edge_wins, "out", b.NullSink(np.float32), "in",
                      buffer=pkg["circular"])
    fg._materialize()
    assert type(head.stream_outputs[0].writer) is pkg["circular"]    # the default
    assert type(wants_ring.stream_outputs[0].writer) is pkg["ring"]
    assert type(edge_wins.stream_outputs[0].writer) is pkg["circular"]


@pytest.mark.parametrize("buffer", BUFFERS)
def test_short_queues_carry_the_stream_unchanged(buffer):
    """Every edge at its floor (16 KiB, a 4 KiB output preference) carries
    the data bit for bit, with a preference on the source's output."""
    x = np.random.default_rng(0).standard_normal(200_003).astype(np.float32)
    fg = Flowgraph()
    src = blocks.VectorSource(x)
    mid = _port_block(PORT, out=dict(preferred_buffer_size=4096))
    snk = blocks.VectorSink(np.float32)
    cls = PORT[buffer]
    fg.connect_stream(src, "out", mid, "in", buffer=cls, buffer_size=16384)
    fg.connect_stream(mid, "out", snk, "in", buffer=cls)
    Runtime().run(fg)
    assert mid.stream_outputs[0].writer.capacity == 1024
    np.testing.assert_array_equal(np.asarray(snk.items()), x)


FRAME = 4096
DEPTH = 2


def _latency_chain(pkg, x, taps, sized: bool):
    """``docs/performance.md``'s latency profile on the CPU:
    VectorSource -> LatencyProbeSource -> TpuKernel(fir) -> LatencyProbeSink,
    the kernel's output also to a VectorSink; ``sized``: 16 KiB on the edges
    around the kernel. Returns the flowgraph, the three buffers' writer
    owners, the probe sink and the vector sink."""
    if pkg is PORT:
        from futuresdr_tpu_torch.ops.stages import fir_stage
        from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
        from futuresdr_tpu_torch.utils.trace import LatencyProbeSink, LatencyProbeSource
        inst = dict(inst=TpuInstance("cpu"))
    else:
        from futuresdr_tpu.ops.stages import fir_stage
        from futuresdr_tpu.tpu import TpuKernel
        from futuresdr_tpu.utils.trace import LatencyProbeSink, LatencyProbeSource
        inst = {}
    fg = pkg["Flowgraph"]()
    src = pkg["blocks"].VectorSource(x)
    probe = LatencyProbeSource(np.complex64, granularity=FRAME)
    tk = TpuKernel([fir_stage(taps, impl="pallas")], np.complex64, frame_size=FRAME,
                   frames_in_flight=DEPTH, wire="f32", **inst)
    lat, vec = LatencyProbeSink(np.complex64), pkg["blocks"].VectorSink(np.complex64)
    kw = dict(buffer_size=16384) if sized else {}
    fg.connect_stream(src, "out", probe, "in")
    fg.connect_stream(probe, "out", tk, "in", **kw)
    fg.connect_stream(tk, "out", lat, "in", **kw)
    fg.connect_stream(tk, "out", vec, "in", **kw)
    return fg, [src, probe, tk], lat, vec


def test_the_latency_profile_chain_sizes_as_the_jax_package():
    """Each edge of both sizings takes the capacity the JAX package's rule
    gives the same graph, recomputed here from the ports: the override holds
    where it is above the kernel's floors (its input's 2 frames, its
    output's depth + 1 frames)."""
    taps = np.hanning(16).astype(np.float32)
    x = np.zeros(FRAME, np.complex64)
    for sized in (False, True):
        caps = []
        for pkg in (PORT, JAX):
            fg, owners, _, _ = _latency_chain(pkg, x, taps, sized)
            fg._materialize()
            caps.append([o.stream_outputs[0].writer.capacity for o in owners])
        budget = 16384 if sized else 1 << 18
        out_items = max(budget, (DEPTH + 1) * FRAME * 8) // 8
        want = [(1 << 18) // 8, max(budget // 8, 2 * FRAME),
                1 << (out_items - 1).bit_length()]
        assert caps == [want, want], sized


def test_the_latency_profile_chain_is_equal_under_both_sizings():
    """The port's chain at both sizings: the same output, bit for bit, the
    plain FIR's within 1e-5 of peak; a probe arrives for every frame."""
    rng = np.random.default_rng(7)
    n = 8 * FRAME                     # fir_stage(impl="pallas") emits whole frames
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    taps = np.hanning(16).astype(np.float32)
    got = []
    for sized in (False, True):
        fg, _, lat, vec = _latency_chain(PORT, x, taps, sized)
        Runtime().run(fg)
        got.append(np.asarray(vec.items()))
        assert len(lat.records) == n // FRAME
    np.testing.assert_array_equal(got[0], got[1])
    want = np.convolve(x.astype(np.complex128), taps)[:n]
    assert len(got[0]) == n
    assert np.abs(got[0] - want).max() <= 1e-5 * np.abs(want).max()
