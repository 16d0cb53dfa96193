"""The port's stream and functional blocks: the cases of
``tests/test_block_coverage.py`` on the blocks this slice adds (``Filter``,
``Split``, ``Selector``, ``Throttle``, ``ApplyNM``, ``ApplyIntoIter``,
``StreamDuplicator``, ``Delay``, ``Source``, ``Sink``, ``FiniteSource``,
``TagDebug``, ``Combine``), then every new stream, functional and vector
block held against the JAX block in the same flowgraph on the same seeded
input, bit for bit, and the Pmt tag kind.
"""

import numpy as np
import pytest
import torch

from futuresdr_tpu_torch import Flowgraph, Mocker, Pmt, Runtime
from futuresdr_tpu_torch.blocks import (ApplyIntoIter, ApplyNM, Combine, Delay, Filter,
                                        FiniteSource, Head, MovingAvg, Selector, Sink,
                                        Source, Split, StreamDeinterleaver,
                                        StreamDuplicator, TagDebug, Throttle, VectorSink,
                                        VectorSource)
from futuresdr_tpu_torch.runtime.tag import Tag

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)


def test_filter_block():
    data = np.arange(10_000, dtype=np.float32)
    fg = Flowgraph()
    src = VectorSource(data)
    flt = Filter(lambda x: x % 2 == 0, np.float32)
    snk = VectorSink(np.float32)
    fg.connect(src, flt, snk)
    Runtime().run(fg)
    np.testing.assert_array_equal(snk.items(), data[::2])


def test_split_block():
    data = (np.arange(5000) + 1j * np.arange(5000)).astype(np.complex64)
    fg = Flowgraph()
    src = VectorSource(data)
    sp = Split(lambda x: (x.real, x.imag), np.complex64, np.float32, np.float32)
    s0, s1 = VectorSink(np.float32), VectorSink(np.float32)
    fg.connect_stream(src, "out", sp, "in")
    fg.connect_stream(sp, "out0", s0, "in")
    fg.connect_stream(sp, "out1", s1, "in")
    Runtime().run(fg)
    np.testing.assert_allclose(s0.items(), data.real)
    np.testing.assert_allclose(s1.items(), data.imag)


def test_selector_routing_and_switch():
    import time
    from futuresdr_tpu_torch.blocks import SignalSource, NullSink

    fg = Flowgraph()
    sa = SignalSource("cos", 0.0, 1e6, amplitude=0.0)       # constant 0s, endless
    sb = SignalSource("cos", 0.0, 1e6, amplitude=1.0)       # constant 1s, endless
    sel = Selector(np.float32, 2, 1, drop_policy="drop_all")
    snk = VectorSink(np.float32)
    fg.connect_stream(sa, "out", sel, "in0")
    fg.connect_stream(sb, "out", sel, "in1")
    fg.connect_stream(sel, "out0", snk, "in")
    rt = Runtime()
    running = rt.start(fg)

    def poll_for(value, deadline=10.0):
        # poll instead of a fixed sleep: on a loaded box a 50 ms nap is flake-bait
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < deadline:
            if value in snk.items():
                return True
            time.sleep(0.01)
        return False

    assert poll_for(0.0), "no samples from input 0 before the switch"
    r = rt.scheduler.run_coro_sync(running.handle.call(sel, "input_index", Pmt.usize(1)))
    assert r == Pmt.usize(1)
    assert poll_for(1.0), "no samples from input 1 after the switch"
    running.stop_sync()
    got = snk.items()
    assert 0.0 in got and 1.0 in got        # routed input switched mid-stream


def test_throttle_rate():
    import time
    data = np.zeros(30_000, np.float32)
    fg = Flowgraph()
    src = VectorSource(data)
    thr = Throttle(np.float32, rate=100_000.0)
    snk = VectorSink(np.float32)
    fg.connect(src, thr, snk)
    t0 = time.perf_counter()
    Runtime().run(fg)
    dt = time.perf_counter() - t0
    assert len(snk.items()) == 30_000
    assert dt >= 0.25                      # 30k at 100k/s ≥ 0.3s (scheduling slack)


def test_apply_nm_block():
    data = np.arange(12_000, dtype=np.float32)
    fg = Flowgraph()
    src = VectorSource(data)
    nm = ApplyNM(lambda x: x.reshape(-1, 3).sum(axis=1), 3, 1, np.float32)
    snk = VectorSink(np.float32)
    fg.connect(src, nm, snk)
    Runtime().run(fg)
    np.testing.assert_allclose(snk.items(), data.reshape(-1, 3).sum(axis=1))


def test_apply_into_iter_block():
    data = np.arange(1000, dtype=np.float32)
    fg = Flowgraph()
    src = VectorSource(data)
    rep = ApplyIntoIter(lambda x: np.repeat(x, 3), np.float32)
    snk = VectorSink(np.float32)
    fg.connect(src, rep, snk)
    Runtime().run(fg)
    np.testing.assert_array_equal(snk.items(), np.repeat(data, 3))


def test_stream_duplicator_and_deinterleaver():
    data = np.arange(6000, dtype=np.float32)
    fg = Flowgraph()
    src = VectorSource(data)
    dup = StreamDuplicator(np.float32, 2)
    deint = StreamDeinterleaver(np.float32, 2)
    s_dup = VectorSink(np.float32)
    s_even, s_odd = VectorSink(np.float32), VectorSink(np.float32)
    fg.connect_stream(src, "out", dup, "in")
    fg.connect_stream(dup, "out0", s_dup, "in")
    fg.connect_stream(dup, "out1", deint, "in")
    fg.connect_stream(deint, "out0", s_even, "in")
    fg.connect_stream(deint, "out1", s_odd, "in")
    Runtime().run(fg)
    np.testing.assert_array_equal(s_dup.items(), data)
    np.testing.assert_array_equal(s_even.items(), data[0::2])
    np.testing.assert_array_equal(s_odd.items(), data[1::2])


def test_delay_in_flowgraph_with_message():
    data = np.arange(1, 1001, dtype=np.float32)
    fg = Flowgraph()
    src = VectorSource(data)
    dl = Delay(np.float32, 10)
    snk = VectorSink(np.float32)
    fg.connect(src, dl, snk)
    Runtime().run(fg)
    out = snk.items()
    np.testing.assert_array_equal(out[:10], np.zeros(10))
    np.testing.assert_array_equal(out[10:], data)


def test_source_sink_closures():
    state = {"n": 0}

    def gen(n):
        start = state["n"]
        state["n"] += n
        return np.arange(start, start + n, dtype=np.float32)

    collected = []
    fg = Flowgraph()
    src = Source(gen, np.float32)
    head = Head(np.float32, 5000)
    snk = Sink(lambda chunk: collected.append(chunk.copy()), np.float32)
    fg.connect(src, head, snk)
    Runtime().run(fg)
    got = np.concatenate(collected)
    np.testing.assert_array_equal(got, np.arange(5000, dtype=np.float32))


def test_finite_source():
    emitted = {"count": 0}

    def gen(n):
        if emitted["count"] >= 1000:
            return None
        k = min(n, 1000 - emitted["count"])
        out = np.full(k, 7.0, np.float32)
        emitted["count"] += k
        return out

    fg = Flowgraph()
    src = FiniteSource(gen, np.float32)
    snk = VectorSink(np.float32)
    fg.connect(src, snk)
    Runtime().run(fg)
    assert len(snk.items()) == 1000


def test_tags_remap_through_decimation():
    """Tag indices scale by the rate change through a decimating FIR (SURVEY hard part)."""
    from futuresdr_tpu_torch import Kernel
    from futuresdr_tpu_torch.blocks import Fir, TagDebug
    from futuresdr_tpu_torch.dsp import firdes

    class TaggingSource(Kernel):
        def __init__(self):
            super().__init__()
            self.output = self.add_stream_output("out", np.complex64)
            self._sent = False

        async def work(self, io, mio, meta):
            if self._sent:
                io.finished = True
                return
            out = self.output.slice()
            n = min(4000, len(out))
            out[:n] = 0
            self.output.add_tag(400, Tag.named_usize("marker", 1))
            self.output.add_tag(2000, Tag.named_usize("marker", 2))
            self.output.produce(n)
            self._sent = True
            io.call_again = True

    fg = Flowgraph()
    src = TaggingSource()
    fir = Fir(firdes.lowpass(0.1, 32), np.complex64, decim=4)
    dbg = TagDebug(np.complex64, "decim")
    snk = VectorSink(np.complex64)
    fg.connect(src, fir, dbg, snk)
    Runtime().run(fg)
    idx = sorted(t.index for t in dbg.seen)
    assert len(idx) == 2
    assert abs(idx[0] - 100) <= 2 and abs(idx[1] - 500) <= 2


def test_tags_flow_through_chain():
    from futuresdr_tpu_torch import Kernel

    class TaggingSource(Kernel):
        def __init__(self):
            super().__init__()
            self.output = self.add_stream_output("out", np.float32)
            self._sent = False

        async def work(self, io, mio, meta):
            if self._sent:
                io.finished = True
                return
            out = self.output.slice()
            n = min(1000, len(out))
            out[:n] = 0
            self.output.add_tag(5, Tag.named_usize("burst_start", 42))
            self.output.add_tag(500, Tag.string("mid"))
            self.output.produce(n)
            self._sent = True
            io.call_again = True

    fg = Flowgraph()
    src = TaggingSource()
    dbg = TagDebug(np.float32, "t")
    snk = VectorSink(np.float32)
    fg.connect(src, dbg, snk)
    Runtime().run(fg)
    assert len(dbg.seen) == 2
    assert dbg.seen[0].index == 5 and dbg.seen[0].tag.value == 42
    assert dbg.seen[1].tag.value == "mid"


# ---- the port against the JAX package -----------------------------------------

def _both(build):
    """Run ``build(blocks, flowgraph)`` on the port and on the JAX package;
    returns each package's list of sink arrays (port first)."""
    import futuresdr_tpu as J
    from futuresdr_tpu import blocks as jb
    from futuresdr_tpu_torch import blocks as tb
    outs = []
    for b, F, R in ((tb, Flowgraph, Runtime), (jb, J.Flowgraph, J.Runtime)):
        fg = F()
        sinks = build(b, fg)
        R().run(fg)
        outs.append([s.items() for s in sinks])
    return outs


def _data(n=20_000, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def _chain(b, fg, data, *mids):
    snk = b.VectorSink(data.dtype)
    fg.connect(b.VectorSource(data), *mids, snk)
    return [snk]


CASES = {
    "copy": lambda b, fg: _chain(b, fg, _data(), b.Copy(np.float32)),
    "copy_rand": lambda b, fg: _chain(b, fg, _data(), b.CopyRand(np.float32, 333, seed=4)),
    "delay_pad": lambda b, fg: _chain(b, fg, _data(), b.Delay(np.float32, 1234)),
    "delay_skip": lambda b, fg: _chain(b, fg, _data(), b.Delay(np.float32, -777)),
    "throttle": lambda b, fg: _chain(b, fg, _data(5_000), b.Throttle(np.float32, 1e7)),
    "tag_debug": lambda b, fg: _chain(b, fg, _data(), b.TagDebug(np.float32)),
    "filter": lambda b, fg: _chain(b, fg, _data(), b.Filter(lambda x: x > 0.1, np.float32)),
    "apply_nm": lambda b, fg: _chain(b, fg, _data(), b.ApplyNM(
        lambda x: x.reshape(-1, 4)[:, :3].reshape(-1) * 2, 4, 3, np.float32)),
    "apply_into_iter": lambda b, fg: _chain(b, fg, _data(), b.ApplyIntoIter(
        lambda x: np.repeat(x[x > 0], 3), np.float32)),
}


def _split(b, fg):
    data = (_data(seed=1) + 1j * _data(seed=2)).astype(np.complex64)
    sp = b.Split(lambda x: (x.real, np.abs(x)), np.complex64, np.float32, np.float32)
    s0, s1 = b.VectorSink(np.float32), b.VectorSink(np.float32)
    fg.connect_stream(b.VectorSource(data), "out", sp, "in")
    fg.connect_stream(sp, "out0", s0, "in")
    fg.connect_stream(sp, "out1", s1, "in")
    return [s0, s1]


def _combine(b, fg):
    c = b.Combine(lambda a, x: a * x + 1, np.float32)
    snk = b.VectorSink(np.float32)
    fg.connect_stream(b.VectorSource(_data(seed=3)), "out", c, "in0")
    fg.connect_stream(b.VectorSource(_data(15_000, seed=4)), "out", c, "in1")
    fg.connect(c, snk)
    return [snk]


def _duplicator(b, fg):
    d = b.StreamDuplicator(np.float32, 3)
    sinks = [b.VectorSink(np.float32) for _ in range(3)]
    fg.connect(b.VectorSource(_data(seed=5)), d)
    for i, s in enumerate(sinks):
        fg.connect_stream(d, f"out{i}", s, "in")
    return sinks


def _selector(b, fg):
    sel = b.Selector(np.float32, 2, 2, drop_policy="no_drop")
    sel.input_index, sel.output_index = 1, 1
    s0, s1 = b.VectorSink(np.float32), b.VectorSink(np.float32)
    fg.connect_stream(b.VectorSource(_data(seed=6)), "out", sel, "in0")
    fg.connect_stream(b.VectorSource(_data(seed=7)), "out", sel, "in1")
    fg.connect_stream(sel, "out0", s0, "in")
    fg.connect_stream(sel, "out1", s1, "in")
    return [s0, s1]


def _sources(b, fg):
    state = {"n": 0}
    data = _data(9_000, seed=8)

    def finite(n):
        if state["n"] >= len(data):
            return None
        chunk = data[state["n"]:state["n"] + min(n, 700)]
        state["n"] += len(chunk)
        return chunk

    ramp = {"k": 0}

    def source(n):
        out = np.arange(ramp["k"], ramp["k"] + n, dtype=np.float32)
        ramp["k"] += n
        return out

    got = []
    s1, s2 = b.VectorSink(np.float32), b.Sink(lambda x: got.append(x.copy()), np.float32)
    s2.items = lambda: np.concatenate(got)
    fg.connect(b.FiniteSource(finite, np.float32), s1)
    fg.connect(b.Source(source, np.float32), b.Head(np.float32, 12_345), s2)
    return [s1, s2]


CASES.update({"split": _split, "combine": _combine, "duplicator": _duplicator,
              "selector": _selector, "sources": _sources})


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_equals_the_jax_block(case):
    port, ref = _both(CASES[case])
    assert len(port) == len(ref) and sum(len(p) for p in port) > 0
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p, r)


def test_pmt_tag_kind_and_constructors_equal_the_jax_tags():
    from futuresdr_tpu.runtime.tag import Tag as JTag
    from futuresdr_tpu.types import Pmt as JPmt
    pairs = [(Tag.id(3), JTag.id(3)), (Tag.string("s"), JTag.string("s")),
             (Tag.named_usize("n", 4), JTag.named_usize("n", 4)),
             (Tag.named_f32("f", 0.5), JTag.named_f32("f", 0.5)),
             (Tag.named_any("a", [1]), JTag.named_any("a", [1]))]
    for t, j in pairs:
        assert (t.kind, t.value, t.name) == (j.kind, j.value, j.name)
    t, j = Tag.pmt(Pmt.u32(9)), JTag.pmt(JPmt.u32(9))
    assert t.kind == j.kind == "pmt" and t.value.to_json() == j.value.to_json()


def test_pmt_tag_rides_through_copy_and_tag_debug():
    """A Pmt tag at item 5 reaches the sink's input through ``Copy`` and
    ``TagDebug``, which records it."""
    from futuresdr_tpu_torch import Kernel
    from futuresdr_tpu_torch.blocks import Copy

    class Tagger(Kernel):
        def __init__(self):
            super().__init__()
            self.input = self.add_stream_input("in", np.float32)
            self.output = self.add_stream_output("out", np.float32)
            self.done = False

        async def work(self, io, mio, meta):
            inp, out = self.input.slice(), self.output.slice()
            n = min(len(inp), len(out))
            if n:
                out[:n] = inp[:n]
                if not self.done and n > 5:
                    self.output.add_tag(5, Tag.pmt(Pmt.string("burst")))
                    self.done = True
                self.input.consume(n)
                self.output.produce(n)
            if self.input.finished() and self.input.available() == 0:
                io.finished = True

    fg = Flowgraph()
    dbg = TagDebug(np.float32)
    snk = VectorSink(np.float32)
    fg.connect(VectorSource(np.arange(100, dtype=np.float32)), Tagger(), Copy(np.float32),
               dbg, snk)
    Runtime().run(fg)
    assert [(t.index, t.tag.kind, t.tag.value.to_json()) for t in dbg.seen] == \
        [(5, "pmt", Pmt.string("burst").to_json())]
