"""The port's message plane and flowgraph handle against the JAX package's.

The cases of ``tests/test_message_blocks.py`` (the message blocks, the
bounded inbox, backpressure, direct dispatch on the async scheduler) and of
``tests/test_mocker.py`` on the port; the handle's ``post``, ``call``,
``describe``, ``metrics``, ``terminate`` and ``cancel``; ``describe()`` of
the same flowgraph shape equal in both packages; and the README's
quick-start handle snippet run on the port.
"""

import asyncio
import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import futuresdr_tpu as jfs
from futuresdr_tpu import blocks as jblocks
from futuresdr_tpu_torch import Flowgraph, FlowgraphError, Mocker, Pmt, Runtime
from futuresdr_tpu_torch.blocks import (Apply, Fft, Head, MessageAnnotator, MessageApply,
                                        MessageBurst, MessageCopy, MessagePipe,
                                        MessageSink, MessageSource, NullSink, NullSource,
                                        SeifySource, VectorSink, VectorSource)
from futuresdr_tpu_torch.config import config
from futuresdr_tpu_torch.runtime import FlowgraphCancelled, Kernel, message_handler
from futuresdr_tpu_torch.runtime.inbox import BlockInbox, Call
from futuresdr_tpu_torch.types import PortId

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

README = Path(__file__).resolve().parent.parent / "README.md"


# ---- tests/test_message_blocks.py on the port ---------------------------------------
def test_burst_copy_sink():
    fg = Flowgraph()
    burst = MessageBurst(Pmt.f64(2.5), 17)
    cp = MessageCopy()
    snk = MessageSink()
    fg.connect_message(burst, "out", cp, "in")
    fg.connect_message(cp, "out", snk, "in")
    Runtime().run(fg)
    assert len(snk.received) == 17
    assert all(p == Pmt.f64(2.5) for p in snk.received)


def test_message_apply_transform_and_drop():
    fg = Flowgraph()
    burst = MessageBurst(Pmt.usize(3), 10)
    app = MessageApply(lambda p: Pmt.usize(p.to_int() * 2) if p.to_int() else None)
    snk = MessageSink()
    fg.connect_message(burst, "out", app, "in")
    fg.connect_message(app, "out", snk, "in")
    Runtime().run(fg)
    assert [p.to_int() for p in snk.received] == [6] * 10


def test_annotator_wraps_in_map():
    fg = Flowgraph()
    burst = MessageBurst(Pmt.string("x"), 1)
    ann = MessageAnnotator({"source": Pmt.string("test")}, key="payload")
    snk = MessageSink()
    fg.connect_message(burst, "out", ann, "in")
    fg.connect_message(ann, "out", snk, "in")
    Runtime().run(fg)
    m = snk.received[0].to_map()
    assert m["payload"] == Pmt.string("x")
    assert m["source"] == Pmt.string("test")


def test_message_source_periodic():
    fg = Flowgraph()
    src = MessageSource(Pmt.null(), interval=0.01, count=5)
    snk = MessageSink()
    fg.connect_message(src, "out", snk, "in")
    Runtime().run(fg)
    assert len(snk.received) == 5


def test_message_pipe_forwards_into_a_queue():
    fg = Flowgraph()
    burst = MessageBurst(Pmt.usize(4), 3)
    pipe = MessagePipe()
    fg.connect_message(burst, "out", pipe, "in")
    Runtime().run(fg)
    got = []
    while not pipe.queue.empty():
        got.append(pipe.queue.get_nowait())
    assert got == [Pmt.usize(4)] * 3


def test_bounded_inbox_try_send_drops_when_full():
    ib = BlockInbox(capacity=3)
    msg = Call(PortId.coerce("in"), Pmt.ok())
    assert all(ib.try_send(msg) for _ in range(3))
    assert not ib.try_send(msg)          # full → bounded drop
    assert ib.try_recv() is not None     # drain one → space frees
    assert ib.try_send(msg)


def test_send_async_backpressures_until_consumer_drains():
    async def scenario():
        ib = BlockInbox(capacity=2)
        msg = Call(PortId.coerce("in"), Pmt.ok())
        await ib.send_async(msg)
        await ib.send_async(msg)
        parked = asyncio.ensure_future(ib.send_async(msg))
        await asyncio.sleep(0.02)
        assert not parked.done()         # producer parked on the full inbox
        assert ib.try_recv() is not None
        await asyncio.wait_for(parked, 1.0)
        assert len(ib) == 2

    asyncio.run(scenario())


def test_closed_inbox_refuses_and_releases_parked_producers():
    async def scenario():
        ib = BlockInbox(capacity=1)
        msg = Call(PortId.coerce("in"), Pmt.ok())
        await ib.send_async(msg)
        parked = asyncio.ensure_future(ib.send_async(msg))
        await asyncio.sleep(0.01)
        ib.close()
        assert await asyncio.wait_for(parked, 1.0) is False
        assert not ib.try_send(msg) and not ib.send(msg)
        assert ib.try_recv() is not None  # queued messages stay drainable

    asyncio.run(scenario())


def test_large_burst_bounded_inbox_delivers_all():
    n = config().queue_size * 4 + 7
    fg = Flowgraph()
    burst = MessageBurst(Pmt.usize(1), n)
    snk = MessageSink()
    fg.connect_message(burst, "out", snk, "in")
    Runtime().run(fg)
    assert len(snk.received) == n


def test_direct_dispatch_eligibility_gates():
    assert MessageCopy()._direct_ok
    assert MessageCopy()._sync_handler("in") is not None
    assert MessageSink()._direct_ok
    assert MessageSink()._sync_handler("in") is not None
    assert not MessageBurst(Pmt.usize(1), 1)._direct_ok     # custom work()
    assert MessagePipe()._sync_handler("in") is None        # async handler
    assert not Fft()._direct_ok                             # stream block


class _CountSource(Kernel):
    def __init__(self, n):
        super().__init__()
        self.n = n
        self.add_message_output("out")

    async def work(self, io, mio, meta):
        for i in range(self.n):
            await mio.post_async("out", Pmt.usize(i))
        io.finished = True


def test_direct_dispatch_preserves_order_and_metrics():
    n = 5_000
    fg = Flowgraph()
    src = _CountSource(n)
    c1, c2 = MessageCopy(), MessageCopy()
    snk = MessageSink()
    fg.connect_message(src, "out", c1, "in")
    fg.connect_message(c1, "out", c2, "in")
    fg.connect_message(c2, "out", snk, "in")
    Runtime().run(fg)
    assert [p.to_int() for p in snk.received] == list(range(n))
    assert fg.wrapped(c1).metrics()["messages_handled"] >= n   # + finished marker


def test_messages_cross_threads_to_a_blocking_block_in_order():
    """A blocking block runs its own loop: posts to it take the inbox (no
    direct call across loops) and arrive once each, in order."""

    class BlockingSink(MessageSink):
        BLOCKING = True

    n = 2_000
    fg = Flowgraph()
    src = _CountSource(n)
    snk = BlockingSink()
    fg.connect_message(src, "out", snk, "in")
    Runtime().run(fg)
    assert [p.to_int() for p in snk.received] == list(range(n))


# ---- tests/test_mocker.py on the port -----------------------------------------------
def test_apply_doubles():
    blk = Apply(lambda x: 2.0 * x, np.float32)
    m = Mocker(blk)
    data = np.arange(128, dtype=np.float32)
    m.input("in", data)
    m.init_output("out", 256)
    m.init()
    m.run()
    m.deinit()
    np.testing.assert_array_equal(m.output("out"), 2.0 * data)


def test_head_stops():
    blk = Head(np.float32, 10)
    m = Mocker(blk)
    m.input("in", np.ones(100, np.float32))
    m.init_output("out", 100)
    m.run()
    assert len(m.output("out")) == 10
    assert m.finished


def test_message_handler_via_post():
    m = Mocker(Fft(64))
    assert m.post("fft_size", Pmt.usize(32)) == Pmt.ok()
    assert m.kernel.fft_size == 32
    assert m.post("fft_size", Pmt.string("bogus")) == Pmt.invalid_value()
    assert m.post("nonexistent", Pmt.null()) == Pmt.invalid_value()
    assert m.post(0, Pmt.usize(16)) == Pmt.ok()            # handler by index
    assert m.post(5, Pmt.usize(16)) == Pmt.invalid_value()


def test_mocker_captures_posted_messages():
    m = Mocker(MessageCopy())
    assert m.post("in", Pmt.f32(1.5)) == Pmt.ok()
    assert m.messages == [("out", Pmt.f32(1.5))]
    assert m.post("in", Pmt.finished()) == Pmt.ok() and m.finished


def test_mocker_matches_jax_mocker_on_apply():
    data = np.random.default_rng(5).standard_normal(1000).astype(np.float32)
    outs = []
    for mocker, apply in ((Mocker, Apply), (jfs.Mocker, jblocks.Apply)):
        m = mocker(apply(lambda x: np.tanh(3 * x), np.float32))
        m.input("in", data)
        m.init_output("out", 1000)
        m.init()
        m.run()
        outs.append(m.output("out"))
    np.testing.assert_array_equal(outs[0], outs[1])


# ---- the flowgraph handle -----------------------------------------------------------
def _handle_flowgraph():
    fg = Flowgraph()
    src, head, snk = NullSource(np.float32), Head(np.float32, 1 << 40), NullSink(np.float32)
    msink = MessageSink()
    fg.connect(src, head, snk)
    fg.add(msink)
    return fg, snk, msink


def test_handle_post_call_describe_metrics_terminate():
    fg, snk, msink = _handle_flowgraph()
    rt = Runtime()
    running = rt.start(fg)
    h = running.handle
    h.post_sync(msink, "in", 7)
    assert h.call_sync(msink, "in", Pmt.string("x")) == Pmt.ok()
    assert h.call_sync(msink, "nope", Pmt.null()) == Pmt.invalid_value()
    assert h.call_sync(99, "in", Pmt.null()) == Pmt.invalid_value()
    assert msink.received == [Pmt.usize(7), Pmt.string("x")]
    desc = h.describe_sync()
    assert [b.type_name for b in desc.blocks] == ["NullSource", "Head", "NullSink",
                                                  "MessageSink"]
    assert desc.stream_edges == [(0, "out", 1, "in"), (1, "out", 2, "in")]
    deadline = time.monotonic() + 10
    while True:
        m = h.metrics_sync()
        if m["NullSink_2"]["items_in"]["in"] > 0 or time.monotonic() > deadline:
            break
        time.sleep(0.01)
    assert m["NullSink_2"]["items_in"]["in"] > 0
    assert m["MessageSink_3"]["messages_handled"] == 3     # "nope" counts too
    assert set(m["Head_1"]) >= {"work_calls", "work_time_s", "messages_handled", "items_in",
                                "items_out", "buffer_fill", "stalls", "starved"}
    rt.scheduler.run_coro_sync(h.terminate())
    done = running.wait_sync(timeout=10)
    assert done is fg and snk.n_received > 0
    # the flowgraph has ended: calls answer InvalidValue, describe is static
    assert h.call_sync(msink, "in", Pmt.null()) == Pmt.invalid_value()
    assert [b.type_name for b in h.describe_sync().blocks][0] == "NullSource"
    assert h.metrics_sync() == {}


def test_handle_cancel_raises_flowgraph_cancelled():
    fg, _, _ = _handle_flowgraph()
    rt = Runtime()
    running = rt.start(fg)
    running.handle.cancel_sync("operator said so")
    with pytest.raises(FlowgraphError) as e:
        running.wait_sync(timeout=10)
    assert any(isinstance(x, FlowgraphCancelled) for x in e.value.errors)
    assert "operator said so" in str(e.value)


def test_wait_timeout_cancels_a_running_flowgraph():
    fg, _, _ = _handle_flowgraph()
    running = Runtime().start(fg)
    with pytest.raises(FlowgraphError, match="deadline"):
        running.wait_sync(timeout=0.2)


def test_stop_sync_returns_the_flowgraph_with_its_blocks():
    fg, snk, _ = _handle_flowgraph()
    running = Runtime().start(fg)
    assert running.stop_sync() is fg
    assert fg.wrapped(snk).kernel is snk


def test_call_during_init_is_held_until_the_barrier():
    """A call sent while a block is still in ``init`` (here through the
    runtime's registry, as the control port sends it) waits for the init
    barrier, then reaches the initialized block."""

    class SlowInit(MessageSink):
        async def init(self, mio, meta):
            await asyncio.sleep(0.3)
            self.ready = True

        @message_handler(name="in")
        def in_handler(self, io, mio, meta, p):
            return Pmt.bool_(getattr(self, "ready", False))

    fg = Flowgraph()
    slow = SlowInit()
    fg.add(slow)
    rt = Runtime()

    async def scenario():
        start = asyncio.ensure_future(rt.start_async(fg))
        while rt.handle.get_flowgraph(0) is None:
            await asyncio.sleep(0.01)
        r = await rt.handle.get_flowgraph(0).call(slow, "in", Pmt.null())
        running = await start
        await running.handle.terminate()
        await running.wait()
        return r

    assert rt.scheduler.run_coro_sync(scenario()) == Pmt.bool_(True)


# ---- describe() against the JAX package ---------------------------------------------
def _same_shape(m, blocks):
    fg = m.Flowgraph()
    src = blocks.VectorSource(np.arange(1000, dtype=np.float32))
    head, snk = blocks.Head(np.float32, 500), blocks.VectorSink(np.float32)
    burst, cp, msnk = blocks.MessageBurst(m.Pmt.usize(1), 3), blocks.MessageCopy(), \
        blocks.MessageSink()
    fg.connect(src, head, snk)
    fg.connect_message(burst, "out", cp, "in")
    fg.connect_message(cp, "out", msnk, "in")
    return fg


def test_describe_equals_the_jax_package_for_the_same_shape():
    from futuresdr_tpu_torch import blocks as tblocks
    import futuresdr_tpu_torch as tfs
    t_fg, j_fg = _same_shape(tfs, tblocks), _same_shape(jfs, jblocks)
    assert t_fg.describe().to_json() == j_fg.describe().to_json()
    Runtime().run(t_fg)
    jfs.Runtime().run(j_fg)
    assert t_fg.describe().to_json() == j_fg.describe().to_json()


def test_running_describe_equals_the_jax_package():
    t_fg, j_fg = Flowgraph(), jfs.Flowgraph()
    # throttled: the reference's SeifySource can overrun its output window
    # when it runs unthrottled (ROADMAP Queue 3)
    t_src = SeifySource("driver=dummy,rate=1e5")
    j_src = jblocks.SeifySource("driver=dummy,rate=1e5")
    t_fg.connect(t_src, Head(np.complex64, 1 << 40), NullSink(np.complex64))
    j_fg.connect(j_src, jblocks.Head(np.complex64, 1 << 40), jblocks.NullSink(np.complex64))
    t_run, j_run = Runtime().start(t_fg), jfs.Runtime().start(j_fg)
    try:
        t_desc = t_run.handle.describe_sync().to_json()
        j_desc = j_run.handle.describe_sync().to_json()
    finally:
        t_run.stop_sync()
        j_run.stop_sync()
    assert t_desc == j_desc
    assert t_desc["blocks"][0]["message_inputs"] == ["cmd", "freq", "gain", "sample_rate"]


# ---- the README's quick start -------------------------------------------------------
def test_readme_handle_snippet_runs_on_the_port():
    text = README.read_text()
    snippet = re.search(r"Message ports and runtime control:\n\n```python\n(.*?)```",
                        text, re.S).group(1)
    assert "running.handle.post_sync" in snippet and "stop_sync" in snippet
    fg = Flowgraph()
    src = SeifySource("driver=dummy,throttle=false")
    fg.connect(src, Head(np.complex64, 1 << 40), NullSink(np.complex64))
    ns = {"fg": fg, "src": src, "Runtime": Runtime, "print": lambda *a: None}
    exec(compile(snippet.replace("futuresdr_tpu", "futuresdr_tpu_torch"), "README", "exec"),
         ns)
    assert ns["fg"] is fg
    assert src.device.driver.frequency == 99.3e6
