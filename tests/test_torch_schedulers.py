"""The port's schedulers and runtime options: the scheduler cases of
``tests/test_transport.py`` and ``tests/test_message_blocks.py`` on the port
(``ThreadedScheduler``, ``TpbScheduler``, direct message dispatch across
worker loops), then the north-star grid's pipes on each scheduler against
the JAX package's actor path, bit for bit; the grid's ``--tpu`` form (one
``TpuKernel`` of ``fir_stage(impl="pallas")`` a pipe, on the CPU here)
against the host ``Fir`` cascade; the worker threads' one torch thread;
config ``default_scheduler``; and ``Runtime(extra_routes=…)`` on the
control port.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from futuresdr_tpu_torch import (AsyncScheduler, Flowgraph, Kernel, Pmt, Runtime,
                                 ThreadedScheduler, TpbScheduler, config)
from futuresdr_tpu_torch.blocks import (Copy, CopyRand, Fir, Head, MessageCopy,
                                        MessageSink, NullSink, NullSource, VectorSink,
                                        VectorSource)
from futuresdr_tpu_torch.dsp import firdes

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

SCHEDULERS = {"async": AsyncScheduler, "threaded": lambda: ThreadedScheduler(workers=3),
              "tpb": TpbScheduler}


def test_threaded_scheduler_runs_flowgraph():
    data = np.random.default_rng(0).random(300_000).astype(np.float32)
    fg = Flowgraph()
    src = VectorSource(data)
    chain = [Copy(np.float32) for _ in range(6)]
    snk = VectorSink(np.float32)
    fg.connect(src, *chain, snk)
    rt = Runtime(ThreadedScheduler(workers=4))
    rt.run(fg)
    np.testing.assert_array_equal(snk.items(), data)
    rt.shutdown()


def test_tpb_scheduler_runs_flowgraph():
    """Thread-per-block comparison scheduler (perf/perf/src/tpb_scheduler.rs role):
    every block runs on its own OS thread; results must match bit-exactly."""
    from futuresdr_tpu_torch import TpbScheduler
    data = np.random.default_rng(1).random(300_000).astype(np.float32)
    fg = Flowgraph()
    src = VectorSource(data)
    chain = [Copy(np.float32) for _ in range(6)]
    snk = VectorSink(np.float32)
    fg.connect(src, *chain, snk)
    rt = Runtime(TpbScheduler())
    rt.run(fg)
    np.testing.assert_array_equal(snk.items(), data)
    rt.shutdown()


def test_tpb_scheduler_reuse_does_not_leak_threads():
    """Per-block workers must be retired after each run (repeated rt.run on one
    scheduler instance), and blocking blocks get dedicated threads too."""
    import threading
    from futuresdr_tpu_torch import TpbScheduler
    sched = TpbScheduler()
    rt = Runtime(sched)
    data = np.arange(50_000, dtype=np.float32)
    for _ in range(3):
        fg = Flowgraph()
        src, snk = VectorSource(data), VectorSink(np.float32)
        fg.connect(src, Copy(np.float32), snk)
        rt.run(fg)
        np.testing.assert_array_equal(snk.items(), data)
    # only the supervisor worker should remain registered
    assert len(sched._workers) <= 1, len(sched._workers)
    rt.shutdown()


def test_direct_dispatch_under_threaded_scheduler():
    """Multi-loop scheduler: same-loop pairs may direct-dispatch, cross-loop
    pairs must fall back to the inbox — either way every message arrives
    exactly once, in per-sender order, across worker assignments."""
    from futuresdr_tpu_torch import ThreadedScheduler
    from futuresdr_tpu_torch.runtime.kernel import Kernel

    n = 3_000

    class CountSource(Kernel):
        def __init__(self):
            super().__init__()
            self.add_message_output("out")

        async def work(self, io, mio, meta):
            for i in range(n):
                await mio.post_async("out", Pmt.usize(i))
            io.finished = True

    fg = Flowgraph()
    src = CountSource()
    chain = [MessageCopy() for _ in range(4)]
    snk = MessageSink()
    fg.connect_message(src, "out", chain[0], "in")
    for a, b in zip(chain, chain[1:]):
        fg.connect_message(a, "out", b, "in")
    fg.connect_message(chain[-1], "out", snk, "in")
    rt = Runtime(ThreadedScheduler(workers=3))
    rt.run(fg)
    rt.shutdown()
    assert [p.to_int() for p in snk.received] == list(range(n))


# ---- the grid on each scheduler -----------------------------------------------

def _grid(pkg, pipes, stages, data, taps):
    """``perf/fir.py``'s grid of ``pkg`` on ``data``: pipes of
    ``[CopyRand(4096) -> Fir]`` stages, each into a VectorSink."""
    import importlib
    top = importlib.import_module(pkg)
    b = importlib.import_module(pkg + ".blocks")
    fg = top.Flowgraph()
    sinks = []
    for p in range(pipes):
        last = b.VectorSource(data[p])
        fg.add(last)
        for s in range(stages):
            cr, fir = b.CopyRand(np.float32, 4096, seed=s + 1), b.Fir(taps, np.float32)
            fg.connect(last, cr, fir)
            last = fir
        snk = b.VectorSink(np.float32)
        fg.connect(last, snk)
        sinks.append(snk)
    return fg, sinks


@pytest.mark.parametrize("sched", sorted(SCHEDULERS))
def test_grid_on_each_scheduler_equals_the_jax_actor_path(monkeypatch, sched):
    """Three pipes of three stages on the actor path (``FSDR_NO_FASTCHAIN=1``
    around both packages' runs) under each scheduler: every pipe's output
    equals the JAX package's under its ``AsyncScheduler`` bit for bit."""
    import futuresdr_tpu as J
    monkeypatch.setenv("FSDR_NO_FASTCHAIN", "1")
    data = np.random.default_rng(4).standard_normal((3, 50_000)).astype(np.float32)
    taps = firdes.lowpass(0.2, 64).astype(np.float32)
    jfg, jsinks = _grid("futuresdr_tpu", 3, 3, data, taps)
    J.Runtime().run(jfg)
    fg, sinks = _grid("futuresdr_tpu_torch", 3, 3, data, taps)
    rt = Runtime(SCHEDULERS[sched]())
    rt.run(fg)
    rt.shutdown()
    for s, j in zip(sinks, jsinks):
        assert len(s.items()) == 50_000
        np.testing.assert_array_equal(s.items(), j.items())


@pytest.mark.parametrize("sched", ["async", "threaded"])
def test_grid_tpu_form_equals_the_host_fir_cascade(sched):
    """The grid's ``--tpu`` form: each pipe's six stages as one ``TpuKernel``
    of ``fir_stage(impl="pallas")`` (the ``fir`` kernel's wrapper, its plain
    version on the CPU) at a 2^14 frame, under the scheduler; the output
    stays within 1e-5 of the peak of the host ``Fir`` cascade on the same
    seeded input."""
    from futuresdr_tpu_torch.ops import fir_stage
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
    taps = firdes.lowpass(0.2, 64).astype(np.float32)
    data = np.random.default_rng(9).standard_normal((2, 3 << 14)).astype(np.float32)
    cpu = TpuInstance("cpu")
    fg = Flowgraph()
    sinks = []
    for p in range(2):
        blk = TpuKernel([fir_stage(taps, name=f"fir{i}", impl="pallas") for i in range(6)],
                        np.float32, frame_size=1 << 14, inst=cpu)
        snk = VectorSink(np.float32)
        fg.connect(VectorSource(data[p]), blk, snk)
        sinks.append(snk)
    rt = Runtime(SCHEDULERS[sched]())
    rt.run(fg)
    rt.shutdown()
    for p, snk in enumerate(sinks):
        want = data[p]
        for _ in range(6):
            want = np.convolve(want, taps)[:len(want)].astype(np.float32)
        got = snk.items()
        assert len(got) == len(want)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_worker_threads_run_torch_at_one_thread():
    """Every thread the threaded schedulers start runs torch at one intra-op
    thread: the workers, a blocking block's pool thread and each of the
    thread-per-block threads."""
    seen = []

    class Probe(Kernel):
        def __init__(self, blocking):
            super().__init__()
            self.meta.blocking = blocking      # a blocking block runs on a pool thread
            self.input = self.add_stream_input("in", np.float32)

        async def work(self, io, mio, meta):
            seen.append((threading.current_thread().name, torch.get_num_threads()))
            self.input.consume(self.input.available())
            if self.input.finished():
                io.finished = True

    torch.set_num_threads(2)
    try:
        for sched in (ThreadedScheduler(workers=2), TpbScheduler()):
            fg = Flowgraph()
            for blocking in (False, True):
                fg.connect(VectorSource(np.zeros(10, np.float32)), Probe(blocking))
            rt = Runtime(sched)
            rt.run(fg)
            rt.shutdown()
    finally:
        torch.set_num_threads(1)
    assert len(seen) >= 4 and any(name.startswith("fsdr-blocking") for name, _ in seen)
    assert all(n == 1 for _, n in seen), seen


def test_default_scheduler_config_picks_the_threaded_scheduler(monkeypatch):
    monkeypatch.setattr(config(), "default_scheduler", "threaded")
    rt = Runtime()
    assert isinstance(rt.scheduler, ThreadedScheduler)
    fg = Flowgraph()
    snk = NullSink(np.float32)
    fg.connect(NullSource(np.float32), Head(np.float32, 10_000), snk)
    rt.run(fg)
    rt.shutdown()
    assert snk.n_received == 10_000


# ---- Runtime(extra_routes=...) --------------------------------------------------

def _get(url, data=None):
    req = urllib.request.Request(url, data=data, method="POST" if data else "GET")
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_extra_routes_serve_beside_the_control_port(monkeypatch):
    """Own routes: a page, a path parameter with a JSON body, a plain
    handler returning ``(status, body, type)``; the port's own routes still
    answer, and an own route's other method is a 405."""
    monkeypatch.setattr(config(), "ctrlport_enable", True)
    monkeypatch.setattr(config(), "ctrlport_bind", "127.0.0.1:0")

    async def page(request):
        return "<h1>hi</h1>"

    async def echo(request):
        return {"name": request.match_info["name"], "body": request.json(),
                "q": request.query}

    def teapot(request):
        return 418, b"short and stout", "text/plain"

    rt = Runtime(extra_routes=[("GET", "/page/", page), ("POST", "/echo/{name}/", echo),
                               ("GET", "/tea", teapot)])
    base = rt.ctrl_port.url
    running = rt.start(_beacon())
    try:
        st, ct, body = _get(base + "/page/")
        assert st == 200 and ct.startswith("text/html") and body == b"<h1>hi</h1>"
        st, ct, body = _get(base + "/echo/abc/?x=1", json.dumps([1, 2]).encode())
        assert json.loads(body) == {"name": "abc", "body": [1, 2], "q": {"x": "1"}}
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base + "/tea")
        assert e.value.code == 418 and e.value.read() == b"short and stout"
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base + "/page/", b"{}")
        assert e.value.code == 405
        assert json.loads(_get(base + "/api/fg/")[2]) == [0]
    finally:
        running.stop_sync()
        rt.shutdown()


def _beacon():
    from futuresdr_tpu_torch.blocks import MessageSource
    fg = Flowgraph()
    fg.connect_message(MessageSource(Pmt.string("x"), interval=0.05), "out",
                       MessageSink(), "in")
    return fg


def test_a_route_handler_launches_a_flowgraph_on_the_runtime(monkeypatch):
    """The reference's ``start_fg`` route: the handler starts a second
    flowgraph on the same runtime from the control port's loop and answers
    with its description; ``/api/fg/`` then lists both."""
    from futuresdr_tpu_torch.apps.custom_routes import make_runtime
    monkeypatch.setattr(config(), "ctrlport_enable", True)
    monkeypatch.setattr(config(), "ctrlport_bind", "127.0.0.1:0")
    rt = make_runtime()
    running = rt.start(_beacon())
    try:
        desc = json.loads(_get(rt.ctrl_port.url + "/start_fg/")[2])
        assert [b["type_name"] for b in desc["blocks"]] == ["MessageSource", "MessageSink"]
        assert json.loads(_get(rt.ctrl_port.url + "/api/fg/")[2]) == [0, 1]
        assert "My Custom Route" in _get(rt.ctrl_port.url + "/my_route/")[2].decode()
    finally:
        for r in [running] + rt.launched:
            r.stop_sync()
        rt.shutdown()
