"""The port's span plane, exposition, journal and their overhead
(``futuresdr_tpu_torch/telemetry``: spans, prom, hist, journal; the hooks in
the block event loop, the transfers, the streamed kernels and the serving
engine).

Against the JAX package's modules of the same names, on the same scripted
inputs and with no timing in the comparison, each pair agrees exactly: the
Chrome trace of the same events at fixed stamps (lineage flows included),
``union_ns`` and ``overlap_report``, the exposition text with per-block
families and exemplars, the journal's spool and cursor reads, and the
latency probes' statistics. The port's own invariants: a streamed and a
served run give the same output, bit for bit, with tracing on as with it
off; every dispatch group carries encode, H2D, compute, D2H and decode
spans; the disabled hooks cost at most 3% of the null_rand chain and of the
streamed ``TpuKernel`` path (the analytic gate of the reference), and tracing
on stays within 1.5× of off.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from futuresdr_tpu.telemetry import hist as J_hist
from futuresdr_tpu.telemetry import journal as J_journal
from futuresdr_tpu.telemetry import lineage as J_lineage
from futuresdr_tpu.telemetry import prom as J_prom
from futuresdr_tpu.telemetry import spans as J_spans
from futuresdr_tpu.config import config as J_config
from futuresdr_tpu_torch import Flowgraph, Kernel, Runtime
from futuresdr_tpu_torch.blocks import Head, NullSink, NullSource, VectorSink, VectorSource
from futuresdr_tpu_torch.config import config as T_config
from futuresdr_tpu_torch.ops import stages as T
from futuresdr_tpu_torch.telemetry import hist as T_hist
from futuresdr_tpu_torch.telemetry import journal as T_journal
from futuresdr_tpu_torch.telemetry import lineage as T_lineage
from futuresdr_tpu_torch.telemetry import prom as T_prom
from futuresdr_tpu_torch.telemetry import spans as T_spans
from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

CPU = TpuInstance("cpu")
FRAME = 4096
TAPS = np.hanning(31).astype(np.float32)


@pytest.fixture
def tracing():
    rec = T_spans.recorder()
    rec.drain()
    T_spans.enable(True)
    try:
        yield rec
    finally:
        T_spans.enable(False)
        rec.drain()


@pytest.fixture
def stride1(monkeypatch):
    """Both lineage tracers sample every frame, fresh."""
    monkeypatch.setattr(T_config(), "lineage_stride", 1)
    monkeypatch.setattr(J_config(), "lineage_stride", 1)
    yield T_lineage.reset_tracer(), J_lineage.reset_tracer()
    monkeypatch.undo()
    T_lineage.reset_tracer()
    J_lineage.reset_tracer()


# ---------------------------------------------------------------------------
# the recorder and its export against the reference
# ---------------------------------------------------------------------------

def _events(mod):
    E = mod.SpanEvent
    return [E(11, "main", 1_000, 500, "tpu", "encode", {"wire": "f32", "items": 4096}),
            E(11, "main", 1_600, 2_000, "tpu", "compute", None),
            E(12, "fsdr-codec-d", 2_100, 700, "tpu", "D2H", {"bytes": 32768}),
            E(12, "fsdr-codec-d", 2_900, None, "runtime", "block_restart", {"block": "b"}),
            E(11, "main", 3_000, None, "counter", "mfu:p", {"value": 0.5}),
            E(13, "blk", 3_100, 10, "block", "TpuKernel_1", None)]


def _lineage_records(mod, tracer):
    """Two sampled frames stamped at fixed times on this thread."""
    for base in (1_000, 5_000):
        tid = tracer.sample()
        for i, lane in enumerate(mod.LANE_ORDER):
            tracer.stamp(tid, lane, base + 100 * i)
        tracer.finish(tid, source="blk", session="s1", tenant="t1")


def test_chrome_trace_matches_the_reference(stride1):
    t_tr, j_tr = stride1
    _lineage_records(T_lineage, t_tr)
    _lineage_records(J_lineage, j_tr)
    trec = T_spans.SpanRecorder(capacity=64, enabled=True)
    jrec = J_spans.SpanRecorder(capacity=64, enabled=True)
    trec.epoch_ns = jrec.epoch_ns = 500
    got = trec.chrome_trace(_events(T_spans))
    want = jrec.chrome_trace(_events(J_spans))
    assert got == want
    assert got["otherData"]["lineage_flows"] == 2
    assert {e["ph"] for e in got["traceEvents"]} == {"X", "i", "C", "M", "s", "t", "f"}
    json.loads(json.dumps(got))                 # the export is JSON


@pytest.mark.parametrize("iv", [
    [], [(0, 10)], [(0, 10), (5, 15)], [(0, 10), (20, 30), (25, 26)],
    [(5, 6), (0, 100), (99, 120), (200, 201)], [(3, 3), (1, 2), (2, 3)]])
def test_union_ns_matches_the_reference(iv):
    assert T_spans.union_ns(iv) == J_spans.union_ns(iv)


@pytest.mark.parametrize("lanes", [("H2D", "compute", "D2H"),
                                   ("encode", "H2D", "compute", "D2H", "decode")])
def test_overlap_report_matches_the_reference(lanes):
    def evs(mod):
        E = mod.SpanEvent
        out = []
        for g in range(4):
            t = g * 1_000
            out += [E(1, "m", t, 300, "tpu", "encode", None),
                    E(1, "m", t + 300, 400, "tpu", "H2D", None),
                    E(1, "m", t + 500, 600, "tpu", "compute", None),
                    E(2, "w", t + 900, 300, "tpu", "D2H", None),
                    E(2, "w", t + 1_100, 200, "tpu", "decode", None),
                    E(1, "m", t, 900, "block", "k", None)]
        return out
    assert T_spans.overlap_report(evs(T_spans), lanes) == \
        J_spans.overlap_report(evs(J_spans), lanes)


def test_serve_overlap_report_keeps_the_tuple_form():
    """The serving module's ``overlap_report`` over ``(lane, t0, t1)``
    tuples reads the same ratio as the span plane's over events."""
    from futuresdr_tpu_torch.serve import overlap_report
    tuples = [("H2D", 0.0, 1.0), ("compute", 0.5, 2.0), ("D2H", 1.5, 3.0)]
    E = T_spans.SpanEvent
    evs = [E(1, "m", int(s * 1e9), int((e - s) * 1e9), "tpu", n, None) for n, s, e in tuples]
    a, b = overlap_report(tuples), T_spans.overlap_report(evs)
    assert a["ratio"] == pytest.approx(b["ratio"]) and a["union_s"] == pytest.approx(3.0)


def test_disabled_recorder_records_nothing_and_rings_bound():
    rec = T_spans.SpanRecorder(capacity=16, enabled=False)
    rec.complete("c", "a", rec.now())
    rec.instant("c", "b")
    assert rec.drain() == [] and rec.span("c", "x") is T_spans._NOOP
    rec.enabled = True
    for i in range(20):
        rec.complete("c", f"e{i}", i, end_ns=i + 1)
    evs = rec.drain()
    assert [e.name for e in evs] == [f"e{i}" for i in range(4, 20)] and rec.dropped == 4


def test_dead_thread_rings_pruned_after_drain():
    rec = T_spans.SpanRecorder(capacity=64, enabled=True)

    def record():
        rec.complete("c", "from_dead_thread", rec.now())

    t = threading.Thread(target=record)
    t.start()
    t.join()
    assert len(rec._rings) == 1
    evs = rec.drain()                   # the events outlive the thread...
    assert [e.name for e in evs] == ["from_dead_thread"]
    assert rec._rings == []             # ...then its ring is unregistered


def test_snapshot_is_non_destructive_and_export_parses(tmp_path):
    rec = T_spans.SpanRecorder(capacity=64, enabled=True)
    with rec.span("c", "a", k=1):
        pass
    assert [e.name for e in rec.snapshot()] == ["a"] == [e.name for e in rec.snapshot()]
    path = rec.export(str(tmp_path / "t.json"))
    doc = json.load(open(path))
    assert [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"] == ["a"]
    assert rec.snapshot() == []


# ---------------------------------------------------------------------------
# exposition, exemplars and the journal against the reference
# ---------------------------------------------------------------------------

_BLOCKS = {0: {"src": {"work_calls": 7, "work_time_s": 0.25, "messages_handled": 1,
                       "restarts": 0, "items_in": {}, "items_out": {"out": 4096},
                       "buffer_fill": {}, "stalls": {"out": 2}, "starved": {},
                       "frames_dispatched": 3, "wire": "sc16"},
               "kern": {"work_calls": 9, "items_in": {"in": 4096}, "items_out": {"out": 1024},
                        "buffer_fill": {"in": 0.5}, "stalls": {}, "starved": {"in": 4},
                        "fsdr_frames_replayed_total": 2, "interior_precision": "off",
                        "inflight_credits": 4}},
           3: {"snk": {"work_calls": 2, "items_in": {"in": 1024}}}}


def _exposition(prom, hist, monkeypatch):
    monkeypatch.setattr(hist, "_time", lambda: 1234.5)
    reg = prom.Registry()
    h = reg.histogram("probe_e2e_latency_seconds", "latency", ("source",))
    c = reg.counter("probe_total", "t", ("app",))
    child = h.labels(source="k")
    for i in range(40):
        child.observe(1e-4 * (i + 1))
    child.exemplar(2e-3, "17")
    child.exemplar(0.5, "23")
    c.inc(app="a")
    return (reg.render(), reg.render_openmetrics(), prom.render_block_metrics(_BLOCKS),
            child.exemplars())


def test_exposition_with_block_families_and_exemplars_matches_the_reference(monkeypatch):
    got = _exposition(T_prom, T_hist, monkeypatch)
    want = _exposition(J_prom, J_hist, monkeypatch)
    assert got == want
    assert 'fsdr_block_work_calls_total{block="kern",fg="0"} 9' in got[2]
    assert '# {trace_id="23"}' in got[1] and got[1].endswith("# EOF\n")


def test_hist_sampled_observe_and_exemplar_slots_match_the_reference(monkeypatch):
    def drive(hist):
        monkeypatch.setattr(hist, "_time", lambda: 99.0)
        h = hist.Log2Hist()
        for i in range(100):
            h.observe_sampled(1e-5 * (i + 1))
        for v, t in ((3e-5, "a"), (3.1e-5, "b"), (1.0, "c")):
            h.exemplar(v, t)
        return h.snapshot(), h.exemplars(), h.count, h.sum
    assert drive(T_hist) == drive(J_hist)


def _journal_story(mod, d):
    j = mod.Journal(maxlen=3, spool_dir=str(d), spool_cap_mb=0)
    for i in range(5):
        j.emit("kernel", "retune", block="b", stage=i)
    j.emit("serve", "admit", session="s")
    strip = lambda e: {k: v for k, v in e.items() if k not in ("t_wall", "t_mono_ns")}  # noqa: E731
    reads = [j.events(since=s, cat=c, limit=lim) for s, c, lim in
             ((0, None, None), (4, "kernel", None), (2, None, 1), (6, None, None))]
    j.close()
    spool = [strip(json.loads(line)) for p in sorted(d.iterdir())
             for line in open(p).read().splitlines()]
    return ([{**r, "events": [strip(e) for e in r["events"]]} for r in reads],
            [strip(e) for e in j.last(2)], spool)


def test_journal_spool_and_cursor_match_the_reference(tmp_path):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    got = _journal_story(T_journal, tmp_path / "t")
    assert got == _journal_story(J_journal, tmp_path / "j")
    assert got[0][0]["gap"] is True and len(got[2]) == 6


def test_latency_probe_stats_match_the_reference():
    from futuresdr_tpu.utils.trace import latency_stats as J_stats
    from futuresdr_tpu_torch.utils.trace import latency_stats as T_stats
    recs = [(i * 32, 1.0 + i, 1.0 + i + 1e-4 * (i % 7 + 1)) for i in range(50)]
    assert T_stats(recs) == J_stats(recs)
    assert T_stats([]) == {"count": 0}


def test_latency_probes_feed_the_e2e_family():
    from futuresdr_tpu_torch.telemetry.doctor import E2E_LATENCY
    from futuresdr_tpu_torch.utils.trace import LatencyProbeSink, LatencyProbeSource
    before = E2E_LATENCY.labels(source="latency_probe").count
    fg = Flowgraph()
    src = VectorSource(np.arange(1 << 14, dtype=np.float32))
    probe = LatencyProbeSource(np.float32, granularity=1024)
    sink = LatencyProbeSink(np.float32)
    fg.connect(src, probe, sink)
    Runtime().run(fg)
    assert [r[0] for r in sink.records] == list(range(0, 1 << 14, 1024))
    assert E2E_LATENCY.labels(source="latency_probe").count == before + 16


# ---------------------------------------------------------------------------
# the streamed and served paths under the plane
# ---------------------------------------------------------------------------

def _stream(k, data, wire="f32", with_fg=False):
    fg = Flowgraph()
    src = VectorSource(data)
    tk = TpuKernel([T.fir_stage(TAPS, fft_len=512), T.rotator_stage(0.05)], np.complex64,
                   frame_size=FRAME, inst=CPU, frames_per_dispatch=k, wire=wire)
    snk = VectorSink(np.complex64)
    fg.connect(src, tk, snk)
    done = Runtime().run(fg)
    return (done if with_fg else np.asarray(snk.items())), tk


def _c64(n, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


@pytest.mark.parametrize("k,wire", [(1, "f32"), (4, "f32"), (2, "sc16")])
def test_streamed_output_bit_equal_and_every_group_carries_the_span_set(tracing, k, wire):
    data = _c64(12 * FRAME)
    T_spans.enable(False)
    off, _ = _stream(k, data, wire)
    T_spans.enable(True)
    tracing.drain()
    on, tk = _stream(k, data, wire)
    evs = tracing.drain()
    np.testing.assert_array_equal(on, off)
    groups = tk.dispatches
    assert groups == 12 // k
    lanes = {n: [e for e in evs if e.cat == "tpu" and e.name == n]
             for n in ("encode", "H2D", "compute", "D2H", "decode")}
    assert len(lanes["encode"]) == 12                # one a frame
    for n in ("H2D", "compute", "D2H", "decode"):    # one a group
        assert len(lanes[n]) == groups, (n, len(lanes[n]))
    assert all(e.args["frames"] == k for e in lanes["compute"])
    blocks = {e.name for e in evs if e.cat == "block"}
    assert tk.meta.instance_name in blocks
    runtime = {e.name for e in evs if e.cat == "runtime"}
    assert {"flowgraph", "init_barrier"} <= runtime
    rep = T_spans.overlap_report(evs)
    assert rep["lanes"]["compute"]["spans"] == groups


def _served(frames, app):
    from futuresdr_tpu_torch.serve import ServeEngine
    pipe = T.Pipeline([T.fir_stage(TAPS, fft_len=256), T.rotator_stage(0.03)], np.complex64)
    eng = ServeEngine(pipe, frame_size=1024, app=app, device="cpu", buckets=(2,),
                      queue_frames=16)
    try:
        a, b = eng.admit(tenant="x"), eng.admit(tenant="y")
        for f in frames:
            assert eng.submit(a.sid, f) and eng.submit(b.sid, f[::-1].copy())
            eng.step()
        eng.step()
        return [np.asarray(r) for r in eng.results(a.sid) + eng.results(b.sid)], eng
    finally:
        eng.shutdown()


def test_served_output_bit_equal_and_records_serve_step_spans(tracing):
    frames = [_c64(1024, seed=i) for i in range(5)]
    T_spans.enable(False)
    off, _ = _served(frames, "tele_off")
    T_spans.enable(True)
    tracing.drain()
    on, eng = _served(frames, "tele_on")
    evs = tracing.drain()
    assert len(on) == len(off) == 10
    for x, y in zip(on, off):
        np.testing.assert_array_equal(x, y)
    steps = [e for e in evs if e.cat == "serve" and e.name == "serve_step"]
    assert len(steps) == eng.dispatches == 5
    assert sum(e.args["frames"] for e in steps) == 10
    for n in ("encode", "H2D", "compute", "D2H", "decode"):
        assert any(e.cat == "tpu" and e.name == n for e in evs), n
    assert eng.e2e_hist.count >= 10
    assert set(eng.compile_seconds) == {(2, 1, "base")}


def test_fanout_span_and_report_carry_branch_attribution(tracing):
    """The fused fan-out run's ``devchain`` span carries each branch, and
    the doctor's report surfaces them (the reference's
    ``tests/test_devchain.py`` case)."""
    from futuresdr_tpu_torch.telemetry import doctor as doc
    from tests.test_torch_devchain import fanout_frame_fg, no_devchain
    data = np.zeros(3 * FRAME, np.complex64)
    with no_devchain(False):
        fg, _sinks = fanout_frame_fg("1→1|1", data, FRAME)
        Runtime().run(fg)
    events = tracing.drain()
    dev = [e for e in events if e.cat == "devchain"]
    assert len(dev) == 1
    branches = dev[0].args["branches"]
    assert [b["branch"] for b in branches] == [0, 1]
    assert all(not b["retired"] and b["members"] == 2 for b in branches)
    assert branches[0]["items_out"] == 3 * FRAME // 4      # the decimating branch
    assert branches[1]["items_out"] == 3 * FRAME
    rep = doc.doctor().report(events=events)
    assert rep["devchain"] and rep["devchain"][0]["frames"] == 3
    assert rep["devchain"][0]["branches"] == branches


def test_dag_span_and_report_carry_sink_attribution(tracing):
    """The fused DAG run's span names each sink and the merges (the
    reference's ``tests/test_devchain.py`` case)."""
    from futuresdr_tpu_torch.telemetry import doctor as doc
    from tests.test_torch_devchain import no_devchain
    from tests.test_torch_devchain_dag import diamond_fg
    data = _c64(3 * FRAME, seed=53)
    with no_devchain(False):
        fg, _snk, _mg = diamond_fg("1|1|1", data, FRAME)
        Runtime().run(fg)
    events = tracing.drain()
    dev = [e for e in events if e.cat == "devchain"]
    assert len(dev) == 1
    sinks = dev[0].args["sinks"]
    assert len(sinks) == 1 and not sinks[0]["retired"]
    assert sinks[0]["items_out"] == 3 * FRAME // 4
    assert dev[0].args["merges"] == 1
    rep = doc.doctor().report(events=events)
    assert rep["devchain"] and rep["devchain"][0]["sinks"] == sinks
    assert rep["devchain"][0]["merges"] == 1


def test_transfers_bill_the_link_families():
    from futuresdr_tpu_torch.ops import xfer
    b0 = xfer._XFER_TRANSFERS.get(direction="d2h")
    s0 = xfer._XFER_STARTS.get(direction="d2h")
    h0 = xfer._XFER_HIST.labels(direction="d2h").count
    fin = xfer.start_host_transfer_parts((torch.zeros(64), torch.zeros(64)))
    assert len(fin()) == 2
    fin.release()
    assert xfer._XFER_TRANSFERS.get(direction="d2h") == b0 + 1     # one transfer
    assert xfer._XFER_STARTS.get(direction="d2h") == s0 + 2        # two copies
    assert xfer._XFER_HIST.labels(direction="d2h").count == h0 + 1


# ---------------------------------------------------------------------------
# the control port's telemetry routes
# ---------------------------------------------------------------------------

class _Gate(Kernel):
    """Passes items while ``open`` is set; parks otherwise."""

    def __init__(self, dtype):
        super().__init__()
        self.input = self.add_stream_input("in", dtype)
        self.output = self.add_stream_output("out", dtype)
        self.open = threading.Event()

    async def work(self, io, mio, meta):
        if not self.open.is_set():
            import asyncio
            io.block_on(asyncio.sleep(0.01))
            return
        i, o = self.input.slice(), self.output.slice()
        n = min(len(i), len(o))
        o[:n] = i[:n]
        self.input.consume(n)
        self.output.produce(n)
        if self.input.finished() and n == len(i):
            io.finished = True


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def test_control_port_serves_every_telemetry_route(tracing):
    from futuresdr_tpu_torch.runtime.ctrl_port import ControlPort
    rt = Runtime()
    cp = ControlPort(rt.handle, bind="127.0.0.1:0")
    cp.start()
    gate = _Gate(np.float32)
    fg = Flowgraph()
    fg.connect(VectorSource(np.arange(8192, dtype=np.float32)), gate, VectorSink(np.float32))
    running = rt.start(fg)
    try:
        base = cp.url
        for path in ("/api/fg/0/trace/?keep=1", "/api/fg/0/doctor/", "/api/fg/0/profile/",
                     "/api/fg/0/lineage/?n=4", "/api/events/?since=0", "/api/host/",
                     "/api/fg/0/trace/"):
            status, ctype, body = _get(base + path)
            assert status == 200 and ctype.startswith("application/json"), path
            json.loads(body)
        status, _, body = _get(base + "/api/fg/0/doctor/?md=1")
        assert status == 200 and body.startswith(b"# Flight record")
        status, _, text = _get(base + "/metrics")
        assert b'fsdr_block_work_calls_total{block=' in text
        status, _, text = _get(base + "/metrics?openmetrics=1")
        assert text.endswith(b"# EOF\n")
        for path in ("/api/fleet/", "/api/fleet/metrics", "/api/fg/9/trace/"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(base + path)
            assert ei.value.code == 404
    finally:
        gate.open.set()
        running.wait_sync()
        cp.stop()


# ---------------------------------------------------------------------------
# the overhead gates
# ---------------------------------------------------------------------------

class CopyRand(Kernel):
    """Copies a seeded random count of items (at most ``max_copy``) a call:
    the null_rand chain's middle block."""

    def __init__(self, dtype, max_copy: int = 2048, seed: int = 0):
        super().__init__()
        self.input = self.add_stream_input("in", dtype)
        self.output = self.add_stream_output("out", dtype)
        self.max_copy = max_copy
        self.rng = np.random.default_rng(seed)

    async def work(self, io, mio, meta):
        i, o = self.input.slice(), self.output.slice()
        n = min(len(i), len(o), int(self.rng.integers(1, self.max_copy + 1)))
        if n:
            o[:n] = i[:n]
            self.input.consume(n)
            self.output.produce(n)
            io.call_again = True
        if self.input.finished() and len(i) == n:
            io.finished = True


def _null_rand_chain(samples=1_000_000, stages=3, max_copy=2048):
    fg = Flowgraph()
    blocks = [NullSource(np.float32), Head(np.float32, samples)]
    fg.connect(blocks[0], blocks[1])
    last = blocks[1]
    for s in range(stages):
        c = CopyRand(np.float32, max_copy=max_copy, seed=1 + s)
        fg.connect(last, c)
        blocks.append(c)
        last = c
    snk = NullSink(np.float32)
    fg.connect(last, snk)
    blocks.append(snk)
    t0 = time.perf_counter()
    done = Runtime().run(fg)
    elapsed = time.perf_counter() - t0
    return elapsed, sum(done.wrapped(b).work_calls for b in blocks)


def _best_of(loop, n):
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter_ns()
        loop()
        best = min(best, (time.perf_counter_ns() - t0) / n)
    return best


def _hook_costs(n=100_000):
    """Per-call cost (ns) of each disabled hook class the block event loop's
    work calls can meet: the work call's span guard, end-clock read and
    1-in-8 work-duration countdown (``runtime/block.py``); the park guard;
    the disabled checkpoint check and the fleet tick's guard (both sit on
    slower paths, a dispatch group and a serving step, and are billed here
    at the work-call rate, an over-count). The per-frame and per-group
    hooks of the streamed kernel (the lineage draw, the stamps, the profile
    plane's dispatch add) are billed at their own rates by the streamed
    gate below."""
    from futuresdr_tpu_torch.telemetry import doctor as doc
    from futuresdr_tpu_torch.telemetry import fleet as fleet_mod
    rec = T_spans.recorder()
    assert not rec.enabled, "the gate measures the disabled path"
    assert fleet_mod._tick_state is None
    hist = doc.WORK_DURATION.labels(block="overhead-gate-probe")
    tk = TpuKernel([T.mag2_stage()], np.complex64, frame_size=1 << 12, inst=CPU,
                   checkpoint_every=0)
    assert tk._ckpt_every == 0

    def work_hook():
        tick = 0
        for _ in range(n):
            end = time.perf_counter_ns()
            tick += 1
            if not tick & 7:
                hist.observe((end - end) * 1e-9 + 1.5e-6)
            if rec.enabled:                          # pragma: no cover
                rec.complete("block", "x", 0)

    def park_hook():
        for _ in range(n):
            if rec.enabled:                          # pragma: no cover
                rec.complete("park", "x", 0)

    def ckpt_hook():
        for i in range(n):
            if tk._ckpt_every and (i + 1) % tk._ckpt_every == 0:   # pragma: no cover
                tk._start_ckpt(i)

    def fleet_hook():
        for _ in range(n):
            if fleet_mod._tick_state is not None:   # pragma: no cover
                fleet_mod.tick()

    return [_best_of(h, n) for h in (work_hook, park_hook, ckpt_hook, fleet_hook)]


def test_telemetry_disabled_overhead_null_rand():
    """The reference's ≤ 3% gate on the port's null_rand actor chain, with
    the watchdog armed at its default interval: each disabled hook class's
    per-call cost, micro-measured, times the chain's work calls over its
    elapsed time (an analytic bound: a wall-clock A/B at 3% would gate on
    noise). Paired trials, the best one kept. The reference also bills its
    per-frame and per-group classes here, at the work-call rate; the port's
    chain runs a work call about 2.7 times as fast as the reference's on the
    same host, so those are billed at their own rates on the streamed path
    (:func:`test_telemetry_disabled_overhead_streamed_kernel`)."""
    from futuresdr_tpu_torch.telemetry import doctor as doc
    trials = []
    for _ in range(6):
        if trials:
            time.sleep(0.5)
        costs = _hook_costs()
        doc.enable()
        try:
            elapsed, calls = _null_rand_chain()
        finally:
            doc.disable()
        overhead = calls * sum(costs) * 1e-9 / elapsed
        trials.append((overhead, costs, calls, elapsed))
        if overhead <= 0.03:
            break
    overhead, costs, calls, elapsed = min(trials)
    assert overhead <= 0.03, (f"disabled hooks cost {overhead * 100:.2f}% of the chain "
                              f"({calls} work calls, {costs} ns a hook, {elapsed:.3f} s)")


def _streamed_hook_costs(k, n=20_000):
    """Per-frame and per-group cost (ns) of the streamed kernel's disabled
    hooks: a frame pays its ring-exit stamp, the lineage draw at the default
    stride, the encode guard, five stamp checks and its latency observe; a
    group pays three span guards and the profile plane's dispatch with its
    clock read."""
    from futuresdr_tpu_torch.telemetry import profile as prof_mod
    from futuresdr_tpu_torch.telemetry.doctor import E2E_LATENCY
    from futuresdr_tpu_torch.tpu.kernel_block import _stamp_metas
    rec = T_spans.recorder()
    assert not rec.enabled
    ltr = T_lineage.reset_tracer()
    assert ltr.stride >= 2, "the gate measures the default sampled stride"
    sample = ltr.sample
    hist = E2E_LATENCY.labels(source="overhead-gate-probe")
    entry = prof_mod.register("overhead-gate-probe-k")
    entry.dispatch()
    metas = ((FRAME, (), 0, 0),)

    def per_frame():
        for _ in range(n):
            t_in = time.perf_counter_ns()
            tid = sample()
            if tid:
                ltr.finish(tid)
            if rec.enabled:                          # pragma: no cover
                rec.complete("tpu", "encode", 0)
            for lane in ("encode", "H2D", "dispatch", "D2H", "decode"):
                _stamp_metas(metas, lane)
            hist.observe((time.perf_counter_ns() - t_in) * 1e-9)

    def per_group():
        for _ in range(n):
            for _s in range(3):
                if rec.enabled:                      # pragma: no cover
                    rec.complete("tpu", "compute", 0)
            entry.dispatch(t=time.monotonic())

    costs = _best_of(per_frame, n), _best_of(per_group, n)
    ltr.clear()
    return costs


@pytest.mark.parametrize("k", [1, 4])
def test_telemetry_disabled_overhead_streamed_kernel(k):
    """The same ≤ 3% gate on the streamed ``TpuKernel`` path: the per-frame
    and per-group hook costs times the frames and groups of a run, plus the
    block loop's per-call hooks times its work calls, over its elapsed
    time."""
    data = _c64(24 * FRAME)
    trials = []
    for _ in range(4):
        frame_ns, group_ns = _streamed_hook_costs(k)
        call_ns = sum(_hook_costs(20_000))
        t0 = time.perf_counter()
        done, tk = _stream(k, data, with_fg=True)
        elapsed = time.perf_counter() - t0
        calls = sum(b.work_calls for b in done._blocks if b is not None)
        overhead = (tk.frames_dispatched * frame_ns + tk.dispatches * group_ns
                    + calls * call_ns) * 1e-9 / elapsed
        trials.append((overhead, frame_ns, group_ns, elapsed))
        if overhead <= 0.03:
            break
    overhead, frame_ns, group_ns, elapsed = min(trials)
    assert overhead <= 0.03, (f"{overhead * 100:.2f}% ({frame_ns:.0f} ns a frame, "
                              f"{group_ns:.0f} ns a group, {elapsed:.3f} s)")


def test_telemetry_enabled_stays_cheap(tracing):
    """Not the 3% gate: recording every work call's span must not blow the
    chain up; a generous bound so noise cannot flake it. Each side is the
    best of three runs, alternated, so a one-off stall of the host (a run
    here takes ~30 ms) cannot decide it."""
    t_off = t_on = float("inf")
    for _ in range(3):
        tracing.enabled = False
        t_off = min(t_off, _null_rand_chain(samples=500_000)[0])
        tracing.enabled = True
        t_on = min(t_on, _null_rand_chain(samples=500_000)[0])
        tracing.drain()
    assert t_on <= 1.5 * t_off + 0.05, (t_on, t_off)
