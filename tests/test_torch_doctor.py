"""The port's flowgraph doctor (``futuresdr_tpu_torch/telemetry/doctor.py``):
the stall watchdog and its diagnosis, the flight recorder, bottleneck
attribution, the ``cancel`` escalation and the serve watchdog.

Against the JAX package's doctor on the same scripted snapshot (duck-typed
blocks, ports and edges, both doctors given the very same objects), the
diagnosis of each stall pattern, the report's lane attribution over the same
drained spans and ``render_markdown`` of the same flight record agree
exactly; the one wording the port changes is the ``compiling`` verdict's
detail (a CUDA-graph capture, not an XLA compile), so that case compares
every other key. Then the port's own runs: a wedged sink trips the watchdog
and names the block, ``doctor_action="cancel"`` turns it into an error with
a flight record, a block wedged in ``init`` is cancelled, the supervisor's
record carries the error count, an in-progress capture reads
``compiling``, a wedged serving engine reads ``serve_wedged``, an engine's
shutdown detaches it, and the sharded runner fills the report's shard
section.
"""

import asyncio
import os
import time

import numpy as np
import pytest
import torch

from futuresdr_tpu.telemetry import doctor as J_doctor
from futuresdr_tpu.telemetry import profile as J_profile
from futuresdr_tpu.telemetry import spans as J_spans
from futuresdr_tpu_torch import Flowgraph, Kernel, Runtime
from futuresdr_tpu_torch.blocks import NullSource, VectorSink, VectorSource
from futuresdr_tpu_torch.config import config
from futuresdr_tpu_torch.ops import stages as T
from futuresdr_tpu_torch.runtime.runtime import FlowgraphCancelled, FlowgraphError
from futuresdr_tpu_torch.telemetry import doctor as T_doctor
from futuresdr_tpu_torch.telemetry import profile as T_profile
from futuresdr_tpu_torch.telemetry import spans as T_spans

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# a scripted snapshot both doctors read
# ---------------------------------------------------------------------------

class _Port:
    def __init__(self, name, space=None, avail=None, finished=False, min_items=1,
                 connected=True):
        self.name, self.min_items, self.connected = name, min_items, connected
        self._space, self._avail, self._fin = space, avail, finished
        self.stalls = self.starved = 0
        if space is not None:
            self.space = lambda: self._space
        if avail is not None:
            self.available = lambda: self._avail
            self.fill = lambda: 0.25
            self.finished = lambda: self._fin


class _K:
    def __init__(self, ins=(), outs=()):
        self.stream_inputs, self.stream_outputs = list(ins), list(outs)


class _WK:
    """A duck-typed WrappedKernel."""

    def __init__(self, name, ins=(), outs=(), inbox=(), progress=0):
        self.instance_name = name
        self.kernel = _K(ins, outs)
        self.inbox = list(inbox)
        self.progress = progress

    def metrics(self):
        return {"work_calls": self.progress, "messages_handled": 0,
                "items_in": {p.name: 0 for p in self.kernel.stream_inputs},
                "items_out": {p.name: 0 for p in self.kernel.stream_outputs},
                "stalls": {}, "starved": {}}


def _chain(pattern):
    """src → mid → snk with the edge state of ``pattern``."""
    if pattern == "backpressured":
        src = _WK("src", outs=[_Port("out", space=0)])
        mid = _WK("mid", ins=[_Port("in", avail=4096)], outs=[_Port("out", space=0)])
        snk = _WK("snk", ins=[_Port("in", avail=4096)])
    elif pattern == "starved":
        src = _WK("src", outs=[_Port("out", space=4096)])
        mid = _WK("mid", ins=[_Port("in", avail=0)], outs=[_Port("out", space=4096)])
        snk = _WK("snk", ins=[_Port("in", avail=0)])
    else:                                     # no full and no empty ring
        src = _WK("src", outs=[_Port("out", space=100)])
        mid = _WK("mid", ins=[_Port("in", avail=50, min_items=10)],
                  outs=[_Port("out", space=100)])
        snk = _WK("snk", ins=[_Port("in", avail=50)])
    return [src, mid, snk], [(src, "out", mid, "in"), (mid, "out", snk, "in")]


def _msg_plane(queued):
    return [_WK("a", inbox=[1] * queued), _WK("b")], []


def _diagnose(mod, blocks, edges, strikes=5):
    d = mod.Doctor()
    att = mod._Attached(7, blocks, edges)
    att.strikes = strikes
    return d.diagnose(att)


@pytest.fixture
def fresh_planes(monkeypatch):
    """Both doctors read a compile-free profile plane: a compile another
    test made inside the no-progress window would read ``compiling``."""
    monkeypatch.setattr(T_profile, "_plane", T_profile.ProfilePlane())
    monkeypatch.setattr(J_profile, "_plane", J_profile.ProfilePlane())


@pytest.mark.parametrize("case", ["backpressured", "starved", "deadlocked", "idle",
                                  "queued"])
def test_diagnosis_matches_the_reference(case, fresh_planes):
    if case in ("idle", "queued"):
        blocks, edges = _msg_plane(3 if case == "queued" else 0)
    else:
        blocks, edges = _chain(case)
    got = _diagnose(T_doctor, blocks, edges)
    want = _diagnose(J_doctor, blocks, edges)
    assert got == want
    assert got["state"] == {"queued": "deadlocked"}.get(case, case)
    if case == "backpressured":
        assert got["suspect_block"] == "snk"
    if case == "starved":
        assert got["suspect_block"] == "src"


@pytest.mark.parametrize("in_progress", [True, False])
def test_compiling_verdict_matches_the_reference(in_progress, fresh_planes):
    """An in-progress (or in-window) compile reads ``compiling``, never
    ``deadlocked``; every key but the detail's wording matches."""
    blocks, edges = _chain("deadlocked")
    out = []
    for mod, prof in ((T_doctor, T_profile), (J_doctor, J_profile)):
        if in_progress:
            with prof.compiling("capt", "warmup", "frame=4096"):
                out.append(_diagnose(mod, blocks, edges))
        else:
            prof.record_compile("capt", "reinit", "frame=4096", 1.5)
            out.append(_diagnose(mod, blocks, edges))
    got, want = out
    assert got["state"] == want["state"] == "compiling"
    assert {k: v for k, v in got.items() if k != "detail"} == \
        {k: v for k, v in want.items() if k != "detail"}
    assert "(CUDA-graph capture) of capt" in got["detail"]


def _record():
    return {"reason": "watchdog:backpressured", "unix_time": 1700000000.5, "span_drops": 3,
            "e2e_latency": {"p50_s": 0.001, "p95_s": 0.004, "p99_s": None},
            "flowgraphs": {"0": {
                "age_s": 12.5,
                "diagnosis": {"state": "backpressured", "detail": "ring full",
                              "suspect_edge": ["a", "out", "b", "in"]},
                "blocks": {"a": {"work_calls": 4, "items_in": {}, "items_out": {"out": 9},
                                 "stalls": {"out": 2}, "starved": {}, "inputs": {}},
                           "b": {"work_calls": 1, "items_in": {"in": 9}, "items_out": {},
                                 "stalls": {}, "starved": {"in": 1},
                                 "inputs": {"in": {"fill": 0.98}}}}}},
            "threads": [{"name": "MainThread", "ident": 1, "daemon": False,
                         "stack": ["f.py:1 in g: x()"]},
                        {"name": "w", "ident": 2, "daemon": True, "stack": []}]}


def test_render_markdown_matches_the_reference():
    assert T_doctor.render_markdown(_record()) == J_doctor.render_markdown(_record())


def _lane_events(mod):
    E = mod.SpanEvent
    evs = []
    for g in range(5):
        t = g * 10_000
        evs += [E(1, "m", t, 2_000, "tpu", "encode", None),
                E(1, "m", t + 2_000, 1_000, "tpu", "H2D", None),
                E(1, "m", t + 3_000, 5_000, "tpu", "compute", None),
                E(2, "w", t + 8_000, 1_000, "tpu", "D2H", None),
                E(2, "w", t + 9_000, 500, "tpu", "decode", None),
                E(3, "b", t, 9_000, "block", "kern", None)]
    evs += [E(4, "s", 100, 300, "shard", "shard:d0", None),
            E(4, "s", 500, 200, "shard", "shard:d1", None),
            E(5, "x", 0, 60_000, "devchain", "devchain[a…x2]",
              {"members": 2, "frames": 5, "dispatches": 5, "frames_per_dispatch": 1,
               "branches": [{"branch": 0}]})]
    return evs


def test_report_attribution_matches_the_reference():
    keys = ("wall_s", "lanes", "blocks", "bottleneck_lane", "bottleneck_busy_frac",
            "host_codec_overlap_frac", "devchain")
    got = T_doctor.Doctor().report(events=_lane_events(T_spans))
    want = J_doctor.Doctor().report(events=_lane_events(J_spans))
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["shard"]["lanes"] == want["shard"]["lanes"]
    assert got["bottleneck_lane"] == "compute"


# ---------------------------------------------------------------------------
# the port's runs
# ---------------------------------------------------------------------------

class WedgeSink(Kernel):
    """Never consumes, never finishes."""

    def __init__(self, dtype):
        super().__init__()
        self.input = self.add_stream_input("in", dtype)

    async def work(self, io, mio, meta):
        pass


class FlakyCopy(Kernel):
    def __init__(self, dtype):
        super().__init__()
        self.input = self.add_stream_input("in", dtype)
        self.output = self.add_stream_output("out", dtype)

    async def work(self, io, mio, meta):
        raise RuntimeError("flaky boom")


def _wedged_fg():
    fg = Flowgraph()
    snk = WedgeSink(np.float32)
    fg.connect(NullSource(np.float32), snk)
    return fg, snk


def test_watchdog_trips_on_a_wedged_sink_and_records_it():
    d = T_doctor.doctor()
    d.enable(interval=0.05, window=3)
    try:
        fg, snk = _wedged_fg()
        rt = Runtime()
        running = rt.start(fg)
        t0 = time.monotonic()
        while (d.last_trip or {}).get("state") != "backpressured" and \
                time.monotonic() - t0 < 10:
            time.sleep(0.05)
        trip = d.last_trip
        assert trip["state"] == "backpressured"
        assert trip["suspect_block"] == snk.meta.instance_name
        rec = d.last_report
        assert rec["reason"] == "watchdog:backpressured"
        assert any(t["stack"] for t in rec["threads"])
        running.handle.terminate_sync()
        running.wait_sync()
    finally:
        d.disable()
        d.last_trip = None


def test_doctor_cancel_converts_wedge_to_error(tmp_path, monkeypatch):
    """With ``doctor_action="cancel"`` a wedged flowgraph becomes a
    FlowgraphError carrying the flight record's path."""
    monkeypatch.setattr(config(), "doctor_action", "cancel")
    monkeypatch.setattr(config(), "doctor_dir", str(tmp_path))
    d = T_doctor.doctor()
    d.enable(interval=0.05, window=3)
    try:
        with pytest.raises(FlowgraphError) as ei:
            Runtime().run(_wedged_fg()[0])
        e = ei.value
        assert any(isinstance(x, FlowgraphCancelled) for x in e.errors)
        assert "doctor watchdog: backpressured" in str(e)
        assert e.flight_record is not None and os.path.exists(e.flight_record)
        assert os.path.exists(e.flight_record[:-5] + ".md")
    finally:
        d.disable()
        d.last_trip = None


def test_doctor_cancel_unwedges_init_barrier(monkeypatch):
    """A block wedged inside ``init()`` never answers the barrier: the
    doctor's cancel still ends the run with an error."""

    class WedgedInit(Kernel):
        def __init__(self, dtype):
            super().__init__()
            self.input = self.add_stream_input("in", dtype)

        async def init(self, mio, meta):
            await asyncio.sleep(3600)

    monkeypatch.setattr(config(), "doctor_action", "cancel")
    d = T_doctor.doctor()
    d.enable(interval=0.05, window=3)
    try:
        fg = Flowgraph()
        fg.connect(NullSource(np.float32), WedgedInit(np.float32))
        t0 = time.perf_counter()
        with pytest.raises(FlowgraphError) as ei:
            Runtime().run(fg)
        assert time.perf_counter() - t0 < 15.0
        assert any(isinstance(x, FlowgraphCancelled) for x in ei.value.errors)
    finally:
        d.disable()
        d.last_trip = None


def test_supervisor_flight_record_carries_error_count():
    d = T_doctor.doctor()
    d.enable(interval=30.0, window=5)
    try:
        fg = Flowgraph()
        bad = FlakyCopy(np.float32)
        fg.connect(VectorSource(np.zeros(1000, np.float32)), bad, VectorSink(np.float32))
        with pytest.raises(FlowgraphError):
            Runtime().run(fg)
        sup = (d.last_report or {}).get("supervisor")
        assert sup is not None
        assert sup["block_errors"] == 1
        assert sup["blocks"] == [fg.wrapped(bad).instance_name]
        assert sup["policy_decisions"][0]["action"] == "fail_fast"
    finally:
        d.disable()
        d.last_trip = None


def test_run_deadline_attaches_the_flight_record(tmp_path, monkeypatch):
    monkeypatch.setattr(config(), "doctor_dir", str(tmp_path))
    monkeypatch.setattr(config(), "run_timeout_grace", 3.0)
    with pytest.raises(FlowgraphError) as ei:
        Runtime().run(_wedged_fg()[0], timeout=0.5)
    assert ei.value.flight_record and os.path.exists(ei.value.flight_record)
    assert T_doctor.doctor().last_report["reason"].startswith("run_timeout:")


def test_a_capture_in_progress_reads_compiling_not_deadlocked(fresh_planes):
    """A flowgraph that makes no progress while a program capture runs is
    ``compiling``; the window re-arms, and no flight record fires."""
    d = T_doctor.Doctor()
    d.window = 2
    blocks, edges = _chain("deadlocked")
    key = d.attach(blocks, edges)
    try:
        with T_profile.compiling("capture_probe", "warmup", "frame=262144"):
            for _ in range(3):
                d.tick()
        att = d._fgs[key]
        assert att.diagnosis["state"] == "compiling" and not att.tripped
        assert d.last_report is None
    finally:
        d.detach(key)


def _serve_pipe():
    return T.Pipeline([T.fir_stage(np.hanning(31).astype(np.float32), fft_len=256),
                       T.rotator_stage(0.03)], np.complex64)


def test_doctor_trips_serve_wedged_and_reports_serve_section():
    from futuresdr_tpu_torch.serve import ServeEngine
    d = T_doctor.doctor()
    eng = ServeEngine(_serve_pipe(), frame_size=1024, app="wedge", buckets=(1,),
                      queue_frames=4, device="cpu")
    try:
        att = next(a for a in d._serve.values() if a.engine() is eng)
        s = eng.admit(tenant="t", sid="wedged_sid")
        assert eng.submit(s.sid, np.ones(1024, np.complex64))
        saved = d.window
        d.window = 2
        try:
            for _ in range(4):               # a baseline, then strikes past the window
                d._tick_serve()
        finally:
            d.window = saved
        diag = att.diagnosis
        assert diag and diag["state"] == "serve_wedged"
        assert diag["app"] == "wedge"
        assert "wedged_sid" in diag["stuck_sessions"]
        assert diag["pending_frames"] == 1
        rec = d.flight_record("test")
        assert rec["serve"]["wedge"]["diagnosis"]["state"] == "serve_wedged"
        eng.step()                           # progress re-arms
        d._tick_serve()
        assert att.diagnosis is None and not att.tripped
        rep = d.report(events=[])
        assert rep["serve"]["wedge"]["app"] == "wedge"
        assert rep["serve"]["wedge"]["capacity"] == 1
    finally:
        eng.shutdown()


def test_engine_shutdown_detaches_from_doctor():
    from futuresdr_tpu_torch.serve import ServeEngine
    d = T_doctor.doctor()
    eng = ServeEngine(_serve_pipe(), frame_size=1024, app="detach", buckets=(1,),
                      device="cpu")
    assert any(a.engine() is eng for a in d._serve.values())
    eng.shutdown()
    assert not any(a.engine() is eng for a in d._serve.values())


def test_doctor_shard_section_and_per_device_gauges(monkeypatch):
    """The sharded runner's plan and live stats land under the report's
    ``shard`` section, its ``shard:d<i>`` spans make one lane a device, and
    each device's program is a ``fsdr_mfu_device`` entry."""
    from futuresdr_tpu_torch.shard import ShardedProgram, ShardRunner, clear_plans, plan_shard
    from futuresdr_tpu_torch.telemetry import prom
    monkeypatch.setattr(config(), "peak_flops", 1e12)
    monkeypatch.setattr(config(), "peak_hbm_gbps", 100.0)
    monkeypatch.setattr(config(), "virtual_devices", 4)
    clear_plans()
    D = 4
    pipe = T.Pipeline([T.fir_stage(np.hanning(33).astype(np.float32)), T.mag2_stage()],
                      np.complex64)
    prog = ShardedProgram(pipe, plan_shard(pipe, mode="data", n_devices=D, device="cpu"),
                          name="doc_shard")
    runner = ShardRunner(prog, 8192, k=1, name="doc_shard")
    rng = np.random.default_rng(0)
    rows = (rng.standard_normal((D, 8192)) + 1j * rng.standard_normal((D, 8192))
            ).astype(np.complex64)
    T_spans.enable(True)
    try:
        T_spans.recorder().drain()
        runner.run_group(rows)
        evs = T_spans.recorder().drain()
    finally:
        T_spans.enable(False)
    rep = T_doctor.doctor().report(events=evs)
    plans = rep["shard"]["plans"]
    assert plans["doc_shard"]["applied"] == "data"
    assert plans["doc_shard"]["n_devices"] == D
    assert plans["doc_shard"]["dispatches"] == 1
    lanes = rep["shard"]["lanes"]
    assert set(lanes) == {f"shard:d{i}" for i in range(D)}
    assert all(v["spans"] == 1 for v in lanes.values())
    pl = T_profile.plane()
    pl.ensure_costs()
    pl.update_live_gauges(min_interval=0.0)
    runner.run_group(rows)
    pl.update_live_gauges(min_interval=0.0)
    progs = pl.roofline_report()["programs"]
    dev_entries = {k: v for k, v in progs.items() if k.startswith("doc_shard@dev")}
    assert len(dev_entries) == D, sorted(progs)
    assert all(v["units"] >= 1 for v in dev_entries.values())
    assert {v["device"] for v in dev_entries.values()} == {str(i) for i in range(D)}
    assert progs["doc_shard"]["units"] == 2 * D
    text = prom.registry().render()
    assert "fsdr_mfu_device" in text and 'program="doc_shard"' in text
    clear_plans()


def test_verdicts_read_the_live_diagnoses(fresh_planes):
    d = T_doctor.Doctor()
    assert d.verdicts()["verdict"] == "ok"
    blocks, edges = _chain("starved")
    key = d.attach(blocks, edges)
    d._fgs[key].diagnosis = {"state": "starved"}
    assert d.verdicts()["verdict"] == "starved"
