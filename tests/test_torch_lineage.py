"""The port's frame lineage (``futuresdr_tpu_torch/telemetry/lineage.py``)
and the paths that stamp it.

Against the JAX package's tracer on the same scripted stamps, the records,
the per-lane attribution and ``tail_report`` (slowest lane, slowest session
and frames, p50/p99) agree exactly, and so do the exemplars the sampled
frames attach to the latency histogram. Then the port's own paths: with
every frame sampled, a streamed ``TpuKernel`` run (K = 1 and 4, the codec
pool on) stamps each frame's ingest, encode, H2D, dispatch, D2H, decode and
emit in order and finishes its record under the block's name, each frame
observes its own latency in ``fsdr_e2e_latency_seconds{source}`` with its
trace id as the bucket's exemplar, the serving engine finishes each lane's
records under its session and tenant, and the sharded runner one record a
group; at stride 0 nothing is sampled.
"""

import numpy as np
import pytest
import torch

from futuresdr_tpu.telemetry import hist as J_hist
from futuresdr_tpu.telemetry import lineage as J_lineage
from futuresdr_tpu_torch import Flowgraph, Runtime
from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
from futuresdr_tpu_torch.config import config
from futuresdr_tpu_torch.ops import stages as T
from futuresdr_tpu_torch.telemetry import hist as T_hist
from futuresdr_tpu_torch.telemetry import lineage as T_lineage
from futuresdr_tpu_torch.telemetry.doctor import E2E_LATENCY
from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

CPU = TpuInstance("cpu")
FRAME = 4096
TAPS = np.hanning(31).astype(np.float32)
LANES = ("ingest", "encode", "H2D", "dispatch", "D2H", "decode", "emit")


@pytest.fixture
def every_frame(monkeypatch):
    monkeypatch.setattr(config(), "lineage_stride", 1)
    tr = T_lineage.reset_tracer()
    yield tr
    monkeypatch.undo()
    T_lineage.reset_tracer()


# the scripted stamps: (lane deltas in ns a frame, session, tenant)
_SCRIPT = [((0, 40, 10, 300, 20, 50, 5), "s1", "a"),
           ((0, 60, 15, 250, 25, 40, 5), "s1", "a"),
           ((0, 30, 500, 200, 20, 30, 5), "s2", "b"),
           ((0, 45, 12, 900, 18, 35, 5), "s3", "b"),
           ((0, 20, 10, 100, 10, 10, 5), None, None),
           ((0, 55, None, 280, 22, 44, 5), "s2", "b"),      # a record missing H2D
           ((0, 50, 10, 260, 20, 30, None), "s1", "a")]     # no emit: no e2e


def _drive(mod, tracer):
    out = []
    for i, (deltas, sess, ten) in enumerate(_SCRIPT):
        tid = tracer.sample()
        t = 1_000_000 * (i + 1)
        for lane, d in zip(LANES, deltas):
            if d is None:
                continue
            t += d
            tracer.stamp(tid, lane, t)
        out.append(tracer.finish(tid, source="blk", session=sess, tenant=ten))
    recs = tracer.records()
    strip = lambda d: {**d, "stamps": [{k: v for k, v in s.items() if k != "thread_ident"}  # noqa
                                       for s in d["stamps"]]}
    return ([strip(d) for d in out], [r.lane_ns() for r in recs],
            [r.e2e_ns() for r in recs], mod.tail_report(recs, n_slowest=3),
            mod.tail_report([]), tracer.dropped)


def test_records_and_tail_attribution_match_the_reference():
    got = _drive(T_lineage, T_lineage.LineageTracer(stride=1, ring=16))
    want = _drive(J_lineage, J_lineage.LineageTracer(stride=1, ring=16))
    assert got == want
    tail = got[3]
    assert tail["slowest_lane"] == "compute" and tail["slowest_session"] == "s3"
    assert [f["id"] for f in tail["slowest_frames"]] == [4, 3, 1]
    assert tail["samples"] == 7 and tail["e2e_samples"] == 6


@pytest.mark.parametrize("stride,ring", [(3, 4), (0, 4), (1, 2)])
def test_sampling_and_bounds_match_the_reference(stride, ring):
    def drive(mod):
        tr = mod.LineageTracer(stride=stride, ring=ring)
        tids = [tr.sample() for _ in range(40)]
        for tid in tids[::2]:
            tr.stamp(tid, "ingest", 5)
            tr.finish(tid, source="x")
        return tids, [r.as_dict()["id"] for r in tr.records()], tr.dropped
    assert drive(T_lineage) == drive(J_lineage)


def test_exemplars_from_the_same_stamps_match_the_reference(monkeypatch):
    def drive(hist, lineage):
        monkeypatch.setattr(hist, "_time", lambda: 7.0)
        h = hist.Log2Hist()
        tr = lineage.LineageTracer(stride=2, ring=8)
        for i in range(12):
            tid = tr.sample()
            lat = 1e-4 * (i + 1) ** 2
            h.observe(lat)
            if tid:
                h.exemplar(lat, str(tid))
        return h.exemplars(), h.snapshot()
    assert drive(T_hist, T_lineage) == drive(J_hist, J_lineage)


def _c64(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


@pytest.mark.parametrize("k", [1, 4])
def test_streamed_frames_carry_full_lineage(every_frame, k):
    tk = TpuKernel([T.fir_stage(TAPS, fft_len=512), T.rotator_stage(0.05)], np.complex64,
                   frame_size=FRAME, inst=CPU, frames_per_dispatch=k, wire="f32")
    tk.meta.instance_name = f"lineage_k{k}"
    hist = E2E_LATENCY.labels(source=f"lineage_k{k}")
    before = hist.count
    fg = Flowgraph()
    snk = VectorSink(np.complex64)
    fg.connect(VectorSource(_c64(8 * FRAME)), tk, snk)
    Runtime().run(fg)
    assert len(snk.items()) == 8 * FRAME
    recs = [r for r in every_frame.records() if r.source == f"lineage_k{k}"]
    assert len(recs) == 8
    for r in recs:
        lanes = [s[0] for s in r.stamps]
        assert lanes == list(LANES), lanes
        ts = [s[1] for s in r.stamps]
        assert ts == sorted(ts)
        assert set(r.lane_ns()) == {"encode", "H2D", "compute", "D2H", "decode", "drain"}
    assert hist.count == before + 8
    assert hist.exemplars()                    # the sampled frames' trace ids
    assert T_lineage.tail_report(recs)["e2e_samples"] == 8


def test_stride_zero_samples_nothing(monkeypatch):
    monkeypatch.setattr(config(), "lineage_stride", 0)
    tr = T_lineage.reset_tracer()
    try:
        tk = TpuKernel([T.rotator_stage(0.05)], np.complex64, frame_size=FRAME, inst=CPU,
                       wire="f32")
        fg = Flowgraph()
        fg.connect(VectorSource(_c64(4 * FRAME)), tk, VectorSink(np.complex64))
        Runtime().run(fg)
        assert tr.records() == [] and tr.sample() == 0
    finally:
        monkeypatch.undo()
        T_lineage.reset_tracer()


def test_serve_lanes_finish_records_under_their_sessions(every_frame):
    from futuresdr_tpu_torch.serve import ServeEngine
    pipe = T.Pipeline([T.rotator_stage(0.03)], np.complex64)
    eng = ServeEngine(pipe, frame_size=1024, app="lin_serve", device="cpu", buckets=(2,))
    try:
        a, b = eng.admit(tenant="ta", sid="sa"), eng.admit(tenant="tb", sid="sb")
        for i in range(3):
            eng.submit(a.sid, _c64(1024, i))
            eng.submit(b.sid, _c64(1024, 10 + i))
            eng.step()
        eng.step()
    finally:
        eng.shutdown()
    recs = [r for r in every_frame.records() if r.source == "serve:lin_serve"]
    assert len(recs) == 6
    assert {(r.session, r.tenant) for r in recs} == {("sa", "ta"), ("sb", "tb")}
    for r in recs:
        assert [s[0] for s in r.stamps] == list(LANES)
    tail = T_lineage.tail_report(recs)
    assert tail["slowest_session"] in ("sa", "sb") and tail["e2e_samples"] == 6
    assert eng.e2e_hist.exemplars()


def test_sharded_runner_records_a_trace_a_group(every_frame, monkeypatch):
    from futuresdr_tpu_torch.shard import ShardedProgram, ShardRunner, clear_plans, plan_shard
    monkeypatch.setattr(config(), "virtual_devices", 2)
    pipe = T.Pipeline([T.mag2_stage()], np.complex64)
    prog = ShardedProgram(pipe, plan_shard(pipe, mode="data", n_devices=2, device="cpu"),
                          name="lin_shard")
    runner = ShardRunner(prog, 1024, k=1, name="lin_shard")
    for _ in range(3):
        runner.run_group(np.ones((2, 1024), np.complex64))
    recs = [r for r in every_frame.records() if r.source == "shard:lin_shard"]
    assert len(recs) == 3
    assert [s[0] for s in recs[0].stamps] == ["ingest", "H2D", "dispatch", "D2H", "emit"]
    clear_plans()
