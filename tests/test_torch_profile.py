"""The port's profile plane (``futuresdr_tpu_torch/telemetry/profile.py``):
compile (capture) observability and the live roofline over the analytic
costs.

Against the JAX package's plane on the same scripted compile records,
dispatch counts, costs and peaks, at the same fake clock, the storm report,
``compiling_or_recent``, the live gauges and the roofline table agree
exactly. The port's own: every capture site bills its reason (a kernel's
first init ``warmup``, a restart's ``reinit``, a recovery ``recover``, a
wire switch ``reinit`` with ``wire:<fmt>``, a serving bucket ``serve_bucket``,
a resident ``Pipeline.compile`` ``warmup``, a plan sweep ``autotune``); the
registered costs are ``utils/roofline.program_cost``'s; the peaks are None on
the CPU unless config pins them; ``/readyz`` gates on the serving programs'
storms only; the doctor and the profile view carry the precision plans.
"""

import json

import numpy as np
import pytest
import torch

from futuresdr_tpu.telemetry import profile as J_profile
from futuresdr_tpu_torch import Flowgraph, Runtime
from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
from futuresdr_tpu_torch.config import config
from futuresdr_tpu_torch.ops import stages as T
from futuresdr_tpu_torch.telemetry import journal as T_journal
from futuresdr_tpu_torch.telemetry import profile as T_profile
from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

CPU = TpuInstance("cpu")
FRAME = 4096
TAPS = np.hanning(31).astype(np.float32)
PEAKS = {"flops": 2e12, "hbm_bytes": 5e11, "chip": "config"}


class _Clock:
    """A fake ``time`` for both planes: ``monotonic`` and ``perf_counter``
    read a value the test sets."""

    def __init__(self, t=1000.0):
        self.t = float(t)

    def monotonic(self):
        return self.t

    def perf_counter(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(T_profile, "time", c)
    monkeypatch.setattr(J_profile, "time", c)
    return c


def _compile_story(mod, clock):
    """Scripted compile records: a storm with signature churn, a benign
    autotune burst, a quiet program, one compile in progress."""
    p = mod.ProfilePlane()
    out = []
    for i, (prog, reason, sig, dt) in enumerate([
            ("k1", "warmup", "frame=4096", 0.5), ("k1", "reinit", "frame=4096", 0.25),
            ("k1", "reinit", "wire:sc16", 0.125), ("tune", "autotune", "a", 1.0),
            ("tune", "autotune", "b", 1.0), ("tune", "autotune", "c", 1.0),
            ("tune", "autotune", "d", 1.0), ("k2", "warmup", "frame=1024", 2.0),
            ("serve:x", "serve_bucket", "cap=4", 0.75)]):
        clock.t = 1000.0 + 10 * i
        p.record_compile(prog, reason, sig, dt)
        out.append(p.compiling_or_recent(5.0))
    clock.t = 1095.0
    out += [p.storm_report(), p.storm_report(window_s=20.0), p.storm_report(window_s=200.0),
            p.compiling_or_recent(1.0), p.compiling_or_recent(20.0),
            p.compiling_or_recent(200.0)]
    clock.t = 1200.0
    out.append(p.compiling_or_recent(30.0))          # only autotune recent: None
    with p.compiling("k3", "recover", "frame=8192"):
        clock.t = 1203.5
        out += [p.compiling_or_recent(1.0), p.active_compiles()]
    out += [p.active_compiles(), p.compiles_total, round(p.compile_seconds_total, 9)]
    return out


def test_storm_and_compiling_match_the_reference(clock):
    got = _compile_story(T_profile, clock)
    want = _compile_story(J_profile, clock)
    assert got == want
    storms = got[9]
    assert [s["program"] for s in storms] == []                  # 60 s window at 1095
    assert [s["program"] for s in got[11]] == ["k1"] and got[11][0]["signature_churn"]
    assert got[-5]["in_progress"] and got[-5]["program"] == "k3"


def _gauge_story(mod, clock):
    p = mod.ProfilePlane()
    p._peaks = lambda: dict(PEAKS)
    a = p.register("prog_a", cost={"flops": 4e9, "bytes": 2e9}, dtype="bf16")
    b = p.register("prog_b", cost_thunk=lambda: {"flops": 1e8, "bytes": 8e8}, dtype="bf16")
    d0 = p.register("prog_b", cost={"flops": 1e7, "bytes": 3e7}, dtype="bf16", device="0")
    p.register("prog_c", cost_thunk=lambda: (_ for _ in ()).throw(RuntimeError("x")))
    out = []
    clock.t = 10.0
    p.update_live_gauges(min_interval=0.0)          # seeds a's window only
    for step in range(1, 6):
        t = 10.0 + step
        a.dispatch(4, t=t)
        b.dispatch(2, t=t)
        d0.dispatch(1, t=t)
    clock.t = 15.0
    p.ensure_costs()
    p.update_live_gauges(min_interval=0.0)
    out.append([(e.name, e.device, e.units, e.mfu, e.hbm_util, e.achieved_flops,
                 e.achieved_bytes) for e in p.programs()])
    for step in range(6, 9):
        a.dispatch(4, t=10.0 + step)
    clock.t = 15.1
    p.update_live_gauges(min_interval=0.25)          # inside the interval: no change
    clock.t = 18.0
    p.update_live_gauges()
    out.append([(e.name, e.units, e.mfu, e.hbm_util) for e in p.programs()])
    rep = p.roofline_report()
    out.append(rep)
    out.append(p.register("prog_a", cost_thunk=lambda: {"flops": 1.0, "bytes": 1.0}).units)
    out.append(p.roofline_report()["programs"]["prog_a"])
    return out


def test_live_gauges_and_roofline_match_the_reference(clock):
    got = _gauge_story(T_profile, clock)
    want = _gauge_story(J_profile, clock)
    assert got == want
    rep = got[2]
    assert rep["peaks"] == PEAKS and rep["ridge_flop_per_byte"] == 4.0
    assert 0 < rep["programs"]["prog_a"]["mfu"] <= 1.05
    assert rep["programs"]["prog_b@dev0"]["device"] == "0"
    assert "mfu" not in rep["programs"]["prog_c"]              # a failing thunk degrades


def test_f32_programs_grade_against_the_f32_peak(clock):
    """The one place the port's arithmetic departs from the reference's: an
    f32 program's operations peak is the card's published float32 figure
    (``utils/roofline.dtype_peak_flops``), where the reference halves its
    bf16 figure."""
    p = T_profile.ProfilePlane()
    p._peaks = lambda: {"flops": 989e12, "f32_flops": 67e12, "hbm_bytes": 3.35e12}
    e = p.register("f32_prog", cost={"flops": 67e9, "bytes": 1.0})
    clock.t = 1.0
    p.update_live_gauges(min_interval=0.0)
    e.dispatch(10, t=1.0)
    clock.t = 2.0
    p.update_live_gauges(min_interval=0.0)
    assert e.mfu == pytest.approx(0.01)


def test_peaks_none_on_the_cpu_and_pinned_by_config(monkeypatch):
    plane = T_profile.ProfilePlane()
    assert plane._peaks() is None                   # no card here
    monkeypatch.setattr(config(), "peak_flops", 1e12)
    monkeypatch.setattr(config(), "peak_hbm_gbps", 100.0)
    assert plane._peaks() == {"flops": 1e12, "hbm_bytes": 1e11, "chip": "config"}


def test_failed_compile_window_bills_nothing():
    plane = T_profile.ProfilePlane()
    with pytest.raises(ValueError):
        with plane.compiling("boom", "warmup", "s"):
            raise ValueError("capture failed")
    assert plane.compiles_total == 0 and plane.active_compiles() == []
    with plane.compiling("ok", "warmup", "s") as win:
        pass
    assert plane.compiles_total == 1 and win.seconds >= 0.0


def test_compiles_journal_every_record():
    T_journal.reset_journal()
    T_profile.record_compile("journal_probe", "warmup", "sig", 0.5)
    ev = T_journal.events(cat="compile")["events"]
    assert [(e["program"], e["reason"], e["seconds"]) for e in ev] == \
        [("journal_probe", "warmup", 0.5)]


# ---------------------------------------------------------------------------
# the capture sites bill their reasons
# ---------------------------------------------------------------------------

def _reasons(program):
    return {labels["reason"]: int(v) for labels, v in T_profile.COMPILES.samples()
            if labels["program"] == program}


def _kernel(name, **kw):
    tk = TpuKernel([T.fir_stage(TAPS, fft_len=512), T.rotator_stage(0.05)], np.complex64,
                   frame_size=FRAME, inst=CPU, **kw)
    tk.meta.instance_name = name
    return tk


def _run(tk, frames=6, seed=0):
    rng = np.random.default_rng(seed)
    data = (rng.standard_normal(frames * FRAME) + 1j * rng.standard_normal(frames * FRAME)
            ).astype(np.complex64)
    fg = Flowgraph()
    snk = VectorSink(np.complex64)
    fg.connect(VectorSource(data), tk, snk)
    Runtime().run(fg)
    return np.asarray(snk.items())


def test_kernel_init_reinit_and_wire_switch_bill_their_reasons():
    tk = _kernel("prof_kernel_a", frames_per_dispatch=2, wire="f32")
    _run(tk)
    assert _reasons("prof_kernel_a") == {"warmup": 1}
    import asyncio
    asyncio.run(tk.init(tk.mio, tk.meta))           # a restart's fresh init
    assert _reasons("prof_kernel_a") == {"warmup": 1, "reinit": 1}
    tk._apply_wire_program("sc16")
    assert _reasons("prof_kernel_a") == {"warmup": 1, "reinit": 2}
    recent = [r for r in T_profile.plane()._recent if r[1] == "prof_kernel_a"]
    assert [r[3] for r in recent][-1] == "wire:sc16"
    assert recent[0][3] == "frame=4096,wire=f32,k=2"


def test_kernel_registers_the_wired_megabatch_cost_and_bills_groups(monkeypatch):
    from futuresdr_tpu_torch.utils.roofline import program_cost
    monkeypatch.setattr(config(), "peak_flops", 1e12)
    monkeypatch.setattr(config(), "peak_hbm_gbps", 100.0)
    tk = _kernel("prof_kernel_b", frames_per_dispatch=2, wire="f32")
    _run(tk, frames=8)
    entry = T_profile.plane().program("prof_kernel_b")
    assert entry.units == tk.dispatches == 4
    assert entry.ensure_cost() == program_cost(tk.pipeline, FRAME, wire="f32", k=2)
    rep = T_profile.plane().roofline_report()["programs"]["prof_kernel_b"]
    assert rep["flops_per_unit"] > 0 and rep["bytes_per_unit"] > 0
    assert 0 < rep["mfu_avg"] <= 1.05 and 0 < rep["hbm_util_avg"] <= 1.05


def test_resident_compile_registers_and_bills_calls():
    pipe = T.Pipeline([T.fir_stage(TAPS, fft_len=512)], np.complex64)
    fn, carry = pipe.compile(FRAME, "cpu", program="prof_resident")
    assert _reasons("prof_resident") == {"warmup": 1}
    for _ in range(3):
        carry, _y = fn(carry, torch.zeros(FRAME, dtype=torch.complex64))
    assert T_profile.plane().program("prof_resident").units == 3
    fn2, _c = pipe.compile(FRAME, "cpu", program="prof_resident", reason=None)
    assert _reasons("prof_resident") == {"warmup": 1}     # the caller's window


def test_serve_bucket_and_sweep_bill_their_reasons():
    from futuresdr_tpu_torch.serve import ServeEngine
    from futuresdr_tpu_torch.tpu import kernel_tune
    pipe = T.Pipeline([T.rotator_stage(0.03)], np.complex64)
    eng = ServeEngine(pipe, frame_size=1024, app="prof_serve", device="cpu", buckets=(1,))
    try:
        s = eng.admit(tenant="t")
        eng.submit(s.sid, np.ones(1024, np.complex64))
        eng.step()
    finally:
        eng.shutdown()
    assert _reasons("serve:prof_serve") == {"serve_bucket": 1}
    assert set(eng.compile_seconds) == {(1, 1, "base")}
    before = _reasons("autotune").get("autotune", 0)
    kernel_tune.sweep_plans(device="cpu", reps=1,
                            shapes=[("rotator", "small", {"n": 4096})])
    assert _reasons("autotune")["autotune"] == before + 1
    assert not [s for s in T_profile.plane().storm_report() if s["program"] == "autotune"]


def test_recover_bills_a_recover_window():
    from futuresdr_tpu_torch.runtime import faults
    tk = _kernel("prof_kernel_r", frames_per_dispatch=1, wire="f32", checkpoint_every=1)
    from futuresdr_tpu_torch.runtime.block import BlockPolicy
    tk.policy = BlockPolicy(on_error="restart", max_restarts=3, backoff=0.0)
    faults.arm("dispatch", rate=1.0, seed=1, max_faults=1)
    try:
        got = _run(tk, frames=6)
    finally:
        faults.disarm()
    assert len(got) == 6 * FRAME
    assert _reasons("prof_kernel_r").get("recover", 0) == 1


# ---------------------------------------------------------------------------
# readiness and the reports
# ---------------------------------------------------------------------------

def test_readiness_storm_gate_scopes_to_serving_programs():
    """``/readyz`` gates on a registered app's serving-program storms only:
    an unrelated kernel's churn never takes the pod out of rotation (the
    reference's case; the port also scopes to the apps it serves)."""
    from futuresdr_tpu_torch.serve import ServeEngine, api, register_app, unregister_app
    pipe = T.Pipeline([T.rotator_stage(0.03)], np.complex64)
    eng = ServeEngine(pipe, frame_size=1024, app="readyz_probe", device="cpu", buckets=(1,))
    register_app(eng)
    try:
        for _ in range(4):                          # an unrelated kernel "storm"
            T_profile.record_compile("tk_readyz_probe", "warmup", "sig", 0.01)
        assert any(s["program"] == "tk_readyz_probe"
                   for s in T_profile.plane().storm_report())
        ready, detail = api.readiness()
        assert ready and detail["compile_storms"] is None
        for _ in range(4):                          # an unregistered serving program
            T_profile.record_compile("serve:not_served", "serve_bucket", "cap=2", 0.01)
        assert api.readiness()[0]
        for _ in range(4):                          # the served app's own storm
            T_profile.record_compile("serve:readyz_probe", "serve_bucket", "cap=2", 0.01)
        ready, detail = api.readiness()
        assert not ready
        assert [s["program"] for s in detail["compile_storms"]] == ["serve:readyz_probe"]
    finally:
        unregister_app("readyz_probe")
        eng.shutdown()
        plane = T_profile.plane()
        with plane._lock:
            keep = [e for e in plane._recent if e[1] not in
                    ("tk_readyz_probe", "serve:readyz_probe", "serve:not_served")]
            plane._recent.clear()
            plane._recent.extend(keep)


def test_doctor_and_profile_report_carry_plans():
    from futuresdr_tpu_torch.ops import precision as P
    from futuresdr_tpu_torch.telemetry import doctor as doc
    p = T.Pipeline([T.fir_stage(np.hanning(64).astype(np.float32), fft_len=2048, name="fir"),
                    T.fft_stage(2048)], np.complex64)
    _low, plan = P.plan_interior_precision(p, mode="auto", budget_db=40.0, device="cpu")
    P.note_plan("t-precision-prog", plan)
    try:
        snap = T_profile.plane().snapshot()
        assert snap["precision"]["t-precision-prog"]["lowered"] == plan.lowered
        rep = doc.report([])
        assert rep["precision"]["t-precision-prog"]["mode"] == "auto"
        json.dumps(snap["precision"])
    finally:
        P.clear_plans()


def test_snapshot_is_json_and_carries_compiles():
    T_profile.record_compile("snap_probe", "cost", "s", 0.0)
    snap = T_profile.plane().snapshot()
    assert snap["compiles"]["snap_probe"] == {"cost": 1}
    json.dumps(snap, default=str)
