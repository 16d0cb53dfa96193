"""Crash-safe serving on the port's engine, on the CPU: the counterparts of
``tests/test_serve_robust.py`` (durable session snapshots and their restore,
the drain lifecycle with ``/healthz``, ``/readyz`` and ``Retry-After`` on the
stdlib control port, the shedding ladder and both brownout levers).

Not ported yet, each waiting for ROADMAP item 4b: the doctor's serve
watchdog (``test_doctor_trips_serve_wedged_and_reports_serve_section``,
``test_engine_shutdown_detaches_from_doctor``) and ``/readyz``'s compile-storm
gate (``test_readiness_storm_gate_scopes_to_serving_programs``).

Resumed and shed streams are held bit for bit against the port's bare
``Pipeline``; the brownout windows against it by SNR (int8 >= 20 dB as in the
reference; bf16 >= 40 dB).
"""

import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from futuresdr_tpu_torch.ops import stages as T
from futuresdr_tpu_torch.serve import (ServeDraining, ServeEngine, ServeOverload,
                                       ShedLadder, register_app, unregister_app)

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

FRAME = 1024


def _pipe():
    return T.Pipeline([T.fir_stage(np.hanning(31).astype(np.float32), fft_len=256),
                       T.rotator_stage(0.03)], np.complex64)


def _engine(app, pipe=None, **kw):
    return ServeEngine(pipe or _pipe(), frame_size=FRAME, app=app, device="cpu", **kw)


def _frames(n, seed=0, frame=FRAME):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(frame) + 1j * rng.standard_normal(frame))
            .astype(np.complex64) for _ in range(n)]


def _solo(pipe, frames):
    fn, carry = pipe.compile(FRAME, "cpu", donate=False)
    out = []
    for f in frames:
        carry, y = fn(carry, torch.from_numpy(f))
        out.append(y.numpy().copy())
    return out


def _drain_results(eng, *sessions):
    while eng.step():
        pass
    return [eng.results(s.sid) for s in sessions]


def _bit_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# durable session state: a new engine resumes bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 3])
def test_persisted_sessions_resume_bit_identically(tmp_path, depth):
    da, db = _frames(9, 1), _frames(9, 2)
    expa, expb = _solo(_pipe(), da), _solo(_pipe(), db)
    a = _engine("crashsafe", buckets=(2,), queue_frames=16, persist_dir=str(tmp_path),
                persist_every=1, inflight=depth)
    sa = a.admit(tenant="t0", sid="dura")
    sb = a.admit(tenant="t1", sid="durb")
    for fa, fb in zip(da[:5], db[:5]):
        assert a.submit(sa.sid, fa) and a.submit(sb.sid, fb)
    outa, outb = _drain_results(a, sa, sb)
    assert len(outa) == 5 and len(outb) == 5
    a.flush_persist()                # then a "crash": never closed, never drained
    b = _engine("crashsafe", buckets=(2,), queue_frames=16, persist_dir=str(tmp_path),
                persist_every=1, inflight=depth)
    assert b.restored_sessions == 2
    assert b.health()["ready"] and b.health()["compiled"]      # warmed on restore
    ra, rb = b.table.get("dura"), b.table.get("durb")
    assert ra.state == "active" and ra.tenant == "t0"
    assert ra.frames_out == 5 and rb.frames_out == 5
    for fa, fb in zip(da[5:], db[5:]):
        assert b.submit("dura", fa) and b.submit("durb", fb)
    tail_a, tail_b = _drain_results(b, ra, rb)
    _bit_equal(outa + tail_a, expa)
    _bit_equal(outb + tail_b, expb)


def test_corrupted_snapshot_skipped_per_session(tmp_path):
    a = _engine("corrupt", buckets=(2,), queue_frames=8, persist_dir=str(tmp_path),
                persist_every=1)
    a.admit(tenant="t", sid="good")
    a.admit(tenant="t", sid="bad")
    for f in _frames(2, 3):
        a.submit("good", f)
        a.submit("bad", f)
    while a.step():
        pass
    a.flush_persist()
    path = a._store.path("bad")
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(path, "wb").write(bytes(data))
    b = _engine("corrupt", buckets=(2,), queue_frames=8, persist_dir=str(tmp_path),
                persist_every=1)
    assert b.restored_sessions == 1
    assert b.table.get("good") is not None and b.table.get("bad") is None


def test_clean_close_and_retire_purge_snapshots(tmp_path):
    eng = _engine("purge", buckets=(4,), queue_frames=8, persist_dir=str(tmp_path),
                  persist_every=1)
    for sid in ("pa", "pb", "pc"):
        eng.admit(tenant="t", sid=sid)
        eng.submit(sid, _frames(1, 7)[0])
    while eng.step():
        pass
    eng.flush_persist()
    for sid in ("pa", "pb", "pc"):
        assert os.path.exists(eng._store.path(sid)), sid
    eng.close("pa")
    eng._retire(eng.table.get("pb"), RuntimeError("injected"))
    eng.flush_persist()
    assert not os.path.exists(eng._store.path("pa"))
    assert not os.path.exists(eng._store.path("pb"))
    assert os.path.exists(eng._store.path("pc"))


def test_pipeline_signature_separates_app_snapshots(tmp_path):
    a = _engine("sig", buckets=(1,), queue_frames=4, persist_dir=str(tmp_path),
                persist_every=1)
    a.admit(tenant="t", sid="s1")
    a.submit("s1", _frames(1, 9)[0])
    a.step()
    a.flush_persist()
    b = _engine("sig", T.Pipeline([T.rotator_stage(0.2)], np.complex64), buckets=(1,),
                queue_frames=4, persist_dir=str(tmp_path), persist_every=1)
    assert b.restored_sessions == 0
    assert a._store.signature != b._store.signature


def test_persist_off_is_one_falsy_check():
    eng = _engine("pfree", buckets=(1,), queue_frames=4)
    assert eng._store is None and eng._persist_every == 0
    s = eng.admit(tenant="t")
    eng.submit(s.sid, _frames(1, 4)[0])
    assert eng.step() == 1


# ---------------------------------------------------------------------------
# graceful lifecycle: drain and readiness
# ---------------------------------------------------------------------------

def test_drain_refuses_admissions_finishes_and_persists(tmp_path):
    from futuresdr_tpu_torch.serve.engine import _SHED
    eng = _engine("drainy", buckets=(2,), queue_frames=16, persist_dir=str(tmp_path),
                  persist_every=0)
    s = eng.admit(tenant="t", sid="dr1")
    for f in _frames(4, 5):
        assert eng.submit(s.sid, f)
    report = eng.drain()
    assert report["drained"] and report["frames_drained"] == 4
    assert report["pending_frames"] == 0 and report["sessions_persisted"] == 1
    eng.flush_persist()
    assert os.path.exists(eng._store.path("dr1"))
    assert len(eng.results(s.sid)) == 4
    with pytest.raises(ServeDraining):
        eng.admit(tenant="t2")
    assert _SHED.get(app="drainy", tenant="t2", reason="drain") == 1
    assert eng.health()["ready"] is False


def test_drain_is_idempotent_and_describe_reports_lifecycle():
    eng = _engine("drain2", buckets=(1,), queue_frames=4)
    assert eng.drain()["drained"] and eng.drain()["drained"]
    d = eng.describe()
    assert d["draining"] and d["drained"] and d["shed"]["rung"] == "ok"


def test_retry_after_derived_from_step_rate():
    eng = _engine("retry", buckets=(1,), queue_frames=4)
    assert eng.retry_after_s() == 1
    s = eng.admit(tenant="t")
    for f in _frames(6, 6):
        eng.submit(s.sid, f)
        eng.step()
    assert 1 <= eng.retry_after_s() <= 30


# ---------------------------------------------------------------------------
# SLO-aware overload shedding
# ---------------------------------------------------------------------------

def test_shed_ladder_unit_escalates_and_unwinds_in_order():
    lad = ShedLadder(hi=0.8, lo=0.3, trip=2, clear=2)
    assert lad.observe(0.1, None, 0.0) == 0
    assert lad.observe(0.9, None, 0.0) == 0
    assert lad.observe(0.9, None, 0.0) == 1
    assert lad.observe(0.1, 50.0, 10.0) == 1
    assert lad.observe(0.1, 50.0, 10.0) == 2
    assert lad.observe(0.9, None, 0.0) == 2
    assert lad.observe(0.9, None, 0.0) == 3
    assert lad.observe(0.9, None, 0.0) == 3
    for _ in range(6):
        assert lad.observe(0.5, None, 0.0) == 3
    assert lad.observe(0.1, 1.0, 10.0) == 3
    assert lad.observe(0.1, 1.0, 10.0) == 2
    assert lad.observe(0.1, None, 0.0) == 2
    assert lad.observe(0.1, None, 0.0) == 1
    assert lad.observe(0.1, None, 0.0) == 1
    assert lad.observe(0.1, None, 0.0) == 0
    assert lad.escalations == 3


def test_overload_sheds_admissions_then_recovers():
    from futuresdr_tpu_torch.serve.engine import _SHED
    data = _frames(8, 11)
    exp = _solo(_pipe(), data)
    eng = _engine("storm", buckets=(2,), queue_frames=2)      # 4 credits
    eng._ladder = ShedLadder(hi=0.5, lo=0.25, trip=2, clear=2)
    s = eng.admit(tenant="hot", sid="res")
    out, backlog = [], list(data)
    for _ in range(50):
        if not backlog:
            break
        for _ in range(2):
            if backlog and eng.submit(s.sid, backlog[0]):
                backlog.pop(0)
            else:
                break
        eng.step()
        out.extend(eng.results(s.sid))
    assert not backlog
    assert eng._ladder.level >= 1
    with pytest.raises(ServeOverload):
        eng.admit(tenant="newcomer")
    assert _SHED.get(app="storm", tenant="newcomer", reason="admission") >= 1
    while eng.step():
        pass
    out.extend(eng.results(s.sid))
    _bit_equal(out, exp)
    eng._slo_ms = 0.001                  # every recorded latency "misses"
    for _ in range(8):
        eng.step()
    assert eng._ladder.level == 0
    eng._slo_ms = 0.0
    assert eng.admit(tenant="newcomer").state == "active"


def test_shed_rung2_evicts_most_stalled_session(tmp_path):
    eng = _engine("rung2", buckets=(2,), queue_frames=2, persist_dir=str(tmp_path),
                  persist_every=0)
    eng._ladder = ShedLadder(hi=0.5, lo=0.25, trip=1, clear=8)
    hog = eng.admit(tenant="t", sid="hogs")
    idle = eng.admit(tenant="t", sid="idles")
    data = _frames(10, 12)
    for i in range(0, 10, 2):
        eng.submit(hog.sid, data[i])
        eng.submit(hog.sid, data[i + 1])
        eng.step()
        if eng._ladder.level >= 2:
            break
    assert eng._ladder.level >= 2
    assert idle.state == "evicted" and idle.carry_leaves is not None
    assert eng.shed_evictions >= 1
    eng.flush_persist()
    assert os.path.exists(eng._store.path("idles"))


def test_brownout_k_lever_drops_megabatch_on_residents():
    data = _frames(12, 13)
    eng = _engine("bk", buckets=(1,), queue_frames=16, frames_per_dispatch=4)
    eng._brownout = "k"
    s = eng.admit(tenant="t")
    for f in data[:4]:
        assert eng.submit(s.sid, f)
    assert eng.step() == 4
    compiles_k4 = eng.compiles
    eng._set_brownout(True)
    assert eng._k_eff == 1
    for f in data[4:8]:
        assert eng.submit(s.sid, f)
    assert eng.step() == 1
    assert eng.compiles == compiles_k4 + 1
    while eng.step():
        pass
    eng._set_brownout(False)
    for f in data[8:12]:
        assert eng.submit(s.sid, f)
    assert eng.step() == 4
    assert eng.compiles == compiles_k4 + 1
    _bit_equal(eng.results(s.sid), _solo(_pipe(), data))   # K never changes a bit here


@pytest.mark.parametrize("mode,floor_db", [("int8", 20.0), ("bf16", 40.0)])
def test_brownout_precision_lever(mode, floor_db):
    """The precision rung serves the interior lowered (int8: the banded
    int8 FIR; bf16) for its duration, within the rung's SNR of the base
    chain, and release restores the base program bit for bit."""
    data = _frames(6, 21)
    eng = _engine(f"bp_{mode}", buckets=(1,), queue_frames=16)
    eng._brownout = "precision"
    eng._brownout_prec = mode
    s = eng.admit(tenant="t")

    def run(frames):
        got = []
        for f in frames:
            assert eng.submit(s.sid, f)
            while eng.step():
                pass
            got.extend(eng.results(s.sid))
        return got

    head = run(data[:2])
    eng._set_brownout(True)
    assert eng._brownout_active and eng._pipe_tag == mode
    assert eng.pipeline is not eng._base_pipeline
    mid = run(data[2:4])
    eng._set_brownout(False)
    assert not eng._brownout_active and eng._pipe_tag == "base"
    assert eng.pipeline is eng._base_pipeline
    tail = run(data[4:6])
    ref = _solo(_pipe(), data)
    _bit_equal(head, ref[:2])
    m, r = np.concatenate(mid), np.concatenate(ref[2:4])
    snr = 10 * np.log10(np.mean(np.abs(r) ** 2) / max(np.mean(np.abs(m - r) ** 2), 1e-30))
    assert snr >= floor_db, snr
    assert len(tail) == 2


# ---------------------------------------------------------------------------
# REST lifecycle on the stdlib control port
# ---------------------------------------------------------------------------

def _get(url):
    return json.load(urllib.request.urlopen(url))


def _post(url, body=None):
    req = urllib.request.Request(url, data=json.dumps(body or {}).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    return json.load(urllib.request.urlopen(req))


def test_rest_lifecycle_drain_healthz_readyz_retry_after():
    from futuresdr_tpu_torch import Runtime
    from futuresdr_tpu_torch.runtime.ctrl_port import ControlPort
    eng = _engine("lifecycle", buckets=(1,), queue_frames=8)
    register_app(eng)
    rt = Runtime()
    cp = ControlPort(rt.handle, bind="127.0.0.1:0")
    cp.start()
    base = cp.url
    try:
        assert _get(f"{base}/healthz") == {"ok": True}
        r = _get(f"{base}/readyz")
        assert r["ready"] and r["apps"]["lifecycle"]["compiled"]
        s = _post(f"{base}/api/serve/lifecycle/session/", {"tenant": "g"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{base}/readyz")
        assert ei.value.code == 503 and ei.value.headers.get("Retry-After")
        body = json.load(ei.value)
        assert body["ready"] is False and body["apps"]["lifecycle"]["compiled"] is False
        assert eng.submit(s["sid"], _frames(1, 15)[0])
        eng.step()
        assert _get(f"{base}/readyz")["ready"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(f"{base}/api/serve/lifecycle/session/", {"tenant": "g"})
        assert ei.value.code == 503 and int(ei.value.headers["Retry-After"]) >= 1
        body = json.load(ei.value)
        assert body["app"] == "lifecycle" and "error" in body
        rep = _post(f"{base}/api/serve/lifecycle/drain/")
        assert rep["drained"] and rep["app"] == "lifecycle"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(f"{base}/api/serve/lifecycle/session/", {"tenant": "x"})
        assert ei.value.code == 503 and "draining" in json.load(ei.value)["error"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{base}/readyz")
        assert json.load(ei.value)["apps"]["lifecycle"]["draining"] is True
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{base}/api/serve/lifecycle/session/nosuch/")
        assert json.load(ei.value) == {"error": "session not found", "app": "lifecycle"}
    finally:
        cp.stop()
        unregister_app("lifecycle")


def test_sigterm_hook_drains_registered_apps():
    import futuresdr_tpu_torch.serve.engine as engine_mod
    eng = _engine("sigterm", buckets=(1,), queue_frames=8)
    register_app(eng)
    chained = threading.Event()
    prev = signal.signal(signal.SIGTERM, lambda s, f: chained.set())
    engine_mod._sigterm_installed = False
    try:
        assert engine_mod.install_sigterm_drain(timeout=10.0)
        s = eng.admit(tenant="t")
        for f in _frames(3, 16):
            assert eng.submit(s.sid, f)
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 10.0
        while not (eng.drained and chained.is_set()):
            assert time.monotonic() < deadline, "the SIGTERM drain did not land"
            time.sleep(0.02)
        assert len(eng.results(s.sid)) == 3
        with pytest.raises(ServeDraining):
            eng.admit(tenant="late")
    finally:
        signal.signal(signal.SIGTERM, prev)
        engine_mod._sigterm_installed = False
        unregister_app("sigterm")
