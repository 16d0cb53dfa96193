"""Paged carries and the overlapped serve step of the port's engine on the
CPU: the counterparts of ``tests/test_serve_paged.py``, and the kernels'
``register_vmap`` rules.

Served outputs are held bit for bit against the port's bare ``Pipeline``
and, where the JAX package's ``ServeEngine`` serves the same numpy-seeded
frames, at the chain's tolerance (overlap-save FIR + rotator: rtol 1e-3, atol
1e-4, as ``tests/test_torch_stages.py`` and ``test_torch_fm_stages.py`` hold
those stages). The vmap rules' lane plain versions are held bit for bit
against the one-stream plain versions, lane by lane.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from futuresdr_tpu.ops import stages as J
from futuresdr_tpu.serve import ServeEngine as JaxServeEngine
from futuresdr_tpu_torch.ops import cuda_kernels as ck
from futuresdr_tpu_torch.ops import stages as T
from futuresdr_tpu_torch.serve import ServeEngine, overlap_report
from futuresdr_tpu_torch.serve.api import register_app, unregister_app

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

FRAME = 1024
RTOL, ATOL = 1e-3, 1e-4


def _stages(m):
    return [m.fir_stage(np.hanning(31).astype(np.float32), fft_len=256),
            m.rotator_stage(0.03)]


def _pipe():
    return T.Pipeline(_stages(T), np.complex64)


def _engine(app, pipe=None, frame=FRAME, **kw):
    return ServeEngine(pipe or _pipe(), frame_size=frame, app=app, device="cpu", **kw)


def _frames(n, seed=0, frame=FRAME):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(frame) + 1j * rng.standard_normal(frame))
            .astype(np.complex64) for _ in range(n)]


def _solo(pipe, frames, retune=None):
    """The port's bare pipeline; ``retune=(at, stage, params)`` applies an
    update before frame ``at``."""
    fn, carry = pipe.compile(FRAME, "cpu", donate=False)
    out = []
    for i, f in enumerate(frames):
        if retune is not None and i == retune[0]:
            carry = pipe.update_stage(carry, retune[1], **retune[2])
        carry, y = fn(carry, torch.from_numpy(f))
        out.append(y.numpy().copy())
    return out


def _pump(eng, feeds):
    """Feed ``{sid: [frames]}`` (submit as credits allow, step until all
    drained)."""
    cursors = {sid: 0 for sid in feeds}
    while True:
        moved = False
        for sid, frames in feeds.items():
            while cursors[sid] < len(frames) and eng.submit(sid, frames[cursors[sid]]):
                cursors[sid] += 1
                moved = True
        if not eng.step() and not moved and \
                all(cursors[s] >= len(feeds[s]) for s in feeds):
            break


def _bit_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


_JAX = []


def _jax_served(frames):
    if not _JAX:
        _JAX.append(JaxServeEngine(J.Pipeline(_stages(J), np.complex64), frame_size=FRAME,
                                   app="jaxpaged", buckets=(1,), queue_frames=64))
    eng = _JAX[0]
    s = eng.admit(tenant="r")
    for f in frames:
        assert eng.submit(s.sid, f)
    while eng.step():
        pass
    out = eng.results(s.sid)
    eng.close(s.sid)
    return out


# ---------------------------------------------------------------------------
# bit-identity through paging and overlap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 3])
def test_paged_n1_bit_equals_bare_pipeline(depth):
    data = _frames(8)
    expected = _solo(_pipe(), data)
    eng = _engine(f"paged{depth}", buckets=(1,), queue_frames=8, inflight=depth)
    s = eng.admit(tenant="t0")
    _pump(eng, {s.sid: data})
    got = eng.results(s.sid)
    _bit_equal(got, expected)
    assert eng.compiles == 1
    for a, b in zip(got, _jax_served(data)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_mid_megabatch_join_lands_at_own_cursor():
    """K = 4: a session joining while a sibling is mid-stream rides the next
    dispatch with its own frames from its own frame 0, no rebuild; both
    streams equal their bare runs bit for bit."""
    da, db = _frames(8, seed=3), _frames(6, seed=4)
    eng = _engine("midjoin", buckets=(2,), queue_frames=8, frames_per_dispatch=4)
    a = eng.admit(tenant="ta")
    for f in da[:4]:
        assert eng.submit(a.sid, f)
    assert eng.step() == 4
    for f in da[4:7]:
        assert eng.submit(a.sid, f)
    b = eng.admit(tenant="tb")
    for f in db[:2]:
        assert eng.submit(b.sid, f)
    assert eng.step() == 5            # A's 3-frame tail and B's first 2
    assert eng.dispatches == 2
    _pump(eng, {a.sid: da[7:], b.sid: db[2:]})
    _bit_equal(eng.results(a.sid), _solo(_pipe(), da))
    _bit_equal(eng.results(b.sid), _solo(_pipe(), db))
    assert eng.compiles == 1


def test_leave_mid_group_frees_page_without_disturbing_siblings():
    data = [_frames(6, seed=10 + i) for i in range(3)]
    refs = [_solo(_pipe(), d) for d in data]
    eng = _engine("leave", buckets=(4,), queue_frames=8)
    ss = [eng.admit(tenant=f"t{i}") for i in range(3)]
    for i, s in enumerate(ss):
        for f in data[i][:3]:
            assert eng.submit(s.sid, f)
    while eng.step():
        pass
    free_before = eng.table.free_slots()
    eng.close(ss[1].sid)
    assert eng.table.free_slots() == free_before + 1
    _pump(eng, {ss[0].sid: data[0][3:], ss[2].sid: data[2][3:]})
    for i in (0, 2):
        _bit_equal(eng.results(ss[i].sid), refs[i])
    assert eng.compiles == 1


def test_page_map_stays_permutation_under_churn():
    eng = _engine("perm", T.Pipeline([T.rotator_stage(0.05)], np.complex64), frame=256,
                  buckets=(8,))
    rng = np.random.default_rng(7)
    live = []
    for _ in range(200):
        if live and rng.random() < 0.45:
            eng.close(live.pop(rng.integers(len(live))))
        elif len(live) < 8:
            live.append(eng.admit(tenant="t").sid)
        t = eng.table
        assert sorted(t.page_of_lane) == list(range(t.capacity))
        assert all(t.lane_of_page[t.page_of_lane[i]] == i for i in range(t.capacity))
        assert all(t.sessions[sid].page == t.page_of_lane[t.sessions[sid].slot]
                   for sid in live)
    assert eng.compiles == 0


def test_evict_readmit_round_trip_under_overlap():
    """At in-flight depth 3, evict quiesces the window and snapshots the
    committed page; readmit restores it bit for bit."""
    data = _frames(9, seed=21)
    expected = _solo(_pipe(), data)
    eng = _engine("evro", buckets=(2,), queue_frames=4, inflight=3)
    s = eng.admit(tenant="t0")
    for f in data[:4]:
        assert eng.submit(s.sid, f)
    eng.step()
    eng.step()
    assert eng._inflight                       # a group still in flight
    eng.evict(s.sid)
    assert s.state == "evicted" and s.carry_leaves is not None
    eng.readmit(s.sid)
    _pump(eng, {s.sid: data[4:]})
    _bit_equal(eng.results(s.sid), expected)


def test_drain_failure_at_depth_three_requeues_every_group(monkeypatch):
    """A D2H failure with three groups in flight rolls every uncommitted
    group back: their frames re-queue in order, the head re-roots at the
    committed pool, and the retry is bit for bit the fault-free run."""
    from futuresdr_tpu_torch.ops import xfer
    data = _frames(6, seed=22)
    expected = _solo(_pipe(), data)
    eng = _engine("d2hfail", buckets=(2,), queue_frames=8, inflight=3)
    eng._flight.adaptive = False
    s = eng.admit(tenant="t0")
    for f in data:
        assert eng.submit(s.sid, f)
    eng.step()                                 # group 1 commits
    real = xfer.start_host_transfer
    state = {"n": 0}

    def flaky(t):
        fin = real(t)
        state["n"] += 1
        if state["n"] != 1:
            return fin

        def boom():
            raise RuntimeError("transient D2H error")
        boom.release, boom._wire = fin.release, fin._wire
        return boom

    monkeypatch.setattr(xfer, "start_host_transfer", flaky)
    eng.step()                                 # group 2 (its D2H will fail)
    eng.step()                                 # group 3
    assert len(eng._inflight) == 2
    with pytest.raises(RuntimeError, match="transient D2H error"):
        eng.step()                             # group 4 launches; the drain fails
    assert not eng._inflight
    assert len(eng.table.get(s.sid).pending) == 5 and eng.dispatches == 1
    _pump(eng, {s.sid: []})
    _bit_equal(eng.results(s.sid), expected)


# ---------------------------------------------------------------------------
# overlap evidence: host intervals of the groups' lanes
# ---------------------------------------------------------------------------

def test_serve_step_overlap_interval_union():
    """Under a rate-limited fake link, the recorded H2D, compute and D2H
    intervals read serialized at depth 1 (union/sum >= 0.9) and overlapped at
    depth 4 (<= 0.75)."""
    from futuresdr_tpu_torch.ops import xfer
    frame = 8192
    rng = np.random.default_rng(5)
    data = [(rng.standard_normal(frame) + 1j * rng.standard_normal(frame))
            .astype(np.complex64) for _ in range(14)]

    def run(depth):
        eng = _engine(f"ovl{depth}", T.Pipeline([T.rotator_stage(0.011)], np.complex64),
                      frame=frame, buckets=(2,), queue_frames=4, inflight=depth)
        a, b = eng.admit(tenant="t0"), eng.admit(tenant="t1")
        eng.submit(a.sid, data[0])
        eng.submit(b.sid, data[0])
        while eng.step():
            pass
        eng.spans = []
        for f in data[1:]:
            eng.submit(a.sid, f)
            eng.submit(b.sid, f)
            eng.step()
        while eng.step():
            pass
        return overlap_report(eng.spans)

    try:
        xfer.set_fake_link(16e6, 8e6)         # [2, 8192] c64: 8 ms up, 16 ms down
        serial = run(1)
        xfer.set_fake_link(16e6, 8e6)
        pipe4 = run(4)
    finally:
        xfer.set_fake_link()
    for rep in (serial, pipe4):
        for lane in ("H2D", "compute", "D2H"):
            assert rep["lanes"][lane]["spans"] > 0, (lane, rep)
    assert pipe4["sum_s"] >= 0.2, pipe4
    assert serial["ratio"] >= 0.9, serial
    assert pipe4["ratio"] <= 0.75, pipe4


# ---------------------------------------------------------------------------
# lane-addressed retunes
# ---------------------------------------------------------------------------

def test_lane_retune_isolated_to_one_session():
    from futuresdr_tpu_torch.telemetry import journal
    da, db = _frames(8, seed=31), _frames(8, seed=32)
    ref_a = _solo(_pipe(), da, retune=(4, "rotator", {"phase_inc": 0.11}))
    ref_b = _solo(_pipe(), db)
    eng = _engine("retune", buckets=(2,), queue_frames=8)
    a, b = eng.admit(tenant="ta"), eng.admit(tenant="tb")
    _pump(eng, {a.sid: da[:4], b.sid: db[:4]})
    since = journal.journal().seq
    eng.retune(a.sid, "rotator", phase_inc=0.11)
    evs = journal.events(since=since, cat="serve")["events"]
    assert any(e["event"] == "lane-retune" and e["session"] == a.sid for e in evs)
    _pump(eng, {a.sid: da[4:], b.sid: db[4:]})
    _bit_equal(eng.results(a.sid), ref_a)
    _bit_equal(eng.results(b.sid), ref_b)
    assert eng.compiles == 1


def test_retune_fresh_lane_and_error_contract():
    data = _frames(4, seed=33)
    ref = _solo(_pipe(), data, retune=(0, "rotator", {"phase_inc": 0.2}))
    eng = _engine("freshtune", buckets=(2,), queue_frames=8)
    s = eng.admit(tenant="t0")
    eng.retune(s.sid, "rotator", phase_inc=0.2)
    _pump(eng, {s.sid: data})
    _bit_equal(eng.results(s.sid), ref)
    with pytest.raises(KeyError):
        eng.retune("nosuch", "rotator", phase_inc=0.1)
    with pytest.raises(ValueError):
        eng.retune(s.sid, "nosuchstage", phase_inc=0.1)


def test_rest_session_ctrl_endpoint():
    from futuresdr_tpu_torch import Runtime
    from futuresdr_tpu_torch.runtime.ctrl_port import ControlPort
    eng = _engine("ctrlapp", buckets=(2,), queue_frames=8)
    register_app(eng)
    rt = Runtime()
    cp = ControlPort(rt.handle, bind="127.0.0.1:0")
    cp.start()
    base = cp.url

    def post(path, body):
        req = urllib.request.Request(f"{base}{path}", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"},
                                     method="POST")
        return json.load(urllib.request.urlopen(req))

    try:
        sid = post("/api/serve/ctrlapp/session/", {"tenant": "gold"})["sid"]
        view = post(f"/api/serve/ctrlapp/session/{sid}/ctrl/",
                    {"stage": "rotator", "params": {"phase_inc": 0.09}})
        assert view["sid"] == sid and view["state"] == "active"
        for path, body, code in ((f"{sid}x/ctrl/", {"stage": "rotator", "params": {}}, 404),
                                 (f"{sid}/ctrl/", {"stage": "nosuch", "params": {}}, 409),
                                 (f"{sid}/ctrl/", {"params": {}}, 400)):
            with pytest.raises(urllib.error.HTTPError) as e:
                post(f"/api/serve/ctrlapp/session/{path}", body)
            assert e.value.code == code
    finally:
        cp.stop()
        unregister_app("ctrlapp")


# ---------------------------------------------------------------------------
# page-admit journal, the narrow step lock, pool growth
# ---------------------------------------------------------------------------

def test_admission_journals_page_admit():
    from futuresdr_tpu_torch.telemetry import journal
    eng = _engine("jadmit", T.Pipeline([T.rotator_stage(0.02)], np.complex64), frame=256,
                  buckets=(2,))
    since = journal.journal().seq
    s = eng.admit(tenant="t0")
    evs = [e for e in journal.events(since=since, cat="serve")["events"]
           if e["event"] == "page-admit"]
    assert len(evs) == 1 and evs[0]["session"] == s.sid
    assert evs[0]["slot"] == s.slot and evs[0]["page"] == s.page


def test_observability_answers_during_compile_bearing_step():
    """A long step (its program call parked) does not block /metrics,
    health(), describe() or session_view(): the state lock is held for
    assembly and commit only."""
    import futuresdr_tpu_torch.serve.engine as engine_mod
    from futuresdr_tpu_torch.telemetry import prom
    real_build = engine_mod.build_slot_program
    entered, release = threading.Event(), threading.Event()

    def slow_build(*args, **kw):
        prog = real_build(*args, **kw)

        def slow(*a, **k):
            entered.set()
            assert release.wait(10.0), "test hung"
            return prog(*a, **k)
        return slow

    engine_mod.build_slot_program = slow_build
    t = None
    try:
        eng = _engine("locknarrow", T.Pipeline([T.rotator_stage(0.02)], np.complex64),
                      frame=256, buckets=(1,))
        s = eng.admit(tenant="t0")
        eng.submit(s.sid, np.zeros(256, np.complex64))
        t = threading.Thread(target=eng.step, daemon=True)
        t.start()
        assert entered.wait(10.0), "step never reached the program call"
        t0 = time.perf_counter()
        h, d, v = eng.health(), eng.describe(), eng.session_view(s.sid)
        text = prom.render_all()
        elapsed = time.perf_counter() - t0
        assert t.is_alive(), "step finished early — the probe proved nothing"
        assert elapsed < 2.0, f"observability blocked {elapsed:.1f}s"
        assert h["active"] == 1 and d["app"] == "locknarrow"
        assert v["sid"] == s.sid and "fsdr_serve_sessions" in text
    finally:
        release.set()
        if t is not None:
            t.join(10.0)
        engine_mod.build_slot_program = real_build


def test_page_pool_growth_preserves_resident_streams():
    data = [_frames(6, seed=40 + i) for i in range(3)]
    refs = [_solo(_pipe(), d) for d in data]
    eng = _engine("pgrow", buckets=(2, 4), queue_frames=8)
    s0, s1 = eng.admit(tenant="t0"), eng.admit(tenant="t1")
    _pump(eng, {s0.sid: data[0][:3], s1.sid: data[1][:3]})
    assert eng.compiles == 1 and eng.capacity == 2
    s2 = eng.admit(tenant="t2")       # 2 -> 4
    assert eng.capacity == 4
    _pump(eng, {s0.sid: data[0][3:], s1.sid: data[1][3:], s2.sid: data[2]})
    assert eng.compiles == 2
    for s, ref in ((s0, refs[0]), (s1, refs[1]), (s2, refs[2])):
        _bit_equal(eng.results(s.sid), ref)


# ---------------------------------------------------------------------------
# the kernels under vmap: the register_vmap rules on the CPU
# ---------------------------------------------------------------------------

def _c64(rng, *shape):
    return torch.from_numpy((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                            .astype(np.complex64))


@pytest.mark.parametrize("L", [1, 4])
@pytest.mark.parametrize("precision", [None, "bf16"])
def test_lane_plain_versions_equal_the_one_stream_plain_versions(L, precision):
    rng = np.random.default_rng(L)
    n, nt = 512, 17
    x, hist = _c64(rng, L, n), _c64(rng, L, nt - 1)
    taps = torch.from_numpy(rng.standard_normal((L, nt)).astype(np.float32))
    y = ck.fir_lanes_plain(hist, x, taps, precision)
    for i in range(L):
        assert torch.equal(y[i], ck.fir_continue_plain(hist[i], x[i], taps[i], precision))
    xr = torch.from_numpy(rng.standard_normal((L, n)).astype(np.float32))
    yr = ck.fir_lanes_plain(None, xr, taps, precision)
    for i in range(L):
        assert torch.equal(yr[i], ck.fir_plain(xr[i], taps[i], precision))
    f = ck.fir_fft_lanes_plain(hist, x, taps, 128, precision)
    for i in range(L):
        assert torch.equal(f[i], ck.fir_fft_plain(hist[i], x[i], taps[i], 128, precision))
    ph0 = torch.from_numpy(rng.uniform(0, 6, L).astype(np.float32))
    inc = torch.from_numpy(rng.uniform(-0.2, 0.2, L).astype(np.float32))
    r, nx = ck.rotator_lanes_plain(x, ph0, inc)
    for i in range(L):
        ri, ni = ck.rotator_plain(x[i], ph0[i], inc[i])
        assert torch.equal(r[i], ri) and torch.equal(nx[i], ni)


def test_vmap_rules_equal_per_lane_calls():
    """``torch.func.vmap`` over each wrapper reaches its custom op's rule,
    the kernel's lane form (``pfb``'s too, with each lane's taps), lane for
    lane equal to the one-stream call; an unbatched argument is shared by
    every lane. No launch is counted for a CPU tensor."""
    rng = np.random.default_rng(9)
    L, n, nt = 3, 256, 9
    x, hist = _c64(rng, L, n), _c64(rng, L, nt - 1)
    taps = torch.from_numpy(rng.standard_normal((L, nt)).astype(np.float32))
    ph0 = torch.from_numpy(rng.uniform(0, 6, L).astype(np.float32))
    inc = torch.from_numpy(rng.uniform(-0.2, 0.2, L).astype(np.float32))
    prev = _c64(rng, L)
    W = torch.from_numpy(rng.standard_normal((L, 3, 4)).astype(np.float32))
    poly_hist = _c64(rng, L, 8)
    pfb_taps = torch.from_numpy(rng.standard_normal((L, 3, 8)).astype(np.float32))
    pfb_hist = _c64(rng, L, 16)
    before = dict(ck.launches)
    vm = torch.func.vmap
    y = vm(ck.fir_continue)(hist, x, taps)
    y0 = vm(ck.fir)(x, taps)
    ys = vm(ck.fir_continue, in_dims=(0, 0, None))(hist, x, taps[0])
    f = vm(lambda h, a, t: ck.fir_fft(h, a, t, 64))(hist, x, taps)
    r, nx = vm(ck.rotator)(x, ph0, inc)
    q, last = vm(lambda p, a: ck.quad_demod(p, a, 0.7))(prev, x)
    pf = vm(ck.poly_fir)(poly_hist, x, W)
    pb = vm(ck.pfb)(pfb_hist, x, pfb_taps)
    for i in range(L):
        assert torch.equal(y[i], ck.fir_continue(hist[i], x[i], taps[i]))
        assert torch.equal(y0[i], ck.fir(x[i], taps[i]))
        assert torch.equal(ys[i], ck.fir_continue(hist[i], x[i], taps[0]))
        assert torch.equal(f[i], ck.fir_fft(hist[i], x[i], taps[i], 64))
        ri, ni = ck.rotator(x[i], ph0[i], inc[i])
        assert torch.equal(r[i], ri) and torch.equal(nx[i], ni)
        qi, li = ck.quad_demod(prev[i], x[i], 0.7)
        assert torch.equal(q[i], qi) and torch.equal(last[i], li)
        assert torch.equal(pf[i], ck.poly_fir(poly_hist[i], x[i], W[i]))
        assert torch.equal(pb[i], ck.pfb(pfb_hist[i], x[i], pfb_taps[i]))
    assert ck.launches == before
