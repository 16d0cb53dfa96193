"""The port's mesh-sharded device plane (``futuresdr_tpu_torch/shard``, the
serving engine's slot axis, ``autotune_shard``) against the JAX package on the
CPU.

The port's devices are config ``virtual_devices`` = 8 logical CPU devices; the
JAX side runs on conftest's 8 virtual CPU devices, one jit a shape.

* data sharding: every row of the D = 8 program is bit-equal to the port's
  D = 1 program fed that row at the same K, with zero cross-shard transfers,
  and within 1e-4 (of the output's peak) of the JAX ``ShardedProgram``'s;
* ``ShardRunner``: an injected dispatch fault, a corrupt newest snapshot and a
  corrupt sole snapshot all recover bit-equal to an unfailed run;
* model sharding: one frame over 4 spans within 1e-5 (float32) of the
  one-device program, and within 1e-4 of the JAX pipeline;
* the plan's refusals, declines and ``off`` identity, beside the JAX pass's;
* the sharded serving engine bit-equal to the unsharded one, evict and
  readmit included, and its growth across the divisibility boundary.
"""

import numpy as np
import pytest
import torch

from futuresdr_tpu_torch.config import config
from futuresdr_tpu_torch.ops.stages import (Pipeline, channelizer_stage, fft_stage,
                                            fir_fft_stage, fir_stage, mag2_stage,
                                            rotator_stage)
from futuresdr_tpu_torch.runtime import faults as _faults
from futuresdr_tpu_torch.shard import (ModelShardedProgram, ShardRunner, ShardedProgram,
                                       collective_ops, plan_shard, rows_to_host,
                                       shard_pipeline)

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

D, K, F = 8, 2, 4096
TOL = 1e-4
MODEL_TOL = 1e-5
TAPS = np.hanning(33).astype(np.float32)


@pytest.fixture(autouse=True)
def logical_devices():
    cfg = config()
    prev = cfg.virtual_devices
    cfg.virtual_devices = D
    yield
    cfg.virtual_devices = prev


def _pipe():
    return Pipeline([fir_stage(TAPS), rotator_stage(0.05), mag2_stage()], np.complex64)


def _jpipe():
    from futuresdr_tpu.ops.stages import Pipeline as JP, fir_stage as jf, mag2_stage as jm
    from futuresdr_tpu.ops.stages import rotator_stage as jr
    return JP([jf(TAPS), jr(0.05), jm()], np.complex64)


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("k", [1, K])
def test_data_shard_rows_bit_equal_d1_and_match_jax(k):
    import jax
    from futuresdr_tpu.shard import ShardedProgram as JSharded, plan_shard as jplan
    pipe = _pipe()
    prog = shard_pipeline(pipe, mode="data", n_devices=D, name=f"eq{k}", device="cpu")
    assert isinstance(prog, ShardedProgram)
    rng = np.random.default_rng(k)
    x = _cplx(rng, (D, F) if k == 1 else (D, k, F))
    fn, carries = prog.compile(F, k)
    carries, ys = fn(carries, x)
    got = rows_to_host(ys)
    for d in range(D):
        f1, c1 = pipe.compile(F, "cpu", k=k)
        c1, y1 = f1(c1, torch.from_numpy(x[d]))
        assert torch.equal(y1, torch.from_numpy(got[d])), d
        for a, b in zip(jax.tree_util.tree_leaves(carries[d]), jax.tree_util.tree_leaves(c1)):
            assert torch.equal(a, b), d
    assert collective_ops(prog) == [] and prog.mesh.transfer_bytes == 0
    jp = _jpipe()
    jprog = JSharded(jp, jplan(jp, mode="data", n_devices=D), name=f"jeq{k}")
    jfn, jc = jprog.compile(F, k)
    _jc, jy = jfn(jc, jprog.place(x))
    _close(got, np.asarray(jy))


def test_data_shard_wired_form():
    from futuresdr_tpu_torch.ops.wire import get_wire
    pipe = _pipe()
    prog = ShardedProgram(pipe, plan_shard(pipe, mode="data", n_devices=D, device="cpu"))
    w = get_wire("sc16")
    x = _cplx(np.random.default_rng(3), (D, K, F))
    parts = [np.stack([np.stack([np.asarray(w.encode_host(x[d, j])[i]) for j in range(K)])
                       for d in range(D)]) for i in range(len(w.encode_host(x[0, 0])))]
    fn, cw = prog.compile(F, K, wire="sc16")
    _c, ys = fn(cw, *parts)
    out = rows_to_host(ys)
    assert out[0].shape[:2] == (D, K)
    # each row is the one-device wired program's
    f1, c1 = pipe.compile(F, "cpu", k=K, wire=w)
    _c1, y1 = f1(c1, tuple(torch.from_numpy(p[3]) for p in parts))
    for a, b in zip(y1, out):
        np.testing.assert_array_equal(a.numpy(), b[3])


def test_off_and_one_device_return_the_same_pipeline():
    pipe = _pipe()
    assert shard_pipeline(pipe, mode="off") is pipe
    assert shard_pipeline(pipe, mode="data", n_devices=1, device="cpu") is pipe
    config().virtual_devices = 0
    assert shard_pipeline(pipe, mode="data", device="cpu") is pipe


def _runner(name, every=1):
    pipe = _pipe()
    prog = ShardedProgram(pipe, plan_shard(pipe, mode="data", n_devices=D, device="cpu"),
                          name=name)
    return ShardRunner(prog, F, k=K, checkpoint_every=every, name=name)


@pytest.fixture(scope="module")
def groups_and_ref():
    rng = np.random.default_rng(0)
    groups = [_cplx(rng, (D, K, F)) for _ in range(5)]
    cfg = config()
    prev = cfg.virtual_devices
    cfg.virtual_devices = D
    ref_runner = _runner("ref")
    ref = [ref_runner.run_group(g) for g in groups]
    cfg.virtual_devices = prev
    assert ref_runner.dispatches == len(groups)          # one a group, never x D
    return groups, ref


def test_shard_runner_recovers_from_a_dispatch_fault(groups_and_ref):
    groups, ref = groups_and_ref
    hit = _runner("hit", every=2)
    out, recoveries = [hit.run_group(g) for g in groups[:3]], 0
    _faults.arm("dispatch:hit", rate=1.0, seed=5, max_faults=1)
    try:
        for g in groups[3:]:
            try:
                out.append(hit.run_group(g))
            except _faults.InjectedFault:
                recoveries += 1
                assert hit.recover() == 1          # seq 3 above the snapshot of seq 2
                out.append(hit.run_group(g))
    finally:
        _faults.disarm()
    assert recoveries == 1
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(a, b)


def test_shard_runner_evicts_a_corrupt_newest_snapshot(groups_and_ref):
    groups, ref = groups_and_ref
    r = _runner("c2")
    for g in groups[:4]:
        r.run_group(g)
    seq, leaves, spec = r._ckpts[-1]
    r._ckpts[-1] = (seq, [np.asarray(a)[..., :1] if np.ndim(a) else a for a in leaves], spec)
    assert r.recover() >= 1
    np.testing.assert_array_equal(r.run_group(groups[4]), ref[4])
    assert max(len(q) for q in r._rlog.values()) <= 2 + r.checkpoint_every


def test_shard_runner_sole_corrupt_snapshot_replays_everything(groups_and_ref):
    groups, ref = groups_and_ref
    r = _runner("c3")
    r.run_group(groups[0])
    seq, leaves, spec = r._ckpts[-1]
    r._ckpts[-1] = (seq, [np.asarray(a)[..., :1] if np.ndim(a) else a for a in leaves], spec)
    assert r.recover() == 1
    np.testing.assert_array_equal(r.run_group(groups[1]), ref[1])
    off = _runner("c4", every=0)
    off.run_group(groups[0])
    assert not off._ckpts and all(not q for q in off._rlog.values())


def test_plan_refusals_declines_and_identity_match_jax():
    from futuresdr_tpu.ops.stages import Pipeline as JP, rotator_stage as jr
    from futuresdr_tpu.shard import plan_shard as jplan
    pipe, jp = _pipe(), _jpipe()
    for f in (plan_shard, jplan):
        with pytest.raises(ValueError, match="unknown shard mode"):
            f(pipe, mode="banana")
        with pytest.raises(ValueError, match=">= 1 device"):
            f(pipe if f is plan_shard else jp, mode="data", n_devices=0)
    with pytest.raises(ValueError, match="exist"):
        plan_shard(pipe, mode="data", n_devices=D + 1, device="cpu")
    for kw in ({"mode": "off"}, {"mode": "data", "n_devices": 1}):
        p = plan_shard(pipe, device="cpu", **kw)
        assert p.applied == "off" and not p.active
    # declines with a fallback, recorded as the reference records them
    flat, jflat = (Pipeline([rotator_stage(0.1)], np.complex64),
                   JP([jr(0.1)], np.complex64))
    for got in (plan_shard(flat, mode="model", n_devices=4, device="cpu"),
                jplan(jflat, mode="model", n_devices=4)):
        assert got.applied == "data" and any("no FFT/PFB" in r for r in got.declined)
    for got in (plan_shard(pipe, mode="model", n_devices=4, frame_size=4098, device="cpu"),
                jplan(jp, mode="model", n_devices=4, frame_size=4098)):
        assert got.applied == "data" and any("divisible" in r for r in got.declined)
    # the port's own decline: the rotator's phase carry cannot split into
    # spans, so it is recorded as replicate and the plan falls back to data
    # (the reference keeps model there and lets GSPMD replicate the stage)
    p = plan_shard(pipe, mode="model", n_devices=4, device="cpu")
    modes = {d.stage: d.mode for d in p.decisions}
    assert p.applied == "data" and modes["rotator"] == "replicate"
    assert any("rotator" in r for r in p.declined)
    assert {d.stage: d.mode for d in jplan(jp, mode="model", n_devices=4).decisions}[
        "rotator"] == "replicate"
    spec = Pipeline([fir_stage(TAPS), fft_stage(256), mag2_stage()], np.complex64)
    p = plan_shard(spec, mode="model", n_devices=4, device="cpu")
    assert p.applied == "model" and {d.mode for d in p.decisions} == {"model"}
    assert plan_shard(pipe, mode="auto", n_devices=4, device="cpu").applied == "data"


def test_model_shard_matches_one_device_and_jax():
    import jax
    from futuresdr_tpu.ops.stages import Pipeline as JP, fft_stage as jfft
    from futuresdr_tpu.ops.stages import fir_stage as jf, mag2_stage as jm
    pipe = Pipeline([fir_stage(TAPS), fft_stage(256), mag2_stage()], np.complex64)
    prog = shard_pipeline(pipe, mode="model", n_devices=4, device="cpu")
    assert isinstance(prog, ModelShardedProgram)
    frame = 4 * F
    fn, carry = prog.compile(frame)
    f1, c1 = pipe.compile(frame, "cpu")
    jp = JP([jf(TAPS), jfft(256), jm()], np.complex64)
    jfn, jc = jax.jit(jp.fn()), jp.init_carry()
    rng = np.random.default_rng(4)
    for _ in range(3):                                  # the carry across frames
        x = _cplx(rng, frame)
        carry, y = fn(carry, x)
        c1, y1 = f1(c1, torch.from_numpy(x))
        jc, jy = jfn(jc, x)
        _close(y.numpy(), y1.numpy(), MODEL_TOL)
        _close(y.numpy(), np.asarray(jy))
    # a frame: a halo a span edge of the one window stage and its window
    # back to the first device, and the spans' gather
    assert prog.mesh.transfers["ppermute"] == 3 * (3 + 1)
    assert prog.mesh.transfers["all_gather"] == 3 * 3


def test_model_shard_fir_fft_and_pfb_spans():
    from futuresdr_tpu_torch.blocks.pfb import pfb_default_taps
    rng = np.random.default_rng(5)
    for stages, frame in (([fir_fft_stage(np.hanning(64).astype(np.float32), 256),
                            mag2_stage()], 4096),
                          ([channelizer_stage(16, pfb_default_taps(16))], 4096)):
        pipe = Pipeline(stages, np.complex64)
        fn, carry = ModelShardedProgram(pipe, n_devices=4, device="cpu").compile(frame, k=2)
        f1, c1 = pipe.compile(frame, "cpu", k=2)
        for _ in range(2):
            x = _cplx(rng, (2, frame))
            carry, y = fn(carry, torch.from_numpy(x))
            c1, y1 = f1(c1, torch.from_numpy(x))
            _close(y.numpy(), y1.numpy(), MODEL_TOL)
    with pytest.raises(ValueError, match="not 'model'"):
        ModelShardedProgram(_pipe(), n_devices=4, device="cpu")


def test_autotune_shard_records_the_device_axis():
    from futuresdr_tpu_torch.tpu import TpuInstance
    from futuresdr_tpu_torch.tpu.autotune import (_norm_entry, autotune_shard,
                                                  cached_shard_devices,
                                                  record_shard_devices,
                                                  record_streamed_pick)
    from futuresdr_tpu.tpu.autotune import _norm_entry as j_norm
    for v in ({"k": 2, "inflight": None, "n_devices": "8"},
              {"k": 2, "inflight": None, "n_devices": "x"},
              {"k": 2, "inflight": None, "n_devices": -4}):
        assert _norm_entry(v).get("n_devices") == j_norm(v).get("n_devices")
    pipe = Pipeline([fir_stage(TAPS), rotator_stage(0.07), mag2_stage()], np.complex64)
    best, rates = autotune_shard(pipe.stages, pipe.in_dtype, frame=F, devices=(1, 2, 4),
                                 min_seconds=0.02, inst=TpuInstance("cpu"))
    assert set(rates) == {1, 2, 4} and best in rates
    assert all(rates[d] <= rates[best] for d in rates if d > best) or best == max(rates)
    assert cached_shard_devices(pipe.stages, pipe.in_dtype, "cpu") == best
    record_shard_devices(pipe.stages, pipe.in_dtype, "cpu", 4)
    record_streamed_pick(pipe.stages, pipe.in_dtype, "cpu", 2, inflight=4)
    assert cached_shard_devices(pipe.stages, pipe.in_dtype, "cpu") == 4
    record_shard_devices(pipe.stages, pipe.in_dtype, "cpu", "junk")
    record_shard_devices(pipe.stages, pipe.in_dtype, "cpu", 0)
    assert cached_shard_devices(pipe.stages, pipe.in_dtype, "cpu") == 4


def _serve(shard, pipe, buckets=(8, 16), k=1):
    from futuresdr_tpu_torch.serve.engine import ServeEngine
    eng = ServeEngine(pipe, frame_size=F, app=f"sh{shard}k{k}", buckets=buckets,
                      shard_devices=shard, frames_per_dispatch=k, device="cpu")
    sids = [eng.admit(tenant="t", sid=f"s{i}").sid for i in range(6)]
    frames = {s: [_cplx(np.random.default_rng(i), F) for _ in range(4)]
              for i, s in enumerate(sids)}
    outs = {s: [] for s in sids}
    for step in range(4):
        for s in sids:
            eng.submit(s, frames[s][step])
        eng.step()
        for s in sids:
            outs[s].extend(eng.results(s))
    eng.retune(sids[2], 0, taps=-TAPS)                  # a lane retune
    eng.evict(sids[0])
    eng.readmit(sids[0])
    view = eng.session_view(sids[0])
    for s in sids:
        eng.submit(s, frames[s][0])
    while eng.step():
        pass
    for s in sids:
        outs[s].extend(eng.results(s))
    return outs, view, eng


@pytest.mark.parametrize("k", [1, 2])
def test_sharded_engine_bit_equals_unsharded(k):
    pipe = _pipe()
    o8, v8, e8 = _serve(8, pipe, k=k)
    o0, v0, _ = _serve(0, pipe, k=k)
    for s in o0:
        assert len(o0[s]) == len(o8[s]) == 5, s
        for a, b in zip(o0[s], o8[s]):
            np.testing.assert_array_equal(a, b)
    assert (v8["device"], v8["device_lane"]) == (0, 0) and "device" not in v0
    assert e8.describe()["shard"] == {"devices": 8, "sharded": True, "lanes_per_device": 1}


def test_sharded_engine_grows_across_the_divisibility_boundary():
    from futuresdr_tpu_torch.serve.engine import ServeEngine, ShardedPool
    pipe = Pipeline([rotator_stage(0.05), mag2_stage()], np.complex64)
    eng = ServeEngine(pipe, frame_size=1024, app="grow", buckets=(6, 16), shard_devices=8,
                      device="cpu")
    ref = ServeEngine(pipe, frame_size=1024, app="grow0", buckets=(6, 16), device="cpu")
    data = [_cplx(np.random.default_rng(i), 1024) for i in range(7)]
    for e in (eng, ref):
        for i in range(6):
            e.admit(tenant="t", sid=f"g{i}")
        for i in range(6):
            e.submit(f"g{i}", data[i])
        assert e.step() == 6
    assert not isinstance(eng._pages, ShardedPool) and not eng._shard_ok(6)
    for e in (eng, ref):
        e.admit(tenant="t", sid="g6")                   # grows 6 -> 16
        for i in range(7):
            e.submit(f"g{i}", data[i])
        assert e.step() == 7
    assert eng.table.capacity == 16 and isinstance(eng._pages, ShardedPool)
    assert eng.describe()["shard"] == {"devices": 8, "sharded": True, "lanes_per_device": 2}
    assert eng.slot_device(5) == (2, 1)
    for i in range(7):
        for a, b in zip(eng.results(f"g{i}"), ref.results(f"g{i}")):
            np.testing.assert_array_equal(a, b)


def test_sharded_engine_refuses_more_devices_than_exist():
    from futuresdr_tpu_torch.serve.engine import ServeEngine
    with pytest.raises(ValueError, match="refusing"):
        ServeEngine(_pipe(), frame_size=1024, app="over", shard_devices=16, device="cpu")
    config().virtual_devices = 0
    with pytest.raises(ValueError, match="refusing"):
        ServeEngine(_pipe(), frame_size=1024, app="over1", shard_devices=2, device="cpu")


def test_broker_on_another_card_makes_its_streams_there(monkeypatch):
    """A ``TpuInstance`` on ``cuda:1`` (or on a second logical device) makes
    its copy streams on its own card and makes its card current: nothing it
    owns is on card 0 (the card calls are recorded, not run)."""
    from futuresdr_tpu_torch.ops import xfer
    import importlib
    inst_mod = importlib.import_module("futuresdr_tpu_torch.tpu.instance")
    made, current = [], []

    class FakeStream:
        def __init__(self, device=None, priority=0):
            made.append(torch.device(device))

    class FakeDeviceCtx:
        def __init__(self, device):
            self.device = torch.device(device)

        def __enter__(self):
            current.append(self.device)

        def __exit__(self, *a):
            return False

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    monkeypatch.setattr(torch.cuda, "device", FakeDeviceCtx)
    monkeypatch.setattr(xfer, "_streams", {})
    monkeypatch.setattr(inst_mod, "_instances", {})
    b = inst_mod.instance("cuda:1")
    assert b.device == torch.device("cuda", 1) and inst_mod.instance("cuda:1") is b
    b.copy_stream("h2d")
    b.copy_stream("d2h")
    with b.card():
        pass
    assert made == [torch.device("cuda", 1)] * 2 and current == [torch.device("cuda", 1)]
