"""The streamed-pick cache, the kernels' tuned-plan table and the picks that
read them, on the CPU, against the JAX package where it has the same
surface (the port's counterparts of ``test_devchain.py``'s and
``test_devchain_dag.py``'s cached-K cases, ``test_arena.py``'s credit seed,
``test_uplink.py``'s wire axis and adaptive start, ``test_wire.py``'s
``pick_wire`` and ``test_pallas.py``'s plan-table cases).

Every comparison with the JAX package is exact: the same cache values
normalised by both ``_norm_entry``s keep the same axes (the
``pallas_blocks`` axis holds the JAX package's block ints there and the
port's plan tuples here, so only its presence is compared), and both
``pick_wire``s make the same pick from the same link numbers.
"""

import importlib
import json

import numpy as np
import pytest
import torch

from futuresdr_tpu_torch import Flowgraph, Runtime
from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
from futuresdr_tpu_torch.config import config
from futuresdr_tpu_torch.ops import cuda_kernels as ck
from futuresdr_tpu_torch.ops import fir_stage, mag2_stage, rotator_stage
from futuresdr_tpu_torch.ops.stages import DagPipeline, Pipeline
from futuresdr_tpu_torch.tpu import TpuKernel, TpuStage
from futuresdr_tpu_torch.tpu import kernel_tune
from tests.test_torch_devchain import CPU, FRAME, c64, fanout_frame_fg, no_devchain
from tests.test_torch_devchain_dag import diamond_fg

torch.set_num_threads(1)

at = importlib.import_module("futuresdr_tpu_torch.tpu.autotune")
jat = importlib.import_module("futuresdr_tpu.tpu.autotune")
TAPS = (np.hanning(17) / np.hanning(17).sum()).astype(np.float32)


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    """Each case on a cache of its own: in memory, and on disk under
    ``tmp_path``; the tuned plans cleared after."""
    monkeypatch.setattr(config(), "autotune_cache_dir", str(tmp_path))
    monkeypatch.setattr(config(), "tpu_inflight", 0)
    monkeypatch.setattr(config(), "tpu_frames_per_dispatch", 0)
    at._streamed_cache.clear()
    at._disk_memo.clear()
    yield
    at._streamed_cache.clear()
    at._disk_memo.clear()
    ck.set_tuned_plans(None)


# ---------------------------------------------------------------------------
# the cache entry's per-axis guard
# ---------------------------------------------------------------------------

ENTRIES = {
    "legacy int": 4,
    "legacy str": "2",
    "dict": {"k": 2, "inflight": 3},
    "no k": {"inflight": 3},
    "bad k": {"k": "x"},
    "ladder": {"k": 1, "inflight": None, "serve_buckets": [16, 1, 4, 4, -2]},
    "bad ladder": {"k": 2, "inflight": None, "serve_buckets": "1,4,16"},
    "pages": {"k": 2, "inflight": None, "serve_pages": 8, "n_devices": 4},
    "bad pages": {"k": 2, "inflight": None, "serve_pages": "many", "n_devices": 0},
    "precision": {"k": 1, "inflight": None, "interior_precision": " BF16 "},
    "typo precision": {"k": 1, "inflight": None, "interior_precision": "bf61"},
    "list precision": {"k": 1, "inflight": None, "interior_precision": ["bf16"]},
    "wire": {"k": 1, "inflight": 2, "wire": "SC16"},
    "unknown wire": {"k": 1, "inflight": 2, "wire": "sc4"},
    "bad blocks": {"k": 2, "inflight": None, "pallas_blocks": "garbage"},
    "unknown kernel": {"k": 2, "inflight": None, "pallas_blocks": {"v5e": {"bogus": 1}}},
}


@pytest.mark.parametrize("name", list(ENTRIES))
def test_norm_entry_keeps_the_reference_axes(name):
    v = ENTRIES[name]
    mine, ref = at._norm_entry(v), jat._norm_entry(v)
    assert (mine is None) == (ref is None)
    if ref is not None:
        assert mine == ref


def test_norm_entry_plan_axis_guard():
    """The plan axis keeps what ``normalize_plans`` accepts (a plan among the
    kernel's candidates at its shape): an unknown kernel, a wrong-arity
    shape or a plan no rule takes loses that part only."""
    shape = (1 << 18, 64, 1, 132)
    good = list(ck.plan_candidates("fir", *shape)[2])
    e = at._norm_entry({"k": 2, "inflight": None, "pallas_blocks": {"card": {
        "fir": {"262144,64,1,132": good, "1,2": good, "262144,64,1,131": [1, 2, 3]},
        "bogus": {"1": [1]}}}})
    assert e["k"] == 2
    assert e["pallas_blocks"] == {"card": {"fir": {"262144,64,1,132": good}}}


def test_port_cache_round_trips_through_disk():
    stages = [fir_stage(TAPS, fft_len=256, name="f")]
    at.record_streamed_pick(stages, np.complex64, "cpu", 4, inflight=2)
    at.record_wire_start(stages, np.complex64, "cpu", "sc16")
    at.record_interior_precision(stages, np.complex64, "cpu", "bf16")
    at.record_pallas_blocks(stages, np.complex64, "cpu", "card",
                            {"rotator": {"512000": [256, 512]}, "bogus": {}})
    at.record_streamed_pick(stages, np.complex64, "cpu", 1, inflight=4)   # keeps axes
    with open(at._cache_file()) as f:
        raw = json.load(f)
    at._streamed_cache.clear()
    at._disk_memo.clear()
    e = at.cached_streamed_pick(stages, np.complex64, "cpu")
    assert e == {"k": 1, "inflight": 4, "wire": "sc16", "interior_precision": "bf16",
                 "pallas_blocks": {"card": {"rotator": {"512000": [256, 512]}}}}
    assert list(raw.values())[0] == e
    at.record_wire_start(stages, np.complex64, "cpu", "bogus")        # dropped
    at.record_interior_precision(stages, np.complex64, "cpu", "fp8")  # dropped
    assert at.cached_wire_start(stages, np.complex64, "cpu") == "sc16"
    assert at.cached_interior_precision(stages, np.complex64, "cpu") == "bf16"


def test_k_only_record_persists_as_a_bare_int():
    stages = [fir_stage(TAPS, fft_len=256, name="k_only")]
    at.record_streamed_pick(stages, np.complex64, "cpu", 4)
    with open(at._cache_file()) as f:
        assert list(json.load(f).values()) == [4]
    assert at.cached_frames_per_dispatch(stages, np.complex64, "cpu") == 4


def test_signatures_match_the_reference_layout():
    """The signature names of a linear, a fan-out and a DAG chain read as the
    JAX package's (the platform key is the card's name here)."""
    from futuresdr_tpu.ops import stages as J
    from futuresdr_tpu_torch.ops import stages as T
    mk = (lambda M: M.DagPipeline([([M.fir_stage(TAPS, name="p")], []),
                                   ([M.mag2_stage()], [0]),
                                   ([M.fir_stage(TAPS, decim=4, name="b")], [0])],
                                  np.complex64))
    assert at._dag_names(mk(T)) == jat._dag_names(mk(J))
    assert at._fanout_names([fir_stage(TAPS, name="p")], [[mag2_stage()], []]) == \
        jat._fanout_names([J.fir_stage(TAPS, name="p")], [[J.mag2_stage()], []])
    assert at._make_sig("cpu", np.complex64, ("a",)) == \
        jat._make_sig("cpu", np.complex64, ("a",))


# ---------------------------------------------------------------------------
# the picks reach the runtime
# ---------------------------------------------------------------------------

def test_kernel_seeds_credits_from_cached_pick(monkeypatch):
    stages = [rotator_stage(0.037)]
    at.record_streamed_pick(stages, np.complex64, "cpu", 1, inflight=6)
    tk = TpuKernel(stages, np.complex64, frame_size=4096, inst=CPU)
    assert tk.depth == 6 and tk._credits.credits == 6 and tk._credits.adaptive
    tk2 = TpuKernel(stages, np.complex64, frame_size=4096, inst=CPU, frames_in_flight=3)
    assert tk2.depth == 3 and not tk2._credits.adaptive
    monkeypatch.setattr(config(), "tpu_inflight", 2)
    tk3 = TpuKernel(stages, np.complex64, frame_size=4096, inst=CPU)
    assert tk3.depth == 2 and not tk3._credits.adaptive


def test_adaptive_kernel_starts_from_cached_pick(monkeypatch):
    monkeypatch.setattr(config(), "tpu_adaptive_wire", True)
    stages = [fir_stage(TAPS, fft_len=256, name="f"), rotator_stage(0.05, name="rot")]
    at.record_wire_start(stages, np.complex64, "cpu", "sc16")
    tk = TpuKernel(stages, np.complex64, frame_size=4096, frames_in_flight=2, wire="f32",
                   inst=CPU)
    assert tk.wire.name == "sc16" and tk._wire_floor_fmt == "sc16"
    assert tk.wire_history == [(0, "sc16")] and tk._wirectl is not None
    assert tk._packed is not None                # derived again for the start
    # unarmed, the build-time wire stays
    monkeypatch.setattr(config(), "tpu_adaptive_wire", False)
    assert TpuKernel(stages, np.complex64, frame_size=4096, wire="f32",
                     inst=CPU).wire.name == "f32"


def _fused_k(fg):
    return [b.metrics().get("frames_per_dispatch") for b in fg._blocks
            if b is not None and isinstance(b.kernel, TpuStage)]


def test_fanout_launches_with_cached_autotune_k():
    """A fan-out region tuned under its shape launches fused with the cached
    K: the producer's and each branch's stage lists, fences aside."""
    data, k = c64(23, 4 * FRAME), 2
    with no_devchain(False):
        fg, sinks = fanout_frame_fg("1→1|1", data)
        st = [b.kernel for b in fg._blocks if b is not None
              and isinstance(b.kernel, TpuStage)]
        prod = next(m for m in st if any(s.name == "p1" for s in m.pipeline.stages))
        b1 = next(m for m in st if any(s.name == "b1" for s in m.pipeline.stages))
        b2 = next(m for m in st if any(s.name == "mag2" for s in m.pipeline.stages))
        at._record_sig(at._make_sig("cpu", np.complex64, at._fanout_names(
            prod.pipeline.stages, [b1.pipeline.stages, b2.pipeline.stages])), k)
        Runtime().run(fg)
    assert set(_fused_k(fg)) == {k}
    assert len(sinks[0].items()) == 4 * FRAME // 4 and len(sinks[1].items()) == 4 * FRAME


def test_dag_launches_with_cached_autotune_k():
    """A DAG region whose canonical shape was tuned (on a hand-built
    ``DagPipeline`` of the same stages, coarser nodes) launches fused with
    the cached K."""
    data, k = c64(59, 4 * FRAME), 2
    with no_devchain(False):
        fg, (snk,), _mg = diamond_fg("1|1|1", data)
        st = [b.kernel for b in fg._blocks if b is not None
              and isinstance(b.kernel, TpuStage)]
        by = {s.name: s for m in st for s in m.pipeline.stages}
        merge = next(b.kernel for b in fg._blocks if b is not None
                     and type(b.kernel).__name__ == "TpuMergeStage")
        hand = DagPipeline([([by["p"]], []), ([by["b1"]], [0]), ([by["b2"]], [0]),
                            (list(merge.stages), [1, 2])], np.complex64)
        at.record_streamed_pick(hand, np.complex64, "cpu", k)
        Runtime().run(fg)
    assert set(_fused_k(fg)) == {k}
    assert len(snk.items()) == 4 * FRAME // 4


def test_explicit_k_is_not_replaced_by_the_cache():
    stages = [fir_stage(TAPS, name="ex1"), fir_stage(TAPS, name="ex2")]
    at.record_streamed_pick(stages, np.complex64, "cpu", 4)
    data = c64(5, 4 * FRAME)
    with no_devchain(False):
        fg = Flowgraph()
        a = TpuKernel(stages[:1], np.complex64, frame_size=FRAME, inst=CPU,
                      frames_per_dispatch=1)
        b = TpuKernel(stages[1:], np.complex64, frame_size=FRAME, inst=CPU)
        snk = VectorSink(np.complex64)
        fg.connect(VectorSource(data), a, b, snk)
        Runtime().run(fg)
    assert a.extra_metrics()["frames_per_dispatch"] == 1
    assert len(snk.items()) == len(data)


@pytest.mark.parametrize("up,down,floor", [(4e9, 4e9, 60.0), (1e8, 1e8, 60.0),
                                           (1e8, 1e8, None), (1e8, 1e8, 20.0)])
def test_pick_wire_snr_floor_and_tie_break(up, down, floor):
    mine = at.pick_wire(up, down, np.complex64, np.complex64, min_snr_db=floor)
    ref = jat.pick_wire(up, down, np.complex64, np.complex64, min_snr_db=floor)
    assert mine == ref


def test_autotune_streamed_records_the_measured_pick():
    """The sweep runs the real streamed block on the CPU and records its
    winner (K, depth, wire) under the raw and the optimized stage lists."""
    stages = [fir_stage(TAPS, name="st1"), fir_stage(TAPS, name="st2")]
    wire, frame, depth, res = at.autotune_streamed(
        stages, np.complex64, wires=("f32",), frames=(FRAME,), depths=(2,), ks=(1, 2),
        min_seconds=0.01, inst=CPU)
    assert (wire, frame, depth) == ("f32", FRAME, 2) and set(res) == {
        ("f32", FRAME, 2, 1), ("f32", FRAME, 2, 2)}
    for sig in (stages, Pipeline(stages, np.complex64).stages):
        e = at.cached_streamed_pick(sig, np.complex64, "cpu")
        assert e["k"] == res.frames_per_dispatch and e["inflight"] == 2
        assert e["wire"] == "f32"


# ---------------------------------------------------------------------------
# the tuned-plan table
# ---------------------------------------------------------------------------

def test_tuned_plan_table_guarded_parse():
    shape = (1 << 18, 64, 1, 132)
    cands = ck.plan_candidates("fir", *shape)
    assert cands[0] == ck._fir_rule(*shape[:2], True, shape[3])     # the rule's own
    assert len(set(cands)) == len(cands) and all(p.smem <= ck._MAX_SMEM for p in cands)
    ck.set_tuned_plans({"fir": {shape: cands[3], (1, 2): cands[3], (9, 64, 1, 132): cands[3]},
                        "bogus": {(1,): (1,)}, "pfb": {"64,12,4096,132": [1, 2]}})
    assert ck.tuned_plans() == {"fir": {shape: cands[3]}}
    ck.set_tuned_plans(None)
    assert ck.tuned_plans() == {}
    for kernel, _label, spec in kernel_tune.SHAPES:
        shape = kernel_tune._workload(kernel, spec, torch.device("cpu"), 1,
                                      torch.Generator().manual_seed(0))[0]
        assert ck.plan_candidates(kernel, *shape), kernel


def test_tuned_plans_reach_plan_less_callers():
    """A wrapper called without a plan (the stages' convention) resolves
    against the table; a plan passed by the caller beats it."""
    shape = (1 << 18, 64, 1, 132)
    pick = ck.plan_candidates("fir", *shape)[5]
    assert ck.fir_plan(1 << 18, 64, True, 132) != pick
    ck.set_tuned_plans({"fir": {shape: pick}})
    assert ck.fir_plan(1 << 18, 64, True, 132) == pick
    assert ck.fir_plan(1 << 18, 64, False, 132) == ck._fir_rule(1 << 18, 64, False, 132)
    pf = ck.plan_candidates("pfb", 64, 12, 4096, 132)[-1]
    ck.set_tuned_plans({"pfb": {(64, 12, 4096, 132): pf}})
    assert ck.pfb_plan(64, 12, 4096, 132) == pf and ck.fir_plan(1 << 18, 64, True, 132) != pick


def test_pallas_blocks_cache_axis():
    stages = [fir_stage(TAPS, name="fir_r12ax"), mag2_stage()]
    plans = {"rotator": {"512000": [256, 512]}, "bogus": {"1": [1]}}
    at.record_pallas_blocks(stages, np.complex64, "cpu", "card-a", plans)
    assert at.cached_pallas_blocks(stages, np.complex64, "cpu", "card-a") == \
        {"rotator": {"512000": [256, 512]}}
    assert at.cached_pallas_blocks(stages, np.complex64, "cpu", "card-b") is None
    at.record_streamed_pick(stages, np.complex64, "cpu", 4, inflight=2)
    at.record_pallas_blocks(stages, np.complex64, "cpu", "card-b", plans)
    e = at.cached_streamed_pick(stages, np.complex64, "cpu")
    assert set(e["pallas_blocks"]) == {"card-a", "card-b"} and e["k"] == 4


def test_autotune_pallas_blocks_cache_hit_skips_sweep(monkeypatch):
    stages = [fir_stage(TAPS, name="fir_r12hit")]
    calls = {"n": 0}
    real = kernel_tune.sweep_plans

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(kernel_tune, "sweep_plans", counting)
    small = (("rotator", "small", {"n": 4096}), ("quad_demod", "small", {"n": 4096}))
    w1 = at.autotune_pallas_blocks(stages, np.complex64, inst=CPU, reps=2, shapes=small)
    assert calls["n"] == 1 and set(w1) == {"rotator", "quad_demod"}
    assert at.autotune_pallas_blocks.last_sweep["failures"] == []
    w2 = at.autotune_pallas_blocks(stages, np.complex64, inst=CPU, reps=2, shapes=small)
    assert calls["n"] == 1 and w2 == w1
    assert ck.tuned_plans()["rotator"] == {(4096,): ck.FixedPlan(256, ck.ROTATOR_TILE)}


def test_kernel_init_installs_cached_plans():
    stages = [fir_stage(TAPS, name="fir_r12init"), mag2_stage()]
    shape = (1 << 18, 64, 1, 132)
    pick = ck.plan_candidates("fir", *shape)[4]
    TpuKernel(stages, np.complex64, frame_size=8192, inst=CPU)
    assert ck.tuned_plans() == {}
    at.record_pallas_blocks(stages, np.complex64, "cpu", kernel_tune.device_key("cpu"),
                            {"fir": {shape: pick}})
    TpuKernel(stages, np.complex64, frame_size=8192, inst=CPU)
    assert ck.fir_plan(*shape[:2], True, shape[3]) == pick


def test_sweep_smoke_on_the_cpu():
    """The sweep's loop on the CPU (the plain versions whatever the plan):
    every candidate of every kernel checked and timed, the rule's pick the
    winner unless another beat it by more than the tie margin."""
    shapes = (("fir", "s", {"n": 8192, "nt": 64}),
              ("fir_fft", "s", {"n": 8192, "nt": 64, "n_fft": 2048}),
              ("poly_fir", "s", {"n": 8192, "D": 16, "m": 8}),
              ("pfb", "s", {"n": 8192, "N": 64, "K": 12}),
              ("rotator", "s", {"n": 4096}), ("quad_demod", "s", {"n": 4096}),
              ("fir_lanes", "s", {"L": 3, "n": 512, "nt": 17}),
              ("fir_fft_lanes", "s", {"L": 2, "n": 4096, "nt": 64, "n_fft": 2048}),
              ("poly_fir_lanes", "s", {"L": 3, "n": 1000, "D": 125, "m": 2, "I": 24,
                                       "real": True, "shared": True}),
              ("pfb_lanes", "s", {"L": 3, "n": 2048, "N": 64, "K": 12}))
    res = kernel_tune.sweep_plans(device="cpu", reps=1, shapes=shapes)
    assert res["failures"] == [] and res["device"] == "cpu"
    assert set(res["winners"]) == set(ck.PLAN_KERNELS)
    for kernel, by_shape in res["matrix"].items():
        for shape, times in by_shape.items():
            assert set(times) == set(ck.plan_candidates(kernel, *shape))
            assert res["winners"][kernel][shape] in times
