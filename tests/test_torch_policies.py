"""The port's failure policies on the CPU, case for case the reference's
``tests/test_policies.py`` (its runtime half; the device recovery cases are
in ``tests/test_torch_recovery.py``): ``restart`` bit-correct and in place,
an exhausted budget escalating, init failures restarted; ``isolate`` and
isolate groups (their own and from the config) retiring a branch while the
others finish; the fail-fast structured error and aggregated failures; the
run deadline turning a hang into an error, in ``work`` and in ``init``; the
device-graph fusion gates; and the decisions carried by ``describe()``.
Where the reference runs the same flowgraph, the port's decisions and
output are held against the JAX package's.

Differences by design, named in ROADMAP (Queue 3): the port has no flight
records, doctor or Prometheus counters (Queue 1 item 4b), so the doctor
cancel and flight-record cases have no counterpart here, and restarts are
read from ``WrappedKernel.restarts`` and ``metrics()``.
"""

import asyncio
import time

import numpy as np
import pytest
import torch

import futuresdr_tpu as jfs
from futuresdr_tpu.runtime import faults as jfaults
from futuresdr_tpu_torch import (BlockPolicy, Flowgraph, FlowgraphCancelled,
                                 FlowgraphError, Kernel, Runtime)
from futuresdr_tpu_torch.blocks import NullSource, VectorSink, VectorSource
from futuresdr_tpu_torch.config import config
from futuresdr_tpu_torch.dsp import firdes
from futuresdr_tpu_torch.ops import fir_stage, mag2_stage, rotator_stage
from futuresdr_tpu_torch.runtime import faults
from futuresdr_tpu_torch.runtime.block import (fusion_degraded, isolate_groups_from_config,
                                               policy_allows_fusion)
from futuresdr_tpu_torch.runtime.devchain import devchain_enabled, find_device_chains
from futuresdr_tpu_torch.tpu import TpuD2H, TpuH2D, TpuInstance, TpuKernel, TpuStage

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

CPU = TpuInstance("cpu")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Every case starts from the shipped policy defaults and leaves no armed
    fault behind (in either package)."""
    c = config()
    for f in ("block_policy", "block_max_restarts", "block_backoff",
              "block_isolate_groups", "run_timeout", "run_timeout_grace"):
        monkeypatch.setattr(c, f, getattr(c, f))
    faults.reset()
    yield
    faults.reset()
    jfaults.reset()


def _copy_body(kernel, io):
    inp = kernel.input.slice()
    out = kernel.output.slice()
    n = min(len(inp), len(out))
    if n:
        out[:n] = inp[:n]
        kernel.input.consume(n)
        kernel.output.produce(n)
    if kernel.input.finished() and n == len(inp):
        io.finished = True


def _kernels(base):
    """Copy, FlakyCopy and FlakyInit on ``base`` (the port's or the JAX
    package's Kernel), so both packages run the same flowgraphs."""

    class Copy(base):
        def __init__(self, dtype):
            super().__init__()
            self.input = self.add_stream_input("in", dtype)
            self.output = self.add_stream_output("out", dtype)

        async def work(self, io, mio, meta):
            _copy_body(self, io)

    class FlakyCopy(Copy):
        """Raises on the chosen work calls before touching a port (the
        ``work:<block>`` fault point), so a restart loses no input."""

        def __init__(self, dtype, fail_on=(), always=False):
            super().__init__(dtype)
            self.fail_on = set(fail_on)
            self.always = always
            self.calls = 0
            self.init_calls = 0

        async def init(self, mio, meta):
            self.init_calls += 1

        async def work(self, io, mio, meta):
            self.calls += 1
            if self.always or self.calls in self.fail_on:
                raise RuntimeError(f"flaky boom #{self.calls}")
            _copy_body(self, io)

    class FlakyInit(Copy):
        """``init`` fails ``fail_times`` times, then the block copies."""

        def __init__(self, dtype, fail_times: int):
            super().__init__(dtype)
            self.fail_times = fail_times
            self.init_calls = 0

        async def init(self, mio, meta):
            self.init_calls += 1
            if self.init_calls <= self.fail_times:
                raise RuntimeError(f"init boom #{self.init_calls}")

    return Copy, FlakyCopy, FlakyInit


Copy, FlakyCopy, FlakyInit = _kernels(Kernel)
JCopy, JFlakyCopy, JFlakyInit = _kernels(jfs.Kernel)


class WedgeSink(Kernel):
    """Never consumes, never finishes: the wedged flowgraph."""

    def __init__(self, dtype):
        super().__init__()
        self.input = self.add_stream_input("in", dtype)

    async def work(self, io, mio, meta):
        pass


class WedgedInit(Kernel):
    def __init__(self, dtype):
        super().__init__()
        self.input = self.add_stream_input("in", dtype)

    async def init(self, mio, meta):
        await asyncio.sleep(3600)


def _actions(e):
    return [d["action"] for d in e.policy_decisions]


# ---------------------------------------------------------------------------
# restart
# ---------------------------------------------------------------------------

def test_restart_recovers_bit_correct():
    """One work failure under ``restart``: the block re-inits in place and
    the output is the input bit for bit, as in the JAX package."""
    data = np.arange(200_000, dtype=np.float32)
    outs, blocks = [], []
    for fg, src, fc, snk, pol, rt in (
            (Flowgraph(), VectorSource(data), FlakyCopy(np.float32, fail_on=(2,)),
             VectorSink(np.float32), BlockPolicy, Runtime),
            (jfs.Flowgraph(), jfs.blocks.VectorSource(data),
             JFlakyCopy(np.float32, fail_on=(2,)), jfs.blocks.VectorSink(np.float32),
             jfs.BlockPolicy, jfs.Runtime)):
        fc.policy = pol(on_error="restart", max_restarts=3, backoff=0.002)
        fg.connect(src, fc, snk)
        rt().run(fg)
        outs.append(np.asarray(snk.items()))
        blocks.append((fg.wrapped(fc), fc))
    np.testing.assert_array_equal(outs[0], data)
    np.testing.assert_array_equal(outs[0], outs[1])
    (wk, fc), (jwk, jfc) = blocks
    assert wk.restarts == jwk.restarts == 1
    assert fc.init_calls == jfc.init_calls == 2       # the first init, one restart
    assert wk.metrics()["restarts"] == 1


def test_restart_exhausted_escalates_to_failure():
    fg = Flowgraph()
    fc = FlakyCopy(np.float32, always=True)
    fc.policy = BlockPolicy(on_error="restart", max_restarts=2, backoff=0.002)
    fg.connect(VectorSource(np.zeros(10_000, np.float32)), fc, VectorSink(np.float32))
    with pytest.raises(FlowgraphError) as ei:
        Runtime().run(fg)
    e = ei.value
    wk = fg.wrapped(fc)
    assert wk.restarts == 2
    assert e.blocks == [wk.instance_name]
    assert _actions(e) == ["restart", "restart", "restarts_exhausted"]
    # the JAX package decides the same
    jfg = jfs.Flowgraph()
    jfc = JFlakyCopy(np.float32, always=True)
    jfc.policy = jfs.BlockPolicy(on_error="restart", max_restarts=2, backoff=0.002)
    jfg.connect(jfs.blocks.VectorSource(np.zeros(10_000, np.float32)), jfc,
                jfs.blocks.VectorSink(np.float32))
    with pytest.raises(jfs.FlowgraphError) as jei:
        jfs.Runtime().run(jfg)
    assert _actions(jei.value) == _actions(e)


def test_restart_covers_init_failures():
    data = np.arange(50_000, dtype=np.float32)
    fg = Flowgraph()
    fi = FlakyInit(np.float32, fail_times=2)
    fi.policy = BlockPolicy(on_error="restart", max_restarts=3, backoff=0.002)
    snk = VectorSink(np.float32)
    fg.connect(VectorSource(data), fi, snk)
    Runtime().run(fg)
    np.testing.assert_array_equal(np.asarray(snk.items()), data)
    assert fi.init_calls == 3
    assert fg.wrapped(fi).restarts == 2
    assert [d["phase"] for d in fg.describe().policy_decisions] == ["init", "init"]


@pytest.mark.parametrize("case", ["on_error", "isolate_group", "config"])
def test_policy_validation(case, monkeypatch):
    if case == "on_error":
        with pytest.raises(ValueError):
            BlockPolicy(on_error="explode")
        assert BlockPolicy.from_config().on_error == "fail_fast"
    elif case == "isolate_group":
        assert BlockPolicy(isolate_group="x").on_error == "isolate"
        assert BlockPolicy(on_error="isolate", isolate_group="x").isolate_group == "x"
        with pytest.raises(ValueError):
            BlockPolicy(on_error="restart", isolate_group="x")
    else:
        # a typo in the config never raises (it resolves inside error paths)
        monkeypatch.setattr(config(), "block_policy", "explode")
        assert BlockPolicy.from_config().on_error == "fail_fast"
        monkeypatch.setattr(config(), "block_isolate_groups", "a=g1; bad ;b=g2;=x")
        assert isolate_groups_from_config() == {"a": "g1", "b": "g2"}


def test_injected_work_fault_with_restart_policy():
    """A seeded single-shot ``work:<block>`` fault under ``restart``."""
    data = np.arange(120_000, dtype=np.float32)
    fg = Flowgraph()
    cp = Copy(np.float32)
    cp.policy = BlockPolicy(on_error="restart", max_restarts=2, backoff=0.002)
    snk = VectorSink(np.float32)
    fg.connect(VectorSource(data), cp, snk)
    faults.reset().arm(f"work:{fg.wrapped(cp).instance_name}", rate=1.0, max_faults=1,
                       seed=3)
    Runtime().run(fg)
    np.testing.assert_array_equal(np.asarray(snk.items()), data)
    assert fg.wrapped(cp).restarts == 1


# ---------------------------------------------------------------------------
# isolate and isolate groups
# ---------------------------------------------------------------------------

def _isolate_fg(make_bad, base=(Flowgraph, VectorSource, VectorSink, Copy),
                policy=BlockPolicy):
    fg_cls, src_cls, snk_cls, copy_cls = base
    data = np.arange(100_000, dtype=np.float32)
    fg = fg_cls()
    snk_a = snk_cls(np.float32)
    fg.connect(src_cls(data), copy_cls(np.float32), snk_a)
    bad = make_bad()
    bad.policy = policy(on_error="isolate")
    fg.connect(src_cls(np.zeros(50_000, np.float32)), bad, snk_cls(np.float32))
    return fg, data, snk_a, bad


def test_isolate_lets_independent_branches_finish():
    """The failed block retires (its ports end) while the independent branch
    finishes bit-correct; the run still raises, naming the block, as in the
    JAX package."""
    fg, data, snk_a, bad = _isolate_fg(lambda: FlakyCopy(np.float32, always=True))
    with pytest.raises(FlowgraphError) as ei:
        Runtime().run(fg, timeout=30)
    e = ei.value
    np.testing.assert_array_equal(np.asarray(snk_a.items()), data)
    assert e.blocks == [fg.wrapped(bad).instance_name]
    assert _actions(e) == ["isolate"]
    assert isinstance(e.errors[0], RuntimeError)
    jfg, _, jsnk, _ = _isolate_fg(lambda: JFlakyCopy(np.float32, always=True),
                                  (jfs.Flowgraph, jfs.blocks.VectorSource,
                                   jfs.blocks.VectorSink, JCopy), jfs.BlockPolicy)
    with pytest.raises(jfs.FlowgraphError) as jei:
        jfs.Runtime().run(jfg)
    assert _actions(jei.value) == _actions(e)
    np.testing.assert_array_equal(np.asarray(jsnk.items()), np.asarray(snk_a.items()))


def test_isolate_covers_init_failures():
    fg, data, snk_a, _ = _isolate_fg(lambda: FlakyInit(np.float32, fail_times=99))
    with pytest.raises(FlowgraphError) as ei:
        Runtime().run(fg, timeout=30)
    np.testing.assert_array_equal(np.asarray(snk_a.items()), data)
    dec = ei.value.policy_decisions
    assert dec and dec[0]["action"] == "isolate" and dec[0]["phase"] == "init"


def test_isolate_group_retires_whole_subgraph():
    """One member of a named 3-block group dies: the whole group retires (its
    ports ended in topological order), the sibling branch finishes, and one
    ``isolate_group`` decision names the group and every member in order."""
    data = np.arange(100_000, dtype=np.float32)
    fg = Flowgraph()
    snk_a = VectorSink(np.float32)
    fg.connect(VectorSource(data), Copy(np.float32), snk_a)
    g1, g2, g3 = (Copy(np.float32) for _ in range(3))
    for g in (g1, g2, g3):
        g.policy = BlockPolicy(isolate_group="rx-branch")
    fg.connect(VectorSource(np.zeros(200_000, np.float32)), g1, g2, g3,
               VectorSink(np.float32))
    name = fg.wrapped(g2).instance_name
    members = [fg.wrapped(g).instance_name for g in (g1, g2, g3)]
    faults.reset().arm(f"work:{name}", rate=1.0, max_faults=1, seed=5)
    with pytest.raises(FlowgraphError) as ei:
        Runtime().run(fg, timeout=30)
    e = ei.value
    np.testing.assert_array_equal(np.asarray(snk_a.items()), data)
    dec = [d for d in e.policy_decisions if d["action"] == "isolate_group"]
    assert len(dec) == 1, e.policy_decisions
    assert dec[0]["group"] == "rx-branch" and dec[0]["block"] == name
    assert dec[0]["members"] == members               # topological order
    assert e.blocks == [name]
    grouped = [b["instance_name"] for b in fg.describe().to_json()["blocks"]
               if b.get("isolate_group") == "rx-branch"]
    assert sorted(grouped) == sorted(members)


def test_isolate_group_from_config(monkeypatch):
    data = np.arange(60_000, dtype=np.float32)
    fg = Flowgraph()
    snk_a = VectorSink(np.float32)
    fg.connect(VectorSource(data), Copy(np.float32), snk_a)
    b1, b2 = Copy(np.float32), Copy(np.float32)
    fg.connect(VectorSource(np.zeros(80_000, np.float32)), b1, b2, VectorSink(np.float32))
    n1, n2 = fg.wrapped(b1).instance_name, fg.wrapped(b2).instance_name
    monkeypatch.setattr(config(), "block_isolate_groups", f"{n1}=grp;{n2}=grp")
    faults.reset().arm(f"work:{n1}", rate=1.0, max_faults=1, seed=5)
    with pytest.raises(FlowgraphError) as ei:
        Runtime().run(fg, timeout=30)
    np.testing.assert_array_equal(np.asarray(snk_a.items()), data)
    dec = [d for d in ei.value.policy_decisions if d["action"] == "isolate_group"]
    assert dec and dec[0]["group"] == "grp" and set(dec[0]["members"]) == {n1, n2}


def test_isolate_group_covers_init_failures():
    data = np.arange(50_000, dtype=np.float32)
    fg = Flowgraph()
    snk_a = VectorSink(np.float32)
    fg.connect(VectorSource(data), Copy(np.float32), snk_a)
    bad, tail = FlakyInit(np.float32, fail_times=99), Copy(np.float32)
    for b in (bad, tail):
        b.policy = BlockPolicy(isolate_group="dead-branch")
    fg.connect(VectorSource(np.zeros(1000, np.float32)), bad, tail, VectorSink(np.float32))
    with pytest.raises(FlowgraphError) as ei:
        Runtime().run(fg, timeout=30)
    np.testing.assert_array_equal(np.asarray(snk_a.items()), data)
    dec = [d for d in ei.value.policy_decisions if d["action"] == "isolate_group"]
    assert len(dec) == 1 and dec[0]["group"] == "dead-branch"


@pytest.mark.parametrize("buffer", ["circular", "ring"])
def test_a_finished_reader_stops_holding_its_writer(buffer):
    """An isolated reader ends its port: the double-mapped buffer and the
    ring both stop counting it, so its writer's other reader keeps the
    stream moving."""
    from futuresdr_tpu_torch.runtime.buffer.circular import CircularWriter, available
    from futuresdr_tpu_torch.runtime.buffer.ring import RingWriter
    from futuresdr_tpu_torch.runtime.inbox import BlockInbox
    if buffer == "circular" and not available():
        pytest.fail("the circular buffer's library did not build")
    cls = CircularWriter if buffer == "circular" else RingWriter
    w = cls(np.float32, 4096, BlockInbox())
    stuck, live = w.add_reader(BlockInbox(), 0), w.add_reader(BlockInbox(), 0)
    cap = len(w.slice())
    w.produce(cap)
    live.consume(len(live.slice()))
    assert w.space_available() == 0                  # the stuck reader holds it
    stuck.notify_finished()
    assert w.space_available() == cap


# ---------------------------------------------------------------------------
# fail-fast, aggregation
# ---------------------------------------------------------------------------

def test_fail_fast_default_structured_error():
    fg = Flowgraph()
    bad = FlakyCopy(np.float32, always=True)          # no policy anywhere
    fg.connect(VectorSource(np.zeros(10_000, np.float32)), bad, VectorSink(np.float32))
    with pytest.raises(FlowgraphError) as ei:
        Runtime().run(fg)
    e = ei.value
    assert str(e) == str(e.errors[0])                 # one error keeps its message
    assert e.blocks == [fg.wrapped(bad).instance_name]
    assert _actions(e) == ["fail_fast"]
    assert len(fg) == 3                               # blocks restored


def test_multi_block_failures_are_aggregated():
    fg = Flowgraph()
    bad1, bad2 = FlakyInit(np.float32, fail_times=99), FlakyInit(np.float32, fail_times=99)
    fg.connect(NullSource(np.float32), bad1, bad2, VectorSink(np.float32))
    with pytest.raises(FlowgraphError) as ei:
        Runtime().run(fg)
    e = ei.value
    assert len(e.errors) == 2 and "2 blocks failed" in str(e)
    names = {fg.wrapped(bad1).instance_name, fg.wrapped(bad2).instance_name}
    assert set(e.blocks) == names
    for n in names:
        assert n in str(e)


# ---------------------------------------------------------------------------
# run deadlines
# ---------------------------------------------------------------------------

def _wedged_fg():
    fg = Flowgraph()
    fg.connect(NullSource(np.float32), Copy(np.float32), WedgeSink(np.float32))
    return fg


def test_run_timeout_converts_hang_to_error(monkeypatch):
    monkeypatch.setattr(config(), "run_timeout_grace", 3.0)
    t0 = time.perf_counter()
    with pytest.raises(FlowgraphError) as ei:
        Runtime().run(_wedged_fg(), timeout=0.6)
    assert time.perf_counter() - t0 < 8.0
    e = ei.value
    assert any(isinstance(x, FlowgraphCancelled) for x in e.errors)
    assert "cancel" in _actions(e)
    assert "deadline" in str(e)


def test_run_timeout_config_knob(monkeypatch):
    monkeypatch.setattr(config(), "run_timeout", 0.6)
    monkeypatch.setattr(config(), "run_timeout_grace", 3.0)
    with pytest.raises(FlowgraphError):
        Runtime().run(_wedged_fg())


def test_run_timeout_bounds_wedged_init():
    """The deadline covers the launch: a block wedged in ``init`` raises at
    the deadline too."""
    fg = Flowgraph()
    fg.connect(NullSource(np.float32), WedgedInit(np.float32))
    t0 = time.perf_counter()
    with pytest.raises(FlowgraphError, match="init barrier") as ei:
        Runtime().run(fg, timeout=0.5)
    assert time.perf_counter() - t0 < 4.0
    assert any(isinstance(x, FlowgraphCancelled) for x in ei.value.errors)
    with pytest.raises(RuntimeError):
        Runtime().run(fg, timeout=0.5)     # a launched flowgraph cannot launch again


def test_run_timeout_not_triggered_on_healthy_run():
    data = np.arange(10_000, dtype=np.float32)
    fg = Flowgraph()
    snk = VectorSink(np.float32)
    fg.connect(VectorSource(data), Copy(np.float32), snk)
    Runtime().run(fg, timeout=30.0)
    np.testing.assert_array_equal(np.asarray(snk.items()), data)


# ---------------------------------------------------------------------------
# fusion x policy
# ---------------------------------------------------------------------------

def _frame_fg(policy):
    frame = 4096
    tone = np.exp(2j * np.pi * 0.05 * np.arange(4 * frame)).astype(np.complex64)
    fg = Flowgraph()
    st = TpuStage([mag2_stage()], np.complex64, inst=CPU)
    st.policy = policy
    snk = VectorSink(np.float32)
    fg.connect(VectorSource(tone), TpuH2D(np.complex64, frame_size=frame, inst=CPU), st,
               TpuD2H(np.float32, inst=CPU), snk)
    return fg, st, snk, (tone.real ** 2 + tone.imag ** 2).astype(np.float32)


@pytest.mark.parametrize("on_error,fuses", [("isolate", False), ("restart", True)])
def test_devchain_policy_members(on_error, fuses):
    """``isolate`` members refuse device-graph fusion; ``restart`` members
    fuse (the fused kernel restarts from its composed carry)."""
    fg, st, snk, want = _frame_fg(BlockPolicy(on_error=on_error))
    done = Runtime().run(fg)
    assert bool(done.wrapped(st).metrics().get("fused_devchain")) is fuses
    np.testing.assert_allclose(np.asarray(snk.items()), want, rtol=1e-5)
    assert policy_allows_fusion(st, restartable=True) is fuses
    assert policy_allows_fusion(st) is False          # no fusion that cannot restart


def test_devchain_degrades_under_global_policy(monkeypatch):
    assert devchain_enabled() and not fusion_degraded()
    monkeypatch.setattr(config(), "block_policy", "restart")
    assert devchain_enabled()
    monkeypatch.setattr(config(), "block_policy", "isolate")
    assert not devchain_enabled()


def test_devchain_degrades_under_work_faults():
    faults.reset().arm("work:some_block", rate=0.5)
    assert not devchain_enabled()
    faults.reset()
    assert devchain_enabled()


@pytest.mark.parametrize("site", ["dispatch", "carry"])
def test_devchain_fault_site_gating(site):
    """A bare site keeps fusion on (the fused kernel polls it); a
    block-addressed one declines (it would never match the fused name)."""
    faults.reset().arm(site, rate=0.5)
    assert devchain_enabled()
    faults.reset().arm(f"{site}:TpuKernel_1", rate=0.5)
    assert not devchain_enabled()
    faults.reset()
    assert devchain_enabled()


def test_fanout_refuses_policy_bearing_member():
    """An ``isolate`` branch member declines the whole fan-out region."""
    t1 = firdes.lowpass(0.25, 48).astype(np.float32)
    fg = Flowgraph()
    prod = TpuKernel([fir_stage(t1, name="p")], np.complex64, frame_size=4096, inst=CPU)
    b1 = TpuKernel([mag2_stage()], np.complex64, frame_size=4096, inst=CPU)
    b2 = TpuKernel([rotator_stage(0.1)], np.complex64, frame_size=4096, inst=CPU)
    b2.policy = BlockPolicy(on_error="isolate")
    fg.connect(VectorSource(np.zeros(8192, np.complex64)), prod)
    fg.connect_stream(prod, "out", b1, "in")
    fg.connect_stream(prod, "out", b2, "in")
    fg.connect(b1, VectorSink(np.float32))
    fg.connect(b2, VectorSink(np.complex64))
    assert find_device_chains(fg) == []
    b2.policy = BlockPolicy(on_error="restart")
    assert len(find_device_chains(fg)) == 1


# ---------------------------------------------------------------------------
# the decisions on the describe surface
# ---------------------------------------------------------------------------

def test_describe_carries_policy_decisions_and_restarts():
    data = np.arange(50_000, dtype=np.float32)
    fg = Flowgraph()
    cp = FlakyCopy(np.float32, fail_on=(1,))
    cp.policy = BlockPolicy(on_error="restart", max_restarts=3, backoff=0.0)
    snk = VectorSink(np.float32)
    fg.connect(VectorSource(data), cp, snk)
    Runtime().run(fg)
    np.testing.assert_array_equal(np.asarray(snk.items()), data)
    desc = fg.describe().to_json()
    blk = next(b for b in desc["blocks"] if b["type_name"] == "FlakyCopy")
    assert blk["policy"] == "restart" and blk["restarts"] == 1
    others = [b for b in desc["blocks"] if b["type_name"] != "FlakyCopy"]
    assert all(b["policy"] == "fail_fast" and b["restarts"] == 0 for b in others)
    acts = [d for d in desc["policy_decisions"] if d["action"] == "restart"]
    assert len(acts) == 1 and acts[0]["block"] == blk["instance_name"]
    assert acts[0]["attempt"] == 1 and acts[0]["phase"] == "work"


def test_describe_policy_decisions_empty_on_clean_run():
    fg = Flowgraph()
    fg.connect(VectorSource(np.arange(1000, dtype=np.float32)), VectorSink(np.float32))
    Runtime().run(fg)
    desc = fg.describe().to_json()
    assert desc["policy_decisions"] == []
    assert all(b["restarts"] == 0 for b in desc["blocks"])


def test_live_describe_and_metrics_see_a_restart():
    """While the flowgraph runs, the handle's describe carries the decision
    and the block's metrics its restart."""
    fg = Flowgraph()
    cp = FlakyCopy(np.float32, fail_on=(1,))
    cp.policy = BlockPolicy(on_error="restart", max_restarts=3, backoff=0.0)
    fg.connect(NullSource(np.float32), cp, WedgeSink(np.float32))
    name = fg.wrapped(cp).instance_name
    running = Runtime().start(fg)
    deadline = time.monotonic() + 10
    while True:
        desc = running.handle.describe_sync()
        if desc.policy_decisions or time.monotonic() > deadline:
            break
        time.sleep(0.01)
    assert [d["action"] for d in desc.policy_decisions] == ["restart"]
    assert running.handle.metrics_sync()[name]["restarts"] == 1
    running.stop_sync()
