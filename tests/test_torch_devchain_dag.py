"""The port's device-graph fusion of general DAGs: fan-in through
``TpuMergeStage``, the diamond, nested fan-out, and the randomized shapes.

The DAG cases of ``tests/test_devchain.py`` on the port, each fused
flowgraph against the same flowgraph with ``FSDR_NO_DEVCHAIN=1``, bit for
bit on the CPU, and the diamond also against the JAX package's fused
flowgraph (the FIR chain's tolerance, rtol 1e-4 / atol 1e-4 on |x|²). The
fuzz case (``test_random_devchain_shapes_fuzz``, the reference's :680) runs
the reference's 4 linear, 3 fan-out and 3 DAG seeds from its master seed,
well inside the port's 20 s a file.

Cases of the reference file that wait, with their ROADMAP items:
``test_dag_span_and_report_carry_sink_attribution`` (telemetry, Queue 1 item
4b), ``test_dag_launches_with_cached_autotune_k`` (the autotuned K, item 7)
and ``test_ctrl_retune_in_replay_window_warns`` (carry checkpoint and
replay, item 6).
"""

import numpy as np
import pytest
import torch

from futuresdr_tpu_torch import Flowgraph, Kernel, Runtime
from futuresdr_tpu_torch.blocks import Apply, VectorSink, VectorSource
from futuresdr_tpu_torch.dsp import firdes
from futuresdr_tpu_torch.ops import (add_merge_stage, concat_merge_stage, fir_stage,
                                     interleave_merge_stage, mag2_stage, rotator_stage,
                                     xfer)
from futuresdr_tpu_torch.runtime.devchain import find_device_chains
from futuresdr_tpu_torch.tpu import TpuD2H, TpuH2D, TpuKernel, TpuMergeStage, TpuStage
from tests.test_torch_devchain import (CPU, FRAME, T1, T2, assert_bit_equal, c64,
                                       frames_per_dispatch, no_devchain,
                                       per_hop_and_fused)
from tests.test_torch_frames import TaggedRampSource, TagRecordingSink

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)


def diamond_fg(split: str, data, frame=FRAME, merge="add", sink=VectorSink):
    """``TpuH2D → producer? → broadcast → two decim-4 FIR branches →
    TpuMergeStage(+, |x|²) → TpuD2H`` under member splits; ``merge="concat"``
    joins a decim-4 branch with a 1:1 one."""
    p = fir_stage(T1, name="p")
    b1 = fir_stage(T2, decim=4, fft_len=512, name="b1")
    b2 = fir_stage(T2, decim=4, fft_len=512, name="b2") if merge == "add" \
        else rotator_stage(0.1, name="b2")
    prod_lists, br1_lists, br2_lists = {
        "0|1|1": ([], [[b1]], [[b2]]),
        "1|1|1": ([[p]], [[b1]], [[b2]]),
        "1|2|1": ([[p]], [[rotator_stage(0.2)], [b1]], [[b2]]),
    }[split]
    if merge == "add":
        mg = TpuMergeStage(add_merge_stage(2), [mag2_stage()], inst=CPU)
        out_dt = np.float32
    else:
        mg = TpuMergeStage(concat_merge_stage(2), inst=CPU)
        out_dt = np.complex64
    fg = Flowgraph()
    src = data if isinstance(data, Kernel) else VectorSource(data)
    h2d = TpuH2D(np.complex64, frame_size=frame, inst=CPU)
    fg.connect_stream(src, "out", h2d, "in")
    prev = h2d
    for sl in prod_lists:
        st = TpuStage(sl, np.complex64, inst=CPU)
        fg.connect_inplace(prev, "out", st, "in")
        prev = st
    for port, lists in (("in0", br1_lists), ("in1", br2_lists)):
        b_prev = prev
        for sl in lists:
            st = TpuStage(sl, np.complex64, inst=CPU)
            fg.connect_inplace(b_prev, "out", st, "in")
            b_prev = st
        fg.connect_inplace(b_prev, "out", mg, port)
    d2h, snk = TpuD2H(out_dt, inst=CPU), sink(out_dt)
    fg.connect_inplace(mg, "out", d2h, "in")
    fg.connect_stream(d2h, "out", snk, "in")
    return fg, [snk], mg


def _one_dag(chains):
    assert len(chains) == 1 and chains[0].dag and not chains[0].fanout
    assert len(chains[0].sinks) == 1


@pytest.mark.parametrize("split", ["0|1|1", "1|1|1", "1|2|1"])
@pytest.mark.parametrize("frames_n", [1, 3])
def test_diamond_fused_bit_equals_per_hop(split, frames_n):
    n = frames_n * FRAME
    data = c64(31, n)
    refs, got, _ = per_hop_and_fused(lambda: diamond_fg(split, data), _one_dag)
    assert len(refs[0]) == n // 4
    assert_bit_equal(got, refs)


@pytest.mark.parametrize("k", [1, 4])
def test_diamond_megabatch_bit_equals_per_hop(k):
    data = c64(37, 5 * FRAME)                # one K = 4 group stays partial
    with no_devchain():
        fg, snks, _ = diamond_fg("1|1|1", data)
        Runtime().run(fg)
        ref = snks[0].items()
    with frames_per_dispatch(k), no_devchain(False):
        fg, snks, mg = diamond_fg("1|1|1", data)
        Runtime().run(fg)
        got = snks[0].items()
        m = mg.extra_metrics()
    assert_bit_equal([got], [ref])
    assert m["devchain_frames"] == 5 and m["devchain_dispatches"] == -(-5 // k)


def test_concat_merge_unequal_rates_bit_equals_per_hop():
    n = 3 * FRAME
    refs, got, _ = per_hop_and_fused(
        lambda: diamond_fg("1|1|1", c64(41, n), merge="concat"),
        lambda ch: len(ch) == 1 and ch[0].dag or pytest.fail(f"{ch}"))
    assert len(refs[0]) == n + n // 4
    assert_bit_equal(got, refs)


def test_concat_merge_partial_tail_bit_equals_per_hop():
    """A ragged EOS tail through a concat merge: both paths emit the full
    frames only, and no padding reaches the output."""
    n = 3 * FRAME + 1000
    refs, got, _ = per_hop_and_fused(
        lambda: diamond_fg("1|1|1", c64(61, n), merge="concat"))
    assert len(refs[0]) == 3 * FRAME + 3 * FRAME // 4
    assert_bit_equal(got, refs)


def nested_kernel_fg(data, frame=FRAME):
    """Stream-plane nested fan-out ``prod → {a → {c, d}, b}``: 3 sinks."""
    def tk(stages):
        return TpuKernel(stages, np.complex64, frame_size=frame, inst=CPU)

    fg = Flowgraph()
    src = VectorSource(data)
    prod, a, b = tk([fir_stage(T1, name="p")]), \
        tk([fir_stage(T2, fft_len=512, name="a")]), tk([mag2_stage()])
    c, d = tk([fir_stage(T2, decim=4, fft_len=512, name="c")]), tk([mag2_stage()])
    snks = [VectorSink(np.complex64), VectorSink(np.float32), VectorSink(np.float32)]
    fg.connect(src, prod)
    fg.connect_stream(prod, "out", a, "in")
    fg.connect_stream(prod, "out", b, "in")
    fg.connect_stream(a, "out", c, "in")
    fg.connect_stream(a, "out", d, "in")
    fg.connect(c, snks[0])
    fg.connect(d, snks[1])
    fg.connect(b, snks[2])
    return fg, snks, prod


@pytest.mark.parametrize("k", [1, 4])
def test_nested_fanout_kernels_bit_equals_per_hop(k):
    data = c64(43, 4 * FRAME)

    def check(chains):
        assert len(chains) == 1 and chains[0].dag and chains[0].kind == "kernels"
        assert len(chains[0].sinks) == 3

    with frames_per_dispatch(k):
        refs, got, built = per_hop_and_fused(lambda: nested_kernel_fg(data), check)
    assert_bit_equal(got, refs)
    m = built[2].extra_metrics()
    assert m["fused_devchain"] and m["devchain_dispatches"] * k == m["devchain_frames"] == 4


def test_nested_fanout_frames_bit_equals_per_hop():
    """``h2d → p → {b1 → {sa, sb}, b2}`` on the frame plane, 3 sinks."""
    data = c64(47, 3 * FRAME)

    def build():
        fg = Flowgraph()
        src = VectorSource(data)
        h2d = TpuH2D(np.complex64, frame_size=FRAME, inst=CPU)
        p = TpuStage([fir_stage(T1, name="p")], np.complex64, inst=CPU)
        b1 = TpuStage([rotator_stage(0.1)], np.complex64, inst=CPU)
        b2 = TpuStage([mag2_stage()], np.complex64, inst=CPU)
        sa = TpuStage([fir_stage(T2, decim=4, fft_len=512, name="sa")], np.complex64,
                      inst=CPU)
        sb = TpuStage([mag2_stage()], np.complex64, inst=CPU)
        fg.connect_stream(src, "out", h2d, "in")
        for a, b in ((h2d, p), (p, b1), (p, b2), (b1, sa), (b1, sb)):
            fg.connect_inplace(a, "out", b, "in")
        snks = []
        for st, dt in ((sa, np.complex64), (sb, np.float32), (b2, np.float32)):
            d2h, snk = TpuD2H(dt, inst=CPU), VectorSink(dt)
            fg.connect_inplace(st, "out", d2h, "in")
            fg.connect_stream(d2h, "out", snk, "in")
            snks.append(snk)
        return fg, snks

    def check(chains):
        assert len(chains) == 1 and chains[0].dag and chains[0].kind == "frames"

    refs, got, _ = per_hop_and_fused(build, check)
    assert_bit_equal(got, refs)


def test_diamond_tags_cross_fused_merge():
    """A tag crossing the fused diamond lands where the per-hop merge (tags
    ride in0) puts it."""
    n = 3 * FRAME
    with no_devchain():
        fg, snks, _ = diamond_fg("0|1|1", TaggedRampSource(n), sink=TagRecordingSink)
        Runtime().run(fg)
        ref = [(i, t.value) for i, t in snks[0].seen]
    with no_devchain(False):
        fg, snks, _ = diamond_fg("0|1|1", TaggedRampSource(n), sink=TagRecordingSink)
        assert len(find_device_chains(fg)) == 1
        Runtime().run(fg)
        got = [(i, t.value) for i, t in snks[0].seen]
    assert snks[0].n_received == n // 4
    assert got == ref and ref


def test_dag_member_metrics_bridge():
    """The merge member reports one in-count a port, each at its path rate;
    a single-sink region attributes every member to sink 0."""
    with no_devchain(False):
        fg, _, mg = diamond_fg("1|1|1", np.zeros(3 * FRAME, np.complex64))
        Runtime().start(fg).wait_sync()
    mets = {b.instance_name: b.metrics() for b in fg._blocks if b is not None}
    fused = {nm: m for nm, m in mets.items() if m.get("fused_devchain")}
    assert len(fused) == 6            # h2d, producer, 2 branches, merge, d2h
    mm = fg.wrapped(mg).metrics()
    assert mm["items_in"] == {"in0": 3 * FRAME // 4, "in1": 3 * FRAME // 4}
    assert mm["items_out"] == {"out": 3 * FRAME // 4}
    assert all(m.get("devchain_branch") == 0 for m in fused.values())


def test_dag_interior_edges_move_no_bytes_when_fused():
    """Fused, the nested stream-plane fan-out uploads its input once and
    downloads its sinks' payloads only; per hop every interior hop crosses
    the link both ways."""
    n = 4 * FRAME
    data = c64(71, n)
    sink_bytes = (n // 4) * 8 + n * 4 + n * 4
    totals = {}
    for fused in (False, True):
        with no_devchain(not fused):
            fg, _, _ = nested_kernel_fg(data)
            xfer.reset_bytes()
            Runtime().run(fg)
            totals[fused] = dict(xfer.bytes_total)
    assert totals[True] == {"h2d": n * 8, "d2h": sink_bytes}
    assert totals[False]["d2h"] == sink_bytes + 2 * n * 8     # prod's and a's
    assert totals[False]["h2d"] == n * 8 + 4 * n * 8          # each member's input


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_dag_refuses_equal_merge_rate_violation():
    fg = Flowgraph()
    h2d = TpuH2D(np.complex64, frame_size=FRAME, inst=CPU)
    b1 = TpuStage([fir_stage(T2, decim=4, fft_len=512)], np.complex64, inst=CPU)
    b2 = TpuStage([rotator_stage(0.1)], np.complex64, inst=CPU)
    mg = TpuMergeStage(add_merge_stage(2), inst=CPU)
    d2h = TpuD2H(np.complex64, inst=CPU)
    fg.connect_stream(VectorSource(np.zeros(2 * FRAME, np.complex64)), "out", h2d, "in")
    fg.connect_inplace(h2d, "out", b1, "in")
    fg.connect_inplace(h2d, "out", b2, "in")
    fg.connect_inplace(b1, "out", mg, "in0")
    fg.connect_inplace(b2, "out", mg, "in1")
    fg.connect_inplace(mg, "out", d2h, "in")
    fg.connect_stream(d2h, "out", VectorSink(np.complex64), "in")
    with no_devchain(False):
        assert find_device_chains(fg) == []


class _Add2(Kernel):
    """A two-input host sum (the loop edge of the host-cycle case)."""

    def __init__(self):
        super().__init__()
        self.a = self.add_stream_input("in0", np.complex64)
        self.b = self.add_stream_input("in1", np.complex64)
        self.output = self.add_stream_output("out", np.complex64)


def test_dag_refuses_cycle_through_host_edges():
    fg = Flowgraph()
    h2d = TpuH2D(np.complex64, frame_size=FRAME, inst=CPU)
    st = TpuStage([fir_stage(T1, name="p")], np.complex64, inst=CPU)
    d2h = TpuD2H(np.complex64, inst=CPU)
    comb = _Add2()
    fg.connect_stream(VectorSource(np.zeros(2 * FRAME, np.complex64)), "out", comb, "in0")
    fg.connect_stream(d2h, "out", comb, "in1")           # the loop edge
    fg.connect_stream(comb, "out", h2d, "in")
    fg.connect_inplace(h2d, "out", st, "in")
    fg.connect_inplace(st, "out", d2h, "in")
    with no_devchain(False):
        assert find_device_chains(fg) == []


def test_dag_refuses_merge_with_external_input():
    fg = Flowgraph()
    h2d1 = TpuH2D(np.complex64, frame_size=FRAME, inst=CPU)
    h2d2 = TpuH2D(np.complex64, frame_size=FRAME, inst=CPU)
    st1 = TpuStage([rotator_stage(0.1)], np.complex64, inst=CPU)
    st2 = TpuStage([rotator_stage(0.2)], np.complex64, inst=CPU)
    mg = TpuMergeStage(add_merge_stage(2), inst=CPU)
    d2h = TpuD2H(np.complex64, inst=CPU)
    fg.connect_stream(VectorSource(np.zeros(2 * FRAME, np.complex64)), "out", h2d1, "in")
    fg.connect_stream(VectorSource(np.zeros(2 * FRAME, np.complex64)), "out", h2d2, "in")
    fg.connect_inplace(h2d1, "out", st1, "in")
    fg.connect_inplace(h2d2, "out", st2, "in")
    fg.connect_inplace(st1, "out", mg, "in0")
    fg.connect_inplace(st2, "out", mg, "in1")
    fg.connect_inplace(mg, "out", d2h, "in")
    fg.connect_stream(d2h, "out", VectorSink(np.complex64), "in")
    with no_devchain(False):
        assert find_device_chains(fg) == []


def test_mixed_broadcast_truncates_not_declines():
    """A kernel-plane broadcast with a host tap: the prefix k1 → k2 fuses
    up to the broadcast owner, whose port still serves the tap and the
    single-member branches."""
    data = c64(67, 3 * FRAME)

    def build():
        fg = Flowgraph()
        k1 = TpuKernel([fir_stage(T1, name="k1")], np.complex64, frame_size=FRAME, inst=CPU)
        k2 = TpuKernel([rotator_stage(0.1)], np.complex64, frame_size=FRAME, inst=CPU)
        b1 = TpuKernel([fir_stage(T2, decim=4, fft_len=512, name="b1")], np.complex64,
                       frame_size=FRAME, inst=CPU)
        b2 = TpuKernel([mag2_stage()], np.complex64, frame_size=FRAME, inst=CPU)
        tap, s1, s2 = VectorSink(np.complex64), VectorSink(np.complex64), \
            VectorSink(np.float32)
        fg.connect(VectorSource(data), k1, k2)
        fg.connect_stream(k2, "out", b1, "in")
        fg.connect_stream(k2, "out", b2, "in")
        fg.connect_stream(k2, "out", tap, "in")
        fg.connect(b1, s1)
        fg.connect(b2, s2)
        return fg, [tap, s1, s2], k1

    def check(chains):
        assert len(chains) == 1 and not chains[0].dag and not chains[0].fanout
        assert [type(m).__name__ for m in chains[0]] == ["TpuKernel", "TpuKernel"]

    refs, got, built = per_hop_and_fused(build, check)
    assert_bit_equal(got, refs)
    assert built[2].extra_metrics().get("fused_devchain")


def test_message_ctrl_feedback_loop_still_fuses():
    """A message edge closing a loop (sink → host block → ctrl of a
    ``devchain_static`` member) is not a host cycle."""
    fg = Flowgraph()
    h2d = TpuH2D(np.complex64, frame_size=FRAME, inst=CPU)
    st = TpuStage([fir_stage(T2, name="f")], np.complex64, inst=CPU)
    st.devchain_static = True
    d2h = TpuD2H(np.complex64, inst=CPU)
    meas = Apply(lambda x: x, np.complex64)
    meas.add_message_output("ctrl_out")
    fg.connect(VectorSource(np.zeros(2 * FRAME, np.complex64)), h2d, st, d2h, meas,
               VectorSink(np.complex64))
    fg.connect_message(meas, "ctrl_out", st, "ctrl")
    with no_devchain(False):
        assert len(find_device_chains(fg)) == 1


def test_diamond_fused_matches_jax_flowgraph():
    """The fused diamond on the port against the JAX package's (fused
    there too)."""
    import futuresdr_tpu as jfs
    from futuresdr_tpu import blocks as jblocks
    from futuresdr_tpu import tpu as jtpu
    from futuresdr_tpu.ops import stages as J
    from futuresdr_tpu.tpu.frames import TpuMergeStage as JaxMerge

    data = c64(73, 3 * FRAME)
    jfg = jfs.Flowgraph()
    jh2d = jtpu.TpuH2D(np.complex64, frame_size=FRAME)
    jp = jtpu.TpuStage([J.fir_stage(T1, name="p")], np.complex64)
    jb = [jtpu.TpuStage([J.fir_stage(T2, decim=4, fft_len=512, name=f"b{i}")],
                        np.complex64) for i in (1, 2)]
    jmg = JaxMerge(J.add_merge_stage(2), [J.mag2_stage()])
    jd2h, jsnk = jtpu.TpuD2H(np.float32), jblocks.VectorSink(np.float32)
    jfg.connect_stream(jblocks.VectorSource(data), "out", jh2d, "in")
    jfg.connect_inplace(jh2d, "out", jp, "in")
    for i, b in enumerate(jb):
        jfg.connect_inplace(jp, "out", b, "in")
        jfg.connect_inplace(b, "out", jmg, f"in{i}")
    jfg.connect_inplace(jmg, "out", jd2h, "in")
    jfg.connect_stream(jd2h, "out", jsnk, "in")
    jfs.Runtime().run(jfg)
    with no_devchain(False):
        fg, snks, _ = diamond_fg("1|1|1", data)
        Runtime().run(fg)
    a, b = jsnk.items(), snks[0].items()
    assert a.shape == b.shape == (3 * FRAME // 4,)
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# randomized shapes (the reference's fuzz family entry)
# ---------------------------------------------------------------------------

def test_random_devchain_shapes_fuzz():
    master = np.random.default_rng(20250802)
    for case in range(4):                     # linear chains, random member splits
        rng = np.random.default_rng(master.integers(1 << 62))
        frame = int(rng.choice([2048, 4096]))
        n_frames = int(rng.integers(2, 5))
        decim = int(rng.choice([1, 2, 4]))
        taps = firdes.lowpass(0.3, int(rng.choice([16, 33, 48]))).astype(np.float32)
        pool = [fir_stage(taps, fft_len=512, name="fa"),
                fir_stage(firdes.lowpass(0.2, 24).astype(np.float32), decim=decim,
                          fft_len=512, name="fb"),
                rotator_stage(float(rng.uniform(-0.3, 0.3))), mag2_stage()]
        n_stages = int(rng.integers(2, len(pool) + 1))
        stages = pool[:n_stages]
        cuts = sorted(rng.choice(range(1, n_stages), size=int(rng.integers(0, n_stages)),
                                 replace=False).tolist())
        groups, lo = [], 0
        for c in cuts + [n_stages]:
            groups.append(stages[lo:c])
            lo = c
        data = c64(int(rng.integers(1 << 30)), n_frames * frame)
        out_dt = np.float32 if any(s.name == "mag2" for s in stages) else np.complex64

        def build(groups=groups, data=data, frame=frame, out_dt=out_dt):
            fg = Flowgraph()
            h2d = TpuH2D(np.complex64, frame_size=frame, inst=CPU)
            fg.connect_stream(VectorSource(data), "out", h2d, "in")
            prev = h2d
            for g in groups:
                st = TpuStage(list(g), np.complex64, inst=CPU)
                fg.connect_inplace(prev, "out", st, "in")
                prev = st
            d2h, snk = TpuD2H(out_dt, inst=CPU), VectorSink(out_dt)
            fg.connect_inplace(prev, "out", d2h, "in")
            fg.connect_stream(d2h, "out", snk, "in")
            return fg, [snk]

        refs, got, _ = per_hop_and_fused(build)
        assert_bit_equal(got, refs)

    for case in range(3):                     # fan-outs: producer depth, branches
        rng = np.random.default_rng(master.integers(1 << 62))
        frame = int(rng.choice([2048, 4096]))
        n_frames = int(rng.integers(2, 5))
        taps = firdes.lowpass(0.3, int(rng.choice([16, 33]))).astype(np.float32)
        prod_depth = int(rng.integers(0, 3))
        n_branches = int(rng.integers(2, 4))
        decim = int(rng.choice([1, 2, 4]))

        def branch(j, rng=rng, taps=taps, decim=decim):
            pick = int(rng.integers(0, 3))
            if pick == 0:
                return [fir_stage(taps, decim=decim, fft_len=512, name=f"bf{j}")], \
                    np.complex64
            if pick == 1:
                return [mag2_stage()], np.float32
            return [rotator_stage(float(rng.uniform(-0.3, 0.3)))], np.complex64

        specs = [branch(j) for j in range(n_branches)]
        data = c64(int(rng.integers(1 << 30)), n_frames * frame)

        def build(specs=specs, data=data, frame=frame, taps=taps, prod_depth=prod_depth):
            fg = Flowgraph()
            h2d = TpuH2D(np.complex64, frame_size=frame, inst=CPU)
            fg.connect_stream(VectorSource(data), "out", h2d, "in")
            prev = h2d
            for d in range(prod_depth):
                st = TpuStage([fir_stage(taps, fft_len=512, name=f"pp{d}")],
                              np.complex64, inst=CPU)
                fg.connect_inplace(prev, "out", st, "in")
                prev = st
            snks = []
            for sl, out_dt in specs:
                st = TpuStage(list(sl), np.complex64, inst=CPU)
                d2h, snk = TpuD2H(out_dt, inst=CPU), VectorSink(out_dt)
                fg.connect_inplace(prev, "out", st, "in")
                fg.connect_inplace(st, "out", d2h, "in")
                fg.connect_stream(d2h, "out", snk, "in")
                snks.append(snk)
            return fg, snks

        refs, got, _ = per_hop_and_fused(
            build, lambda ch: len(ch) == 1 and ch[0].fanout or pytest.fail(f"{ch}"))
        assert_bit_equal(got, refs)

    for case in range(3):                     # diamonds and nested fan-outs
        rng = np.random.default_rng(master.integers(1 << 62))
        frame = int(rng.choice([2048, 4096]))
        n_frames = int(rng.integers(2, 5))
        taps = firdes.lowpass(0.3, int(rng.choice([16, 33]))).astype(np.float32)
        shape = ("diamond", "nested")[case % 2]
        prod_depth = int(rng.integers(0, 2))
        k_in = int(rng.integers(2, 4))
        decim = int(rng.choice([1, 2]))
        pick = int(rng.integers(0, 3))
        data = c64(int(rng.integers(1 << 30)), n_frames * frame)

        def build(shape=shape, taps=taps, frame=frame, data=data, prod_depth=prod_depth,
                  k_in=k_in, decim=decim, pick=pick):
            fg = Flowgraph()
            h2d = TpuH2D(np.complex64, frame_size=frame, inst=CPU)
            fg.connect_stream(VectorSource(data), "out", h2d, "in")
            prev = h2d
            for d in range(prod_depth):
                st = TpuStage([fir_stage(taps, fft_len=512, name=f"dp{d}")],
                              np.complex64, inst=CPU)
                fg.connect_inplace(prev, "out", st, "in")
                prev = st
            ends = []
            if shape == "diamond":
                mg = TpuMergeStage([add_merge_stage(k_in), interleave_merge_stage(k_in),
                                    concat_merge_stage(k_in)][pick], inst=CPU)
                for i in range(k_in):
                    st = TpuStage([fir_stage(taps, decim=decim, fft_len=512,
                                             name=f"db{i}")], np.complex64, inst=CPU)
                    fg.connect_inplace(prev, "out", st, "in")
                    fg.connect_inplace(st, "out", mg, f"in{i}")
                ends.append((mg, np.complex64))
            else:
                mid = TpuStage([fir_stage(taps, fft_len=512, name="mid")], np.complex64,
                               inst=CPU)
                fg.connect_inplace(prev, "out", mid, "in")
                for i in range(2):
                    st = TpuStage([fir_stage(taps, fft_len=512, name=f"leaf{i}")],
                                  np.complex64, inst=CPU)
                    fg.connect_inplace(mid, "out", st, "in")
                    ends.append((st, np.complex64))
                st2 = TpuStage([mag2_stage()], np.complex64, inst=CPU)
                fg.connect_inplace(prev, "out", st2, "in")
                ends.append((st2, np.float32))
            snks = []
            for st, dt in ends:
                d2h, snk = TpuD2H(dt, inst=CPU), VectorSink(dt)
                fg.connect_inplace(st, "out", d2h, "in")
                fg.connect_stream(d2h, "out", snk, "in")
                snks.append(snk)
            return fg, snks

        refs, got, _ = per_hop_and_fused(
            build, lambda ch: len(ch) == 1 and ch[0].dag or pytest.fail(f"{ch}"))
        assert_bit_equal(got, refs)
