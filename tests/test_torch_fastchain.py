"""The port's native fast chain (``runtime/fastchain.py`` over
``csrc/host/fastchain.cpp``): the cases of ``tests/test_fastchain.py`` and
``tests/test_fastchain_tree.py`` on the port, then the port held against the
JAX package: a grid pipe fused natively within 1e-5 of the peak of the JAX
package's actor path, the AVX-512 and ``-mno-avx512f`` builds in agreement to
float32 rounding, a failed build raising with the compiler's output, and the
opt-outs. Both packages read ``FSDR_NO_FASTCHAIN``/``FSDR_NO_NATIVE``: the
parity cases set them around each package's run with ``monkeypatch``.
"""

import time

import numpy as np
import pytest
import torch

from futuresdr_tpu_torch import Flowgraph, Runtime
from futuresdr_tpu_torch.blocks import (Copy, CopyRand, Fir, Head, NullSink, NullSource,
                                        Throttle, VectorSink, VectorSource)
from futuresdr_tpu_torch.dsp import firdes
from futuresdr_tpu_torch.runtime import fastchain
from futuresdr_tpu_torch.runtime.fastchain import fastchain_available, find_native_chains

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)


def _pipe(fg, samples, stages=2):
    src, head = NullSource(np.float32), Head(np.float32, samples)
    fg.connect(src, head)
    last = head
    for s in range(stages):
        c = CopyRand(np.float32, max_copy=512, seed=s + 1)
        fg.connect(last, c)
        last = c
    snk = NullSink(np.float32)
    fg.connect(last, snk)
    return snk


def test_fused_pipe_runs_and_counts():
    fg = Flowgraph()
    snk = _pipe(fg, 100_000)
    assert len(find_native_chains(fg)) == 1
    fg2 = Flowgraph()
    snk2 = _pipe(fg2, 100_000)
    Runtime().run(fg2)
    assert snk2.n_received == 100_000
    # metrics carry the counters + the fused marker
    w = fg2.wrapped(snk2)
    m = w.metrics()
    assert m["work_calls"] > 0
    assert m["fused_native"] is True
    assert m["items_in"]["in"] == 100_000
    del fg, snk


def test_opt_out_env_runs_python_path():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FSDR_NO_FASTCHAIN", "1")
        fg = Flowgraph()
        snk = _pipe(fg, 50_000)
        assert find_native_chains(fg) == []
        Runtime().run(fg)
        assert snk.n_received == 50_000
        assert "fused_native" not in fg.wrapped(snk).metrics()


def test_broadcast_tap_fuses_as_tree():
    """A broadcast tap (one output port wired to two sinks) fuses as a TREE
    since the v3 driver (round 5): every consumer of the tapped ring sees
    every item, matching the actor runtime's 1-writer→N-reader port groups."""
    fg = Flowgraph()
    src, head = NullSource(np.float32), Head(np.float32, 1000)
    cp, snk = Copy(np.float32), NullSink(np.float32)
    fg.connect(src, head, cp, snk)
    snk2 = NullSink(np.float32)
    fg.connect_stream(cp, "out", snk2, "in")
    trees = find_native_chains(fg)
    assert len(trees) == 1 and len(trees[0]) == 5
    assert trees[0].in_ring == [-1, 0, 1, 2, 2]
    Runtime().run(fg)
    assert snk.n_received == 1000 and snk2.n_received == 1000


def test_vector_endpoints_fuse_with_exact_data():
    """VectorSource/VectorSink are native-capable: a real data pipe fuses and
    the collected samples are BIT-exact — the data-integrity check the Null
    chains cannot provide."""
    from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
    rng = np.random.default_rng(3)
    data = rng.standard_normal(50_000).astype(np.float32)
    fg = Flowgraph()
    src = VectorSource(data, repeat=2)
    cp = CopyRand(np.float32, max_copy=512, seed=9)
    vs = VectorSink(np.float32)
    fg.connect(src, cp, vs)
    assert len(find_native_chains(fg)) == 1
    Runtime().run(fg)
    got = vs.items()
    np.testing.assert_array_equal(got, np.concatenate([data, data]))
    m = fg.wrapped(vs).metrics()
    assert m["fused_native"] is True and m["items_in"]["in"] == 100_000

    # a Head mid-chain clamps the collected count exactly
    fg2 = Flowgraph()
    src2 = VectorSource(data)
    h2 = Head(np.float32, 12_345)
    vs2 = VectorSink(np.float32)
    fg2.connect(src2, h2, Copy(np.float32), vs2)
    assert len(find_native_chains(fg2)) == 1
    Runtime().run(fg2)
    np.testing.assert_array_equal(vs2.items(), data[:12_345])


def test_unbounded_into_vector_sink_not_fused():
    """NullSource (infinite) into a collecting VectorSink must NOT fuse — the
    capacity bound would be unbounded."""
    from futuresdr_tpu_torch.blocks import VectorSink
    fg = Flowgraph()
    src, cp = NullSource(np.float32), Copy(np.float32)
    vs = VectorSink(np.float32)
    fg.connect(src, cp, vs)
    assert find_native_chains(fg) == []


def test_terminate_stops_unbounded_fused_chain():
    fg = Flowgraph()
    src, cp, snk = NullSource(np.float32), Copy(np.float32), NullSink(np.float32)
    fg.connect(src, cp, snk)
    assert len(find_native_chains(fg)) == 1
    rt = Runtime()
    running = rt.start(fg)
    deadline = time.perf_counter() + 10.0
    seen = 0
    while time.perf_counter() < deadline:
        m = running.handle.metrics_sync()
        seen = max((v["work_calls"] for v in m.values()), default=0)
        if seen > 0:
            break
        time.sleep(0.01)
    assert seen > 0, "live metrics never observed the fused chain"
    running.stop_sync()                    # Terminate → stop flag → clean join
    assert snk.n_received > 0


def test_fused_beside_python_pipe():
    """A fused pipe and a plain Python pipe coexist in one flowgraph."""
    from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
    fg = Flowgraph()
    snk_native = _pipe(fg, 20_000)
    data = np.arange(5000, dtype=np.float32)
    vsrc, vsnk = VectorSource(data), VectorSink(np.float32)
    fg.connect(vsrc, Copy(np.float32), vsnk)
    assert len(find_native_chains(fg)) == 2    # the vector pipe fuses too now
    Runtime().run(fg)
    assert snk_native.n_received == 20_000
    np.testing.assert_array_equal(vsnk.items(), data)


def test_untyped_sink_port_uses_chain_dtype():
    """Regression (review): the sink buffer must be sized by the CHAIN dtype,
    not the sink port's own (possibly None) dtype — deriving them separately
    wrote item_size-wide items into a uint8 buffer (heap corruption)."""
    from futuresdr_tpu_torch.blocks import VectorSink
    fg = Flowgraph()
    src = NullSource(np.float64)
    head = Head(np.float64, 1000)
    vs = VectorSink(None)                   # untyped collecting port
    fg.connect(src, head, vs)
    assert len(find_native_chains(fg)) == 1
    Runtime().run(fg)
    got = vs.items()
    assert got.dtype == np.float64 and len(got) == 1000
    assert not got.any()                    # NullSource emits zeros


def test_fused_chain_busy_ns_profile():
    """The native driver attributes per-stage busy time (every scheduling
    pass, productive or not) into the metrics bridge: a 64-tap FIR stage must
    dominate the copies, and the per-stage sum must stay within the run's
    wall time (nothing double-counted)."""
    import time as _t

    from futuresdr_tpu_torch.blocks import Fir
    from futuresdr_tpu_torch.dsp import firdes

    fg = Flowgraph()
    src = NullSource(np.float32)
    head = Head(np.float32, 4_000_000)
    fir = Fir(firdes.lowpass(0.2, 64).astype(np.float32))
    cp = Copy(np.float32)
    snk = NullSink(np.float32)
    fg.connect(src, head, fir, cp, snk)
    assert len(find_native_chains(fg)) == 1
    t0 = _t.perf_counter()
    Runtime().run(fg)
    wall_ns = (_t.perf_counter() - t0) * 1e9
    busy = {type(b.kernel).__name__: b.metrics().get("busy_ns", 0)
            for b in (fg.wrapped(k) for k in (src, head, fir, cp, snk))}
    assert all(v > 0 for v in busy.values()), busy
    assert busy["Fir"] > busy["Copy"], busy          # the FIR does the FLOPs
    assert sum(busy.values()) <= wall_ns * 1.1, (busy, wall_ns)


def test_refused_flowgraph_metrics_stay_fresh():
    """Re-running the SAME flowgraph re-bridges the fused members: the second
    run's counters must reflect the second run (review regression: chaining
    off the previous bridge re-applied run 1's counters after refresh, so
    stale values won and every re-fuse pinned another set of arrays)."""
    fg = Flowgraph()
    src, head = NullSource(np.float32), Head(np.float32, 100_000)
    cp, snk = Copy(np.float32), NullSink(np.float32)
    fg.connect(src, head, cp, snk)
    Runtime().run(fg)
    assert fg.wrapped(cp).metrics()["items_in"]["in"] == 100_000
    # second run: the Head is exhausted, so the actor semantics are 0 items
    Runtime().run(fg)
    m = fg.wrapped(cp).metrics()
    assert m["items_in"]["in"] == 0, m


def test_fused_then_actor_relaunch_metrics_not_stomped():
    """A kernel that fused once and is then relaunched on the ACTOR path (new
    flowgraph, FSDR_NO_FASTCHAIN A/B pattern) must shed the stale bridge:
    the actor run's live counters, not the old fused run's frozen values."""
    src, head = NullSource(np.float32), Head(np.float32, 70_000)
    cp, snk = Copy(np.float32), NullSink(np.float32)
    fg = Flowgraph()
    fg.connect(src, head, cp, snk)
    Runtime().run(fg)
    assert fg.wrapped(cp).metrics()["fused_native"] is True

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FSDR_NO_FASTCHAIN", "1")     # same fg, actor path this time
        head.remaining = 12_000                # rearm for the second run
        Runtime().run(fg)
        m = fg.wrapped(cp).metrics()
        assert "fused_native" not in m, m
        # port counters are kernel-lifetime cumulative (70k fused + 12k
        # actor); the stale bridge would have frozen this at 70k
        assert m["items_in"]["in"] == 82_000, m


def _tree_fg(n=30_000, seed=5):
    """VectorSource → CopyRand → broadcast{VectorSink, Fir64 → VectorSink}."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal(n).astype(np.float32)
    taps = firdes.lowpass(0.25, 64).astype(np.float32)
    fg = Flowgraph()
    src = VectorSource(data)
    cr = CopyRand(np.float32, max_copy=700, seed=seed)
    raw = VectorSink(np.float32)
    fir = Fir(taps)
    filt = VectorSink(np.float32)
    fg.connect(src, cr)
    fg.connect_stream(cr, "out", raw, "in")
    fg.connect(cr, fir, filt)
    return fg, data, taps, raw, filt


def test_broadcast_tree_data_exact_vs_actor():
    """Both branches of a fused broadcast see every item: the raw branch is
    BIT-exact vs the source data, the FIR branch matches the actor path run
    of the same flowgraph to float32 rounding."""
    fg, data, taps, raw, filt = _tree_fg()
    trees = find_native_chains(fg)
    assert len(trees) == 1 and len(trees[0]) == 5
    Runtime().run(fg)
    got_raw = raw.items()
    got_filt = filt.items()
    assert np.array_equal(got_raw, data)          # broadcast copy is bit-exact

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FSDR_NO_FASTCHAIN", "1")
        fg2, data2, _, raw2, filt2 = _tree_fg()
        assert find_native_chains(fg2) == []
        Runtime().run(fg2)
    assert np.array_equal(raw2.items(), got_raw)
    np.testing.assert_allclose(filt2.items(), got_filt, rtol=2e-5, atol=2e-6)


def test_broadcast_counters_per_branch():
    """Per-member metrics stay honest on a tree: the broadcast producer
    reports its items once, each branch its own consumed/produced counts."""
    fg, data, taps, raw, filt = _tree_fg(n=10_000)
    Runtime().run(fg)
    w_cr = fg.wrapped(next(k for k in (b.kernel for b in fg._blocks
                                       if b is not None)
                           if isinstance(k, CopyRand)))
    m = w_cr.metrics()
    assert m["fused_native"] is True
    assert m["items_out"]["out"] == 10_000
    assert fg.wrapped(raw).metrics()["items_in"]["in"] == 10_000
    assert fg.wrapped(filt).metrics()["items_in"]["in"] == 10_000


def test_early_finishing_branch_releases_ring():
    """A Head-bounded branch that finishes first must not wedge its broadcast
    sibling: its ring slot is released (the actor runtime drops a finished
    reader the same way)."""
    fg = Flowgraph()
    src = NullSource(np.float32)
    cp = Copy(np.float32)
    h_short = Head(np.float32, 512)          # finishes almost immediately
    snk_short = NullSink(np.float32)
    h_long = Head(np.float32, 3_000_000)     # many ring generations later
    snk_long = NullSink(np.float32)
    fg.connect(src, cp)
    fg.connect(cp, h_short, snk_short)
    fg.connect_stream(cp, "out", h_long, "in")
    fg.connect(h_long, snk_long)
    assert len(find_native_chains(fg)) == 1
    Runtime().run(fg)
    assert snk_short.n_received == 512
    assert snk_long.n_received == 3_000_000


def test_throttle_fuses_behind_static_opt_in_and_paces():
    """Throttle fuses only with the fastchain_static promise (it has a live
    rate retune handler), and the native stage paces by the same wall-clock
    budget math as the actor work() loop."""
    def build(static):
        fg = Flowgraph()
        src = VectorSource(np.ones(20_000, np.float32))
        th = Throttle(np.float32, 40_000.0)
        if static:
            th.fastchain_static = True
        snk = NullSink(np.float32)
        fg.connect(src, th, snk)
        return fg, snk

    fg, _ = build(static=False)
    assert find_native_chains(fg) == []      # no opt-in → actor path

    fg, snk = build(static=True)
    assert len(find_native_chains(fg)) == 1
    t0 = time.perf_counter()
    Runtime().run(fg)
    dt = time.perf_counter() - t0
    assert snk.n_received == 20_000
    # 20k items at 40k/s ≈ 0.5 s; generous upper bound for a loaded host
    assert 0.4 <= dt <= 5.0, dt

    # degenerate rates must not freeze the fused loop: inf is rejected at the
    # gate (actor path raises on it), a finite-but-huge rate fuses and runs
    # effectively unthrottled (the C budget clamps instead of overflowing
    # the int64 cast into a permanent 0-item sleep)
    fg3 = Flowgraph()
    src3 = VectorSource(np.ones(5_000, np.float32))
    th3 = Throttle(np.float32, 1e19)
    th3.fastchain_static = True
    snk3 = NullSink(np.float32)
    fg3.connect(src3, th3, snk3)
    assert len(find_native_chains(fg3)) == 1
    Runtime().run(fg3)
    assert snk3.n_received == 5_000


def test_tree_with_collecting_sinks_bounded_per_path():
    """Each collecting sink's capacity derives from its OWN source→sink path
    (a decimating branch collects fewer items than its sibling)."""
    rng = np.random.default_rng(11)
    data = rng.standard_normal(8_192).astype(np.float32)
    taps = firdes.lowpass(0.2, 32).astype(np.float32)
    fg = Flowgraph()
    src = VectorSource(data)
    cp = Copy(np.float32)
    full = VectorSink(np.float32)
    dec = Fir(taps, decim=4)
    quarter = VectorSink(np.float32)
    fg.connect(src, cp)
    fg.connect_stream(cp, "out", full, "in")
    fg.connect(cp, dec, quarter)
    assert len(find_native_chains(fg)) == 1
    Runtime().run(fg)
    assert len(full.items()) == 8_192
    assert len(quarter.items()) == 2_048
    assert np.array_equal(full.items(), data)


def test_random_tree_shapes_fuzz():
    """Seeded sweep over random ELIGIBLE trees: a random linear prefix, a
    fan-out point broadcasting to 2-3 branches, each branch a random stage
    suffix into its own VectorSink — every fused tree must match its actor
    twin per branch. The tree-composition analog of the chain fuzz
    (`test_torch_fastchain_dsp.test_random_chain_shapes_fuzz`)."""
    rng = np.random.default_rng(24242)
    for trial in range(5):
        n = int(rng.integers(5_000, 16_000))
        data = rng.standard_normal(n).astype(np.float32)
        n_branches = int(rng.integers(2, 4))
        pre = [str(k) for k in rng.choice(["copyrand", "fir"],
                                          size=rng.integers(0, 3))]
        suff = [[str(k) for k in rng.choice(["copyrand", "fir", "decim"],
                                            size=rng.integers(0, 3))]
                for _ in range(n_branches)]
        pseed = int(rng.integers(0, 1 << 30))

        def stage(kind, r):
            if kind == "copyrand":
                return CopyRand(np.float32, int(r.integers(64, 1024)),
                                seed=int(r.integers(1, 99)))
            if kind == "fir":
                return Fir(firdes.lowpass(0.2, int(r.integers(8, 65))
                                          ).astype(np.float32))
            return Fir(firdes.lowpass(0.1, 32).astype(np.float32),
                       decim=int(r.integers(2, 5)))

        def build():
            r = np.random.default_rng(pseed)   # identical params per path
            fg = Flowgraph()
            last = VectorSource(data)
            fg.add(last)
            for k in pre:
                b = stage(k, r)
                fg.connect(last, b)
                last = b
            fan = Copy(np.float32)
            fg.connect(last, fan)
            sinks = []
            for br in suff:
                cur = fan
                for k in br:
                    b = stage(k, r)
                    fg.connect_stream(cur, "out", b, "in")
                    cur = b
                vs = VectorSink(np.float32)
                fg.connect_stream(cur, "out", vs, "in")
                sinks.append(vs)
            return fg, sinks

        fg, sinks = build()
        trees = find_native_chains(fg)
        assert len(trees) == 1, (trial, pre, suff)
        Runtime().run(fg)
        native = [vs.items() for vs in sinks]

        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("FSDR_NO_FASTCHAIN", "1")
            fg2, sinks2 = build()
            assert find_native_chains(fg2) == []
            Runtime().run(fg2)
        for bi, (got, want_sink) in enumerate(zip(native, sinks2)):
            want = want_sink.items()
            assert len(got) == len(want), (trial, bi, pre, suff)
            np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-5,
                                       err_msg=f"{trial} branch {bi}")


def test_stream_duplicator_fuses_as_broadcast():
    """StreamDuplicator (1→N duplicate block, `stream_duplicator.rs`) fuses
    as one broadcast ring — N ports all carrying every item is exactly the
    per-consumer-tails ring; per-port produced counters match the actor's."""
    from futuresdr_tpu_torch.blocks import StreamDuplicator
    rng = np.random.default_rng(7)
    data = rng.standard_normal(12_000).astype(np.float32)

    def build():
        fg = Flowgraph()
        src = VectorSource(data)
        dup = StreamDuplicator(np.float32, n_outputs=2)
        a, b = VectorSink(np.float32), VectorSink(np.float32)
        fg.connect(src, dup)
        fg.connect_stream(dup, "out0", a, "in")
        fg.connect_stream(dup, "out1", b, "in")
        return fg, dup, a, b

    fg, dup, a, b = build()
    assert len(find_native_chains(fg)) == 1
    Runtime().run(fg)
    assert np.array_equal(a.items(), data)
    assert np.array_equal(b.items(), data)
    m = fg.wrapped(dup).metrics()
    assert m["fused_native"] is True
    assert m["items_out"]["out0"] == 12_000
    assert m["items_out"]["out1"] == 12_000

    # an UNWIRED duplicator port must not fuse: the actor path raises on it,
    # and the substitution must stay invisible (review regression)
    fg2 = Flowgraph()
    dup2 = StreamDuplicator(np.float32, n_outputs=3)
    a2 = VectorSink(np.float32)
    fg2.connect(VectorSource(data), dup2)
    fg2.connect_stream(dup2, "out0", a2, "in")
    fg2.connect_stream(dup2, "out1", VectorSink(np.float32), "in")
    assert find_native_chains(fg2) == []


# ---- the port against the JAX package -----------------------------------------

def _grid_pipe(blocks, data, stages, taps):
    """``VectorSource -> [CopyRand(4096) -> Fir(taps)] x stages -> VectorSink``
    of ``blocks`` (either package's block module)."""
    fg_mod = blocks.__name__.rsplit(".", 1)[0]
    Fg = __import__(fg_mod, fromlist=["Flowgraph"]).Flowgraph
    fg = Fg()
    last = blocks.VectorSource(data)
    fg.add(last)
    for s in range(stages):
        cr = blocks.CopyRand(np.float32, 4096, seed=s + 1)
        fir = blocks.Fir(taps, np.float32)
        fg.connect(last, cr, fir)
        last = fir
    snk = blocks.VectorSink(np.float32)
    fg.connect(last, snk)
    return fg, snk


def test_native_grid_pipe_is_within_1e5_of_the_jax_actor_path(monkeypatch):
    """One pipe of the north-star grid (``perf/fir.py``: CopyRand(4096) ->
    64-tap Fir, 6 stages) on a seeded VectorSource: fused natively on the
    port, it stays within 1e-5 of the peak of the JAX package's actor path."""
    import futuresdr_tpu as J
    from futuresdr_tpu import blocks as jblocks
    from futuresdr_tpu_torch import blocks as tblocks
    data = np.random.default_rng(20).standard_normal(200_000).astype(np.float32)
    taps = firdes.lowpass(0.2, 64).astype(np.float32)
    monkeypatch.setenv("FSDR_NO_FASTCHAIN", "1")
    jfg, jsnk = _grid_pipe(jblocks, data, 6, taps)
    J.Runtime().run(jfg)
    want = jsnk.items()
    monkeypatch.delenv("FSDR_NO_FASTCHAIN")
    fg, snk = _grid_pipe(tblocks, data, 6, taps)
    assert len(find_native_chains(fg)) == 1
    Runtime().run(fg)
    got = snk.items()
    assert fg.wrapped(snk).metrics()["fused_native"] is True
    assert len(got) == len(want) == len(data)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
@pytest.mark.parametrize("n_taps", [64, 33])
def test_avx512_and_scalar_builds_agree_to_float32_rounding(monkeypatch, dtype, n_taps):
    """The library built with the AVX-512 FIR kernels and the one built with
    ``-mno-avx512f`` (the scalar and auto-vectorized paths) give the same FIR
    cascade to float32 rounding; 64 taps take the folded symmetric kernel,
    33 the plain one. On a CPU without AVX-512 both builds are the scalar one."""
    rng = np.random.default_rng(n_taps)
    x = rng.standard_normal(30_000)
    if dtype == np.complex64:
        x = x + 1j * rng.standard_normal(30_000)
    x = x.astype(dtype)
    taps = firdes.lowpass(0.2, n_taps).astype(np.float32)

    def run(lib):
        monkeypatch.setattr(fastchain, "_lib", lib)
        fg = Flowgraph()
        snk = VectorSink(dtype)
        fg.connect(VectorSource(x), Fir(taps, dtype), CopyRand(dtype, 700, seed=3),
                   Fir(taps, dtype, decim=3), snk)
        assert len(find_native_chains(fg)) == 1
        Runtime().run(fg)
        return snk.items()

    from futuresdr_tpu_torch.ops import _build
    wide = run(fastchain.library())
    # the scalar build: the same source with -mno-avx512f after its own flags
    monkeypatch.setitem(_build.HOST_SOURCE_FLAGS, "fastchain",
                        _build.HOST_SOURCE_FLAGS["fastchain"] + ("-mno-avx512f",))
    monkeypatch.setattr(_build, "_host_libs", {})
    narrow_lib = fastchain.library()
    assert narrow_lib.fsdr_fastchain_avx512() == 0
    narrow = run(narrow_lib)
    assert len(wide) == len(narrow) == 10_000
    np.testing.assert_allclose(wide, narrow, rtol=2e-5, atol=2e-6 * np.abs(narrow).max())


def test_avx512_flag_follows_the_cpu():
    """``avx512_built()`` says whether the library has the AVX-512 FIR path:
    it does exactly where the CPU reports ``avx512f``."""
    with open("/proc/cpuinfo") as f:
        has = any(line.startswith("flags") and " avx512f" in line for line in f)
    assert fastchain.avx512_built() == has


def test_a_failed_build_raises_with_the_compiler_output(monkeypatch):
    """No silent way back to the actor path: a fast chain whose library does
    not build makes the launch raise with g++'s message."""
    from futuresdr_tpu_torch.ops import _build
    monkeypatch.setitem(_build.HOST_SOURCE_FLAGS, "fastchain",
                        _build.HOST_SOURCE_FLAGS["fastchain"] + ("-fno-such-option-here",))
    monkeypatch.setattr(_build, "_host_libs", {})
    monkeypatch.setattr(fastchain, "_lib", None)
    fg = Flowgraph()
    fg.connect(NullSource(np.float32), Head(np.float32, 100), NullSink(np.float32))
    with pytest.raises(RuntimeError, match="no-such-option-here"):
        find_native_chains(fg)
    with pytest.raises(RuntimeError, match="no-such-option-here"):
        Runtime().run(fg, timeout=60)


def test_a_flowgraph_with_nothing_to_fuse_never_builds_the_library(monkeypatch):
    """The library is built only where a tree fuses: a flowgraph with no
    fusable tree runs on the actor path even where the build would fail,
    and leaves the library unbuilt."""
    from futuresdr_tpu_torch.blocks import Apply
    from futuresdr_tpu_torch.ops import _build
    monkeypatch.setitem(_build.HOST_SOURCE_FLAGS, "fastchain",
                        _build.HOST_SOURCE_FLAGS["fastchain"] + ("-fno-such-option-here",))
    monkeypatch.setattr(_build, "_host_libs", {})
    monkeypatch.setattr(fastchain, "_lib", None)
    fg = Flowgraph()
    snk = VectorSink(np.float32)
    fg.connect(VectorSource(np.arange(1000, dtype=np.float32)),
               Apply(lambda x: 2 * x, np.float32, np.float32), snk)
    assert find_native_chains(fg) == []
    Runtime().run(fg, timeout=60)
    np.testing.assert_array_equal(snk.items(), 2 * np.arange(1000, dtype=np.float32))
    assert fastchain._lib is None and _build._host_libs == {}


@pytest.mark.parametrize("var", ["FSDR_NO_FASTCHAIN", "FSDR_NO_NATIVE"])
def test_each_opt_out_runs_the_actor_path(monkeypatch, var):
    monkeypatch.setenv(var, "1")
    assert not fastchain_available() and not fastchain.avx512_built()
    fg = Flowgraph()
    snk = NullSink(np.float32)
    fg.connect(NullSource(np.float32), Head(np.float32, 20_000), Copy(np.float32), snk)
    assert find_native_chains(fg) == []
    Runtime().run(fg)
    assert snk.n_received == 20_000
    assert "fused_native" not in fg.wrapped(snk).metrics()


def test_fused_member_answers_a_call_with_invalid_value():
    """A fused chain is static: a callback addressed to a member (Throttle's
    rate handler, fused behind ``fastchain_static``) gets ``invalid_value``."""
    from futuresdr_tpu_torch import Pmt
    fg = Flowgraph()
    th = Throttle(np.float32, 2_000.0)
    th.fastchain_static = True
    fg.connect(NullSource(np.float32), th, NullSink(np.float32))
    assert len(find_native_chains(fg)) == 1
    running = Runtime().start(fg)
    try:
        got = running.handle.call_sync(th, "rate_handler",
                                       Pmt.f32(10.0))
        assert got == Pmt.invalid_value()
    finally:
        running.stop_sync()
