"""The port's device-graph fusion (``runtime/devchain.py``), linear and fan-out.

The linear and fan-out cases of ``tests/test_devchain.py`` on the port, each
fused flowgraph against the same flowgraph with ``FSDR_NO_DEVCHAIN=1`` (per
hop), bit for bit on the CPU: the fused program runs each member's stages as
the per-hop blocks do, with identity stages at member boundaries. Tags
rebase through the composed rate, metrics report the original blocks, and
the refusals keep regions per hop. One linear frame-plane flowgraph is also
held against the JAX package's flowgraph (the FIR chain's tolerance of
``tests/test_torch_stages.py``, rtol 1e-4 / atol 1e-5, |x|² after it 1e-4 /
1e-4). The port's own cases follow: a ``ctrl`` retune addressed to a fused
member, the handle's metrics of a fused run, and the EOS divergence the
reference documents (a final partial frame yields up to one composed frame
multiple fewer items fused).

Cases of the reference file that wait, with their ROADMAP items:
``test_fanout_refuses_policy_bearing_member`` (failure policies, Queue 1
item 4b), ``test_fanout_span_and_report_carry_branch_attribution``
(telemetry, 4b), ``test_fanout_launches_with_cached_autotune_k`` (the
autotuned K, item 7) and ``test_donation_mask_fanout_compile`` (XLA
donation, which has no counterpart: a CUDA graph's carry is static buffers).
The DAG cases are ``tests/test_torch_devchain_dag.py``'s.
"""

import asyncio
import os
import threading
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from futuresdr_tpu_torch import Flowgraph, Kernel, Runtime
from futuresdr_tpu_torch.blocks import MessageSource, VectorSink, VectorSource
from futuresdr_tpu_torch.config import config
from futuresdr_tpu_torch.dsp import firdes
from futuresdr_tpu_torch.ops import fft_stage, fir_stage, mag2_stage, rotator_stage
from futuresdr_tpu_torch.runtime.devchain import find_device_chains
from futuresdr_tpu_torch.tpu import TpuD2H, TpuH2D, TpuInstance, TpuKernel, TpuStage
from futuresdr_tpu_torch.types import Pmt
from tests.test_torch_frames import TAG_AT, TaggedRampSource, TagRecordingSink

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

CPU = TpuInstance("cpu")
T1 = firdes.lowpass(0.25, 48).astype(np.float32)
T2 = firdes.lowpass(0.2, 32).astype(np.float32)
FRAME = 4096


@contextmanager
def no_devchain(on: bool = True):
    old = os.environ.pop("FSDR_NO_DEVCHAIN", None)
    if on:
        os.environ["FSDR_NO_DEVCHAIN"] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("FSDR_NO_DEVCHAIN", None)
        else:
            os.environ["FSDR_NO_DEVCHAIN"] = old


@contextmanager
def frames_per_dispatch(k: int):
    old = config().tpu_frames_per_dispatch
    config().tpu_frames_per_dispatch = k
    try:
        yield
    finally:
        config().tpu_frames_per_dispatch = old


def c64(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


def per_hop_and_fused(build, check_chains=None):
    """Run ``build()``'s flowgraph per hop, then fused; returns both sinks'
    items (lists, one a sink) and the fused flowgraph's build result."""
    with no_devchain():
        built = build()
        assert find_device_chains(built[0]) == []
        Runtime().run(built[0])
        refs = [s.items() for s in built[1]]
    with no_devchain(False):
        built = build()
        chains = find_device_chains(built[0])
        if check_chains is not None:
            check_chains(chains)
        Runtime().run(built[0])
        got = [s.items() for s in built[1]]
    return refs, got, built


def assert_bit_equal(got, refs):
    for g, r in zip(got, refs):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


def frame_plane_fg(member_lists, data, frame, out_dt=np.float32, inst=CPU):
    fg = Flowgraph()
    src = VectorSource(data)
    h2d = TpuH2D(np.complex64, frame_size=frame, inst=inst)
    d2h = TpuD2H(out_dt, inst=inst)
    snk = VectorSink(out_dt)
    fg.connect_stream(src, "out", h2d, "in")
    prev = h2d
    for sl in member_lists:
        st = TpuStage(sl, np.complex64, inst=inst)
        fg.connect_inplace(prev, "out", st, "in")
        prev = st
    fg.connect_inplace(prev, "out", d2h, "in")
    fg.connect_stream(d2h, "out", snk, "in")
    return fg, [snk]


def stage_lists(split: str):
    """The same 3-stage chain under different member splits."""
    s1, s2, s3 = fir_stage(T1, name="a"), fir_stage(T2, decim=4, name="b"), mag2_stage()
    return {"1|1|1": [[s1], [s2], [s3]], "2|1": [[s1, s2], [s3]],
            "1|2": [[s1], [s2, s3]]}[split]


# ---------------------------------------------------------------------------
# linear regions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split", ["1|1|1", "2|1", "1|2"])
@pytest.mark.parametrize("frames_n", [1, 3])
def test_frame_plane_fused_bit_equals_per_hop(split, frames_n):
    n = frames_n * FRAME
    data = c64(7, n)
    refs, got, _ = per_hop_and_fused(
        lambda: frame_plane_fg(stage_lists(split), data, FRAME),
        lambda ch: len(ch) == 1 or pytest.fail(f"{ch}"))
    assert len(refs[0]) == n // 4
    assert_bit_equal(got, refs)


def test_kernel_run_fused_bit_equals_per_hop():
    """Adjacent TpuKernels over a stream edge fuse into one kernel."""
    data = c64(8, 4 * FRAME)

    def build():
        fg = Flowgraph()
        src, snk = VectorSource(data), VectorSink(np.float32)
        k1 = TpuKernel([fir_stage(T1, decim=4)], np.complex64, frame_size=FRAME, inst=CPU)
        k2 = TpuKernel([mag2_stage()], np.complex64, frame_size=1024, inst=CPU)
        fg.connect(src, k1, k2, snk)
        return fg, [snk], k1

    def check(chains):
        assert len(chains) == 1 and chains[0].kind == "kernels"

    refs, got, built = per_hop_and_fused(build, check)
    assert_bit_equal(got, refs)
    m = built[2].extra_metrics()
    assert m["fused_devchain"] and m["devchain_dispatches"] == m["devchain_frames"] == 4


@pytest.mark.parametrize("k", [2, 4])
def test_fused_megabatch_bit_equals_per_hop(k):
    """K frames a dispatch through the fused chain, the EOS partial group
    included (5 frames)."""
    data = c64(9, 5 * FRAME)
    with no_devchain():
        fg, snks = frame_plane_fg(stage_lists("1|1|1"), data, FRAME)
        Runtime().run(fg)
        ref = snks[0].items()
    with frames_per_dispatch(k), no_devchain(False):
        fg, snks = frame_plane_fg(stage_lists("1|1|1"), data, FRAME)
        Runtime().run(fg)
        got = snks[0].items()
        h2d = next(b.kernel for b in fg._blocks if isinstance(b.kernel, TpuH2D))
        m = h2d.extra_metrics()
    assert_bit_equal([got], [ref])
    assert m["frames_per_dispatch"] == k and m["devchain_frames"] == 5
    assert m["devchain_dispatches"] == -(-5 // k)


def test_tags_rebase_through_decimating_fused_run():
    n = 3 * FRAME
    with no_devchain(False):
        fg = Flowgraph()
        src = TaggedRampSource(n)
        h2d = TpuH2D(np.complex64, frame_size=FRAME, inst=CPU)
        st1 = TpuStage([fir_stage(T2, decim=4)], np.complex64, inst=CPU)
        st2 = TpuStage([mag2_stage()], np.complex64, inst=CPU)
        d2h = TpuD2H(np.float32, inst=CPU)
        snk = TagRecordingSink(np.float32)
        fg.connect(src, h2d, st1, st2, d2h, snk)
        assert len(find_device_chains(fg)) == 1
        Runtime().run(fg)
    assert snk.n_received == n // 4
    assert {t.value: i for i, t in snk.seen} == {a: a // 4 for a in TAG_AT}


def test_fused_member_metrics_bridge():
    """metrics() reports every original block: fused provenance, and item
    counters through the composed rates."""
    with no_devchain(False):
        fg, _ = frame_plane_fg(stage_lists("1|1|1"), np.zeros(3 * FRAME, np.complex64),
                               FRAME)
        Runtime().start(fg).wait_sync()
    mets = {b.instance_name: b.metrics() for b in fg._blocks if b is not None}
    fused = {n: m for n, m in mets.items() if m.get("fused_devchain")}
    assert len(fused) == 5            # h2d, 3 stages, d2h
    for m in fused.values():
        assert m["devchain_frames"] == 3 and m["devchain_dispatches"] == 3
    st_dec = fused["TpuStage_3"]
    assert st_dec["items_in"] == {"in": 3 * FRAME}
    assert st_dec["items_out"] == {"out": 3 * FRAME // 4}


class GateSource(Kernel):
    """Emits ``data`` once ``gate`` is set (a test's handle calls land on a
    running flowgraph before any frame moves)."""

    def __init__(self, data, gate: threading.Event):
        super().__init__()
        self.data, self.gate, self._pos = data, gate, 0
        self.output = self.add_stream_output("out", data.dtype)

    async def work(self, io, mio, meta):
        if not self.gate.is_set():
            io.block_on(asyncio.sleep(0.005))
            return
        out = self.output.slice()
        k = min(len(out), len(self.data) - self._pos)
        out[:k] = self.data[self._pos:self._pos + k]
        self.output.produce(k)
        self._pos += k
        if self._pos >= len(self.data):
            io.finished = True
        elif k:
            io.call_again = True


def test_ctrl_to_a_fused_member_and_handle_metrics():
    """A ``ctrl`` call to a fused member retunes its stage in the fused
    carry (its stage range); a bad address answers invalid; the handle's
    metrics name the original blocks. The output equals a per-hop run whose
    stage was built with the new taps."""
    taps2 = firdes.lowpass(0.05, 48).astype(np.float32)
    data = c64(21, 3 * FRAME)
    with no_devchain():
        fg, snks = frame_plane_fg([[fir_stage(taps2, name="a")], [mag2_stage()]],
                                  data, FRAME)
        Runtime().run(fg)
        ref = snks[0].items()
    with no_devchain(False):
        gate = threading.Event()
        fg = Flowgraph()
        src = GateSource(data, gate)
        h2d = TpuH2D(np.complex64, frame_size=FRAME, inst=CPU)
        st1 = TpuStage([fir_stage(T1, name="a")], np.complex64, inst=CPU)
        st2 = TpuStage([mag2_stage()], np.complex64, inst=CPU)
        d2h = TpuD2H(np.float32, inst=CPU)
        snk = VectorSink(np.float32)
        fg.connect(src, h2d, st1, st2, d2h, snk)
        assert len(find_device_chains(fg)) == 1
        running = Runtime().start(fg)
        h = running.handle
        assert h.call_sync(st1, "ctrl", Pmt.map({"stage": "a", "taps": taps2.tolist()})) \
            == Pmt.ok()
        assert h.call_sync(st1, "ctrl", Pmt.map({"stage": "zz", "taps": T1.tolist()})) \
            == Pmt.invalid_value()
        assert h.call_sync(st2, "ctrl", Pmt.map({"stage": 1})) == Pmt.invalid_value()
        mets = h.metrics_sync()
        assert {"TpuH2D_1", "TpuStage_2", "TpuStage_3", "TpuD2H_4"} <= set(mets)
        desc = h.describe_sync()
        assert [b.instance_name for b in desc.blocks][1:5] == \
            ["TpuH2D_1", "TpuStage_2", "TpuStage_3", "TpuD2H_4"]
        assert all(mets[n]["fused_devchain"] for n in ("TpuH2D_1", "TpuStage_2"))
        gate.set()
        running.wait_sync()
    assert_bit_equal([snk.items()], [ref])


def test_eos_tail_may_yield_one_composed_multiple_fewer_items():
    """The reference's documented divergence: at EOS the composed frame
    contract applies once. FFT 4 then FFT 3 on a 1001-item tail: per hop
    1000 then 999 items, fused 996 (the composed multiple is 12); the items
    both emit are bit-equal."""
    frame = 4080
    data = c64(23, 2 * frame + 1001)
    refs, got, _ = per_hop_and_fused(
        lambda: frame_plane_fg([[fft_stage(4)], [fft_stage(3)]], data, frame,
                               out_dt=np.complex64))
    assert len(refs[0]) == 2 * frame + 999 and len(got[0]) == 2 * frame + 996
    np.testing.assert_array_equal(got[0], refs[0][:len(got[0])])


def test_linear_fused_frame_plane_matches_jax_flowgraph():
    """The fused ``H2D → fir → fir↓4 → |x|² → D2H`` region on the port
    against the JAX package's flowgraph (fused there too)."""
    import futuresdr_tpu as jfs
    from futuresdr_tpu import blocks as jblocks
    from futuresdr_tpu import tpu as jtpu
    from futuresdr_tpu.ops import stages as J

    data = c64(25, 3 * FRAME)
    jfg = jfs.Flowgraph()
    jsrc, jsnk = jblocks.VectorSource(data), jblocks.VectorSink(np.float32)
    jh2d = jtpu.TpuH2D(np.complex64, frame_size=FRAME)
    jsts = [jtpu.TpuStage(sl, np.complex64) for sl in
            ([J.fir_stage(T1, name="a")], [J.fir_stage(T2, decim=4, name="b")],
             [J.mag2_stage()])]
    jd2h = jtpu.TpuD2H(np.float32)
    jfg.connect_stream(jsrc, "out", jh2d, "in")
    prev = jh2d
    for st in jsts:
        jfg.connect_inplace(prev, "out", st, "in")
        prev = st
    jfg.connect_inplace(prev, "out", jd2h, "in")
    jfg.connect_stream(jd2h, "out", jsnk, "in")
    jfs.Runtime().run(jfg)
    with no_devchain(False):
        fg, snks = frame_plane_fg(stage_lists("1|1|1"), data, FRAME)
        Runtime().run(fg)
    a, b = jsnk.items(), snks[0].items()
    assert a.shape == b.shape == (3 * FRAME // 4,)
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# fan-out regions
# ---------------------------------------------------------------------------

def fanout_stage_lists(split: str):
    p1, p2 = fir_stage(T1, name="p1"), rotator_stage(0.1, name="p2")
    b1, b2 = fir_stage(T2, decim=4, name="b1"), mag2_stage()
    return {"1→1|1": ([[p1]], [[b1]], [[b2]]),
            "2→1|1": ([[p1], [p2]], [[b1]], [[b2]]),
            "1→2|1": ([[p1]], [[p2, b1]], [[b2]])}[split]


def fanout_frame_fg(split, data, frame=FRAME):
    prod_lists, br1_lists, br2_lists = fanout_stage_lists(split)
    fg = Flowgraph()
    src = VectorSource(data)
    h2d = TpuH2D(np.complex64, frame_size=frame, inst=CPU)
    fg.connect_stream(src, "out", h2d, "in")
    prev = h2d
    for sl in prod_lists:
        st = TpuStage(sl, np.complex64, inst=CPU)
        fg.connect_inplace(prev, "out", st, "in")
        prev = st
    sinks = []
    for lists, out_dt in ((br1_lists, np.complex64), (br2_lists, np.float32)):
        b_prev = prev
        for sl in lists:
            st = TpuStage(sl, np.complex64, inst=CPU)
            fg.connect_inplace(b_prev, "out", st, "in")
            b_prev = st
        d2h, snk = TpuD2H(out_dt, inst=CPU), VectorSink(out_dt)
        fg.connect_inplace(b_prev, "out", d2h, "in")
        fg.connect_stream(d2h, "out", snk, "in")
        sinks.append(snk)
    return fg, sinks


@pytest.mark.parametrize("split", ["1→1|1", "2→1|1", "1→2|1"])
@pytest.mark.parametrize("frames_n", [1, 3])
def test_frames_fanout_fused_bit_equals_per_hop(split, frames_n):
    n = frames_n * FRAME
    data = c64(17, n)

    def check(chains):
        assert len(chains) == 1 and chains[0].fanout

    refs, got, _ = per_hop_and_fused(lambda: fanout_frame_fg(split, data), check)
    assert len(refs[0]) == n // 4 and len(refs[1]) == n
    assert_bit_equal(got, refs)


def test_kernels_fanout_1to3_bit_equals_per_hop():
    """A TpuKernel producer broadcasting to three TpuKernel branches fuses:
    one upload and one dispatch a frame."""
    data = c64(18, 4 * FRAME)

    def build():
        fg = Flowgraph()
        src = VectorSource(data)
        prod = TpuKernel([fir_stage(T1, name="p")], np.complex64, frame_size=FRAME,
                         inst=CPU)
        bs = [TpuKernel([fir_stage(T2, decim=4, name="b1")], np.complex64,
                        frame_size=FRAME, inst=CPU),
              TpuKernel([mag2_stage()], np.complex64, frame_size=FRAME, inst=CPU),
              TpuKernel([rotator_stage(0.2)], np.complex64, frame_size=FRAME, inst=CPU)]
        snks = [VectorSink(np.complex64), VectorSink(np.float32), VectorSink(np.complex64)]
        fg.connect(src, prod)
        for b, s in zip(bs, snks):
            fg.connect_stream(prod, "out", b, "in")
            fg.connect(b, s)
        return fg, snks, prod

    def check(chains):
        assert len(chains) == 1 and chains[0].fanout and chains[0].kind == "kernels"
        assert len(chains[0].branches) == 3

    refs, got, built = per_hop_and_fused(build, check)
    assert_bit_equal(got, refs)
    m = built[2].extra_metrics()
    assert m["fused_devchain"] and m["devchain_dispatches"] == m["devchain_frames"] == 4


@pytest.mark.parametrize("k", [1, 4])
def test_fanout_megabatch_bit_equals_per_hop(k):
    data = c64(19, 5 * FRAME)
    with no_devchain():
        fg, sinks = fanout_frame_fg("1→1|1", data)
        Runtime().run(fg)
        refs = [s.items() for s in sinks]
    with frames_per_dispatch(k), no_devchain(False):
        fg, sinks = fanout_frame_fg("1→1|1", data)
        Runtime().run(fg)
        got = [s.items() for s in sinks]
    assert_bit_equal(got, refs)


def test_fanout_tags_rebase_through_decimating_branch():
    n = 3 * FRAME
    with no_devchain(False):
        fg = Flowgraph()
        src = TaggedRampSource(n)
        h2d = TpuH2D(np.complex64, frame_size=FRAME, inst=CPU)
        b1 = TpuStage([fir_stage(T2, decim=4)], np.complex64, inst=CPU)
        b2 = TpuStage([mag2_stage()], np.complex64, inst=CPU)
        d1, d2 = TpuD2H(np.complex64, inst=CPU), TpuD2H(np.float32, inst=CPU)
        s1, s2 = TagRecordingSink(np.complex64), TagRecordingSink(np.float32)
        fg.connect_stream(src, "out", h2d, "in")
        fg.connect_inplace(h2d, "out", b1, "in")
        fg.connect_inplace(h2d, "out", b2, "in")
        fg.connect_inplace(b1, "out", d1, "in")
        fg.connect_inplace(b2, "out", d2, "in")
        fg.connect_stream(d1, "out", s1, "in")
        fg.connect_stream(d2, "out", s2, "in")
        chains = find_device_chains(fg)
        assert len(chains) == 1 and chains[0].fanout
        Runtime().run(fg)
    assert s1.n_received == n // 4 and s2.n_received == n
    assert {t.value: i for i, t in s1.seen} == {a: a // 4 for a in TAG_AT}
    assert {t.value: i for i, t in s2.seen} == {a: a for a in TAG_AT}


def test_fused_fanout_retires_a_branch_whose_reader_detaches():
    """A branch's reader that finishes early (a ``Head``) retires that branch
    of the fused kernel; the other branch streams to the end."""
    from futuresdr_tpu_torch.blocks import Head
    n = 6 * FRAME
    with no_devchain(False):
        fg = Flowgraph()
        h2d = TpuH2D(np.complex64, frame_size=FRAME, inst=CPU)
        b1 = TpuStage([fir_stage(T2, decim=4)], np.complex64, inst=CPU)
        b2 = TpuStage([mag2_stage()], np.complex64, inst=CPU)
        d1, d2 = TpuD2H(np.complex64, inst=CPU), TpuD2H(np.float32, inst=CPU)
        head, s1, s2 = Head(np.complex64, 1000), VectorSink(np.complex64), \
            VectorSink(np.float32)
        fg.connect(VectorSource(c64(27, n)), h2d)
        fg.connect_inplace(h2d, "out", b1, "in")
        fg.connect_inplace(h2d, "out", b2, "in")
        fg.connect(b1, d1, head, s1)
        fg.connect(b2, d2, s2)
        assert len(find_device_chains(fg)) == 1
        Runtime().run(fg)
    assert len(s1.items()) == 1000 and len(s2.items()) == n
    assert fg.wrapped(h2d).metrics()["devchain_frames"] == 6


def test_fanout_member_metrics_bridge():
    with no_devchain(False):
        fg, _ = fanout_frame_fg("1→1|1", np.zeros(3 * FRAME, np.complex64))
        Runtime().start(fg).wait_sync()
    mets = {b.instance_name: b.metrics() for b in fg._blocks if b is not None}
    fused = {nm: m for nm, m in mets.items() if m.get("fused_devchain")}
    assert len(fused) == 6            # h2d, producer, 2 branches, 2 d2h
    assert {m.get("devchain_branch") for m in fused.values()} == {None, 0, 1}
    dec = next(m for nm, m in fused.items()
               if m.get("devchain_branch") == 0 and nm.startswith("TpuStage"))
    assert dec["items_in"] == {"in": 3 * FRAME}
    assert dec["items_out"] == {"out": 3 * FRAME // 4}


def test_fanout_refuses_cross_instance_branch():
    fg = Flowgraph()
    src = VectorSource(np.zeros(2 * FRAME, np.complex64))
    h2d = TpuH2D(np.complex64, frame_size=FRAME, inst=CPU)
    b1 = TpuStage([fir_stage(T2, name="b1")], np.complex64, inst=CPU)
    b2 = TpuStage([mag2_stage()], np.complex64, inst=TpuInstance("cpu"))
    d1, d2 = TpuD2H(np.complex64, inst=CPU), TpuD2H(np.float32, inst=CPU)
    fg.connect_stream(src, "out", h2d, "in")
    fg.connect_inplace(h2d, "out", b1, "in")
    fg.connect_inplace(h2d, "out", b2, "in")
    fg.connect_inplace(b1, "out", d1, "in")
    fg.connect_inplace(b2, "out", d2, "in")
    fg.connect_stream(d1, "out", VectorSink(np.complex64), "in")
    fg.connect_stream(d2, "out", VectorSink(np.float32), "in")
    with no_devchain(False):
        assert find_device_chains(fg) == []


def test_no_devchain_env_declines_fanout():
    with no_devchain():
        fg, sinks = fanout_frame_fg("1→1|1", np.zeros(2 * FRAME, np.complex64))
        assert find_device_chains(fg) == []
        Runtime().run(fg)
    assert len(sinks[0].items()) == 2 * FRAME // 4 and len(sinks[1].items()) == 2 * FRAME


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_refuses_wired_retune_handler_without_static_optin():
    def build(static):
        fg = Flowgraph()
        src = VectorSource(np.zeros(2 * FRAME, np.complex64))
        h2d = TpuH2D(np.complex64, frame_size=FRAME, inst=CPU)
        st = TpuStage([fir_stage(T2, name="f")], np.complex64, inst=CPU)
        if static:
            st.devchain_static = True
        d2h, snk = TpuD2H(np.complex64, inst=CPU), VectorSink(np.complex64)
        msg = MessageSource(Pmt.map({"stage": "f", "taps": T2.tolist()}), interval=1.0)
        fg.connect(src, h2d, st, d2h, snk)
        fg.connect_message(msg, "out", st, "ctrl")
        return fg

    with no_devchain(False):
        assert find_device_chains(build(static=False)) == []
        assert len(find_device_chains(build(static=True))) == 1


def test_refuses_mismatched_instances():
    fg = Flowgraph()
    h2d = TpuH2D(np.complex64, frame_size=FRAME, inst=CPU)
    st = TpuStage([fir_stage(T2)], np.complex64, inst=TpuInstance("cpu"))
    d2h = TpuD2H(np.complex64, inst=CPU)
    fg.connect(VectorSource(np.zeros(2 * FRAME, np.complex64)), h2d, st, d2h,
               VectorSink(np.complex64))
    with no_devchain(False):
        assert find_device_chains(fg) == []


def test_refuses_branching_port():
    """A broadcast with a host tap ends the region at its owner: k1's port
    group serves k2 and the tap, k1 alone is no region, and k2 alone
    neither, so nothing fuses."""
    fg = Flowgraph()
    k1 = TpuKernel([fir_stage(T2)], np.complex64, frame_size=FRAME, inst=CPU)
    k2 = TpuKernel([mag2_stage()], np.complex64, frame_size=FRAME, inst=CPU)
    fg.connect(VectorSource(np.zeros(2 * FRAME, np.complex64)), k1, k2,
               VectorSink(np.float32))
    fg.connect_stream(k1, "out", VectorSink(np.complex64), "in")
    with no_devchain(False):
        assert find_device_chains(fg) == []


def test_refuses_frame_not_multiple_of_composed_contract():
    fg = Flowgraph()
    h2d = TpuH2D(np.complex64, frame_size=1024, inst=CPU)
    st = TpuStage([fft_stage(2048)], np.complex64, inst=CPU)
    d2h = TpuD2H(np.complex64, inst=CPU)
    fg.connect(VectorSource(np.zeros(8192, np.complex64)), h2d, st, d2h,
               VectorSink(np.complex64))
    with no_devchain(False):
        assert find_device_chains(fg) == []


def test_refuses_d2h_dtype_other_than_the_composed_output():
    fg = Flowgraph()
    h2d = TpuH2D(np.complex64, frame_size=FRAME, inst=CPU)
    st = TpuStage([mag2_stage()], np.complex64, inst=CPU)
    d2h = TpuD2H(np.complex64, inst=CPU)
    fg.connect(VectorSource(np.zeros(FRAME, np.complex64)), h2d, st, d2h,
               VectorSink(np.complex64))
    with no_devchain(False):
        assert find_device_chains(fg) == []


def test_refuses_per_kernel_opt_out():
    fg = Flowgraph()
    k1 = TpuKernel([fir_stage(T2)], np.complex64, frame_size=FRAME, inst=CPU)
    k2 = TpuKernel([mag2_stage()], np.complex64, frame_size=FRAME, inst=CPU)
    k2.devchain = False
    fg.connect(VectorSource(np.zeros(FRAME, np.complex64)), k1, k2, VectorSink(np.float32))
    with no_devchain(False):
        assert find_device_chains(fg) == []


def test_no_devchain_env_declines_everything():
    with no_devchain():
        fg, snks = frame_plane_fg(stage_lists("1|1|1"), np.zeros(2 * FRAME, np.complex64),
                                  FRAME)
        assert find_device_chains(fg) == []
        Runtime().run(fg)
    assert len(snks[0].items()) == 2 * FRAME // 4
