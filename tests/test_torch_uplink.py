"""The port's uplink plane on the CPU: the streamed ``TpuKernel`` per wire
against the JAX package's, coalescing, the codec pool, zero-copy ingest,
deferred consume, wire switches and transfer faults.

The streamed kernel (the spectrum chain, eleven frames and a partial one)
with each wire at K = 1 and 4 emits what the reference ``TpuKernel`` with the
same wire and K emits, at ``tests/test_torch_hostpath.py``'s megabatch
tolerance (rtol 1e-3, atol 1e-2) plus two LSB of the wire; a fan-out kernel
likewise. Then the port-side contracts of the reference's
``tests/test_arena.py`` (``encode_into``, the group allocator, the codec
pool) and ``tests/test_uplink.py``: packed groups bit-identical to per-part
ones with one H2D start a group; the ingest registry and its zero-copy
frames; deferred consume against an inline encode, behind a writer that
fills the double-mapped buffer as fast as it can; the wire controller; a
wire switch at a quiescent boundary, bit for bit the chained wired programs,
and a switch back that builds no program; the adaptive wire widening on a
burst; transfer faults retried to the unfaulted output, an exhausted budget
failing the flowgraph; and the device-chain pass refusing a region whose
ends' wires differ.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import futuresdr_tpu as jfs
from futuresdr_tpu import blocks as jblocks
from futuresdr_tpu.ops import stages as J
from futuresdr_tpu.tpu import TpuKernel as JaxTpuKernel
from futuresdr_tpu.tpu.kernel_block import TpuFanoutKernel as JaxFanoutKernel
from futuresdr_tpu.tpu.kernel_block import WireController as JaxWireController
from futuresdr_tpu_torch import Flowgraph, Mocker, Runtime
from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
from futuresdr_tpu_torch.config import config
from futuresdr_tpu_torch.dsp import firdes
from futuresdr_tpu_torch.ops import codec_pool, ingest, xfer
from futuresdr_tpu_torch.ops import stages as T
from futuresdr_tpu_torch.ops.arena import GroupAlloc, PackedAlloc, StagingArena
from futuresdr_tpu_torch.ops.wire import get_wire
from futuresdr_tpu_torch.runtime import faults
from futuresdr_tpu_torch.runtime.devchain import find_device_chains
from futuresdr_tpu_torch.runtime.runtime import FlowgraphError
from futuresdr_tpu_torch.tpu import TpuD2H, TpuH2D, TpuInstance, TpuKernel, TpuStage
from futuresdr_tpu_torch.tpu.kernel_block import TpuFanoutKernel, WireController

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

CPU = TpuInstance("cpu")
WIRES = ["f32", "bf16", "sc16", "sc8"]
TAPS = firdes.lowpass(0.2, 64).astype(np.float32)
FRAME = 1024
FS = 2048


@pytest.fixture(autouse=True)
def _uplink_defaults(monkeypatch):
    """Every case starts from the shipped defaults and leaves no ingest
    registration, armed fault or fake link behind."""
    c = config()
    for f in ("tpu_coalesce", "tpu_zero_copy_ingest", "tpu_deferred_consume",
              "tpu_adaptive_wire", "xfer_backoff"):
        monkeypatch.setattr(c, f, getattr(c, f))
    ingest.reset()
    yield
    ingest.reset()
    faults.reset()
    xfer.set_fake_link()


def _spectrum(m):
    return [m.fir_stage(TAPS, fft_len=512), m.fft_stage(256), m.mag2_stage()]


def _stream(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


def _tol(name, want):
    """The megabatch test's tolerance plus two LSB of the wire: a quantized
    wire's LSB is its frame's peak over qmax (the output's peak bounds it),
    bfloat16's 2^-7 of the value."""
    peak = float(np.abs(want).max())
    lsb = {"sc16": peak / 32767, "sc8": peak / 127}.get(name, 0.0)
    return dict(rtol=1e-3 + (2.0 ** -6 if name == "bf16" else 0.0), atol=1e-2 + 2 * lsb)


def _run_port(kern, data, out_dtype=np.float32):
    fg = Flowgraph()
    snk = VectorSink(out_dtype)
    fg.connect(VectorSource(data), kern, snk)
    Runtime().run(fg)
    return snk.items()


def _run_jax(kern, data):
    fg = jfs.Flowgraph()
    snk = jblocks.VectorSink(np.float32)
    fg.connect(jblocks.VectorSource(data), kern, snk)
    jfs.Runtime().run(fg)
    return snk.items()


# ---------------------------------------------------------------------------
# the streamed kernel per wire against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("name", WIRES)
def test_streamed_kernel_per_wire_matches_jax(name, k):
    data = _stream(5, 11 * FRAME + 3 * 256 + 100)
    port = TpuKernel(_spectrum(T), np.complex64, frame_size=FRAME, inst=CPU,
                     frames_in_flight=2, frames_per_dispatch=k, wire=name)
    ref = JaxTpuKernel(_spectrum(J), np.complex64, frame_size=FRAME, frames_in_flight=2,
                       frames_per_dispatch=k, wire=name)
    got, want = _run_port(port, data), _run_jax(ref, data)
    assert port.wire.name == name and port.extra_metrics()["wire"] == name
    assert len(got) == len(want) == 11 * FRAME + 3 * 256
    np.testing.assert_allclose(got, want, **_tol(name, want))


def test_fanout_kernel_with_a_wire_matches_jax():
    data = _stream(6, 6 * FRAME)
    prod = [T.fir_stage(TAPS, fft_len=512)]
    port = TpuFanoutKernel(T.FanoutPipeline(prod, [[T.mag2_stage()],
                                                   [T.rotator_stage(0.1), T.mag2_stage()]],
                                            np.complex64),
                           frame_size=FRAME, inst=CPU, frames_in_flight=2, wire="sc16")
    ref = JaxFanoutKernel(J.FanoutPipeline([J.fir_stage(TAPS, fft_len=512)],
                                           [[J.mag2_stage()],
                                            [J.rotator_stage(0.1), J.mag2_stage()]],
                                           np.complex64),
                          frame_size=FRAME, frames_in_flight=2, wire="sc16")
    assert port._part_counts == (2, 2)
    outs = []
    for kern, (fg_cls, rt_cls, src_cls, snk_cls) in (
            (port, (Flowgraph, Runtime, VectorSource, VectorSink)),
            (ref, (jfs.Flowgraph, jfs.Runtime, jblocks.VectorSource, jblocks.VectorSink))):
        fg = fg_cls()
        src, s0, s1 = src_cls(data), snk_cls(np.float32), snk_cls(np.float32)
        fg.connect_stream(src, "out", kern, "in")
        fg.connect_stream(kern, "out0", s0, "in")
        fg.connect_stream(kern, "out1", s1, "in")
        rt_cls().run(fg)
        outs.append((s0.items(), s1.items()))
    for got, want in zip(outs[0], outs[1]):
        assert len(got) == len(want) == len(data)
        np.testing.assert_allclose(got, want, **_tol("sc16", want))


# ---------------------------------------------------------------------------
# the arena's group allocators and the codec pool (tests/test_arena.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["bf16", "sc16", "sc8"])
def test_encode_into_bit_identical_to_encode_host(name):
    ar = StagingArena(pin=False)
    w = get_wire(name)
    for x in (_stream(1, 4096), np.random.default_rng(2).standard_normal(999).astype(np.float32)):
        alloc = GroupAlloc(ar)
        got, want = w.encode_into(x, alloc), w.encode_host(x)
        for g, r in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
        assert not alloc._temps                   # the scratch went back
        alloc.release()
    assert ar.stats()["pinned_bytes"] == 0


def test_group_alloc_temps_only_and_packed_alloc_writes_through_slots():
    ar = StagingArena(pin=False)
    g = GroupAlloc(ar)
    sub = g.temps_only()
    sub((64,), np.float32)
    sub.temp((8,), np.int16)
    assert not g.handles and len(g._temps) == 2
    g.drop_temps()
    assert ar.stats()["pinned_bytes"] == 0
    w = get_wire("sc16")
    lay = xfer.PackedLayout.probe(w, 2048, np.complex64)
    alloc = PackedAlloc(ar, lay)
    x = _stream(3, 2048)
    parts = w.encode_into(x, alloc)
    sh, dt, off, nb = lay.slots[0]
    assert np.shares_memory(parts[0], alloc.packed)    # the payload was written in place
    buf = alloc.finish(parts)
    want = lay.pack(w.encode_host(x), np.empty(lay.nbytes, np.uint8))
    np.testing.assert_array_equal(buf, want)
    alloc.release()


def test_codec_pool_order_threads_and_config_off(monkeypatch):
    codec_pool.reset_pool()
    torch.set_num_threads(1)
    p = codec_pool.pool()
    try:
        futs = [p.submit_encode(lambda i=i: (i, torch.get_num_threads())) for i in range(16)]
        assert [f.result() for f in futs] == [(i, 1) for i in range(16)]
        assert p.submit_decode(threading.current_thread).result().name.startswith(
            "fsdr-codec-dec")
    finally:
        codec_pool.reset_pool()
    monkeypatch.setattr(config(), "host_codec_workers", 0)
    assert codec_pool.pool() is None
    k = TpuKernel(_spectrum(T), np.complex64, frame_size=FRAME, inst=CPU, wire="sc16")
    assert not k._deferred_consume and not k._encode_offload
    codec_pool.reset_pool()


# ---------------------------------------------------------------------------
# coalescing (tests/test_uplink.py)
# ---------------------------------------------------------------------------

def _kernel(wire="sc16", k=1, **kw):
    return TpuKernel([T.fir_stage(firdes.lowpass(0.2, 31).astype(np.float32), fft_len=256,
                                  name="f"), T.rotator_stage(0.05, name="rot")],
                     np.complex64, frame_size=FS, inst=CPU, frames_in_flight=2, wire=wire,
                     frames_per_dispatch=k, **kw)


def _drive(mk, data, out_scale=2):
    m = Mocker(mk)
    m.input("in", data)
    m.init_output("out", len(data) * out_scale)
    m.init()
    m.run()
    return m.output("out").copy()


def _run_chain(wire, k, coalesce, n_frames=8, seed=7):
    config().tpu_coalesce = coalesce
    data = _stream(seed, FS * n_frames)
    mk = _kernel(wire=wire, k=k)
    m = Mocker(mk)
    m.input("in", data)
    m.init_output("out", len(data) * 2)
    m.init()
    xfer.reset_bytes()
    m.run()
    return m.output("out").copy(), xfer.starts_total["h2d"], mk.extra_metrics()


@pytest.mark.parametrize("wire", ["sc16", "sc8"])
@pytest.mark.parametrize("k", [1, 4])
def test_packed_bit_identical_and_single_start(wire, k):
    a, sa, ema = _run_chain(wire, k, coalesce=True)
    b, sb, emb = _run_chain(wire, k, coalesce=False)
    np.testing.assert_array_equal(a, b)
    assert ema["uplink_coalesced"] == 1 and emb["uplink_coalesced"] == 0
    assert ema["h2d_starts_per_frame"] == 1 and emb["h2d_starts_per_frame"] == 2
    groups = 8 // k
    assert sa == groups, (sa, groups)            # one start a packed group
    assert sb == 2 * groups, (sb, groups)        # payload and scale apart


def test_packed_single_part_wires_stay_per_part():
    _, starts, em = _run_chain("f32", 1, coalesce=True)
    assert em["uplink_coalesced"] == 0 and em["h2d_starts_per_frame"] == 1
    assert starts == 8


# ---------------------------------------------------------------------------
# zero-copy ingest
# ---------------------------------------------------------------------------

def test_ingest_registry_lookup_and_writable_fallback():
    a = np.arange(4096, dtype=np.complex64)
    h = ingest.register(a, name="t")
    assert not a.flags.writeable                 # the tripwire is armed
    assert ingest.lookup(a[10:100]) is h         # views resolve to the root
    assert ingest.register(a) is h               # once a root
    w = np.arange(64, dtype=np.complex64)
    assert ingest.lookup(w) is None              # writable: the copy path
    assert not h.page_locked                     # no card here
    ingest.unregister(h)
    assert ingest.lookup(a) is None


def test_ingest_refcount_idle_callback():
    idled = []
    a = np.zeros(1024, np.float32)
    h = ingest.register(a, on_idle=idled.append)
    assert not h.pinned
    h.retain()
    assert h.pinned and not idled
    h.release()
    assert not h.pinned and idled == [h]


def test_ingest_zero_copy_frames_on_aliasing_wire():
    """A registered read-only buffer skips the ring-exit copy on the f32
    wire; the output equals the copying run's bit for bit and the buffer is
    free once everything drained."""
    data = _stream(9, 6 * FS)
    want = _drive(_kernel(wire="f32"), data)
    h = ingest.register(data, name="capture")
    mk = _kernel(wire="f32")
    got = _drive(mk, data)
    assert mk.extra_metrics()["ingest_zero_copy_frac"] == 1.0
    assert ingest.stats()["zero_copy_frames"] == 6
    assert not h.pinned
    np.testing.assert_array_equal(got, want)


def test_ingest_disabled_on_quant_wire_and_from_dlpack():
    data = _stream(4, 4 * FS)
    ingest.register(data)
    mk = _kernel(wire="sc16")
    assert not mk._ingest_enabled
    _drive(mk, data)
    assert mk.extra_metrics()["ingest_zero_copy_frac"] == 0.0
    x = torch.arange(256, dtype=torch.float32)
    arr = ingest.from_dlpack(x)
    assert ingest.lookup(arr) is not None
    np.testing.assert_array_equal(x.numpy(), arr)


# ---------------------------------------------------------------------------
# deferred consume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sc16", "sc8"])
def test_deferred_consume_behind_a_fast_writer_matches_inline(name, monkeypatch):
    """A quantizing K = 1 kernel with the pool encodes each frame on a worker
    straight out of its ring slot. The source fills the (double-mapped)
    buffer as fast as it can, into a ring of a few frames: a consume()
    before the worker's read would let it overwrite a frame in flight."""
    monkeypatch.setattr(config(), "buffer_size", 8 * 4096 * 8)
    data = _stream(11, 24 * 4096)
    outs = {}
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)             # hand the interpreter lock round often
    try:
        for deferred in (True, False):
            config().tpu_deferred_consume = deferred
            kern = TpuKernel(_spectrum(T), np.complex64, frame_size=4096, inst=CPU,
                             frames_in_flight=3, wire=name)
            assert kern.extra_metrics()["deferred_consume"] == int(deferred)
            outs[deferred] = _run_port(kern, data)
            assert kern._pending_consume is None
    finally:
        sys.setswitchinterval(switch)
    np.testing.assert_array_equal(outs[True], outs[False])


# ---------------------------------------------------------------------------
# the wire controller and wire switches
# ---------------------------------------------------------------------------

def _feed(ctl, frames, wire_s=0.0, n=16):
    for _ in range(n):
        for f in frames:
            ctl.observe_frame(f)
        ctl.note_dispatch((0.0, wire_s) if wire_s else None)


@pytest.mark.parametrize("cls", [JaxWireController, WireController], ids=["jax", "port"])
def test_wire_controller_widens_on_low_snr_and_narrows_only_when_busy(cls):
    ctl = cls(budget_db=40.0, window=4)
    quiet = np.full(512, 1e-4, np.complex64)
    quiet[0] = 1.0 + 0j                          # crest: peak >> rms
    assert ctl.predicted_snr_db("f32") == float("inf")
    _feed(ctl, [quiet], n=4)
    assert ctl.propose("sc8") is None            # the first agreeing window
    _feed(ctl, [quiet], n=4)
    assert ctl.propose("sc8") == "sc16"          # the second: widen one step
    _feed(ctl, [quiet], n=4)
    assert ctl.propose("sc16") is None           # the holdoff
    sig = (np.ones(512) * 0.5).astype(np.complex64)
    idle = cls(budget_db=40.0, window=4)
    _feed(idle, [sig], n=8)
    assert idle.propose("f32") is None           # an idle link stays exact
    busy = cls(budget_db=40.0, window=4)
    _feed(busy, [sig], wire_s=10.0, n=4)
    assert busy.propose("f32") is None
    _feed(busy, [sig], wire_s=10.0, n=4)
    assert busy.propose("f32") == "sc16"


def _chained(pipe, data, schedule):
    """The wired programs by hand: frame i through ``schedule[i]``'s wire,
    the carry chained, the output decoded on the host."""
    fns, carry, out = {}, pipe.init_carry("cpu"), []
    for i, name in enumerate(schedule):
        w = get_wire(name)
        if name not in fns:
            fns[name] = pipe.compile(FS, "cpu", wire=w)[0]
        x = data[i * FS:(i + 1) * FS]
        carry, y = fns[name](carry, tuple(torch.from_numpy(np.array(p))
                                          for p in w.encode_host(x)))
        out.append(w.decode_host(tuple(t.numpy() for t in y), pipe.out_dtype))
    return np.concatenate(out)


def test_apply_wire_retune_switches_at_a_quiescent_boundary_and_back():
    """sc16 for four frames, then sc8, then sc16 again: each segment is the
    chained wired programs' output bit for bit (the carry carries over), and
    going back takes the program built before."""
    data = _stream(13, 12 * FS)
    mk = _kernel(wire="sc16")
    m = Mocker(mk)
    m.init_output("out", len(data) * 2)
    m.init()
    first = mk._fn
    for seg, (start, nxt) in enumerate(((0, "sc8"), (4, "sc16"), (8, None))):
        m.input("in", data[start * FS:(start + 4) * FS])
        m.run()
        if nxt is not None:
            mk.apply_wire_retune(nxt)
            assert mk.wire.name != nxt           # not before the next boundary
    assert mk.wire_history == [(0, "sc16"), (4, "sc8"), (8, "sc16")]
    assert mk.extra_metrics()["wire_switches"] == 2
    assert mk._fn is first and len(mk._programs) == 2
    want = _chained(mk.pipeline, data, ["sc16"] * 4 + ["sc8"] * 4 + ["sc16"] * 4)
    np.testing.assert_array_equal(m.output("out"), want)
    with pytest.raises(ValueError, match="unknown wire format"):
        mk.apply_wire_retune("nope")


def test_adaptive_wire_widens_on_a_burst(monkeypatch):
    """``tpu_adaptive_wire``: a tone (its sc8 SNR clears the 40 dB budget)
    steps to a quiet floor carrying short full-scale bursts; the predicted
    sc8 SNR falls below the budget and the kernel widens to sc16."""
    config().tpu_adaptive_wire = True
    n = 256
    t = np.arange(64 * n)
    tone = np.exp(2j * np.pi * 0.05 * t).astype(np.complex64)
    burst = np.full(96 * n, 1e-3, np.complex64)
    burst[::n] = 1.0
    data = np.concatenate([tone, burst])
    kern = TpuKernel([T.mag2_stage()], np.complex64, frame_size=n, inst=CPU,
                     frames_in_flight=2, wire="sc8")
    assert kern.extra_metrics()["adaptive_wire"] == 1
    got = _run_port(kern, data)
    assert len(got) == len(data)
    assert [w for _, w in kern.wire_history] == ["sc8", "sc16"]
    assert kern.wire_history[1][0] >= 64             # after the step
    np.testing.assert_allclose(got, np.abs(data) ** 2, rtol=0, atol=2e-2)


# ---------------------------------------------------------------------------
# transfer faults
# ---------------------------------------------------------------------------

def test_h2d_faults_retry_to_the_unfaulted_output():
    config().xfer_backoff = 0.0001
    data = _stream(5, 8 * FS)
    want = _drive(_kernel(wire="sc16"), data)
    faults.arm("h2d", rate=0.2, seed=3)
    xfer.reset_bytes()
    got = _drive(_kernel(wire="sc16"), data)
    assert xfer.retries_total["h2d"] > 0
    np.testing.assert_array_equal(got, want)
    faults.reset()
    data = _stream(6, 32 * FS)
    want4 = _drive(_kernel(wire="sc16", k=4), data)
    xfer.set_fake_link(fault_rate=0.2, fault_seed=3)
    xfer.reset_bytes()
    got = _drive(_kernel(wire="sc16", k=4), data)
    xfer.set_fake_link()
    assert xfer.retries_total["h2d"] + xfer.retries_total["d2h"] > 0
    np.testing.assert_array_equal(got, want4)


def test_exhausted_retry_budget_fails_the_flowgraph():
    config().xfer_backoff = 0.0001
    faults.arm("h2d", rate=1.0, seed=0)
    with pytest.raises(FlowgraphError) as ei:
        _run_port(_kernel(wire="sc16"), _stream(2, 4 * FS), np.complex64)
    chain, e = [], ei.value
    while e is not None:
        chain.append(type(e).__name__)
        e = e.__cause__
    assert "TransferError" in chain, chain


def test_dispatch_fault_fails_fast():
    faults.arm("dispatch", rate=1.0, seed=0, max_faults=1)
    with pytest.raises(FlowgraphError):
        _run_port(_kernel(wire="f32"), _stream(2, 4 * FS), np.complex64)


# ---------------------------------------------------------------------------
# the device-chain pass and the wire
# ---------------------------------------------------------------------------

def _frames_fg(h2d_wire, d2h_wire, data):
    fg = Flowgraph()
    snk = VectorSink(np.float32)
    h2d = TpuH2D(np.complex64, frame_size=FS, inst=CPU, wire=h2d_wire)
    st = TpuStage([T.fir_stage(TAPS, fft_len=512), T.mag2_stage()], np.complex64, inst=CPU)
    d2h = TpuD2H(np.float32, inst=CPU, wire=d2h_wire)
    fg.connect(VectorSource(data), h2d, st, d2h, snk)
    return fg, snk


def test_devchain_refuses_mismatched_wires_and_fuses_matching_ones(monkeypatch):
    monkeypatch.delenv("FSDR_NO_DEVCHAIN", raising=False)
    data = _stream(8, 4 * FS)
    fg, _ = _frames_fg("sc16", "f32", data)
    assert find_device_chains(fg) == []
    fg = Flowgraph()
    k1 = TpuKernel([T.fir_stage(TAPS)], np.complex64, frame_size=FS, inst=CPU, wire="sc16")
    k2 = TpuKernel([T.mag2_stage()], np.complex64, frame_size=FS, inst=CPU, wire="sc8")
    fg.connect(VectorSource(data), k1, k2, VectorSink(np.float32))
    assert find_device_chains(fg) == []
    fg, snk = _frames_fg("sc16", "sc16", data)
    assert len(find_device_chains(fg)) == 1
    Runtime().run(fg)
    fused = snk.items()
    monkeypatch.setenv("FSDR_NO_DEVCHAIN", "1")
    fg, snk = _frames_fg("sc16", "sc16", data)
    Runtime().run(fg)
    np.testing.assert_array_equal(fused, snk.items())
