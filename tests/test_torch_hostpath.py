"""The port's host side of the main path against the JAX package's, on the CPU.

``CreditController`` runs the reference's credit cases side by side on both
copies; the port's ``StagingArena`` runs the reference's size-class,
recycle, refcount and cap cases (unpinned here: no card) and its event gate;
``Pipeline.compile`` on the CPU (the eager chain looped over K frames), by
call and through its slots, equals ``Pipeline.fn`` over chained frames;
``TpuKernel(frames_per_dispatch=K)`` streams the same seeded input as the
reference ``TpuKernel`` with the same K: the same item count, an EOS partial
group included, and the same values, also across a retune that both kernels
take at the same dispatch-group boundary.
"""

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

import futuresdr_tpu as jfs
from futuresdr_tpu import blocks as jblocks
from futuresdr_tpu.ops import stages as J
from futuresdr_tpu.runtime.kernel import Kernel as JaxKernelBase
from futuresdr_tpu.tpu import TpuKernel as JaxTpuKernel
from futuresdr_tpu.tpu.kernel_block import CreditController as JaxCreditController
from futuresdr_tpu_torch import Flowgraph, Kernel, Runtime
from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
from futuresdr_tpu_torch.dsp import firdes
from futuresdr_tpu_torch.ops import stages as T
from futuresdr_tpu_torch.ops import xfer
from futuresdr_tpu_torch.ops.arena import StagingArena
from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
from futuresdr_tpu_torch.tpu.kernel_block import CreditController

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

TAPS = firdes.lowpass(0.2, 64).astype(np.float32)
TAPS2 = firdes.lowpass(0.05, 64).astype(np.float32)
FRAME = 1024
CPU = TpuInstance("cpu")
CONTROLLERS = [pytest.param(JaxCreditController, id="jax"),
               pytest.param(CreditController, id="port")]


def _chain(m):
    return [m.fir_stage(TAPS, fft_len=512), m.fft_stage(256), m.mag2_stage()]


def _stream(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


# ---------------------------------------------------------------------------
# the credit controller, both copies (tests/test_arena.py's credit cases)
# ---------------------------------------------------------------------------

def _window(cc, count=8, idle=0.0, limited=False, max_seen=4, span=1.0):
    """Drive one observation window by hand: ``count`` dispatches over
    ``span`` seconds with ``idle`` seconds of link idle."""
    cc._count = count
    cc._idle_s = idle
    cc._limited = limited
    cc._max_seen = max_seen
    cc._t0 = time.perf_counter() - span
    cc._tick()


@pytest.mark.parametrize("cls", CONTROLLERS)
def test_credit_controller_grow_needs_two_windows_and_keeps_on_improvement(cls):
    cc = cls(4, adaptive=True)
    _window(cc, count=8, idle=0.5, limited=True)
    assert cc.credits == 4               # one window is not a signal
    _window(cc, count=8, idle=0.5, limited=True)
    assert cc.credits == 5 and cc._probe == (4, pytest.approx(8.0, rel=0.2))
    _window(cc, count=12, idle=0.5, limited=True)   # rate improved: keep
    assert cc.credits == 5 and cc._probe is None


@pytest.mark.parametrize("cls", CONTROLLERS)
def test_credit_controller_rolls_back_unproductive_grow(cls):
    cc = cls(4, adaptive=True)
    _window(cc, count=8, idle=0.5, limited=True)
    _window(cc, count=8, idle=0.5, limited=True)
    assert cc.credits == 5
    _window(cc, count=8, idle=0.5, limited=True)    # no improvement
    assert cc.credits == 4 and cc._hold == 3
    for _ in range(4):                              # hold: no growth
        _window(cc, count=8, idle=0.5, limited=True)
        assert cc.credits == 4


@pytest.mark.parametrize("cls", CONTROLLERS)
def test_credit_controller_shrinks_on_slack(cls):
    cc = cls(6, adaptive=True)
    _window(cc, max_seen=2)
    assert cc.credits == 6               # hysteresis: one slack window
    _window(cc, max_seen=2)
    assert cc.credits == 5
    for _ in range(10):
        _window(cc, max_seen=1)
    assert cc.credits == cc.lo           # bounded below


@pytest.mark.parametrize("cls", CONTROLLERS)
def test_credit_controller_pinned_when_not_adaptive(cls):
    cc = cls(4, adaptive=False)
    cc.note_limited()
    for _ in range(64):
        cc.note_dispatch((0.0, 1.0), 4)
    assert cc.credits == 4 and cc.hi == 4
    cc1 = cls(1, adaptive=True)          # depth 1 stays strictly serial
    assert not cc1.adaptive and cc1.credits == 1


@pytest.mark.parametrize("cls", CONTROLLERS)
def test_credit_controller_idle_detection(cls):
    cc = cls(4, adaptive=True, window=64)
    cc.note_dispatch((10.0, 10.5), 1)
    cc.note_dispatch((11.5, 12.0), 2)    # service 1.0 s after the last deadline
    assert cc._idle_s == pytest.approx(1.0)
    cc.note_dispatch((11.9, 12.4), 2)    # overlapping window: no new idle
    assert cc._idle_s == pytest.approx(1.0)


def test_kernel_credits_pinned_by_depth_or_config(monkeypatch):
    """No explicit depth: adaptive credits seeded from the instance's
    in-flight default; an explicit depth or config ``tpu_inflight`` > 0 pins
    the budget, as in the reference."""
    from futuresdr_tpu_torch.config import config
    seeded = TpuKernel(_chain(T), np.complex64, frame_size=FRAME, inst=CPU)
    assert seeded._credits.adaptive and seeded._credits.credits == CPU.frames_in_flight
    explicit = TpuKernel(_chain(T), np.complex64, frame_size=FRAME, inst=CPU,
                         frames_in_flight=3)
    assert not explicit._credits.adaptive and explicit._credits.credits == 3
    monkeypatch.setattr(config(), "tpu_inflight", 5)
    pinned = TpuKernel(_chain(T), np.complex64, frame_size=FRAME, inst=CPU)
    assert not pinned._credits.adaptive and pinned._credits.credits == 5
    monkeypatch.setattr(config(), "tpu_frames_per_dispatch", 3)
    k3 = TpuKernel(_chain(T), np.complex64, frame_size=FRAME, inst=CPU)
    assert k3.k_batch == 3
    # the output ring holds every group in flight and one more frame
    assert k3.output.min_buffer_size == (5 * 3 + 1) * k3.out_frame * 4


# ---------------------------------------------------------------------------
# the staging arena (tests/test_arena.py's arena cases)
# ---------------------------------------------------------------------------

def test_arena_size_classes_and_recycle():
    a = StagingArena(max_bytes=64 << 20, pin=False)
    b1 = a.take(100_000)                 # -> 128 KiB class
    assert b1.nbytes == 1 << 17
    b1.release()
    b2 = a.take(120_000)                 # same class: served from the pool
    assert b2 is b1
    assert a.hits == 1 and a.misses == 1
    b3 = a.take(1 << 20)                 # a different class allocates fresh
    assert b3 is not b1 and b3.nbytes == 1 << 20
    assert a.misses == 2
    b2.release()
    b3.release()
    st = a.stats()
    assert st["pinned_bytes"] == 0
    assert st["pooled_bytes"] == (1 << 17) + (1 << 20)


def test_arena_refcount_blocks_recycle():
    """A retained buffer survives the taker's release: it recycles only at
    refcount zero, and a release past zero is a no-op."""
    a = StagingArena(pin=False)
    b = a.take(4096)
    b.retain()                           # a second holder
    b.release()                          # the taker is done
    assert a.stats()["pooled_bytes"] == 0
    b2 = a.take(4096)
    assert b2 is not b                   # never the retained buffer
    b.release()
    assert a.stats()["pooled_bytes"] == b.nbytes
    b.release()                          # over-release: no-op
    assert a.stats()["pooled_bytes"] == b.nbytes
    b2.release()


def test_arena_pool_cap_drops():
    a = StagingArena(max_bytes=1 << 17, pin=False)   # cap: one 128 KiB buffer
    b1, b2 = a.take(1 << 17), a.take(1 << 17)
    b1.release()
    b2.release()                         # past the cap: dropped, not pooled
    assert a.stats()["pooled_bytes"] == 1 << 17
    assert len(a._free[17]) == 1


def test_arena_copy_in_and_array_view():
    a = StagingArena(pin=False)
    src = np.arange(1000, dtype=np.complex64)
    v, h = a.copy_in(src)
    np.testing.assert_array_equal(v, src)
    assert v.dtype == src.dtype and np.shares_memory(v, h.base)
    assert torch.equal(h.tensor[:src.nbytes].view(torch.complex64), torch.from_numpy(src))
    h.release()


class _Event:
    """A CUDA event's ``query`` for the CPU: completed once ``done`` is set."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done


def test_arena_reuses_a_buffer_only_after_its_copy_completed():
    a = StagingArena(pin=False)
    b = a.take(4096)
    ev = _Event()
    b.record(ev)                         # a copy still reads the buffer
    b.release()
    assert a.stats()["pooled_bytes"] == b.nbytes
    b2 = a.take(4096)
    assert b2 is not b and a.misses == 2
    ev.done = True
    b2.release()
    assert a.take(4096) in (b, b2) and a.hits == 1


def test_cpu_transfers_copy_and_never_pin():
    """On the CPU a host buffer is a plain array: the H2D copies the frame
    (the caller may reuse its memory at once) and the D2H's release is a
    no-op."""
    frame = _stream(3, 64)
    finish = xfer.start_device_transfer(frame, "cpu")
    frame[:] = 0
    got = finish()
    np.testing.assert_array_equal(got.numpy(), _stream(3, 64))
    assert not xfer.host_buffer((4, 8), np.complex64, "cpu").tensor.is_pinned()
    back = xfer.start_host_transfer(got)
    np.testing.assert_array_equal(back(), _stream(3, 64))
    back.release()
    np.testing.assert_array_equal(xfer.to_host(got), _stream(3, 64))


# ---------------------------------------------------------------------------
# Pipeline.compile on the CPU
# ---------------------------------------------------------------------------

def _fm_chain():
    return [T.rotator_stage(-0.3, impl="pallas"),
            T.fir_stage(firdes.lowpass(0.1, 32), decim=4, impl="pallas"),
            T.quad_demod_stage(2.0, impl="pallas"),
            T.resample_stage(3, 5, impl="pallas")]


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("chain", ["spectrum", "fm"])
def test_compile_on_cpu_equals_fn_over_chained_frames(chain, k):
    stages = _chain(T) if chain == "spectrum" else _fm_chain()
    pipe = T.Pipeline(stages, np.complex64)
    frame = 2 * pipe.frame_multiple * (1 if chain == "spectrum" else 20)
    xs = torch.from_numpy(_stream(4, 3 * k * frame)).reshape(3 * k, frame)
    fn, carry = pipe.compile(frame, "cpu", k=k)
    slotted, slot_carry = pipe.compile(frame, "cpu", k=k, slots=2)
    got, via_slots = [], []
    for d in range(3):
        x = xs[d * k:(d + 1) * k] if k > 1 else xs[d]
        carry, y = fn(carry, x)
        assert y.shape == ((k, pipe.out_items(frame)) if k > 1 else (pipe.out_items(frame),))
        got.append(y.reshape(-1))
        slotted.inputs[d % 2].copy_(x)          # the streamed caller's H2D
        slot_carry, y = slotted.dispatch(d % 2, slot_carry)
        via_slots.append(y.reshape(-1))
    ref_fn, ref_carry = pipe.fn(), pipe.init_carry("cpu")
    want = []
    for x in xs:
        ref_carry, y = ref_fn(ref_carry, x)
        want.append(y)
    torch.testing.assert_close(torch.cat(got), torch.cat(want), rtol=0, atol=0)
    torch.testing.assert_close(torch.cat(via_slots), torch.cat(want), rtol=0, atol=0)


def test_compile_rejects_a_frame_off_the_multiple():
    pipe = T.Pipeline(_chain(T), np.complex64)
    with pytest.raises(ValueError):
        pipe.compile(pipe.frame_multiple + 1, "cpu")


# ---------------------------------------------------------------------------
# TpuKernel(frames_per_dispatch=K) against the reference
# ---------------------------------------------------------------------------

def _gated_source(base):
    """A source for either runtime that emits ``items[:gate_at]``, waits for
    ``gate``, then emits the rest: a retune applied while it waits lands at
    the same dispatch-group boundary in both kernels."""

    class Gated(base):
        def __init__(self, items, gate_at, gate):
            super().__init__()
            self.items, self.gate_at, self.gate, self._pos = items, gate_at, gate, 0
            self.output = self.add_stream_output("out", items.dtype)

        async def work(self, io, mio, meta):
            end = len(self.items) if self.gate.is_set() else self.gate_at
            if self._pos >= end:
                await asyncio.sleep(0.001)
                io.call_again = True
                return
            out = self.output.slice()
            k = min(len(out), end - self._pos)
            out[:k] = self.items[self._pos:self._pos + k]
            self.output.produce(k)
            self._pos += k
            if self._pos == len(self.items):
                io.finished = True
            elif k:
                io.call_again = True

    return Gated


def _run_gated(fg_cls, rt_cls, sink_cls, src, kern, dispatched, retune):
    """Run ``src -> kern -> sink``; once ``dispatched()`` frames went out
    and the source waits at its gate, ``retune()``, then open the gate."""
    fg = fg_cls()
    snk = sink_cls(np.float32)
    fg.connect(src, kern, snk)
    rt = rt_cls()
    running = rt.start(fg)
    deadline = time.monotonic() + 30
    while dispatched() < (src.gate_at // FRAME) // kern.k_batch * kern.k_batch:
        assert time.monotonic() < deadline, "the stream did not reach the gate"
        time.sleep(0.001)
    retune()
    src.gate.set()
    running.wait_sync()
    rt.shutdown()
    return snk.items()


@pytest.mark.parametrize("k", [1, 3, 4])
def test_tpu_kernel_megabatch_matches_jax_tpu_kernel(k):
    """Eleven full frames and a partial one through K-frame dispatch groups
    (the last group partial, zero-padded at EOS), with the taps swapped
    while the source holds after five frames: the port and the reference
    emit the same items, and the retune lands on the same frame."""
    data = _stream(5, 11 * FRAME + 3 * 256 + 100)
    gate_at = 5 * FRAME
    port = TpuKernel(_chain(T), np.complex64, frame_size=FRAME, inst=CPU,
                     frames_in_flight=2, frames_per_dispatch=k)
    ref = JaxTpuKernel(_chain(J), np.complex64, frame_size=FRAME, frames_in_flight=2,
                       frames_per_dispatch=k)
    at = []
    got = _run_gated(Flowgraph, Runtime, VectorSink,
                     _gated_source(Kernel)(data, gate_at, threading.Event()), port,
                     lambda: port.frames_dispatched,
                     lambda: at.append(port.apply_retune(0, taps=TAPS2)))
    want = _run_gated(jfs.Flowgraph, jfs.Runtime, jblocks.VectorSink,
                      _gated_source(JaxKernelBase)(data, gate_at, threading.Event()), ref,
                      lambda: ref._frames_dispatched,
                      lambda: ref.apply_retune(0, {"taps": TAPS2}))
    fm = port.pipeline.frame_multiple
    assert at == [5 // k * k]
    assert len(got) == len(want) == len(data) - (len(data) - 11 * FRAME) % fm
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-2)
    # the swap shows: the frames after it differ from an unswapped run
    plain = TpuKernel(_chain(T), np.complex64, frame_size=FRAME, inst=CPU,
                      frames_per_dispatch=k)
    fg = Flowgraph()
    snk = VectorSink(np.float32)
    fg.connect(VectorSource(data), plain, snk)
    Runtime().run(fg)
    cut = at[0] * FRAME
    np.testing.assert_array_equal(snk.items()[:cut], got[:cut])
    assert not np.allclose(snk.items()[cut:], got[cut:], rtol=1e-3, atol=1e-2)
