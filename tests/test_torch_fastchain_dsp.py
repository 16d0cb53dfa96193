"""The port's native fast chain with its DSP stages (``csrc/host/fastchain.cpp``
``FC_FIR_*``, ``FC_QUAD_DEMOD``, ``FC_XLATING``, ``FC_AGC``, ``FC_RESAMPLE``,
``FC_SIG``, ``FC_DELAY``, files): the cases of ``tests/test_fastchain_dsp.py``
on the port. Whole pipes containing real filters run as one C++ thread and are
held against the port's actor path; FIR outputs agree to float32 rounding
(the native kernel accumulates taps in ascending order, ``np.convolve``
through BLAS), copy-class chains bit for bit. Then each stage kind, fused on
the port, is held against the JAX package's actor path on the same seeded
input at the same tolerances. Both packages read ``FSDR_NO_FASTCHAIN``: it is
set with ``monkeypatch`` around the actor run only.
"""

import numpy as np
import pytest
import torch

from futuresdr_tpu_torch import Flowgraph, Runtime
from futuresdr_tpu_torch.blocks import CopyRand, Fir, Head, NullSink, NullSource, \
    QuadratureDemod, VectorSink, VectorSource
from futuresdr_tpu_torch.dsp import firdes
from futuresdr_tpu_torch.runtime.fastchain import find_native_chains

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)


def _run_ab(build):
    """Run `build()`-produced (fg, sink) twice — fused and actor — and return
    both collected arrays."""
    fg, vs = build()
    assert len(find_native_chains(fg)) == 1, "chain did not fuse"
    Runtime().run(fg)
    got_native = vs.items().copy()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FSDR_NO_FASTCHAIN", "1")
        fg2, vs2 = build()
        assert find_native_chains(fg2) == []
        Runtime().run(fg2)
    return got_native, vs2.items()


def test_fir_chain_matches_actor_path():
    taps = firdes.lowpass(0.2, 64).astype(np.float32)
    rng = np.random.default_rng(11)
    data = rng.standard_normal(30_000).astype(np.float32)

    def build():
        fg = Flowgraph()
        src = VectorSource(data)
        vs = VectorSink(np.float32)
        fg.connect(src, CopyRand(np.float32, max_copy=777, seed=3),
                   Fir(taps, np.float32),
                   CopyRand(np.float32, max_copy=129, seed=5),
                   Fir(taps, np.float32), vs)
        return fg, vs

    native, actor = _run_ab(build)
    assert len(native) == len(actor) == len(data)
    np.testing.assert_allclose(native, actor, rtol=2e-5, atol=1e-6)


def test_decimating_fir_chain_counts_and_values():
    taps = firdes.lowpass(0.1, 48).astype(np.float32)
    rng = np.random.default_rng(12)
    data = rng.standard_normal(10_001).astype(np.float32)   # odd length on purpose

    def build():
        fg = Flowgraph()
        vs = VectorSink(np.float32)
        fg.connect(VectorSource(data), Fir(taps, np.float32, decim=4), vs)
        return fg, vs

    native, actor = _run_ab(build)
    assert len(native) == len(actor) == -(-len(data) // 4)   # ceil(n/decim)
    np.testing.assert_allclose(native, actor, rtol=2e-5, atol=1e-6)


def test_complex_fir_quad_demod_fm_chain():
    """The FM front-end shape: c64 stream → decimating FIR (f32 taps) → quad
    demod (c64 → f32) — exercises per-edge item sizes across a dtype change."""
    taps = firdes.lowpass(0.15, 64).astype(np.float32)
    rng = np.random.default_rng(13)
    iq = (rng.standard_normal(20_000) + 1j * rng.standard_normal(20_000)) \
        .astype(np.complex64)

    def build():
        fg = Flowgraph()
        vs = VectorSink(np.float32)
        fg.connect(VectorSource(iq), Fir(taps, np.complex64, decim=2),
                   QuadratureDemod(gain=0.7), vs)
        return fg, vs

    native, actor = _run_ab(build)
    assert len(native) == len(actor) == 10_000
    # atan2 near small-magnitude arguments amplifies the f32 FIR rounding
    np.testing.assert_allclose(native, actor, rtol=2e-4, atol=1e-5)


def test_complex_taps_xlating_fir():
    base = firdes.lowpass(0.2, 32).astype(np.float32)
    taps = (base * np.exp(2j * np.pi * 0.05 * np.arange(32))).astype(np.complex64)
    rng = np.random.default_rng(14)
    iq = (rng.standard_normal(8_000) + 1j * rng.standard_normal(8_000)) \
        .astype(np.complex64)

    def build():
        fg = Flowgraph()
        vs = VectorSink(np.complex64)
        fg.connect(VectorSource(iq), CopyRand(np.complex64, max_copy=333, seed=7),
                   Fir(taps, np.complex64), vs)
        return fg, vs

    native, actor = _run_ab(build)
    np.testing.assert_allclose(native, actor, rtol=3e-5, atol=2e-6)


def test_xlating_fir_chain_matches_actor_path():
    """FC_XLATING: rotate→FIR→decimate in one native stage — the front half of
    every receiver (blocks.XlatingFir) now fuses."""
    from futuresdr_tpu_torch.blocks import XlatingFir
    fs = 250e3
    taps = firdes.lowpass(0.1, 64).astype(np.float32)
    rng = np.random.default_rng(21)
    iq = (rng.standard_normal(24_000) + 1j * rng.standard_normal(24_000)) \
        .astype(np.complex64)

    def build():
        fg = Flowgraph()
        vs = VectorSink(np.complex64)
        xf = XlatingFir(taps, decim=5, offset_freq=12e3, sample_rate=fs)
        xf.fastchain_static = True     # promise: no runtime freq retunes
        fg.connect(VectorSource(iq),
                   CopyRand(np.complex64, max_copy=513, seed=4), xf, vs)
        return fg, vs

    native, actor = _run_ab(build)
    assert len(native) == len(actor) == -(-24_000 // 5)
    np.testing.assert_allclose(native, actor, rtol=2e-4, atol=2e-5)


def test_xlating_fir_not_fused_without_static_optin():
    """Default: a block with a live retune handler stays on the actor path —
    a fused chain cannot service handle.call(freq) (review regression)."""
    from futuresdr_tpu_torch.blocks import XlatingFir
    taps = firdes.lowpass(0.1, 32).astype(np.float32)
    fg = Flowgraph()
    fg.connect(VectorSource(np.zeros(1000, np.complex64)),
               XlatingFir(taps, decim=2, offset_freq=1e3, sample_rate=48e3),
               NullSink(np.complex64))
    assert find_native_chains(fg) == []


def test_xlating_fir_with_connected_freq_port_not_fused():
    """A message EDGE into the xlating block's freq port must keep it on the
    actor path (retunes need the live handler)."""
    from futuresdr_tpu_torch.blocks import MessageBurst, XlatingFir
    from futuresdr_tpu_torch import Pmt
    taps = firdes.lowpass(0.1, 32).astype(np.float32)
    fg = Flowgraph()
    xf = XlatingFir(taps, decim=2, offset_freq=1e3, sample_rate=48e3)
    # opt-in SET: the message-EDGE exclusion must hold even when the user
    # promised static operation (the edge proves they lied) — without this
    # line the opt-in gate already excludes the block and the test is vacuous
    xf.fastchain_static = True
    fg.connect(VectorSource(np.zeros(1000, np.complex64)), xf,
               NullSink(np.complex64))
    tuner = MessageBurst(Pmt.f64(2e3), 1)
    fg.connect_message(tuner, "out", xf, "freq")
    assert find_native_chains(fg) == []


def test_agc_chain_matches_actor_path_and_writes_back_gain():
    """FC_AGC: the per-sample feedback loop (blocks.Agc mode='sample') runs
    natively; the final gain is written back to kernel.gain like the actor
    path leaves it."""
    from futuresdr_tpu_torch.blocks import Agc
    rng = np.random.default_rng(31)
    iq = (0.25 * (rng.standard_normal(20_000) + 1j * rng.standard_normal(20_000))
          ).astype(np.complex64)
    gains = {}

    def build():
        fg = Flowgraph()
        vs = VectorSink(np.complex64)
        agc = Agc(np.complex64, reference=1.0, adjustment_rate=1e-3)
        agc.fastchain_static = True    # promise: no gain_lock/reference calls
        fg.connect(VectorSource(iq), CopyRand(np.complex64, max_copy=601,
                                              seed=6), agc, vs)
        gains["last"] = agc
        return fg, vs

    native, actor = _run_ab(build)
    # _run_ab's second run was the actor build — its kernel holds actor gain
    actor_gain = gains["last"].gain
    fg_n, _ = build()
    Runtime().run(fg_n)
    native_gain = gains["last"].gain

    np.testing.assert_allclose(native, actor, rtol=2e-5, atol=1e-6)
    assert native_gain > 1.0           # quiet input: gain climbed
    # glibc hypotf and numpy's npy_hypotf can differ by 1 ulp on |x|, so the
    # 20k-step feedback trajectory lands within a few ulps, not bit-equal
    np.testing.assert_allclose(native_gain, actor_gain, rtol=1e-6)


def test_agc_not_fused_without_static_optin_or_in_block_mode():
    from futuresdr_tpu_torch.blocks import Agc
    fg = Flowgraph()
    fg.connect(VectorSource(np.zeros(1000, np.complex64)),
               Agc(np.complex64), NullSink(np.complex64))
    assert find_native_chains(fg) == []          # no opt-in
    fg2 = Flowgraph()
    a2 = Agc(np.complex64, mode="block")
    a2.fastchain_static = True
    fg2.connect(VectorSource(np.zeros(1000, np.complex64)), a2,
                NullSink(np.complex64))
    assert find_native_chains(fg2) == []         # block mode stays actor


def test_kernel_state_writeback_after_fused_run():
    """Round-4 advisory: post-run attribute reads must match the actor path —
    Head.remaining hits 0, VectorSource shows its position consumed."""
    taps = firdes.lowpass(0.2, 16).astype(np.float32)
    data = np.arange(4_000, dtype=np.float32)
    fg = Flowgraph()
    src = VectorSource(data, repeat=3)
    head = Head(np.float32, 7_000)
    snk = NullSink(np.float32)
    fg.connect(src, head, Fir(taps, np.float32), snk)
    assert len(find_native_chains(fg)) == 1
    Runtime().run(fg)
    assert head.remaining == 0
    # the source EMITS its full budget into the (64k-item) ring even though the
    # Head only forwards 7000 — exactly like the actor path, whose 256 KiB
    # stream buffer also swallows all 12000 before the Head stops consuming
    assert (src._round, src._pos) == (3, 0)
    assert snk.n_received == 7_000


def test_mid_stream_fir_state_not_eligible():
    taps = firdes.lowpass(0.2, 16).astype(np.float32)
    fir = Fir(taps, np.float32)
    fir.core.process(np.zeros(10, dtype=np.float32))   # leaves history behind
    fg = Flowgraph()
    fg.connect(NullSource(np.float32), Head(np.float32, 1000), fir,
               NullSink(np.float32))
    assert find_native_chains(fg) == []


def test_f64_taps_not_eligible():
    taps = firdes.lowpass(0.2, 16)                     # float64 by default
    assert taps.dtype == np.float64
    fg = Flowgraph()
    fg.connect(NullSource(np.float32), Head(np.float32, 1000),
               Fir(taps, np.float32), NullSink(np.float32))
    assert find_native_chains(fg) == []


def test_untyped_passthrough_between_widths_not_fused():
    """Review regression (heap overflow): an UNTYPED Copy between a c64 edge
    and an f32 edge must not fuse — the C driver would memcpy 8-byte items
    into a 4-byte ring."""
    from futuresdr_tpu_torch.blocks import Copy
    taps = firdes.lowpass(0.2, 16).astype(np.float32)
    iq = np.zeros(1000, dtype=np.complex64)
    fg = Flowgraph()
    fg.connect(VectorSource(iq), Fir(taps, np.complex64), Copy(None),
               NullSink(np.float32))
    assert find_native_chains(fg) == []


def test_rate_changing_stage_metrics_are_per_port():
    """A decimating FIR reports consumed ≠ produced through the live bridge."""
    taps = firdes.lowpass(0.1, 32).astype(np.float32)
    fg = Flowgraph()
    fir = Fir(taps, np.float32, decim=8)
    snk = NullSink(np.float32)
    fg.connect(NullSource(np.float32), Head(np.float32, 80_000), fir, snk)
    assert len(find_native_chains(fg)) == 1
    Runtime().run(fg)
    w = fg.wrapped(fir)
    m = w.metrics()
    assert m["fused_native"] is True
    assert m["items_in"]["in"] == 80_000
    assert m["items_out"]["out"] == 10_000
    assert snk.n_received == 10_000


def test_fused_dsp_chain_live_metrics_over_rest():
    """The fused chain's live counter bridge serves honest per-port counts for
    a RATE-CHANGING stage through the real REST surface while the native loop
    is mid-run — the HTTP twin of test_fastchain's handle-based check."""
    import json
    import time
    import urllib.request

    from futuresdr_tpu_torch import Runtime
    from futuresdr_tpu_torch.runtime.ctrl_port import ControlPort

    taps = firdes.lowpass(0.1, 32).astype(np.float32)
    fg = Flowgraph()
    fir = Fir(taps, np.float32, decim=8)
    snk = NullSink(np.float32)
    fg.connect(NullSource(np.float32), Head(np.float32, 300_000_000), fir, snk)
    assert len(find_native_chains(fg)) == 1
    rt = Runtime()
    cp = ControlPort(rt.handle, bind="127.0.0.1:0")
    cp.start()
    running = rt.start(fg)
    try:
        base = cp.url
        deadline = time.time() + 15
        seen = None
        while time.time() < deadline:
            m = json.load(urllib.request.urlopen(f"{base}/api/fg/0/metrics/"))
            # the decimating FIR is the one fused member consuming MORE than
            # it produces (Head/source/sink are 1:1)
            fir_m = next((v for v in m.values()
                          if v.get("fused_native")
                          and v["items_out"].get("out", 0) > 0
                          and v["items_in"].get("in", 0)
                          > v["items_out"]["out"]), None)
            if fir_m:
                seen = fir_m
                break
            time.sleep(0.05)
        assert seen is not None, "fused metrics never appeared over REST"
        # decimating stage: consumed ≈ produced × 8, live mid-run
        assert seen["items_in"]["in"] >= 8 * seen["items_out"]["out"] > 0
    finally:
        running.stop_sync()
        cp.stop()


@pytest.mark.parametrize("interp,decim,dtype", [
    (3, 2, np.float32), (2, 5, np.float32), (12, 5, np.complex64),
    (5, 12, np.complex64)])
def test_rational_resampler_chain_matches_actor(interp, decim, dtype):
    """FC_RESAMPLE: Fir(interp≠1) — the rational polyphase resampler — fuses
    with exact output counts (the m_hi contract of dsp/kernels.py) and
    allclose values across up/down ratios and both dtypes."""
    taps = firdes.lowpass(0.4 / max(interp, decim), 48).astype(np.float32)
    rng = np.random.default_rng(41)
    n = 10_007                                     # odd on purpose
    if dtype == np.complex64:
        data = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
            .astype(np.complex64)
    else:
        data = rng.standard_normal(n).astype(np.float32)

    def build():
        fg = Flowgraph()
        vs = VectorSink(dtype)
        fg.connect(VectorSource(data),
                   CopyRand(dtype, max_copy=431, seed=9),
                   Fir(taps, dtype, decim=decim, interp=interp), vs)
        return fg, vs

    native, actor = _run_ab(build)
    assert len(native) == len(actor), (len(native), len(actor))
    np.testing.assert_allclose(native, actor, rtol=3e-5, atol=3e-6)


def test_resampler_f64_taps_not_fused():
    taps = firdes.lowpass(0.1, 32)                 # float64
    fg = Flowgraph()
    fg.connect(VectorSource(np.zeros(1000, np.float32)),
               Fir(taps, np.float32, interp=2, decim=3), NullSink(np.float32))
    assert find_native_chains(fg) == []


def test_file_source_dsp_chain_fuses(tmp_path):
    """FileSource replays as a memmap-backed native source: a whole
    file → FIR → demod receiver pipe runs in C, matching the actor path."""
    rng = np.random.default_rng(61)
    iq = (rng.standard_normal(16_000) + 1j * rng.standard_normal(16_000)) \
        .astype(np.complex64)
    path = str(tmp_path / "capture.cf32")
    iq.tofile(path)
    taps = firdes.lowpass(0.2, 48).astype(np.float32)

    def build():
        from futuresdr_tpu_torch.blocks import FileSource
        fg = Flowgraph()
        vs = VectorSink(np.float32)
        fg.connect(FileSource(path, np.complex64),
                   Fir(taps, np.complex64, decim=4),
                   QuadratureDemod(gain=1.0), vs)
        return fg, vs

    native, actor = _run_ab(build)
    assert len(native) == len(actor) == 4_000
    np.testing.assert_allclose(native, actor, rtol=2e-4, atol=1e-5)


def test_file_source_repeat_bounded_by_head(tmp_path):
    """repeat=True replays the file forever natively (infinite cyclic
    budget); Head bounds it and the wrap seam matches the actor path."""
    from futuresdr_tpu_torch.blocks import Copy, FileSource
    data = np.arange(1000, dtype=np.float32)
    path = str(tmp_path / "loop.f32")
    data.tofile(path)

    def build():
        fg = Flowgraph()
        vs = VectorSink(np.float32)
        fg.connect(FileSource(path, np.float32, repeat=True),
                   Head(np.float32, 3_500), Copy(np.float32), vs)
        return fg, vs

    native, actor = _run_ab(build)
    want = np.concatenate([data, data, data, data[:500]])
    np.testing.assert_array_equal(native, want)
    np.testing.assert_array_equal(actor, want)


def test_file_to_file_dsp_chain_fully_native(tmp_path):
    """file → xlating front end → quad demod → resampler → file, all in C:
    the file_trx rx shape end to end, byte-compared against the actor path."""
    from futuresdr_tpu_torch.blocks import FileSink, FileSource, XlatingFir
    rng = np.random.default_rng(71)
    iq = (rng.standard_normal(30_000) + 1j * rng.standard_normal(30_000)) \
        .astype(np.complex64)
    src_path = str(tmp_path / "in.cf32")
    iq.tofile(src_path)
    taps = firdes.lowpass(0.08, 64).astype(np.float32)
    rtaps = firdes.lowpass(0.2, 36).astype(np.float32)
    outs = {}

    def build():
        fg = Flowgraph()
        xf = XlatingFir(taps, decim=5, offset_freq=20e3, sample_rate=250e3)
        xf.fastchain_static = True
        path = str(tmp_path / f"out{len(outs)}.f32")
        outs[len(outs)] = path
        sink = FileSink(path, np.float32)
        fg.connect(FileSource(src_path, np.complex64), xf,
                   QuadratureDemod(gain=1.0),
                   Fir(rtaps, np.float32, interp=2, decim=3), sink)
        # VectorSink-style probe is absent: compare the files themselves
        return fg, sink

    fg_n, sink_n = build()
    assert len(find_native_chains(fg_n)) == 1
    Runtime().run(fg_n)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FSDR_NO_FASTCHAIN", "1")
        fg_a, sink_a = build()
        assert find_native_chains(fg_a) == []
        Runtime().run(fg_a)
    native = np.fromfile(outs[0], np.float32)
    actor = np.fromfile(outs[1], np.float32)
    assert sink_n.n_written == len(native) == len(actor) > 0
    np.testing.assert_allclose(native, actor, rtol=3e-4, atol=2e-5)


def test_unbounded_file_sink_not_fused(tmp_path):
    """NullSource (infinite) → FileSink must stay on the actor path: a fused
    bounded-collection sink would buffer forever."""
    from futuresdr_tpu_torch.blocks import Copy, FileSink
    fg = Flowgraph()
    fg.connect(NullSource(np.float32), Copy(np.float32),
               FileSink(str(tmp_path / "x.f32"), np.float32))
    assert find_native_chains(fg) == []


def test_large_bounded_file_sink_not_fused(tmp_path):
    """A bounded output above the 256 MB RAM gate streams on the actor path
    (the fused sink buffers everything before its one-shot flush)."""
    from futuresdr_tpu_torch.blocks import FileSink
    fg = Flowgraph()
    fg.connect(NullSource(np.float32), Head(np.float32, 100_000_000),
               FileSink(str(tmp_path / "big.f32"), np.float32))
    assert find_native_chains(fg) == []


def test_unwritable_file_sink_path_errors_cleanly(tmp_path):
    """An unwritable sink path must surface as a flowgraph error (like the
    actor path's init failure), never hang the supervisor."""
    from futuresdr_tpu_torch.blocks import FileSink
    fg = Flowgraph()
    fg.connect(NullSource(np.float32), Head(np.float32, 1000),
               FileSink(str(tmp_path / "no" / "such" / "dir" / "x.f32"),
                        np.float32))
    assert len(find_native_chains(fg)) == 1
    with pytest.raises(Exception):
        Runtime().run(fg)


def test_bounded_file_sink_above_gate_not_fused(tmp_path):
    """A bounded-but-huge output (here 500M f32 = 2 GB after decimation)
    stays on the streaming actor path — the RAM gate applies to the
    POST-rate-transform bound, not the source budget."""
    from futuresdr_tpu_torch.blocks import FileSink
    taps = firdes.lowpass(0.1, 32).astype(np.float32)
    fg = Flowgraph()
    fg.connect(NullSource(np.float32), Head(np.float32, 2_000_000_000),
               Fir(taps, np.float32, decim=4),
               FileSink(str(tmp_path / "part.f32"), np.float32))
    assert find_native_chains(fg) == []


def test_terminate_stops_fused_dsp_chain():
    """Terminate mid-run stops a DSP-bearing fused chain cleanly: the stop
    flag reaches the C loop, BlockDone flows for every member, and the
    decimating stage's counters stay rate-consistent."""
    import time

    taps = firdes.lowpass(0.1, 32).astype(np.float32)
    fg = Flowgraph()
    fir = Fir(taps, np.float32, decim=4)
    snk = NullSink(np.float32)
    fg.connect(NullSource(np.float32), fir, snk)      # unbounded: stop() ends it
    assert len(find_native_chains(fg)) == 1
    rt = Runtime()
    running = rt.start(fg)
    deadline = time.perf_counter() + 10.0
    seen = 0
    while time.perf_counter() < deadline and seen == 0:
        m = running.handle.metrics_sync()
        seen = max((v["items_out"].get("out", 0) for v in m.values()
                    if v.get("fused_native")), default=0)
        time.sleep(0.01)
    assert seen > 0, "fused DSP chain never made progress"
    running.stop_sync()                    # Terminate → stop flag → clean join
    assert snk.n_received > 0
    w = fg.wrapped(fir)
    m = w.metrics()
    # consumed ≈ produced × decim (within one in-flight chunk)
    assert m["items_in"]["in"] >= 4 * m["items_out"]["out"] > 0


def test_signal_source_chain_bit_exact():
    """FC_SIG: the fxpt NCO source fuses with a BIT-exact phase schedule (the
    wrapping-u32 ramp is integer) — sample values match the actor path to
    float32 rounding of the same f64 trig, and the tone lands on frequency."""
    from futuresdr_tpu_torch.blocks import SignalSource

    from futuresdr_tpu_torch.dsp import fxpt
    sigs = {}

    def build(waveform, dtype):
        fg = Flowgraph()
        vs = VectorSink(dtype)
        sig = SignalSource(waveform, 12_500.0, 250e3, amplitude=0.8,
                           offset=0.1)
        sig.fastchain_static = True    # promise: no runtime freq/amp calls
        sigs["last"] = sig
        fg.connect(sig, Head(dtype, 50_000), vs)
        return fg, vs

    for waveform, dtype in (("complex", np.complex64), ("sin", np.float32),
                            ("square", np.float32)):
        fg, vs = build(waveform, dtype)
        assert len(find_native_chains(fg)) == 1, waveform
        Runtime().run(fg)
        native = vs.items().copy()
        # NCO phase write-back: post-fused-run state matches the actor
        # path's wrap-advance over everything the source EMITTED (the ring
        # swallows more than Head forwards)
        sig_n = sigs["last"]
        assert sig_n._phase_i == fxpt.advance_u32(
            0, sig_n._inc_i, sig_n.output.items_produced)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("FSDR_NO_FASTCHAIN", "1")
            fg2, vs2 = build(waveform, dtype)
            Runtime().run(fg2)
        actor = vs2.items()
        assert len(native) == len(actor) == 50_000
        np.testing.assert_allclose(native, actor, rtol=1e-6, atol=1e-6,
                                   err_msg=waveform)
        if waveform == "complex":
            # single-sided spectral check: the complex tone lands on its bin
            # (a real waveform would have an equal mirror bin — review)
            spec = np.abs(np.fft.fft(native[:16384]))
            assert np.argmax(spec) == round(12_500.0 / 250e3 * 16384)


def test_signal_source_not_fused_without_optin_or_float_nco():
    from futuresdr_tpu_torch.blocks import SignalSource
    fg = Flowgraph()
    fg.connect(SignalSource("sin", 1e3, 48e3), Head(np.float32, 100),
               NullSink(np.float32))
    assert find_native_chains(fg) == []          # no opt-in
    fg2 = Flowgraph()
    s2 = SignalSource("sin", 1e3, 48e3, nco="float")
    s2.fastchain_static = True
    fg2.connect(s2, Head(np.float32, 100), NullSink(np.float32))
    assert find_native_chains(fg2) == []         # float NCO stays actor


def test_random_chain_shapes_fuzz():
    """Seeded sweep over random ELIGIBLE chain shapes: stage mixes across
    both dtype lanes (copies, plain/decim/resampling FIRs, xlating, AGC,
    quad demod), random data and chunking — every fused chain must match its
    actor twin. The chain-composition analog of the receiver family fuzzes."""
    from futuresdr_tpu_torch.blocks import Agc, XlatingFir
    rng = np.random.default_rng(4242)
    for trial in range(6):
        complex_lane = bool(rng.integers(0, 2))
        dt = np.complex64 if complex_lane else np.float32
        n = int(rng.integers(6_000, 20_000))
        if complex_lane:
            data = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
                .astype(np.complex64)
        else:
            data = rng.standard_normal(n).astype(np.float32)
        n_stages = int(rng.integers(1, 5))
        spec = []
        for _ in range(n_stages):
            kind = rng.choice(["copyrand", "fir", "decim", "resample",
                               "xlating", "agc"] if complex_lane else
                              ["copyrand", "fir", "decim", "resample"])
            spec.append(str(kind))
        demod_tail = complex_lane and bool(rng.integers(0, 2))

        def build():
            nonlocal rng_b
            rng_b = np.random.default_rng(pseed)   # identical params per path
            fg = Flowgraph()
            src = VectorSource(data)
            last = src
            cur_dt = dt
            for kind in spec:
                if kind == "copyrand":
                    b = CopyRand(cur_dt, int(rng_b.integers(64, 1024)),
                                 seed=int(rng_b.integers(1, 99)))
                elif kind == "fir":
                    b = Fir(firdes.lowpass(0.2, int(rng_b.integers(8, 65))
                                           ).astype(np.float32), cur_dt)
                elif kind == "decim":
                    b = Fir(firdes.lowpass(0.1, 32).astype(np.float32),
                            cur_dt, decim=int(rng_b.integers(2, 5)))
                elif kind == "resample":
                    b = Fir(firdes.lowpass(0.1, 24).astype(np.float32),
                            cur_dt, interp=int(rng_b.integers(2, 4)),
                            decim=int(rng_b.integers(2, 6)))
                elif kind == "xlating":
                    b = XlatingFir(firdes.lowpass(0.1, 32).astype(np.float32),
                                   decim=int(rng_b.integers(1, 4)),
                                   offset_freq=float(rng_b.uniform(-2e4, 2e4)),
                                   sample_rate=250e3)
                    b.fastchain_static = True
                else:
                    b = Agc(cur_dt, reference=0.8, adjustment_rate=1e-3)
                    b.fastchain_static = True
                fg.connect(last, b)
                last = b
            if demod_tail:
                b = QuadratureDemod(gain=float(rng_b.uniform(0.3, 2.0)))
                gains["demod"] = b.gain
                fg.connect(last, b)
                last = b
                cur_dt = np.float32
            vs = VectorSink(cur_dt)
            fg.connect(last, vs)
            return fg, vs

        gains = {}
        pseed = int(rng.integers(0, 1 << 30))
        rng_b = None
        native, actor = _run_ab(build)
        assert len(native) == len(actor), (trial, spec)
        bad = ~np.isclose(native, actor, rtol=5e-4, atol=5e-5)
        if demod_tail and bad.any():
            # the demod's ±π branch cut: a 1-ulp FIR difference can flip
            # atan2 across the cut, giving wrap-EQUIVALENT outputs that
            # differ by exactly 2π·gain — both are correct demod values
            wrap = 2 * np.pi * gains["demod"]
            np.testing.assert_allclose(
                np.abs(np.asarray(native)[bad] - np.asarray(actor)[bad]),
                wrap, rtol=1e-3,
                err_msg=f"{trial} {spec} non-wrap mismatch")
        else:
            assert not bad.any(), (trial, spec, int(bad.sum()))


def test_delay_chain_pad_and_skip_match_actor():
    """FC_DELAY: positive delay zero-pads the front, negative skips inputs —
    both through the native chain bit-exactly (copy-class data)."""
    from futuresdr_tpu_torch.blocks import Delay
    data = np.arange(1, 9_001, dtype=np.float32)
    for n in (137, -251):
        def build():
            fg = Flowgraph()
            vs = VectorSink(np.float32)
            d = Delay(np.float32, n)
            d.fastchain_static = True   # promise: no new_value retunes
            fg.connect(VectorSource(data),
                       CopyRand(np.float32, max_copy=333, seed=2), d, vs)
            return fg, vs

        native, actor = _run_ab(build)
        np.testing.assert_array_equal(native, actor)
        if n > 0:
            assert len(native) == len(data) + n
            assert not native[:n].any() and native[n] == 1.0
        else:
            assert len(native) == len(data) + n
            assert native[0] == float(-n + 1)


def test_delay_not_fused_without_static_optin():
    from futuresdr_tpu_torch.blocks import Delay
    fg = Flowgraph()
    fg.connect(VectorSource(np.zeros(100, np.float32)),
               Delay(np.float32, 5), NullSink(np.float32))
    assert find_native_chains(fg) == []


# ---- each stage kind against the JAX package's actor path ----------------------

def _iq(rng, n):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


def _stage_case(kind):
    """``(build, rtol, atol)``: ``build(B)`` wires the pipe of stage ``kind``
    from ``B``, either package's block module, and returns ``(blocks, sink)``
    in connect order; the tolerances are this file's for that stage."""
    rng = np.random.default_rng(900 + len(kind))
    f32 = rng.standard_normal(12_001).astype(np.float32)
    iq = _iq(rng, 12_001)
    lp = firdes.lowpass(0.2, 64).astype(np.float32)
    if kind == "fir_cf":
        return (lambda B: ([B.VectorSource(iq), B.CopyRand(np.complex64, 333, seed=7),
                            B.Fir(lp, np.complex64)], B.VectorSink(np.complex64)),
                3e-5, 2e-6)
    if kind == "fir_cc":
        ctaps = (firdes.lowpass(0.2, 32) * np.exp(2j * np.pi * 0.05 * np.arange(32))
                 ).astype(np.complex64)
        return (lambda B: ([B.VectorSource(iq), B.CopyRand(np.complex64, 333, seed=7),
                            B.Fir(ctaps, np.complex64)], B.VectorSink(np.complex64)),
                3e-5, 2e-6)
    if kind == "fir_decim":
        taps = firdes.lowpass(0.1, 48).astype(np.float32)
        return (lambda B: ([B.VectorSource(f32), B.Fir(taps, np.float32, decim=4)],
                           B.VectorSink(np.float32)), 2e-5, 1e-6)
    if kind == "resample":
        taps = firdes.lowpass(0.4 / 12, 48).astype(np.float32)
        return (lambda B: ([B.VectorSource(iq), B.CopyRand(np.complex64, 431, seed=9),
                            B.Fir(taps, np.complex64, decim=5, interp=12)],
                           B.VectorSink(np.complex64)), 3e-5, 3e-6)
    if kind == "quad_demod":
        taps = firdes.lowpass(0.15, 64).astype(np.float32)
        return (lambda B: ([B.VectorSource(iq), B.Fir(taps, np.complex64, decim=2),
                            B.QuadratureDemod(gain=0.7)], B.VectorSink(np.float32)),
                2e-4, 1e-5)

    def static(block):
        block.fastchain_static = True
        return block

    if kind == "xlating":
        taps = firdes.lowpass(0.1, 64).astype(np.float32)
        return (lambda B: ([B.VectorSource(iq), B.CopyRand(np.complex64, 513, seed=4),
                            static(B.XlatingFir(taps, decim=5, offset_freq=12e3,
                                                sample_rate=250e3))],
                           B.VectorSink(np.complex64)), 2e-4, 2e-5)
    if kind == "agc":
        quiet = (0.25 * iq).astype(np.complex64)
        return (lambda B: ([B.VectorSource(quiet), B.CopyRand(np.complex64, 601, seed=6),
                            static(B.Agc(np.complex64, reference=1.0,
                                         adjustment_rate=1e-3))],
                           B.VectorSink(np.complex64)), 2e-5, 1e-6)
    if kind == "signal_source":
        return (lambda B: ([static(B.SignalSource("complex", 12_500.0, 250e3,
                                                  amplitude=0.8, offset=0.1)),
                            B.Head(np.complex64, 50_000)], B.VectorSink(np.complex64)),
                1e-6, 1e-6)
    if kind == "delay":
        return (lambda B: ([B.VectorSource(f32), B.CopyRand(np.float32, 333, seed=2),
                            static(B.Delay(np.float32, 137))], B.VectorSink(np.float32)),
                0.0, 0.0)
    assert kind == "throttle"
    return (lambda B: ([B.VectorSource(f32), static(B.Throttle(np.float32, 2e6))],
                       B.VectorSink(np.float32)), 0.0, 0.0)


@pytest.mark.parametrize("kind", ["fir_cf", "fir_cc", "fir_decim", "resample",
                                  "quad_demod", "xlating", "agc", "signal_source",
                                  "delay", "throttle"])
def test_each_stage_kind_fused_is_held_to_the_jax_actor_path(monkeypatch, kind):
    """One pipe per native stage kind (``FC_FIR_CF``, ``FC_FIR_CC``, the
    decimating FIR, ``FC_RESAMPLE``, ``FC_QUAD_DEMOD``, ``FC_XLATING``,
    ``FC_AGC``, ``FC_SIG``, ``FC_DELAY``, ``FC_THROTTLE``): fused natively on
    the port, it gives the JAX package's actor path on the same input, at
    this file's tolerance for that stage (copy-class stages bit for bit)."""
    import futuresdr_tpu as J
    from futuresdr_tpu import blocks as jblocks
    from futuresdr_tpu.runtime.fastchain import find_native_chains as j_find
    from futuresdr_tpu_torch import blocks as tblocks
    build, rtol, atol = _stage_case(kind)

    def run(pkg, B, find):
        chain, snk = build(B)
        fg = pkg.Flowgraph()
        fg.connect(*chain, snk)
        fused = len(find(fg))
        pkg.Runtime().run(fg)
        return fg, snk, fused

    with monkeypatch.context() as m:
        m.setenv("FSDR_NO_FASTCHAIN", "1")
        _, jsnk, jfused = run(J, jblocks, j_find)
    import futuresdr_tpu_torch as T
    fg, snk, fused = run(T, tblocks, find_native_chains)
    assert (jfused, fused) == (0, 1)
    assert fg.wrapped(snk).metrics()["fused_native"] is True
    got, want = snk.items(), jsnk.items()
    assert len(got) == len(want) > 0
    if rtol == atol == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
