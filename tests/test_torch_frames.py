"""The port's device-frame plane on the CPU: ``TpuH2D → TpuStage* → TpuD2H``.

The five cases of ``tests/test_tpu_frames.py`` on the port (two stage blocks
against scipy's ``lfilter`` at the reference's rtol 1e-3 / atol 1e-4, a
spectrum's tone bin, ``connect`` dispatching on the port kind, a serial
``read_ahead=0`` drain, ``parse_ctrl``'s scalars), and the frame-plane
spectrum chain (``fir_stage`` 64 taps → ``fft_stage`` → |x|²) against the JAX
package's flowgraph on the same seeded input, at
``tests/test_torch_stages.py``'s chain tolerance (rtol 1e-3 / atol 1e-2). The
frame plane's own contracts follow: a ``TpuStage``'s ``ctrl`` retune queued
before the first frame, a merge's tags riding ``in0`` and its EOS as
``Combine``'s, tags rebased through a decimating stage, the in-place
ports' counters, and the byte tally of ``ops/xfer.py``. Every flowgraph runs
per hop (``FSDR_NO_DEVCHAIN=1``) except where a case says otherwise; fused
runs are ``tests/test_torch_devchain*.py``'s.
"""

import asyncio
import os

import numpy as np
import pytest
import torch
from scipy import signal as sps

from futuresdr_tpu_torch import Flowgraph, Kernel, Runtime
from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
from futuresdr_tpu_torch.dsp import firdes
from futuresdr_tpu_torch.ops import (add_merge_stage, concat_merge_stage, fft_stage,
                                     fir_stage, mag2_stage, rotator_stage, xfer)
from futuresdr_tpu_torch.runtime.flowgraph import ConnectError
from futuresdr_tpu_torch.runtime.tag import Tag
from futuresdr_tpu_torch.tpu import TpuD2H, TpuH2D, TpuInstance, TpuMergeStage, TpuStage
from futuresdr_tpu_torch.types import Pmt

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

CPU = TpuInstance("cpu")


@pytest.fixture(autouse=True)
def _per_hop(monkeypatch):
    monkeypatch.setenv("FSDR_NO_DEVCHAIN", "1")


def test_h2d_stage_d2h_pipeline():
    """Two separate device stages; the frame between them stays a tensor."""
    taps = firdes.lowpass(0.2, 64).astype(np.float32)
    data = np.random.default_rng(0).standard_normal(200_000).astype(np.float32)
    frame = 16384
    fg = Flowgraph()
    src = VectorSource(data)
    h2d = TpuH2D(np.float32, frame_size=frame, inst=CPU)
    s1 = TpuStage([fir_stage(taps, fft_len=1024)], np.float32, inst=CPU)
    s2 = TpuStage([fir_stage(taps, fft_len=1024)], np.float32, inst=CPU)
    d2h = TpuD2H(np.float32, inst=CPU)
    snk = VectorSink(np.float32)
    fg.connect_stream(src, "out", h2d, "in")
    fg.connect_inplace(h2d, "out", s1, "in")
    fg.connect_inplace(s1, "out", s2, "in")
    fg.connect_inplace(s2, "out", d2h, "in")
    fg.connect_stream(d2h, "out", snk, "in")
    Runtime().run(fg)
    got = snk.items()
    ref = sps.lfilter(taps, 1.0, sps.lfilter(taps, 1.0, data))
    n = (len(data) // frame) * frame
    assert len(got) >= n
    np.testing.assert_allclose(got[:n], ref[:n], rtol=1e-3, atol=1e-4)


def test_frame_pipeline_spectrum():
    frame, n_fft = 8192, 256
    tone = np.exp(1j * 2 * np.pi * 0.2 * np.arange(65536)).astype(np.complex64)
    fg = Flowgraph()
    src = VectorSource(tone)
    h2d = TpuH2D(np.complex64, frame_size=frame, inst=CPU)
    st = TpuStage([fft_stage(n_fft), mag2_stage()], np.complex64, inst=CPU)
    d2h = TpuD2H(np.float32, inst=CPU)
    snk = VectorSink(np.float32)
    fg.connect(src, h2d, st, d2h, snk)
    Runtime().run(fg)
    spec = snk.items()
    assert len(spec) == 65536
    assert np.argmax(spec[:n_fft]) == round(0.2 * n_fft)


def test_plain_connect_dispatches_inplace_edges():
    """``connect`` wires in-place edges where both ports are in-place and
    rejects a stream/in-place mix; ``connect_stream`` refuses in-place ports."""
    taps = firdes.lowpass(0.2, 32).astype(np.float32)
    data = np.random.default_rng(1).standard_normal(65536).astype(np.float32)
    fg = Flowgraph()
    src, snk = VectorSource(data), VectorSink(np.float32)
    h2d = TpuH2D(np.float32, frame_size=16384, inst=CPU)
    st = TpuStage([fir_stage(taps, fft_len=1024)], np.float32, inst=CPU)
    d2h = TpuD2H(np.float32, inst=CPU)
    fg.connect(src, h2d, st, d2h, snk)
    assert len(fg.inplace_edges) == 2 and len(fg.stream_edges) == 2
    Runtime().run(fg)
    got = snk.items()
    assert len(got) == 65536
    np.testing.assert_allclose(got[:1000], np.convolve(data, taps)[:1000],
                               rtol=1e-3, atol=1e-4)
    fg2 = Flowgraph()
    with pytest.raises(ConnectError, match="inplace"):
        fg2.connect_stream(TpuH2D(np.float32, frame_size=1024, inst=CPU), "out",
                           VectorSink(np.float32), "in")
    with pytest.raises(ConnectError, match="port kind"):
        Flowgraph().connect(TpuH2D(np.float32, frame_size=1024, inst=CPU),
                            VectorSink(np.float32))


def test_d2h_read_ahead_zero_is_serial_drain():
    taps = firdes.lowpass(0.25, 32).astype(np.float32)
    data = np.random.default_rng(2).standard_normal(65536).astype(np.float32)
    fg = Flowgraph()
    src, snk = VectorSource(data), VectorSink(np.float32)
    h2d = TpuH2D(np.float32, frame_size=8192, inst=CPU)
    st = TpuStage([fir_stage(taps, fft_len=1024)], np.float32, inst=CPU)
    d2h = TpuD2H(np.float32, read_ahead=0, inst=CPU)
    assert d2h.read_ahead == 1          # 0 clamps to the least bound that progresses
    fg.connect(src, h2d, st, d2h, snk)
    Runtime().run(fg)
    got = snk.items()
    assert len(got) == 65536
    np.testing.assert_allclose(got[:4096], np.convolve(data, taps)[:4096],
                               rtol=1e-3, atol=1e-4)


def test_parse_ctrl_preserves_int_bool_str():
    from futuresdr_tpu_torch.tpu.frames import parse_ctrl
    stage, params = parse_ctrl(Pmt.map({
        "stage": Pmt.string("st"), "phase_inc": Pmt.f64(0.25), "count": Pmt.u64(7),
        "enable": Pmt.bool_(True), "mode": Pmt.string("soft")}))
    assert stage == "st"
    assert params["phase_inc"] == 0.25 and type(params["phase_inc"]) is float
    assert params["count"] == 7 and isinstance(params["count"], int) \
        and not isinstance(params["count"], bool)
    assert params["enable"] is True and params["mode"] == "soft"


def test_spectrum_frame_plane_matches_jax_flowgraph():
    """``TpuH2D → TpuStage[fir 64] → TpuStage[fft 256] → TpuStage[|x|²] →
    TpuD2H`` on the port against the same flowgraph of the JAX package."""
    import futuresdr_tpu as jfs
    from futuresdr_tpu import blocks as jblocks
    from futuresdr_tpu import tpu as jtpu
    from futuresdr_tpu.ops import stages as J

    taps = firdes.lowpass(0.2, 64).astype(np.float32)
    frame, n = 4096, 3 * 4096 + 1000
    rng = np.random.default_rng(5)
    data = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)

    def build(fgm, blk, tpum, stages, **kw):
        fg = fgm.Flowgraph()
        src, snk = blk.VectorSource(data), blk.VectorSink(np.float32)
        h2d = tpum.TpuH2D(np.complex64, frame_size=frame, **kw)
        sts = [tpum.TpuStage([s], np.complex64, **kw)
               for i, s in enumerate(stages)]
        d2h = tpum.TpuD2H(np.float32, **kw)
        fg.connect_stream(src, "out", h2d, "in")
        prev = h2d
        for st in sts:
            fg.connect_inplace(prev, "out", st, "in")
            prev = st
        fg.connect_inplace(prev, "out", d2h, "in")
        fg.connect_stream(d2h, "out", snk, "in")
        return fg, snk

    jfg, jsnk = build(jfs, jblocks, jtpu, [J.fir_stage(taps, fft_len=512),
                                           J.fft_stage(256), J.mag2_stage()])
    jfs.Runtime().run(jfg)
    import futuresdr_tpu_torch as tfs
    from futuresdr_tpu_torch import blocks as tblocks
    from futuresdr_tpu_torch import tpu as ttpu
    tfg, tsnk = build(tfs, tblocks, ttpu, [fir_stage(taps, fft_len=512), fft_stage(256),
                                           mag2_stage()], inst=CPU)
    Runtime().run(tfg)
    a, b = jsnk.items(), tsnk.items()
    assert a.shape == b.shape == (3 * 4096 + 768,)
    np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-2)


# ---------------------------------------------------------------------------
# the frame plane's own contracts
# ---------------------------------------------------------------------------

TAG_AT = [5, 4099, 10_000]


class TaggedRampSource(Kernel):
    """A ramp whose chosen absolute indices carry a tag with their index."""

    def __init__(self, n, dtype=np.complex64):
        super().__init__()
        self.n, self._pos = n, 0
        self.output = self.add_stream_output("out", dtype)

    async def work(self, io, mio, meta):
        out = self.output.slice()
        k = min(len(out), self.n - self._pos)
        if k:
            out[:k] = np.arange(self._pos, self._pos + k)
            for a in TAG_AT:
                if self._pos <= a < self._pos + k:
                    self.output.add_tag(a - self._pos, Tag("usize", a, "mark"))
            self.output.produce(k)
            self._pos += k
        if self._pos >= self.n:
            io.finished = True
        elif k:
            io.call_again = True


class TagRecordingSink(Kernel):
    """Records ``(absolute index, tag)`` as items arrive."""

    def __init__(self, dtype):
        super().__init__()
        self.input = self.add_stream_input("in", dtype)
        self.n_received, self.seen = 0, []

    async def work(self, io, mio, meta):
        n = self.input.available()
        if n:
            for t in self.input.tags(n):
                self.seen.append((self.n_received + t.index, t.tag))
            self.input.consume(n)
            self.n_received += n
        if self.input.finished() and self.input.available() == 0:
            io.finished = True


def test_tags_rebase_through_a_decimating_stage():
    taps = firdes.lowpass(0.2, 32).astype(np.float32)
    n = 3 * 4096
    fg = Flowgraph()
    src = TaggedRampSource(n)
    h2d = TpuH2D(np.complex64, frame_size=4096, inst=CPU)
    st1 = TpuStage([fir_stage(taps, decim=4)], np.complex64, inst=CPU)
    st2 = TpuStage([mag2_stage()], np.complex64, inst=CPU)
    d2h = TpuD2H(np.float32, inst=CPU)
    snk = TagRecordingSink(np.float32)
    fg.connect(src, h2d, st1, st2, d2h, snk)
    Runtime().run(fg)
    assert snk.n_received == n // 4
    assert {t.value: i for i, t in snk.seen} == {a: a // 4 for a in TAG_AT}


def test_stage_ctrl_before_the_first_frame_is_applied_at_compile():
    """A retune queued before the carry exists lands on the first frame; a
    bad stage name is rejected at once."""
    taps, taps2 = (firdes.lowpass(c, 32).astype(np.float32) for c in (0.2, 0.05))
    data = np.random.default_rng(3).standard_normal(3 * 4096).astype(np.float32)
    fg = Flowgraph()
    src, snk = VectorSource(data), VectorSink(np.float32)
    h2d = TpuH2D(np.float32, frame_size=4096, inst=CPU)
    st = TpuStage([fir_stage(taps, fft_len=1024, name="f")], np.float32, inst=CPU)
    d2h = TpuD2H(np.float32, inst=CPU)
    fg.connect(src, h2d, st, d2h, snk)
    bad = asyncio.run(st.ctrl_handler(None, st.mio, st.meta,
                                      Pmt.map({"stage": "nope", "taps": taps2.tolist()})))
    assert bad == Pmt.invalid_value() and not st._pending_ctrl
    res = asyncio.run(st.ctrl_handler(None, st.mio, st.meta,
                                      Pmt.map({"stage": "f", "taps": taps2.tolist()})))
    assert res == Pmt.ok() and st._pending_ctrl
    Runtime().run(fg)
    np.testing.assert_allclose(snk.items(), sps.lfilter(taps2, 1.0, data),
                               rtol=1e-3, atol=1e-4)


def test_merge_tags_ride_in0_and_eos_follows_combine():
    """``in0`` carries the tags (rebased through the merge), ``in1``'s copies
    are dropped; the shorter input ends the merge."""
    n = 3 * 4096
    fg = Flowgraph()
    src = TaggedRampSource(n)
    h2d = TpuH2D(np.complex64, frame_size=4096, inst=CPU)
    a = TpuStage([rotator_stage(0.0)], np.complex64, inst=CPU)
    b = TpuStage([rotator_stage(0.0)], np.complex64, inst=CPU)
    mg = TpuMergeStage(add_merge_stage(2), [mag2_stage()], inst=CPU)
    d2h = TpuD2H(np.float32, inst=CPU)
    snk = TagRecordingSink(np.float32)
    fg.connect_stream(src, "out", h2d, "in")
    fg.connect_inplace(h2d, "out", a, "in")
    fg.connect_inplace(h2d, "out", b, "in")
    fg.connect_inplace(a, "out", mg, "in0")
    fg.connect_inplace(b, "out", mg, "in1")
    fg.connect_inplace(mg, "out", d2h, "in")
    fg.connect_stream(d2h, "out", snk, "in")
    Runtime().run(fg)
    assert snk.n_received == n
    assert sorted((i, t.value) for i, t in snk.seen) == [(x, x) for x in TAG_AT]
    m = fg.wrapped(mg).metrics()
    assert m["items_in"] == {"in0": n, "in1": n} and m["dispatches"] == 3


def test_concat_merge_emits_full_frames_only():
    """A partial EOS frame has no valid-prefix form under a concat: the
    merge emits the full frames and drops the tail."""
    n = 2 * 4096 + 1000
    data = np.arange(n).astype(np.complex64)
    fg = Flowgraph()
    src, snk = VectorSource(data), VectorSink(np.complex64)
    h2d = TpuH2D(np.complex64, frame_size=4096, inst=CPU)
    a = TpuStage([rotator_stage(0.0)], np.complex64, inst=CPU)
    b = TpuStage([fir_stage(np.array([1.0, 0.0], np.float32), decim=4)],
                 np.complex64, inst=CPU)
    mg = TpuMergeStage(concat_merge_stage(2), inst=CPU)
    d2h = TpuD2H(np.complex64, inst=CPU)
    fg.connect_stream(src, "out", h2d, "in")
    fg.connect_inplace(h2d, "out", a, "in")
    fg.connect_inplace(h2d, "out", b, "in")
    fg.connect_inplace(a, "out", mg, "in0")
    fg.connect_inplace(b, "out", mg, "in1")
    fg.connect_inplace(mg, "out", d2h, "in")
    fg.connect_stream(d2h, "out", snk, "in")
    Runtime().run(fg)
    got = snk.items()
    assert len(got) == 2 * (4096 + 1024)
    np.testing.assert_allclose(got[:4096], data[:4096], atol=1e-3)
    np.testing.assert_allclose(got[4096:5120], data[:4096:4], atol=1e-3)


def test_wire_formats_wait_for_the_host_data_path():
    """The host data path is in: both blocks take every wire format (None
    and ``auto`` resolve to f32 on the CPU), and an unknown one raises."""
    for name in ("f32", "bf16", "sc16", "sc8"):
        assert TpuH2D(np.float32, 1024, inst=CPU, wire=name).wire.name == name
        assert TpuD2H(np.float32, inst=CPU, wire=name).wire.name == name
    assert TpuH2D(np.float32, 1024, inst=CPU).wire.name == "f32"
    assert TpuD2H(np.float32, inst=CPU, wire="auto").wire.name == "f32"
    with pytest.raises(KeyError, match="unknown wire format"):
        TpuH2D(np.float32, 1024, inst=CPU, wire="sc12")


def test_xfer_byte_tally_counts_each_direction():
    xfer.reset_bytes()
    data = np.zeros(4 * 4096, np.complex64)
    fg = Flowgraph()
    src, snk = VectorSource(data), VectorSink(np.float32)
    h2d = TpuH2D(np.complex64, frame_size=4096, inst=CPU)
    st = TpuStage([fir_stage(firdes.lowpass(0.2, 32).astype(np.float32), decim=4),
                   mag2_stage()], np.complex64, inst=CPU)
    d2h = TpuD2H(np.float32, inst=CPU)
    fg.connect(src, h2d, st, d2h, snk)
    Runtime().run(fg)
    assert xfer.bytes_total == {"h2d": 4 * 4096 * 8, "d2h": 4 * 1024 * 4}
    xfer.reset_bytes()
    assert xfer.bytes_total == {"h2d": 0, "d2h": 0}
    assert os.environ["FSDR_NO_DEVCHAIN"] == "1"
