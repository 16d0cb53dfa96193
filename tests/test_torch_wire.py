"""The port's wire codecs (``ops/wire.py``) and transfer plane (``ops/xfer.py``)
against the JAX package's, on the CPU.

Per wire, on seeded numpy frames: the host encode's payload and scale are the
reference's bit for bit (complex64 and float32, non-finite samples, an
all-zero frame, integer passthrough); ``decode_torch`` equals ``decode_jax``
and ``decode_host`` bit for bit; ``encode_torch`` equals the port's own
``encode_host`` bit for bit and ``encode_jax`` within one payload LSB (XLA:CPU
divides ``qmax / scale`` in float32, numpy and the port in float64). Then the
reference's ``tests/test_wire.py`` contracts on the port: measured SNR floors,
byte widths, ``resolve_wire`` (``auto`` is f32 on the CPU and sc16 on a card)
and its environment name, the link ceiling; ``PackedLayout`` with the JAX
package's offsets and ``unpack_torch`` against ``unpack_jax``; the wired
program (``Pipeline.compile(wire=…)``) at K = 1 and 4, one scale a frame, and
packed against per part; ``TpuH2D``/``TpuD2H`` per wire against the JAX
frame plane; the transfers' round trips, the fake link, the retry policy and
the classification of CUDA's sticky errors as fatal.
"""

import time

import numpy as np
import pytest
import torch

import futuresdr_tpu as jfs
from futuresdr_tpu import blocks as jblocks
from futuresdr_tpu.ops import stages as J
from futuresdr_tpu.ops import wire as JW
from futuresdr_tpu.ops import xfer as JX
from futuresdr_tpu.tpu import TpuD2H as JD2H
from futuresdr_tpu.tpu import TpuH2D as JH2D
from futuresdr_tpu.tpu import TpuStage as JStage
from futuresdr_tpu_torch import Flowgraph, Runtime
from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
from futuresdr_tpu_torch.config import config, reload_config
from futuresdr_tpu_torch.dsp import firdes
from futuresdr_tpu_torch.ops import stages as T
from futuresdr_tpu_torch.ops import wire as W
from futuresdr_tpu_torch.ops import xfer
from futuresdr_tpu_torch.runtime import faults
from futuresdr_tpu_torch.tpu import TpuD2H, TpuH2D, TpuInstance, TpuStage

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

WIRES = ["f32", "bf16", "sc16", "sc8"]
QUANT = ["sc16", "sc8"]
CPU = TpuInstance("cpu")
# the reference's measured floors (tests/test_wire.py:56)
SNR_FLOORS = {"f32": float("inf"), "bf16": 35.0, "sc16": 80.0, "sc8": 38.0}


def _c64(n, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            * (scale / np.sqrt(2))).astype(np.complex64)


def _frames():
    """Seeded frames: complex64, float32, with non-finite samples, all zero."""
    c = _c64(4096, seed=1, scale=3.0)
    f = np.random.default_rng(2).standard_normal(4096).astype(np.float32)
    bad = _c64(2048, seed=3)
    bad[[5, 77, 900]] = [np.nan, np.inf + 1j, -np.inf * 1j]
    return {"c64": c, "f32": f, "nonfinite": bad, "zero": np.zeros(1024, np.complex64)}


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


def _t(parts):
    return tuple(torch.from_numpy(np.array(p)) for p in parts)


# ---------------------------------------------------------------------------
# the codecs against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", WIRES)
def test_encode_host_bit_equal_to_the_reference(name):
    w, jw = W.get_wire(name), JW.get_wire(name)
    for label, x in _frames().items():
        got, want = w.encode_host(x), jw.encode_host(x)
        assert len(got) == len(want) == w.part_count(x.dtype), label
        for g, r in zip(got, want):
            assert np.shape(g) == np.shape(r), label
            np.testing.assert_array_equal(_bits(g), _bits(r), err_msg=f"{name} {label}")
    ints = np.arange(300, dtype=np.int32)
    (p,) = w.encode_host(ints)
    np.testing.assert_array_equal(p, ints)            # passthrough


@pytest.mark.parametrize("name", WIRES)
def test_decode_torch_bit_equal_to_decode_jax_and_host(name):
    import ml_dtypes
    w, jw = W.get_wire(name), JW.get_wire(name)
    for label, x in _frames().items():
        parts = w.encode_host(x)
        got = w.decode_torch(_t(parts), x.dtype).numpy()
        jparts = tuple(np.asarray(p).view(ml_dtypes.bfloat16) if name == "bf16" else p
                       for p in parts)
        want = np.asarray(jw.decode_jax(jparts, x.dtype))
        host = w.decode_host(parts, x.dtype)
        assert got.dtype == want.dtype == host.dtype
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=f"{name} {label}")
        np.testing.assert_array_equal(_bits(got), _bits(host), err_msg=f"{name} {label}")


@pytest.mark.parametrize("name", WIRES)
def test_encode_torch_against_host_twin_and_encode_jax(name):
    w, jw = W.get_wire(name), JW.get_wire(name)
    for label, x in _frames().items():
        got = w.encode_torch(torch.from_numpy(x))
        host = w.encode_host(x)
        want = jw.encode_jax(torch.from_numpy(x).numpy())
        finite = np.isfinite(x.view(np.float32)) if np.iscomplexobj(x) else np.isfinite(x)
        for g, h, r in zip(got, host, want):
            g, h, r = g.numpy(), np.asarray(h), np.asarray(r)
            if name == "bf16":
                # NaN's bits are the device's own; every finite value rounds
                # to nearest even on all three
                r = r.view(np.int16)
                keep = finite.reshape(g.shape)
                np.testing.assert_array_equal(g[keep], h[keep])
                np.testing.assert_array_equal(g[keep], r[keep])
                continue
            np.testing.assert_array_equal(_bits(g), _bits(h), err_msg=f"{name} {label}")
            if name in QUANT and g.dtype != np.float32:
                lsb = np.abs(g.astype(np.int32) - r.astype(np.int32)).max()
                assert lsb <= 1, (name, label, lsb)
            else:
                np.testing.assert_array_equal(_bits(g), _bits(r), err_msg=f"{name} {label}")


@pytest.mark.parametrize("name", QUANT)
def test_quant_nonfinite_zeroed_and_zero_frame_scale(name):
    w = W.get_wire(name)
    x = _frames()["nonfinite"]
    for q, scale in (w.encode_host(x), tuple(t.numpy() for t in w.encode_torch(torch.from_numpy(x)))):
        y = w.decode_host((q, scale), np.complex64).view(np.float32)
        xv = x.view(np.float32)
        fin = np.isfinite(xv)                      # component by component
        assert np.isfinite(y).all()
        assert float(np.asarray(scale)) == float(np.max(np.abs(xv[fin])))
        assert (y[~fin] == 0).all()
    for parts in (w.encode_host(np.zeros(64, np.complex64)),
                  w.encode_torch(torch.zeros(64, dtype=torch.complex64))):
        assert float(np.asarray(parts[1])) == 1.0      # peak 0 -> scale 1
        assert not np.asarray(parts[0]).any()


@pytest.mark.parametrize("name", WIRES)
def test_measured_snr_floor_and_round_trip(name):
    assert W.measure_snr_db(name) >= SNR_FLOORS[name]
    assert W.measure_snr_db(name) == JW.measure_snr_db(name)
    assert W.measure_snr_db(name, np.int32) == float("inf")
    x = _c64(1024, seed=4)
    y = W.get_wire(name).decode_host(W.get_wire(name).encode_host(x), np.complex64)
    assert y.dtype == np.complex64 and y.shape == x.shape
    e = W.get_wire(name).encode_host(np.empty(0, np.complex64))
    assert W.get_wire(name).decode_host(e, np.complex64).shape == (0,)


def test_bytes_part_counts_resolve_and_ceiling(monkeypatch):
    for name in WIRES:
        w, jw = W.get_wire(name), JW.get_wire(name)
        for dt in (np.complex64, np.float32, np.int32):
            assert w.bytes_per_sample(dt) == jw.bytes_per_sample(dt)
            assert w.part_count(dt) == jw.part_count(dt)
            assert w.encode_may_alias(dt) == jw.encode_may_alias(dt)
        assert W.streamed_ceiling_msps(name, 96e6, 62e6) == \
            JW.streamed_ceiling_msps(name, 96e6, 62e6)
    with pytest.raises(KeyError, match="unknown wire format"):
        W.get_wire("sc4")
    assert W.get_wire(W.WIRE_FORMATS["sc16"]) is W.WIRE_FORMATS["sc16"]
    assert W.resolve_wire("auto", "cpu").name == "f32"
    assert W.resolve_wire("auto", "cuda").name == "sc16"
    assert W.resolve_wire(None, "cpu").name == "f32"
    assert W.resolve_wire(None, "cuda").name == "sc16"
    monkeypatch.setenv("FUTURESDR_TPU_WIRE_FORMAT", "sc8")   # the reference's name
    try:
        reload_config()
        assert W.resolve_wire(None, "cpu").name == "sc8"
        monkeypatch.setenv("FUTURESDR_TPU_TPU_WIRE_FORMAT", "bf16")
        monkeypatch.setenv("FUTURESDR_TPU_XFER_BACKOFF", "0.25")
        reload_config()
        assert W.resolve_wire(None, "cpu").name == "bf16"
        assert config().xfer_backoff == 0.25
    finally:
        monkeypatch.delenv("FUTURESDR_TPU_WIRE_FORMAT")
        monkeypatch.delenv("FUTURESDR_TPU_TPU_WIRE_FORMAT")
        monkeypatch.delenv("FUTURESDR_TPU_XFER_BACKOFF")
        reload_config()
    c = config()
    assert (c.tpu_wire_format, c.tpu_coalesce, c.tpu_zero_copy_ingest,
            c.tpu_deferred_consume, c.tpu_adaptive_wire, c.tpu_wire_snr_budget_db,
            c.host_codec_workers, c.xfer_retries, c.xfer_backoff, c.xfer_deadline) == \
        ("auto", True, True, True, False, 40.0, 2, 3, 0.005, 30.0)


# ---------------------------------------------------------------------------
# the coalesced layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", WIRES)
@pytest.mark.parametrize("k", [1, 4])
def test_packed_layout_matches_the_reference(name, k):
    lay = xfer.PackedLayout.probe(W.get_wire(name), 1000, np.complex64, k=k)
    ref = JX.PackedLayout.probe(JW.get_wire(name), 1000, np.complex64, k=k)
    if name in ("f32", "bf16"):
        assert lay is None and ref is None     # one part: nothing to coalesce
        return
    assert lay.nbytes == ref.nbytes
    assert [(s, o, n) for s, _d, o, n in lay.slots] == [(s, o, n) for s, _d, o, n in ref.slots]
    assert all(off % lay.ALIGN == 0 for _s, _d, off, _n in lay.slots)
    w = W.get_wire(name)
    frames = [_c64(1000, seed=10 + i, scale=10.0 ** -i) for i in range(k)]
    enc = [w.encode_host(f) for f in frames]
    parts = [np.stack([np.asarray(e[j]) for e in enc]) if k > 1 else np.asarray(enc[0][j])
             for j in range(2)]
    buf = lay.pack(parts, np.full(lay.nbytes, 0xAB, np.uint8))
    jbuf = ref.pack(parts, np.full(ref.nbytes, 0xCD, np.uint8))
    np.testing.assert_array_equal(buf, jbuf)               # gaps zeroed alike
    got = lay.unpack_torch(torch.from_numpy(buf))
    want = ref.unpack_jax(jbuf)
    for g, r, p in zip(got, want, parts):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(np.asarray(r)))
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(p))


# ---------------------------------------------------------------------------
# the wired program
# ---------------------------------------------------------------------------

TAPS = firdes.lowpass(0.2, 64).astype(np.float32)


def _spectrum(m):
    return [m.fir_stage(TAPS, fft_len=512), m.fft_stage(256), m.mag2_stage()]


@pytest.mark.parametrize("name", WIRES)
@pytest.mark.parametrize("k", [1, 4])
def test_wired_program_is_decode_chain_encode_one_scale_a_frame(name, k):
    """``compile(wire=…)`` equals the host encode, the device decode, the
    chain and the device encode done by hand frame by frame (each frame its
    own peak: the frames here are 60 dB apart), and the packed program
    equals the per-part one bit for bit."""
    w = W.get_wire(name)
    pipe = T.Pipeline(_spectrum(T), np.complex64)
    frame = 1024
    xs = [_c64(frame, seed=20 + i, scale=10.0 ** (-i)) for i in range(2 * k)]
    lay = xfer.PackedLayout.probe(w, frame, np.complex64, k=k)
    fn, carry = pipe.compile(frame, "cpu", k=k, wire=w)
    pfn, pcarry = pipe.compile(frame, "cpu", k=k, wire=w, packed=lay) if lay else (None, None)
    ref_fn, ref_carry = pipe.fn(), pipe.init_carry("cpu")
    for d in range(2):
        group = xs[d * k:(d + 1) * k]
        enc = [w.encode_host(x) for x in group]
        parts = [np.stack([np.asarray(e[j]) for e in enc]) if k > 1 else np.asarray(enc[0][j])
                 for j in range(len(enc[0]))]
        carry, y = fn(carry, _t(parts))
        if pfn is not None:
            buf = lay.pack(parts, np.empty(lay.nbytes, np.uint8))
            pcarry, py = pfn(pcarry, (torch.from_numpy(buf),))
            for a, b in zip(y, py):
                assert torch.equal(a, b)
        for i, e in enumerate(enc):
            ref_carry, yi = ref_fn(ref_carry, w.decode_torch(_t(e), np.complex64))
            want = w.encode_torch(yi)
            for a, b in zip(y, want):
                got = a[i] if k > 1 else a
                assert torch.equal(got, b), (name, k, d, i)


# ---------------------------------------------------------------------------
# the frame plane per wire against the reference's
# ---------------------------------------------------------------------------

def _frame_plane(mods, wire, data, frame):
    fg_cls, rt_cls, src_cls, snk_cls, h2d_cls, st_cls, d2h_cls, m, kw = mods
    fg = fg_cls()
    src, snk = src_cls(data), snk_cls(np.float32)
    h2d = h2d_cls(np.float32, frame_size=frame, wire=wire, **kw)
    st = st_cls([m.fir_stage(TAPS, fft_len=1024)], np.float32, **kw)
    d2h = d2h_cls(np.float32, wire=wire, **kw)
    fg.connect(src, h2d, st, d2h, snk)
    rt_cls().run(fg)
    return snk.items()


@pytest.mark.parametrize("name", WIRES)
def test_frame_plane_per_wire_matches_jax(name, monkeypatch):
    monkeypatch.setenv("FSDR_NO_DEVCHAIN", "1")
    data = np.random.default_rng(10).standard_normal(5 * 4096 + 1024).astype(np.float32)
    port = (Flowgraph, Runtime, VectorSource, VectorSink, TpuH2D, TpuStage, TpuD2H, T,
            {"inst": CPU})
    ref = (jfs.Flowgraph, jfs.Runtime, jblocks.VectorSource, jblocks.VectorSink, JH2D,
           JStage, JD2H, J, {})
    got = _frame_plane(port, name, data, 4096)
    want = _frame_plane(ref, name, data, 4096)
    assert len(got) == len(want) == len(data)
    peak = float(np.abs(want).max())
    lsb = {"f32": 0.0, "bf16": 2.0 ** -7, "sc16": 1 / 32767, "sc8": 1 / 127}[name] * peak
    # the chain's tolerance (tests/test_torch_stages.py) plus two LSB of the wire
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 + 2 * lsb)


# ---------------------------------------------------------------------------
# transfers: round trips, the fake link, retries
# ---------------------------------------------------------------------------

@pytest.fixture
def no_faults():
    yield
    xfer.set_fake_link()
    faults.reset()


def test_to_device_to_host_round_trip_bit_exact():
    x = _c64(4096, seed=7)
    x[7] = np.float32(1e-38) + 1j * np.float32(-1e38)
    y = xfer.to_host(xfer.to_device(x, "cpu"))
    np.testing.assert_array_equal(y.view(np.uint64), x.view(np.uint64))
    strided = _c64(4096, seed=8)[::3]
    np.testing.assert_array_equal(xfer.to_host(xfer.to_device(strided, "cpu")), strided)
    assert xfer.to_host(xfer.to_device(np.empty(0, np.complex64), "cpu")).shape == (0,)
    xfer.reset_bytes()
    fin = xfer.start_device_transfer_parts((np.zeros((4, 8), np.int16), np.ones(4, np.float32)),
                                           "cpu")
    a, b = fin()
    assert a.shape == (4, 8) and b.dtype == torch.float32
    assert xfer.starts_total == {"h2d": 2, "d2h": 0}
    assert xfer.bytes_total == {"h2d": 4 * 8 * 2 + 16, "d2h": 0}


def test_fake_link_throttles_and_restores(no_faults):
    payload = np.zeros(1 << 18, np.float32)          # 1 MiB
    xfer.set_fake_link(64e6, 64e6)                   # >= ~16 ms a crossing
    t0 = time.perf_counter()
    y = xfer.to_device(payload, "cpu")
    up = time.perf_counter() - t0
    t0 = time.perf_counter()
    xfer.to_host(y)
    down = time.perf_counter() - t0
    assert up >= 0.014 and down >= 0.014
    xfer.set_fake_link()
    t0 = time.perf_counter()
    xfer.to_host(xfer.to_device(payload, "cpu"))
    assert time.perf_counter() - t0 < 0.014


def test_retries_count_and_exhausted_budget_raises(no_faults, monkeypatch):
    monkeypatch.setattr(config(), "xfer_backoff", 0.0001)
    xfer.reset_bytes()
    faults.arm("h2d", rate=1.0, seed=1, max_faults=2)
    got = xfer.to_device(np.arange(8, dtype=np.float32), "cpu")
    np.testing.assert_array_equal(got.numpy(), np.arange(8, dtype=np.float32))
    assert xfer.retries_total["h2d"] == 2
    faults.reset()
    faults.arm("d2h", rate=1.0, seed=1)              # no cap: every attempt fails
    with pytest.raises(xfer.TransferError, match="retry budget"):
        xfer.to_host(torch.zeros(4))
    assert xfer.retries_total["d2h"] == config().xfer_retries
    faults.reset()
    xfer.set_fake_link(fault_rate=0.2, fault_seed=3)
    for _ in range(8):
        xfer.to_host(xfer.to_device(np.ones(4, np.float32), "cpu"))
    fired = xfer.fake_link().faults
    assert fired["h2d"] + fired["d2h"] > 0


def test_classify_transfer_error_cuda_sticky_errors_are_fatal():
    """CUDA's sticky errors leave the context unusable: never retried, even
    where their text holds a transient marker. Both packages agree on the
    reference's cases."""
    sticky = ["CUDA error: an illegal memory access was encountered",
              "CUDA error: unspecified launch failure",
              "CUDA error: device-side assert triggered",
              "CUDA error: the launch timed out and was terminated",
              "CUDA error: misaligned address", "CUDA error: an illegal instruction was "
              "encountered", "CUDA error: uncorrectable ECC error encountered"]
    for msg in sticky:
        assert not xfer.classify_transfer_error(RuntimeError(msg)), msg
    shared = [(RuntimeError("UNAVAILABLE: socket closed"), True),
              (RuntimeError("connection reset by peer"), True),
              (RuntimeError("shape mismatch"), False),
              (xfer.TransferError("x"), False)]
    for e, want in shared:
        assert xfer.classify_transfer_error(e) is want
        assert JX.classify_transfer_error(e) is want
    assert xfer.classify_transfer_error(xfer.FakeLinkFault("x"))
    try:
        faults.arm("link", rate=1.0, seed=0, max_faults=1)
        with pytest.raises(faults.InjectedFault) as ei:
            faults.maybe("link")
        assert xfer.classify_transfer_error(ei.value)      # transient site
        faults.arm("dispatch", rate=1.0, seed=0, max_faults=1)
        with pytest.raises(faults.InjectedFault) as ei:
            faults.maybe("dispatch")
        assert not xfer.classify_transfer_error(ei.value)
    finally:
        faults.reset()


def test_fault_plan_spec_and_seeded_sites_match_the_reference(monkeypatch):
    from futuresdr_tpu.runtime import faults as jfaults
    spec = "seed=42;work:TpuKernel_1@0.3;h2d@0.25@2"
    mine, ref = faults.FaultPlan(spec), jfaults.FaultPlan(spec)
    for plan in (mine, ref):
        assert plan.armed() and plan.resolve("work", "TpuKernel_1") is not None
        assert plan.resolve("work", "other") is None and plan.resolve("h2d") is not None
    draws = []
    for plan in (mine, ref):
        seq = []
        for _ in range(40):
            for site, name in (("work", "TpuKernel_1"), ("h2d", None)):
                try:
                    plan.maybe(site, name)
                    seq.append(0)
                except Exception as e:                 # noqa: BLE001
                    seq.append((type(e).__name__, getattr(e, "transient", None)))
        draws.append(seq)
    assert draws[0] == draws[1]
    assert mine.counts() == ref.counts() and mine.counts()["h2d"] == 2
    monkeypatch.setenv(faults.ENV_VAR, "seed=1;d2h@1.0@1")
    try:
        plan = faults.reset(reload_env=True)
        assert plan.resolve("d2h") is not None
    finally:
        monkeypatch.delenv(faults.ENV_VAR)
        faults.reset()
