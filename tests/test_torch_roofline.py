"""Roofline accounting and the marginal rate on the CPU (the port's
counterparts of ``tests/test_measure.py``, on analytic counts instead of
XLA's cost analysis), and each hand kernel's bound at the shapes of
PERF.md §6's kernel table: equal to the table's Bound column (three
significant digits) within 2%."""

import numpy as np
import pytest
import torch

from futuresdr_tpu_torch.dsp import firdes
from futuresdr_tpu_torch.ops import precision as TP
from futuresdr_tpu_torch.ops.stages import (DagPipeline, FanoutPipeline, Pipeline,
                                            add_merge_stage, channelizer_stage, fft_stage,
                                            fir_fft_stage, fir_stage, mag2_stage,
                                            quad_demod_stage, resample_stage,
                                            rotator_stage)
from futuresdr_tpu_torch.utils import roofline as R
from futuresdr_tpu_torch.utils.measure import (default_k_pair, run_marginal,
                                               run_marginal_retry, scaled_k_pair)

torch.set_num_threads(1)

H100 = "NVIDIA H100 80GB HBM3"
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12


def test_run_marginal_positive_rate():
    rng = np.random.default_rng(0)
    pipe = Pipeline([fir_stage(rng.standard_normal(32).astype(np.float32))], np.float32)
    x = torch.from_numpy(rng.standard_normal(1 << 16).astype(np.float32))
    assert run_marginal(pipe.fn(), pipe.init_carry("cpu"), x, k_pair=(4, 64), reps=2) > 0
    assert run_marginal_retry(pipe.fn(), pipe.init_carry("cpu"), x, k_pair=(2, 32)) > 0
    with pytest.raises(ValueError):
        run_marginal(pipe.fn(), pipe.init_carry("cpu"), x, k_pair=(8, 8))
    assert default_k_pair("cpu") == (8, 16)
    lo, hi = scaled_k_pair((8, 16), 1 << 16, "cpu")
    assert lo * (1 << 16) >= 2_000_000 and hi == 2 * lo


def test_pipeline_roofline_accounting():
    stages = [fir_stage(firdes.lowpass(0.2, 64).astype(np.float32)), fft_stage(1024),
              mag2_stage()]
    r = R.pipeline_roofline(stages, np.complex64, 1 << 16, rate_sps=1e6, device="cpu")
    assert [s["name"] for s in r["stages"]] == ["fir", "fft1024", "mag2"]
    assert r["flops_per_sample"] > 50 and r["bytes_per_sample"] >= 12
    total = sum(s["flops_per_sample"] for s in r["stages"])
    assert abs(total - r["flops_per_sample"]) < 1e-6
    assert r["achieved_flops"] == 1e6 * r["flops_per_sample"]
    assert "mfu" not in r                        # no peak on the CPU
    r2 = R.pipeline_roofline(stages, np.complex64, 1 << 16, rate_sps=1e9, chip=H100)
    assert 0 < r2["mfu"] < 1 and "bound" in r2["stages"][0]
    assert r2["stages"][1]["bound"] == "hbm"     # an FFT is far under the ridge


def test_roofline_decimating_stage():
    stages = [fir_stage(firdes.lowpass(0.1, 64).astype(np.float32), decim=4, name="decim4"),
              mag2_stage()]
    r = R.pipeline_roofline(stages, np.complex64, 1 << 16, chip=H100)
    assert [s["name"] for s in r["stages"]] == ["decim4", "mag2"]
    assert all(s["flops_per_sample"] > 0 for s in r["stages"])
    assert r["stages"][0]["flops_per_sample"] > r["stages"][1]["flops_per_sample"]
    # mag2 runs on a quarter of the samples: per chain-input sample
    assert r["stages"][1]["flops_per_sample"] == pytest.approx(3 / 4)
    assert r["stages"][0]["bound"] in ("hbm", "compute")


def test_graph_roofline_fanout_per_node():
    fo = FanoutPipeline([fir_stage(firdes.lowpass(0.2, 32).astype(np.float32), name="prod")],
                        [[mag2_stage()],
                         [fir_stage(firdes.lowpass(0.1, 16).astype(np.float32), decim=4,
                                    name="b1")]], np.complex64)
    r = R.graph_roofline(fo, 1 << 14, rate_sps=1e6, chip=H100)
    assert [(n["name"], n["inputs"]) for n in r["nodes"]] == \
        [("prod", []), ("mag2", [0]), ("b1", [0])]
    total = sum(n["flops_per_sample"] for n in r["nodes"])
    assert abs(total - r["flops_per_sample"]) < 1e-6
    assert 0 < r["mfu"] < 1 and all(n["bound"] in ("hbm", "compute") for n in r["nodes"])
    c = R.cost_of(fo, 1 << 14)
    assert c["flops"] == pytest.approx(r["flops_per_sample"] * (1 << 14))


def test_graph_roofline_dag_diamond():
    taps = firdes.lowpass(0.2, 32).astype(np.float32)
    dag = DagPipeline([([fir_stage(taps, name="prod")], []),
                       ([fir_stage(taps, name="a")], [0]),
                       ([fir_stage(taps, name="b")], [0]),
                       ([add_merge_stage(2), mag2_stage()], [1, 2])], np.complex64)
    r = R.graph_roofline(dag, 1 << 14, device="cpu")
    assert [n["inputs"] for n in r["nodes"]] == [[], [0], [0], [1, 2]]
    assert r["nodes"][3]["name"] == "add_merge+mag2"
    assert r["nodes"][1]["flops_per_sample"] == r["nodes"][2]["flops_per_sample"]
    # the merge: two inputs read, one written, one add an item; then |x|²
    assert r["nodes"][3]["bytes_per_sample"] == pytest.approx(3 * 8 + 8 + 4)
    assert "mfu" not in r


def test_cost_of_signature_cache_reuses_records():
    sig = ("test-cost-cache", id(object()))
    p = Pipeline([mag2_stage()], np.complex64)
    out = R.cost_of(p, 1024, signature=sig)
    assert out == {"flops": 3 * 1024.0, "bytes": 12 * 1024.0}
    assert R.cost_of(None, signature=sig) == out        # a hit reads no pipeline


def test_program_cost_signature_disambiguates_stage_params():
    t64 = firdes.lowpass(0.2, 64).astype(np.float32)
    t256 = firdes.lowpass(0.2, 256).astype(np.float32)
    m = {R._stage_marker(fir_stage(t64)), R._stage_marker(fir_stage(t256)),
         R._stage_marker(fir_stage(t256, decim=4))}
    assert len(m) == 3
    full = R.program_cost(Pipeline([fir_stage(t256)], np.complex64), 1 << 12)
    decim = R.program_cost(Pipeline([fir_stage(t256, decim=4)], np.complex64), 1 << 12)
    assert decim["bytes"] < full["bytes"]
    k2 = R.program_cost(Pipeline([fir_stage(t256)], np.complex64), 1 << 12, k=2)
    assert k2["bytes"] == 2 * full["bytes"]
    wired = R.program_cost(Pipeline([fir_stage(t256)], np.complex64), 1 << 12, wire="sc16")
    assert wired["bytes"] > full["bytes"]


def test_detect_peaks_dtype_keying_and_dominant_dtype():
    assert R.detect_peaks("cpu") is None and R.detect_peaks(chip="Some GPU") is None
    f32 = R.detect_peaks(chip=H100, dtype="f32")
    bf16 = R.detect_peaks(chip=H100, dtype="bf16")
    i8 = R.detect_peaks(chip=H100, dtype="int8")
    assert f32["flops"] == PEAK_F32 and bf16["flops"] == 989e12 and i8["flops"] == 1979e12
    assert f32["hbm_bytes"] == PEAK_BYTES
    p = Pipeline([fir_stage(np.hanning(64).astype(np.float32), fft_len=2048, name="fir"),
                  fft_stage(2048)], np.complex64)
    assert R.dominant_dtype(p.stages) == "f32"
    low, _plan = TP.plan_interior_precision(p, mode="bf16", device="cpu")
    assert R.dominant_dtype(low.stages) == "bf16"
    low8, _plan = TP.plan_interior_precision(p, mode="int8", device="cpu")
    assert TP.dominant_compute_dtype(low8) == "int8"


def _bound_us(nbytes, flops):
    return max(nbytes / PEAK_BYTES, flops / PEAK_F32) * 1e6


# (kernel, its call at the table's shape, the table's Bound in µs)
ROWS = [
    ("fir", dict(n=1 << 18, nt=64), 1.25), ("fir", dict(n=1 << 20, nt=64), 5.01),
    ("fir_fft", dict(n=1 << 18, nt=64, n_fft=2048), 1.26),
    ("fir_fft", dict(n=1 << 20, nt=64, n_fft=2048), 5.01),
    ("rotator", dict(n=512_000), 2.45), ("rotator", dict(n=4_096_000), 19.6),
    ("poly_fir", dict(n=512_000, m=32, D=4), 1.53),
    ("poly_fir", dict(n=128_000, m=2, D=125, I=24, complex=False), 0.275),
    ("poly_fir", dict(n=1_024_000, m=2, D=125, I=24, complex=False), 2.20),
    ("quad_demod", dict(n=128_000), 0.459), ("quad_demod", dict(n=1_024_000), 3.67),
    ("pfb", dict(n=1 << 18, N=64, K=12), 1.25), ("pfb", dict(n=1 << 21, N=64, K=12), 10.0),
    ("pfb", dict(n=1 << 18, N=2048, K=12), 1.34),
    ("pfb_lanes", dict(L=16, n=1 << 18, N=64, K=12), 20.1),
    ("pfb_lanes", dict(L=64, n=1 << 15, N=64, K=12), 10.2),
    ("poly_fir", dict(n=1 << 18, m=8, D=16), 0.666),
    ("viterbi", dict(B=256, T=4096), 9.01), ("viterbi", dict(B=256, T=4096, S=16), 2.82),
]


@pytest.mark.parametrize("kernel,shape,table_us", ROWS)
def test_kernel_bound_equals_the_perf_table(kernel, shape, table_us):
    assert _bound_us(*R.kernel_cost(kernel, **shape)) == pytest.approx(table_us, rel=0.02)


@pytest.mark.parametrize("L", [1, 3, 64])
def test_pfb_lanes_cost_reads_shared_tables_once(L):
    """The lane form's count is L one-stream counts, with the twiddle table
    (one for every lane) read once, and a shared prototype's taps once."""
    one = R.kernel_cost("pfb", n=4096, N=64, K=12, tap_bytes=2)
    own = R.kernel_cost("pfb_lanes", L=L, n=4096, N=64, K=12, tap_bytes=2)
    shared = R.kernel_cost("pfb_lanes", L=L, n=4096, N=64, K=12, tap_bytes=2, shared=True)
    assert own == (L * one[0] - (L - 1) * 8 * 64, L * one[1])
    assert shared == (own[0] - (L - 1) * 2 * 12 * 64, own[1])


@pytest.mark.parametrize("make,kernel,shape,n,dt", [
    (lambda: fir_stage(np.hanning(64).astype(np.float32), impl="pallas"), "fir",
     dict(n=1 << 14, nt=64), 1 << 14, np.complex64),
    (lambda: fir_fft_stage(np.hanning(64).astype(np.float32), 2048), "fir_fft",
     dict(n=1 << 14, nt=64, n_fft=2048), 1 << 14, np.complex64),
    (lambda: rotator_stage(0.1, impl="pallas"), "rotator", dict(n=4096), 4096,
     np.complex64),
    (lambda: quad_demod_stage(0.5, impl="pallas"), "quad_demod", dict(n=4096), 4096,
     np.complex64),
    (lambda: fir_stage(firdes.lowpass(0.1, 128), decim=4, impl="pallas"), "poly_fir",
     dict(n=4096, m=32, D=4), 4096, np.complex64),
    (lambda: resample_stage(24, 125, impl="pallas"), "poly_fir", None, 16_000, np.float32),
    (lambda: channelizer_stage(64, impl="pallas"), "pfb", dict(n=4096, N=64, K=12), 4096,
     np.complex64),
])
def test_stages_declare_their_kernels_cost(make, kernel, shape, n, dt):
    """Each kernel-backed stage's declared cost is its kernel's count."""
    st = make()
    got = R.stage_cost(st, n, dt)
    assert got[0] > 0 and got[1] > 0
    if shape is not None:
        assert got == R.kernel_cost(kernel, **shape)
