"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA card (the kernels have no CPU
mode). This file imports no JAX, so it runs on a machine without it:
``python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q``.
"""

import numpy as np
import pytest
import torch

from futuresdr_tpu_torch.ops import cuda_kernels as ck

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)


def _c64(rng, n):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda:0")


def _rel_err(got, ref):
    return ((got - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("complex_stream", [True, False])
def test_fir_kernel_matches_plain_on_card(cuda_device, precision, complex_stream):
    rng = np.random.default_rng(21)
    n, nt = (1 << 18) + 777, 64
    taps = torch.from_numpy(rng.standard_normal(nt).astype(np.float32)).to(cuda_device)
    if complex_stream:
        hist, x = _c64(rng, nt - 1), _c64(rng, n)
    else:
        hist = rng.standard_normal(nt - 1).astype(np.float32)
        x = rng.standard_normal(n).astype(np.float32)
    h, xx = torch.from_numpy(hist).to(cuda_device), torch.from_numpy(x).to(cuda_device)
    before = ck.launches["fir"]
    got = ck.fir_continue(h, xx, taps, precision)
    torch.cuda.synchronize()
    assert ck.launches["fir"] == before + 1
    assert _rel_err(got, ck.fir_continue_plain(h, xx, taps, precision)) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("n_fft,nt,rows", [(2048, 64, 128), (128, 17, 7), (1000, 33, 5)])
def test_fir_fft_kernel_matches_plain_on_card(cuda_device, precision, n_fft, nt, rows):
    rng = np.random.default_rng(22)
    taps = torch.from_numpy(rng.standard_normal(nt).astype(np.float32)).to(cuda_device)
    h = torch.from_numpy(_c64(rng, nt - 1)).to(cuda_device)
    x = torch.from_numpy(_c64(rng, n_fft * rows)).to(cuda_device)
    before = ck.launches["fir_fft"]
    got = ck.fir_fft(h, x, taps, n_fft, precision)
    torch.cuda.synchronize()
    assert ck.launches["fir_fft"] == before + 1
    assert _rel_err(got, ck.fir_fft_plain(h, x, taps, n_fft, precision)) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("n_fft,nt", [(2, 2), (16, 2), (16, 16), (4096, 2), (4096, 4096),
                                      (8192, 2), (8192, 8192)])
def test_fir_fft_kernel_plan_edges_on_card(cuda_device, precision, n_fft, nt):
    """One- and two-pass transforms, the largest rows (8192 with 8192 taps
    takes the unpadded layout with the twiddles read from device memory),
    the shortest and longest tap sets; one row."""
    rng = np.random.default_rng(28)
    taps = torch.from_numpy(rng.standard_normal(nt).astype(np.float32)).to(cuda_device)
    h = torch.from_numpy(_c64(rng, nt - 1)).to(cuda_device)
    x = torch.from_numpy(_c64(rng, n_fft)).to(cuda_device)
    before = ck.launches["fir_fft"]
    got = ck.fir_fft(h, x, taps, n_fft, precision)
    torch.cuda.synchronize()
    assert ck.launches["fir_fft"] == before + 1
    assert _rel_err(got, ck.fir_fft_plain(h, x, taps, n_fft, precision)) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["512 threads", "radix 8", "twiddles unstaged",
                                     "unpadded"])
def test_fir_fft_kernel_takes_every_plan_layout_on_card(cuda_device, variant):
    """The main path's row (N = 2048, 64 taps) under the layouts the wrapper
    takes at other shapes (512 threads of 4 outputs, the twiddles read from
    device memory, no padding) and radix-8 passes; the kernel takes the
    plan's shared memory only where it equals its layout's."""
    n, nt = 2048, 64
    rng = np.random.default_rng(29)
    taps = torch.from_numpy(rng.standard_normal(nt).astype(np.float32)).to(cuda_device)
    h = torch.from_numpy(_c64(rng, nt - 1)).to(cuda_device)
    x = torch.from_numpy(_c64(rng, n * 3)).to(cuda_device)
    plan = ck.fir_fft_plan(n, nt)
    plan = {"512 threads": plan._replace(threads=512, outs=4, span_shift=2),
            "radix 8": plan._replace(radices=(4, 8, 8, 8)),
            "twiddles unstaged": plan._replace(tw_staged=False),
            "unpadded": plan._replace(span_shift=ck._NO_PAD, pad_shift=ck._NO_PAD,
                                      tw_staged=False)}[variant]
    plan = plan._replace(smem=ck._fir_fft_smem(n, nt, plan.span_shift, plan.pad_shift,
                                               plan.tw_len if plan.tw_staged else 0))
    with pytest.raises(RuntimeError, match="cudaError"):
        ck._launch_fir_fft(h, x, taps, n, False, plan._replace(smem=plan.smem + 8))
    got = ck._launch_fir_fft(h, x, taps, n, False, plan)
    torch.cuda.synchronize()
    assert _rel_err(got, ck.fir_fft_plain(h, x, taps, n)) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["main", "real", "zero state", "bf16", "shrunk",
                                     "one window", "n_sm 2", "two buffers",
                                     "two buffers bf16", "one buffer, 3 blocks"])
def test_fir_kernel_takes_every_plan_layout_on_card(cuda_device, variant):
    """The wrapper's plan at the main path's call (2^18, 64 taps: 4 warps a
    block, one tile a warp), a real stream, the zero state, bf16, the one
    unpadded warp a block that long tap sets fall back to, a frame shorter
    than one window, a plan for 2 SMs (8 warps a block), and warps walking
    many tiles with two span buffers (f32, bf16) and with one; the kernel
    takes the plan's shared memory only where it equals its layout's."""
    rng = np.random.default_rng(31)
    n, nt = {"one window": (5, 17)}.get(variant, ((1 << 18) + 3, 64))
    cplx = variant != "real"
    taps = torch.from_numpy(rng.standard_normal(nt).astype(np.float32)).to(cuda_device)
    if cplx:
        hist, x = _c64(rng, nt - 1), _c64(rng, n)
    else:
        hist = rng.standard_normal(nt - 1).astype(np.float32)
        x = rng.standard_normal(n).astype(np.float32)
    h, xx = torch.from_numpy(hist).to(cuda_device), torch.from_numpy(x).to(cuda_device)
    if variant == "zero state":
        h = None
    plan = ck.fir_plan(n, nt, cplx, 2 if variant == "n_sm 2" else 132)
    if variant == "shrunk":
        plan = ck.FirPlan(32, 500, ck._NO_PAD, 1, ck._fir_smem(1, 1, nt, ck._NO_PAD, 8))
    if variant.startswith("two buffers"):
        plan = ck.FirPlan(128, 50, 3, 2, ck._fir_smem(4, 2, nt, 3, 8))
    if variant == "one buffer, 3 blocks":
        plan = ck.FirPlan(128, 3, 3, 1, ck._fir_smem(4, 1, nt, 3, 8))
    prec = "bf16" if variant.endswith("bf16") else None
    with pytest.raises(RuntimeError, match="cudaError"):
        ck._launch_fir(h, xx, taps, prec == "bf16", plan._replace(smem=plan.smem + 4))
    before = ck.launches["fir"]
    got = ck._launch_fir(h, xx, taps, prec == "bf16", plan)
    torch.cuda.synchronize()
    assert ck.launches["fir"] == before + 1
    ref = ck.fir_plain(xx, taps, prec) if h is None else ck.fir_continue_plain(h, xx, taps,
                                                                                prec)
    assert _rel_err(got, ref) <= 1e-5


@pytest.mark.gpu
def test_fir_kernel_long_taps_take_the_shrunk_tile_on_card(cuda_device):
    """18,000 taps on a complex stream: the padded spans do not fit, the plan
    falls back to one unpadded warp a block."""
    rng = np.random.default_rng(32)
    n, nt = 20_000, 18_000
    assert ck.fir_plan(n, nt, True).span_shift == ck._NO_PAD
    taps = torch.from_numpy(rng.standard_normal(nt).astype(np.float32)).to(cuda_device)
    h = torch.from_numpy(_c64(rng, nt - 1)).to(cuda_device)
    x = torch.from_numpy(_c64(rng, n)).to(cuda_device)
    got = ck.fir_continue(h, x, taps)
    torch.cuda.synchronize()
    assert _rel_err(got, ck.fir_continue_plain(h, x, taps)) <= 1e-5


@pytest.mark.gpu
def test_empty_frames_launch_nothing(cuda_device):
    taps = torch.ones(16, device=cuda_device)
    hist = torch.zeros(15, dtype=torch.complex64, device=cuda_device)
    x = torch.zeros(0, dtype=torch.complex64, device=cuda_device)
    before = dict(ck.launches)
    assert ck.fir_continue(hist, x, taps).shape == (0,)
    assert ck.fir_fft(hist, x, taps, 256).shape == (0,)
    assert ck.launches == before


@pytest.mark.gpu
def test_kernel_wrappers_reject_non_contiguous_tensors(cuda_device):
    x = torch.zeros(4096, dtype=torch.complex64, device=cuda_device)[::2]
    taps = torch.ones(16, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ck.fir(x, taps)


# ---------------------------------------------------------------------------
# the FM front end's kernels at the FM shapes
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("n", [512_000, 512_000 * 8 + 77])
def test_rotator_kernel_matches_plain_on_card(cuda_device, n):
    """|ph| reaches 0.628·n: the kernel must round ph0 + inc·t as the plain
    version does (no FMA contraction, full-range sincosf)."""
    rng = np.random.default_rng(23)
    x = torch.from_numpy(_c64(rng, n)).to(cuda_device)
    ph0 = torch.tensor(1.25, device=cuda_device)
    inc = torch.tensor(-2 * np.pi * 0.1, dtype=torch.float32, device=cuda_device)
    before = ck.launches["rotator"]
    got, ph_next = ck.rotator(x, ph0, inc)
    torch.cuda.synchronize()
    assert ck.launches["rotator"] == before + 1
    ref, ref_next = ck.rotator_plain(x, ph0, inc)
    assert _rel_err(got, ref) <= 1e-5
    assert ph_next.item() == ref_next.item()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [128_000, 1_001])
def test_quad_demod_kernel_matches_plain_on_card(cuda_device, n):
    rng = np.random.default_rng(24)
    x = torch.from_numpy(_c64(rng, n)).to(cuda_device)
    prev = torch.tensor(0.7 - 0.2j, dtype=torch.complex64, device=cuda_device)
    gain = 250e3 / (2 * np.pi * 75e3)
    before = ck.launches["quad_demod"]
    got, last = ck.quad_demod(prev, x, gain)
    torch.cuda.synchronize()
    assert ck.launches["quad_demod"] == before + 1
    ref, ref_last = ck.quad_demod_plain(prev, x, gain)
    period = 2 * np.pi * gain
    d = got - ref
    d = d - period * torch.round(d / period)       # atan2's ±π branch
    assert d.abs().max().item() <= 1e-5
    assert last.item() == ref_last.item() == x[-1].item()


def _demod_err(got, ref, gain):
    period = 2 * np.pi * gain
    d = (got - ref).double()
    return (d - period * torch.round(d / period)).abs().max().item()


# (frame length, view): the views x[1:] (a head sample before the rotator's
# first 16-byte word) and x[:-1]; 1-3 samples; one block's tile +- 1
_VIEW_CASES = [(512_000, "x[1:]"), (512_000, "x[:-1]"), (128_000, "x[1:]"),
               (128_000, "x[:-1]"), (1, "x"), (2, "x"), (3, "x"), (1, "x[1:]"),
               (2, "x[1:]"), (3, "x[1:]"), ("tile", "x[1:]"), ("tile+1", "x[1:]"),
               ("tile+2", "x[1:]"), ("tile-1", "x"), ("tile+1", "x")]


def _view(rng, n, view, tile, device):
    if isinstance(n, str):
        n = tile + int(n[4:] or 0)
    x = torch.from_numpy(_c64(rng, n + 1)).to(device)
    return x[1:] if view == "x[1:]" else x[:-1] if view == "x[:-1]" else x[:n]


@pytest.mark.gpu
@pytest.mark.parametrize("n,view", _VIEW_CASES)
def test_rotator_kernel_takes_views_and_edge_sizes_on_card(cuda_device, n, view):
    rng = np.random.default_rng(31)
    x = _view(rng, n, view, ck.ROTATOR_TILE, cuda_device)
    ph0 = torch.tensor(-3.0, device=cuda_device)
    inc = torch.tensor(-2 * np.pi * 0.1, dtype=torch.float32, device=cuda_device)
    got, ph_next = ck.rotator(x, ph0, inc)
    torch.cuda.synchronize()
    ref, ref_next = ck.rotator_plain(x, ph0, inc)
    assert got.shape == ref.shape and got.is_contiguous()
    assert _rel_err(got, ref) <= 1e-5
    assert ph_next.item() == ref_next.item()


@pytest.mark.gpu
@pytest.mark.parametrize("n,view", _VIEW_CASES)
def test_quad_demod_kernel_takes_views_and_edge_sizes_on_card(cuda_device, n, view):
    rng = np.random.default_rng(32)
    x = _view(rng, n, view, ck.QUAD_DEMOD_TILE, cuda_device)
    prev = torch.tensor(-0.3 + 0.9j, dtype=torch.complex64, device=cuda_device)
    gain = 250e3 / (2 * np.pi * 75e3)
    got, last = ck.quad_demod(prev, x, gain)
    torch.cuda.synchronize()
    ref, ref_last = ck.quad_demod_plain(prev, x, gain)
    assert got.shape == ref.shape and got.is_contiguous()
    assert _demod_err(got, ref, gain) <= 1e-5
    assert last.item() == ref_last.item() == x[-1].item()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 512_000, 4_096_000])
@pytest.mark.parametrize("inc", [0.3, -2 * np.pi * 0.1])
@pytest.mark.parametrize("ph0", [1.25, float(np.float32(np.pi)) - 2e-7,
                                 -float(np.float32(np.pi)) + 2e-7, 0.0])
def test_rotator_next_phase_is_torch_remainder_bit_for_bit(cuda_device, n, inc, ph0):
    x = torch.ones(n, dtype=torch.complex64, device=cuda_device)
    ph0 = torch.tensor(ph0, dtype=torch.float32, device=cuda_device)
    inc = torch.tensor(inc, dtype=torch.float32, device=cuda_device)
    before = ck.launches["rotator"]
    _, ph_next = ck.rotator(x, ph0, inc)
    want = torch.remainder(ph0 + inc * n, 2 * np.pi)
    torch.cuda.synchronize()
    assert ck.launches["rotator"] == before + 1          # an empty frame too: the carry
    assert ph_next.shape == want.shape == ()
    assert ph_next.view(torch.int32).item() == want.view(torch.int32).item()


@pytest.mark.gpu
def test_rotator_stage_launches_one_kernel_a_frame_on_card(cuda_device):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from futuresdr_tpu_torch.ops import stages as T
    rng = np.random.default_rng(33)
    pipe = T.Pipeline([T.rotator_stage(-2 * np.pi * 0.1, impl="pallas")], np.complex64)
    fn, carry = pipe.fn(), pipe.init_carry(cuda_device)
    frames = [torch.from_numpy(_c64(rng, 512_000)).to(cuda_device) for _ in range(3)]
    carry, _ = fn(carry, frames[0])
    before = ck.launches["rotator"]
    carry, _ = fn(carry, frames[1])
    assert ck.launches["rotator"] == before + 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        carry, _ = fn(carry, frames[2])
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    assert len(kernels) == 1 and "rotator" in kernels[0], kernels
    # the carried phase after three frames is the stage's remainder, frame by frame
    want = torch.zeros((), device=cuda_device)
    inc = torch.tensor(-2 * np.pi * 0.1, dtype=torch.float32, device=cuda_device)
    for _ in range(3):
        want = torch.remainder(want + inc * 512_000, 2 * np.pi)
    assert carry[0][0].item() == want.item()


@pytest.mark.gpu
@pytest.mark.parametrize("head,offset", [(0, 1), (1, 0)])
def test_rotator_kernel_refuses_a_misaligned_body(cuda_device, head, offset):
    """A head that leaves the 16-byte words off their boundary is refused,
    never run."""
    buf = torch.ones(1001, dtype=torch.complex64, device=cuda_device)
    x, y = buf[offset:offset + 1000], torch.empty_like(buf)[offset:offset + 1000]
    ph0 = torch.zeros((), device=cuda_device)
    lib = ck._lib("rotator")
    err = lib.fsdr_rotator(x.data_ptr(), ph0.data_ptr(), ph0.data_ptr(), y.data_ptr(),
                           ph0.data_ptr(), 1000, head, ck._stream(x))
    with pytest.raises(RuntimeError, match="failed to launch"):
        ck._raise_on(err, "rotator")


@pytest.mark.gpu
@pytest.mark.parametrize("D,m,I,nq,complex_stream,precision", [
    (4, 32, None, 128_000, True, None), (4, 32, None, 128_000, True, "bf16"),
    (125, 2, 24, 1_024, False, None), (125, 2, 24, 1_021, False, "bf16"),
    (8, 7, None, 777, False, None)])
def test_poly_fir_kernel_matches_plain_on_card(cuda_device, D, m, I, nq,
                                               complex_stream, precision):
    rng = np.random.default_rng(25)
    shape = (m + 1, D) if I is None else (m + 1, D, I)
    W = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda_device)
    if precision == "bf16":
        W = W.to(torch.bfloat16)
    if complex_stream:
        hist, x = _c64(rng, m * D), _c64(rng, nq * D)
    else:
        hist = rng.standard_normal(m * D).astype(np.float32)
        x = rng.standard_normal(nq * D).astype(np.float32)
    h, xx = torch.from_numpy(hist).to(cuda_device), torch.from_numpy(x).to(cuda_device)
    before = ck.launches["poly_fir"]
    got = ck.poly_fir(h, xx, W, precision)
    torch.cuda.synchronize()
    assert ck.launches["poly_fir"] == before + 1
    assert _rel_err(got, ck.poly_fir_plain(h, xx, W, precision)) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("D,m,I,nq,complex_stream", [
    (4, 32, None, 1, True), (4, 32, None, 511, True), (4, 32, None, 513, True),
    (125, 2, 24, 1, True), (125, 2, 24, 3, True), (125, 2, 24, 5, True),
    (125, 2, 24, 8_192, True), (1, 63, None, 1_001, False), (5, 8, None, 777, True),
    (8, 1, None, 1_000, False), (125, 2, None, 333, False)])
def test_poly_fir_kernel_plan_edges_on_card(cuda_device, D, m, I, nq, complex_stream,
                                            precision):
    """nq = 1 and one tile +- 1 of each tiling (512 rows for "rows", 4 for
    the resampler's "gemm" at small nq), D = 1, an odd D, m = 1 and a 2-D W
    with few tap rows (the gemm tiling at I = 1), I = 24 on a complex
    stream; bf16 W in bf16 mode. The kernel takes the plan's shared memory
    only where it equals its layout's."""
    rng = np.random.default_rng(30)
    shape = (m + 1, D) if I is None else (m + 1, D, I)
    W = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda_device)
    if precision == "bf16":
        W = W.to(torch.bfloat16)
    if complex_stream:
        hist, x = _c64(rng, m * D), _c64(rng, nq * D)
    else:
        hist = rng.standard_normal(m * D).astype(np.float32)
        x = rng.standard_normal(nq * D).astype(np.float32)
    h, xx = torch.from_numpy(hist).to(cuda_device), torch.from_numpy(x).to(cuda_device)
    plan = ck.poly_fir_plan(m, D, I or 1, nq, complex_stream, ck._sm_count(xx.device))
    y = torch.empty((nq, I) if I else (nq,), dtype=xx.dtype, device=cuda_device)
    with pytest.raises(RuntimeError, match="cudaError"):
        ck._launch_poly_fir(h, xx, W, y, precision == "bf16",
                            plan._replace(smem=plan.smem + 4))
    before = ck.launches["poly_fir"]
    got = ck.poly_fir(h, xx, W, precision)
    torch.cuda.synchronize()
    assert ck.launches["poly_fir"] == before + 1
    assert _rel_err(got, ck.poly_fir_plain(h, xx, W, precision)) <= 1e-5


# ---------------------------------------------------------------------------
# the PFB channelizer's kernel
# ---------------------------------------------------------------------------

# bf16 kernel vs plain version: between the bf16 kernel's reading and that of
# the kernel in float32 mode on the same inputs (chip_smoke.PFB_BF16_SNR)
PFB_BF16_SNR = 54.5


def _snr_db(got, ref):
    return 10 * torch.log10(ref.abs().pow(2).mean() / (got - ref).abs().pow(2).mean()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("t,K,N,precision", [
    (4096, 12, 64, None), (4096, 12, 64, "bf16"), (37, 12, 64, None), (1, 12, 64, None),
    (500, 4, 24, None), (300, 1, 64, None), (64, 12, 1024, None), (16, 12, 2048, None),
    (16, 12, 2048, "bf16"), (9, 12, 4096, None)])
def test_pfb_kernel_matches_plain_on_card(cuda_device, t, K, N, precision):
    """f32 within 1e-5 of the plain output's peak. bf16 by SNR against the
    plain version, which also rounds its cos/sin matrix to bf16 (as the JAX
    kernel does) while the kernel keeps float32 twiddles: the bf16 kernel
    reads at least PFB_BF16_SNR, the kernel in float32 mode on the same
    inputs less. N = 2048 and 4096 read rows and taps from device memory."""
    rng = np.random.default_rng(26)
    hc = torch.from_numpy(rng.standard_normal((N, K)).astype(np.float32)).to(cuda_device)
    if precision == "bf16":
        hc = hc.to(torch.bfloat16)                  # the stage carries bf16 taps
    hist = torch.from_numpy(_c64(rng, (K - 1) * N)).to(cuda_device)
    x = torch.from_numpy(_c64(rng, t * N)).to(cuda_device)
    before = ck.launches["pfb"]
    got = ck.pfb(hist, x, hc.t(), precision)        # the carry's transposed view
    torch.cuda.synchronize()
    assert ck.launches["pfb"] == before + 1
    ref = ck.pfb_plain(hist, x, hc.t(), precision)
    if precision == "bf16":
        snr, off = _snr_db(got, ref), _snr_db(ck.pfb(hist, x, hc.t()), ref)
        assert off < PFB_BF16_SNR <= snr, (snr, off)
    else:
        assert _rel_err(got, ref) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("n_channels", [64, 2048])
def test_channelizer_auto_takes_the_kernel_on_card(cuda_device, n_channels):
    """The stage's default route on a carry on the card launches ``pfb`` once
    a frame and gives the ``pallas`` route's output."""
    from futuresdr_tpu_torch.ops.stages import Pipeline, channelizer_stage
    rng = np.random.default_rng(27)
    xs = [torch.from_numpy(_c64(rng, 8 * n_channels)).to(cuda_device) for _ in range(3)]
    outs = {}
    for impl in ("auto", "pallas"):
        pipe = Pipeline([channelizer_stage(n_channels, impl=impl)], np.complex64)
        fn, carry = pipe.fn(), pipe.init_carry(cuda_device)
        before = ck.launches["pfb"]
        ys = []
        for x in xs:
            carry, y = fn(carry, x)
            ys.append(y)
        torch.cuda.synchronize()
        assert ck.launches["pfb"] == before + len(xs)
        outs[impl] = torch.cat(ys)
    assert torch.equal(outs["auto"], outs["pallas"])


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["outs 1", "outs 4", "outs 8", "taps in smem",
                                     "unpadded", "twiddles unstaged", "v pow2", "v direct",
                                     "PFB-2048 outs 4", "N=1000 chunks"])
def test_pfb_kernel_takes_every_plan_layout_on_card(cuda_device, variant):
    """PFB-64 (t = 37) under every rows-a-thread window, the taps read from
    shared memory at K = 12, the unpadded layout with the twiddles read from
    device memory, the "v" layout (radix-2 at N = 2048, the direct DFT at
    N = 1000), PFB-2048 with 4 rows a thread and N = 1000 in two chunks, the
    last ragged; bf16 taps in bf16 mode on the main shapes. The kernel takes
    the plan's shared memory only where it equals its layout's."""
    N, t = {"v pow2": (2048, 5), "PFB-2048 outs 4": (2048, 9), "v direct": (1000, 5),
            "N=1000 chunks": (1000, 7)}.get(variant, (64, 37))
    K = 12
    rng = np.random.default_rng(33)
    hc = torch.from_numpy(rng.standard_normal((N, K)).astype(np.float32)).to(cuda_device)
    hist = torch.from_numpy(_c64(rng, (K - 1) * N)).to(cuda_device)
    x = torch.from_numpy(_c64(rng, t * N)).to(cuda_device)
    plan = ck.pfb_plan(N, K, 1 << 16)
    if variant.startswith("v "):
        plan = ck.PfbPlan(False, 256, N, 1, 1, 1, 0, (), (), (), N, N, ck._NO_PAD, False,
                          8 * N)
    else:
        outs = {"outs 1": 1, "outs 4": 4, "PFB-2048 outs 4": 4}.get(variant, plan.outs)
        if variant == "outs 8":
            outs = 8
        plan = plan._replace(outs=outs, rows=plan.groups * outs)
        if variant == "taps in smem":
            plan = plan._replace(k_regs=0)
        if variant == "unpadded":
            plan = plan._replace(pad_shift=ck._NO_PAD, tw_staged=False,
                                 pitch=ck._pfb_pitch(N, ck._NO_PAD, plan.radices))
        if variant == "twiddles unstaged":
            plan = plan._replace(tw_staged=False)
        plan = plan._replace(smem=ck._pfb_smem(N, K, plan.rows, plan.chunk,
                                               len(plan.radices), plan.pitch,
                                               plan.tw_len if plan.tw_staged else 0,
                                               plan.k_regs))
    assert plan.smem <= ck._MAX_SMEM
    y = torch.empty((t, N), dtype=torch.complex64, device=cuda_device)
    with pytest.raises(RuntimeError, match="cudaError"):
        ck._launch_pfb(hist, x, hc.t(), y, False, plan._replace(smem=plan.smem + 8))
    before = ck.launches["pfb"]
    got = ck._launch_pfb(hist, x, hc.t(), y, False, plan)
    torch.cuda.synchronize()
    assert ck.launches["pfb"] == before + 1
    assert _rel_err(got, ck.pfb_plain(hist, x, hc.t())) <= 1e-5


# ---------------------------------------------------------------------------
# the compiled program (Pipeline.compile: one CUDA graph replay a dispatch)
# and the streamed host path (megabatch K, the pinned arena)
# ---------------------------------------------------------------------------

def _fm_tone(n, offset):
    """A 1 kHz tone FM-modulated at 75 kHz deviation, ``offset`` Hz off the
    tuned frequency at 1 Msps (chip_smoke.py's ``fm_iq``), complex64."""
    t = np.arange(n) / 1e6
    ph = 2 * np.pi * 75e3 * np.cumsum(np.sin(2 * np.pi * 1000.0 * t)) / 1e6 \
        + 2 * np.pi * offset * t
    return np.exp(1j * ph).astype(np.complex64)


def _chain(name, offset=100e3):
    """``(stages, frame)`` of each chain chip_smoke.py drives, at a reduced
    frame (FM at ``offset``)."""
    from futuresdr_tpu_torch.apps.fm_receiver import front_end_stages
    from futuresdr_tpu_torch.apps.spectrum import spectrum_stages
    from futuresdr_tpu_torch.dsp import firdes
    from futuresdr_tpu_torch.ops import stages as T
    taps = firdes.lowpass(0.2, 64).astype(np.float32)
    route = name.split()[-1]
    if name.startswith("spectrum "):
        if route == "app":
            return spectrum_stages(2048), 1 << 15
        if route == "fused":
            return [T.fir_fft_stage(taps, 2048), T.mag2_stage()], 1 << 16
        return [T.fir_stage(taps, impl=route), T.fft_stage(2048), T.mag2_stage()], 1 << 16
    if name.startswith("pfb "):
        return [T.channelizer_stage(64, impl=route)], 1 << 14
    if route == "app":
        return front_end_stages(1e6, offset), 32_000
    k = route == "kernel"
    return [T.rotator_stage(-2 * np.pi * offset / 1e6, name="tuner",
                            impl="pallas" if k else "xla"),
            T.fir_stage(firdes.lowpass(0.5 / 4 * 0.8, 128), decim=4,
                        impl="pallas" if k else "poly", name="chan"),
            T.quad_demod_stage(250e3 / (2 * np.pi * 75e3), impl="pallas" if k else "xla"),
            T.resample_stage(24, 125, impl="pallas" if k else "poly")], 32_000


_CHAINS = ["spectrum os", "spectrum pallas", "spectrum fused", "spectrum app",
           "fm app", "fm kernel", "fm plain", "pfb matmul", "pfb pallas"]


def _input(name, n, rng, offset=100e3):
    return _fm_tone(n, offset) if name.startswith("fm ") else _c64(rng, n)


def _eager(pipe, frames, dev, retune=None):
    """``pipe.fn`` over ``frames``, carry chained; ``retune = (at, stage,
    params)`` updates the carry before frame ``at``."""
    fn, carry = pipe.fn(), pipe.init_carry(dev)
    outs = []
    for i, x in enumerate(frames):
        if retune is not None and i == retune[0]:
            carry = pipe.update_stage(carry, retune[1], **retune[2])
        carry, y = fn(carry, x)
        outs.append(y.reshape(-1))
    return torch.cat(outs)


def _compiled(fn, carry, frames, k, pipe=None, retune=None):
    """The compiled ``fn`` over ``frames``, ``k`` a dispatch."""
    outs = []
    for d in range(len(frames) // k):
        if retune is not None and d * k == retune[0]:
            carry = pipe.update_stage(carry, retune[1], **retune[2])
        x = torch.stack(frames[d * k:(d + 1) * k]) if k > 1 else frames[d]
        carry, y = fn(carry, x)
        outs.append(y.reshape(-1))
    return torch.cat(outs)


def _abs_err(got, ref):
    return float((got.to(torch.complex128) - ref.to(torch.complex128)).abs().max())


def _max_err(got, ref):
    return _abs_err(got, ref) / float(ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("name", _CHAINS)
def test_compiled_replay_equals_eager_on_card(cuda_device, name, k):
    """Three chained dispatches of ``k`` frames replay one graph each: the
    output equals the eager chain's at the kernels' limit (1e-5 of the
    peak), the program captured once, and each replay added the launches
    the graph recorded to the wrappers' counts."""
    from futuresdr_tpu_torch.ops import stages as T
    rng = np.random.default_rng(40)
    stages, frame = _chain(name)
    pipe = T.Pipeline(stages, np.complex64)
    host = _input(name, 3 * k * frame, rng)
    frames = list(torch.from_numpy(host).to(cuda_device).split(frame))
    fn, carry = pipe.compile(frame, cuda_device, k=k)
    before = dict(ck.launches)
    got = _compiled(fn, carry, frames, k)
    torch.cuda.synchronize()
    assert {n: ck.launches[n] - before[n] for n in ck.launches} == \
        {n: 3 * fn.launches.get(n, 0) for n in ck.launches}
    kernel_of = {"spectrum pallas": "fir", "spectrum fused": "fir_fft",
                 "fm kernel": "quad_demod", "pfb pallas": "pfb"}
    if name in kernel_of:
        assert fn.launches[kernel_of[name]] == k
    assert fn.captures == 1
    want = _eager(pipe, frames, cuda_device)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert _max_err(got, want) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("name", _CHAINS)
def test_compiled_chained_frames_equal_one_long_frame_on_card(cuda_device, name):
    """Twelve frames in three K = 4 replays against the eager chain over one
    long frame (FM at offset 0, where every phase ramp is exact): 1e-5 of
    the peak, FM 1e-4 (chip_smoke.py's FM_CHAIN_TOL, unit-amplitude audio)."""
    from futuresdr_tpu_torch.ops import stages as T
    rng = np.random.default_rng(41)
    stages, frame = _chain(name, offset=0.0)
    pipe = T.Pipeline(stages, np.complex64)
    x = torch.from_numpy(_input(name, 12 * frame, rng, offset=0.0)).to(cuda_device)
    fn, carry = pipe.compile(frame, cuda_device, k=4)
    got = _compiled(fn, carry, list(x.split(frame)), 4)
    want = _eager(pipe, [x], cuda_device)
    if name.startswith("fm "):
        assert _abs_err(got, want) <= 1e-4
    else:
        assert _max_err(got, want) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("name,stage,params", [
    ("spectrum pallas", 0, "taps"), ("spectrum fused", 0, "taps"),
    ("pfb pallas", 0, "prototype"), ("fm app", "tuner", "phase_inc"),
    ("fm kernel", "tuner", "phase_inc"), ("fm app", "tuner", "taps")])
def test_retune_through_the_compiled_carry_needs_no_capture_on_card(
        cuda_device, name, stage, params):
    """A retune between dispatches writes the new leaves into the program's
    buffers: no capture, and the output equals the eager chain retuned at
    the same frame."""
    from futuresdr_tpu_torch.blocks.pfb import pfb_default_taps
    from futuresdr_tpu_torch.dsp import firdes
    from futuresdr_tpu_torch.ops import stages as T
    rng = np.random.default_rng(42)
    stages, frame = _chain(name)
    kw = {"taps": {"taps": firdes.lowpass(0.05, 64 if name.startswith("spectrum")
                                          else 128).astype(np.float32)},
          "prototype": {"taps": 0.5 * pfb_default_taps(64)},
          "phase_inc": {"phase_inc": -2 * np.pi * 150e3 / 1e6}}[params]
    pipe = T.Pipeline(stages, np.complex64)
    frames = list(torch.from_numpy(_input(name, 6 * frame, rng)).to(cuda_device)
                  .split(frame))
    fn, carry = pipe.compile(frame, cuda_device, k=2)
    got = _compiled(fn, carry, frames, 2, pipe, retune=(2, stage, kw))
    assert fn.captures == 1
    want = _eager(pipe, frames, cuda_device, retune=(2, stage, kw))
    if name.startswith("fm "):
        assert _abs_err(got, want) <= 1e-4
    else:
        assert _max_err(got, want) <= 1e-5
    unretuned = _eager(pipe, frames, cuda_device)
    assert _max_err(got[-len(got) // 3:], unretuned[-len(got) // 3:]) > 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["spectrum fused", "fm kernel"])
def test_slots_share_the_carry_and_keep_their_outputs_on_card(cuda_device, name):
    """Four slots, each its own graph over its own input and output buffers,
    replayed in turn on the shared carry: every slot's output stays as its
    replay left it while the others replay, and the four together equal the
    eager chain over the same frames."""
    from futuresdr_tpu_torch.ops import stages as T
    rng = np.random.default_rng(46)
    stages, frame = _chain(name)
    pipe = T.Pipeline(stages, np.complex64)
    frames = list(torch.from_numpy(_input(name, 8 * frame, rng)).to(cuda_device)
                  .split(frame))
    fn, carry = pipe.compile(frame, cuda_device, slots=4)
    assert len(fn.inputs) == len(fn.outputs) == 4 and fn.captures == 1
    got = []
    for lap in range(2):
        ys = []
        for slot in range(4):
            fn.inputs[slot].copy_(frames[4 * lap + slot])
            carry, y = fn.dispatch(slot, carry)
            assert y is fn.outputs[slot]
            ys.append(y)
        got += [y.clone() for y in ys]          # all four read after the lap
    want = _eager(pipe, frames, cuda_device)
    assert _max_err(torch.cat(got), want) <= 1e-5


@pytest.mark.gpu
def test_a_program_that_does_not_donate_returns_carries_of_their_own_on_card(cuda_device):
    """``donate=False``: each call returns a copy of the carry it left, so
    an earlier carry keeps its values after later replays."""
    from futuresdr_tpu_torch.ops import stages as T
    pipe = T.Pipeline([T.rotator_stage(0.25, impl="pallas")], np.complex64)
    fn, carry = pipe.compile(4096, cuda_device, donate=False)
    x = torch.ones(4096, dtype=torch.complex64, device=cuda_device)
    first, _ = fn(carry, x)
    second, _ = fn(first, x)
    assert first is not fn.carry and second is not fn.carry
    ph = [float(c[0][0]) for c in (first, second)]
    want = [float(np.float32(np.remainder(np.float32(0.25) * 4096 * n, 2 * np.pi)))
            for n in (1, 2)]
    assert ph == pytest.approx(want, abs=1e-3)


@pytest.mark.gpu
def test_a_changed_carry_shape_captures_again_on_card(cuda_device):
    """A carry leaf of another shape (here the overlap-save FIR's unused tap
    copy) makes new buffers and a new capture; the counter says so."""
    from futuresdr_tpu_torch.ops import stages as T
    rng = np.random.default_rng(43)
    pipe = T.Pipeline([T.fir_stage(np.ones(16, np.float32) / 16, fft_len=1024)],
                      np.complex64)
    frame = 4 * pipe.frame_multiple
    frames = list(torch.from_numpy(_c64(rng, 3 * frame)).to(cuda_device).split(frame))
    fn, carry = pipe.compile(frame, cuda_device)
    carry, y0 = fn(carry, frames[0])
    (H, tt, tail), = carry
    carry = ((H, torch.zeros(32, device=cuda_device), tail),)
    carry, y1 = fn(carry, frames[1])
    assert fn.captures == 2 and fn.carry[0][1].shape == (32,)
    carry, y2 = fn(carry, frames[2])
    assert fn.captures == 2
    want = _eager(pipe, frames, cuda_device)
    assert _max_err(torch.cat([y0, y1, y2]), want) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["window", "resampler", "lora"])
def test_a_cold_pipeline_captures_on_card(cuda_device, which):
    """Stages that build a device table on first use (the FFT window, the
    resampler's weights, the LoRa chirps) were never run: compile's warm-up
    builds them before the capture, which forbids their host copies."""
    from futuresdr_tpu_torch.ops import stages as T
    rng = np.random.default_rng(44)
    stages, dtype, frame = {
        "window": ([T.fft_stage(256, window="hann"), T.mag2_stage()], np.complex64, 4096),
        "resampler": ([T.resample_stage(24, 125)], np.float32, 4000),
        "lora": ([T.lora_demod_stage(7)], np.complex64, 4096)}[which]
    pipe = T.Pipeline(stages, dtype)
    x = _c64(rng, 2 * frame)
    if dtype == np.float32:
        x = x.real.copy()
    frames = list(torch.from_numpy(x).to(cuda_device).split(frame))
    fn, carry = pipe.compile(frame, cuda_device)
    got = _compiled(fn, carry, frames, 1)
    want = _eager(pipe, frames, cuda_device)
    assert torch.equal(got, want) if which == "lora" else _max_err(got, want) <= 1e-5


@pytest.mark.gpu
def test_a_stage_that_syncs_makes_compile_raise_on_card(cuda_device):
    """A host sync inside a stage's fn cannot be captured: compile raises,
    nothing runs eagerly in its place, and the card works on."""
    from futuresdr_tpu_torch.ops import stages as T
    sync = T.apply_stage(lambda x: x * float(x.real.abs().max()), name="sync")
    with pytest.raises(RuntimeError, match="capture"):
        T.Pipeline([sync], np.complex64).compile(4096, cuda_device)
    fn, carry = T.Pipeline([T.mag2_stage()], np.complex64).compile(4096, cuda_device)
    x = torch.full((4096,), 2 + 0j, dtype=torch.complex64, device=cuda_device)
    _, y = fn(carry, x)
    assert float(y.sum()) == 4 * 4096


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["spectrum fused", "fm kernel", "pfb pallas"])
def test_megabatch_streams_equal_one_frame_dispatch_on_card(cuda_device, name):
    """``VectorSource -> TpuKernel -> VectorSink`` at K = 4 and K = 1 over
    eleven frames and a partial one (the last group partial at EOS): the
    same items, equal at the kernels' limit; the arena served the
    staging buffers from its pool after the first lap."""
    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
    from futuresdr_tpu_torch.ops.arena import arena
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
    rng = np.random.default_rng(45)
    stages, frame = _chain(name)
    host = _input(name, 11 * frame + frame // 3 + 7, rng)
    out = {}
    for k in (1, 4):
        hits = arena().hits
        # the f32 wire: K = 4 against K = 1 at the kernels' limit (the card's
        # default wire, sc16, rounds each output to its frame's scale)
        kern = TpuKernel(_chain(name)[0], np.complex64, frame_size=frame,
                         inst=TpuInstance(cuda_device), frames_in_flight=3,
                         frames_per_dispatch=k, wire="f32")
        fg = Flowgraph()
        snk = VectorSink(kern.pipeline.out_dtype)
        fg.connect(VectorSource(host), kern, snk)
        Runtime().run(fg)
        out[k] = torch.from_numpy(snk.items())
        assert kern.frames_dispatched == 12
        assert arena().hits > hits
    assert out[4].shape == out[1].shape
    assert _max_err(out[4], out[1]) <= 1e-5


# ---------------------------------------------------------------------------
# the device-frame plane and device-graph fusion
# ---------------------------------------------------------------------------

def _graph_shapes(T):
    """A fan-out and a diamond on the hand kernels' routes."""
    t1 = np.asarray(np.hanning(64) / np.hanning(64).sum(), np.float32)
    t2 = np.asarray(np.hanning(33) / np.hanning(33).sum(), np.float32)
    fo = T.FanoutPipeline(
        [T.rotator_stage(-0.3, impl="pallas"), T.fir_stage(t1, impl="pallas")],
        [[T.fir_stage(t2, decim=4, impl="pallas")],
         [T.quad_demod_stage(0.5, impl="pallas")]], np.complex64, optimize=False)
    dag = T.DagPipeline([
        ([T.fir_stage(t1, impl="pallas")], []),
        ([T.fir_stage(t2, decim=4, impl="pallas")], [0]),
        ([T.fir_stage(t1, decim=4, impl="pallas")], [0]),
        ([T.add_merge_stage(2), T.mag2_stage()], [1, 2]),
    ], np.complex64)
    return {"fanout": fo, "diamond": dag}


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("shape", ["fanout", "diamond"])
def test_multi_output_capture_equals_eager_on_card(cuda_device, shape, k):
    """A fan-out or DAG pipeline compiles into one graph with one static
    output a sink: three chained dispatches of ``k`` frames equal the eager
    program bit for bit (the same kernels on the same shapes, a frame at a
    time), one capture, and each replay adds the graph's launches."""
    from futuresdr_tpu_torch.ops import stages as T
    pipe = _graph_shapes(T)[shape]
    frame = 4096
    rng = np.random.default_rng(90)
    frames = list(torch.from_numpy(_c64(rng, 3 * k * frame)).to(cuda_device).split(frame))
    fn, carry = pipe.compile(frame, cuda_device, k=k)
    assert fn.captures == 1 and isinstance(fn.outputs[0], tuple)
    before = dict(ck.launches)
    got = [[] for _ in range(pipe.n_branches)]
    for d in range(3):
        x = torch.stack(frames[d * k:(d + 1) * k]) if k > 1 else frames[d]
        carry, ys = fn(carry, x)
        for j, y in enumerate(ys):
            got[j].append(y.reshape(-1))
    torch.cuda.synchronize()
    assert {n: ck.launches[n] - before[n] for n in ck.launches} == \
        {n: 3 * fn.launches.get(n, 0) for n in ck.launches}
    assert fn.launches["fir"] == k
    run, ec = pipe.fn(), pipe.init_carry(cuda_device)
    want = [[] for _ in range(pipe.n_branches)]
    for x in frames:
        ec, ys = run(ec, x)
        for j, y in enumerate(ys):
            want[j].append(y.reshape(-1))
    for g, w in zip(got, want):
        assert torch.equal(torch.cat(g), torch.cat(w))


@pytest.mark.gpu
@pytest.mark.parametrize("wait", [True, False])
def test_device_frame_crosses_threads_on_card(cuda_device, wait):
    """A frame written on one thread's stream, held busy by a device sleep,
    and read on another thread's stream: through the in-place ports the
    reader waits on the producer's event and reads the written values; a
    reader that takes the frame without the wait reads it before it is
    written (the control, which shows the case can fail)."""
    import threading

    from futuresdr_tpu_torch.runtime.buffer.circuit import InplaceInput, InplaceOutput
    out, inp = InplaceOutput("out"), InplaceInput("in")
    out.connect(inp)
    n = 1 << 20
    src = torch.randn(n, device=cuda_device) + 7.0
    torch.cuda.synchronize()
    result = {}

    def produce():
        s = torch.cuda.Stream(cuda_device)
        with torch.cuda.stream(s):
            frame = torch.empty(n, device=cuda_device)
            torch.cuda._sleep(200_000_000)          # holds the stream ~0.1 s
            frame.copy_(src)
            if wait:
                out.put_full(frame, n, ())
            else:
                inp.push(frame, None, n, ())        # no event: the control
            del frame

    def consume():
        s = torch.cuda.Stream(cuda_device)
        with torch.cuda.stream(s):
            frame, valid, _ = inp.get_full()
            result["y"] = (frame * 2.0).cpu()       # synchronizes this stream only
            result["valid"] = valid

    t1 = threading.Thread(target=produce)
    t1.start()
    t1.join()
    t2 = threading.Thread(target=consume)
    t2.start()
    t2.join()
    torch.cuda.synchronize()
    same = torch.equal(result["y"], (src * 2.0).cpu())
    assert result["valid"] == n
    assert same is wait


@pytest.mark.gpu
def test_two_stage_blocks_capture_concurrently_on_card(cuda_device):
    """Two TpuStages compile on their own threads at once (the capture lock
    serializes the captures); each program captured once and equals its
    eager chain."""
    import threading

    from futuresdr_tpu_torch.ops import stages as T
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuStage
    inst = TpuInstance(cuda_device)
    t1 = np.asarray(np.hanning(64) / np.hanning(64).sum(), np.float32)
    blocks = [TpuStage([T.fir_stage(t1, impl="pallas"), T.fft_stage(2048),
                        T.mag2_stage()], np.complex64, inst=inst),
              TpuStage([T.rotator_stage(0.2, impl="pallas"),
                        T.quad_demod_stage(0.5, impl="pallas")], np.complex64, inst=inst)]
    frame = 1 << 16
    rng = np.random.default_rng(91)
    x = torch.from_numpy(_c64(rng, frame)).to(cuda_device)
    barrier = threading.Barrier(2)
    errors = []

    def compile_one(b):
        try:
            barrier.wait()
            b._compile(frame)
        except Exception as e:          # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=compile_one, args=(b,)) for b in blocks]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for b in blocks:
        assert b._compiled.captures == 1
        _, y = b._compiled(b._carry, x)
        _, want = b.pipeline.fn()(b.pipeline.init_carry(cuda_device), x)
        assert torch.equal(y, want)


@pytest.mark.gpu
def test_fused_frame_plane_equals_per_hop_on_card(cuda_device):
    """``TpuH2D → TpuStage[fir] → TpuStage[fft] → TpuStage[|x|²] → TpuD2H``
    on the card, fused and per hop: bit-equal at K = 1, one dispatch a frame
    fused."""
    import os

    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
    from futuresdr_tpu_torch.ops import stages as T
    from futuresdr_tpu_torch.runtime.devchain import find_device_chains
    from futuresdr_tpu_torch.tpu import TpuD2H, TpuH2D, TpuInstance, TpuStage
    inst = TpuInstance(cuda_device)
    t1 = np.asarray(np.hanning(64) / np.hanning(64).sum(), np.float32)
    frame = 1 << 16
    host = _c64(np.random.default_rng(92), 5 * frame)
    out = {}
    for fused in (False, True):
        if fused:
            os.environ.pop("FSDR_NO_DEVCHAIN", None)
        else:
            os.environ["FSDR_NO_DEVCHAIN"] = "1"
        try:
            fg = Flowgraph()
            h2d = TpuH2D(np.complex64, frame_size=frame, inst=inst, wire="f32")
            sts = [TpuStage([s], np.complex64, inst=inst) for s in
                   (T.fir_stage(t1, impl="pallas"), T.fft_stage(2048), T.mag2_stage())]
            d2h, snk = TpuD2H(np.float32, inst=inst, wire="f32"), VectorSink(np.float32)
            fg.connect(VectorSource(host), h2d, *sts, d2h, snk)
            assert len(find_device_chains(fg)) == int(fused)
            Runtime().run(fg)
            out[fused] = snk.items()
            if fused:
                m = h2d.extra_metrics()
                assert m["devchain_dispatches"] == m["devchain_frames"] == 5
        finally:
            os.environ.pop("FSDR_NO_DEVCHAIN", None)
    assert out[True].shape == out[False].shape == (5 * frame,)
    np.testing.assert_array_equal(out[True], out[False])


@pytest.mark.gpu
def test_captures_never_take_a_transfer_stream_on_card(cuda_device):
    """Forty captures on one thread while another thread's transfers run:
    the pool hands its streams out round robin, so a capture on a stream of
    the transfers' pool would, within 32 captures, capture a copy and its
    event (an error at the capture or at the arena's next query)."""
    import threading

    from futuresdr_tpu_torch.ops import stages as T
    from futuresdr_tpu_torch.ops import xfer
    stop, errors = threading.Event(), []
    host = np.ones(1 << 16, np.complex64)

    def transfers():
        try:
            while not stop.is_set():
                t = xfer.start_device_transfer(host, cuda_device)()
                finish = xfer.start_host_transfer(t)
                finish()
                finish.release()
        except Exception as e:          # noqa: BLE001 — reported below
            errors.append(e)

    th = threading.Thread(target=transfers)
    th.start()
    try:
        for _ in range(40):
            fn, carry = T.Pipeline([T.mag2_stage()], np.complex64).compile(4096, cuda_device)
            fn(carry, torch.ones(4096, dtype=torch.complex64, device=cuda_device))
    finally:
        stop.set()
        th.join()
    torch.cuda.synchronize()
    assert not errors, errors


# ---------------------------------------------------------------------------
# the wires and the uplink plane
# ---------------------------------------------------------------------------

WIRES = ["f32", "bf16", "sc16", "sc8"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", WIRES)
def test_wire_codecs_equal_their_host_twin_on_card(cuda_device, name):
    """The device decode and encode, eager and inside a captured K = 4
    program (each frame its own peak), against the host codec bit for bit
    (bf16: every finite value; a NaN's bits are the device's)."""
    from futuresdr_tpu_torch.ops import stages as T
    from futuresdr_tpu_torch.ops.wire import get_wire
    w = get_wire(name)
    rng = np.random.default_rng(120)
    x = _c64(rng, 1 << 16)
    x[[3, 70]] = [np.nan, np.inf]
    parts = w.encode_host(x)
    dev_parts = tuple(torch.from_numpy(np.array(p)).to(cuda_device)
                      for p in parts)
    got = w.decode_torch(dev_parts, np.complex64).cpu().numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  w.decode_host(parts, np.complex64).view(np.uint32))
    enc = w.encode_torch(torch.from_numpy(x).to(cuda_device))
    keep = np.isfinite(x.view(np.float32)).reshape(-1, 2)
    for e, h in zip(enc, parts):
        e, h = e.cpu().numpy(), np.asarray(h)
        if name == "bf16":
            np.testing.assert_array_equal(e[keep], h[keep])
        else:
            np.testing.assert_array_equal(e.reshape(-1).view(np.uint8),
                                          np.ascontiguousarray(h).reshape(-1).view(np.uint8))
    xs = [_c64(rng, 4096) * np.float32(10.0 ** -i) for i in range(4)]
    enc = [w.encode_host(v) for v in xs]
    stacked = tuple(torch.from_numpy(np.stack([np.asarray(e[j]) for e in enc])).to(cuda_device)
                    for j in range(len(enc[0])))
    fn, carry = T.Pipeline([T.apply_stage(lambda v: v.clone())], np.complex64).compile(
        4096, cuda_device, k=4, wire=w)
    _, y = fn(carry, stacked)
    for i, e in enumerate(enc):
        again = w.encode_host(w.decode_host(e, np.complex64))
        for a, h in zip(y, again):
            np.testing.assert_array_equal(a[i].cpu().numpy(), np.asarray(h))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4])
def test_packed_uplink_one_start_and_bit_equal_on_card(cuda_device, k):
    """sc16 streamed with coalescing on and off: the same output bit for bit,
    one H2D start a group packed, two per part."""
    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
    from futuresdr_tpu_torch.config import config
    from futuresdr_tpu_torch.ops import stages as T
    from futuresdr_tpu_torch.ops import xfer
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
    host = _c64(np.random.default_rng(121), 8 * 4096)
    out, starts = {}, {}
    saved = config().tpu_coalesce
    try:
        for coalesce in (True, False):
            config().tpu_coalesce = coalesce
            kern = TpuKernel([T.fir_stage(np.hanning(33).astype(np.float32), impl="pallas"),
                              T.mag2_stage()], np.complex64, frame_size=4096,
                             inst=TpuInstance(cuda_device), frames_in_flight=2,
                             frames_per_dispatch=k, wire="sc16")
            fg = Flowgraph()
            snk = VectorSink(np.float32)
            fg.connect(VectorSource(host), kern, snk)
            xfer.reset_bytes()
            Runtime().run(fg)
            out[coalesce], starts[coalesce] = snk.items(), xfer.starts_total["h2d"]
    finally:
        config().tpu_coalesce = saved
    np.testing.assert_array_equal(out[True], out[False])
    assert starts == {True: 8 // k, False: 2 * 8 // k}


@pytest.mark.gpu
def test_zero_copy_ingest_page_locks_on_card(cuda_device):
    """A registered buffer is page-locked on a card and its frames ship
    without the ring-exit copy, bit-equal to the copying path; unregister
    unlocks it."""
    from futuresdr_tpu_torch import Mocker
    from futuresdr_tpu_torch.ops import ingest
    from futuresdr_tpu_torch.ops import stages as T
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
    data = _c64(np.random.default_rng(122), 6 * 4096)

    def drive():
        kern = TpuKernel([T.mag2_stage()], np.complex64, frame_size=4096,
                         inst=TpuInstance(cuda_device), frames_in_flight=2, wire="f32")
        m = Mocker(kern)
        m.input("in", data)
        m.init_output("out", len(data))
        m.init()
        m.run()
        return m.output("out").copy(), kern.extra_metrics()["ingest_zero_copy_frac"]

    want, frac0 = drive()
    h = ingest.register(data)
    try:
        assert h.page_locked
        got, frac = drive()
    finally:
        ingest.unregister(h)
    assert (frac0, frac) == (0.0, 1.0)
    assert not h.page_locked and h.refcount == 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_wire_switch_back_captures_nothing_on_card(cuda_device):
    """f32 -> sc8 -> f32 between runs of one kernel: two programs, sharing
    the carry buffers; the way back takes the first with no capture."""
    from futuresdr_tpu_torch import Mocker
    from futuresdr_tpu_torch.ops import stages as T
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
    data = _c64(np.random.default_rng(123), 4 * 4096)
    kern = TpuKernel([T.fir_stage(np.hanning(33).astype(np.float32), impl="pallas")],
                     np.complex64, frame_size=4096, inst=TpuInstance(cuda_device),
                     frames_in_flight=2, wire="f32")
    m = Mocker(kern)
    m.init_output("out", 3 * len(data))
    m.init()
    first = kern._fn
    for nxt in ("sc8", "f32", None):
        m.input("in", data)
        m.run()
        if nxt:
            kern.apply_wire_retune(nxt)
    assert [w for _, w in kern.wire_history] == ["f32", "sc8", "f32"]
    assert kern._fn is first and first.captures == 1 and len(kern._programs) == 2
    (sc8,) = [fn for key, fn in kern._programs.items() if key[0] == "sc8"]
    assert sc8.carry is first.carry


# ---------------------------------------------------------------------------
# recovery: the carry checkpoint through the compiled program's static carry
# ---------------------------------------------------------------------------

def _leaves_of(carry):
    from futuresdr_tpu_torch.ops import stages as T
    return T._leaves(carry)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["spectrum fused", "fm kernel"])
def test_snapshot_in_stream_order_equals_the_carry_after_its_group_on_card(cuda_device,
                                                                           name):
    """A snapshot started right behind group 1's replay and read only after
    group 2's replay overwrote the static carry is still the carry after
    group 1 (a clone taken there in another program), and not group 2's."""
    from futuresdr_tpu_torch.ops import stages as T
    rng = np.random.default_rng(71)
    stages, frame = _chain(name)
    # noise: the FM tone repeats every 32 ms, one reduced frame
    frames = list(torch.from_numpy(_c64(rng, 2 * frame)).to(cuda_device).split(frame))
    carries = []
    for snapshot in (False, True):
        pipe = T.Pipeline(_chain(name)[0], np.complex64)
        fn, carry = pipe.compile(frame, cuda_device)
        carry, _ = fn(carry, frames[0])
        if snapshot:
            fetches, spec = pipe.snapshot_carry(carry)
        else:
            after1 = [t.clone() for t in _leaves_of(carry)]
        carry, _ = fn(carry, frames[1])
        after2 = [t.clone() for t in _leaves_of(carry)]
        carries.append((after1 if not snapshot else None, after2))
    torch.cuda.synchronize()
    got = [f() for f in fetches]
    assert pipe.carry_matches(got, spec, carry)
    want1, want2 = carries[0]
    changed = False
    for g, a, b in zip(got, want1, want2):
        np.testing.assert_array_equal(g, a.cpu().numpy())
        changed |= not np.array_equal(g, b.cpu().numpy())
    assert changed, "group 2 left the carry as group 1 did: the check sees nothing"


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["spectrum fused", "fm kernel"])
def test_restore_writes_the_static_carry_in_place_with_no_capture_on_card(cuda_device,
                                                                          name):
    """A restored carry goes through the program's load into the very static
    buffers its kernels read and write (the rotator's phase, fir_fft's
    history): same tensors, no new capture, and the frame after the restore
    point comes out as it did the first time, bit for bit."""
    from futuresdr_tpu_torch.ops import stages as T
    rng = np.random.default_rng(72)
    stages, frame = _chain(name)
    pipe = T.Pipeline(stages, np.complex64)
    fn, carry = pipe.compile(frame, cuda_device)
    static = [t.data_ptr() for t in _leaves_of(fn.carry)]
    frames = list(torch.from_numpy(_c64(rng, 4 * frame)).to(cuda_device).split(frame))
    carry, _ = fn(carry, frames[0])
    fetches, spec = pipe.snapshot_carry(carry)
    carry, y1 = fn(carry, frames[1])
    carry, _ = fn(carry, frames[2])
    leaves = [f() for f in fetches]
    carry = pipe.restore_carry(leaves, spec, cuda_device)
    carry, y1_again = fn(carry, frames[1])
    assert fn.captures == 1
    assert [t.data_ptr() for t in _leaves_of(fn.carry)] == static
    assert carry is fn.carry
    assert torch.equal(y1_again, y1)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["spectrum fused", "fm kernel"])
def test_chains_recover_bit_exact_at_k4_on_card(cuda_device, name):
    """``VectorSource -> TpuKernel(restart) -> VectorSink`` at K = 4 with a
    dispatch fault mid-stream: the output is the fault-free run's bit for
    bit, frames were replayed, and the program captured once."""
    from futuresdr_tpu_torch import BlockPolicy, Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
    from futuresdr_tpu_torch.runtime import faults
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
    rng = np.random.default_rng(73)
    stages, frame = _chain(name)
    host = _input(name, 13 * frame + frame // 3, rng)
    out = {}
    for fault in (False, True):
        kern = TpuKernel(_chain(name)[0], np.complex64, frame_size=frame,
                         inst=TpuInstance(cuda_device), frames_in_flight=3,
                         frames_per_dispatch=4, wire="f32")
        kern.policy = BlockPolicy(on_error="restart", max_restarts=3, backoff=0.0)
        fg = Flowgraph()
        snk = VectorSink(kern.pipeline.out_dtype)
        fg.connect(VectorSource(host), kern, snk)
        plan = faults.reset()
        if fault:
            plan.arm(f"dispatch:{fg.wrapped(kern).instance_name}", rate=0.5, seed=2,
                     max_faults=1, transient=False)
        try:
            Runtime().run(fg, timeout=120)
        finally:
            faults.reset()
        out[fault] = snk.items()
        if fault:
            assert fg.wrapped(kern).restarts == 1 and kern.frames_replayed > 0
            assert kern._fn.captures == 1 and len(kern._programs) == 1
    np.testing.assert_array_equal(out[True], out[False])


# ---------------------------------------------------------------------------
# precision and tuning: the int8 rungs, the plan sweep's layouts, the tuned
# plans and an interior-precision kernel, on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("decim", [1, 16])
def test_int8_rungs_equal_the_cpu_on_card(cuda_device, decim):
    """The banded int8 FIR (``torch._int_mm``) and the int8 shifted matvec
    give the CPU's bits: correctly rounded quotients, exact accumulators."""
    from futuresdr_tpu_torch.dsp import firdes
    from futuresdr_tpu_torch.ops.stages import Pipeline, fir_stage
    taps = firdes.lowpass(0.2, 64) if decim == 1 else firdes.lowpass(0.04, 128)
    pipe = Pipeline([fir_stage(taps, decim=decim, precision="int8")], np.complex64)
    rng = np.random.default_rng(decim)
    frames = [_c64(rng, 1 << 16) for _ in range(2)]
    outs = {}
    for dev in (cuda_device, torch.device("cpu")):
        c, fn, ys = pipe.init_carry(dev), pipe.fn(), []
        for f in frames:
            c, y = fn(c, torch.from_numpy(f).to(dev))
            ys.append(y.cpu())
        outs[dev.type] = torch.cat(ys)
    assert torch.equal(torch.view_as_real(outs["cuda"]), torch.view_as_real(outs["cpu"]))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["fir", "fir_fft", "poly_fir", "pfb", "rotator",
                                    "quad_demod", "fir_lanes", "fir_fft_lanes",
                                    "poly_fir_lanes", "pfb_lanes"])
def test_sweep_candidates_launch_and_match_plain_on_card(cuda_device, kernel):
    """Every layout the plan sweep may pick launches at the main paths'
    shapes and matches the plain version at phase 7's limits."""
    from futuresdr_tpu_torch.tpu import kernel_tune
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    for k, _label, spec in kernel_tune.SHAPES:
        if k != kernel:
            continue
        shape, args, call, plain = kernel_tune._workload(k, spec, cuda_device, 1, gen)
        ref = plain(*args[0])
        for plan in ck.plan_candidates(k, *shape):
            got = call(plan, *args[0])
            torch.cuda.synchronize()
            assert kernel_tune._err(k, got, ref) <= kernel_tune.TOL[k], (shape, plan)


@pytest.mark.gpu
def test_tuned_plan_reaches_the_launch_on_card(cuda_device):
    """A plan in the tuned table is the one the next plan-less launch takes;
    a plan passed by the caller beats the table."""
    rng = np.random.default_rng(3)
    n, nt = 1 << 18, 64
    taps = torch.from_numpy(rng.standard_normal(nt).astype(np.float32)).to(cuda_device)
    h = torch.from_numpy(_c64(rng, nt - 1)).to(cuda_device)
    x = torch.from_numpy(_c64(rng, n)).to(cuda_device)
    shape = (n, nt, 1, ck._sm_count(cuda_device))
    cands = ck.plan_candidates("fir", *shape)
    try:
        ck.set_tuned_plans({"fir": {shape: cands[-1]}})
        y = ck.fir_continue(h, x, taps)
        assert ck.last_plans["fir"] == cands[-1]
        y2 = ck.fir_continue(h, x, taps, plan=cands[1])
        assert ck.last_plans["fir"] == cands[1]
        ref = ck.fir_continue_plain(h, x, taps)
        assert _rel_err(y, ref) <= 1e-5 and _rel_err(y2, ref) <= 1e-5
    finally:
        ck.set_tuned_plans(None)


@pytest.mark.gpu
def test_interior_precision_kernel_streams_on_card(cuda_device):
    """The spectrum chain through ``TpuKernel`` with ``interior_precision=
    "auto"``, calibrated on the card: within the plan's floor of the f32
    stream (budget 40 dB less 10·log10 of the lowered stages)."""
    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
    from futuresdr_tpu_torch.dsp import firdes
    from futuresdr_tpu_torch.ops.stages import fft_stage, fir_stage, mag2_stage
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
    inst = TpuInstance(cuda_device)
    data = _c64(np.random.default_rng(4), 6 << 16)
    outs = {}
    for mode in ("off", "auto"):
        fg = Flowgraph()
        tk = TpuKernel([fir_stage(firdes.lowpass(0.2, 64)), fft_stage(2048), mag2_stage()],
                       np.complex64, frame_size=1 << 16, inst=inst, wire="f32",
                       interior_precision=mode)
        snk = VectorSink(np.float32)
        fg.connect(VectorSource(data), tk, snk)
        Runtime().run(fg)
        outs[mode] = (snk.items(), tk)
    ref, (got, tk) = outs["off"][0], outs["auto"]
    n_low = tk._precision_plan.lowered
    assert n_low >= 1 and len(got) == len(ref)
    snr = 10 * np.log10(np.mean(ref.astype(np.float64) ** 2)
                        / np.mean((got.astype(np.float64) - ref) ** 2))
    assert snr >= 40.0 - 10 * np.log10(n_low)


# ---------------------------------------------------------------------------
# the serving plane: the lane kernels and the served slot program
# ---------------------------------------------------------------------------

def _lane_cases():
    """(kernel, L, case): every lane form at L = 1, 3, 4, 16, 64 with each
    lane's own taps, history and phase; the FIR lane forms at L = 3 and 16
    with shared taps (one row expanded, stride 0), in bf16, and on a layout
    other than the rule's (``fir``: one warp a lane walking three tiles, the
    last ragged, with two buffers; ``fir_fft``: the table read through L1);
    ``fir`` on a real stream."""
    cases = [(k, L, "own") for k in ("fir", "fir_fft", "rotator") for L in (1, 3, 4, 16, 64)]
    cases += [(k, L, c) for k in ("fir", "fir_fft") for L in (3, 16)
              for c in ("shared", "bf16", "layout")]
    return cases + [("fir", L, "real") for L in (3, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,L,case", _lane_cases())
def test_lane_kernel_equals_one_stream_launches_on_card(cuda_device, kernel, L, case):
    """Each lane of a lane launch equals the one-stream launch on its row bit
    for bit (distinct taps, histories and phases a lane, or shared taps), one
    launch in all, and lies within its kernel's tolerance of the lane plain
    version (fir 1e-5, fir_fft 1e-4)."""
    g = torch.Generator(device=cuda_device).manual_seed(L)
    n = 1 << 14 if kernel == "fir_fft" else 513 if kernel == "rotator" else 512
    if kernel == "fir" and case == "layout":
        n += 8                                        # three tiles, the last ragged
    nt = 64 if kernel == "fir_fft" else 17
    dtype = torch.float32 if case == "real" else torch.complex64
    x = torch.randn(L, n, dtype=dtype, generator=g, device=cuda_device)
    hist = torch.randn(L, nt - 1, dtype=dtype, generator=g, device=cuda_device)
    taps = torch.randn(L, nt, generator=g, device=cuda_device)
    if case == "shared":
        taps = taps[:1].expand(L, nt)
    prec = "bf16" if case == "bf16" else None
    plan = None
    if case == "layout" and kernel == "fir":
        plan = ck.FirPlan(32, 1, 3, 2, ck._fir_smem(1, 2, nt, 3, 8))
    elif case == "layout":
        shape = (L, n, 2048, nt, ck._sm_count(cuda_device))
        plan = next(p for p in ck.plan_candidates("fir_fft_lanes", *shape)
                    if not p.tw_staged and p.pad_shift == 4)
    ph0 = torch.rand(L, generator=g, device=cuda_device) * 6
    inc = torch.rand(L, generator=g, device=cuda_device) * 0.2 - 0.1
    name = ck.LANE_KERNELS[kernel]
    before = ck.launches[name]
    if kernel == "fir":
        got = ck.fir_lanes(hist, x, taps, prec, plan=plan)
        per = [ck.fir_continue(hist[i], x[i], taps[i].contiguous(), prec) for i in range(L)]
        plain = ck.fir_lanes_plain(hist, x, taps, prec)
    elif kernel == "fir_fft":
        got = ck.fir_fft_lanes(hist, x, taps, 2048, prec, plan=plan)
        per = [ck.fir_fft(hist[i], x[i], taps[i].contiguous(), 2048, prec) for i in range(L)]
        plain = ck.fir_fft_lanes_plain(hist, x, taps, 2048, prec)
    else:
        got, nxt = ck.rotator_lanes(x, ph0, inc)
        pairs = [ck.rotator(x[i], ph0[i], inc[i]) for i in range(L)]
        per = [p[0] for p in pairs]
        assert torch.equal(nxt, torch.stack([p[1] for p in pairs]))
        plain = ck.rotator_lanes_plain(x, ph0, inc)[0]
    torch.cuda.synchronize()
    assert ck.launches[name] == before + 1
    assert torch.equal(got, torch.stack(per))
    assert _rel_err(got, plain) <= (1e-4 if kernel == "fir_fft" else 1e-5)


# the FM chain's two polyphase calls at the served FM frame (32,000 input
# samples a session): the channel filter (D 4, m 32, complex) and the
# resampler (24/125, m 2, real)
_POLY_LANES = {"channel": (4, 32, 1, 8000, torch.complex64),
               "resampler": (125, 2, 24, 64, torch.float32)}


@pytest.mark.gpu
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("L", [1, 3, 16, 64])
@pytest.mark.parametrize("kind", list(_POLY_LANES))
def test_poly_fir_lanes_equals_one_stream_launches_on_card(cuda_device, kind, L, precision,
                                                           shared):
    """Each lane of a ``poly_fir_lanes`` launch equals the one-stream launch
    on its row bit for bit, with each lane's own W or one W shared by every
    lane (stride 0, not copied), one launch in all, and lies within 1e-5 of
    the lane plain version."""
    D, m, I, nq, dtype = _POLY_LANES[kind]
    g = torch.Generator(device=cuda_device).manual_seed(L + 10 * shared)
    w_shape = (m + 1, D) if I == 1 else (m + 1, D, I)
    W = torch.randn((1 if shared else L,) + w_shape, generator=g, device=cuda_device)
    if precision == "bf16":
        W = W.to(torch.bfloat16)
    if shared:
        W = W.expand((L,) + w_shape)
        assert W.stride(0) == 0 or L == 1
    hist = torch.randn(L, m * D, dtype=dtype, generator=g, device=cuda_device)
    x = torch.randn(L, nq * D, dtype=dtype, generator=g, device=cuda_device)
    before = dict(ck.launches)
    got = ck.poly_fir_lanes(hist, x, W, precision)
    torch.cuda.synchronize()
    assert ck.launches["poly_fir_lanes"] == before["poly_fir_lanes"] + 1
    assert ck.launches["poly_fir"] == before["poly_fir"]
    per = torch.stack([ck.poly_fir(hist[i], x[i], W[i].contiguous(), precision)
                       for i in range(L)])
    torch.cuda.synchronize()
    assert got.shape == per.shape and torch.equal(got, per)
    assert _rel_err(got, ck.poly_fir_lanes_plain(hist, x, W, precision)) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("L", [16, 64])
@pytest.mark.parametrize("kind", list(_POLY_LANES))
def test_poly_fir_lane_walks_equal_one_stream_launches_on_card(cuda_device, kind, L):
    """At the served FM shapes (16 and 64 sessions), every layout of the lane
    walk that the plan sweep may pick (the channel filter's resident blocks
    over every lane's tiles or a block a tile, at 128, 64 and 32 threads; the
    resampler's rows a block) gives each lane the bits of the one-stream
    launch on its row, with each lane's W (channel) or one W shared
    (resampler)."""
    D, m, I, nq, dtype = _POLY_LANES[kind]
    g = torch.Generator(device=cuda_device).manual_seed(L + 7)
    w_shape = (m + 1, D) if I == 1 else (m + 1, D, I)
    W = torch.randn((L if kind == "channel" else 1,) + w_shape, generator=g,
                    device=cuda_device).expand((L,) + w_shape)
    hist = torch.randn(L, m * D, dtype=dtype, generator=g, device=cuda_device)
    x = torch.randn(L, nq * D, dtype=dtype, generator=g, device=cuda_device)
    per = torch.stack([ck.poly_fir(hist[i], x[i], W[i].contiguous()) for i in range(L)])
    plans = ck.plan_candidates("poly_fir_lanes", L, m, D, I, nq, int(dtype == torch.complex64),
                               ck._sm_count(x.device))
    assert plans[0] == ck.poly_fir_lanes_plan(L, m, D, I, nq, dtype == torch.complex64,
                                              ck._sm_count(x.device))
    for plan in plans:
        got = ck.poly_fir_lanes(hist, x, W, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(got, per), plan


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 3, 64])
def test_quad_demod_lanes_equals_one_stream_launches_on_card(cuda_device, L):
    """Each lane of a ``quad_demod_lanes`` launch equals the one-stream
    launch on its row from its own carry sample bit for bit, outputs and next
    carries, one launch in all, and lies within 1e-5 (radians times gain,
    wrapped) of the lane plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(L)
    x = torch.randn(L, 8000, dtype=torch.complex64, generator=g, device=cuda_device)
    prev = torch.randn(L, dtype=torch.complex64, generator=g, device=cuda_device)
    gain = 0.53
    before = ck.launches["quad_demod_lanes"]
    got, last = ck.quad_demod_lanes(prev, x, gain)
    torch.cuda.synchronize()
    assert ck.launches["quad_demod_lanes"] == before + 1
    pairs = [ck.quad_demod(prev[i], x[i], gain) for i in range(L)]
    assert torch.equal(got, torch.stack([p[0] for p in pairs]))
    assert torch.equal(last, torch.stack([p[1] for p in pairs])) and torch.equal(last, x[:, -1])
    ref = ck.quad_demod_lanes_plain(prev, x, gain)[0]
    d = (got - ref).double()
    period = 2 * np.pi * gain
    assert float((d - period * torch.round(d / period)).abs().max()) <= 1e-5


def _qd_wrapped_err(got, ref, gain):
    d = (got - ref).double()
    period = 2 * np.pi * gain
    return float((d - period * torch.round(d / period)).abs().max()) if d.numel() else 0.0


def _qd_equals_one_stream(prev, x, gain):
    """One ``quad_demod_lanes`` launch on ``x``, each lane held bit for bit to
    the one-stream launch on its row (outputs and next carries) and within
    1e-5 (wrapped) of the lane plain version."""
    before = ck.launches["quad_demod_lanes"]
    got, last = ck.quad_demod_lanes(prev, x, gain)
    torch.cuda.synchronize()
    assert ck.launches["quad_demod_lanes"] == before + 1
    pairs = [ck.quad_demod(prev[i], x[i], gain) for i in range(x.shape[0])]
    assert torch.equal(got, torch.stack([p[0] for p in pairs]))
    assert torch.equal(last, torch.stack([p[1] for p in pairs])) and torch.equal(last, x[:, -1])
    assert _qd_wrapped_err(got, ck.quad_demod_lanes_plain(prev, x, gain)[0], gain) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("L, n", [(16, 8000), (64, 8000), (64, 8002), (7, 8001), (3, 1022),
                                  (5, 2), (3, 1), (1, 128_000)])
def test_quad_demod_lanes_served_and_ragged_batches_equal_one_stream_launches_on_card(
        cuda_device, L, n):
    """The served 16 and 64 × 8,000 and ragged batches (an even n past the
    served one, odd n, rows of one and two samples, one long lane): each lane
    bit-equal to its one-stream launch, one launch a call."""
    g = torch.Generator(device=cuda_device).manual_seed(100_003 * L + n)
    x = torch.randn(L, n, dtype=torch.complex64, generator=g, device=cuda_device)
    prev = torch.randn(L, dtype=torch.complex64, generator=g, device=cuda_device)
    _qd_equals_one_stream(prev, x, 0.53)


@pytest.mark.gpu
@pytest.mark.parametrize("stride, offset", [(8008, 0), (8000, 1)])
def test_quad_demod_lanes_strided_rows_equal_one_stream_launches_on_card(cuda_device, stride,
                                                                        offset):
    """Rows a stride wider than n apart, and a batch 8 bytes off a 16-byte
    boundary: the lane grid reads each row through its stride, each lane
    bit-equal to its one-stream launch."""
    g = torch.Generator(device=cuda_device).manual_seed(stride + offset)
    buf = torch.randn(offset + 16 * stride, dtype=torch.complex64, generator=g,
                      device=cuda_device)
    x = buf[offset:].view(16, stride)[:, :8000]
    prev = torch.randn(16, dtype=torch.complex64, generator=g, device=cuda_device)
    _qd_equals_one_stream(prev, x, 0.53)


@pytest.mark.gpu
def test_lane_forms_of_the_fm_kernels_take_empty_batches_on_card(cuda_device):
    """No lane or no sample: an empty result of the right shape, the carry
    passed on, and no launch."""
    before = dict(ck.launches)
    c64 = dict(dtype=torch.complex64, device=cuda_device)
    y, last = ck.quad_demod_lanes(torch.zeros(0, **c64), torch.zeros(0, 500, **c64), 1.0)
    assert y.shape == (0, 500) and last.shape == (0,)
    prev = torch.ones(3, **c64)
    y, last = ck.quad_demod_lanes(prev, torch.zeros(3, 0, **c64), 1.0)
    assert y.shape == (3, 0) and torch.equal(last, prev)
    W = torch.ones(0, 3, 125, 24, device=cuda_device)
    y = ck.poly_fir_lanes(torch.zeros(0, 250, device=cuda_device),
                          torch.zeros(0, 500, device=cuda_device), W)
    assert y.shape == (0, 4, 24)
    y = ck.poly_fir_lanes(torch.zeros(2, 128, **c64), torch.zeros(2, 0, **c64),
                          torch.ones(2, 33, 4, device=cuda_device))
    assert y.shape == (2, 0)
    torch.cuda.synchronize()
    assert ck.launches == before


@pytest.mark.gpu
def test_vmap_of_the_fm_kernels_takes_one_lane_launch_on_card(cuda_device):
    """``torch.func.vmap`` over ``poly_fir`` (each lane's W, and one W for
    every lane) and ``quad_demod`` launches the lane form once, not the
    one-stream kernel once a lane, and equals the one-stream launches."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    L = 16
    x = torch.randn(L, 500, dtype=torch.float32, generator=g, device=cuda_device)
    hist = torch.randn(L, 250, dtype=torch.float32, generator=g, device=cuda_device)
    W = torch.randn(3, 125, 24, generator=g, device=cuda_device)
    Ws = torch.randn(L, 3, 125, 24, generator=g, device=cuda_device)
    z = torch.randn(L, 500, dtype=torch.complex64, generator=g, device=cuda_device)
    prev = torch.randn(L, dtype=torch.complex64, generator=g, device=cuda_device)
    vm = torch.func.vmap
    before = dict(ck.launches)
    shared = vm(ck.poly_fir, in_dims=(0, 0, None))(hist, x, W)
    own = vm(ck.poly_fir)(hist, x, Ws)
    q, last = vm(lambda p, a: ck.quad_demod(p, a, 0.7))(prev, z)
    torch.cuda.synchronize()
    assert ck.launches["poly_fir_lanes"] == before["poly_fir_lanes"] + 2
    assert ck.launches["quad_demod_lanes"] == before["quad_demod_lanes"] + 1
    assert ck.launches["poly_fir"] == before["poly_fir"]
    assert ck.launches["quad_demod"] == before["quad_demod"]
    for i in range(L):
        assert torch.equal(shared[i], ck.poly_fir(hist[i], x[i], W))
        assert torch.equal(own[i], ck.poly_fir(hist[i], x[i], Ws[i]))
        qi, li = ck.quad_demod(prev[i], z[i], 0.7)
        assert torch.equal(q[i], qi) and torch.equal(last[i], li)


@pytest.mark.gpu
def test_served_fm_chain_bit_equals_bare_pipeline_on_card(cuda_device):
    """The FM kernel chain served to three sessions at their own offsets (a
    lane retune of the rotator's increment), one joining late: each equals
    the bare compiled Pipeline built at its offset bit for bit; one capture
    whose replay launches the rotator, demod and two polyphase lane forms."""
    from futuresdr_tpu_torch.dsp import firdes
    from futuresdr_tpu_torch.ops import stages as T
    from futuresdr_tpu_torch.serve import ServeEngine

    def chain(theta):
        return T.Pipeline([T.rotator_stage(theta, name="tuner", impl="pallas"),
                           T.fir_stage(firdes.lowpass(0.1, 128), decim=4, impl="pallas",
                                       name="chan"),
                           T.quad_demod_stage(0.53, impl="pallas"),
                           T.resample_stage(24, 125, impl="pallas")], np.complex64)

    frame = 32_000
    rng = np.random.default_rng(11)
    feed = [_c64(rng, frame) for _ in range(4)]
    thetas = (-0.6, 0.3, 1.1)
    eng = ServeEngine(chain(0.0), frame_size=frame, app="gpu_fm", buckets=(4,),
                      queue_frames=8, device=cuda_device)
    sess, out = {}, {0: [], 1: [], 2: []}
    for j in range(4):
        for i, th in enumerate(thetas):
            if j == (2 if i == 2 else 0):
                sess[i] = eng.admit(tenant=f"t{i}")
                eng.retune(sess[i].sid, "tuner", phase_inc=th)
        for s in sess.values():
            eng.submit(s.sid, feed[j])
        eng.step()
        for i, s in sess.items():
            out[i] += eng.results(s.sid)
    assert eng.compiles == 1
    prog = next(iter(eng._programs.values()))
    assert prog.launches == {"rotator_lanes": 1, "poly_fir_lanes": 2, "quad_demod_lanes": 1}
    for i, th in enumerate(thetas):
        pipe = chain(th)
        fn, _ = pipe.compile(frame, cuda_device, donate=False)
        carry = pipe.init_carry(cuda_device)
        frames = feed[2:] if i == 2 else feed
        assert len(out[i]) == len(frames)
        for got, f in zip(out[i], frames):
            carry, y = fn(carry, torch.from_numpy(f).to(cuda_device))
            np.testing.assert_array_equal(got, y.cpu().numpy())


def _pfb_lanes_args(dev, L, N, K, t, seed, shared=False, bf16=False):
    """L lanes of history and frame, and taps as the stage passes them: its
    ``[L, N, K]`` carry transposed, bf16 as the bf16 stage carries them, one
    expanded with stride 0 where ``shared``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    hc = torch.randn(1 if shared else L, N, K, generator=g, device=dev)
    if bf16:
        hc = hc.to(torch.bfloat16)
    taps = hc.expand(L, N, K).transpose(1, 2)
    hist = torch.randn(L, (K - 1) * N, dtype=torch.complex64, generator=g, device=dev)
    x = torch.randn(L, t * N, dtype=torch.complex64, generator=g, device=dev)
    return hist, x, taps


def _v_plan(N):
    return ck.PfbPlan(False, 256, N, 1, 1, 1, 0, (), (), (), N, N, ck._NO_PAD, False, 8 * N)


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 3, 16])
@pytest.mark.parametrize("case", ["PFB-64", "PFB-64 bf16", "PFB-64 shared", "PFB-2048",
                                  "v pow2", "v direct"])
def test_pfb_lanes_equals_one_stream_launches_on_card(cuda_device, case, L):
    """Each lane of a ``pfb_lanes`` launch equals the one-stream ``pfb``
    launch on its row bit for bit, one launch in all: PFB-64 at 512 rows a
    lane in f32 and bf16 and with one prototype shared (stride 0, not
    copied), PFB-2048, and the v layout forced on both sides (N = 2048,
    radix 2; N = 1000, the direct DFT). f32 lies within 1e-5 of the lane
    plain version; bf16 at the one-stream kernel's SNR."""
    N, t = {"v pow2": (2048, 5), "v direct": (1000, 5), "PFB-2048": (2048, 128)}.get(
        case, (64, 512))
    bf16 = case.endswith("bf16")
    prec = "bf16" if bf16 else None
    hist, x, taps = _pfb_lanes_args(cuda_device, L, N, 12, t, L + len(case),
                                    shared=case.endswith("shared"), bf16=bf16)
    if case.endswith("shared") and L > 1:
        assert taps.stride(0) == 0
    plan = _v_plan(N) if case.startswith("v ") else None
    before = dict(ck.launches)
    got = ck.pfb_lanes(hist, x, taps, prec, plan=plan)
    torch.cuda.synchronize()
    assert ck.launches["pfb_lanes"] == before["pfb_lanes"] + 1
    assert ck.launches["pfb"] == before["pfb"]
    if plan is None:
        per = [ck.pfb(hist[i], x[i], taps[i], prec) for i in range(L)]
    else:
        per = [ck._launch_pfb(hist[i], x[i], taps[i], torch.empty(
            (t, N), dtype=torch.complex64, device=cuda_device), bf16, plan) for i in range(L)]
    per = torch.stack(per)
    torch.cuda.synchronize()
    assert got.shape == per.shape == (L, t, N) and torch.equal(got, per)
    ref = ck.pfb_lanes_plain(hist, x, taps, prec)
    if bf16:
        assert _snr_db(got, ref) >= PFB_BF16_SNR
    else:
        assert _rel_err(got, ref) <= 1e-5


@pytest.mark.gpu
def test_pfb_lanes_refuses_a_plan_of_another_layout_size_on_card(cuda_device):
    """The lane entry keeps the one-stream plan's checks: a plan whose shared
    memory is not its layout's is refused with cudaErrorInvalidValue, and
    nothing is counted; no lane or no row launches nothing."""
    hist, x, taps = _pfb_lanes_args(cuda_device, 3, 64, 12, 64, 1)
    plan = ck.pfb_lanes_plan(3, 64, 12, 64)
    before = dict(ck.launches)
    with pytest.raises(RuntimeError, match="pfb_lanes"):
        ck.pfb_lanes(hist, x, taps, plan=plan._replace(smem=plan.smem + 8))
    y = ck.pfb_lanes(hist[:0], x[:0], taps[:0])
    assert y.shape == (0, 64, 64)
    y = ck.pfb_lanes(hist, x[:, :0], taps)
    assert y.shape == (3, 0, 64)
    torch.cuda.synchronize()
    assert ck.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("shared", [False, True])
def test_vmap_of_pfb_takes_one_lane_launch_on_card(cuda_device, shared):
    """``torch.func.vmap`` over ``pfb`` with each lane's taps (the carry's
    transposed view, batched) or one prototype for every lane (unbatched)
    launches the lane form once, not the one-stream kernel once a lane, and
    equals the one-stream launches."""
    L, N, K, t = 16, 64, 12, 512
    hist, x, taps = _pfb_lanes_args(cuda_device, L, N, K, t, 9)
    hc = taps.transpose(1, 2).contiguous()          # [L, N, K], the carry
    vm = torch.func.vmap
    before = dict(ck.launches)
    if shared:
        got = vm(ck.pfb, in_dims=(0, 0, None))(hist, x, hc[0].t())
    else:
        got = vm(lambda h, a, c: ck.pfb(h, a, c.t()))(hist, x, hc)
    torch.cuda.synchronize()
    assert ck.launches["pfb_lanes"] == before["pfb_lanes"] + 1
    assert ck.launches["pfb"] == before["pfb"]
    for i in range(L):
        assert torch.equal(got[i], ck.pfb(hist[i], x[i], hc[0 if shared else i].t()))


@pytest.mark.gpu
def test_served_channelizer_bit_equals_bare_pipeline_on_card(cuda_device):
    """PFB-64 served to three sessions, one on its own prototype (a lane
    retune at admission), one joining late: each equals the bare compiled
    Pipeline built with its prototype bit for bit; one capture whose replay
    launches ``pfb_lanes`` once."""
    from futuresdr_tpu_torch.blocks import pfb_default_taps
    from futuresdr_tpu_torch.ops import stages as T
    from futuresdr_tpu_torch.serve import ServeEngine

    def chain(taps=None):
        return T.Pipeline([T.channelizer_stage(64, pfb_default_taps(64) if taps is None
                                               else taps, impl="pallas")], np.complex64)

    frame = 1 << 15
    rng = np.random.default_rng(12)
    feeds = [[_c64(rng, frame) for _ in range(4)] for _ in range(3)]
    own = pfb_default_taps(64, atten_db=80.0)
    eng = ServeEngine(chain(), frame_size=frame, app="gpu_pfb", buckets=(4,),
                      queue_frames=8, device=cuda_device)
    sess, out = {}, {0: [], 1: [], 2: []}
    for j in range(4):
        for i in range(3):
            if j == (2 if i == 2 else 0):
                sess[i] = eng.admit(tenant=f"t{i}")
                if i == 1:
                    eng.retune(sess[i].sid, "channelizer", taps=own)
        for i, s in sess.items():
            eng.submit(s.sid, feeds[i][j])
        eng.step()
        for i, s in sess.items():
            out[i] += eng.results(s.sid)
    assert eng.compiles == 1
    prog = next(iter(eng._programs.values()))
    assert prog.launches == {"pfb_lanes": 1}
    for i in range(3):
        pipe = chain(own if i == 1 else None)
        fn, _ = pipe.compile(frame, cuda_device, donate=False)
        carry = pipe.init_carry(cuda_device)
        frames = feeds[i][2:] if i == 2 else feeds[i]
        assert len(out[i]) == len(frames)
        for got, f in zip(out[i], frames):
            carry, y = fn(carry, torch.from_numpy(f).to(cuda_device))
            np.testing.assert_array_equal(got, y.cpu().numpy())


# (L, t, n_sm, mode) of the pfb walk on the card: the served shapes under
# the rule's plan (n_sm 0: the card's), runs of many tiles crossing lanes (a
# few resident blocks), ragged batches whose runs start inside a lane and
# whose last block holds fewer tiles, bf16 with bf16 taps, one prototype
# shared
_PFB_WALKS = {"64 x 2^15": (64, 512, 0, "f32"), "16 x 2^18": (16, 4096, 0, "f32"),
              "64 x 2^15 bf16": (64, 512, 0, "bf16"), "64 x 2^15 shared": (64, 512, 0, "shared"),
              "long runs": (7, 512, 3, "f32"), "ragged": (5, 37, 3, "f32"),
              "part-filled tiles end runs": (5, 100, 2, "f32"), "ragged bf16": (9, 70, 3, "bf16")}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_PFB_WALKS))
def test_pfb_lanes_walk_equals_one_stream_launches_on_card(cuda_device, case):
    """Every lane of the walk (PFB-64) equals the one-stream ``pfb`` launch
    on its row bit for bit, one ``pfb_lanes`` launch and no ``pfb`` in all,
    the plan that ran recorded; f32 within 1e-5 of the lane plain version,
    bf16 at the one-stream kernel's SNR."""
    L, t, n_sm, mode = _PFB_WALKS[case]
    N, K = 64, 12
    prec = "bf16" if mode == "bf16" else None
    hist, x, taps = _pfb_lanes_args(cuda_device, L, N, K, t, L + t, shared=mode == "shared",
                                    bf16=mode == "bf16")
    if n_sm:
        plan = ck._pfb_walk(ck._pfb_rule(N, K, L * t, n_sm), N, K, n_sm)
    else:
        plan = ck.pfb_lanes_plan(L, N, K, t, ck._sm_count(cuda_device))
    assert plan.blocks
    before = dict(ck.launches)
    got = ck.pfb_lanes(hist, x, taps, prec, plan=None if not n_sm else plan)
    torch.cuda.synchronize()
    assert ck.last_plans["pfb_lanes"] == plan
    assert ck.launches["pfb_lanes"] == before["pfb_lanes"] + 1
    assert ck.launches["pfb"] == before["pfb"]
    per = torch.stack([ck.pfb(hist[i], x[i], taps[i], prec) for i in range(L)])
    torch.cuda.synchronize()
    assert got.shape == per.shape == (L, t, N) and torch.equal(got, per)
    ref = ck.pfb_lanes_plain(hist, x, taps, prec)
    if prec:
        assert _snr_db(got, ref) >= PFB_BF16_SNR
    else:
        assert _rel_err(got, ref) <= 1e-5


@pytest.mark.gpu
def test_pfb_lanes_walk_refuses_a_misaligned_lane_on_card(cuda_device):
    """A walk plan on rows that do not start 16-byte aligned is refused with
    cudaErrorInvalidValue and counts nothing; the rule takes the window
    layout for them, bit-equal to the one-stream launches."""
    L, N, K, t = 4, 64, 12, 64
    hist, x, taps = _pfb_lanes_args(cuda_device, L, N, K, t, 3)
    buf = torch.empty(L * t * N + 1, dtype=torch.complex64, device=cuda_device)
    xm = buf[1:].view(L, t * N)
    xm.copy_(x)
    walk = ck._pfb_walk(ck._pfb_rule(N, K, L * t, 2), N, K, 2)
    before = dict(ck.launches)
    with pytest.raises(RuntimeError, match="pfb_lanes"):
        ck.pfb_lanes(hist, xm, taps, plan=walk)
    assert ck.launches == before
    got = ck.pfb_lanes(hist, xm, taps)
    assert not ck.last_plans["pfb_lanes"].blocks
    per = torch.stack([ck.pfb(hist[i], x[i], taps[i]) for i in range(L)])
    torch.cuda.synchronize()
    assert torch.equal(got, per)


@pytest.mark.gpu
def test_lane_fir_refuses_unaligned_rows_on_card(cuda_device):
    x = torch.zeros(2, 511, dtype=torch.complex64, device=cuda_device)
    taps = torch.ones(2, 5, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        ck.fir_lanes(None, x, taps)


def _serve_chain(name):
    from futuresdr_tpu_torch.ops import stages as T
    if name == "main":
        return T.Pipeline([T.fir_fft_stage(np.hanning(64).astype(np.float32), 2048),
                           T.mag2_stage()], np.complex64)
    return T.Pipeline([T.rotator_stage(0.013, impl="pallas"),
                       T.fir_stage(np.hanning(17).astype(np.float32), fft_len=128,
                                   impl="pallas")], np.complex64)


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("chain,frame", [("main", 1 << 14), ("ab", 512)])
def test_served_chain_bit_equals_bare_pipeline_on_card(cuda_device, chain, frame, depth):
    """Sessions served in one bucket, one joining late and one stalled for a
    frame, each equal the bare compiled Pipeline on its frames bit for bit;
    one capture, the lane kernels counted a replay."""
    from futuresdr_tpu_torch.serve import ServeEngine
    rng = np.random.default_rng(7)
    data = [[_c64(rng, frame) for _ in range(4)] for _ in range(3)]
    pipe = _serve_chain(chain)
    fn, _ = pipe.compile(frame, cuda_device, donate=False)
    refs = []
    for d in data:
        carry, out = pipe.init_carry(cuda_device), []
        for f in d:
            carry, y = fn(carry, torch.from_numpy(f).to(cuda_device))
            out.append(y.cpu().numpy())
        refs.append(out)
    eng = ServeEngine(_serve_chain(chain), frame_size=frame, app=f"gpu_{chain}{depth}",
                      buckets=(4,), queue_frames=8, device=cuda_device, inflight=depth)
    a, b = eng.admit(tenant="a"), eng.admit(tenant="b")
    eng.submit(a.sid, data[0][0])
    eng.submit(b.sid, data[1][0])
    eng.step()
    c = eng.admit(tenant="c")                 # joins after the first dispatch
    cursor = {a.sid: 1, b.sid: 1, c.sid: 0}
    for j in range(1, 6):
        for s, d in zip((a, b, c), data):
            if cursor[s.sid] < 4 and not (s is b and j == 2):   # b stalls a frame time
                eng.submit(s.sid, d[cursor[s.sid]])
                cursor[s.sid] += 1
        eng.step()
    while eng.step():
        pass
    for s, ref in zip((a, b, c), refs):
        got = eng.results(s.sid)
        assert len(got) == 4
        for x, y in zip(got, ref):
            np.testing.assert_array_equal(x, y)
    assert eng.compiles == 1
    prog = next(iter(eng._programs.values()))
    assert prog.captured and prog.launches


@pytest.mark.gpu
def test_served_evict_readmit_and_retune_capture_nothing_on_card(cuda_device):
    from futuresdr_tpu_torch.serve import ServeEngine
    rng = np.random.default_rng(8)
    eng = ServeEngine(_serve_chain("ab"), frame_size=512, app="gpu_surgery", buckets=(2,),
                      queue_frames=8, device=cuda_device)
    s = eng.admit(tenant="t")
    for _ in range(2):
        eng.submit(s.sid, _c64(rng, 512))
        eng.step()
    eng.evict(s.sid)
    eng.readmit(s.sid)
    eng.retune(s.sid, "rotator", phase_inc=0.05)
    for _ in range(2):
        eng.submit(s.sid, _c64(rng, 512))
        eng.step()
    assert eng.compiles == 1 and len(eng.results(s.sid)) == 4


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_precision_brownout_serves_the_lowered_program_on_card(cuda_device, mode):
    """The brownout's precision rung builds its lowered program (one more
    capture) and serves within the rung's SNR of the base chain."""
    from futuresdr_tpu_torch.ops import stages as T
    from futuresdr_tpu_torch.serve import ServeEngine

    def mk():
        return T.Pipeline([T.fir_stage(np.hanning(31).astype(np.float32), fft_len=256),
                           T.rotator_stage(0.03)], np.complex64)

    rng = np.random.default_rng(9)
    data = [_c64(rng, 1024) for _ in range(3)]
    eng = ServeEngine(mk(), frame_size=1024, app=f"gpu_bp_{mode}", buckets=(2,),
                      queue_frames=8, device=cuda_device)
    eng._brownout, eng._brownout_prec = "precision", mode
    s = eng.admit(tenant="t")
    eng.submit(s.sid, data[0])
    eng.step()
    eng._set_brownout(True)
    assert eng._pipe_tag == mode
    eng.submit(s.sid, data[1])
    eng.step()
    out = eng.results(s.sid)
    pipe = mk()
    fn, _ = pipe.compile(1024, cuda_device, donate=False)
    carry = pipe.init_carry(cuda_device)
    ref = []
    for f in data[:2]:
        carry, y = fn(carry, torch.from_numpy(f).to(cuda_device))
        ref.append(y.cpu().numpy())
    np.testing.assert_array_equal(out[0], ref[0])
    err = np.mean(np.abs(out[1] - ref[1]) ** 2)
    snr = 10 * np.log10(np.mean(np.abs(ref[1]) ** 2) / max(err, 1e-30))
    assert snr >= (20.0 if mode == "int8" else 40.0), snr
    assert eng.compiles == 2


# ---------------------------------------------------------------------------
# the models' device plane: the Viterbi ACS kernel, the WLAN receiver, MCLDNN
# ---------------------------------------------------------------------------

def _trellis(device):
    from futuresdr_tpu_torch.models.wlan import coding
    return (torch.from_numpy(coding._PREV_S.astype(np.int32)).to(device),
            torch.from_numpy(coding._BM0.astype(np.float32)).to(device),
            torch.from_numpy(coding._BM1.astype(np.float32)).to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("batch,steps", [(1, 8), (8, 512), (3, 100), (256, 4096)])
def test_viterbi_kernel_picks_equal_plain_on_card(cuda_device, batch, steps):
    """The ACS kernel's picks equal its plain version's bit for bit (noisy
    LLRs; the all-zero input, where every compare is a tie, picks 0)."""
    from futuresdr_tpu_torch.ops import viterbi as V
    rng = np.random.default_rng(batch * steps)
    tables = _trellis(cuda_device)
    for lams in (rng.standard_normal((batch, steps, 2)).astype(np.float32) * 2,
                 np.zeros((batch, steps, 2), np.float32)):
        x = torch.from_numpy(lams).to(cuda_device)
        before = V.launches["viterbi"]
        got = V.acs(x, *tables)
        torch.cuda.synchronize()
        assert V.launches["viterbi"] == before + 1
        assert torch.equal(got, V.acs_plain(x, *tables))
    assert not got.any()


def _trellis_np(name: str):
    """``(prev_s, prev_b, bm0, bm1)`` numpy tables: 802.11's 64 states and
    M17's 16 (the butterfly route); 802.11's with its states relabelled by a
    seeded permutation that keeps state 0, and a random 12-state trellis (the
    generic route)."""
    from futuresdr_tpu_torch.models.m17 import codec
    from futuresdr_tpu_torch.models.wlan import coding
    if name == "m17":
        return codec._M17_PREV
    wlan = (coding._PREV_S, coding._PREV_B, coding._BM0, coding._BM1)
    rng = np.random.default_rng(16)
    if name == "wlan":
        return wlan
    if name == "relabelled":
        sigma = np.concatenate([[0], 1 + rng.permutation(63)])
        out = [np.empty_like(t) for t in wlan]
        out[0][sigma] = sigma[wlan[0]]
        for o, t in zip(out[1:], wlan[1:]):
            o[sigma] = t
        return tuple(out)
    return (rng.integers(0, 12, (12, 2)), rng.integers(0, 2, (12, 2)),
            rng.choice([-1.0, 1.0], (12, 2)), rng.choice([-1.0, 1.0], (12, 2)))


def _trellis_t(name: str, device):
    prev_s, prev_b, bm0, bm1 = _trellis_np(name)
    return tuple(torch.from_numpy(np.ascontiguousarray(t, dt)).to(device)
                 for t, dt in ((prev_s, np.int32), (prev_b, np.int32), (bm0, np.float32),
                               (bm1, np.float32)))


@pytest.mark.gpu
@pytest.mark.parametrize("trellis", ["wlan", "m17", "relabelled", "random12"])
@pytest.mark.parametrize("batch", [1, 8, 256])
def test_viterbi_survivors_and_bits_equal_plain_on_card(cuda_device, trellis, batch):
    """Ragged frames (each its own length, one the whole bucket): the
    kernel's survivors, unpacked, equal ``acs_plain``'s picks for t <
    steps[b] bit for bit (0 past them), and its decoded bits the plain
    traceback's, on noisy LLRs and on all-zero ones (every compare a tie);
    one launch each. Both routes: the butterfly (802.11, M17) and the generic
    one (a relabelled 802.11 trellis, a random 12-state one)."""
    from futuresdr_tpu_torch.ops import viterbi as V
    rng = np.random.default_rng(batch)
    ps, pb, b0, b1 = _trellis_t(trellis, cuda_device)
    S, T = int(ps.shape[0]), 512
    steps_np = rng.integers(1, T + 1, batch).astype(np.int32)
    steps_np[0] = T
    steps = torch.from_numpy(steps_np).to(cuda_device)
    live = (torch.arange(T, device=cuda_device)[:, None] < steps[None, :])[..., None]
    for lams in (rng.standard_normal((batch, T, 2)).astype(np.float32) * 2,
                 np.zeros((batch, T, 2), np.float32)):
        x = torch.from_numpy(lams).to(cuda_device)
        before = V.launches["viterbi"]
        words = V.survivors(x, steps, ps, b0, b1)
        bits = V.decode(x, steps, ps, pb, b0, b1)
        torch.cuda.synchronize()
        assert V.launches["viterbi"] == before + 2
        picks = V.unpack_survivors(words, S)
        want = V.acs_plain(x, ps, b0, b1) * live
        assert torch.equal(picks, want)
        assert torch.equal(bits, V.traceback_plain(V.pack_survivors(want), steps, ps, pb))
    if trellis != "random12":                 # there a tie can still meet a -1e18
        assert not picks.any() and not bits.any()


@pytest.mark.gpu
def test_viterbi_routes_agree_on_card(cuda_device):
    """A trellis and its relabelling decode the same bits: the butterfly
    route against the generic one on the same noisy codewords."""
    from futuresdr_tpu_torch.models.wlan import coding
    from futuresdr_tpu_torch.ops import viterbi as V
    rng = np.random.default_rng(64)
    bits = rng.integers(0, 2, (8, 700)).astype(np.uint8)
    bits[:, -6:] = 0
    coded = np.stack([coding.conv_encode(b) for b in bits]).astype(np.float32) * 2 - 1
    coded += 0.5 * rng.standard_normal(coded.shape).astype(np.float32)   # Eb/N0 6 dB
    x = torch.from_numpy(coded.reshape(8, 700, 2)).to(cuda_device)
    steps = torch.full((8,), 700, dtype=torch.int32, device=cuda_device)
    fly = V.decode(x, steps, *_trellis_t("wlan", cuda_device))
    generic = V.decode(x, steps, *_trellis_t("relabelled", cuda_device))
    assert torch.equal(fly, generic)
    assert (fly.cpu().numpy() != bits).mean() < 0.01


@pytest.mark.gpu
def test_sixteen_state_trellis_decodes_on_card(cuda_device):
    """M17's 16-state trellis through ``scan_viterbi`` on the card launches
    the kernel once and equals the CPU decode (a 64-state-only kernel raised
    here); a trellis above 64 states raises before any launch."""
    from futuresdr_tpu_torch.models.m17 import codec
    from futuresdr_tpu_torch.ops import viterbi as V
    rng = np.random.default_rng(17)
    llrs = (rng.standard_normal(1200) * 2).astype(np.float32)
    before = V.launches["viterbi"]
    got = V.scan_viterbi(llrs, 600, *codec._M17_PREV, device=cuda_device)
    assert V.launches["viterbi"] == before + 1
    assert np.array_equal(got, V.scan_viterbi(llrs, 600, *codec._M17_PREV, device="cpu"))
    big = np.zeros((128, 2), np.int64)
    with pytest.raises(ValueError, match="2 to 64 states"):
        V.scan_viterbi(llrs, 600, big, big, big * 1.0, big * 1.0, device=cuda_device)
    assert V.launches["viterbi"] == before + 1


@pytest.mark.gpu
def test_wlan_decode_on_card(cuda_device):
    """``perf/wlan.py``'s stream (20 frames) through ``decode_stream_batch``
    on the card: the CPU tensors' frames, one ACS launch; the demod head and
    body on the card within 2e-4 of the CPU (cuFFT and the card's sincos
    against the CPU's)."""
    from futuresdr_tpu_torch.models import wlan as W
    from futuresdr_tpu_torch.models.wlan.torch_demod import demod_body_torch, demod_head_torch
    from futuresdr_tpu_torch.ops import viterbi as V
    rng = np.random.default_rng(0)
    mac, parts, sent = W.Mac(), [], []
    for _ in range(20):
        psdu = mac.frame(bytes(rng.integers(0, 256, 256, dtype=np.uint8)))
        sent.append(psdu)
        parts += [W.encode_frame(psdu, "qpsk_1_2"), np.zeros(300, np.complex64)]
    sig = np.concatenate(parts)
    sigma = np.sqrt(np.mean(np.abs(sig) ** 2) * 10 ** (-25 / 10) / 2)
    sig = (sig + sigma * (rng.standard_normal(len(sig))
                          + 1j * rng.standard_normal(len(sig)))).astype(np.complex64)
    before = V.launches["viterbi"]
    got = W.decode_stream_batch(sig, device=cuda_device)
    assert V.launches["viterbi"] == before + 1
    assert [f.psdu for f in got] == sent
    lts = got[3].start
    Hg, lg = demod_head_torch(sig[lts:lts + 208], 0.001, cuda_device)
    Hc, lc = demod_head_torch(sig[lts:lts + 208], 0.001, "cpu")
    np.testing.assert_allclose(Hg, Hc, atol=2e-4)
    np.testing.assert_allclose(lg, lc, atol=2e-3)
    off = lts + 208
    for mod in ("bpsk", "qpsk", "qam16", "qam64"):
        args = (sig[off:off + 37 * 80], Hc, 37, 1, 0.001, 208, mod)
        np.testing.assert_allclose(demod_body_torch(*args, cuda_device),
                                   demod_body_torch(*args, "cpu"), atol=2e-4)


@pytest.mark.gpu
def test_mcldnn_on_card_matches_cpu(cuda_device):
    """The pretrained MCLDNN's logits on the card within 1e-4 of the CPU's
    (TF32 off for its convolutions and LSTMs), its accuracy above 0.9, and
    the classifier block on the card."""
    from futuresdr_tpu_torch.models import modrec
    from futuresdr_tpu_torch.models.mcldnn import loss_fn
    X, y = modrec.synth_batch(np.random.default_rng(42), 256, 128, (10.0, 20.0))
    card = modrec.load_pretrained(device=cuda_device)
    cpu = modrec.load_pretrained(device="cpu")
    with torch.no_grad():
        got = card(torch.from_numpy(X).to(cuda_device)).cpu().numpy()
        want = cpu(torch.from_numpy(X)).numpy()
        _, acc = loss_fn(card, torch.from_numpy(X).to(cuda_device),
                         torch.from_numpy(y).to(cuda_device))
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert float(acc) > 0.9
    assert torch.backends.cudnn.allow_tf32 is False
    clf = modrec.ModClassifier(card, n=128, batch=8, device=cuda_device)
    probs = clf.classify(X[:8])
    assert probs.shape == (8, 5) and np.allclose(probs.sum(axis=1), 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# the device axis: training, sharded streams and programs, the sharded engine
# ---------------------------------------------------------------------------

@pytest.fixture
def logical_cards(cuda_device):
    """Four logical devices on card 0 (config ``virtual_devices``)."""
    from futuresdr_tpu_torch.config import config
    cfg = config()
    prev = cfg.virtual_devices
    cfg.virtual_devices = 4
    yield cuda_device
    cfg.virtual_devices = prev


@pytest.mark.gpu
def test_mcldnn_train_step_on_card_matches_cpu(cuda_device):
    """One train step's gradients on the card within 1e-3 of each leaf's
    largest |g| on the CPU (cuDNN's LSTM backward sums in another order),
    and the loss falls over ten steps."""
    from futuresdr_tpu_torch.models import modrec
    from futuresdr_tpu_torch.models.mcldnn import (MCLDNN, init_params, make_train_step,
                                                   trainable_parameters)
    X, y = modrec.synth_batch(np.random.default_rng(3), 128, 128)
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        m = init_params(MCLDNN(5, 24, 64).to(dev), torch.Generator().manual_seed(0))
        step = make_train_step(m, torch.optim.SGD(trainable_parameters(m), lr=0.0))
        step(torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev))
        grads.append({n: p.grad.cpu() for n, p in m.named_parameters() if p.grad is not None})
    for n, g in grads[1].items():
        assert (grads[0][n] - g).abs().max() <= 1e-3 * g.abs().max(), n
    m, hist = modrec.train(n_steps=10, batch=128, n=128,
                           model=MCLDNN(5, 24, 64), device=cuda_device)
    assert all(np.isfinite(h[0]) for h in hist) and hist[-1][0] < hist[0][0]


@pytest.mark.gpu
def test_sp_fir_fft_mag2_stream_on_logical_shards_matches_one_card(logical_cards):
    from futuresdr_tpu_torch.parallel import make_mesh, sp_fir_fft_mag2_stream, to_host
    dev = logical_cards
    rng = np.random.default_rng(30)
    taps = rng.standard_normal(64).astype(np.float32)
    n = 1 << 16
    mesh = make_mesh(("sp",), shape=(4,))
    fn, init = sp_fir_fft_mag2_stream(taps, 2048, mesh)
    carry = init(np.complex64)
    hist = torch.zeros(63, dtype=torch.complex64, device=dev)
    tt = torch.from_numpy(taps).to(dev)
    before = ck.launches["fir_fft"]
    for _ in range(3):
        x = torch.from_numpy(_c64(rng, n)).to(dev)
        carry, y = fn(carry, x)
        spec = ck.fir_fft(hist, x, tt, 2048)
        hist = x[-63:].clone()
        want = (spec.real ** 2 + spec.imag ** 2).cpu().numpy()
        got = to_host(y)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert ck.launches["fir_fft"] == before + 3 * 5
    assert mesh.transfers["ppermute"] == 3 * 4


@pytest.mark.gpu
def test_data_sharded_rows_bit_equal_one_card_program(logical_cards):
    from futuresdr_tpu_torch.ops import stages as T
    from futuresdr_tpu_torch.shard import collective_ops, rows_to_host, shard_pipeline
    dev = logical_cards
    taps = np.hanning(64).astype(np.float32)
    pipe = T.Pipeline([T.fir_fft_stage(taps, 2048), T.mag2_stage()], np.complex64)
    prog = shard_pipeline(pipe, mode="data", n_devices=4)
    rng = np.random.default_rng(31)
    for k in (1, 4):
        fn, carries = prog.compile(1 << 14, k)
        f1, c1 = pipe.compile(1 << 14, dev, k=k)
        x = _c64(rng, 4 * k * (1 << 14)).reshape((4, k, 1 << 14) if k > 1 else (4, 1 << 14))
        carries, ys = fn(carries, x)
        got = rows_to_host(ys)
        for d in range(4):
            c1 = pipe.init_carry(dev)
            _c, y1 = f1(c1, torch.from_numpy(x[d]).to(dev))
            np.testing.assert_array_equal(y1.cpu().numpy(), got[d])
    assert collective_ops(prog) == []


@pytest.mark.gpu
def test_sharded_engine_bit_equals_unsharded_on_card(logical_cards):
    from futuresdr_tpu_torch.ops import stages as T
    from futuresdr_tpu_torch.serve import ServeEngine
    taps = np.hanning(64).astype(np.float32)
    pipe = T.Pipeline([T.fir_fft_stage(taps, 2048), T.mag2_stage()], np.complex64)
    rng = np.random.default_rng(32)
    data = [[_c64(rng, 1 << 14) for _ in range(3)] for _ in range(6)]
    outs = []
    for shard in (4, 0):
        eng = ServeEngine(pipe, frame_size=1 << 14, app=f"gpu_sh{shard}", buckets=(8,),
                          shard_devices=shard, device=logical_cards)
        sids = [eng.admit(tenant="t").sid for _ in range(6)]
        got = {s: [] for s in sids}
        for j in range(3):
            for s, d in zip(sids, data):
                eng.submit(s, d[j])
            eng.step()
            if j == 1:
                eng.evict(sids[1])
                eng.readmit(sids[1])
        while eng.step():
            pass
        for s in sids:
            got[s] = eng.results(s)
        outs.append(list(got.values()))
    for a, b in zip(*outs):
        assert len(a) == len(b) == 3
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


@pytest.mark.gpu
def test_broker_copy_streams_live_on_its_card(cuda_device):
    from futuresdr_tpu_torch.tpu import TpuInstance
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    b = TpuInstance(last)
    for direction in ("h2d", "d2h"):
        assert b.copy_stream(direction).device == last
    with b.card():
        assert torch.cuda.current_device() == last.index


# ---------------------------------------------------------------------------
# the telemetry plane on the card
# ---------------------------------------------------------------------------

def _tele_stream(dev, data, k, name):
    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
    from futuresdr_tpu_torch.ops import stages as T
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
    kern = TpuKernel([T.fir_fft_stage(np.hanning(64).astype(np.float32), 2048),
                      T.mag2_stage()], np.complex64, frame_size=1 << 16,
                     inst=TpuInstance(dev), frames_per_dispatch=k, wire="f32")
    kern.meta.instance_name = name
    fg = Flowgraph()
    snk = VectorSink(np.float32)
    fg.connect(VectorSource(data), kern, snk)
    Runtime().run(fg)
    return np.asarray(snk.items()), kern


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4])
def test_traced_stream_bit_equal_and_every_group_carries_its_spans_on_card(cuda_device, k):
    from futuresdr_tpu_torch.telemetry import spans
    rng = np.random.default_rng(71)
    data = _c64(rng, 8 << 16)
    off, _ = _tele_stream(cuda_device, data, k, f"gpu_tele_off_{k}")
    rec = spans.recorder()
    rec.drain()
    spans.enable(True)
    try:
        on, kern = _tele_stream(cuda_device, data, k, f"gpu_tele_on_{k}")
    finally:
        spans.enable(False)
    evs = rec.drain()
    np.testing.assert_array_equal(on, off)
    count = {n: sum(e.cat == "tpu" and e.name == n for e in evs)
             for n in ("encode", "H2D", "compute", "D2H", "decode")}
    g = kern.dispatches
    assert count == {"encode": 8, "H2D": g, "compute": g, "D2H": g, "decode": g}


@pytest.mark.gpu
def test_captures_bill_their_reasons_on_card(cuda_device):
    """A capture is a compile: the first one ``warmup``, one for a changed
    carry shape ``reinit`` with the carry's signature."""
    from futuresdr_tpu_torch.ops import stages as T
    from futuresdr_tpu_torch.telemetry import profile
    pipe = T.Pipeline([T.fir_stage(np.ones(16, np.float32) / 16, fft_len=1024)],
                      np.complex64)
    frame = 4 * pipe.frame_multiple
    fn, carry = pipe.compile(frame, cuda_device, program="gpu_tele_recapture")
    x = torch.from_numpy(_c64(np.random.default_rng(72), frame)).to(cuda_device)
    carry, _ = fn(carry, x)
    (H, _tt, tail), = carry
    carry, _ = fn(((H, torch.zeros(32, device=cuda_device), tail),), x)
    reasons = {lab["reason"]: int(v) for lab, v in profile.COMPILES.samples()
               if lab["program"] == "gpu_tele_recapture"}
    assert fn.captures == 2 and reasons == {"warmup": 1, "reinit": 1}
    assert profile.plane().program("gpu_tele_recapture").units == 2


@pytest.mark.gpu
def test_a_capture_in_progress_reads_compiling_on_card(cuda_device):
    import threading
    import time

    from futuresdr_tpu_torch.ops import stages as T
    from futuresdr_tpu_torch.telemetry import profile

    def slow(c, x):
        time.sleep(0.3)
        return c, x.clone()

    pipe = T.Pipeline([T.Stage(fn=slow, init_carry=lambda dt, dv: torch.zeros(1, device=dv),
                               name="slow")], np.complex64)
    t = threading.Thread(target=pipe.compile, args=(1024, cuda_device),
                         kwargs={"program": "gpu_tele_slow"})
    t.start()
    t0 = time.monotonic()
    while not profile.plane().active_compiles() and time.monotonic() - t0 < 10:
        time.sleep(0.01)
    comp = profile.plane().compiling_or_recent(1.0)
    t.join()
    assert comp["in_progress"] and comp["program"] == "gpu_tele_slow"


@pytest.mark.gpu
def test_served_steps_record_spans_and_gauges_on_card(cuda_device, monkeypatch):
    from futuresdr_tpu_torch.ops import stages as T
    from futuresdr_tpu_torch.serve import ServeEngine
    from futuresdr_tpu_torch.telemetry import profile, spans
    pipe = T.Pipeline([T.rotator_stage(0.013, impl="pallas")], np.complex64)
    eng = ServeEngine(pipe, frame_size=512, app="gpu_tele_serve", buckets=(4,),
                      device=cuda_device)
    try:
        sess = [eng.admit(tenant="t") for _ in range(4)]
        rng = np.random.default_rng(73)
        spans.recorder().drain()
        spans.enable(True)
        try:
            for _ in range(5):
                for s in sess:
                    eng.submit(s.sid, _c64(rng, 512))
                eng.step()
            while eng.step():
                pass
        finally:
            spans.enable(False)
        evs = spans.recorder().drain()
        steps = [e for e in evs if e.cat == "serve" and e.name == "serve_step"]
        assert len(steps) == eng.dispatches == 5
        assert profile.plane().program("serve:gpu_tele_serve").units == 20
        assert eng.e2e_hist.count == 20
    finally:
        eng.shutdown()


def _m17_frame_llrs(rng, n_steps, sigma):
    """Soft bits of a random terminated M17 frame of ``n_steps`` trellis steps
    at its P2 puncturing: BPSK ±1, white noise ``sigma``, zeros where
    punctured. Returns ``(llrs, bits)``."""
    from futuresdr_tpu_torch.models.m17 import codec
    bits = np.concatenate([rng.integers(0, 2, n_steps - 4), np.zeros(4)]).astype(np.uint8)
    coded = codec.conv_encode_m17(bits)
    sent = codec.puncture_p2(coded).astype(np.float64) * 2 - 1
    sent += sigma * rng.standard_normal(len(sent))
    return codec.depuncture_p2(sent, len(coded)), bits


@pytest.mark.gpu
@pytest.mark.parametrize("n_steps", [512, 4096])
def test_m17_long_frames_decode_on_card(cuda_device, n_steps):
    """``viterbi_decode_m17`` at 512 and 4,096 steps with ``device=None`` (the
    broker's card) launches ``csrc/viterbi.cu`` once and gives the float64
    numpy trellis's bits, bit for bit."""
    from futuresdr_tpu_torch.models.m17 import codec, viterbi_decode_m17
    from futuresdr_tpu_torch.ops import viterbi as V
    rng = np.random.default_rng(33 + n_steps)
    llrs, bits = _m17_frame_llrs(rng, n_steps, 0.5)
    before = V.launches["viterbi"]
    got = viterbi_decode_m17(llrs, n_steps)
    assert V.launches["viterbi"] == before + 1
    assert np.array_equal(got, codec._viterbi_numpy(llrs, n_steps))
    assert (got != bits).mean() < 0.01


@pytest.mark.gpu
def test_m17_loopback_decodes_on_the_card_machine(cuda_device):
    """The M17 loopback app on the card's machine: the three beacons, the
    transmission's own LSF and a four-frame payload, every one."""
    from futuresdr_tpu_torch.apps.m17_loopback import run
    payload = bytes(range(64))
    metas, lsfs, transmissions, _ = run(payload=payload)
    assert [f.meta for f in lsfs] == metas + [bytes(14)]
    assert [p for _, p in transmissions] == [payload]


def _host_fir_cascade(x, taps, stages):
    for _ in range(stages):
        x = np.convolve(x, taps)[:len(x)].astype(np.float32)
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("sched", ["threaded", "async"])
def test_grid_tpu_form_on_card_equals_the_host_cascade(cuda_device, sched):
    """``perf/fir.py``'s ``--tpu`` form: two pipes, each six ``fir_stage(impl=
    "pallas")`` stages in one ``TpuKernel`` at frame 2^18 on the f32 wire,
    under the scheduler: the ``fir`` kernel launches, and each pipe's output
    is within 1e-5 of peak of the host ``Fir`` cascade."""
    from futuresdr_tpu_torch import Flowgraph, Runtime, ThreadedScheduler, AsyncScheduler
    from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
    from futuresdr_tpu_torch.dsp import firdes
    from futuresdr_tpu_torch.ops.stages import fir_stage
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
    taps = firdes.lowpass(0.2, 64).astype(np.float32)
    x = np.random.default_rng(34).standard_normal((2, 3 << 18)).astype(np.float32)
    fg = Flowgraph()
    sinks = []
    for p in range(2):
        blk = TpuKernel([fir_stage(taps, name=f"fir{i}", impl="pallas") for i in range(6)],
                        np.float32, frame_size=1 << 18, inst=TpuInstance(cuda_device),
                        wire="f32")
        snk = VectorSink(np.float32)
        fg.connect(VectorSource(x[p]), blk, snk)
        sinks.append(snk)
    before = ck.launches["fir"]
    rt = Runtime(ThreadedScheduler() if sched == "threaded" else AsyncScheduler())
    rt.run(fg)
    rt.shutdown()
    torch.cuda.synchronize()
    assert ck.launches["fir"] > before
    for p, snk in enumerate(sinks):
        want = _host_fir_cascade(x[p], taps, 6)
        got = snk.items()
        assert len(got) == len(want)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.gpu
def test_file_through_the_card_equals_the_vector_run(cuda_device, tmp_path):
    """``FileSource -> TpuKernel(fir_fft_stage, mag2_stage) -> FileSink`` on a
    2^20-sample complex64 file writes the same bytes as the run from a
    ``VectorSource``, with ``fir_fft`` launched."""
    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import FileSink, FileSource, VectorSource
    from futuresdr_tpu_torch.dsp import firdes
    from futuresdr_tpu_torch.ops.stages import fir_fft_stage, mag2_stage
    from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
    taps = firdes.lowpass(0.2, 64).astype(np.float32)
    x = _c64(np.random.default_rng(35), 1 << 20)
    x.tofile(tmp_path / "in.cf32")
    before = ck.launches["fir_fft"]
    for kind in ("file", "vector"):
        fg = Flowgraph()
        src = FileSource(str(tmp_path / "in.cf32"), np.complex64) if kind == "file" \
            else VectorSource(x)
        blk = TpuKernel([fir_fft_stage(taps, 2048), mag2_stage()], np.complex64,
                        frame_size=1 << 18, inst=TpuInstance(cuda_device), wire="f32")
        fg.connect(src, blk, FileSink(str(tmp_path / f"{kind}.f32"), np.float32))
        Runtime().run(fg)
    torch.cuda.synchronize()
    assert ck.launches["fir_fft"] > before
    a, b = (tmp_path / "file.f32").read_bytes(), (tmp_path / "vector.f32").read_bytes()
    assert len(a) == 4 << 20 and a == b
