"""The tiling plans of the port's CUDA kernels, walked on the CPU.

``csrc/fir.cu``, ``fir_fft.cu``, ``poly_fir.cu`` and ``pfb.cu`` take their
plans from ``fir_plan``, ``fir_fft_plan``, ``poly_fir_plan`` and ``pfb_plan``
in ``futuresdr_tpu_torch/ops/cuda_kernels.py``; ``rotator.cu`` and
``quad_demod.cu`` walk a frame in one fixed layout. The twins below repeat the
kernels' index arithmetic with torch ops (the staged layouts with their pad
slots, in buffers of the kernels' sizes, so an index past a buffer raises;
the sliding register windows and their slots; the Stockham passes with their
mod-N twiddle indices and in-register butterflies; the register tiles, K
parts and their sum; the rotator's 16-byte words with their head and tail
samples, the demod's one sample a thread, each output written once), and
are held against
``torch.fft.fft`` and the plain versions. The kernels themselves run only on
the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from futuresdr_tpu_torch.ops import cuda_kernels as ck

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

# cos(2π·t/16) as the kernel's float literals
_COS16 = [np.float32(np.cos(2 * np.pi * t / 16)) for t in range(16)]


def _c64(rng, n):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


_skew = ck._skew


def _prep(t, bf16):
    if not bf16:
        return t
    if t.is_complex():
        return torch.complex(ck._bf16(t.real), ck._bf16(t.imag))
    return ck._bf16(t)


# ---------------------------------------------------------------------------
# fir_fft
# ---------------------------------------------------------------------------

def _rot16(b, t):
    """``b·exp(−2πi·t/16)`` as the kernel's ``rot16``."""
    if t == 0:
        return b
    if t == 4:
        return torch.complex(b.imag, -b.real)
    if t == 12:
        return torch.complex(-b.imag, b.real)
    c, s = float(_COS16[t % 16]), float(_COS16[(t - 4) % 16])
    return torch.complex(b.real * c + b.imag * s, b.imag * c - b.real * s)


def _brev(i, bits):
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def _dft_regs(u, inverse=False):
    """The kernel's in-register DFT: radix-2 DIT over bit-reversed registers
    (``inverse``: the inverse's exp(+2πi·t/16) rotations)."""
    R = len(u)
    bits = R.bit_length() - 1
    v = [u[_brev(i, bits)] for i in range(R)]
    ln = 2
    while ln <= R:
        for i in range(0, R, ln):
            for k in range(ln // 2):
                t = k * (16 // ln)
                a, b = v[i + k], _rot16(v[i + k + ln // 2], (16 - t) % 16 if inverse else t)
                v[i + k], v[i + k + ln // 2] = a + b, a - b
        ln *= 2
    return v


def _stockham(src, in_sh, dst, out_sh, tw, n, radix, ns):
    """One pass; ``tw`` is the pass's segment of the kernel's table."""
    nb = n // radix
    j = torch.arange(nb)
    k = j & (ns - 1)
    u = [src[:, _skew(j + q * nb, in_sh)] for q in range(radix)]
    assert tw.shape[0] == (radix - 1) * ns
    if ns > 1:
        for q in range(1, radix):
            idx = (q - 1) * ns + k
            u[q] = u[q] * torch.complex(tw[idx, 0], -tw[idx, 1])
    v = _dft_regs(u)
    base = (j - k) * radix + k
    for q in range(radix):
        dst[:, _skew(base + q * ns, out_sh)] = v[q]


def _fft_twin(rows, plan, n):
    """Stockham passes of ``plan`` over ``rows`` [r, n] (complex64), through
    buffers of the kernel's sizes; returns [r, n]."""
    tw = ck._fft_table(n, plan.radices, torch.device("cpu"))
    psh = plan.pad_shift
    b_len = _skew(n - 1, psh) + 1
    src = torch.zeros(rows.shape[0], b_len, dtype=torch.complex64)
    src[:, _skew(torch.arange(n), psh)] = rows
    other = torch.zeros_like(src)
    y = torch.zeros(rows.shape[0], n, dtype=torch.complex64)
    off = 0
    for p, (r, ns, st) in enumerate(zip(plan.radices, plan.spans, plan.strides)):
        assert st == n // (ns * r)
        last = p == len(plan.radices) - 1
        dst, out_sh = (y, ck._NO_PAD) if last else (other, psh)
        _stockham(src, psh, dst, out_sh, tw[off:off + (r - 1) * ns], n, r, ns)
        off += (r - 1) * ns
        src, other = dst, src
    assert off == tw.shape[0]
    return y


def _fir_fft_twin(hist, x, taps, n, plan, bf16=False):
    """The whole kernel: skewed span, sliding-window MAC into the padded row,
    then the passes (or the direct mod-N DFT)."""
    nt, R, ssh, psh = taps.shape[0], plan.outs, plan.span_shift, plan.pad_shift
    ext = torch.cat([hist, x])
    if not ext.is_complex():
        ext = torch.complex(ext, torch.zeros_like(ext))
    ext, taps = _prep(ext, bf16), _prep(taps, bf16)
    rows, span = x.shape[0] // n, n + nt - 1
    b_len = _skew(n - 1, psh) + 1
    a_len = max(_skew(span - 1, ssh) + 1, b_len)
    tw_len = ck._fft_table(n, plan.radices, torch.device("cpu")).shape[0]
    assert tw_len == plan.tw_len
    assert ck._fir_fft_smem(n, nt, ssh, psh, tw_len if plan.tw_staged else 0) == plan.smem
    s_a = torch.zeros(rows, a_len, dtype=torch.complex64)
    s_a[:, _skew(torch.arange(span), ssh)] = ext[torch.arange(rows)[:, None] * n
                                                 + torch.arange(span)]
    # every thread's c0: tid·R + it·threads·R covers 0, R, 2R, ... < n
    c0 = torch.arange(0, n, R)
    assert sorted(t * R + it * plan.threads * R for t in range(plan.threads)
                  for it in range(-(-n // (plan.threads * R)))
                  if t * R + it * plan.threads * R < n) == c0.tolist()
    win = [None] * R
    for r in range(1, R):
        win[(R - r) % R] = s_a[:, _skew(torch.clamp(c0 + nt - 1 + r, max=span - 1), ssh)]
    acc = [torch.zeros(rows, c0.shape[0], dtype=torch.complex64) for _ in range(R)]
    for k in range(nt):
        kk = k % R
        win[kk] = s_a[:, _skew(c0 + nt - 1 - k, ssh)]
        for r in range(R):
            acc[r] = acc[r] + taps[k] * win[(kk - r) % R]
    s_b = torch.zeros(rows, b_len, dtype=torch.complex64)
    for r in range(R):
        keep = c0 + r < n
        s_b[:, _skew(c0[keep] + r, psh)] = _prep(acc[r][:, keep], bf16)
    filtered = s_b[:, _skew(torch.arange(n), psh)]
    if plan.radices:
        return _fft_twin(filtered, plan, n).reshape(-1)
    tw = ck._fft_table(n, (), torch.device("cpu"))
    c = torch.arange(n)
    idx = (c[:, None] * c[None, :]) % n
    e = torch.complex(tw[idx, 0], -tw[idx, 1])
    return (filtered @ e).reshape(-1)


_POW2 = [1 << b for b in range(1, 14)]


def _passes(n, max_radix):
    """Stockham passes of radix ``max_radix`` with one smaller pass first,
    the plan's rule for its radix 16, as ``_replace`` fields."""
    bits, step = n.bit_length() - 1, max_radix.bit_length() - 1
    radices = ((1 << bits % step,) if bits % step else ()) + (max_radix,) * (bits // step)
    spans = tuple(int(np.prod(radices[:p])) for p in range(len(radices)))
    return {"radices": radices, "spans": spans,
            "strides": tuple(n // (ns * r) for ns, r in zip(spans, radices))}


def _variant(n, nt, variant):
    """``fir_fft_plan(n, nt)`` under a layout it takes at other shapes, or
    an alternative it was measured against: 512 threads of 4 outputs,
    radix-8 passes, the twiddles read from device memory, no padding."""
    plan = ck.fir_fft_plan(n, nt)
    if variant == "512 threads":
        plan = plan._replace(threads=512, outs=4, span_shift=2)
    elif variant == "radix 8":
        plan = plan._replace(**_passes(n, 8))
    elif variant == "twiddles unstaged":
        plan = plan._replace(tw_staged=False)
    elif variant == "unpadded":
        plan = plan._replace(span_shift=ck._NO_PAD, pad_shift=ck._NO_PAD, tw_staged=False)
    return plan._replace(smem=ck._fir_fft_smem(n, nt, plan.span_shift, plan.pad_shift,
                                               plan.tw_len if plan.tw_staged else 0))


@pytest.mark.parametrize("max_radix", [8, 16])
@pytest.mark.parametrize("n", _POW2)
def test_stockham_passes_match_torch_fft(n, max_radix):
    rng = np.random.default_rng(n + max_radix)
    plan = ck.fir_fft_plan(n, 2)
    if max_radix == 8:
        plan = plan._replace(**_passes(n, 8))
    else:
        assert plan.radices == _passes(n, 16)["radices"]
    assert int(np.prod(plan.radices)) == n
    assert all(r <= max_radix for r in plan.radices)
    rows = torch.from_numpy(_c64(rng, 2 * n)).reshape(2, n)
    assert _rel(_fft_twin(rows, plan, n), torch.fft.fft(rows, dim=1)) <= 1e-5


def _fir_fft_case(n, nt, rows, complex_stream, seed):
    rng = np.random.default_rng(seed)
    taps = torch.from_numpy(rng.standard_normal(nt).astype(np.float32))
    if complex_stream:
        return (torch.from_numpy(_c64(rng, nt - 1)), torch.from_numpy(_c64(rng, n * rows)),
                taps)
    return (torch.from_numpy(rng.standard_normal(nt - 1).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(n * rows).astype(np.float32)), taps)


@pytest.mark.parametrize("nt_kind", ["2", "17", "64", "n"])
@pytest.mark.parametrize("n", _POW2)
def test_fir_fft_plan_matches_plain(n, nt_kind):
    nt = n if nt_kind == "n" else min(int(nt_kind), n)
    rows = 1 + n.bit_length() % 3
    hist, x, taps = _fir_fft_case(n, nt, rows, n % 3 != 1, n + nt)
    plan = ck.fir_fft_plan(n, nt)
    got = _fir_fft_twin(hist, x, taps, n, plan)
    assert _rel(got, ck.fir_fft_plain(hist, x, taps, n)) <= 1e-5


@pytest.mark.parametrize("variant", ["512 threads", "radix 8", "twiddles unstaged",
                                     "unpadded", "bf16", "real stream"])
def test_fir_fft_plan_variants_match_plain(variant):
    """The main path's shape (N = 2048, 64 taps) under the other plans the
    kernel takes: 512 threads of 4 outputs, radix-8 passes, the layouts that
    large rows fall back to, bf16 mode and a real stream."""
    n, nt = 2048, 64
    hist, x, taps = _fir_fft_case(n, nt, 2, variant != "real stream", 5)
    plan = _variant(n, nt, variant)
    prec = "bf16" if variant == "bf16" else None
    got = _fir_fft_twin(hist, x, taps, n, plan, bf16=prec == "bf16")
    assert _rel(got, ck.fir_fft_plain(hist, x, taps, n, prec)) <= 1e-5


@pytest.mark.parametrize("n,nt", [(1000, 33), (2047, 64), (300, 20)])
def test_fir_fft_plan_direct_dft_matches_plain(n, nt):
    """N not a power of two keeps the direct DFT (no passes in the plan)."""
    hist, x, taps = _fir_fft_case(n, nt, 2, True, n)
    plan = ck.fir_fft_plan(n, nt)
    assert plan.radices == ()
    assert _rel(_fir_fft_twin(hist, x, taps, n, plan), ck.fir_fft_plain(hist, x, taps, n)) \
        <= 1e-5


def test_fir_fft_main_path_layout_is_conflict_free():
    """At N = 2048 with 64 taps, the MAC's window loads and its stores into
    the padded row put the 16 lanes of each half-warp on 16 distinct 8-byte
    bank slots (float2 accesses are served a half-warp at a time)."""
    plan = ck.fir_fft_plan(2048, 64)
    R, ssh, psh = plan.outs, plan.span_shift, plan.pad_shift
    assert (plan.threads, R, plan.radices) == (256, 8, (8, 16, 16)) and plan.tw_staged
    for half in range(0, plan.threads, 16):
        c0 = np.arange(half, half + 16) * R
        for step in range(R):
            assert len({_skew(int(c) + 63 - step, ssh) % 16 for c in c0}) == 16
            assert len({_skew(int(c) + step, psh) % 16 for c in c0}) == 16


def test_plans_are_worked_out_once():
    """The wrappers take their plans on every call; each is built once."""
    assert ck.fir_fft_plan(2048, 64) is ck.fir_fft_plan(2048, 64)
    assert ck.poly_fir_plan(32, 4, 1, 128_000, True, 132) is \
        ck.poly_fir_plan(32, 4, 1, 128_000, True, 132)


def _old_fir_fft_smem(n, nt):
    return (2 * n + nt - 1) * 8 + 4 * nt


@pytest.mark.parametrize("n", _POW2 + [1000, 2047, 3000, 9000, 12000, 14527])
def test_fir_fft_plan_takes_every_shape_the_old_kernel_took(n):
    for nt in sorted({2, 17, 64, 1024, n // 2, n}):
        if 2 <= nt <= n and _old_fir_fft_smem(n, nt) <= ck._MAX_SMEM:
            assert ck.fir_fft_plan(n, nt).smem <= ck._MAX_SMEM, (n, nt)


# ---------------------------------------------------------------------------
# poly_fir
# ---------------------------------------------------------------------------

def _staged_ext(hist, x, W, q0s, length, bf16):
    """Per block, ``length`` samples of hist ++ x from q0·D on, zero past the
    frame (the kernels' ``ext_at``)."""
    D = W.shape[1]
    ext = torch.cat([hist, x])
    pad = torch.zeros(int(q0s.max()) * D + length, dtype=ext.dtype)
    pad[:ext.shape[0]] = ext[:pad.shape[0]]
    return _prep(pad[q0s[:, None] * D + torch.arange(length)], bf16)


def _poly_rows_twin(hist, x, W, plan, bf16=False):
    m, D = W.shape[0] - 1, W.shape[1]
    nq, R, C, tq, pad = x.shape[0] // D, plan.tile_rows, plan.ksplit, plan.rows, plan.pad
    groups = plan.threads // C
    assert tq == groups * R and plan.threads % 32 == 0 and 32 % C == 0
    q0s = torch.arange(-(-nq // tq)) * tq
    span, rd = (tq + m) * D, R * D
    elt = 8 if x.is_complex() else 4
    assert ck._poly_fir_smem("rows", m, D, 1, tq, R, C, pad, elt) == plan.smem
    s_x = torch.zeros(q0s.shape[0], ck._rows_slot(span - 1, rd, pad) + 1, dtype=x.dtype)
    s_x[:, ck._rows_slot(torch.arange(span), rd, pad)] = _staged_ext(hist, x, W, q0s, span,
                                                                     bf16)
    pw = ck._w_pitch(m)
    assert pw % 8 == 0 and pw % 32 != 0 and pw >= m + 1
    kw = torch.arange(D * pw)
    s, b = kw // pw, kw % pw
    keep = b <= m
    s_w = torch.zeros(D * pw)
    s_w[kw[keep]] = _prep(W.to(torch.float32).reshape(-1), bf16)[((m - b) * D + s)[keep]]
    r0 = torch.arange(groups) * R

    def at(row, s):
        return s_x[:, ck._rows_slot(row * D + s, rd, pad)]

    part = []                                   # part[lane][r]: [blocks, groups]
    for lane in range(C):
        acc = [torch.zeros(q0s.shape[0], groups, dtype=x.dtype) for _ in range(R)]
        for s in range(lane, D, C):
            win = [at(r0 + r, s) for r in range(R - 1)] + [None]
            for b0 in range(0, m + 1, R):
                w = s_w[s * pw + b0:s * pw + b0 + R]          # R / 4 16-byte loads
                assert w.shape[0] == R
                for bb in range(R):
                    if b0 + bb <= m:
                        win[(bb + R - 1) % R] = at(r0 + b0 + bb + R - 1, s)
                        for r in range(R):
                            acc[r] = acc[r] + win[(bb + r) % R] * w[bb]
        part.append(acc)
    off = 1
    while off < C:                              # the shuffle tree: lane ^ off
        part = [[part[ln][r] + part[ln ^ off][r] for r in range(R)] for ln in range(C)]
        off *= 2
    out = torch.stack([part[r % C][r] for r in range(R)], dim=-1)   # lane r mod C stores r
    return out.reshape(-1)[:nq]


def _poly_gemm_twin(hist, x, W, plan, bf16=False):
    m, D = W.shape[0] - 1, W.shape[1]
    I = W.shape[2] if W.dim() == 3 else 1
    nq, J, tm = x.shape[0] // D, (m + 1) * D, plan.rows
    RM, RN, ks = plan.tile_rows, plan.tile_phases, plan.ksplit
    assert plan.threads % ks == 0
    elt = 8 if x.is_complex() else 4
    assert ck._poly_fir_smem("gemm", m, D, I, tm, RM, ks, 0, elt) == plan.smem
    q0s = torch.arange(-(-nq // tm)) * tm
    w_flat = _prep(W.to(torch.float32).reshape(-1), bf16)     # read in W's own order
    s_x = _staged_ext(hist, x, W, q0s, (tm + m) * D, bf16)
    gn_count = -(-I // RN)
    units = -(-tm // RM) * gn_count
    U, jc = plan.threads // ks, -(-J // ks)
    red = torch.zeros(q0s.shape[0], ks, tm, I, dtype=x.dtype)
    for p in range(ks):
        t = torch.arange(min(J, p * jc), min(J, p * jc + jc))     # t = a·D + s
        off = (m - t // D) * D + t % D
        for u in range(units):          # thread p·U + (u mod U), in its pass u // U
            gm, gn = divmod(u, gn_count)
            rows_, ph = gm * RM + torch.arange(RM), gn * RN + torch.arange(RN)
            rl = torch.clamp(rows_, max=tm - 1) * D
            il = torch.clamp(ph, max=I - 1)
            a = s_x[:, rl[:, None] + off[None, :]]                 # [blocks, RM, nt]
            w = w_flat[t[:, None] * I + il[None, :]].to(x.dtype)   # [nt, RN]
            acc = a @ w
            keep_r, keep_c = rows_ < tm, ph < I
            red[:, p, rows_[keep_r][:, None], ph[keep_c][None, :]] = \
                acc[:, keep_r][:, :, keep_c]
    total = red[:, 0]
    for p in range(1, ks):
        total = total + red[:, p]
    y = total.reshape(-1, I)[:nq]
    return y if W.dim() == 3 else y[:, 0]


def _poly_case(D, m, I, nq, complex_stream, seed, w_bf16=False):
    rng = np.random.default_rng(seed)
    shape = (m + 1, D) if I == 1 else (m + 1, D, I)
    W = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    if w_bf16:
        W = W.to(torch.bfloat16)
    if complex_stream:
        return (torch.from_numpy(_c64(rng, m * D)), torch.from_numpy(_c64(rng, nq * D)), W)
    return (torch.from_numpy(rng.standard_normal(m * D).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(nq * D).astype(np.float32)), W)


def _poly_twin(hist, x, W, plan, bf16=False):
    twin = _poly_rows_twin if plan.tiling == "rows" else _poly_gemm_twin
    return twin(hist, x, W, plan, bf16)


@pytest.mark.parametrize("complex_stream", [True, False])
@pytest.mark.parametrize("I", [1, 24])
@pytest.mark.parametrize("m", [1, 2, 32])
@pytest.mark.parametrize("D", [1, 4, 5, 125])
def test_poly_fir_plan_matches_plain(D, m, I, complex_stream):
    """nq below, at and one past a tile (and 1), so the ragged last tile and
    the rows past the frame are walked. Twin and plain version sum the J
    products in different orders in float32: rel. 1e-6 up to J = 1000 taps,
    growing with J beyond (4.1e-6 at D = 125, m = 32)."""
    tol = 1e-6 * max(1.0, D * (m + 1) / 1000)
    tile = ck.poly_fir_plan(m, D, I, 1, complex_stream).rows
    for k, nq in enumerate(sorted({1, max(1, tile - 1), tile, tile + 1})):
        hist, x, W = _poly_case(D, m, I, nq, complex_stream, D * 1000 + m * 10 + I + k)
        plan = ck.poly_fir_plan(m, D, I, nq, complex_stream)
        got = _poly_twin(hist, x, W, plan)
        ref = ck.poly_fir_plain(hist, x, W)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert _rel(got, ref) <= tol, (plan, nq)


@pytest.mark.parametrize("case", ["channel", "channel bf16", "resampler", "resampler c64",
                                  "resampler 4M", "gemm I=1", "rows D=1"])
def test_poly_fir_main_path_plans_match_plain(case):
    """The FM chain's two calls at their widths (nq cut for the CPU where the
    plan does not depend on it), bf16 W with the bf16 mode, a W the gemm
    tiling takes at I = 1, and the rows tiling at D = 1."""
    D, m, I, nq, cplx, n_sm = {
        "channel": (4, 32, 1, 1500, True, 132), "channel bf16": (4, 32, 1, 700, True, 132),
        "resampler": (125, 2, 24, 1024, False, 132),
        "resampler c64": (125, 2, 24, 1021, True, 132),
        "resampler 4M": (125, 2, 24, 8192, False, 132),
        "gemm I=1": (125, 2, 1, 333, False, 132), "rows D=1": (1, 63, 1, 1000, False, 132),
    }[case]
    bf16 = case.endswith("bf16")
    hist, x, W = _poly_case(D, m, I, nq, cplx, nq, w_bf16=bf16)
    plan = ck.poly_fir_plan(m, D, I, nq, cplx, n_sm)
    want = {"channel": "rows", "channel bf16": "rows", "gemm I=1": "gemm",
            "rows D=1": "rows"}.get(case, "gemm")
    assert plan.tiling == want
    if case == "resampler":
        assert (plan.rows, plan.tile_rows, plan.tile_phases) == (8, 4, 3) and plan.ksplit > 1
    got = _poly_twin(hist, x, W, plan, bf16)
    ref = ck.poly_fir_plain(hist, x, W, "bf16" if bf16 else None)
    assert _rel(got, ref) <= 1e-6


@pytest.mark.parametrize("D,complex_stream", [(4, True), (4, False), (1, True), (5, True)])
def test_poly_fir_rows_layout_is_conflict_free(D, complex_stream):
    """The "rows" window loads at every step: the 32 lanes of a warp (16 of
    a half-warp for float2) on distinct banks; the C lanes of a group read
    their W rows from distinct 16-byte bank groups."""
    plan = ck.poly_fir_plan(32, D, 1, 128_000, complex_stream)
    R, C, pad = plan.tile_rows, plan.ksplit, plan.pad
    lanes, banks = (16, 16) if complex_stream else (32, 32)
    for b in range(2 * R):
        slots = {ck._rows_slot((ln // C * R + b + R - 1) * D + ln % C, R * D, pad) % banks
                 for ln in range(lanes)}
        assert len(slots) == lanes, (b, sorted(slots))
    pw = ck._w_pitch(32)
    assert len({(c * pw * 4 // 16) % 8 for c in range(C)}) == C


def _old_poly_fir_smem(m, D, I, elt):
    tq = max(1, 256 // I)
    return ((m + 1) * D * I + 1 & ~1) * 4 + (tq + m) * (D | 1) * elt


@pytest.mark.parametrize("I", [1, 2, 24, 100, 300, 1000])
def test_poly_fir_plan_takes_every_shape_the_old_kernel_took(I):
    for m in (1, 2, 8, 32, 100):
        for D in (1, 2, 4, 5, 64, 125, 500, 2000):
            for elt, cplx in ((4, False), (8, True)):
                if _old_poly_fir_smem(m, D, I, elt) <= ck._MAX_SMEM:
                    plan = ck.poly_fir_plan(m, D, I, 10_000, cplx)
                    assert plan.smem <= ck._MAX_SMEM, (m, D, I, cplx, plan)


# ---------------------------------------------------------------------------
# fir
# ---------------------------------------------------------------------------

def _fir_twin(hist, x, taps, plan, bf16=False):
    """``csrc/fir.cu`` under ``plan``: per warp of 256 outputs its skewed span
    (hist or zeros before the stream, zeros past it) in a region of the
    kernel's size, then each lane's 8-output sliding window over it
    (``window_mac``); ``hist`` None is the zero state."""
    n, nt = x.shape[0], taps.shape[0]
    R, W, ssh = ck._FIR_OUTS, ck._FIR_WARP_OUTS, plan.span_shift
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256 and plan.bufs in (1, 2)
    elt = 8 if x.is_complex() else 4
    assert ck._fir_smem(plan.threads // 32, plan.bufs, nt, ssh, elt) == plan.smem
    # warp v walks the tiles v, v + stride, ...: every tile once
    stride = plan.blocks * plan.threads // 32
    tiles = -(-n // W)
    walked = sorted(v + it * stride for v in range(stride)
                    for it in range(-(-tiles // stride)) if v + it * stride < tiles)
    assert walked == list(range(tiles))
    warps, span = tiles, W + nt - 1
    g = torch.arange(warps)[:, None] * W - (nt - 1) + torch.arange(span)
    before = torch.zeros(nt - 1, dtype=x.dtype) if hist is None else hist
    ext = torch.cat([before, x, torch.zeros(W, dtype=x.dtype)])
    off = ck._fir_span_off(nt)
    s_x = torch.zeros(warps, _skew(off + span - 1, ssh) + 1, dtype=x.dtype)
    s_x[:, _skew(torch.arange(span) + off, ssh)] = _prep(ext[g + nt - 1], bf16)
    taps = _prep(taps, bf16)
    c0 = torch.arange(32) * R                   # lane·R
    win = [None] * R
    for r in range(1, R):
        win[(R - r) % R] = s_x[:, _skew(torch.clamp(c0 + nt - 1 + r, max=span - 1) + off,
                                         ssh)]
    acc = [torch.zeros(warps, 32, dtype=x.dtype) for _ in range(R)]
    top = c0 + nt - 1 + off
    assert bool((top % R == R - 1).all())       # the kernel's ALIGNED window
    for k in range(nt):
        kk = k % R
        # the chunk's loads at constant offsets below one slot
        at = _skew(top - (k - kk), ssh) - kk
        assert torch.equal(at, _skew(top - k, ssh))
        win[kk] = s_x[:, at]
        for r in range(R):
            acc[r] = acc[r] + taps[k] * win[(kk - r) % R]
    y = torch.stack(acc, dim=-1).reshape(-1)     # warp w, lane l, r: w·256 + l·R + r
    return y[:n]


def _fir_case(n, nt, complex_stream, seed, zero_state=False):
    rng = np.random.default_rng(seed)
    taps = torch.from_numpy(rng.standard_normal(nt).astype(np.float32))
    if complex_stream:
        hist, x = torch.from_numpy(_c64(rng, nt - 1)), torch.from_numpy(_c64(rng, n))
    else:
        hist = torch.from_numpy(rng.standard_normal(nt - 1).astype(np.float32))
        x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    return (None if zero_state else hist), x, taps


def _fir_plain(hist, x, taps, precision=None):
    if hist is None:
        return ck.fir_plain(x, taps, precision)
    return ck.fir_continue_plain(hist, x, taps, precision)


@pytest.mark.parametrize("complex_stream", [True, False])
@pytest.mark.parametrize("nt", [1, 17, 64])
@pytest.mark.parametrize("n", [1, 13, 256, 4096 + 777, 40_000])
def test_fir_plan_matches_plain(n, nt, complex_stream):
    """One sample, a ragged tail shorter than a window, one whole tile and
    several ragged ones, under the plan the wrapper takes with n_sm cut to 2
    (4,873 samples: blocks of 8 warps; 40,000: 157 tiles on 96 warps, two
    buffers) and with the zero state."""
    for zero_state in (False, True):
        hist, x, taps = _fir_case(n, nt, complex_stream, n + nt, zero_state)
        plan = ck.fir_plan(n, nt, complex_stream, 2)
        assert plan.bufs == (2 if n == 40_000 else 1)
        got = _fir_twin(hist, x, taps, plan)
        assert _rel(got, _fir_plain(hist, x, taps)) <= 1e-6, plan


@pytest.mark.parametrize("variant", ["main", "bf16", "real", "shrunk", "shrunk bf16"])
def test_fir_plan_main_path_and_shrunk_layout_match_plain(variant):
    """The main path's plan (2^18, 64 taps: blocks of 4 warps, one tile a
    warp) on a cut frame, bf16 mode, a real stream, and the one unpadded warp
    a block that a tap set too long for the padded spans falls back to (2
    blocks, so the warps walk several tiles with one buffer)."""
    nt, complex_stream = 64, variant != "real"
    plan = ck.fir_plan(1 << 18, nt, complex_stream)
    assert (plan.threads, plan.blocks, plan.span_shift, plan.bufs) == (128, 256, 3, 1)
    assert ck.fir_plan(1 << 20, nt, complex_stream)[:4] == (256, 256, 3, 2)
    if variant.startswith("shrunk"):
        plan = ck.FirPlan(32, 2, ck._NO_PAD, 1, ck._fir_smem(1, 1, nt, ck._NO_PAD, 8))
    prec = "bf16" if variant.endswith("bf16") else None
    hist, x, taps = _fir_case(3 * plan.threads * ck._FIR_OUTS + 77, nt, complex_stream, 11)
    got = _fir_twin(hist, x, taps, plan, bf16=prec == "bf16")
    assert _rel(got, ck.fir_continue_plain(hist, x, taps, prec)) <= 1e-6


def test_fir_main_path_layout_is_conflict_free():
    """At 2^18 with 64 taps the window loads of a warp's lanes, windows 8
    samples apart in the warp's span, fall on distinct banks at every step
    (the taps are a broadcast): 16 lanes of a
    half-warp on 16 8-byte slots for a complex stream, 32 lanes on 32 4-byte
    banks for a real one."""
    for complex_stream, lanes in ((True, 16), (False, 32)):
        plan = ck.fir_plan(1 << 18, 64, complex_stream)
        R, ssh, off = ck._FIR_OUTS, plan.span_shift, ck._fir_span_off(64)
        for group in range(0, 32, lanes):
            c0 = np.arange(group, group + lanes) * R
            for step in range(64 + R):
                assert len({_skew(int(c) + step + off, ssh) % lanes for c in c0}) == lanes


def _old_fir_smem(nt, elt):
    return (1024 + nt - 1) * elt + 4 * nt


@pytest.mark.parametrize("complex_stream", [True, False])
def test_fir_plan_takes_every_shape_the_old_kernel_took(complex_stream):
    elt = 8 if complex_stream else 4
    for nt in (1, 2, 17, 64, 1000, 10_000, 19_000, 19_300, 28_000, 29_000, 40_000):
        for n in (1, 1000, 1 << 18, 1 << 22):
            plan = ck.fir_plan(n, nt, complex_stream)
            if _old_fir_smem(nt, elt) <= ck._MAX_SMEM:
                assert plan.smem <= ck._MAX_SMEM, (nt, n, plan)
            assert plan.threads in (32, 64, 128, 256)


# ---------------------------------------------------------------------------
# pfb
# ---------------------------------------------------------------------------

def _stockham_rows(src, dst, tr, pitch, psh, tw, n, radix, ns, inverse, y_rows=None):
    """One pass over the block's ``tr`` rows, ``pitch`` apart in the flat
    buffers ``src``/``dst`` [blocks, L]: butterfly b is butterfly b mod nb of
    row b // nb; the last pass (``y_rows`` [blocks, tr, n]) stores unpadded."""
    nb = n // radix
    b = torch.arange(tr * nb)
    row, j = b // nb, b % nb
    k = j & (ns - 1)
    u = [src[:, row * pitch + _skew(j + q * nb, psh)] for q in range(radix)]
    assert tw.shape[0] == (radix - 1) * ns
    if ns > 1:
        for q in range(1, radix):
            idx = (q - 1) * ns + k
            w = torch.complex(tw[idx, 0], tw[idx, 1] if inverse else -tw[idx, 1])
            u[q] = u[q] * w
    v = _dft_regs(u, inverse)
    base = (j - k) * radix + k
    for q in range(radix):
        if y_rows is None:
            dst[:, row * pitch + _skew(base + q * ns, psh)] = v[q]
        else:
            y_rows[:, row, base + q * ns] = v[q]


def _pfb_idft_twin(s_v, w_len, plan, n):
    """The IDFT of the block's v rows (flat [blocks, rows·pitch]), through
    a second buffer of the kernel's size; returns [blocks, rows, n]."""
    tr, pitch, psh = plan.rows, plan.pitch, plan.pad_shift
    tw = ck._fft_table(n, plan.radices, torch.device("cpu"))
    assert tw.shape[0] == plan.tw_len
    y = torch.zeros(s_v.shape[0], tr, n, dtype=torch.complex64)
    if not plan.radices:
        c = torch.arange(n)
        idx = (c[:, None] * c[None, :]) % n
        e = torch.complex(tw[idx, 0], tw[idx, 1])
        rows = torch.stack([s_v[:, r * pitch + _skew(c, psh)] for r in range(tr)], dim=1)
        return rows @ e
    src, other = s_v, torch.zeros(s_v.shape[0], w_len, dtype=torch.complex64)
    off = 0
    for p, (r, ns, st) in enumerate(zip(plan.radices, plan.spans, plan.strides)):
        assert st == n // (ns * r)
        last = p == len(plan.radices) - 1
        _stockham_rows(src, other, tr, pitch, psh, tw[off:off + (r - 1) * ns], n, r, ns,
                       True, y if last else None)
        off += (r - 1) * ns
        src, other = other, src
    assert off == tw.shape[0]
    return y


def _pfb_twin(hist, x, taps, plan, bf16=False):
    """``csrc/pfb.cu``'s "window" layout: per block and chunk of channels
    the staged rows (reversed columns, zero past the frame) in a staging
    buffer of the kernel's size, the register window down the rows (row
    g·R + jj feeds output r through tap r + K − 1 − jj, jj descending), v
    into the padded rows, then the inverse passes (or the direct DFT)."""
    K, N = taps.shape
    t = x.shape[0] // N
    tr, C, G, R, pitch, psh = (plan.rows, plan.chunk, plan.groups, plan.outs, plan.pitch,
                               plan.pad_shift)
    assert plan.window and tr == G * R and C * G <= plan.threads <= 512
    assert plan.k_regs in (0, K) and (plan.k_regs == 0 or K == ck._PFB_K_REGS)
    assert pitch >= _skew(N - 1, psh) + 1
    tw_staged = plan.tw_len if plan.tw_staged else 0
    assert ck._pfb_smem(N, K, tr, C, len(plan.radices), pitch, tw_staged,
                        plan.k_regs) == plan.smem
    span = tr + K - 1
    bufs = 2 if N > C else 1
    w_len = max(bufs * span * C, tr * pitch if len(plan.radices) >= 2 else 0)
    ext = torch.cat([hist, x])
    nblk = -(-t // tr)
    s0 = torch.arange(nblk) * tr
    w = _prep(taps.to(torch.float32), bf16)
    s_v = torch.zeros(nblk, tr * pitch, dtype=torch.complex64)
    s_w = torch.zeros(nblk, w_len, dtype=torch.complex64)
    for ch in range(-(-N // C)):
        cc = torch.arange(C)
        c = ch * C + cc
        buf = (ch % bufs) * span * C
        r = torch.arange(span)
        e = (s0[:, None, None] + r[None, :, None]) * N + (N - 1 - c)[None, None, :]
        ok = (c < N)[None, None, :] & (e < ext.shape[0])
        staged = torch.where(ok, ext[torch.where(ok, e, 0)], torch.zeros((), dtype=ext.dtype))
        s_w[:, buf + (r[:, None] * C + cc[None, :]).reshape(-1)] = \
            _prep(staged.reshape(nblk, -1), bf16)
        live = c < N
        tap = w[:, torch.clamp(c, max=N - 1)]                          # [K, C]
        for g in range(G):
            acc = [torch.zeros(nblk, C, dtype=torch.complex64) for _ in range(R)]
            for jj in range(R + K - 2, -1, -1):
                v = s_w[:, buf + (g * R + jj) * C + cc]
                for rr in range(R):
                    kk = rr + K - 1 - jj
                    if 0 <= kk < K:
                        acc[rr] = acc[rr] + tap[kk] * v
            for rr in range(R):
                s_v[:, (g * R + rr) * pitch + _skew(c[live], psh)] = _prep(acc[rr][:, live],
                                                                           bf16)
    y = _pfb_idft_twin(s_v, w_len, plan, N).reshape(-1, N)
    return y[:t]


def _pfb_case(N, K, t, seed, taps_bf16=False):
    rng = np.random.default_rng(seed)
    hc = torch.from_numpy(rng.standard_normal((N, K)).astype(np.float32))
    if taps_bf16:
        hc = hc.to(torch.bfloat16)                  # the stage carries bf16 taps
    hist = torch.from_numpy(_c64(rng, (K - 1) * N))
    x = torch.from_numpy(_c64(rng, t * N))
    return hist, x, hc.t()                          # the carry's transposed view


def _pfb_variant(N, K, t_plan, outs):
    """``pfb_plan`` at ``t_plan`` rows with R = ``outs`` rows a thread."""
    plan = ck.pfb_plan(N, K, t_plan)
    tw_staged = plan.tw_len if plan.tw_staged else 0
    rows = plan.groups * outs
    return plan._replace(outs=outs, rows=rows, smem=ck._pfb_smem(
        N, K, rows, plan.chunk, len(plan.radices), plan.pitch, tw_staged, plan.k_regs))


@pytest.mark.parametrize("outs", [1, 4, 8])
@pytest.mark.parametrize("K", [1, 4, 12])
@pytest.mark.parametrize("N", [16, 64, 2048])
def test_pfb_plan_matches_plain(N, K, outs):
    """Every rows-a-thread window at N = 16 and 64 (one chunk, several row
    groups) and N = 2048 (four 512-channel chunks, one group), the taps in
    registers (K = 12) and in shared memory; t ragged against the tile."""
    t = {16: 37, 64: 37, 2048: 3}[N]
    hist, x, taps = _pfb_case(N, K, t, N + K + outs)
    plan = _pfb_variant(N, K, 1 << 16, outs)
    got = _pfb_twin(hist, x, taps, plan)
    assert _rel(got, ck.pfb_plain(hist, x, taps)) <= 1e-5, plan


@pytest.mark.parametrize("case", ["PFB-64 bf16", "PFB-2048 bf16", "N=24 direct",
                                  "N=1000 ragged chunk", "PFB-64 2^21", "unpadded"])
def test_pfb_plan_edges_match_plain(case):
    """bf16 mode with bf16 taps (held, like the kernel, by the rounding of
    rows, taps and v against the plain version's; the plain version's bf16
    IDFT matrix is not the kernel's, so bf16 compares with float32 twiddles),
    the direct DFT at N = 24 with 10 row groups, a ragged last chunk, the
    2^21 plan (R = 8) and the unpadded layout without staged twiddles."""
    N, K, t, t_plan = {"PFB-64 bf16": (64, 12, 37, 4096), "PFB-2048 bf16": (2048, 12, 2, 128),
                       "N=24 direct": (24, 4, 41, 500), "N=1000 ragged chunk": (1000, 12, 3, 64),
                       "PFB-64 2^21": (64, 12, 70, 1 << 15),
                       "unpadded": (64, 12, 37, 4096)}[case]
    bf16 = case.endswith("bf16")
    hist, x, taps = _pfb_case(N, K, t, len(case), taps_bf16=bf16)
    plan = ck.pfb_plan(N, K, t_plan)
    if case == "unpadded":
        plan = plan._replace(pad_shift=ck._NO_PAD, pitch=ck._pfb_pitch(64, ck._NO_PAD,
                                                                       plan.radices),
                             tw_staged=False)
        plan = plan._replace(smem=ck._pfb_smem(64, K, plan.rows, plan.chunk, 2, plan.pitch,
                                               0, plan.k_regs))
    got = _pfb_twin(hist, x, taps, plan, bf16)
    if bf16:
        # the plain version's arithmetic with the kernel's float32 twiddles
        rows = ck._planes(torch.cat([hist, x])).reshape(t + K - 1, N, 2).flip(1)
        rows, w = ck._bf16(rows), ck._bf16(taps.to(torch.float32))
        acc = torch.zeros((t, N, 2))
        for k in range(K):
            acc = acc + w[k, :, None] * rows[K - 1 - k:K - 1 - k + t]
        v = torch.view_as_complex(ck._bf16(acc).contiguous())
        ref = torch.fft.ifft(v, dim=1) * N
        assert _rel(got, ref) <= 1e-5
    else:
        assert _rel(got, ck.pfb_plain(hist, x, taps)) <= 1e-5, plan
    assert plan.radices == ck._stockham_passes(N)[0]


@pytest.mark.parametrize("n", _POW2)
def test_inverse_stockham_passes_match_torch_ifft(n):
    """The pfb kernel's inverse passes over several rows, pitch apart, against
    ``torch.fft.ifft(·)·N``."""
    rng = np.random.default_rng(n)
    plan = _pfb_variant(n, 12, 1 << 12, 4)
    rows = torch.from_numpy(_c64(rng, plan.rows * n)).reshape(plan.rows, n)
    s_v = torch.zeros(1, plan.rows * plan.pitch, dtype=torch.complex64)
    for r in range(plan.rows):
        s_v[0, r * plan.pitch + _skew(torch.arange(n), plan.pad_shift)] = rows[r]
    got = _pfb_idft_twin(s_v, plan.rows * plan.pitch, plan, n)[0]
    assert _rel(got, torch.fft.ifft(rows, dim=1) * n) <= 1e-5


def test_pfb_main_path_layouts_are_conflict_free():
    """PFB-64 at 2^18 and 2^21 and PFB-2048 at 2^18: the staging stores and
    MAC loads of each half-warp (thread (g, cc) on row slots r·C + cc), its v
    stores, and every Stockham pass's loads and (but the last) stores put the
    16 lanes of a half-warp on 16 distinct 8-byte bank slots."""
    for N, t in ((64, 4096), (64, 32768), (2048, 128)):
        plan = ck.pfb_plan(N, 12, t)
        C, G, R, pitch, psh = plan.chunk, plan.groups, plan.outs, plan.pitch, plan.pad_shift
        assert plan.window and plan.k_regs == 12 and plan.tw_staged
        for half in range(0, G * C, 16):
            tid = np.arange(half, half + 16)
            g, cc = tid // C, tid % C
            for jj in range(R + 11):
                assert len({int(s) % 16 for s in (g * R + jj) * C + cc}) == 16
            for r in range(R):
                assert len({((gg * R + r) * pitch + _skew(int(c), psh)) % 16
                            for gg, c in zip(g, cc)}) == 16
        ns = 1
        for p, radix in enumerate(plan.radices):
            nb = N // radix
            for half in range(0, plan.rows * nb, 16):
                b = np.arange(half, min(half + 16, plan.rows * nb))
                row, j = b // nb, b % nb
                k = j & (ns - 1)
                base = (j - k) * radix + k
                for q in range(radix):
                    loads = {(int(rw) * pitch + _skew(int(jj + q * nb), psh)) % 16
                             for rw, jj in zip(row, j)}
                    assert len(loads) == len(b), (N, p, q)
                    if p < len(plan.radices) - 1:
                        stores = {(int(rw) * pitch + _skew(int(bs + q * ns), psh)) % 16
                                  for rw, bs in zip(row, base)}
                        assert len(stores) == len(b), (N, p, q)
            ns *= radix


def test_pfb_main_path_plans():
    """PFB-64: 16 rows a block at 2^18 (256 blocks), 32 at 2^21; PFB-2048: one
    row a block (128 blocks), four 512-channel chunks."""
    p = ck.pfb_plan(64, 12, 4096)
    assert (p.threads, p.chunk, p.groups, p.outs, p.radices) == (256, 64, 4, 4, (4, 16))
    assert ck.pfb_plan(64, 12, 32768).outs == 8
    p = ck.pfb_plan(2048, 12, 128)
    assert (p.threads, p.chunk, p.groups, p.outs, p.radices) == (512, 512, 1, 1, (8, 16, 16))
    assert ck.pfb_plan(64, 12, 4096) is ck.pfb_plan(64, 12, 4096)
    assert ck.fir_plan(1 << 18, 64, True) is ck.fir_plan(1 << 18, 64, True)


def _old_pfb_smem(n, k):
    tr = max(1, 1024 // n)
    staged = (2 * tr + k - 1) * n * 8 + k * n * 4
    return staged if staged <= ck._MAX_SMEM else tr * n * 8


@pytest.mark.parametrize("K", [1, 4, 12, 64, 300])
def test_pfb_plan_takes_every_shape_the_old_kernel_took(K):
    for n in _POW2 + [1, 5, 24, 100, 1000, 3000, 12000, 16383, 20000, 29056, 29057]:
        plan = ck.pfb_plan(n, K, 1000)
        if _old_pfb_smem(n, K) <= ck._MAX_SMEM:
            assert plan.smem <= ck._MAX_SMEM, (n, K, plan)
        if not plan.window:
            assert plan.smem == 8 * n and plan.tw_len == n


def test_library_hash_covers_the_shared_headers(tmp_path, monkeypatch):
    """A header edit names a new library, so a stale one is never loaded."""
    from futuresdr_tpu_torch.ops import _build
    for f in _build.CSRC.iterdir():
        if f.is_file():                    # csrc/host/ holds the host flavour
            (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    with open(tmp_path / "common.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)


# ---------------------------------------------------------------------------
# rotator and quad_demod: their walks over a frame
# ---------------------------------------------------------------------------

_TWO_PI, _INV_TWO_PI = 6.283185307179586, 0.15915494309189535


def _count(count, idx):
    count.index_add_(0, idx.reshape(-1), torch.ones(idx.numel(), dtype=torch.int64))


def _rotate(v, t, ph0, inc):
    """``rotate`` of ``csrc/rotator.cu``: the float32 phase rounded as product
    then sum, reduced by 2π in float64, the complex multiply's four products."""
    ph = ph0 + inc * t.to(torch.float32)
    k = torch.round(ph.double() * _INV_TWO_PI)
    r = (ph.double() - k * _TWO_PI).float()
    s, c = torch.sin(r), torch.cos(r)
    return torch.complex(v.real * c - v.imag * s, v.real * s + v.imag * c)


def _rotator_twin(x, ph0, inc, head):
    """``csrc/rotator.cu`` on a frame whose first ``head`` samples lie before
    a 16-byte boundary: ``(n − head) // 2`` words, one a thread, in blocks of
    ``ROTATOR_TILE // 2`` threads (one block for an empty body, which still
    writes the carry), both samples of each word; then thread 0 of block 0's
    head, tail and carry. Asserts every output sample is written once;
    returns ``(y, ph_next)``."""
    n = x.shape[0]
    assert head in (0, 1) and head <= n
    threads = ck.ROTATOR_TILE // 2
    words = (n - head) // 2
    blocks = max(1, -(-words // threads))
    w = torch.arange(blocks * threads)
    t = head + 2 * w[w < words]
    y = torch.zeros(n, dtype=torch.complex64)
    count = torch.zeros(n, dtype=torch.int64)
    for ts in (t, t + 1):
        y[ts] = _rotate(x[ts], ts, ph0, inc)
        _count(count, ts)
    edge = ([0] if head else []) + ([head + 2 * words] if head + 2 * words < n else [])
    for e in edge:
        te = torch.tensor([e])
        y[te] = _rotate(x[te], te, ph0, inc)
        _count(count, te)
    assert bool((count == 1).all())
    b = torch.tensor(_TWO_PI, dtype=torch.float32)
    mod = torch.fmod(ph0 + inc * torch.tensor(float(n), dtype=torch.float32), b)
    if mod != 0 and bool(b < 0) != bool(mod < 0):
        mod = mod + b
    return y, mod


def _demod(v, p, gain):
    zr = v.real * p.real + v.imag * p.imag
    zi = v.imag * p.real - v.real * p.imag
    return float(np.float32(gain)) * torch.atan2(zi, zr)


def _quad_demod_twin(prev, x, gain):
    """``csrc/quad_demod.cu``: blocks of ``QUAD_DEMOD_TILE`` threads, one
    sample a thread, its left neighbour from device memory (``prev`` for
    t = 0). Asserts every output is written once."""
    n = x.shape[0]
    blocks = -(-n // ck.QUAD_DEMOD_TILE)
    t = torch.arange(blocks * ck.QUAD_DEMOD_TILE)
    t = t[t < n]
    ext = torch.cat([prev.reshape(1), x])                  # ext[t] = x[t − 1]
    y = torch.zeros(n, dtype=torch.float32)
    count = torch.zeros(n, dtype=torch.int64)
    y[t] = _demod(x[t], ext[t], gain)
    _count(count, t)
    assert bool((count == 1).all())
    return y, x[n - 1].clone()


def _stream_case(n, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(_c64(rng, n))


# frame sizes: one to three samples, one tile (after the head) ± 1, the demod
# frame and a ragged FM frame
_STREAM_SIZES = {"1": (0, 1), "2": (0, 2), "3": (0, 3), "tile - 1": (1, -1),
                 "tile": (1, 0), "tile + 1": (1, 1), "128000": (0, 128_000),
                 "512333": (0, 512_333)}


def _stream_size(spec, tile, head=0):
    """``tiles`` tiles of ``tile`` samples after the head, plus ``extra``."""
    tiles, extra = _STREAM_SIZES[spec]
    return tiles * (head + tile) + extra


def _wrapped_err(got, ref, gain):
    period = 2 * np.pi * gain
    d = (got - ref).double()
    return float((d - period * torch.round(d / period)).abs().max())


@pytest.mark.parametrize("head", [0, 1])
@pytest.mark.parametrize("n", list(_STREAM_SIZES))
def test_rotator_walk_matches_plain(n, head):
    """The kernel's walk at one sample to three, one tile ± 1 (after the
    head), the demod frame and a ragged FM frame, with head 0 and 1 (a view
    ``x[1:]``): every sample written once, within 1e-5 of the plain
    version's peak, the carry equal to the plain version's."""
    n = _stream_size(n, ck.ROTATOR_TILE, head)
    x = _stream_case(n, n + head)
    ph0 = torch.tensor(np.float32(-3.1))
    inc = torch.tensor(np.float32(-2 * np.pi * 0.1))
    y, ph_next = _rotator_twin(x, ph0, inc, head)
    ref, ref_next = ck.rotator_plain(x, ph0, inc)
    assert _rel(y, ref) <= 1e-5, (n, head)
    assert ph_next.item() == ref_next.item()


@pytest.mark.parametrize("head", [0, 1])
@pytest.mark.parametrize("ph0", [3.14, -3.14, 0.0])
def test_rotator_walk_carry_matches_plain_on_an_empty_body(ph0, head):
    """Frames of ``head`` samples and no word: one block still launches and
    thread 0 writes the head sample and the carry."""
    x = _stream_case(head, 9)
    ph0, inc = torch.tensor(np.float32(ph0)), torch.tensor(np.float32(0.73))
    y, ph_next = _rotator_twin(x, ph0, inc, head)
    ref, ref_next = ck.rotator_plain(x, ph0, inc)
    assert y.shape == ref.shape and ph_next.item() == ref_next.item()
    if head:
        assert _rel(y, ref) <= 1e-5


@pytest.mark.parametrize("n", list(_STREAM_SIZES))
def test_quad_demod_walk_matches_plain(n):
    """As for the rotator: every sample written once, its neighbour read
    across block edges, the first from the carry."""
    n = _stream_size(n, ck.QUAD_DEMOD_TILE)
    x = _stream_case(n, n + 7)
    prev = torch.tensor(np.complex64(0.7 - 0.2j))
    gain = 250e3 / (2 * np.pi * 75e3)
    y, last = _quad_demod_twin(prev, x, gain)
    ref, ref_last = ck.quad_demod_plain(prev, x, gain)
    assert _wrapped_err(y, ref, gain) <= 1e-5, n
    assert last.item() == ref_last.item() == x[-1].item()

