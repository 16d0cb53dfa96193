"""The tiling plans of the ``fir_fft`` and ``poly_fir`` CUDA kernels, walked on
the CPU.

``csrc/fir_fft.cu`` and ``csrc/poly_fir.cu`` take their plans from
``fir_fft_plan`` and ``poly_fir_plan`` in ``futuresdr_tpu_torch/ops/
cuda_kernels.py``. The twins below repeat the kernels' index arithmetic with
torch ops (the staged layouts with their pad slots, in buffers of the
kernels' sizes, so an index past a buffer raises; the sliding register
windows and their slots; the Stockham passes with their mod-N twiddle
indices and in-register butterflies; the register tiles, K parts and their
sum), and are held against ``torch.fft.fft`` and the plain versions. The
kernels themselves run only on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from futuresdr_tpu_torch.ops import cuda_kernels as ck

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
    c, s = float(_COS16[t % 16]), float(_COS16[(t - 4) % 16])
    return torch.complex(b.real * c + b.imag * s, b.imag * c - b.real * s)


def _brev(i, bits):
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def _dft_regs(u):
    """The kernel's in-register DFT: radix-2 DIT over bit-reversed registers."""
    R = len(u)
    bits = R.bit_length() - 1
    v = [u[_brev(i, bits)] for i in range(R)]
    ln = 2
    while ln <= R:
        for i in range(0, R, ln):
            for k in range(ln // 2):
                a, b = v[i + k], _rot16(v[i + k + ln // 2], k * (16 // ln))
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
    tw = ck._twiddles(n, torch.device("cpu"))
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
