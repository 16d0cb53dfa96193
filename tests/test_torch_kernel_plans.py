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


def _planes(t):
    """A float32 tensor ``[..., 2]`` (complex) or ``[..., 1]`` (real)."""
    return torch.view_as_real(t) if t.is_complex() else t[..., None]


def _lane_w(W):
    """``(flat, stride)``: the lanes' W as flat storage of the tensor's own
    size and a lane's offset in it (0 where every lane shares one W)."""
    if W.shape[0] > 1 and W.stride(0) == 0:
        return W[0].contiguous().reshape(-1), 0
    return W.contiguous().reshape(-1), W[0].numel()


def _chains(acc, C):
    """The C column chains of each output added in the kernel's order:
    ``(c0 + c1) + (c2 + c3)``."""
    if C == 4:
        return (acc[..., 0, :] + acc[..., 1, :]) + (acc[..., 2, :] + acc[..., 3, :])
    if C == 2:
        return acc[..., 0, :] + acc[..., 1, :]
    return acc[..., 0, :]


def _poly_rows_twin(hist, x, W, plan, bf16=False):
    """``csrc/poly_fir.cu``'s "rows" walk over the lanes of ``hist [L, m·D]``,
    ``x [L, nq·D]`` and ``W [L, m+1, D]``: the grid's blocks walk the
    ``L·⌈nq/tq⌉`` tiles at the grid's stride (every tile once); a tile stages
    its lane's W as given and its span, ``tq + m`` rows of hist ++ x from
    ``q0·D`` on (zero past the frame), with ``pad`` slots after every R rows,
    in a buffer of the kernel's size; thread t takes rows ``t·R .. t·R + R −
    1`` and, column group by column group, C chains over the columns ``g·C +
    c``, each over the taps b = 0 … m ascending (row r's sample at step b is
    span row ``t·R + b + r``, its weight ``W[(m − b)·D + g·C + c]``; summed
    in float64, rounded once a chain), then adds the chains ``(c0 + c1) +
    (c2 + c3)`` in float32 and stores its R outputs, each output once."""
    L, m, D = x.shape[0], W.shape[1] - 1, W.shape[2]
    nq, cplx = x.shape[1] // D, x.is_complex()
    R, C, th, tq, pad = plan.tile_rows, plan.ksplit, plan.threads, plan.rows, plan.pad
    assert plan.tiling == "rows" and tq == th * R and th % 32 == 0 and C in (1, 2, 4)
    tiles = -(-nq // tq)
    total, span = L * tiles, ck._rows_span(tq, m, D, R, pad)
    grid = min(plan.blocks, total) if plan.blocks else total
    assert ck._poly_fir_smem("rows", m, D, 1, tq, R, C, pad, 2 if plan.blocks else 1,
                             8 if cplx else 4) == plan.smem
    walk = [b + k * grid for b in range(grid) for k in range(-(-(total - b) // grid))]
    assert sorted(walk) == list(range(total))
    fw, ws = _lane_w(W)
    y = torch.zeros(L, nq, 2 if cplx else 1)
    writes = torch.zeros(L, nq, dtype=torch.int64)
    thread = torch.arange(th)
    k = torch.arange((tq + m) * D)
    for t in walk:
        lane, q0 = t // tiles, t % tiles * tq
        ext = torch.cat([hist[lane], x[lane]])
        e = q0 * D + k
        s_x = torch.zeros(span, dtype=x.dtype)
        s_x[k + pad * (k // (R * D))] = torch.where(e < ext.shape[0],
                                                   ext[e.clamp(max=ext.shape[0] - 1)], 0)
        s_x = _planes(_prep(s_x, bf16))
        s_w = _prep(fw[lane * ws + torch.arange((m + 1) * D)].to(torch.float32), bf16)
        acc = torch.zeros(th, R, C, s_x.shape[-1], dtype=torch.float64)
        first = thread * (R * D + pad)                 # each thread's first row
        for g in range(-(-D // C)):
            for c in range(min(C, D - g * C)):
                for b in range(m + 1):
                    i = b + torch.arange(R)
                    v = s_x[first[:, None] + i * D + pad * (i // R) + g * C + c]
                    acc[:, :, c] += v.double() * float(s_w[(m - b) * D + g * C + c])
        q = q0 + thread[:, None] * R + torch.arange(R)
        keep = q < nq
        y[lane, q[keep]] = _chains(acc.float(), C)[keep]
        writes[lane, q[keep]] += 1
    assert torch.equal(writes, torch.ones_like(writes)), "an output written twice or never"
    return torch.view_as_complex(y) if cplx else y[..., 0]


def _poly_gemm_twin(hist, x, W, plan, bf16=False):
    m, D = W.shape[0] - 1, W.shape[1]
    I = W.shape[2] if W.dim() == 3 else 1
    nq, J, tm = x.shape[0] // D, (m + 1) * D, plan.rows
    RM, RN, ks = plan.tile_rows, plan.tile_phases, plan.ksplit
    assert plan.threads % ks == 0
    elt = 8 if x.is_complex() else 4
    assert ck._poly_fir_smem("gemm", m, D, I, tm, RM, ks, 0, 1, elt) == plan.smem
    q0s = torch.arange(-(-nq // tm)) * tm
    w_flat = _prep(W.to(torch.float32).reshape(-1), bf16)     # read in W's own order
    rows = tm + m                          # the span, its rows reversed: row j at
    k = torch.arange(rows * D)             # slot (rows - 1 - j)·D
    s_x = torch.zeros(q0s.shape[0], rows * D, dtype=x.dtype)
    s_x[:, (rows - 1 - k // D) * D + k % D] = _staged_ext(hist, x, W, q0s, rows * D, bf16)
    gn_count = -(-I // RN)
    units = -(-tm // RM) * gn_count
    U, jc = plan.threads // ks, -(-J // ks)
    red = torch.zeros(q0s.shape[0], ks, tm, I, dtype=x.dtype)
    for p in range(ks):
        t = torch.arange(min(J, p * jc), min(J, p * jc + jc))     # t = a·D + s
        for u in range(units):          # thread p·U + (u mod U), in its pass u // U
            gm, gn = divmod(u, gn_count)
            rows_, ph = gm * RM + torch.arange(RM), gn * RN + torch.arange(RN)
            rl = (tm - 1 - torch.clamp(rows_, max=tm - 1)) * D    # row r's step 0
            il = torch.clamp(ph, max=I - 1)
            a = s_x[:, rl[:, None] + t[None, :]]                   # [blocks, RM, nt]
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
    if plan.tiling == "rows":
        return _poly_rows_twin(hist[None], x[None], W[None], plan, bf16)[0]
    return _poly_gemm_twin(hist, x, W, plan, bf16)


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


@pytest.mark.parametrize("D,complex_stream", [(4, True), (4, False), (16, True), (1, True),
                                              (5, True), (2, False)])
def test_poly_fir_rows_layout_is_conflict_free(D, complex_stream):
    """The "rows" window loads at every step of a chunk: thread t's span row
    ``t·R + i`` (i < 2R, the priming rows and a chunk's) at slot ``t·(R·D +
    pad) + i·D + pad·(i // R)`` plus its column group, in words of
    ``_rows_vec`` samples (16 bytes at D = 4; one sample where C does not
    divide D): the threads one word width serves together (8 for 16 bytes,
    16 for 8, 32 for 4) on distinct banks, and each word aligned to its
    width. The weights of a step are one address for the whole warp."""
    plan = ck.poly_fir_plan(32, D, 1, 128_000, complex_stream)
    R, C, pad, elt = plan.tile_rows, plan.ksplit, plan.pad, 8 if complex_stream else 4
    vec = ck._rows_vec(D, C, elt)
    width = vec * elt if vec else elt
    words = -(-C * elt // width) if vec else 1
    per = 128 // width
    for g in range(-(-D // C)):
        for i in range(2 * R):
            for word in range(words):
                byte = [(t * (R * D + pad) + i * D + pad * (i // R) + g * C) * elt + word * width
                        for t in range(32)]
                assert all(b % width == 0 for b in byte)
                for t0 in range(0, 32, per):
                    banks = [(b // 4 + w) % 32 for b in byte[t0:t0 + per]
                             for w in range(width // 4)]
                    assert len(set(banks)) == len(banks), (g, i, word, t0, sorted(banks))


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


def _pfb_window_mac(stage, w, plan, bf16):
    """The window layout's MAC on one chunk of all ``N`` channels: ``stage``
    [blocks, span, N] the staged rows (channel c in column c), ``w`` [K, N]
    the taps; thread (g, c) walks its R rows' window down (row g·R + jj feeds
    output r through tap r + K − 1 − jj, jj descending); returns the padded
    v rows [blocks, rows·pitch]."""
    K, N = w.shape
    R, pitch, psh = plan.outs, plan.pitch, plan.pad_shift
    c = torch.arange(N)
    s_v = torch.zeros(stage.shape[0], plan.rows * pitch, dtype=torch.complex64)
    for g in range(plan.groups):
        acc = [torch.zeros(stage.shape[0], N, dtype=torch.complex64) for _ in range(R)]
        for jj in range(R + K - 2, -1, -1):
            v = stage[:, g * R + jj]
            for rr in range(R):
                kk = rr + K - 1 - jj
                if 0 <= kk < K:
                    acc[rr] = acc[rr] + w[kk] * v
        for rr in range(R):
            s_v[:, (g * R + rr) * pitch + _skew(c, psh)] = _prep(acc[rr], bf16)
    return s_v


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


def _pfb_v_twin(hist, x, taps, plan):
    """``csrc/pfb.cu``'s "v" layout: one row a block, the MAC read through the
    reversed channel index from device memory, v alone in shared memory
    (bit-reversed for the in-place radix-2 transform of a power of two, in
    order for the direct DFT), the inverse twiddles ``tw[pos << shift]``."""
    K, N = taps.shape
    t = x.shape[0] // N
    assert not plan.window and plan.tw_len == N and plan.smem == 8 * N
    ext = torch.cat([hist, x])
    c = torch.arange(N)
    v = torch.zeros(t, N, dtype=torch.complex64)
    for kk in range(K):
        e = (torch.arange(t)[:, None] + K - 1 - kk) * N + (N - 1 - c)[None, :]
        v = v + taps[kk].to(torch.float32)[None, :] * ext[e]
    tab = ck._fft_table(N, (), torch.device("cpu"))
    tw = torch.complex(tab[:, 0], tab[:, 1])
    if N & (N - 1):
        idx = (c[:, None] * c[None, :]) % N                # [c, c']
        return (v[:, :, None] * tw[idx][None]).sum(dim=1)
    log2n = N.bit_length() - 1
    brev = torch.tensor([int(f"{i:0{log2n}b}"[::-1], 2) if log2n else 0 for i in range(N)])
    s_v = torch.zeros_like(v)
    s_v[:, brev] = v
    b = torch.arange(N // 2)
    for st in range(1, log2n + 1):
        half, shift = 1 << (st - 1), log2n - st
        pos = b & (half - 1)
        i = ((b >> (st - 1)) << st) + pos
        j = i + half
        w = tw[pos << shift]
        u, p = s_v[:, i], s_v[:, j] * w
        s_v[:, i], s_v[:, j] = u + p, u - p
    return s_v


SWEEP_PFB = {(64, 12, 4096), (2048, 12, 128)}


def _sweep_cases():
    """Every candidate of the plan sweep (``tpu/kernel_tune.py``) at the main
    paths' shapes: ``(kernel, shape, candidate index)``."""
    from futuresdr_tpu_torch.tpu import kernel_tune
    cases = []
    for kernel, _label, spec in kernel_tune.SHAPES:
        if kernel in ("rotator", "quad_demod"):
            continue
        shape = kernel_tune._workload(kernel, spec, torch.device("cpu"), 1,
                                      torch.Generator().manual_seed(0))[0]
        for i in range(len(ck.plan_candidates(kernel, *shape))):
            cases.append((kernel, shape, i))
    return cases


@pytest.mark.parametrize("kernel,shape,i", _sweep_cases())
def test_sweep_candidate_layouts_match_plain(kernel, shape, i):
    """Each layout the sweep may pick, walked by its kernel's twin at the
    main path's shape (the poly_fir rows cut to 2,048 outputs where the
    layout does not depend on them; the lane forms' batches cut to 3 lanes
    of 2,048 samples and 2 lanes of 2 rows, ``poly_fir_lanes`` to 3 lanes of
    at most 2,048 rows), against
    the plain version: the tolerances of the twins' own tests (rel. 1e-6
    ``fir``, ``poly_fir``, ``fir_lanes``; 1e-5 ``fir_fft``, ``pfb``,
    ``fir_fft_lanes``, ``pfb_lanes``, cut to 3 lanes of 256 rows; the sums'
    orders differ)."""
    plan = ck.plan_candidates(kernel, *shape)[i]
    seed = (sum(shape) + 31 * i) % 10_000
    if kernel == "fir":
        n, nt, cplx, _n_sm = shape
        hist, x, taps = _fir_case(n, nt, bool(cplx), seed)
        assert _rel(_fir_twin(hist, x, taps, plan), _fir_plain(hist, x, taps)) <= 1e-6
    elif kernel == "fir_fft":
        n_fft, nt = shape
        hist, x, taps = _fir_case(1 << 18, nt, True, seed)
        got = _fir_fft_twin(hist, x, taps, n_fft, plan)
        assert _rel(got, ck.fir_fft_plain(hist, x, taps, n_fft)) <= 1e-5
    elif kernel == "poly_fir":
        m, D, I, nq, cplx, _n_sm = shape
        hist, x, W = _poly_case(D, m, I, min(nq, 2048), bool(cplx), seed)
        tol = 1e-6 * max(1.0, D * (m + 1) / 1000)
        assert _rel(_poly_twin(hist, x, W, plan), ck.poly_fir_plain(hist, x, W)) <= tol
    elif kernel == "fir_lanes":
        L, n, nt, cplx, _n_sm = shape
        hist, x, taps = _lanes_case(min(L, 3), min(n, 2048), nt, bool(cplx), seed)
        got = _fir_lanes_twin(hist, x, taps, plan)
        assert _rel(got, ck.fir_lanes_plain(hist, x, taps)) <= 1e-6
    elif kernel == "fir_fft_lanes":
        L, n, n_fft, nt, _n_sm = shape
        hist, x, taps = _lanes_case(min(L, 2), 2 * n_fft, nt, True, seed)
        got = _fir_fft_lanes_twin(hist, x, taps, n_fft, plan)
        assert _rel(got, ck.fir_fft_lanes_plain(hist, x, taps, n_fft)) <= 1e-5
    elif kernel == "poly_fir_lanes":
        L, m, D, I, nq, cplx, _n_sm = shape
        hist, x, W = _poly_lanes_case(min(L, 3), D, m, I, min(nq, 2048), bool(cplx), seed,
                                      shared=I > 1)
        got = _poly_fir_lanes_twin(hist, x, W, plan)
        assert _rel(got, ck.poly_fir_lanes_plain(hist, x, W)) <= 1e-6 * max(
            1.0, D * (m + 1) / 1000)
    elif kernel == "pfb_lanes":
        L, N, K, t, _n_sm = shape
        hist, x, taps = _pfb_lanes_case(min(L, 3), N, K, min(t, 256), seed)
        got = _pfb_lanes_twin(hist, x, taps, plan)
        assert _rel(got, ck.pfb_lanes_plain(hist, x, taps)) <= 1e-5
    else:
        N, K, t, _n_sm = shape
        hist, x, taps = _pfb_case(N, K, t, seed)
        twin = _pfb_twin if plan.window else _pfb_v_twin
        assert _rel(twin(hist, x, taps, plan), ck.pfb_plain(hist, x, taps)) <= 1e-5


# ---------------------------------------------------------------------------
# the lane forms: fir_lanes and fir_fft_lanes
# ---------------------------------------------------------------------------

def _rows_of(t):
    """``t [L, k]`` as the kernel sees it: the flat storage its rows lie in
    (one row where the lanes share it, stride 0) and the row stride."""
    if t.shape[0] > 1 and t.stride(0) == 0:
        return t[0].contiguous(), 0
    return t.contiguous().reshape(-1), t.shape[1]


def _lanes_twin(hist, x, taps, one_stream, out_dtype):
    """A lane form's grid walk (``csrc/fir.cu``, ``fir_fft.cu``): grid y is
    the lane, whose blocks offset hist, x, taps and y by its row strides and
    run the one-stream walk ``one_stream(hist_row, x_row, taps_row)`` on its
    row. The rows are cut from flat buffers of the tensors' own sizes (an
    index past one raises), and every output of the ``[L, n]`` result is
    written exactly once, into its own lane's row."""
    L, n = x.shape
    nt = taps.shape[1]
    fx, xs = _rows_of(x)
    ft, ts = _rows_of(taps)
    fh, hs = (None, 0) if hist is None else _rows_of(hist)
    y = torch.zeros(L * n, dtype=out_dtype)
    writes = torch.zeros(L * n, dtype=torch.int64)
    for lane in range(L):
        row = lane * n + torch.arange(n)
        y[row] = one_stream(None if fh is None else fh[lane * hs + torch.arange(nt - 1)],
                            fx[lane * xs + torch.arange(n)], ft[lane * ts + torch.arange(nt)])
        writes[row] += 1
    assert torch.equal(writes, torch.ones_like(writes)), "an output written twice or never"
    return y.view(L, n)


def _fir_lanes_twin(hist, x, taps, plan, bf16=False):
    return _lanes_twin(hist, x, taps, lambda h, xr, t: _fir_twin(h, xr, t, plan, bf16),
                       x.dtype)


def _fir_fft_lanes_twin(hist, x, taps, n, plan, bf16=False):
    assert plan.radices == ck._fir_fft_rule(n, taps.shape[1]).radices   # one arithmetic
    return _lanes_twin(hist, x, taps, lambda h, xr, t: _fir_fft_twin(h, xr, t, n, plan, bf16),
                       torch.complex64)


def _lanes_case(L, n, nt, complex_stream, seed, shared=False, zero_state=False):
    rng = np.random.default_rng(seed)
    if complex_stream:
        hist = torch.from_numpy(np.stack([_c64(rng, nt - 1) for _ in range(L)]))
        x = torch.from_numpy(np.stack([_c64(rng, n) for _ in range(L)]))
    else:
        hist = torch.from_numpy(rng.standard_normal((L, nt - 1)).astype(np.float32))
        x = torch.from_numpy(rng.standard_normal((L, n)).astype(np.float32))
    taps = torch.from_numpy(rng.standard_normal((L, nt)).astype(np.float32))
    if shared:
        taps = taps[:1].expand(L, nt)
    return (None if zero_state else hist), x, taps


_LANE_COUNTS = [1, 3, 16]
_FIR_LANES_N = 2 * ck._FIR_WARP_OUTS - 37         # two tiles a lane, the last ragged


@pytest.mark.parametrize("case", ["own", "shared", "zero state", "bf16", "real"])
@pytest.mark.parametrize("L", _LANE_COUNTS)
def test_fir_lanes_plans_match_plain(L, case):
    """Every ``fir_lanes`` candidate (the one-stream layouts for a lane's
    samples, the rule's first) at L lanes of two tiles, the last ragged, with
    17 taps and ``n_sm`` cut to 3, against the lane plain version: every
    output once, into its own lane's row."""
    nt, cplx = 17, case != "real"
    hist, x, taps = _lanes_case(L, _FIR_LANES_N, nt, cplx, 40 + L, shared=case == "shared",
                                zero_state=case == "zero state")
    prec = "bf16" if case == "bf16" else None
    want = ck.fir_lanes_plain(hist, x, taps, prec)
    cands = ck.plan_candidates("fir_lanes", L, _FIR_LANES_N, nt, int(cplx), 3)
    assert cands[0] == ck.fir_lanes_plan(L, _FIR_LANES_N, nt, cplx, 3)
    assert cands == ck.plan_candidates("fir", _FIR_LANES_N, nt, int(cplx), 3)
    for plan in cands:
        assert plan.smem <= ck._MAX_SMEM
        got = _fir_lanes_twin(hist, x, taps, plan, bf16=prec == "bf16")
        assert _rel(got, want) <= 1e-6, plan


@pytest.mark.parametrize("case", ["own", "shared", "bf16", "real"])
@pytest.mark.parametrize("L", _LANE_COUNTS)
def test_fir_fft_lanes_plans_match_plain(L, case):
    """Every ``fir_fft_lanes`` candidate (the rule, then the one-stream row
    layouts) at L lanes of 3 rows of 128 with 17 taps and ``n_sm`` cut to 3,
    against the lane plain version: every output once, into its own lane's
    row; the rule reads the table through L1 once the batch puts more than
    two rows on an SM."""
    n, nt, rows, cplx = 128, 17, 3, case != "real"
    hist, x, taps = _lanes_case(L, n * rows, nt, cplx, 50 + L, shared=case == "shared")
    prec = "bf16" if case == "bf16" else None
    want = ck.fir_fft_lanes_plain(hist, x, taps, n, prec)
    cands = ck.plan_candidates("fir_fft_lanes", L, n * rows, n, nt, 3)
    assert cands[0] == ck.fir_fft_lanes_plan(L, n * rows, n, nt, 3)
    assert cands[0].tw_staged == (L * rows <= 2 * 3)
    for plan in cands:
        assert plan.smem <= ck._MAX_SMEM
        got = _fir_fft_lanes_twin(hist, x, taps, n, plan, bf16=prec == "bf16")
        assert _rel(got, want) <= 1e-5, plan


@pytest.mark.parametrize("L,n,nt", [(64, 512, 17), (16, 1 << 18, 64), (1, 1 << 18, 64),
                                    (2, 1 << 18, 64), (4, 1 << 18, 64)])
def test_lane_plans_at_the_served_shapes(L, n, nt):
    """The rules at the served shapes (serve_ab's 64 × 512, the main chain's
    16 × 2^18) and beside them: ``fir_lanes`` runs the one-stream rule's plan
    for a lane's samples on every lane; ``fir_fft_lanes`` the one-stream row
    plan, the table read through L1 where the batch puts more than two rows
    on an SM (here from 4 × 2^18). Every candidate fits the card's shared
    memory."""
    for cplx in (1, 0):
        rule = ck.fir_lanes_plan(L, n, nt, bool(cplx))
        assert rule == ck._fir_rule(n, nt, bool(cplx))
        cands = ck.plan_candidates("fir_lanes", L, n, nt, cplx, 132)
        assert cands[0] == rule and all(p.smem <= ck._MAX_SMEM for p in cands)
    if (L, n) == (64, 512):
        assert rule[:4] == (32, 2, 3, 1)              # one-warp blocks, two a lane
    if (L, n) == (16, 1 << 18):
        assert rule[:4] == (128, 256, 3, 1)           # a tile a warp, one buffer
    n_fft = 2048
    if n < n_fft:
        return                                        # no fir_fft row at this frame
    items = L * (n // n_fft)
    rule = ck.fir_fft_lanes_plan(L, n, n_fft, nt)
    row = ck.fir_fft_plan(n_fft, nt)
    assert rule[:6] == row[:6] and rule.tw_staged == (items <= 2 * 132)
    assert rule.tw_staged == (L <= 2)
    assert rule.smem == ck._fir_fft_smem(n_fft, nt, row.span_shift, row.pad_shift,
                                         row.tw_len if rule.tw_staged else 0)
    cands = ck.plan_candidates("fir_fft_lanes", L, n, n_fft, nt, 132)
    assert cands[0] == rule
    for p in cands:
        assert p.smem <= ck._MAX_SMEM and p.radices == row.radices


# ---------------------------------------------------------------------------
# the lane forms of poly_fir and quad_demod
# ---------------------------------------------------------------------------

def _poly_fir_lanes_twin(hist, x, W, plan, bf16=False):
    """``csrc/poly_fir.cu``'s lane form: "rows" walks every lane's tiles as
    one sequence (:func:`_poly_rows_twin`); "gemm" takes the lane as the
    grid's y, whose blocks move hist, x, W and y to its rows by their strides
    (W's 0 where the lanes share one) and run the one-stream walk on its row.
    Each lane's W is cut from the flat storage of the tensor's own size;
    every output of the batch is written exactly once, into its own lane's
    rows."""
    if plan.tiling == "rows":
        return _poly_rows_twin(hist, x, W, plan, bf16)
    L = x.shape[0]
    fw, ws = _lane_w(W)
    D = W.shape[2]
    nq = x.shape[1] // D
    per = nq * (W.shape[3] if W.dim() == 4 else 1)
    y = torch.zeros(L * per, dtype=x.dtype)
    writes = torch.zeros(L * per, dtype=torch.int64)
    for lane in range(L):
        w = fw[lane * ws + torch.arange(W[0].numel())].view(W.shape[1:])
        row = lane * per + torch.arange(per)
        y[row] = _poly_gemm_twin(hist[lane], x[lane], w, plan, bf16).reshape(-1)
        writes[row] += 1
    assert torch.equal(writes, torch.ones_like(writes)), "an output written twice or never"
    return y.view((L,) + tuple(ck.poly_fir_plain(hist[0], x[0], W[0]).shape))


def _poly_lanes_case(L, D, m, I, nq, complex_stream, seed, shared=False, w_bf16=False):
    rng = np.random.default_rng(seed)
    w_shape = (m + 1, D) if I == 1 else (m + 1, D, I)
    W = torch.from_numpy(rng.standard_normal((1 if shared else L,) + w_shape)
                         .astype(np.float32))
    if w_bf16:
        W = W.to(torch.bfloat16)
    W = W.expand((L,) + w_shape) if shared else W
    if complex_stream:
        return (torch.from_numpy(np.stack([_c64(rng, m * D) for _ in range(L)])),
                torch.from_numpy(np.stack([_c64(rng, nq * D) for _ in range(L)])), W)
    return (torch.from_numpy(rng.standard_normal((L, m * D)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((L, nq * D)).astype(np.float32)), W)


# the FM chain's two polyphase calls (n_sm cut to 3, so that few rows fill
# the batch): the channel filter (each lane's W, as the carry holds it) and
# the resampler (one W shared by every lane, a stage constant)
_POLY_LANE_CASES = {"channel": (4, 32, 1, 300, True, False),
                    "channel bf16": (4, 32, 1, 130, True, False),
                    "channel real": (4, 32, 1, 77, False, False),
                    "resampler": (125, 2, 24, 20, False, True),
                    "resampler own W": (125, 2, 24, 9, False, False),
                    "resampler c64": (125, 2, 24, 13, True, True)}


@pytest.mark.parametrize("case", list(_POLY_LANE_CASES))
@pytest.mark.parametrize("L", _LANE_COUNTS)
def test_poly_fir_lanes_plans_match_plain(L, case):
    """Every ``poly_fir_lanes`` candidate (the batch rule, the one-stream
    rule, then its layout at other rows a block) at L lanes against the lane
    plain version, every output once into its own lane's rows; each keeps
    the tiling and K split of a lane's one-stream plan."""
    D, m, I, nq, cplx, shared = _POLY_LANE_CASES[case]
    bf16 = case.endswith("bf16")
    hist, x, W = _poly_lanes_case(L, D, m, I, nq, cplx, 60 + L + nq, shared, bf16)
    prec = "bf16" if bf16 else None
    want = ck.poly_fir_lanes_plain(hist, x, W, prec)
    row = ck.poly_fir_plan(m, D, I, nq, cplx, 3)
    cands = ck.plan_candidates("poly_fir_lanes", L, m, D, I, nq, int(cplx), 3)
    assert cands[0] == ck.poly_fir_lanes_plan(L, m, D, I, nq, cplx, 3)
    assert len(cands) > 1
    tol = 1e-6 * max(1.0, D * (m + 1) / 1000)
    for plan in cands:
        assert plan.smem <= ck._MAX_SMEM and ck._same_order(plan, row), plan
        got = _poly_fir_lanes_twin(hist, x, W, plan, bf16)
        assert got.shape == want.shape and got.dtype == want.dtype
        assert _rel(got, want) <= tol, plan


@pytest.mark.parametrize("L", [1, 3, 4, 16, 64])
def test_poly_fir_lanes_plan_at_the_served_fm_shape(L):
    """At the served FM frame (32,000 input samples a session): the channel
    filter keeps the one-stream plan's "rows" order (4 column chains) in 128
    threads of 4 rows; its 16 tiles a lane go to 2 resident blocks a SM
    walking them with two buffers once there are more tiles than that (from
    17 sessions), else a block a tile. The resampler keeps the one-stream
    plan's K split over its 375 taps (16 parts) and takes more rows a block
    as the batch grows, as many as still give 4 blocks a SM, else 7/8 of one
    (4 at one lane, 8 at 16 and 64 lanes: 512 blocks at 64, where the
    one-stream plan's 4 rows would make 1,024). One lane is the one-stream
    plan."""
    chan_row = ck.poly_fir_plan(32, 4, 1, 8000, True)
    chan = ck.poly_fir_lanes_plan(L, 32, 4, 1, 8000, True)
    assert chan.tiling == "rows" and ck._same_order(chan, chan_row) and chan.ksplit == 4
    assert (chan.threads, chan.rows, chan.tile_rows, chan.pad) == (128, 512, 4, 2)
    assert chan.blocks == (264 if L * 16 > 264 else 0)
    row = ck.poly_fir_plan(2, 125, 24, 64, False)
    res = ck.poly_fir_lanes_plan(L, 2, 125, 24, 64, False)
    assert res.tiling == "gemm" and ck._same_order(res, row) and res.ksplit == 16
    assert res.rows == {1: 4, 3: 4, 4: 4, 16: 8, 64: 8}[L]
    assert L * -(-64 // res.rows) * 8 >= 132 * 7 or res.rows == 4
    if L == 1:
        assert res == row and chan == chan_row


# (D, m, I, nq, complex, shared W) at the served widths, few rows: the
# channel filter (each lane's W, and one shared) and the resampler (one W
# shared, and each lane's)
_LANE_WALKS = {"channel": (4, 32, 1, 1100, True, False),
               "channel shared": (4, 32, 1, 1100, True, True),
               "resampler": (125, 2, 24, 70, False, True),
               "resampler own W": (125, 2, 24, 70, False, False)}


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", list(_LANE_WALKS))
def test_poly_fir_lane_walk_equals_one_stream_walk(case, bf16):
    """A served lane equals the bare one-stream launch bit for bit: the lane
    walk (the batch rule's layout: "rows" on 2 resident blocks a SM over
    every lane's tiles, "gemm" with the batch's rows a block) holds each lane
    against the one-stream walk's twin on its row with ``torch.equal``, at
    the served widths on 3 lanes, with the lanes' own W and one W shared
    (stride 0), float32 and bf16 (bf16 W in bf16 mode). ``n_sm`` is cut to
    1, so that 3 lanes of 3 tiles already take the resident "rows" walk,
    held against a block a tile; the "gemm" lanes' rows a block are held
    against 8."""
    D, m, I, nq, cplx, shared = _LANE_WALKS[case]
    L, n_sm = 3, 1
    hist, x, W = _poly_lanes_case(L, D, m, I, nq, cplx, 90 + nq, shared, bf16)
    row = ck.poly_fir_plan(m, D, I, nq, cplx, n_sm)
    plan = ck.poly_fir_lanes_plan(L, m, D, I, nq, cplx, n_sm)
    one = ck._gemm_layout(1, row, m, D, I, nq, cplx, n_sm, 8) \
        if row.tiling == "gemm" else ck._rows_layout(1, m, D, row.ksplit, nq, cplx, n_sm,
                                                     blocks=0)
    assert ck._same_order(plan, row) and ck._same_order(one, row) and plan != one
    if plan.tiling == "rows":
        assert 0 < plan.blocks < L * -(-nq // plan.rows) and one.blocks == 0
    got = _poly_fir_lanes_twin(hist, x, W, plan, bf16)
    for lane in range(L):
        lone = _poly_twin(hist[lane], x[lane], W[lane].contiguous(), one, bf16)
        assert torch.equal(got[lane], lone), lane
    ref = ck.poly_fir_lanes_plain(hist, x, W, "bf16" if bf16 else None)
    assert _rel(got, ref) <= 1e-6


def test_poly_fir_same_order_is_the_tiling_and_its_k_split():
    """What fixes an output's bits: the tiling and its K split (the column
    chains of "rows", the parts of "gemm"). The rows a thread or a block, the
    threads, the pad and the resident blocks do not; a plan that differs
    from the one-stream plan in its K split or tiling is another order, and
    its walk gives other bits on the same inputs."""
    row = ck.poly_fir_plan(32, 4, 1, 1100, True, 1)
    same = [row._replace(tile_rows=8), row._replace(threads=64, rows=256),
            row._replace(pad=0), row._replace(blocks=7)]
    assert all(ck._same_order(p, row) for p in same)
    assert not ck._same_order(row._replace(ksplit=2), row)
    assert not ck._same_order(row._replace(tiling="gemm"), row)
    res = ck.poly_fir_plan(2, 125, 24, 70, False, 1)
    assert ck._same_order(res._replace(rows=16), res)
    assert ck._same_order(res._replace(tile_phases=4), res)
    assert not ck._same_order(res._replace(ksplit=1), res)
    # the walks: another layout of one order gives the same bits, another
    # K split other bits
    hist, x, W = _poly_case(125, 2, 24, 70, False, 5)
    base = _poly_twin(hist, x, W, res)
    other = ck._gemm_layout(1, res, 2, 125, 24, 70, False, 1, 4)
    assert ck._same_order(other, res) and other.rows != res.rows
    assert torch.equal(_poly_twin(hist, x, W, other), base)
    unsplit = ck._gemm_layout(1, res._replace(ksplit=1), 2, 125, 24, 70, False, 1)
    assert not ck._same_order(unsplit, res)
    assert not torch.equal(_poly_twin(hist, x, W, unsplit), base)
    hist, x, W = _poly_case(4, 32, 1, 1100, True, 6)
    base = _poly_twin(hist, x, W, row)
    assert torch.equal(_poly_twin(hist, x, W, ck._rows_layout(1, 32, 4, 4, 1100, True, 1, 32,
                                                                  2)), base)
    two = ck._rows_layout(1, 32, 4, 2, 1100, True, 1)
    assert not ck._same_order(two, row)
    assert not torch.equal(_poly_twin(hist, x, W, two), base)


def test_poly_fir_lanes_plan_keeps_the_bare_chains_order():
    """A tuned lane plan that sums in another order than the one-stream plan
    (which the bare chain launches) is passed over for the rule; a tuned
    one-stream plan moves the lane plan's K split with it."""
    shape = (64, 2, 125, 24, 64, 0, 132)
    cands = ck.plan_candidates("poly_fir_lanes", *shape)
    pick = cands[-1]
    try:
        ck.set_tuned_plans({"poly_fir_lanes": {shape: pick}})
        assert ck.poly_fir_lanes_plan(*shape[:5], False, 132) == pick
        other = next(p for p in ck.plan_candidates("poly_fir", 2, 125, 24, 64, 0, 132)
                     if p.ksplit != cands[0].ksplit)
        ck.set_tuned_plans({"poly_fir_lanes": {shape: pick},
                            "poly_fir": {(2, 125, 24, 64, 0, 132): other}})
        got = ck.poly_fir_lanes_plan(*shape[:5], False, 132)
        assert got != pick and got.ksplit == other.ksplit and ck._same_order(got, other)
    finally:
        ck.set_tuned_plans(None)


@pytest.mark.parametrize("n", [1, 255, 257, 2000])
def test_quad_demod_lanes_walk_matches_plain(n):
    """``csrc/quad_demod.cu``'s lane form: grid y is the lane, whose blocks
    move x and y by their row strides and read the lane's own ``prev``; its
    last thread writes the lane's ``last``. Each lane the one-stream walk,
    every output of the batch once."""
    L = 3
    rng = np.random.default_rng(n)
    x = torch.from_numpy(np.stack([_c64(rng, n) for _ in range(L)]))
    prev = torch.from_numpy(_c64(rng, L))
    gain = 250e3 / (2 * np.pi * 75e3)
    ys, lasts = zip(*[_quad_demod_twin(prev[i], x[i], gain) for i in range(L)])
    y, last = torch.stack(ys), torch.stack(lasts)
    ref, ref_last = ck.quad_demod_lanes_plain(prev, x, gain)
    assert y.shape == ref.shape == (L, n) and torch.equal(last, ref_last)
    assert _wrapped_err(y, ref, gain) <= 1e-5


def _quad_demod_lanes_twin(prev, x, gain):
    """``csrc/quad_demod.cu``'s lane form as it walks ``x [L, n]`` through its
    pointer and row stride: a grid of ``⌈n / QUAD_DEMOD_TILE⌉`` blocks by L
    lanes, thread t of lane l reading the sample at ``l·xs + t`` of the
    batch's memory (x moved by the lane's row), its neighbour ``prev[l]`` at
    t = 0 and the sample before it otherwise, and thread n − 1 writing
    ``last[l]``. Asserts every output is written once and each lane's ``last``
    once. Each row's arithmetic is the plain version's on the operands the
    walk gathered, so the result is ``torch.equal`` to it exactly where the
    walk gathers the right samples. Returns ``(y, last)``."""
    L, n = x.shape
    xs = x.stride(0)
    mem = x.as_strided(((L - 1) * xs + n,), (1,))      # the memory from x's start
    blocks = -(-n // ck.QUAD_DEMOD_TILE)
    t = torch.arange(blocks * ck.QUAD_DEMOD_TILE)
    lane = torch.arange(L).repeat_interleave(t.numel())
    t = t.repeat(L)
    live = t < n
    lane, t = lane[live], t[live]
    v = mem[lane * xs + t]
    p = torch.where(t == 0, prev[lane], mem[(lane * xs + t - 1).clamp(min=0)])
    count = torch.zeros(L * n, dtype=torch.int64)
    _count(count, lane * n + t)
    ends = t == n - 1
    last = torch.zeros(L, dtype=torch.complex64)
    last[lane[ends]] = v[ends]
    last_count = torch.zeros(L, dtype=torch.int64)
    _count(last_count, lane[ends])
    assert bool((count == 1).all()) and bool((last_count == 1).all())
    rows_v = torch.zeros(L * n, dtype=torch.complex64)
    rows_p = torch.zeros(L * n, dtype=torch.complex64)
    rows_v[lane * n + t], rows_p[lane * n + t] = v, p
    rows_v, rows_p = rows_v.reshape(L, n), rows_p.reshape(L, n)
    y = torch.stack([_demod(rows_v[i], rows_p[i], gain) for i in range(L)])
    return y, last


def _qd_batch(L, n, seed, stride=None, offset=0):
    """``(prev [L], x [L, n])`` from a seed; rows ``stride`` samples apart
    (a view of a wider batch), the batch ``offset`` samples into its buffer."""
    rng = np.random.default_rng(seed)
    stride = n if stride is None else stride
    buf = torch.from_numpy(_c64(rng, offset + L * stride)).clone()
    x = buf[offset:].reshape(L, stride)[:, :n]
    return torch.from_numpy(_c64(rng, L)), x


@pytest.mark.parametrize("n", [1, 2, 3, 255, 256, 257, 1023, 8000, 8002])
@pytest.mark.parametrize("L", [1, 2, 16, 64])
def test_quad_demod_lanes_walk_equals_plain(L, n):
    """The lane grid over ``[L, n]``, walked thread by thread: every output
    and each lane's ``last`` written once, each neighbour from the right
    sample, and ``torch.equal`` to the plain version, outputs and carries."""
    prev, x = _qd_batch(L, n, 1000 * L + n)
    gain = 250e3 / (2 * np.pi * 75e3)
    y, last = _quad_demod_lanes_twin(prev, x, gain)
    ref, ref_last = ck.quad_demod_lanes_plain(prev, x, gain)
    assert torch.equal(y, ref) and torch.equal(last, ref_last), (L, n)


@pytest.mark.parametrize("L, n, stride, offset", [(16, 8000, 8008, 0), (3, 256, 300, 0),
                                                  (64, 8000, 8000, 1), (5, 2, 2, 1)])
def test_quad_demod_lanes_walk_takes_strided_and_unaligned_rows(L, n, stride, offset):
    """Rows a stride wider than n apart, and a batch 8 bytes off a 16-byte
    boundary: the walk reads each lane's row through the stride and equals
    the plain version."""
    prev, x = _qd_batch(L, n, n + L, stride, offset)
    gain = 0.53
    y, last = _quad_demod_lanes_twin(prev, x, gain)
    ref, ref_last = ck.quad_demod_lanes_plain(prev, x, gain)
    assert torch.equal(y, ref) and torch.equal(last, ref_last)


# ---------------------------------------------------------------------------
# the lane form of pfb
# ---------------------------------------------------------------------------

def _pfb_walk_twin(hist, x, taps, plan, bf16=False):
    """``csrc/pfb.cu``'s "walk": ``min(blocks, L·tiles)`` blocks, block b
    walking the (lane, tile) pairs from ``total·b // B`` to ``total·(b+1) //
    B`` in order; a ring of 3 slots of ``K − 1`` halo rows and ``rows``
    tile rows (stale slots hold NaN), filled 2 tiles ahead and refilled after the MAC of the tile after the slot's: a lane's
    first tile takes hist into its halo rows, a run's first tile inside a lane
    its halo rows of x with its span, every other tile its span alone, its
    halo read from the previous slot's last rows; channel c read at column
    ``N − 1 − c``. Asserts each tile finds its own rows in its slot and the
    previous tile's in the previous one. Each tile's window then goes through
    the window layout's MAC (on half the block: half the row groups, 2R rows
    a thread) and IDFT, a lane's tiles as one batch (as :func:`_pfb_twin`
    batches them); every output written once."""
    L, K, N = taps.shape
    t = x.shape[1] // N
    tr, S = plan.rows, ck._PFB_WALK_STAGES
    assert plan.blocks > 0 and ck._pfb_walks(plan, N, K)
    tw_staged = plan.tw_len if plan.tw_staged else 0
    assert ck._pfb_walk_smem(N, K, tr, plan.pitch, tw_staged) == plan.smem
    # the MAC on the block's second half: half the row groups, 2R rows a thread
    mac_plan = plan._replace(groups=plan.groups // 2, outs=2 * plan.outs)
    tiles = -(-t // tr)
    total = L * tiles
    blocks = min(plan.blocks, total)
    span = tr + K - 1
    stale = torch.full((span, N), complex("nan"), dtype=torch.complex64)
    windows = torch.zeros(L, tiles, span, N, dtype=torch.complex64)
    seen = torch.zeros(L, tiles, dtype=torch.int64)
    for b in range(blocks):
        q0, q1 = total * b // blocks, total * (b + 1) // blocks
        ring = [stale.clone() for _ in range(S)]
        held = [None] * S

        def issue(q):
            lane, s0 = q // tiles, (q % tiles) * tr
            rows, slot = min(tr, t - s0), (q - q0) % S
            ring[slot] = stale.clone()
            xl = x[lane]
            if s0 == 0:
                ring[slot][:K - 1] = hist[lane].view(K - 1, N)
                ring[slot][K - 1:K - 1 + rows] = xl[:rows * N].view(rows, N)
            elif q == q0:
                ring[slot][:K - 1 + rows] = xl[(s0 - K + 1) * N:(s0 + rows) * N].view(-1, N)
            else:
                ring[slot][K - 1:K - 1 + rows] = xl[s0 * N:(s0 + rows) * N].view(rows, N)
            held[slot] = q

        for q in range(q0, min(q1, q0 + S - 1)):
            issue(q)
        for q in range(q0, q1):
            j, lane, tau = q - q0, q // tiles, q % tiles
            assert held[j % S] == q, "a tile's slot does not hold its rows"
            own = tau == 0 or q == q0
            if not own:
                assert held[(j - 1) % S] == q - 1, "the halo's slot was refilled"
            cur, prev = ring[j % S], ring[(j - 1) % S]
            win = torch.stack([prev[tr + w] if (w < K - 1 and not own) else cur[w]
                               for w in range(span)])
            windows[lane, tau] = win.flip(1)           # channel c: column N - 1 - c
            seen[lane, tau] += 1
            if q + S - 1 < q1:
                issue(q + S - 1)                       # after the MAC's last read
    assert torch.equal(seen, torch.ones_like(seen)), "a tile walked twice or never"
    store = torch.empty(0, dtype=taps.dtype).set_(taps.untyped_storage())
    sl, sk, sn = taps.stride()
    kk, c = torch.arange(K)[:, None], torch.arange(N)[None, :]
    y = torch.zeros(L, tiles * tr, N, dtype=torch.complex64)
    for lane in range(L):
        w = _prep(store[taps.storage_offset() + lane * sl + kk * sk + c * sn].to(torch.float32),
                  bf16)
        s_v = _pfb_window_mac(_prep(windows[lane], bf16), w, mac_plan, bf16)
        y[lane] = _pfb_idft_twin(s_v, tr * plan.pitch, plan, N).reshape(-1, N)
    return y[:, :t]


def _pfb_lanes_twin(hist, x, taps, plan, bf16=False):
    """``csrc/pfb.cu``'s lane form: grid y is the lane, whose blocks move
    hist, x, the taps and y to its rows by their strides (the taps' 0 where
    the lanes share one prototype; within a lane the taps' own two strides,
    the carry's transposed view) and run the one-stream layout on its row.
    Each lane's taps are read from the storage of the tensor's own size (an
    index past it raises); every output of the batch is written exactly
    once, into its own lane's rows."""
    L, K, N = taps.shape
    t = x.shape[1] // N
    if plan.blocks:
        return _pfb_walk_twin(hist, x, taps, plan, bf16)
    store = torch.empty(0, dtype=taps.dtype).set_(taps.untyped_storage())
    sl, sk, sn = taps.stride()
    kk, c = torch.arange(K)[:, None], torch.arange(N)[None, :]
    y = torch.zeros(L * t * N, dtype=torch.complex64)
    writes = torch.zeros(L * t * N, dtype=torch.int64)
    for lane in range(L):
        w = store[taps.storage_offset() + lane * sl + kk * sk + c * sn]
        one = _pfb_twin(hist[lane], x[lane], w, plan, bf16) if plan.window else \
            _pfb_v_twin(hist[lane], x[lane], w, plan)
        row = lane * t * N + torch.arange(t * N)
        y[row] = one.reshape(-1)
        writes[row] += 1
    assert torch.equal(writes, torch.ones_like(writes)), "an output written twice or never"
    return y.view(L, t, N)


def _pfb_lanes_case(L, N, K, t, seed, shared=False, taps_bf16=False):
    """L lanes of history and frame, and taps as the stage passes them: its
    ``[L, N, K]`` carry transposed (one expanded with stride 0 where
    ``shared``)."""
    rng = np.random.default_rng(seed)
    hc = torch.from_numpy(rng.standard_normal((1 if shared else L, N, K)).astype(np.float32))
    if taps_bf16:
        hc = hc.to(torch.bfloat16)
    hc = hc.expand(L, N, K)
    hist = torch.from_numpy(np.stack([_c64(rng, (K - 1) * N) for _ in range(L)]))
    x = torch.from_numpy(np.stack([_c64(rng, t * N) for _ in range(L)]))
    return hist, x, hc.transpose(1, 2)


# (N, K, t, shared): PFB-64 with its 12 taps in registers, ragged against the
# tile; a prototype shared (stride 0); 4 taps a branch from shared memory;
# PFB-2048 in 512-channel chunks; the direct DFT
_PFB_LANE_CASES = {"PFB-64": (64, 12, 37, False), "PFB-64 shared": (64, 12, 37, True),
                   "N=16 K=4": (16, 4, 29, False), "PFB-2048": (2048, 12, 3, False),
                   "N=24 direct": (24, 12, 11, False)}


@pytest.mark.parametrize("case", list(_PFB_LANE_CASES))
@pytest.mark.parametrize("L", _LANE_COUNTS)
def test_pfb_lanes_plans_match_plain(L, case):
    """Every ``pfb_lanes`` candidate (the batch rule, then the one-stream
    layouts that keep the rule's layout and radices) at L lanes with
    ``n_sm`` cut to 3 against the lane plain version, every output once into
    its own lane's rows."""
    N, K, t, shared = _PFB_LANE_CASES[case]
    hist, x, taps = _pfb_lanes_case(L, N, K, t, 70 + L + N, shared)
    want = ck.pfb_lanes_plain(hist, x, taps)
    row = ck.pfb_plan(N, K, t, 3)
    cands = ck.plan_candidates("pfb_lanes", L, N, K, t, 3)
    assert cands[0] == ck.pfb_lanes_plan(L, N, K, t, 3)
    for plan in cands:
        assert plan.smem <= ck._MAX_SMEM and ck._pfb_same_values(plan, row), plan
        got = _pfb_lanes_twin(hist, x, taps, plan)
        assert got.shape == want.shape and _rel(got, want) <= 1e-5, plan


def test_pfb_lanes_twin_takes_the_v_layout_and_bf16_taps():
    """The v layout (forced, as the card's checks force it) over 3 lanes,
    and the window layout with bf16 taps in bf16 mode against the lane plain
    version's arithmetic with the kernel's float32 twiddles."""
    N, K, t = 1000, 12, 3
    hist, x, taps = _pfb_lanes_case(3, N, K, t, 5)
    v = ck.PfbPlan(False, 256, N, 1, 1, 1, 0, (), (), (), N, N, ck._NO_PAD, False, 8 * N)
    assert _rel(_pfb_lanes_twin(hist, x, taps, v), ck.pfb_lanes_plain(hist, x, taps)) <= 1e-5
    N, t = 64, 37
    hist, x, taps = _pfb_lanes_case(3, N, K, t, 6, taps_bf16=True)
    got = _pfb_lanes_twin(hist, x, taps, ck.pfb_lanes_plan(3, N, K, t, 3), bf16=True)
    for lane in range(3):
        rows = ck._planes(torch.cat([hist[lane], x[lane]])).reshape(t + K - 1, N, 2).flip(1)
        rows, w = ck._bf16(rows), ck._bf16(taps[lane].to(torch.float32))
        acc = torch.zeros((t, N, 2))
        for k in range(K):
            acc = acc + w[k, :, None] * rows[K - 1 - k:K - 1 - k + t]
        ref = torch.fft.ifft(torch.view_as_complex(ck._bf16(acc).contiguous()), dim=1) * N
        assert _rel(got[lane], ref) <= 1e-5


# (L, N, K, t, n_sm): the served shapes cut to a few lanes (runs of many
# tiles: n_sm 3 gives 6 resident blocks), ragged rows (runs starting inside a
# lane, a part-filled last tile; long runs of 5 on 2 blocks; a run's last
# tile part-filled, the next run starting on a lane's first), and the other
# channel count the walk takes (N = 32: radices 2 x 16, 64 rows a tile), in
# one tile a lane and ragged
_PFB_WALK_CASES = {"64 x 2^15 cut": (3, 64, 12, 512, 3),
                   "16 x 2^18 cut": (2, 64, 12, 4096, 3),
                   "ragged": (5, 64, 12, 37, 3), "ragged on 2 blocks": (5, 64, 12, 37, 1),
                   "part-filled tile ends a run": (3, 64, 12, 100, 2),
                   "N=32": (3, 32, 12, 300, 3), "N=32 ragged": (5, 32, 12, 150, 2)}


def _pfb_walk_plan(L, N, K, t, n_sm):
    rule = ck._pfb_rule(N, K, L * t, n_sm)
    assert ck._pfb_walks(rule, N, K), rule
    return ck._pfb_walk(rule, N, K, n_sm)


@pytest.mark.parametrize("mode", ["f32", "bf16", "shared"])
@pytest.mark.parametrize("case", list(_PFB_WALK_CASES))
def test_pfb_walk_equals_window_layout(case, mode):
    """The walk's tiling (each block's run of (lane, tile) pairs, the ring's
    slots and halo rows, the reversed read, the MAC on half the block at 2R
    rows a thread) gives each lane the window layout's values at the same
    rows a tile bit for bit, in f32, in bf16 mode with bf16 taps and with one
    prototype shared (stride 0); f32 within 1e-5 of the lane plain version's
    peak."""
    L, N, K, t, n_sm = _PFB_WALK_CASES[case]
    hist, x, taps = _pfb_lanes_case(L, N, K, t, L + N + t, shared=mode == "shared",
                                    taps_bf16=mode == "bf16")
    plan = _pfb_walk_plan(L, N, K, t, n_sm)
    window = plan._replace(blocks=0, smem=ck._pfb_smem(
        N, K, plan.rows, plan.chunk, len(plan.radices), plan.pitch,
        plan.tw_len if plan.tw_staged else 0, plan.k_regs))
    bf16 = mode == "bf16"
    got = _pfb_walk_twin(hist, x, taps, plan, bf16)
    assert torch.equal(got, _pfb_lanes_twin(hist, x, taps, window, bf16))
    if not bf16:
        assert _rel(got, ck.pfb_lanes_plain(hist, x, taps)) <= 1e-5


@pytest.mark.parametrize("case,walks", [
    ("64 x 2^15", True), ("16 x 2^18", True), ("one lane of 2^21", True),
    ("misaligned", False), ("N=2048", False), ("v layout", False), ("K=40", False),
    ("N=25", False), ("3 x 37", False), ("N=16", False), ("K=4", False), ("N=128", False)])
def test_pfb_lanes_plan_walks_where_it_applies(case, walks):
    """The walk for the served PFB-64 batches (2 blocks an SM, R = 8)
    and one long lane; today's window layout for a misaligned lane stride,
    N above one chunk, the v layout, a halo longer than the tile, an odd N,
    a batch whose rule keeps R = 1, one Stockham pass (N = 16), taps out of
    registers (K = 4) and a walk two of whose blocks would not fit an SM's
    shared memory (N = 128: 118,808 B a block); a tuned walk is passed over for a misaligned
    batch."""
    L, N, K, t, aligned = {"64 x 2^15": (64, 64, 12, 512, True),
                           "16 x 2^18": (16, 64, 12, 4096, True),
                           "one lane of 2^21": (1, 64, 12, 1 << 15, True),
                           "misaligned": (64, 64, 12, 512, False),
                           "N=2048": (16, 2048, 12, 128, True),
                           "v layout": (3, 16384, 12, 4, True),
                           "K=40": (64, 64, 40, 512, True), "N=25": (64, 25, 12, 512, True),
                           "3 x 37": (3, 64, 12, 37, True), "N=16": (64, 16, 12, 2048, True),
                           "K=4": (64, 64, 4, 512, True),
                           "N=128": (64, 128, 12, 512, True)}[case]
    plan = ck.pfb_lanes_plan(L, N, K, t, 132, aligned)
    assert bool(plan.blocks) == walks, plan
    assert ck._pfb_same_values(plan, ck.pfb_plan(N, K, t, 132))
    if walks:
        assert (plan.blocks, plan.outs) == (264, 8)
        assert plan == ck._pfb_walk(plan, N, K, 132) and plan in ck.plan_candidates(
            "pfb_lanes", L, N, K, t, 132)
    elif case == "misaligned":
        walk = ck.pfb_lanes_plan(L, N, K, t, 132, True)
        ck.set_tuned_plans({"pfb_lanes": {(L, N, K, t, 132): walk}})
        try:
            assert ck.pfb_lanes_plan(L, N, K, t, 132, True) == walk
            assert not ck.pfb_lanes_plan(L, N, K, t, 132, False).blocks
        finally:
            ck.set_tuned_plans(None)
    if case == "v layout":
        assert not plan.window
