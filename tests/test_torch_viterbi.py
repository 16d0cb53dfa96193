"""The port's Viterbi decoder (``futuresdr_tpu_torch/ops/viterbi.py``) against
the JAX package's ``lax.scan`` decoder (``futuresdr_tpu/ops/viterbi.py``) on the
CPU, for 802.11's 64-state and M17's 16-state trellis.

The plain ACS (the kernel's plain version, which a CPU tensor takes) must give
the JAX scan's picks bit for bit: both sum ``m + bm0·λ0 + bm1·λ1`` left to
right in float32 with ±1 branch weights (the products are exact) and keep
candidate 0 on a tie. The plain traceback over packed survivors must give the
reference's host loop's bits. Inputs are made by numpy from a seed.
"""

import numpy as np
import pytest
import torch

import futuresdr_tpu.ops.viterbi as JV
from futuresdr_tpu.models.m17 import codec as jm17
from futuresdr_tpu.models.wlan import coding as jcoding
from futuresdr_tpu_torch.models.m17 import codec as m17
from futuresdr_tpu_torch.models.wlan import coding
from futuresdr_tpu_torch.ops import viterbi as V

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

TABLES = (coding._PREV_S, coding._PREV_B, coding._BM0, coding._BM1)
M17 = m17._M17_PREV


def _jax_run(bucket: int, batch=None):
    """The JAX scan program for ``bucket`` steps (and ``batch`` frames)."""
    prev_s, prev_b, bm0, bm1 = TABLES
    key = (64, prev_s.tobytes(), prev_b.tobytes(), bm0.tobytes(), bm1.tobytes())
    hkey = hash(key)
    JV.tables_key_store.setdefault(hkey, TABLES)
    if batch is None:
        return JV._compiled(64, bucket, hkey)
    return JV._compiled_batch(64, bucket, batch, hkey)


def _tables_t():
    prev_s, _, bm0, bm1 = TABLES
    return (torch.from_numpy(prev_s.astype(np.int32)), torch.from_numpy(bm0.astype(np.float32)),
            torch.from_numpy(bm1.astype(np.float32)))


def _noisy_lams(rng, batch: int, steps: int, sigma: float = 0.8) -> np.ndarray:
    """Soft LLRs of random terminated codewords, ``[batch, steps, 2]`` float32."""
    out = np.empty((batch, steps, 2), np.float32)
    for b in range(batch):
        bits = rng.integers(0, 2, steps).astype(np.uint8)
        bits[-6:] = 0
        coded = coding.conv_encode(bits).astype(np.float64) * 2 - 1
        out[b] = (coded + sigma * rng.standard_normal(2 * steps)).reshape(steps, 2)
    return out


def test_tables_equal_the_reference():
    for mine, ref in zip(TABLES, (jcoding._PREV_S, jcoding._PREV_B, jcoding._BM0,
                                  jcoding._BM1)):
        assert np.array_equal(mine, ref) and mine.dtype == ref.dtype


@pytest.mark.parametrize("bucket", [8, 128, 1024])
def test_plain_acs_picks_equal_the_jax_scan_one_frame(bucket):
    rng = np.random.default_rng(bucket)
    lams = _noisy_lams(rng, 1, bucket)
    want = np.asarray(_jax_run(bucket)(lams[0]))                 # [bucket, 64]
    got = V.acs_plain(torch.from_numpy(lams), *_tables_t())      # [bucket, 1, 64]
    assert got.dtype == torch.uint8 and tuple(got.shape) == (bucket, 1, 64)
    assert np.array_equal(got[:, 0].numpy(), want)


@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("bucket", [8, 64, 1024])
def test_plain_acs_picks_equal_the_jax_scan_batch(batch, bucket):
    rng = np.random.default_rng(100 * batch + bucket)
    lams = _noisy_lams(rng, batch, bucket, sigma=1.2)
    lams[-1] = rng.uniform(-3, 3, (bucket, 2)).astype(np.float32)   # not a codeword
    want = np.asarray(_jax_run(bucket, batch)(lams))            # [bucket, B, 64]
    got = V.acs(torch.from_numpy(lams), *_tables_t())
    assert tuple(got.shape) == (bucket, batch, 64)
    assert np.array_equal(got.numpy(), want)


def test_ties_go_to_candidate_zero():
    """All-zero LLRs leave every pair of candidates equal (0 or −1e18 each):
    every pick is candidate 0, as ``jnp.argmax`` keeps the first maximum; a
    ``>=`` compare would pick candidate 1 on every tie."""
    lams = np.zeros((2, 16, 2), np.float32)
    got = V.acs_plain(torch.from_numpy(lams), *_tables_t()).numpy()
    want = np.asarray(_jax_run(16, 2)(lams))
    assert np.array_equal(got, want)
    assert not got.any()
    bits = V.scan_viterbi(np.zeros(32), 16, *TABLES, device="cpu")
    assert np.array_equal(bits, JV.scan_viterbi(np.zeros(32, np.float32), 16, *TABLES))
    assert not bits.any()


@pytest.mark.parametrize("n", [5, 24, 513, 1000])
def test_scan_viterbi_equals_the_reference(n):
    rng = np.random.default_rng(n)
    lams = _noisy_lams(rng, 1, n, sigma=0.9)[0].reshape(-1)
    got = V.scan_viterbi(lams, n, *TABLES, device="cpu")
    want = JV.scan_viterbi(lams, n, *TABLES)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_scan_viterbi_batch_equals_the_reference():
    """Ragged frames (5 of them, padded to a batch of 8 and a 1024-step
    bucket): the decoded bits equal the JAX batch decoder's and each frame's
    one-frame decode."""
    rng = np.random.default_rng(7)
    lens = [600, 24, 1000, 311, 97]
    llrs = [_noisy_lams(rng, 1, n, sigma=0.9)[0].reshape(-1) for n in lens]
    stats = {}
    got = V.scan_viterbi_batch(llrs, lens, *TABLES, device="cpu", stats=stats)
    want = JV.scan_viterbi_batch(llrs, lens, *TABLES)
    assert len(got) == len(want) == 5
    for g, w, l, n in zip(got, want, llrs, lens):
        assert np.array_equal(g, w)
        assert np.array_equal(g, V.scan_viterbi(l, n, *TABLES, device="cpu"))
    # the real frames go (the reference pads to 8), their decoded bits come back
    assert stats["frames"] == 5 and stats["bucket"] == 1024
    assert stats["d2h_bytes"] == 1024 * 5
    assert V.bucket_steps(1000) == 1024


def test_cpu_tensor_never_launches_the_kernel():
    V.reset_launches()
    rng = np.random.default_rng(3)
    V.acs(torch.from_numpy(_noisy_lams(rng, 2, 32)), *_tables_t())
    V.scan_viterbi(rng.standard_normal(64), 32, *TABLES, device="cpu")
    V.scan_viterbi_batch([rng.standard_normal(64)] * 3, [32] * 3, *TABLES, device="cpu")
    lams = torch.from_numpy(_noisy_lams(rng, 2, 32))
    steps = torch.tensor([32, 5], dtype=torch.int32)
    ps, b0, b1 = _tables_t()
    V.survivors(lams, steps, ps, b0, b1)
    V.decode(lams, steps, ps, torch.from_numpy(TABLES[1].astype(np.int32)), b0, b1)
    assert V.launches == {"viterbi": 0}


def test_non_cuda_device_raises_instead_of_falling_back():
    lams = torch.empty(2, 16, 2, device="meta")
    ps, b0, b1 = (t.to("meta") for t in _tables_t())
    before = dict(V.launches)
    with pytest.raises(ValueError, match="CUDA"):
        V.acs(lams, ps, b0, b1)
    assert V.launches == before


def test_bad_arguments_raise():
    ps, b0, b1 = _tables_t()
    with pytest.raises(TypeError, match="lams"):
        V.acs(torch.zeros(2, 16, 3), ps, b0, b1)
    with pytest.raises(TypeError, match="bm0"):
        V.acs(torch.zeros(2, 16, 2), ps, b0.double(), b1)
    bad = TABLES[0].copy()
    bad[0, 0] = 64
    with pytest.raises(ValueError, match="outside"):
        V.scan_viterbi(np.zeros(16), 8, bad, *TABLES[1:], device="cpu")


def test_default_device_is_the_card(monkeypatch):
    """``device=None`` asks the broker for the card, which raises without one:
    no silent CPU."""
    import importlib
    inst = importlib.import_module("futuresdr_tpu_torch.tpu.instance")
    monkeypatch.setattr(inst, "_instance", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        V.scan_viterbi(np.zeros(16), 8, *TABLES)


# ---------------------------------------------------------------------------
# M17's 16-state trellis, ragged batches, the plain survivors and traceback
# ---------------------------------------------------------------------------

def _m17_llrs(rng, steps: int, sigma: float = 0.9) -> np.ndarray:
    """Soft bits (2 a step) of a random terminated M17 codeword."""
    bits = rng.integers(0, 2, steps).astype(np.uint8)
    bits[-4:] = 0
    coded = jm17.conv_encode_m17(bits).astype(np.float64) * 2 - 1
    return (coded + sigma * rng.standard_normal(2 * steps)).astype(np.float32)


def _host_traceback(picks: np.ndarray, steps, prev_s, prev_b) -> np.ndarray:
    """The reference's vectorized host traceback
    (``futuresdr_tpu/ops/viterbi.py`` ``scan_viterbi_batch``), ``[T, B]``."""
    T, B, _ = picks.shape
    steps_arr = np.asarray(steps)
    states = np.zeros(B, dtype=np.int64)
    bits_all = np.zeros((T, B), dtype=np.uint8)
    rows = np.arange(B)
    for tt in range(T - 1, -1, -1):
        active = tt < steps_arr
        b = picks[tt, rows, states]
        bits_all[tt, active] = prev_b[states, b][active]
        states = np.where(active, prev_s[states, b], states)
    return bits_all


def test_m17_tables_equal_the_reference():
    for mine, ref in zip(M17, jm17._M17_PREV):
        assert np.array_equal(mine, ref) and mine.dtype == ref.dtype
    # the shift-register butterfly the kernel's fast route takes
    t = np.arange(16)
    assert np.array_equal(M17[0], np.stack([2 * (t % 8), 2 * (t % 8) + 1], 1))
    assert np.array_equal(M17[1], np.stack([t >= 8, t >= 8], 1))


@pytest.mark.parametrize("n", [512, 1024])
def test_m17_decoders_equal_the_jax_decoders(n):
    """M17's frames of 512 steps and more, which ``viterbi_decode_m17`` sends
    to ``scan_viterbi``: one frame and a batch of three, bit for bit."""
    rng = np.random.default_rng(17 + n)
    llrs = [_m17_llrs(rng, n), _m17_llrs(rng, n - 3), _m17_llrs(rng, n // 2 + 1)]
    lens = [n, n - 3, n // 2 + 1]
    got = V.scan_viterbi(llrs[0], n, *M17, device="cpu")
    assert got.dtype == np.uint8 and np.array_equal(got, JV.scan_viterbi(llrs[0], n, *M17))
    got = V.scan_viterbi_batch(llrs, lens, *M17, device="cpu")
    want = JV.scan_viterbi_batch(llrs, lens, *M17)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("trellis", ["wlan", "m17"])
def test_ragged_batches_equal_the_jax_batch_decoder(trellis):
    """Six frames of different lengths (a batch that is not a power of two,
    one frame of 2 steps, one filling the 512-step bucket): the decoded bits
    equal the JAX batch decoder's."""
    rng = np.random.default_rng(61 if trellis == "wlan" else 62)
    tables = TABLES if trellis == "wlan" else M17
    lens = [300, 7, 129, 64, 512, 2]
    if trellis == "wlan":
        llrs = [_noisy_lams(rng, 1, n, sigma=1.0)[0].reshape(-1) for n in lens]
    else:
        llrs = [_m17_llrs(rng, n, sigma=1.0) for n in lens]
    stats = {}
    got = V.scan_viterbi_batch(llrs, lens, *tables, device="cpu", stats=stats)
    want = JV.scan_viterbi_batch(llrs, lens, *tables)
    assert [len(g) for g in got] == lens
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert stats["frames"] == 6 and stats["d2h_bytes"] == 6 * 512


@pytest.mark.parametrize("trellis", ["wlan", "m17"])
def test_traceback_plain_equals_the_host_loop(trellis):
    """Random picks (any survivor pattern, not only a decoder's) and ragged
    lengths: ``traceback_plain`` over the packed survivors gives the
    reference's host loop's bits, 0 past each frame's length."""
    prev_s, prev_b, _, _ = TABLES if trellis == "wlan" else M17
    rng = np.random.default_rng(5)
    T, B, S = 96, 7, prev_s.shape[0]
    picks = rng.integers(0, 2, (T, B, S)).astype(np.uint8)
    steps = [96, 0, 1, 33, 95, 64, 17]
    want = _host_traceback(picks, steps, prev_s, prev_b)       # [T, B]
    words = V.pack_survivors(torch.from_numpy(picks))
    got = V.traceback_plain(words, torch.tensor(steps), torch.from_numpy(prev_s),
                            torch.from_numpy(prev_b))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (B, T)
    assert np.array_equal(got.numpy(), want.T)


@pytest.mark.parametrize("n_states", [2, 5, 16, 32, 33, 64])
def test_pack_then_unpack_returns_the_picks(n_states):
    rng = np.random.default_rng(n_states)
    picks = torch.from_numpy(rng.integers(0, 2, (9, 3, n_states)).astype(np.uint8))
    words = V.pack_survivors(picks)
    assert words.dtype == torch.int32
    assert tuple(words.shape) == (3, 9, 2 if n_states > 32 else 1)
    assert torch.equal(V.unpack_survivors(words, n_states), picks)
    # word w holds states 32w .. 32w + 31, bit s % 32 for state s
    s = n_states - 1
    one = torch.zeros_like(picks)
    one[4, 1, s] = 1
    w = V.pack_survivors(one)[1, 4].tolist()
    assert w[s // 32] & 0xFFFFFFFF == 1 << (s % 32) and sum(w) == w[s // 32]


def test_survivors_and_decode_follow_the_plain_versions_on_cpu():
    """On CPU tensors the kernel's entry points are their plain versions:
    the survivors are the packed picks up to each frame's length (0 past
    it), the decode their traceback."""
    rng = np.random.default_rng(12)
    lams = torch.from_numpy(_noisy_lams(rng, 3, 40))
    steps = torch.tensor([40, 13, 0], dtype=torch.int32)
    ps, b0, b1 = _tables_t()
    pb = torch.from_numpy(TABLES[1].astype(np.int32))
    words = V.survivors(lams, steps, ps, b0, b1)
    picks = V.acs_plain(lams, ps, b0, b1)
    live = (torch.arange(40)[:, None] < steps[None, :])[..., None]
    assert torch.equal(V.unpack_survivors(words, 64), picks * live)
    bits = V.decode(lams, steps, ps, pb, b0, b1)
    assert torch.equal(bits, V.traceback_plain(words, steps, ps, pb))
    assert not bits[2].any() and not bits[1, 13:].any()


@pytest.mark.parametrize("n_states", [1, 65, 128])
def test_trellises_outside_2_to_64_states_raise(n_states):
    prev = np.zeros((n_states, 2), np.int64)
    w = np.ones((n_states, 2))
    with pytest.raises(ValueError, match="2 to 64 states"):
        V.scan_viterbi(np.zeros(16), 8, prev, prev, w, w, device="cpu")
    lams = torch.zeros(1, 8, 2)
    ps = torch.from_numpy(prev.astype(np.int32))
    wt = torch.from_numpy(w.astype(np.float32))
    with pytest.raises(ValueError, match="2 to 64 states"):
        V.acs(lams, ps, wt, wt)
    with pytest.raises(ValueError, match="2 to 64 states"):
        V.decode(lams, torch.tensor([8]), ps, ps, wt, wt)


# ---------------------------------------------------------------------------
# csrc/viterbi.cu's warp layout, walked on the CPU
# ---------------------------------------------------------------------------

def _kernel_twin(lams, steps, prev_s, prev_b, bm0, bm1):
    """``csrc/viterbi.cu`` repeated warp by warp in numpy: a frame's ``half``
    lanes (states j and j + half), the route the kernel picks from the
    tables, the two shuffles (butterfly) or eight (generic) of width
    ``half``, the ballots kept by lane i for step i of a 32-step chunk, the
    word stores, the traceback over words held k·half + j steps below the
    chunk's top, and the zero tail. Returns ``(survivor words, bits, butterfly)``;
    survivors the kernel does not write read 0, bits 0xAB."""
    f32 = np.float32
    B, T, _ = lams.shape
    S = prev_s.shape[0]
    half = 1
    while 2 * half < S:
        half *= 2
    G, W = 32 // half, 2 if half == 32 else 1
    lane = np.arange(32)
    seg, j = lane // half, lane % half
    surv = np.zeros((B, T, W), np.uint32)
    bits = np.full((B, T), 0xAB, np.uint8)
    tb = np.zeros(64, np.int64)
    tb[:S] = ((prev_s[:, 0] & 63) | (prev_s[:, 1] & 63) << 8 | (prev_b[:, 0] & 1) << 16
              | (prev_b[:, 1] & 1) << 24)
    s_all = np.arange(S)
    fly = S == 2 * half and np.array_equal(
        prev_s, np.stack([2 * (s_all & (half - 1)), 2 * (s_all & (half - 1)) + 1], 1))
    fly_b = fly and np.array_equal(prev_b, np.stack([s_all >= half] * 2, 1))

    def shfl(v, src):
        return v[seg * half + (np.asarray(src) & (half - 1))]

    def ballot(p):
        return int(np.sum(p.astype(np.int64) << lane))

    def cand(m, w0, l0, w1, l1):
        return f32(f32(m + f32(w0 * l0)) + f32(w1 * l1))

    for b0 in range(0, B, G):
        b_of = b0 + np.arange(G)
        n_of = np.array([min(max(int(steps[b]), 0), T) if b < B else 0 for b in b_of])
        n, n_warp = n_of[seg], int(n_of.max())
        if fly:
            upper = (half > 1) & (j >= half // 2)
            odd = (j & 1).astype(bool)
            src1 = np.where(upper, 2 * j + 1 - half, 2 * j)
            src2 = np.where(upper, 2 * j - half, 2 * j + 1)
            nst = [np.where(odd, j + half, j), np.where(odd, j, j + half)]
            ka = upper.astype(int)
            a0 = [bm0[no, ka].astype(f32) for no in nst]
            a1 = [bm1[no, ka].astype(f32) for no in nst]
            c0 = [bm0[no, 1 - ka].astype(f32) for no in nst]
            c1 = [bm1[no, 1 - ka].astype(f32) for no in nst]
            x = np.where(j == 0, f32(0), f32(-1e18)).astype(f32)
            y = np.full(32, -1e18, f32)
        else:
            src, hi, w0, w1 = {}, {}, {}, {}
            for o in range(2):
                no = j + o * half
                real = no < S
                for k in range(2):
                    p = np.where(real, prev_s[np.minimum(no, S - 1), k], no)
                    src[o, k], hi[o, k] = p & (half - 1), p >= half
                    w0[o, k] = np.where(real, bm0[np.minimum(no, S - 1), k], 0).astype(f32)
                    w1[o, k] = np.where(real, bm1[np.minimum(no, S - 1), k], 0).astype(f32)
            m = [np.where(j == 0, f32(0), f32(-1e18)).astype(f32), np.full(32, -1e18, f32)]
        for t0 in range(0, n_warp, 32):
            r_lo = np.zeros(32, np.int64)
            r_hi = np.zeros(32, np.int64)
            for i in range(32):
                t = t0 + i
                live = t < n
                l = np.where(live[:, None], lams[np.minimum(b_of[seg], B - 1),
                                                 min(t, T - 1)], 0).astype(f32)
                l0, l1 = l[:, 0], l[:, 1]
                if fly:
                    ra, rb = shfl(x, src1), shfl(y, src2)
                    ca = [cand(ra, a0[o], l0, a1[o], l1) for o in range(2)]
                    cb = [cand(rb, c0[o], l0, c1[o], l1) for o in range(2)]
                    p = [np.where(upper, ca[o] > cb[o], cb[o] > ca[o]) for o in range(2)]
                    x, y = np.maximum(ca[0], cb[0]), np.maximum(ca[1], cb[1])
                    p_lo, p_hi = np.where(odd, p[1], p[0]), np.where(odd, p[0], p[1])
                else:
                    c = {(o, k): cand(np.where(hi[o, k], shfl(m[1], src[o, k]),
                                               shfl(m[0], src[o, k])),
                                      w0[o, k], l0, w1[o, k], l1)
                         for o in range(2) for k in range(2)}
                    p_lo, p_hi = c[0, 1] > c[0, 0], c[1, 1] > c[1, 0]
                    m = [np.where(p_lo, c[0, 1], c[0, 0]), np.where(p_hi, c[1, 1], c[1, 0])]
                r_lo[i], r_hi[i] = ballot(p_lo), ballot(p_hi)
            for g in range(G):
                for i in range(32):
                    t = t0 + i
                    if t < n_of[g]:
                        if half == 32:
                            surv[b_of[g], t] = (r_lo[i], r_hi[i])
                        else:
                            mask = (1 << half) - 1
                            surv[b_of[g], t, 0] = (((r_lo[i] >> (g * half)) & mask)
                                                   | (((r_hi[i] >> (g * half)) & mask) << half))
        # the traceback: lane j holds the words of steps t_hi - (k * half + j)
        b = np.where(b_of[seg] < B, b_of[seg], 0)
        n = np.where(b_of[seg] < B, n, 0)
        R = 32 // half

        def load(c):
            lo, up = np.zeros((R, 32), np.int64), np.zeros((R, 32), np.int64)
            for k in range(R):
                t = n - 1 - 32 * c - (k * half + j)
                ok = t >= 0
                wds = surv[b, np.maximum(t, 0)].astype(np.int64)
                lo[k] = np.where(ok, wds[:, 0], 0)
                up[k] = np.where(ok, wds[:, -1], 0) if W == 2 else 0
            return lo, up

        s = np.zeros(32, np.int64)
        for c in range((n_warp + 31) // 32):
            cur_lo, cur_hi = load(c)
            acc = np.zeros(32, np.int64)
            for i in range(32):
                w_lo = shfl(cur_lo[i // half], np.full(32, i % half))
                if W == 2:
                    w_hi = shfl(cur_hi[i // half], np.full(32, i % half))
                    p = (np.where(s & 32, w_hi, w_lo) >> (s & 31)) & 1
                else:
                    p = (w_lo >> s) & 1
                if fly_b:
                    acc |= (s >> int(np.log2(half))) << i
                    s = ((s << 1) & (2 * half - 1)) | p
                else:
                    v = tb[s]
                    acc |= ((v >> (16 + 8 * p)) & 1) << i
                    s = (v >> (8 * p)) & 63
            for k in range(R):
                i = k * half + j
                t = n - 1 - 32 * c - i
                ok = t >= 0
                bits[b[ok], t[ok]] = (acc[ok] >> i[ok]) & 1
        for ln in range(32):
            if b_of[seg[ln]] < B:
                bits[b[ln], n[ln] + j[ln]::half] = 0
    return surv.view(np.int32), bits, fly


@pytest.mark.parametrize("trellis", ["wlan", "m17", "relabelled", "random5", "random12",
                                     "random40", "random2"])
def test_kernel_twin_equals_the_plain_versions(trellis):
    """The kernel's layout on ragged frames (more frames than a warp holds
    at 16 states and below, one of 0 steps, one past a chunk): its survivors
    equal the plain packed picks for t < steps[b], its bits the plain
    traceback's, and it takes the butterfly route on 802.11's and M17's
    tables, the generic one elsewhere."""
    rng = np.random.default_rng(len(trellis))
    if trellis in ("wlan", "m17"):
        tables = TABLES if trellis == "wlan" else M17
    elif trellis == "relabelled":
        sigma = np.concatenate([[0], 1 + rng.permutation(63)])
        tables = [np.empty_like(t) for t in TABLES]
        tables[0][sigma] = sigma[TABLES[0]]
        for o, t in zip(tables[1:], TABLES[1:]):
            o[sigma] = t
    else:
        S = int(trellis[6:])
        tables = (rng.integers(0, S, (S, 2)), rng.integers(0, 2, (S, 2)),
                  rng.choice([-1.0, 1.0], (S, 2)), rng.choice([-1.0, 1.0], (S, 2)))
    prev_s, prev_b, bm0, bm1 = tables
    B, T = 6, 70
    lams = (rng.standard_normal((B, T, 2)) * 2).astype(np.float32)
    steps = np.array([70, 0, 33, 1, 64, 45], np.int32)
    words, bits, fly = _kernel_twin(lams, steps, prev_s, prev_b, bm0, bm1)
    assert fly == (trellis in ("wlan", "m17"))
    ps, pb = torch.from_numpy(prev_s.astype(np.int32)), torch.from_numpy(prev_b.astype(np.int32))
    b0, b1 = (torch.from_numpy(t.astype(np.float32)) for t in (bm0, bm1))
    st = torch.from_numpy(steps)
    want_w = V.survivors(torch.from_numpy(lams), st, ps, b0, b1)
    assert np.array_equal(words, want_w.numpy())
    assert np.array_equal(bits, V.traceback_plain(want_w, st, ps, pb).numpy())
