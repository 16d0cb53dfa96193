"""The lane form of ``pfb``, and the PFB channelizer served to many sessions,
against the JAX package on the CPU.

The JAX package serves a batch of sessions through ``jax.vmap`` of its
session program (``futuresdr_tpu/serve/engine.py``), so a served channelizer
reaches its Pallas kernel as ``jax.vmap`` of ``pallas_pfb``; the port runs the
same batch as one launch of its lane kernel (``pfb_lanes`` in
``futuresdr_tpu_torch/ops/cuda_kernels.py``). On the CPU the port's lane
wrapper runs its plain version; the JAX side is ``jax.vmap`` of the Pallas
kernel in interpret mode, as ``tests/test_pallas.py`` runs it, under one
``jax.jit`` a shape. Inputs come from numpy with a seed. The CUDA kernel is
held against this plain version, and bit for bit against one-stream
launches, on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase
28).

Tolerances, as ``tests/test_pallas.py`` and ``tests/test_torch_pfb.py`` state
them for this kernel:

* ``pfb`` in f32: rtol 2e-3, atol 2e-3;
* ``pfb`` in bf16: >= 100 dB against the JAX kernel's bf16 (both round the
  rows, taps and ``v`` to bf16 and accumulate the exact products in f32; the
  sums differ in order only), on taps scaled by 0.25;
* the served channelizer against the JAX ``Pipeline``: rtol 2e-3, atol 2e-3
  (the stage's tolerance in ``tests/test_torch_pfb.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from futuresdr_tpu.ops import stages as J
from futuresdr_tpu.ops.pallas_kernels import pallas_pfb
from futuresdr_tpu_torch.blocks import pfb_default_taps
from futuresdr_tpu_torch.ops import cuda_kernels as ck
from futuresdr_tpu_torch.ops import stages as T
from futuresdr_tpu_torch.serve import ServeEngine

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

L_MAX = 5
T_ROWS = 16
TOL = 2e-3
BF16_SNR_DB = 100.0


def _c64(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _snr_db(got, ref):
    err = float(np.mean(np.abs(got - ref) ** 2))
    return 10 * np.log10(float(np.mean(np.abs(ref) ** 2)) / max(err, 1e-30))


@functools.lru_cache(maxsize=None)
def _vmapped_pallas_pfb(precision, shared: bool):
    """The JAX serving plane's batch of ``pallas_pfb``: ``jax.vmap`` over the
    lanes' commutated rows and, unless ``shared``, their taps."""
    def one(rows, taps):
        return pallas_pfb(rows, taps, precision=precision)
    return jax.jit(jax.vmap(one, in_axes=(0, None if shared else 0)))


@functools.lru_cache(maxsize=None)
def _case(N: int, K: int, shared: bool, taps_scale: float = 1.0):
    """``L_MAX`` lanes of commutated rows ``[t + K−1, N]`` and taps ``[K, N]``
    (one set for every lane where ``shared``)."""
    rng = np.random.default_rng(1000 * N + 10 * K + shared)
    rows = _c64(rng, L_MAX, T_ROWS + K - 1, N)
    taps = (rng.standard_normal((1 if shared else L_MAX, K, N)) * taps_scale).astype(np.float32)
    return rows, taps


def _flat(rows, K, N):
    """``(hist [L, (K−1)·N], x [L, t·N])`` of the flat streams whose
    commutated rows are ``rows``: ``rows[s, c] = ext[s·N + N−1−c]``."""
    ext = np.ascontiguousarray(rows[:, :, ::-1]).reshape(rows.shape[0], -1)
    return (torch.from_numpy(ext[:, :(K - 1) * N].copy()),
            torch.from_numpy(ext[:, (K - 1) * N:].copy()))


def _port_taps(taps, L, shared, precision=None):
    """The taps as the stage passes them: its ``[L, N, K]`` carry transposed
    (bf16 under ``precision="bf16"``), one expanded with stride 0 where
    ``shared``."""
    carry = torch.from_numpy(np.ascontiguousarray(taps[:1 if shared else L].transpose(0, 2, 1)))
    if precision == "bf16":
        carry = carry.to(torch.bfloat16)
    if shared:
        carry = carry.expand(L, *carry.shape[1:])
    return carry.transpose(1, 2)


def _pair(N, K, shared, L, precision=None, taps_scale=1.0):
    rows, taps = _case(N, K, shared, taps_scale)
    ref = np.asarray(_vmapped_pallas_pfb(precision, shared)(
        jnp.asarray(rows), jnp.asarray(taps[0] if shared else taps)))[:L]
    hist, x = _flat(rows[:L], K, N)
    got = ck.pfb_lanes(hist, x, _port_taps(taps, L, shared, precision), precision).numpy()
    assert got.shape == ref.shape == (L, T_ROWS, N) and got.dtype == ref.dtype
    return got, ref


@pytest.mark.parametrize("L", [1, 3, L_MAX])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("N,K", [(8, 4), (8, 12), (16, 4), (16, 12)])
def test_pfb_lanes_matches_vmapped_pallas_pfb(N, K, shared, L):
    """``pfb_lanes`` over L lanes against ``jax.vmap`` of ``pallas_pfb``
    (interpret mode), each lane its own rows, with each lane's taps or one set
    shared (stride 0 on the port's side, unbatched on the JAX side)."""
    got, ref = _pair(N, K, shared, L)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("L", [1, 3, L_MAX])
@pytest.mark.parametrize("N,K,shared", [(16, 4, False), (8, 12, True)])
def test_pfb_lanes_bf16_matches_vmapped_pallas_pfb_bf16(N, K, shared, L):
    """bf16 mode with the stage's bf16 taps against the JAX kernel's bf16 at
    the bar of ``tests/test_torch_pfb.py``."""
    got, ref = _pair(N, K, shared, L, "bf16", taps_scale=0.25)
    assert _snr_db(got, ref) >= BF16_SNR_DB


@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("N,K,shared", [(8, 12, False), (16, 4, True), (24, 3, False)])
def test_pfb_lanes_plain_equals_one_stream_calls(N, K, shared, precision):
    """Each lane of the lane plain version equals the one-stream plain call
    on its row bit for bit (the kernels' contract, which the card checks on
    launches); N = 24 is the direct DFT's."""
    rng = np.random.default_rng(N + K)
    rows = _c64(rng, L_MAX, T_ROWS + K - 1, N)
    taps = rng.standard_normal((L_MAX, K, N)).astype(np.float32)
    hist, x = _flat(rows, K, N)
    tp = _port_taps(taps, L_MAX, shared, precision)
    got = ck.pfb_lanes_plain(hist, x, tp, precision)
    assert got.shape == (L_MAX, T_ROWS, N) and got.dtype == torch.complex64
    for i in range(L_MAX):
        assert torch.equal(got[i], ck.pfb_plain(hist[i], x[i], tp[i], precision)), i
    empty = ck.pfb_lanes_plain(hist[:0], x[:0], tp[:0], precision)
    assert empty.shape == (0, T_ROWS, N)


def test_pfb_lanes_refuse_bad_shapes():
    x = torch.zeros(2, 64, dtype=torch.complex64)
    hist = torch.zeros(2, 24, dtype=torch.complex64)
    taps = torch.ones(2, 4, 8)
    with pytest.raises(TypeError, match="x must be"):
        ck.pfb_lanes(hist, torch.zeros(2, 64), taps)
    with pytest.raises(TypeError, match="x must be"):
        ck.pfb_lanes(hist, x[0], taps)
    with pytest.raises(TypeError, match="taps must be"):
        ck.pfb_lanes(hist, x, torch.ones(3, 4, 8))
    with pytest.raises(TypeError, match="taps must be"):
        ck.pfb_lanes(hist, x, torch.ones(2, 4, 8, dtype=torch.complex64))
    with pytest.raises(TypeError, match="taps must be"):
        ck.pfb_lanes(hist, x, torch.ones(4, 8))
    with pytest.raises(ValueError, match="multiple of N"):
        ck.pfb_lanes(hist, torch.zeros(2, 60, dtype=torch.complex64), taps)
    with pytest.raises(ValueError, match="hist"):
        ck.pfb_lanes(torch.zeros(2, 16, dtype=torch.complex64), x, taps)
    with pytest.raises(ValueError, match="hist"):
        ck.pfb_lanes(torch.zeros(3, 24, dtype=torch.complex64), x, taps)
    with pytest.raises(ValueError, match="precision"):
        ck.pfb_lanes(hist, x, taps, precision="int8")


# ---------------------------------------------------------------------------
# the lane plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", [1, 3, 16, 64])
@pytest.mark.parametrize("N,t", [(64, 512), (64, 4096), (2048, 128), (16384, 5), (1000, 7)])
def test_pfb_lanes_plan_keeps_the_one_stream_radices_and_layout(N, t, L):
    """PFB-64 at the served rows (2^15 and 2^18 a session), PFB-2048, and N =
    16,384, whose rows take the v layout: the lane plan computes a lane's
    bits as the one-stream plan does (its layout and radices), picks R and
    the tile over the batch, and fits the card; one lane is the one-stream
    plan."""
    row = ck.pfb_plan(N, 12, t)
    plan = ck.pfb_lanes_plan(L, N, 12, t)
    assert (plan.window, plan.radices) == (row.window, row.radices)
    assert (plan.threads, plan.chunk, plan.groups) == (row.threads, row.chunk, row.groups)
    assert plan.smem <= ck._MAX_SMEM
    if N == 16384:
        assert not row.window and plan == row
    if L == 1:
        assert plan == row
    cands = ck.plan_candidates("pfb_lanes", L, N, 12, t, 132)
    assert cands[0] == plan
    assert all(ck._pfb_same_values(p, row) and p.smem <= ck._MAX_SMEM for p in cands)


@pytest.mark.parametrize("L,t,outs", [(16, 4096, 8), (64, 512, 8), (3, 512, 1), (8, 512, 4)])
def test_pfb_lanes_plan_at_the_served_shapes(L, t, outs):
    """PFB-64 served: one stream's 512 rows take R = 1 (4 rows a block, 128
    blocks) so that one stream fills the card; the batch takes the largest R
    that still gives the card a block an SM (64 sessions: R = 8, 1,024
    blocks)."""
    plan = ck.pfb_lanes_plan(L, 64, 12, t)
    assert plan.window and plan.outs == outs and plan.rows == plan.groups * outs
    assert L * -(-t // plan.rows) >= 132 or outs == 1


def test_pfb_lanes_plan_keeps_the_bare_chains_values():
    """A tuned lane plan is taken where it keeps the one-stream plan's
    layout and radices; a tuned one-stream plan of the v layout (which the
    bare chain then launches) moves the lane plan to the v layout with it."""
    shape = (64, 64, 12, 512, 132)
    cands = ck.plan_candidates("pfb_lanes", *shape)
    pick = cands[-1]
    try:
        ck.set_tuned_plans({"pfb_lanes": {shape: pick}})
        assert ck.pfb_lanes_plan(*shape) == pick
        v = ck.plan_candidates("pfb", 64, 12, 512, 132)[-1]
        assert not v.window
        ck.set_tuned_plans({"pfb_lanes": {shape: pick}, "pfb": {(64, 12, 512, 132): v}})
        assert ck.pfb_lanes_plan(*shape) == v
    finally:
        ck.set_tuned_plans(None)


# ---------------------------------------------------------------------------
# the PFB channelizer served to many sessions
# ---------------------------------------------------------------------------

N_CH = 8
FRAME = 32 * N_CH
N_FRAMES = 5
# session 2 joins before frame 2, session 1 leaves after frame 2; session 0
# runs its own prototype
JOIN, LEAVE = {2: 2}, {1: 3}
OWN_TAPS = {0: pfb_default_taps(N_CH, atten_db=50.0)}


def _chain(m, taps=None):
    return [m.channelizer_stage(N_CH, pfb_default_taps(N_CH) if taps is None else taps,
                                impl="pallas")]


def _span(i):
    return range(JOIN.get(i, 0), LEAVE.get(i, N_FRAMES))


def test_pfb_channelizer_served_to_many_sessions():
    """Three sessions of the PFB channelizer in a bucket of four, each with its
    own feed, one on its own prototype (a lane retune at admission); one joins
    mid-stream and one leaves. The batch reaches the lane form once a
    dispatch; each session's channels equal its bare ``Pipeline`` bit for
    bit, and the JAX package's channelizer ``Pipeline`` run per session at
    the stage's tolerance."""
    rng = np.random.default_rng(24)
    feeds = [[_c64(rng, FRAME) for _ in range(N_FRAMES)] for _ in range(3)]
    eng = ServeEngine(T.Pipeline(_chain(T), np.complex64), frame_size=FRAME,
                      app="pfb_lanes", buckets=(4,), queue_frames=8, device="cpu")
    seen = []
    lane_plain = ck.pfb_lanes_plain

    def watch(*a, **k):
        seen.append(tuple(a[1].shape))
        return lane_plain(*a, **k)

    live, out = {}, {i: [] for i in range(3)}
    ck.pfb_lanes_plain = watch
    try:
        for j in range(N_FRAMES):
            for i in range(3):
                if j == JOIN.get(i, 0):
                    live[i] = eng.admit(tenant=f"t{i}")
                    if i in OWN_TAPS:
                        eng.retune(live[i].sid, "channelizer", taps=OWN_TAPS[i])
                if j == LEAVE.get(i):
                    out[i] += eng.results(live[i].sid)
                    eng.close(live.pop(i).sid)
            for i, s in live.items():
                assert eng.submit(s.sid, feeds[i][j])
            assert eng.step() == len(live)
            for i, s in live.items():
                out[i] += eng.results(s.sid)
    finally:
        ck.pfb_lanes_plain = lane_plain
    assert eng.compiles == 1 and eng.dispatches == N_FRAMES
    assert seen == [(4, FRAME)] * N_FRAMES

    # the JAX channelizer has no update hook: a session on its own prototype
    # is held against a JAX Pipeline built with it
    jax_chains = {}
    for i in range(3):
        span = _span(i)
        assert len(out[i]) == len(span)
        bare = T.Pipeline(_chain(T, OWN_TAPS.get(i)), np.complex64)
        fn, carry = bare.compile(FRAME, "cpu", donate=False)
        key = i if i in OWN_TAPS else None
        if key not in jax_chains:
            jp = J.Pipeline(_chain(J, OWN_TAPS.get(i)), np.complex64)
            jax_chains[key] = (jp, jax.jit(jp.fn()))
        jp, jfn = jax_chains[key]
        jcarry = jp.init_carry()
        for got, j in zip(out[i], span):
            carry, want = fn(carry, torch.from_numpy(feeds[i][j]))
            assert got.dtype == np.complex64 and got.shape == (FRAME,)
            assert np.array_equal(got, want.numpy()), (i, j)
            jcarry, jy = jfn(jcarry, jnp.asarray(feeds[i][j]))
            jcarry = jax.tree_util.tree_map(np.asarray, jcarry)
            np.testing.assert_allclose(got, np.asarray(jy), rtol=TOL, atol=TOL)
