"""The port's Viterbi ACS (``futuresdr_tpu_torch/ops/viterbi.py``) against the
JAX package's ``lax.scan`` decoder (``futuresdr_tpu/ops/viterbi.py``) on the CPU.

The plain ACS (the kernel's plain version, which a CPU tensor takes) must give
the JAX scan's picks bit for bit: both sum ``m + bm0·λ0 + bm1·λ1`` left to
right in float32 with ±1 branch weights (the products are exact) and keep
candidate 0 on a tie. Inputs are made by numpy from a seed.
"""

import numpy as np
import pytest
import torch

import futuresdr_tpu.ops.viterbi as JV
from futuresdr_tpu.models.wlan import coding as jcoding
from futuresdr_tpu_torch.models.wlan import coding
from futuresdr_tpu_torch.ops import viterbi as V

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

TABLES = (coding._PREV_S, coding._PREV_B, coding._BM0, coding._BM1)


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
    assert stats["picks_bytes"] == 1024 * 8 * 64
    assert V.bucket_steps(1000) == 1024 and V.batch_size(5) == 8


def test_cpu_tensor_never_launches_the_kernel():
    V.reset_launches()
    rng = np.random.default_rng(3)
    V.acs(torch.from_numpy(_noisy_lams(rng, 2, 32)), *_tables_t())
    V.scan_viterbi(rng.standard_normal(64), 32, *TABLES, device="cpu")
    V.scan_viterbi_batch([rng.standard_normal(64)] * 3, [32] * 3, *TABLES, device="cpu")
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
