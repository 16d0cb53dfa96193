"""Viterbi decoding on the device: the batched decoder of the WLAN receiver and M17.

The counterpart of ``futuresdr_tpu/ops/viterbi.py``, whose ACS recursion is a
jitted ``lax.scan`` and whose traceback runs on the host. Here both run in one
hand kernel, ``csrc/viterbi.cu``: any trellis of 2 to 64 states, the
survivors packed one bit a state, the traceback on the card, each frame run
to its own length. :func:`decode` takes soft bits and frame lengths and
returns the decoded bits; :func:`survivors` returns the packed survivors
alone; each launch is counted in :data:`launches`. Beside the kernel sit its
plain PyTorch versions: :func:`acs_plain` (the recursion step by step, the
same float32 arithmetic), :func:`pack_survivors` / :func:`unpack_survivors`
(the kernel's survivor words) and :func:`traceback_plain` (the reference's
host loop). As with the kernels of ``ops/cuda_kernels.py``, a CPU tensor takes
the plain versions; a CUDA tensor launches the kernel or raises. :func:`acs`
keeps the picks' contract (``uint8 [T, B, S]``) for bit-for-bit checks.

:func:`scan_viterbi` and :func:`scan_viterbi_batch` keep the reference's step
buckets (a power of two ≥ 8 steps), its float32 metrics (−1e18, state 0 at 0)
and its traceback from state 0 at each frame's last step. They send the real
frames only (the reference pads the batch to a power of two), and only the
decoded bits come back. They run on the ``device`` given (None: the card,
through ``tpu/instance.py``'s broker, which raises without one).
"""

from __future__ import annotations

import ctypes
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..tpu.instance import resolve_device

__all__ = ["acs", "acs_plain", "survivors", "decode", "pack_survivors", "unpack_survivors",
           "traceback_plain", "scan_viterbi", "scan_viterbi_batch", "launches",
           "reset_launches", "bucket_steps", "MAX_STATES"]

#: launches of ``csrc/viterbi.cu`` since the last :func:`reset_launches`
launches: Dict[str, int] = {"viterbi": 0}

#: the largest trellis the kernel takes (two survivor words a step)
MAX_STATES = 64


def reset_launches() -> None:
    launches["viterbi"] = 0


def _n_words(n_states: int) -> int:
    """Survivor words (32 bits) a frame a step."""
    return 2 if n_states > 32 else 1


def _check_states(n_states: int) -> None:
    if not 2 <= n_states <= MAX_STATES:
        raise ValueError(f"the Viterbi decoder takes trellises of 2 to {MAX_STATES} states, "
                         f"got {n_states}")


def _check(lams: torch.Tensor, prev_s: torch.Tensor, bm0: torch.Tensor,
           bm1: torch.Tensor, prev_b: Optional[torch.Tensor] = None,
           steps: Optional[torch.Tensor] = None) -> None:
    ints = (torch.int32, torch.int64)
    if lams.dtype != torch.float32 or lams.dim() != 3 or lams.shape[2] != 2:
        raise TypeError(f"lams must be float32 [B, T, 2], got {lams.dtype} of shape "
                        f"{tuple(lams.shape)}")
    if prev_s.dim() != 2 or prev_s.shape[1] != 2 or prev_s.dtype not in ints:
        raise TypeError(f"prev_s must be an integer [S, 2] table, got {prev_s.dtype} of "
                        f"shape {tuple(prev_s.shape)}")
    s = int(prev_s.shape[0])
    _check_states(s)
    if prev_b is not None and (prev_b.dtype not in ints or tuple(prev_b.shape) != (s, 2)):
        raise TypeError(f"prev_b must be an integer [{s}, 2] table, got {prev_b.dtype} of "
                        f"shape {tuple(prev_b.shape)}")
    for name, t in (("bm0", bm0), ("bm1", bm1)):
        if t.dtype != torch.float32 or tuple(t.shape) != (s, 2):
            raise TypeError(f"{name} must be float32 [{s}, 2], got {t.dtype} of shape "
                            f"{tuple(t.shape)}")
    if steps is not None and (steps.dtype not in ints
                              or tuple(steps.shape) != (lams.shape[0],)):
        raise TypeError(f"steps must be an integer [{lams.shape[0]}] tensor, got "
                        f"{steps.dtype} of shape {tuple(steps.shape)}")
    others = [t for t in (prev_s, prev_b, bm0, bm1, steps) if t is not None]
    if any(t.device != lams.device for t in others):
        raise ValueError("lams, steps and the trellis tables must lie on one device, got "
                         f"{[str(t.device) for t in [lams] + others]}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def acs_plain(lams: torch.Tensor, prev_s: torch.Tensor, bm0: torch.Tensor,
              bm1: torch.Tensor) -> torch.Tensor:
    """The ACS recursion in plain PyTorch ops: ``lams [B, T, 2]`` float32 →
    ``picks [T, B, S]`` uint8, the kernel's (and the JAX scan's) arithmetic
    step by step (ties to candidate 0)."""
    _check(lams, prev_s, bm0, bm1)
    B, T = int(lams.shape[0]), int(lams.shape[1])
    S = int(prev_s.shape[0])
    ps = prev_s.long()
    m = torch.full((B, S), -1e18, dtype=torch.float32, device=lams.device)
    m[:, 0] = 0.0
    picks = torch.empty((T, B, S), dtype=torch.uint8, device=lams.device)
    for t in range(T):
        l0 = lams[:, t, 0, None, None]
        l1 = lams[:, t, 1, None, None]
        cand = m[:, ps] + bm0 * l0 + bm1 * l1                   # [B, S, 2]
        pick = cand[..., 1] > cand[..., 0]
        m = torch.where(pick, cand[..., 1], cand[..., 0])
        picks[t] = pick
    return picks


def pack_survivors(picks: torch.Tensor) -> torch.Tensor:
    """``picks [T, B, S]`` (0/1) → the kernel's survivor words ``int32 [B, T,
    W]`` (W = 2 above 32 states, else 1): word w holds states 32w … 32w + 31,
    bit ``s % 32`` for state s."""
    T, B, S = (int(d) for d in picks.shape)
    _check_states(S)
    W = _n_words(S)
    bits = torch.zeros((B, T, 32 * W), dtype=torch.int64, device=picks.device)
    bits[..., :S] = picks.permute(1, 0, 2).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=picks.device) << torch.arange(
        32, device=picks.device)
    words = (bits.view(B, T, W, 32) * weights).sum(-1)          # < 2^32, in int64
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def unpack_survivors(words: torch.Tensor, n_states: int) -> torch.Tensor:
    """The inverse of :func:`pack_survivors`: ``int32 [B, T, W]`` → ``picks
    [T, B, n_states]`` uint8."""
    B, T, W = (int(d) for d in words.shape)
    shifts = torch.arange(32, device=words.device)
    bits = (words.to(torch.int64).unsqueeze(-1) >> shifts) & 1  # [B, T, W, 32]
    return bits.reshape(B, T, 32 * W)[..., :n_states].permute(1, 0, 2).to(torch.uint8)


def traceback_plain(words: torch.Tensor, steps: torch.Tensor, prev_s: torch.Tensor,
                    prev_b: torch.Tensor) -> torch.Tensor:
    """The reference's host traceback over packed survivors: from state 0 at
    ``steps[b] − 1`` down to step 0, ``bit = prev_b[s, pick]``, ``s =
    prev_s[s, pick]``; ``words int32 [B, T, W]`` → ``bits uint8 [B, T]``, 0 at
    ``t ≥ steps[b]``. One loop over the steps, vectorized over the frames."""
    B, T, _ = (int(d) for d in words.shape)
    dev = words.device
    w64 = words.to(torch.int64) & 0xFFFFFFFF
    n = steps.to(device=dev, dtype=torch.int64).clamp(0, T)
    ps = prev_s.to(device=dev, dtype=torch.int64).reshape(-1)   # [s * 2 + pick]
    pb = prev_b.to(device=dev, dtype=torch.uint8).reshape(-1)
    bits = torch.zeros((B, T), dtype=torch.uint8, device=dev)
    s = torch.zeros(B, dtype=torch.int64, device=dev)
    rows = torch.arange(B, device=dev)
    for t in range(int(n.max()) - 1 if B else -1, -1, -1):
        active = t < n
        pick = (w64[rows, t, s >> 5] >> (s & 31)) & 1
        at = s * 2 + pick
        bits[:, t] = torch.where(active, pb[at], 0)
        s = torch.where(active, ps[at], s)
    return bits


def _survivors_plain(lams: torch.Tensor, steps: torch.Tensor, prev_s: torch.Tensor,
                     bm0: torch.Tensor, bm1: torch.Tensor) -> torch.Tensor:
    """The kernel's survivor words by :func:`acs_plain`, rows at ``t ≥
    steps[b]`` zero."""
    T = int(lams.shape[1])
    n = steps.to(torch.int64).clamp(0, T)
    t_max = int(n.max()) if lams.shape[0] else 0
    picks = torch.zeros((T, lams.shape[0], prev_s.shape[0]), dtype=torch.uint8,
                        device=lams.device)
    picks[:t_max] = acs_plain(lams[:, :t_max].contiguous(), prev_s, bm0, bm1)
    live = torch.arange(T, device=lams.device)[:, None] < n.to(lams.device)[None, :]
    return pack_survivors(picks * live[..., None])


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _lib():
    from . import _build
    lib = _build.load("viterbi")
    if not getattr(lib, "_fsdr_typed", False):
        vp = ctypes.c_void_p
        lib.fsdr_viterbi.argtypes = [vp] * 8 + [ctypes.c_int, ctypes.c_longlong,
                                                ctypes.c_int, vp]
        lib.fsdr_viterbi.restype = ctypes.c_int
        lib._fsdr_typed = True
    return lib


def _launch(lams: torch.Tensor, steps: torch.Tensor, prev_s: torch.Tensor,
            bm0: torch.Tensor, bm1: torch.Tensor, prev_b: Optional[torch.Tensor],
            surv: torch.Tensor, bits: Optional[torch.Tensor]) -> None:
    """One launch of ``csrc/viterbi.cu`` on the current stream: the survivors
    into ``surv``, and with ``bits`` the traceback into it."""
    for t in (lams, steps, prev_s, bm0, bm1, prev_b):
        if t is not None and t.device.type != "cuda":
            raise ValueError(f"the CUDA kernels take CUDA or CPU tensors, got {t.device}")
    B, T = int(lams.shape[0]), int(lams.shape[1])
    if B == 0 or T == 0:
        return                              # nothing to launch
    args = [lams.contiguous(), steps.to(torch.int32).contiguous(),
            prev_s.to(torch.int32).contiguous(),
            None if prev_b is None else prev_b.to(torch.int32).contiguous(),
            bm0.contiguous(), bm1.contiguous()]
    lib = _lib()
    idx = lams.device.index
    with torch.cuda.device(idx):
        err = lib.fsdr_viterbi(*(None if a is None else a.data_ptr() for a in args),
                               surv.data_ptr(), None if bits is None else bits.data_ptr(),
                               B, T, int(prev_s.shape[0]),
                               torch._C._cuda_getCurrentRawStream(idx))
    if err != 0:
        raise RuntimeError(f"CUDA kernel viterbi failed to launch: cudaError {err}")
    launches["viterbi"] += 1


def survivors(lams: torch.Tensor, steps: torch.Tensor, prev_s: torch.Tensor,
              bm0: torch.Tensor, bm1: torch.Tensor) -> torch.Tensor:
    """The packed survivors ``int32 [B, T, W]`` of the ACS recursion over
    ``lams [B, T, 2]`` float32, frame b run for ``steps[b]`` steps (rows past
    it zero). A CPU tensor runs :func:`acs_plain` and :func:`pack_survivors`;
    a CUDA tensor launches ``csrc/viterbi.cu`` without its traceback or
    raises."""
    _check(lams, prev_s, bm0, bm1, steps=steps)
    if lams.device.type == "cpu":
        return _survivors_plain(lams, steps, prev_s, bm0, bm1)
    S = int(prev_s.shape[0])
    surv = torch.zeros((lams.shape[0], lams.shape[1], _n_words(S)), dtype=torch.int32,
                       device=lams.device)
    _launch(lams, steps, prev_s, bm0, bm1, None, surv, None)
    return surv


def acs(lams: torch.Tensor, prev_s: torch.Tensor, bm0: torch.Tensor,
        bm1: torch.Tensor) -> torch.Tensor:
    """``picks [T, B, S]`` uint8 of the ACS recursion over ``lams [B, T, 2]``
    float32. A CPU tensor runs :func:`acs_plain`; a CUDA tensor launches
    ``csrc/viterbi.cu`` over every step on the current stream (or raises) and
    unpacks its survivors."""
    if lams.device.type == "cpu":
        return acs_plain(lams, prev_s, bm0, bm1)
    _check(lams, prev_s, bm0, bm1)
    steps = torch.full((lams.shape[0],), lams.shape[1], dtype=torch.int32,
                       device=lams.device)
    return unpack_survivors(survivors(lams, steps, prev_s, bm0, bm1), int(prev_s.shape[0]))


def decode(lams: torch.Tensor, steps: torch.Tensor, prev_s: torch.Tensor,
           prev_b: torch.Tensor, bm0: torch.Tensor, bm1: torch.Tensor) -> torch.Tensor:
    """Decoded bits ``uint8 [B, T]`` of ``lams [B, T, 2]`` float32, frame b
    over its first ``steps[b]`` steps (0 past them), traced back from state
    0. A CPU tensor runs the plain versions (:func:`acs_plain`,
    :func:`pack_survivors`, :func:`traceback_plain`); a CUDA tensor launches
    ``csrc/viterbi.cu`` once (the recursion and the traceback) on the current
    stream or raises."""
    _check(lams, prev_s, bm0, bm1, prev_b=prev_b, steps=steps)
    if lams.device.type == "cpu":
        return traceback_plain(_survivors_plain(lams, steps, prev_s, bm0, bm1), steps,
                               prev_s, prev_b)
    B, T = int(lams.shape[0]), int(lams.shape[1])
    surv = torch.empty((B, T, _n_words(int(prev_s.shape[0]))), dtype=torch.int32,
                       device=lams.device)
    bits = torch.empty((B, T), dtype=torch.uint8, device=lams.device)
    _launch(lams, steps, prev_s, bm0, bm1, prev_b, surv, bits)
    return bits


# ---------------------------------------------------------------------------
# decoders over numpy LLRs
# ---------------------------------------------------------------------------

_tables_cache: Dict[tuple, tuple] = {}


def _tables(prev_s: np.ndarray, prev_b: np.ndarray, bm0: np.ndarray, bm1: np.ndarray,
            device: torch.device) -> tuple:
    """The trellis tables ``(prev_s, prev_b, bm0, bm1)`` as tensors on
    ``device`` (int32, int32, float32, float32), checked and made once a
    table set and device."""
    key = (prev_s.tobytes(), prev_b.tobytes(), bm0.tobytes(), bm1.tobytes(), str(device))
    got = _tables_cache.get(key)
    if got is None:
        _check_states(int(prev_s.shape[0]))
        if prev_s.min() < 0 or prev_s.max() >= prev_s.shape[0]:
            raise ValueError("prev_s holds a state outside the trellis")
        if not np.isin(prev_b, (0, 1)).all():
            raise ValueError("prev_b must hold bits (0 or 1)")
        got = tuple(torch.from_numpy(np.ascontiguousarray(t, dt)).to(device)
                    for t, dt in ((prev_s, np.int32), (prev_b, np.int32),
                                  (bm0, np.float32), (bm1, np.float32)))
        _tables_cache[key] = got
    return got


def bucket_steps(n_steps: int) -> int:
    """The step bucket: a power of two, at least 8."""
    return max(8, 1 << int(np.ceil(np.log2(max(n_steps, 1)))))


def scan_viterbi_batch(llrs_list: Sequence[np.ndarray], n_bits_list: Sequence[int],
                       prev_s: np.ndarray, prev_b: np.ndarray, bm0: np.ndarray,
                       bm1: np.ndarray, device=None,
                       stats: Optional[dict] = None) -> List[np.ndarray]:
    """Decode a batch of frames with one :func:`decode` launch on ``device``.

    ``llrs_list``: per-frame soft arrays (2 per step); returns the list of bit
    arrays. Frames are padded to a common power-of-two step bucket, as the
    reference pads them, and each runs to its own length. ``stats``, when
    given, receives ``frames``, ``bucket``, ``d2h_bytes`` (the decoded bits
    that come back), ``acs_s`` (the H2D and the launch, recursion and
    traceback, to its end) and ``d2h_s`` (the bits' copy to the host).
    """
    dev = resolve_device(device)
    steps = [min(len(l) // 2, n) for l, n in zip(llrs_list, n_bits_list)]
    bucket = bucket_steps(max(steps))
    n_frames = len(llrs_list)
    lams = np.zeros((n_frames, bucket, 2), dtype=np.float32)
    for i, (l, t) in enumerate(zip(llrs_list, steps)):
        lams[i, :t] = np.asarray(l[:2 * t], np.float32).reshape(t, 2)
    ps, pb, b0, b1 = _tables(prev_s, prev_b, bm0, bm1, dev)
    t0 = time.perf_counter()
    bits_t = decode(torch.from_numpy(lams).to(dev),
                    torch.tensor(steps, dtype=torch.int32).to(dev), ps, pb, b0, b1)
    if stats is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    bits = bits_t.cpu().numpy()                                 # [frames, bucket]
    if stats is not None:
        stats.update(frames=n_frames, bucket=bucket, d2h_bytes=int(bits.nbytes),
                     acs_s=t1 - t0, d2h_s=time.perf_counter() - t1)
    return [bits[i, :steps[i]][:n_bits_list[i]] for i in range(n_frames)]


def scan_viterbi(llrs: np.ndarray, n_bits: int, prev_s: np.ndarray, prev_b: np.ndarray,
                 bm0: np.ndarray, bm1: np.ndarray, device=None) -> np.ndarray:
    """Decode ``n_bits`` from soft ``llrs`` (2 per step) given trellis tables,
    one frame on ``device``: :func:`scan_viterbi_batch` of that one frame.

    ``prev_s/prev_b``: [S, 2] predecessor state/input per next-state; ``bm0/bm1``: the
    corresponding branch output bits in ±1. Terminated trellis (traceback from state 0).
    """
    return scan_viterbi_batch([llrs], [n_bits], prev_s, prev_b, bm0, bm1, device)[0]
