"""Viterbi add-compare-select on the device: the WLAN receiver's batched decoder.

The counterpart of ``futuresdr_tpu/ops/viterbi.py``, whose ACS recursion is a
jitted ``lax.scan``. Here it is a hand kernel, ``csrc/viterbi.cu`` (one frame a
warp, the 64 metrics in registers): :func:`acs`, with its plain PyTorch
version :func:`acs_plain` (a loop over the steps, the same float32
arithmetic) and a launch counter in :data:`launches`. As with the kernels of
``ops/cuda_kernels.py``, a CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.

:func:`scan_viterbi` and :func:`scan_viterbi_batch` keep the reference's
buckets (a power of two ≥ 8 steps, the batch padded to a power of two), its
float32 metrics (−1e18, state 0 at 0) and its picks (``uint8 [bucket, B,
64]``), and trace back on the host. They run on the ``device`` given (None:
the card, through ``tpu/instance.py``'s broker, which raises without one).
"""

from __future__ import annotations

import ctypes
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..tpu.instance import resolve_device

__all__ = ["acs", "acs_plain", "scan_viterbi", "scan_viterbi_batch", "launches",
           "reset_launches", "bucket_steps", "batch_size"]

#: launches of ``csrc/viterbi.cu`` since the last :func:`reset_launches`
launches: Dict[str, int] = {"viterbi": 0}

_N_STATES = 64


def reset_launches() -> None:
    launches["viterbi"] = 0


def _check(lams: torch.Tensor, prev_s: torch.Tensor, bm0: torch.Tensor,
           bm1: torch.Tensor) -> None:
    if lams.dtype != torch.float32 or lams.dim() != 3 or lams.shape[2] != 2:
        raise TypeError(f"lams must be float32 [B, T, 2], got {lams.dtype} of shape "
                        f"{tuple(lams.shape)}")
    s = prev_s.shape[0] if prev_s.dim() == 2 else -1
    if prev_s.dim() != 2 or prev_s.shape[1] != 2 or prev_s.dtype not in (torch.int32,
                                                                          torch.int64):
        raise TypeError(f"prev_s must be an integer [S, 2] table, got {prev_s.dtype} of "
                        f"shape {tuple(prev_s.shape)}")
    for name, t in (("bm0", bm0), ("bm1", bm1)):
        if t.dtype != torch.float32 or tuple(t.shape) != (s, 2):
            raise TypeError(f"{name} must be float32 [{s}, 2], got {t.dtype} of shape "
                            f"{tuple(t.shape)}")
    if any(t.device != lams.device for t in (prev_s, bm0, bm1)):
        raise ValueError("lams and the trellis tables must lie on one device, got "
                         f"{[str(t.device) for t in (lams, prev_s, bm0, bm1)]}")


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


def _lib():
    from . import _build
    lib = _build.load("viterbi")
    if not getattr(lib, "_fsdr_typed", False):
        vp = ctypes.c_void_p
        lib.fsdr_viterbi_acs.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int,
                                         ctypes.c_longlong, vp]
        lib.fsdr_viterbi_acs.restype = ctypes.c_int
        lib._fsdr_typed = True
    return lib


def acs(lams: torch.Tensor, prev_s: torch.Tensor, bm0: torch.Tensor,
        bm1: torch.Tensor) -> torch.Tensor:
    """``picks [T, B, 64]`` uint8 of the ACS recursion over ``lams [B, T, 2]``
    float32. A CPU tensor runs :func:`acs_plain`; a CUDA tensor launches
    ``csrc/viterbi.cu`` (64 states) on the current stream or raises."""
    if lams.device.type == "cpu":
        return acs_plain(lams, prev_s, bm0, bm1)
    _check(lams, prev_s, bm0, bm1)
    for t in (lams, prev_s, bm0, bm1):
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA kernels take CUDA or CPU tensors, got {t.device}")
    if prev_s.shape[0] != _N_STATES:
        raise ValueError(f"the kernel decodes a {_N_STATES}-state trellis, got "
                         f"{prev_s.shape[0]} states")
    lams = lams.contiguous()
    ps = prev_s.to(torch.int32).contiguous()   # the kernel reads a state mod 64
    b0, b1 = bm0.contiguous(), bm1.contiguous()
    B, T = int(lams.shape[0]), int(lams.shape[1])
    picks = torch.empty((T, B, _N_STATES), dtype=torch.uint8, device=lams.device)
    if B == 0 or T == 0:
        return picks                        # nothing to launch
    lib = _lib()
    idx = lams.device.index
    with torch.cuda.device(idx):
        err = lib.fsdr_viterbi_acs(lams.data_ptr(), ps.data_ptr(), b0.data_ptr(),
                                   b1.data_ptr(), picks.data_ptr(), B, T,
                                   torch._C._cuda_getCurrentRawStream(idx))
    if err != 0:
        raise RuntimeError(f"CUDA kernel viterbi failed to launch: cudaError {err}")
    launches["viterbi"] += 1
    return picks


# ---------------------------------------------------------------------------
# decoders over numpy LLRs
# ---------------------------------------------------------------------------

_tables_cache: Dict[tuple, tuple] = {}


def _tables(prev_s: np.ndarray, bm0: np.ndarray, bm1: np.ndarray,
            device: torch.device) -> tuple:
    """The trellis tables as tensors on ``device`` (int32 / float32), made
    once a table set and device."""
    key = (prev_s.tobytes(), bm0.tobytes(), bm1.tobytes(), str(device))
    got = _tables_cache.get(key)
    if got is None:
        if prev_s.min() < 0 or prev_s.max() >= prev_s.shape[0]:
            raise ValueError("prev_s holds a state outside the trellis")
        got = (torch.from_numpy(np.ascontiguousarray(prev_s, np.int32)).to(device),
               torch.from_numpy(np.ascontiguousarray(bm0, np.float32)).to(device),
               torch.from_numpy(np.ascontiguousarray(bm1, np.float32)).to(device))
        _tables_cache[key] = got
    return got


def bucket_steps(n_steps: int) -> int:
    """The step bucket: a power of two, at least 8."""
    return max(8, 1 << int(np.ceil(np.log2(max(n_steps, 1)))))


def batch_size(n_frames: int) -> int:
    """The frame batch: a power of two, at least 1."""
    return max(1, 1 << int(np.ceil(np.log2(max(n_frames, 1)))))


def scan_viterbi_batch(llrs_list: Sequence[np.ndarray], n_bits_list: Sequence[int],
                       prev_s: np.ndarray, prev_b: np.ndarray, bm0: np.ndarray,
                       bm1: np.ndarray, device=None,
                       stats: Optional[dict] = None) -> List[np.ndarray]:
    """Decode a batch of frames with one ACS launch on ``device``.

    ``llrs_list``: per-frame soft arrays (2 per step); returns the list of bit
    arrays. Frames are padded to a common power-of-two step bucket and the
    batch to a power of two, as the reference pads them. ``stats``, when
    given, receives ``picks_bytes``, ``acs_s`` (the launch to its end) and
    ``d2h_s`` (the picks' copy to the host).
    """
    dev = resolve_device(device)
    steps = [min(len(l) // 2, n) for l, n in zip(llrs_list, n_bits_list)]
    bucket = bucket_steps(max(steps))
    b_real = len(llrs_list)
    batch = batch_size(b_real)
    lams = np.zeros((batch, bucket, 2), dtype=np.float32)
    for i, (l, t) in enumerate(zip(llrs_list, steps)):
        lams[i, :t] = np.asarray(l[:2 * t], np.float32).reshape(t, 2)
    ps, b0, b1 = _tables(prev_s, bm0, bm1, dev)
    t0 = time.perf_counter()
    picks_t = acs(torch.from_numpy(lams).to(dev), ps, b0, b1)   # [bucket, B, S]
    if stats is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    picks = picks_t.cpu().numpy()
    if stats is not None:
        stats.update(picks_bytes=int(picks.nbytes), acs_s=t1 - t0,
                     d2h_s=time.perf_counter() - t1)
    # vectorized traceback over the whole batch: one loop over time, [B] states;
    # frames shorter than the bucket stay parked at state 0 until their own end
    steps_arr = np.asarray(steps + [0] * (batch - b_real))
    states = np.zeros(batch, dtype=np.int64)
    bits_all = np.zeros((bucket, batch), dtype=np.uint8)
    rows = np.arange(batch)
    for tt in range(bucket - 1, -1, -1):
        active = tt < steps_arr
        b = picks[tt, rows, states]
        bits_all[tt, active] = prev_b[states, b][active]
        states = np.where(active, prev_s[states, b], states)
    return [bits_all[:steps[i], i][:n_bits_list[i]] for i in range(b_real)]


def scan_viterbi(llrs: np.ndarray, n_bits: int, prev_s: np.ndarray, prev_b: np.ndarray,
                 bm0: np.ndarray, bm1: np.ndarray, device=None) -> np.ndarray:
    """Decode ``n_bits`` from soft ``llrs`` (2 per step) given trellis tables,
    one frame on ``device``: :func:`scan_viterbi_batch` of that one frame.

    ``prev_s/prev_b``: [S, 2] predecessor state/input per next-state; ``bm0/bm1``: the
    corresponding branch output bits in ±1. Terminated trellis (traceback from state 0).
    """
    return scan_viterbi_batch([llrs], [n_bits], prev_s, prev_b, bm0, bm1, device)[0]
