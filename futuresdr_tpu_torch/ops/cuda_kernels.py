"""Hand-written CUDA kernels of the streaming hot ops, and their plain versions.

The counterpart of ``futuresdr_tpu/ops/pallas_kernels.py``. Each kernel has:

* a wrapper that checks device, dtype, shape and contiguity, sends a tensor
  that lies on the CPU to the plain version, and otherwise launches the
  kernel on PyTorch's current stream (or raises; nothing falls back);
* a launch counter in :data:`launches`, incremented where the kernel is
  launched and nowhere else;
* ``*_plain``: the same function in plain PyTorch ops, which repeats the
  kernel's arithmetic (the CPU tests hold it against the JAX package; the
  chip check holds the kernel against it).

Kernels (sources under ``csrc/``, built by :mod:`._build`):

* ``fir`` (``csrc/fir.cu``) replaces ``_fir_kernel``: the causal real-tap FIR
  of a float32 or complex64 stream, ``fir`` from a zero state and
  ``fir_continue`` from the previous ``n_taps - 1`` samples.
* ``fir_fft`` (``csrc/fir_fft.cu``) replaces ``_fir_fft_kernel``: the FIR
  fused with the forward FFT of each ``n_fft``-sample row.

``precision="bf16"`` rounds the MAC's operands (samples and taps) to bfloat16;
their products are exact in float32 and accumulate in float32, in the kernel
and in the plain version alike, as the JAX kernels' bf16 mode computes them.
``fir_fft`` also rounds the filtered row to bfloat16 before its transform,
which runs in float32. (The JAX kernel's bf16 mode also rounds its DFT
matrix; a radix-2 FFT has no such matrix, so the port keeps its twiddles in
float32.) The TPU block-shape table (``DEFAULT_BLOCKS``) is TPU VMEM
geometry and has no counterpart: each CUDA kernel picks its own tile.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["fir", "fir_continue", "fir_fft", "fir_plain", "fir_continue_plain",
           "fir_fft_plain", "launches", "reset_launches"]

#: launches per kernel since the last :func:`reset_launches`
launches: Dict[str, int] = {"fir": 0, "fir_fft": 0}

# Largest dynamic shared memory one block may request on Hopper (227 KB).
_MAX_SMEM = 232448

_PRECISIONS = (None, "f32", "bf16")
_STREAM_DTYPES = (torch.float32, torch.complex64)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------------

def _check_precision(precision: Optional[str]) -> bool:
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}, got {precision!r}")
    return precision == "bf16"


def _check_args(hist: Optional[torch.Tensor], x: torch.Tensor,
                taps: torch.Tensor) -> int:
    """Validate a FIR call; returns the tap count."""
    if x.dtype not in _STREAM_DTYPES or x.dim() != 1:
        raise TypeError(f"x must be a 1-D float32 or complex64 tensor, got "
                        f"{x.dtype} of shape {tuple(x.shape)}")
    if taps.dtype != torch.float32 or taps.dim() != 1 or taps.shape[0] < 1:
        raise TypeError(f"taps must be a non-empty 1-D float32 tensor, got "
                        f"{taps.dtype} of shape {tuple(taps.shape)}")
    nt = int(taps.shape[0])
    tensors = [x, taps]
    if hist is not None:
        if hist.dtype != x.dtype or tuple(hist.shape) != (nt - 1,):
            raise ValueError(f"hist must be {nt - 1} samples of {x.dtype}, got "
                             f"{hist.dtype} of shape {tuple(hist.shape)}")
        tensors.append(hist)
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, taps and hist must lie on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    return nt


def _check_cuda(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA kernels take CUDA or CPU tensors, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels need contiguous tensors")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def _planes(x: torch.Tensor) -> torch.Tensor:
    """``[n, 2]`` float view of a complex stream, ``[n, 1]`` of a real one."""
    return torch.view_as_real(x) if x.is_complex() else x.unsqueeze(-1)


def _unplanes(p: torch.Tensor, complex_out: bool) -> torch.Tensor:
    return torch.view_as_complex(p.contiguous()) if complex_out else p[:, 0]


def _fir_planes(ext: torch.Tensor, taps: torch.Tensor, n: int, bf16: bool) -> torch.Tensor:
    """``y[i] = Σ_k taps[k] · ext[i + nt − 1 − k]`` over float planes, taps in
    ascending order (the kernel's summation order)."""
    nt = int(taps.shape[0])
    if bf16:
        ext, taps = _bf16(ext), _bf16(taps)
    acc = torch.zeros((n, ext.shape[1]), dtype=torch.float32, device=ext.device)
    for k in range(nt):
        off = nt - 1 - k
        acc = acc + taps[k] * ext[off:off + n]
    return acc


def fir_continue_plain(hist: torch.Tensor, x: torch.Tensor, taps: torch.Tensor,
                       precision: Optional[str] = None) -> torch.Tensor:
    """Plain version of :func:`fir_continue`."""
    bf16 = _check_precision(precision)
    _check_args(hist, x, taps)
    ext = _planes(torch.cat([hist, x]))
    return _unplanes(_fir_planes(ext, taps, x.shape[0], bf16), x.is_complex())


def fir_plain(x: torch.Tensor, taps: torch.Tensor,
              precision: Optional[str] = None) -> torch.Tensor:
    """Plain version of :func:`fir` (zero initial state)."""
    hist = torch.zeros(taps.shape[0] - 1, dtype=x.dtype, device=x.device)
    return fir_continue_plain(hist, x, taps, precision)


_dft_lock = threading.Lock()
_dft_cache: Dict[Tuple[int, str], torch.Tensor] = {}
_tw_cache: Dict[Tuple[int, str], torch.Tensor] = {}


def _phases(n_fft: int) -> np.ndarray:
    """``2π·k/N`` for k in [0, N), in float64 (the phase index is an integer
    already reduced mod N)."""
    return 2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft


def _dft_matrix(n_fft: int, device: torch.device) -> torch.Tensor:
    """``E[j, c] = exp(−2πi·((j·c) mod N)/N)`` as complex64 on ``device``."""
    key = (n_fft, str(device))
    with _dft_lock:
        e = _dft_cache.get(key)
        if e is None:
            c = np.arange(n_fft, dtype=np.int64)
            ang = _phases(n_fft)[np.outer(c, c) % n_fft]
            e = torch.from_numpy(np.exp(-1j * ang).astype(np.complex64)).to(device)
            _dft_cache[key] = e
        return e


def _twiddles(n_fft: int, device: torch.device) -> torch.Tensor:
    """The kernel's twiddle table: ``[N, 2]`` float32 ``(cos, sin)(2π·k/N)``."""
    key = (n_fft, str(device))
    with _dft_lock:
        tw = _tw_cache.get(key)
        if tw is None:
            ang = _phases(n_fft)
            tab = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
            tw = torch.from_numpy(tab).to(device)
            _tw_cache[key] = tw
        return tw


def _check_fir_fft(hist, x, taps, n_fft: int) -> int:
    nt = _check_args(hist, x, taps)
    if hist is None:
        raise ValueError("fir_fft needs hist (the previous n_taps - 1 samples)")
    if not 2 <= nt <= n_fft:
        raise ValueError(f"fir_fft needs 2 <= n_taps <= n_fft, got {nt} taps, "
                         f"n_fft={n_fft}")
    if x.shape[0] % n_fft:
        raise ValueError(f"frame ({x.shape[0]}) must be a multiple of n_fft ({n_fft})")
    return nt


def fir_fft_plain(hist: torch.Tensor, x: torch.Tensor, taps: torch.Tensor,
                  n_fft: int, precision: Optional[str] = None) -> torch.Tensor:
    """Plain version of :func:`fir_fft`: the FIR, then each row times the
    DFT matrix."""
    bf16 = _check_precision(precision)
    _check_fir_fft(hist, x, taps, n_fft)
    ext = _planes(torch.cat([hist, x]))
    v = _fir_planes(ext, taps, x.shape[0], bf16)
    if bf16:
        v = _bf16(v)
    if v.shape[1] == 1:
        v = torch.cat([v, torch.zeros_like(v)], dim=1)
    rows = torch.view_as_complex(v.contiguous()).reshape(-1, n_fft)
    return (rows @ _dft_matrix(n_fft, x.device)).reshape(-1)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _lib(name: str):
    from . import _build
    lib = _build.load(name)
    if not getattr(lib, "_fsdr_typed", False):
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        if name == "fir":
            lib.fsdr_fir.argtypes = [vp, vp, vp, vp, ll, i, i, i, vp]
            lib.fsdr_fir.restype = i
            lib.fsdr_fir_tile.argtypes = []
            lib.fsdr_fir_tile.restype = i
        else:
            lib.fsdr_fir_fft.argtypes = [vp, vp, vp, vp, vp, ll, i, i, i, i, i, vp]
            lib.fsdr_fir_fft.restype = i
        lib._fsdr_typed = True
    return lib


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def _launch_fir(hist: Optional[torch.Tensor], x: torch.Tensor, taps: torch.Tensor,
                bf16: bool) -> torch.Tensor:
    _check_cuda(*(t for t in (hist, x, taps) if t is not None))
    nt = int(taps.shape[0])
    if x.shape[0] == 0:
        return torch.empty_like(x)          # nothing to launch
    lib = _lib("fir")
    smem = (lib.fsdr_fir_tile() + nt - 1) * x.element_size() + 4 * nt
    if smem > _MAX_SMEM:
        raise ValueError(f"fir: {nt} taps need {smem} B of shared memory per "
                         f"block, over the card's {_MAX_SMEM} B")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fsdr_fir(None if hist is None else hist.data_ptr(), x.data_ptr(),
                           taps.data_ptr(), y.data_ptr(), x.shape[0], nt,
                           int(x.is_complex()), int(bf16), stream)
    _raise_on(err, "fir")
    launches["fir"] += 1
    return y


def fir(x: torch.Tensor, taps: torch.Tensor,
        precision: Optional[str] = None) -> torch.Tensor:
    """Causal FIR of a 1-D float32 or complex64 stream from a zero initial
    state; real float32 taps. Any frame length."""
    if x.device.type == "cpu":
        return fir_plain(x, taps, precision)
    bf16 = _check_precision(precision)
    _check_args(None, x, taps)
    return _launch_fir(None, x, taps, bf16)


def fir_continue(hist: torch.Tensor, x: torch.Tensor, taps: torch.Tensor,
                 precision: Optional[str] = None) -> torch.Tensor:
    """Streaming continuation: filter ``x`` given the previous ``n_taps − 1``
    input samples in ``hist``; returns ``len(x)`` outputs. The taps may come
    from a stage carry, so a retune reaches the kernel."""
    if x.device.type == "cpu":
        return fir_continue_plain(hist, x, taps, precision)
    bf16 = _check_precision(precision)
    _check_args(hist, x, taps)
    return _launch_fir(hist, x, taps, bf16)


def fir_fft(hist: torch.Tensor, x: torch.Tensor, taps: torch.Tensor, n_fft: int,
            precision: Optional[str] = None) -> torch.Tensor:
    """Fused FIR → forward FFT: ``fft(filtered.reshape(-1, n_fft))`` flattened,
    with ``filtered`` the causal FIR of ``x`` after ``hist`` (the previous
    ``n_taps − 1`` samples). Real taps, ``2 ≤ n_taps ≤ n_fft``, ``len(x)`` a
    multiple of ``n_fft``; any ``n_fft`` (a power of two takes the FFT, any
    other size a direct DFT). Returns complex64."""
    if x.device.type == "cpu":
        return fir_fft_plain(hist, x, taps, n_fft, precision)
    bf16 = _check_precision(precision)
    nt = _check_fir_fft(hist, x, taps, n_fft)
    _check_cuda(hist, x, taps)
    smem = (2 * n_fft + nt - 1) * 8 + 4 * nt
    if smem > _MAX_SMEM:
        raise ValueError(f"fir_fft: n_fft={n_fft} with {nt} taps needs {smem} B "
                         f"of shared memory per block, over the card's {_MAX_SMEM} B")
    if x.shape[0] == 0:
        return torch.empty(0, dtype=torch.complex64, device=x.device)   # nothing to launch
    log2n = n_fft.bit_length() - 1 if n_fft & (n_fft - 1) == 0 else -1
    tw = _twiddles(n_fft, x.device)
    lib = _lib("fir_fft")
    y = torch.empty(x.shape[0], dtype=torch.complex64, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fsdr_fir_fft(hist.data_ptr(), x.data_ptr(), taps.data_ptr(),
                               tw.data_ptr(), y.data_ptr(), x.shape[0] // n_fft,
                               n_fft, log2n, nt, int(x.is_complex()), int(bf16),
                               stream)
    _raise_on(err, "fir_fft")
    launches["fir_fft"] += 1
    return y
