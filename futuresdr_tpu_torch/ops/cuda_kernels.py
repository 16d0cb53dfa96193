"""Hand-written CUDA kernels of the streaming hot ops, and their plain versions.

The counterpart of ``futuresdr_tpu/ops/pallas_kernels.py``. Each kernel has:

* a wrapper that checks device, dtype, shape and contiguity, sends a tensor
  that lies on the CPU to the plain version, and otherwise launches the
  kernel on PyTorch's current stream (or raises; nothing falls back);
* a launch counter in :data:`launches`, incremented where the kernel is
  launched and nowhere else (a launch recorded into a CUDA graph capture
  counts in the capture's tally instead, :func:`capturing`, and each replay
  of the graph adds it);
* ``*_plain``: the same function in plain PyTorch ops, which repeats the
  kernel's arithmetic (the CPU tests hold it against the JAX package; the
  chip check holds the kernel against it).

Kernels (sources under ``csrc/``, built by :mod:`._build`):

* ``fir`` (``csrc/fir.cu``) replaces ``_fir_kernel``: the causal real-tap FIR
  of a float32 or complex64 stream, ``fir`` from a zero state and
  ``fir_continue`` from the previous ``n_taps - 1`` samples.
* ``fir_fft`` (``csrc/fir_fft.cu``) replaces ``_fir_fft_kernel``: the FIR
  fused with the forward FFT of each ``n_fft``-sample row.
* ``rotator`` (``csrc/rotator.cu``) replaces ``_rotator_kernel``: the phase
  ramp ``x[t]·exp(i·(ph0 + inc·t))``, ``ph0``/``inc`` read on the device,
  and the stage's next phase ``remainder(ph0 + inc·n, 2π)`` written by the
  kernel.
* ``poly_fir`` (``csrc/poly_fir.cu``) replaces ``_poly_fir_kernel``: the
  decimating FIR at the decimated rate over the stride-D row matrix, and with
  a 3-D weight tensor the rational resampler's phase outputs.
* ``quad_demod`` (``csrc/quad_demod.cu``) replaces ``_quad_demod_kernel``:
  ``gain·angle(x[t]·conj(x[t−1]))`` with the previous sample from the carry.
* ``pfb`` (``csrc/pfb.cu``) replaces ``_pfb_kernel``: the critically sampled
  polyphase analysis bank, the branch MAC over the commutated rows and the
  IDFT across branches in one kernel.

Under ``torch.func.vmap`` (the serving plane's slot program, ``serve/engine.py``)
each wrapper hands its batched call to a ``torch.library.custom_op`` of its
own (``fsdr::fir`` …), whose CPU and CUDA implementations are the wrapper's
plain version and launch, and whose ``register_vmap`` rule runs the batch as
one launch of the kernel's **lane form** (:func:`fir_lanes`,
:func:`fir_fft_lanes`, :func:`rotator_lanes`, :func:`poly_fir_lanes`,
:func:`quad_demod_lanes`, :func:`pfb_lanes`: the lane a grid dimension, each
lane the one-stream kernel's arithmetic on its own row, its own taps,
weights or prototype, history, phase or carry sample, the plans of the FIR,
polyphase and PFB forms chosen for the batch by :func:`fir_lanes_plan`,
:func:`fir_fft_lanes_plan`, :func:`poly_fir_lanes_plan` and
:func:`pfb_lanes_plan`; ``*_lanes_plain`` their plain versions).

``precision="bf16"`` rounds the MAC's operands (samples and taps) to bfloat16;
their products are exact in float32 and accumulate in float32, in the kernel
and in the plain version alike, as the JAX kernels' bf16 mode computes them.
``fir_fft`` also rounds the filtered row to bfloat16 before its transform,
which runs in float32. (The JAX kernel's bf16 mode also rounds its DFT
matrix; an FFT has no such matrix, so the port keeps its twiddles in
float32.) ``pfb`` in bf16 also rounds its branch bank ``v`` to bfloat16
before the IDFT; its plain version, like the JAX kernel, then also rounds the
cos/sin matrix, while the kernel keeps float32 twiddles.

The TPU block-shape table (``DEFAULT_BLOCKS``, ``set_tuned_blocks``) becomes
a table of plans: each kernel's plan function (:func:`fir_plan`,
:func:`fir_fft_plan`, :func:`poly_fir_plan`, :func:`pfb_plan`,
:func:`fir_lanes_plan`, :func:`fir_fft_lanes_plan`,
:func:`poly_fir_lanes_plan`, :func:`pfb_lanes_plan`) returns the
plan a sweep measured best at that shape (:func:`set_tuned_plans`,
``tpu/kernel_tune.py``), else its rule's pick; a plan passed to a wrapper
(``plan=``) beats both. ``rotator`` and ``quad_demod`` have one layout each.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = ["fir", "fir_continue", "fir_fft", "rotator", "poly_fir", "quad_demod",
           "pfb", "fir_plain", "fir_continue_plain", "fir_fft_plain", "rotator_plain",
           "poly_fir_plain", "quad_demod_plain", "pfb_plain", "fir_lanes", "fir_fft_lanes",
           "rotator_lanes", "poly_fir_lanes", "quad_demod_lanes", "pfb_lanes",
           "fir_lanes_plain", "fir_fft_lanes_plain", "rotator_lanes_plain",
           "poly_fir_lanes_plain", "quad_demod_lanes_plain", "pfb_lanes_plain",
           "LANE_KERNELS", "launches",
           "reset_launches", "capturing", "PLAN_KERNELS", "plan_candidates",
           "set_tuned_plans", "tuned_plans", "normalize_plans", "fir_plan",
           "fir_fft_plan", "poly_fir_plan", "pfb_plan", "fir_lanes_plan",
           "fir_fft_lanes_plan", "poly_fir_lanes_plan", "pfb_lanes_plan"]

#: launches per kernel since the last :func:`reset_launches`: the six kernels,
#: then their lane forms (:data:`LANE_KERNELS`)
launches: Dict[str, int] = {"fir": 0, "fir_fft": 0, "rotator": 0, "poly_fir": 0,
                            "quad_demod": 0, "pfb": 0, "fir_lanes": 0,
                            "fir_fft_lanes": 0, "rotator_lanes": 0, "poly_fir_lanes": 0,
                            "quad_demod_lanes": 0, "pfb_lanes": 0}

# Largest dynamic shared memory one block may request on Hopper (227 KB).
_MAX_SMEM = 232448
_SM_SMEM = 233472            # an SM's shared memory, its blocks' and 1 KB each

_PRECISIONS = (None, "f32", "bf16")
_STREAM_DTYPES = (torch.float32, torch.complex64)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


_tally = threading.local()


@contextlib.contextmanager
def capturing():
    """Count the launches this thread's wrappers record into a CUDA graph
    capture apart from :data:`launches`: a capture runs no kernel. Yields
    the tally, ``{kernel: launches}``, which each replay of the graph adds
    to :data:`launches` (``ops/stages.py`` ``CompiledPipeline``)."""
    counts = dict.fromkeys(launches, 0)
    _tally.counts = counts
    try:
        yield counts
    finally:
        _tally.counts = None


def _count(name: str) -> None:
    counts = getattr(_tally, "counts", None)
    (launches if counts is None else counts)[name] += 1


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
            # the N distinct entries, then gathered: the same values as
            # exp(−i·phase) taken entry by entry, without N² float64 temporaries
            w = torch.from_numpy(np.exp(-1j * _phases(n_fft)).astype(np.complex64))
            c = torch.arange(n_fft, dtype=torch.int64)
            e = w[torch.outer(c, c) % n_fft].to(device)
            _dft_cache[key] = e
        return e


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


def _check_rotator(x: torch.Tensor, ph0: torch.Tensor, inc: torch.Tensor) -> None:
    if x.dtype != torch.complex64 or x.dim() != 1:
        raise TypeError(f"x must be a 1-D complex64 tensor, got {x.dtype} of shape "
                        f"{tuple(x.shape)}")
    for name, t in (("ph0", ph0), ("inc", inc)):
        if t.dtype != torch.float32 or t.numel() != 1:
            raise TypeError(f"{name} must be one float32 value, got {t.dtype} of "
                            f"shape {tuple(t.shape)}")
    if any(t.device != x.device for t in (ph0, inc)):
        raise ValueError("x, ph0 and inc must lie on one device")


def rotator_plain(x: torch.Tensor, ph0: torch.Tensor,
                  inc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`rotator`: the float32 phase ``ph0 + inc·t``
    (product and sum rounded separately), then the complex multiply as four
    real products; the next phase as the stage computed it in PyTorch ops."""
    _check_rotator(x, ph0, inc)
    n = x.shape[0]
    ph0, inc = ph0.reshape(()), inc.reshape(())
    t = torch.arange(n, dtype=torch.float32, device=x.device)
    ph = ph0 + inc * t
    c, s = torch.cos(ph), torch.sin(ph)
    xr, xi = x.real, x.imag
    return (torch.complex(xr * c - xi * s, xr * s + xi * c),
            torch.remainder(ph0 + inc * n, 2 * np.pi))


def _check_quad_demod(prev: torch.Tensor, x: torch.Tensor) -> None:
    if x.dtype != torch.complex64 or x.dim() != 1:
        raise TypeError(f"x must be a 1-D complex64 tensor, got {x.dtype} of shape "
                        f"{tuple(x.shape)}")
    if prev.dtype != torch.complex64 or prev.numel() != 1:
        raise TypeError(f"prev must be one complex64 sample, got {prev.dtype} of "
                        f"shape {tuple(prev.shape)}")
    if prev.device != x.device:
        raise ValueError("x and prev must lie on one device")


def quad_demod_plain(prev: torch.Tensor, x: torch.Tensor,
                     gain: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`quad_demod`: ``z = x[t]·conj(x[t−1])`` formed
    as the kernel forms it, then ``gain·atan2(Im z, Re z)``."""
    _check_quad_demod(prev, x)
    ext = torch.cat([prev.reshape(1), x])
    pr, pi = ext[:-1].real, ext[:-1].imag
    xr, xi = x.real, x.imag
    zr = xr * pr + xi * pi
    zi = xi * pr - xr * pi
    y = float(np.float32(gain)) * torch.atan2(zi, zr)
    return y, ext[-1].clone()


def _check_poly_fir(hist: torch.Tensor, x: torch.Tensor, W: torch.Tensor) -> tuple:
    """Validate a polyphase call; returns ``(m, D, I, nq)`` (``I`` is 1 for a
    2-D ``W``)."""
    if x.dtype not in _STREAM_DTYPES or x.dim() != 1:
        raise TypeError(f"x must be a 1-D float32 or complex64 tensor, got "
                        f"{x.dtype} of shape {tuple(x.shape)}")
    if W.dtype not in (torch.float32, torch.bfloat16) or W.dim() not in (2, 3):
        raise TypeError(f"W must be a real 2-D [m+1, D] or 3-D [m+1, D, I] float32 "
                        f"or bfloat16 tensor, got {W.dtype} of shape {tuple(W.shape)}")
    m, D = int(W.shape[0]) - 1, int(W.shape[1])
    I = int(W.shape[2]) if W.dim() == 3 else 1
    if m < 1 or D < 1 or I < 1:
        raise ValueError(f"W needs m >= 1, D >= 1 and I >= 1, got {tuple(W.shape)}")
    if x.shape[0] % D:
        raise ValueError(f"frame ({x.shape[0]}) must be a multiple of D ({D})")
    if hist.dtype != x.dtype or tuple(hist.shape) != (m * D,):
        raise ValueError(f"hist must be {m * D} samples of {x.dtype}, got "
                         f"{hist.dtype} of shape {tuple(hist.shape)}")
    if any(t.device != x.device for t in (hist, W)):
        raise ValueError("hist, x and W must lie on one device")
    return m, D, I, x.shape[0] // D


def poly_fir_plain(hist: torch.Tensor, x: torch.Tensor, W: torch.Tensor,
                   precision: Optional[str] = None) -> torch.Tensor:
    """Plain version of :func:`poly_fir`: the shifted-row matmul sum
    ``Σ_a rows[m−a : m−a+nq] @ W[a]`` over float planes, in float32."""
    bf16 = _check_precision(precision)
    m, D, I, nq = _check_poly_fir(hist, x, W)
    planes = _planes(torch.cat([hist, x]))                 # [(m + nq)·D, 1 or 2]
    w = W.to(torch.float32).reshape(m + 1, D, I)
    if bf16:
        planes, w = _bf16(planes), _bf16(w)
    out = []
    for p in range(planes.shape[1]):
        rows = planes[:, p].reshape(-1, D)
        acc = rows[m:m + nq] @ w[0]
        for a in range(1, m + 1):
            acc = acc + rows[m - a:m - a + nq] @ w[a]
        out.append(acc)                                    # [nq, I]
    y = torch.complex(out[0], out[1]) if x.is_complex() else out[0]
    return y if W.dim() == 3 else y[:, 0]


def _idft_matrix(n: int, device: torch.device, bf16: bool) -> torch.Tensor:
    """``E[c, c'] = exp(+2πi·((c·c') mod N)/N)`` as complex64 on ``device``,
    its cos and sin planes rounded to bfloat16 when ``bf16`` (the JAX kernel's
    bf16 IDFT matrices)."""
    key = (n, f"{device}/idft/{'bf16' if bf16 else 'f32'}")
    with _dft_lock:
        e = _dft_cache.get(key)
    if e is None:
        planes = torch.view_as_real(_dft_matrix(n, device).conj().resolve_conj())
        e = torch.view_as_complex((_bf16(planes) if bf16 else planes).contiguous())
        with _dft_lock:
            _dft_cache[key] = e
    return e


def _check_pfb(hist: torch.Tensor, x: torch.Tensor, taps: torch.Tensor) -> tuple:
    """Validate a PFB call; returns ``(K, N, t)``."""
    if x.dtype != torch.complex64 or x.dim() != 1:
        raise TypeError(f"x must be a 1-D complex64 tensor, got {x.dtype} of shape "
                        f"{tuple(x.shape)}")
    if taps.dtype not in (torch.float32, torch.bfloat16) or taps.dim() != 2 \
            or min(taps.shape) < 1:
        raise TypeError(f"taps must be a real [K, N] float32 or bfloat16 tensor, got "
                        f"{taps.dtype} of shape {tuple(taps.shape)}")
    K, N = int(taps.shape[0]), int(taps.shape[1])
    if x.shape[0] % N:
        raise ValueError(f"frame ({x.shape[0]}) must be a multiple of N ({N})")
    if hist.dtype != torch.complex64 or tuple(hist.shape) != ((K - 1) * N,):
        raise ValueError(f"hist must be {(K - 1) * N} complex64 samples, got "
                         f"{hist.dtype} of shape {tuple(hist.shape)}")
    if any(t.device != x.device for t in (hist, taps)):
        raise ValueError("hist, x and taps must lie on one device")
    return K, N, x.shape[0] // N


def pfb_plain(hist: torch.Tensor, x: torch.Tensor, taps: torch.Tensor,
              precision: Optional[str] = None) -> torch.Tensor:
    """Plain version of :func:`pfb`, the JAX kernel's arithmetic: the branch
    MAC over the commutated rows in float32 (taps in ascending depth, the
    kernel's order), then each row times the IDFT matrix. In bf16 the rows,
    taps, ``v`` and the matrix's cos/sin planes are rounded to bfloat16."""
    bf16 = _check_precision(precision)
    K, N, t = _check_pfb(hist, x, taps)
    rows = _planes(torch.cat([hist, x])).reshape(t + K - 1, N, 2).flip(1)
    w = taps.to(torch.float32)
    if bf16:
        rows, w = _bf16(rows), _bf16(w)
    acc = torch.zeros((t, N, 2), dtype=torch.float32, device=x.device)
    for k in range(K):
        acc = acc + w[k, :, None] * rows[K - 1 - k:K - 1 - k + t]
    if bf16:
        acc = _bf16(acc)
    return torch.view_as_complex(acc.contiguous()) @ _idft_matrix(N, x.device, bf16)


# ---------------------------------------------------------------------------
# tiling plans of fir, fir_fft, poly_fir and pfb (the kernels take them as
# arguments; tests/test_torch_kernel_plans.py walks them on the CPU)
# ---------------------------------------------------------------------------

_NO_PAD = 31                 # a pad shift that pads nothing below 2^31


def _skew(i: int, sh: int) -> int:
    """Index ``i`` of a shared buffer with one slot of padding every
    ``2^sh`` slots (the kernels' ``skew``)."""
    return i + (i >> sh)


class FirFftPlan(NamedTuple):
    """How ``csrc/fir_fft.cu`` runs one ``n_fft``-sample row per block."""
    threads: int                 # threads per block (per row)
    outs: int                    # consecutive filtered samples a thread computes (R)
    radices: Tuple[int, ...]     # Stockham passes; empty: direct DFT (N not 2^k)
    spans: Tuple[int, ...]       # Ns of each pass: the product of the radices before it
    strides: Tuple[int, ...]     # twiddle index stride of each pass, N / (Ns·radix)
    tw_len: int                  # entries of the twiddle table (_fft_table)
    span_shift: int              # staged span: one pad slot every 2^span_shift samples
    pad_shift: int               # FFT buffers: one pad slot every 2^pad_shift points
    tw_staged: bool              # twiddle table (_fft_table) in shared memory, else L2
    smem: int                    # dynamic shared memory per block, bytes


def _fir_fft_smem(n: int, nt: int, span_shift: int, pad_shift: int, tw_len: int) -> int:
    """Bytes of the kernel's layout: buffer A (the skewed span, later an FFT
    buffer), buffer B (the padded filtered row), ``tw_len`` staged twiddle
    entries, the taps."""
    b_len = _skew(n - 1, pad_shift) + 1
    a_len = max(_skew(n + nt - 2, span_shift) + 1, b_len)
    return 8 * (a_len + b_len + tw_len) + 4 * nt


def _fft_table_index(n_fft: int, radices: Tuple[int, ...]) -> np.ndarray:
    """Phase index (mod N) of each entry of the ``fir_fft`` kernel's twiddle
    table: for Stockham passes, pass p's entries ``(q − 1)·Ns + k`` hold
    ``(k·q·stride) mod N`` (q < radix, k < Ns), the passes one after the
    other, so the threads of a pass read neighbouring entries; for the direct
    DFT (no passes) entry k is k."""
    if not radices:
        return np.arange(n_fft, dtype=np.int64)
    idx, ns = [], 1
    for r in radices:
        stride = n_fft // (ns * r)
        q, k = np.arange(1, r, dtype=np.int64)[:, None], np.arange(ns, dtype=np.int64)
        idx.append(((k[None, :] * q * stride) % n_fft).reshape(-1))
        ns *= r
    return np.concatenate(idx)


@functools.lru_cache(maxsize=64)
def _fft_table(n_fft: int, radices: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The twiddle table of the ``fir_fft`` and ``pfb`` kernels, ``[L, 2]``
    float32 ``(cos, sin)`` of the float64 phases at :func:`_fft_table_index`
    (no radices: the ``N`` entries of ``(cos, sin)(2π·k/N)``), built once per
    card."""
    ang = _phases(n_fft)[_fft_table_index(n_fft, radices)]
    tab = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    return torch.from_numpy(tab).to(device)


_FFT_RADIX = 16              # Stockham passes of radix 16, one smaller pass first


def _stockham_passes(n: int) -> Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...], int]:
    """``(radices, spans, strides, tw_len)`` of an ``n``-point transform:
    for a power of two, Stockham passes of radix 16 with one smaller pass
    first for the rest of log2(N) (8·16·16 at N = 2048), each pass's Ns (the
    product of the radices before it) and twiddle index stride N / (Ns·radix),
    and the table's length (the passes' tables hold (radix − 1)·Ns entries
    each, N − 1 in all); for any other ``n`` no passes (the direct DFT) and
    its N-entry table."""
    if n & (n - 1):
        return (), (), (), n
    bits, step = n.bit_length() - 1, _FFT_RADIX.bit_length() - 1
    rest = bits % step
    radices = ((1 << rest,) if rest else ()) + (_FFT_RADIX,) * (bits // step)
    spans, strides, ns = [], [], 1
    for r in radices:
        spans.append(ns)
        strides.append(n // (ns * r))
        ns *= r
    return radices, tuple(spans), tuple(strides), n - 1 if radices else n


@functools.lru_cache(maxsize=256)
def _fir_fft_rule(n_fft: int, n_taps: int) -> FirFftPlan:
    """The ``fir_fft`` kernel's plan for one row of ``n_fft`` samples.

    The MAC gives each thread ``outs`` consecutive filtered samples (a
    sliding register window over the staged span; 256 threads of 8 at
    N = 2048, 512 threads from N = 4096); a power-of-two ``n_fft`` then runs
    Stockham passes of radix 16 with one smaller pass first for the rest of
    log2(N) (8·16·16 at N = 2048). Where the padded layout with staged
    twiddles does not fit in shared memory, the twiddles are read from device
    memory instead, then the padding goes: the unpadded layout is the old
    kernel's size, so every shape that ran before still runs."""
    threads = min(512, max(32, n_fft // 8))
    outs = 8 if n_fft >= 8 * threads else 4
    radices, spans, strides, tw_len = _stockham_passes(n_fft)
    layouts = ((outs.bit_length() - 1, 4, True), (outs.bit_length() - 1, 4, False),
               (_NO_PAD, _NO_PAD, False))
    for span_shift, pad_shift, tw_staged in layouts:
        smem = _fir_fft_smem(n_fft, n_taps, span_shift, pad_shift,
                             tw_len if tw_staged else 0)
        if smem <= _MAX_SMEM:
            break
    return FirFftPlan(threads, outs, radices, spans, strides, tw_len,
                      span_shift, pad_shift, tw_staged, smem)


class PolyFirPlan(NamedTuple):
    """How ``csrc/poly_fir.cu`` computes ``y[q, i] = Σ_j ext[q·D + j]·W'[j, i]``
    (``J = (m+1)·D`` taps, ``W'[j, i] = W[m − j//D, j mod D, i]``). The
    tiling and its K split fix every output's order of summation
    (:func:`_same_order`); the other fields are the layout."""
    tiling: str      # "rows": I = 1, sliding window; "gemm": register tile, K split
    threads: int
    rows: int        # output rows a block ("rows": a tile, threads·R)
    tile_rows: int   # "rows": consecutive outputs a thread (R); "gemm": a tile's rows (RM)
    tile_phases: int  # "gemm": a register tile's phases (RN); "rows": 1
    ksplit: int      # "rows": the column chains (C); "gemm": the parts of J, folded in order
    pad: int         # "rows": pad slots after every R rows of a staged span
    blocks: int      # "rows": resident blocks walking the tiles, two buffers each; 0: a
                     # block a tile, one buffer ("gemm": always)
    smem: int        # dynamic shared memory per block, bytes


_ROWS_R = 4                         # "rows": consecutive outputs a thread
_ROWS_THREADS = (128, 64, 32)       # "rows": threads a block, the first that fits
_ROWS_BLOCKS_PER_SM = 2             # "rows": resident blocks a SM walking the tiles
_GEMM_THREADS, _GEMM_RM = 256, 4    # "gemm": threads a block, rows a register tile
_GEMM_TM = (64, 32, 16, 8, 4)       # "gemm": rows a block, the largest that gives 7/8 of
                                    # a block per SM
_GEMM_MIN_K = 16                    # "gemm": taps a K part at least
_GEMM_DEEP = 4                      # "gemm" lanes: blocks a SM where the batch has them


def _first_gemm(m: int, D: int, I: int, nq: int, is_complex: bool,
                n_sm: int) -> PolyFirPlan:
    """The "gemm" plan of one stream: each thread a register tile of 4 rows
    × RN phases (3 where 3 divides I, else 4, else 1) over its part of J; a
    block takes the most rows (64 … 4) that still give 7/8 of ``n_sm``
    blocks, and splits J into the most parts (a power of two of at least 16
    taps each) its 256 threads have room for; where the partials' buffer
    does not fit in shared memory the K split and then the rows shrink, down
    to one row a block (every W that ran on the kernel's first design still
    runs)."""
    elt = 8 if is_complex else 4
    rn = 3 if I % 3 == 0 else 4 if I % 4 == 0 else 1
    tm = next((t for t in _GEMM_TM if -(-nq // t) * 8 >= n_sm * 7), _GEMM_TM[-1])
    J = (m + 1) * D
    while True:
        units = -(-tm // _GEMM_RM) * -(-I // rn)
        ks = 1
        while ks * 2 * units <= _GEMM_THREADS and J // (ks * 2) >= _GEMM_MIN_K:
            ks *= 2
        while True:
            smem = _poly_fir_smem("gemm", m, D, I, tm, _GEMM_RM, ks, 0, 1, elt)
            if smem <= _MAX_SMEM or ks == 1:
                break
            ks //= 2
        if smem <= _MAX_SMEM or tm == 1:
            return PolyFirPlan("gemm", _GEMM_THREADS, tm, _GEMM_RM, rn, ks, 0, 0, smem)
        tm = max(1, tm // 2)


def _first_order(m: int, D: int, I: int, nq: int, is_complex: bool,
                 n_sm: int) -> Tuple[str, int]:
    """``(tiling, ksplit)``: the order of summation the first design's plan
    gave a one-stream call, kept at every shape (so a served lane, planned
    from the bare chain's plan, and every launch of an earlier version sum
    alike): "rows" (C column chains: 4 at D ≥ 4) where I = 1, m + 1 ≥ 8 and
    that design's 256-row span fit in shared memory, else "gemm" with
    :func:`_first_gemm`'s K split."""
    elt = 8 if is_complex else 4
    if I == 1 and m + 1 >= 8:
        c = 4 if D >= 4 else 2 if D >= 2 else 1
        lanes, banks = (16, 16) if elt == 8 else (32, 32)

        def slot(k, pad):
            return k + pad * (k // (8 * D))
        pad = next((p for p in range(32) if len({
            slot((ln // c * 8 + 7) * D + ln % c, p) % banks for ln in range(lanes)}) == lanes),
            1)
        pitch = (m + 8) // 8 * 8
        pitch += 8 if pitch % 32 == 0 else 0
        span = (128 // c * 8 + m) * D
        if 4 * D * pitch + elt * (slot(span - 1, pad) + 1) <= _MAX_SMEM:
            return "rows", c
    return "gemm", _first_gemm(m, D, I, nq, is_complex, n_sm).ksplit


def _w4(n: int) -> int:
    """Floats of a block staged ahead of samples (the kernel's ``w_slots``)."""
    return (n + 3) & ~3


def _rows_span(tq: int, m: int, D: int, R: int, pad: int) -> int:
    """Slots of a "rows" tile's span: ``tq + m`` rows of D samples, row j at
    slot ``j·D + pad·(j // R)`` (the kernel's ``rows_span``)."""
    last = tq + m - 1
    return last * D + D + pad * (last // R)


def _rows_vec(D: int, C: int, elt: int) -> int:
    """Samples of the 16-byte (or narrower) word a "rows" thread loads the C
    samples of a span row in, where C divides D; 0 where it loads them one by
    one."""
    return min(C, 16 // elt) if D % C == 0 else 0


def _rows_pad(D: int, C: int, R: int, elt: int) -> int:
    """The fewest pad slots after every R span rows that put the window loads
    of a warp on distinct banks: thread t's row t·R + b lies ``t·(R·D + pad)``
    slots after thread 0's, loaded in words of ``_rows_vec`` samples (the pad
    a multiple of them) or one sample at a time; the threads a word width
    serves together (8 for 16 bytes, 16 for 8, 32 for 4) must fall on
    distinct banks."""
    vec = _rows_vec(D, C, elt)
    width = vec * elt if vec else elt
    banks, per = width // 4, 128 // width
    for pad in range(0, 64, vec or 1):
        stride = (R * D + pad) * elt // 4
        if all(len({(t * stride + w) % 32 for t in range(t0, t0 + per)
                    for w in range(banks)}) == per * banks for t0 in range(0, 32, per)):
            return pad
    return 0


def _poly_fir_smem(tiling: str, m: int, D: int, I: int, rows: int, tile_rows: int,
                   ksplit: int, pad: int, bufs: int, elt: int) -> int:
    """Bytes of the kernel's layout: "rows", ``bufs`` tile buffers, each W
    then its padded span; "gemm", W, the span of ``rows + m`` rows and, where
    J is split, the ``ksplit`` partials of each output."""
    if tiling == "rows":
        return 4 * bufs * (_w4((m + 1) * D) +
                           _w4(_rows_span(rows, m, D, tile_rows, pad) * elt // 4))
    red = ksplit * rows * I if ksplit > 1 else 0
    return 4 * (((m + 1) * D * I + 1) & ~1) + elt * ((rows + m) * D + red)


def _rows_layout(L: int, m: int, D: int, C: int, nq: int, is_complex: bool, n_sm: int,
                 threads: Optional[int] = None, blocks: Optional[int] = None) -> PolyFirPlan:
    """The "rows" layout of C column chains over ``L`` streams of ``nq``
    rows: R = 4 rows a thread, the most threads a block (128 … 32) whose
    tiles fit in shared memory, and ``blocks`` (2 a SM) resident blocks
    walking the ``L·⌈nq / tq⌉`` tiles with two buffers where there are more
    tiles than that, else a block a tile with one buffer (``blocks`` 0);
    ``threads`` and ``blocks`` fix either instead."""
    elt, R = (8 if is_complex else 4), _ROWS_R
    pad = _rows_pad(D, C, R, elt)
    want = n_sm * _ROWS_BLOCKS_PER_SM if blocks is None else blocks
    for th in ((threads,) if threads else _ROWS_THREADS):
        tq = th * R
        for nb in (want if 0 < want < L * -(-nq // tq) else 0, 0):
            smem = _poly_fir_smem("rows", m, D, 1, tq, R, C, pad, 2 if nb else 1, elt)
            if smem <= _MAX_SMEM:
                return PolyFirPlan("rows", th, tq, R, 1, C, pad, nb, smem)
    return PolyFirPlan("rows", th, tq, R, 1, C, pad, 0, smem)


def _gemm_layout(L: int, row: PolyFirPlan, m: int, D: int, I: int, nq: int,
                 is_complex: bool, n_sm: int, tm: Optional[int] = None) -> PolyFirPlan:
    """``row``'s "gemm" layout over ``L`` streams: the most rows a block (64
    … 4) that still give ``L·⌈nq/rows⌉`` blocks ``_GEMM_DEEP`` blocks a SM
    (7/8 of them), else 7/8 of one, halved while the layout does not fit in
    shared memory; ``tm`` fixes the rows instead."""
    elt = 8 if is_complex else 4
    tm = tm or next((t for d in (_GEMM_DEEP, 1) for t in _GEMM_TM
                     if L * -(-nq // t) * 8 >= n_sm * 7 * d), _GEMM_TM[-1])
    while True:
        smem = _poly_fir_smem("gemm", m, D, I, tm, row.tile_rows, row.ksplit, 0, 1, elt)
        if smem <= _MAX_SMEM or tm == 1:
            return row._replace(rows=tm, smem=smem)
        tm = max(1, tm // 2)


@functools.lru_cache(maxsize=1024)
def _poly_fir_rule(m: int, D: int, I: int, nq: int, is_complex: bool,
                   n_sm: int = 132) -> PolyFirPlan:
    """The ``poly_fir`` kernel's plan for one call: the first design's order
    (:func:`_first_order`). "rows" (the channel filter): C = 4 column chains
    at D ≥ 4, 4 rows a thread, 128 threads a block where the tiles fit, 2
    resident blocks a SM walking them. "gemm" (the resampler, and any W the
    first "rows" span could not hold): :func:`_first_gemm`."""
    tiling, ks = _first_order(m, D, I, nq, is_complex, n_sm)
    if tiling == "rows":
        return _rows_layout(1, m, D, ks, nq, is_complex, n_sm)
    return _first_gemm(m, D, I, nq, is_complex, n_sm)


def _same_order(plan: PolyFirPlan, row: PolyFirPlan) -> bool:
    """Does ``plan`` sum every output in the order of ``row``? The tiling and
    its K split fix the order (the column chains of "rows", the parts of
    "gemm"); the rows a thread or a block, the threads, the pad and the
    resident blocks only map the outputs to threads."""
    return (plan.tiling, plan.ksplit) == (row.tiling, row.ksplit)


@functools.lru_cache(maxsize=1024)
def _poly_fir_lanes_rule(L: int, row: PolyFirPlan, m: int, D: int, I: int, nq: int,
                         is_complex: bool, n_sm: int = 132) -> PolyFirPlan:
    """The lane form's plan for ``L`` streams whose one-stream plan is
    ``row``: ``row``'s tiling and K split, so each lane sums in a one-stream
    launch's order, in the layout chosen over the batch: "rows" walks the
    lanes' tiles with 2 resident blocks a SM (the served channel filter's
    1,024 tiles at 64 sessions on 264 blocks); "gemm" takes the most rows a
    block that still give the batch 4 blocks a SM, else 7/8 of one (the FM
    resampler's 64 rows a session: 8 rows a block at 16 and 64 sessions,
    where the one-stream plan for 64 rows takes 4)."""
    if row.tiling == "rows":
        return _rows_layout(L, m, D, row.ksplit, nq, is_complex, n_sm)
    return _gemm_layout(L, row, m, D, I, nq, is_complex, n_sm)


def _poly_fir_layouts(L: int, row: PolyFirPlan, m: int, D: int, I: int, nq: int,
                      is_complex: bool, n_sm: int) -> list:
    """The layouts of ``row``'s order over ``L`` streams that the sweep
    measures: "rows" at 128 and 64 threads a block, each with 2 and 4
    resident blocks a SM and with a block a tile; "gemm" at each rows a
    block of ``_GEMM_TM``."""
    if row.tiling == "rows":
        return [_rows_layout(L, m, D, row.ksplit, nq, is_complex, n_sm, th, nb)
                for th in _ROWS_THREADS[:2] for nb in (2 * n_sm, 4 * n_sm, 0)]
    return [_gemm_layout(L, row, m, D, I, nq, is_complex, n_sm, tm) for tm in _GEMM_TM]


class FirPlan(NamedTuple):
    """How ``csrc/fir.cu`` tiles a stream: tiles of 256 outputs, one a warp at
    a time, each warp staging and filtering its tiles on its own (8 outputs a
    lane on a sliding window)."""
    threads: int         # threads per block, whole warps
    blocks: int          # each warp walks the tiles blocks·warps apart
    span_shift: int      # each span: one pad slot every 2^span_shift samples
    bufs: int            # span buffers a warp: 2 stages the next tile during the MAC
    smem: int            # dynamic shared memory per block, bytes


_FIR_OUTS = 8                # consecutive outputs a lane (the kernel's kOuts)
_FIR_WARP_OUTS = 32 * _FIR_OUTS
_FIR_WARPS = (8, 4, 2, 1)    # warps a block, largest first
_FIR_WARPS_PER_SM = 16       # above this many tiles a SM, warps walk several


def _fir_span_off(nt: int) -> int:
    """The slot shift of a ``fir`` span (the kernel's ``span_off``): every
    window's top sample ``c0 + nt − 1`` lands last in its group of 8."""
    return (_FIR_OUTS - nt % _FIR_OUTS) % _FIR_OUTS


def _fir_smem(warps: int, bufs: int, nt: int, span_shift: int, elt: int) -> int:
    """Bytes of the kernel's layout: the taps (an even number of floats), then
    ``bufs`` skewed spans of ``256 + nt − 1`` samples of ``elt`` bytes a
    warp, span index i at slot ``_skew(i + _fir_span_off(nt))``."""
    return 4 * (nt + (nt & 1)) + elt * bufs * warps * (
        _skew(_fir_span_off(nt) + _FIR_WARP_OUTS + nt - 2, span_shift) + 1)


@functools.lru_cache(maxsize=1024)
def _fir_rule(n: int, nt: int, is_complex: bool, n_sm: int = 132) -> FirPlan:
    """The ``fir`` kernel's plan for an ``n``-sample call with ``nt`` taps.

    Up to 16 warps a SM each filter one tile of 256 outputs; a longer frame
    gives each warp several tiles (2 at 2^20) and two span buffers, so the
    next tile is staged during the MAC. A block holds the most warps (8, 4,
    2, 1) that still gives ``n_sm`` blocks (4 at 2^18: 256 blocks; 8 at
    2^20). Where that does not fit in shared memory the warps halve, then a
    warp keeps one buffer, and at one warp the padding goes: one unpadded
    warp needs less than the first design's 1,024-output tile, so every tap
    count that ran before still runs."""
    elt = 8 if is_complex else 4
    tiles = -(-n // _FIR_WARP_OUTS)
    per_warp = -(-tiles // (n_sm * _FIR_WARPS_PER_SM))
    warps = -(-tiles // per_warp)
    first = next((i for i, w in enumerate(_FIR_WARPS) if -(-warps // w) >= n_sm),
                 len(_FIR_WARPS) - 1)
    pad = _FIR_OUTS.bit_length() - 1
    layouts = [(w, 2 if per_warp > 1 else 1, pad) for w in _FIR_WARPS[first:]]
    layouts += [(1, 1, pad), (1, 1, _NO_PAD)]
    for w, bufs, span_shift in layouts:
        smem = _fir_smem(w, bufs, nt, span_shift, elt)
        if smem <= _MAX_SMEM:
            break
    return FirPlan(32 * w, -(-warps // w), span_shift, bufs, smem)


_FIR_FFT_L1_ROWS = 2         # rows an SM above which the lane form reads its table via L1


@functools.lru_cache(maxsize=256)
def _fir_fft_lanes_rule(L: int, n: int, n_fft: int, n_taps: int,
                        n_sm: int = 132) -> FirFftPlan:
    """The lane form's plan for ``L`` streams of ``n`` samples (a block a
    row, the lane the grid's y): the one-stream row plan
    (:func:`_fir_fft_rule`: its radices, threads and layout, so each lane's
    arithmetic is a one-stream launch's), except that where the batch puts
    more than two rows on an SM the twiddle table is read through L1 instead
    of staged by every block: the blocks on an SM share the cached table,
    where staging copies 16 KB a row (``port_plans.py``, PERF.md: faster
    from 512 rows of 2048, slower at 256)."""
    row = _fir_fft_rule(n_fft, n_taps)
    if L * (n // n_fft) > n_sm * _FIR_FFT_L1_ROWS and row.tw_staged:
        row = row._replace(tw_staged=False, smem=_fir_fft_smem(
            n_fft, n_taps, row.span_shift, row.pad_shift, 0))
    return row


class PfbPlan(NamedTuple):
    """How ``csrc/pfb.cu`` runs a bank of ``N`` channels with ``K`` taps a
    branch over ``t`` rows."""
    window: bool         # the "window" layout; False: the "v" layout (v alone staged)
    threads: int
    chunk: int           # channels staged a step (C)
    groups: int          # row groups a block (G = threads // C at most)
    outs: int            # consecutive output rows a thread (R: 1, 4 or 8)
    rows: int            # output rows a block (G·R)
    k_regs: int          # K, with the taps in registers; 0: taps in shared memory
    radices: Tuple[int, ...]     # Stockham passes; empty: direct DFT (N not 2^k)
    spans: Tuple[int, ...]
    strides: Tuple[int, ...]
    tw_len: int          # entries of the twiddle table (_fft_table)
    pitch: int           # float2 slots between the v rows in shared memory
    pad_shift: int       # v rows: one pad slot every 2^pad_shift points
    tw_staged: bool      # twiddle table in shared memory, else read through L2
    smem: int            # dynamic shared memory per block, bytes
    blocks: int = 0      # the "walk" (a window layout): its resident blocks, 2 an SM, each
                         # walking a run of (lane, tile) pairs; 0: a block a tile


_PFB_K_REGS = 12             # the K whose taps the kernel keeps in registers
_PFB_OUTS = (8, 4, 1)        # rows a thread, largest first
_PFB_SMALL_N = 256           # up to here a block holds all N channels (256 threads)
_PFB_CHUNK = 512             # above, 512 threads stage 512 channels a step


def _pfb_pitch(n: int, pad_shift: int, radices: Tuple[int, ...]) -> int:
    """Float2 slots a v row takes: the padded row, grown where the last
    Stockham pass has nb < 16 butterflies a row until the rows a half-warp
    spans start nb banks apart (≡ nb mod 16), so its loads are conflict-free."""
    pitch = _skew(n - 1, pad_shift) + 1
    nb = n // radices[-1] if radices else 16
    if nb < 16:
        pitch += (nb - pitch) % 16
    return pitch


def _pfb_smem(n: int, k: int, rows: int, chunk: int, n_pass: int, pitch: int,
              tw_staged_len: int, k_regs: int) -> int:
    """Bytes of the "window" layout: the v rows, a second buffer holding the
    chunk staging buffers (two where the channels take several chunks, else
    one) and then (with two passes or more) a Stockham buffer, the staged
    twiddles, and without ``k_regs`` the taps' chunk buffers."""
    bufs = 2 if n > chunk else 1
    w = max(bufs * (rows + k - 1) * chunk, rows * pitch if n_pass >= 2 else 0)
    return 8 * (rows * pitch + w + tw_staged_len) + (0 if k_regs else 4 * bufs * k * chunk)


_PFB_WALK_PER_SM = 2         # the walk's resident blocks an SM (its __launch_bounds__)
_PFB_WALK_STAGES = 3         # its ring (kWalkStages): the tile read, the one before, one ahead
_PFB_WALK_R = 8              # its rows a thread (kWalkR)


def _pfb_walk_smem(n: int, k: int, rows: int, pitch: int, tw_staged_len: int) -> int:
    """Bytes of the "walk" layout: the ring's mbarriers (16-byte aligned),
    its slots of ``k − 1 + rows`` rows of ``n`` samples, the v rows, the
    Stockham buffer and the staged twiddles."""
    S = _PFB_WALK_STAGES
    return 16 * -(-S // 2) + 8 * (S * (k - 1 + rows) * n + 2 * rows * pitch + tw_staged_len)


def _pfb_walks(plan: PfbPlan, n: int, k: int) -> bool:
    """Can a window plan take the walk? One chunk of an even ``n`` (a row
    is whole 16-byte words), 256 threads, R = 8, the taps in registers, the
    halo (``k − 1`` rows) inside one tile, and two Stockham passes whose
    last one's butterflies fit half the block, which runs them beside the
    next tile's MAC on the other half (PFB-64: 32 rows × 4; N = 32 too; N =
    128 too, but two of its blocks do not fit an SM: :func:`_pfb_walk`)."""
    return (plan.window and plan.chunk == n and n % 2 == 0 and plan.threads == 256
            and plan.outs == _PFB_WALK_R and bool(plan.k_regs) and k - 1 <= plan.rows
            and len(plan.radices) == 2 and plan.groups % 2 == 0
            and plan.rows * (n // plan.radices[-1]) <= plan.threads // 2)


def _pfb_walk(plan: PfbPlan, n: int, k: int, n_sm: int) -> Optional[PfbPlan]:
    """``plan`` as the walk, 2 resident blocks an SM, or None where two of
    its blocks do not fit an SM's shared memory (228 KB, 1 KB of it kept a
    block)."""
    walk = plan._replace(blocks=_PFB_WALK_PER_SM * n_sm, smem=_pfb_walk_smem(
        n, k, plan.rows, plan.pitch, plan.tw_len if plan.tw_staged else 0))
    return walk if _PFB_WALK_PER_SM * (walk.smem + 1024) <= _SM_SMEM else None


@functools.lru_cache(maxsize=1024)
def _pfb_rule(n: int, k: int, t: int, n_sm: int = 132) -> PfbPlan:
    """The ``pfb`` kernel's plan for ``t`` rows of ``n`` channels, ``k`` taps
    a branch.

    "window": up to N = 256 a block of 256 threads holds all channels in
    256 // N row groups; above, 512 threads walk the channels 512 at a time,
    one row group. Each thread computes R consecutive rows, R the largest of
    8, 4, 1 that still gives ``n_sm`` blocks (PFB-64: R = 4 at 2^18, 16 rows
    a block, 256 blocks; R = 8 at 2^21; PFB-2048 at 2^18: R = 1, 128 blocks).
    Where the layout does not fit, R shrinks, then the twiddles are read
    from device memory, then the padding goes; where it still does not fit,
    the "v" layout (the first design's unstaged mode, v alone in shared
    memory, N ≤ 29,056) takes the row."""
    radices, spans, strides, tw_len = _stockham_passes(n)
    threads = _PFB_SMALL_N if n <= _PFB_SMALL_N else _PFB_CHUNK
    chunk = min(n, threads)
    groups = threads // chunk
    k_regs = k if k == _PFB_K_REGS else 0
    first = next((i for i, r in enumerate(_PFB_OUTS) if -(-t // (groups * r)) >= n_sm),
                 len(_PFB_OUTS) - 1)
    for pad_shift, tw_staged in ((4, True), (4, False), (_NO_PAD, False)):
        pitch = _pfb_pitch(n, pad_shift, radices)
        for outs in _PFB_OUTS[first:]:
            rows = groups * outs
            smem = _pfb_smem(n, k, rows, chunk, len(radices), pitch,
                             tw_len if tw_staged else 0, k_regs)
            if smem <= _MAX_SMEM:
                return PfbPlan(True, threads, chunk, groups, outs, rows, k_regs, radices,
                               spans, strides, tw_len, pitch, pad_shift, tw_staged, smem)
    return PfbPlan(False, 256, n, 1, 1, 1, 0, (), (), (), n, n, _NO_PAD, False, 8 * n)


def _pfb_same_values(plan: PfbPlan, row: PfbPlan) -> bool:
    """Does ``plan`` compute every output's bits as ``row`` does? The layout
    (window or v) and the radices fix them; R, the tile, the pad, the taps'
    place, the staging of the twiddles and the walk (a window layout whose
    blocks walk the tiles, staging each row once) only cut the work among
    threads."""
    return (plan.window, plan.radices) == (row.window, row.radices)


@functools.lru_cache(maxsize=1024)
def _pfb_lanes_rule(L: int, row: PfbPlan, n: int, k: int, t: int,
                    n_sm: int = 132, aligned: bool = True) -> PfbPlan:
    """The lane form's plan for ``L`` streams of ``t`` rows whose one-stream
    plan is ``row``: :func:`_pfb_rule` at the batch's ``L·t`` rows, which picks
    R and the tile so that the batch, not one stream, fills the card (PFB-64 at
    64 × 512 rows: R = 8, 32 rows a tile, where one stream's 512 rows take R =
    1), where it keeps ``row``'s layout and radices; else ``row`` (the v
    layout, one row a block, has nothing to choose). Where that window plan
    walks (:func:`_pfb_walks`) and every lane's rows of hist and x start
    16-byte aligned (``aligned``), the walk: 2 resident blocks an SM over a
    ring of 3 slots (PFB-64 at both served shapes); else a block a tile (N
    above 256, other taps than 12, one pass, a misaligned lane stride, a
    batch whose rule keeps R below 8)."""
    rule = _pfb_rule(n, k, L * t, n_sm)
    if not _pfb_same_values(rule, row):
        return row
    walk = _pfb_walk(rule, n, k, n_sm) if aligned and _pfb_walks(rule, n, k) else None
    return walk or rule


ROTATOR_TILE = 512   # samples a block of csrc/rotator.cu takes: 256 threads, one
                     # 16-byte word (two samples) each
QUAD_DEMOD_TILE = 256    # samples a block of csrc/quad_demod.cu takes, one a thread


class FixedPlan(NamedTuple):
    """The one layout of ``rotator`` and ``quad_demod`` (a sweep records it)."""
    threads: int
    tile: int                    # samples a block


_ROTATOR_PLAN = FixedPlan(256, ROTATOR_TILE)
_QUAD_DEMOD_PLAN = FixedPlan(256, QUAD_DEMOD_TILE)


# ---------------------------------------------------------------------------
# the tuned-plan table: a sweep's measured winners (tpu/kernel_tune.py), the
# counterpart of the JAX package's DEFAULT_BLOCKS / set_tuned_blocks
# ---------------------------------------------------------------------------

#: the kernels whose plans a sweep measures
PLAN_KERNELS = ("fir", "fir_fft", "poly_fir", "pfb", "rotator", "quad_demod", "fir_lanes",
                "fir_fft_lanes", "poly_fir_lanes", "pfb_lanes")
_PLAN_TYPES = {"fir": FirPlan, "fir_fft": FirFftPlan, "poly_fir": PolyFirPlan,
               "pfb": PfbPlan, "rotator": FixedPlan, "quad_demod": FixedPlan,
               "fir_lanes": FirPlan, "fir_fft_lanes": FirFftPlan,
               "poly_fir_lanes": PolyFirPlan, "pfb_lanes": PfbPlan}
#: each kernel's shape: the arguments of its plan function
PLAN_SHAPES = {"fir": ("n", "nt", "is_complex", "n_sm"), "fir_fft": ("n_fft", "n_taps"),
               "poly_fir": ("m", "D", "I", "nq", "is_complex", "n_sm"),
               "pfb": ("n", "k", "t", "n_sm"), "rotator": ("n",), "quad_demod": ("n",),
               "fir_lanes": ("L", "n", "nt", "is_complex", "n_sm"),
               "fir_fft_lanes": ("L", "n", "n_fft", "n_taps", "n_sm"),
               "poly_fir_lanes": ("L", "m", "D", "I", "nq", "is_complex", "n_sm"),
               "pfb_lanes": ("L", "n", "k", "t", "n_sm")}
_tuned_lock = threading.Lock()
_tuned: Dict[str, Dict[tuple, tuple]] = {}     # kernel -> {shape: plan}
#: the plan of each kernel's latest launch (a recorded plan reaches the kernel)
last_plans: Dict[str, tuple] = {}


def _as_tuple(v):
    return tuple(_as_tuple(e) for e in v) if isinstance(v, (list, tuple)) else v


def plan_candidates(kernel: str, *shape) -> list:
    """Every layout ``kernel`` takes at ``shape`` (its plan function's
    arguments), the rule's own pick first: the layouts the plan function
    chooses between, each within the card's shared memory."""
    shape = tuple(int(v) for v in shape)
    if kernel == "fir":
        n, nt, cplx, n_sm = shape
        out = [_fir_rule(n, nt, bool(cplx), n_sm)]
        elt, tiles = (8 if cplx else 4), -(-n // _FIR_WARP_OUTS)
        pad = _FIR_OUTS.bit_length() - 1
        for w in _FIR_WARPS:
            for per_warp, bufs in ((1, 1), (2, 1), (2, 2)):
                out.append(FirPlan(32 * w, -(-tiles // (w * per_warp)), pad, bufs,
                                   _fir_smem(w, bufs, nt, pad, elt)))
        out.append(FirPlan(32, tiles, _NO_PAD, 1, _fir_smem(1, 1, nt, _NO_PAD, elt)))
    elif kernel == "fir_fft":
        n_fft, nt = shape
        rule = _fir_fft_rule(n_fft, nt)
        out = [rule]
        for span_shift, pad_shift, staged in (
                (rule.outs.bit_length() - 1, 4, True), (rule.outs.bit_length() - 1, 4, False),
                (_NO_PAD, _NO_PAD, False)):
            out.append(rule._replace(
                span_shift=span_shift, pad_shift=pad_shift, tw_staged=staged,
                smem=_fir_fft_smem(n_fft, nt, span_shift, pad_shift,
                                   rule.tw_len if staged else 0)))
    elif kernel == "poly_fir":
        m, D, I, nq, cplx, n_sm = shape
        rule = _poly_fir_rule(m, D, I, nq, bool(cplx), n_sm)
        out = [rule]
        if rule.tiling == "rows":
            out += _poly_fir_layouts(1, rule, m, D, I, nq, bool(cplx), n_sm)
        # the gemm tiling at each rows a block, with that rule's K split and
        # unsplit (other orders, but for the rule's own)
        elt, rn = (8 if cplx else 4), 3 if I % 3 == 0 else 4 if I % 4 == 0 else 1
        J = (m + 1) * D
        for tm in _GEMM_TM:
            units = -(-tm // _GEMM_RM) * -(-I // rn)
            ks = 1
            while ks * 2 * units <= _GEMM_THREADS and J // (ks * 2) >= _GEMM_MIN_K:
                ks *= 2
            for k in sorted({ks, 1}):
                out.append(PolyFirPlan("gemm", _GEMM_THREADS, tm, _GEMM_RM, rn, k, 0, 0,
                                       _poly_fir_smem("gemm", m, D, I, tm, _GEMM_RM, k, 0, 1,
                                                      elt)))
    elif kernel == "pfb":
        n, k, t, n_sm = shape
        rule = _pfb_rule(n, k, t, n_sm)
        out = [rule]
        if rule.window:
            for pad_shift, staged in ((4, True), (4, False), (_NO_PAD, False)):
                pitch = _pfb_pitch(n, pad_shift, rule.radices)
                for outs in _PFB_OUTS:
                    for k_regs in sorted({rule.k_regs, 0}):
                        rows = rule.groups * outs
                        out.append(rule._replace(
                            outs=outs, rows=rows, k_regs=k_regs, pitch=pitch,
                            pad_shift=pad_shift, tw_staged=staged,
                            smem=_pfb_smem(n, k, rows, rule.chunk, len(rule.radices),
                                           pitch, rule.tw_len if staged else 0, k_regs)))
        out.append(PfbPlan(False, 256, n, 1, 1, 1, 0, (), (), (), n, n, _NO_PAD, False,
                           8 * n))
    elif kernel == "fir_lanes":
        # the one-stream layouts for a lane's n samples, the lane the grid's y
        L, n, nt, cplx, n_sm = shape
        out = plan_candidates("fir", n, nt, cplx, n_sm)
    elif kernel == "fir_fft_lanes":
        L, n, n_fft, nt, n_sm = shape
        out = [_fir_fft_lanes_rule(L, n, n_fft, nt, n_sm)] + plan_candidates("fir_fft", n_fft,
                                                                              nt)
    elif kernel == "poly_fir_lanes":
        # the one-stream plan's order in every layout, the batch rule's first
        L, m, D, I, nq, cplx, n_sm = shape
        row = _poly_fir_rule(m, D, I, nq, bool(cplx), n_sm)
        out = [_poly_fir_lanes_rule(L, row, m, D, I, nq, bool(cplx), n_sm), row] + \
            _poly_fir_layouts(L, row, m, D, I, nq, bool(cplx), n_sm)
    elif kernel == "pfb_lanes":
        # the one-stream layouts that compute a lane's bits as the rule's
        # plan, then the walk of each padded, staged one of them that takes
        # it and fits
        L, n, k, t, n_sm = shape
        row = _pfb_rule(n, k, t, n_sm)
        rule = _pfb_lanes_rule(L, row, n, k, t, n_sm)
        same = [p for p in plan_candidates("pfb", n, k, t, n_sm) if _pfb_same_values(p, row)]
        out = [rule] + same
        for p in same:
            if p.tw_staged and p.pad_shift != _NO_PAD and _pfb_walks(p, n, k):
                out += [w] if (w := _pfb_walk(p, n, k, n_sm)) else []
    elif kernel == "rotator":
        out = [_ROTATOR_PLAN]
    elif kernel == "quad_demod":
        out = [_QUAD_DEMOD_PLAN]
    else:
        raise ValueError(f"unknown kernel {kernel!r} (expected one of {PLAN_KERNELS})")
    seen, uniq = set(), []
    for p in out:
        if getattr(p, "smem", 0) <= _MAX_SMEM and p not in seen:
            seen.add(p)
            uniq.append(p)
    return uniq


def normalize_plans(table) -> Dict[str, Dict[tuple, tuple]]:
    """The valid part of a plan table ``{kernel: {shape: plan}}`` (shapes as
    tuples or comma-joined strings, plans as tuples or JSON lists): an
    unknown kernel, a shape of the wrong arity or a plan that is not one of
    :func:`plan_candidates` at its shape is dropped. Raises nothing."""
    out: Dict[str, Dict[tuple, tuple]] = {}
    try:
        items = dict(table or {}).items()
    except (TypeError, ValueError):
        return out
    for kn, shapes in items:
        if kn not in _PLAN_TYPES:
            continue
        try:
            shape_items = dict(shapes).items()
        except (TypeError, ValueError):
            continue
        for shape, plan in shape_items:
            try:
                if isinstance(shape, str):
                    shape = tuple(int(v) for v in shape.split(","))
                shape = tuple(int(v) for v in shape)
                if len(shape) != len(PLAN_SHAPES[kn]):
                    continue
                plan = _PLAN_TYPES[kn](*_as_tuple(plan))
                if plan in plan_candidates(kn, *shape):
                    out.setdefault(kn, {})[shape] = plan
            except (TypeError, ValueError):
                continue
    return out


def plans_to_json(table) -> Dict[str, Dict[str, list]]:
    """A plan table in its cache form: shapes comma-joined, plans as lists."""
    def lst(v):
        return [lst(e) for e in v] if isinstance(v, tuple) else v
    return {kn: {",".join(str(int(v)) for v in shape): lst(tuple(plan))
                 for shape, plan in shapes.items()}
            for kn, shapes in normalize_plans(table).items()}


def set_tuned_plans(table) -> None:
    """Install measured plans process-wide (``None``/``{}`` clears); the part
    :func:`normalize_plans` drops is ignored, never raised."""
    good = normalize_plans(table)
    with _tuned_lock:
        _tuned.clear()
        _tuned.update(good)


def tuned_plans() -> Dict[str, Dict[tuple, tuple]]:
    """The installed table (the rules fill every shape it does not hold)."""
    with _tuned_lock:
        return {k: dict(v) for k, v in _tuned.items()}


def _tuned_plan(kernel: str, shape: tuple):
    hit = _tuned.get(kernel)
    return None if hit is None else hit.get(shape)


def fir_plan(n: int, nt: int, is_complex: bool, n_sm: int = 132) -> FirPlan:
    """The ``fir`` plan of a call: the tuned table's, else :func:`_fir_rule`."""
    return _tuned_plan("fir", (n, nt, int(is_complex), n_sm)) or \
        _fir_rule(n, nt, is_complex, n_sm)


def fir_fft_plan(n_fft: int, n_taps: int) -> FirFftPlan:
    """The ``fir_fft`` plan: the tuned table's, else :func:`_fir_fft_rule`."""
    return _tuned_plan("fir_fft", (n_fft, n_taps)) or _fir_fft_rule(n_fft, n_taps)


def fir_lanes_plan(L: int, n: int, nt: int, is_complex: bool,
                   n_sm: int = 132) -> FirPlan:
    """The ``fir_lanes`` plan of a batch: the tuned table's, else
    :func:`_fir_rule`'s plan for one lane's ``n`` samples, run on every lane
    (its ``blocks`` a lane, the lane the grid's y)."""
    return _tuned_plan("fir_lanes", (L, n, nt, int(is_complex), n_sm)) or \
        _fir_rule(n, nt, is_complex, n_sm)


def fir_fft_lanes_plan(L: int, n: int, n_fft: int, n_taps: int,
                       n_sm: int = 132) -> FirFftPlan:
    """The ``fir_fft_lanes`` plan of a batch: the tuned table's, else
    :func:`_fir_fft_lanes_rule`."""
    return _tuned_plan("fir_fft_lanes", (L, n, n_fft, n_taps, n_sm)) or \
        _fir_fft_lanes_rule(L, n, n_fft, n_taps, n_sm)


def poly_fir_plan(m: int, D: int, I: int, nq: int, is_complex: bool,
                  n_sm: int = 132) -> PolyFirPlan:
    """The ``poly_fir`` plan: the tuned table's, else :func:`_poly_fir_rule`."""
    return _tuned_plan("poly_fir", (m, D, I, nq, int(is_complex), n_sm)) or \
        _poly_fir_rule(m, D, I, nq, is_complex, n_sm)


def poly_fir_lanes_plan(L: int, m: int, D: int, I: int, nq: int, is_complex: bool,
                        n_sm: int = 132) -> PolyFirPlan:
    """The ``poly_fir_lanes`` plan of a batch: the tuned table's where it
    sums in the order of a lane's one-stream plan (:func:`poly_fir_plan`,
    which the bare chain launches), else :func:`_poly_fir_lanes_rule` on that
    plan, so a served lane stays bit-equal to the bare chain whatever either
    table holds."""
    row = poly_fir_plan(m, D, I, nq, is_complex, n_sm)
    tuned = _tuned_plan("poly_fir_lanes", (L, m, D, I, nq, int(is_complex), n_sm))
    if tuned is not None and _same_order(tuned, row):
        return tuned
    return _poly_fir_lanes_rule(L, row, m, D, I, nq, is_complex, n_sm)


def pfb_plan(n: int, k: int, t: int, n_sm: int = 132) -> PfbPlan:
    """The ``pfb`` plan: the tuned table's, else :func:`_pfb_rule`."""
    return _tuned_plan("pfb", (n, k, t, n_sm)) or _pfb_rule(n, k, t, n_sm)


def pfb_lanes_plan(L: int, n: int, k: int, t: int, n_sm: int = 132,
                   aligned: bool = True) -> PfbPlan:
    """The ``pfb_lanes`` plan of ``L`` streams of ``t`` rows: the tuned
    table's where it computes a lane's bits as the one-stream plan at ``t``
    does (:func:`pfb_plan`, which the bare chain launches: the same layout and
    radices), else :func:`_pfb_lanes_rule` on that plan, so a served lane stays
    bit-equal to the bare chain whatever either table holds. ``aligned``:
    every lane's rows of hist and x start 16-byte aligned (else no walk)."""
    row = pfb_plan(n, k, t, n_sm)
    tuned = _tuned_plan("pfb_lanes", (L, n, k, t, n_sm))
    if tuned is not None and _pfb_same_values(tuned, row) and (aligned or not tuned.blocks):
        return tuned
    return _pfb_lanes_rule(L, row, n, k, t, n_sm, aligned)


def _stream_head(x: torch.Tensor) -> int:
    """Scalar samples of a complex64 frame before its first 16-byte boundary."""
    ptr = x.data_ptr()
    if ptr % 8:
        raise ValueError("the CUDA kernels need complex64 tensors 8-byte aligned")
    return (ptr >> 3) & 1 if x.shape[0] else 0


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _lib(name: str):
    from . import _build
    lib = _build.load(name)
    if not getattr(lib, "_fsdr_typed", False):
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        if name == "fir":
            lib.fsdr_fir.argtypes = [vp, vp, vp, vp, ll, i, i, ctypes.POINTER(i), ll, vp]
            lib.fsdr_fir.restype = i
            lib.fsdr_fir_lanes.argtypes = [vp, vp, vp, vp, ll, i, i, ctypes.POINTER(i), ll,
                                           i, ll, ll, ll, ll, vp]
            lib.fsdr_fir_lanes.restype = i
        elif name == "fir_fft":
            lib.fsdr_fir_fft.argtypes = [vp, vp, vp, vp, i, vp, ll, i, i, i, i, i, i, i,
                                         ctypes.POINTER(i), i, i, i, ll, vp]
            lib.fsdr_fir_fft.restype = i
            lib.fsdr_fir_fft_lanes.argtypes = [vp, vp, vp, vp, i, vp, ll, i, i, i, i, i, i,
                                               i, ctypes.POINTER(i), i, i, i, ll, i, ll, ll,
                                               ll, ll, vp]
            lib.fsdr_fir_fft_lanes.restype = i
        elif name == "rotator":
            lib.fsdr_rotator.argtypes = [vp, vp, vp, vp, vp, ll, i, vp]
            lib.fsdr_rotator.restype = i
            lib.fsdr_rotator_lanes.argtypes = [vp, vp, vp, vp, vp, ll, i, i, ll, vp]
            lib.fsdr_rotator_lanes.restype = i
        elif name == "poly_fir":
            lib.fsdr_poly_fir.argtypes = [vp, vp, vp, vp, ll, i, i, i, i, i, i, i, i, i,
                                          i, i, i, i, i, ll, vp]
            lib.fsdr_poly_fir.restype = i
            lib.fsdr_poly_fir_lanes.argtypes = [vp, vp, vp, vp, ll, i, i, i, i, i, i, i, i, i,
                                                i, i, i, i, i, ll, i, ll, ll, ll, ll, vp]
            lib.fsdr_poly_fir_lanes.restype = i
        elif name == "pfb":
            lib.fsdr_pfb.argtypes = [vp, vp, vp, ll, ll, vp, vp, ll, i, i, i,
                                     ctypes.POINTER(i), ll, vp]
            lib.fsdr_pfb.restype = i
            lib.fsdr_pfb_lanes.argtypes = [vp, vp, vp, ll, ll, vp, vp, ll, i, i, i,
                                           ctypes.POINTER(i), ll, i, ll, ll, ll, ll, vp]
            lib.fsdr_pfb_lanes.restype = i
        else:
            lib.fsdr_quad_demod.argtypes = [vp, vp, vp, vp, ll, ctypes.c_float, vp]
            lib.fsdr_quad_demod.restype = i
            lib.fsdr_quad_demod_lanes.argtypes = [vp, vp, vp, vp, ll, ctypes.c_float, i, ll,
                                                  ll, vp]
            lib.fsdr_quad_demod_lanes.restype = i
        lib._fsdr_typed = True
    return lib


@functools.lru_cache(maxsize=64)
def _c_ints(values: Tuple[int, ...]):
    """``values`` as a C int array (one element at least), built once."""
    return (ctypes.c_int * max(1, len(values)))(*values)


_CURRENT = contextlib.nullcontext()


def _card(x: torch.Tensor):
    """A context that makes ``x``'s card the current one for a launch (the
    kernels launch on the current card); nothing to do where it is already."""
    idx = x.device.index
    return _CURRENT if idx == torch.cuda.current_device() else torch.cuda.device(idx)


def _stream(x: torch.Tensor) -> int:
    """The raw current CUDA stream of ``x``'s card."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


_sm_counts: Dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    n = _sm_counts.get(idx)
    if n is None:
        n = _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return n


def _launch_fir(hist: Optional[torch.Tensor], x: torch.Tensor, taps: torch.Tensor,
                bf16: bool, plan: Optional[FirPlan] = None) -> torch.Tensor:
    _check_cuda(*(t for t in (hist, x, taps) if t is not None))
    nt = int(taps.shape[0])
    if x.shape[0] == 0:
        return torch.empty_like(x)          # nothing to launch
    if plan is None:
        plan = fir_plan(x.shape[0], nt, x.is_complex(), _sm_count(x.device))
    last_plans["fir"] = plan
    if plan.smem > _MAX_SMEM:
        raise ValueError(f"fir: {nt} taps need {plan.smem} B of shared memory per "
                         f"block, over the card's {_MAX_SMEM} B")
    lib = _lib("fir")
    y = torch.empty_like(x)
    with _card(x):
        err = lib.fsdr_fir(None if hist is None else hist.data_ptr(), x.data_ptr(),
                           taps.data_ptr(), y.data_ptr(), x.shape[0], nt,
                           x.is_complex() | bf16 << 1, _c_ints(plan[:4]), plan.smem,
                           _stream(x))
    _raise_on(err, "fir")
    _count("fir")
    return y


def fir(x: torch.Tensor, taps: torch.Tensor,
        precision: Optional[str] = None, plan: Optional[FirPlan] = None) -> torch.Tensor:
    """Causal FIR of a 1-D float32 or complex64 stream from a zero initial
    state; real float32 taps. Any frame length. ``plan`` (one of
    :func:`plan_candidates`) beats the tuned table and the rule."""
    if _batched(x, taps):
        return torch.ops.fsdr.fir(x, taps, precision)
    if x.device.type == "cpu":
        return fir_plain(x, taps, precision)
    bf16 = _check_precision(precision)
    _check_args(None, x, taps)
    return _launch_fir(None, x, taps, bf16, plan)


def fir_continue(hist: torch.Tensor, x: torch.Tensor, taps: torch.Tensor,
                 precision: Optional[str] = None,
                 plan: Optional[FirPlan] = None) -> torch.Tensor:
    """Streaming continuation: filter ``x`` given the previous ``n_taps − 1``
    input samples in ``hist``; returns ``len(x)`` outputs. The taps may come
    from a stage carry, so a retune reaches the kernel."""
    if _batched(hist, x, taps):
        return torch.ops.fsdr.fir_continue(hist, x, taps, precision)
    if x.device.type == "cpu":
        return fir_continue_plain(hist, x, taps, precision)
    bf16 = _check_precision(precision)
    _check_args(hist, x, taps)
    return _launch_fir(hist, x, taps, bf16, plan)


def fir_fft(hist: torch.Tensor, x: torch.Tensor, taps: torch.Tensor, n_fft: int,
            precision: Optional[str] = None,
            plan: Optional[FirFftPlan] = None) -> torch.Tensor:
    """Fused FIR → forward FFT: ``fft(filtered.reshape(-1, n_fft))`` flattened,
    with ``filtered`` the causal FIR of ``x`` after ``hist`` (the previous
    ``n_taps − 1`` samples). Real taps, ``2 ≤ n_taps ≤ n_fft``, ``len(x)`` a
    multiple of ``n_fft``; any ``n_fft`` (a power of two takes the FFT, any
    other size a direct DFT). Returns complex64."""
    if _batched(hist, x, taps):
        return torch.ops.fsdr.fir_fft(hist, x, taps, int(n_fft), precision)
    if x.device.type == "cpu":
        return fir_fft_plain(hist, x, taps, n_fft, precision)
    bf16 = _check_precision(precision)
    nt = _check_fir_fft(hist, x, taps, n_fft)
    _check_cuda(hist, x, taps)
    plan = plan or fir_fft_plan(n_fft, nt)
    if plan.smem > _MAX_SMEM:
        raise ValueError(f"fir_fft: n_fft={n_fft} with {nt} taps needs {plan.smem} B "
                         f"of shared memory per block, over the card's {_MAX_SMEM} B")
    if x.shape[0] == 0:
        return torch.empty(0, dtype=torch.complex64, device=x.device)   # nothing to launch
    return _launch_fir_fft(hist, x, taps, n_fft, bf16, plan)


def _launch_fir_fft(hist: torch.Tensor, x: torch.Tensor, taps: torch.Tensor, n_fft: int,
                    bf16: bool, plan: FirFftPlan) -> torch.Tensor:
    nt = int(taps.shape[0])
    last_plans["fir_fft"] = plan
    tw = _fft_table(n_fft, plan.radices, x.device)
    lib = _lib("fir_fft")
    y = torch.empty(x.shape[0], dtype=torch.complex64, device=x.device)
    with _card(x):
        err = lib.fsdr_fir_fft(hist.data_ptr(), x.data_ptr(), taps.data_ptr(),
                               tw.data_ptr(), tw.shape[0], y.data_ptr(),
                               x.shape[0] // n_fft, n_fft, nt, int(x.is_complex()),
                               int(bf16), plan.threads,
                               plan.outs, len(plan.radices), _c_ints(plan.radices),
                               plan.span_shift, plan.pad_shift, int(plan.tw_staged),
                               plan.smem, _stream(x))
    _raise_on(err, "fir_fft")
    _count("fir_fft")
    return y


def rotator(x: torch.Tensor, ph0: torch.Tensor,
            inc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase-ramp rotator ``y[t] = x[t]·exp(i·(ph0 + inc·t))`` of a 1-D
    complex64 frame; ``ph0`` and ``inc`` are one-element float32 tensors on
    the frame's device (the stage carry), read by the kernel on the device.
    Returns ``(y, ph_next)``, ``ph_next = remainder(ph0 + inc·n, 2π)`` in
    float32, a tensor of its own written by the same launch (also for an
    empty frame). ``y`` starts at the same offset from a 16-byte boundary as
    ``x``: a view ``x[1:]`` gives a view of a buffer one sample longer."""
    if _batched(x, ph0, inc):
        return torch.ops.fsdr.rotator(x, ph0, inc)
    if x.device.type == "cpu":
        return rotator_plain(x, ph0, inc)
    _check_rotator(x, ph0, inc)
    _check_cuda(x, ph0, inc)
    n = x.shape[0]
    head = _stream_head(x)
    y = torch.empty_like(x) if head == 0 else \
        torch.empty(n + 1, dtype=torch.complex64, device=x.device)[1:]
    ph_next = torch.empty((), dtype=torch.float32, device=x.device)
    lib = _lib("rotator")
    with _card(x):
        err = lib.fsdr_rotator(x.data_ptr(), ph0.data_ptr(), inc.data_ptr(), y.data_ptr(),
                               ph_next.data_ptr(), n, head, _stream(x))
    _raise_on(err, "rotator")
    _count("rotator")
    last_plans["rotator"] = _ROTATOR_PLAN
    return y, ph_next


def quad_demod(prev: torch.Tensor, x: torch.Tensor,
               gain: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quadrature demod ``y[t] = gain·angle(x[t]·conj(x[t−1]))`` of a 1-D
    complex64 frame, ``x[−1]`` being ``prev`` (one complex64 sample, the
    stage carry). Returns ``(y float32, x[n−1])``; the second is a tensor of
    its own (``prev`` again for an empty frame), the stage's next carry."""
    if _batched(prev, x):
        return torch.ops.fsdr.quad_demod(prev, x, float(gain))
    if x.device.type == "cpu":
        return quad_demod_plain(prev, x, gain)
    _check_quad_demod(prev, x)
    _check_cuda(prev, x)
    y = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    if x.shape[0] == 0:
        return y, prev.reshape(()).clone()  # nothing to launch
    last = torch.empty((), dtype=torch.complex64, device=x.device)
    lib = _lib("quad_demod")
    with _card(x):
        err = lib.fsdr_quad_demod(x.data_ptr(), prev.data_ptr(), y.data_ptr(),
                                  last.data_ptr(), x.shape[0], float(gain), _stream(x))
    _raise_on(err, "quad_demod")
    _count("quad_demod")
    last_plans["quad_demod"] = _QUAD_DEMOD_PLAN
    return y, last


def poly_fir(hist: torch.Tensor, x: torch.Tensor, W: torch.Tensor,
             precision: Optional[str] = None,
             plan: Optional[PolyFirPlan] = None) -> torch.Tensor:
    """Polyphase decimating FIR at the decimated rate: with
    ``rows = cat([hist, x]).reshape(-1, D)``, ``y[q] = Σ_a rows[q+m−a]·W[a]``.
    ``W``: real ``[m+1, D]`` (returns ``[nq]``) or ``[m+1, D, I]`` (the
    resampler's phase taps; returns ``[nq, I]``), float32 or bfloat16;
    ``hist``: the previous ``m·D`` samples; ``x``: ``nq·D`` float32 or
    complex64 samples, a complex stream filtered in one pass. The output has
    the stream's dtype."""
    if _batched(hist, x, W):
        return torch.ops.fsdr.poly_fir(hist, x, W, precision)
    if x.device.type == "cpu":
        return poly_fir_plain(hist, x, W, precision)
    bf16 = _check_precision(precision)
    m, D, I, nq = _check_poly_fir(hist, x, W)
    _check_cuda(hist, x, W)
    shape = (nq, I) if W.dim() == 3 else (nq,)
    y = torch.empty(shape, dtype=x.dtype, device=x.device)
    if nq == 0:
        return y                            # nothing to launch
    plan = plan or poly_fir_plan(m, D, I, nq, x.is_complex(), _sm_count(x.device))
    if plan.smem > _MAX_SMEM:
        raise ValueError(f"poly_fir: W {tuple(W.shape)} needs {plan.smem} B of shared "
                         f"memory per block, over the card's {_MAX_SMEM} B")
    return _launch_poly_fir(hist, x, W, y, bf16, plan)


def _launch_poly_fir(hist: torch.Tensor, x: torch.Tensor, W: torch.Tensor, y: torch.Tensor,
                     bf16: bool, plan: PolyFirPlan) -> torch.Tensor:
    m, D = int(W.shape[0]) - 1, int(W.shape[1])
    I = int(W.shape[2]) if W.dim() == 3 else 1
    last_plans["poly_fir"] = plan
    lib = _lib("poly_fir")
    with _card(x):
        err = lib.fsdr_poly_fir(hist.data_ptr(), x.data_ptr(), W.data_ptr(),
                                y.data_ptr(), x.shape[0] // D, m, D, I,
                                int(x.is_complex()), int(bf16),
                                int(W.dtype == torch.bfloat16), int(plan.tiling == "gemm"),
                                plan.threads, plan.rows, plan.tile_rows, plan.tile_phases,
                                plan.ksplit, plan.pad, plan.blocks, plan.smem, _stream(x))
    _raise_on(err, "poly_fir")
    _count("poly_fir")
    return y


def pfb(hist: torch.Tensor, x: torch.Tensor, taps: torch.Tensor,
        precision: Optional[str] = None, plan: Optional[PfbPlan] = None) -> torch.Tensor:
    """Critically sampled PFB analysis bank: with ``ext = cat([hist, x])`` and
    the commutated rows ``rows[s, c] = ext[s·N + N−1−c]``, the branch MAC
    ``v[s, c] = Σ_k taps[k, c]·rows[s+K−1−k, c]`` and the IDFT across branches
    without 1/N, ``y[s, c'] = Σ_c v[s, c]·exp(+2πi·c·c'/N)``. ``taps``: real
    ``[K, N]`` float32 or bfloat16, any strides (the stage passes its
    ``[N, K]`` carry transposed); ``hist``: the previous ``(K−1)·N`` samples;
    ``x``: ``t·N`` complex64 samples. Returns ``[t, N]`` complex64."""
    if _batched(hist, x, taps):
        return torch.ops.fsdr.pfb(hist, x, taps, precision)
    if x.device.type == "cpu":
        return pfb_plain(hist, x, taps, precision)
    bf16 = _check_precision(precision)
    K, N, t = _check_pfb(hist, x, taps)
    _check_cuda(hist, x)
    if taps.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA or CPU tensors, got {taps.device}")
    plan = plan or pfb_plan(N, K, t, _sm_count(x.device))
    if plan.smem > _MAX_SMEM:
        raise ValueError(f"pfb: N={N} needs {plan.smem} B of shared memory per block "
                         f"for its v row, over the card's {_MAX_SMEM} B")
    y = torch.empty((t, N), dtype=torch.complex64, device=x.device)
    if t == 0:
        return y                            # nothing to launch
    return _launch_pfb(hist, x, taps, y, bf16, plan)


@functools.lru_cache(maxsize=256)
def _pfb_consts(plan: PfbPlan, n: int, device: torch.device) -> tuple:
    """A plan's launch constants, built once: its twiddle table on ``device``
    and the plan as the kernel's C int array."""
    tw = _fft_table(n, plan.radices, device)
    ints = (int(plan.window), plan.threads, plan.chunk, plan.groups, plan.outs, plan.k_regs,
            plan.pitch, plan.pad_shift, int(plan.tw_staged), plan.tw_len, len(plan.radices),
            plan.blocks, *plan.radices)
    return tw, _c_ints(ints)


def _launch_pfb(hist: torch.Tensor, x: torch.Tensor, taps: torch.Tensor, y: torch.Tensor,
                bf16: bool, plan: PfbPlan) -> torch.Tensor:
    K, N = int(taps.shape[0]), int(taps.shape[1])
    last_plans["pfb"] = plan
    tw, ints = _pfb_consts(plan, N, x.device)
    lib = _lib("pfb")
    with _card(x):
        err = lib.fsdr_pfb(hist.data_ptr(), x.data_ptr(), taps.data_ptr(),
                           taps.stride(0), taps.stride(1), tw.data_ptr(), y.data_ptr(),
                           y.shape[0], N, K, (taps.dtype == torch.bfloat16) | bf16 << 1,
                           ints, plan.smem, _stream(x))
    _raise_on(err, "pfb")
    _count("pfb")
    return y


# ---------------------------------------------------------------------------
# lane forms: [L, n] batches, one launch, each lane its own stream
# ---------------------------------------------------------------------------

#: the kernels with a lane form, and its launch counter's name
LANE_KERNELS = {"fir": "fir_lanes", "fir_fft": "fir_fft_lanes", "rotator": "rotator_lanes",
                "poly_fir": "poly_fir_lanes", "quad_demod": "quad_demod_lanes",
                "pfb": "pfb_lanes"}


def _batched(*tensors) -> bool:
    """Is any argument a ``torch.func.vmap`` batched tensor (the call comes
    from inside a vmapped function and goes to the kernel's custom op)?"""
    return any(t is not None and torch._C._functorch.is_batchedtensor(t) for t in tensors)


def _check_lanes(hist: Optional[torch.Tensor], x: torch.Tensor,
                 taps: torch.Tensor) -> Tuple[int, int]:
    """Validate a lane FIR call (``x [L, n]``, ``taps [L, nt]``, ``hist [L,
    nt − 1]``); returns ``(L, nt)``."""
    if x.dtype not in _STREAM_DTYPES or x.dim() != 2:
        raise TypeError(f"x must be a [L, n] float32 or complex64 tensor, got "
                        f"{x.dtype} of shape {tuple(x.shape)}")
    L = int(x.shape[0])
    if taps.dtype != torch.float32 or taps.dim() != 2 or taps.shape[0] != L \
            or taps.shape[1] < 1:
        raise TypeError(f"taps must be a [{L}, nt] float32 tensor, got {taps.dtype} "
                        f"of shape {tuple(taps.shape)}")
    nt = int(taps.shape[1])
    tensors = [x, taps]
    if hist is not None:
        if hist.dtype != x.dtype or tuple(hist.shape) != (L, nt - 1):
            raise ValueError(f"hist must be [{L}, {nt - 1}] of {x.dtype}, got "
                             f"{hist.dtype} of shape {tuple(hist.shape)}")
        tensors.append(hist)
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, taps and hist must lie on one device")
    return L, nt


def fir_lanes_plain(hist: Optional[torch.Tensor], x: torch.Tensor, taps: torch.Tensor,
                    precision: Optional[str] = None) -> torch.Tensor:
    """Plain version of :func:`fir_lanes`: each lane's FIR in the summation
    order of :func:`fir_continue_plain` (its outputs equal that function's on
    each lane's row bit for bit)."""
    bf16 = _check_precision(precision)
    L, nt = _check_lanes(hist, x, taps)
    n = int(x.shape[1])
    if hist is None:
        hist = torch.zeros((L, nt - 1), dtype=x.dtype, device=x.device)
    ext = torch.cat([hist, x], dim=1)
    ext = torch.view_as_real(ext) if ext.is_complex() else ext.unsqueeze(-1)
    if bf16:
        ext, taps = _bf16(ext), _bf16(taps)
    acc = torch.zeros((L, n, ext.shape[2]), dtype=torch.float32, device=x.device)
    for k in range(nt):
        off = nt - 1 - k
        acc = acc + taps[:, k, None, None] * ext[:, off:off + n]
    return torch.view_as_complex(acc.contiguous()) if x.is_complex() else acc[..., 0]


def fir_fft_lanes_plain(hist: torch.Tensor, x: torch.Tensor, taps: torch.Tensor,
                        n_fft: int, precision: Optional[str] = None) -> torch.Tensor:
    """Plain version of :func:`fir_fft_lanes`: :func:`fir_lanes_plain`, then
    each lane's rows times the DFT matrix, one matrix product a lane."""
    bf16 = _check_precision(precision)
    L, nt = _check_lanes(hist, x, taps)
    if hist is None:
        raise ValueError("fir_fft needs hist (the previous n_taps - 1 samples)")
    if not 2 <= nt <= n_fft or x.shape[1] % n_fft:
        raise ValueError(f"fir_fft needs 2 <= n_taps <= n_fft and rows of n_fft; got "
                         f"{nt} taps, n_fft={n_fft}, rows of {x.shape[1]}")
    v = fir_lanes_plain(hist, x, taps, precision)
    if bf16:
        v = torch.view_as_complex(_bf16(torch.view_as_real(v)).contiguous()) \
            if v.is_complex() else _bf16(v)
    if not v.is_complex():
        v = torch.complex(v, torch.zeros_like(v))
    rows = v.reshape(L, -1, n_fft)
    e = _dft_matrix(n_fft, x.device)
    return torch.stack([rows[i] @ e for i in range(L)]).reshape(L, -1) if L else \
        torch.empty((0, x.shape[1]), dtype=torch.complex64, device=x.device)


def _check_rotator_lanes(x: torch.Tensor, ph0: torch.Tensor, inc: torch.Tensor) -> int:
    if x.dtype != torch.complex64 or x.dim() != 2:
        raise TypeError(f"x must be a [L, n] complex64 tensor, got {x.dtype} of shape "
                        f"{tuple(x.shape)}")
    L = int(x.shape[0])
    for name, t in (("ph0", ph0), ("inc", inc)):
        if t.dtype != torch.float32 or tuple(t.shape) != (L,):
            raise TypeError(f"{name} must be [{L}] float32, got {t.dtype} of shape "
                            f"{tuple(t.shape)}")
    if any(t.device != x.device for t in (ph0, inc)):
        raise ValueError("x, ph0 and inc must lie on one device")
    return L


def rotator_lanes_plain(x: torch.Tensor, ph0: torch.Tensor,
                        inc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`rotator_lanes`: :func:`rotator_plain`'s ramp
    and multiply on each lane's row with its own phase and increment."""
    _check_rotator_lanes(x, ph0, inc)
    n = x.shape[1]
    t = torch.arange(n, dtype=torch.float32, device=x.device)
    ph = ph0[:, None] + inc[:, None] * t[None, :]
    c, s = torch.cos(ph), torch.sin(ph)
    xr, xi = x.real, x.imag
    return (torch.complex(xr * c - xi * s, xr * s + xi * c),
            torch.remainder(ph0 + inc * n, 2 * np.pi))


def _check_poly_fir_lanes(hist: torch.Tensor, x: torch.Tensor,
                          W: torch.Tensor) -> Tuple[int, int, int, int, int]:
    """Validate a lane polyphase call (``x [L, nq·D]``, ``hist [L, m·D]``,
    ``W [L, m+1, D]`` or ``[L, m+1, D, I]``); returns ``(L, m, D, I, nq)``."""
    if x.dtype not in _STREAM_DTYPES or x.dim() != 2:
        raise TypeError(f"x must be a [L, nq*D] float32 or complex64 tensor, got "
                        f"{x.dtype} of shape {tuple(x.shape)}")
    L = int(x.shape[0])
    if W.dtype not in (torch.float32, torch.bfloat16) or W.dim() not in (3, 4) \
            or W.shape[0] != L:
        raise TypeError(f"W must be a real [{L}, m+1, D] or [{L}, m+1, D, I] float32 or "
                        f"bfloat16 tensor, got {W.dtype} of shape {tuple(W.shape)}")
    m, D = int(W.shape[1]) - 1, int(W.shape[2])
    I = int(W.shape[3]) if W.dim() == 4 else 1
    if m < 1 or D < 1 or I < 1:
        raise ValueError(f"W needs m >= 1, D >= 1 and I >= 1, got {tuple(W.shape)}")
    if x.shape[1] % D:
        raise ValueError(f"rows of {x.shape[1]} samples must be a multiple of D ({D})")
    if hist.dtype != x.dtype or tuple(hist.shape) != (L, m * D):
        raise ValueError(f"hist must be [{L}, {m * D}] of {x.dtype}, got {hist.dtype} "
                         f"of shape {tuple(hist.shape)}")
    if any(t.device != x.device for t in (hist, W)):
        raise ValueError("hist, x and W must lie on one device")
    return L, m, D, I, int(x.shape[1]) // D


def poly_fir_lanes_plain(hist: torch.Tensor, x: torch.Tensor, W: torch.Tensor,
                         precision: Optional[str] = None) -> torch.Tensor:
    """Plain version of :func:`poly_fir_lanes`: :func:`poly_fir_plain` on
    each lane's row with its own weights (each lane equals that function's
    output bit for bit)."""
    _check_precision(precision)
    L, m, D, I, nq = _check_poly_fir_lanes(hist, x, W)
    if L == 0:
        return torch.empty((0, nq, I) if W.dim() == 4 else (0, nq), dtype=x.dtype,
                           device=x.device)
    return torch.stack([poly_fir_plain(hist[i], x[i], W[i], precision) for i in range(L)])


def _check_quad_demod_lanes(prev: torch.Tensor, x: torch.Tensor) -> int:
    if x.dtype != torch.complex64 or x.dim() != 2:
        raise TypeError(f"x must be a [L, n] complex64 tensor, got {x.dtype} of shape "
                        f"{tuple(x.shape)}")
    L = int(x.shape[0])
    if prev.dtype != torch.complex64 or tuple(prev.shape) != (L,):
        raise TypeError(f"prev must be [{L}] complex64, got {prev.dtype} of shape "
                        f"{tuple(prev.shape)}")
    if prev.device != x.device:
        raise ValueError("x and prev must lie on one device")
    return L


def quad_demod_lanes_plain(prev: torch.Tensor, x: torch.Tensor,
                           gain: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`quad_demod_lanes`: :func:`quad_demod_plain`
    on each lane's row from its own carry sample (each lane equals that
    function's outputs bit for bit)."""
    L = _check_quad_demod_lanes(prev, x)
    if L == 0:
        return (torch.empty(x.shape, dtype=torch.float32, device=x.device),
                prev.clone())
    outs = [quad_demod_plain(prev[i], x[i], gain) for i in range(L)]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def _check_pfb_lanes(hist: torch.Tensor, x: torch.Tensor,
                     taps: torch.Tensor) -> Tuple[int, int, int, int]:
    """Validate a lane PFB call (``x [L, t·N]``, ``hist [L, (K−1)·N]``,
    ``taps [L, K, N]``); returns ``(L, K, N, t)``."""
    if x.dtype != torch.complex64 or x.dim() != 2:
        raise TypeError(f"x must be a [L, t*N] complex64 tensor, got {x.dtype} of shape "
                        f"{tuple(x.shape)}")
    L = int(x.shape[0])
    if taps.dtype not in (torch.float32, torch.bfloat16) or taps.dim() != 3 \
            or taps.shape[0] != L or min(taps.shape[1:]) < 1:
        raise TypeError(f"taps must be a real [{L}, K, N] float32 or bfloat16 tensor, got "
                        f"{taps.dtype} of shape {tuple(taps.shape)}")
    K, N = int(taps.shape[1]), int(taps.shape[2])
    if x.shape[1] % N:
        raise ValueError(f"rows of {x.shape[1]} samples must be a multiple of N ({N})")
    if hist.dtype != torch.complex64 or tuple(hist.shape) != (L, (K - 1) * N):
        raise ValueError(f"hist must be [{L}, {(K - 1) * N}] complex64, got {hist.dtype} "
                         f"of shape {tuple(hist.shape)}")
    if any(t.device != x.device for t in (hist, taps)):
        raise ValueError("hist, x and taps must lie on one device")
    return L, K, N, int(x.shape[1]) // N


def pfb_lanes_plain(hist: torch.Tensor, x: torch.Tensor, taps: torch.Tensor,
                    precision: Optional[str] = None) -> torch.Tensor:
    """Plain version of :func:`pfb_lanes`: :func:`pfb_plain` on each lane's
    row with its own taps (each lane equals that function's output bit for
    bit; a batched IDFT product rounds apart on the CPU)."""
    _check_precision(precision)
    L, K, N, t = _check_pfb_lanes(hist, x, taps)
    if L == 0:
        return torch.empty((0, t, N), dtype=torch.complex64, device=x.device)
    return torch.stack([pfb_plain(hist[i], x[i], taps[i], precision) for i in range(L)])


def _check_rows(*tensors: Optional[torch.Tensor]) -> None:
    """A lane kernel's tensors: on the card, each row contiguous (rows at any
    stride, so a ``[1, nt]`` tensor expanded to ``[L, nt]``, stride 0, is
    shared taps)."""
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA kernels take CUDA or CPU tensors, got {t.device}")
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError("the lane kernels need each row contiguous")


def fir_lanes(hist: Optional[torch.Tensor], x: torch.Tensor, taps: torch.Tensor,
              precision: Optional[str] = None,
              plan: Optional[FirPlan] = None) -> torch.Tensor:
    """The ``fir`` kernel over ``L`` streams in one launch: ``x [L, n]``,
    ``taps [L, nt]`` (stride 0 across lanes: shared taps), ``hist [L,
    nt − 1]`` (None: zero states), each lane exactly :func:`fir_continue` on
    its row. Each lane's output row must start 16-byte aligned (``n`` even
    on a complex stream, a multiple of 4 on a real one). ``plan`` (one of
    :func:`plan_candidates`) beats the tuned table and the rule. Raises
    where the kernel does not build or launch."""
    if x.device.type == "cpu":
        return fir_lanes_plain(hist, x, taps, precision)
    bf16 = _check_precision(precision)
    L, nt = _check_lanes(hist, x, taps)
    _check_rows(hist, x, taps)
    n = int(x.shape[1])
    elt = 8 if x.is_complex() else 4
    if (n * elt) % 16:
        raise ValueError(f"fir_lanes: rows of {n} samples do not keep each lane's output "
                         f"16-byte aligned")
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    if n == 0 or L == 0:
        return y
    plan = plan or fir_lanes_plan(L, n, nt, x.is_complex(), _sm_count(x.device))
    last_plans["fir_lanes"] = plan
    if plan.smem > _MAX_SMEM:
        raise ValueError(f"fir: {nt} taps need {plan.smem} B of shared memory per block")
    lib = _lib("fir")
    with _card(x):
        err = lib.fsdr_fir_lanes(None if hist is None else hist.data_ptr(), x.data_ptr(),
                                 taps.data_ptr(), y.data_ptr(), n, nt,
                                 x.is_complex() | bf16 << 1, _c_ints(plan[:4]), plan.smem,
                                 L, 0 if hist is None else hist.stride(0), x.stride(0),
                                 taps.stride(0), y.stride(0), _stream(x))
    _raise_on(err, "fir_lanes")
    _count("fir_lanes")
    return y


def fir_fft_lanes(hist: torch.Tensor, x: torch.Tensor, taps: torch.Tensor, n_fft: int,
                  precision: Optional[str] = None,
                  plan: Optional[FirFftPlan] = None) -> torch.Tensor:
    """The ``fir_fft`` kernel over ``L`` streams in one launch: ``x [L, n]``
    (``n`` a multiple of ``n_fft``), ``taps [L, nt]`` (stride 0 across
    lanes: shared taps), ``hist [L, nt − 1]``; each lane exactly
    :func:`fir_fft` on its row. ``plan`` (one of :func:`plan_candidates`)
    beats the tuned table and the rule. Returns ``[L, n]`` complex64; raises
    where the kernel does not build or launch."""
    if x.device.type == "cpu":
        return fir_fft_lanes_plain(hist, x, taps, n_fft, precision)
    bf16 = _check_precision(precision)
    L, nt = _check_lanes(hist, x, taps)
    if hist is None or not 2 <= nt <= n_fft or x.shape[1] % n_fft:
        raise ValueError(f"fir_fft_lanes needs hist, 2 <= n_taps <= n_fft and rows of "
                         f"n_fft; got {nt} taps, n_fft={n_fft}, rows of {x.shape[1]}")
    _check_rows(hist, x, taps)
    n = int(x.shape[1])
    plan = plan or fir_fft_lanes_plan(L, n, n_fft, nt, _sm_count(x.device))
    if plan.smem > _MAX_SMEM:
        raise ValueError(f"fir_fft: n_fft={n_fft} with {nt} taps needs {plan.smem} B of "
                         f"shared memory per block")
    y = torch.empty((L, n), dtype=torch.complex64, device=x.device)
    if n == 0 or L == 0:
        return y
    last_plans["fir_fft_lanes"] = plan
    tw = _fft_table(n_fft, plan.radices, x.device)
    lib = _lib("fir_fft")
    with _card(x):
        err = lib.fsdr_fir_fft_lanes(hist.data_ptr(), x.data_ptr(), taps.data_ptr(),
                                     tw.data_ptr(), tw.shape[0], y.data_ptr(), n // n_fft,
                                     n_fft, nt, int(x.is_complex()), int(bf16),
                                     plan.threads, plan.outs, len(plan.radices),
                                     _c_ints(plan.radices), plan.span_shift, plan.pad_shift,
                                     int(plan.tw_staged), plan.smem, L, hist.stride(0),
                                     x.stride(0), taps.stride(0), y.stride(0), _stream(x))
    _raise_on(err, "fir_fft_lanes")
    _count("fir_fft_lanes")
    return y


def rotator_lanes(x: torch.Tensor, ph0: torch.Tensor,
                  inc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``rotator`` kernel over ``L`` streams in one launch: ``x [L, n]``
    complex64 (rows contiguous), ``ph0``/``inc [L]`` float32 on the device;
    each lane exactly :func:`rotator` on its row with its own phase. Returns
    ``(y [L, n], ph_next [L])``, each lane's 16-byte head as its input row's
    (an odd ``n`` is taken as it comes). Raises where the kernel does not
    build or launch."""
    if x.device.type == "cpu":
        return rotator_lanes_plain(x, ph0, inc)
    L = _check_rotator_lanes(x, ph0, inc)
    _check_cuda(x, ph0, inc)
    n = int(x.shape[1])
    head = _stream_head(x[0]) if L else 0
    # y's rows start at x's offsets from a 16-byte boundary, lane by lane
    y = torch.empty((L, n), dtype=torch.complex64, device=x.device) if head == 0 else \
        torch.empty(L * n + 1, dtype=torch.complex64, device=x.device)[1:].view(L, n)
    ph_next = torch.empty(L, dtype=torch.float32, device=x.device)
    if L == 0:
        return y, ph_next
    lib = _lib("rotator")
    with _card(x):
        err = lib.fsdr_rotator_lanes(x.data_ptr(), ph0.data_ptr(), inc.data_ptr(),
                                     y.data_ptr(), ph_next.data_ptr(), n, head, L,
                                     x.stride(0), _stream(x))
    _raise_on(err, "rotator_lanes")
    last_plans["rotator_lanes"] = _ROTATOR_PLAN
    _count("rotator_lanes")
    return y, ph_next


def poly_fir_lanes(hist: torch.Tensor, x: torch.Tensor, W: torch.Tensor,
                   precision: Optional[str] = None,
                   plan: Optional[PolyFirPlan] = None) -> torch.Tensor:
    """The ``poly_fir`` kernel over ``L`` streams in one launch: ``hist [L,
    m·D]`` and ``x [L, nq·D]`` float32 or complex64 (rows contiguous), ``W
    [L, m+1, D]`` or ``[L, m+1, D, I]`` float32 or bfloat16 (each lane's W
    contiguous; stride 0 across lanes is one W shared by every lane, read
    once); each lane exactly :func:`poly_fir` on its row. ``plan`` (one of
    :func:`plan_candidates`) beats the tuned table and the rule; it must keep
    the tiling and K split of a lane's one-stream plan, as
    :func:`poly_fir_lanes_plan` does. Returns ``[L, nq]`` or ``[L, nq, I]``
    of the stream's dtype; raises where the kernel does not build or
    launch."""
    if x.device.type == "cpu":
        return poly_fir_lanes_plain(hist, x, W, precision)
    bf16 = _check_precision(precision)
    L, m, D, I, nq = _check_poly_fir_lanes(hist, x, W)
    _check_rows(hist, x)
    if L and (not W[0].is_contiguous() or L > 1 and 0 < W.stride(0) < W[0].numel()):
        raise ValueError("poly_fir_lanes needs each lane's W contiguous, the lanes' W "
                         "apart or one W shared (stride 0)")
    y = torch.empty((L, nq, I) if W.dim() == 4 else (L, nq), dtype=x.dtype, device=x.device)
    if nq == 0 or L == 0:
        return y
    plan = plan or poly_fir_lanes_plan(L, m, D, I, nq, x.is_complex(), _sm_count(x.device))
    if plan.smem > _MAX_SMEM:
        raise ValueError(f"poly_fir_lanes: W {tuple(W.shape[1:])} needs {plan.smem} B of "
                         f"shared memory per block, over the card's {_MAX_SMEM} B")
    last_plans["poly_fir_lanes"] = plan
    lib = _lib("poly_fir")
    with _card(x):
        err = lib.fsdr_poly_fir_lanes(hist.data_ptr(), x.data_ptr(), W.data_ptr(),
                                      y.data_ptr(), nq, m, D, I, int(x.is_complex()),
                                      int(bf16), int(W.dtype == torch.bfloat16),
                                      int(plan.tiling == "gemm"), plan.threads, plan.rows,
                                      plan.tile_rows, plan.tile_phases, plan.ksplit,
                                      plan.pad, plan.blocks, plan.smem, L, hist.stride(0),
                                      x.stride(0), W.stride(0), y.stride(0), _stream(x))
    _raise_on(err, "poly_fir_lanes")
    _count("poly_fir_lanes")
    return y


def quad_demod_lanes(prev: torch.Tensor, x: torch.Tensor,
                     gain: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``quad_demod`` kernel over ``L`` streams in one launch: ``x [L,
    n]`` complex64 (rows contiguous), ``prev [L]`` each lane's carry sample,
    ``gain`` shared; each lane exactly :func:`quad_demod` on its row. Returns
    ``(y [L, n] float32, last [L])``, ``last`` each lane's ``x[n−1]`` (its
    ``prev`` for ``n = 0``), a tensor of its own. Raises where the kernel does
    not build or launch."""
    if x.device.type == "cpu":
        return quad_demod_lanes_plain(prev, x, gain)
    L = _check_quad_demod_lanes(prev, x)
    _check_rows(x)
    _check_cuda(prev)
    n = int(x.shape[1])
    y = torch.empty((L, n), dtype=torch.float32, device=x.device)
    if n == 0 or L == 0:
        return y, prev.clone()                # nothing to launch
    last = torch.empty(L, dtype=torch.complex64, device=x.device)
    lib = _lib("quad_demod")
    with _card(x):
        err = lib.fsdr_quad_demod_lanes(x.data_ptr(), prev.data_ptr(), y.data_ptr(),
                                        last.data_ptr(), n, float(gain), L, x.stride(0),
                                        y.stride(0), _stream(x))
    _raise_on(err, "quad_demod_lanes")
    _count("quad_demod_lanes")
    return y, last


def pfb_lanes(hist: torch.Tensor, x: torch.Tensor, taps: torch.Tensor,
              precision: Optional[str] = None, plan: Optional[PfbPlan] = None) -> torch.Tensor:
    """The ``pfb`` kernel over ``L`` streams in one launch: ``hist [L,
    (K−1)·N]`` and ``x [L, t·N]`` complex64 (rows contiguous), ``taps [L, K,
    N]`` real float32 or bfloat16 at any strides (the stage's ``[L, N, K]``
    carry transposed; stride 0 across lanes is one prototype shared by every
    lane, read once); each lane exactly :func:`pfb` on its row. ``plan`` (one
    of :func:`plan_candidates`) beats the tuned table and the rule; it must
    keep the layout and radices of a lane's one-stream plan, as
    :func:`pfb_lanes_plan` does. Returns ``[L, t, N]`` complex64; raises
    where the kernel does not build or launch."""
    if x.device.type == "cpu":
        return pfb_lanes_plain(hist, x, taps, precision)
    bf16 = _check_precision(precision)
    L, K, N, t = _check_pfb_lanes(hist, x, taps)
    _check_rows(hist, x)
    if taps.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA or CPU tensors, got {taps.device}")
    # the walk's bulk copies need every lane's rows of hist and x 16-byte aligned
    aligned = x.data_ptr() % 16 == 0 and hist.data_ptr() % 16 == 0 and \
        (L < 2 or x.stride(0) % 2 == 0 and hist.stride(0) % 2 == 0)
    plan = plan or pfb_lanes_plan(L, N, K, t, _sm_count(x.device), aligned)
    if plan.smem > _MAX_SMEM:
        raise ValueError(f"pfb_lanes: N={N} needs {plan.smem} B of shared memory per "
                         f"block for its v row, over the card's {_MAX_SMEM} B")
    y = torch.empty((L, t, N), dtype=torch.complex64, device=x.device)
    if t == 0 or L == 0:
        return y                            # nothing to launch
    last_plans["pfb_lanes"] = plan
    tw, ints = _pfb_consts(plan, N, x.device)
    lib = _lib("pfb")
    with _card(x):
        err = lib.fsdr_pfb_lanes(hist.data_ptr(), x.data_ptr(), taps.data_ptr(),
                                 taps.stride(1), taps.stride(2), tw.data_ptr(), y.data_ptr(),
                                 t, N, K, (taps.dtype == torch.bfloat16) | bf16 << 1, ints,
                                 plan.smem, L, hist.stride(0), x.stride(0), taps.stride(0),
                                 y.stride(0), _stream(x))
    _raise_on(err, "pfb_lanes")
    _count("pfb_lanes")
    return y


# ---------------------------------------------------------------------------
# the custom ops and their vmap rules
# ---------------------------------------------------------------------------

Tensor = torch.Tensor


def _lanes_of(t: Optional[torch.Tensor], d: Optional[int], L: int,
              scalar: bool = False) -> Optional[torch.Tensor]:
    """A vmap argument as a contiguous ``[L, …]`` tensor: its batch dim moved
    to the front, or an unbatched argument repeated a lane; ``scalar``
    flattens a lane's one value (``[L]``)."""
    if t is None:
        return None
    t = t.movedim(d, 0) if d is not None else t.unsqueeze(0).expand(L, *t.shape)
    if scalar:
        t = t.reshape(L)
    return t.contiguous()


@torch.library.custom_op("fsdr::fir", mutates_args=())
def _fir_op(x: Tensor, taps: Tensor, precision: Optional[str]) -> Tensor:
    return fir(x, taps, precision)


@torch.library.custom_op("fsdr::fir_continue", mutates_args=())
def _fir_continue_op(hist: Tensor, x: Tensor, taps: Tensor,
                     precision: Optional[str]) -> Tensor:
    return fir_continue(hist, x, taps, precision)


@torch.library.custom_op("fsdr::fir_fft", mutates_args=())
def _fir_fft_op(hist: Tensor, x: Tensor, taps: Tensor, n_fft: int,
                precision: Optional[str]) -> Tensor:
    return fir_fft(hist, x, taps, n_fft, precision)


@torch.library.custom_op("fsdr::rotator", mutates_args=())
def _rotator_op(x: Tensor, ph0: Tensor, inc: Tensor) -> Tuple[Tensor, Tensor]:
    y, nxt = rotator(x, ph0, inc)
    return y.clone() if y.storage_offset() else y, nxt


@torch.library.custom_op("fsdr::quad_demod", mutates_args=())
def _quad_demod_op(prev: Tensor, x: Tensor, gain: float) -> Tuple[Tensor, Tensor]:
    return quad_demod(prev, x, gain)


@torch.library.custom_op("fsdr::poly_fir", mutates_args=())
def _poly_fir_op(hist: Tensor, x: Tensor, W: Tensor, precision: Optional[str]) -> Tensor:
    return poly_fir(hist, x, W, precision)


@torch.library.custom_op("fsdr::pfb", mutates_args=())
def _pfb_op(hist: Tensor, x: Tensor, taps: Tensor, precision: Optional[str]) -> Tensor:
    return pfb(hist, x, taps, precision)


@torch.library.register_vmap("fsdr::fir")
def _fir_vmap(info, in_dims, x, taps, precision):
    L = info.batch_size
    return fir_lanes(None, _lanes_of(x, in_dims[0], L), _lanes_of(taps, in_dims[1], L),
                     precision), 0


@torch.library.register_vmap("fsdr::fir_continue")
def _fir_continue_vmap(info, in_dims, hist, x, taps, precision):
    L = info.batch_size
    return fir_lanes(_lanes_of(hist, in_dims[0], L), _lanes_of(x, in_dims[1], L),
                     _lanes_of(taps, in_dims[2], L), precision), 0


@torch.library.register_vmap("fsdr::fir_fft")
def _fir_fft_vmap(info, in_dims, hist, x, taps, n_fft, precision):
    L = info.batch_size
    return fir_fft_lanes(_lanes_of(hist, in_dims[0], L), _lanes_of(x, in_dims[1], L),
                         _lanes_of(taps, in_dims[2], L), n_fft, precision), 0


@torch.library.register_vmap("fsdr::rotator")
def _rotator_vmap(info, in_dims, x, ph0, inc):
    L = info.batch_size
    y, nxt = rotator_lanes(_lanes_of(x, in_dims[0], L),
                           _lanes_of(ph0, in_dims[1], L, scalar=True),
                           _lanes_of(inc, in_dims[2], L, scalar=True))
    return (y, nxt), (0, 0)


@torch.library.register_vmap("fsdr::quad_demod")
def _quad_demod_vmap(info, in_dims, prev, x, gain):
    L = info.batch_size
    y, last = quad_demod_lanes(_lanes_of(prev, in_dims[0], L, scalar=True),
                               _lanes_of(x, in_dims[1], L), gain)
    return (y, last), (0, 0)


@torch.library.register_vmap("fsdr::poly_fir")
def _poly_fir_vmap(info, in_dims, hist, x, W, precision):
    L = info.batch_size
    # an unbatched W (the resampler's, a stage constant) is one W for every
    # lane: expanded with stride 0, never copied L times
    w = _lanes_of(W, in_dims[2], L) if in_dims[2] is not None else \
        W.contiguous().unsqueeze(0).expand(L, *W.shape)
    return poly_fir_lanes(_lanes_of(hist, in_dims[0], L), _lanes_of(x, in_dims[1], L), w,
                          precision), 0


@torch.library.register_vmap("fsdr::pfb")
def _pfb_vmap(info, in_dims, hist, x, taps, precision):
    L = info.batch_size
    # an unbatched prototype is one for every lane: expanded with stride 0,
    # never copied L times; batched taps keep their strides (the stage's
    # carry transposed)
    t = taps.movedim(in_dims[2], 0) if in_dims[2] is not None else \
        taps.unsqueeze(0).expand(L, *taps.shape)
    return pfb_lanes(_lanes_of(hist, in_dims[0], L), _lanes_of(x, in_dims[1], L), t,
                     precision), 0
