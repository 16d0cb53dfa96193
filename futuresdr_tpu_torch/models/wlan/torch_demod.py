"""OFDM demodulation on the device: CFO → batched FFT → equalize → CPE → max-log demap.

The counterpart of ``futuresdr_tpu/models/wlan/jax_demod.py``, whose two jitted
programs are built from XLA ops (no Pallas): the frame HEAD (the LTS channel
estimate and the SIGNAL symbol's LLRs, :func:`demod_head_torch`) and the data
symbols of a frame (:func:`demod_body_torch`), bucketed by symbol count
(``max(4, next power of two)`` symbols with a symbol mask) and tabled per
modulation. Here both are eager PyTorch ops (``torch.fft`` and elementwise
ops) on the device they are given, with the reference's arithmetic and
tables; no hand kernel. :func:`demod_body_tensors` is the body on tensors that
already lie on the device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ...tpu.instance import resolve_device
from .consts import (CP_LEN, DATA_CARRIERS, FFT_SIZE, LTS_FREQ, MODULATION_TABLES,
                     PILOT_CARRIERS, PILOT_POLARITY, PILOT_VALUES, SYM_LEN,
                     carriers_to_grid)

__all__ = ["demod_head_torch", "demod_body_torch", "demod_body_tensors",
           "body_bucket", "body_inputs"]

_DATA_IDX = (DATA_CARRIERS % FFT_SIZE).astype(np.int64)
_PIL_IDX = (PILOT_CARRIERS % FFT_SIZE).astype(np.int64)
_BIG = 1e30

_tables: Dict[tuple, tuple] = {}


def _demap_tables(modulation: str, device: torch.device) -> tuple:
    """``(lvl_i, lvl_q, mask_i, mask_q, data_idx, pil_idx, pilot_values)`` on
    ``device``: the per-axis max-log decomposition of ``_compiled``.

    Every 802.11 constellation is a product of two Gray PAMs, the LOW index
    bits selecting the I level and the HIGH ones the Q level, so each bit's
    LLR is a max over √M real distances on one axis."""
    key = (modulation, str(device))
    got = _tables.get(key)
    if got is None:
        table = MODULATION_TABLES[modulation].astype(np.complex64)
        n_bpsc = int(np.log2(len(table)))
        n_i = (n_bpsc + 1) // 2
        n_q = n_bpsc - n_i
        lvl_i = table[np.arange(1 << n_i)].real.astype(np.float32)
        lvl_q = table[(np.arange(1 << n_q)) << n_i].imag.astype(np.float32)
        mask_i = np.stack([((np.arange(1 << n_i) >> b) & 1) > 0 for b in range(n_i)])
        mask_q = (np.stack([((np.arange(1 << n_q) >> b) & 1) > 0 for b in range(n_q)])
                  if n_q else np.zeros((0, 1), bool))
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        got = (t(lvl_i), t(lvl_q), t(mask_i), t(mask_q), t(_DATA_IDX), t(_PIL_IDX),
               t(PILOT_VALUES.astype(np.float32)))
        _tables[key] = got
    return got


def _head_tables(device: torch.device) -> tuple:
    key = ("head", str(device))
    got = _tables.get(key)
    if got is None:
        ref = carriers_to_grid(LTS_FREQ).astype(np.complex64)
        used = ref != 0
        ref_safe = np.where(used, ref, 1.0).astype(np.complex64)
        got = (torch.from_numpy(ref_safe).to(device), torch.from_numpy(used).to(device),
               torch.from_numpy(_PIL_IDX).to(device), torch.from_numpy(_DATA_IDX).to(device),
               torch.from_numpy(PILOT_VALUES.astype(np.complex64)).to(device))
        _tables[key] = got
    return got


def _ramp(n: int, cfo: float, phase0: float, device: torch.device) -> torch.Tensor:
    """``exp(-i·cfo·(k + phase0))`` for ``k < n``, the angle
    ``float32(k + phase0) · float32(-cfo)`` as the JAX program rounds it (no
    host-to-device copy, so a CUDA graph can capture it)."""
    k = torch.arange(n, dtype=torch.float32, device=device)
    ang = (k + float(np.float32(phase0))) * float(np.float32(-cfo))
    return torch.polar(torch.ones_like(ang), ang)


def demod_head_torch(head: np.ndarray, cfo: float, device=None):
    """LTS channel estimate + SIGNAL-symbol LLRs on ``device`` (None: the card).

    ``head``: the 208 raw samples from ``lts_start`` (two LTS symbols + the
    SIGNAL symbol with CP), without host-side CFO correction; the CFO ramp is
    applied here with phase 0 at ``lts_start``. Returns ``(H[64] complex64,
    llrs[48] float32)`` numpy arrays, as ``demod_head_jax`` does."""
    dev = resolve_device(device)
    ref_c, used_c, pil_idx, data_idx, expected = _head_tables(dev)
    x = torch.from_numpy(np.ascontiguousarray(head[:208], dtype=np.complex64)).to(dev)
    x = x * _ramp(x.shape[0], cfo, 0.0, dev)
    s1 = torch.fft.fft(x[0:64])
    s2 = torch.fft.fft(x[64:128])
    avg = (s1 + s2) * 0.5
    H = torch.where(used_c, avg / ref_c, torch.ones_like(avg))
    spec = torch.fft.fft(x[128 + CP_LEN:128 + SYM_LEN])
    eq = spec / H
    pilots = eq[pil_idx]
    # SIGNAL symbol: pilot polarity index 0 => +1 on all four pilots
    cpe = torch.angle((pilots * torch.conj(expected)).sum())
    eq = eq * torch.polar(torch.ones_like(cpe), -cpe)
    llrs = 4.0 * eq[data_idx].real             # BPSK max-log, closed form
    return H.cpu().numpy(), llrs.to(torch.float32).cpu().numpy()


def body_bucket(n_sym: int) -> int:
    """Symbols the body program runs: ``max(4, next power of two)``."""
    return max(4, 1 << int(np.ceil(np.log2(max(n_sym, 1)))))


def body_inputs(n_sym: int, symbol_offset: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(pilot polarity [bucket], symbol mask [bucket])`` float32 on ``device``."""
    bucket = body_bucket(n_sym)
    pol = PILOT_POLARITY[(symbol_offset + np.arange(bucket)) % len(PILOT_POLARITY)]
    mask = (np.arange(bucket) < n_sym).astype(np.float32)
    return (torch.from_numpy(pol.astype(np.float32)).to(device),
            torch.from_numpy(mask).to(device))


def demod_body_tensors(body: torch.Tensor, H: torch.Tensor, pol: torch.Tensor,
                       sym_mask: torch.Tensor, cfo: float, phase0: float,
                       modulation: str) -> torch.Tensor:
    """The body program on device tensors: ``body [bucket·80]`` complex64
    (zero-padded), ``H [64]`` complex64, ``pol`` and ``sym_mask`` float32
    ``[bucket]`` → raw LLRs ``[bucket·48·n_bpsc]`` float32, the masked symbols'
    zero."""
    dev = body.device
    bucket = body.shape[0] // SYM_LEN
    li, lq, mi, mq, data_idx, pil_idx, pv = _demap_tables(modulation, dev)
    x = body * _ramp(body.shape[0], cfo, phase0, dev)
    sym = x.reshape(bucket, SYM_LEN)[:, CP_LEN:]
    spec = torch.fft.fft(sym, dim=1)
    eq = spec / H[None, :]
    pilots = eq[:, pil_idx]
    expected = (pv[None, :] * pol[:, None]).to(torch.complex64)
    cpe = torch.angle((pilots * torch.conj(expected)).sum(dim=1))
    eq = eq * torch.polar(torch.ones_like(cpe), -cpe)[:, None]
    data = eq[:, data_idx]                                    # [bucket, 48]
    d_i = -(data.real[..., None] - li[None, None, :]) ** 2    # [bucket, 48, Li]
    llrs = [torch.where(mi[b], d_i, -_BIG).amax(dim=2)
            - torch.where(mi[b], -_BIG, d_i).amax(dim=2) for b in range(mi.shape[0])]
    if mq.shape[0]:
        d_q = -(data.imag[..., None] - lq[None, None, :]) ** 2
        llrs += [torch.where(mq[b], d_q, -_BIG).amax(dim=2)
                 - torch.where(mq[b], -_BIG, d_q).amax(dim=2) for b in range(mq.shape[0])]
    out = torch.stack(llrs, dim=2).reshape(bucket, -1)        # [bucket, 48·n_bpsc]
    return (out * sym_mask[:, None]).reshape(-1)


def demod_body_torch(body: np.ndarray, H: np.ndarray, n_sym: int, symbol_offset: int,
                     cfo: float, phase0: float, modulation: str, device=None) -> np.ndarray:
    """Raw LLRs for ``n_sym`` symbols (``[n_sym·48·n_bpsc]`` float32 numpy) on
    ``device`` (None: the card); ``body`` holds exactly ``n_sym·80`` samples
    without CFO correction, ``phase0`` the CFO ramp's sample offset from
    ``lts_start``. The bucket padding is handled here."""
    dev = resolve_device(device)
    bucket = body_bucket(n_sym)
    padded = np.zeros(bucket * SYM_LEN, dtype=np.complex64)
    padded[:n_sym * SYM_LEN] = body
    pol, mask = body_inputs(n_sym, symbol_offset, dev)
    out = demod_body_tensors(torch.from_numpy(padded).to(dev),
                             torch.from_numpy(np.asarray(H, np.complex64)).to(dev),
                             pol, mask, cfo, phase0, modulation)
    n_bpsc = int(np.log2(len(MODULATION_TABLES[modulation])))
    return out[:n_sym * 48 * n_bpsc].cpu().numpy()
