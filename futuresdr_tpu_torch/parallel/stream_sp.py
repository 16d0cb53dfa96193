"""Sequence parallelism for sample streams: the time axis split over a mesh
axis, with a halo from the left neighbour.

The counterpart of ``futuresdr_tpu/parallel/stream_sp.py``. A frame is cut
into contiguous time shards, one a device of the axis (:func:`place`); an
operator that needs history gets its left halo, the previous shard's tail, by
one counted peer copy (:meth:`Mesh.copy`, the reference's ``ppermute``), then
computes on its own device. Each shard's work is a hand-kernel launch:

* :func:`sp_fir` / :func:`sp_fir_stream`: ``fir_continue(halo, x_local, taps)``
  (the halo *is* the kernel's ``hist``);
* :func:`sp_fir_fft_mag2` / :func:`sp_fir_fft_mag2_stream`: ``fir_fft(halo, …)``
  then ``|x|²``;
* :func:`sp_channelizer`: ``pfb(halo, …)``, the halo ``(K − 1)·N`` samples;
  :func:`sp_channelizer_a2a` then swaps time for channels across the shards;
* :func:`sp_dechirp_scan` takes a right halo, the next shard's head.

On the CPU the kernels' plain versions run, as everywhere in the port. Every
function takes a :class:`~.mesh.Sharded` value or a whole frame (which it
places), and returns :class:`~.mesh.Sharded` values.

On a mesh across processes (:mod:`.multihost`) every rank calls the same
function on the same global frame: :func:`place` keeps the rank's own
shards, each rank runs the kernels on them, and every halo or block whose
two shards belong to two ranks crosses by :meth:`~.mesh.Mesh.move`, a send
and its receive, walked in the same order on every rank. The per-shard
arithmetic is the one-process run's, so the output is the same bits.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from ..models.lora.phy import _downchirp
from ..ops import cuda_kernels as ck
from ..ops.xfer import torch_dtype
from .mesh import Mesh, Sharded

__all__ = ["sp_fir", "sp_fir_fft_mag2", "sp_fir_stream", "sp_fir_fft_mag2_stream",
           "sp_channelizer", "sp_channelizer_a2a", "sp_dechirp_scan", "place", "to_host"]


def place(x, mesh: Mesh, axis: str = "sp", dim: int = 0) -> Sharded:
    """Split a whole frame (numpy or tensor) into contiguous shards along
    ``dim``, one a device of ``axis``; on a mesh across processes only the
    calling rank's shards are made (every rank holds the same global frame,
    made from the same seed: the counterpart of
    ``jax.make_array_from_callback``). A :class:`Sharded` passes through."""
    if isinstance(x, Sharded):
        return x
    devs = mesh.line(axis)
    mine = mesh.mine(axis)
    t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
    if t.shape[dim] % len(devs):
        raise ValueError(f"frame length {t.shape[dim]} does not divide by the "
                         f"{len(devs)} shards of axis {axis!r}")
    return Sharded([c.to(d) if m else None
                    for c, d, m in zip(t.chunk(len(devs), dim), devs, mine)], axis, dim,
                   mesh if mesh.distributed else None)


def to_host(s: Sharded) -> np.ndarray:
    """The whole value on the host: a device-to-host copy a shard, no
    cross-shard transfer; on a mesh across processes an all-gather, which
    every rank calls (:meth:`~.mesh.Mesh.gather`)."""
    if s.mesh is not None:
        return s.mesh.gather(s.shards, torch.device("cpu"), s.dim).numpy()
    return torch.cat([t.cpu() for t in s.shards], dim=s.dim).numpy()


def _out(shards: List[Optional[torch.Tensor]], axis: str, mesh: Mesh, dim: int = 0):
    return Sharded(shards, axis, dim, mesh if mesh.distributed else None)


def _any(shards) -> Optional[torch.Tensor]:
    return next((s for s in shards if s is not None), None)


def _halos_from_left(shards: List[Optional[torch.Tensor]], halo: int, mesh: Mesh,
                     first: Optional[torch.Tensor], axis: str) -> List[Optional[torch.Tensor]]:
    """Each shard's left context: the previous shard's last ``halo`` samples
    by a counted move (a send and a receive where two ranks hold the two
    shards); shard 0 gets ``first`` (the previous frame's global tail), or
    zeros. None where this rank holds no shard."""
    ref = _any(shards)
    out: List[Optional[torch.Tensor]] = [None] * len(shards)
    s0 = shards[0]
    if s0 is not None:
        if first is None:
            first = torch.zeros((halo,) + tuple(s0.shape[1:]), dtype=s0.dtype,
                                device=s0.device)
        out[0] = first.to(s0.dtype)
    for i in range(1, len(shards)):
        prev = shards[i - 1]
        tail = None if prev is None else prev[prev.shape[0] - halo:]
        out[i] = mesh.move(tail, i - 1, i, axis, like=ref,
                           shape=(halo,) + tuple(ref.shape[1:]) if ref is not None else None)
    return out


def _check_local(shards: List[Optional[torch.Tensor]], halo: int) -> None:
    s = _any(shards)
    if s is not None and s.shape[0] < halo:
        raise ValueError(f"per-shard length {s.shape[0]} < halo {halo}: grow the frame or "
                         f"reduce taps/devices")


def _taps_on(taps: np.ndarray, devs, mine) -> list:
    t = torch.from_numpy(np.ascontiguousarray(np.real(taps), dtype=np.float32))
    return [t.to(d) if m else None for d, m in zip(devs, mine)]


def _each(fn: Callable, *cols) -> list:
    """``fn`` over the shards this rank holds (None elsewhere)."""
    return [None if row[0] is None else fn(*row) for row in zip(*cols)]


def _fir_local(x, halo, tt):
    return ck.fir_continue(halo, x, tt)


def _fir_fft_mag2_local(fft_size):
    def local(x, halo, tt):
        spec = ck.fir_fft(halo, x, tt, fft_size)
        return (spec.real * spec.real + spec.imag * spec.imag).to(torch.float32)
    return local


def _sharded(local: Callable, taps: np.ndarray, mesh: Mesh, axis: str):
    nt = len(taps)
    tts = _taps_on(taps, mesh.line(axis), mesh.mine(axis))

    def fn(x) -> Sharded:
        xs = place(x, mesh, axis)
        _check_local(xs.shards, nt - 1)
        halos = _halos_from_left(xs.shards, nt - 1, mesh, None, axis)
        return _out(_each(local, xs.shards, halos, tts), axis, mesh)

    return fn


def sp_fir(taps: np.ndarray, mesh: Mesh, axis: str = "sp") -> Callable:
    """Time-sharded causal FIR from a zero initial state: ``fn(x) -> y``,
    both sharded over ``axis``; the global FIR, shard edges included. Needs
    a per-shard length ≥ ``len(taps) − 1`` (the halo fits in one
    neighbour)."""
    return _sharded(_fir_local, np.asarray(taps), mesh, axis)


def sp_fir_fft_mag2(taps: np.ndarray, fft_size: int, mesh: Mesh,
                    axis: str = "sp") -> Callable:
    """The fused spectrum chain, time-sharded: FIR with the halo, the DFT of
    each ``fft_size`` row, ``|x|²`` (float32). The per-shard length must be a
    multiple of ``fft_size``."""
    return _sharded(_fir_fft_mag2_local(int(fft_size)), np.asarray(taps), mesh, axis)


def _make_stream(local: Callable, taps: np.ndarray, mesh: Mesh, axis: str):
    """``fn(carry, x) -> (carry, y)`` and ``init_carry(dtype)``: the carry is
    the previous frame's global tail (``n_taps − 1`` samples on shard 0's
    device), shard 0's left context; the new carry is this frame's tail, a
    counted copy from the last shard."""
    nt = len(taps)
    devs = mesh.line(axis)
    mine = mesh.mine(axis)
    n_dev = len(devs)
    tts = _taps_on(taps, devs, mine)

    def fn(carry, x):
        if isinstance(x, Sharded):
            s = _any(x.shards)
            per = None if s is None else s.shape[0]
        else:
            per = x.shape[0] // n_dev
        if per is not None and per < nt - 1:
            raise ValueError(f"per-shard length {per} < halo {nt - 1}: "
                             f"grow the frame or reduce taps/devices")
        xs = place(x, mesh, axis)
        halos = _halos_from_left(xs.shards, nt - 1, mesh, carry, axis)
        y = _out(_each(local, xs.shards, halos, tts), axis, mesh)
        last = xs.shards[-1]
        tail = None if last is None else last[last.shape[0] - (nt - 1):]
        if n_dev == 1:
            return (None if tail is None else tail.clone()), y
        return mesh.move(tail, n_dev - 1, 0, axis, like=_any(xs.shards),
                         shape=(nt - 1,)), y

    def init_carry(dtype):
        if not mine[0]:
            return None
        return torch.zeros(nt - 1, dtype=torch_dtype(np.dtype(dtype)), device=devs[0])

    return fn, init_carry


def sp_fir_stream(taps: np.ndarray, mesh: Mesh, axis: str = "sp"):
    """Cross-frame time-sharded FIR: ``(fn, init_carry)``, ``fn(carry, x) ->
    (carry, y)``. N frames through it give the single-device streaming FIR's
    output across the frame edges (see :func:`_make_stream`)."""
    return _make_stream(_fir_local, np.asarray(taps), mesh, axis)


def sp_fir_fft_mag2_stream(taps: np.ndarray, fft_size: int, mesh: Mesh,
                           axis: str = "sp"):
    """Cross-frame form of :func:`sp_fir_fft_mag2` (the carry contract of
    :func:`sp_fir_stream`)."""
    return _make_stream(_fir_fft_mag2_local(int(fft_size)), np.asarray(taps), mesh, axis)


def _pfb_taps(n_channels: int, taps: np.ndarray):
    N = int(n_channels)
    taps = np.asarray(taps, dtype=np.float32)
    K = -(-len(taps) // N)
    padded = np.zeros(K * N, dtype=np.float32)
    padded[:len(taps)] = taps
    # the reference's sp_channelizer correlates block s+k with tap row k,
    # where the pfb kernel (like the channelizer stage) convolves block
    # s+K-1-k with tap row k: the rows go in reversed
    return N, K, torch.from_numpy(padded.reshape(K, N)[::-1].copy())      # [K, N]


def _channelize_local(n_channels: int, taps: np.ndarray, mesh: Mesh, axis: str):
    N, K, w = _pfb_taps(n_channels, taps)
    devs = mesh.line(axis)
    ws = [w.to(d) if m else None for d, m in zip(devs, mesh.mine(axis))]

    def local(x) -> List[Optional[torch.Tensor]]:
        xs = place(x, mesh, axis)
        s0 = _any(xs.shards)
        if s0 is not None and s0.shape[0] % N:
            raise ValueError(f"per-shard length {s0.shape[0]} is not a multiple "
                             f"of n_channels {N}")
        _check_local(xs.shards, (K - 1) * N)
        shards = [None if s is None else s.to(torch.complex64) for s in xs.shards]
        halos = _halos_from_left(shards, (K - 1) * N, mesh, None, axis)
        # [t, N] a shard; the output's channel axis leads, as in the reference
        return _each(lambda s, h, t: ck.pfb(h, s.contiguous(), t).t(), shards, halos, ws)

    return N, local


def sp_channelizer(n_channels: int, taps: np.ndarray, mesh: Mesh,
                   axis: str = "sp") -> Callable:
    """Critically sampled PFB channelizer, time-sharded: input ``[n]``
    complex (a per-shard length a multiple of ``n_channels``), output
    ``[n_channels, n/N]`` sharded on time (``dim=1``). Each branch needs
    ``K − 1`` blocks of history: the halo is ``(K − 1)·N`` samples, the
    ``pfb`` kernel's ``hist``."""
    _N, local = _channelize_local(n_channels, taps, mesh, axis)

    def fn(x) -> Sharded:
        return _out(local(x), axis, mesh, 1)

    return fn


def sp_channelizer_a2a(n_channels: int, taps: np.ndarray, mesh: Mesh,
                       axis: str = "sp") -> Callable:
    """All-to-all form of :func:`sp_channelizer`: each device channelizes its
    time shard, then the shards swap time for channels, so device j ends
    with channels ``[j·N/D, (j+1)·N/D)`` over the whole frame: output
    ``[n_channels, n/N]`` sharded on channels (``dim=0``). Each of the
    ``D·(D − 1)`` blocks that changes device is a counted transfer."""
    N, local = _channelize_local(n_channels, taps, mesh, axis)
    devs = mesh.line(axis)
    n_dev = len(devs)
    if N % n_dev:
        raise ValueError("n_channels must divide by the mesh axis")
    per = N // n_dev

    def fn(x) -> Sharded:
        ys = local(x)                                   # [N, t_local] on device i
        ref = _any(ys)
        out = []
        for j in range(n_dev):
            blocks = []
            for i, y in enumerate(ys):
                block = None if y is None else y[j * per:(j + 1) * per]
                blocks.append(block if i == j else
                              mesh.move(block, i, j, axis, "all_to_all", like=ref,
                                        shape=None if ref is None else (per, ref.shape[1])))
            out.append(None if blocks[j] is None else torch.cat(blocks, dim=1))
        return _out(out, axis, mesh, 0)

    return fn


def sp_dechirp_scan(sf: int, mesh: Mesh, hop: Optional[int] = None, axis: str = "sp"):
    """LoRa preamble scan, time-sharded: dechirp every ``hop``-spaced window
    and return each window's peak bin and energy concentration, ``(bins
    int32, conc float32)``, both time-sharded. A window near a shard's end
    reaches into the next shard: each shard fetches a window-length right
    halo (the next shard's head; zeros after the last shard). The per-shard
    length must be ≥ the window and a multiple of ``hop``."""
    n = 1 << int(sf)
    hop = hop or n // 4
    if n % hop:
        raise ValueError(f"window length {n} must be a multiple of hop {hop}")
    devs = mesh.line(axis)
    down = torch.from_numpy(_downchirp(n).astype(np.complex64))
    downs = [down.to(d) if mi else None for d, mi in zip(devs, mesh.mine(axis))]

    def fn(x):
        xs = place(x, mesh, axis)
        shards = [None if s is None else s.to(torch.complex64) for s in xs.shards]
        ref = _any(shards)
        m = None if ref is None else ref.shape[0]
        if m is not None and m < n:
            raise ValueError(f"per-shard length {m} < window {n}: grow the capture or "
                             f"reduce sf/devices")
        if m is not None and m % hop:
            raise ValueError(f"per-shard length {m} must be a multiple of hop {hop}")
        # each shard's right halo: the next shard's head (zeros after the last)
        rights = [mesh.move(None if shards[i + 1] is None else shards[i + 1][:n], i + 1, i,
                            axis, like=ref, shape=(n,))
                  for i in range(len(shards) - 1)]
        rights.append(None if ref is None or shards[-1] is None
                      else torch.zeros(n, dtype=torch.complex64, device=shards[-1].device))
        bins: List[Optional[torch.Tensor]] = []
        concs: List[Optional[torch.Tensor]] = []
        for i, s in enumerate(shards):
            if s is None:
                bins.append(None)
                concs.append(None)
                continue
            right = rights[i]
            ext = torch.cat([s, right])
            idx = (torch.arange(m // hop, device=s.device)[:, None] * hop
                   + torch.arange(n, device=s.device)[None, :])
            spec = torch.fft.fft(ext[idx] * downs[i][None, :], dim=1)
            pw = spec.real ** 2 + spec.imag ** 2
            peak = pw.argmax(dim=1)
            p2 = pw.gather(1, peak[:, None])[:, 0]
            conc = p2 / torch.clamp(pw.sum(dim=1), min=1e-12)
            bins.append(peak.to(torch.int32))
            concs.append(conc.to(torch.float32))
        return _out(bins, axis, mesh), _out(concs, axis, mesh)

    return fn
