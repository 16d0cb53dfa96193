"""Parks-McClellan equiripple FIR design — native Remez exchange, all four types.

A copy of ``futuresdr_tpu/dsp/remez.py``.

Re-design of the reference's Remez port (``crates/futuredsp/src/firdes/remez_impl.rs:713``,
itself from Janovetz's C): Chebyshev approximation over a dense per-band frequency grid
with barycentric-Lagrange interpolation and extremal exchange. Supports all four
linear-phase types — I/II (symmetric: ``filter_type="bandpass"``) and III/IV
(antisymmetric: ``"hilbert"`` and ``"differentiator"``) — via the standard
amplitude factorization A(f) = Q(f)·P(cos 2πf):

    type I:  Q = 1          type II: Q = cos(πf)
    type III: Q = sin(2πf)  type IV: Q = sin(πf)

The exchange approximates D/Q with weight W·Q; the impulse response is synthesized
exactly from N amplitude samples of the converged polynomial (per-type cosine/sine
series), so the only approximation is the grid discretization itself.

Bands/gains follow the reference API: band edges in cycles/sample (0..0.5), one
desired gain and weight per band.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["remez_exchange"]


def _band_grids(r: int, bands: np.ndarray, density: int, n_taps: int,
                antisym: bool):
    """Per-band dense grids, classic discretization: points spaced
    ``delf = 0.5/(density·r)`` from each band's lower edge, the last point clamped
    to the upper edge. Edges where the structural factor Q vanishes are clamped
    inward by delf (not dropped), keeping the grid aligned with the canonical
    algorithm. Returned per band so extremal candidates never straddle the
    discontinuity between adjacent bands."""
    odd = n_taps % 2 == 1
    delf = 0.5 / (density * r)
    grids = []
    for bi, (f0, f1) in enumerate(bands):
        if bi == 0 and antisym and f0 < delf:
            f0 = delf                       # Q(0) = 0 for types III/IV
        k = max(int((f1 - f0) / delf + 0.5), 8)
        pts = f0 + delf * np.arange(k)
        pts[-1] = f1
        grids.append(pts)
    # Q(0.5) = 0 for type II (sym even) and type III (antisym odd)
    if (not antisym and not odd) or (antisym and odd):
        last = grids[-1]
        if last[-1] > 0.5 - delf:
            last[-1] = 0.5 - delf
    return grids


def _q_factor(f: np.ndarray, n_taps: int, antisym: bool) -> np.ndarray:
    odd = n_taps % 2 == 1
    if not antisym:
        return np.ones_like(f) if odd else np.cos(np.pi * f)
    return np.sin(2 * np.pi * f) if odd else np.sin(np.pi * f)


def _poly_eval(x, xe, ye, b):
    """Barycentric evaluation of the polynomial through (xe, ye) with weights b."""
    dx = x[:, None] - xe[None, :]
    small = np.abs(dx) < 1e-13
    dx = np.where(small, 1.0, dx)
    num = (b * ye / dx).sum(axis=1)
    den = (b / dx).sum(axis=1)
    out = num / den
    hit = small.any(axis=1)
    if hit.any():
        out[hit] = ye[np.argmax(small[hit], axis=1)]
    return out


def remez_exchange(n_taps: int, bands, desired,
                   weight: Optional[Sequence[float]] = None,
                   grid_density: int = 16, max_iters: int = 64,
                   filter_type: str = "bandpass") -> np.ndarray:
    """Design a linear-phase FIR; returns ``n_taps`` coefficients.

    ``bands``: flat ``[f0, f1, f2, f3, ...]`` edge list or list of (lo, hi) pairs;
    ``desired``: one gain per band; ``weight``: one per band (default 1).
    ``filter_type``: "bandpass" (types I/II), "hilbert" (III/IV, antisymmetric),
    or "differentiator" (III/IV with D ∝ f·gain and 1/f weighting within bands,
    as in the reference/scipy conventions).
    """
    assert filter_type in ("bandpass", "hilbert", "differentiator"), filter_type
    bands = np.asarray(bands, dtype=np.float64).reshape(-1, 2)
    n_bands = len(bands)
    desired = [float(d) for d in desired]
    weight = [float(w) for w in (weight if weight is not None else [1.0] * n_bands)]
    assert len(desired) == n_bands and len(weight) == n_bands

    odd = n_taps % 2 == 1
    antisym = filter_type != "bandpass"
    if antisym:
        L = (n_taps - 3) // 2 if odd else n_taps // 2 - 1
    else:
        L = (n_taps - 1) // 2 if odd else n_taps // 2 - 1
    r = L + 2                                  # extremal count (alternations)

    grids = _band_grids(r, bands, grid_density, n_taps, antisym)
    gf, gD, gW = [], [], []
    for g, (f0, f1), d, w in zip(grids, bands, desired, weight):
        D = np.full(len(g), d)
        W = np.full(len(g), w)
        if filter_type == "differentiator":
            D = d * g
            # relative-error weighting where the response is large (Janovetz rule)
            nz = np.abs(D) > 1e-4
            W = np.where(nz, w / np.maximum(np.abs(D), 1e-12), w)
        gf.append(g)
        gD.append(D)
        gW.append(W)

    grid = np.concatenate(gf)
    D = np.concatenate(gD)
    W = np.concatenate(gW)
    Q = _q_factor(grid, n_taps, antisym)
    D = D / Q
    W = W * np.abs(Q)
    x = np.cos(2 * np.pi * grid)
    seg_edges = np.cumsum([0] + [len(g) for g in gf])

    n_grid = len(grid)
    assert n_grid > r, "grid too small for the requested order"
    ext = np.round(np.linspace(0, n_grid - 1, r)).astype(np.int64)

    delta = 0.0
    for _ in range(max_iters):
        xe, de, we = x[ext], D[ext], W[ext]
        diff = xe[:, None] - xe[None, :]
        np.fill_diagonal(diff, 1.0)
        b = 1.0 / np.prod(np.where(np.abs(diff) < 1e-14, 1e-14, diff), axis=1)
        sgn = (-1.0) ** np.arange(r)
        delta = np.dot(b, de) / np.dot(b, sgn / we)
        ae = de - sgn * delta / we
        A = _poly_eval(x, xe[:-1], ae[:-1], b[:-1] * (xe[:-1] - xe[-1]))
        E = W * (D - A)

        # candidates: per-band local maxima of |E| plus BOTH band edges — never
        # across the inter-band discontinuity (the seam is not a real extremum)
        cand = []
        for s0, s1 in zip(seg_edges[:-1], seg_edges[1:]):
            seg = E[s0:s1]
            if len(seg) == 0:
                continue
            cand.append(s0)
            for i in range(1, len(seg) - 1):
                if (seg[i] - seg[i - 1]) * (seg[i + 1] - seg[i]) <= 0:
                    cand.append(s0 + i)
            if s1 - 1 != s0:
                cand.append(s1 - 1)
        cand = np.array(sorted(set(cand)))
        # enforce alternation: of consecutive same-sign candidates keep largest |E|
        kept: list = []
        for i in cand:
            if kept and np.sign(E[i]) == np.sign(E[kept[-1]]):
                if np.abs(E[i]) > np.abs(E[kept[-1]]):
                    kept[-1] = i
            else:
                kept.append(i)
        if len(kept) < r:
            break                              # degenerate; keep previous extremals
        keep_arr = np.array(kept)
        while len(keep_arr) > r:
            # drop the weaker endpoint (classic rule retains the alternation)
            if np.abs(E[keep_arr[0]]) <= np.abs(E[keep_arr[-1]]):
                keep_arr = keep_arr[1:]
            else:
                keep_arr = keep_arr[:-1]
        new_ext = keep_arr
        if np.array_equal(new_ext, ext):
            break
        ext = new_ext
        # classic done test: the error profile is flat over the extremal set
        aE = np.abs(E[ext])
        if (aE.max() - aE.min()) <= 1e-12 * max(aE.max(), 1e-12):
            break

    # exact synthesis: sample the converged amplitude at k/N and apply the
    # per-type cosine/sine series
    xe, de, we = x[ext], D[ext], W[ext]
    diff = xe[:, None] - xe[None, :]
    np.fill_diagonal(diff, 1.0)
    b = 1.0 / np.prod(np.where(np.abs(diff) < 1e-14, 1e-14, diff), axis=1)
    sgn = (-1.0) ** np.arange(len(ext))
    delta = np.dot(b, de) / np.dot(b, sgn / we)
    ae = de - sgn * delta / we

    N = n_taps
    M = (N - 1) / 2.0
    ks = np.arange(N // 2 + 1)
    fk = ks / N                                # 0 .. 0.5
    Qk = _q_factor(fk, n_taps, antisym)
    Pk = _poly_eval(np.cos(2 * np.pi * fk), xe[:-1], ae[:-1],
                    b[:-1] * (xe[:-1] - xe[-1]))
    Ak = Qk * Pk                               # true amplitude at the sample points

    n_idx = np.arange(N)
    h = np.zeros(N)
    if not antisym:
        h += Ak[0]
        hi = N // 2 if N % 2 == 0 else N // 2 + 1
        for k in range(1, hi):
            h += 2 * Ak[k] * np.cos(2 * np.pi * k * (n_idx - M) / N)
        if N % 2 == 0:
            h += Ak[N // 2] * np.cos(np.pi * (n_idx - M))   # structurally 0 (type II)
    else:
        hi = N // 2 if N % 2 == 0 else N // 2 + 1
        for k in range(1, hi):
            h += 2 * Ak[k] * np.sin(2 * np.pi * k * (M - n_idx) / N)
        if N % 2 == 0:
            h += Ak[N // 2] * np.sin(np.pi * (M - n_idx))
    return h / N
