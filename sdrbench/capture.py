"""The one capture generator: a configuration's ``capture`` parameters and a
seed give a complex64 recording made on the device.

``kind: "tones"``: complex Gaussian noise of ``noise_rms`` plus ``tones``
sinusoids at frequencies drawn uniformly over the band, each ``tone_db``
(a range) above the noise. The small parameters come from a host
generator seeded with the seed; the noise from a ``torch.Generator`` on
the device; phases are worked out in float64 a chunk at a time, so a
sample's value does not depend on the chunk it falls in.
"""

from __future__ import annotations

import math

import numpy as np
import torch

CHUNK = 1 << 24


def _phase(freq: float, phase0: float, start: int, n: int, device) -> torch.Tensor:
    """``2π·frac(freq·k) + phase0`` for ``k = start .. start+n-1`` (float64)."""
    k = torch.arange(start, start + n, dtype=torch.float64, device=device)
    return 2.0 * math.pi * torch.remainder(freq * k, 1.0) + phase0


def params(spec: dict, seed: int) -> dict:
    """The capture's drawn parameters (frequencies, levels, phases)."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 0x5D8])
    if spec["kind"] == "tones":
        lo, hi = spec["tone_db"]
        return {"tones": [(float(rng.uniform(-0.5, 0.5)),
                           float(10 ** (rng.uniform(lo, hi) / 20.0)),
                           float(rng.uniform(0, 2 * np.pi))) for _ in range(spec["tones"])]}
    raise ValueError(f"unknown capture kind {spec['kind']!r}")


def make(spec: dict, seed: int, device, samples=None) -> torch.Tensor:
    """The capture: ``samples`` (default ``spec["samples"]``) complex64
    samples on ``device``."""
    n = int(spec["samples"] if samples is None else samples)
    p = params(spec, seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    noise = float(spec.get("noise_rms", 1.0))
    out = torch.randn(n, dtype=torch.complex64, device=device, generator=gen)
    out *= noise                           # randn's complex draw has unit power
    for at in range(0, n, CHUNK):
        m = min(CHUNK, n - at)
        acc = torch.zeros(m, dtype=torch.complex128, device=device)
        for f, amp, ph in p["tones"]:
            acc += amp * noise * torch.polar(
                torch.ones(m, dtype=torch.float64, device=device),
                _phase(f, ph, at, m, device))
        out[at:at + m] += acc.to(torch.complex64)
    return out
