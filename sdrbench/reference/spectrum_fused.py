"""Plain reference of the spectrum chain (FutureSDR ``perf/fir`` and
``examples/spectrum``): a causal FIR with the configuration's lowpass,
then an N-point FFT of each aligned N-sample block, then |X|².

``u[n] = Σ_t h[t]·x[n−t]`` on the endless stream that repeats the capture
(zero before sample 0); block b holds ``u[bN .. bN+N−1]``. Computed in
float64; nothing here imports the program, the taps are designed again
from the configuration's parameters.

The numbers compared read each bin's amplitude, ``√P``, against the
reference's, in units of its block's RMS amplitude ``√mean(P_reference)``:
the scale of float32's own rounding in a block, so the strong bins and the
weak ones (the noise floor, the stopband) are held alike.

- ``amp_gap``: the largest such gap over every compared bin.
- ``amp_rms``: their root mean square over every compared bin, a steady
  reading of the whole spectrum.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _dsp

# The limits; PERF.md gives the readings they were set from.
LIMITS = {"amp_gap": 1e-3, "amp_rms": 3e-5}
# The control: this reference with TF32 operands in the FIR, the step below
# the configuration's float32 (the chain runs float32 with TF32 off).
CONTROL = {"reference_precision": "tf32"}


def expected(capture: torch.Tensor, config: dict, start: int, n: int,
             precision: Optional[str] = None) -> torch.Tensor:
    """The power spectra of stream inputs ``start .. start+n-1`` (``start``
    and ``n`` multiples of N), flattened."""
    chain = config["chain"]
    h = torch.from_numpy(_dsp.design(chain["fir"])).to(capture.device)
    nt, N = h.shape[0], int(chain["n_fft"])
    x = _dsp.stream(capture, start - (nt - 1), n + nt - 1)
    u = _dsp.fir(x, h, nt - 1, n, precision)
    X = torch.fft.fft(u.reshape(-1, N), dim=1)
    return (X.real * X.real + X.imag * X.imag).reshape(-1)


def compare(pairs, config: dict) -> dict:
    """``amp_gap`` and ``amp_rms`` over ``(program output, reference
    output)`` pairs."""
    N = int(config["chain"]["n_fft"])
    worst, squares, bins = 0.0, 0.0, 0
    for got, want in pairs:
        got = got.reshape(-1, N).to(torch.float64)
        want = want.reshape(-1, N).to(torch.float64)
        amp = got.sign() * got.abs().sqrt()        # a negative power counts as one
        gap = (amp - want.sqrt()).abs() / want.mean(1, keepdim=True).sqrt()
        gap = torch.nan_to_num(gap, nan=float("inf"))
        worst = max(worst, float(gap.max()))
        squares += float(gap.square().sum())
        bins += gap.numel()
    return {"amp_gap": worst, "amp_rms": (squares / bins) ** 0.5 if bins else float("inf")}
