"""Fixed-point phase arithmetic — drift-free NCO state.

A copy of ``futuresdr_tpu/dsp/fxpt.py``.

Re-design of the reference's ``FixedPointPhase``
(``src/blocks/signal_source/fxpt_phase.rs:11-19``): phase lives in a wrapping
i32 where ``-2^31 ↔ -π`` and ``2^31-1 ↔ π-ε``. Because the per-sample increment
is an exact integer, the accumulated phase never collects floating-point error —
after a billion samples the oscillator is still bit-exactly on its (quantized)
frequency, which a float accumulator is not. Frequency resolution is
``fs / 2^32`` (sub-millihertz at any practical rate).

Deviation from the reference, by design: the reference pairs the i32 phase with
a 10-bit sine LUT because scalar CPU ``sin`` was the bottleneck; here synthesis
is vectorized (numpy/XLA transcendentals over the whole chunk), so the LUT's
speed role is moot and its ~1e-3 amplitude quantization is simply not inherited.
The phase-domain semantics (wrap, increment, retune) are identical.
"""

from __future__ import annotations

import numpy as np

__all__ = ["FixedPointPhase", "advance_u32", "phase_ramp_i32", "i32_to_radians"]

_TWO31 = float(2 ** 31)
_MASK = np.uint64(0xFFFF_FFFF)


def advance_u32(phase: int, inc: int, n: int = 1) -> int:
    """The single wrap-advance rule, unsigned domain: ``(phase + inc·n) mod 2^32``.
    Every fxpt consumer (FixedPointPhase.advance, streaming block state) must go
    through this so a width change happens in exactly one place."""
    return (int(phase) + int(inc) * int(n)) & 0xFFFF_FFFF


def _wrap_to_i32(x_rad: float) -> int:
    """Fold radians into [-π, π) and quantize to the i32 phase domain."""
    tau = 2.0 * np.pi
    d = np.floor(x_rad / tau + 0.5)
    x = x_rad - d * tau
    return int(np.int32(np.clip(round(x * _TWO31 / np.pi), -(2 ** 31), 2 ** 31 - 1)))


class FixedPointPhase:
    """Wrapping-i32 phase accumulator (`fxpt_phase.rs:11-19` semantics)."""

    __slots__ = ("value",)

    def __init__(self, radians: float = 0.0, *, raw: int | None = None):
        self.value = int(np.int32(raw)) if raw is not None else _wrap_to_i32(radians)

    @staticmethod
    def increment_for(frequency: float, sample_rate: float) -> int:
        """Exact i32 per-sample increment for a tone at ``frequency``."""
        cycles = frequency / sample_rate
        v = round((cycles % 1.0) * 2 ** 32) & 0xFFFF_FFFF
        return v - 2 ** 32 if v >= 2 ** 31 else v

    def advance(self, inc: int, n: int = 1) -> "FixedPointPhase":
        """Phase after ``n`` wrapping additions of ``inc`` — O(1), exact."""
        v = advance_u32(self.value, inc, n)
        return FixedPointPhase(raw=v - 2 ** 32 if v >= 2 ** 31 else v)

    def to_radians(self) -> float:
        return self.value * (np.pi / _TWO31)

    def __eq__(self, other) -> bool:
        return isinstance(other, FixedPointPhase) and self.value == other.value

    def __hash__(self) -> int:
        return hash(self.value)

    def __repr__(self) -> str:
        return f"FixedPointPhase({self.to_radians():.6f} rad, {self.value:#x})"


def phase_ramp_i32(start: int, inc: int, n: int) -> np.ndarray:
    """``n`` successive wrapped phases as int32: ``start + inc·[0..n)`` mod 2^32.

    Vectorized in the unsigned domain (int64 intermediate, masked) — the whole
    chunk's phase schedule is exact regardless of chunk boundaries."""
    ramp = (np.uint64(int(start) & 0xFFFF_FFFF) +
            np.uint64(int(inc) & 0xFFFF_FFFF) * np.arange(n, dtype=np.uint64)) & _MASK
    return ramp.astype(np.uint32).view(np.int32)


def i32_to_radians(ph: np.ndarray) -> np.ndarray:
    """Map i32 phases to radians in [-π, π) as float64."""
    return ph.astype(np.float64) * (np.pi / _TWO31)
