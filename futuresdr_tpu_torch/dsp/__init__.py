"""DSP helpers: window functions, FIR design (windowed, Kaiser, Remez), the
streaming filter cores and the fixed-point NCO phase."""

from . import firdes, fxpt, kernels, remez, windows
from .kernels import (DecimatingFirFilter, FirFilter, IirFilter, PolyphaseResamplingFir,
                      Rotator)

__all__ = ["firdes", "fxpt", "kernels", "remez", "windows", "FirFilter",
           "DecimatingFirFilter", "PolyphaseResamplingFir", "IirFilter", "Rotator"]
