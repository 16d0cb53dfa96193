"""DSP helpers: window functions, FIR design and the streaming filter cores."""

from . import firdes, kernels, windows

__all__ = ["firdes", "kernels", "windows"]
