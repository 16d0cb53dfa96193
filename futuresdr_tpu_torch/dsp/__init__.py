"""DSP helpers: window functions and FIR design."""

from . import firdes, windows

__all__ = ["firdes", "windows"]
