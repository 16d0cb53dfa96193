"""Blocks of the port's host runtime."""

from .audio import WavSink
from .stream import Head
from .vector import NullSink, NullSource, VectorSink, VectorSource

__all__ = ["Head", "NullSink", "NullSource", "VectorSink", "VectorSource", "WavSink"]
