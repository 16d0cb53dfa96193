"""Blocks of the port's host runtime."""

from .audio import WavSink
from .pfb import PfbChannelizer, pfb_default_taps
from .stream import Head, StreamDeinterleaver
from .vector import NullSink, NullSource, VectorSink, VectorSource

__all__ = ["Head", "NullSink", "NullSource", "PfbChannelizer", "StreamDeinterleaver",
           "VectorSink", "VectorSource", "WavSink", "pfb_default_taps"]
