"""Blocks of the port's host runtime."""

from .audio import WavSink
from .dsp import Fft, Fir, FirBuilder, QuadratureDemod, XlatingFir
from .functional import Apply
from .message import (MessageAnnotator, MessageApply, MessageBurst, MessageCopy,
                      MessagePipe, MessageSink, MessageSource)
from .pfb import PfbArbResampler, PfbChannelizer, pfb_default_taps
from .seify import SeifyBuilder, SeifySink, SeifySource
from .stream import Head, MovingAvg, StreamDeinterleaver
from .vector import NullSink, NullSource, VectorSink, VectorSource
from .websocket import WebsocketPmtSink, WebsocketSink

__all__ = ["Apply", "Fft", "Fir", "FirBuilder", "Head", "MessageAnnotator",
           "MessageApply", "MessageBurst", "MessageCopy", "MessagePipe", "MessageSink",
           "MessageSource", "MovingAvg", "NullSink", "NullSource", "PfbArbResampler",
           "PfbChannelizer", "QuadratureDemod", "SeifyBuilder", "SeifySink", "SeifySource",
           "StreamDeinterleaver", "VectorSink", "VectorSource", "WavSink",
           "WebsocketPmtSink", "WebsocketSink", "XlatingFir", "pfb_default_taps"]
