"""Blocks of the port's host runtime (the reference's ``futuresdr_tpu/blocks``
but for ``zeromq.py``)."""

from .audio import AudioSink, AudioSource, FakeAudioBackend, WavSink, WavSource, \
    set_audio_backend
from .dsp import (Agc, ClockRecoveryMm, Fft, Fir, FirBuilder, Iir, QuadratureDemod,
                  SignalSource, XlatingFir)
from .functional import (Apply, ApplyIntoIter, ApplyNM, Combine, Filter, FiniteSource,
                         Sink, Source, Split)
from .io import (BlobToUdp, ChannelSink, ChannelSource, FileSink, FileSource, TcpSink,
                 TcpSource, UdpSource)
from .message import (MessageAnnotator, MessageApply, MessageBurst, MessageCopy,
                      MessagePipe, MessageSink, MessageSource)
from .pfb import PfbArbResampler, PfbChannelizer, PfbSynthesizer, pfb_default_taps
from .seify import SeifyBuilder, SeifySink, SeifySource
from .stream import (Copy, Delay, Head, MovingAvg, Selector, StreamDeinterleaver,
                     StreamDuplicator, TagDebug, Throttle)
from .vector import CopyRand, NullSink, NullSource, VectorSink, VectorSource
from .websocket import WebsocketPmtSink, WebsocketSink

__all__ = ["Agc", "Apply", "ApplyIntoIter", "ApplyNM", "AudioSink", "AudioSource",
           "BlobToUdp", "ChannelSink", "ChannelSource", "ClockRecoveryMm", "Combine",
           "Copy", "CopyRand", "Delay", "FakeAudioBackend", "Fft", "FileSink", "FileSource",
           "Filter", "FiniteSource", "Fir", "FirBuilder", "Head", "Iir", "MessageAnnotator",
           "MessageApply", "MessageBurst", "MessageCopy", "MessagePipe", "MessageSink",
           "MessageSource", "MovingAvg", "NullSink", "NullSource", "PfbArbResampler",
           "PfbChannelizer", "PfbSynthesizer", "QuadratureDemod", "SeifyBuilder",
           "SeifySink", "SeifySource", "Selector", "SignalSource", "Sink", "Source",
           "Split", "StreamDeinterleaver", "StreamDuplicator", "TagDebug", "TcpSink",
           "TcpSource", "Throttle", "UdpSource", "VectorSink", "VectorSource",
           "WavSink", "WavSource", "WebsocketPmtSink", "WebsocketSink", "XlatingFir",
           "pfb_default_taps", "set_audio_backend"]
