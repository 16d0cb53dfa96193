"""rtl_tcp driver: real RTL-SDR hardware over the rtl_tcp network protocol.

A copy of ``futuresdr_tpu/hw/rtl_tcp.py``. The reference reaches
RTL-SDR/HackRF/Soapy hardware through the external seify HAL
(``src/blocks/seify/builder.rs``); this driver gives the same capability with zero
native dependencies by speaking the ``rtl_tcp`` wire protocol (shipped with librtlsdr,
speaks to any RTL dongle on the network):

- on connect the server sends a 12-byte greeting: ``"RTL0"`` magic, tuner type (u32 BE),
  tuner gain count (u32 BE);
- the client tunes with 5-byte commands ``[id, u32 param BE]`` — 0x01 frequency Hz,
  0x02 sample rate Hz, 0x03 gain mode (1 = manual), 0x04 gain in tenths of dB,
  0x08 AGC mode;
- the server then streams interleaved unsigned-8-bit I/Q; samples map to complex64 as
  ``(u8 − 127.5)/127.5``.

Usage: ``SeifySource(args="driver=rtl_tcp,host=192.168.1.5,port=1234,rate=2.4e6,
freq=100e6,gain=28")``. ``SeifySource`` is a blocking block: a ``read`` that
waits on the socket (up to its 10 s timeout) holds its own thread, never the
runtime's event loop; a read cut short by a lull hands back what arrived,
and only the read after the server closed returns ``None`` (end of stream).
"""

from __future__ import annotations

import socket
import struct
from typing import Dict, Optional

import numpy as np

from . import Driver, register_driver
from ..log import logger

__all__ = ["RtlTcpDriver"]

log = logger("hw.rtl_tcp")

CMD_FREQUENCY = 0x01
CMD_SAMPLE_RATE = 0x02
CMD_GAIN_MODE = 0x03
CMD_GAIN = 0x04
CMD_FREQ_CORRECTION = 0x05
CMD_AGC_MODE = 0x08


class RtlTcpDriver(Driver):
    """``driver=rtl_tcp,host=...,port=...[,rate=][,freq=][,gain=]``."""

    def __init__(self, args: Dict[str, str]):
        super().__init__(args)
        self.host = args.get("host", "127.0.0.1")
        self.port = int(float(args.get("port", 1234)))
        self._sock: Optional[socket.socket] = None
        self._leftover = b""        # odd trailing byte of a half-received I/Q pair
        self.tuner_type = 0
        self.tuner_gain_count = 0

    # -- connection -----------------------------------------------------------
    def _connect(self) -> None:
        s = socket.create_connection((self.host, self.port), timeout=10.0)
        s.settimeout(10.0)
        magic = self._recv_exact(s, 12)
        if magic[:4] != b"RTL0":
            s.close()
            raise ConnectionError(
                f"{self.host}:{self.port} is not an rtl_tcp server "
                f"(magic {magic[:4]!r})")
        self.tuner_type, self.tuner_gain_count = struct.unpack(">II", magic[4:])
        self._sock = s
        log.info("rtl_tcp %s:%d connected (tuner type %d, %d gains)",
                 self.host, self.port, self.tuner_type, self.tuner_gain_count)

    @staticmethod
    def _recv_exact(s: socket.socket, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("rtl_tcp server closed the connection")
            buf += chunk
        return buf

    def _cmd(self, cmd: int, param: int) -> None:
        if self._sock is not None:
            self._sock.sendall(struct.pack(">BI", cmd, int(param) & 0xFFFFFFFF))

    # -- tuning (live when connected, latched otherwise) ------------------------
    def set_sample_rate(self, rate: float, channel: int = 0):
        super().set_sample_rate(rate, channel)
        self._cmd(CMD_SAMPLE_RATE, int(rate))

    def set_frequency(self, freq: float, channel: int = 0):
        super().set_frequency(freq, channel)
        self._cmd(CMD_FREQUENCY, int(freq))

    def set_gain(self, gain: float, channel: int = 0):
        super().set_gain(gain, channel)
        self._cmd(CMD_GAIN_MODE, 1)                 # manual
        self._cmd(CMD_GAIN, int(round(gain * 10)))  # tenths of dB

    # -- streaming --------------------------------------------------------------
    def activate_rx(self, channels=(0,)):
        if self._sock is None:
            self._connect()
        self._cmd(CMD_SAMPLE_RATE, int(self.sample_rate))
        self._cmd(CMD_FREQUENCY, int(self.frequency))
        if self.gain is not None:                   # 0.0 dB is a valid manual gain
            self._cmd(CMD_GAIN_MODE, 1)
            self._cmd(CMD_GAIN, int(round(self.gain * 10)))
        else:
            self._cmd(CMD_AGC_MODE, 1)

    def read(self, n: int):
        if self._sock is None:
            raise RuntimeError("rtl_tcp: read before activate_rx")
        # collect up to 2n bytes; on server close deliver the partial tail first
        # and signal EOS (None) on the NEXT read
        buf = self._leftover
        self._leftover = b""
        want = 2 * n
        eos = False
        while len(buf) < want:
            try:
                chunk = self._sock.recv(want - len(buf))
            except socket.timeout:
                # a lull on a live connection is NOT end-of-stream: hand back what we
                # have (possibly nothing) and let the caller poll again
                break
            except OSError:
                chunk = b""
            if not chunk:
                eos = True
                break
            buf += chunk
        if eos and len(buf) < 2:
            return None                             # EOS: server gone → finish
        raw = buf[:(len(buf) // 2) * 2]
        # a half pair at a timeout boundary belongs to the NEXT read — dropping it
        # would shift the stream one byte and swap I/Q for the rest of the session
        self._leftover = buf[len(raw):]
        u = np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
        u = (u - 127.5) / 127.5
        return (u[0::2] + 1j * u[1::2]).astype(np.complex64)

    def deactivate(self):
        if self._sock is not None:
            self._sock.close()
            self._sock = None


register_driver("rtl_tcp", RtlTcpDriver)
