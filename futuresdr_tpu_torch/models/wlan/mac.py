"""Minimal 802.11 MAC framing: data frames with FCS (CRC32). The port's copy of
``futuresdr_tpu/models/wlan/mac.py``.

Reference: the WLAN example's ``Mac`` block (``examples/wlan/src/mac.rs``): wraps payloads
in a data MPDU (frame control, duration, addresses, sequence number) and appends/validates
the FCS; sequence numbers increment per frame.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

__all__ = ["mpdu_from_payload", "payload_from_mpdu", "Mac"]


def _fcs(data: bytes) -> bytes:
    return struct.pack("<I", zlib.crc32(data) & 0xFFFFFFFF)


def mpdu_from_payload(payload: bytes, seq: int = 0,
                      dst: bytes = b"\x42" * 6, src: bytes = b"\x23" * 6,
                      bssid: bytes = b"\xff" * 6) -> bytes:
    """Build a data MPDU: FC(2) dur(2) addr1 addr2 addr3 seq(2) body FCS(4)."""
    fc = struct.pack("<H", 0x0008)          # type=data
    dur = struct.pack("<H", 0)
    seq_ctl = struct.pack("<H", (seq & 0xFFF) << 4)
    hdr = fc + dur + dst + src + bssid + seq_ctl
    return hdr + payload + _fcs(hdr + payload)


def payload_from_mpdu(mpdu: bytes) -> Optional[bytes]:
    """Validate FCS and strip the MAC header; None on CRC failure."""
    if len(mpdu) < 28:
        return None
    body, fcs = mpdu[:-4], mpdu[-4:]
    if _fcs(body) != fcs:
        return None
    return body[24:]


class Mac:
    """Stateful framer with an incrementing sequence number."""

    def __init__(self, dst: bytes = b"\x42" * 6, src: bytes = b"\x23" * 6):
        self.dst, self.src = dst, src
        self.seq = 0
        self.decoded = 0
        self.crc_failures = 0

    def frame(self, payload: bytes) -> bytes:
        m = mpdu_from_payload(payload, self.seq, self.dst, self.src)
        self.seq = (self.seq + 1) & 0xFFF
        return m

    def deframe(self, mpdu: bytes) -> Optional[bytes]:
        p = payload_from_mpdu(mpdu)
        if p is None:
            self.crc_failures += 1
        else:
            self.decoded += 1
        return p
