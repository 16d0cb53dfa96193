"""Meshtastic over LoRa: modem presets, channel keys, and packet codec.

The port's copy of ``futuresdr_tpu/models/lora/meshtastic.py``, unchanged.

Re-design of the reference's meshtastic support (``examples/lora/src/meshtastic.rs``:
``MeshtasticConfig`` presets, ``MeshtasticChannel`` AES-CTR channel crypto and name
hash, ``MeshPacket`` header parse; ``bin/rx_meshtastic.rs`` wiring). The protobuf
``Data`` payload is handled with a minimal varint codec (fields: 1=portnum,
2=payload) rather than a generated binding.
"""

from __future__ import annotations

import base64
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .phy import LoraParams

__all__ = ["MeshtasticConfig", "PRESETS", "preset", "MeshtasticChannel",
           "MeshPacket", "encode_data_proto", "decode_data_proto"]

# Meshtastic's well-known default channel key ("AQ==" expands to this AES-128 key)
DEFAULT_KEY = bytes([0xd4, 0xf1, 0xbb, 0x3a, 0x20, 0x29, 0x07, 0x59,
                     0xf0, 0xbc, 0xff, 0xab, 0xcf, 0x4e, 0x69, 0x01])


@dataclass(frozen=True)
class MeshtasticConfig:
    """One modem preset: bandwidth/sf/cr/frequency/ldro (`meshtastic.rs:31-246`)."""

    bandwidth_hz: int
    sf: int
    cr: int                  # LoRa coding rate 4/(4+cr)
    frequency_hz: int
    ldro: bool

    def lora_params(self, **kw) -> LoraParams:
        return LoraParams(sf=self.sf, cr=self.cr, ldro=self.ldro,
                          bw_hz=self.bandwidth_hz,
                          sync_word=0x2B, **kw)     # Meshtastic sync word 0x2B


PRESETS: Dict[str, MeshtasticConfig] = {
    # EU868
    "ShortFastEu": MeshtasticConfig(250_000, 7, 1, 869_525_000, False),
    "ShortSlowEu": MeshtasticConfig(250_000, 8, 1, 869_525_000, False),
    "MediumFastEu": MeshtasticConfig(250_000, 9, 1, 869_525_000, False),
    "MediumSlowEu": MeshtasticConfig(250_000, 10, 1, 869_525_000, False),
    "LongFastEu": MeshtasticConfig(250_000, 11, 1, 869_525_000, False),
    "LongModerateEu": MeshtasticConfig(125_000, 11, 4, 869_587_500, True),
    "LongSlowEu": MeshtasticConfig(125_000, 12, 4, 869_587_500, True),
    "VeryLongSlowEu": MeshtasticConfig(62_500, 12, 4, 869_492_500, True),
    # US915
    "ShortTurboUs": MeshtasticConfig(500_000, 7, 1, 906_875_000, False),
    "ShortFastUs": MeshtasticConfig(250_000, 7, 1, 906_875_000, False),
    "ShortSlowUs": MeshtasticConfig(250_000, 8, 1, 906_875_000, False),
    "MediumFastUs": MeshtasticConfig(250_000, 9, 1, 906_875_000, False),
    "MediumSlowUs": MeshtasticConfig(250_000, 10, 1, 906_875_000, False),
    "LongTurboUs": MeshtasticConfig(500_000, 11, 1, 906_875_000, False),
    "LongFastUs": MeshtasticConfig(250_000, 11, 1, 906_875_000, False),
    "LongModerateUs": MeshtasticConfig(125_000, 11, 4, 904_437_500, True),
    "LongSlowUs": MeshtasticConfig(125_000, 12, 4, 904_437_500, True),
    "VeryLongSlowUs": MeshtasticConfig(62_500, 12, 4, 916_218_750, True),
}


def preset(name: str) -> MeshtasticConfig:
    """Case-insensitive preset lookup, or ``bw,sf,cr,freq,ldro`` custom string."""
    for k, v in PRESETS.items():
        if k.lower() == name.lower():
            return v
    parts = [s.strip() for s in name.split(",")]
    if len(parts) == 5:
        return MeshtasticConfig(int(parts[0]), int(parts[1]), int(parts[2]),
                                int(parts[3]), parts[4].lower() in ("1", "true", "on"))
    raise KeyError(f"unknown Meshtastic preset {name!r} "
                   f"(known: {', '.join(PRESETS)}, or 'bw,sf,cr,freq,ldro')")


@dataclass
class MeshPacket:
    """The 16-byte Meshtastic radio header + encrypted body (`meshtastic.rs:392-414`)."""

    dest: int
    sender: int
    packet_id: int
    flags: int
    channel_hash: int
    data: bytes

    @classmethod
    def parse(cls, b: bytes) -> "MeshPacket":
        if len(b) < 16:
            raise ValueError(f"MeshPacket needs >=16 bytes, got {len(b)}")
        return cls(dest=int.from_bytes(b[0:4], "little"),
                   sender=int.from_bytes(b[4:8], "little"),
                   packet_id=int.from_bytes(b[8:12], "little"),
                   flags=b[12], channel_hash=b[13], data=b[16:])

    def to_bytes(self) -> bytes:
        return (self.dest.to_bytes(4, "little") + self.sender.to_bytes(4, "little")
                + self.packet_id.to_bytes(4, "little") + bytes([self.flags & 0xFF])
                + bytes([self.channel_hash & 0xFF]) + b"\x00\x00" + self.data)


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _read_varint(b: bytes, i: int) -> Tuple[int, int]:
    v = s = 0
    while True:
        v |= (b[i] & 0x7F) << s
        s += 7
        i += 1
        if not b[i - 1] & 0x80:
            return v, i


def encode_data_proto(portnum: int, payload: bytes) -> bytes:
    """Minimal meshtastic.protobufs.Data: field 1 = portnum, field 2 = payload."""
    return (b"\x08" + _varint(portnum)
            + b"\x12" + _varint(len(payload)) + payload)


def decode_data_proto(b: bytes) -> Optional[Tuple[int, bytes]]:
    """Parse (portnum, payload) from a Data message; None if malformed.

    The portnum field must actually be PRESENT and nonzero: portnum 0 is
    UNKNOWN_APP (never a deliverable packet — every real sender sets ≥ 1),
    and a defaulted/zero portnum is exactly what a wrong-key decrypt looks
    like when a 1-byte channel-hash collision lets garbage reach this parser
    (round-5 fuzz campaign, offset 23253: a random channel's xor hash
    collided with another channel's and the lenient parse returned (0, b''))."""
    portnum, payload = 0, b""
    saw_port = False
    i = 0
    try:
        while i < len(b):
            tag, i = _read_varint(b, i)
            field, wire = tag >> 3, tag & 7
            if wire == 0:
                v, i = _read_varint(b, i)
                if field == 1:
                    portnum = v
                    saw_port = True
            elif wire == 2:
                ln, i = _read_varint(b, i)
                if i + ln > len(b):
                    return None        # truncated length: malformed, not short
                if field == 2:
                    payload = b[i:i + ln]
                i += ln
            else:
                return None
    except IndexError:
        return None
    if not saw_port or portnum == 0:
        return None
    return portnum, payload


class MeshtasticChannel:
    """A named channel: key (AES-128/256-CTR) + the 1-byte xor hash used for channel
    matching on the air (`meshtastic.rs:432-505`)."""

    def __init__(self, name: str, key_b64: str = "AQ=="):
        key = base64.b64decode(key_b64)
        if len(key) == 1 and 1 <= key[0] <= 10:
            # simple PSK index 1-10: the default key with the last byte offset
            key = DEFAULT_KEY[:-1] + bytes([(DEFAULT_KEY[-1] + key[0] - 1) & 0xFF])
        if len(key) not in (16, 32):
            raise ValueError(
                "key must decode to 16 or 32 bytes, or a 1-byte simple PSK index 1-10")
        self.key = key
        self.name = name if name and name != "\n" else "<unset>"
        h = 0
        for c in (name or "\n").encode():
            h ^= c
        for c in key:
            h ^= c
        self.hash = h

    def _ctr(self, packet_id: int, sender: int):
        try:
            from cryptography.hazmat.primitives.ciphers import (Cipher, algorithms,
                                                                modes)
        except ImportError as e:                     # pragma: no cover
            raise RuntimeError(
                "Meshtastic channel crypto needs the 'cryptography' package "
                "installed") from e
        iv = packet_id.to_bytes(8, "little") + sender.to_bytes(8, "little")
        return Cipher(algorithms.AES(self.key), modes.CTR(iv))

    def decode(self, pkt: MeshPacket) -> Optional[Tuple[int, bytes]]:
        """Decrypt + parse the Data protobuf; None if the hash or parse fails."""
        if pkt.channel_hash != self.hash:
            return None
        dec = self._ctr(pkt.packet_id, pkt.sender).decryptor()
        plain = dec.update(pkt.data) + dec.finalize()
        return decode_data_proto(plain)

    def encode(self, text: str, sender: int = 0x3A48290E, packet_id: int = 1,
               dest: int = 0xFFFFFFFF, portnum: int = 1) -> MeshPacket:
        """Build an encrypted text packet (portnum 1 = TextMessageApp)."""
        if portnum < 1:
            # the decoder rejects portnum 0 (UNKNOWN_APP — the signature of a
            # wrong-key decrypt); refuse to emit a packet no receiver takes
            raise ValueError("portnum must be >= 1 (0 = UNKNOWN_APP)")
        plain = encode_data_proto(portnum, text.encode())
        enc = self._ctr(packet_id, sender).encryptor()
        return MeshPacket(dest=dest, sender=sender, packet_id=packet_id, flags=0,
                          channel_hash=self.hash,
                          data=enc.update(plain) + enc.finalize())


def decode_any(channels: List[MeshtasticChannel], frame: bytes):
    """Try every configured channel against a received LoRa payload; returns
    (channel, portnum, payload) or None."""
    try:
        pkt = MeshPacket.parse(frame)
    except ValueError:
        return None
    for ch in channels:
        r = ch.decode(pkt)
        if r is not None:
            return ch, r[0], r[1]
    return None
