"""Semtech UDP packet-forwarder (GWMP v2) client.

Re-design of the reference's ``PacketForwarderClient``
(``examples/lora/src/packet_forwarder_client.rs``, built on the ``semtech_udp`` crate):
decoded LoRa frames arrive on the ``in`` message port as Pmt maps and are forwarded to
a LoRaWAN gateway bridge / network server as ``PUSH_DATA`` datagrams with the standard
``rxpk`` JSON; ``PULL_DATA`` keepalives hold the downlink path open, ``PULL_RESP``
downlink requests are acknowledged with ``TX_ACK`` and re-posted on the ``downlink``
message port. Pure-socket implementation of the wire protocol (GWMP v2):

    byte 0       protocol version (2)
    bytes 1-2    random token
    byte 3       identifier: PUSH_DATA=0 PUSH_ACK=1 PULL_DATA=2 PULL_RESP=3
                 PULL_ACK=4 TX_ACK=5
    bytes 4-11   gateway EUI (PUSH_DATA / PULL_DATA / TX_ACK)
    bytes 12+    JSON payload

The port's copy of ``futuresdr_tpu/models/lora/forwarder.py``.
"""

from __future__ import annotations

import asyncio
import base64
import json
import time
from typing import Optional

from ...log import logger
from ...runtime.kernel import Kernel, message_handler
from ...types import Pmt

__all__ = ["PacketForwarderClient", "build_rxpk", "datr_string"]

log = logger("lora.forwarder")

PROTOCOL_VERSION = 2
PUSH_DATA, PUSH_ACK, PULL_DATA, PULL_RESP, PULL_ACK, TX_ACK = range(6)

_CODR = {1: "4/5", 2: "4/6", 3: "4/7", 4: "4/8"}


def datr_string(sf: int, bw_hz: int) -> str:
    return f"SF{sf}BW{bw_hz // 1000}"


def build_rxpk(payload: bytes, sf: int, bw_hz: int, cr: int, freq_hz: float,
               snr: float = 0.0, rssi: int = 0, crc_ok: bool = True,
               timestamp_ns: Optional[int] = None) -> dict:
    """One ``rxpk`` object per the Semtech packet-forwarder spec (the fields the
    reference populates via ``RxPkV2``, `packet_forwarder_client.rs:200-216`)."""
    t_ns = timestamp_ns if timestamp_ns is not None else time.time_ns()
    return {
        "time": time.strftime("%Y%m%dT%H%M%S", time.gmtime(t_ns / 1e9))
                + f".{(t_ns % 1_000_000_000) // 1000:06d}Z",
        "tmst": (t_ns // 1000) & 0xFFFFFFFF,
        "freq": round(freq_hz / 1e6, 6),
        "chan": 0,
        "rfch": 0,
        "stat": 1 if crc_ok else -1,
        "modu": "LORA",
        "datr": datr_string(sf, bw_hz),
        "codr": _CODR.get(cr, "4/5"),
        "rssi": int(rssi),
        "lsnr": round(float(snr), 1),
        "size": len(payload),
        "data": base64.b64encode(payload).decode(),
    }


class _Proto(asyncio.DatagramProtocol):
    def __init__(self, owner: "PacketForwarderClient"):
        self.owner = owner

    def datagram_received(self, data, addr):
        self.owner._on_datagram(data)

    def error_received(self, exc):
        log.warning("forwarder socket error: %r", exc)


class PacketForwarderClient(Kernel):
    """Message-plane block: Pmt map in → GWMP ``PUSH_DATA`` out over UDP.

    Input map keys (missing ones default): ``payload`` (blob, required), ``sf``,
    ``bandwidth``, ``cr``, ``freq``, ``snr``, ``crc_ok``, ``timestamp`` (ns).
    Downlinks (``PULL_RESP``) are posted on the ``downlink`` port as maps with the
    decoded ``txpk`` fields and acknowledged with ``TX_ACK``.
    """

    def __init__(self, gateway_eui: str = "00-00-00-00-00-00-00-00",
                 server: str = "127.0.0.1:1700", sf: int = 7,
                 bandwidth: int = 125_000, cr: int = 1, freq_hz: float = 868.1e6,
                 keepalive_s: float = 10.0):
        super().__init__()
        self.eui = bytes(int(x, 16) for x in gateway_eui.replace(":", "-").split("-"))
        assert len(self.eui) == 8, "gateway EUI must be 8 bytes"
        host, port = server.rsplit(":", 1)
        self.server = (host, int(port))
        self.defaults = dict(sf=sf, bandwidth=bandwidth, cr=cr, freq=freq_hz)
        self.keepalive_s = keepalive_s
        self._transport = None
        self._token = 1
        self._keepalive_task = None
        self.acked = 0              # PUSH_ACKs seen (observability / tests)
        self.add_message_output("downlink")

    async def init(self, mio, meta):
        loop = asyncio.get_running_loop()
        self._transport, _ = await loop.create_datagram_endpoint(
            lambda: _Proto(self), remote_addr=self.server)
        self._keepalive_task = asyncio.ensure_future(self._keepalive())
        self._mio = mio

    async def deinit(self, mio, meta):
        if self._keepalive_task is not None:
            self._keepalive_task.cancel()
        if self._transport is not None:
            self._transport.close()

    def _next_token(self) -> bytes:
        self._token = (self._token + 1) & 0xFFFF
        return self._token.to_bytes(2, "big")

    def _send(self, ident: int, body: bytes = b"", with_eui: bool = True,
              token: Optional[bytes] = None) -> None:
        pkt = (bytes([PROTOCOL_VERSION]) + (token or self._next_token())
               + bytes([ident]))
        if with_eui:
            pkt += self.eui
        self._transport.sendto(pkt + body)

    async def _keepalive(self) -> None:
        while True:
            self._send(PULL_DATA)
            await asyncio.sleep(self.keepalive_s)

    def _on_datagram(self, data: bytes) -> None:
        if len(data) < 4 or data[0] != PROTOCOL_VERSION:
            return
        ident = data[3]
        if ident in (PUSH_ACK, PULL_ACK):
            self.acked += 1
        elif ident == PULL_RESP:
            try:
                txpk = json.loads(data[4:].decode()).get("txpk", {})
            except (ValueError, UnicodeDecodeError):
                log.warning("malformed PULL_RESP")
                return
            # ack the downlink (error NONE) — the TX_ACK must ECHO the PULL_RESP's
            # token, that's how the server correlates it — then surface the txpk
            body = json.dumps({"txpk_ack": {"error": "NONE"}}).encode()
            self._send(TX_ACK, body, token=data[1:3])
            if "data" in txpk:
                txpk = dict(txpk)
                txpk["data"] = Pmt.blob(base64.b64decode(txpk["data"]))
            self._mio.post("downlink", Pmt.map(
                {k: (v if isinstance(v, Pmt) else Pmt.from_py(v))
                 for k, v in txpk.items()}))

    @staticmethod
    def _num(m: dict, key: str, default):
        v = m.get(key)
        if v is None:
            return default
        return v.to_float() if isinstance(v, Pmt) else float(v)

    @message_handler(name="in")
    async def in_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        if p.is_finished():
            io.finished = True
            return Pmt.ok()
        try:
            m = p.to_map()
        except Exception:
            log.warning("forwarder expects a map with 'payload'; got %r", p)
            return Pmt.invalid_value()
        if "payload" not in m:
            log.warning("forwarder map lacks 'payload': %r", list(m))
            return Pmt.invalid_value()
        try:
            payload = m["payload"]
            payload = payload.to_blob() if isinstance(payload, Pmt) else bytes(payload)
        except Exception:
            log.warning("forwarder 'payload' is not a blob: %r", m["payload"])
            return Pmt.invalid_value()
        crc = m.get("crc_ok", True)
        ts = m.get("timestamp")
        rxpk = build_rxpk(
            payload,
            sf=int(self._num(m, "sf", self.defaults["sf"])),
            bw_hz=int(self._num(m, "bandwidth", self.defaults["bandwidth"])),
            cr=int(self._num(m, "cr", self.defaults["cr"])),
            freq_hz=self._num(m, "freq", self.defaults["freq"]),
            snr=self._num(m, "snr", 0.0),
            crc_ok=crc.to_bool() if isinstance(crc, Pmt) else bool(crc),
            timestamp_ns=int(ts.to_int()) if isinstance(ts, Pmt) else ts)
        self._send(PUSH_DATA, json.dumps({"rxpk": [rxpk]}).encode())
        return Pmt.ok()
