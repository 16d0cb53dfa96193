"""The port's LoRa ecosystem on the CPU: the cases of
``tests/test_lora_ecosystem.py`` (the Semtech UDP packet forwarder against a
fake GWMP v2 server, Meshtastic presets and channel crypto, the multi-channel
receiver through per-channel ``XlatingFir`` blocks or one ``PfbChannelizer`` and a
``PfbArbResampler`` a channel) on the port's copies and runtime, and the
port's ``PfbArbResampler`` against the JAX package's block, bit for bit.
"""

import base64
import json
import socket
import threading

import numpy as np
import pytest
import torch

from futuresdr_tpu_torch import Flowgraph, Pmt, Runtime
from futuresdr_tpu_torch.blocks import MessageSink
from futuresdr_tpu_torch.models.lora import (LoraParams, PacketForwarderClient,
                                             build_multichannel_rx, build_rxpk, meshtastic)
from futuresdr_tpu_torch.models.lora.forwarder import (PROTOCOL_VERSION, PULL_DATA,
                                                       PULL_RESP, PUSH_ACK, PUSH_DATA,
                                                       TX_ACK)

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)


class FakeGwmpServer:
    """Minimal Semtech GWMP v2 server: records PUSH_DATA, acks everything, and can
    inject a PULL_RESP downlink."""

    def __init__(self):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.settimeout(0.2)
        self.addr = self.sock.getsockname()
        self.push_data = []
        self.pull_addrs = []
        self.tx_acks = []           # (token, body) pairs
        self._stop = False
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while not self._stop:
            try:
                data, addr = self.sock.recvfrom(65536)
            except socket.timeout:
                continue
            if len(data) < 4 or data[0] != PROTOCOL_VERSION:
                continue
            token, ident = data[1:3], data[3]
            if ident == PUSH_DATA:
                self.push_data.append(json.loads(data[12:].decode()))
                self.sock.sendto(bytes([PROTOCOL_VERSION]) + token
                                 + bytes([PUSH_ACK]), addr)
            elif ident == PULL_DATA:
                self.pull_addrs.append(addr)
                self.sock.sendto(bytes([PROTOCOL_VERSION]) + token + bytes([4]), addr)
            elif ident == TX_ACK:
                self.tx_acks.append((bytes(token), data[12:]))

    def send_downlink(self, txpk: dict, token: bytes = b"\x5a\xa5"):
        body = json.dumps({"txpk": txpk}).encode()
        for addr in self.pull_addrs[-1:]:
            self.sock.sendto(bytes([PROTOCOL_VERSION]) + token
                             + bytes([PULL_RESP]) + body, addr)

    def close(self):
        self._stop = True
        self.thread.join()
        self.sock.close()


def test_forwarder_push_data_and_downlink():
    server = FakeGwmpServer()
    try:
        fwd = PacketForwarderClient(gateway_eui="aa-bb-cc-dd-ee-ff-00-11",
                                    server=f"127.0.0.1:{server.addr[1]}",
                                    sf=7, bandwidth=125_000, cr=1,
                                    freq_hz=868.1e6, keepalive_s=0.05)
        snk = MessageSink()
        fg = Flowgraph()
        fg.add(fwd)
        fg.connect_message(fwd, "downlink", snk, "in")

        import asyncio

        async def scenario():
            rt = Runtime()
            running = await rt.start_async(fg)
            await running.handle.post(fwd, "in", Pmt.map({
                "payload": Pmt.blob(b"hello-lora"),
                "sf": Pmt.usize(9), "snr": Pmt.f64(7.5)}))
            for _ in range(40):                      # wait for push + keepalive
                await asyncio.sleep(0.05)
                if server.push_data and server.pull_addrs:
                    break
            server.send_downlink({"freq": 869.525, "data":
                                  base64.b64encode(b"dl-payload").decode()})
            for _ in range(40):
                await asyncio.sleep(0.05)
                if snk.received:
                    break
            await running.handle.post(fwd, "in", Pmt.finished())
            await running.wait()

        asyncio.run(scenario())

        assert server.push_data, "no PUSH_DATA reached the server"
        rxpk = server.push_data[0]["rxpk"][0]
        assert rxpk["modu"] == "LORA"
        assert rxpk["datr"] == "SF9BW125"
        assert rxpk["codr"] == "4/5"
        assert base64.b64decode(rxpk["data"]) == b"hello-lora"
        assert rxpk["size"] == len(b"hello-lora")
        assert abs(rxpk["freq"] - 868.1) < 1e-6
        assert rxpk["lsnr"] == 7.5
        assert fwd.acked >= 1                        # PUSH_ACK/PULL_ACK processed
        assert snk.received, "downlink not surfaced"
        dl = snk.received[0].to_map()
        assert dl["data"].to_blob() == b"dl-payload"
        # TX_ACK must echo the PULL_RESP token (servers correlate acks by token)
        assert server.tx_acks and server.tx_acks[0][0] == b"\x5a\xa5"
    finally:
        server.close()


def test_rxpk_fields():
    r = build_rxpk(b"\x01\x02", sf=12, bw_hz=62_500, cr=4, freq_hz=869.4925e6,
                   snr=-19.75, crc_ok=False, timestamp_ns=1_700_000_000_000_000_000)
    assert r["datr"] == "SF12BW62"
    assert r["codr"] == "4/8"
    assert r["stat"] == -1
    assert r["size"] == 2
    assert r["time"].endswith("Z") and "T" in r["time"]


def test_meshtastic_presets_and_channel_roundtrip():
    cfg = meshtastic.preset("longfasteu")
    assert (cfg.sf, cfg.cr, cfg.bandwidth_hz, cfg.ldro) == (11, 1, 250_000, False)
    assert cfg.frequency_hz == 869_525_000
    p = cfg.lora_params()
    assert isinstance(p, LoraParams) and p.sf == 11 and p.sync_word == 0x2B
    assert meshtastic.preset("VeryLongSlowUs").frequency_hz == 916_218_750
    with pytest.raises(KeyError):
        meshtastic.preset("NoSuchPreset")

    # channel crypto roundtrip with the default key
    ch = meshtastic.MeshtasticChannel("LongFast", "AQ==")
    pkt = ch.encode("hello mesh", sender=0x12345678, packet_id=99)
    wire = pkt.to_bytes()
    back = meshtastic.decode_any([ch], wire)
    assert back is not None
    ch2, portnum, payload = back
    assert ch2 is ch and portnum == 1 and payload == b"hello mesh"
    # wrong channel name → hash mismatch → no decode
    other = meshtastic.MeshtasticChannel("Different", "AQ==")
    assert other.decode(meshtastic.MeshPacket.parse(wire)) is None


def test_multichannel_rx_two_channels():
    """Two frames on two EU868 channels inside one wideband stream, both decoded
    with the right channel frequency tag."""
    from futuresdr_tpu_torch.blocks import VectorSource
    from futuresdr_tpu_torch.models.lora.phy import modulate_frame

    p = LoraParams(sf=7)
    rate = 1e6
    center = 867.9e6
    channels = [867.7e6, 868.1e6]
    decim = int(rate // 125e3)

    payloads = [b"chan-A-frame", b"chan-B-frame"]
    n = p.n
    base = np.zeros(int(rate * 0.06), np.complex64)
    t = np.arange(len(base)) / rate
    for f, payload in zip(channels, payloads):
        chips = modulate_frame(payload, p)
        up = np.zeros(len(chips) * decim, np.complex64)   # chip rate → wideband rate
        up[::decim] = chips
        from scipy import signal as sps
        lp = sps.firwin(8 * decim + 1, 0.9 / decim)
        up = sps.lfilter(lp, 1.0, up).astype(np.complex64) * decim
        k = 2000
        seg = min(len(up), len(base) - k)
        base[k:k + seg] += (up[:seg]
                            * np.exp(2j * np.pi * (f - center) * t[:seg])
                            ).astype(np.complex64)

    fg = Flowgraph()
    src = VectorSource(base)
    fg, receivers, tags = build_multichannel_rx(src, rate, center, p,
                                                channels_hz=channels, fg=fg)
    sinks = []
    for tag in tags:
        snk = MessageSink()
        fg.connect_message(tag, "out", snk, "in")
        sinks.append(snk)
    Runtime().run(fg)

    got = {}
    for snk in sinks:
        for m in snk.received:
            d = m.to_map()
            got[d["payload"].to_blob()] = d["freq"].to_float()
    assert got.get(b"chan-A-frame") == 867.7e6
    assert got.get(b"chan-B-frame") == 868.1e6


def test_multichannel_rx_channelizer_front_end():
    """use_channelizer=True: ONE PFB channelizer + per-channel arb resampler
    (the reference `rx_all_channels_eu.rs:109-144` chain) decodes frames on two
    grid channels with the right frequency tags."""
    from futuresdr_tpu_torch.blocks import VectorSource
    from futuresdr_tpu_torch.models.lora.phy import modulate_frame

    p = LoraParams(sf=7)
    rate = 1e6
    center = 867.9e6
    channels = [867.65e6, 868.15e6]            # ±250 kHz: on the 4-slot grid
    decim = int(rate // 125e3)

    payloads = [b"grid-chan-lo", b"grid-chan-hi"]
    base = np.zeros(int(rate * 0.06), np.complex64)
    t = np.arange(len(base)) / rate
    from scipy import signal as sps
    for f, payload in zip(channels, payloads):
        chips = modulate_frame(payload, p)
        up = np.zeros(len(chips) * decim, np.complex64)
        up[::decim] = chips
        lp = sps.firwin(8 * decim + 1, 0.9 / decim)
        up = sps.lfilter(lp, 1.0, up).astype(np.complex64) * decim
        k = 3000
        seg = min(len(up), len(base) - k)
        base[k:k + seg] += (up[:seg]
                            * np.exp(2j * np.pi * (f - center) * t[:seg])
                            ).astype(np.complex64)

    fg = Flowgraph()
    src = VectorSource(base)
    fg, receivers, tags = build_multichannel_rx(src, rate, center, p,
                                                channels_hz=channels, fg=fg,
                                                use_channelizer=True,
                                                spacing_hz=250e3)
    sinks = []
    for tag in tags:
        snk = MessageSink()
        fg.connect_message(tag, "out", snk, "in")
        sinks.append(snk)
    Runtime().run(fg)

    got = {}
    for snk in sinks:
        for m in snk.received:
            d = m.to_map()
            got[d["payload"].to_blob()] = d["freq"].to_float()
    assert got.get(b"grid-chan-lo") == 867.65e6
    assert got.get(b"grid-chan-hi") == 868.15e6


def test_meshtastic_random_roundtrip_fuzz():
    """Seeded sweep: random Meshtastic payloads/senders/packet-ids across
    random channel keys encode→decode exactly; wrong channels never decode."""
    rng = np.random.default_rng(20101)
    for trial in range(10):
        key = base64.b64encode(rng.integers(0, 256, 16).astype(np.uint8)
                               .tobytes()).decode()
        ch = meshtastic.MeshtasticChannel(f"Chan{trial}", key)
        text = bytes(rng.integers(32, 127, int(rng.integers(1, 60)))
                     .astype(np.uint8)).decode()
        sender = int(rng.integers(1, 1 << 32))
        pid = int(rng.integers(1, 1 << 32))
        wire = ch.encode(text, sender=sender, packet_id=pid).to_bytes()
        back = meshtastic.decode_any([ch], wire)
        assert back is not None and back[2].decode() == text, trial
        other = meshtastic.MeshtasticChannel("Other", "AQ==")
        assert other.decode(meshtastic.MeshPacket.parse(wire)) is None, trial


def test_hash_collision_wrong_key_garbage_rejected():
    """Regression (r5 fuzz campaign, offset 23253 trial 5): when a random
    channel's 1-byte xor hash COLLIDES with another channel's, the wrong-key
    decrypt reaches the Data parser — garbage must not parse as a packet.
    The exact colliding configuration is pinned here."""
    rng = np.random.default_rng(20101 + 23253)
    key = sender = pid = text = None
    for trial in range(6):
        key = base64.b64encode(rng.integers(0, 256, 16).astype(np.uint8)
                               .tobytes()).decode()
        ch = meshtastic.MeshtasticChannel(f"Chan{trial}", key)
        text = bytes(rng.integers(32, 127, int(rng.integers(1, 60)))
                     .astype(np.uint8)).decode()
        sender = int(rng.integers(1, 1 << 32))
        pid = int(rng.integers(1, 1 << 32))
    other = meshtastic.MeshtasticChannel("Other", "AQ==")
    assert ch.hash == other.hash          # the collision that let garbage in
    wire = ch.encode(text, sender=sender, packet_id=pid).to_bytes()
    assert other.decode(meshtastic.MeshPacket.parse(wire)) is None
    # the right channel still decodes (portnum-presence gate is not too strict)
    got = meshtastic.decode_any([ch], wire)
    assert got is not None and got[2].decode() == text



@pytest.mark.parametrize("rate", [0.625, 1.6, 0.3])
def test_pfb_arb_resampler_equals_the_jax_package_block(rate):
    """The port's ``PfbArbResampler`` in a flowgraph gives the reference
    block's output bit for bit (both numpy; the reference in its own
    runtime)."""
    from futuresdr_tpu import Flowgraph as JFlowgraph, Runtime as JRuntime
    from futuresdr_tpu.blocks import PfbArbResampler as JResampler
    from futuresdr_tpu.blocks import VectorSink as JSink, VectorSource as JSource
    from futuresdr_tpu_torch.blocks import PfbArbResampler, VectorSink, VectorSource
    rng = np.random.default_rng(40)
    x = (rng.standard_normal(20_000) + 1j * rng.standard_normal(20_000)).astype(np.complex64)
    fg, snk = Flowgraph(), VectorSink(np.complex64)
    fg.connect(VectorSource(x), PfbArbResampler(rate), snk)
    Runtime().run(fg)
    jfg, jsnk = JFlowgraph(), JSink(np.complex64)
    jfg.connect(JSource(x), JResampler(rate), jsnk)
    JRuntime().run(jfg)
    got, want = np.asarray(snk.items()), np.asarray(jsnk.items())
    assert abs(len(got) - rate * len(x)) < 64
    n = min(len(got), len(want))
    assert n > 0.9 * rate * len(x)
    np.testing.assert_array_equal(got[:n], want[:n])
    with pytest.raises(ValueError, match="rate"):
        PfbArbResampler(0.0)
