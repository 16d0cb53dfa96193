"""The port's apps on their host surfaces, against the JAX package's apps.

The cases of ``tests/test_apps.py`` on the port (the spectrum tone on the
CPU block path, the FM tone recovered on the CPU block path), each held
against the JAX app on the same input; both apps' ``main()`` with argv (and
with stdin for the FM retune loop) on the CPU block path and the Seify dummy
radio; the websocket sink's spectra and Pmt frames read by a
standard-library client; and the card chains (the apps' default) on
``TpuInstance("cpu")`` against the JAX package's at
``tests/test_torch_fm_app.py``'s tolerance.
"""

import asyncio
import base64
import hashlib
import json
import os
import socket
import struct
import threading
import time
import wave

import numpy as np
import pytest
import torch

import futuresdr_tpu as jfs
from futuresdr_tpu import blocks as jblocks
from futuresdr_tpu.apps import fm_receiver as jfm
from futuresdr_tpu.apps import spectrum as jspectrum
from futuresdr_tpu.tpu import TpuKernel as JaxTpuKernel
from futuresdr_tpu_torch import Flowgraph, Pmt, Runtime
from futuresdr_tpu_torch import blocks as tblocks
from futuresdr_tpu_torch.apps import fm_receiver as fm
from futuresdr_tpu_torch.apps import spectrum
from futuresdr_tpu_torch.blocks import (MessageBurst, VectorSink, VectorSource,
                                        WebsocketPmtSink, WebsocketSink)
from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

CPU = TpuInstance("cpu")
FS = 1e6


# ---- a standard-library websocket client ----------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("closed")
        buf += chunk
    return buf


class WsClient:
    """RFC 6455 client: the handshake, reading unmasked server frames,
    sending masked close frames."""

    def __init__(self, port, timeout=30.0):
        deadline = time.monotonic() + timeout
        while True:
            try:
                self.sock = socket.create_connection(("127.0.0.1", port), timeout=timeout)
                break
            except ConnectionRefusedError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.02)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall((f"GET / HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\n"
                           "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                           f"Sec-WebSocket-Key: {key}\r\n"
                           "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        head = b""
        while not head.endswith(b"\r\n\r\n"):
            head += _recv_exact(self.sock, 1)
        lines = head.decode().split("\r\n")
        assert lines[0].startswith("HTTP/1.1 101"), lines[0]
        accept = base64.b64encode(hashlib.sha1(
            key.encode() + b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11").digest()).decode()
        assert f"Sec-WebSocket-Accept: {accept}" in lines

    def recv(self):
        b0, b1 = _recv_exact(self.sock, 2)
        assert b1 & 0x80 == 0, "server frames are unmasked"
        n = b1 & 0x7F
        if n == 126:
            n, = struct.unpack("!H", _recv_exact(self.sock, 2))
        elif n == 127:
            n, = struct.unpack("!Q", _recv_exact(self.sock, 8))
        return b0 & 0x0F, _recv_exact(self.sock, n)

    def send(self, opcode, payload=b""):
        mask = os.urandom(4)
        body = bytes(c ^ mask[i % 4] for i, c in enumerate(payload))
        self.sock.sendall(struct.pack("!BB", 0x80 | opcode, 0x80 | len(payload)) + mask + body)

    def close(self):
        try:
            self.send(0x8, struct.pack("!H", 1000))
            while self.recv()[0] != 0x8:
                pass
        finally:
            self.sock.close()


# ---- tests/test_apps.py on the port ----------------------------------------------------
def _fm_iq(n, offset=0.0):
    t = np.arange(n) / FS
    msg = np.sin(2 * np.pi * 1000.0 * t)
    return np.exp(1j * (2 * np.pi * 75e3 * np.cumsum(msg) / FS
                        + 2 * np.pi * offset * t)).astype(np.complex64)


def _read_wav(path):
    with wave.open(path, "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16).astype(np.float64)


def _peak_hz(pcm, rate=fm.AUDIO_RATE):
    pcm = pcm[len(pcm) // 4:]           # skip transients
    spec = np.abs(np.fft.rfft(pcm * np.hanning(len(pcm))))
    return np.fft.rfftfreq(len(pcm), 1.0 / rate)[np.argmax(spec[5:]) + 5]


def test_spectrum_app_cpu_path_matches_the_jax_app():
    fft = 256
    tone = np.exp(1j * 2 * np.pi * 0.25 * np.arange(64 * fft)).astype(np.complex64)
    fg, sink = spectrum.build_flowgraph(VectorSource(tone), use_tpu=False, fft_size=fft,
                                        collect=True)
    Runtime().run(fg)
    spec = sink.items()
    assert len(spec) >= fft
    assert np.argmax(spec[-fft:]) == round(0.25 * fft)
    jfg, jsink = jspectrum.build_flowgraph(jblocks.VectorSource(tone), use_tpu=False,
                                           fft_size=fft, collect=True)
    jfs.Runtime().run(jfg)
    np.testing.assert_allclose(spec, jsink.items(), rtol=0, atol=1e-6)


def test_spectrum_app_dummy_source_finds_the_dummy_tone():
    fg, sink = spectrum.build_flowgraph(None, use_tpu=False, n_samples=200_000,
                                        collect=True)
    Runtime().run(fg)
    spec = sink.items()
    assert len(spec) == (200_000 // 2048 // 3) * 2048
    assert np.argmax(spec[-2048:]) == round(0.1 * 2048)


def test_fm_receiver_recovers_audio_tone_like_the_jax_app(tmp_path):
    """tests/test_apps.py's FM case on the CPU block path; the PCM is the JAX
    app's within one LSB (the rotator's phase is wrapped per chunk, and the
    two runtimes chunk the stream differently)."""
    iq = _fm_iq(400_000)
    wav, jwav = str(tmp_path / "audio.wav"), str(tmp_path / "jax.wav")
    fg, xlate, sink = fm.build_flowgraph(VectorSource(iq), input_rate=FS, audio_path=wav,
                                         use_tpu=False)
    Runtime().run(fg)
    assert sink.n_written > fm.AUDIO_RATE // 10
    pcm = _read_wav(wav)
    assert abs(_peak_hz(pcm) - 1000.0) < 20.0
    jfg, _, _ = jfm.build_flowgraph(jblocks.VectorSource(iq), input_rate=FS, audio_path=jwav)
    jfs.Runtime().run(jfg)
    jpcm = _read_wav(jwav)
    assert len(pcm) == len(jpcm)
    assert np.abs(pcm - jpcm).max() <= 1.0


def test_fm_receiver_dummy_source_cpu_path():
    fg, xlate, sink = fm.build_flowgraph(None, n_samples=1_000_000, use_tpu=False)
    assert type(xlate).__name__ == "XlatingFir"
    Runtime().run(fg)
    assert sink.n_received == 1_000_000 * 48 // 1000


# ---- both apps' main() -------------------------------------------------------------
def test_spectrum_main_streams_spectra_to_a_websocket_client():
    """``main(["--cpu", "--ws-port", N, ...])``: the dummy radio throttled
    to 2 Msps, so the stream outlasts the client's connect; each frame is
    one 2048-float spectrum whose peak is the dummy tone's bin."""
    port = _free_port()
    argv = ["--cpu", "--args", "driver=dummy,rate=2e6", "--samples", "3000000",
            "--ws-port", str(port)]
    t = threading.Thread(target=spectrum.main, args=(argv,), daemon=True)
    t.start()
    client = WsClient(port)
    try:
        opcode, payload = client.recv()
    finally:
        client.close()
    spec = np.frombuffer(payload, np.float32)
    assert opcode == 0x2 and len(spec) == 2048
    assert np.argmax(spec) == round(0.1 * 2048)
    t.join(timeout=30)
    assert not t.is_alive()


@pytest.mark.parametrize("flag", ["--bf16", "--autotune"])
def test_spectrum_main_flags_of_item_7_raise(flag, capsys):
    """``--bf16`` and ``--autotune`` (ported with the precision and tuning
    slice) run on the CPU blocks as the JAX app does: ``--bf16`` lowers only
    the device chain and says so, ``--autotune`` tunes only the card's; the
    app streams its samples and returns."""
    t = threading.Thread(target=spectrum.main, daemon=True, args=(
        ["--cpu", flag, "--samples", "65536", "--ws-port", str(_free_port())],))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    err = capsys.readouterr().err
    assert ("lowers only the device chain" in err) == (flag == "--bf16")


def test_fm_main_retunes_from_stdin_and_writes_the_wav(tmp_path):
    wav = str(tmp_path / "fm.wav")
    retunes = []

    def lines():
        yield "25000\n"
        yield "not a number\n"
        deadline = time.monotonic() + 20
        while (not os.path.exists(wav) or os.path.getsize(wav) < 44 + 2 * 4800) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        yield "q\n"

    from futuresdr_tpu_torch.runtime import runtime as rt_mod
    real_post = rt_mod.FlowgraphHandle.post_sync

    def spy(self, block, port, data=None):
        retunes.append((type(block).__name__, port, data))
        return real_post(self, block, port, data)

    rt_mod.FlowgraphHandle.post_sync = spy
    try:
        fm.main(["--cpu", "--wav", wav, "--args", "driver=dummy,rate=1e6"],
                stdin=lines())
    finally:
        rt_mod.FlowgraphHandle.post_sync = real_post
    assert retunes == [("XlatingFir", "freq", 25000.0)]
    assert len(_read_wav(wav)) >= 4800


def test_fm_main_tpu_without_a_card_raises(monkeypatch):
    """``main()`` runs the front end on the card unless ``--cpu`` asks for
    the CPU blocks; without a card it raises instead of falling back."""
    import importlib
    inst_mod = importlib.import_module("futuresdr_tpu_torch.tpu.instance")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(inst_mod, "_instance", None)
    with pytest.raises(RuntimeError, match="CUDA"):
        fm.main([], stdin=iter(["q\n"]))


def test_fm_tuner_retune_message_is_the_jax_apps():
    assert fm.tuner_retune(25_000.0).to_json() == {
        "MapStrPmt": {"stage": {"String": "tuner"},
                      "phase_inc": {"F64": -2 * np.pi * 25_000.0 / 1e6}}}


# ---- the websocket sinks ------------------------------------------------------------
def test_websocket_sink_delivers_a_2048_float_chunk_and_answers_ping():
    data = np.arange(64 * 2048, dtype=np.float32)
    fg = Flowgraph()
    ws = WebsocketSink(0, np.float32, chunk_items=2048, mode="block")
    gate = threading.Event()

    class Gate(VectorSource):
        async def work(self, io, mio, meta):
            if not gate.is_set():
                io.block_on(asyncio.sleep(0.005))
                return
            await super().work(io, mio, meta)

    fg.connect(Gate(data), ws)
    running = Runtime().start(fg)
    client = WsClient(ws.bound_port)
    client.send(0x9, b"hi")
    assert client.recv() == (0xA, b"hi")
    gate.set()
    opcode, payload = client.recv()
    assert opcode == 0x2 and len(payload) == 2048 * 4
    np.testing.assert_array_equal(np.frombuffer(payload, np.float32), data[:2048])
    frames = 1
    while frames < 64:
        opcode, payload = client.recv()
        if opcode == 0x8:
            break
        frames += 1
    running.wait_sync(timeout=30)
    client.sock.close()
    assert frames == 64


def test_websocket_pmt_sink_sends_pmt_json_text_frames():
    fg = Flowgraph()
    snk = WebsocketPmtSink(0)
    gate = threading.Event()

    class GatedBurst(MessageBurst):
        async def work(self, io, mio, meta):
            if not gate.is_set():
                io.block_on(asyncio.sleep(0.005))
                return
            await super().work(io, mio, meta)

    burst = GatedBurst(Pmt.vec_f32(np.ones(200, np.float32)), 3)
    fg.connect_message(burst, "out", snk, "in")
    running = Runtime().start(fg)
    client = WsClient(snk.bound_port)
    gate.set()
    got = [client.recv() for _ in range(3)]
    running.wait_sync(timeout=30)
    client.sock.close()
    for opcode, payload in got:
        assert opcode == 0x1
        assert Pmt.from_json(json.loads(payload)) == Pmt.vec_f32(np.ones(200, np.float32))


# ---- the card chains on the CPU against the JAX package's --------------------------------
def test_fm_tpu_chain_matches_the_jax_app_chain():
    """The app's device chain (``front_end_stages``) at 100 kHz offset, in
    a TpuKernel on both packages over 16,000-sample frames: within 1e-4
    (``tests/test_torch_fm_app.py``'s tolerance) after the filters'
    transient."""
    x = _fm_iq(5 * 16_000 + 1_234, offset=100e3)
    outs = []
    for kernel, blocks, stages, kw in (
            (TpuKernel, tblocks, fm.front_end_stages, {"inst": CPU}),
            (JaxTpuKernel, jblocks, jfm.front_end_stages, {})):
        fg = (Flowgraph if kernel is TpuKernel else jfs.Flowgraph)()
        snk = blocks.VectorSink(np.float32)
        fg.connect(blocks.VectorSource(x), kernel(stages(FS, 100e3), np.complex64,
                                                  frame_size=16_000, **kw), snk)
        (Runtime if kernel is TpuKernel else jfs.Runtime)().run(fg)
        outs.append(snk.items())
    assert len(outs[0]) == len(outs[1]) == (len(x) - len(x) % 500) * 24 // 500
    np.testing.assert_allclose(outs[0][200:], outs[1][200:], rtol=0, atol=1e-4)
