"""The port's REST control port against the JAX package's.

The REST round trip of ``tests/test_io_blocks.py:144`` and
``tests/test_app_integration.py`` on the port's standard-library server: the
same flowgraph runs in both packages, each behind its own control port, and
every route answers the same status and JSON body. A ``TpuKernel`` retuned
through its ``ctrl`` port over REST (``tests/test_retune.py:126``) gives the
JAX ``TpuKernel``'s output for the same retune at the same frame, within
1e-3 (the rotator's phase-ulp difference, ROADMAP Queue 3); malformed
retunes are answered ``InvalidValue`` (``tests/test_retune.py:186``).
Servers bind port 0 (the JAX one a port found free), so parallel workers
never collide.
"""

import asyncio
import json
import socket
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import futuresdr_tpu as jfs
from futuresdr_tpu import blocks as jblocks
from futuresdr_tpu.ops import stages as J
from futuresdr_tpu.runtime.ctrl_port import ControlPort as JaxControlPort
from futuresdr_tpu.tpu import TpuKernel as JaxTpuKernel
import futuresdr_tpu_torch as tfs
from futuresdr_tpu_torch import Flowgraph, Pmt, Runtime
from futuresdr_tpu_torch import config as tconfig
from futuresdr_tpu_torch.blocks import Head, NullSink, SeifySource, VectorSink
from futuresdr_tpu_torch.dsp import firdes
from futuresdr_tpu_torch.ops import stages as T
from futuresdr_tpu_torch.runtime.ctrl_port import ControlPort
from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

CPU = TpuInstance("cpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _req(base, path, body=None, method=None):
    """``(status, headers, parsed body)`` of one request."""
    data = None if body is None else (body if isinstance(body, bytes)
                                      else json.dumps(body).encode())
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            raw, status, headers = r.read(), r.status, r.headers
    except urllib.error.HTTPError as e:
        raw, status, headers = e.read(), e.code, e.headers
    try:
        return status, headers, json.loads(raw)
    except ValueError:
        return status, headers, raw.decode()


def _radio(pkg, blocks):
    """The dummy radio throttled to 100 ksps: the reference's SeifySource can
    overrun its output window when it runs unthrottled (ROADMAP Queue 3)."""
    fg = pkg.Flowgraph()
    src = blocks.SeifySource("driver=dummy,rate=1e5")
    fg.connect(src, blocks.Head(np.complex64, 1 << 40), blocks.NullSink(np.complex64))
    return fg, src


ROUTES = [
    ("/api/fg/", None, None),
    ("/api/fg/0/", None, None),
    ("/api/fg/0/block/0/", None, None),
    ("/api/fg/0/block/2/", None, None),
    ("/api/fg/0/block/9/", None, None),
    ("/api/fg/5/", None, None),
    ("/api/fg/5/metrics/", None, None),
    ("/api/fg/0/block/0/call/freq/", {"F64": 2000.0}, "POST"),
    ("/api/fg/0/block/0/call/1/", {"F64": 3000.0}, "POST"),
    ("/api/fg/0/block/0/call/freq/", None, "GET"),
    ("/api/fg/0/block/0/call/cmd/", {"MapStrPmt": {"gain": {"F64": 20.0}}}, "POST"),
    ("/api/fg/0/block/0/call/nope/", "Null", "POST"),
    ("/api/fg/0/block/7/call/freq/", {"F64": 1.0}, "POST"),
    ("/api/fg/0/block/0/call/freq/", b"{not json", "POST"),
]


def test_rest_bodies_match_the_jax_control_port():
    t_fg, t_src = _radio(tfs, tfs.blocks)
    j_fg, j_src = _radio(jfs, jblocks)
    t_rt, j_rt = Runtime(), jfs.Runtime()
    t_cp = ControlPort(t_rt.handle, bind="127.0.0.1:0")
    j_port = _free_port()
    j_cp = JaxControlPort(j_rt.handle, bind=f"127.0.0.1:{j_port}")
    t_cp.start()
    j_cp.start()
    t_run, j_run = t_rt.start(t_fg), j_rt.start(j_fg)
    try:
        assert t_cp.port != 0
        for path, body, method in ROUTES:
            t = _req(t_cp.url, path, body, method)
            j = _req(f"http://127.0.0.1:{j_port}", path, body, method)
            assert t[0] == j[0], (path, t, j)
            assert t[2] == j[2], (path, t, j)
            assert t[1]["Access-Control-Allow-Origin"] == "*"
            assert t[1]["Content-Type"] == j[1]["Content-Type"]
        assert t_src.device.driver.frequency == j_src.device.driver.frequency == 3000.0
        assert t_src.device.driver.gain == 20.0
        t_m = _req(t_cp.url, "/api/fg/0/metrics/")[2]
        j_m = _req(f"http://127.0.0.1:{j_port}", "/api/fg/0/metrics/")[2]
        assert list(t_m) == list(j_m)
        for name in t_m:
            base = {"work_calls", "work_time_s", "messages_handled", "restarts",
                    "items_in", "items_out", "buffer_fill", "stalls", "starved"}
            assert base <= set(t_m[name]) and base <= set(j_m[name])
            for key in ("items_in", "items_out", "stalls", "starved"):
                assert set(t_m[name][key]) == set(j_m[name][key])
        assert t_m["SeifySource_0"]["messages_handled"] == \
            j_m["SeifySource_0"]["messages_handled"] == 5
    finally:
        t_run.stop_sync()
        j_run.stop_sync()
        t_cp.stop()
        j_cp.stop()


def test_unknown_paths_and_methods_and_the_connection_header():
    rt = Runtime()
    cp = ControlPort(rt.handle, bind="127.0.0.1:0")
    cp.start()
    try:
        status, headers, body = _req(cp.url, "/nothing/here")
        assert (status, body) == (404, "404: Not Found")
        status, _, body = _req(cp.url, "/api/fg/", b"{}", "POST")
        assert (status, body) == (405, "405: Method Not Allowed")
        status, headers, body = _req(cp.url, "/api/fg/?x=1")
        assert (status, body) == (200, [])
        assert headers["Connection"] == "close"
        assert headers["Access-Control-Allow-Origin"] == "*"
    finally:
        cp.stop()


def test_runtime_starts_the_control_port_from_config(monkeypatch):
    monkeypatch.setattr(tconfig(), "ctrlport_enable", True)
    monkeypatch.setattr(tconfig(), "ctrlport_bind", "127.0.0.1:0")
    rt = Runtime()
    try:
        fg, _ = _radio(tfs, tfs.blocks)
        running = rt.start(fg)
        assert _req(rt.ctrl_port.url, "/api/fg/")[2] == [0]
        running.stop_sync()
        assert _req(rt.ctrl_port.url, "/api/fg/")[2] == []
    finally:
        rt.shutdown()


def test_config_parses_environment_values_by_type(monkeypatch):
    from futuresdr_tpu_torch.config import Config
    monkeypatch.setenv("FUTURESDR_TPU_CTRLPORT_ENABLE", "true")
    monkeypatch.setenv("FUTURESDR_TPU_CTRLPORT_BIND", "0.0.0.0:4242")
    monkeypatch.setenv("FUTURESDR_TPU_QUEUE_SIZE", "17")
    c = Config.from_env()
    assert (c.ctrlport_enable, c.ctrlport_bind, c.queue_size) == \
        (True, "0.0.0.0:4242", 17)
    monkeypatch.setenv("FUTURESDR_TPU_CTRLPORT_ENABLE", "maybe")
    with pytest.raises(ValueError, match="boolean"):
        Config.from_env()


# ---- a TpuKernel retuned over REST against the JAX TpuKernel -------------------------
FS = 256_000.0
F_A, F_B = 60_000.0, -90_000.0
FRAME = 4096
N = 16 * FRAME
N_BEFORE = 6 * FRAME
TUNER_TAPS = firdes.kaiser_lowpass(0.05, 0.02).astype(np.float32)


def _stations():
    t = np.arange(N) / FS
    return (np.exp(2j * np.pi * F_A * t) + 0.25 * np.exp(2j * np.pi * F_B * t)) \
        .astype(np.complex64)


def _tuner_stages(m):
    return [m.rotator_stage(-2 * np.pi * F_A / FS, name="tuner"),
            m.fir_stage(TUNER_TAPS, name="chan"), m.mag2_stage()]


def _gated_source(kernel_cls, data):
    """A source that emits ``data`` only as far as ``release(n)`` allows."""

    class Gated(kernel_cls):
        def __init__(self):
            super().__init__()
            self.output = self.add_stream_output("out", np.complex64)
            self.pos = 0
            self.allowed = 0

        def release(self, n):
            self.allowed = n

        async def work(self, io, mio, meta):
            out = self.output.slice()
            n = min(len(out), self.allowed - self.pos)
            if n > 0:
                out[:n] = data[self.pos:self.pos + n]
                self.output.produce(n)
                self.pos += n
            if self.pos == len(data):
                io.finished = True
            elif n > 0:
                io.call_again = True
            else:
                io.block_on(asyncio.sleep(0.002))

    return Gated()


def _wait_items(snk, n, timeout=60.0):
    deadline = time.monotonic() + timeout
    while len(snk.items()) < n:
        assert time.monotonic() < deadline, (len(snk.items()), n)
        time.sleep(0.005)


def _retuned_run(pkg, blocks, kernel, stages, retune, **kw):
    """Release N_BEFORE samples, wait for all their outputs, ``retune``,
    then release the rest: the retune lands exactly at frame 6."""
    x = _stations()
    fg = pkg.Flowgraph()
    src = _gated_source(pkg.Kernel, x)
    tk = kernel(_tuner_stages(stages), np.complex64,
                frame_size=FRAME, frames_in_flight=2, **kw)
    snk = blocks.VectorSink(np.float32)
    fg.connect(src, tk, snk)
    rt = pkg.Runtime()
    running = rt.start(fg)
    src.release(N_BEFORE)
    _wait_items(snk, N_BEFORE)
    reply = retune(rt, running, tk)
    src.release(N)
    running.wait_sync()
    return snk.items(), reply


def test_tpu_kernel_ctrl_retune_over_rest_matches_the_jax_ctrl_retune():
    retune_pmt = {"stage": "tuner", "phase_inc": -2 * np.pi * F_B / FS}

    def over_rest(rt, running, tk):
        cp = ControlPort(rt.handle, bind="127.0.0.1:0")
        cp.start()
        try:
            body = Pmt.map(retune_pmt).to_json()
            status, _, r = _req(cp.url, "/api/fg/0/block/1/call/ctrl/", body, "POST")
            bad = _req(cp.url, "/api/fg/0/block/1/call/ctrl/",
                       {"MapStrPmt": {"stage": {"String": "nope"}}}, "POST")[2]
            assert bad == "InvalidValue"
            return status, r
        finally:
            cp.stop()

    def jax_call(rt, running, tk):
        from futuresdr_tpu.types import Pmt as JPmt
        return running.handle.call_sync(tk, "ctrl", JPmt.map(retune_pmt))

    got, (status, reply) = _retuned_run(tfs, tfs.blocks, TpuKernel, T, over_rest, inst=CPU)
    ref, j_reply = _retuned_run(jfs, jblocks, JaxTpuKernel, J, jax_call)
    assert (status, reply) == (200, "Ok")
    assert j_reply.kind.value == "Ok"
    assert len(got) == len(ref) == N
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    # station A (|.|² ≈ 1) before the retune, station B (≈ 0.0625) after it
    assert np.median(got[4 * len(TUNER_TAPS):N_BEFORE]) > 0.5
    assert 0.01 < np.median(got[N_BEFORE + 4 * len(TUNER_TAPS):]) < 0.2


def test_ctrl_rejects_garbage_and_waits_for_init():
    """``tests/test_retune.py:186`` on the port: a malformed message before
    init is answered InvalidValue, not raised."""
    tk = TpuKernel([T.rotator_stage(0.1, name="r")], np.complex64, frame_size=4096,
                   inst=CPU)

    async def call(p):
        return await tk.ctrl_handler(None, None, None, p)

    assert asyncio.run(call(Pmt.f64(1.0))) == Pmt.invalid_value()
    assert asyncio.run(call(Pmt.map({"stage": "r", "phase_inc": 0.2}))) == \
        Pmt.invalid_value()                       # well formed, but before init


@pytest.mark.parametrize("msg", [
    {"stage": "nope", "phase_inc": 0.1},
    {"stage": 7, "phase_inc": 0.1},
    {"stage": "r", "no_such_param": 0.1},
    {"phase_inc": 0.1},
    {"stage": "r", "interior_precision": "fp8"},
])
def test_malformed_or_unported_retunes_answer_invalid_value(msg):
    fg = Flowgraph()
    tk = TpuKernel([T.rotator_stage(0.1, name="r")], np.complex64, frame_size=4096,
                   inst=CPU)
    fg.connect(SeifySource("driver=dummy,throttle=false"), Head(np.complex64, 1 << 40), tk,
               NullSink(np.complex64))
    running = Runtime().start(fg)
    try:
        assert running.handle.call_sync(tk, "ctrl", Pmt.map(msg)) == Pmt.invalid_value()
        # the block lives on and takes a good retune
        assert running.handle.call_sync(tk, "ctrl", Pmt.map(
            {"stage": "r", "phase_inc": 0.2})) == Pmt.ok()
    finally:
        running.stop_sync()
