"""The port's remote client against the JAX package's.

The client half of ``tests/test_io_blocks.py::test_ctrl_port_rest_roundtrip``
on the port: ``futuresdr_tpu_torch.ctrl.Remote`` (standard library HTTP)
lists the flowgraphs, reads a block's typed handlers and the ``connections()``
with a stream edge, and calls a handler, answered ``Pmt.ok()``. Against one
of the port's control ports the reference's ``Remote`` (aiohttp) gives the
same descriptions, connections and reply Pmts; a status outside 2xx raises
in both. Servers bind port 0 (the JAX one a port found free).
"""

import asyncio
import socket

import aiohttp
import numpy as np
import pytest
import torch

from futuresdr_tpu.ctrl import Remote as JaxRemote
from futuresdr_tpu.runtime.ctrl_port import ControlPort as JaxControlPort
import futuresdr_tpu as jfs
from futuresdr_tpu_torch import Flowgraph, Pmt, Runtime
from futuresdr_tpu_torch.blocks import Head, NullSink, SignalSource
from futuresdr_tpu_torch.ctrl import Remote, RemoteError
from futuresdr_tpu_torch.runtime.ctrl_port import ControlPort

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def served():
    """A running ``SignalSource -> Head -> NullSink`` behind the port's
    control port; yields the port's URL and the source."""
    fg = Flowgraph()
    src = SignalSource("complex", 1000.0, 48000.0)
    fg.connect(src, Head(np.complex64, 10_000_000_000), NullSink(np.complex64))
    rt = Runtime()
    cp = ControlPort(rt.handle, bind="127.0.0.1:0")
    cp.start()
    running = rt.start(fg)
    try:
        yield cp.url, src
    finally:
        running.stop_sync()
        cp.stop()
        rt.shutdown()


async def _session(remote, pmt_f64):
    """What a client reads and calls; every value as plain JSON."""
    fgs = await remote.flowgraphs()
    rfg = await remote.flowgraph(fgs[0].id)
    desc = await rfg.description()
    blocks = await rfg.blocks()
    blk = await rfg.block(0)
    conns = await rfg.connections()
    ok = await blk.callback("freq", pmt_f64(3000.0))
    by_index = await blk.callback(blk.handlers().index("freq"), pmt_f64(2000.0))
    null = await blk.call("freq")
    plain = await blk.callback("freq", 2500.0)
    return {"ids": [f.id for f in fgs], "desc": desc,
            "blocks": [(b.id, b.instance_name, b.type_name, b.handlers()) for b in blocks],
            "block": (blk.instance_name, blk.type_name, blk.handlers(), blk.description),
            "conns": [(c.kind, c.src.id, c.src_port, c.dst.id, c.dst_port) for c in conns],
            "replies": [r.to_json() for r in (ok, by_index, null, plain)], "ok": ok}


def test_remote_roundtrip_on_the_port(served):
    url, src = served

    async def via_client():
        rfg = await Remote(url).flowgraph(0)
        blk = await rfg.block(0)
        assert "freq" in blk.handlers()           # typed handler enumeration
        assert blk.type_name == "SignalSource"
        conns = await rfg.connections()
        assert any(c.kind == "stream" for c in conns)
        assert "SignalSource" in repr(conns[0])
        return await blk.callback("freq", Pmt.f64(3000.0))

    assert asyncio.run(via_client()) == Pmt.ok()
    assert src._inc == pytest.approx(2 * np.pi * 3000.0 / 48000.0)


def test_remote_matches_the_jax_client(served):
    url, src = served
    got = asyncio.run(_session(Remote(url), Pmt.f64))
    want = asyncio.run(_session(JaxRemote(url), jfs.Pmt.f64))
    assert got["ok"] == Pmt.ok()
    for key in ("ids", "desc", "blocks", "block", "conns", "replies"):
        assert got[key] == want[key], key
    assert got["ids"] == [0]
    assert ("stream", 0, "out", 1, "in") in got["conns"]
    assert got["replies"][0] == "Ok"
    assert src._inc == pytest.approx(2 * np.pi * 2500.0 / 48000.0)


def test_remote_raises_outside_2xx(served):
    url, _ = served

    async def fail(remote, what):
        if what == "fg":
            return await (await remote.flowgraph(5)).description()
        return await (await remote.flowgraph(0)).block(9)

    for what in ("fg", "block"):
        with pytest.raises(RemoteError) as e:
            asyncio.run(fail(Remote(url), what))
        assert e.value.status == 404
        with pytest.raises(aiohttp.ClientResponseError) as j:
            asyncio.run(fail(JaxRemote(url), what))
        assert j.value.status == e.value.status
    with pytest.raises(ValueError, match="http"):
        Remote("ftp://127.0.0.1:1/")
    with pytest.raises(RemoteError) as e:          # a route's 405 raises too
        asyncio.run(Remote(url)._post("/api/fg/", {}))
    assert e.value.status == 405


def test_port_client_reads_the_jax_control_port():
    """The port's client speaks to the reference's aiohttp control port too."""
    fg = jfs.Flowgraph()
    src = jfs.blocks.SignalSource("complex", 1000.0, 48000.0)
    fg.connect(src, jfs.blocks.Head(np.complex64, 10_000_000_000),
               jfs.blocks.NullSink(np.complex64))
    rt = jfs.Runtime()
    port = _free_port()
    cp = JaxControlPort(rt.handle, bind=f"127.0.0.1:{port}")
    cp.start()
    running = rt.start(fg)
    try:
        url = f"http://127.0.0.1:{port}"
        got = asyncio.run(_session(Remote(url), Pmt.f64))
        want = asyncio.run(_session(JaxRemote(url), jfs.Pmt.f64))
        for key in ("ids", "desc", "blocks", "block", "conns", "replies"):
            assert got[key] == want[key], key
        assert got["ok"] == Pmt.ok()
    finally:
        running.stop_sync()
        cp.stop()
