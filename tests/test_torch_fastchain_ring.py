"""The fused native chain's ring size, held against the JAX package: the
inter-stage rings take ``run_chain_task(..., ring_items=)`` or
``FSDR_FASTCHAIN_RING``, which wins where it is set. The ring size shows in
the chunks the native loop moves (each member's ``work_calls``): a smaller
ring moves the same items in more chunks, the port's counts equal the JAX
package's at every size, and the items stay bit for bit the same. A
resampler whose burst would not fit half the ring stays on the actor path in
both packages, and the edges' ``buffer_size`` never reaches the rings."""

import functools

import numpy as np
import pytest
import torch

import futuresdr_tpu as jfs
from futuresdr_tpu import blocks as jblocks
from futuresdr_tpu.runtime import fastchain as jfastchain
from futuresdr_tpu_torch import Flowgraph, Runtime
from futuresdr_tpu_torch import blocks
from futuresdr_tpu_torch.runtime import fastchain

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

N = 100_000
TAPS = (np.arange(8, dtype=np.float32) + 1) / 36


def _run(pkg: str, **edge):
    """VectorSource -> Fir -> VectorSink in ``pkg`` ("port" or "jax"), fused;
    ``edge``: keywords of the edge into the Fir. Returns each member's
    work calls and the sink's items."""
    fgc, rt, b = ((Flowgraph, Runtime, blocks) if pkg == "port"
                  else (jfs.Flowgraph, jfs.Runtime, jblocks))
    x = np.random.default_rng(0).standard_normal(N).astype(np.float32)
    fg = fgc()
    src, fir, snk = b.VectorSource(x), b.Fir(TAPS, np.float32), b.VectorSink(np.float32)
    fg.connect_stream(src, "out", fir, "in", **edge)
    fg.connect_stream(fir, "out", snk, "in")
    rt().run(fg)
    metrics = [fg.wrapped(k).metrics() for k in (src, fir, snk)]
    assert all(m["fused_native"] for m in metrics)
    return [m["work_calls"] for m in metrics], np.asarray(snk.items())


@pytest.mark.parametrize("ring", [None, 4096, 1024, 100])
def test_the_ring_env_sizes_the_rings_as_in_the_jax_package(ring, monkeypatch):
    if ring is None:
        monkeypatch.delenv("FSDR_FASTCHAIN_RING", raising=False)
    else:
        monkeypatch.setenv("FSDR_FASTCHAIN_RING", str(ring))
    calls, got = _run("port")
    jcalls, want = _run("jax")
    assert calls == jcalls
    np.testing.assert_array_equal(got, want)
    # a chunk holds at most a ring's worth of items
    assert calls[0] >= -(-N // (ring or 1 << 16))


def test_ring_items_sizes_the_rings_and_the_env_wins(monkeypatch):
    monkeypatch.delenv("FSDR_FASTCHAIN_RING", raising=False)
    base_calls, base = _run("port")
    monkeypatch.setattr(fastchain, "run_chain_task",
                        functools.partial(fastchain.run_chain_task, ring_items=1024))
    monkeypatch.setattr(jfastchain, "run_chain_task",
                        functools.partial(jfastchain.run_chain_task, ring_items=1024))
    calls, got = _run("port")
    assert calls == _run("jax")[0]
    assert calls[0] >= -(-N // 1024) > base_calls[0]
    np.testing.assert_array_equal(got, base)
    monkeypatch.setenv("FSDR_FASTCHAIN_RING", "4096")
    env_calls = _run("port")[0]
    assert env_calls == _run("jax")[0]
    assert -(-N // 1024) > env_calls[0] >= -(-N // 4096)


def test_an_edges_buffer_size_does_not_reach_the_rings(monkeypatch):
    monkeypatch.delenv("FSDR_FASTCHAIN_RING", raising=False)
    calls, got = _run("port", buffer_size=4096)
    assert (calls, _run("jax", buffer_size=4096)[0]) == (_run("port")[0],) * 2
    np.testing.assert_array_equal(got, _run("port")[1])


@pytest.mark.parametrize("ring,fused", [(None, True), (8, False)])
def test_a_resampler_burst_past_half_the_ring_stays_on_the_actor_path(
        ring, fused, monkeypatch):
    if ring is None:
        monkeypatch.delenv("FSDR_FASTCHAIN_RING", raising=False)
    else:
        monkeypatch.setenv("FSDR_FASTCHAIN_RING", str(ring))
    got = []
    for fgc, b, find in ((Flowgraph, blocks, fastchain.find_native_chains),
                         (jfs.Flowgraph, jblocks, jfastchain.find_native_chains)):
        fg = fgc()
        fg.connect(b.VectorSource(np.zeros(1000, np.float32)),
                   b.Fir(TAPS, np.float32, decim=1, interp=16),
                   b.VectorSink(np.float32))
        got.append(len(find(fg)) == 1)
    assert got == [fused, fused]
