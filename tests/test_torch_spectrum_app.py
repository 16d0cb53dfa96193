"""The port's spectrum app against the JAX package's, on the CPU.

``apps/spectrum.py`` ``build_flowgraph(VectorSource(...), use_tpu=True,
collect=True, inst=TpuInstance("cpu"))`` on the port's runtime and the JAX
app on its own, on the same tone: the tone's bin (``tests/test_apps.py``) and
the same spectra in dB. The app's chain (FFT, |x|², EMA, 10·log10) also runs
resident over chained frames against the JAX ``Pipeline``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import futuresdr_tpu as jfs
from futuresdr_tpu import blocks as jblocks
from futuresdr_tpu.apps.spectrum import build_flowgraph as j_build
from futuresdr_tpu.ops import stages as J
from futuresdr_tpu_torch import Runtime
from futuresdr_tpu_torch.apps.spectrum import FFT_SIZE, build_flowgraph, spectrum_stages
from futuresdr_tpu_torch.blocks import VectorSource
from futuresdr_tpu_torch.ops import stages as T
from futuresdr_tpu_torch.tpu import TpuInstance

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

CPU = TpuInstance("cpu")


def _tone(n, freq, noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    x = np.exp(1j * 2 * np.pi * freq * np.arange(n))
    x = x + noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


def _port_app(x, fft):
    fg, sink = build_flowgraph(VectorSource(x), fft_size=fft, collect=True, inst=CPU)
    Runtime().run(fg)
    return sink.items()


def _jax_app(x, fft):
    fg, sink = j_build(jblocks.VectorSource(x), use_tpu=True, fft_size=fft, collect=True)
    jfs.Runtime().run(fg)
    return sink.items()


def test_spectrum_app_finds_tone():
    """test_apps.py's case: a tone at 0.125 of the rate peaks in its bin."""
    fft = 512
    spec = _port_app(_tone(64 * fft, 0.125), fft)
    assert len(spec) >= fft
    assert np.argmax(spec[-fft:]) == round(0.125 * fft)


def test_spectrum_app_matches_jax_app():
    """The app at FFT_SIZE 2048 over three 32,768-sample frames of a noisy tone
    (so no bin sits at the log floor): the same item count and the same
    spectra within 1e-3 dB."""
    x = _tone(3 * 32768, 0.3, noise=0.05, seed=7)
    got, ref = _port_app(x, FFT_SIZE), _jax_app(x, FFT_SIZE)
    assert got.dtype == ref.dtype == np.float32
    assert len(got) == len(ref) == len(x)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    assert np.argmax(got[-FFT_SIZE:]) == round(0.3 * FFT_SIZE)


def test_spectrum_chain_matches_jax_over_chained_frames():
    rng = np.random.default_rng(3)
    frames = [(rng.standard_normal(4 * 256) + 1j * rng.standard_normal(4 * 256))
              .astype(np.complex64) for _ in range(3)]
    jp = J.Pipeline([J.fft_stage(256), J.mag2_stage(), J.moving_avg_stage(256, 0.1),
                     J.log10_stage()], np.complex64)
    tp = T.Pipeline(spectrum_stages(256), np.complex64)
    fn, jc = jax.jit(jp.fn()), jp.init_carry()
    tfn, tc = tp.fn(), tp.init_carry("cpu")
    for x in frames:
        jc, a = fn(jc, jnp.asarray(x))
        tc, b = tfn(tc, torch.from_numpy(x))
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-3)


def test_spectrum_app_surfaces_not_ported_raise():
    """The Seify source, the CPU blocks and the websocket sink are ported
    (ROADMAP Queue 1 item 4) and build; ``--bf16`` and ``--autotune``
    (item 7) are ported too: with ``--cpu`` the app streams its samples and
    returns, as the JAX app does (both flags act on the card's chain)."""
    import threading

    from futuresdr_tpu_torch.apps.spectrum import main
    for kw in ({"source": None}, {"use_tpu": False}, {"ws_port": 0}):
        fg, sink = build_flowgraph(**({"source": VectorSource(_tone(1024, 0.1))} | kw),
                                   inst=CPU)
        assert len(fg) >= 3
    assert type(sink).__name__ == "WebsocketSink"
    for flag in ("--bf16", "--autotune"):
        t = threading.Thread(target=main, daemon=True,
                             args=(["--cpu", flag, "--samples", "65536", "--ws-port", "0"],))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
