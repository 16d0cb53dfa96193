"""The apps that waited for the host plane's blocks, as
``tests/test_examples.py`` runs the reference's: ``keyfob_rx`` (loopback, and
``tx --out``), ``ssb_rx --wav``, ``file_trx rx`` (cs8), ``custom_routes`` and
``adsb_rx --file`` on a capture that ``FileSink`` wrote, each ``main()`` a
subprocess (all started at once, so the file takes one app's time) that must
exit 0 and pass its own check. Then ``ssb_rx --audio`` through
``FakeAudioBackend``, and the keyfob and file-conversion paths against the
reference's examples on the JAX package.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from futuresdr_tpu_torch import Flowgraph, Runtime

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
APPS = {
    "keyfob_rx": ([], "# loopback OK: code round-tripped"),
    "keyfob_rx_tx": (["tx", "--out", "{tmp}/burst.cf32"], "0xA53C96"),
    "ssb_rx": (["--wav", "{tmp}/ssb.wav"], "# loopback OK: both test tones recovered"),
    "file_trx": (["rx", "--out", "{tmp}/cap.cs8", "--samples", "50000"],
                 "wrote 50000 items"),
    "custom_routes": (["--port", "0"], "GET /api/fg/   -> [0, 1]"),
    "adsb_rx": (["--file", "{tmp}/adsb.f32"], "decoded 6 frames"),
}


@pytest.fixture(scope="module")
def app_runs(tmp_path_factory):
    """Every app's ``main()`` in its own process, all started together;
    ``{name: (returncode, stdout, stderr, tmp)}``."""
    from futuresdr_tpu_torch.apps.adsb_rx import synth_stream
    from futuresdr_tpu_torch.blocks import FileSink, VectorSource
    tmp = tmp_path_factory.mktemp("apps")
    fg = Flowgraph()
    fg.connect(VectorSource(synth_stream()), FileSink(str(tmp / "adsb.f32"), np.float32))
    Runtime().run(fg)
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = {}
    for name, (args, _) in APPS.items():
        mod = "futuresdr_tpu_torch.apps." + name.removesuffix("_tx")
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", mod, *[a.format(tmp=tmp) for a in args]], cwd=tmp,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for name, p in procs.items():
        try:
            so, se = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            so, se = p.communicate()
        out[name] = (p.returncode, so, se, tmp)
    return out


@pytest.mark.parametrize("name", sorted(APPS))
def test_app_main_exits_0_and_passes_its_check(app_runs, name):
    rc, so, se, tmp = app_runs[name]
    assert rc == 0, f"{name}:\n{so[-1500:]}\n{se[-1500:]}"
    assert APPS[name][1] in so, so
    if name == "keyfob_rx_tx":
        assert (tmp / "burst.cf32").stat().st_size > 0
    if name == "file_trx":
        assert (tmp / "cap.cs8").stat().st_size == 50_000 * 2
    if name == "ssb_rx":
        assert (tmp / "ssb.wav").stat().st_size > 44


def test_ssb_rx_plays_through_the_audio_sink(tmp_path):
    """``ssb_rx --audio``: the demodulated audio goes to ``AudioSink``, here an
    in-memory device, which receives exactly what the AGC emitted."""
    from futuresdr_tpu_torch.apps import ssb_rx
    from futuresdr_tpu_torch.blocks.audio import FakeAudioBackend, set_audio_backend
    path = str(tmp_path / "usb.cf32")
    ssb_rx.synthesize_usb(256e3, 12e3, 0.3).tofile(path)
    dev = FakeAudioBackend()
    set_audio_backend(dev)
    try:
        audio, fs_audio = ssb_rx.run(path, audio=True)
    finally:
        set_audio_backend(None)
    assert dev.opened == ["output"] and fs_audio == 64_000
    np.testing.assert_array_equal(dev.played_samples(), audio)
    top = ssb_rx.dominant_tones(audio, fs_audio)
    assert all(any(abs(f - w) <= 50 for f in top) for w in ssb_rx.TONES)


def _example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_keyfob_capture_and_decode_equal_the_jax_example(tmp_path):
    """The port's tx writes the reference example's capture byte for byte, and
    both receivers slice the same bits from it."""
    from futuresdr_tpu_torch.apps import keyfob_rx
    ref = _example("keyfob_rx")
    args = (0x5A0F3C, 24, 250e3, 1000.0, 20e3)
    keyfob_rx.run_tx(str(tmp_path / "port.cf32"), *args)
    ref.run_tx(str(tmp_path / "ref.cf32"), *args)
    assert (tmp_path / "port.cf32").read_bytes() == (tmp_path / "ref.cf32").read_bytes()
    bits = keyfob_rx.run_rx(str(tmp_path / "port.cf32"), 24, 250e3, 1000.0)
    np.testing.assert_array_equal(bits, ref.run_rx(str(tmp_path / "ref.cf32"), 24, 250e3,
                                                   1000.0))
    np.testing.assert_array_equal(bits, keyfob_rx.key_bits(0x5A0F3C, 24))


def test_file_trx_conversions_equal_the_jax_example(tmp_path):
    """cf32 -> cs8 -> cf32 through both packages' file paths: the same bytes
    on disk and the same samples back."""
    from futuresdr_tpu_torch.apps import file_trx
    ref = _example("file_trx")
    import futuresdr_tpu as J
    x = (np.random.default_rng(1).uniform(-0.9, 0.9, (20_000, 2)) @ [1, 1j]).astype(
        np.complex64)
    x.tofile(tmp_path / "in.cf32")
    outs = []
    for mod, F, R, tag in ((file_trx, Flowgraph, Runtime, "port"),
                           (ref, J.Flowgraph, J.Runtime, "ref")):
        fg = F()
        last = mod.file_iq_source(fg, str(tmp_path / "in.cf32"), "cf32", False)
        cvt = mod.cf32_to_cs8()
        fg.connect(last, cvt)
        snk_mod = sys.modules[type(cvt).__module__.rsplit(".", 1)[0] + ".io"]
        fg.connect(cvt, snk_mod.FileSink(str(tmp_path / f"{tag}.cs8"), np.int16))
        R().run(fg)
        fg = F()
        last = mod.file_iq_source(fg, str(tmp_path / f"{tag}.cs8"), "cs8", False)
        vs = sys.modules[type(cvt).__module__.rsplit(".", 1)[0] + ".vector"].VectorSink(
            np.complex64)
        fg.connect(last, vs)
        R().run(fg)
        outs.append(vs.items())
    assert (tmp_path / "port.cs8").read_bytes() == (tmp_path / "ref.cs8").read_bytes()
    np.testing.assert_array_equal(outs[0], outs[1])
    assert np.abs(outs[0] - x).max() < np.sqrt(2) / 127    # int8 truncation per part
