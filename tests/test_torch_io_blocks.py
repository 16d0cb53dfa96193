"""The port's Seify radio blocks against the JAX package's.

The cases of ``tests/test_io_blocks.py:33-95`` on the port: the dummy
source's tone, the sink and its handlers, the ``cmd`` map and the file
driver's replay; the dummy driver gives bit-equal samples to the JAX
package's for the same seed and the same read sizes, read directly and
through ``Mocker``.
"""

import time

import numpy as np
import pytest
import torch

import futuresdr_tpu as jfs
from futuresdr_tpu import blocks as jblocks
from futuresdr_tpu import hw as jhw
from futuresdr_tpu_torch import Flowgraph, Mocker, Pmt, Runtime
from futuresdr_tpu_torch import hw
from futuresdr_tpu_torch.blocks import (Head, NullSink, NullSource, SeifyBuilder, SeifySink,
                                        SeifySource, VectorSink, VectorSource)

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)


def test_seify_dummy_source():
    fg = Flowgraph()
    src = SeifyBuilder().args("driver=dummy,throttle=false").sample_rate(1e6).build_source()
    head = Head(np.complex64, 50_000)
    snk = VectorSink(np.complex64)
    fg.connect(src, head, snk)
    Runtime().run(fg)
    x = snk.items()
    assert len(x) == 50_000
    # dummy driver: tone at 10% of fs dominates
    spec = np.abs(np.fft.fft(x[:16384] * np.hanning(16384)))
    assert abs(np.fft.fftfreq(16384)[np.argmax(spec)] - 0.1) < 0.01


@pytest.mark.parametrize("seed", [1, 7])
def test_dummy_driver_bit_equals_the_jax_package(seed):
    args = f"driver=dummy,throttle=false,seed={seed}"
    t, j = hw.Device(args).driver, jhw.Device(args).driver
    t.activate_rx()
    j.activate_rx()
    for n in (1, 4096, 333, 65536, 7):
        np.testing.assert_array_equal(t.read(n), j.read(n))


def test_dummy_source_through_mocker_bit_equals_the_jax_package():
    outs = []
    for mocker, source in ((Mocker, SeifySource), (jfs.Mocker, jblocks.SeifySource)):
        m = mocker(source("driver=dummy,throttle=false,seed=3"))
        m.init_output("out", 10_000)
        m.init()
        m.run()
        m.deinit()
        outs.append(m.output("out"))
    assert len(outs[0]) == 10_000
    np.testing.assert_array_equal(outs[0], outs[1])


def test_seify_sink_writes_every_item():
    fg = Flowgraph()
    snk = SeifySink("driver=dummy")
    fg.connect(VectorSource(np.zeros(10_000, np.complex64)), snk)
    Runtime().run(fg)
    assert snk.device.driver.tx_written == 10_000


def test_seify_sink_and_handlers():
    fg = Flowgraph()
    snk = SeifySink("driver=dummy")
    fg.connect(NullSource(np.complex64), Head(np.complex64, 1 << 40), snk)
    rt = Runtime()
    running = rt.start(fg)
    r = rt.scheduler.run_coro_sync(running.handle.call(snk, "freq", Pmt.f64(433e6)))
    assert r == Pmt.ok()
    assert running.handle.call_sync(snk, "freq", Pmt.string("x")) == Pmt.invalid_value()
    assert running.handle.call_sync(snk, "cmd", Pmt.map({"gain": 12.0})) == Pmt.ok()
    deadline = time.monotonic() + 10
    while snk.device.driver.tx_written == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    running.stop_sync()
    assert snk.device.driver.tx_written > 0
    assert snk.device.driver.frequency == 433e6
    assert snk.device.driver.gain == 12.0


def test_file_driver_replay(tmp_path):
    """driver=file replays an IQ recording through the seify source."""
    path = str(tmp_path / "iq.c64")
    data = np.exp(1j * 2 * np.pi * 0.05 * np.arange(5000)).astype(np.complex64)
    data.tofile(path)
    fg = Flowgraph()
    src = SeifySource(f"driver=file,path={path},throttle=false,repeat=true")
    head = Head(np.complex64, 12_000)
    snk = VectorSink(np.complex64)
    fg.connect(src, head, snk)
    Runtime().run(fg)
    got = snk.items()
    assert len(got) == 12_000
    np.testing.assert_array_equal(got[:5000], data)
    np.testing.assert_array_equal(got[5000:10000], data)   # looped


def test_file_driver_without_repeat_ends_the_stream(tmp_path):
    path = str(tmp_path / "iq.c64")
    data = (np.arange(3000) * (1 + 1j)).astype(np.complex64)
    data.tofile(path)
    fg = Flowgraph()
    snk = VectorSink(np.complex64)
    fg.connect(SeifySource(f"driver=file,path={path},throttle=false,repeat=false"), snk)
    Runtime().run(fg)
    np.testing.assert_array_equal(snk.items(), data)


def test_seify_cmd_config_map():
    fg = Flowgraph()
    src = SeifySource("driver=dummy,throttle=false")
    head = Head(np.complex64, 1 << 40)
    snk = NullSink(np.complex64)
    fg.connect(src, head, snk)
    rt = Runtime()
    running = rt.start(fg)
    r = rt.scheduler.run_coro_sync(running.handle.call(
        src, "cmd", Pmt.map({"freq": 94.2e6, "gain": 30.0})))
    assert r == Pmt.ok()
    assert running.handle.call_sync(src, "sample_rate", Pmt.f64(2e6)) == Pmt.ok()
    assert running.handle.call_sync(src, "cmd", Pmt.f64(1.0)) == Pmt.invalid_value()
    running.stop_sync()
    assert src.device.driver.frequency == 94.2e6
    assert src.device.driver.gain == 30.0
    assert src.device.driver.sample_rate == 2e6


def test_device_args_and_unknown_driver():
    assert hw.parse_args("driver=dummy, rate=1e6,,x=y") == \
        jhw.parse_args("driver=dummy, rate=1e6,,x=y") == \
        {"driver": "dummy", "rate": "1e6", "x": "y"}
    with pytest.raises(ValueError, match="unknown driver"):
        hw.Device("driver=nosuch")
    with pytest.raises(ValueError, match="unknown driver"):
        jhw.Device("driver=nosuch")
    with pytest.raises(ValueError, match="path"):
        hw.Device("driver=file")


def test_builder_applies_its_settings_like_the_jax_builder():
    for builder in (SeifyBuilder, jblocks.SeifyBuilder):
        src = builder().args("driver=dummy").frequency(91e6).gain(3.0).sample_rate(2e6) \
            .build_source()
        d = src.device.driver
        assert (d.frequency, d.gain, d.sample_rate) == (91e6, 3.0, 2e6)
    assert [p.name for p in SeifyBuilder().channels(2).build_source().stream_outputs] == \
        ["out0", "out1"]


def test_source_reads_no_more_than_the_window_it_writes():
    """The read is sized from the window it is written into, even when a
    second look at the buffer would show more space (a reader consumed in
    between): the reference sizes it from a second slice() (ROADMAP Queue 3)."""
    m = Mocker(SeifySource("driver=dummy,throttle=false"))
    m.init_output("out", 1000)
    writer = m.kernel.outputs[0].writer
    real, looks = writer.slice, []

    def slice_():
        looks.append(1)
        s = real()
        return s[:10] if len(looks) == 1 else s

    writer.slice = slice_
    m.init()
    m.run()
    m.deinit()
    assert len(m.output("out")) == 1000
