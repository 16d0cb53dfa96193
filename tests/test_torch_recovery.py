"""Recovery on the streamed path on the CPU: the carry checkpoint and the
bit-exact replay of ``TpuKernel``, the fan-out and DAG kernels and the
fused device chains, case for case the reference's device-recovery tests
(``tests/test_policies.py``'s second half, the checkpoint cases of
``tests/test_arena.py``, ``tests/test_uplink.py``'s replay cases and
``tests/test_devchain.py``'s replay-window warning).

Every recovered stream is held bit for bit against the port's own fault-free
run of the same flowgraph; the fault-free run is held against the JAX
package's ``TpuKernel`` on the same flowgraph (FIR then rotator), at the
tolerance the port's rotator comparisons use (``test_torch_fm_stages.py``:
rtol 1e-3, atol 1e-4). Each fault is armed non-transient, seeded, mid-stream;
the seeds are the port's own (its draw sequence differs from the
reference's, whose carry snapshots also draw at the ``d2h`` site), each
chosen so that the fault fires mid-stream, which each case asserts.
"""

import asyncio
import logging
import os
import time

import numpy as np
import pytest
import torch

import futuresdr_tpu as jfs
from futuresdr_tpu.ops import stages as J
from futuresdr_tpu.tpu import TpuKernel as JaxTpuKernel
from futuresdr_tpu_torch import BlockPolicy, Flowgraph, Mocker, Runtime
from futuresdr_tpu_torch.blocks import VectorSink, VectorSource
from futuresdr_tpu_torch.config import config
from futuresdr_tpu_torch.dsp import firdes
from futuresdr_tpu_torch.ops import arena as arena_mod
from futuresdr_tpu_torch.ops import codec_pool, ingest
from futuresdr_tpu_torch.ops import stages as T
from futuresdr_tpu_torch.runtime import faults
from futuresdr_tpu_torch.tpu import TpuInstance, TpuKernel
from futuresdr_tpu_torch.tpu.kernel_block import TpuDagKernel, TpuFanoutKernel
from futuresdr_tpu_torch.types import Pmt
from futuresdr_tpu_torch.utils import snapshot

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

CPU = TpuInstance("cpu")
FRAME = 1 << 11
N = FRAME * 21 + 517          # a partial tail frame, and a partial K-group at EOS
TAPS = firdes.lowpass(0.2, 31).astype(np.float32)
JAX_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    c = config()
    for f in ("block_policy", "checkpoint_dir", "tpu_checkpoint_every", "host_arena",
              "host_arena_mb", "host_codec_workers", "tpu_coalesce",
              "tpu_zero_copy_ingest", "tpu_adaptive_wire"):
        monkeypatch.setattr(c, f, getattr(c, f))
    faults.reset()
    ingest.reset()
    yield
    faults.reset()
    ingest.reset()


def _data(n=N, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


def _stages(m=T):
    """FIR history and rotator phase: both carries must survive a restart."""
    return [m.fir_stage(TAPS, fft_len=256), m.rotator_stage(0.05)]


def _run(data, fault=None, restart=False, k=1, ck=None, max_faults=1, extra=()):
    """``VectorSource -> TpuKernel(FIR, rotator) -> VectorSink``; ``fault`` =
    (site, rate, seed), armed non-transient (the dispatch and work sites
    addressed to the kernel). Returns (output, restarts, kernel)."""
    fg = Flowgraph()
    tk = TpuKernel(_stages(), np.complex64, frame_size=FRAME, inst=CPU,
                   frames_in_flight=2, frames_per_dispatch=k, checkpoint_every=ck)
    if restart:
        tk.policy = BlockPolicy(on_error="restart", max_restarts=4, backoff=0.002)
    snk = VectorSink(np.complex64)
    fg.connect(VectorSource(data), tk, snk)
    name = fg.wrapped(tk).instance_name
    plan = faults.reset()
    if fault:
        site, rate, seed = fault
        plan.arm(f"{site}:{name}" if site in ("dispatch", "work") else site, rate=rate,
                 max_faults=max_faults, seed=seed, transient=False)
    for site, rate, seed, mf in extra:
        plan.arm(site, rate=rate, max_faults=mf, seed=seed)
    try:
        Runtime().run(fg, timeout=60)
    finally:
        faults.reset()
    return np.asarray(snk.items()), fg.wrapped(tk).restarts, tk


_REF = {}


def _ref(k=1):
    """The port's fault-free run at ``k`` (computed once)."""
    if k not in _REF:
        _REF[k] = _run(_data(), k=k)[0]
    return _REF[k]


# ---------------------------------------------------------------------------
# the fault-free stream against the JAX package
# ---------------------------------------------------------------------------

def test_fault_free_stream_matches_the_jax_tpukernel():
    data = _data()
    fg = jfs.Flowgraph()
    snk = jfs.blocks.VectorSink(np.complex64)
    fg.connect(jfs.blocks.VectorSource(data),
               JaxTpuKernel(_stages(J), np.complex64, frame_size=FRAME, frames_in_flight=2),
               snk)
    jfs.Runtime().run(fg)
    want = np.asarray(snk.items())
    got, _, tk = _run(data, restart=True)
    assert tk.extra_metrics()["checkpoint_every"] == 1      # checkpoints on, no fault
    np.testing.assert_array_equal(got, _ref())              # and bit for bit without
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **JAX_TOL)


def test_default_fail_fast_pays_nothing(monkeypatch):
    """Under the default policy with no explicit cadence the cadence reads
    0: no snapshot is taken and the replay log stays empty."""
    calls = []
    orig = T.Pipeline.snapshot_carry
    monkeypatch.setattr(T.Pipeline, "snapshot_carry",
                        lambda self, c: calls.append(1) or orig(self, c))
    got, _, tk = _run(_data())
    m = tk.extra_metrics()
    assert m["checkpoint_every"] == 0 and m["checkpoint_seq"] == -1
    assert m["replay_log_frames"] == 0 and not tk._rlog and not tk._ckpts
    assert calls == []
    np.testing.assert_array_equal(got, _ref())
    # an explicit cadence or a restart policy turns it on
    _, _, tk1 = _run(_data(), ck=2)
    _, _, tk2 = _run(_data(), restart=True)
    assert tk1.extra_metrics()["checkpoint_every"] == 2
    assert tk2.extra_metrics()["checkpoint_every"] == 1
    assert calls


# ---------------------------------------------------------------------------
# TpuKernel: every fault site, K, cadence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("site,rate,seed,mf", [
    ("dispatch", 0.12, 9, 1),
    ("h2d", 0.08, 4, 1),
    ("h2d", 0.2, 3, 2),          # a second fault lands during the recovery
    ("d2h", 0.1, 5, 2),
    ("work", 0.1, 4, 1),
])
def test_restart_replays_bit_exact(site, rate, seed, mf):
    got, restarts, tk = _run(_data(), fault=(site, rate, seed), restart=True,
                             max_faults=mf)
    assert restarts >= 1, (site, seed)
    assert tk.frames_replayed > 0
    np.testing.assert_array_equal(got, _ref())


@pytest.mark.parametrize("ck", [1, 3])
def test_megabatch_restart_replays_bit_exact(ck):
    """K = 4: the log keeps the exact zero-padded group, so the partial EOS
    group replays bit for bit too (against the fault-free K = 4 run)."""
    got, restarts, tk = _run(_data(), fault=("dispatch", 0.3, 5), restart=True, k=4,
                             ck=ck)
    assert restarts == 1 and tk.frames_replayed > 0
    np.testing.assert_array_equal(got, _ref(4))


def test_sparse_cadence_replays_bit_exact():
    got, restarts, tk = _run(_data(), fault=("dispatch", 0.12, 9), restart=True, ck=3)
    assert restarts == 1
    np.testing.assert_array_equal(got, _ref())


def test_checkpoint_off_forfeits_and_counts():
    """Cadence 0: ``recover`` declines, the fresh init forfeits the window
    (counted) and the run completes short."""
    got, restarts, tk = _run(_data(), fault=("dispatch", 0.12, 9), restart=True, ck=0)
    assert restarts == 1
    assert tk.frames_forfeited > 0
    assert tk.extra_metrics()["fsdr_frames_forfeited_total"] == tk.frames_forfeited
    assert len(got) < len(_ref())


def test_carry_fault_falls_back_to_the_previous_checkpoint():
    """The ``carry`` site corrupts checkpoint candidates; the restore's
    integrity check rejects them and falls back, bit for bit."""
    data = _data()
    fg = Flowgraph()
    tk = TpuKernel(_stages(), np.complex64, frame_size=FRAME, inst=CPU, frames_in_flight=2)
    tk.policy = BlockPolicy(on_error="restart", max_restarts=4, backoff=0.002)
    snk = VectorSink(np.complex64)
    fg.connect(VectorSource(data), tk, snk)
    name = fg.wrapped(tk).instance_name
    plan = faults.reset()
    carry_inj = plan.arm("carry", rate=0.3, max_faults=2, seed=3)
    plan.arm(f"dispatch:{name}", rate=0.10, max_faults=1, seed=9, transient=False)
    Runtime().run(fg, timeout=60)
    assert carry_inj.fired >= 1
    assert fg.wrapped(tk).restarts == 1
    np.testing.assert_array_equal(np.asarray(snk.items()), _ref())


def test_corrupted_newest_checkpoint_is_rejected_at_restore():
    """Directly: the newest commit corrupted, recover() takes the older one
    and replays from there, bit for bit."""
    data = _data()
    mk = TpuKernel(_stages(), np.complex64, frame_size=FRAME, inst=CPU, frames_in_flight=2,
                   checkpoint_every=1)
    m = Mocker(mk)
    m.init_output("out", len(data) + FRAME)
    m.init()
    cut = FRAME * 9
    m.input("in", data[:cut])
    m.run()
    s, leaves, spec = mk._ckpts[-1]
    mk._ckpts[-1] = (s, [np.zeros(1, np.uint8)], spec)
    assert asyncio.run(mk.recover(RuntimeError("injected test fault")))
    assert mk._ckpts[-1][0] < s and mk.frames_replayed > 0
    m.input("in", data[cut:])
    m.run()
    np.testing.assert_array_equal(m.output("out")[:cut], _ref()[:cut])


def test_snapshot_is_the_carry_after_its_group():
    """Each committed checkpoint equals the eager pipeline's carry after the
    same frames: the copy is taken in stream order, right behind its
    group's replay (a snapshot taken one group later fails this)."""
    data = _data(FRAME * 6)
    mk = TpuKernel(_stages(), np.complex64, frame_size=FRAME, inst=CPU, frames_in_flight=3,
                   checkpoint_every=1)
    m = Mocker(mk)
    m.init_output("out", len(data))
    m.init()
    m.input("in", data)
    m.run()
    pipe = T.Pipeline(_stages(), np.complex64)
    carry, after = pipe.init_carry("cpu"), []
    fn = pipe.fn()
    for i in range(6):
        carry, _ = fn(carry, torch.from_numpy(data[i * FRAME:(i + 1) * FRAME]))
        after.append([t.clone().numpy() for t in T._leaves(carry)])
    assert [c[0] for c in mk._ckpts] == [4, 5]
    for seq, leaves, _ in mk._ckpts:
        for got, want in zip(leaves, after[seq]):
            np.testing.assert_array_equal(got, want)


def test_retune_before_the_restore_point_is_applied_again():
    """A retune logged between checkpoints is applied again at its group
    when the recovery restores a carry from before it."""
    data = _data()
    taps2 = firdes.lowpass(0.05, 31).astype(np.float32)

    def run(recover_at):
        mk = TpuKernel(_stages(), np.complex64, frame_size=FRAME, inst=CPU,
                       frames_in_flight=2, checkpoint_every=3)
        m = Mocker(mk)
        m.init_output("out", len(data) + FRAME)
        m.init()
        m.input("in", data[:FRAME * 7])
        m.run()
        mk.apply_retune(0, taps=taps2)
        m.input("in", data[FRAME * 7:FRAME * 8])
        m.run()
        if recover_at:
            assert mk._retune_log
            assert asyncio.run(mk.recover(RuntimeError("injected test fault")))
            assert mk._replay_retunes
        m.input("in", data[FRAME * 8:FRAME * 12])
        m.run()
        return m.output("out")[:FRAME * 12]

    np.testing.assert_array_equal(run(True), run(False))


def test_restore_writes_the_carry_through_the_program():
    """The restored carry is new tensors the program copies into its carry
    (``dispatch`` loads it); the program is not built again."""
    data = _data(FRAME * 8)
    mk = TpuKernel(_stages(), np.complex64, frame_size=FRAME, inst=CPU, frames_in_flight=2,
                   checkpoint_every=2)
    m = Mocker(mk)
    m.init_output("out", len(data))
    m.init()
    m.input("in", data[:FRAME * 5])
    m.run()
    fn, programs = mk._fn, dict(mk._programs)
    assert asyncio.run(mk.recover(RuntimeError("injected test fault")))
    assert mk._fn is fn and mk._programs == programs
    m.input("in", data[FRAME * 5:])
    m.run()
    np.testing.assert_array_equal(m.output("out"), _run(data)[0])


@pytest.mark.parametrize("sticky", [True, False])
def test_recover_declines_a_sticky_cuda_error(sticky):
    mk = TpuKernel(_stages(), np.complex64, frame_size=FRAME, inst=CPU, checkpoint_every=1)
    asyncio.run(mk.init(mk.mio, mk.meta))
    err = RuntimeError("CUDA error: an illegal memory access was encountered") if sticky \
        else RuntimeError("injected fault at 'dispatch' (fire #1)")
    assert asyncio.run(mk.recover(err)) is (not sticky)


# ---------------------------------------------------------------------------
# the host path under recovery
# ---------------------------------------------------------------------------

def test_arena_recycling_under_recovery_bit_identical(monkeypatch):
    """Faults while a 1 MB arena recycles every released buffer at once and
    the codec pool runs: a buffer the replay log holds is never handed to a
    newer frame."""
    c = config()
    monkeypatch.setattr(c, "host_arena", 1)
    monkeypatch.setattr(c, "host_arena_mb", 1)
    monkeypatch.setattr(c, "host_codec_workers", 2)
    arena_mod.reset_arena()
    codec_pool.reset_pool()
    try:
        for site, rate, seed, mf in (("dispatch", 0.12, 9, 1), ("h2d", 0.08, 4, 1),
                                     ("d2h", 0.1, 5, 2)):
            got, r, _ = _run(_data(), fault=(site, rate, seed), restart=True, max_faults=mf)
            assert r >= 1, (site, seed)
            np.testing.assert_array_equal(got, _ref(), err_msg=f"{site}@{seed}")
        got4, r, _ = _run(_data(), fault=("dispatch", 0.3, 5), restart=True, k=4)
        assert r == 1
        np.testing.assert_array_equal(got4, _ref(4))
    finally:
        arena_mod.reset_arena()
        codec_pool.reset_pool()


def test_replay_bit_identical_with_hostpath_disabled(monkeypatch):
    """Arena off, the codec inline: the replay holds as well."""
    c = config()
    monkeypatch.setattr(c, "host_arena", 0)
    monkeypatch.setattr(c, "host_codec_workers", 0)
    arena_mod.reset_arena()
    codec_pool.reset_pool()
    try:
        got, r, _ = _run(_data(), fault=("dispatch", 0.12, 9), restart=True)
        assert r == 1
        np.testing.assert_array_equal(got, _ref())
    finally:
        arena_mod.reset_arena()
        codec_pool.reset_pool()


def _wire_kernel(wire, k=1, ck=None):
    return TpuKernel(_stages(), np.complex64, frame_size=FRAME, inst=CPU,
                     frames_in_flight=2, frames_per_dispatch=k, wire=wire, checkpoint_every=ck)


def _mock_run(mk, parts, total):
    """Feed ``parts`` through a Mocker one after another, ``between`` called
    after each but the last; returns the output."""
    m = Mocker(mk)
    m.init_output("out", total + FRAME)
    m.init()
    for p, between in parts:
        m.input("in", p)
        m.run()
        if between is not None:
            between(mk)
    return m.output("out")


def _recover(mk):
    assert asyncio.run(mk.recover(RuntimeError("injected test fault")))


@pytest.mark.parametrize("k", [1, 4])
def test_packed_replay_bit_identical(k):
    """A recovery mid-stream re-ships the logged packed buffers untouched."""
    config().tpu_coalesce = True
    data = _data(FRAME * 8, seed=11)
    want = _mock_run(_wire_kernel("sc16", k, ck=2), [(data, None)], len(data))
    mk = _wire_kernel("sc16", k, ck=2)
    # five frames: one group after the newest checkpoint (K = 1), or a
    # replayed group and a part-filled one (K = 4)
    got = _mock_run(mk, [(data[:FRAME * 5], _recover), (data[FRAME * 5:], None)], len(data))
    assert mk._packed is not None and mk.frames_replayed > 0
    np.testing.assert_array_equal(got, want)


def test_ingest_pinned_through_checkpoint_replay():
    """The ingest pin rides the replay log: the re-shipped frames come from
    the still-pinned registered buffer, bit for bit; the pin drops only when
    the kernel's retention ends."""
    data = _data(FRAME * 8, seed=13)
    want = _mock_run(_wire_kernel("f32", ck=2), [(data.copy(), None)], len(data))
    h = ingest.register(data, name="capture")
    mk = _wire_kernel("f32", ck=2)
    got = _mock_run(mk, [(data[:FRAME * 5], _recover), (data[FRAME * 5:], None)], len(data))
    np.testing.assert_array_equal(got, want)
    assert mk.extra_metrics()["ingest_zero_copy_frac"] > 0 and mk.frames_replayed > 0
    assert h.pinned                   # the log still covers the tail groups
    mk._recovery_reset()
    assert not h.pinned


def test_wire_switch_survives_recovery():
    """The wire-switch log replays like the retune log: the groups re-ship
    under the wire they first had, and the recovery ends on the switched
    wire, bit for bit the run without the fault."""
    data = _data(FRAME * 8, seed=13)

    def switch(mk):
        mk.apply_wire_retune("sc8")

    want = _mock_run(_wire_kernel("sc16", ck=2),
                     [(data[:FRAME * 4], switch), (data[FRAME * 4:FRAME * 6], None),
                      (data[FRAME * 6:], None)], len(data))
    mk = _wire_kernel("sc16", ck=2)

    def recover(k):
        assert k.wire.name == "sc8"
        _recover(k)
        assert k.wire.name == "sc8" or k._replay_queue

    got = _mock_run(mk, [(data[:FRAME * 4], switch), (data[FRAME * 4:FRAME * 6], recover),
                         (data[FRAME * 6:], None)], len(data))
    assert mk.wire.name == "sc8"
    np.testing.assert_array_equal(got, want)


def test_ctrl_retune_in_replay_window_warns(caplog):
    """A ctrl retune landing inside an active replay window logs a warning
    naming the block and the pending replayed frames, and waits for the
    window's end."""
    taps = firdes.lowpass(0.2, 32).astype(np.float32)
    k = TpuKernel([T.fir_stage(taps, name="f")], np.complex64, frame_size=4096, inst=CPU)
    k.meta.instance_name = "replay_kernel"
    asyncio.run(k.init(k.mio, k.meta))
    k._replay_queue.append((3, (), ((4096, ()),), (), False))
    k._replay_queue.append((4, (), ((4096, ()),), (), False))
    k._replay_high = 4
    pmt = Pmt.map({"stage": "f", "taps": taps.tolist()})
    with caplog.at_level(logging.WARNING):
        res = asyncio.run(k.ctrl_handler(None, k.mio, k.meta, pmt))
    assert res == Pmt.ok()
    recs = [r for r in caplog.records if "replay window" in r.getMessage()]
    assert recs, caplog.text
    msg = recs[0].getMessage()
    assert "replay_kernel" in msg and "2 replayed frame(s)" in msg
    assert [e[0] for e in k._replay_retunes] == [5]
    caplog.clear()
    k._replay_queue.clear()
    with caplog.at_level(logging.WARNING):
        asyncio.run(k.ctrl_handler(None, k.mio, k.meta, pmt))
    assert not [r for r in caplog.records if "replay window" in r.getMessage()]
    assert k._replay_high == -1


# ---------------------------------------------------------------------------
# checkpoints on disk
# ---------------------------------------------------------------------------

def _drain_persist_queue():
    snapshot.persist_executor().submit(lambda: None).result()


def _disk_kernel(ck=1, stages=None):
    tk = TpuKernel(stages or _stages(), np.complex64, frame_size=FRAME, inst=CPU,
                   frames_in_flight=2, checkpoint_every=ck)
    tk.meta.instance_name = "rx_chain"
    return tk


def test_checkpoint_persists_and_recovers_across_processes(tmp_path, monkeypatch):
    """A commit lands under ``checkpoint_dir``; a new kernel (the next
    process) with nothing of its own restores from it and the stream goes
    on bit for bit."""
    data = _data(FRAME * 10)
    want = _mock_run(_disk_kernel(ck=0), [(data, None)], len(data))
    monkeypatch.setattr(config(), "checkpoint_dir", str(tmp_path))
    tk1 = _disk_kernel()
    out1 = _mock_run(tk1, [(data[:FRAME * 6], None)], FRAME * 6)[:FRAME * 6]
    _drain_persist_queue()
    path = tk1._ckpt_file()
    assert path and os.path.exists(path)
    tk2 = _disk_kernel()
    out2 = _mock_run(tk2, [(np.zeros(0, np.complex64), _recover), (data[FRAME * 6:], None)],
                     FRAME * 4)[:FRAME * 4]
    np.testing.assert_array_equal(np.concatenate([out1, out2]), want)


def test_checkpoint_disk_corruption_rejected(tmp_path, monkeypatch):
    monkeypatch.setattr(config(), "checkpoint_dir", str(tmp_path))
    tk1 = _disk_kernel()
    _mock_run(tk1, [(_data(FRAME * 4), None)], FRAME * 4)
    _drain_persist_queue()
    path = tk1._ckpt_file()
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    tk2 = _disk_kernel()
    asyncio.run(tk2.init(tk2.mio, tk2.meta))
    assert tk2._load_disk_ckpt() is None
    # recover falls back to the fresh-init sentinel, not the corrupted file
    assert asyncio.run(tk2.recover(RuntimeError("restart")))
    for a, b in zip(T._leaves(tk2._carry), T._leaves(tk2.pipeline.init_carry("cpu"))):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_checkpoint_dir_key_collisions(tmp_path, monkeypatch):
    """The file name is the instance name plus the pipeline's signature: two
    pipelines under one name write two files and read only their own."""
    monkeypatch.setattr(config(), "checkpoint_dir", str(tmp_path))
    tk_fir = _disk_kernel()
    tk_rot = _disk_kernel(stages=[T.rotator_stage(0.05)])
    assert tk_fir._ckpt_file() != tk_rot._ckpt_file()
    assert snapshot.snapshot_signature(tk_fir.pipeline, "rx_chain") != \
        snapshot.snapshot_signature(tk_rot.pipeline, "rx_chain")
    data = _data(FRAME * 4)
    _mock_run(tk_fir, [(data, None)], len(data))
    _mock_run(tk_rot, [(data, None)], len(data))
    _drain_persist_queue()
    got = _disk_kernel()._load_disk_ckpt()
    assert got is not None
    fresh = tk_fir.pipeline.init_carry("cpu")
    assert tk_fir.pipeline.carry_matches(got[1], tk_fir.pipeline.carry_spec(fresh), fresh)
    got2 = _disk_kernel(stages=[T.rotator_stage(0.05)])._load_disk_ckpt()
    assert got2 is not None and len(got2[1]) != len(got[1])


def test_checkpoint_clean_eos_purges_snapshot(tmp_path, monkeypatch):
    monkeypatch.setattr(config(), "checkpoint_dir", str(tmp_path))
    fg = Flowgraph()
    tk = _disk_kernel()
    snk = VectorSink(np.complex64)
    fg.connect(VectorSource(_data(FRAME * 5)), tk, snk)
    Runtime().run(fg, timeout=60)
    _drain_persist_queue()
    assert len(snk.items()) == FRAME * 5
    assert not os.path.exists(tk._ckpt_file())


def test_snapshot_file_round_trip_and_crc(tmp_path):
    leaves = [np.arange(5, dtype=np.complex64), np.float32(2.5) * np.ones(()),
              np.zeros((2, 3), np.int16)]
    path = str(tmp_path / "s" / "a.ckpt.npz")
    assert snapshot.write_snapshot(path, 7, leaves, meta={"cursor": 3})
    seq, got, meta = snapshot.read_snapshot(path)
    assert seq == 7 and meta == {"cursor": 3}
    for a, b in zip(got, leaves):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert snapshot.read_snapshot(str(tmp_path / "none.npz")) is None
    assert snapshot.sanitize_name("devchain[a…x2]/b") == "devchain_a_x2__b"


# ---------------------------------------------------------------------------
# fused device chains, fan-out and DAG kernels
# ---------------------------------------------------------------------------

def test_fused_devchain_restart_replay():
    """A restart-policy member fuses; the drive loop restarts the fused
    kernel from its composed carry's checkpoint, bit for bit, and the
    decision is recorded under the member's name."""
    data = _data()

    def run(fault):
        fg = Flowgraph()
        k1 = TpuKernel([T.fir_stage(TAPS, fft_len=256)], np.complex64, frame_size=FRAME,
                       inst=CPU, frames_in_flight=2)
        k2 = TpuKernel([T.rotator_stage(0.05)], np.complex64, frame_size=FRAME, inst=CPU,
                       frames_in_flight=2)
        k2.policy = BlockPolicy(on_error="restart", max_restarts=4, backoff=0.002)
        snk = VectorSink(np.complex64)
        fg.connect(VectorSource(data), k1, k2, snk)
        plan = faults.reset()
        if fault:
            plan.arm("dispatch", rate=0.12, max_faults=1, seed=5, transient=False)
        Runtime().run(fg, timeout=60)
        faults.reset()
        wk2 = fg.wrapped(k2)
        return (np.asarray(snk.items()), wk2.restarts,
                bool(wk2.metrics().get("fused_devchain")), fg.describe().to_json())

    want, _, fused0, _ = run(False)
    assert fused0
    got, restarts, fused1, desc = run(True)
    assert fused1 and restarts == 1
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _ref())       # fused = per hop = one kernel
    acts = [d for d in desc["policy_decisions"] if d["action"] == "restart"]
    assert len(acts) == 1 and acts[0]["phase"] == "work"


def test_fanout_fused_restart_replay():
    """A fused fan-out region (its flat composed carry) recovers bit for bit
    on every branch."""
    n = FRAME * 13 + 300
    data = _data(n, seed=3)

    def run(fault):
        fg = Flowgraph()
        prod = TpuKernel([T.fir_stage(TAPS, fft_len=256)], np.complex64, frame_size=FRAME,
                         inst=CPU, frames_in_flight=2)
        prod.policy = BlockPolicy(on_error="restart", max_restarts=4, backoff=0.002)
        b1 = TpuKernel([T.rotator_stage(0.05)], np.complex64, frame_size=FRAME, inst=CPU,
                       frames_in_flight=2)
        b2 = TpuKernel([T.mag2_stage()], np.complex64, frame_size=FRAME, inst=CPU,
                       frames_in_flight=2)
        s1, s2 = VectorSink(np.complex64), VectorSink(np.float32)
        fg.connect(VectorSource(data), prod)
        fg.connect(prod, b1, s1)
        fg.connect(prod, b2, s2)
        plan = faults.reset()
        if fault:
            plan.arm("dispatch", rate=0.15, max_faults=1, seed=6, transient=False)
        Runtime().run(fg, timeout=60)
        faults.reset()
        wp = fg.wrapped(prod)
        return (np.asarray(s1.items()), np.asarray(s2.items()), wp.restarts,
                bool(wp.metrics().get("fused_devchain")))

    e1, e2, _, fused0 = run(False)
    assert fused0
    g1, g2, restarts, fused1 = run(True)
    assert fused1 and restarts == 1
    np.testing.assert_array_equal(g1, e1)
    np.testing.assert_array_equal(g2, e2)


@pytest.mark.parametrize("kind", ["fanout", "dag"])
def test_multi_output_kernel_recover_replays_every_sink(kind):
    """``TpuFanoutKernel`` and ``TpuDagKernel`` recovered mid-stream (K = 4,
    sparse cadence): every sink bit for bit the run without a recovery."""
    data = _data(FRAME * 12, seed=21)

    def make():
        if kind == "fanout":
            pipe = T.FanoutPipeline([T.fir_stage(TAPS, fft_len=256, name="p")],
                                    [[T.rotator_stage(0.05)], [T.mag2_stage()]],
                                    np.complex64)
            return TpuFanoutKernel(pipe, frame_size=FRAME, inst=CPU, frames_in_flight=2,
                                   frames_per_dispatch=4, checkpoint_every=2)
        pipe = T.DagPipeline([
            ([T.fir_stage(TAPS, fft_len=256, name="p")], []),
            ([T.rotator_stage(0.05, name="a")], [0]),
            ([T.fir_stage(TAPS, decim=4, fft_len=256, name="b")], [0]),
            ([T.mag2_stage()], [1]),
        ], np.complex64)
        return TpuDagKernel(pipe, frame_size=FRAME, inst=CPU, frames_in_flight=2,
                            frames_per_dispatch=4, checkpoint_every=2)

    def run(recover):
        mk = make()
        m = Mocker(mk)
        for o in mk.outputs:
            m.init_output(o.name, len(data) * 2)
        m.init()
        cut = FRAME * 5       # one group (before the first checkpoint) and a part
        m.input("in", data[:cut])
        m.run()
        if recover:
            _recover(mk)
            assert mk.frames_replayed > 0
        m.input("in", data[cut:])
        m.run()
        return [m.output(o.name).copy() for o in mk.outputs]

    for got, want in zip(run(True), run(False)):
        np.testing.assert_array_equal(got, want)
