"""The port's mesh across processes (``futuresdr_tpu_torch/parallel/
multihost.py``): two rank processes over ``torch.distributed`` with gloo on
localhost, each owning 4 logical CPU devices (config ``virtual_devices``) of
one global 8-device mesh; the counterpart of ``tests/test_multihost.py``.

Each rank makes the same global input from one seed, keeps its own shards
(``place``), runs the plain versions of the kernels on them, and every halo
between its shards and the other rank's is a send and its receive. The
sequence-parallel paths do the one-process run's per-shard arithmetic, so
they are held to it bit for bit; the data-parallel train step sums its
gradients over the ranks in another order than the one-device step, so it is
held at the train tolerance of ``tests/test_torch_train.py``. The ranks write
their results to ``.npz`` files that this process reads. A rank that fails
fails the test; the only skip is a torch without gloo.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from futuresdr_tpu_torch.config import config
from futuresdr_tpu_torch.models.mcldnn import (MCLDNN, init_params, make_train_step,
                                               trainable_parameters)
from futuresdr_tpu_torch.parallel import make_mesh, multihost
from futuresdr_tpu_torch.parallel.stream_sp import sp_fir, sp_fir_stream, to_host

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

REPO = str(Path(__file__).resolve().parents[1])
STEP_TOL = 2e-6        # tests/test_torch_train.py: parameters after one Adam step
TINY_G = 1e-6
RANK_TIMEOUT_S = 120

_PRELUDE = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from futuresdr_tpu_torch.config import config
from futuresdr_tpu_torch.parallel import multihost
rank, coordinator, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
config().virtual_devices = 4
multihost.initialize(coordinator, 2, rank, device="cpu", timeout_s=60)
assert multihost.backend() == "gloo" and multihost.world_size() == 2
assert multihost.global_device_count() == 8
"""

_OTHERS = r"""
def _others(mesh, sp_fir_fft_mag2_stream, sp_channelizer_a2a, sp_dechirp_scan, to_host):
    rng = np.random.default_rng(43)
    taps = np.hanning(64).astype(np.float32)
    fn, init = sp_fir_fft_mag2_stream(taps, 128, mesh)
    carry, spec = init(np.complex64), []
    for _ in range(2):
        x = (rng.standard_normal(8 * 256) + 1j * rng.standard_normal(8 * 256))
        carry, y = fn(carry, x.astype(np.complex64))
        spec.append(to_host(y))
    xc = (rng.standard_normal(8 * 32 * 8) + 1j * rng.standard_normal(8 * 32 * 8))
    a2a = to_host(sp_channelizer_a2a(8, np.hanning(96), mesh)(xc.astype(np.complex64)))
    xs = (rng.standard_normal(8 * 256) + 1j * rng.standard_normal(8 * 256)).astype(np.complex64)
    bins, conc = sp_dechirp_scan(7, mesh, 32)(xs)
    return {"spec": np.concatenate(spec), "a2a": a2a, "bins": to_host(bins),
            "conc": to_host(conc)}
"""
exec(_OTHERS)

_EPILOGUE = r"""
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "futuresdr_tpu")]
assert not bad, bad
multihost.shutdown()
print(f"proc {rank} OK", flush=True)
"""

WORKER_FIR = _PRELUDE + _OTHERS + r"""
from futuresdr_tpu_torch.parallel.stream_sp import (sp_channelizer_a2a, sp_dechirp_scan,
                                                    sp_fir, sp_fir_fft_mag2_stream, to_host)
mesh = multihost.global_mesh(("sp",))
assert list(mesh.owners) == [0] * 4 + [1] * 4
rng = np.random.default_rng(42)          # the same seed: the same global input
taps = rng.standard_normal(31).astype(np.float32)
x = rng.standard_normal(8 * 1024).astype(np.float32)
ys = sp_fir(taps, mesh)(x)
held = [i for i, s in enumerate(ys.shards) if s is not None]
assert held == list(range(4 * rank, 4 * rank + 4)), held
crossed, crossed_bytes = mesh.rank_transfers["ppermute"], mesh.rank_transfer_bytes
y = to_host(ys)                           # the all-gather, every rank
assert mesh.rank_transfers["all_gather"] == 4
# the other sharded forms: their halos and blocks cross the ranks too
others = _others(mesh, sp_fir_fft_mag2_stream, sp_channelizer_a2a, sp_dechirp_scan, to_host)
np.savez(f"{out}/rank{rank}.npz", y=y, crossed=crossed, crossed_bytes=crossed_bytes,
         **others)
""" + _EPILOGUE

WORKER_TRAIN = _PRELUDE + r"""
from futuresdr_tpu_torch.models.mcldnn import MCLDNN, init_params, loss_fn
from futuresdr_tpu_torch.parallel.sharded_train import ShardedTrainStep
from futuresdr_tpu_torch.parallel.stream_sp import sp_fir_stream, to_host
# the data-parallel step: the gradient all-reduce crosses the ranks
mesh = multihost.global_mesh(("dp",))
model = init_params(MCLDNN(n_classes=11, conv_features=8, lstm_features=16),
                    torch.Generator().manual_seed(0))
rng = np.random.default_rng(7)
iq = rng.standard_normal((16, 2, 64)).astype(np.float32)
labels = (np.arange(16) % 11).astype(np.int64)
step = ShardedTrainStep(model, mesh, loss_fn, "dp", None)
assert step.rows == list(range(4 * rank, 4 * rank + 4)), step.rows
loss, acc = step(torch.from_numpy(iq), torch.from_numpy(labels))
losses = multihost.process_allgather(loss.reshape(1))
assert torch.equal(losses[0], losses[1]), losses
sd = {k: v.numpy() for k, v in step.state_dict().items()}
# the stateful stream: the halos and the carry cross the ranks every frame
mesh_sp = multihost.global_mesh(("sp",))
taps = rng.standard_normal(31).astype(np.float32)
fn, init_carry = sp_fir_stream(taps, mesh_sp)
carry = init_carry(np.float32)
assert (carry is None) == (rank == 1)     # the carry lives with shard 0
F = 8 * 512
xs = rng.standard_normal(2 * F).astype(np.float32)
outs = []
for k in range(2):
    carry, y = fn(carry, xs[k * F:(k + 1) * F])
    outs.append(to_host(y))
np.savez(f"{out}/rank{rank}.npz", loss=float(loss), acc=float(acc),
         stream=np.concatenate(outs), **{"p/" + k: v for k, v in sd.items()})
""" + _EPILOGUE


def _run_two_ranks(worker: str, tmp_path) -> list:
    """Both ranks of ``worker`` on a free localhost port (one retry where the
    port was taken in between); each must exit 0 and print its OK line.
    Returns each rank's ``.npz``."""
    if not dist.is_gloo_available():
        pytest.skip("this torch has no gloo backend")
    script = tmp_path / "rank.py"
    script.write_text(worker)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    results = multihost.launch(
        lambda r, coord: [sys.executable, str(script), str(r), coord, str(tmp_path)],
        2, RANK_TIMEOUT_S, env=env, cwd=REPO)
    for r, (rc, out) in enumerate(results):
        assert rc == 0, f"rank {r} rc={rc}\n{out[-3000:]}"
        assert f"proc {r} OK" in out, out[-3000:]
    return [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]


@pytest.fixture
def eight_devices():
    cfg = config()
    prev = cfg.virtual_devices
    cfg.virtual_devices = 8
    yield make_mesh(("sp",), device="cpu")
    cfg.virtual_devices = prev


def _convolve(x, taps):
    return np.convolve(np.concatenate([np.zeros(len(taps) - 1, np.float32), x]), taps,
                       mode="valid").astype(np.float32)


def test_two_process_global_mesh_sp_fir(tmp_path, eight_devices):
    """``sp_fir`` over the global mesh: both ranks gather the same output,
    bit-equal to the one-process 8-device run and within the reference
    test's 1e-3 of ``np.convolve``; rank 1 received the one halo that
    crosses (shard 3 to shard 4, 30 samples). The spectrum stream, the
    all-to-all channelizer and the LoRa scan across the ranks are the
    one-process run's bits too."""
    got = _run_two_ranks(WORKER_FIR, tmp_path)
    rng = np.random.default_rng(42)
    taps = rng.standard_normal(31).astype(np.float32)
    x = rng.standard_normal(8 * 1024).astype(np.float32)
    want = to_host(sp_fir(taps, eight_devices)(x))
    for g in got:
        np.testing.assert_array_equal(g["y"], want)
    assert np.abs(want - _convolve(x, taps)).max() < 1e-3
    assert [int(g["crossed"]) for g in got] == [0, 1]
    assert int(got[1]["crossed_bytes"]) == 30 * 4
    from futuresdr_tpu_torch.parallel.stream_sp import (sp_channelizer_a2a, sp_dechirp_scan,
                                                        sp_fir_fft_mag2_stream)
    want = _others(eight_devices, sp_fir_fft_mag2_stream, sp_channelizer_a2a,
                   sp_dechirp_scan, to_host)
    for g in got:
        for k, w in want.items():
            np.testing.assert_array_equal(g[k], w, err_msg=k)


def test_two_process_train_and_stateful_stream(tmp_path, eight_devices):
    """The data-parallel train step over a global ("dp",) mesh (the gradient
    all-reduce crosses the ranks): the same loss on both ranks, the loss and
    the stepped weights those of the one-device step on the whole batch (the
    weights within the train tolerance where |g| > 1e-6); then the
    carry-chained ``sp_fir_stream`` over two frames, bit-equal to the
    one-process stream."""
    got = _run_two_ranks(WORKER_TRAIN, tmp_path)
    assert float(got[0]["loss"]) == float(got[1]["loss"])
    model = init_params(MCLDNN(n_classes=11, conv_features=8, lstm_features=16),
                        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    iq = rng.standard_normal((16, 2, 64)).astype(np.float32)
    labels = (np.arange(16) % 11).astype(np.int64)
    step = make_train_step(model, torch.optim.Adam(trainable_parameters(model), lr=1e-3))
    loss, _acc = step(torch.from_numpy(iq), torch.from_numpy(labels))
    assert abs(float(got[0]["loss"]) - float(loss)) <= 1e-5
    grads = {k: p.grad for k, p in model.named_parameters()}
    for name, want in model.state_dict().items():
        g = grads[name]
        for rank in got:
            w = rank["p/" + name]
            if g is None:
                np.testing.assert_array_equal(w, want.numpy())
                continue
            keep = g.abs().numpy() > TINY_G
            np.testing.assert_allclose(w[keep], want.numpy()[keep], atol=STEP_TOL,
                                       err_msg=name)
    taps = rng.standard_normal(31).astype(np.float32)
    F = 8 * 512
    xs = rng.standard_normal(2 * F).astype(np.float32)
    fn, init_carry = sp_fir_stream(taps, eight_devices)
    carry = init_carry(np.float32)
    outs = []
    for k in range(2):
        carry, y = fn(carry, xs[k * F:(k + 1) * F])
        outs.append(to_host(y))
    want = np.concatenate(outs)
    for g in got:
        np.testing.assert_array_equal(g["stream"], want)
    assert np.abs(want - _convolve(xs, taps)).max() < 1e-3


def test_initialize_stays_single_only_where_no_cluster_is_named(monkeypatch, eight_devices):
    """With no arguments and no ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/
    ``RANK``, ``initialize`` stays one process and the global mesh is the
    single-process mesh; an environment that names part of a cluster, or
    arguments given in part, raise instead of dropping to one process."""
    for k in multihost.ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    multihost.initialize()
    assert not multihost.is_distributed() and multihost.backend() is None
    assert multihost.rank() == 0 and multihost.world_size() == 1
    mesh = multihost.global_mesh(("sp",), device="cpu")
    assert mesh.owners is None and mesh.size == multihost.global_device_count("cpu") == 8
    got = multihost.process_allgather(torch.tensor([1.5, 2.5]))
    assert got.shape == (1, 2) and got[0, 1] == 2.5
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    with pytest.raises(RuntimeError, match="MASTER_PORT"):
        multihost.initialize()
    with pytest.raises(ValueError, match="together"):
        multihost.initialize("127.0.0.1:1", 2)
    with pytest.raises(ValueError, match="not a rank"):
        multihost.initialize("127.0.0.1:1", 2, 2, device="cpu")


def test_a_group_brought_up_elsewhere_takes_the_card_or_raises(eight_devices):
    """A group that ``torch.distributed.init_process_group`` brought up
    itself (as a ``torchrun`` script does) is adopted: asked for the card,
    ``global_mesh`` lists it, and on a host without one it raises; it never
    drops to the CPU unless ``device="cpu"`` asks for it."""
    if not dist.is_gloo_available():
        pytest.skip("this torch has no gloo backend")
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{multihost.free_port()}",
                            world_size=1, rank=0)
    try:
        if torch.cuda.is_available():
            multihost.initialize()
            card = torch.device("cuda", torch.cuda.current_device())
            assert multihost.global_mesh(("sp",)).devices == [card] * 8
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                multihost.initialize()
            with pytest.raises(RuntimeError, match="no CUDA device"):
                multihost.global_mesh(("sp",))
            with pytest.raises(RuntimeError, match="no CUDA device"):
                multihost.local_devices()
        mesh = multihost.global_mesh(("sp",), device="cpu")
        assert mesh.size == 8 and all(d.type == "cpu" for d in mesh.devices)
        assert list(np.asarray(mesh.owners).reshape(-1)) == [0] * 8
    finally:
        multihost.shutdown()


@pytest.mark.parametrize("names,rank,want", [
    (["a", "a"], 0, (0, 2)), (["a", "a"], 1, (1, 2)),
    (["a", "b"], 1, (0, 1)), (["a", "b", "a", "b"], 3, (1, 2))])
def test_a_rank_finds_its_place_on_its_host_at_the_rendezvous(monkeypatch, names, rank, want):
    """The local rank and the local count come from the host names the ranks
    leave at the rendezvous store, not from the global rank: ranks on two
    hosts that share no ``LOCAL_RANK`` each take their own host's cards."""
    store = dist.HashStore()
    for i, name in enumerate(names):
        if i != rank:
            store.set(f"fsdr_host/{i}", name)
    monkeypatch.setattr(multihost.socket, "gethostname", lambda: names[rank])
    assert multihost._hosts(store, len(names), rank) == want
    assert multihost._choose("cpu", *want) == ("gloo", None)
