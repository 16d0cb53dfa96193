"""Checkpoint and resume in the port (``futuresdr_tpu_torch/utils/checkpoint.py``)
against the JAX package on the CPU.

Trees of tensors and arrays (a model's and Adam's state dicts among them) come
back bit for bit; training resumed from a checkpoint equals training straight
through, bit for bit; block state round-trips through a flowgraph; a device
pipeline's carry, retuned or not, resumes the stream bit for bit, and the
resumed stream stays within the FIR's tolerance of the JAX package's
(``tests/test_checkpoint.py``'s cases, with the JAX pipeline's output beside).
"""

import numpy as np
import pytest
import torch

from futuresdr_tpu_torch import Flowgraph, Kernel
from futuresdr_tpu_torch.models.mcldnn import (MCLDNN, init_params, make_train_step,
                                               trainable_parameters)
from futuresdr_tpu_torch.models.modrec import synth_batch
from futuresdr_tpu_torch.ops.stages import Pipeline, fir_stage
from futuresdr_tpu_torch.utils.checkpoint import (load_flowgraph_state, load_pytree,
                                                  save_flowgraph_state, save_pytree)

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

FIR_TOL = 1e-5


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_pytree_roundtrip(tmp_path):
    tree = {"w": torch.arange(12.0).reshape(3, 4), "b": torch.zeros(4),
            "c": torch.randn(5, dtype=torch.complex64),
            "h": torch.randn(3).to(torch.bfloat16),
            "meta": {"step": torch.tensor(7), 3: (1.5, None, "x", True)},
            "arr": np.arange(6, dtype=np.int16).reshape(2, 3), "raw": b"\x00\x01"}
    path = str(tmp_path / "ckpt")
    save_pytree(path, tree)
    back = load_pytree(path, like=tree)
    _same(tree, back)
    assert int(back["meta"]["step"]) == 7


def test_corrupted_checkpoint_is_refused(tmp_path):
    path = tmp_path / "ckpt"
    save_pytree(str(path), {"w": torch.ones(1000)})
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(FileNotFoundError):
        load_pytree(str(path))
    with pytest.raises(TypeError):
        save_pytree(str(tmp_path / "bad"), {"x": object()})


def _fresh():
    m = init_params(MCLDNN(n_classes=5, conv_features=8, lstm_features=16),
                    torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(trainable_parameters(m), lr=1e-3)
    return m, opt, make_train_step(m, opt)


def test_training_resume_bit_exact(tmp_path):
    """Save the model and Adam mid-training, load them into fresh objects,
    keep training: the result equals six steps straight through."""
    rng = np.random.default_rng(0)
    batches = [tuple(map(torch.from_numpy, synth_batch(rng, 16, 64))) for _ in range(6)]
    m, _o, step = _fresh()
    for X, y in batches:
        step(X, y)
    m2, o2, step2 = _fresh()
    for X, y in batches[:3]:
        step2(X, y)
    path = str(tmp_path / "train")
    save_pytree(path, {"model": m2.state_dict(), "opt": o2.state_dict()})
    m3, o3, step3 = _fresh()
    back = load_pytree(path)
    m3.load_state_dict(back["model"])
    o3.load_state_dict(back["opt"])
    _same(o2.state_dict(), o3.state_dict())
    for X, y in batches[3:]:
        step3(X, y)
    for (k, a), b in zip(m.state_dict().items(), m3.state_dict().values()):
        assert torch.equal(a, b), k


class StatefulBlock(Kernel):
    def __init__(self):
        super().__init__()
        self.counter = 0
        self.add_stream_input("in", np.float32)

    def state_dict(self):
        return {"counter": self.counter, "hist": torch.arange(3.0)}

    def load_state_dict(self, d):
        self.counter = d["counter"]
        self.hist = d["hist"]


def test_flowgraph_state_roundtrip(tmp_path):
    fg = Flowgraph()
    blk = StatefulBlock()
    fg.add(blk)
    blk.counter = 42
    path = str(tmp_path / "state.npz")
    save_flowgraph_state(fg, path)
    fg2 = Flowgraph()
    blk2 = StatefulBlock()
    fg2.add(blk2)
    assert load_flowgraph_state(fg2, path) == 1
    assert blk2.counter == 42 and torch.equal(blk2.hist, torch.arange(3.0))


@pytest.fixture(scope="module")
def jax_fir_stream():
    """The JAX package's fir_stage pipeline over the same two halves of a
    stream, with and without the retune (one jit)."""
    import jax
    from futuresdr_tpu.ops import Pipeline as JPipeline, fir_stage as jfir_stage
    taps = np.hanning(32).astype(np.float32)
    x = np.random.default_rng(0).standard_normal(1 << 16).astype(np.float32)
    pipe = JPipeline([jfir_stage(taps, name="f")], np.float32, optimize=False)
    fn = jax.jit(pipe.fn())
    carry, _ = fn(pipe.init_carry(), x[:1 << 15])
    _, ya = fn(carry, x[1 << 15:])
    _, yc = fn(pipe.update_stage(carry, "f", taps=-taps), x[1 << 15:])
    return taps, x, np.asarray(ya), np.asarray(yc)


def test_pipeline_carry_checkpoint_resume_bit_exact(tmp_path, jax_fir_stream):
    taps, x, ja, jc = jax_fir_stream
    pipe = Pipeline([fir_stage(taps, name="f")], np.float32, optimize=False)
    fn, carry = pipe.fn(), pipe.init_carry("cpu")
    carry, _ = fn(carry, torch.from_numpy(x[:1 << 15]))
    save_pytree(str(tmp_path / "ck"), carry)
    carry2 = load_pytree(str(tmp_path / "ck"), like=carry)
    rest = torch.from_numpy(x[1 << 15:])
    _, ya = fn(carry, rest)
    _, yb = fn(carry2, rest)
    assert torch.equal(ya, yb)
    np.testing.assert_allclose(ya.numpy(), ja, atol=FIR_TOL)
    carry3 = pipe.update_stage(carry, "f", taps=-taps)             # a runtime retune
    save_pytree(str(tmp_path / "ck2"), carry3)
    carry4 = load_pytree(str(tmp_path / "ck2"), like=carry3)
    _, yc = fn(carry3, rest)
    _, yd = fn(carry4, rest)
    assert torch.equal(yc, yd)
    np.testing.assert_allclose(yc.numpy(), jc, atol=FIR_TOL)
    np.testing.assert_allclose(yc.numpy(), -ya.numpy(), atol=FIR_TOL)
