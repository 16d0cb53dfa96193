"""MCLDNN training in the port (``models/mcldnn.py`` ``init_params``,
``make_train_step``; ``models/modrec.py`` ``train``) against the JAX package's
flax model and optax on the CPU.

Both packages start from the JAX init, converted by ``convert.mcldnn_from_flax``
(flax's one LSTM bias a gate in ``bias_hh_l0``, ``bias_ih_l0`` zero and frozen).
Gradients of one batch: each leaf within 1e-4 of the leaf's largest |g|. One Adam
step (lr 1e-3, optax's and ``torch.optim.Adam``'s defaults): the new parameters
within 2e-6 where the gradient's magnitude is above 1e-6. Adam's first step is
about ``lr·sign(g)``, so where |g| is tiny its sign is rounding noise and the two
packages may step opposite ways; those entries are left out, and the test says
how many there are.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from futuresdr_tpu.models.mcldnn import MCLDNN as FlaxMCLDNN
from futuresdr_tpu.models.mcldnn import init_params as flax_init
from futuresdr_tpu.models.mcldnn import loss_fn as flax_loss_fn
from futuresdr_tpu.models.modrec import synth_batch as jax_synth_batch
from futuresdr_tpu_torch.convert import mcldnn_from_flax
from futuresdr_tpu_torch.models import modrec
from futuresdr_tpu_torch.models.mcldnn import (MCLDNN, freeze_input_biases, init_params,
                                               make_train_step, trainable_parameters)

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

GRAD_TOL = 1e-4        # relative to each leaf's largest |g|
STEP_TOL = 2e-6        # on the parameters after one Adam step at lr 1e-3
TINY_G = 1e-6
LR = 1e-3
CFG = dict(n_classes=5, conv_features=8, lstm_features=16)
N = 64


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_case():
    """The flax init, one batch, its loss and gradients, and one optax Adam
    step, computed once (one jit a function)."""
    fm = FlaxMCLDNN(**CFG)
    params = flax_init(fm, n=N, seed=0)
    X, y = jax_synth_batch(np.random.default_rng(7), 32, N)

    def loss(p):
        return flax_loss_fn(fm, p, X, y)

    (lval, acc), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    opt = optax.adam(LR)
    upd, _ = opt.update(grads, opt.init(params), params)
    stepped = optax.apply_updates(params, upd)
    return {"params": _np(params), "X": X, "y": y, "loss": float(lval), "acc": float(acc),
            "grads": mcldnn_from_flax(_np(grads)), "stepped": mcldnn_from_flax(_np(stepped))}


def _port_model(params) -> MCLDNN:
    m = MCLDNN(**CFG)
    m.load_state_dict(mcldnn_from_flax(params), strict=True)
    return freeze_input_biases(m)


def test_gradients_of_one_batch_match_flax(jax_case):
    m = _port_model(jax_case["params"])
    opt = torch.optim.SGD(trainable_parameters(m), lr=0.0)      # a step that moves nothing
    step = make_train_step(m, opt)
    loss, acc = step(torch.from_numpy(jax_case["X"]), torch.from_numpy(jax_case["y"]))
    assert abs(float(loss) - jax_case["loss"]) <= 1e-5
    assert float(acc) == jax_case["acc"]
    for name, p in m.named_parameters():
        want = jax_case["grads"][name].numpy()
        if name.endswith("bias_ih_l0"):
            assert p.grad is None and not p.requires_grad
            assert float(p.detach().abs().max()) == 0.0
            continue
        got = p.grad.numpy()
        scale = max(np.abs(want).max(), 1e-12)
        assert np.abs(got - want).max() <= GRAD_TOL * scale, name


def test_one_adam_step_matches_optax(jax_case):
    m = _port_model(jax_case["params"])
    opt = torch.optim.Adam(trainable_parameters(m), lr=LR)
    assert opt.defaults["betas"] == (0.9, 0.999) and opt.defaults["eps"] == 1e-8
    make_train_step(m, opt)(torch.from_numpy(jax_case["X"]), torch.from_numpy(jax_case["y"]))
    tiny = 0
    for name, p in m.state_dict().items():
        g = jax_case["grads"][name].numpy()
        want = jax_case["stepped"][name].numpy()
        keep = np.abs(g) > TINY_G
        tiny += int((~keep).sum())
        np.testing.assert_allclose(p.numpy()[keep], want[keep], atol=STEP_TOL, err_msg=name)
        if name.endswith("bias_ih_l0"):
            assert float(p.abs().max()) == 0.0       # frozen: never stepped
    # the zero input biases and any dead units are the entries left out
    assert tiny < sum(v.numel() for v in m.state_dict().values()) // 10


def test_init_params_draws_flax_distributions():
    m = init_params(MCLDNN(n_classes=5, conv_features=24, lstm_features=64),
                    torch.Generator().manual_seed(0))
    fm = FlaxMCLDNN(n_classes=5, conv_features=24, lstm_features=64)
    ref = mcldnn_from_flax(_np(flax_init(fm, n=128, seed=0)))
    sd = m.state_dict()
    for name, want in ref.items():
        got = sd[name]
        assert got.shape == want.shape, name
        if "bias" in name:
            assert float(got.abs().max()) == 0.0, name
        elif "weight_hh" not in name:           # lecun normal: the same scale
            assert abs(float(got.std()) / float(want.std()) - 1.0) < 0.15, name
            assert float(got.abs().max()) <= 2.0 * float(want.std()) / 0.8796 * 1.2, name
    for lstm in (m.lstm1, m.lstm2):
        H = lstm.hidden_size
        for g in lstm.weight_hh_l0.detach().split(H):             # orthogonal a gate
            np.testing.assert_allclose((g @ g.t()).numpy(), np.eye(H), atol=1e-5)
        assert not lstm.bias_ih_l0.requires_grad
    again = init_params(MCLDNN(n_classes=5, conv_features=24, lstm_features=64),
                        torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(sd.values(), again.state_dict().values()))


def test_freeze_keeps_the_function():
    m = init_params(MCLDNN(**CFG), torch.Generator().manual_seed(1))
    with torch.no_grad():
        m.lstm1.bias_ih_l0.normal_()
        m.lstm1.bias_ih_l0.requires_grad_(True)
    X = torch.randn(4, 2, N, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        before = m(X)
        freeze_input_biases(m)
        after = m(X)
    torch.testing.assert_close(after, before, atol=1e-6, rtol=0)
    assert float(m.lstm1.bias_ih_l0.abs().max()) == 0.0


def test_training_learns():
    """As ``tests/test_modrec.py``'s: a small MCLDNN beats chance within 60
    steps, from the same stream of batches."""
    model = MCLDNN(n_classes=len(modrec.CLASSES), conv_features=12, lstm_features=24)
    model, history = modrec.train(n_steps=60, batch=64, n=N, model=model, lr=2e-3,
                                  device="cpu")
    first = np.mean([a for _, a in history[:5]])
    last = np.mean([a for _, a in history[-10:]])
    assert last > 0.5, f"accuracy {last} not above chance (first={first})"
    assert last > first
    assert all(np.isfinite(loss) for loss, _ in history)
