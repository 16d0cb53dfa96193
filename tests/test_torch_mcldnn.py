"""The port's MCLDNN (``futuresdr_tpu_torch/models/{mcldnn,modrec}.py``) against
the JAX package's flax model on the CPU.

Logits: the port's module, given the flax tree through
``convert.mcldnn_from_flax``, against ``MCLDNN.apply``: a random init (conv 12,
LSTM 24, n 64, seed 0) at atol 1e-5 (measured 2.1e-7 on logits of about 0.4)
and the pretrained weights at atol 1e-4 (measured 5.7e-6 on logits up to
12.4; two LSTMs of 124 steps sum in another order). Inputs come from the
reference's own numpy generator.
"""

import jax
import numpy as np
import pytest
import torch

from futuresdr_tpu.models import modrec as jmodrec
from futuresdr_tpu.models.mcldnn import MCLDNN as FlaxMCLDNN
from futuresdr_tpu.models.mcldnn import init_params
from futuresdr_tpu.models.mcldnn import loss_fn as flax_loss_fn
from futuresdr_tpu_torch.convert import mcldnn_from_flax
from futuresdr_tpu_torch.dsp import firdes
from futuresdr_tpu_torch.models import modrec
from futuresdr_tpu_torch.models.mcldnn import MCLDNN, loss_fn

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)

RANDOM_ATOL = 1e-5
PRETRAINED_ATOL = 1e-4


def _leaves(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def pretrained():
    """The reference's pretrained flax model and params, loaded once."""
    return jmodrec.load_pretrained()


@pytest.fixture(scope="module")
def eval_batch():
    return jmodrec.synth_batch(np.random.default_rng(42), 256, 128, snr_db_range=(10.0, 20.0))


def test_random_init_logits_equal_flax():
    fm = FlaxMCLDNN(n_classes=5, conv_features=12, lstm_features=24)
    params = init_params(fm, n=64, seed=0)
    X = np.random.default_rng(0).standard_normal((16, 2, 64)).astype(np.float32)
    want = np.asarray(jax.jit(fm.apply)(params, X))
    m = MCLDNN(n_classes=5, conv_features=12, lstm_features=24)
    m.load_state_dict(mcldnn_from_flax(_leaves(params)), strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(X)).numpy()
    assert got.shape == (16, 5)
    np.testing.assert_allclose(got, want, atol=RANDOM_ATOL)


def test_conversion_layouts():
    """HWIO → OIHW, (in, out) → (out, in), the LSTM gates concatenated in
    flax's (= PyTorch's) order i, f, g, o with a zero input bias."""
    fm = FlaxMCLDNN(n_classes=5, conv_features=12, lstm_features=24)
    p = _leaves(init_params(fm, n=64, seed=1))["params"]
    sd = mcldnn_from_flax({"params": p})
    assert np.array_equal(sd["conv_iq.weight"].numpy()[3, 0, 1, 5],
                          p["conv_iq"]["kernel"][1, 5, 0, 3])
    assert np.array_equal(sd["conv_i.weight"].numpy()[2, 0, 7], p["conv_i"]["kernel"][7, 0, 2])
    assert np.array_equal(sd["fc1.weight"].numpy(), p["fc1"]["kernel"].T)
    w = sd["lstm2.weight_ih_l0"].numpy()
    assert w.shape == (4 * 24, 24)
    assert np.array_equal(w[2 * 24:3 * 24], p["OptimizedLSTMCell_1"]["ig"]["kernel"].T)
    assert np.array_equal(sd["lstm1.bias_hh_l0"].numpy()[24:48],
                          p["OptimizedLSTMCell_0"]["hf"]["bias"])
    assert not sd["lstm1.bias_ih_l0"].any()
    assert set(sd) == set(MCLDNN(5, 12, 24).state_dict())


def test_committed_weights_equal_a_fresh_conversion(pretrained):
    _, params = pretrained
    fresh = mcldnn_from_flax(_leaves(params))
    with np.load(f"{modrec.WEIGHTS_DIR}/mcldnn_v1.npz") as z:
        assert sorted(z.files) == sorted(fresh)
        for k, v in fresh.items():
            assert z[k].dtype == np.float32 and np.array_equal(z[k], v.numpy()), k


def test_pretrained_logits_and_accuracy(pretrained, eval_batch):
    """The pretrained logits against flax on the reference's evaluation batch,
    and the port's accuracy above ``tests/test_pretrained.py``'s bar."""
    fm, params = pretrained
    X, y = eval_batch
    want = np.asarray(jax.jit(fm.apply)(params, X))
    model = modrec.load_pretrained(device="cpu")
    assert not model.training
    with torch.no_grad():
        got = model(torch.from_numpy(X)).numpy()
        loss, acc = loss_fn(model, torch.from_numpy(X), torch.from_numpy(y))
    np.testing.assert_allclose(got, want, atol=PRETRAINED_ATOL)
    jloss, jacc = flax_loss_fn(fm, params, X, y)
    assert float(acc) > 0.9
    assert float(acc) == pytest.approx(float(jacc), abs=1 / 256)
    assert float(loss) == pytest.approx(float(jloss), abs=1e-4)


def test_synth_batch_bit_equal_to_the_reference():
    for seed, snr in ((0, (0.0, 20.0)), (42, (10.0, 20.0))):
        X, y = modrec.synth_batch(np.random.default_rng(seed), 64, 128, snr)
        Xr, yr = jmodrec.synth_batch(np.random.default_rng(seed), 64, 128, snr)
        assert X.dtype == np.float32 and y.dtype == np.int32
        assert np.array_equal(X, Xr) and np.array_equal(y, yr)
    assert modrec.CLASSES == jmodrec.CLASSES
    from futuresdr_tpu.dsp import firdes as jfirdes
    for span, sps, beta in ((6, 8, 0.35), (4, 4, 0.25), (8, 2, 0.5)):
        assert np.array_equal(firdes.root_raised_cosine(span, sps, beta),
                              jfirdes.root_raised_cosine(span, sps, beta))


def test_classifier_in_flowgraph():
    """``ModClassifier(device="cpu")`` on a 15 dB QPSK stream labels at least
    70% of its windows ``qpsk`` (``tests/test_pretrained.py``'s bar) and posts
    each on ``out``."""
    from futuresdr_tpu_torch import Flowgraph, Runtime
    from futuresdr_tpu_torch.blocks import MessageSink, VectorSource
    rng = np.random.default_rng(1)
    x = modrec._psk_qam(rng, 64 * 128, "qpsk")
    x = x / np.sqrt(np.mean(np.abs(x) ** 2))
    sigma = np.sqrt(10 ** (-15 / 10) / 2)
    x = (x + sigma * (rng.standard_normal(len(x))
                      + 1j * rng.standard_normal(len(x)))).astype(np.complex64)
    fg = Flowgraph()
    src = VectorSource(x)
    clf = modrec.ModClassifier(modrec.load_pretrained(device="cpu"), n=128, batch=8,
                               device="cpu")
    snk = MessageSink()
    fg.connect_stream(src, "out", clf, "in")
    fg.connect_message(clf, "out", snk, "in")
    Runtime().run(fg)
    labels = [c for c, _ in clf.predictions]
    assert len(labels) == 64
    assert labels.count("qpsk") >= len(labels) * 0.7, labels
    assert [p.to_map()["class"].value for p in snk.received] == labels


def test_load_pretrained_defaults_to_the_card(monkeypatch):
    import importlib
    inst = importlib.import_module("futuresdr_tpu_torch.tpu.instance")
    monkeypatch.setattr(inst, "_instance", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        modrec.load_pretrained()
    with pytest.raises(FileNotFoundError):
        modrec.load_pretrained("no_such_weights", device="cpu")
