"""Modulation recognition: the synthetic dataset, the pretrained MCLDNN, and the
in-flowgraph classifier.

The counterpart of ``futuresdr_tpu/models/modrec.py`` (the reference's burn example
workflow, ``examples/burn/src/{infer,radio}.rs``): the MCLDNN model (:mod:`.mcldnn`)
run INSIDE a flowgraph as a block, IQ windows in on the stream plane, class
probabilities out on the message plane. :func:`synth_batch` makes the reference's
RadioML-style set (numpy, the same samples from the same generator).
:func:`load_pretrained` reads the packaged weights, ``weights/<name>.npz`` (the
reference's orbax checkpoint converted by the repository's ``port_weights.py``) with
``weights/<name>.json`` recording the architecture. :func:`train` trains MCLDNN on
the synthetic set with autograd and Adam (``models/mcldnn.py``).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..dsp import firdes
from ..runtime.kernel import Kernel
from ..tpu.instance import resolve_device
from ..types import Pmt
from .mcldnn import MCLDNN, init_params, make_train_step, trainable_parameters

__all__ = ["CLASSES", "synth_batch", "train", "ModClassifier", "load_pretrained",
           "WEIGHTS_DIR"]

WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "weights")


def load_pretrained(name: str = "mcldnn_v1", device=None) -> MCLDNN:
    """The packaged pretrained MCLDNN (trained on the synthetic RadioML-style set)
    on ``device`` (None: the card), in eval mode."""
    cfg_path = os.path.join(WEIGHTS_DIR, f"{name}.json")
    npz_path = os.path.join(WEIGHTS_DIR, f"{name}.npz")
    if not (os.path.exists(cfg_path) and os.path.exists(npz_path)):
        raise FileNotFoundError(f"no pretrained weights {name!r} in {WEIGHTS_DIR}")
    with open(cfg_path) as f:
        cfg = json.load(f)
    model = MCLDNN(n_classes=cfg["n_classes"], conv_features=cfg["conv_features"],
                   lstm_features=cfg["lstm_features"])
    with np.load(npz_path) as z:
        state = {k: torch.from_numpy(z[k]) for k in z.files}
    model.load_state_dict(state, strict=True)
    return model.to(resolve_device(device)).eval()


CLASSES = ["bpsk", "qpsk", "qam16", "fm", "noise"]


def _psk_qam(rng, n, order: str):
    sps = 8
    n_sym = n // sps + 8
    if order == "bpsk":
        pts = np.array([-1.0, 1.0])
    elif order == "qpsk":
        pts = (np.array([1 + 1j, -1 + 1j, 1 - 1j, -1 - 1j]) / np.sqrt(2))
    else:
        lv = np.array([-3, -1, 1, 3]) / np.sqrt(10)
        pts = (lv[:, None] + 1j * lv[None, :]).reshape(-1)
    syms = pts[rng.integers(0, len(pts), n_sym)]
    up = np.zeros(n_sym * sps, dtype=complex)
    up[::sps] = syms
    h = firdes.root_raised_cosine(6, sps, 0.35)
    x = np.convolve(up, h)[4 * sps:4 * sps + n]
    return x


def _fm(rng, n):
    msg = np.cumsum(rng.standard_normal(n)) * 0.05
    msg -= msg.mean()
    return np.exp(1j * 2 * np.pi * 0.1 * np.cumsum(np.tanh(msg)) / 4)


def synth_batch(rng: np.random.Generator, batch: int, n: int = 128,
                snr_db_range=(0.0, 20.0)) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (iq[batch, 2, n] float32, labels[batch] int32)."""
    X = np.empty((batch, 2, n), np.float32)
    y = rng.integers(0, len(CLASSES), batch).astype(np.int32)
    for i in range(batch):
        cls = CLASSES[y[i]]
        if cls in ("bpsk", "qpsk", "qam16"):
            x = _psk_qam(rng, n, cls)
        elif cls == "fm":
            x = _fm(rng, n)
        else:
            x = np.zeros(n, dtype=complex)
        # random phase + small CFO + unit power normalization
        x = x * np.exp(1j * (rng.uniform(0, 2 * np.pi)
                             + 2 * np.pi * rng.uniform(-0.01, 0.01) * np.arange(n)))
        p = np.mean(np.abs(x) ** 2)
        if p > 0:
            x = x / np.sqrt(p)
        snr = rng.uniform(*snr_db_range)
        sigma = np.sqrt(10 ** (-snr / 10) / 2)
        x = x + sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        X[i, 0] = x.real
        X[i, 1] = x.imag
    return X, y


def train(n_steps: int = 200, batch: int = 64, n: int = 128, seed: int = 0,
          model: Optional[MCLDNN] = None, lr: float = 1e-3, log_every: int = 0,
          device=None):
    """Train MCLDNN on the synthetic set on ``device`` (None: the card):
    ``init_params`` from a ``torch.Generator`` seeded with ``seed``, Adam at
    ``lr``, batches from ``numpy.random.default_rng(seed)`` (the reference's
    stream of batches). Returns ``(model, history)``, ``history`` a list of
    ``(loss, acc)`` a step; the model's parameters are its trained state."""
    dev = resolve_device(device)
    model = model or MCLDNN(n_classes=len(CLASSES))
    model = init_params(model.to(dev), torch.Generator().manual_seed(seed))
    opt = torch.optim.Adam(trainable_parameters(model), lr=lr)
    step = make_train_step(model, opt)
    rng = np.random.default_rng(seed)
    history: List[Tuple[float, float]] = []
    for i in range(n_steps):
        X, y = synth_batch(rng, batch, n)
        loss, acc = step(torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev))
        history.append((float(loss), float(acc)))
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i + 1}: loss {history[-1][0]:.3f} acc {history[-1][1]:.3f}")
    return model, history


class ModClassifier(Kernel):
    """In-flowgraph classifier (`radio.rs` role): consumes complex64 windows of length
    ``n``, ``batch`` of them ``hop`` apart a call, and posts {class, confidence}
    maps on the ``out`` message port. ``model`` runs on ``device`` (None: the
    card; the module is moved there)."""

    BLOCKING = True

    def __init__(self, model: MCLDNN, n: int = 128, hop: Optional[int] = None,
                 batch: int = 32, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.n = n
        self.hop = hop or n
        self.batch = batch
        self.input = self.add_stream_input("in", np.complex64,
                                           min_items=n + (batch - 1) * self.hop)
        self.add_message_output("out")
        self.predictions: List[Tuple[str, float]] = []

    def classify(self, X: np.ndarray) -> np.ndarray:
        """Class probabilities ``[batch, classes]`` of windows ``X [batch, 2, n]``."""
        with torch.inference_mode():
            x = torch.from_numpy(X).to(self.device)
            return torch.softmax(self.model(x), dim=-1).cpu().numpy()

    async def work(self, io, mio, meta):
        need = self.n + (self.batch - 1) * self.hop
        inp = self.input.slice()
        if len(inp) >= need:
            idx = np.arange(self.batch)[:, None] * self.hop + np.arange(self.n)[None, :]
            wins = inp[idx]
            X = np.stack([wins.real, wins.imag], axis=1).astype(np.float32)
            probs = self.classify(X)
            for row in probs:
                c = int(np.argmax(row))
                self.predictions.append((CLASSES[c], float(row[c])))
                mio.post("out", Pmt.map({"class": CLASSES[c],
                                         "confidence": float(row[c])}))
            self.input.consume(self.batch * self.hop)
            io.call_again = True
            return
        if self.input.finished():
            io.finished = True
