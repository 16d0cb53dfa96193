"""MCLDNN: multi-channel convolutional LSTM deep neural network for automatic
modulation classification, as a ``torch.nn`` module.

The counterpart of ``futuresdr_tpu/models/mcldnn.py`` (the reference's burn example
model, ``examples/burn/src/model.rs:55-62``: Conv2D + per-I/Q Conv1D branches →
merge conv → 2×LSTM → SELU dense head). The JAX model is built from XLA ops (no
Pallas), so its counterpart here is PyTorch's convolutions, ``nn.LSTM`` and linears.
The parameter names follow the flax tree (``conv_iq``, ``conv_i``, ``conv_q``,
``conv_merge``, ``lstm1``/``lstm2`` for the flax tree's ``OptimizedLSTMCell_0``/``_1``,
``fc1``, ``fc2``, ``head``); ``convert.mcldnn_from_flax`` maps a flax tree onto them.

Input: ``[batch, 2, n]`` float32 (I/Q rows), as in the reference. The package
switches TF32 off at import (``futuresdr_tpu_torch/__init__.py``), so the card's
convolutions, LSTMs and linears compute float32 as the CPU does.

Training (the reference's ``make_train_step`` and ``init_params``) runs on
autograd and ``torch.optim.Adam``, whose defaults are optax's ``adam`` (b1 0.9,
b2 0.999, eps 1e-8). flax's LSTM cell has one bias a gate, which
``convert.mcldnn_from_flax`` puts in ``bias_hh_l0`` with ``bias_ih_l0`` zero;
``nn.LSTM`` would train both, and Adam would then move their sum by up to twice
the learning rate a step where flax moves its one bias by the rate. So
:func:`freeze_input_biases` (called by :func:`init_params` and
:func:`make_train_step`) folds any ``bias_ih_l0`` into ``bias_hh_l0``, zeroes it
and takes it out of autograd (``requires_grad = False``): it stays zero, and the
optimizer never steps it. A cuDNN LSTM's backward on a card need not give the
same bits twice; compare two card runs at a stated tolerance.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["MCLDNN", "loss_fn", "init_params", "make_train_step", "freeze_input_biases",
           "trainable_parameters"]

_SAME_8 = (3, 4)              # F.pad order: last dimension first
_SAME_2x8 = (3, 4, 0, 1)


class MCLDNN(nn.Module):
    def __init__(self, n_classes: int = 11, conv_features: int = 50,
                 lstm_features: int = 128):
        super().__init__()
        f = conv_features
        self.n_classes = n_classes
        self.conv_features = conv_features
        self.lstm_features = lstm_features
        self.conv_iq = nn.Conv2d(1, f, (2, 8))
        self.conv_i = nn.Conv1d(1, f, 8)
        self.conv_q = nn.Conv1d(1, f, 8)
        self.conv_merge = nn.Conv2d(2 * f, 2 * f, (2, 5))
        self.lstm1 = nn.LSTM(2 * f, lstm_features, batch_first=True)
        self.lstm2 = nn.LSTM(lstm_features, lstm_features, batch_first=True)
        self.fc1 = nn.Linear(lstm_features, 128)
        self.fc2 = nn.Linear(128, 128)
        self.head = nn.Linear(128, n_classes)

    def forward(self, iq: torch.Tensor) -> torch.Tensor:      # [B, 2, N]
        # flax's SAME pads (k - 1) // 2 before and the rest after:
        # width 8 → (3, 4), height 2 → (0, 1)
        a = self.conv_iq(F.pad(iq[:, None], _SAME_2x8))       # [B, f, 2, N]
        i = self.conv_i(F.pad(iq[:, 0:1], _SAME_8))            # [B, f, N]
        q = self.conv_q(F.pad(iq[:, 1:2], _SAME_8))
        rails = torch.stack([i, q], dim=2)                     # [B, f, 2, N]
        merged = F.relu(torch.cat([a, rails], dim=1))          # [B, 2f, 2, N]
        v = F.relu(self.conv_merge(merged)[:, :, 0])           # [B, 2f, N-4]
        v, _ = self.lstm1(v.transpose(1, 2))                   # [B, N-4, H]
        v, _ = self.lstm2(v)
        h = v[:, -1]                                           # last step
        h = F.selu(self.fc1(h))
        h = F.selu(self.fc2(h))
        return self.head(h)


def loss_fn(model: MCLDNN, iq: torch.Tensor,
            labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(mean cross-entropy, accuracy)`` of ``model`` on ``iq`` (forward only)."""
    logits = model(iq)
    loss = F.cross_entropy(logits, labels.long())
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, acc


def _trunc_normal(shape, std: float, gen: torch.Generator) -> torch.Tensor:
    """Normal draws truncated to ±2 standard deviations (redrawn until
    inside), scaled to ``std``: flax's ``truncated_normal``."""
    out = torch.randn(shape, generator=gen)
    bad = out.abs() > 2.0
    while bad.any():
        out[bad] = torch.randn(int(bad.sum()), generator=gen)
        bad = out.abs() > 2.0
    return out * std


def _lecun_normal(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal``: ``variance_scaling(1, "fan_in",
    "truncated_normal")``, whose standard deviation is corrected for the
    truncation."""
    return _trunc_normal(shape, math.sqrt(1.0 / fan_in) / 0.87962566103423978, gen)


def _orthogonal(n: int, gen: torch.Generator) -> torch.Tensor:
    """flax's ``orthogonal``: the Q of a normal draw's QR, its columns'
    signs set by R's diagonal."""
    q, r = torch.linalg.qr(torch.randn(n, n, generator=gen))
    return q * torch.sign(torch.diagonal(r))[None, :]


def freeze_input_biases(model: MCLDNN) -> MCLDNN:
    """Fold each LSTM's ``bias_ih_l0`` into ``bias_hh_l0`` (the gates see
    their sum, so the function is kept), zero it and take it out of autograd:
    flax's cell has the one bias (module docstring)."""
    with torch.no_grad():
        for lstm in (model.lstm1, model.lstm2):
            lstm.bias_hh_l0.add_(lstm.bias_ih_l0)
            lstm.bias_ih_l0.zero_()
            lstm.bias_ih_l0.requires_grad_(False)
    return model


def trainable_parameters(model: MCLDNN) -> list:
    """The parameters the optimizer steps (all but the frozen input biases)."""
    return [p for p in model.parameters() if p.requires_grad]


def init_params(model: MCLDNN, generator: torch.Generator) -> MCLDNN:
    """Initialize ``model`` in place from ``generator`` (a CPU
    ``torch.Generator``) with flax's initializers' distributions: lecun-normal
    kernels (convolutions, linears, the LSTMs' input kernels), orthogonal
    recurrent kernels (one ``[H, H]`` block a gate, as flax's cell has one
    kernel a gate), zero biases; the input biases frozen at zero. Returns
    ``model``."""
    H = model.lstm_features
    dev = next(model.parameters()).device
    with torch.no_grad():
        for conv in (model.conv_iq, model.conv_i, model.conv_q, model.conv_merge):
            w = conv.weight
            fan_in = w.shape[1] * math.prod(w.shape[2:])
            w.copy_(_lecun_normal(tuple(w.shape), fan_in, generator).to(dev))
            conv.bias.zero_()
        for lstm in (model.lstm1, model.lstm2):
            n_in = lstm.weight_ih_l0.shape[1]
            lstm.weight_ih_l0.copy_(torch.cat(
                [_lecun_normal((H, n_in), n_in, generator) for _ in range(4)]).to(dev))
            lstm.weight_hh_l0.copy_(torch.cat(
                [_orthogonal(H, generator).t() for _ in range(4)]).to(dev))
            lstm.bias_ih_l0.zero_()
            lstm.bias_hh_l0.zero_()
        for fc in (model.fc1, model.fc2, model.head):
            fc.weight.copy_(_lecun_normal(tuple(fc.weight.shape), fc.weight.shape[1],
                                          generator).to(dev))
            fc.bias.zero_()
    return freeze_input_biases(model)


def make_train_step(model: MCLDNN, optimizer: torch.optim.Optimizer) -> Callable:
    """The train step (forward, backward, optimizer step) on ``model``'s
    parameters in place: ``step(iq, labels) -> (loss, acc)``, both detached
    0-d tensors, as the reference's step returns beside its new state.
    ``optimizer`` is built over :func:`trainable_parameters` (e.g.
    ``torch.optim.Adam(trainable_parameters(model), lr)``); the input biases
    are frozen first."""
    freeze_input_biases(model)

    def step(iq: torch.Tensor, labels: torch.Tensor):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss, acc = loss_fn(model, iq, labels)
        loss.backward()
        optimizer.step()
        return loss.detach(), acc.detach()

    return step
