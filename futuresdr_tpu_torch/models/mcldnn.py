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
convolutions, LSTMs and linears compute float32 as the CPU does. Training is not
ported here.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["MCLDNN", "loss_fn"]

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
