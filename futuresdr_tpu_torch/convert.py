"""Carry conversion from the JAX package.

A stage carry in the port has the same leaves, shapes and dtypes as the JAX
stage's carry on the CPU. :func:`carry_from_numpy` rebuilds the port's carry
from the JAX carry's leaves, flattened in tree order to numpy arrays by the
caller (``[np.asarray(l) for l in jax.tree_util.tree_leaves(carry)]``), so a
stream can move from one package to the other mid-run. A bfloat16 leaf (the
``ml_dtypes`` type numpy holds JAX's bf16 in) converts bit for bit.

:func:`session_from_jax` does the same for a serving session: the host
leaves a JAX ``ServeEngine.evict`` left on the session (its page of the pool,
in tree order) become the leaves and carry spec the port's engine restores
(``ServeEngine.adopt`` then ``readmit``), checked by ``carry_matches``
against the port's template.

:func:`mcldnn_from_flax` maps the JAX package's MCLDNN parameter tree (its
leaves as numpy arrays) onto the port's ``models/mcldnn.MCLDNN`` state dict.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .ops.stages import Pipeline

__all__ = ["carry_from_numpy", "session_from_jax", "mcldnn_from_flax"]


def _flatten(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in _flatten(sub)]
    return [tree]


def _unflatten(template, leaves):
    if isinstance(template, (tuple, list)):
        return tuple(_unflatten(sub, leaves) for sub in template)
    return next(leaves)


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A host tensor of its own holding ``a``; ``torch.from_numpy`` rejects
    ``ml_dtypes.bfloat16``, so such a leaf goes through its 16 bits."""
    if a.dtype.name == "bfloat16" and a.dtype.itemsize == 2:
        return torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def carry_from_numpy(pipeline: Pipeline, leaves: Sequence[np.ndarray], device) -> tuple:
    """The port's carry for ``pipeline`` on ``device`` from the JAX carry's
    numpy leaves; raises ``ValueError`` on a leaf count, shape or dtype that
    does not match the port's carry."""
    device = torch.device(device)
    template = pipeline.init_carry("cpu")
    t_leaves = _flatten(template)
    if len(leaves) != len(t_leaves):
        raise ValueError(f"carry has {len(t_leaves)} leaves, got {len(leaves)}")
    out = []
    for i, (leaf, t) in enumerate(zip(leaves, t_leaves)):
        a = np.asarray(leaf)
        got = _tensor(a)
        if tuple(got.shape) != tuple(t.shape) or got.dtype != t.dtype:
            raise ValueError(f"carry leaf {i}: expected {tuple(t.shape)} {t.dtype}, "
                             f"got {a.shape} {a.dtype}")
        out.append(got.to(device))
    return _unflatten(template, iter(out))


def session_from_jax(pipeline, leaves: Sequence[np.ndarray]) -> tuple:
    """``(host leaves, carry spec)`` of an evicted JAX serving session, for
    the port's ``ServeEngine.adopt``: the leaves of the JAX engine's
    ``evict`` (``Session.carry_leaves``) converted leaf for leaf, in the
    port's snapshot leaf contract (a bfloat16 leaf as its int16 bits).
    Raises ``ValueError`` when they do not fit the port's carry."""
    carry = carry_from_numpy(pipeline, leaves, "cpu")
    host = [(t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().copy()
            for t in _flatten(carry)]
    spec = pipeline.carry_spec(carry)
    if not pipeline.carry_matches(host, spec, pipeline.init_carry("cpu")):
        raise ValueError("the converted session carry fails the pipeline's carry contract")
    return host, spec


_LSTM_CELLS = {"lstm1": "OptimizedLSTMCell_0", "lstm2": "OptimizedLSTMCell_1"}
_GATES = ("i", "f", "g", "o")           # flax's gate order is PyTorch's


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def mcldnn_from_flax(params) -> dict:
    """The port's ``MCLDNN`` state dict from a flax MCLDNN tree (``{"params":
    {...}}`` or its inner dict) with numpy leaves: convolution kernels HWIO →
    OIHW (a 1-D one WIO → OIW), dense kernels ``(in, out)`` → ``(out, in)``;
    each LSTM's ``weight_ih`` is ``cat(ii, if, ig, io)ᵀ`` and ``weight_hh``
    ``cat(hi, hf, hg, ho)ᵀ``, ``bias_hh`` the hidden kernels' biases and
    ``bias_ih`` zero (flax's input kernels have none)."""
    p = params.get("params", params)
    out = {}
    for name in ("conv_iq", "conv_merge"):
        out[f"{name}.weight"] = _t(np.transpose(p[name]["kernel"], (3, 2, 0, 1)))
        out[f"{name}.bias"] = _t(p[name]["bias"])
    for name in ("conv_i", "conv_q"):
        out[f"{name}.weight"] = _t(np.transpose(p[name]["kernel"], (2, 1, 0)))
        out[f"{name}.bias"] = _t(p[name]["bias"])
    for name, cell in _LSTM_CELLS.items():
        c = p[cell]
        w_ih = np.concatenate([c[f"i{g}"]["kernel"] for g in _GATES], axis=1).T
        w_hh = np.concatenate([c[f"h{g}"]["kernel"] for g in _GATES], axis=1).T
        b_hh = np.concatenate([c[f"h{g}"]["bias"] for g in _GATES])
        out[f"{name}.weight_ih_l0"] = _t(w_ih)
        out[f"{name}.weight_hh_l0"] = _t(w_hh)
        out[f"{name}.bias_ih_l0"] = torch.zeros(b_hh.shape[0], dtype=torch.float32)
        out[f"{name}.bias_hh_l0"] = _t(b_hh)
    for name in ("fc1", "fc2", "head"):
        out[f"{name}.weight"] = _t(np.asarray(p[name]["kernel"]).T)
        out[f"{name}.bias"] = _t(p[name]["bias"])
    return out
