"""Pipeline parallelism over a mesh axis: GPipe microbatching.

The counterpart of ``futuresdr_tpu/parallel/pipeline_pp.py``. Each device on
the ``pp`` axis owns one stage's weights; microbatches stream through the
stages, an activation hopping to the next stage's device by a counted peer
copy (:meth:`~.mesh.Mesh.copy`, the reference's ``ppermute``). The schedule is
the reference's: ``n_micro + n_stages − 1`` steps, stage s working on
microbatch ``t − s`` at step t, so all stages work at once after the fill
(the bubble is ``(S − 1)/(S − 1 + M)``). One controller launches every step;
the launches on different cards run concurrently.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["make_pp_pipeline", "tree_map", "stage_slice"]


def tree_map(f: Callable, tree):
    """``f`` on every leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(f, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(f, v) for v in tree)
    return f(tree)


def stage_slice(stage_params, s: int, device):
    """Stage ``s``'s parameters (row ``s`` of every leaf) on ``device``."""
    return tree_map(lambda leaf: torch.as_tensor(leaf)[s].to(device), stage_params)


def make_pp_pipeline(apply_stage: Callable, n_stages: int, n_micro: int, mesh,
                     axis: str = "pp"):
    """Build ``fn(stage_params, micro_x) -> micro_y``, an ``n_stages``-deep
    pipeline over ``mesh[axis]``.

    - ``apply_stage(params_one_stage, x) -> y``: one stage's computation;
      input and output share shape and dtype;
    - ``stage_params``: leaves with a leading ``n_stages`` axis (stage s's
      row goes to the axis's device s), or the per-stage list
      :func:`stage_slice` gives, already placed;
    - ``micro_x``: ``[n_micro, ...]`` microbatches; returns the last stage's
      ``[n_micro, ...]`` outputs on the axis's first device, the one that fed
      them (the reference replicates them over the axis with a ``psum``; one
      controller reads one copy)."""
    devs = mesh.line(axis)
    if len(devs) != n_stages:
        raise ValueError(f"mesh axis {axis} has {len(devs)} devices, need {n_stages}")
    n_steps = n_micro + n_stages - 1

    def fn(stage_params, micro_x):
        if isinstance(stage_params, list) and len(stage_params) == n_stages:
            per = stage_params
        else:
            per = [stage_slice(stage_params, s, d) for s, d in enumerate(devs)]
        x = torch.as_tensor(micro_x).to(devs[0])
        recv = [None] * n_stages          # activation waiting at each stage
        outs = [None] * n_micro
        for t in range(n_steps):
            sent = [None] * n_stages
            for s in range(n_stages):
                m = t - s
                if not 0 <= m < n_micro:
                    continue
                a = x[m] if s == 0 else recv[s]
                y = apply_stage(per[s], a)
                if s + 1 < n_stages:
                    sent[s + 1] = mesh.copy(y, devs[s + 1])
                else:
                    outs[m] = y if n_stages == 1 else mesh.copy(y, devs[0], "psum")
            recv = sent
        return torch.stack(outs)

    return fn
