"""Model-sharded programs: one frame split across the mesh.

The counterpart of ``futuresdr_tpu/shard/model.py`` (``shard/plan.py`` mode
``model``). One frame's item axis splits into D contiguous spans, span d on
device d, and the unchanged stages run span by span, stage after stage:

* a stage whose carry is an input-history window (``Stage.history``: the FIR,
  ``fir_fft``, the PFB) runs span d with span d − 1's last ``history`` input
  samples as its carry's window, one counted peer copy (the halo); span 0
  takes the stream's carry;
* a stateless stage (the FFT, ``|x|²``) needs nothing.

The plan admits no other stage (it falls back to ``data``). The stream's carry
lives on the first device; a carry's parameter leaves (taps, spectra) are
copied to the other devices once, and again only when a retune replaces them.
The spans' outputs are gathered onto the first device. The reference lets
GSPMD place the same program; here the FFTs of a span are the span's own, so
the output is held to the single-device program at float32 tolerance, not bit
for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..log import logger
from ..ops.stages import _leaves, _rebuild
from .plan import ShardPlan, note_plan, plan_shard

__all__ = ["ModelShardedProgram"]

log = logger("shard.model")


def _with_window(carry, window: torch.Tensor):
    """``carry`` with its last leaf (the input-history window) replaced."""
    if isinstance(carry, tuple):
        return carry[:-1] + (window,)
    return window


def _window(carry) -> torch.Tensor:
    return carry[-1] if isinstance(carry, tuple) else carry


class ModelShardedProgram:
    """A fused pipeline whose frame splits across the mesh: one stream, D
    spans. ``compile(frame_size, k)`` returns ``(fn, carry)`` with ``fn(carry,
    x) -> (carry, y)``, ``x`` ``[frame]`` or ``[k, frame]`` (host or any
    device), ``y`` on the first device; the carry is the pipeline's, on the
    first device (``update_stage`` retunes it as usual)."""

    def __init__(self, pipeline, plan: Optional[ShardPlan] = None,
                 n_devices: Optional[int] = None, name: str = "shard_model", device=None):
        from .data import shard_mesh
        self.pipeline = pipeline
        self.plan = plan if plan is not None else plan_shard(
            pipeline, mode="model", n_devices=n_devices, device=device)
        if not self.plan.active:
            raise ValueError("ModelShardedProgram needs an active plan")
        if self.plan.applied != "model":
            raise ValueError(f"plan applied {self.plan.applied!r}, not 'model' "
                             f"(declines: {self.plan.declined})")
        self.name = str(name)
        self.n_devices = self.plan.n_devices
        self.axis = self.plan.axis
        self.mesh = shard_mesh(self.n_devices, self.axis,
                               device if device is not None else self.plan.device)
        self.devices = self.mesh.line(self.axis)
        self.in_dtype = pipeline.in_dtype
        self.out_dtype = pipeline.out_dtype
        self.ratio = pipeline.ratio
        self.stages = pipeline.stages
        # every span honours the per-lane frame contract
        self.frame_multiple = int(pipeline.frame_multiple) * self.n_devices
        self._replicas: dict = {}         # id(leaf on device 0) -> (leaf, [copies])
        note_plan(self.name, self.plan)

    def init_carry(self):
        return self.pipeline.init_carry(self.devices[0])

    def out_items(self, in_items: int) -> int:
        return self.pipeline.out_items(in_items)

    def _replica(self, leaf: torch.Tensor, d: int) -> torch.Tensor:
        """A parameter leaf of the stream's carry on device ``d`` (copied once
        a leaf object, a counted transfer)."""
        if d == 0:
            return leaf
        hit = self._replicas.get(id(leaf))
        if hit is None or hit[0] is not leaf:
            hit = (leaf, [None] * self.n_devices)
            self._replicas[id(leaf)] = hit
        if hit[1][d] is None:
            hit[1][d] = self.mesh.copy(leaf, self.devices[d], "broadcast")
        return hit[1][d]

    def _frame(self, carry, x: torch.Tensor):
        D, devs = self.n_devices, self.devices
        spans = [c.to(d) for c, d in zip(x.chunk(D), devs)]
        new_carry = []
        for s, c in zip(self.stages, carry):
            if s.history > 0:
                h = int(s.history)
                if spans[0].shape[0] < h:
                    raise ValueError(f"span length {spans[0].shape[0]} < the "
                                     f"{h}-sample history of stage {s.name!r}: grow the "
                                     f"frame or use fewer devices")
                leaves = _leaves(c)
                outs = []
                c0, y = s.fn(c, spans[0])
                outs.append(y)
                last = c0
                for d in range(1, D):
                    prev = spans[d - 1]
                    halo = self.mesh.copy(prev[prev.shape[0] - h:], devs[d])
                    params = [self._replica(t, d) for t in leaves[:-1]]
                    cd = _with_window(_rebuild(c, iter(params + [leaves[-1]])), halo)
                    last, y = s.fn(cd, spans[d])
                    outs.append(y)
                window = _window(last)
                if D > 1:
                    window = self.mesh.copy(window, devs[0])
                new_carry.append(_with_window(c0, window))
            else:
                outs = [s.fn(c, sp)[1] for sp in spans]
                new_carry.append(c)
            spans = outs
        y = self.mesh.gather(spans, devs[0], 0, src_index=0)
        return tuple(new_carry), y

    def fn(self, k: int = 1):
        def run(carry, x):
            x = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
            if int(k) == 1:
                return self._frame(carry, x)
            ys = []
            for j in range(int(k)):
                carry, y = self._frame(carry, x[j])
                ys.append(y)
            return carry, torch.stack(ys)
        return run

    def compile(self, frame_size: int, k: int = 1):
        if frame_size % self.frame_multiple:
            raise ValueError(f"frame_size {frame_size} not a multiple of "
                             f"{self.frame_multiple}")
        return self.fn(k), self.init_carry()
