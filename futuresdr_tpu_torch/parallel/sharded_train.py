"""The train step over a mesh: the batch data-parallel over ``dp``, the
weights FSDP-sharded over ``mp``.

The counterpart of ``jax.jit(make_train_step(model, opt))`` over the
shardings of ``futuresdr_tpu/parallel/mesh.shard_params``
(``tests/test_parallel.py``'s ``test_sharded_train_step_spmd``, the
dryrun of ``__graft_entry__.py``). XLA derives that program's collectives from the
shardings; here they are written out, each a counted transfer on the mesh:

* every ``dp`` index is a row of the mesh (its other axes at 0 but ``mp``).
  Each row holds the parameters: a leaf that :func:`~.mesh.shard_params`
  marks ``mp`` is stored split along ``mp`` over the row's ``mp`` devices,
  the rest a copy on each (with ``mp_axis`` None, the row is one device and
  holds every leaf whole);
* a step gathers each row's ``mp`` shards onto the row's first device
  (``all_gather``), runs the forward and backward there on the row's shard
  of the batch, weighted by its share of the batch;
* the rows' gradients are summed over ``dp`` into the mean-batch gradient
  the one-device step takes: within a process on the first row's device and
  copied back (``psum``), and across processes by an all-reduce over
  ``torch.distributed``;
* each ``mp`` shard takes its slice of the summed gradient
  (``reduce_scatter``), each copy of a whole leaf the whole of it
  (``broadcast``), and the optimizer (``torch.optim.Adam``, elementwise, so
  a shard steps as its slice of the leaf would) steps the stored shards. The ``mp`` leaves stay sharded through the step.

On a mesh across processes (:mod:`.multihost`) each rank runs the rows it
owns (a row must not span two ranks) and every rank sees the same loss. The
sums run in another order than the one-device step's, so the two agree to a
stated tolerance, not bit for bit. Parameters with ``requires_grad`` False
(MCLDNN's frozen LSTM input biases) are carried and never stepped.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from .mesh import Mesh, Sharded, shard_params
from .stream_sp import place

__all__ = ["ShardedTrainStep"]

LR = 1e-3              # optax's adam default, the one-device step's optimizer


class ShardedTrainStep:
    """``step(iq, labels) -> (loss, acc)`` over ``mesh`` (module docstring),
    stepping with ``torch.optim.Adam`` at :data:`LR` (optax's ``adam``
    defaults, as the one-device ``make_train_step``'s optimizer);
    ``loss_fn(model, iq, labels) -> (loss, acc)`` is the model's loss (for
    MCLDNN, ``models.mcldnn.loss_fn``).

    ``iq`` and ``labels`` are the whole batch (every rank the same, made from
    one seed; each row takes its shard); ``loss`` and ``acc`` are the whole
    batch's, 0-d tensors on the first row's device this rank owns.
    ``model`` gives the architecture and the starting weights and is not
    changed; :meth:`state_dict` gives the stepped weights whole."""

    def __init__(self, model: nn.Module, mesh: Mesh, loss_fn: Callable,
                 dp_axis: str = "dp", mp_axis: Optional[str] = "mp"):
        self.mesh = mesh
        self.dp_axis = dp_axis
        self.mp_axis = mp_axis
        self.loss_fn = loss_fn
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        self.trainable = [n for n, p in model.named_parameters() if p.requires_grad]
        n_dp = mesh.shape[dp_axis]
        self.rows: List[int] = []
        self.params: Dict[int, dict] = {}
        self.specs: Dict[str, tuple] = {}
        self._replicas: Dict[int, nn.Module] = {}
        self._opts = {}
        self._devs: Dict[int, list] = {}
        for d in range(n_dp):
            devs, owners = self._row(d)
            if len(set(owners)) > 1:
                raise ValueError(f"dp row {d} spans ranks {sorted(set(owners))}: a row's "
                                 f"{mp_axis!r} devices must belong to one process")
            if owners[0] != mesh.rank:
                continue
            self.rows.append(d)
            self._devs[d] = devs
            if mp_axis is None:
                leaves = {k: [v.to(devs[0])] for k, v in state.items()}
                self.specs = {k: (None,) * v.dim() for k, v in state.items()}
            else:
                leaves, self.specs = shard_params(state, mesh, mp_axis,
                                                  **{dp_axis: d})
            # tensors of the row's own: a shard or copy on the device it is
            # already on would otherwise be a view of ``model``'s weights
            leaves = {n: (Sharded([t.detach().clone() for t in leaf.shards], leaf.axis,
                                  leaf.dim) if isinstance(leaf, Sharded)
                          else [t.detach().clone() for t in leaf])
                      for n, leaf in leaves.items()}
            for n in self.trainable:
                for t in self._tensors(leaves[n]):
                    t.requires_grad_(True)
            self.params[d] = leaves
            replica = copy.deepcopy(model).to(devs[0])
            replica.train()
            self._replicas[d] = replica
            stepped = [t for n in self.trainable for t in self._tensors(leaves[n])]
            self._opts[d] = torch.optim.Adam(stepped, lr=LR)

    def _row(self, d: int):
        at = {self.dp_axis: d}
        if self.mp_axis is None:
            line = self.mesh.line(self.dp_axis)
            return [line[d]], [self.mesh.line_owners(self.dp_axis)[d]]
        return (self.mesh.line(self.mp_axis, **at),
                self.mesh.line_owners(self.mp_axis, **at))

    @staticmethod
    def _tensors(leaf) -> list:
        return list(leaf.shards) if isinstance(leaf, Sharded) else list(leaf)

    def mp_leaves(self) -> List[str]:
        """The leaves stored split along ``mp``."""
        return [k for k, s in self.specs.items() if self.mp_axis in s]

    def _gather_into(self, d: int) -> None:
        """Row ``d``'s stored leaves, whole, into its replica's parameters
        (the ``mp`` shards gathered onto the row's first device)."""
        lead = self._devs[d][0]
        leaves = self.params[d]
        with torch.no_grad():
            for name, p in self._replicas[d].named_parameters():
                leaf = leaves[name]
                if isinstance(leaf, Sharded):
                    parts = [s if m == 0 else self.mesh.copy(s, lead, "all_gather")
                             for m, s in enumerate(leaf.shards)]
                    p.copy_(torch.cat(parts, dim=leaf.dim))
                else:
                    p.copy_(leaf[0])

    def _scatter_grads(self, d: int, grads: Dict[str, torch.Tensor]) -> None:
        devs = self._devs[d]
        for name in self.trainable:
            g, leaf = grads[name], self.params[d][name]
            if isinstance(leaf, Sharded):
                for m, (c, s) in enumerate(zip(g.chunk(len(devs), leaf.dim), leaf.shards)):
                    s.grad = c.clone() if m == 0 else self.mesh.copy(c, devs[m],
                                                                     "reduce_scatter")
            else:
                for m, t in enumerate(leaf):
                    t.grad = g.clone() if m == 0 else self.mesh.copy(g, devs[m], "broadcast")

    def __call__(self, iq, labels):
        mesh = self.mesh
        if isinstance(iq, Sharded):
            raise ValueError("pass the whole batch (every rank the same): its size "
                             "weighs each row's loss")
        batch = int(iq.shape[0])
        xs = place(iq, mesh, self.dp_axis)
        ys = place(labels, mesh, self.dp_axis)
        grads: Dict[int, Dict[str, torch.Tensor]] = {}
        stats: Dict[int, torch.Tensor] = {}
        for d in self.rows:
            self._gather_into(d)
            replica = self._replicas[d]
            replica.zero_grad(set_to_none=True)
            x, y = xs.shards[d], ys.shards[d]
            w = x.shape[0] / batch
            loss, acc = self.loss_fn(replica, x, y)
            (loss * w).backward()
            params = dict(replica.named_parameters())
            grads[d] = {n: params[n].grad for n in self.trainable}
            stats[d] = torch.stack([loss.detach() * w, acc.detach() * w])
        # sum over dp: this process's rows on its first row's device, then
        # across processes, then back to every row
        first = self.rows[0]
        lead = self._devs[first][0]
        total = {n: grads[first][n].clone() for n in self.trainable}
        stat = stats[first].clone()
        for d in self.rows[1:]:
            for n in self.trainable:
                total[n] += mesh.copy(grads[d][n], lead, "psum")
            stat += mesh.copy(stats[d], lead, "psum")
        if mesh.distributed:
            from . import multihost
            flat = torch.cat([total[n].reshape(-1) for n in self.trainable] + [stat])
            multihost.all_reduce_(flat)
            off = 0
            for n in self.trainable:
                k = total[n].numel()
                total[n] = flat[off:off + k].view_as(total[n])
                off += k
            stat = flat[off:]
        for d in self.rows:
            dlead = self._devs[d][0]
            mine = total if d == first else {n: mesh.copy(g, dlead, "psum")
                                             for n, g in total.items()}
            self._scatter_grads(d, mine)
            self._opts[d].step()
            self._opts[d].zero_grad(set_to_none=True)
        return stat[0], stat[1]

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """A copy of the weights whole, on the CPU, from the first row this
        rank owns."""
        out = {}
        for name, leaf in self.params[self.rows[0]].items():
            if isinstance(leaf, Sharded):
                out[name] = torch.cat([s.detach().cpu() for s in leaf.shards], dim=leaf.dim)
            else:
                out[name] = leaf[0].detach().cpu().clone()
        return out

