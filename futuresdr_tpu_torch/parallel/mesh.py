"""Device meshes for the port's multi-device plane.

The counterpart of ``futuresdr_tpu/parallel/mesh.py``. The reference is
single-controller SPMD: one process holds a ``jax.sharding.Mesh`` and XLA
inserts the collectives. The port keeps the single controller: one process
drives every device of a :class:`Mesh`, an array of ``torch.device`` with axis
names. A sharded value is the list of its per-device shards plus the axis it
splits (:class:`Sharded`). Cross-shard communication is explicit and counted on
the mesh:

* ``ppermute`` is a peer copy (:meth:`Mesh.copy`), ``t.to(dst,
  non_blocking=True)``: PyTorch orders a copy between two cards after the work
  queued on the source's current stream, and on an H100 host the copy rides
  NVLink;
* an all-gather (:meth:`Mesh.gather`) copies every shard to one device and
  concatenates them there in shard order, so a result never depends on
  timing;
* every such copy adds one to :attr:`Mesh.transfers` (by kind) and its bytes
  to :attr:`Mesh.transfer_bytes`. A data-sharded program makes none.

Devices: :func:`visible_devices` lists the cards there are and raises without
one. Config ``virtual_devices`` (0, off, by default) lists that many logical
devices on the first physical one instead (the CPU when ``device="cpu"`` is
asked for, else card 0): the counterpart of the reference's
``--xla_force_host_platform_device_count``. Logical devices on one card run
one after another, so they measure overhead, not scaling. Nothing turns it on
implicitly and nothing falls back to the CPU.
"""

from __future__ import annotations

import contextlib
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "Sharded", "make_mesh", "factor_devices", "shard_params",
           "visible_devices", "describe_devices", "on_device"]


def factor_devices(n: int, n_axes: int = 2) -> Tuple[int, ...]:
    """Factor n devices into a near-balanced axis tuple (largest axes first).

    The product always equals ``n`` and the tuple always has ``n_axes``
    entries: prime counts on deep meshes land the whole prime on one axis
    with 1s elsewhere (``factor_devices(7, 3) == (7, 1, 1)``). Degenerate
    inputs are refused."""
    n, n_axes = int(n), int(n_axes)
    if n < 1:
        raise ValueError(f"cannot factor {n} devices (need >= 1)")
    if n_axes < 1:
        raise ValueError(f"need >= 1 mesh axis, got {n_axes}")
    dims = [1] * n_axes
    rem = n
    f = 2
    factors = []
    while rem > 1 and f * f <= rem:
        while rem % f == 0:
            factors.append(f)
            rem //= f
        f += 1
    if rem > 1:
        factors.append(rem)
    for f in sorted(factors, reverse=True):
        i = int(np.argmin(dims))
        dims[i] *= f
    assert int(np.prod(dims)) == n, (n, n_axes, dims)
    return tuple(sorted(dims, reverse=True))


def visible_devices(device=None) -> List[torch.device]:
    """The devices a mesh may take: every card (``device`` None or a CUDA
    device), or ``device`` alone (the CPU); with config ``virtual_devices``
    n > 0, n logical devices on one physical device (``device``, else card
    0). Raises without a card unless the CPU is asked for by name."""
    from ..config import config
    n = int(config().virtual_devices or 0)
    if device is not None and torch.device(device).type != "cuda":
        return [torch.device(device)] * max(n, 1)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' (with config "
                           "virtual_devices for a mesh of logical CPU devices)")
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n > 0:
        d = torch.device(device) if device is not None else cards[0]
        return [torch.device("cuda", d.index if d.index is not None else 0)] * n
    return cards


def on_device(device):
    """A context making ``device``'s card the current one (nothing for the
    CPU): a program is captured, and replayed, under its own card."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def describe_devices(devices: Sequence[torch.device]) -> str:
    """What a mesh's shards run on: ``"4 logical shards on 1 card(s)"`` where
    several share a device (or ``on the CPU``), else ``"4 shards on 4
    card(s)"``."""
    phys = {str(d) for d in devices}
    where = "the CPU" if all(d.type == "cpu" for d in devices) else f"{len(phys)} card(s)"
    kind = "logical shards" if len(phys) < len(devices) else "shard(s)"
    return f"{len(devices)} {kind} on {where}"


@dataclass
class Sharded:
    """A value split over one mesh axis: ``shards[i]`` lives on the axis's
    i-th device and holds the i-th contiguous block along ``dim``."""
    shards: List[torch.Tensor]
    axis: str
    dim: int = 0


@dataclass
class Mesh:
    """An array of devices with axis names, and the counts of the transfers
    between its shards."""
    devices: np.ndarray                   # object array of torch.device
    axis_names: Tuple[str, ...]
    transfers: Counter = field(default_factory=Counter)
    transfer_bytes: int = 0

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_index(self, axis: str) -> int:
        try:
            return self.axis_names.index(axis)
        except ValueError:
            raise ValueError(f"mesh has no axis {axis!r} (axes {self.axis_names})") from None

    def line(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis: where a
        value sharded over ``axis`` alone lives (the other axes replicate it,
        so one copy of the work is enough)."""
        a = self.axis_index(axis)
        idx = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[a]):
            idx[a] = i
            out.append(self.devices[tuple(idx)])
        return out

    def reset_counts(self) -> None:
        self.transfers = Counter()
        self.transfer_bytes = 0

    def copy(self, t: torch.Tensor, dst: torch.device, kind: str = "ppermute") -> torch.Tensor:
        """A cross-shard transfer of ``t`` to ``dst`` (a tensor of its own,
        also between two logical devices on one card), counted."""
        self.transfers[kind] += 1
        self.transfer_bytes += t.numel() * t.element_size()
        return t.to(dst, non_blocking=True, copy=True)

    def gather(self, shards: Sequence[torch.Tensor], dst: torch.device, dim: int = 0,
               src_index: Optional[int] = None) -> torch.Tensor:
        """All shards concatenated along ``dim`` on ``dst``; every shard but
        the one already there (``src_index``) is a counted transfer."""
        parts = [s if i == src_index else self.copy(s, dst, "all_gather")
                 for i, s in enumerate(shards)]
        return torch.cat(parts, dim=dim)


def make_mesh(axis_names: Sequence[str], shape: Optional[Sequence[int]] = None,
              devices=None, device=None) -> Mesh:
    """A mesh over ``devices`` (default :func:`visible_devices` of
    ``device``); the shape is factored when omitted.

    A ``shape`` needing more devices than exist is refused: a short mesh
    would change what the program computes. A shape over fewer devices than
    exist is an explicit sub-mesh and stays valid."""
    devices = list(devices) if devices is not None else visible_devices(device)
    devices = [torch.device(d) for d in devices]
    if shape is None:
        shape = factor_devices(len(devices), len(axis_names))
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} has {len(shape)} axes but "
                         f"{len(axis_names)} axis names {tuple(axis_names)}")
    need = int(np.prod(shape))
    if need > len(devices):
        raise ValueError(f"mesh shape {shape} needs {need} devices but only "
                         f"{len(devices)} exist — refusing to build a short mesh "
                         f"(shrink the shape, or set config virtual_devices)")
    arr = np.empty(need, dtype=object)
    for i, d in enumerate(devices[:need]):
        arr[i] = d
    return Mesh(arr.reshape(shape), tuple(axis_names))


def _spec_for(shape: Tuple[int, ...], n: int, axis: str) -> tuple:
    """The reference's rule: shard the largest dimension that divides by
    ``n``; replicate a leaf with none (or a scalar)."""
    if not shape:
        return ()
    for ax in np.argsort(list(shape), kind="stable")[::-1]:
        if shape[ax] % n == 0 and shape[ax] >= n:
            spec = [None] * len(shape)
            spec[ax] = axis
            return tuple(spec)
    return (None,) * len(shape)


def shard_params(params: Dict[str, torch.Tensor], mesh: Mesh, axis: str = "mp"):
    """FSDP-style weight sharding of a flat dict of tensors (a state dict):
    each leaf's largest dimension that divides by the axis size splits over
    ``axis`` (a :class:`Sharded`), the rest are copied to every device of the
    axis (a list). Returns ``(sharded, specs)``, ``specs[name]`` a tuple with
    ``axis`` at the split dimension (the reference's ``PartitionSpec``)."""
    devs = mesh.line(axis)
    n = len(devs)
    sharded, specs = {}, {}
    for name, t in params.items():
        t = torch.as_tensor(t)
        spec = _spec_for(tuple(t.shape), n, axis)
        specs[name] = spec
        if axis in spec:
            dim = spec.index(axis)
            sharded[name] = Sharded([c.to(d) for c, d in zip(t.chunk(n, dim), devs)], axis,
                                    dim)
        else:
            sharded[name] = [t.to(d) for d in devs]
    return sharded, specs
