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

Across processes (:mod:`.multihost`), every mesh entry also carries the rank
that owns it (:attr:`Mesh.owners`), and each process walks the same program
over the whole mesh (SPMD). A :class:`Sharded` value then holds only the
calling rank's shards (``None`` stands for another rank's, which is never
materialised); a copy between two ranks' entries is a send on the owner and
a receive on the destination (:meth:`Mesh.move`), and :meth:`Mesh.gather`
is an all-gather in shard order. The single-process mesh is the case of one
rank (``owners`` None) and behaves as the single controller does.

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
    i-th device and holds the i-th contiguous block along ``dim``. On a mesh
    across processes ``shards[i]`` is ``None`` where another rank owns the
    i-th device, and ``mesh`` is that mesh (:func:`~.stream_sp.to_host`
    gathers through it)."""
    shards: List[Optional[torch.Tensor]]
    axis: str
    dim: int = 0
    mesh: Optional["Mesh"] = None


@dataclass
class Mesh:
    """An array of devices with axis names, and the counts of the transfers
    between its shards.

    ``owners`` (an int array of the devices' shape, or None for a single
    process) is each entry's rank and ``rank`` the calling process's. Every
    transfer is counted on the rank it lands on: :attr:`transfers` by kind
    and :attr:`transfer_bytes` all of them, :attr:`rank_transfers` and
    :attr:`rank_transfer_bytes` the ones that crossed from another rank."""
    devices: np.ndarray                   # object array of torch.device
    axis_names: Tuple[str, ...]
    transfers: Counter = field(default_factory=Counter)
    transfer_bytes: int = 0
    owners: Optional[np.ndarray] = None
    rank: int = 0
    rank_transfers: Counter = field(default_factory=Counter)
    rank_transfer_bytes: int = 0

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

    @property
    def distributed(self) -> bool:
        """Whether the mesh's entries belong to more than one process."""
        return self.owners is not None

    def _line_index(self, axis: str, at: Dict[str, int]) -> List[tuple]:
        a = self.axis_index(axis)
        idx = [0] * self.devices.ndim
        for name, i in at.items():
            idx[self.axis_index(name)] = int(i)
        out = []
        for i in range(self.devices.shape[a]):
            idx[a] = i
            out.append(tuple(idx))
        return out

    def line(self, axis: str, **at: int) -> List[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis (or at
        the indices ``at`` names): where a value sharded over ``axis`` alone
        lives (the other axes replicate it, so one copy of the work is
        enough)."""
        return [self.devices[i] for i in self._line_index(axis, at)]

    def line_owners(self, axis: str, **at: int) -> List[int]:
        """The rank owning each device of :meth:`line`."""
        if self.owners is None:
            return [self.rank] * self.devices.shape[self.axis_index(axis)]
        return [int(self.owners[i]) for i in self._line_index(axis, at)]

    def mine(self, axis: str, **at: int) -> List[bool]:
        """Whether this process owns each device of :meth:`line`."""
        return [r == self.rank for r in self.line_owners(axis, **at)]

    def reset_counts(self) -> None:
        self.transfers = Counter()
        self.transfer_bytes = 0
        self.rank_transfers = Counter()
        self.rank_transfer_bytes = 0

    def _count(self, kind: str, nbytes: int, crossed: bool) -> None:
        self.transfers[kind] += 1
        self.transfer_bytes += nbytes
        if crossed:
            self.rank_transfers[kind] += 1
            self.rank_transfer_bytes += nbytes

    def copy(self, t: torch.Tensor, dst: torch.device, kind: str = "ppermute") -> torch.Tensor:
        """A cross-shard transfer of ``t`` to ``dst`` inside this process (a
        tensor of its own, also between two logical devices on one card),
        counted."""
        self._count(kind, t.numel() * t.element_size(), False)
        return t.to(dst, non_blocking=True, copy=True)

    def move(self, t: Optional[torch.Tensor], src: int, dst: int, axis: str,
             kind: str = "ppermute", like: Optional[torch.Tensor] = None,
             shape: Optional[Tuple[int, ...]] = None, **at: int) -> Optional[torch.Tensor]:
        """Entry ``src`` of ``axis``'s line hands ``t`` to entry ``dst``:
        returns the tensor on ``dst``'s device where this process owns
        ``dst``, else None. Within one process it is :meth:`copy`; between
        two ranks the owner of ``src`` sends ``t`` and the owner of ``dst``
        receives a tensor of ``shape`` and ``like``'s dtype (``like``: any
        tensor of the receiver's with that dtype; ``shape`` defaults to
        ``like``'s). Every rank walks the same moves in the same order, so
        each send meets its receive."""
        owners = self.line_owners(axis, **at)
        a, b = owners[src], owners[dst]
        if a == b:
            if b != self.rank:
                return None
            return self.copy(t, self.line(axis, **at)[dst], kind)
        from . import multihost
        if self.rank == a:
            multihost.send(t, b)
            return None
        if self.rank != b:
            return None
        shape = tuple(like.shape) if shape is None else tuple(shape)
        y = multihost.recv(shape, like.dtype, a, self.line(axis, **at)[dst])
        self._count(kind, y.numel() * y.element_size(), True)
        return y

    def gather(self, shards: Sequence[Optional[torch.Tensor]], dst: torch.device,
               dim: int = 0, src_index: Optional[int] = None) -> torch.Tensor:
        """All shards concatenated along ``dim`` on ``dst``; every shard but
        the one already there (``src_index``) is a counted transfer. On a
        mesh across processes (``shards`` holding None for another rank's) it
        is an all-gather: every rank takes part, in shard order, and every
        rank gets the whole value on its own ``dst``."""
        if self.owners is None:
            parts = [s if i == src_index else self.copy(s, dst, "all_gather")
                     for i, s in enumerate(shards)]
            return torch.cat(parts, dim=dim)
        from . import multihost
        parts = multihost.allgather_shards(list(shards), dst)
        for s, p in zip(shards, parts):
            if s is None:
                self._count("all_gather", p.numel() * p.element_size(), True)
        return torch.cat(parts, dim=dim)


def make_mesh(axis_names: Sequence[str], shape: Optional[Sequence[int]] = None,
              devices=None, device=None, owners: Optional[Sequence[int]] = None,
              rank: int = 0) -> Mesh:
    """A mesh over ``devices`` (default :func:`visible_devices` of
    ``device``); the shape is factored when omitted. ``owners`` (one rank a
    device) and ``rank`` make a mesh across processes
    (:func:`.multihost.global_mesh` passes them).

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
    own = None
    if owners is not None:
        if len(owners) != len(devices):
            raise ValueError(f"{len(owners)} owners for {len(devices)} devices")
        own = np.asarray(owners[:need], dtype=np.int64).reshape(shape)
    return Mesh(arr.reshape(shape), tuple(axis_names), owners=own, rank=int(rank))


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


def shard_params(params: Dict[str, torch.Tensor], mesh: Mesh, axis: str = "mp",
                 **at: int):
    """FSDP-style weight sharding of a flat dict of tensors (a state dict):
    each leaf's largest dimension that divides by the axis size splits over
    ``axis`` (a :class:`Sharded`), the rest are copied to every device of the
    axis (a list). The axis's line is :meth:`Mesh.line` at ``at``. Returns
    ``(sharded, specs)``, ``specs[name]`` a tuple with ``axis`` at the split
    dimension (the reference's ``PartitionSpec``)."""
    devs = mesh.line(axis, **at)
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
