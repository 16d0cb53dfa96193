"""Meshes that span processes: one process a rank over ``torch.distributed``.

The counterpart of ``futuresdr_tpu/parallel/multihost.py``. The reference
brings up jax's distributed runtime, and XLA routes the collectives of one
SPMD program over every host's devices. Here every rank runs the same Python
program over one global :class:`~.mesh.Mesh`, whose entries carry their
owning rank: each rank computes its own shards, and a copy between two
ranks' entries is a matched send and receive (:meth:`.mesh.Mesh.move`)::

    from futuresdr_tpu_torch.parallel import multihost
    multihost.initialize(coordinator="10.0.0.1:29500", num_processes=4, process_id=rank)
    mesh = multihost.global_mesh(("dp", "sp"))

The backend:

* **gloo** on the CPU, and where the ranks share one card. Gloo sends host
  tensors, so a halo between two ranks on a card is staged through pinned
  host memory: D2H, send, receive, H2D. Two ranks on one card over gloo on
  localhost are the stand-in for a network link between hosts, as the
  reference's gloo over localhost stands in for DCN between TPU hosts;
* **NCCL** where every rank of a host has a card of its own (the ranks of a
  host, found by their host names at the rendezvous, take its cards in rank
  order): the tensors go card to card.

:func:`initialize` fails loudly: a cluster that the arguments or the
environment name and that does not come up within ``timeout_s`` raises, and
nothing drops to one process. Each rank's local devices are what
:func:`~.mesh.visible_devices` gives a process (its card, or config
``virtual_devices`` logical devices on it); the global mesh is every rank's
devices in rank order.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import tempfile
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.rendezvous import rendezvous

from ..config import config
from .mesh import Mesh, make_mesh, visible_devices

__all__ = ["initialize", "shutdown", "is_distributed", "rank", "world_size", "backend",
           "local_devices", "local_device_count", "global_device_count", "global_mesh",
           "process_allgather", "all_reduce_", "barrier", "send", "recv",
           "allgather_shards", "free_port", "launch"]

DEFAULT_TIMEOUT_S = 120.0
ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


class _Process:
    """This process's place in the group: ``known`` once its card is settled,
    ``card`` None where the group runs on the CPU."""
    known: bool = False
    card: Optional[int] = None


def _hosts(store, n: int, r: int) -> Tuple[int, int]:
    """``(local_rank, local_world_size)``: this rank's place among the ranks
    on its host, by every rank's host name exchanged over the rendezvous
    store (ranks of one host in rank order)."""
    store.set(f"fsdr_host/{r}", socket.gethostname())
    names = [store.get(f"fsdr_host/{i}").decode() for i in range(n)]
    mine = [i for i in range(n) if names[i] == names[r]]
    return mine.index(r), len(mine)


def _choose(device, local_r: int, local_n: int) -> Tuple[str, Optional[int]]:
    """``(backend, card)`` for a rank that is ``local_r`` of the ``local_n``
    on its host: gloo on the CPU and where the host's ranks share a card,
    NCCL where each has one of its own."""
    if device is not None and torch.device(device).type != "cuda":
        return "gloo", None
    if not torch.cuda.is_available():
        raise RuntimeError("multihost.initialize: no CUDA device is visible to this "
                           "rank; pass device='cpu' for ranks on the CPU")
    if torch.cuda.device_count() >= local_n and dist.is_nccl_available():
        return "nccl", local_r
    return "gloo", 0


def _adopt(device) -> None:
    """Settle the card of a group that :func:`initialize` did not bring up
    (a script that called ``init_process_group`` itself): the CPU where
    ``device`` asks for it, else the card the process made current, which
    NCCL also takes; without a card it raises."""
    if device is not None and torch.device(device).type != "cuda":
        _Process.card = None
    elif not torch.cuda.is_available():
        raise RuntimeError("the process group is up but no CUDA device is visible to "
                           "this rank; pass device='cpu' for ranks on the CPU")
    else:
        _Process.card = torch.cuda.current_device()
    _Process.known = True


def initialize(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group.

    ``coordinator`` is ``host:port`` of rank 0's store. With no arguments,
    the standard environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``) names the cluster; where it names none, the
    process stays single. ``device`` None means the card (it raises without
    one); ``"cpu"`` runs the ranks on the CPU over gloo. The ranks meet at
    the ``tcp://`` store first and tell each other their hosts, so a rank
    knows its place on its host and the backend follows from the cards
    there. Where the group is already up, only this rank's card is settled
    (``device``, else the current card)."""
    if dist.is_initialized():
        if not _Process.known:
            _adopt(device)
        return
    args = (coordinator, num_processes, process_id)
    if all(a is None for a in args):
        named = [k for k in ENV_KEYS if os.environ.get(k)]
        if not named:
            return                         # no cluster named: one process
        missing = [k for k in ENV_KEYS if not os.environ.get(k)]
        if missing:
            raise RuntimeError(f"the environment names a cluster ({', '.join(named)}) "
                               f"but not {', '.join(missing)}")
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    elif any(a is None for a in args):
        raise ValueError("pass coordinator, num_processes and process_id together")
    n, r = int(num_processes), int(process_id)
    if not 0 <= r < n:
        raise ValueError(f"process_id {r} is not a rank of {n} processes")
    timeout = datetime.timedelta(seconds=float(timeout_s))
    store, _, _ = next(rendezvous(f"tcp://{coordinator}", r, n, timeout=timeout))
    store.set_timeout(timeout)
    be, card = _choose(device, *_hosts(store, n, r))
    if card is not None:
        torch.cuda.set_device(card)
    dist.init_process_group(be, store=store, world_size=n, rank=r, timeout=timeout)
    _Process.card = card
    _Process.known = True


def shutdown() -> None:
    """Leave the process group (nothing when there is none)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _Process.card = None
    _Process.known = False


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def backend() -> Optional[str]:
    """``"gloo"``, ``"nccl"``, or None for a single process."""
    return str(dist.get_backend()) if dist.is_initialized() else None


def local_devices(device=None) -> List[torch.device]:
    """This rank's devices: its card (config ``virtual_devices`` n > 0: n
    logical devices on it), or the CPU where the group runs there or
    ``device`` asks for it. A card asked of a group on the CPU raises. In a
    single process, :func:`~.mesh.visible_devices` of ``device``."""
    if not dist.is_initialized():
        return visible_devices(device)
    if not _Process.known:
        _adopt(device)
    if device is not None and torch.device(device).type != "cuda":
        return visible_devices("cpu")
    if _Process.card is None:
        if device is not None:
            raise ValueError(f"device {device!r} asked of a process group on the CPU")
        return visible_devices("cpu")
    n = int(config().virtual_devices or 0)
    return [torch.device("cuda", _Process.card)] * max(n, 1)


def local_device_count(device=None) -> int:
    return len(local_devices(device))


def _all_objects(obj) -> list:
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def global_device_count(device=None) -> int:
    if not dist.is_initialized():
        return local_device_count(device)
    return sum(_all_objects(local_device_count()))


def global_mesh(axis_names: Sequence[str], shape: Optional[Sequence[int]] = None,
                device=None) -> Mesh:
    """A mesh over every rank's devices in rank order (call it on every rank
    after :func:`initialize`); each entry owned by the rank that listed it.
    In a single process, the mesh over :func:`local_devices` of ``device``."""
    local = local_devices(device)
    if not dist.is_initialized():
        return make_mesh(axis_names, shape=shape, devices=local)
    listed = _all_objects([str(d) for d in local])
    devices = [torch.device(d) for ds in listed for d in ds]
    owners = [r for r, ds in enumerate(listed) for _ in ds]
    return make_mesh(axis_names, shape=shape, devices=devices, owners=owners, rank=rank())


# ---- tensors on the wire ------------------------------------------------------

def _wire_device() -> torch.device:
    """Where the backend takes its tensors: the host for gloo, the rank's
    card for NCCL."""
    if backend() == "nccl":
        if not _Process.known:
            _adopt(None)
        return torch.device("cuda", _Process.card)
    return torch.device("cpu")


def _real(dtype: torch.dtype) -> torch.dtype:
    return torch.empty(0, dtype=dtype).real.dtype if dtype.is_complex else dtype


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the backend sends it: complex as its real pairs, contiguous,
    staged through pinned host memory where gloo takes a card's tensor."""
    if t.is_complex():
        t = torch.view_as_real(t)
    t = t.contiguous()
    wd = _wire_device()
    if t.device == wd:
        return t
    if wd.type == "cpu":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)                      # D2H, finished before the send
        return host
    return t.to(wd)


def _wire_buffer(shape, dtype: torch.dtype) -> torch.Tensor:
    shape = tuple(shape) + ((2,) if dtype.is_complex else ())
    wd = _wire_device()
    pin = wd.type == "cpu" and torch.cuda.is_available()
    return torch.empty(shape, dtype=_real(dtype), device=wd, pin_memory=pin)


def _from_wire(buf: torch.Tensor, dtype: torch.dtype, dst) -> torch.Tensor:
    y = buf.to(dst, non_blocking=True) if buf.device != torch.device(dst) else buf
    return torch.view_as_complex(y) if dtype.is_complex else y


def send(t: torch.Tensor, dst: int) -> None:
    """Send ``t`` to rank ``dst`` (its :func:`recv` takes the shape and dtype)."""
    dist.send(_to_wire(t), dst)


def recv(shape, dtype: torch.dtype, src: int, dst) -> torch.Tensor:
    """Receive a ``shape``/``dtype`` tensor from rank ``src`` onto device ``dst``."""
    buf = _wire_buffer(shape, dtype)
    dist.recv(buf, src)
    return _from_wire(buf, dtype, dst)


def _broadcast(t: Optional[torch.Tensor], shape, dtype: torch.dtype, src: int,
               dst) -> torch.Tensor:
    if rank() == src:
        buf = _to_wire(t)
        dist.broadcast(buf, src)
        return t.to(dst, copy=True)
    buf = _wire_buffer(shape, dtype)
    dist.broadcast(buf, src)
    return _from_wire(buf, dtype, dst)


def allgather_shards(shards: List[Optional[torch.Tensor]], dst) -> List[torch.Tensor]:
    """Every shard of a value on every rank, in shard order: ``shards[i]`` is
    this rank's tensor or None where another rank holds it; each shard is
    broadcast by its owner onto every rank's ``dst``."""
    held = [(i, tuple(s.shape), str(s.dtype).split(".")[-1])
            for i, s in enumerate(shards) if s is not None]
    where = {}
    for r, items in enumerate(_all_objects(held)):
        for i, shape, dt in items:
            where[i] = (r, shape, getattr(torch, dt))
    missing = [i for i in range(len(shards)) if i not in where]
    if missing:
        raise RuntimeError(f"no rank holds shard(s) {missing}")
    return [_broadcast(shards[i], where[i][1], where[i][2], where[i][0], dst)
            for i in range(len(shards))]


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over every rank, in place (every rank gets the same bits)."""
    buf = _to_wire(t)
    dist.all_reduce(buf)
    out = _from_wire(buf, t.dtype, t.device)
    if out.data_ptr() != t.data_ptr():
        t.copy_(out)
    return t


def process_allgather(x) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all ranks), stacked along a new
    first axis in rank order: the counterpart of
    ``multihost_utils.process_allgather``. The result lies on ``x``'s
    device."""
    x = torch.as_tensor(x)
    if not dist.is_initialized():
        return x[None].clone()
    bufs = [_wire_buffer(x.shape, x.dtype) for _ in range(world_size())]
    dist.all_gather(bufs, _to_wire(x))
    return torch.stack([_from_wire(b, x.dtype, x.device) for b in bufs])


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


# ---- ranks on one host --------------------------------------------------------

def free_port() -> int:
    """A localhost port that was free a moment ago (bound to 0, closed)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_PORT_TAKEN = "Address already in use"


def launch(argv_of_rank: Callable[[int, str], List[str]], n: int, timeout_s: float,
           env: Optional[dict] = None, cwd: Optional[str] = None) -> List[Tuple[int, str]]:
    """Start ``n`` rank processes, ``argv_of_rank(rank, "127.0.0.1:<port>")``
    each, on a port found free; wait for all of them up to ``timeout_s`` in
    all, then kill what is left. Returns ``(returncode, output)`` a rank
    (stdout and stderr together; a killed rank's code is negative). A run
    whose coordinator port was taken between the probe and the bind is
    started once more on a fresh port."""
    for attempt in range(2):
        coordinator = f"127.0.0.1:{free_port()}"
        files = [tempfile.TemporaryFile(mode="w+") for _ in range(n)]
        procs = []
        try:
            for r in range(n):
                procs.append(subprocess.Popen(argv_of_rank(r, coordinator), stdout=files[r],
                                              stderr=subprocess.STDOUT, text=True, env=env,
                                              cwd=cwd))
            deadline = time.monotonic() + float(timeout_s)
            timed_out = False
            for p in procs:
                try:
                    p.wait(timeout=max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    timed_out = True
                    break
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait(timeout=30)
            outs = []
            for f in files:
                f.seek(0)
                outs.append(f.read())
                f.close()
        if timed_out:
            outs = [o + f"\n<killed after {timeout_s:.0f} s>" for o in outs]
        result = [(p.returncode, o) for p, o in zip(procs, outs)]
        if attempt == 0 and any(rc != 0 for rc, _ in result) \
                and any(_PORT_TAKEN in o for _, o in result):
            continue
        return result
    return result
