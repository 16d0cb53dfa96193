"""Schedulers executing block tasks (a copy of
``futuresdr_tpu/runtime/scheduler``; reference: ``src/runtime/scheduler/``):

* :class:`AsyncScheduler` (the default): one event loop on a thread of its
  own; blocking blocks (``Kernel.BLOCKING``) run on pool threads, each with
  a private loop.
* :class:`ThreadedScheduler`: N event-loop worker threads with blocks pinned
  to workers, by name or by block id (the ``FlowScheduler``'s pinned local
  queues, ``flow.rs:79-136``). It wins where the blocks' work releases the
  interpreter lock (numpy, device dispatch, IO).
* :class:`TpbScheduler`: a thread for every block, for comparison with GNU
  Radio's execution model.
"""

from .async_scheduler import AsyncScheduler
from .base import Scheduler
from .threaded import ThreadedScheduler, TpbScheduler

__all__ = ["Scheduler", "AsyncScheduler", "ThreadedScheduler", "TpbScheduler"]
