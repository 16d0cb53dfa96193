"""Pinned multi-worker scheduler: N event-loop threads, blocks pinned to workers.

A copy of ``futuresdr_tpu/runtime/scheduler/threaded.py``, the analog of the
reference's ``FlowScheduler`` (``scheduler/flow.rs:39-136``): per-worker local
queues with explicit block pinning (``pinned``) or deterministic id-based
mapping (``map_block``). Worker 0 doubles as the supervisor loop.
:class:`TpbScheduler` gives every block a thread of its own.

Every thread these schedulers start (the workers, a thread-per-block block's
thread and the blocking pool) runs torch's CPU ops at one intra-op thread:
N workers at one thread a core each would oversubscribe the cores. A block
that launches on a card names its device (the broker's), since torch keeps
the current device per thread.
"""

from __future__ import annotations

import asyncio
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Awaitable, Callable, Dict, List, Optional

import torch

from ...log import logger
from .async_scheduler import _finalize_loop_on_drop
from .base import Scheduler

__all__ = ["ThreadedScheduler", "TpbScheduler"]

log = logger("scheduler.threaded")


class _Worker:
    def __init__(self, index: int, pin_core: bool = False):
        self.index = index
        self.pin_core = pin_core
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self.ready = threading.Event()
        self.thread = threading.Thread(
            target=self._run, name=f"fsdr-worker-{index}", daemon=True)

    def _run(self):
        torch.set_num_threads(1)
        if self.pin_core:
            # core pinning (the reference's SmolScheduler/FlowScheduler CPU affinity)
            try:
                import os
                cores = sorted(os.sched_getaffinity(0))
                os.sched_setaffinity(0, {cores[self.index % len(cores)]})
            except (AttributeError, OSError) as e:
                log.warning("core pinning unavailable: %r", e)
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self.loop = loop
        self.ready.set()
        try:
            loop.run_forever()
        finally:
            loop.close()


class ThreadedScheduler(Scheduler):
    def __init__(self, workers: Optional[int] = None,
                 pinned: Optional[Dict[str, int]] = None,
                 pin_cores: bool = False):
        import os
        self.n_workers = workers or os.cpu_count() or 4
        self.pinned = pinned or {}        # instance_name -> worker index
        self.pin_cores = pin_cores
        self._workers: List[_Worker] = []
        self._blocking_pool = ThreadPoolExecutor(
            max_workers=32, thread_name_prefix="fsdr-blocking",
            initializer=torch.set_num_threads, initargs=(1,))
        self._lock = threading.Lock()

    def start(self) -> None:
        with self._lock:
            if self._workers:
                return
            for i in range(self.n_workers):
                w = _Worker(i, self.pin_cores)
                self._workers.append(w)
                w.thread.start()
            for w in self._workers:
                w.ready.wait()
            # a dropped scheduler stops its loops, as AsyncScheduler does; the
            # pool rides worker 0's finalizer
            for w in self._workers:
                _finalize_loop_on_drop(
                    self, w.loop,
                    self._blocking_pool if w.index == 0 else None)

    def shutdown(self) -> None:
        # Stop loops and snapshot under the lock, but join OUTSIDE it: a worker
        # retiring concurrently (TpbScheduler._retire runs on its own loop thread
        # and takes self._lock) would otherwise deadlock against the join until
        # its timeout expired.
        with self._lock:
            workers = list(self._workers)
            self._workers = []
            for w in workers:
                if w.loop is not None and w.loop.is_running():
                    w.loop.call_soon_threadsafe(w.loop.stop)
        for w in workers:
            w.thread.join(timeout=5)
        self._blocking_pool.shutdown(wait=False, cancel_futures=True)

    @property
    def loop(self) -> asyncio.AbstractEventLoop:
        self.start()
        return self._workers[0].loop

    @property
    def _loop_thread(self):
        return self._workers[0].thread if self._workers else None

    def map_block(self, blk) -> int:
        """Deterministic id-based worker mapping (`flow.rs:125-136`)."""
        if blk.instance_name in self.pinned:
            return self.pinned[blk.instance_name] % self.n_workers
        return blk.id % self.n_workers

    def run_flowgraph_blocks(self, blocks, fg_inbox) -> List[Awaitable]:
        handles: List[Awaitable] = []
        sup_loop = asyncio.get_running_loop()
        for blk in blocks:
            if blk.is_blocking:
                def runner(b=blk):
                    asyncio.run(b.run(fg_inbox))
                handles.append(sup_loop.run_in_executor(self._blocking_pool, runner))
                continue
            worker = self._workers[self.map_block(blk)]
            if worker.loop is sup_loop:
                handles.append(sup_loop.create_task(
                    blk.run(fg_inbox), name=f"block:{blk.instance_name}"))
            else:
                cf = asyncio.run_coroutine_threadsafe(blk.run(fg_inbox), worker.loop)
                handles.append(asyncio.wrap_future(cf))
        return handles

    def spawn(self, coro) -> Awaitable:
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is self.loop:
            return running.create_task(coro)
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return asyncio.wrap_future(fut) if running else fut

    def spawn_blocking(self, fn: Callable) -> Awaitable:
        return self.loop.run_in_executor(self._blocking_pool, fn)


class TpbScheduler(ThreadedScheduler):
    """Thread-per-block scheduler: every block's event loop gets its own OS thread.

    Role of the reference perf crate's ``TpbScheduler`` (``perf/perf/src/
    tpb_scheduler.rs:21-24`` — "mainly for comparison to GNU Radio. Do not use."):
    GNU Radio runs one thread per block, and scheduler comparisons are only
    apples-to-apples if that execution model is reproducible here. Same caveat as
    the reference: use :class:`AsyncScheduler` or :class:`ThreadedScheduler` for
    real workloads.
    """

    def __init__(self, pin_cores: bool = False):
        super().__init__(workers=1, pin_cores=pin_cores)

    def run_flowgraph_blocks(self, blocks, fg_inbox) -> List[Awaitable]:
        self.start()                      # worker 0 = supervisor/spawn loop
        handles: List[Awaitable] = []
        for i, blk in enumerate(blocks):
            # EVERY block — blocking or not — gets its own loop thread (that is the
            # whole point of this scheduler; the pool-backed blocking branch of the
            # parent would cap at its pool size). The worker is retired as soon as
            # its block finishes, so repeated run() calls don't accumulate threads.
            with self._lock:
                w = _Worker(len(self._workers), self.pin_cores)
                self._workers.append(w)
            w.thread.start()
            w.ready.wait()
            cf = asyncio.run_coroutine_threadsafe(blk.run(fg_inbox), w.loop)

            def _retire(_f, w=w):
                with self._lock:
                    if w in self._workers:
                        self._workers.remove(w)
                if w.loop is not None and w.loop.is_running():
                    w.loop.call_soon_threadsafe(w.loop.stop)

            cf.add_done_callback(_retire)
            handles.append(asyncio.wrap_future(cf))
        return handles
