"""Default scheduler: one event loop thread + a thread pool for blocking blocks.

A reduced copy of ``futuresdr_tpu/runtime/scheduler/async_scheduler.py``: the
asyncio loop multiplexes all non-blocking block tasks, and each blocking
block (``BLOCKING = True``, such as the device kernel) gets a dedicated
thread with its own event loop.

Every thread the scheduler starts runs torch's CPU ops with the intra-op
thread count of the thread that created the scheduler: OpenMP keeps that
count per thread, and a new thread would otherwise take one a core, whatever
the process set (and MKL's FFTs round differently at different counts, so a
block's CPU output would depend on the thread it ran on).
"""

from __future__ import annotations

import asyncio
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Awaitable, List, Optional

import torch

from .base import Scheduler

__all__ = ["AsyncScheduler"]


def _finalize_loop_on_drop(owner, loop, pool) -> None:
    """Stop ``loop`` and shut ``pool`` (None: no pool) when ``owner`` is
    garbage-collected, so a dropped ``Runtime().run(fg)`` releases its loop
    thread at once; ``shutdown()`` stays the graceful path."""

    def stop(l=loop, p=pool):
        try:
            if not l.is_closed():
                l.call_soon_threadsafe(l.stop)
        except RuntimeError:
            pass                       # already stopping/closed
        if p is not None:
            p.shutdown(wait=False, cancel_futures=True)

    weakref.finalize(owner, stop)


class AsyncScheduler(Scheduler):
    def __init__(self, blocking_workers: int = 32):
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_thread: Optional[threading.Thread] = None
        self._torch_threads = torch.get_num_threads()
        self._blocking_pool = ThreadPoolExecutor(
            max_workers=blocking_workers, thread_name_prefix="fsdr-blocking",
            initializer=torch.set_num_threads, initargs=(self._torch_threads,))
        self._started = threading.Event()
        self._lock = threading.Lock()

    def start(self) -> None:
        spawned = False
        with self._lock:
            if self._loop_thread is None or not self._loop_thread.is_alive():
                spawned = True
                self._started.clear()
                # the thread must not hold ``self`` strongly, or the
                # drop finalizer below could never fire
                started, wself = self._started, weakref.ref(self)
                n_threads = self._torch_threads

                def run():
                    torch.set_num_threads(n_threads)
                    loop = asyncio.new_event_loop()
                    asyncio.set_event_loop(loop)
                    s = wself()
                    if s is not None:
                        s._loop = loop
                    del s
                    started.set()
                    try:
                        loop.run_forever()
                    finally:
                        loop.close()

                self._loop_thread = threading.Thread(
                    target=run, name="fsdr-scheduler", daemon=True)
                self._loop_thread.start()
        self._started.wait()
        if spawned:
            with self._lock:
                loop_now = self._loop
            if loop_now is not None:
                _finalize_loop_on_drop(self, loop_now, self._blocking_pool)

    def shutdown(self) -> None:
        with self._lock:
            if self._loop is not None and self._loop.is_running():
                self._loop.call_soon_threadsafe(self._loop.stop)
            if self._loop_thread is not None:
                self._loop_thread.join(timeout=5)
            self._loop_thread = None
            self._loop = None
        self._blocking_pool.shutdown(wait=False, cancel_futures=True)

    @property
    def loop(self) -> asyncio.AbstractEventLoop:
        self.start()
        return self._loop

    def run_flowgraph_blocks(self, blocks, fg_inbox) -> List[Awaitable]:
        """Spawn one actor task per block (blocking blocks on pool threads)."""
        handles: List[Awaitable] = []
        loop = asyncio.get_running_loop()
        for blk in blocks:
            if blk.is_blocking:
                def runner(b=blk):
                    asyncio.run(b.run(fg_inbox))
                handles.append(loop.run_in_executor(self._blocking_pool, runner))
            else:
                handles.append(loop.create_task(
                    blk.run(fg_inbox), name=f"block:{blk.instance_name}"))
        return handles

    def spawn(self, coro) -> Awaitable:
        """Run ``coro`` as a task on the running loop (a device chain's
        supervisor-protocol task)."""
        return asyncio.get_running_loop().create_task(coro)

    async def spawn_blocking(self, fn):
        """Run ``fn()`` on a pool thread and await its result (a fused device
        chain's compile and drive loop, which block)."""
        return await asyncio.get_running_loop().run_in_executor(self._blocking_pool, fn)

    def run_coro_sync(self, coro):
        """Run ``coro`` on the scheduler loop from sync code, blocking for the result."""
        self.start()
        if threading.current_thread() is self._loop_thread:
            raise RuntimeError("run_coro_sync called from the scheduler loop thread")
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result()
