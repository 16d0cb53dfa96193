"""The scheduler interface (a copy of ``futuresdr_tpu/runtime/scheduler/base.py``;
reference: ``src/runtime/scheduler/scheduler.rs:13-33``)."""

from __future__ import annotations

import asyncio
import threading
from abc import ABC, abstractmethod
from typing import Awaitable, Callable, List

__all__ = ["Scheduler"]


class Scheduler(ABC):
    """Spawns the flowgraph's block tasks and arbitrary coroutines."""

    @abstractmethod
    def start(self) -> None:
        """Bring up worker threads / event loops (idempotent)."""

    @abstractmethod
    def shutdown(self) -> None:
        """Stop workers. Only safe when no flowgraph is running."""

    @abstractmethod
    def run_flowgraph_blocks(self, blocks, fg_inbox) -> List[Awaitable]:
        """Spawn one actor task per block; returns awaitable join handles.

        Must be called from within this scheduler's supervisor loop context
        (`Scheduler::run_flowgraph`, one task per block as in `smol.rs:109-137`).
        """

    @abstractmethod
    def spawn(self, coro) -> Awaitable:
        """Spawn a coroutine on the scheduler (`Scheduler::spawn`)."""

    @abstractmethod
    def spawn_blocking(self, fn: Callable) -> Awaitable:
        """Run a blocking callable off-loop (`Scheduler::spawn_blocking`)."""

    @property
    @abstractmethod
    def loop(self) -> asyncio.AbstractEventLoop:
        """The supervisor event loop (flowgraph main loops run here)."""

    # -- sync bridging for the user-facing API --------------------------------
    def run_coro_sync(self, coro):
        """Run ``coro`` on the scheduler loop from sync code, blocking for the result."""
        self.start()
        if threading.current_thread() is getattr(self, "_loop_thread", None):
            raise RuntimeError("run_coro_sync called from the scheduler loop thread")
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result()
