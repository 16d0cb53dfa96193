"""Work-loop control surface handed to ``Kernel.work`` (a copy of
``futuresdr_tpu/runtime/work_io.py``).

Reference: ``src/runtime/work_io.rs:11-41``. ``call_again`` requests an immediate re-run of
``work`` without waiting for a wakeup; ``finished`` starts orderly shutdown; ``block_on``
parks the block on an arbitrary awaitable (timers, hardware readiness) instead of the notifier —
e.g. the reference's ``Throttle`` re-arms itself with a timer (``blocks/throttle.rs:92-94``).
"""

from __future__ import annotations

from typing import Awaitable, Optional

__all__ = ["WorkIo"]


class WorkIo:
    __slots__ = ("call_again", "finished", "_block_on")

    def __init__(self):
        self.call_again: bool = False
        self.finished: bool = False
        self._block_on: Optional[Awaitable] = None

    def block_on(self, awaitable: Awaitable) -> None:
        """Park on ``awaitable`` before the next ``work`` call (`work_io.rs:30-38`)."""
        self._drop_pending()
        self._block_on = awaitable

    def take_block_on(self) -> Optional[Awaitable]:
        aw, self._block_on = self._block_on, None
        return aw

    def _drop_pending(self) -> None:
        """Close a never-awaited parked coroutine (else: RuntimeWarning + leak)."""
        aw, self._block_on = self._block_on, None
        if aw is not None and hasattr(aw, "close"):
            aw.close()

    def reset(self) -> None:
        # a block_on left unconsumed by the event loop (work re-entered via
        # call_again before the park happened) is stale — work() re-arms if needed
        self._drop_pending()
        self.call_again = False
