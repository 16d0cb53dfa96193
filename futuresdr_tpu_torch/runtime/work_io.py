"""Work-loop control surface handed to ``Kernel.work`` (a copy of
``futuresdr_tpu/runtime/work_io.py`` without ``block_on``): ``call_again``
re-runs ``work`` without waiting for a wakeup; ``finished`` starts orderly
shutdown."""

from __future__ import annotations

__all__ = ["WorkIo"]


class WorkIo:
    __slots__ = ("call_again", "finished")

    def __init__(self):
        self.call_again: bool = False
        self.finished: bool = False

    def reset(self) -> None:
        self.call_again = False
