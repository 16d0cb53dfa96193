"""Schedulers (only the default asyncio scheduler is carried over)."""

from .async_scheduler import AsyncScheduler

__all__ = ["AsyncScheduler"]
