"""Structured lifecycle event journal.

A reduced copy of ``futuresdr_tpu/telemetry/journal.py``: a process-global,
bounded ring of lifecycle decisions (admissions, evictions, shed-rung
transitions, brownouts, retunes, drains). Each :func:`emit` gets a monotonic
sequence number (the cursor of :func:`events`) and wall and monotonic clocks::

    {"seq": 42, "t_wall": 1754500000.123, "t_mono_ns": 9876543210,
     "cat": "serve", "event": "evict", ...site fields...}

:func:`events` reads with a cursor: events newer than ``since``, a category
filter, and a ``gap`` flag when the ring already dropped part of the range.
The reference's JSONL spool and its ``/api/events/`` route wait for the rest
of the telemetry plane (ROADMAP item 4b).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Optional

__all__ = ["Journal", "journal", "emit", "events", "reset_journal"]


class Journal:
    """Bounded ring of structured lifecycle events with a monotonic cursor;
    ``maxlen`` bounds memory (the seq keeps counting past dropped events)."""

    def __init__(self, maxlen: int = 1024):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, int(maxlen)))
        self._seq = 0

    def emit(self, cat: str, event: str, **fields: Any) -> int:
        """Record one event; returns its seq."""
        rec: Dict[str, Any] = {"seq": 0, "t_wall": time.time(),
                               "t_mono_ns": time.monotonic_ns(),
                               "cat": str(cat), "event": str(event)}
        for k, v in fields.items():
            rec.setdefault(k, v)
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._ring.append(rec)
        return rec["seq"]

    @property
    def seq(self) -> int:
        """The last assigned sequence number (0: nothing emitted yet)."""
        with self._lock:
            return self._seq

    def events(self, since: int = 0, cat: Optional[str] = None,
               limit: Optional[int] = None) -> dict:
        """Events with ``seq > since`` in seq order: ``{"events", "next",
        "seq", "gap"}``; ``next`` is the cursor for the next call."""
        since = int(since)
        with self._lock:
            evs = [e for e in self._ring if e["seq"] > since]
            latest = self._seq
            oldest = self._ring[0]["seq"] if self._ring else latest + 1
        if cat is not None:
            evs = [e for e in evs if e["cat"] == cat]
        gap = since + 1 < oldest and latest > since
        if limit is not None and len(evs) > int(limit):
            evs = evs[:int(limit)]
        nxt = evs[-1]["seq"] if (limit is not None and evs) else latest
        return {"events": [dict(e) for e in evs], "next": nxt, "seq": latest,
                "gap": bool(gap)}


_journal: Optional[Journal] = None
_jlock = threading.Lock()


def journal() -> Journal:
    """The process-global journal."""
    global _journal
    if _journal is None:
        with _jlock:
            if _journal is None:
                _journal = Journal()
    return _journal


def emit(cat: str, event: str, **fields: Any) -> int:
    """``emit("serve", "evict", app=..., session=...)``."""
    return journal().emit(cat, event, **fields)


def events(since: int = 0, cat: Optional[str] = None, limit: Optional[int] = None) -> dict:
    return journal().events(since=since, cat=cat, limit=limit)


def reset_journal() -> Journal:
    """Discard the journal and start a fresh one (tests)."""
    global _journal
    with _jlock:
        _journal = None
    return journal()
