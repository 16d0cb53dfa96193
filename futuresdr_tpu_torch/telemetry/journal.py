"""Structured lifecycle event journal.

The port's copy of ``futuresdr_tpu/telemetry/journal.py``, spool included.

Lifecycle *decisions* — admissions, evictions, shed-rung transitions,
brownouts, restarts, recoveries, replays, checkpoint commits, retunes,
compiles, drains — used to vanish into log lines. This module gives them a
process-global, bounded, machine-readable ring: every decision site calls
:func:`emit` with a category + event name + structured fields, and each
event gets a **monotonic sequence number** (the REST cursor) plus wall and
monotonic clocks. Consumers:

* ``GET /api/events/?since=<seq>&cat=<cat>`` (runtime/ctrl_port.py) —
  cursor pagination over the ring; a client polls with the last seq it saw
  and receives only newer events, with an explicit ``gap`` flag when the
  bounded ring already evicted part of the requested range.
* Every doctor flight record embeds the last-N events (the black box now
  carries the decision history next to the thread stacks).
* a fault-injection run can check that each injected failure's journal tells
  the story in seq order (admit → shed-rung → evict → readmit → unwind).
* An optional ``journal_dir`` config knob spools every event as one JSONL
  line (single locked ``write`` of a complete line on an append-mode
  handle — atomic at the OS level), so a post-crash incarnation can read
  the previous process's decision history.

Overhead contract: :func:`emit` takes a lock, but it is only ever called at
*decision* sites (admission, eviction, restart, compile, …) — never on the
per-frame dispatch hot path, so its cost lands in the telemetry overhead
gate's measured chain ``elapsed``, not in the per-call hook classes the
gate bills (tests/test_torch_telemetry.py — the lineage sample draw is the fifth
per-call class; the journal rides inside the same ≤3% budget by riding in
the baseline).

Event schema (every event, before free-form fields)::

    {"seq": 42, "t_wall": 1754500000.123, "t_mono_ns": 9876543210,
     "cat": "serve", "event": "evict", ...site fields...}

Categories in use: ``serve`` (engine lifecycle), ``kernel`` (device-plane
init/restart/recover/replay/checkpoint/retune), ``compile`` (every
ProfilePlane-billed compile), ``shard`` (mesh runner checkpoint/recover),
``devchain`` (fused-region restart), ``chaos`` (injected faults, so a
post-mortem distinguishes the injection from the reaction), ``fleet``
(cross-host state transitions + admission-routing decisions —
telemetry/fleet.py / serve/router.py), ``journal`` (the journal's own
lifecycle: spool rotation).

The spool is size-capped: past ``journal_spool_mb`` the active
``events_<pid>.jsonl`` atomically renames to ``.1`` (``.1`` shifts to
``.2``, …, the oldest beyond ``journal_spool_keep`` is deleted) and a
fresh file opens — the rotation itself is journaled as the first event of
the new file, so a reader stitching rotated files back together can
detect the seam.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..log import logger

__all__ = ["Journal", "journal", "emit", "events", "reset_journal",
           "CATEGORIES"]

log = logger("telemetry.journal")

#: the categories the runtime emits today (free-form strings are accepted;
#: this tuple is the documented vocabulary)
CATEGORIES = ("serve", "kernel", "compile", "shard", "devchain", "chaos",
              "fleet", "journal")


class Journal:
    """Bounded ring of structured lifecycle events with a monotonic cursor.

    ``maxlen`` bounds memory (oldest events fall off; the seq counter keeps
    counting, which is how :meth:`events` detects a cursor gap).
    ``spool_dir`` optionally appends every event as one JSONL line to
    ``events_<pid>.jsonl`` under it — the durable form of the ring.
    ``spool_cap_mb``/``spool_keep`` bound the spool on long runs: past the
    cap the active file rotates (atomic ``os.replace`` shifts, oldest
    deleted), so disk use stays ≈ ``(keep + 1) × cap``.
    """

    def __init__(self, maxlen: int = 1024, spool_dir: str = "",
                 spool_cap_mb: int = 64, spool_keep: int = 4):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, int(maxlen)))
        self._seq = 0
        self._spool_dir = str(spool_dir or "")
        self._spool_f = None
        self._spool_failed = False
        self._spool_path = ""
        self._spool_bytes = 0
        self._spool_cap = max(0, int(spool_cap_mb)) * (1 << 20)
        self._spool_keep = max(1, int(spool_keep))

    # -- emission --------------------------------------------------------------
    def emit(self, cat: str, event: str, **fields: Any) -> int:
        """Record one lifecycle event; returns its seq. Never raises — a
        journal failure must not take a decision site down."""
        rec: Dict[str, Any] = {"seq": 0, "t_wall": time.time(),
                               "t_mono_ns": time.monotonic_ns(),
                               "cat": str(cat), "event": str(event)}
        for k, v in fields.items():
            if k not in rec:
                rec[k] = v
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._ring.append(rec)
            self._spool_locked(rec)
        return rec["seq"]

    def _spool_locked(self, rec: dict) -> None:
        """One complete JSONL line per event on an append-mode handle (an
        O_APPEND write of one line is atomic for readers); opened lazily,
        disabled permanently on the first OSError."""
        if not self._spool_dir or self._spool_failed:
            return
        try:
            if self._spool_f is None:
                os.makedirs(self._spool_dir, exist_ok=True)
                self._spool_path = os.path.join(
                    self._spool_dir, f"events_{os.getpid()}.jsonl")
                self._spool_f = open(self._spool_path, "a", buffering=1)
                try:  # resume the byte count of a pre-existing file
                    self._spool_bytes = os.path.getsize(self._spool_path)
                except OSError:
                    self._spool_bytes = 0
            line = json.dumps(rec, default=str) + "\n"
            self._spool_f.write(line)
            self._spool_bytes += len(line)
            if self._spool_cap and self._spool_bytes >= self._spool_cap:
                self._rotate_locked()
        except (OSError, TypeError, ValueError) as e:
            self._spool_failed = True
            log.error("journal spool disabled: %r", e)

    def _rotate_locked(self) -> None:
        """Size-cap rotation under the held emit lock: shift
        ``events_<pid>.jsonl`` → ``.1`` → ``.2`` … via atomic ``os.replace``
        (oldest beyond ``spool_keep`` deleted), reopen a fresh active file,
        and record the rotation as the new file's first event. The record is
        built inline — ``emit()`` would deadlock on the non-reentrant lock —
        so the rotation seam is visible in both the ring and the spool."""
        rotated_bytes = self._spool_bytes
        try:
            self._spool_f.close()
        except OSError:
            pass
        self._spool_f = None
        keep, path = self._spool_keep, self._spool_path
        try:
            os.remove(f"{path}.{keep}")
        except OSError:
            pass
        for i in range(keep - 1, 0, -1):
            try:
                os.replace(f"{path}.{i}", f"{path}.{i + 1}")
            except OSError:
                pass  # gap in the chain: that generation never existed
        os.replace(path, f"{path}.1")
        self._spool_f = open(path, "a", buffering=1)
        self._spool_bytes = 0
        self._seq += 1
        rec = {"seq": self._seq, "t_wall": time.time(),
               "t_mono_ns": time.monotonic_ns(),
               "cat": "journal", "event": "spool-rotate",
               "file": os.path.basename(path), "rotated_to": f"{path}.1",
               "rotated_bytes": rotated_bytes, "keep": keep}
        self._ring.append(rec)
        line = json.dumps(rec, default=str) + "\n"
        self._spool_f.write(line)
        self._spool_bytes += len(line)

    # -- reads -----------------------------------------------------------------
    @property
    def seq(self) -> int:
        """The last assigned sequence number (0 = nothing emitted yet)."""
        with self._lock:
            return self._seq

    def events(self, since: int = 0, cat: Optional[str] = None,
               limit: Optional[int] = None) -> dict:
        """Cursor read: events with ``seq > since`` in seq order.

        Returns ``{"events": [...], "next": <cursor for the next call>,
        "seq": <latest assigned seq>, "gap": <bool>}``. ``gap`` is True
        when the bounded ring already evicted part of the requested range
        (the client's cursor predates the oldest retained event) — the
        events returned are still contiguous among themselves. ``limit``
        caps the page size (the REST route's pagination); ``next`` then
        points at the last RETURNED event so the client can keep paging.
        """
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
        # `next` advances even when a cat filter returned nothing: the
        # cursor tracks the journal, not the filtered view, so a poller
        # never rereads (and never re-flags a gap for) the same range
        nxt = evs[-1]["seq"] if (limit is not None and evs) else latest
        return {"events": [dict(e) for e in evs], "next": nxt,
                "seq": latest, "gap": bool(gap)}

    def last(self, n: int = 32) -> List[dict]:
        """The newest ``n`` events oldest-first (flight-record embedding)."""
        with self._lock:
            evs = list(self._ring)
        return [dict(e) for e in evs[-max(0, int(n)):]]

    def close(self) -> None:
        with self._lock:
            f, self._spool_f = self._spool_f, None
        if f is not None:
            try:
                f.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# module-level singleton + convenience wrappers
# ---------------------------------------------------------------------------

_journal: Optional[Journal] = None
_jlock = threading.Lock()


def journal() -> Journal:
    """The process-global journal (created on first use from the
    ``journal_ring`` / ``journal_dir`` config knobs)."""
    global _journal
    if _journal is None:
        with _jlock:
            if _journal is None:
                from ..config import config
                c = config()
                _journal = Journal(
                    maxlen=int(c.get("journal_ring", 1024)),
                    spool_dir=str(c.get("journal_dir", "") or ""),
                    spool_cap_mb=int(c.get("journal_spool_mb", 64)),
                    spool_keep=int(c.get("journal_spool_keep", 4)))
    return _journal


def emit(cat: str, event: str, **fields: Any) -> int:
    """``emit("serve", "evict", app=..., session=...)`` — the one-call form
    every decision site uses."""
    return journal().emit(cat, event, **fields)


def events(since: int = 0, cat: Optional[str] = None,
           limit: Optional[int] = None) -> dict:
    return journal().events(since=since, cat=cat, limit=limit)


def reset_journal() -> Journal:
    """Discard the singleton and build a fresh one from current config
    (tests; also the path a config reload takes)."""
    global _journal
    with _jlock:
        old, _journal = _journal, None
    if old is not None:
        old.close()
    return journal()
