"""Slot-table session bookkeeping for the serving front-end.

The port's copy of ``futuresdr_tpu/serve/slots.py``.

A :class:`SlotTable` is the RAGGED-admission surface of docs/serving.md: a
fixed-capacity slot axis (the leading vmap axis of the compiled serving
program) whose lanes are claimed and released by sessions at runtime.
Sessions join, leave, stall and come back WITHOUT recompiling anything —
occupancy changes only flip entries of the active-lanes mask the engine
threads into every dispatch, and a lane's per-session carry slice is
swapped by functional index update, never by reshaping the batch.

The table is pure host bookkeeping (which session owns which lane, who is
admissible, which lanes are free); the device-side carry pages live in
:class:`~futuresdr_tpu_torch.serve.engine.ServeEngine`, which owns the page pool
the slots index into.

Paged carries: alongside lane ownership the table maintains the
session→page binding of docs/serving.md "Paged session carries". A PAGE is
one lane-sized row of the engine's device-resident carry pool; the mapping
``page_of_lane`` is threaded into every dispatch as a program input, so the
compiled program gathers each lane's carry page, steps it, and scatters it
back — joins/leaves/evicts are edits to this host-side map, never a
restack of device memory. The map is kept a PERMUTATION of ``[0, capacity)``
at all times (admission SWAPS page entries between the claimed lane and
wherever its page was parked): the in-program scatter therefore never sees
duplicate indices, whose write order ``index_copy`` does not define — the
permutation invariant is what makes the paged step deterministic.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Deque, Dict, List, Optional

__all__ = ["Session", "SlotTable", "ServeFull", "ServeDraining",
           "ServeOverload"]

#: session lifecycle states (docs/serving.md "Session lifecycle"):
#:   active   — owns a slot, dispatches whenever it has a pending frame
#:   evicted  — carry snapshotted to host, slot released; re-admissible
#:   retired  — faulted; its slot was masked off and released, outputs stop
#:   closed   — explicitly ended by the client; terminal
STATES = ("active", "evicted", "retired", "closed")

_sid_counter = itertools.count(1)


class ServeFull(RuntimeError):
    """Admission refused: every slot bucket is at capacity."""


class ServeDraining(ServeFull):
    """Admission refused: the engine is draining (graceful shutdown —
    rolling-restart lifecycle, docs/robustness.md "Serving-plane recovery").
    The REST plane maps it to 503 + ``Retry-After`` like :class:`ServeFull`;
    an orchestrator should route new sessions to another replica."""


class ServeOverload(ServeFull):
    """Admission refused by the overload-shedding ladder (rung 1): the
    engine is over its queue-pressure watermark or missing its latency SLO,
    so NEW admissions shed first while resident sessions keep their lanes
    bit-exact (serve/overload.py, billed on
    ``fsdr_serve_shed_total{reason="admission"}``)."""


class Session:
    """One tenant stream multiplexed through the serving program.

    Host-side queues only — ``pending`` holds ``(frame, t_submit_ns)``
    entries awaiting a dispatch lane, ``out`` the decoded per-frame results
    (per-sink tuples for fan-out/DAG pipelines). The device-side state is
    the session's carry LANE inside the engine's stacked carries while
    active, or the ``carry_leaves`` host snapshot while evicted.
    """

    __slots__ = ("sid", "tenant", "state", "slot", "page", "pending", "out",
                 "frames_in", "frames_out", "stall_steps", "created_ns",
                 "carry_leaves", "carry_treedef", "error", "last_latency_s")

    def __init__(self, tenant: str, sid: Optional[str] = None):
        self.sid = str(sid) if sid else f"s{next(_sid_counter)}"
        self.tenant = str(tenant)
        self.state = "active"
        self.slot: Optional[int] = None
        self.page: Optional[int] = None   # carry-pool page while active
        self.pending: Deque[tuple] = deque()
        self.out: Deque = deque()
        self.frames_in = 0
        self.frames_out = 0
        self.stall_steps = 0          # consecutive dispatches with no input
        self.created_ns = time.time_ns()
        self.carry_leaves: Optional[list] = None   # host snapshot (evicted)
        self.carry_treedef = None
        self.error: Optional[str] = None
        self.last_latency_s: Optional[float] = None

    def view(self) -> dict:
        """The per-session metrics/doctor view served by the REST plane."""
        return {
            "sid": self.sid,
            "tenant": self.tenant,
            "state": self.state,
            "slot": self.slot,
            "page": self.page,
            "frames_in": self.frames_in,
            "frames_out": self.frames_out,
            "queued": len(self.pending),
            "undelivered": len(self.out),
            "stall_steps": self.stall_steps,
            "evicted_carry": self.carry_leaves is not None,
            "error": self.error,
            "last_latency_ms": (round(self.last_latency_s * 1e3, 3)
                                if self.last_latency_s is not None else None),
        }

    def __repr__(self):
        return (f"Session({self.sid}, tenant={self.tenant}, "
                f"state={self.state}, slot={self.slot})")


class SlotTable:
    """Lane ownership over a growable slot axis.

    ``capacity`` only ever GROWS (to the next configured bucket — the engine
    compiles one program per resident bucket and restacks the carries); a
    session leaving frees its lane for the next admit, it never shrinks the
    axis. ``slots[i]`` is the owning session or None.
    """

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self.slots: List[Optional[Session]] = [None] * self.capacity
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))
        self.sessions: Dict[str, Session] = {}
        # session→page binding (module docstring): page_of_lane is the
        # permutation the engine threads into every dispatch; lane_of_page
        # is its inverse, kept in lockstep so admission can find where a
        # free page is parked in O(1)
        self.page_of_lane: List[int] = list(range(self.capacity))
        self.lane_of_page: List[int] = list(range(self.capacity))
        self._free_pages: List[int] = list(range(self.capacity - 1, -1, -1))

    # -- occupancy ------------------------------------------------------------
    @property
    def active(self) -> int:
        return self.capacity - len(self._free)

    def free_slots(self) -> int:
        return len(self._free)

    def get(self, sid: str) -> Optional[Session]:
        return self.sessions.get(str(sid))

    def occupants(self) -> List[Session]:
        """Sessions holding a lane, in slot order (the dispatch walk)."""
        return [s for s in self.slots if s is not None]

    # -- admission / release ---------------------------------------------------
    def _bind_page(self, slot: int) -> int:
        """Claim the lowest free page for ``slot``, SWAPPING map entries so
        ``page_of_lane`` stays a permutation: the claimed page is free, so
        the lane it is currently parked at is itself free — that lane takes
        over whatever page ``slot`` was parked with. (Release never swaps;
        a freed page stays parked at its lane until re-claimed.)"""
        page = self._free_pages.pop()
        lane2 = self.lane_of_page[page]
        if lane2 != slot:
            page2 = self.page_of_lane[slot]
            self.page_of_lane[slot], self.page_of_lane[lane2] = page, page2
            self.lane_of_page[page], self.lane_of_page[page2] = slot, lane2
        return page

    def admit(self, session: Session) -> int:
        """Claim a free lane for ``session`` (lowest index first — keeps the
        active prefix dense, which is what the autotuned buckets assume)
        and bind it the lowest free carry page. Raises :class:`ServeFull`
        when no lane is free; the ENGINE decides whether to grow to the
        next bucket first."""
        if not self._free:
            raise ServeFull(f"slot table at capacity ({self.capacity})")
        slot = self._free.pop()
        session.slot = slot
        session.page = self._bind_page(slot)
        session.state = "active"
        self.slots[slot] = session
        self.sessions[session.sid] = session
        return slot

    def release_slot(self, session: Session) -> Optional[int]:
        """Give the session's lane and page back (eviction/retire/close).
        The session stays in the registry — ``forget`` drops it entirely."""
        slot = session.slot
        if slot is None:
            return None
        self.slots[slot] = None
        self._free.append(slot)
        self._free.sort(reverse=True)     # lowest-index-first reuse
        session.slot = None
        if session.page is not None:
            self._free_pages.append(session.page)
            self._free_pages.sort(reverse=True)
            session.page = None
        return slot

    def forget(self, session: Session) -> None:
        self.release_slot(session)
        self.sessions.pop(session.sid, None)

    def grow(self, new_capacity: int) -> None:
        new_capacity = int(new_capacity)
        assert new_capacity > self.capacity, (new_capacity, self.capacity)
        extra = range(self.capacity, new_capacity)
        self.slots.extend([None] * (new_capacity - self.capacity))
        self._free = sorted(self._free + list(extra), reverse=True)
        # new pages park at the new lanes (identity tail keeps the
        # permutation invariant); existing bindings are untouched
        self.page_of_lane.extend(extra)
        self.lane_of_page.extend(extra)
        self._free_pages = sorted(self._free_pages + list(extra),
                                  reverse=True)
        self.capacity = new_capacity

    def tenants(self) -> Dict[str, int]:
        """``{tenant: live session count}`` over the registry (closed and
        retired sessions drop out once forgotten)."""
        out: Dict[str, int] = {}
        for s in self.sessions.values():
            out[s.tenant] = out.get(s.tenant, 0) + 1
        return out
