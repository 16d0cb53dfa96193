"""Per-tenant fair credit budgeting for the serving front-end.

The port's copy of ``futuresdr_tpu/serve/credits.py``.

This generalizes the single-stream :class:`~futuresdr_tpu_torch.tpu.kernel_block.
CreditController` (the adaptive in-flight budget of the streamed drain loop)
to the MULTI-tenant admission plane: the serving engine holds ONE shared
frame-credit budget (how many submitted-but-undispatched frames the whole
slot table may queue), and this controller divides it fairly between
tenants. The invariant it enforces is the starvation guard of
docs/serving.md:

    a stalled tenant — one whose sessions stopped consuming their queued
    frames — can never hold so much of the shared budget that a sibling
    tenant is denied its fair share.

Mechanically: every tenant is guaranteed ``fair = max(1, total //
n_tenants)`` credits at all times. A tenant may borrow PAST its fair share
(a lone busy tenant should be able to use the whole chip), but only out of
headroom that is not reserved for the other tenants' unexhausted guarantees
— so when a sibling shows up, its ``fair`` credits are by construction
still grantable, no matter how wedged the borrower is. All O(tenants) per
acquire, lock-cheap (admission rate, not sample rate).
"""

from __future__ import annotations

import threading
from typing import Dict

__all__ = ["TenantCreditController"]


class TenantCreditController:
    """Fair division of a shared frame-credit ``total`` between tenants.

    ``register``/``unregister`` track tenant membership (the engine calls
    them on the first admit / last close of a tenant's sessions);
    ``try_acquire`` grants one credit to a tenant or refuses (the engine
    surfaces refusal as submit backpressure, billed per tenant on
    ``fsdr_serve_rejects_total``); ``release`` returns one.
    """

    def __init__(self, total: int):
        self._total = max(1, int(total))
        self._used: Dict[str, int] = {}
        self._lock = threading.Lock()

    # -- membership -----------------------------------------------------------
    def register(self, tenant: str) -> None:
        with self._lock:
            self._used.setdefault(tenant, 0)

    def unregister(self, tenant: str) -> None:
        """Drop a tenant from the fair-share divisor. Outstanding credits (a
        closed session's still-queued frames) die with the registration."""
        with self._lock:
            self._used.pop(tenant, None)

    def set_total(self, total: int) -> None:
        """Re-size the shared budget (the engine grows it with the slot
        table). Shrinking below current usage only throttles NEW acquires —
        outstanding credits drain normally."""
        with self._lock:
            self._total = max(1, int(total))

    # -- introspection --------------------------------------------------------
    @property
    def total(self) -> int:
        return self._total

    def fair_share(self) -> int:
        with self._lock:
            return self._fair()

    def _fair(self) -> int:
        return max(1, self._total // max(1, len(self._used)))

    def used(self, tenant: str) -> int:
        with self._lock:
            return self._used.get(tenant, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._used)

    def pressure(self) -> float:
        """Aggregate queue pressure in [0, 1]: outstanding credits over the
        shared budget — the shedding ladder's primary signal
        (serve/overload.py)."""
        with self._lock:
            return min(1.0, sum(self._used.values()) / float(self._total))

    def tenant_pressure(self) -> Dict[str, float]:
        """Per-tenant queue-depth watermark view: each tenant's outstanding
        credits over its fair share (>1 = borrowing past the guarantee).
        Served on the engine's describe() so an operator sees WHICH tenant
        is driving the ladder."""
        with self._lock:
            fair = float(self._fair())
            return {t: round(u / fair, 4) for t, u in self._used.items()}

    # -- the credit operations ------------------------------------------------
    def try_acquire(self, tenant: str) -> bool:
        """Grant one credit to ``tenant`` or refuse.

        Grant when the tenant is under its fair share, OR when the remaining
        headroom exceeds what the OTHER tenants' guarantees still reserve —
        borrowing never eats into a sibling's unexhausted fair share, which
        is exactly the stalled-tenant starvation guard."""
        with self._lock:
            self._used.setdefault(tenant, 0)
            fair = self._fair()
            mine = self._used[tenant]
            if mine < fair:
                self._used[tenant] = mine + 1
                return True
            reserved = sum(max(0, fair - u) for t, u in self._used.items()
                           if t != tenant)
            if sum(self._used.values()) + reserved < self._total:
                self._used[tenant] = mine + 1
                return True
            return False

    def release(self, tenant: str, n: int = 1) -> None:
        with self._lock:
            if tenant in self._used:
                self._used[tenant] = max(0, self._used[tenant] - int(n))

    def reacquire(self, tenant: str, n: int = 1) -> None:
        """Unconditionally re-take ``n`` credits released in error — the
        engine's dispatch-failure rollback re-queues popped frames and their
        credits with it. Bypasses the fairness check: the frames it covers
        already passed admission once."""
        with self._lock:
            self._used[tenant] = self._used.get(tenant, 0) + int(n)
