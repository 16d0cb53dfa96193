"""Seeded, site-addressed fault injection.

The port's copy of the registry of ``futuresdr_tpu/runtime/faults.py``
(its Prometheus counter left out): the planes poll it at their fault points,

=================  ==========================================================
site               checked by
=================  ==========================================================
``work:<block>``   the block event loop, right before ``kernel.work()``
                   (``runtime/block.py``)
``dispatch``       ``TpuKernel._launch_staged`` before the program's replay
                   (``tpu/kernel_block.py``)
``h2d`` / ``d2h``  ``ops/xfer.py`` at transfer start, inside the retry loop:
                   transient by default, so the backoff and deadline are
                   what gets exercised
``link``           both transfer directions (one knob faults the whole
                   link); the fake link's ``fault_rate`` is the other way
``carry``          ``TpuKernel._note_drained`` at a checkpoint's commit: a
                   fire corrupts the candidate instead of raising, so the
                   restore's integrity check must reject it and fall back
                   to the previous checkpoint
=================  ==========================================================

``work``/``dispatch``/``h2d``/``d2h``/``carry`` also accept a bare site (no
``:<name>``) matching every block; an exact ``site:name`` entry wins over the
bare one. What a fault that is not retried does is the failing block's
``BlockPolicy`` (``runtime/block.py``): fail the flowgraph, restart the
block (a ``TpuKernel`` from its carry checkpoint, replaying its in-flight
groups bit for bit) or retire it.

Device-graph fusion (``runtime/devchain.py``) declines while a ``work`` site
or a block-addressed ``dispatch:<name>``/``carry:<name>`` site is armed
(:meth:`FaultPlan.has_site`, :meth:`FaultPlan.has_named_site`): the fused
kernel polls those sites under its own name, which would quietly disarm the
campaign. A bare ``dispatch`` or ``carry`` site keeps fusion on.

Arming: programmatic (:func:`arm` / :func:`disarm`) or the environment,

    FUTURESDR_TPU_FAULTS="seed=42;work:TpuKernel_1@0.01;h2d@0.25@2"

``seed=N`` sets the default seed; each other entry is ``site@rate`` with an
optional ``@max`` cap (``h2d@0.25@2`` = 25% a transfer, at most 2 fires).
Each armed site draws from its own ``random.Random(f"{seed}:{site}")``
stream, so injection does not depend on the order of arming or on other
sites.

The module imports only the logger, so ``ops/xfer.py`` can use it.
"""

from __future__ import annotations

import os
import random
import threading
from typing import Dict, Optional

from ..log import logger

__all__ = [
    "InjectedFault", "TransientInjectedFault", "FaultPlan", "plan", "arm",
    "disarm", "maybe", "reset", "SITES", "TRANSIENT_SITES", "ENV_VAR",
]

log = logger("runtime.faults")

ENV_VAR = "FUTURESDR_TPU_FAULTS"

#: documented injection sites (arbitrary site strings are allowed — these are
#: the ones the runtime polls)
SITES = ("work", "dispatch", "h2d", "d2h", "link", "carry")

#: sites whose faults default to TRANSIENT (retryable by ops/xfer.py)
TRANSIENT_SITES = ("h2d", "d2h", "link")


class InjectedFault(RuntimeError):
    """A fault fired by an armed injector. ``transient`` steers the transfer
    plane's classification (``ops.xfer.classify_transfer_error``)."""

    transient = False

    def __init__(self, site: str, seq: int):
        self.site = site
        self.seq = seq                       # nth fire at this site
        super().__init__(f"injected fault at {site!r} (fire #{seq})")


class TransientInjectedFault(InjectedFault):
    transient = True


class SiteInjector:
    """One armed site: seeded Bernoulli draw per :meth:`check`, optional
    fault cap. ``draws``/``fired`` are exposed for campaign assertions."""

    __slots__ = ("site", "rate", "seed", "max_faults", "transient",
                 "draws", "fired", "_rng", "_lock")

    def __init__(self, site: str, rate: float, seed: int,
                 max_faults: Optional[int], transient: bool):
        self.site = site
        self.rate = float(rate)
        self.seed = int(seed)
        self.max_faults = max_faults
        self.transient = bool(transient)
        self.draws = 0
        self.fired = 0
        # per-site stream: independent of other sites and of arming order
        self._rng = random.Random(f"{seed}:{site}")
        self._lock = threading.Lock()

    def check(self) -> None:
        """Draw once; raise when the fault fires (and the cap allows)."""
        with self._lock:
            self.draws += 1
            if self.max_faults is not None and self.fired >= self.max_faults:
                return
            hit = self.rate >= 1.0 or self._rng.random() < self.rate
            if not hit:
                return
            self.fired += 1
            seq = self.fired
        cls = TransientInjectedFault if self.transient else InjectedFault
        raise cls(self.site, seq)


class FaultPlan:
    """The registry of armed injectors (one per site address)."""

    def __init__(self, env: Optional[str] = None):
        self._sites: Dict[str, SiteInjector] = {}
        self._armed = False
        if env:
            self.load_spec(env)

    # -- arming ---------------------------------------------------------------
    def arm(self, site: str, rate: float = 1.0, seed: int = 0,
            max_faults: Optional[int] = None,
            transient: Optional[bool] = None) -> SiteInjector:
        """Arm ``site`` (``"h2d"`` or ``"work:<block>"`` style); returns the
        injector for fired/draw introspection. ``transient=None`` defaults by
        the site's plane (:data:`TRANSIENT_SITES`)."""
        if transient is None:
            transient = site.split(":", 1)[0] in TRANSIENT_SITES
        inj = SiteInjector(site, rate, seed, max_faults, transient)
        self._sites[site] = inj
        self._armed = True
        log.info("fault injector armed: %s rate=%g seed=%d max=%s "
                 "transient=%s", site, rate, seed, max_faults, transient)
        return inj

    def disarm(self, site: Optional[str] = None) -> None:
        """Disarm one site, or everything when ``site`` is None."""
        if site is None:
            self._sites.clear()
        else:
            self._sites.pop(site, None)
        self._armed = bool(self._sites)

    def load_spec(self, spec: str) -> None:
        """Parse the :data:`ENV_VAR` grammar (see module docstring)."""
        seed = 0
        entries = []
        for raw in spec.replace(",", ";").split(";"):
            raw = raw.strip()
            if not raw:
                continue
            if raw.startswith("seed="):
                try:
                    seed = int(raw[5:])
                except ValueError:
                    log.error("bad fault seed %r (ignored)", raw)
                continue
            parts = raw.split("@")
            if len(parts) not in (2, 3):
                log.error("bad fault entry %r (want site@rate[@max])", raw)
                continue
            entries.append(parts)
        for parts in entries:
            try:
                site = parts[0]
                rate = float(parts[1])
                cap = int(parts[2]) if len(parts) == 3 else None
            except ValueError:
                log.error("bad fault entry %r (ignored)", "@".join(parts))
                continue
            self.arm(site, rate, seed=seed, max_faults=cap)

    # -- querying -------------------------------------------------------------
    def armed(self) -> bool:
        return self._armed

    def has_site(self, plane: str) -> bool:
        """Is an injector armed on ``plane``, bare or ``plane:<name>``?"""
        if not self._armed:
            return False
        prefix = plane + ":"
        return any(s == plane or s.startswith(prefix) for s in self._sites)

    def has_named_site(self, plane: str) -> bool:
        """Is a block-addressed injector (``plane:<name>``) armed? A fused
        kernel polls the bare site under its own name, so only these make
        fusion decline."""
        if not self._armed:
            return False
        prefix = plane + ":"
        return any(s.startswith(prefix) for s in self._sites)

    def resolve(self, site: str, name: Optional[str] = None
                ) -> Optional[SiteInjector]:
        """The injector addressing ``site``(+``name``): exact ``site:name``
        first, then the bare site; None when unarmed. Resolve once per hot
        loop and call :meth:`SiteInjector.check` on the result."""
        if not self._armed:
            return None
        if name is not None:
            inj = self._sites.get(f"{site}:{name}")
            if inj is not None:
                return inj
        return self._sites.get(site)

    def maybe(self, site: str, name: Optional[str] = None) -> None:
        """Draw at ``site`` (no-op when unarmed); raises on a fire."""
        inj = self.resolve(site, name)
        if inj is not None:
            inj.check()

    def counts(self) -> Dict[str, int]:
        """``{site: fired}`` across every armed injector."""
        return {s: inj.fired for s, inj in self._sites.items()}


_plan: Optional[FaultPlan] = None
_plan_lock = threading.Lock()


def plan() -> FaultPlan:
    """The process-global plan (created on first use; arms from the
    :data:`ENV_VAR` spec if one is set)."""
    global _plan
    if _plan is None:
        with _plan_lock:
            if _plan is None:
                _plan = FaultPlan(os.environ.get(ENV_VAR, ""))
    return _plan


def reset(reload_env: bool = False) -> FaultPlan:
    """Replace the process plan with a fresh one (tests); ``reload_env``
    re-parses :data:`ENV_VAR`."""
    global _plan
    with _plan_lock:
        _plan = FaultPlan(os.environ.get(ENV_VAR, "") if reload_env else "")
    return _plan


def arm(site: str, rate: float = 1.0, seed: int = 0,
        max_faults: Optional[int] = None,
        transient: Optional[bool] = None) -> SiteInjector:
    return plan().arm(site, rate, seed, max_faults, transient)


def disarm(site: Optional[str] = None) -> None:
    plan().disarm(site)


def maybe(site: str, name: Optional[str] = None) -> None:
    plan().maybe(site, name)
