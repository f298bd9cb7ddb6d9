"""Multi-tenant admission: quotas, priority classes, weighted-fair
dequeue.

The port's own copy of the JAX package's ``serving/tenancy.py``: the
same decisions, counters and fair order on the same script.

One serving plane multiplexing N models (``serving/registry.py``) is
only safe to share when traffic classes can't starve each other. This
module is the gateway's admission layer:

- **per-tenant quotas** — each :class:`TenantConfig` caps how many
  units a tenant may hold in the plane at once (a unit is one queued
  offline request at the scheduler, or one live session at the
  streaming router). Past the quota, :meth:`AdmissionController.charge`
  raises :class:`TenantQuotaExceeded` — a subclass of
  :class:`~.scheduler.OverloadRejected`, so every existing shed path
  (the gateway's accounting, the serve loops) handles it unchanged;
- **priority classes** ``realtime | standard | batch`` — each class
  carries a default relative deadline (realtime tightest), which is
  exactly what the scheduler's oldest-deadline flush rule consumes: a
  realtime request's rung flushes partial long before a batch
  request's would. Classes also stage the brownout shed order:
  ``batch`` sheds at level 1 (degraded), ``standard`` at level 2
  (brownout), ``realtime`` is never brownout-shed (it stays bounded by
  its quota and the global queue) — the bulk tenant is always the
  first over the side;
- **weighted-fair dequeue** — when a rung holds more eligible requests
  than one flush takes, :meth:`AdmissionController.fair_select` picks
  them by stride scheduling over per-tenant virtual time (``vt +=
  1/weight`` per dequeued request, smallest vt first, FIFO within a
  tenant, tenant name breaking exact ties deterministically). A
  saturating tenant advances its own clock fast and yields the next
  slots; an idle tenant re-enters at the current floor instead of
  monopolizing with stale credit. No tenant starves.

The controller is synchronous and injectable like its hosts (scheduler
/ router); it never touches queue internals — the scheduler hands it
the eligible slice and takes back an ordering.

``serve.py --tenant-config tenants.json`` builds one from a JSON file:
``{"tenants": [{"tenant": "acme", "quota": 8, "priority": "realtime",
"weight": 2.0}, ...]}`` (see :meth:`AdmissionController.from_file`).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

from ..resilience.brownout import LEVEL_BROWNOUT, LEVEL_DEGRADED
from .scheduler import OverloadRejected

PRIORITY_REALTIME = "realtime"
PRIORITY_STANDARD = "standard"
PRIORITY_BATCH = "batch"
PRIORITY_CLASSES = (PRIORITY_REALTIME, PRIORITY_STANDARD,
                    PRIORITY_BATCH)

# Default relative deadline (clock units) per priority class — what
# the scheduler's oldest-deadline flush consumes when a request
# arrives without an explicit deadline.
CLASS_DEADLINES: Dict[str, float] = {
    PRIORITY_REALTIME: 0.05,
    PRIORITY_STANDARD: 0.25,
    PRIORITY_BATCH: 2.0,
}

# Brownout level at which a class starts shedding (None = never shed
# by brownout; realtime stays bounded by quota + queue only).
CLASS_SHED_LEVELS: Dict[str, Optional[int]] = {
    PRIORITY_BATCH: LEVEL_DEGRADED,
    PRIORITY_STANDARD: LEVEL_BROWNOUT,
    PRIORITY_REALTIME: None,
}


class TenantQuotaExceeded(OverloadRejected):
    """Tenant is at its admission quota — shed this tenant's request
    without touching anyone else's."""


@dataclass(frozen=True)
class TenantConfig:
    """One tenant's admission contract."""

    tenant: str
    quota: int = 64
    priority: str = PRIORITY_STANDARD
    weight: float = 1.0
    # Per-request default deadline override (clock units); None =
    # the priority class default (CLASS_DEADLINES).
    deadline: Optional[float] = None
    # Default serving tier for this tenant's requests (None = the
    # request's own choice / tierless).
    tier: Optional[str] = None

    def __post_init__(self):
        if not self.tenant or not isinstance(self.tenant, str):
            raise ValueError("tenant must be a non-empty string")
        if self.quota < 1:
            raise ValueError(f"tenant {self.tenant!r}: quota >= 1")
        if self.priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"tenant {self.tenant!r}: priority must be one of "
                f"{PRIORITY_CLASSES}, got {self.priority!r}")
        if not self.weight > 0:
            raise ValueError(f"tenant {self.tenant!r}: weight > 0")


class AdmissionController:
    """See module docstring. Scheduler protocol::

        tenancy = AdmissionController([TenantConfig("acme", quota=8)])
        tenancy.charge("acme")          # admit (may raise)
        ...                             # request lives in the plane
        tenancy.release("acme")         # terminal result recorded
    """

    def __init__(self, tenants: Iterable[TenantConfig], *,
                 class_deadlines: Optional[Dict[str, float]] = None):
        self._cfg: Dict[str, TenantConfig] = {}
        for cfg in tenants:
            if cfg.tenant in self._cfg:
                raise ValueError(f"duplicate tenant {cfg.tenant!r}")
            self._cfg[cfg.tenant] = cfg
        if not self._cfg:
            raise ValueError(
                "AdmissionController needs at least one tenant")
        self.class_deadlines = dict(class_deadlines
                                    or CLASS_DEADLINES)
        self._inflight: Dict[str, int] = {t: 0 for t in self._cfg}
        self._peak: Dict[str, int] = {t: 0 for t in self._cfg}
        self._served: Dict[str, int] = {t: 0 for t in self._cfg}
        self._rejected: Dict[str, int] = {t: 0 for t in self._cfg}
        # Stride-scheduling virtual time, advanced 1/weight per
        # dequeued request (fair_select).
        self._vt: Dict[str, float] = {}

    @classmethod
    def from_file(cls, path: str) -> "AdmissionController":
        """Build from the ``serve.py --tenant-config`` JSON shape:
        ``{"tenants": [{"tenant": ..., "quota": ..., ...}, ...]}``
        (a bare list of tenant objects is accepted too)."""
        with open(path) as fh:
            doc = json.load(fh)
        rows = doc.get("tenants", doc) if isinstance(doc, dict) else doc
        if not isinstance(rows, list):
            raise ValueError(
                f"{path}: expected a list of tenant objects")
        return cls([TenantConfig(**row) for row in rows])

    # -- config lookups -------------------------------------------------
    def config(self, tenant: str) -> TenantConfig:
        """The tenant's contract; unknown tenants are an admission
        error (strict: a typo'd tenant id must not ride for free)."""
        try:
            return self._cfg[tenant]
        except KeyError:
            raise KeyError(
                f"unknown tenant {tenant!r} (configured: "
                f"{sorted(self._cfg)})") from None

    def tenants(self) -> List[str]:
        return sorted(self._cfg)

    def default_deadline(self, tenant: str) -> float:
        cfg = self.config(tenant)
        if cfg.deadline is not None:
            return cfg.deadline
        return self.class_deadlines[cfg.priority]

    def default_tier(self, tenant: str) -> Optional[str]:
        return self.config(tenant).tier

    def weight(self, tenant: Optional[str]) -> float:
        if tenant is None or tenant not in self._cfg:
            return 1.0
        return self._cfg[tenant].weight

    def sheds_at(self, tenant: str, level: int) -> bool:
        """Does this tenant's class shed at brownout ``level``? The
        staged shed order: batch first (level 1), standard at level 2,
        realtime never — quota and the bounded queue are realtime's
        only backpressure."""
        shed = CLASS_SHED_LEVELS[self.config(tenant).priority]
        return shed is not None and level >= shed

    # -- quota accounting -----------------------------------------------
    def charge(self, tenant: str) -> None:
        """Admit one unit for ``tenant`` (queued request or live
        session). Raises :class:`TenantQuotaExceeded` at the quota."""
        cfg = self.config(tenant)
        if self._inflight[tenant] >= cfg.quota:
            self._rejected[tenant] += 1
            raise TenantQuotaExceeded(
                f"tenant {tenant!r} at quota "
                f"({self._inflight[tenant]} >= {cfg.quota})")
        self._inflight[tenant] += 1
        self._peak[tenant] = max(self._peak[tenant],
                                 self._inflight[tenant])

    def release(self, tenant: str) -> None:
        """One unit retired (terminal result / session closed)."""
        if tenant in self._inflight and self._inflight[tenant] > 0:
            self._inflight[tenant] -= 1
            self._served[tenant] += 1

    def inflight(self, tenant: str) -> int:
        return self._inflight.get(tenant, 0)

    def peak(self, tenant: str) -> int:
        """High-water admitted units — the "admission never exceeded
        quota" evidence."""
        return self._peak.get(tenant, 0)

    # -- weighted-fair dequeue ------------------------------------------
    def fair_select(self, requests: Sequence, n: int) -> List:
        """Pick up to ``n`` requests in weighted-fair order (stride
        scheduling over per-tenant virtual time; FIFO within a
        tenant). ``requests`` carry a ``tenant`` attribute (None =
        unconfigured traffic at weight 1). The selection ADVANCES the
        fair clock — call it only for requests actually dequeued."""
        if n >= len(requests):
            # Everything goes; still advance the clock so later
            # contention remembers who has been served.
            for r in requests:
                self._advance(getattr(r, "tenant", None))
            return list(requests)
        by_tenant: Dict[Optional[str], List] = {}
        for r in requests:
            by_tenant.setdefault(getattr(r, "tenant", None),
                                 []).append(r)
        # An idle tenant re-enters at the current floor: stale credit
        # from sitting out must not let it monopolize the next flush.
        known = [self._vt[t] for t in by_tenant if t in self._vt]
        floor = min(known) if known else 0.0
        for t in by_tenant:
            self._vt[t] = max(self._vt.get(t, floor), floor)
        heads: Dict[Optional[str], int] = {t: 0 for t in by_tenant}
        out: List = []
        while len(out) < n:
            live = [t for t in by_tenant
                    if heads[t] < len(by_tenant[t])]
            if not live:
                break
            t = min(live, key=lambda t: (self._vt[t], t or ""))
            out.append(by_tenant[t][heads[t]])
            heads[t] += 1
            self._vt[t] += 1.0 / self.weight(t)
        return out

    def _advance(self, tenant: Optional[str]) -> None:
        self._vt[tenant] = self._vt.get(tenant, 0.0) \
            + 1.0 / self.weight(tenant)

    # -- observability ---------------------------------------------------
    def stats(self) -> dict:
        return {
            "tenants": {
                t: {
                    "quota": cfg.quota,
                    "priority": cfg.priority,
                    "weight": cfg.weight,
                    "inflight": self._inflight[t],
                    "peak": self._peak[t],
                    "served": self._served[t],
                    "rejected": self._rejected[t],
                }
                for t, cfg in sorted(self._cfg.items())
            },
        }
