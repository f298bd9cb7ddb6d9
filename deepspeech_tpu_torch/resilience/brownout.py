"""Serving brownout: degrade deliberately instead of falling over.

The port's own copy of the JAX package's ``resilience/brownout.py``
(stdlib only).
Under sustained queue pressure a gateway has three honest choices —
reject (already covered by bounded admission), blow deadlines
silently (never), or *shed quality*: smaller micro-batch rungs for
lower per-flush latency, greedy decode instead of beam, and early
load-shedding at the top level. This controller decides which regime
the gateway is in.

Pressure is ``pending / max_queue`` — and, when ``device_budget_s``
is set, the *device side* too: the p95 of the ``device_hist``
histogram in the metrics registry (the scheduler feeds
``gateway.dispatch_s`` per dispatch) over the budget, capped at 1.
The effective pressure is the max of the two, so a gateway whose
queue looks shallow but whose decode calls are blowing their time
budget still degrades. The regime only moves after the pressure has
been on the other side of a threshold for ``hold_s`` (sustained, not
a one-poll blip):

- level 0 **normal** — full batches, configured decode mode. Within
  level 0 an optional *rescore rung* (``rescore_pressure``, below
  ``enter_pressure``) disables async second-pass LM rescoring
  (``should_rescore()``; slice 6 of the port) — quality-UPGRADE work
  is the first thing shed, before any first-pass degradation
- level 1 **degraded** — batch rungs capped at half (flushes leave
  sooner), ``decode_mode()`` degrades beam → greedy, and
  ``effective_tier()`` degrades the ``premium`` serving tier to
  ``bulk`` (int8 greedy replicas serve everything; the int8 tree is
  smaller resident, so bulk capacity is what pressure buys)
- level 2 **brownout** — additionally sheds new admissions
  (``should_shed()``), keeping the queue servable for what's already
  accepted
- level 3 **replica drain** — opt-in via ``park_pressure``: when even
  shedding can't hold the pressure down, ``should_park_replica()``
  tells the :class:`~..serving.pool.ReplicaPool` to drain and
  park its most-loaded replica (less parallel decode → less memory
  and device contention), re-admitting it when the level drops.
  Controllers without a pool leave ``park_pressure`` at None and the
  ladder stops at level 2, exactly as before.

Two more pressure inputs compose by max with the queue fill:

- **device pressure** (``device_budget_s``): p95 of the
  ``device_hist`` histogram family over the budget — the *family*,
  i.e. the worst of the bare series and every labeled variant, so a
  pool whose ``gateway.dispatch_s{replica="r1"}`` is blowing its
  budget degrades even when the other replicas look healthy;
- **device-memory pressure** (``hbm_budget_bytes``): the ``hbm_gauge`` gauge
  over the budget — inert until something publishes the gauge, so
  hosts without memory telemetry lose nothing;
- **SLO burn pressure** (``slo_burn_budget``): the worst
  ``slo_burn_rate`` gauge (the :class:`~..obs.slo.SloBurnEngine`
  publishes one per window/tier) over the budget — the burn rate at
  which pressure saturates at 1. A burning SLO
  degrades quality *before* the queue alone would force it; inert
  until an engine publishes the family.

The current level is surfaced as the ``degraded`` gauge in the
metrics registry (scrapeable; also in every telemetry snapshot), and
level changes are counted (``brownout_enter`` / ``brownout_exit``).
Clock is injectable; the controller is synchronous like its host.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from .. import obs
from ..obs import timeline as _timeline

LEVEL_NORMAL = 0
LEVEL_DEGRADED = 1
LEVEL_BROWNOUT = 2
LEVEL_REPLICA_DRAIN = 3


class BrownoutController:
    def __init__(self, *, enter_pressure: float = 0.75,
                 exit_pressure: float = 0.25,
                 shed_pressure: float = 0.9, hold_s: float = 0.05,
                 park_pressure: Optional[float] = None,
                 rescore_pressure: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 registry=None,
                 device_budget_s: Optional[float] = None,
                 device_hist: str = "gateway.dispatch_s",
                 hbm_budget_bytes: Optional[float] = None,
                 hbm_gauge: str = "hbm_used_bytes",
                 slo_burn_budget: Optional[float] = None,
                 slo_burn_gauge: str = "slo_burn_rate"):
        if not (0.0 <= exit_pressure < enter_pressure
                <= shed_pressure <= 1.0):
            raise ValueError(
                "need 0 <= exit_pressure < enter_pressure <= "
                "shed_pressure <= 1")
        if park_pressure is not None and not (
                shed_pressure <= park_pressure <= 1.0):
            raise ValueError(
                "need shed_pressure <= park_pressure <= 1")
        if rescore_pressure is not None and not (
                0.0 < rescore_pressure <= enter_pressure):
            raise ValueError(
                "need 0 < rescore_pressure <= enter_pressure (the "
                "rescore rung fires BEFORE any first-pass "
                "degradation)")
        self.enter_pressure = enter_pressure
        self.exit_pressure = exit_pressure
        self.shed_pressure = shed_pressure
        self.park_pressure = park_pressure
        self.rescore_pressure = rescore_pressure
        self.hold_s = hold_s
        self.clock = clock
        self._registry = registry
        if device_budget_s is not None and device_budget_s <= 0:
            raise ValueError("device_budget_s must be > 0")
        self.device_budget_s = device_budget_s
        self.device_hist = device_hist
        if hbm_budget_bytes is not None and hbm_budget_bytes <= 0:
            raise ValueError("hbm_budget_bytes must be > 0")
        self.hbm_budget_bytes = hbm_budget_bytes
        self.hbm_gauge = hbm_gauge
        if slo_burn_budget is not None and slo_burn_budget <= 0:
            raise ValueError("slo_burn_budget must be > 0")
        self.slo_burn_budget = slo_burn_budget
        self.slo_burn_gauge = slo_burn_gauge
        self.level = LEVEL_NORMAL
        self._above_since: Optional[float] = None  # >= next level's bar
        self._below_since: Optional[float] = None  # <= exit bar
        # Last effective (max-composed) pressure seen by update() —
        # the rescore rung compares against it directly.
        self._pressure = 0.0
        self._reg().gauge("degraded", 0)
        if rescore_pressure is not None:
            self._reg().gauge("rescore_enabled", 1)

    def _reg(self):
        return self._registry if self._registry is not None \
            else obs.registry()

    def _set_level(self, level: int) -> None:
        if level == self.level:
            return
        entering = level > self.level
        self._reg().count("brownout_enter" if entering
                          else "brownout_exit")
        _timeline.publish(
            "brownout_enter" if entering else "brownout_exit",
            "brownout", level=level, prev_level=self.level,
            pressure=round(self._pressure, 6))
        self.level = level
        self._reg().gauge("degraded", level)
        self._above_since = None
        self._below_since = None

    def device_pressure(self) -> float:
        """Device-side pressure in [0, 1]: worst p95 across the
        ``device_hist`` histogram *family* — the bare series plus any
        labeled variants (per-replica pools record
        ``gateway.dispatch_s{replica=...}``) — over the time budget
        (0 until a histogram exists — no dispatches yet means no
        device evidence)."""
        if self.device_budget_s is None:
            return 0.0
        reg = self._reg()
        fam = (reg.hist_family(self.device_hist)
               if hasattr(reg, "hist_family")
               else {self.device_hist:
                     reg.hists.get(self.device_hist)})
        p95s = [h.percentile(95) for h in fam.values()
                if h is not None]
        p95s = [p for p in p95s if p is not None]
        if not p95s:
            return 0.0
        return min(max(p95s) / self.device_budget_s, 1.0)

    def hbm_pressure(self) -> float:
        """Memory-side pressure in [0, 1]: the ``hbm_gauge`` gauge
        over the byte budget. Inert (0) until a budget is configured
        AND something publishes the gauge."""
        if self.hbm_budget_bytes is None:
            return 0.0
        used = self._reg().gauges.get(self.hbm_gauge)
        if used is None:
            return 0.0
        return min(max(used, 0.0) / self.hbm_budget_bytes, 1.0)

    def slo_burn_pressure(self) -> float:
        """SLO-side pressure in [0, 1]: the worst ``slo_burn_gauge``
        gauge across the family — the burn-rate engine publishes one
        series per (window, tier) — over the budget (the burn at
        which pressure saturates). Inert (0) until a budget is
        configured AND an engine publishes the family."""
        if self.slo_burn_budget is None:
            return 0.0
        gauges = self._reg().gauges
        prefix = self.slo_burn_gauge + "{"
        vals = [v for k, v in dict(gauges).items()
                if k == self.slo_burn_gauge or k.startswith(prefix)]
        if not vals:
            return 0.0
        return min(max(vals) / self.slo_burn_budget, 1.0)

    def _max_level(self) -> int:
        return (LEVEL_REPLICA_DRAIN if self.park_pressure is not None
                else LEVEL_BROWNOUT)

    def update(self, pressure: float,
               now: Optional[float] = None) -> int:
        """Feed one pressure observation (typically queue fill); the
        effective pressure is its max with :meth:`device_pressure`,
        :meth:`hbm_pressure`, and :meth:`slo_burn_pressure`. Returns
        the (new) level."""
        now = self.clock() if now is None else now
        pressure = max(pressure, self.device_pressure(),
                       self.hbm_pressure(), self.slo_burn_pressure())
        was_rescoring = self.should_rescore()
        self._pressure = pressure
        if self.level == LEVEL_NORMAL:
            bar = self.enter_pressure
        elif self.level < LEVEL_BROWNOUT or self.park_pressure is None:
            bar = self.shed_pressure
        else:
            bar = self.park_pressure
        if self.level < self._max_level() and pressure >= bar:
            self._below_since = None
            if self._above_since is None:
                self._above_since = now
            if now - self._above_since >= self.hold_s:
                self._set_level(self.level + 1)
        elif self.level > LEVEL_NORMAL and pressure <= self.exit_pressure:
            self._above_since = None
            if self._below_since is None:
                self._below_since = now
            if now - self._below_since >= self.hold_s:
                self._set_level(self.level - 1)
        else:
            self._above_since = None
            self._below_since = None
        if self.rescore_pressure is not None \
                and self.should_rescore() != was_rescoring:
            self._reg().count("rescore_disabled" if was_rescoring
                              else "rescore_reenabled")
            self._reg().gauge("rescore_enabled",
                              0 if was_rescoring else 1)
        return self.level

    # -- what the gateway asks ------------------------------------------
    def decode_mode(self, configured: str = "beam") -> str:
        """Beam degrades to greedy under pressure; greedy stays greedy."""
        return "greedy" if self.level >= LEVEL_DEGRADED else configured

    def effective_tier(self, requested: Optional[str] = None
                       ) -> Optional[str]:
        """The quality-tier twin of :meth:`decode_mode`: ``premium``
        (bf16 beam replicas) degrades to ``bulk`` (int8 greedy) under
        pressure, ``bulk`` stays ``bulk``, and tierless traffic
        (``None``) is untouched. The scheduler applies this at
        admission and counts each downgrade (``tier_degraded``); once
        the level drops back below degraded, new premium submissions
        get their requested tier again."""
        if requested == "premium" and self.level >= LEVEL_DEGRADED:
            return "bulk"
        return requested

    def effective_max_batch(self, max_batch: int) -> int:
        """Degraded regimes cap the B rung at half — smaller flushes
        leave sooner, trading occupancy for latency."""
        if self.level >= LEVEL_DEGRADED:
            return max(max_batch // 2, 1)
        return max_batch

    def should_shed(self) -> bool:
        return self.level >= LEVEL_BROWNOUT

    def should_rescore(self) -> bool:
        """Rung 0.5 — the FIRST capability shed: second-pass LM
        rescoring (slice 6 of the port) runs only while the gateway
        is fully healthy. With ``rescore_pressure`` set, rescoring
        stops as soon as the effective pressure reaches it (no
        hysteresis: dropping quality-upgrade work is free and
        instantly reversible, unlike a level change); any degraded
        level stops it regardless — first-pass quality is shed only
        AFTER the second pass is already gone."""
        if self.level >= LEVEL_DEGRADED:
            return False
        if self.rescore_pressure is not None \
                and self._pressure >= self.rescore_pressure:
            return False
        return True

    def should_park_replica(self) -> bool:
        """Rung 3: the replica pool should drain-and-park its
        most-loaded replica (and re-admit once this goes False)."""
        return self.level >= LEVEL_REPLICA_DRAIN
