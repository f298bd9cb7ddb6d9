"""Closed-loop autoscaling over a live :class:`ReplicaPool`.

The port's own copy of the JAX package's ``serving/autoscale.py``: the
same episodes, events and metric families on the same script. The
observability plane is the *signal* half of the fleet-sizing loop
(per-request traces, SLO burn-rate gauges, the ``/metrics``/``/slo``
surface); this module is the *decision* half.
:class:`AutoscaleController` watches the ``obs`` signals the serving
plane already publishes and resizes the pool through the primitives the
stack already trusts:

- **signals, max-composed** (the same pattern as
  :class:`~..resilience.brownout.BrownoutController`):
  gateway queue fill (``scheduler.pending / max_queue``), per-replica
  occupancy (in-flight rows over ``rows_per_replica`` across routable
  replicas), dispatch p95 over ``dispatch_budget_s`` (worst of the
  ``gateway.dispatch_s`` histogram *family*, labeled variants
  included), the brownout level (a browning-out gateway is overloaded
  by definition), and the worst ``slo_burn_rate`` gauge over
  ``slo_burn_budget``. Each signal is inert until its budget/source is
  configured, so partial deployments lose nothing.
- **hysteresis state machine** — pressure must sit at or above
  ``up_pressure`` (below ``down_pressure``) for ``hold_s`` before an
  episode starts, a ``cooldown_s`` window follows every completed
  episode, and ``min_replicas``/``max_replicas`` bound the fleet. A
  one-poll blip never resizes the pool; a burst-trough-burst pattern
  resizes it exactly twice.
- **scale-up** — ``replica_factory(rid)`` builds the newcomer and
  ``ReplicaPool.add_replica`` splices it into the consistent-hash
  ring: only ~1/N of the keyspace (and at most one re-pin per pinned
  session) moves, which the ring already guarantees.
- **scale-down = drain-before-remove** — the victim (fewest pinned
  sessions, never the last routable) goes through the existing
  park/drain lifecycle (``begin_drain(park=True,
  reason="autoscale")``): in-flight micro-batches finish inside the
  drain window, pinned sessions re-pin behind it (their old manager
  finalizes the fed chunks as a segment — zero lost chunks), and only
  a parked, session-quiet replica is actually removed from the ring.
  ``apply_brownout`` ignores ``park_reason="autoscale"`` parks, so
  brownout recovery never re-admits a replica the controller is
  removing.
- **gateway capacity follows the fleet** — with a scheduler attached,
  admission capacity is re-targeted to ``capacity_per_replica * N``
  on every resize via :meth:`MicroBatchScheduler.set_max_queue`,
  whose shrink path is bounded (never below the currently admitted
  backlog — see the scheduler).
- **hold-off** — no new episode starts while a
  :class:`~.rollout.RolloutController` is mid-swap (state
  ``running``/``paused``: two controllers draining replicas at once
  could violate the min-routable floor between them) or while any
  replica's breaker is open inside its cooldown (the pool is already
  degraded; shrinking it would amplify the outage, growing it would
  mask the failure the breaker is isolating).
- **drain cancel** — a fault arriving *during* a scale-down drain
  flips the episode's premise: if a peer replica's breaker opens
  while the victim drains, the fleet is already degraded and removing
  the victim would amplify the outage. The controller cancels the
  episode instead — the victim un-parks and re-admits
  (``Replica.unpark``), nothing is removed, the cancel is counted
  (``autoscale_events{direction="cancel"}``), postmortemed, and
  starts the normal cooldown before any re-drain.
- **vertical actuators** — replica count is the *slow, expensive*
  axis (a scale-up pays backend build + ring re-pins and is
  cooldown-gated). Two cheaper vertical rungs act *inside* the
  horizontal cooldown window, with their own (faster) hysteresis and
  their own cooldown: a **rung-ladder-height step** (re-target
  ``scheduler.max_batch`` / per-tier caps to a taller rung the
  ``serving/ladder.py`` budget math sized — ``vertical_max_batch`` /
  ``vertical_tier_max_batch``) and a **premium→bulk tier-mix shift**
  (install ``scheduler.tier_shift`` so premium arrivals ride the
  taller bulk ladder, the same degradation the brownout ladder uses
  at level 1). Sustained up-pressure engages them in that order
  (cheapest first); sustained down-pressure disengages in reverse
  *before* any horizontal scale-down — restoring quality is cheaper
  than a drain.

Observability: ``autoscale_replicas`` / ``autoscale_pressure`` /
``autoscale_state`` / ``autoscale_vertical`` gauges, an
``autoscale_events`` counter that ALWAYS carries ``direction`` AND
``actuator`` labels (``horizontal`` | ``ladder`` | ``tier_mix``;
both always present, like the rollout families'
``version`` label), an ``autoscale.scale`` span per horizontal
episode, one ``kind="autoscale"`` postmortem per episode — horizontal
*and* vertical (direction, actuator, fleet before/after, the signal
snapshot) — and an :attr:`events` list mirrored to ``on_event``
(``serve.py --autoscale`` prints them as JSONL). Every event is also
forwarded to ``resilience.faults.notify`` as ``autoscale.<action>``, so chaos
plans can schedule episode-relative faults ("breaker-trip the
replica the autoscaler just added") against the controller's own
actions.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from .. import obs
from ..obs import timeline as _timeline
from ..resilience import faults, postmortem
from ..resilience.brownout import LEVEL_REPLICA_DRAIN
from .pool import ReplicaPool
from .replica import Replica, STATE_PARKED

AUTOSCALE_STEADY = "steady"
AUTOSCALE_DRAINING = "draining"
AUTOSCALE_HOLDOFF = "holdoff"

# Numeric encoding for the autoscale_state gauge.
STATE_GAUGE = {AUTOSCALE_STEADY: 0, AUTOSCALE_DRAINING: 1,
               AUTOSCALE_HOLDOFF: 2}


class AutoscaleController:
    """See module docstring. Pump-loop protocol::

        ctrl = AutoscaleController(pool, factory, scheduler=sched,
                                   min_replicas=1, max_replicas=4)
        while traffic:
            sched.pump()
            ctrl.tick()      # safe every iteration; hysteresis inside
    """

    def __init__(self, pool: ReplicaPool,
                 replica_factory: Callable[[str], Replica], *,
                 scheduler=None,
                 min_replicas: int = 1, max_replicas: int = 4,
                 up_pressure: float = 0.7,
                 down_pressure: float = 0.25,
                 hold_s: float = 0.05, cooldown_s: float = 1.0,
                 rows_per_replica: Optional[float] = None,
                 dispatch_budget_s: Optional[float] = None,
                 dispatch_hist: str = "gateway.dispatch_s",
                 slo_burn_budget: Optional[float] = None,
                 slo_burn_gauge: str = "slo_burn_rate",
                 brownout=None, rollout=None,
                 capacity_per_replica: Optional[int] = None,
                 drain_window_s: Optional[float] = None,
                 vertical_max_batch: Optional[int] = None,
                 vertical_tier_max_batch: Optional[Dict[str, int]]
                 = None,
                 tier_shift: Optional[Dict[str, str]] = None,
                 vertical_hold_s: Optional[float] = None,
                 vertical_cooldown_s: Optional[float] = None,
                 handoff: bool = False,
                 telemetry=None,
                 warmstore=None,
                 clock: Optional[Callable[[], float]] = None,
                 on_event: Optional[Callable[[dict], None]] = None,
                 postmortem_fn: Callable = postmortem.record):
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        if not 0.0 <= down_pressure < up_pressure <= 1.0:
            raise ValueError(
                "need 0 <= down_pressure < up_pressure <= 1")
        if rows_per_replica is not None and rows_per_replica <= 0:
            raise ValueError("rows_per_replica must be > 0")
        if dispatch_budget_s is not None and dispatch_budget_s <= 0:
            raise ValueError("dispatch_budget_s must be > 0")
        if slo_burn_budget is not None and slo_burn_budget <= 0:
            raise ValueError("slo_burn_budget must be > 0")
        if vertical_max_batch is not None:
            if scheduler is None:
                raise ValueError(
                    "vertical_max_batch needs a scheduler to act on")
            if vertical_max_batch < 1:
                raise ValueError("vertical_max_batch must be >= 1")
        if vertical_tier_max_batch and vertical_max_batch is None:
            raise ValueError("vertical_tier_max_batch is part of the "
                             "ladder rung: set vertical_max_batch too")
        if tier_shift:
            if scheduler is None:
                raise ValueError(
                    "tier_shift needs a scheduler to act on")
            for src, dst in tier_shift.items():
                if src == dst:
                    raise ValueError(
                        f"tier_shift {src!r} -> {dst!r} is a no-op")
        self.pool = pool
        self.replica_factory = replica_factory
        self.scheduler = scheduler
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.up_pressure = float(up_pressure)
        self.down_pressure = float(down_pressure)
        self.hold_s = float(hold_s)
        self.cooldown_s = float(cooldown_s)
        self.rows_per_replica = rows_per_replica
        self.dispatch_budget_s = dispatch_budget_s
        self.dispatch_hist = dispatch_hist
        self.slo_burn_budget = slo_burn_budget
        self.slo_burn_gauge = slo_burn_gauge
        self.brownout = brownout
        self.rollout = rollout
        # Gateway admission capacity per replica: every resize
        # re-targets scheduler.max_queue to this times the fleet size
        # (shrink bounded by the scheduler). Default: the starting
        # capacity split across the starting fleet.
        if capacity_per_replica is None and scheduler is not None:
            capacity_per_replica = max(
                1, scheduler.max_queue // max(len(pool), 1))
        self.capacity_per_replica = capacity_per_replica
        self.drain_window_s = (pool.drain_window_s
                               if drain_window_s is None
                               else drain_window_s)
        # handoff=True: scale-down victims start their drain with the
        # live-migration flag, so the streaming router snapshots their
        # pinned sessions to surviving replicas instead of waiting for
        # the conv/lookahead flush — _sessions_quiet passes the moment
        # the handoffs land, collapsing scale-down latency.
        self.handoff = bool(handoff)
        self.telemetry = telemetry if telemetry is not None \
            else pool.telemetry
        # Executable warm store (serving/warmstore.py): a scale-up
        # newcomer's ladder is preloaded before it becomes routable
        # (trigger "scale_up"). None = no preload.
        self.warmstore = warmstore
        self.clock = clock if clock is not None else pool.clock
        self.on_event = on_event
        self._postmortem = postmortem_fn

        # Vertical actuators: ordered cheapest-first. The ladder step
        # (taller scheduler rung) engages before the tier-mix shift
        # (quality degradation); down-pressure disengages in reverse.
        self.vertical_max_batch = vertical_max_batch
        self.vertical_tier_max_batch = dict(vertical_tier_max_batch
                                            or {})
        self.tier_shift_map = dict(tier_shift or {})
        self._vertical_rungs: List[str] = []
        if vertical_max_batch is not None:
            self._vertical_rungs.append("ladder")
        if self.tier_shift_map:
            self._vertical_rungs.append("tier_mix")
        self.vertical_hold_s = (self.hold_s / 2.0
                                if vertical_hold_s is None
                                else float(vertical_hold_s))
        self.vertical_cooldown_s = (self.cooldown_s / 2.0
                                    if vertical_cooldown_s is None
                                    else float(vertical_cooldown_s))
        # Baselines to restore on disengage. getattr: a controller
        # with no vertical rungs may ride a scheduler stub that only
        # exposes the capacity surface (pending/max_queue).
        self._base_max_batch = getattr(scheduler, "max_batch", None)
        self._base_tier_max_batch = dict(
            getattr(scheduler, "tier_max_batch", None) or {})
        if self._vertical_rungs and self._base_max_batch is None:
            raise ValueError(
                "vertical actuators need a scheduler exposing "
                "max_batch/tier_max_batch")

        self.state = AUTOSCALE_STEADY
        self.events: List[dict] = []
        self.episodes: List[dict] = []
        self.scale_ups = 0
        self.scale_downs = 0
        self.holdoffs = 0
        self.vertical_ups = 0
        self.vertical_downs = 0
        self.drain_cancels = 0
        self._vertical_engaged: List[str] = []
        self._victim: Optional[Replica] = None
        self._victim_since: Optional[float] = None
        self._victim_signals: Optional[dict] = None
        self._above_since: Optional[float] = None
        self._below_since: Optional[float] = None
        self._v_above_since: Optional[float] = None
        self._v_below_since: Optional[float] = None
        self._last_action_t: Optional[float] = None
        self._last_vertical_t: Optional[float] = None
        self._holdoff_reason: Optional[str] = None
        self._ids = 0
        # Peer controllers on the same group (e.g. a rollout) learn of
        # an in-progress scale-down drain through the group's hold-off
        # probe registry instead of holding a reference to us.
        pool.group.attach(
            "autoscale",
            lambda: (f"autoscale_drain_{self._victim.rid}"
                     if self._victim is not None else None))
        self._gauge_state()
        self.telemetry.gauge("autoscale_replicas", len(pool))
        self._event("init", replicas=len(pool),
                    min=self.min_replicas, max=self.max_replicas)

    # -- bookkeeping ------------------------------------------------------
    def _gauge_state(self) -> None:
        self.telemetry.gauge("autoscale_state", STATE_GAUGE[self.state])

    def _event(self, action: str, **fields) -> dict:
        ev = {"event": "autoscale", "action": action, "t": self.clock(),
              **fields}
        self.events.append(ev)
        seq = _timeline.publish(
            action, "autoscale", replica=fields.get("replica"),
            cause_seq=self._tl_cause(action, fields),
            **{k: v for k, v in fields.items() if k != "replica"})
        # Episode hook for chaos plans: a FaultSpec with
        # on_event="autoscale.scale_up" (etc.) arms off the
        # controller's own action, target="@event" resolves to the
        # replica this event names. No-op without an active plan.
        # cause_seq rides along so a fire armed here traces back to
        # this very event on the fleet timeline.
        faults.notify("autoscale." + action,
                      replica=fields.get("replica"), cause_seq=seq)
        if self.on_event is not None:
            self.on_event(ev)
        return ev

    def _tl_cause(self, action: str, fields: dict) -> Optional[int]:
        """The fleet-timeline seq this action reacts to. Drain-cancels
        name their trigger in the reason string (``breaker_open_<rid>``
        from the shared cooldown scan) and fall back to the drain they
        cancel; vertical steps taken while a breaker holds the group
        out of horizontal moves chain to that breaker's event; plain
        signal-driven actions (scale/drain on pressure) are roots of
        nothing — they stay ambient."""
        if _timeline.active() is None:
            return None
        if action == "drain_cancel":
            reason = str(fields.get("reason") or "")
            if reason.startswith("breaker_open_"):
                return _timeline.last_for(
                    reason[len("breaker_open_"):])
            return _timeline.last_for(fields.get("replica"))
        if action in ("vertical_up", "vertical_down"):
            reason = self.pool.group.breaker_cooldown_reason(
                self.pool, self.clock())
            if reason and reason.startswith("breaker_open_"):
                return _timeline.last_for(
                    reason[len("breaker_open_"):])
            return None
        if action in ("init", "scale_up", "drain_begin", "resume"):
            return None
        return _timeline.last_for(fields.get("replica"))

    def _next_rid(self) -> str:
        existing = {r.rid for r in self.pool}
        while True:
            rid = f"a{self._ids}"
            self._ids += 1
            if rid not in existing:
                return rid

    def status(self) -> dict:
        return {
            "state": self.state,
            "replicas": len(self.pool),
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "vertical_ups": self.vertical_ups,
            "vertical_downs": self.vertical_downs,
            "vertical_engaged": list(self._vertical_engaged),
            "drain_cancels": self.drain_cancels,
            "holdoffs": self.holdoffs,
            "holdoff_reason": self._holdoff_reason,
            "victim": self._victim.rid if self._victim is not None
            else None,
            "last_action_t": self._last_action_t,
            "signals": self.signals(),
        }

    # -- signals ----------------------------------------------------------
    def queue_pressure(self) -> float:
        """Gateway backlog over capacity (0 without a scheduler)."""
        if self.scheduler is None:
            return 0.0
        return min(self.scheduler.pending
                   / max(self.scheduler.max_queue, 1), 1.0)

    def occupancy_pressure(self, now: Optional[float] = None) -> float:
        """In-flight rows across routable replicas over the fleet's
        row budget (``rows_per_replica`` each). Inert until the budget
        is configured."""
        if self.rows_per_replica is None:
            return 0.0
        now = self.clock() if now is None else now
        routable = [r for r in self.pool if r.can_route(now)]
        if not routable:
            return 1.0   # nothing can take work: the fleet is gone
        inflight = sum(r.inflight for r in routable)
        return min(inflight / (self.rows_per_replica * len(routable)),
                   1.0)

    def dispatch_pressure(self) -> float:
        """Worst p95 across the dispatch-latency histogram family
        (bare + labeled per-replica variants) over the budget — the
        same family scan the brownout controller runs."""
        if self.dispatch_budget_s is None:
            return 0.0
        reg = self.telemetry
        fam = (reg.hist_family(self.dispatch_hist)
               if hasattr(reg, "hist_family")
               else {self.dispatch_hist:
                     reg.hists.get(self.dispatch_hist)})
        p95s = [h.percentile(95) for h in fam.values() if h is not None]
        p95s = [p for p in p95s if p is not None]
        if not p95s:
            return 0.0
        return min(max(p95s) / self.dispatch_budget_s, 1.0)

    def slo_burn_pressure(self) -> float:
        """Worst ``slo_burn_rate`` gauge across the family (the burn
        engine publishes one per window/tier) over the budget."""
        if self.slo_burn_budget is None:
            return 0.0
        gauges = self.telemetry.gauges
        prefix = self.slo_burn_gauge + "{"
        vals = [v for k, v in dict(gauges).items()
                if k == self.slo_burn_gauge or k.startswith(prefix)]
        if not vals:
            return 0.0
        return min(max(vals) / self.slo_burn_budget, 1.0)

    def brownout_pressure(self) -> float:
        """The brownout ladder as pressure: level over the top rung.
        A gateway already shedding quality is overloaded whatever the
        queue says right now."""
        if self.brownout is None:
            return 0.0
        return min(max(self.brownout.level, 0)
                   / float(LEVEL_REPLICA_DRAIN), 1.0)

    def signals(self, now: Optional[float] = None) -> Dict[str, float]:
        """Every pressure component plus their max (the decision
        input) — also the postmortem's evidence snapshot."""
        sig = {
            "queue": round(self.queue_pressure(), 6),
            "occupancy": round(self.occupancy_pressure(now), 6),
            "dispatch": round(self.dispatch_pressure(), 6),
            "slo_burn": round(self.slo_burn_pressure(), 6),
            "brownout": round(self.brownout_pressure(), 6),
        }
        sig["max"] = max(sig.values())
        return sig

    # -- hold-off ---------------------------------------------------------
    def _holdoff(self, now: float) -> Optional[str]:
        """Anything that makes a topology change unsafe right now:
        an explicitly-wired rollout mid-swap, any peer controller's
        hold-off probe on the group (``GroupState.attach``), or an
        open breaker inside its cooldown (``GroupState``'s shared
        breaker-cooldown scan)."""
        ro = self.rollout
        if ro is not None and getattr(ro, "state", None) in (
                "running", "paused"):
            return f"rollout_{ro.state}"
        group = self.pool.group
        reason = group.holdoff_reason(exclude=("autoscale",))
        if reason is not None:
            return reason
        return group.breaker_cooldown_reason(self.pool, now)

    # -- the tick ---------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> str:
        """One controller turn: advance an in-progress drain, check
        hold-off, evaluate the hysteresis thresholds, maybe start one
        episode. Safe to call every pump-loop iteration."""
        now = self.clock() if now is None else now
        self.pool.maintain(now)
        sig = self.signals(now)
        self.telemetry.gauge("autoscale_pressure", sig["max"])
        self.telemetry.gauge("autoscale_replicas", len(self.pool))

        if self._victim is not None:
            # A scale-down in progress always runs to completion — the
            # victim is already out of routing, so finishing the
            # removal only returns ring share, never capacity.
            self._advance_drain(now)
            return self.state

        in_cooldown = (self._last_action_t is not None
                       and now - self._last_action_t < self.cooldown_s)
        p = sig["max"]
        # Vertical first, and NOT gated by hold-off: a vertical step
        # touches only the scheduler (rung height / tier mix), never
        # the topology, so a rollout mid-swap or a breaker cooldown —
        # which hold off replica add/remove — don't apply. Those are
        # exactly the moments cheap absorption matters most. The
        # horizontal cooldown doesn't gate it either (that's the
        # point of having a second, cheaper axis).
        acted_vertical = self._tick_vertical(now, p, sig, in_cooldown)

        reason = self._holdoff(now)
        if reason is not None:
            if self.state != AUTOSCALE_HOLDOFF:
                self.state = AUTOSCALE_HOLDOFF
                self.holdoffs += 1
                self.telemetry.count("autoscale_holdoffs")
                self._gauge_state()
                self._event("holdoff", reason=reason)
            self._holdoff_reason = reason
            self._above_since = None
            self._below_since = None
            return self.state
        if self.state == AUTOSCALE_HOLDOFF:
            self.state = AUTOSCALE_STEADY
            self._holdoff_reason = None
            self._gauge_state()
            self._event("resume")
        if acted_vertical:
            return self.state    # one actuator step per tick

        if p >= self.up_pressure:
            self._below_since = None
            if self._above_since is None:
                self._above_since = now
            if (now - self._above_since >= self.hold_s
                    and not in_cooldown
                    and len(self.pool) < self.max_replicas):
                self._scale_up(now, sig)
        elif p <= self.down_pressure:
            self._above_since = None
            if self._below_since is None:
                self._below_since = now
            # Disengage vertical rungs (restore quality/height) before
            # any horizontal drain — the reverse of the way up.
            if (now - self._below_since >= self.hold_s
                    and not in_cooldown
                    and not self._vertical_engaged
                    and len(self.pool) > self.min_replicas):
                self._begin_scale_down(now, sig)
        else:
            # The hysteresis band: pressure must re-earn a threshold
            # from scratch after visiting the middle.
            self._above_since = None
            self._below_since = None
        return self.state

    # -- scale up ---------------------------------------------------------
    def _scale_up(self, now: float, sig: dict) -> None:
        n_from = len(self.pool)
        rid = self._next_rid()
        repins0 = self.pool.repins
        with obs.span("autoscale.scale", direction="up", replica=rid):
            rep = self.replica_factory(rid)
            if self.warmstore is not None:
                # Before add_replica makes the newcomer routable: load
                # its ladder from the store (counted per rung; misses
                # run eagerly — never blocks the scale-up).
                self.warmstore.preload_replica(rep, trigger="scale_up")
                self.warmstore.install_export_hook(rep)
            self.pool.add_replica(rep)
        self._apply_capacity()
        self.scale_ups += 1
        self._last_action_t = now
        self._above_since = None
        self.telemetry.count("autoscale_events",
                             labels={"direction": "up",
                                     "actuator": "horizontal"})
        self.telemetry.gauge("autoscale_replicas", len(self.pool))
        self._episode("up", now, now, n_from, len(self.pool), rid, sig,
                      repins=self.pool.repins - repins0)

    # -- vertical actuators ----------------------------------------------
    def _tick_vertical(self, now: float, p: float, sig: dict,
                       in_horizontal_cooldown: bool) -> bool:
        """Run the vertical actuators' own hysteresis against the
        composed pressure; returns True when a step was taken this
        tick (the horizontal branch then sits the tick out)."""
        if not self._vertical_rungs:
            return False
        if p >= self.up_pressure:
            self._v_below_since = None
            if self._v_above_since is None:
                self._v_above_since = now
            if self._vertical_ready(now, "up"):
                self._vertical_step(now, "up", sig,
                                    in_horizontal_cooldown)
                return True
        elif p <= self.down_pressure:
            self._v_above_since = None
            if self._v_below_since is None:
                self._v_below_since = now
            if self._vertical_ready(now, "down"):
                self._vertical_step(now, "down", sig,
                                    in_horizontal_cooldown)
                return True
        else:
            self._v_above_since = None
            self._v_below_since = None
        return False

    def _vertical_ready(self, now: float, direction: str) -> bool:
        """Is a vertical step eligible right now? Own hysteresis
        (``vertical_hold_s``, typically faster than the horizontal
        hold) and own cooldown; the horizontal cooldown never gates
        it."""
        if not self._vertical_rungs:
            return False
        if (self._last_vertical_t is not None
                and now - self._last_vertical_t
                < self.vertical_cooldown_s):
            return False
        if direction == "up":
            if len(self._vertical_engaged) >= len(self._vertical_rungs):
                return False
            return (self._v_above_since is not None
                    and now - self._v_above_since
                    >= self.vertical_hold_s)
        if not self._vertical_engaged:
            return False
        return (self._v_below_since is not None
                and now - self._v_below_since >= self.vertical_hold_s)

    def _engage(self, actuator: str) -> dict:
        sched = self.scheduler
        if actuator == "ladder":
            detail = {"from_max_batch": sched.max_batch,
                      "to_max_batch": self.vertical_max_batch}
            sched.max_batch = self.vertical_max_batch
            if self.vertical_tier_max_batch:
                sched.tier_max_batch.update(
                    self.vertical_tier_max_batch)
            return detail
        # tier_mix: premium arrivals ride the bulk ladder from here on.
        sched.tier_shift.update(self.tier_shift_map)
        return {"tier_shift": dict(self.tier_shift_map)}

    def _disengage(self, actuator: str) -> dict:
        sched = self.scheduler
        if actuator == "ladder":
            detail = {"from_max_batch": sched.max_batch,
                      "to_max_batch": self._base_max_batch}
            sched.max_batch = self._base_max_batch
            for t in self.vertical_tier_max_batch:
                if t in self._base_tier_max_batch:
                    sched.tier_max_batch[t] = \
                        self._base_tier_max_batch[t]
                else:
                    sched.tier_max_batch.pop(t, None)
            return detail
        for t in self.tier_shift_map:
            sched.tier_shift.pop(t, None)
        return {"tier_shift": {}}

    def _vertical_step(self, now: float, direction: str, sig: dict,
                       in_horizontal_cooldown: bool) -> None:
        if direction == "up":
            actuator = self._vertical_rungs[len(self._vertical_engaged)]
            detail = self._engage(actuator)
            self._vertical_engaged.append(actuator)
            self.vertical_ups += 1
        else:
            actuator = self._vertical_engaged.pop()
            detail = self._disengage(actuator)
            self.vertical_downs += 1
        self._last_vertical_t = now
        self._v_above_since = None
        self._v_below_since = None
        self.telemetry.count("autoscale_events",
                             labels={"direction": direction,
                                     "actuator": actuator})
        self.telemetry.gauge("autoscale_vertical",
                             len(self._vertical_engaged))
        n = len(self.pool)
        ep = {"direction": direction, "actuator": actuator,
              "t_start": now, "t_end": now, "from_replicas": n,
              "to_replicas": n, "replica": None,
              "pressure": dict(sig), "repins": 0, **detail}
        self.episodes.append(ep)
        self._postmortem(
            "autoscale",
            trigger=("pressure_above_up" if direction == "up"
                     else "pressure_below_down"),
            direction=direction, actuator=actuator,
            from_replicas=n, to_replicas=n, signals=dict(sig),
            in_horizontal_cooldown=bool(in_horizontal_cooldown),
            **detail)
        self._event("vertical_" + direction, actuator=actuator,
                    pressure=sig.get("max"),
                    in_horizontal_cooldown=bool(in_horizontal_cooldown),
                    engaged=list(self._vertical_engaged), **detail)

    # -- scale down -------------------------------------------------------
    def _pick_victim(self, now: float) -> Optional[Replica]:
        """Fewest pinned sessions first (early drains displace the
        fewest streams), never a replica whose drain would leave no
        other routable one — the never-the-last-routable rule."""
        cands = []
        for i, rep in enumerate(self.pool.replicas):
            if not rep.can_route(now):
                continue
            others = sum(1 for o in self.pool
                         if o is not rep and o.can_route(now))
            if others < 1:
                continue
            cands.append(((self.pool.pins_on(rep.rid), i), rep))
        if not cands:
            return None
        return min(cands, key=lambda kv: kv[0])[1]

    def _begin_scale_down(self, now: float, sig: dict) -> None:
        victim = self._pick_victim(now)
        if victim is None:
            return      # floor would be violated; wait for recovery
        self._victim = victim
        self._victim_since = now
        self._victim_signals = sig
        victim.begin_drain(now, self.drain_window_s, park=True,
                           reason="autoscale", handoff=self.handoff)
        self.state = AUTOSCALE_DRAINING
        self._below_since = None
        self._gauge_state()
        self._event("drain_begin", replica=victim.rid,
                    pressure=sig["max"], handoff=self.handoff)

    def _sessions_quiet(self, rep: Replica) -> bool:
        """All streaming state flushed off the parked victim? The
        conv/lookahead lag keeps the old manager finalizing for a few
        steps after its sessions re-pin away — removing it earlier
        would strand those segments."""
        mgr = rep.peek_session_manager()
        if mgr is None:
            return True
        st = mgr.stats()
        return not st.get("active") and not st.get("draining")

    def _drain_cancel_reason(self, now: float) -> Optional[str]:
        """A fault arriving mid-drain flips the episode's premise: a
        PEER replica's breaker opening means the fleet is degraded
        while we're voluntarily removing capacity. Cancel instead of
        completing — the shared breaker-cooldown scan, skipping the
        victim itself."""
        return self.pool.group.breaker_cooldown_reason(
            self.pool, now, skip=(self._victim,))

    def _cancel_drain(self, now: float, reason: str) -> None:
        rep = self._victim
        rep.unpark()       # re-admit: parked or draining-to-park
        self.drain_cancels += 1
        self._last_action_t = now    # cooldown before any re-drain
        self.telemetry.count("autoscale_events",
                             labels={"direction": "cancel",
                                     "actuator": "horizontal"})
        n = len(self.pool)
        self._postmortem(
            "autoscale", trigger=reason, direction="cancel",
            actuator="horizontal", from_replicas=n, to_replicas=n,
            replica=rep.rid, signals=dict(self._victim_signals or {}),
            repins=0)
        self._event("drain_cancel", replica=rep.rid, reason=reason)
        self._victim = None
        self._victim_since = None
        self._victim_signals = None
        self._below_since = None
        self.state = AUTOSCALE_STEADY
        self._gauge_state()

    def _advance_drain(self, now: float) -> None:
        rep = self._victim
        cancel = self._drain_cancel_reason(now)
        if cancel is not None:
            self._cancel_drain(now, cancel)
            return
        rep.tick(now)
        if rep.state != STATE_PARKED or not self._sessions_quiet(rep):
            return
        n_from = len(self.pool)
        repins0 = self.pool.repins
        with obs.span("autoscale.scale", direction="down",
                      replica=rep.rid):
            self.pool.remove_replica(rep.rid)
        self._apply_capacity()
        self.scale_downs += 1
        self._last_action_t = now
        self.telemetry.count("autoscale_events",
                             labels={"direction": "down",
                                     "actuator": "horizontal"})
        self.telemetry.gauge("autoscale_replicas", len(self.pool))
        self._episode("down", self._victim_since or now, now, n_from,
                      len(self.pool), rep.rid,
                      self._victim_signals or {},
                      repins=self.pool.repins - repins0)
        self._victim = None
        self._victim_since = None
        self._victim_signals = None
        self.state = AUTOSCALE_STEADY
        self._gauge_state()

    # -- episode accounting ----------------------------------------------
    def _episode(self, direction: str, t_start: float, t_end: float,
                 n_from: int, n_to: int, rid: str, sig: dict,
                 repins: int) -> None:
        ep = {"direction": direction, "actuator": "horizontal",
              "t_start": t_start,
              "t_end": t_end, "from_replicas": n_from,
              "to_replicas": n_to, "replica": rid,
              "pressure": dict(sig), "repins": repins}
        self.episodes.append(ep)
        self._postmortem(
            "autoscale",
            trigger=("pressure_above_up" if direction == "up"
                     else "pressure_below_down"),
            direction=direction, actuator="horizontal",
            from_replicas=n_from,
            to_replicas=n_to, replica=rid, signals=dict(sig),
            repins=repins,
            queue_depth=(self.scheduler.pending
                         if self.scheduler is not None else None))
        self._event("scale_" + direction, replica=rid,
                    from_replicas=n_from, to_replicas=n_to,
                    pressure=sig.get("max"), repins=repins)

    def _apply_capacity(self) -> None:
        """Re-target gateway admission capacity to the fleet size.
        Growth is immediate; shrink is bounded by the scheduler (never
        below the admitted backlog — ``set_max_queue``)."""
        if self.scheduler is None or self.capacity_per_replica is None:
            return
        applied = self.scheduler.set_max_queue(
            self.capacity_per_replica * len(self.pool))
        self.telemetry.gauge("autoscale_capacity", applied)

    # -- convenience ------------------------------------------------------
    def run_until_steady(self, pump: Optional[Callable[[], None]]
                         = None, max_ticks: int = 100000,
                         sleep_s: float = 0.0) -> str:
        """Drive :meth:`tick` until no drain is in progress — for
        callers that must finish a started scale-down before shutdown
        (``serve.py`` ticks inside its chunk loop instead)."""
        for _ in range(max_ticks):
            if self._victim is None:
                return self.state
            if pump is not None:
                pump()
            self.tick()
            if sleep_s:
                time.sleep(sleep_s)
        raise RuntimeError(
            f"autoscale drain did not finish in {max_ticks} ticks "
            f"(victim={self._victim.rid if self._victim else None})")
