"""Zero-downtime rolling model swap over a live :class:`ReplicaPool`.

The port's own copy of the JAX package's ``serving/rollout.py``: the
same transitions, events and metric families on the same script.

A serving plane for millions of users cannot go dark to pick up a new
checkpoint. :class:`RolloutController` upgrades a pool one replica at
a time, reusing the primitives the stack already trusts:

- **drain behind the existing window** — the victim stops taking new
  work (``begin_drain(park=True, reason="rollout")``); in-flight
  micro-batches finish and pinned streaming sessions re-pin behind the
  drain window exactly as they do for a breaker open, so no request or
  chunk is lost. Rollout parks are tagged ``park_reason="rollout"`` so
  ``apply_brownout`` neither skips its own rung-3 park because of them
  nor re-admits a mid-swap replica behind the controller's back.
- **swap via a caller-supplied** ``backend_factory(replica) -> dict``
  (keys ``decode_fn`` / ``session_factory`` / ``inferencer``, the
  shape :meth:`Replica.backend_snapshot` returns) — a new checkpoint,
  or a new quantization tier via ``Inferencer(quantize=...)``
  path. Runs under the ``rollout.swap`` span and fault point.
- **shadow canary** — decode a fixed slice on BOTH the old and the
  candidate backend (``rollout.canary`` span/fault point); accept only
  if the transcripts are bit-identical or the WER delta is within
  ``wer_guardrail``. The candidate never serves live traffic before it
  passes.
- **rollback** — on canary failure or any mid-swap fault, restore the
  old backend bit-exactly (the pre-swap :meth:`backend_snapshot`),
  re-admit the replica on the old version, park the rejected candidate
  in :attr:`parked_candidate`, write a ``kind="rollout"`` postmortem,
  and halt the rollout. Already-upgraded replicas keep the new version
  (each passed its own canary).
- **pause, never brown out** — the controller pauses (re-admitting a
  mid-drain victim) while ``BrownoutController`` pressure is at or
  above ``pause_level`` or any other replica's breaker holds it out of
  routing, and never starts a drain that would leave fewer than
  ``min_routable`` other routable replicas — the same
  never-the-last-routable rule as ``apply_brownout``.

Re-pin economics: while a rollout is live the pool's re-pin preference
(``ReplicaPool.prefer_rids``) is kept at the already-upgraded set, so
a session displaced by a drain lands on the new version and never has
to move again; victims are picked fewest-pinned-sessions-first so
early drains displace as few sessions as possible.

Observability: every transition lands in :attr:`events` (and the
``on_event`` callback — ``serve.py --swap-checkpoint`` prints them as
JSONL), and the controller emits ``version``-labeled metric families —
``rollout_state`` (gauge, see ``STATE_GAUGE``), ``canary_wer_delta``,
``rollout_swaps``, ``rollout_rollbacks`` — under the same
all-or-nothing family-mixing rule as ``replica``/``tier``, and
``version``-labeled spans.

A CUDA backend swaps only on a parked, drained replica:
:meth:`Replica.swap_backend` synchronizes the replica's stream before
it drops the old backend, so the caching allocator cannot hand the old
weights' blocks out while kernels queued on that stream still read
them. With a warm store (``warmstore=``) the swapped-in Inferencer's
ladder is captured between the swap and the re-admission; the graphs
belong to that Inferencer and go with it, so a rollback restores the old
Inferencer with its own graphs.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple

from .. import obs
from ..metrics import wer
from ..obs import timeline as _timeline
from ..resilience import faults, postmortem
from ..resilience.brownout import LEVEL_DEGRADED
from .pool import ReplicaPool
from .replica import Replica, STATE_PARKED

ROLLOUT_IDLE = "idle"
ROLLOUT_RUNNING = "running"
ROLLOUT_PAUSED = "paused"
ROLLOUT_DONE = "done"
ROLLOUT_ROLLED_BACK = "rolled_back"

# Numeric encoding for the rollout_state gauge.
STATE_GAUGE = {ROLLOUT_IDLE: 0, ROLLOUT_RUNNING: 1, ROLLOUT_PAUSED: 2,
               ROLLOUT_DONE: 3, ROLLOUT_ROLLED_BACK: 4}


class RolloutController:
    """See module docstring. Pump-loop protocol::

        ro = RolloutController(pool, factory, to_version="ckpt-0042",
                               canary_set=[(batch, plan), ...])
        ro.start()
        while ro.state in ("running", "paused"):
            sched.pump()        # live traffic keeps flowing
            ro.tick()
        assert ro.state == "done"
    """

    def __init__(self, pool: ReplicaPool,
                 backend_factory: Callable[[Replica], dict], *,
                 to_version: str = "v2",
                 canary_set: Optional[Sequence[Tuple[dict, object]]]
                 = None,
                 canary_fn: Optional[Callable[[dict, dict],
                                              Tuple[List[str],
                                                    List[str]]]] = None,
                 wer_guardrail: float = 0.0,
                 brownout=None,
                 pause_level: int = LEVEL_DEGRADED,
                 min_routable: int = 1,
                 drain_window_s: Optional[float] = None,
                 handoff: bool = False,
                 telemetry=None,
                 warmstore=None,
                 clock: Optional[Callable[[], float]] = None,
                 on_event: Optional[Callable[[dict], None]] = None,
                 postmortem_fn: Callable = postmortem.record):
        self.pool = pool
        self.backend_factory = backend_factory
        self.to_version = str(to_version)
        # canary_set: (batch, plan) pairs fed to each backend's
        # decode_fn. canary_fn: custom shadow decode for backends the
        # pair shape doesn't fit (e.g. streaming session factories);
        # takes (old_backend, new_backend) dicts, returns the two
        # transcript lists. Neither configured = canary skipped (the
        # caller opted out; the swap/rollback machinery still runs).
        self.canary_set = list(canary_set) if canary_set else []
        self.canary_fn = canary_fn
        self.wer_guardrail = float(wer_guardrail)
        self.brownout = brownout
        self.pause_level = int(pause_level)
        self.min_routable = max(int(min_routable), 1)
        self.drain_window_s = (pool.drain_window_s
                               if drain_window_s is None
                               else drain_window_s)
        # handoff=True: rollout victims drain with the live-migration
        # flag — their pinned sessions snapshot onto the already-
        # upgraded replicas (prefer_rids keeps the at-most-one-move
        # contract) instead of draining out as segments.
        self.handoff = bool(handoff)
        self.telemetry = telemetry if telemetry is not None \
            else pool.telemetry
        # Executable warm store (serving/warmstore.py): a swapped
        # replica re-admits with its new version's ladder preloaded
        # (trigger "rollout_readmit"). None = no preload.
        self.warmstore = warmstore
        self.clock = clock if clock is not None else pool.clock
        self.on_event = on_event
        self._postmortem = postmortem_fn

        self.state = ROLLOUT_IDLE
        self.events: List[dict] = []
        self.upgraded: List[str] = []      # rids, in swap order
        self.rollbacks = 0
        self.last_wer_delta: Optional[float] = None
        # The rejected candidate backend (canary failure / swap fault),
        # held for offline inspection — "parked", never routable.
        self.parked_candidate: Optional[dict] = None
        self._remaining: List[str] = []
        self._victim: Optional[Replica] = None
        self._pause_reason: Optional[str] = None
        # Group-scoped hold-off: an autoscaler on the same pool learns
        # a swap is mid-flight via GroupState, no direct wiring needed.
        pool.group.attach(
            "rollout",
            lambda: (f"rollout_{self.state}"
                     if self.state in (ROLLOUT_RUNNING, ROLLOUT_PAUSED)
                     else None))

    # -- bookkeeping ----------------------------------------------------
    @property
    def version_labels(self) -> dict:
        return {"version": self.to_version}

    def _gauge_state(self) -> None:
        self.telemetry.gauge("rollout_state", STATE_GAUGE[self.state],
                             labels=self.version_labels)

    def _event(self, action: str, **fields) -> dict:
        ev = {"event": "rollout", "action": action, "t": self.clock(),
              "version": self.to_version, **fields}
        self.events.append(ev)
        # Fleet timeline: swaps and rollbacks react to the newest
        # event naming their replica (the drain/fault that led here);
        # the signal-driven transitions stay ambient.
        cause = (_timeline.last_for(fields.get("replica"))
                 if action in ("swap", "rollback") else None)
        _timeline.publish(
            "rollout_" + action, "rollout",
            replica=fields.get("replica"), cause_seq=cause,
            version=self.to_version,
            **{k: v for k, v in fields.items() if k != "replica"})
        if self.on_event is not None:
            self.on_event(ev)
        return ev

    def status(self) -> dict:
        return {
            "state": self.state,
            "to_version": self.to_version,
            "upgraded": list(self.upgraded),
            "remaining": list(self._remaining),
            "rollbacks": self.rollbacks,
            "last_wer_delta": self.last_wer_delta,
            "pause_reason": self._pause_reason,
        }

    # -- lifecycle ------------------------------------------------------
    def start(self, now: Optional[float] = None) -> None:
        if self.state != ROLLOUT_IDLE:
            raise RuntimeError(f"rollout already {self.state}")
        self._remaining = [r.rid for r in self.pool.replicas
                           if r.version != self.to_version]
        self.state = ROLLOUT_RUNNING if self._remaining else ROLLOUT_DONE
        self._gauge_state()
        self._event("start", replicas=list(self._remaining))

    def tick(self, now: Optional[float] = None) -> str:
        """One controller turn: advance drains, pause/resume, pick the
        next victim, and run the swap+canary once the victim is parked
        and quiet. Safe to call every pump-loop iteration."""
        if self.state not in (ROLLOUT_RUNNING, ROLLOUT_PAUSED):
            return self.state
        now = self.clock() if now is None else now
        self.pool.maintain(now)

        reason = self._should_pause(now)
        if reason is not None:
            if self.state != ROLLOUT_PAUSED:
                self._pause(now, reason)
            return self.state
        if self.state == ROLLOUT_PAUSED:
            self.state = ROLLOUT_RUNNING
            self._pause_reason = None
            self._gauge_state()
            self._event("resume")

        if self._victim is None:
            if not self._remaining:
                self._finish()
                return self.state
            victim = self._pick_victim(now)
            if victim is None:
                return self.state      # floor would be violated: wait
            self._victim = victim
            victim.begin_drain(now, self.drain_window_s, park=True,
                               reason="rollout", handoff=self.handoff)
            self._event("drain_begin", replica=victim.rid,
                        handoff=self.handoff)
            return self.state

        rep = self._victim
        rep.tick(now)
        if rep.state != STATE_PARKED or not self._sessions_quiet(rep):
            return self.state          # still draining/flushing
        self._swap(rep, now)
        return self.state

    # -- pause / floor ---------------------------------------------------
    def _should_pause(self, now: float) -> Optional[str]:
        if self.brownout is not None \
                and self.brownout.level >= self.pause_level:
            return f"brownout_level_{self.brownout.level}"
        # GroupState's shared breaker-cooldown scan, skipping our own
        # victim: a replica we drained on purpose must not pause us.
        skip = () if self._victim is None else (self._victim,)
        return self.pool.group.breaker_cooldown_reason(
            self.pool, now, skip=skip)

    def _pause(self, now: float, reason: str) -> None:
        victim = self._victim
        if victim is not None and victim.park_reason == "rollout":
            # Give the capacity back while the pool is under pressure;
            # the replica re-enters routing on the OLD backend (nothing
            # was swapped yet) and is re-drained on resume.
            victim.unpark()
            self._victim = None
        self.state = ROLLOUT_PAUSED
        self._pause_reason = reason
        self.telemetry.count("rollout_paused",
                             labels=self.version_labels)
        self._gauge_state()
        self._event("pause", reason=reason)

    def _pick_victim(self, now: float) -> Optional[Replica]:
        """Next un-upgraded routable replica, fewest pinned sessions
        first — but never one whose drain would drop the pool below
        ``min_routable`` OTHER routable replicas (the
        never-the-last-routable rule)."""
        cands = []
        for i, rep in enumerate(self.pool.replicas):
            if rep.rid not in self._remaining or not rep.can_route(now):
                continue
            others = sum(1 for o in self.pool
                         if o is not rep and o.can_route(now))
            if others < self.min_routable:
                continue
            cands.append(((self.pool.pins_on(rep.rid), i), rep))
        if not cands:
            return None
        return min(cands, key=lambda kv: kv[0])[1]

    def _sessions_quiet(self, rep: Replica) -> bool:
        """All streaming state flushed off the parked victim? Sessions
        re-pin away while it drains, but the conv/lookahead lag keeps
        the old manager finalizing for a few extra steps — swapping
        the manager out from under a draining local would strand its
        segment."""
        mgr = rep.peek_session_manager()
        if mgr is None:
            return True
        st = mgr.stats()
        return not st.get("active") and not st.get("draining")

    # -- swap + canary ---------------------------------------------------
    def _swap(self, rep: Replica, now: float) -> None:
        old = rep.backend_snapshot()
        from_version = old.get("version")
        candidate = None
        # Episode hook for chaos plans scheduled against the swap
        # (e.g. "fault the swap target mid-burst"): arms any
        # on_event="rollout.swap_begin" spec with this replica.
        faults.notify("rollout.swap_begin", replica=rep.rid)
        try:
            with obs.span("rollout.swap", replica=rep.rid,
                          version=self.to_version):
                faults.inject("rollout.swap", replica=rep.rid)
                candidate = dict(self.backend_factory(rep))
            accept, delta = self._canary(rep, old, candidate)
        except Exception as e:
            self._rollback(rep, old, candidate, now,
                           trigger="swap_fault", error=repr(e))
            return
        if not accept:
            self._rollback(rep, old, candidate, now,
                           trigger="canary_regression",
                           wer_delta=delta)
            return
        rep.swap_backend(
            decode_fn=candidate.get("decode_fn"),
            session_factory=candidate.get("session_factory"),
            inferencer=candidate.get("inferencer"),
            version=self.to_version)
        if self.warmstore is not None:
            # Between swap and unpark: the replica carries the new
            # version, so the store keys resolve to the new ladder —
            # re-admission starts warm (counted; misses run eagerly).
            self.warmstore.preload_replica(rep,
                                           trigger="rollout_readmit")
            self.warmstore.install_export_hook(rep)
        rep.unpark()
        self.upgraded.append(rep.rid)
        self._remaining.remove(rep.rid)
        self.pool.prefer_rids = set(self.upgraded)
        self._victim = None
        self.telemetry.count("rollout_swaps", labels=self.version_labels)
        self._event("swap", replica=rep.rid,
                    from_version=from_version,
                    wer_delta=delta)
        if not self._remaining:
            self._finish()

    def _canary(self, rep: Replica, old: dict,
                new: dict) -> Tuple[bool, Optional[float]]:
        """Shadow-decode the fixed slice on both backends. Returns
        (accept, wer_delta). Bit-identical transcripts short-circuit
        to accept; otherwise the WER of the candidate against the old
        backend's output must stay within the guardrail."""
        with obs.span("rollout.canary", replica=rep.rid,
                      version=self.to_version):
            faults.inject("rollout.canary", replica=rep.rid)
            if self.canary_fn is not None:
                old_texts, new_texts = self.canary_fn(old, new)
            elif self.canary_set:
                old_fn, new_fn = old["decode_fn"], new["decode_fn"]
                old_texts = [t for batch, plan in self.canary_set
                             for t in old_fn(batch, plan)]
                new_texts = [t for batch, plan in self.canary_set
                             for t in new_fn(batch, plan)]
            else:
                return True, None   # no canary configured
        old_texts, new_texts = list(old_texts), list(new_texts)
        identical = old_texts == new_texts
        delta = 0.0 if identical else wer(old_texts, new_texts)
        self.last_wer_delta = delta
        self.telemetry.observe("canary_wer_delta", delta,
                               labels=self.version_labels)
        return identical or delta <= self.wer_guardrail, delta

    # -- rollback --------------------------------------------------------
    def _rollback(self, rep: Replica, old: dict,
                  candidate: Optional[dict], now: float, *,
                  trigger: str, **evidence) -> None:
        """Restore the old backend bit-exactly, re-admit the replica,
        park the candidate, write the postmortem, halt the rollout."""
        rep.swap_backend(decode_fn=old.get("decode_fn"),
                         session_factory=old.get("session_factory"),
                         inferencer=old.get("inferencer"),
                         version=old.get("version"))
        rep.unpark()
        self.parked_candidate = candidate
        self.rollbacks += 1
        self._victim = None
        self.pool.prefer_rids = set()
        self.state = ROLLOUT_ROLLED_BACK
        self.telemetry.count("rollout_rollbacks",
                             labels=self.version_labels)
        self._gauge_state()
        # Flight-recorder dump: the requests that flowed just before
        # the rollback are the postmortem's traffic-side evidence.
        from ..obs.slo import slim_trace
        self._postmortem(
            "rollout", trigger=trigger, replica=rep.rid,
            from_version=old.get("version"),
            to_version=self.to_version,
            upgraded=list(self.upgraded),
            recent_traces=[slim_trace(t) for t in
                           obs.flight_recorder().recent(8)],
            **evidence)
        self._event("rollback", replica=rep.rid, trigger=trigger,
                    **evidence)

    def _finish(self) -> None:
        self.state = ROLLOUT_DONE
        self.pool.prefer_rids = set()
        self._gauge_state()
        self._event("done", upgraded=list(self.upgraded))

    # -- convenience ------------------------------------------------------
    def run(self, pump: Optional[Callable[[], None]] = None,
            max_ticks: int = 100000,
            sleep_s: float = 0.0) -> str:
        """Drive :meth:`tick` to completion — for callers without their
        own pump loop (``serve.py`` runs ticks inside the chunk loop
        instead). ``pump`` is called before every tick (e.g. the
        scheduler's); raises if the rollout is still unfinished after
        ``max_ticks``."""
        if self.state == ROLLOUT_IDLE:
            self.start()
        for _ in range(max_ticks):
            if self.state in (ROLLOUT_DONE, ROLLOUT_ROLLED_BACK):
                return self.state
            if pump is not None:
                pump()
            self.tick()
            if sleep_s:
                time.sleep(sleep_s)
        raise RuntimeError(
            f"rollout did not finish in {max_ticks} ticks "
            f"(state={self.state}, pause={self._pause_reason})")
