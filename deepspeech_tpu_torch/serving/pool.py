"""Replica pool: replica-aware routing for the serving plane.

The port's own copy of the JAX package's ``serving/pool.py``: the same
ring positions (``hashlib.blake2b``), spill order, drains and re-pins.
:class:`ReplicaPool` owns N :class:`~.replica.Replica` workers and
answers one question for the scheduler and the streaming router: *which
replica takes this work right now?* Three routing rules:

- **consistent-hash session pinning** — a session id hashes onto a
  ring of virtual nodes (``hashlib``-based: Python's builtin ``hash``
  is salted per process and would unpin every session on restart), so
  a streaming session lands on one replica and stays there while that
  replica is routable. Ring membership changes move only ~1/N of the
  keyspace (see ``ring_owner`` and the resize-stability test).
- **spill-to-least-loaded** — stateless (offline) micro-batches go to
  the routable replica with the fewest in-flight row slots, dispatch
  p95 breaking ties (both read from the replica's own accounting /
  labeled ``obs`` histogram), construction order breaking exact ties
  deterministically.
- **automatic re-pin behind a drain window** — when a replica's
  breaker opens, :meth:`ReplicaPool.maintain` starts draining it and
  drops its pins; pinned sessions re-pin to the next routable ring
  owner on their next route. The drained replica finishes in-flight
  work inside the window, then returns to routing (breaker state
  permitting) or parks.

The pool also carries the brownout escalation past admission shed:
:meth:`apply_brownout` at ``LEVEL_REPLICA_DRAIN`` drains-and-parks the
most-loaded replica (never the last routable one) and re-admits it
when the controller recovers.

:class:`PooledSessionRouter` is the streaming half: each replica hosts
its own :class:`~.session.StreamingSessionManager`, a live session
feeds exactly one manager, and a re-pin is ``leave()`` on the old
manager (the drain window flushes the conv/lookahead lag, finalizing
the fed chunks as a *segment*) plus ``join()`` on the new one.
``final()`` space-joins the segments — every fed chunk lands in
exactly one finalized segment, which is the pool-wide no-lost-chunks
invariant the tests pin down.

With a ``migrator=`` (:class:`~.migration.MigrationController`) the
router upgrades forced moves to live handoffs: the session's slot
state snapshots off the old manager and restores into the new one in
the SAME segment — bit-identical transcript, zero drain wait — and
drains flagged ``begin_drain(handoff=True)`` (pool ``handoff=`` for
breaker trips; autoscale/rollout pass their own) request exactly
that. Snapshot-incompatible moves fall back to the segment drain
above.
"""

from __future__ import annotations

import bisect
import hashlib
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .. import obs
from ..obs import timeline as _timeline
from ..obs.context import FlightRecorder, PHASE_DECODE, TraceContext
from ..resilience.brownout import LEVEL_REPLICA_DRAIN
from .registry import GroupState
from .replica import (Replica, STATE_ACTIVE, STATE_PARKED)
from .telemetry import ServingTelemetry


def _hash64(key: str) -> int:
    """Stable 64-bit ring position (process-salt-free, unlike
    ``hash``)."""
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(),
        "big")


class ReplicaPool:
    """See module docstring."""

    def __init__(self, replicas: Sequence[Replica], *, vnodes: int = 64,
                 drain_window_s: float = 0.25,
                 clock: Callable[[], float] = time.monotonic,
                 telemetry: Optional[ServingTelemetry] = None,
                 group: Optional[GroupState] = None,
                 handoff: bool = False):
        if not replicas:
            raise ValueError("ReplicaPool needs at least one replica")
        if vnodes < 1:
            raise ValueError("vnodes >= 1")
        self.vnodes = vnodes
        self.drain_window_s = drain_window_s
        # Live-migration policy: breaker drains started by maintain()
        # mark the replica handoff=True so the streaming router moves
        # its pinned sessions by snapshot (serving/migration.py)
        # instead of waiting out the drain window. Off by default —
        # the router must also be built with a migrator for handoffs
        # to actually happen; otherwise the flag is inert.
        self.handoff = handoff
        self.clock = clock
        self.telemetry = telemetry if telemetry is not None \
            else replicas[0].telemetry
        # Shared controller bookkeeping (serving/registry.py): the
        # breaker-opens scan maintain() consumes, the breaker-cooldown
        # scan the rollout/autoscale controllers consult, and their
        # hold-off probes — factored out of pool internals so
        # per-model controllers never reach in here.
        self.group = group if group is not None else GroupState()
        self.replicas: List[Replica] = []
        self._by_rid: Dict[str, Replica] = {}
        self._ring: List[Tuple[int, str]] = []
        self._pins: Dict[str, str] = {}      # session id -> rid
        self.repins = 0
        # Re-pin preference (rollout controller): when non-empty,
        # sessions re-pinning off an unroutable home prefer these
        # replicas (ring order within the set) before the rest of the
        # ring. The rollout keeps this at "already upgraded", so a
        # session displaced by a drain lands on the new version and
        # never has to move again — the at-most-one-re-pin contract.
        self.prefer_rids: set = set()
        # Fleet-timeline breaker scan state: transitions already
        # published per rid, and the seq of the rid's last breaker
        # event (the causal parent of its next one).
        self._tl_seen: Dict[str, int] = {}
        self._tl_breaker_last: Dict[str, int] = {}
        for r in replicas:
            self.add_replica(r)

    # -- membership -----------------------------------------------------
    def add_replica(self, rep: Replica) -> None:
        if rep.rid in self._by_rid:
            raise ValueError(f"duplicate replica id {rep.rid!r}")
        self.replicas.append(rep)
        self._by_rid[rep.rid] = rep
        self.group.note_replica(rep)
        # Joining mid-life must not replay old transitions as new.
        self._tl_seen[rep.rid] = (len(rep.breaker.transitions)
                                  if rep.breaker is not None else 0)
        self._build_ring()
        # Live resize: pins whose ring owner the resize moved onto the
        # new replica follow it (counted as re-pins) — the ~1/N
        # keyspace the consistent-hash contract says a membership
        # change may move. The streaming router notices the pin moved
        # on its next step() and migrates the session behind the usual
        # segment drain, so no chunk is lost.
        if self._pins and rep.can_route(self.clock()):
            for sid, old_rid in list(self._pins.items()):
                if old_rid != rep.rid and self.ring_owner(sid) == rep.rid:
                    self._pins[sid] = rep.rid
                    self.repins += 1
                    self.telemetry.count("session_repins")
        self.telemetry.gauge("pool_size", len(self.replicas))

    def remove_replica(self, rid: str) -> Replica:
        rep = self._by_rid.pop(rid)
        self.replicas.remove(rep)
        self.group.forget_replica(rid)
        self._tl_seen.pop(rid, None)
        self._tl_breaker_last.pop(rid, None)
        self._pins = {sid: r for sid, r in self._pins.items()
                      if r != rid}
        self._build_ring()
        self.telemetry.gauge("pool_size", len(self.replicas))
        return rep

    def replica(self, rid: str) -> Replica:
        return self._by_rid[rid]

    def pins_on(self, rid: str) -> int:
        """How many sessions are currently pinned to ``rid`` — the
        rollout controller's fewest-sessions-first victim ordering."""
        return sum(1 for r in self._pins.values() if r == rid)

    def __len__(self) -> int:
        return len(self.replicas)

    def __iter__(self):
        return iter(self.replicas)

    # -- consistent-hash ring -------------------------------------------
    def _build_ring(self) -> None:
        ring = []
        for rep in self.replicas:
            for v in range(self.vnodes):
                ring.append((_hash64(f"{rep.rid}#{v}"), rep.rid))
        ring.sort()
        self._ring = ring
        self._ring_points = [h for h, _ in ring]

    def ring_order(self, key: str) -> List[str]:
        """Replica ids in ring-walk order from ``key``'s position —
        the pin preference list (first entry = owner, rest =
        fallbacks), independent of replica health."""
        if not self._ring:
            return []
        start = bisect.bisect_right(self._ring_points, _hash64(key))
        order: List[str] = []
        seen = set()
        n = len(self._ring)
        for i in range(n):
            rid = self._ring[(start + i) % n][1]
            if rid not in seen:
                seen.add(rid)
                order.append(rid)
                if len(order) == len(self.replicas):
                    break
        return order

    def ring_owner(self, key: str) -> str:
        """Pure ring lookup (health-blind): the replica that owns
        ``key``. Membership changes move only ~1/N of the keyspace —
        the consistent-hash stability contract."""
        return self.ring_order(key)[0]

    # -- routing --------------------------------------------------------
    def pin_of(self, session_id: str) -> Optional[str]:
        return self._pins.get(session_id)

    def pin_to(self, session_id: str, rid: str) -> None:
        """Atomically set a session's pin — the migration
        controller's flip after a successful handoff. Idempotent when
        ``route`` already moved the pin (the common path: route picks
        the target, the handoff confirms it); counts a re-pin only
        when the pin actually moves here."""
        prev = self._pins.get(session_id)
        self._pins[session_id] = rid
        if prev is not None and prev != rid:
            self.repins += 1
            self.telemetry.count("session_repins")

    def route(self, session_id: Optional[str] = None,
              now: Optional[float] = None,
              planned: Optional[Dict[str, int]] = None,
              tier: Optional[str] = None,
              model: Optional[str] = None) -> Optional[Replica]:
        """The replica that takes this work, or None when nothing is
        routable. With ``session_id``: the pinned replica while it is
        routable, else re-pin to the first routable replica in ring
        order (counted as ``session_repins`` when the pin moves).
        Without: least-loaded spill — ``planned`` adds rows the caller
        has routed but not yet dispatched (one poll's worth of batches
        spreads instead of piling on the currently-idlest replica),
        and ``tier`` restricts the candidates to replicas that serve
        that quality tier (``Replica.serves``): a bulk micro-batch
        only ever lands on an int8 replica, a premium one only on a
        bf16 replica, so per-tier transcripts are independent of the
        traffic mix. ``model`` restricts the same way for model-tagged
        replicas (mixed pools; the ModelRegistry's per-model pools
        make the constraint structural instead) — a request for model
        "a" never decodes on model "b"'s weights, on any path
        including the session ring walk."""
        now = self.clock() if now is None else now
        if session_id is not None:
            pinned = self._pins.get(session_id)
            if pinned is not None:
                rep = self._by_rid.get(pinned)
                if rep is not None and rep.can_route(now) \
                        and rep.serves(tier, model):
                    return rep
            order = self.ring_order(session_id)
            if self.prefer_rids:
                order = ([r for r in order if r in self.prefer_rids]
                         + [r for r in order
                            if r not in self.prefer_rids])
            for rid in order:
                rep = self._by_rid[rid]
                if rep.can_route(now) and rep.serves(tier, model):
                    if pinned is not None and pinned != rid:
                        self.repins += 1
                        self.telemetry.count("session_repins")
                    self._pins[session_id] = rid
                    return rep
            return None
        planned = planned or {}
        cands = []
        for i, rep in enumerate(self.replicas):
            if not rep.can_route(now) or not rep.serves(tier, model):
                continue
            inflight, p95, idx = rep.load_key(i)
            cands.append(((inflight + planned.get(rep.rid, 0), p95,
                           idx), rep))
        if not cands:
            return None
        return min(cands, key=lambda kv: kv[0])[1]

    # -- health / lifecycle ---------------------------------------------
    def maintain(self, now: Optional[float] = None) -> None:
        """One housekeeping turn (the scheduler calls this from
        ``poll``): newly-opened breakers start their replica draining;
        draining replicas advance their lifecycle. Pins to a drained
        replica stay in place — ``route`` re-pins (and counts the
        re-pin) lazily when the session next asks, so a session that
        sits out the outage keeps its warm home."""
        now = self.clock() if now is None else now
        self._publish_breaker_events()
        for rep in self.group.newly_opened(self.replicas):
            if rep.state == STATE_ACTIVE:
                rep.begin_drain(now, self.drain_window_s,
                                handoff=self.handoff)
        for rep in self.replicas:
            rep.tick(now)

    _TL_BREAKER_KINDS = {"open": "breaker_open",
                         "half_open": "breaker_half_open",
                         "closed": "breaker_close"}

    def _publish_breaker_events(self) -> None:
        """Publish breaker state transitions to the fleet timeline,
        each exactly once. An open's causal parent is the newest
        timeline event naming the replica (typically the fault fire
        that broke it); half-open/close chain to the replica's
        previous breaker event, so open → half-open → close reads as
        one causal thread."""
        if _timeline.active() is None:
            return
        for rep in self.replicas:
            b = rep.breaker
            if b is None:
                continue
            trans = b.transitions
            seen = self._tl_seen.get(rep.rid, 0)
            for t, state in trans[seen:]:
                kind = self._TL_BREAKER_KINDS.get(state)
                if kind is None:
                    continue
                cause = (_timeline.last_for(rep.rid)
                         if kind == "breaker_open"
                         else self._tl_breaker_last.get(rep.rid))
                seq = _timeline.publish(
                    kind, "pool", replica=rep.rid, model=rep.model,
                    cause_seq=cause, breaker=b.name, t_breaker=t)
                if seq is not None:
                    self._tl_breaker_last[rep.rid] = seq
            self._tl_seen[rep.rid] = len(trans)

    def apply_brownout(self, level: int,
                       now: Optional[float] = None) -> None:
        """Escalation rung 3: at ``LEVEL_REPLICA_DRAIN`` drain-and-park
        the most-loaded replica (at most one at a time, never the last
        routable one); below it, re-admit parked replicas. Only
        brownout-originated parks count either way: a rollout-parked
        candidate (``park_reason == "rollout"``) neither suppresses
        the rung-3 park nor gets re-admitted behind the rollout's back
        on recovery."""
        now = self.clock() if now is None else now
        if level >= LEVEL_REPLICA_DRAIN:
            if any((r.state == STATE_PARKED or r.parking)
                   and r.park_reason == "brownout"
                   for r in self.replicas):
                return
            active = [(rep.load_key(i), rep)
                      for i, rep in enumerate(self.replicas)
                      if rep.state == STATE_ACTIVE and rep.can_route(now)]
            if len(active) < 2:
                return
            victim = max(active, key=lambda kv: kv[0])[1]
            victim.begin_drain(now, self.drain_window_s, park=True,
                               reason="brownout")
            self.telemetry.count("brownout_replica_parks")
        else:
            for rep in self.replicas:
                if (rep.state == STATE_PARKED or rep.parking) \
                        and rep.park_reason == "brownout":
                    rep.unpark()

    # -- observability ---------------------------------------------------
    def stats(self) -> dict:
        return {
            "size": len(self.replicas),
            "routable": sum(r.can_route(self.clock())
                            for r in self.replicas),
            "pins": len(self._pins),
            "repins": self.repins,
            "replicas": [r.stats() for r in self.replicas],
        }


class PooledSessionRouter:
    """Streaming sessions over a :class:`ReplicaPool` — see module
    docstring. Pump loop (mirrors the single-manager contract)::

        router = PooledSessionRouter(pool)
        router.join("a")
        partials = router.step({"a": chunk})    # re-pins as needed
        router.leave("a")
        router.flush()
        text = router.final("a")                # segments space-joined
    """

    def __init__(self, pool: Optional[ReplicaPool] = None, *,
                 registry=None, tenancy=None,
                 flight_recorder: Optional[FlightRecorder] = None,
                 migrator=None):
        if (pool is None) == (registry is None):
            raise ValueError(
                "PooledSessionRouter takes exactly one of pool= "
                "(single-model) or registry= (multi-model)")
        self.pool = pool
        # Optional AdmissionController (serving/tenancy.py): a live
        # session is one admitted unit against its tenant's quota,
        # charged at join and released at leave.
        self.tenancy = tenancy
        # Optional MigrationController (serving/migration.py): when
        # set, a session forced off its home replica is moved by
        # snapshot handoff — same segment, bit-identical transcript,
        # zero drain wait — with the legacy detach/attach drain as
        # the fallback for anything the snapshot cannot cover.
        self.migrator = migrator
        # Multi-model mode: a ModelRegistry (serving/registry.py) —
        # sessions join with a model id and live on that group's pool.
        self.registry = registry
        self._home: Dict[str, str] = {}      # sid -> hosting rid
        self._local: Dict[str, str] = {}     # sid -> sid at that manager
        self._sid_pool: Dict[str, ReplicaPool] = {}
        self._model_of: Dict[str, Optional[str]] = {}
        self._tenant_of: Dict[str, str] = {}
        self._seg_count: Dict[str, int] = {}
        self._segments: Dict[str, List[str]] = {}
        self._seg_nbest: Dict[str, List[tuple]] = {}
        # Drained-but-not-yet-finalized locals:
        # (pool, rid, local sid, sid).
        self._draining: List[Tuple[ReplicaPool, str, str, str]] = []
        # Session-scoped trace contexts (trace id "sess:<sid>"): the
        # ledger spans join -> final, with every chunk fed, re-pin,
        # and segment on the timeline — so "why did this stream's
        # transcript arrive late" is answerable per session.
        self.flight_recorder = flight_recorder \
            if flight_recorder is not None else obs.flight_recorder()
        self._ctx: Dict[str, TraceContext] = {}

    # -- helpers --------------------------------------------------------
    def _pools(self) -> List[ReplicaPool]:
        if self.registry is not None:
            return self.registry.pools()
        return [self.pool]

    def _clock(self) -> float:
        return self._pools()[0].clock()

    def _pool_for(self, model: Optional[str]) -> ReplicaPool:
        if self.registry is not None:
            return self.registry.group(model).pool
        return self.pool

    def _manager(self, rep: Replica):
        mgr = rep.session_manager
        if mgr is None:
            raise RuntimeError(
                f"replica {rep.rid!r} has no session_factory")
        return mgr

    def _attach(self, sid: str, pool: ReplicaPool,
                rep: Replica) -> None:
        seg = self._seg_count.get(sid, 0)
        self._seg_count[sid] = seg + 1
        local = f"{sid}@{seg}"
        self._manager(rep).join(local)
        self._home[sid] = rep.rid
        self._local[sid] = local
        self._sid_pool[sid] = pool

    def _detach(self, sid: str, tail=None) -> None:
        rid = self._home.pop(sid)
        local = self._local.pop(sid)
        pool = self._sid_pool.pop(sid)
        self._manager(pool.replica(rid)).leave(local, tail=tail)
        self._draining.append((pool, rid, local, sid))

    def _collect(self) -> None:
        """Sweep drained locals whose manager has finalized them into
        the per-session segment list."""
        still: List[Tuple[ReplicaPool, str, str, str]] = []
        for pool, rid, local, sid in self._draining:
            mgr = self._manager(pool.replica(rid))
            try:
                text = mgr.final(local)
            except KeyError:
                still.append((pool, rid, local, sid))
                continue
            self._segments.setdefault(sid, []).append(text)
            # Latest segment's hypothesis list: the rescoring feed for
            # single-segment sessions (the common case); multi-segment
            # sessions fall back to 1-best in final_nbest(). Managers
            # without the n-best API (minimal doubles) feed 1-best too.
            nbest_fn = getattr(mgr, "final_nbest", None)
            self._seg_nbest[sid] = (nbest_fn(local) if nbest_fn
                                    else [(text, 0.0)])
        self._draining = still

    # -- session lifecycle ----------------------------------------------
    def join(self, sid: str, model: Optional[str] = None,
             tenant: Optional[str] = None) -> str:
        """Attach a session; returns the hosting replica id. ``model``
        picks the model group (registry mode; the default group when
        None) — the session is served by that model's pool for its
        whole life, re-pins included. ``tenant`` charges one unit
        against the tenant's quota (released at :meth:`leave`); at the
        quota the join sheds with
        :class:`~.tenancy.TenantQuotaExceeded`."""
        if sid in self._home:
            raise ValueError(f"session {sid!r} already attached")
        pool = self._pool_for(model)
        if self.registry is not None:
            model = self.registry.resolve(model)
        now = pool.clock()
        if tenant is not None and self.tenancy is not None:
            self.tenancy.charge(tenant)    # may raise: shed the join
        rep = pool.route(session_id=sid, now=now, model=model)
        if rep is None:
            if tenant is not None and self.tenancy is not None:
                self.tenancy.release(tenant)
            raise RuntimeError("no routable replica for session join")
        self._attach(sid, pool, rep)
        self._model_of[sid] = model
        if tenant is not None:
            self._tenant_of[sid] = tenant
        ctx = TraceContext(f"sess:{sid}", now, kind="session",
                           replica=rep.rid, model=model, tenant=tenant)
        ctx.to(PHASE_DECODE, now)  # streaming: live from the first chunk
        self._ctx[sid] = ctx
        return rep.rid

    def home_of(self, sid: str) -> str:
        return self._home[sid]

    def leave(self, sid: str, tail=None) -> None:
        self._detach(sid, tail=tail)
        tenant = self._tenant_of.pop(sid, None)
        if tenant is not None and self.tenancy is not None:
            self.tenancy.release(tenant)

    # -- lockstep advance ------------------------------------------------
    def step(self, chunks: Dict[str, "object"]) -> Dict[str, str]:
        """Advance every live session by one chunk. Re-pins any session
        whose home replica stopped being routable (breaker drain,
        park): the old manager drains its fed chunks into a segment
        while new chunks flow to the new home — the drain window in
        action. Returns partials with earlier segments prefixed."""
        now = self._clock()
        for pool in self._pools():
            pool.maintain(now)
        for sid in chunks:
            if sid not in self._home:
                raise KeyError(f"session {sid!r} not attached")
            pool = self._sid_pool[sid]
            rep = pool.replica(self._home[sid])
            pinned = pool.pin_of(sid)
            moved = pinned is not None and pinned != rep.rid
            if not rep.can_route(now) or moved:
                # Home stopped being routable (breaker drain, park) —
                # or the pool moved the pin out from under us (live
                # ring resize: add_replica). Either way the old
                # manager drains its fed chunks into a segment. The
                # session stays inside its model group's pool, so a
                # re-pin can never cross models.
                new = pool.route(session_id=sid, now=now,
                                 model=self._model_of.get(sid))
                if new is not None and new.rid != rep.rid:
                    migrated = False
                    if self.migrator is not None and (
                            getattr(rep, "handoff", False)
                            or rep.can_route(now)):
                        # Snapshot handoff: drains flagged handoff=
                        # (breaker/autoscale/rollout/brownout with the
                        # policy on) and healthy live-resize moves —
                        # where handing off is pure win. Falls back to
                        # the drain re-pin below when the snapshot
                        # cannot transfer (version/config skew,
                        # managers without the export surface).
                        if rep.can_route(now):
                            reason = "resize"
                        else:
                            reason = rep.park_reason or "breaker"
                        migrated = self.migrator.migrate(
                            pool, sid, rep, new,
                            local=self._local[sid],
                            reason=reason, now=now)
                    if migrated:
                        self._home[sid] = new.rid
                        ctx = self._ctx.get(sid)
                        if ctx is not None:
                            ctx.event("handoff", now, src=rep.rid,
                                      dst=new.rid)
                            ctx.note(replica=new.rid)
                        continue
                    self._detach(sid)
                    self._attach(sid, pool, new)
                    ctx = self._ctx.get(sid)
                    if ctx is not None:
                        ctx.event("repin", now, src=rep.rid,
                                  dst=new.rid)
                        ctx.note(replica=new.rid,
                                 repins=len([e for e in ctx.events
                                             if e["name"] == "repin"]))
        by_rid: Dict[str, Dict[str, "object"]] = {}
        for sid, chunk in chunks.items():
            by_rid.setdefault(self._home[sid],
                              {})[self._local[sid]] = chunk
            ctx = self._ctx.get(sid)
            if ctx is not None:
                ctx.note(chunks=ctx.attrs.get("chunks", 0) + 1)
        current: Dict[str, str] = {}
        for pool in self._pools():
            for rep in pool:
                mgr = rep.peek_session_manager()
                if mgr is None:
                    continue
                sub = by_rid.get(rep.rid, {})
                if not sub and not mgr.stats()["active"]:
                    continue
                out = mgr.step(sub)
                for sid in chunks:
                    if self._home[sid] == rep.rid:
                        current[sid] = out.get(self._local[sid], "")
        # Collect BEFORE building partials: a segment finalized by this
        # very step (the old home draining out) must already prefix the
        # session's partial.
        self._collect()
        partials: Dict[str, str] = {}
        for sid in chunks:
            prev = [t for t in self._segments.get(sid, ()) if t]
            partials[sid] = " ".join(
                [*prev, current.get(sid, "")]).strip()
        return partials

    def flush(self) -> None:
        """Finalize every drained session on every manager (only legal
        once their managers hold no live sessions — same contract as
        ``StreamingSessionManager.flush``)."""
        for pool in self._pools():
            for rep in pool:
                mgr = rep.peek_session_manager()
                if mgr is None:
                    continue
                st = mgr.stats()
                if st["draining"]:
                    mgr.flush()
        self._collect()

    def final(self, sid: str) -> str:
        """Finalized transcript: the session's segments (one per home
        replica it lived on) space-joined in feed order."""
        if sid in self._home:
            raise KeyError(f"session {sid!r} still attached")
        if any(s == sid for _, _, _, s in self._draining):
            raise KeyError(f"session {sid!r} not finalized "
                           "(still draining? call step()/flush())")
        text = " ".join(t for t in self._segments.get(sid, ()) if t)
        ctx = self._ctx.pop(sid, None)
        if ctx is not None:
            ctx.note(segments=len(self._segments.get(sid, ())))
            ctx.finish(self._clock(), "ok")
            rec = ctx.summary()
            self.flight_recorder.record(rec)
            obs.tracer.emit(rec)
        return text

    def final_nbest(self, sid: str) -> List[tuple]:
        """Hypothesis list of a finalized session, best-first — the
        rescoring feed. Exact (the manager's beam n-best) when the
        session lived on one replica as one segment; a re-pinned /
        multi-segment session degrades to 1-best of the joined text
        (its segments' beams were finalized independently, so no
        whole-utterance n-best exists)."""
        text = self.final(sid)
        segs = [t for t in self._segments.get(sid, ()) if t]
        nb = self._seg_nbest.get(sid)
        if len(segs) <= 1 and nb:
            return nb
        return [(text, 0.0)]

    def stats(self) -> dict:
        out = {
            "attached": len(self._home),
            "draining": len(self._draining),
            "finalized": len(self._segments),
            "repins": sum(p.repins for p in self._pools()),
        }
        if self.migrator is not None:
            out["migrations"] = self.migrator.migrations
            out["migration_fallbacks"] = self.migrator.fallbacks
        return out
