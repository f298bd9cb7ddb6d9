"""Multi-model registry: one serving plane routing N model groups.

The port's own copy of the JAX package's ``serving/registry.py``
(stdlib only). A :class:`ModelGroup` is everything one model owns: its
own :class:`~.pool.ReplicaPool` (replica set + consistent-hash ring —
cross-model batch mixing is impossible by construction, the pools are
disjoint), its own rung ladder (``bucket_frames``, ``max_batch``,
``tier_max_batch``), and its own controller scope (rollout / autoscale
operate on the group's pool, never the fleet). :class:`ModelRegistry`
maps ``model_id -> ModelGroup`` and is what the
:class:`~.scheduler.MicroBatchScheduler` and
:class:`~.pool.PooledSessionRouter` route through in multi-model mode
(``serve --models`` builds one).

:class:`GroupState` is the controller bookkeeping a pool keeps apart
from its routing:

- the **breaker-opens scan**: which replicas' breakers opened since
  last look, so ``maintain`` can start their drains exactly once;
- the **breaker-cooldown scan** shared by the rollout and autoscale
  controllers: is any replica's breaker open inside its cooldown, i.e.
  is the group too unhealthy for a topology change;
- **controller hold-off flags**: a controller registers a probe
  (``attach``) and peers consult ``holdoff_reason`` — how the
  autoscaler learns a rollout is mid-swap without reaching into the
  rollout object, and how both stay scoped to their own model group.

Every replica registered into a group is tagged with the group's
``model_id`` (``Replica.model``), so its metric labels, spans, and
``pool.route(model=...)`` checks all carry the model dimension.
"""

from __future__ import annotations

from typing import (TYPE_CHECKING, Callable, Dict, Iterable, List,
                    Optional, Sequence)

if TYPE_CHECKING:  # import cycle: pool.py owns a default GroupState
    from .pool import ReplicaPool
    from .replica import Replica


class GroupState:
    """Shared controller bookkeeping for one replica group — see
    module docstring. Owned by the group's pool (``pool.group``);
    controllers talk to it instead of pool internals."""

    def __init__(self):
        self._seen_opens: Dict[str, int] = {}
        # Controller hold-off probes: name -> () -> Optional[reason].
        self._probes: Dict[str, Callable[[], Optional[str]]] = {}

    # -- breaker-opens scan (pool.maintain) ------------------------------
    def note_replica(self, rep: Replica) -> None:
        """Start tracking a replica's breaker from its CURRENT open
        count — joining mid-life must not replay old opens as new."""
        self._seen_opens[rep.rid] = (rep.breaker.opens
                                     if rep.breaker is not None else 0)

    def forget_replica(self, rid: str) -> None:
        self._seen_opens.pop(rid, None)

    def newly_opened(self, replicas: Iterable[Replica]
                     ) -> List[Replica]:
        """Replicas whose breaker opened since the last scan (each
        open reported exactly once)."""
        out: List[Replica] = []
        for rep in replicas:
            b = rep.breaker
            if b is not None and b.opens > self._seen_opens.get(
                    rep.rid, 0):
                self._seen_opens[rep.rid] = b.opens
                out.append(rep)
        return out

    # -- breaker-cooldown scan (rollout / autoscale hold-off) -----------
    @staticmethod
    def breaker_holds_out(rep: Replica, now: float) -> bool:
        """Is this replica's breaker open and still inside its
        cooldown — i.e. known-bad rather than probing?"""
        b = rep.breaker
        return (b is not None and b.state == "open"
                and now - b.opened_at < b.cooldown_s)

    def breaker_cooldown_reason(self, replicas: Iterable[Replica],
                                now: float,
                                skip: Sequence[Replica] = ()
                                ) -> Optional[str]:
        """First held-out replica as a hold-off reason string, or
        None when the group is healthy enough for a topology change.
        ``skip`` excludes replicas the caller already owns (a rollout
        victim's own breaker must not pause its own swap)."""
        for rep in replicas:
            if any(rep is s for s in skip):
                continue
            if self.breaker_holds_out(rep, now):
                return f"breaker_open_{rep.rid}"
        return None

    # -- controller hold-off flags --------------------------------------
    def attach(self, name: str,
               probe: Callable[[], Optional[str]]) -> None:
        """Register (or replace) a controller's hold-off probe. The
        probe returns a reason string while the controller wants
        peers held off, else None."""
        self._probes[name] = probe

    def detach(self, name: str) -> None:
        self._probes.pop(name, None)

    def holdoff_reason(self, exclude: Sequence[str] = ()
                       ) -> Optional[str]:
        """First peer hold-off reason (registration order), skipping
        the caller's own probe(s)."""
        for name, probe in self._probes.items():
            if name in exclude:
                continue
            reason = probe()
            if reason:
                return reason
        return None


class ModelGroup:
    """One model's slice of the serving plane — see module docstring."""

    def __init__(self, model_id: str, pool: ReplicaPool, *,
                 bucket_frames: Optional[Sequence[int]] = None,
                 max_batch: Optional[int] = None,
                 tier_max_batch: Optional[Dict[str, int]] = None):
        if not model_id or not isinstance(model_id, str):
            raise ValueError("model_id must be a non-empty string")
        self.model_id = model_id
        self.pool = pool
        # Per-model rung ladder overrides (None = the scheduler's
        # global ladder): a streaming model's T rungs and a batch
        # model's B heights need not agree.
        self.bucket_frames = (tuple(sorted(bucket_frames))
                              if bucket_frames else None)
        if max_batch is not None and max_batch < 1:
            raise ValueError(f"group {model_id!r}: max_batch >= 1")
        self.max_batch = max_batch
        if tier_max_batch:
            for t, cap in tier_max_batch.items():
                if cap < 1:
                    raise ValueError(
                        f"group {model_id!r}: tier_max_batch[{t!r}] "
                        f">= 1")
        self.tier_max_batch = dict(tier_max_batch or {})
        # Per-model controller scope, attached by the operator
        # (serve.py) — they act on this group's pool only.
        self.rollout = None
        self.autoscale = None
        for rep in pool.replicas:
            self._tag(rep)

    @property
    def state(self) -> GroupState:
        return self.pool.group

    def _tag(self, rep: Replica) -> None:
        if rep.model is not None and rep.model != self.model_id:
            raise ValueError(
                f"replica {rep.rid!r} already belongs to model "
                f"{rep.model!r}, can't join group {self.model_id!r}")
        rep.model = self.model_id

    def add_replica(self, rep: Replica) -> None:
        """Membership changes go through the group so the model tag
        is never missing from a routable replica."""
        self._tag(rep)
        self.pool.add_replica(rep)

    def stats(self) -> dict:
        return {
            "model": self.model_id,
            "pool": self.pool.stats(),
            "rollout": (self.rollout.status()
                        if self.rollout is not None else None),
            "autoscale": (self.autoscale.status()
                          if self.autoscale is not None else None),
        }


class ModelRegistry:
    """``model_id -> ModelGroup`` — the multi-model routing surface.

    Replica ids are unique across the registry (dispatch accounting
    and report tooling key on rid), and ``resolve`` fills the default
    model so single-model callers keep working unchanged."""

    def __init__(self, default_model: Optional[str] = None):
        self._groups: Dict[str, ModelGroup] = {}
        self.default_model = default_model

    def register(self, group: ModelGroup) -> ModelGroup:
        if group.model_id in self._groups:
            raise ValueError(
                f"duplicate model id {group.model_id!r}")
        for other in self._groups.values():
            clash = {r.rid for r in other.pool.replicas} \
                & {r.rid for r in group.pool.replicas}
            if clash:
                raise ValueError(
                    f"replica ids {sorted(clash)} already registered "
                    f"under model {other.model_id!r}")
        self._groups[group.model_id] = group
        if self.default_model is None:
            self.default_model = group.model_id
        return group

    def add_group(self, model_id: str, pool: ReplicaPool,
                  **cfg) -> ModelGroup:
        return self.register(ModelGroup(model_id, pool, **cfg))

    # -- lookups ---------------------------------------------------------
    def resolve(self, model: Optional[str]) -> str:
        """Fill the default model id; unknown ids are an admission
        error (a typo'd model must shed loudly, not decode on
        whatever)."""
        model = model if model is not None else self.default_model
        if model not in self._groups:
            raise KeyError(
                f"unknown model {model!r} (registered: "
                f"{sorted(self._groups)})")
        return model

    def group(self, model: Optional[str] = None) -> ModelGroup:
        return self._groups[self.resolve(model)]

    def models(self) -> List[str]:
        return sorted(self._groups)

    def pools(self) -> List[ReplicaPool]:
        return [g.pool for g in self._groups.values()]

    def __len__(self) -> int:
        return len(self._groups)

    def __iter__(self):
        return iter(self._groups.values())

    def __contains__(self, model_id: str) -> bool:
        return model_id in self._groups

    # -- fleet-wide housekeeping ----------------------------------------
    def maintain(self, now: Optional[float] = None) -> None:
        for g in self._groups.values():
            g.pool.maintain(now)

    def apply_brownout(self, level: int,
                       now: Optional[float] = None) -> None:
        for g in self._groups.values():
            g.pool.apply_brownout(level, now)

    def stats(self) -> dict:
        return {"models": {m: g.stats()
                           for m, g in sorted(self._groups.items())}}
