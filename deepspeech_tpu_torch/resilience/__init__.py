"""Fault tolerance: chaos injection, retry and breaker, brownout,
postmortems, the training guardian and the preemption guard.

The port's own copy of the JAX package's ``resilience/`` (stdlib only):

- :mod:`.faults` — deterministic fault *injection*: a process-wide
  :class:`FaultPlan` (env/JSON-configurable, seeded, injectable clock)
  fires scheduled faults at named points (the gateway's
  ``gateway.dispatch``). Near-zero cost when no plan is installed.
- :mod:`.retry` — :class:`Retry` (exponential backoff + jitter,
  budget-capped) and :class:`CircuitBreaker` (closed/open/half-open
  with cooldown), both metered through ``obs``.
- :mod:`.brownout` — :class:`BrownoutController`: sustained queue or
  device pressure degrades the gateway (smaller rungs, premium →
  bulk, load shedding, replica parking) and surfaces a ``degraded``
  gauge.
- :mod:`.postmortem` — :class:`PostmortemWriter`: one JSONL record per
  automatic intervention (quarantined sample or request, breaker open,
  migration), shared by the data pipeline and the serving plane.

- :mod:`.preempt` — :class:`PreemptionGuard`: SIGTERM latches a flag,
  ``Trainer.fit`` writes an emergency checkpoint and returns; the
  resumed run is bit-identical.
- :mod:`.guardian` — :class:`TrainingGuardian` and
  :class:`StallWatchdog`: per-step health classification, the
  skip / backoff / rollback ladder over the ``CheckpointManager``
  last-good ring, and a heartbeat watchdog for a wedged step.
"""

from . import faults, postmortem
from .brownout import (LEVEL_BROWNOUT, LEVEL_DEGRADED, LEVEL_NORMAL,
                       LEVEL_REPLICA_DRAIN, BrownoutController)
from .faults import (FaultPlan, FaultSpec, InjectedFault,
                     validate_plan_dict)
from .guardian import (GuardianConfig, GuardianDecision, GuardianHalt,
                       StallWatchdog, TrainingGuardian)
from .postmortem import PostmortemWriter
from .preempt import PreemptionGuard
from .retry import CircuitBreaker, CircuitOpen, Retry

__all__ = [
    "BrownoutController",
    "CircuitBreaker",
    "CircuitOpen",
    "FaultPlan",
    "FaultSpec",
    "GuardianConfig",
    "GuardianDecision",
    "GuardianHalt",
    "InjectedFault",
    "LEVEL_BROWNOUT",
    "LEVEL_DEGRADED",
    "LEVEL_NORMAL",
    "LEVEL_REPLICA_DRAIN",
    "PostmortemWriter",
    "PreemptionGuard",
    "Retry",
    "StallWatchdog",
    "TrainingGuardian",
    "faults",
    "postmortem",
    "validate_plan_dict",
]
