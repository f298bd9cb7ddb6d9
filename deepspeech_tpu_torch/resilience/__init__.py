"""Fault tolerance for the serving plane: chaos injection, retry and
breaker, brownout, postmortems.

The port's own copy of the JAX package's ``resilience/`` serving half
(stdlib only):

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

The training guardian and the preemption guard of the JAX package
come with item 16 of the port.
"""

from . import faults, postmortem
from .brownout import (LEVEL_BROWNOUT, LEVEL_DEGRADED, LEVEL_NORMAL,
                       LEVEL_REPLICA_DRAIN, BrownoutController)
from .faults import (FaultPlan, FaultSpec, InjectedFault,
                     validate_plan_dict)
from .postmortem import PostmortemWriter
from .retry import CircuitBreaker, CircuitOpen, Retry

__all__ = [
    "BrownoutController",
    "CircuitBreaker",
    "CircuitOpen",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "LEVEL_BROWNOUT",
    "LEVEL_DEGRADED",
    "LEVEL_NORMAL",
    "LEVEL_REPLICA_DRAIN",
    "PostmortemWriter",
    "Retry",
    "faults",
    "postmortem",
    "validate_plan_dict",
]
