"""The port's serving plane (slices 4a, 4b and 6b).

- ``ladder.py`` — the tier-aware rung ladder;
- ``session.py`` — :class:`StreamingSessionManager`, live streams that
  join and leave one running batch;
- ``migration.py`` — :class:`StreamSnapshot` and the
  :class:`MigrationController` that moves live sessions between
  replicas;
- ``replica.py`` — :class:`Replica`, one executor (an ``Inferencer``
  bound by :meth:`Replica.from_inferencer`, or a session factory) with
  its own breaker, load accounting and CUDA stream;
- ``pool.py`` — :class:`ReplicaPool` (consistent-hash pins,
  least-loaded spill, drains and re-pins, brownout parking) and
  :class:`PooledSessionRouter`, live streams over the pool;
- ``scheduler.py`` — :class:`MicroBatchScheduler`, the deadline-aware
  micro-batch gateway for offline requests;
- ``registry.py`` — :class:`ModelRegistry`, N model groups, each with
  its own pool and controller scope (:class:`GroupState` holds the
  breaker scans and the controllers' hold-off probes);
- ``tenancy.py`` — :class:`AdmissionController`: per-tenant quotas,
  priority-class deadlines and shed order, weighted-fair dequeue;
- ``rollout.py`` — :class:`RolloutController`, the zero-downtime
  rolling swap (drain, shadow canary under a WER guardrail, swap,
  re-admit, rollback);
- ``autoscale.py`` — :class:`AutoscaleController`, closed-loop fleet
  sizing (horizontal episodes with drain-before-remove, the vertical
  ladder and tier-mix rungs); ``trafficmodel.py`` —
  :class:`TrafficModel`, seeded diurnal/bursty arrival schedules;
- ``rescoring.py`` — the async LM second pass: :class:`RescoringPool`
  over a bounded :class:`RescoringQueue`, emitting
  :class:`RevisionEvent` s;
- ``telemetry.py`` — :class:`ServingTelemetry`, the serving layers'
  shared registry.

The session store, the journal and cross-process handoff come with
slice 4c of the port, the executable warm store with item 17.
"""

from .autoscale import AutoscaleController
from .ladder import (max_batch_for_budget, recurrent_stream_bytes,
                     tier_max_batches)
from .migration import (CODEC_VERSION, MigrationController,
                        SnapshotIncompatible, StreamSnapshot)
from .pool import PooledSessionRouter, ReplicaPool
from .registry import GroupState, ModelGroup, ModelRegistry
from .replica import Replica, synthetic_replicas
from .rescoring import RescoringPool, RescoringQueue, RevisionEvent
from .rollout import RolloutController
from .scheduler import (GatewayResult, MicroBatch, MicroBatchScheduler,
                        OverloadRejected, warm_rung_chooser)
from .session import StreamingSessionManager
from .telemetry import Histogram, ServingTelemetry
from .tenancy import (AdmissionController, TenantConfig,
                      TenantQuotaExceeded)
from .trafficmodel import Arrival, Schedule, SessionPlan, TrafficModel

__all__ = [
    "AdmissionController", "Arrival", "AutoscaleController",
    "CODEC_VERSION", "GatewayResult", "GroupState", "Histogram",
    "MicroBatch", "MicroBatchScheduler", "MigrationController",
    "ModelGroup", "ModelRegistry", "OverloadRejected",
    "PooledSessionRouter", "Replica", "ReplicaPool", "RescoringPool",
    "RescoringQueue", "RevisionEvent", "RolloutController", "Schedule",
    "ServingTelemetry", "SessionPlan", "SnapshotIncompatible",
    "StreamSnapshot", "StreamingSessionManager", "TenantConfig",
    "TenantQuotaExceeded", "TrafficModel", "max_batch_for_budget",
    "recurrent_stream_bytes", "synthetic_replicas", "tier_max_batches",
    "warm_rung_chooser",
]
