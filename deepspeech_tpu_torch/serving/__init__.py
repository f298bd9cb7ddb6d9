"""The port's serving plane (slice 4a).

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
  its own pool;
- ``telemetry.py`` — :class:`ServingTelemetry`, the serving layers'
  shared registry.

Rollouts, autoscaling, tenancy and the traffic model come with slice
4b of the port; the session store, the journal and cross-process
handoff with slice 4c; LM rescoring with slice 6b.
"""

from .ladder import (max_batch_for_budget, recurrent_stream_bytes,
                     tier_max_batches)
from .migration import (CODEC_VERSION, MigrationController,
                        SnapshotIncompatible, StreamSnapshot)
from .pool import PooledSessionRouter, ReplicaPool
from .registry import GroupState, ModelGroup, ModelRegistry
from .replica import Replica, synthetic_replicas
from .scheduler import (GatewayResult, MicroBatch, MicroBatchScheduler,
                        OverloadRejected, warm_rung_chooser)
from .session import StreamingSessionManager
from .telemetry import Histogram, ServingTelemetry

__all__ = [
    "CODEC_VERSION", "GatewayResult", "GroupState", "Histogram",
    "MicroBatch", "MicroBatchScheduler", "MigrationController",
    "ModelGroup", "ModelRegistry", "OverloadRejected",
    "PooledSessionRouter", "Replica", "ReplicaPool", "ServingTelemetry",
    "SnapshotIncompatible", "StreamSnapshot", "StreamingSessionManager",
    "max_batch_for_budget", "recurrent_stream_bytes", "synthetic_replicas",
    "tier_max_batches", "warm_rung_chooser",
]
