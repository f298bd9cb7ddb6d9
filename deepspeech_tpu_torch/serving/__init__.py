"""The port's serving plane (slices 4a, 4b, 4c and 6b, and item 17).

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
- ``sessionstore.py`` — crash durability for those snapshots: the
  versioned, CRC-checksummed wire codec (:func:`snapshot_to_bytes`,
  :func:`snapshot_from_bytes`), the segment-rotated
  :class:`SessionJournal` the session manager checkpoints into, and the
  :class:`RecoveryController` that replays it at boot;
- ``transport.py`` — cross-process handoff over those bytes: a
  handshake-gated, two-phase idempotent transfer with
  :class:`LoopbackTransport` and :class:`SocketTransport` /
  :class:`HandoffListener` under retry and a per-peer breaker, and the
  :class:`RemoteMigrationController`, whose ladder (remote, journal
  re-pin, drain re-pin, stay) never loses a session;
- ``warmstore.py`` — :class:`WarmStore`, warm restarts: each stored
  ``(B, T)`` rung of a replica's ``Inferencer`` captured as a CUDA graph
  before the replica takes traffic (``utils/aotstore.py`` keeps the
  rungs' recipes), and the recipes of rungs first used at run time
  written back;
- ``telemetry.py`` — :class:`ServingTelemetry`, the serving layers'
  shared registry.
"""

from .autoscale import AutoscaleController
from .ladder import (max_batch_for_budget, recurrent_stream_bytes,
                     tier_max_batches)
from .migration import (MigrationController, SnapshotIncompatible,
                        StreamSnapshot)
from .pool import PooledSessionRouter, ReplicaPool
from .registry import GroupState, ModelGroup, ModelRegistry
from .replica import Replica, synthetic_replicas
from .rescoring import RescoringPool, RescoringQueue, RevisionEvent
from .rollout import RolloutController
from .scheduler import (GatewayResult, MicroBatch, MicroBatchScheduler,
                        OverloadRejected, warm_rung_chooser)
from .session import StreamingSessionManager
from .sessionstore import (CODEC_VERSION, RecoveryController,
                           SessionJournal, SnapshotDecodeError,
                           snapshot_from_bytes, snapshot_to_bytes)
from .telemetry import Histogram, ServingTelemetry
from .tenancy import (AdmissionController, TenantConfig,
                      TenantQuotaExceeded)
from .transport import (HandoffListener, HandoffReceiver,
                        HandshakeRejected, LoopbackTransport,
                        RemoteMigrationController, SocketTransport,
                        TransportError)
from .trafficmodel import Arrival, Schedule, SessionPlan, TrafficModel
from .warmstore import WarmStore

__all__ = [
    "AdmissionController", "Arrival", "AutoscaleController",
    "CODEC_VERSION", "GatewayResult", "GroupState", "HandoffListener",
    "HandoffReceiver", "HandshakeRejected", "Histogram",
    "LoopbackTransport", "MicroBatch", "MicroBatchScheduler",
    "MigrationController", "ModelGroup", "ModelRegistry",
    "OverloadRejected", "PooledSessionRouter", "RecoveryController",
    "RemoteMigrationController", "Replica", "ReplicaPool",
    "RescoringPool", "RescoringQueue", "RevisionEvent",
    "RolloutController", "Schedule", "ServingTelemetry",
    "SessionJournal", "SessionPlan", "SnapshotDecodeError",
    "SnapshotIncompatible", "SocketTransport", "StreamSnapshot",
    "StreamingSessionManager", "TenantConfig", "TenantQuotaExceeded",
    "TrafficModel", "TransportError", "WarmStore", "max_batch_for_budget",
    "recurrent_stream_bytes", "snapshot_from_bytes",
    "snapshot_to_bytes", "synthetic_replicas", "tier_max_batches",
    "warm_rung_chooser",
]
