"""Gateway observability: counters, gauges, histograms, JSONL emission.

The port's copy of the JAX package's ``serving/telemetry.py``: a thin
subclass of the shared :class:`~..obs.metrics.MetricsRegistry` whose
JSONL event keeps the ``"serving_telemetry"`` name. The session manager
(``serving/session.py``) records into one: ``count`` for events
(``sessions_joined``, ``capacity_grows``, ...), ``gauge`` for last
values (``capacity``, ``active_sessions``), ``observe`` for histograms
(``slot_occupancy``, ``session_drain_frames``).
"""

from __future__ import annotations

from typing import IO

from ..obs.metrics import Histogram, MetricsRegistry

__all__ = ["Histogram", "ServingTelemetry"]


class ServingTelemetry(MetricsRegistry):
    """One sink shared by the serving layers — a per-run
    :class:`MetricsRegistry` whose JSONL event is named
    ``"serving_telemetry"``."""

    def emit_jsonl(self, fh: IO[str], event: str = "serving_telemetry",
                   **extra) -> dict:
        """Append one JSONL record of the current snapshot; returns it."""
        return super().emit_jsonl(fh, event=event, **extra)
