"""Request-scoped trace context + flight recorder.

The port's own copy of the JAX package's ``obs/context.py`` (stdlib
only). Aggregate metrics (spans, ``slo_ok``/``slo_miss``) answer "how
is the fleet doing"; they cannot answer "why was THIS slow request
slow". A :class:`TraceContext` rides each gateway request from
``MicroBatchScheduler.submit`` to result finalization (the trace id IS
the scheduler ``rid``) and keeps a *phase ledger* — every moment of
the request's life is attributed to exactly one phase:

- ``queue``         — pending, waiting for a flush rule to fire
- ``breaker_defer`` — requeued because the breaker (or every replica)
  held the batch out, attempts unburned
- ``retry_backoff`` — requeued after a failed decode, waiting out the
  exponential backoff (plus the re-queue wait that follows it)
- ``decode``        — from micro-batch routing through the backend
  decode to result finalization

The accounting is transition-based: :meth:`TraceContext.to` attributes
``now - t_last`` to the *current* phase and switches; :meth:`finish`
closes the last phase with the same clock value the scheduler uses for
the result's latency. The intervals therefore telescope — the phase
parts sum to the measured latency to float rounding.

Context bookkeeping is always on (a handful of dict ops per request).
The JSONL ``{"event": "trace", ...}`` record only leaves the process
when the tracer is enabled — identical transcripts either way, since
nothing downstream reads the context.

:class:`FlightRecorder` is the bounded ring of recent trace summaries
— the "what just happened" evidence dumped into SLO burn-rate alert
postmortems (``obs/slo.py``) and breaker-open postmortems.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

PHASE_QUEUE = "queue"
PHASE_DECODE = "decode"
PHASE_BREAKER = "breaker_defer"
PHASE_BACKOFF = "retry_backoff"
# Second-pass phases (LM rescoring, slice 6b of the port): a rescore
# job carries its OWN context (same trace id as the first pass,
# ``kind: "rescore"``) so the first-pass ledger keeps telescoping to
# the first-pass latency while the slow path gets its own queue/compute
# split.
PHASE_RESCORE_QUEUE = "rescore_queue"
PHASE_RESCORE_COMPUTE = "rescore_compute"


class TraceContext:
    """Phase ledger for one request; see module docstring.

    ``now`` values come from the owner's injectable clock (the
    scheduler's ``clock``), so tests drive the ledger deterministically
    with the same fake clock that drives the flush rules.
    """

    __slots__ = ("rid", "t0", "phases", "attrs", "events", "status",
                 "total_s", "_t_last", "_phase")

    def __init__(self, rid: str, now: float, **attrs):
        self.rid = rid
        self.t0 = now
        self._t_last = now
        self._phase = PHASE_QUEUE
        self.phases: Dict[str, float] = {}
        self.attrs = {k: v for k, v in attrs.items() if v is not None}
        self.events: List[dict] = []
        self.status: Optional[str] = None
        self.total_s: Optional[float] = None

    @property
    def phase(self) -> str:
        return self._phase

    @property
    def done(self) -> bool:
        return self.status is not None

    def to(self, phase: str, now: float) -> None:
        """Attribute time since the last transition to the CURRENT
        phase, then enter ``phase``."""
        dt = now - self._t_last
        if dt:
            self.phases[self._phase] = \
                self.phases.get(self._phase, 0.0) + dt
        self._t_last = now
        self._phase = phase

    def note(self, **attrs) -> None:
        """Attach request-level annotations (rung, replica, flush
        reason, deadline-flush padding share, ...)."""
        for k, v in attrs.items():
            if v is not None:
                self.attrs[k] = v

    def event(self, name: str, now: float, **fields) -> None:
        """Record a point event on the request timeline (tier
        degrade, breaker deferral, retry, session re-pin)."""
        self.events.append({"name": name,
                            "t_ms": round((now - self.t0) * 1e3, 6),
                            **fields})

    def finish(self, now: float, status: str) -> None:
        """Close the ledger: the open phase absorbs the remaining time
        and the total is stamped from the same clock value the caller
        used for the result latency. Idempotent."""
        if self.status is not None:
            return
        self.to(self._phase, now)
        self.status = status
        self.total_s = now - self.t0

    # -- reading --------------------------------------------------------
    def cause(self) -> Optional[str]:
        """The attributed cause: the phase that ate the most time."""
        if not self.phases:
            return None
        return max(self.phases, key=lambda k: self.phases[k])

    def complete(self, eps_s: float = 1e-6) -> bool:
        """Finished, with phase parts summing to the measured total
        (the telescoping invariant; ``eps_s`` absorbs float adds)."""
        return (self.status is not None and self.total_s is not None
                and abs(sum(self.phases.values()) - self.total_s)
                <= eps_s)

    def summary(self, wall: Callable[[], float] = time.time) -> dict:
        """One JSON-ready ``{"event": "trace", ...}`` record — the
        flight-recorder entry and (tracing on) the JSONL line."""
        rec = {"event": "trace",
               "ts": round(wall(), 6),
               "rid": self.rid,
               "status": self.status if self.status is not None
               else "inflight",
               "phases": {k: round(v * 1e3, 6)
                          for k, v in self.phases.items()}}
        if self.total_s is not None:
            rec["latency_ms"] = round(self.total_s * 1e3, 6)
        cause = self.cause()
        if cause is not None:
            rec["cause"] = cause
        rec.update(self.attrs)
        if self.events:
            rec["events"] = list(self.events)
        return rec


class FlightRecorder:
    """Bounded ring of recent trace summaries (thread-safe: pooled
    dispatch finalization is serial today, but streaming session
    closes may land from serve loops)."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError("capacity >= 1")
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)

    def record(self, summary: dict) -> None:
        with self._lock:
            self._ring.append(summary)

    def recent(self, n: Optional[int] = None) -> List[dict]:
        """Newest-last tail (all of the ring when ``n`` is None)."""
        with self._lock:
            recs = list(self._ring)
        return recs if n is None else recs[-n:]

    def slowest(self, n: int = 5) -> List[dict]:
        """The ``n`` highest-latency finished requests in the ring,
        slowest first — the "name the suspects" evidence an SLO
        burn-rate alert postmortem carries."""
        with self._lock:
            recs = [r for r in self._ring
                    if isinstance(r.get("latency_ms"), (int, float))]
        recs.sort(key=lambda r: r["latency_ms"], reverse=True)
        return recs[:n]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


_DEFAULT = FlightRecorder()


def flight_recorder() -> FlightRecorder:
    """The process-wide flight recorder (scheduler/router default;
    tests construct private ones)."""
    return _DEFAULT
