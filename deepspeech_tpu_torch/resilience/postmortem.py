"""Postmortem records: durable evidence for every automatic recovery.

The port's own copy of the JAX package's ``resilience/postmortem.py``
(stdlib only). Self-healing only earns trust when each intervention
leaves a record a human can audit afterwards: which utterance was
quarantined and why, which request was isolated, which breaker
tripped. A :class:`PostmortemWriter` appends one JSONL line per
intervention and keeps a bounded in-memory tail for callers (tests)
that never configure a file.

Record schema (the JAX package's, so one reader serves both)::

    {"event": "postmortem", "ts": <wall s>, "kind": <str>,
     "trigger": <str>, ...evidence}

``kind`` names the intervention class — the port's producers:

- ``corrupt_sample``      — data/pipeline.py quarantine (utt, row,
  frames, label_len)
- ``quarantined_request`` — serving/scheduler.py poison isolation (rid,
  rung, attempts)
- ``breaker_open``        — serving/scheduler.py circuit-breaker
  rising edge (the failure that tripped it, plus recent traces)
- ``migration``           — serving/migration.py live handoff or its
  drain fallback
- ``slo_burn``            — obs/slo.py burn-rate alert (window,
  burn_rate, threshold, and the slowest recent requests)
- ``warm_start``          — serving/warmstore.py ladder preload at
  replica init / autoscale scale-up / rollout re-admission (replica,
  tier, version, rung counts; linted shape — ``check_obs_schema``
  requires numeric ``warm_pct`` + ``compiles_avoided``)
- ``incident``            — obs/timeline.py correlated incident close

``trigger`` is the specific condition inside the kind
(``nonfinite_features``, ``batch_error`` ...). Everything else is
kind-specific evidence; keep values JSON-native.

Every write is counted in the metrics registry as
``postmortems_written{kind=...}`` plus the bare total. Export
``DS2_POSTMORTEM=/path/pm.jsonl`` or call :func:`configure`; without a
path, records still count and stay readable via
:meth:`PostmortemWriter.recent`.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, IO, List, Optional

from .. import obs


class PostmortemWriter:
    """Thread-safe JSONL postmortem sink with a bounded recent tail."""

    def __init__(self, path: Optional[str] = None,
                 sink: Optional[IO[str]] = None,
                 registry=None,
                 wall: Callable[[], float] = time.time,
                 max_recent: int = 256):
        self._lock = threading.Lock()
        self._registry = registry
        self._wall = wall
        self._recent: deque = deque(maxlen=max_recent)
        self._sink = sink
        self._owns_sink = False
        if path:
            self._sink = open(path, "a")
            self._owns_sink = True

    def _reg(self):
        return self._registry if self._registry is not None \
            else obs.registry()

    def write(self, kind: str, trigger: str = "", **evidence) -> dict:
        """Record one intervention; returns the record written."""
        rec = {"event": "postmortem", "ts": round(self._wall(), 6),
               "kind": kind, "trigger": trigger, **evidence}
        line = json.dumps(rec, ensure_ascii=False, default=str)
        with self._lock:
            self._recent.append(rec)
            if self._sink is not None:
                self._sink.write(line + "\n")
                self._sink.flush()
        self._reg().count("postmortems_written")
        self._reg().count("postmortems_written", labels={"kind": kind})
        return rec

    def recent(self, kind: Optional[str] = None) -> List[dict]:
        with self._lock:
            recs = list(self._recent)
        return recs if kind is None else \
            [r for r in recs if r.get("kind") == kind]

    def written(self) -> int:
        return int(self._reg().counter("postmortems_written"))

    def close(self) -> None:
        with self._lock:
            if self._sink is not None and self._owns_sink:
                try:
                    self._sink.close()
                except Exception:
                    pass
            self._sink, self._owns_sink = None, False


# -- process-wide default ----------------------------------------------
_DEFAULT: Optional[PostmortemWriter] = None
_DEFAULT_LOCK = threading.Lock()


def writer() -> PostmortemWriter:
    """The process-wide writer (created lazily; honors
    ``DS2_POSTMORTEM`` at first use)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = PostmortemWriter(
                path=os.environ.get("DS2_POSTMORTEM") or None)
        return _DEFAULT


def configure(path: Optional[str] = None, sink: Optional[IO[str]] = None,
              registry=None) -> PostmortemWriter:
    """Replace the process-wide writer (tests)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is not None:
            _DEFAULT.close()
        _DEFAULT = PostmortemWriter(path=path, sink=sink,
                                    registry=registry)
        return _DEFAULT


def record(kind: str, trigger: str = "", **evidence) -> dict:
    """Convenience: write through the process-wide writer."""
    return writer().write(kind, trigger, **evidence)


# Register into the obs-side seam (obs/postmortem_link.py): obs
# callers (SLO alerts, the incident correlator) reach the writer
# through it without importing resilience at module load.
obs.set_postmortem_recorder(record)
