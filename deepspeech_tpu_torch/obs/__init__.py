"""Observability: metrics, span tracing, request traces, SLOs, timeline.

The port's own copy of the JAX package's ``obs/`` (stdlib only):

- :class:`MetricsRegistry` (``registry()`` is the process-wide
  default): thread-safe counters, gauges, bounded histograms and
  per-rung usage, with optional Prometheus-style labels;
- :func:`span` times one named phase on the span :class:`Tracer`
  (``tracer``); :func:`compile_event` counts a rung's first use;
- :class:`TraceContext` phase ledgers and the :class:`FlightRecorder`
  ring of recent request summaries (``obs/context.py``);
- :class:`SloBurnEngine`, multi-window burn-rate alerting over
  ``slo_ok``/``slo_miss`` (``obs/slo.py``);
- the :class:`EventLog` causal event ledger, the
  :class:`IncidentCorrelator` and :class:`MetricSeries`
  (``obs/timeline.py``), and the ``postmortem_link`` seam through
  which ``resilience`` registers its recorder, so obs never imports
  resilience at module load;
- :class:`StatusServer`, the live ops surface (``obs/status.py``:
  ``/metrics`` ``/healthz`` ``/slo`` ``/traces`` ``/timeline``
  ``/incidents``), a stdlib HTTP server bound to ``127.0.0.1``.
"""

from __future__ import annotations

from .context import FlightRecorder, TraceContext, flight_recorder
from .metrics import Histogram, MetricsRegistry, registry
from .postmortem_link import (postmortem_record, postmortem_recorder,
                              set_postmortem_recorder)
from .slo import SloBurnEngine
from .status import StatusServer
from .timeline import EventLog, IncidentCorrelator, MetricSeries
from .trace import Tracer, tracer
from . import timeline

__all__ = ["Histogram", "MetricsRegistry", "Tracer", "registry",
           "tracer", "span", "compile_event", "TraceContext",
           "FlightRecorder", "flight_recorder", "SloBurnEngine",
           "StatusServer", "EventLog", "IncidentCorrelator", "MetricSeries", "timeline",
           "set_postmortem_recorder", "postmortem_recorder",
           "postmortem_record"]


def span(name: str, **attrs):
    """Context manager timing one named phase on the default tracer."""
    return tracer.span(name, **attrs)


def compile_event(batch: int, frames: int, labels: dict = None) -> None:
    """Report one rung's first use (see :meth:`Tracer.compile_event`)."""
    tracer.compile_event(batch, frames, labels=labels)
