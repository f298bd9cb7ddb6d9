"""Observability: one metrics registry and span tracing.

The port's own copy of the JAX package's ``obs/`` core: the
:class:`MetricsRegistry` (``registry()`` is the process-wide default)
and the span :class:`Tracer` (``tracer``; ``span`` times one named phase
on it). The rest of the JAX ``obs/`` (request contexts, SLO burn rates,
the status server, the incident timeline) comes with slice 4 of the
port.
"""

from __future__ import annotations

from .metrics import Histogram, MetricsRegistry, registry
from .trace import Tracer, tracer

__all__ = ["Histogram", "MetricsRegistry", "Tracer", "registry", "span",
           "tracer"]


def span(name: str, **attrs):
    """Context manager timing one named phase on the default tracer."""
    return tracer.span(name, **attrs)
