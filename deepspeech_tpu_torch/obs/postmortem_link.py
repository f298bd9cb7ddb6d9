"""Injection seam between obs and the postmortem writer.

The port's own copy of the JAX package's ``obs/postmortem_link.py``.
``resilience/postmortem.py`` imports ``obs`` at module load, so obs
modules (SLO burn alerts, the incident correlator) cannot import it
back there. Instead resilience *registers* its recorder here when it
loads (``obs.set_postmortem_recorder(postmortem.record)``), and obs
callers go through :func:`postmortem_record`. A lazy import remains
only for the degenerate order (an obs caller firing before
``resilience.postmortem`` was ever imported).
"""

from __future__ import annotations

from typing import Callable, Optional

__all__ = ["set_postmortem_recorder", "postmortem_recorder",
           "postmortem_record"]

_RECORDER: Optional[Callable] = None


def set_postmortem_recorder(fn: Optional[Callable]) -> None:
    """Register ``fn(kind, trigger="", **evidence)`` as the process
    postmortem recorder (``resilience.postmortem`` does on import)."""
    global _RECORDER
    _RECORDER = fn


def postmortem_recorder() -> Optional[Callable]:
    return _RECORDER


def postmortem_record(kind: str, trigger: str = "", **evidence):
    """Write one postmortem through the registered recorder."""
    fn = _RECORDER
    if fn is None:
        from ..resilience import postmortem as _pm
        fn = _pm.record
    return fn(kind, trigger=trigger, **evidence)
