"""Span tracing: nested monotonic-clock spans, written as JSONL.

The port's own copy of the JAX package's ``obs/trace.py`` (stdlib
only). A span answers "where did this chunk's time go?"::

    {"event": "span", "name": "serve.chunk", "ts": <wall s>,
     "dur_ms": <float>, "id": 7, "parent": 3, ...attrs}
    {"event": "compile", "name": "compile", "ts": ..., "dur_ms": 0.0,
     "rung": "4x64", "replica": "r0"}

Durations come from a monotonic clock (injectable for tests — wall time
only stamps ``ts``); nesting is tracked per thread. A span times the
host: work it queued on the card may still be running when it closes.

DISABLED BY DEFAULT. ``span()`` on a disabled tracer returns a shared
no-op context manager — one attribute read, no allocation. Enable with
``configure(jsonl_path=...)`` or by exporting ``DS2_TRACE=/path``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, IO, Optional

from .metrics import MetricsRegistry, registry as _default_registry


class _NoopSpan:
    """Shared do-nothing span for the disabled tracer."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("_tracer", "name", "attrs", "id", "parent",
                 "ts", "_t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.id = tracer._new_id()
        self.parent = None
        self.ts = 0.0
        self._t0 = 0.0

    def set(self, **attrs) -> None:
        """Attach attributes discovered mid-span (e.g. cache hit)."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = self._tracer._stack()
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self.ts = self._tracer._wall()
        self._t0 = self._tracer._clock()
        return self

    def __exit__(self, *exc):
        dur_ms = (self._tracer._clock() - self._t0) * 1e3
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._tracer._record(self, dur_ms)
        return False


class Tracer:
    """Span recorder with an injectable monotonic clock and JSONL sink.

    ``registry`` (default: the process-wide one) additionally receives
    every span duration as a ``span_ms{name=...}`` histogram sample, so
    ``registry().render_text()`` exposes the same breakdown the trace
    file records, without parsing JSONL.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 clock: Optional[Callable[[], float]] = None,
                 wall: Optional[Callable[[], float]] = None):
        self.enabled = False
        self._clock = clock or time.perf_counter
        self._wall = wall or time.time
        self._registry = (registry if registry is not None
                          else _default_registry())
        self._sink: Optional[IO[str]] = None
        self._owns_sink = False
        self._lock = threading.Lock()
        self._tl = threading.local()
        self._id = 0

    # -- configuration --------------------------------------------------
    def configure(self, enabled: bool = True,
                  jsonl_path: Optional[str] = None,
                  sink: Optional[IO[str]] = None,
                  registry: Optional[MetricsRegistry] = None,
                  clock: Optional[Callable[[], float]] = None,
                  wall: Optional[Callable[[], float]] = None) -> None:
        """(Re)configure in place: pass ``jsonl_path`` to append span
        records to a file, or ``sink`` for an open stream (tests use
        ``io.StringIO``). Disabling closes an owned file sink."""
        with self._lock:
            if clock is not None:
                self._clock = clock
            if wall is not None:
                self._wall = wall
            if registry is not None:
                self._registry = registry
            if sink is not None:
                self._close_sink()
                self._sink, self._owns_sink = sink, False
            elif jsonl_path:
                self._close_sink()
                self._sink = open(jsonl_path, "a")
                self._owns_sink = True
                # Buffered writes (a flush per span would dominate the
                # span itself); make sure the tail reaches disk even
                # when nobody calls configure(enabled=False).
                import atexit

                atexit.register(self._close_sink)
            if not enabled:
                self._close_sink()
            self.enabled = enabled

    def _close_sink(self) -> None:
        if self._sink is not None and self._owns_sink:
            try:
                self._sink.close()
            except Exception:
                pass
        self._sink, self._owns_sink = None, False

    # -- recording ------------------------------------------------------
    def span(self, name: str, **attrs):
        """``with tracer.span("train.step", step=i): ...`` — returns the
        shared no-op when disabled (the fast path)."""
        if not self.enabled:
            return _NOOP
        return _Span(self, name, attrs)

    def compile_event(self, batch: int, frames: int,
                      labels: Optional[dict] = None) -> None:
        """One rung's first use (``utils/cache.ShapeBucketCache``):
        always counted per rung as ``compiles{rung=...}`` in the
        registry; with tracing on, also written as a zero-duration
        ``{"event": "compile", "rung", ...}`` record. Extra ``labels``
        (``{"replica": "r0"}`` from a pooled inferencer's ledger) join
        the counter's labels and the record."""
        rung = f"{int(batch)}x{int(frames)}"
        self._registry.count("compiles", 1,
                             labels={"rung": rung, **(labels or {})})
        if not self.enabled:
            return
        self._write({"event": "compile", "name": "compile",
                     "ts": round(self._wall(), 6), "dur_ms": 0.0,
                     "id": self._new_id(), "parent": None,
                     "rung": rung, **(labels or {})})

    def emit(self, rec: dict) -> None:
        """Write one caller-built record (a request-trace summary,
        ``obs/context.py``) through the JSONL sink; no-op when
        disabled."""
        if not self.enabled:
            return
        self._write(rec)

    # -- internals ------------------------------------------------------
    def _new_id(self) -> int:
        with self._lock:
            self._id += 1
            return self._id

    def _stack(self) -> list:
        stack = getattr(self._tl, "stack", None)
        if stack is None:
            stack = self._tl.stack = []
        return stack

    def _record(self, span: _Span, dur_ms: float) -> None:
        self._registry.observe("span_ms", dur_ms,
                               labels={"name": span.name})
        self._write({"event": "span", "name": span.name,
                     "ts": round(span.ts, 6),
                     "dur_ms": round(dur_ms, 6),
                     "id": span.id, "parent": span.parent,
                     **span.attrs})

    def _write(self, rec: dict) -> None:
        # The line is serialized OUTSIDE the lock, and the single
        # sink.write of a complete line happens INSIDE it:
        # io.TextIOWrapper/StringIO writes are not atomic across
        # threads without this, and two threads' records would tear
        # mid-line.
        sink = self._sink
        if sink is None:
            return
        line = json.dumps(rec, ensure_ascii=False, default=str) + "\n"
        with self._lock:
            sink.write(line)


tracer = Tracer()

_env_path = os.environ.get("DS2_TRACE", "")
if _env_path:
    tracer.configure(enabled=True, jsonl_path=_env_path)
