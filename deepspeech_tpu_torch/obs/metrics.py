"""Metrics registry: counters, gauges, histograms, per-rung usage.

The port's own copy of the JAX package's ``obs/metrics.py`` (stdlib
only): a process-wide, thread-safe registry that the serving layers
share. Everything is plain host-side Python; nothing here touches a
device.

Conventions:
- counters are monotone event counts (``sessions_joined``, ...);
- gauges are last-observed values (``capacity``, ``active_sessions``);
- histograms keep a bounded reservoir and report count/mean/p50/p95/max;
- per-rung usage is a counter keyed by the padded ``(B, T)`` shape;
- labels: every recording method takes ``labels={...}``; the labeled
  series is stored under ``name{k="v",...}`` (Prometheus spelling), so
  ``count("x", labels={"rung": "4x64"})`` and a bare ``count("x")`` are
  distinct series.

``snapshot()`` returns one JSON-ready dict; ``emit_jsonl()`` appends it
as one line with a wall-clock ``ts``; ``render_text()`` renders the
Prometheus text exposition for scraping.
"""

from __future__ import annotations

import json
import re
import threading
import time
from typing import Dict, IO, List, Optional, Tuple


class Histogram:
    """Bounded-reservoir histogram with exact percentiles while the
    sample count fits the reservoir (gateway runs are bounded; serving
    benches see thousands of samples, not billions). Past
    ``max_samples`` the reservoir keeps every ``_stride``-th
    observation so memory stays bounded while the spread remains
    representative.

    The keep rule tracks the absolute index of the next sample to
    retain (``_next_keep``) rather than testing ``seen % stride``:
    after a thin-by-2 the modulus test would be evaluated against the
    pre-thinning phase, and a phase mismatch aliases the retained set
    to one side of the stream. Advancing an explicit index from the
    last retained sample keeps the reservoir uniformly spaced across
    the whole stream by construction.

    ``observe(value, exemplar=...)`` optionally tags the sample with an
    id; the histogram keeps the exemplar of its extreme (max) sample,
    so a histogram answers "WHICH session was the worst" (the session
    manager tags its per-session series with ``sess:<sid>``).
    """

    def __init__(self, max_samples: int = 4096):
        self.max_samples = max_samples
        self._samples: List[float] = []
        self._stride = 1
        self._seen = 0
        self._next_keep = 0
        self.count = 0
        self.total = 0.0
        self.max = None  # type: Optional[float]
        self.max_exemplar = None  # type: Optional[str]

    def observe(self, value: float,
                exemplar: Optional[str] = None) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        if self.max is None or value > self.max:
            self.max = value
            # A new max without an exemplar clears the old one — the
            # stored id must always belong to the stored extreme.
            self.max_exemplar = exemplar
        if self._seen == self._next_keep:
            self._samples.append(value)
            if len(self._samples) > self.max_samples:
                # Thin by 2: keep every other retained sample. The
                # survivors sit at multiples of the NEW stride, so the
                # next keep continues their spacing exactly.
                self._samples = self._samples[::2]
                self._stride *= 2
            self._next_keep = self._seen + self._stride
        self._seen += 1

    def percentile(self, p: float) -> Optional[float]:
        if not self._samples:
            return None
        s = sorted(self._samples)
        k = min(len(s) - 1, max(0, round(p / 100.0 * (len(s) - 1))))
        return s[k]

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None

    def snapshot(self) -> dict:
        r6 = lambda v: None if v is None else round(v, 6)  # noqa: E731
        snap = {"count": self.count, "mean": r6(self.mean),
                "p50": r6(self.percentile(50)),
                "p95": r6(self.percentile(95)), "max": r6(self.max)}
        if self.max_exemplar is not None:
            snap["max_exemplar"] = self.max_exemplar
        return snap


def _labeled(name: str, labels: Optional[dict]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


_LABEL_RE = re.compile(r'(\w+)="([^"]*)"')


def parse_series(series: str) -> Tuple[str, Dict[str, str]]:
    """Invert :func:`_labeled`: split ``name{k="v",...}`` into
    ``(name, {k: v})`` (``(name, {})`` for a bare series)."""
    base, brace, rest = series.partition("{")
    if not brace:
        return series, {}
    return base, dict(_LABEL_RE.findall(rest[:-1] if rest.endswith("}")
                                        else rest))


def _prom_parts(prefix: str, name: str) -> Tuple[str, str]:
    """Split a (possibly labeled) series name into a sanitized
    exposition metric name and its ``{...}`` label suffix."""
    base, _, labels = name.partition("{")
    base = re.sub(r"[^a-zA-Z0-9_:]", "_", base)
    return f"{prefix}_{base}", f"{{{labels}" if labels else ""


class MetricsRegistry:
    """Thread-safe counters/gauges/histograms/per-rung usage.

    One lock guards every mutation: recording happens on the gateway
    dispatch path and (with tracing on) from the training loop, both of
    which may run alongside background threads (checkpoint writers,
    stream sessions). Reads (``snapshot``/``render_text``) take the
    same lock so exports are point-in-time consistent.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, Histogram] = {}
        self._rungs: Dict[Tuple[int, int], int] = {}

    # -- recording ------------------------------------------------------
    def count(self, name: str, n: float = 1,
              labels: Optional[dict] = None) -> None:
        name = _labeled(name, labels)
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float,
              labels: Optional[dict] = None) -> None:
        name = _labeled(name, labels)
        with self._lock:
            self.gauges[name] = value

    def observe(self, name: str, value: float,
                labels: Optional[dict] = None,
                exemplar: Optional[str] = None) -> None:
        name = _labeled(name, labels)
        with self._lock:
            self.hists.setdefault(name, Histogram()).observe(
                value, exemplar=exemplar)

    def rung(self, batch: int, frames: int, n: int = 1) -> None:
        key = (int(batch), int(frames))
        with self._lock:
            self._rungs[key] = self._rungs.get(key, 0) + n

    # -- reading --------------------------------------------------------
    def counter(self, name: str, labels: Optional[dict] = None) -> float:
        return self.counters.get(_labeled(name, labels), 0)

    def rung_usage(self) -> Dict[Tuple[int, int], int]:
        with self._lock:
            return dict(self._rungs)

    def hist_family(self, name: str) -> Dict[str, Histogram]:
        """Every histogram series of the family ``name`` — the bare
        series plus all labeled variants (``name{replica="r0"}``...).
        Readers that must see the worst series regardless of labeling
        (e.g. brownout device pressure across replicas) use this."""
        prefix = name + "{"
        with self._lock:
            return {k: h for k, h in self.hists.items()
                    if k == name or k.startswith(prefix)}

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(sorted(self.counters.items())),
                "gauges": dict(sorted(self.gauges.items())),
                "histograms": {k: h.snapshot()
                               for k, h in sorted(self.hists.items())},
                # JSON keys must be strings; "BxT" mirrors the ladder
                # docs.
                "per_rung": {f"{b}x{t}": n for (b, t), n
                             in sorted(self._rungs.items())},
            }

    def emit_jsonl(self, fh: IO[str], event: str = "metrics",
                   **extra) -> dict:
        """Append one JSONL record of the current snapshot; returns it.

        Every record carries ``event`` and a wall-clock ``ts``.

        The write happens under the registry lock (RLock — snapshot
        re-enters it): two threads emitting to one stream must never
        interleave halves of two records on the same line.
        """
        with self._lock:
            rec = {"event": event, "ts": round(time.time(), 6),
                   **self.snapshot(), **extra}
            fh.write(json.dumps(rec, ensure_ascii=False) + "\n")
            fh.flush()
        return rec

    def render_text(self, prefix: str = "ds2") -> str:
        """Prometheus text exposition of the current state.

        Counters/gauges render as their native types, histograms as
        summaries (``quantile`` series + ``_sum``/``_count``), per-rung
        usage as one counter labeled by rung.
        """
        with self._lock:
            lines: List[str] = []
            typed: set = set()

            def _type(metric: str, kind: str) -> None:
                if metric not in typed:
                    typed.add(metric)
                    lines.append(f"# TYPE {metric} {kind}")

            for name, v in sorted(self.counters.items()):
                metric, lab = _prom_parts(prefix, name)
                _type(metric, "counter")
                lines.append(f"{metric}{lab} {v:g}")
            for name, v in sorted(self.gauges.items()):
                metric, lab = _prom_parts(prefix, name)
                _type(metric, "gauge")
                lines.append(f"{metric}{lab} {v:g}")
            for name, h in sorted(self.hists.items()):
                metric, lab = _prom_parts(prefix, name)
                _type(metric, "summary")
                for q in (50, 95):
                    val = h.percentile(q)
                    if val is None:
                        continue
                    qlab = (lab[:-1] + "," if lab
                            else "{") + f'quantile="0.{q}"}}'
                    lines.append(f"{metric}{qlab} {val:g}")
                lines.append(f"{metric}_sum{lab} {h.total:g}")
                lines.append(f"{metric}_count{lab} {h.count:g}")
            if self._rungs:
                metric = f"{prefix}_rung_usage"
                _type(metric, "counter")
                for (b, t), n in sorted(self._rungs.items()):
                    lines.append(f'{metric}{{rung="{b}x{t}"}} {n:g}')
            return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        """Forget everything (tests and bench phases reuse the
        process-wide registry)."""
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.hists.clear()
            self._rungs.clear()


_DEFAULT = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide default registry (train/infer/serve share it;
    the gateway may still construct private ``ServingTelemetry``
    instances for per-run isolation)."""
    return _DEFAULT
