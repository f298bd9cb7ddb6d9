"""SLO burn-rate engine: multi-window alerting over slo_ok/slo_miss.

The port's own copy of the JAX package's ``obs/slo.py`` (stdlib only).
The gateway counts per-request SLO attainment (``slo_ok``/``slo_miss``,
tier-labeled when tiers are active); this module turns the counters
into the signal an operator pages on — the **burn rate**: the observed
miss rate divided by the error budget (``1 - target``). Burn 1.0
spends the budget exactly at the SLO period's natural pace; burn 14.4
over a 5-minute window spends ~2% of a 30-day budget in one hour. Two
windows keep the alert honest:

- the **fast** window (default 5m) catches a sharp regression within
  minutes of onset;
- the **slow** window (default 1h) *holds* — a short blip that the
  fast window sees but the slow window dilutes below its threshold
  stays a fast-window page, and once the breach passes out of a
  window the burn falls and the alert state resets (re-arming for the
  next episode).

:class:`SloBurnEngine` samples the counters on :meth:`update` (the
pump-loop cadence; the clock is injectable so tests script the
timeline), computes per-(window, tier) burn over cumulative-count
diffs, and

- publishes ``slo_burn_rate{window=...}`` gauges (plus ``tier=`` for
  tiered traffic; the family always carries ``window``);
- on a threshold breach, fires ONE alert per episode: an
  ``slo_alerts_fired`` counter and a ``kind="slo_burn"`` postmortem
  (``resilience/postmortem.py``) whose evidence names the slowest
  recent requests from the :class:`~.context.FlightRecorder`, each
  with its attributed cause;
- feeds brownout: ``BrownoutController(slo_burn_budget=...)`` reads
  the worst ``slo_burn_rate`` gauge as a pressure input alongside
  queue/device/memory pressure.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, Optional, Tuple

from . import timeline as _timeline
from .context import FlightRecorder, flight_recorder
from .metrics import MetricsRegistry, parse_series
from .metrics import registry as _default_registry
from .postmortem_link import postmortem_record

DEFAULT_WINDOWS = {"fast": 300.0, "slow": 3600.0}
# SRE-workbook-style page thresholds (fraction-of-budget per window,
# scaled for a 30-day budget period): the fast window needs a steep
# burn to page, the slow window a sustained one.
DEFAULT_THRESHOLDS = {"fast": 14.4, "slow": 6.0}

# Keys kept when a flight-recorder summary rides into alert evidence —
# enough to name the request and its attributed cause without dumping
# whole feature payloads into the postmortem line.
_EVIDENCE_KEYS = ("rid", "status", "latency_ms", "cause", "phases",
                  "tier", "replica", "attempts")


def slim_trace(rec: dict) -> dict:
    """A trace summary reduced to postmortem-evidence size."""
    return {k: rec[k] for k in _EVIDENCE_KEYS if k in rec}


class SloBurnEngine:
    """See module docstring. Pump-loop protocol::

        engine = SloBurnEngine(registry=sched.telemetry,
                               recorder=recorder, target=0.99)
        while serving:
            sched.pump()
            engine.update()        # gauges + alert edge detection
    """

    def __init__(self, *, target: float = 0.99,
                 windows: Optional[Dict[str, float]] = None,
                 thresholds: Optional[Dict[str, float]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 clock: Callable[[], float] = time.monotonic,
                 recorder: Optional[FlightRecorder] = None,
                 postmortem_fn: Optional[Callable] = None,
                 slowest_n: int = 5):
        if not 0.0 < target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {target}")
        self.target = float(target)
        self.budget = 1.0 - self.target
        self.windows = dict(windows if windows is not None
                            else DEFAULT_WINDOWS)
        if not self.windows or any(w <= 0
                                   for w in self.windows.values()):
            raise ValueError("windows must be positive durations")
        self.thresholds = dict(thresholds if thresholds is not None
                               else DEFAULT_THRESHOLDS)
        self._registry = registry
        self.clock = clock
        self.recorder = recorder if recorder is not None \
            else flight_recorder()
        # Default goes through the postmortem_link seam: resilience
        # registers its recorder there on import, so obs never imports
        # resilience at module load.
        self._postmortem = postmortem_fn
        self.slowest_n = int(slowest_n)
        # Timeline seq of each live alert, per (window, tier) — the
        # causal parent of the matching slo_recover event.
        self._alert_seq: Dict[Tuple[str, str], Optional[int]] = {}
        # Cumulative (ok, miss) per tier key ("" = tierless), sampled
        # on every update — the diff base for window burn.
        self._samples: deque = deque()
        self._active: Dict[Tuple[str, str], bool] = {}
        self.alerts: list = []          # fired alert records, in order
        self.burn: Dict[Tuple[str, str], float] = {}

    def _reg(self) -> MetricsRegistry:
        return self._registry if self._registry is not None \
            else _default_registry()

    def _fire_postmortem(self, **evidence) -> dict:
        fn = self._postmortem if self._postmortem is not None \
            else postmortem_record
        return fn("slo_burn", **evidence)

    # -- counter sampling -----------------------------------------------
    def _read_counts(self) -> Dict[str, Tuple[float, float]]:
        """Cumulative (ok, miss) per tier key from the registry's
        ``slo_ok``/``slo_miss`` series (bare + tier-labeled)."""
        counts: Dict[str, Tuple[float, float]] = {}
        for series, v in dict(self._reg().counters).items():
            name, labels = parse_series(series)
            if name not in ("slo_ok", "slo_miss"):
                continue
            tier = labels.get("tier", "")
            ok, miss = counts.get(tier, (0.0, 0.0))
            if name == "slo_ok":
                ok += v
            else:
                miss += v
            counts[tier] = (ok, miss)
        return counts

    def _base_at(self, t: float) -> Dict[str, Tuple[float, float]]:
        """The newest sample at or before ``t`` — the window's diff
        base. Before the engine has that much history, the oldest
        sample: burn is computed over the observed part of the window
        rather than inventing a zero history."""
        base = self._samples[0][1]
        for ts, counts in self._samples:
            if ts <= t:
                base = counts
            else:
                break
        return base

    # -- the engine turn -------------------------------------------------
    def update(self, now: Optional[float] = None
               ) -> Dict[Tuple[str, str], float]:
        """Sample the counters, recompute burn per (window, tier key),
        publish gauges, and run alert edge detection. Returns the burn
        map (also kept on :attr:`burn`)."""
        now = self.clock() if now is None else now
        counts = self._read_counts()
        self._samples.append((now, counts))
        # Trim to the longest window, keeping one sample at or beyond
        # the horizon as the diff base.
        horizon = now - max(self.windows.values())
        while len(self._samples) >= 2 and self._samples[1][0] <= horizon:
            self._samples.popleft()

        burn: Dict[Tuple[str, str], float] = {}
        for wname, wlen in self.windows.items():
            base = self._base_at(now - wlen)
            for tier, (ok1, miss1) in counts.items():
                ok0, miss0 = base.get(tier, (0.0, 0.0))
                total = (ok1 - ok0) + (miss1 - miss0)
                rate = (miss1 - miss0) / total if total > 0 else 0.0
                b = rate / self.budget
                labels = {"window": wname}
                if tier:
                    labels["tier"] = tier
                self._reg().gauge("slo_burn_rate", b, labels=labels)
                burn[(wname, tier)] = b
        self.burn = burn
        self._edge_detect(burn, now)
        return burn

    def _edge_detect(self, burn: Dict[Tuple[str, str], float],
                     now: float) -> None:
        """One alert per breach episode: fire on the rising edge past
        the window's threshold, re-arm when the burn recovers below
        it."""
        for (wname, tier), b in burn.items():
            thr = self.thresholds.get(wname)
            if thr is None:
                continue
            key = (wname, tier)
            active = self._active.get(key, False)
            if b >= thr and not active:
                self._active[key] = True
                self._fire(wname, tier, b, thr, now)
            elif b < thr and active:
                self._active[key] = False
                labels = {"window": wname}
                if tier:
                    labels["tier"] = tier
                self._reg().count("slo_alerts_recovered",
                                  labels=labels)
                _timeline.publish(
                    "slo_recover", "slo", tier=tier or None,
                    cause_seq=self._alert_seq.pop(key, None),
                    window=wname, burn_rate=round(b, 6))

    def _fire(self, wname: str, tier: str, burn: float,
              threshold: float, now: float) -> None:
        labels = {"window": wname}
        if tier:
            labels["tier"] = tier
        self._reg().count("slo_alerts_fired", labels=labels)
        evidence = {
            "trigger": f"burn_rate_{wname}",
            "window": wname,
            "burn_rate": round(burn, 6),
            "threshold": threshold,
            "target": self.target,
            "slowest_requests": [slim_trace(r) for r in
                                 self.recorder.slowest(self.slowest_n)],
        }
        if tier:
            evidence["tier"] = tier
        self._alert_seq[(wname, tier)] = _timeline.publish(
            "slo_alert", "slo", tier=tier or None, window=wname,
            burn_rate=round(burn, 6), threshold=threshold)
        rec = self._fire_postmortem(**evidence)
        self.alerts.append({"t": now, "window": wname, "tier": tier,
                            "burn_rate": burn,
                            "postmortem": rec})

    # -- reading ---------------------------------------------------------
    def alert_active(self, window: str,
                     tier: str = "") -> bool:
        return self._active.get((window, tier), False)

    def worst_burn(self, window: Optional[str] = None) -> float:
        """Worst current burn (optionally within one window) — the
        scalar a pressure consumer wants."""
        vals = [b for (w, _), b in self.burn.items()
                if window is None or w == window]
        return max(vals) if vals else 0.0

    def status(self) -> dict:
        """JSON-ready state for the ``/slo`` ops endpoint."""
        return {
            "target": self.target,
            "windows": dict(self.windows),
            "thresholds": dict(self.thresholds),
            "burn": {f"{w}|{t}" if t else w: round(b, 6)
                     for (w, t), b in sorted(self.burn.items())},
            "active_alerts": [{"window": w, "tier": t}
                              for (w, t), on in sorted(
                                  self._active.items()) if on],
            "alerts_fired": len(self.alerts),
        }
