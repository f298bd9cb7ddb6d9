"""Deterministic traffic model: make replay benches tell the truth.

The port's own copy of the JAX package's ``serving/trafficmodel.py``
(numpy only): the same schedules for the same seed.

``bench.py --bench=serve_traffic`` replays a flat Poisson process —
useful for exercising the gateway, useless for sizing a fleet. Real
speech traffic from millions of users is none of that: request rate
follows the day (diurnal curve), rides sharp social/broadcast bursts
on top of it, utterance lengths are heavy-tailed (a few long
dictations dominate device time), traffic splits across quality
tiers, and streaming sessions churn continuously. This module models
all five as one *seeded, deterministic* generator so a bench replay —
and the :class:`~.autoscale.AutoscaleController` reacting to it — is
reproducible sample for sample:

- **diurnal rate curve** — a sinusoid over a (compressible) ``day_s``
  period: ``base_rps * (1 + amplitude * sin(2*pi*t/day_s + phase))``.
  Benches compress the day to seconds; the shape is what matters
  (trough -> peak -> trough drives scale-down -> scale-up ->
  scale-down).
- **Markov burst modulation** — a two-state (calm/burst) chain stepped
  every ``burst_step_s``; the burst state multiplies the instantaneous
  rate by ``burst_rate_mult``. Bursts arrive in runs, not i.i.d.
  coin flips — exactly the pattern that defeats naive reactive
  scaling without hysteresis.
- **heavy-tailed utterance lengths** — clipped lognormal frame counts
  (the classic speech duration fit): most requests are short, the
  tail is long, and padding-waste / rung choice see realistic spread.
- **per-tier mix** — each arrival draws its quality tier from
  ``tier_mix`` (e.g. ``{"premium": 0.3, "bulk": 0.7}``); ``None``
  keeps the traffic tierless.
- **session churn** — streaming sessions join at ``session_rate``
  (uniform over the window) and live for a geometric number of
  chunks, so consistent-hash pins churn while the fleet resizes.

Determinism contract: one ``numpy`` Generator seeded at construction,
consumed in a fixed order (burst chain, then the arrival thinning
loop, then sessions) — the same seed yields the *identical* schedule,
byte for byte, which the tests pin down. Arrival times come from
Lewis-Shedler thinning of a homogeneous process at the peak rate, so
the non-homogeneous intensity is exact, not bin-approximated.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass(frozen=True)
class Arrival:
    """One offline transcribe request in the schedule."""

    t: float                    # seconds from the window start
    feat_len: int               # utterance length, feature frames
    tier: Optional[str] = None  # quality tier ("premium"/"bulk"/None)


@dataclass(frozen=True)
class SessionPlan:
    """One streaming session's lifetime in the schedule."""

    sid: str
    t_join: float
    n_chunks: int


@dataclass
class Schedule:
    """A generated replay schedule (arrivals time-sorted)."""

    arrivals: List[Arrival]
    sessions: List[SessionPlan]
    duration_s: float
    seed: int
    burst_states: List[int] = field(default_factory=list)
    burst_step_s: float = 1.0

    def per_bin_rps(self, bin_s: float = 1.0) -> List[float]:
        """Realized arrival rate per time bin — what the model actually
        offered, for reporting peak/trough against the fleet curve."""
        n = max(1, math.ceil(self.duration_s / bin_s))
        counts = [0] * n
        for a in self.arrivals:
            counts[min(int(a.t / bin_s), n - 1)] += 1
        return [c / bin_s for c in counts]

    def summary(self, bin_s: float = 1.0) -> Dict[str, object]:
        bins = self.per_bin_rps(bin_s)
        tiers: Dict[str, int] = {}
        for a in self.arrivals:
            tiers[a.tier or ""] = tiers.get(a.tier or "", 0) + 1
        lens = [a.feat_len for a in self.arrivals]
        return {
            "n_arrivals": len(self.arrivals),
            "n_sessions": len(self.sessions),
            "duration_s": self.duration_s,
            "seed": self.seed,
            "peak_rps": round(max(bins), 3) if bins else 0.0,
            "trough_rps": round(min(bins), 3) if bins else 0.0,
            "burst_fraction": (
                round(sum(self.burst_states) / len(self.burst_states), 4)
                if self.burst_states else 0.0),
            "len_p50": int(np.median(lens)) if lens else 0,
            "len_max": max(lens) if lens else 0,
            "tier_counts": tiers,
        }


class TrafficModel:
    """See module docstring. Typical bench use::

        model = TrafficModel(seed=0, duration_s=6.0, base_rps=24.0,
                             day_s=6.0, diurnal_amplitude=0.9)
        sched = model.schedule()
        for a in sched.arrivals:      # deterministic, time-sorted
            ...replay a.t / a.feat_len / a.tier...
    """

    def __init__(self, *, seed: int = 0, duration_s: float = 60.0,
                 base_rps: float = 8.0,
                 day_s: float = 86400.0,
                 diurnal_amplitude: float = 0.6,
                 diurnal_phase: float = -math.pi / 2,
                 burst_rate_mult: float = 3.0,
                 burst_enter_p: float = 0.08,
                 burst_exit_p: float = 0.35,
                 burst_step_s: float = 1.0,
                 len_log_mean: float = math.log(220.0),
                 len_log_sigma: float = 0.8,
                 len_min: int = 16, len_max: int = 1600,
                 tier_mix: Optional[Dict[str, float]] = None,
                 session_rate: float = 0.0,
                 session_mean_chunks: float = 8.0,
                 max_arrivals: Optional[int] = None):
        if duration_s <= 0 or base_rps < 0:
            raise ValueError("duration_s > 0 and base_rps >= 0")
        if not 0.0 <= diurnal_amplitude <= 1.0:
            raise ValueError("diurnal_amplitude in [0, 1]")
        if burst_rate_mult < 1.0:
            raise ValueError("burst_rate_mult >= 1 (1 = bursts off)")
        if not (0.0 <= burst_enter_p <= 1.0
                and 0.0 <= burst_exit_p <= 1.0):
            raise ValueError("burst probabilities in [0, 1]")
        if len_min < 1 or len_max < len_min:
            raise ValueError("need 1 <= len_min <= len_max")
        if tier_mix is not None:
            if not tier_mix or any(p < 0 for p in tier_mix.values()):
                raise ValueError("tier_mix needs non-negative weights")
        self.seed = int(seed)
        self.duration_s = float(duration_s)
        self.base_rps = float(base_rps)
        self.day_s = float(day_s)
        self.diurnal_amplitude = float(diurnal_amplitude)
        self.diurnal_phase = float(diurnal_phase)
        self.burst_rate_mult = float(burst_rate_mult)
        self.burst_enter_p = float(burst_enter_p)
        self.burst_exit_p = float(burst_exit_p)
        self.burst_step_s = float(burst_step_s)
        self.len_log_mean = float(len_log_mean)
        self.len_log_sigma = float(len_log_sigma)
        self.len_min = int(len_min)
        self.len_max = int(len_max)
        self.tier_mix = dict(tier_mix) if tier_mix else None
        self.session_rate = float(session_rate)
        self.session_mean_chunks = float(session_mean_chunks)
        self.max_arrivals = max_arrivals

    # -- the rate surface ------------------------------------------------
    def diurnal_rate(self, t: float) -> float:
        """Instantaneous diurnal rate (no burst), clamped at 0."""
        return max(0.0, self.base_rps * (
            1.0 + self.diurnal_amplitude * math.sin(
                2.0 * math.pi * t / self.day_s + self.diurnal_phase)))

    def _burst_chain(self, rng: np.random.Generator) -> List[int]:
        """The Markov calm(0)/burst(1) state per ``burst_step_s`` bin."""
        n = max(1, math.ceil(self.duration_s / self.burst_step_s))
        states: List[int] = []
        s = 0
        for _ in range(n):
            u = float(rng.random())
            if s == 0 and u < self.burst_enter_p:
                s = 1
            elif s == 1 and u < self.burst_exit_p:
                s = 0
            states.append(s)
        return states

    def rate(self, t: float, burst_states: List[int]) -> float:
        """Effective intensity: diurnal shape times burst modulation."""
        r = self.diurnal_rate(t)
        i = min(int(t / self.burst_step_s), len(burst_states) - 1)
        if burst_states and burst_states[i]:
            r *= self.burst_rate_mult
        return r

    # -- generation -------------------------------------------------------
    def schedule(self) -> Schedule:
        """Generate the full replay schedule. Same seed -> identical
        schedule (the determinism test's contract)."""
        rng = np.random.default_rng(self.seed)
        burst_states = self._burst_chain(rng)
        lam_max = (self.base_rps * (1.0 + self.diurnal_amplitude)
                   * self.burst_rate_mult)
        arrivals: List[Arrival] = []
        tiers = probs = None
        if self.tier_mix:
            tiers = sorted(self.tier_mix)
            total = sum(self.tier_mix.values())
            probs = [self.tier_mix[k] / total for k in tiers]
        t = 0.0
        while lam_max > 0:
            # Thinning: candidate gaps at the peak rate, accepted with
            # probability rate(t)/lam_max — exact non-homogeneous
            # Poisson sampling.
            t += float(rng.exponential(1.0 / lam_max))
            if t >= self.duration_s:
                break
            if float(rng.random()) > self.rate(t, burst_states) / lam_max:
                continue
            ln = int(round(float(rng.lognormal(self.len_log_mean,
                                               self.len_log_sigma))))
            ln = min(max(ln, self.len_min), self.len_max)
            tier = None
            if tiers is not None:
                tier = str(rng.choice(tiers, p=probs))
            arrivals.append(Arrival(t=round(t, 6), feat_len=ln,
                                    tier=tier))
            if self.max_arrivals is not None \
                    and len(arrivals) >= self.max_arrivals:
                break
        sessions: List[SessionPlan] = []
        if self.session_rate > 0:
            n_sess = int(rng.poisson(self.session_rate
                                     * self.duration_s))
            joins = sorted(float(rng.uniform(0.0, self.duration_s))
                           for _ in range(n_sess))
            for i, tj in enumerate(joins):
                n_chunks = 1 + int(rng.geometric(
                    1.0 / max(self.session_mean_chunks, 1.0)))
                sessions.append(SessionPlan(sid=f"sess{i}",
                                            t_join=round(tj, 6),
                                            n_chunks=n_chunks))
        return Schedule(arrivals=arrivals, sessions=sessions,
                        duration_s=self.duration_s, seed=self.seed,
                        burst_states=burst_states,
                        burst_step_s=self.burst_step_s)
