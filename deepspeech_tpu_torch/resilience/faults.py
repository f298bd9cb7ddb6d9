"""Deterministic fault injection: a process-wide ``FaultPlan``.

The port's own copy of the JAX package's ``resilience/faults.py``
(stdlib only), with the same plan format, so one plan file drives
either package. Chaos testing needs the failure, not the outage: a
decode that throws mid-batch cannot be *scheduled* in the wild, so
none of the recovery paths could be regression-tested without this.

A :class:`FaultPlan` is a list of :class:`FaultSpec` entries, each
bound to a named **injection point** (a call site that opted in via
:func:`inject`). The port wires every point of ``KNOWN_POINTS`` but
``backend.init`` (the JAX package's benchmark probe):

- ``gateway.dispatch`` — ``serving/replica.py`` and
  ``serving/scheduler.py``, around each micro-batch decode;
- ``pipeline.device_prefetch`` / ``pipeline.materialize`` —
  ``data/pipeline.py``, per batch transfer and per materialized batch
  (``corrupt_batch`` poisons a sample for the quarantine scrubber);
- ``checkpoint.save`` / ``checkpoint.restore`` — ``checkpoint.py``;
- ``train.step`` — ``train.py``, before each guarded step (``nan_grad``
  poisons the batch so the loss and gradients go non-finite);
- ``rollout.swap`` / ``rollout.canary`` — ``serving/rollout.py``;
- ``journal.append`` / ``journal.recover`` —
  ``serving/sessionstore.py`` (``partial_write`` tears the journal
  frame in flight);
- ``transport.send`` / ``transport.recv`` / ``transport.ack`` —
  ``serving/transport.py`` (``partial_write`` on ``transport.send``
  tears the wire frame; ``unavailable`` on ``transport.ack`` loses the
  ACK after the import landed).

Six fault kinds:

- ``error``         — raise :class:`InjectedFault` (transient failure)
- ``unavailable``   — raise :class:`InjectedFault` whose message
  carries ``UNAVAILABLE`` (backend-outage shape); usually windowed
  via ``after_s``/``until_s`` to model an outage with a recovery edge
- ``latency``       — sleep ``latency_s`` (spike, not failure)
- ``partial_write``, ``nan_grad``, ``corrupt_batch`` — returned to the
  caller, who simulates the damage (a torn write, a poisoned batch)

Determinism: firing decisions come from one seeded ``random.Random``
and a plan-relative clock (``clock() - started_at``; the clock is
injectable), so a plan replays identically under a virtual clock. For
*step-exact* schedules, ``skip`` counts down would-fire checks before
the first real fire — e.g. ``skip=10, count=2`` fires on exactly the
11th and 12th eligible checks at that point, independent of wall time.
Every fire is counted in the plan's metrics registry as
``faults_injected{point=...,kind=...}``.

**Episode-relative triggers** (``on_event`` + ``arm_for_s``): instead
of a wall-clock window, a spec may be *armed* by a named controller
event (:func:`notify`; see ``KNOWN_EVENTS``). ``target`` narrows a
spec to one replica: a literal rid, or the sentinel ``"@event"``
meaning "whatever replica the arming event named" (call sites pass
context: ``inject("gateway.dispatch", replica=rid)``).
**Load-relative triggers** (``min_load``): a replay loop reports
offered load via :func:`note_load`; a spec with ``min_load`` only
fires while the reported load is at or above it. Wall-clock
(``after_s``/``until_s``) and episode (``on_event``) triggers are
mutually exclusive on one spec — :func:`validate_plan_dict` rejects
the combination.

Configuration is env/JSON: export ``DS2_FAULT_PLAN=/path/plan.json``
(validated by :func:`validate_plan_dict`) or install
programmatically::

    plan = FaultPlan([FaultSpec("gateway.dispatch", "error", prob=0.1)])
    faults.install(plan)
    ...
    faults.clear()

When no plan is installed (the default) :func:`inject` is one
module-global read.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

from .. import obs
from ..obs import timeline as _timeline

KINDS = ("error", "unavailable", "latency", "partial_write",
         "nan_grad", "corrupt_batch")

# Injection points wired into the codebase today. Unknown points are
# legal (a plan may predate the code that wires them) but
# :func:`lint_plan_points` warns, since a typo'd point silently never fires.
KNOWN_POINTS = ("gateway.dispatch", "pipeline.device_prefetch",
                "pipeline.materialize", "checkpoint.save",
                "checkpoint.restore", "backend.init", "train.step",
                "rollout.swap", "rollout.canary",
                "journal.append", "journal.recover",
                "transport.send", "transport.recv", "transport.ack")

# Controller events wired to a faults.notify() call today. Like
# KNOWN_POINTS: an unknown event name is legal but lint-warned, since
# a typo'd event leaves the spec armed never.
KNOWN_EVENTS = ("autoscale.init", "autoscale.scale_up",
                "autoscale.scale_down", "autoscale.drain_begin",
                "autoscale.drain_cancel", "autoscale.vertical_up",
                "autoscale.vertical_down", "autoscale.holdoff",
                "autoscale.resume", "rollout.swap_begin",
                "traffic.burst", "traffic.calm",
                "recovery.begin", "recovery.done",
                "migration.remote_begin")

_SPEC_KEYS = {"point", "kind", "prob", "count", "after_s", "until_s",
              "latency_s", "message", "skip", "on_event", "arm_for_s",
              "target", "min_load"}
_PLAN_KEYS = {"seed", "faults"}


class InjectedFault(RuntimeError):
    """A fault fired by the active :class:`FaultPlan`."""

    def __init__(self, point: str, kind: str, message: str):
        super().__init__(message)
        self.point = point
        self.kind = kind


@dataclass
class FaultSpec:
    """One scheduled fault at one injection point.

    ``after_s``/``until_s`` window the fault on the plan-relative clock
    (``until_s=None`` = forever); ``prob`` thins it; ``count`` caps the
    total fires (None = unlimited); ``skip`` consumes that many
    would-fire checks before the first real fire (a step-exact
    schedule, immune to wall time).

    Episode-relative alternative to the wall-clock window:
    ``on_event`` names a controller event (:func:`notify`) that *arms*
    the spec; ``arm_for_s`` bounds how long it stays armed after each
    arming (None = forever). ``target`` restricts firing to one
    replica's injection context — a literal rid, or ``"@event"`` for
    the replica the arming event named. ``min_load`` gates firing on
    the replay loop's reported offered load (:func:`note_load`).
    ``fired``/``skipped``/``armed_at``/``armed_target``/
    ``armed_cause`` are runtime state (``armed_cause`` is the fleet-
    timeline seq of the arming event, so every fire carries its
    causal parent).
    """

    point: str
    kind: str
    prob: float = 1.0
    count: Optional[int] = None
    after_s: float = 0.0
    until_s: Optional[float] = None
    latency_s: float = 0.0
    message: str = ""
    skip: int = 0
    on_event: Optional[str] = None
    arm_for_s: Optional[float] = None
    target: Optional[str] = None
    min_load: Optional[float] = None
    fired: int = field(default=0, compare=False)
    skipped: int = field(default=0, compare=False)
    armed_at: Optional[float] = field(default=None, compare=False)
    armed_target: Optional[str] = field(default=None, compare=False)
    armed_cause: Optional[int] = field(default=None, compare=False)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"fault kind {self.kind!r} not in {KINDS}")
        if self.on_event is not None \
                and (self.after_s > 0 or self.until_s is not None):
            raise ValueError(
                "wall-clock (after_s/until_s) and episode (on_event) "
                "triggers are mutually exclusive on one spec")
        if self.target == "@event" and self.on_event is None:
            raise ValueError(
                "target '@event' requires on_event (no event names "
                "the replica)")
        if not self.message:
            self.message = (
                f"injected backend UNAVAILABLE at {self.point}"
                if self.kind == "unavailable"
                else f"injected {self.kind} at {self.point}")


class FaultPlan:
    """A deterministic schedule of faults over named injection points.

    ``clock`` is any monotonic float source (injectable for tests);
    elapsed time is measured from :meth:`start` (called by
    :func:`install`, or lazily on first check). ``sleep`` backs the
    ``latency`` kind and is injectable so tests don't really wait.
    """

    def __init__(self, specs: Sequence[FaultSpec], *, seed: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 registry=None):
        self.specs = list(specs)
        self.seed = seed
        self.rng = random.Random(seed)
        self.clock = clock
        self.sleep = sleep
        self._registry = registry
        self.started_at: Optional[float] = None
        self.load: float = 0.0

    # -- construction ---------------------------------------------------
    @classmethod
    def from_dict(cls, obj: dict, **kw) -> "FaultPlan":
        problems = validate_plan_dict(obj)
        if problems:
            raise ValueError("invalid fault plan: " + "; ".join(problems))
        specs = [FaultSpec(**f) for f in obj.get("faults", [])]
        return cls(specs, seed=int(obj.get("seed", 0)), **kw)

    @classmethod
    def from_json(cls, path: str, **kw) -> "FaultPlan":
        with open(path) as fh:
            return cls.from_dict(json.load(fh), **kw)

    def to_dict(self) -> dict:
        runtime = ("fired", "skipped", "armed_at", "armed_target",
                   "armed_cause")
        return {"seed": self.seed, "faults": [
            {k: v for k, v in dataclasses.asdict(s).items()
             if k not in runtime and v is not None}
            for s in self.specs]}

    # -- runtime --------------------------------------------------------
    @property
    def registry(self):
        return self._registry if self._registry is not None \
            else obs.registry()

    def start(self) -> "FaultPlan":
        self.started_at = self.clock()
        return self

    def elapsed(self) -> float:
        if self.started_at is None:
            self.start()
        return self.clock() - self.started_at

    def notify(self, event: str, **info) -> int:
        """A controller event happened: arm every spec scheduled on it
        (``on_event``). ``info`` may carry ``replica=`` — captured for
        ``target="@event"`` specs so the fault chases the episode's
        replica — and ``cause_seq=`` — the fleet-timeline seq of the
        controller event, threaded through the arming so a later fire
        traces back to its trigger. Re-notifying re-arms (a fresh
        ``arm_for_s`` window). Returns the number of specs armed."""
        armed_specs = []
        t = self.elapsed()
        for spec in self.specs:
            if spec.on_event != event:
                continue
            spec.armed_at = t
            if spec.target == "@event":
                rid = info.get("replica")
                if rid:
                    spec.armed_target = str(rid)
            armed_specs.append(spec)
        if armed_specs:
            self.registry.count("faults_armed",
                                labels={"event": event})
            seq = _timeline.publish(
                "fault_armed", "faults",
                replica=info.get("replica"),
                cause_seq=info.get("cause_seq"),
                trigger=event, n_armed=len(armed_specs))
            for spec in armed_specs:
                spec.armed_cause = seq
        return len(armed_specs)

    def note_load(self, load: float) -> None:
        """The replay loop's offered-load report (``min_load`` gate)."""
        self.load = float(load)

    def check(self, point: str, **ctx) -> Optional[FaultSpec]:
        """First spec at ``point`` that fires now (counted), else None.
        ``ctx`` is the injection context (``replica=rid``) matched
        against ``target`` specs."""
        t = self.elapsed()
        for spec in self.specs:
            if spec.point != point:
                continue
            if spec.on_event is not None:
                # Episode-relative: live only while armed (and inside
                # the arm window, when bounded).
                if spec.armed_at is None:
                    continue
                if spec.arm_for_s is not None \
                        and t >= spec.armed_at + spec.arm_for_s:
                    continue
            else:
                if t < spec.after_s:
                    continue
                if spec.until_s is not None and t >= spec.until_s:
                    continue
            if spec.min_load is not None and self.load < spec.min_load:
                continue
            if spec.target is not None:
                want = (spec.armed_target if spec.target == "@event"
                        else spec.target)
                if want is None or ctx.get("replica") != want:
                    continue
            if spec.count is not None and spec.fired >= spec.count:
                continue
            if spec.prob < 1.0 and self.rng.random() >= spec.prob:
                continue
            if spec.skipped < spec.skip:
                spec.skipped += 1
                continue
            spec.fired += 1
            self.registry.count("faults_injected",
                                labels={"point": point, "kind": spec.kind})
            _timeline.publish(
                "fault_fire", "faults", replica=ctx.get("replica"),
                cause_seq=spec.armed_cause, point=point,
                fault_kind=spec.kind, fired=spec.fired)
            return spec
        return None

    def fired(self) -> int:
        return sum(s.fired for s in self.specs)


# -- process-wide installation -----------------------------------------
_ACTIVE: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    """Make ``plan`` the process-wide active plan (clock starts now)."""
    global _ACTIVE
    plan.start()
    _ACTIVE = plan
    return plan


def clear() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[FaultPlan]:
    return _ACTIVE


def inject(point: str, **ctx) -> Optional[FaultSpec]:
    """The injection-point hook.

    No active plan (production default): one global read, returns None.
    Otherwise: ``error``/``unavailable`` raise :class:`InjectedFault`,
    ``latency`` sleeps then returns the spec, and the caller-acted
    kinds (``partial_write``, ``nan_grad``, ``corrupt_batch``) return
    the spec for the call site to simulate the damage. ``ctx`` is the
    call site's injection context (``replica=rid``), matched against
    ``target`` specs.
    """
    plan = _ACTIVE
    if plan is None:
        return None
    spec = plan.check(point, **ctx)
    if spec is None:
        return None
    if spec.kind in ("error", "unavailable"):
        raise InjectedFault(point, spec.kind, spec.message)
    if spec.kind == "latency":
        plan.sleep(spec.latency_s)
    return spec


def notify(event: str, **info) -> int:
    """Controller-event hook for episode-relative specs: one global
    read when no plan is active, else :meth:`FaultPlan.notify`."""
    plan = _ACTIVE
    if plan is None:
        return 0
    return plan.notify(event, **info)


def note_load(load: float) -> None:
    """Offered-load hook for ``min_load`` specs (replay loops call
    this as the traffic model's rate moves)."""
    plan = _ACTIVE
    if plan is not None:
        plan.note_load(load)


# -- validation ----------------------------------------------------------
def _num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate_plan_dict(obj) -> List[str]:
    """Schema problems with one parsed fault-plan dict ([] = valid)."""
    problems = []
    if not isinstance(obj, dict):
        return [f"plan is {type(obj).__name__}, not an object"]
    for k in obj:
        if k not in _PLAN_KEYS:
            problems.append(f"unknown top-level key {k!r}")
    if "seed" in obj and (not isinstance(obj["seed"], int)
                          or isinstance(obj["seed"], bool)):
        problems.append("'seed' must be an integer")
    faults = obj.get("faults")
    if not isinstance(faults, list):
        return problems + ["missing/invalid required key 'faults' (list)"]
    for i, f in enumerate(faults):
        where = f"faults[{i}]"
        if not isinstance(f, dict):
            problems.append(f"{where}: not an object")
            continue
        for k in f:
            if k not in _SPEC_KEYS:
                problems.append(f"{where}: unknown key {k!r}")
        if not isinstance(f.get("point"), str) or not f.get("point"):
            problems.append(f"{where}: missing 'point' (string)")
        if f.get("kind") not in KINDS:
            problems.append(
                f"{where}: 'kind' must be one of {list(KINDS)}, "
                f"got {f.get('kind')!r}")
        if "prob" in f and not (_num(f["prob"])
                                and 0.0 <= f["prob"] <= 1.0):
            problems.append(f"{where}: 'prob' must be a number in [0, 1]")
        if "count" in f and f["count"] is not None and not (
                isinstance(f["count"], int)
                and not isinstance(f["count"], bool) and f["count"] >= 1):
            problems.append(f"{where}: 'count' must be an int >= 1")
        if "after_s" in f and not (_num(f["after_s"])
                                   and f["after_s"] >= 0):
            problems.append(f"{where}: 'after_s' must be a number >= 0")
        if "until_s" in f and f["until_s"] is not None:
            if not _num(f["until_s"]):
                problems.append(f"{where}: 'until_s' must be a number")
            elif _num(f.get("after_s", 0.0)) \
                    and f["until_s"] <= f.get("after_s", 0.0):
                problems.append(f"{where}: 'until_s' must be > 'after_s'")
        if "latency_s" in f and not (_num(f["latency_s"])
                                     and f["latency_s"] >= 0):
            problems.append(f"{where}: 'latency_s' must be a number >= 0")
        if f.get("kind") == "latency" and not _num(f.get("latency_s")):
            problems.append(
                f"{where}: kind 'latency' requires numeric 'latency_s'")
        if "message" in f and not isinstance(f["message"], str):
            problems.append(f"{where}: 'message' must be a string")
        if "skip" in f and not (isinstance(f["skip"], int)
                                and not isinstance(f["skip"], bool)
                                and f["skip"] >= 0):
            problems.append(f"{where}: 'skip' must be an int >= 0")
        has_event = "on_event" in f and f["on_event"] is not None
        if has_event and (not isinstance(f["on_event"], str)
                          or not f["on_event"]):
            problems.append(
                f"{where}: 'on_event' must be a non-empty string")
        if has_event and (("after_s" in f
                           and _num(f["after_s"]) and f["after_s"] > 0)
                          or f.get("until_s") is not None):
            # A spec scheduled against BOTH clocks is ambiguous: does
            # the wall window gate the armed window or replace it?
            problems.append(
                f"{where}: wall-clock ('after_s'/'until_s') and "
                f"episode ('on_event') triggers on the same spec")
        if "arm_for_s" in f and f["arm_for_s"] is not None:
            if not (_num(f["arm_for_s"]) and f["arm_for_s"] > 0):
                problems.append(
                    f"{where}: 'arm_for_s' must be a number > 0")
            elif not has_event:
                problems.append(
                    f"{where}: 'arm_for_s' requires 'on_event' "
                    f"(nothing arms the window)")
        if "target" in f and f["target"] is not None:
            if not isinstance(f["target"], str) or not f["target"]:
                problems.append(
                    f"{where}: 'target' must be a non-empty string")
            elif f["target"] == "@event" and not has_event:
                problems.append(
                    f"{where}: target '@event' requires 'on_event' "
                    f"(no event names the replica)")
        if "min_load" in f and f["min_load"] is not None \
                and not (_num(f["min_load"]) and f["min_load"] >= 0):
            problems.append(
                f"{where}: 'min_load' must be a number >= 0")
    return problems


def lint_plan_points(obj) -> List[str]:
    """Advisory warnings (never schema errors) for a VALID plan dict:
    injection points no call site is wired to, and caller-acted kinds
    scheduled at points whose call sites ignore them. A typo'd point
    silently never fires — worth a loud warning at lint time even
    though forward-written plans are legal."""
    warnings = []
    if not isinstance(obj, dict) or not isinstance(obj.get("faults"), list):
        return warnings
    acts_at = {"nan_grad": ("train.step",),
               "corrupt_batch": ("pipeline.materialize",),
               "partial_write": ("checkpoint.save", "journal.append",
                                 "transport.send")}
    for i, f in enumerate(obj["faults"]):
        if not isinstance(f, dict):
            continue
        point, kind = f.get("point"), f.get("kind")
        if isinstance(point, str) and point not in KNOWN_POINTS:
            warnings.append(
                f"faults[{i}]: point {point!r} is not wired into any "
                f"call site (known: {list(KNOWN_POINTS)})")
        if kind in acts_at and isinstance(point, str) \
                and point in KNOWN_POINTS and point not in acts_at[kind]:
            warnings.append(
                f"faults[{i}]: kind {kind!r} is only acted on at "
                f"{list(acts_at[kind])}; at {point!r} it fires but "
                f"nothing simulates the damage")
        ev = f.get("on_event")
        if isinstance(ev, str) and ev and ev not in KNOWN_EVENTS:
            warnings.append(
                f"faults[{i}]: on_event {ev!r} names a controller "
                f"event nothing is wired to emit (known: "
                f"{list(KNOWN_EVENTS)}) — the spec would stay armed "
                f"never")
    return warnings


# Env hook, mirroring obs.trace's DS2_TRACE: a fault plan can ride into
# any entry point without code changes.
_env_plan = os.environ.get("DS2_FAULT_PLAN")
if _env_plan:
    install(FaultPlan.from_json(_env_plan))
