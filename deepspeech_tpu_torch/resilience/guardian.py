"""Training guardian: numerical guardrails and an anomaly recovery ladder.

The port's copy of the JAX package's ``resilience/guardian.py``. CTC/RNN
training at Deep Speech 2 scale diverges in practice (NaN losses,
exploding gradients, corrupt batches, wedged devices) and an unguarded
loop dies on the first one. The guardian turns each into a bounded,
audited recovery:

1. **Health scalars, on the device.** The guarded step
   (``Trainer.train_step`` with ``train.guardian``) computes the loss's
   finiteness, the global gradient norm and the update norm alongside
   the update, and gates the state transition on the device: a
   non-finite step leaves the parameters, the optimizer state and the BN
   statistics as they were, bit for bit, so a skipped batch is a true
   no-op.
2. **Classification.** Each step is ``ok``, ``soft`` (finite, but the
   gradient norm is ``soft_grad_factor`` times the rolling median kept
   in the ``obs`` registry) or ``hard`` (a non-finite loss, gradient
   norm or update norm).
3. **Policy ladder.** Hard: skip the batch (already gated on the
   device; count-capped). Soft: back the rate off, ``lr_scale`` times
   ``backoff_factor``, recovering after ``recovery_steps`` clean steps.
   Too many consecutive skips: **rollback** to the newest entry of the
   ``CheckpointManager`` last-good ring, the data stream going on past
   the poison window.
4. **Stall watchdog.** A heartbeat thread detects a wedged step (no
   heartbeat within ``k`` times the p95 step time of the ``obs``
   ``train.step_s`` histogram), dumps every thread's stack and a metrics
   snapshot into a postmortem, and triggers the ``PreemptionGuard``
   emergency-checkpoint path instead of hanging.

Every intervention writes a :mod:`postmortem` record and counts in the
registry (``guardian_skipped_batches``, ``guardian_soft_anomalies``,
``guardian_rollbacks``, ``guardian_snapshots``,
``stall_watchdog_fires``). The knobs ride ``DS2_GUARDIAN`` (``1`` =
defaults, a JSON object or a path to one = overrides; see
:class:`GuardianConfig`); the ``nan_grad`` and ``corrupt_batch`` fault
kinds drive it in tests. Off (the default), the training loop's only
cost is one ``is not None`` test a step.
"""

from __future__ import annotations

import json
import math
import os
import sys
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import obs
from ..obs import timeline as _timeline
from . import postmortem as _postmortem_mod

GRAD_HIST = "guardian.grad_norm"
STEP_HIST = "train.step_s"


class GuardianHalt(RuntimeError):
    """Recovery budget exhausted (or no snapshot to roll back to) —
    the run is genuinely unhealthy and should stop loudly."""


@dataclass(frozen=True)
class GuardianConfig:
    """Knobs for the policy ladder. ``DS2_GUARDIAN`` accepts ``1`` /
    ``true`` (defaults), ``0`` / empty (disabled), an inline JSON
    object, or a path to a JSON file with any subset of these fields.
    """

    # -- classification --
    # Finite steps whose grad-norm exceeds factor * rolling median are
    # soft anomalies; the median comes from the ok-step history in the
    # registry's GRAD_HIST histogram.
    soft_grad_factor: float = 10.0
    # Ok steps observed before the rolling stats are trusted (a cold
    # median over 2 samples would flag normal variation).
    stats_warmup_steps: int = 20
    # -- skip ladder --
    max_skips: int = 16              # total skip budget between rollbacks
    max_consecutive_skips: int = 2   # beyond this -> rollback
    # -- LR backoff --
    backoff_factor: float = 0.5
    min_lr_scale: float = 0.0625
    recovery_steps: int = 20         # clean steps to step the scale back up
    # -- rollback --
    snapshot_every: int = 25         # applied steps between ring snapshots
    ring_size: int = 2               # last-good ring bound (CheckpointManager)
    max_rollbacks: int = 4           # beyond this -> GuardianHalt
    # -- stall watchdog --
    watchdog: bool = True
    watchdog_k: float = 10.0         # timeout = k * p95 step time
    watchdog_min_s: float = 30.0     # timeout floor (covers compiles)
    watchdog_poll_s: float = 1.0

    @classmethod
    def from_env(cls, var: str = "DS2_GUARDIAN"
                 ) -> Optional["GuardianConfig"]:
        """None when the env disables the guardian; a config otherwise."""
        raw = os.environ.get(var, "").strip()
        if not raw or raw.lower() in ("0", "false", "off", "no"):
            return None
        if raw.lower() in ("1", "true", "on", "yes"):
            return cls()
        obj = json.loads(raw) if raw.lstrip().startswith("{") else \
            json.load(open(raw))
        return cls(**obj)


@dataclass
class GuardianDecision:
    """What ``Trainer.fit`` should do with the step just observed."""

    action: str     # "ok" | "backoff" | "skip" | "rollback"
    classify: str   # "ok" | "soft" | "hard"
    trigger: str = ""


class TrainingGuardian:
    """Per-step health classification + the recovery ladder.

    The guardian is host-side and synchronous: ``observe_step`` reads
    the guarded step's metrics (forcing the device sync the enabled
    path accepts), classifies, and tells the loop what to do. Rolling
    grad-norm statistics live in the metrics registry (GRAD_HIST) so
    they ride every snapshot/export for free.
    """

    def __init__(self, cfg: Optional[GuardianConfig] = None, *,
                 ckpt=None, registry=None, postmortem=None):
        self.cfg = cfg if cfg is not None else GuardianConfig()
        self.ckpt = ckpt
        self._registry = registry
        self._pm = postmortem
        self.lr_scale = 1.0
        self.total_skips = 0
        self.skips_since_rollback = 0
        self.consecutive_skips = 0
        self.soft_anomalies = 0
        self.rollbacks = 0
        self.ok_streak = 0
        self.steps_seen = 0
        # Fleet-timeline seq of the newest skip — the causal parent
        # of the rollback it may escalate into.
        self._last_skip_seq: Optional[int] = None
        # Batch ordinals whose updates currently stand (rollback
        # truncates) — the surviving-batch list a bit-identity check
        # replays.
        self.applied: List[int] = []

    def _reg(self):
        return self._registry if self._registry is not None \
            else obs.registry()

    def _postmortem(self):
        return self._pm if self._pm is not None \
            else _postmortem_mod.writer()

    # -- classification -------------------------------------------------
    def classify(self, loss: float, grad_norm: float,
                 update_norm: float) -> Tuple[str, str]:
        for name, v in (("loss", loss), ("grad_norm", grad_norm),
                        ("update_norm", update_norm)):
            if not math.isfinite(v):
                return "hard", f"nonfinite_{name}"
        if len(self.applied) >= self.cfg.stats_warmup_steps:
            hist = self._reg().hists.get(GRAD_HIST)
            med = hist.percentile(50) if hist is not None else None
            if med is not None and med > 0 \
                    and grad_norm > self.cfg.soft_grad_factor * med:
                return "soft", "grad_norm_spike"
        return "ok", ""

    # -- the per-step hook ----------------------------------------------
    def observe_step(self, step: int, batch_idx: int,
                     metrics: Dict[str, Any]) -> GuardianDecision:
        """Classify one guarded step and advance the ladder. ``step``
        is the device step the batch would have applied at; ``batch_idx``
        is the ordinal of the batch within the run's data stream."""
        loss = float(metrics["loss"])
        grad_norm = float(metrics["grad_norm"])
        update_norm = float(metrics["update_norm"])
        self.steps_seen += 1
        cls, trigger = self.classify(loss, grad_norm, update_norm)
        if cls == "hard":
            self.total_skips += 1
            self.skips_since_rollback += 1
            self.consecutive_skips += 1
            self.ok_streak = 0
            self._reg().count("guardian_skipped_batches")
            self._last_skip_seq = _timeline.publish(
                "guardian_skip", "guardian", trigger=trigger,
                step=int(step), batch=int(batch_idx),
                consecutive=self.consecutive_skips)
            self._postmortem().write(
                "anomaly", trigger, step=int(step), batch=int(batch_idx),
                loss=loss, grad_norm=grad_norm, update_norm=update_norm,
                consecutive=self.consecutive_skips)
            cfg = self.cfg
            if (self.consecutive_skips > cfg.max_consecutive_skips
                    or self.skips_since_rollback > cfg.max_skips):
                return GuardianDecision("rollback", cls, trigger)
            return GuardianDecision("skip", cls, trigger)
        # Finite step: the update stood (the on-device gate applied it).
        self.consecutive_skips = 0
        self.applied.append(int(batch_idx))
        if cls == "soft":
            self.soft_anomalies += 1
            self.ok_streak = 0
            self.lr_scale = max(self.lr_scale * self.cfg.backoff_factor,
                                self.cfg.min_lr_scale)
            self._reg().count("guardian_soft_anomalies")
            self._reg().gauge("guardian_lr_scale", self.lr_scale)
            self._postmortem().write(
                "anomaly", trigger, step=int(step), batch=int(batch_idx),
                loss=loss, grad_norm=grad_norm, update_norm=update_norm,
                lr_scale=self.lr_scale)
            return GuardianDecision("backoff", cls, trigger)
        self.ok_streak += 1
        if self.lr_scale < 1.0 and self.ok_streak >= self.cfg.recovery_steps:
            self.lr_scale = min(1.0,
                                self.lr_scale / self.cfg.backoff_factor)
            self.ok_streak = 0
            self._reg().gauge("guardian_lr_scale", self.lr_scale)
        self._reg().observe(GRAD_HIST, grad_norm)
        return GuardianDecision("ok", "ok", "")

    # -- snapshots + rollback -------------------------------------------
    def snapshot(self, step: int, state: Any) -> bool:
        """Push ``state`` into the last-good ring (host copy)."""
        if self.ckpt is None:
            return False
        self.ckpt.save_last_good(int(step), state,
                                 meta={"applied_len": len(self.applied)})
        self._reg().count("guardian_snapshots")
        return True

    def maybe_snapshot(self, step: int, state: Any) -> bool:
        """Ring snapshot at the configured applied-step cadence."""
        if self.ckpt is None or self.cfg.snapshot_every <= 0:
            return False
        if len(self.applied) % self.cfg.snapshot_every:
            return False
        return self.snapshot(step, state)

    def rollback(self, trigger: str = "") -> Tuple[int, Any]:
        """Restore the newest last-good snapshot; returns
        ``(step, host_state)`` for the loop to load. On-disk
        checkpoints newer than the snapshot are marked rejected (they
        may embed the poisoned regime) so a later ``restore()`` walks
        past them. Raises :class:`GuardianHalt` when the rollback
        budget is spent or no snapshot exists."""
        self.rollbacks += 1
        if self.rollbacks > self.cfg.max_rollbacks:
            raise GuardianHalt(
                f"rollback budget exhausted ({self.cfg.max_rollbacks}); "
                f"training is not recovering")
        if self.ckpt is None:
            raise GuardianHalt(
                "rollback needed but no CheckpointManager (set "
                "train.checkpoint_dir)")
        snap = self.ckpt.restore_last_good()
        if snap is None:
            raise GuardianHalt("rollback needed but the last-good ring "
                               "is empty")
        step, state, meta = snap
        applied_len = int((meta or {}).get("applied_len",
                                           len(self.applied)))
        dropped = len(self.applied) - applied_len
        del self.applied[applied_len:]
        self.skips_since_rollback = 0
        self.consecutive_skips = 0
        self.ok_streak = 0
        self._reg().count("guardian_rollbacks")
        _timeline.publish(
            "guardian_rollback", "guardian",
            cause_seq=self._last_skip_seq, trigger=trigger,
            to_step=int(step), dropped_applied_steps=int(dropped))
        self._postmortem().write(
            "rollback", trigger, to_step=int(step),
            dropped_applied_steps=int(dropped),
            skipped_total=self.total_skips)
        for s in self.ckpt.all_steps():
            if s > step:
                self.ckpt.mark_rejected(s)
        return int(step), state

    def report(self) -> Dict[str, Any]:
        return {"steps_seen": self.steps_seen,
                "applied_steps": len(self.applied),
                "skipped_batches": self.total_skips,
                "soft_anomalies": self.soft_anomalies,
                "rollbacks": self.rollbacks,
                "lr_scale": self.lr_scale}


def dump_all_stacks() -> Dict[str, List[str]]:
    """Formatted stacks of every live thread, keyed ``name:ident`` —
    the watchdog's evidence of where a wedged run was stuck."""
    names = {t.ident: t.name for t in threading.enumerate()}
    return {
        f"{names.get(tid, '?')}:{tid}": traceback.format_stack(frame)
        for tid, frame in sys._current_frames().items()}


class StallWatchdog:
    """Heartbeat watchdog for a wedged training step.

    ``heartbeat()`` is called once per step by the loop; a background
    thread checks that the latest beat is no older than
    ``max(k * p95_step_time, min_timeout_s)``, with the p95 fed from
    the obs ``train.step_s`` histogram (so the timeout tracks the
    workload instead of a magic constant). One fire per wedge: the
    watchdog dumps all-thread stacks + a metrics snapshot into a
    ``stall`` postmortem, counts ``stall_watchdog_fires``, and triggers
    the :class:`~.preempt.PreemptionGuard` so the loop's existing
    emergency-checkpoint path runs if the step ever completes — and the
    evidence survives even if it never does. ``clock`` is injectable;
    ``check()`` runs one poll synchronously for tests.
    """

    def __init__(self, *, k: float = 10.0, min_timeout_s: float = 30.0,
                 poll_s: float = 1.0, hist: str = STEP_HIST,
                 registry=None, postmortem=None, preempt=None,
                 clock: Callable[[], float] = time.monotonic):
        self.k = k
        self.min_timeout_s = min_timeout_s
        self.poll_s = poll_s
        self.hist = hist
        self._registry = registry
        self._pm = postmortem
        self.preempt = preempt
        self.clock = clock
        self._beat: Optional[float] = None
        self._fired_for: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _reg(self):
        return self._registry if self._registry is not None \
            else obs.registry()

    def _postmortem(self):
        return self._pm if self._pm is not None \
            else _postmortem_mod.writer()

    def heartbeat(self, now: Optional[float] = None) -> None:
        self._beat = self.clock() if now is None else now

    def timeout_s(self) -> float:
        hist = self._reg().hists.get(self.hist)
        p95 = hist.percentile(95) if hist is not None else None
        if p95 is None:
            return self.min_timeout_s
        return max(self.k * p95, self.min_timeout_s)

    def check(self, now: Optional[float] = None) -> bool:
        """One poll: fire (once per wedge) if the heartbeat is stale."""
        now = self.clock() if now is None else now
        beat = self._beat
        if beat is None or self._fired_for == beat:
            return False
        stalled = now - beat
        if stalled <= self.timeout_s():
            return False
        self._fired_for = beat
        self._reg().count("stall_watchdog_fires")
        self._postmortem().write(
            "stall", "no_heartbeat", stalled_s=round(stalled, 3),
            timeout_s=round(self.timeout_s(), 3),
            stacks=dump_all_stacks(), metrics=self._reg().snapshot())
        if self.preempt is not None:
            self.preempt.trigger()
        return True

    def start(self) -> "StallWatchdog":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="stall-watchdog")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.check()
            except Exception:
                # The watchdog must never take the training loop down.
                pass

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def __enter__(self) -> "StallWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
