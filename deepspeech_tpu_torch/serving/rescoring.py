"""Async LM rescoring: the fast-path/slow-path split.

The port's own copy of the JAX package's ``serving/rescoring.py``
(host-only: ``offer`` takes host lists and ``pump`` never touches the
card).

Deep Speech 2's accuracy lever on top of the acoustic model is an
external-LM second pass over the n-best list
(``decode/ngram.py:rescore_nbest``). Inline, that pass rides the
serving hot path — every request pays LM latency whether or not the
LM changes anything. This module moves it OFF the hot path: the first
pass (greedy/beam) returns to the caller at today's latency, and
completed results that carry an n-best list are enqueued into a
bounded :class:`RescoringQueue` drained by a :class:`RescoringPool`
of workers. When the LM pass promotes a different hypothesis, the
pool emits a :class:`RevisionEvent` — ``(rid, old_text, new_text,
score_delta, rescore_latency)`` — which ``serve.py`` streams as a
``{"revision": ...}`` JSONL line beside the original transcript and
the gateway surfaces via the ``on_revision`` callback.

Control-surface integration (the point of doing this in the serving
plane rather than as a batch job):

- **Admission**: rescoring work is charged as ``batch``-class
  tenancy (``tenancy=`` + ``tenant=``) — the class that sheds FIRST
  under brownout, so a second pass can never crowd out a first pass.
- **Brownout**: the controller's dedicated rescore rung
  (``BrownoutController(rescore_pressure=...)``,
  :meth:`~..resilience.brownout.BrownoutController.
  should_rescore`) disables rescoring *below* the first degradation
  level — quality-upgrade work is the first capability shed, before
  any first-pass degradation. Sheds are counted by reason
  (``rescore_shed{reason=...}``), never silently dropped.
- **Tracing**: each job gets its own :class:`~..obs.
  context.TraceContext` (trace id = the first-pass rid, ``kind:
  "rescore"``) with a ``rescore_queue`` / ``rescore_compute`` phase
  split, so "why did this revision arrive late" is answerable from
  the flight recorder without touching the first-pass ledger (whose
  phases must keep telescoping to the measured first-pass latency).
- **Metrics**: ``rescore_submitted`` / ``rescore_completed`` /
  ``rescore_shed`` / ``rescore_revised`` counters, the
  ``rescore_queue_depth`` gauge, and ``rescore_latency`` /
  ``revision_score_delta`` histograms.

The pool is **pump-driven and synchronous**, like every controller in
this plane (scheduler ``pump()``, rollout/autoscale ``tick()``): the
host decides when slow-path compute runs (between chunks, after a
flush, on an idle beat) and the injectable clock makes every replay
deterministic — two same-seed replays produce bit-identical revision
streams.
"Workers" are logical LM owners (``lm_factory`` is called once per
worker; jobs are assigned round-robin at submit time so the
job→worker mapping is replay-stable), not threads: LM scoring is
host-side and GIL-bound, so threads would add nondeterminism without
adding throughput.

``score_delta`` is the combined-score gain of the promoted hypothesis
over the first-pass text *under the same LM objective* — nonnegative
by construction (the promoted hypothesis is the argmax of a list that
contains the first-pass text).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from .. import obs
from ..decode.ngram import rescore_nbest
from ..obs.context import (PHASE_RESCORE_COMPUTE, PHASE_RESCORE_QUEUE,
                           FlightRecorder, TraceContext)
from .telemetry import ServingTelemetry
from .tenancy import TenantQuotaExceeded

NBest = Sequence[Tuple[str, float]]


@dataclasses.dataclass
class RevisionEvent:
    """One second-pass outcome that CHANGED the transcript."""

    rid: str                  # first-pass request id (or session sid)
    old_text: str             # what the first pass returned
    new_text: str             # what the LM pass promoted
    score_delta: float        # combined-score gain, >= 0 by argmax
    rescore_latency: float    # submit -> revision, clock units
    model: Optional[str] = None
    tenant: Optional[str] = None
    worker: int = 0

    def to_json(self) -> dict:
        """The ``{"revision": ...}`` JSONL payload (``rid`` and
        ``score_delta`` always, ``model`` whenever ``tenant`` rides)."""
        rec = {"rid": self.rid,
               "old_text": self.old_text,
               "new_text": self.new_text,
               "score_delta": round(self.score_delta, 6),
               "rescore_latency_ms": round(
                   self.rescore_latency * 1e3, 6)}
        if self.model is not None:
            rec["model"] = self.model
        if self.tenant is not None:
            rec["tenant"] = self.tenant
        return rec


@dataclasses.dataclass
class _Job:
    rid: str
    nbest: List[Tuple[str, float]]
    old_text: str
    submitted: float
    worker: int
    model: Optional[str] = None
    tenant: Optional[str] = None
    charged: bool = False
    ctx: Optional[TraceContext] = None


class RescoringQueue:
    """Bounded FIFO of pending rescore jobs. ``offer`` never blocks —
    a full queue refuses (the caller counts the shed); the first pass
    must never wait on the second."""

    def __init__(self, max_depth: int = 64):
        if max_depth < 1:
            raise ValueError("max_depth >= 1")
        self.max_depth = max_depth
        self._q: Deque[_Job] = deque()

    def offer(self, job: _Job) -> bool:
        if len(self._q) >= self.max_depth:
            return False
        self._q.append(job)
        return True

    def pop(self) -> Optional[_Job]:
        return self._q.popleft() if self._q else None

    def __len__(self) -> int:
        return len(self._q)


class RescoringPool:
    """See module docstring. Typical wiring::

        pool = RescoringPool(lm=load_lm(path), alpha=a, beta=b,
                             telemetry=tel, brownout=ctrl,
                             on_revision=emit_jsonl)
        ...
        pool.offer(rid, nbest, old_text)   # O(1), on the hot path
        ...
        pool.pump()                        # off the hot path
    """

    def __init__(self, lm=None, *,
                 lm_factory: Optional[Callable[[], object]] = None,
                 alpha: float = 0.5, beta: float = 0.0,
                 workers: int = 1, max_queue: int = 64,
                 to_lm_text: Optional[Callable[[str], str]] = None,
                 telemetry: Optional[ServingTelemetry] = None,
                 brownout=None, tenancy=None, tenant: str = "rescore",
                 clock: Callable[[], float] = time.monotonic,
                 flight_recorder: Optional[FlightRecorder] = None,
                 on_revision: Optional[
                     Callable[[RevisionEvent], None]] = None):
        if (lm is None) == (lm_factory is None):
            raise ValueError("RescoringPool takes exactly one of lm= "
                             "(shared) or lm_factory= (one per worker)")
        if workers < 1:
            raise ValueError("workers >= 1")
        # Each logical worker owns an LM (kenlm state is not
        # thread-safe and a per-worker LM is how a real slow-path
        # fleet shards anyway); a shared lm= serves every worker.
        self._lms = ([lm_factory() for _ in range(workers)]
                     if lm_factory is not None else [lm] * workers)
        self.workers = workers
        self.alpha = alpha
        self.beta = beta
        self.to_lm_text = to_lm_text
        self.queue = RescoringQueue(max_depth=max_queue)
        self.telemetry = telemetry if telemetry is not None \
            else ServingTelemetry()
        self.brownout = brownout
        self.tenancy = tenancy
        self.tenant = tenant
        self.clock = clock
        self.flight_recorder = flight_recorder \
            if flight_recorder is not None else obs.flight_recorder()
        self.on_revision = on_revision
        self._seq = 0
        self.submitted = 0
        self.completed = 0
        self.revised = 0
        self.shed: Dict[str, int] = {}

    # -- the hot-path side ----------------------------------------------
    def _shed(self, reason: str, model: Optional[str]) -> None:
        self.shed[reason] = self.shed.get(reason, 0) + 1
        labels = {"reason": reason}
        if model is not None:
            labels["model"] = model
        self.telemetry.count("rescore_shed", labels=labels)

    def offer(self, rid: str, nbest: NBest,
              old_text: Optional[str] = None, *,
              model: Optional[str] = None,
              tenant: Optional[str] = None,
              now: Optional[float] = None) -> bool:
        """Enqueue one completed first-pass result for a second pass.
        O(1) and never raises toward the caller: every refusal is a
        counted shed (``rescore_shed{reason=...}``). Returns whether
        the job was accepted. ``old_text`` defaults to the n-best
        head; ``tenant`` is the ORIGINATING tenant (attribution only
        — the quota charged is this pool's own batch-class
        ``self.tenant``)."""
        now = self.clock() if now is None else now
        nbest = [(str(t), float(s)) for t, s in (nbest or [])]
        if not nbest:
            self._shed("empty_nbest", model)
            return False
        if self.brownout is not None \
                and not self.brownout.should_rescore():
            self._shed("brownout", model)
            return False
        charged = False
        if self.tenancy is not None:
            # Brownout shed order: batch class goes first. The
            # controller's rescore rung usually fires earlier, but a
            # tenancy-only deployment still sheds here.
            if self.brownout is not None and self.tenancy.sheds_at(
                    self.tenant, self.brownout.level):
                self._shed("brownout", model)
                return False
            try:
                self.tenancy.charge(self.tenant)
                charged = True
            except (TenantQuotaExceeded, KeyError):
                self._shed("quota", model)
                return False
        job = _Job(rid=rid, nbest=nbest,
                   old_text=(old_text if old_text is not None
                             else nbest[0][0]),
                   submitted=now, worker=self._seq % self.workers,
                   model=model, tenant=tenant, charged=charged)
        if not self.queue.offer(job):
            if charged:
                self.tenancy.release(self.tenant)
            self._shed("queue_full", model)
            return False
        self._seq += 1
        # A rescore-scoped ledger, NOT the first-pass one: the
        # first-pass context already closed with phases telescoping to
        # the first-pass latency, and must stay that way.
        ctx = TraceContext(rid, now, kind="rescore", model=model,
                           tenant=tenant, worker=job.worker)
        ctx.to(PHASE_RESCORE_QUEUE, now)
        job.ctx = ctx
        self.submitted += 1
        labels = {"model": model} if model is not None else None
        self.telemetry.count("rescore_submitted", labels=labels)
        self.telemetry.gauge("rescore_queue_depth", len(self.queue))
        return True

    # -- the slow-path side ---------------------------------------------
    def _rescore(self, job: _Job,
                 now: float) -> Optional[RevisionEvent]:
        lm = self._lms[job.worker]
        rescored = rescore_nbest(job.nbest, lm, self.alpha, self.beta,
                                 to_lm_text=self.to_lm_text)
        new_text, new_score = rescored[0]
        # The first-pass text scored under the SAME objective — it is
        # in the list, so the delta is >= 0 by argmax. (A first-pass
        # text missing from its own n-best — segment joins — falls
        # back to the n-best head's rescored score.)
        old_score = next(
            (s for t, s in rescored if t == job.old_text),
            next(s for t, s in rescored if t == job.nbest[0][0]))
        if new_text == job.old_text:
            return None
        return RevisionEvent(
            rid=job.rid, old_text=job.old_text, new_text=new_text,
            score_delta=new_score - old_score,
            rescore_latency=now - job.submitted, model=job.model,
            tenant=job.tenant, worker=job.worker)

    def pump(self, now: Optional[float] = None,
             max_jobs: Optional[int] = None) -> List[RevisionEvent]:
        """Run pending jobs (all of them, or at most ``max_jobs``)
        and return the revisions they produced. Safe to call on an
        empty queue; the caller decides the cadence."""
        out: List[RevisionEvent] = []
        n = 0
        while max_jobs is None or n < max_jobs:
            job = self.queue.pop()
            if job is None:
                break
            n += 1
            t_c = self.clock() if now is None else now
            if job.ctx is not None:
                job.ctx.to(PHASE_RESCORE_COMPUTE, t_c)
            ev = self._rescore(job, t_c)
            t_done = self.clock() if now is None else now
            labels = {"model": job.model} \
                if job.model is not None else None
            self.completed += 1
            self.telemetry.count("rescore_completed", labels=labels)
            self.telemetry.observe("rescore_latency",
                                   t_done - job.submitted,
                                   labels=labels, exemplar=job.rid)
            if ev is not None:
                ev.rescore_latency = t_done - job.submitted
                self.revised += 1
                self.telemetry.count("rescore_revised", labels=labels)
                self.telemetry.observe("revision_score_delta",
                                       ev.score_delta, labels=labels,
                                       exemplar=job.rid)
                if self.on_revision is not None:
                    self.on_revision(ev)
                out.append(ev)
            if job.ctx is not None:
                job.ctx.note(revised=ev is not None)
                job.ctx.finish(t_done, "ok")
                rec = job.ctx.summary()
                self.flight_recorder.record(rec)
                obs.tracer.emit(rec)
            if job.charged:
                self.tenancy.release(self.tenant)
        self.telemetry.gauge("rescore_queue_depth", len(self.queue))
        return out

    def drain(self, now: Optional[float] = None) -> List[RevisionEvent]:
        """Pump until the queue is empty."""
        out: List[RevisionEvent] = []
        while len(self.queue):
            out.extend(self.pump(now=now))
        return out

    @property
    def depth(self) -> int:
        return len(self.queue)

    def stats(self) -> dict:
        return {"submitted": self.submitted,
                "completed": self.completed,
                "revised": self.revised,
                "shed": dict(self.shed),
                "queue_depth": len(self.queue),
                "workers": self.workers}
