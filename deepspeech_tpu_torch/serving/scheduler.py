"""Deadline-aware dynamic micro-batcher for offline transcribe requests.

The port's own copy of the JAX package's ``serving/scheduler.py``, the
gateway: the same admissions, flushes, retries and results on the same
request trace. Independent requests arrive one at a time; the model
wants ladder-shaped ``(B, T)`` batches (data/infer_bucket.py). This
scheduler is the layer between: it admits requests into per-T-rung
queues and flushes rung-shaped micro-batches under two rules —

- **rung-full**: a T rung holding ``max_batch`` requests flushes
  immediately (best occupancy, zero added latency);
- **oldest-deadline**: when the oldest pending request's deadline is
  within ``flush_slack`` of now, its rung flushes partial rather than
  letting the deadline slip waiting for peers.

A deadline flush pads its row count to the batch rung anyway
(``batch_rung``), so the padded rows are computed regardless — the
scheduler therefore *fills* them with the most urgent pending requests
from SMALLER T rungs (their frames fit the flushing rung by
construction). Filling free rows is free compute: strictly less padding
waste and strictly less queueing latency than leaving them queued.

Admission control is a bounded queue: past ``max_queue`` pending
requests, ``submit`` raises :class:`OverloadRejected` — explicit
backpressure instead of unbounded memory growth and silently blown
deadlines. Each request also carries a queue ``timeout``; requests
that expire before dispatch are failed as ``"timeout"`` (never
decoded). The expiry scan runs on submit, poll, and flush, so even an
idle gateway fails timed-out requests promptly.

Failure handling (``resilience/``):

- a micro-batch whose decode raises is retried with exponential
  backoff (``retry_backoff`` policy; requests carry a ``not_before``
  and are invisible to the flush rules until it passes);
- a failed batch of more than one request is **quarantined**: each
  request retries as a singleton micro-batch, so one poison request
  exhausts its own ``max_attempts`` and fails alone instead of
  re-killing its batchmates;
- an optional :class:`~..resilience.CircuitBreaker` guards the
  backend: while open, due batches are deferred (requeued WITHOUT
  burning attempts — the backend is known-bad, the requests aren't)
  until the cooldown admits a half-open probe;
- an optional :class:`~..resilience.BrownoutController` watches queue
  pressure — and device pressure too, when constructed with
  ``device_budget_s`` and ``registry=telemetry``: every dispatch
  records its wall time in the ``gateway.dispatch_s`` histogram, whose
  p95-over-budget feeds the controller. Sustained pressure halves the
  flush rung (lower latency, lower occupancy) and, at brownout level,
  sheds new admissions while the backlog drains;
- a request quarantined after a multi-request batch failure also
  writes a ``quarantined_request`` postmortem record
  (``resilience.postmortem``) and counts ``postmortems_written`` in
  telemetry — the same audit trail the data pipeline's corrupt-sample
  quarantine feeds;
- the ``gateway.dispatch`` fault-injection point
  (``resilience.faults``) sits inside the decode try block, so a fault
  plan exercises exactly these paths.

The scheduler's *state* is synchronous and single-threaded by design —
the gateway loop is one host thread, and an injectable ``clock`` makes
every flush rule deterministic under test. Decode is delegated:
``decode_fn(batch, plan) -> texts`` where ``plan`` is the
:class:`~..data.infer_bucket.InferBucketPlan` the batch was shaped by
(``Inferencer.decode_batch_bucketed(batch, plans=[plan])`` is the
intended consumer).

Multi-replica mode: constructed with a :class:`~.pool.ReplicaPool`,
the ``submit``/``poll`` surface is unchanged but dispatch routes
through the pool — each due micro-batch goes to the least-loaded
routable replica (its own breaker gating it, its own labeled telemetry
recording it), and :meth:`MicroBatchScheduler.dispatch_many` fans the
due set out with one worker thread per involved replica. Only
``Replica.decode`` runs off the main thread: each CUDA replica decodes
on a stream of its own, and a ctypes kernel call, like PyTorch's
launches and copies, releases the GIL, so replicas overlap on the
card. Routing, admission bookkeeping, and result finalization stay
serial, and one replica's batches serialize on its thread — scheduler
state is never mutated concurrently.

An optional ``rung_of(feat_len)`` hook overrides the T-rung choice —
e.g. promote a cold exact rung to an already-warm neighbour using
``ShapeBucketCache.rung_usage()`` feedback (see
:func:`warm_rung_chooser`).

Quality tiers: ``submit(..., tier="premium"|"bulk")`` tags a request
with the serving tier it paid for — ``premium`` is the bf16 path,
``bulk`` the int8 path (weight-only PTQ, ``utils/quantize.py``).
Pending queues are keyed per (tier, T rung) so every micro-batch is
tier-homogeneous (free-row fill only donates within the same tier),
dispatch routes ``pool.route(tier=...)`` so a batch only lands on a
replica that serves its tier, and ``tier_max_batch`` gives each tier
its own flush cap. Terminal metrics (``requests_*``, ``latency_*``,
``slo_ok``/``slo_miss``) carry a ``tier`` label for tiered requests
and stay unlabeled for tierless ones — all-or-nothing per deployment,
the same family rule as for ``replica``. Under brownout (level >=
degraded) newly submitted premium requests are downgraded to bulk
(``BrownoutController.effective_tier``), counted as
``tier_degraded{tier="premium"}``, and recover automatically once the
level drops.

Request tracing: every ``submit`` opens a :class:`~..obs.TraceContext`
(trace id = the scheduler ``rid``) whose phase ledger follows the
request through queue wait, breaker deferral, retry backoff, and
decode; ``_finish`` closes it on the same clock value as the result
latency, so the phases sum to the measured latency exactly. Finished
summaries land in the scheduler's :class:`~..obs.FlightRecorder` ring
and — when tracing is enabled — as ``{"event": "trace"}`` JSONL
records. The terminal latency histograms carry the slowest request's
rid as a ``max_exemplar``.

Per-tenant admission (``tenancy=``, :mod:`.tenancy`) charges each
request against its tenant's quota, inherits the tenant's priority-class
deadline and tier, stages brownout sheds by class, and picks flushes
weighted-fair over tenants. The asynchronous LM second pass
(``rescorer=``, :mod:`.rescoring`) is offered every ok result that
carries an n-best (the ``(texts, nbest)`` decode contract of
``Replica.from_inferencer(nbest=True)``).
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import obs
from ..data.infer_bucket import (InferBucketPlan, batch_rung, frame_rung,
                                 padding_waste)
from ..obs.context import (PHASE_BACKOFF, PHASE_BREAKER, PHASE_DECODE,
                           FlightRecorder, TraceContext)
from ..obs.slo import slim_trace
from ..resilience import BrownoutController, CircuitBreaker, Retry
from ..resilience import faults
from ..resilience import postmortem as _postmortem
from ..resilience.retry import STATE_OPEN
from .telemetry import ServingTelemetry


class OverloadRejected(RuntimeError):
    """Bounded admission queue is full — shed load explicitly."""


@dataclass
class _Request:
    rid: str
    features: np.ndarray  # [T, F]
    feat_len: int
    t_rung: int
    submitted: float
    deadline: float
    timeout: Optional[float]
    attempts: int = 0
    # Retry backoff: invisible to flush rules until the clock passes.
    not_before: float = 0.0
    # Quarantined after a multi-request batch failure: retries alone.
    solo: bool = False
    # Serving quality tier ("premium" | "bulk"); None = tierless.
    tier: Optional[str] = None
    # Model group this request decodes on (serving/registry.py);
    # None = single-model deployment.
    model: Optional[str] = None
    # Paying tenant (serving/tenancy.py); None = unmetered traffic.
    tenant: Optional[str] = None
    # Request-scoped phase ledger (obs/context.py), created at submit.
    ctx: Optional[TraceContext] = None


@dataclass
class GatewayResult:
    """Terminal state of one request."""

    rid: str
    status: str  # "ok" | "timeout" | "error"
    text: Optional[str] = None
    latency: Optional[float] = None  # clock units, submit -> completion
    attempts: int = 0
    error: Optional[str] = None
    # Per-request n-best [(text, score), ...] when the backend
    # returned one (decode_fn contract: (texts, nbest) tuple; see
    # Replica.from_inferencer(nbest=True)) — the feed for the async
    # rescoring plane (serving/rescoring.py). ``text`` stays the
    # n-best head, so callers ignoring this field see no change.
    nbest: Optional[List[Tuple[str, float]]] = None


@dataclass
class MicroBatch:
    """One ladder-shaped dispatch unit."""

    requests: List[_Request]
    t_rung: int
    reason: str  # "full" | "deadline" | "drain" | "quarantine"
    max_batch: int
    # Tier-homogeneous by construction: every request in the batch
    # shares this tier (None = tierless), and dispatch routes it only
    # to replicas that serve it.
    tier: Optional[str] = None
    # Model-homogeneous the same way: pending queues are keyed per
    # (model, tier), so a batch never mixes models and dispatch routes
    # it only to the model's own replica group. Tenants MAY mix within
    # a batch — they share the weights; fairness is an admission and
    # dequeue-order property, not a batch-shape one.
    model: Optional[str] = None

    @property
    def b_rung(self) -> int:
        return batch_rung(len(self.requests), self.max_batch)

    @property
    def occupancy(self) -> float:
        return len(self.requests) / self.b_rung

    def plan(self) -> InferBucketPlan:
        return InferBucketPlan(
            indices=np.arange(len(self.requests), dtype=np.int64),
            batch_pad=self.b_rung, bucket_frames=self.t_rung)

    def batch(self) -> Dict[str, np.ndarray]:
        """Assemble the host batch at exactly the T rung; row padding
        to the B rung happens in ``slice_to_plan`` via the plan."""
        n = len(self.requests)
        f = self.requests[0].features.shape[-1]
        feats = np.zeros((n, self.t_rung, f), np.float32)
        lens = np.zeros((n,), np.int32)
        for i, r in enumerate(self.requests):
            t = min(r.feat_len, self.t_rung)
            feats[i, :t] = r.features[:t]
            lens[i] = t
        return {"features": feats, "feat_lens": lens}

    def padding_waste(self) -> float:
        return padding_waste([r.feat_len for r in self.requests],
                             [self.plan()])


def _split_decode_result(res):
    """Normalize a backend decode result. The decode_fn contract is
    ``List[str]`` texts, optionally ``(texts, nbest)`` where ``nbest``
    is one ``[(text, score), ...]`` list per row — the second form
    feeds :class:`GatewayResult.nbest` for the async rescoring plane
    without changing any texts-only caller."""
    if isinstance(res, tuple) and len(res) == 2:
        texts, nbest = res
        return list(texts), nbest
    return res, None


def warm_rung_chooser(bucket_frames: Sequence[int],
                      usage_fn: Callable[[], Dict[tuple, int]],
                      max_frames_over: float = 0.5
                      ) -> Callable[[int], int]:
    """Rung-choice hook: prefer an already-compiled T rung over a cold
    exact one when the extra padding is bounded.

    ``usage_fn`` supplies live rung-usage feedback (typically
    ``ShapeBucketCache.rung_usage``); a request whose exact rung has
    never been compiled is promoted to the next warm rung up if that
    costs at most ``max_frames_over`` extra relative frame padding —
    on live traffic a bounded padding hit beats a first-use stall.
    """
    edges = sorted(bucket_frames)

    def choose(feat_len: int) -> int:
        exact = frame_rung(feat_len, edges)
        warm_t = {t for (_, t) in usage_fn()}
        if exact in warm_t:
            return exact
        for t in edges:
            if t > exact and t in warm_t and t <= exact * (
                    1.0 + max_frames_over):
                return t
        return exact

    return choose


class MicroBatchScheduler:
    """See module docstring. Typical pump loop::

        sched = MicroBatchScheduler(cfg.data.bucket_frames,
                                    cfg.data.batch_size)
        rid = sched.submit(feats, feat_len, deadline=0.1)   # may raise
        for mb in sched.poll():                  # due micro-batches
            sched.dispatch(mb, decode_fn)
        sched.drain(decode_fn)                   # flush the tail
        result = sched.results[rid]
    """

    def __init__(self, bucket_frames: Sequence[int], max_batch: int, *,
                 max_queue: int = 256, flush_slack: float = 0.0,
                 default_deadline: float = 0.1,
                 default_timeout: Optional[float] = 30.0,
                 max_attempts: int = 2,
                 clock: Callable[[], float] = time.monotonic,
                 rung_of: Optional[Callable[[int], int]] = None,
                 telemetry: Optional[ServingTelemetry] = None,
                 retry_backoff: Optional[Retry] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 brownout: Optional[BrownoutController] = None,
                 pool=None,
                 registry=None,
                 tenancy=None,
                 tier_max_batch: Optional[Dict[str, int]] = None,
                 flight_recorder: Optional[FlightRecorder] = None,
                 rescorer=None):
        if max_batch < 1 or max_queue < 1 or max_attempts < 1:
            raise ValueError("max_batch, max_queue, max_attempts >= 1")
        self.bucket_frames = tuple(sorted(bucket_frames))
        self.max_batch = max_batch
        self.max_queue = max_queue
        self.flush_slack = flush_slack
        self.default_deadline = default_deadline
        self.default_timeout = default_timeout
        self.max_attempts = max_attempts
        self.clock = clock
        self._rung_of = rung_of or (
            lambda n: frame_rung(n, self.bucket_frames))
        self.telemetry = telemetry if telemetry is not None \
            else ServingTelemetry()
        # Only .delay() is consulted — the scheduler does its own
        # requeueing, so the policy's attempts/budget don't apply here.
        self._retry = retry_backoff if retry_backoff is not None else \
            Retry(base_s=0.02, max_s=1.0, jitter=0.25,
                  name="gateway_dispatch")
        self.breaker = breaker
        self.brownout = brownout
        # A ReplicaPool (serving/pool.py): dispatch routes through it
        # and per-replica breakers replace the single gateway breaker.
        self.pool = pool
        # A ModelRegistry (serving/registry.py): multi-model mode —
        # every request resolves to a model group and dispatch routes
        # through that group's own pool. Mutually exclusive with a
        # bare pool (the registry IS the routing surface).
        self.registry = registry
        if registry is not None and pool is not None:
            raise ValueError(
                "pass either pool= (single-model) or registry= "
                "(multi-model), not both")
        if (pool is not None or registry is not None) \
                and breaker is not None:
            raise ValueError(
                "pool mode uses per-replica breakers; don't also pass "
                "a gateway-level breaker")
        # An AdmissionController (serving/tenancy.py): per-tenant
        # quotas at submit, priority-class default deadlines and
        # brownout shed order, weighted-fair dequeue in _take.
        self.tenancy = tenancy
        # A RescoringPool (serving/rescoring.py): ok results carrying
        # an n-best are offered for an async LM second pass at
        # _finish — an O(1) enqueue; the slow-path compute runs only
        # when the owner pumps the pool, never on this hot path.
        self.rescorer = rescorer
        # Per-tier flush caps (tier -> max_batch): the int8 "bulk"
        # tier's ladder is taller than the bf16 "premium" one under
        # the same HBM budget. Tiers absent from the map (and
        # tierless traffic) use ``max_batch``.
        if tier_max_batch is not None:
            for t, cap in tier_max_batch.items():
                if cap < 1:
                    raise ValueError(
                        f"tier_max_batch[{t!r}] must be >= 1")
        self.tier_max_batch = dict(tier_max_batch or {})
        # Tier-mix shift (tier -> tier), applied at submit AFTER the
        # brownout's effective_tier: the autoscaler's vertical
        # actuator routes premium arrivals onto the taller bulk
        # ladder inside the horizontal cooldown window. Empty =
        # inactive (the default; the controller installs/clears it).
        self.tier_shift: Dict[str, str] = {}
        # Finished-request trace summaries land here (and, tracing on,
        # in the JSONL stream). Tests pass a private ring;
        # the default is the process-wide one the status server reads.
        self.flight_recorder = flight_recorder \
            if flight_recorder is not None else obs.flight_recorder()
        # Pending queues: (model key, tier key) ("" = none) -> T rung
        # -> FIFO. Model- and tier-homogeneous by construction; see
        # module docstring.
        self._pending: Dict[Tuple[str, str],
                            Dict[int, List[_Request]]] = {}
        self._solo: List[_Request] = []  # quarantined, dispatch alone
        self._n_pending = 0
        self._ids = itertools.count()
        self.results: Dict[str, GatewayResult] = {}

    # -- admission ------------------------------------------------------
    @property
    def pending(self) -> int:
        return self._n_pending

    def set_max_queue(self, n: int) -> int:
        """Re-target admission capacity (the autoscaler couples it to
        fleet size). Growth applies immediately; shrink is *bounded*:
        never below the currently admitted backlog (those requests
        hold slots until they retire — dropping capacity under them
        would make ``pending >= max_queue`` shed everything while the
        backlog drains) and never below 1. Returns the applied value,
        which later calls can shrink further as the backlog retires."""
        applied = max(int(n), self._n_pending, 1)
        if applied > self.max_queue:
            self.telemetry.count("capacity_grows")
        elif applied < self.max_queue:
            self.telemetry.count("capacity_shrinks")
        self.max_queue = applied
        self.telemetry.gauge("gateway_capacity", applied)
        return applied

    def _tenant_labels(self, model: Optional[str],
                       tenant: Optional[str],
                       tier: Optional[str] = None
                       ) -> Optional[Dict[str, str]]:
        labels: Dict[str, str] = {}
        if tier is not None:
            labels["tier"] = tier
        if model is not None:
            labels["model"] = model
        if tenant is not None:
            labels["tenant"] = tenant
        return labels or None

    def submit(self, features, feat_len: Optional[int] = None, *,
               deadline: Optional[float] = None,
               timeout: Optional[float] = None,
               rid: Optional[str] = None,
               tier: Optional[str] = None,
               model: Optional[str] = None,
               tenant: Optional[str] = None) -> str:
        """Admit one request; returns its id. ``deadline``/``timeout``
        are relative clock units; ``tier`` is the serving quality tier
        ("premium" | "bulk"; None = tierless). ``model`` picks the
        model group (registry mode fills the default and rejects
        unknown ids); ``tenant`` charges the tenant's quota and
        inherits the tenant's priority-class deadline/tier defaults.
        Raises :class:`OverloadRejected` (after counting the shed)
        when the bounded queue is full, the tenant is at quota
        (:class:`~.tenancy.TenantQuotaExceeded`), or the brownout
        controller is shedding — with tenancy the shed is staged by
        priority class: batch tenants shed at level 1, standard at
        level 2, realtime never (quota + queue bound them instead).
        Under brownout, premium submissions are downgraded to bulk
        (counted ``tier_degraded``) instead of shed outright."""
        if tier is not None and (not isinstance(tier, str) or not tier):
            raise ValueError(f"tier must be a non-empty string or "
                             f"None, got {tier!r}")
        if self.registry is not None:
            model = self.registry.resolve(model)  # KeyError on typo
        if tenant is not None and model is None:
            # The fairness lint's contract: a tenant-sliced SLO series
            # must also say which model earned it.
            raise ValueError(
                "tenant-scoped requests need a model id (pass model= "
                "or construct the scheduler with a registry)")
        tcfg = None
        if tenant is not None and self.tenancy is not None:
            tcfg = self.tenancy.config(tenant)   # KeyError on typo
            if deadline is None:
                deadline = self.tenancy.default_deadline(tenant)
            if tier is None:
                tier = tcfg.tier
        now = self.clock()
        # Expire first: already-dead requests must not hold admission
        # slots (a queue full of ghosts would shed live traffic).
        self._expire(now)
        degraded_from: Optional[str] = None
        if self.brownout is not None:
            self.brownout.update(self._n_pending / self.max_queue,
                                 now=now)
            if tcfg is not None:
                shed = self.tenancy.sheds_at(tenant,
                                             self.brownout.level)
            else:
                shed = self.brownout.should_shed()
            if shed:
                labels = self._tenant_labels(model, tenant)
                self.telemetry.count("rejected", labels=labels)
                self.telemetry.count("brownout_shed", labels=labels)
                raise OverloadRejected(
                    f"brownout shed (level {self.brownout.level}, "
                    f"{self._n_pending}/{self.max_queue} pending)")
            eff = self.brownout.effective_tier(tier)
            if eff != tier:
                # Labeled with the REQUESTED tier: the counter answers
                # "how much premium traffic got downgraded".
                self.telemetry.count("tier_degraded",
                                     labels={"tier": tier})
                degraded_from, tier = tier, eff
        if tier is not None and self.tier_shift:
            # The autoscaler's vertical tier-mix actuator (after the
            # brownout's own degradation — brownout wins when both
            # map the tier). Counted with the REQUESTED tier, like
            # tier_degraded.
            eff = self.tier_shift.get(tier, tier)
            if eff != tier:
                self.telemetry.count("tier_shifted",
                                     labels={"tier": tier})
                if degraded_from is None:
                    degraded_from = tier
                tier = eff
        if self._n_pending >= self.max_queue:
            self.telemetry.count("rejected",
                                 labels=self._tenant_labels(model,
                                                            tenant))
            raise OverloadRejected(
                f"queue full ({self._n_pending} >= {self.max_queue})")
        features = np.asarray(features, np.float32)
        if features.ndim != 2:
            raise ValueError(f"features must be [T, F], "
                             f"got {features.shape}")
        feat_len = int(features.shape[0] if feat_len is None else feat_len)
        # Quota charge LAST among the reject paths: every earlier
        # raise leaves the tenant's inflight count untouched.
        if tcfg is not None:
            try:
                self.tenancy.charge(tenant)
            except OverloadRejected:
                labels = self._tenant_labels(model, tenant)
                self.telemetry.count("rejected", labels=labels)
                self.telemetry.count("tenant_quota_rejected",
                                     labels=labels)
                raise

        rid = rid if rid is not None else f"r{next(self._ids)}"
        req = _Request(
            rid=rid, features=features, feat_len=feat_len,
            t_rung=self._rung_for(feat_len, model), submitted=now,
            deadline=now + (self.default_deadline if deadline is None
                            else deadline),
            timeout=(self.default_timeout if timeout is None else timeout),
            tier=tier, model=model, tenant=tenant)
        # Trace context: the id IS the scheduler rid; the ledger opens
        # in the "queue" phase with the same clock value as submitted.
        req.ctx = TraceContext(rid, now, tier=tier, model=model,
                               tenant=tenant,
                               degraded_from=degraded_from)
        if degraded_from is not None:
            req.ctx.event("tier_degraded", now, requested=degraded_from)
        self._pending.setdefault((model or "", tier or ""), {}) \
            .setdefault(req.t_rung, []).append(req)
        self._n_pending += 1
        self.telemetry.count("admitted")
        self.telemetry.gauge("queue_depth", self._n_pending)
        return rid

    def _rung_for(self, feat_len: int, model: Optional[str]) -> int:
        """T-rung choice: the model group's own ladder when it has
        one, else the scheduler-global ``rung_of`` hook/edges."""
        if self.registry is not None:
            group = self.registry.group(model)
            if group.bucket_frames is not None:
                return int(frame_rung(feat_len, group.bucket_frames))
        return int(self._rung_of(feat_len))

    # -- flush rules ----------------------------------------------------
    def _expire(self, now: float) -> None:
        """Fail queued requests whose timeout passed before dispatch.
        Runs on submit/poll/flush so even an idle gateway answers."""
        def alive(r: _Request) -> bool:
            if r.timeout is not None and now - r.submitted > r.timeout:
                self._finish(r, GatewayResult(
                    r.rid, "timeout", latency=now - r.submitted,
                    attempts=r.attempts,
                    error=f"queued > timeout={r.timeout}"), now)
                self._n_pending -= 1
                return False
            return True

        for tkey, rungs in list(self._pending.items()):
            for rung, reqs in list(rungs.items()):
                keep = [r for r in reqs if alive(r)]
                if keep:
                    rungs[rung] = keep
                else:
                    del rungs[rung]
            if not rungs:
                del self._pending[tkey]
        self._solo = [r for r in self._solo if alive(r)]

    def _eligible(self, qkey: Tuple[str, str], rung: int,
                  now: float) -> List[_Request]:
        """Requests in ((model, tier), rung) whose retry backoff has
        elapsed."""
        return [r for r in self._pending.get(qkey, {}).get(rung, ())
                if r.not_before <= now]

    def _take(self, qkey: Tuple[str, str], rung: int, n: int,
              now: Optional[float] = None) -> List[_Request]:
        """Remove up to ``n`` requests from ((model, tier), rung) —
        backoff-eligible only when ``now`` is given, everything when
        None (drain). With an admission controller and more eligible
        requests than the flush takes, the pick is weighted-fair over
        tenants (stride scheduling; FIFO within a tenant) instead of
        global FIFO — a saturating bulk tenant can't starve the
        others out of a contended rung."""
        rungs = self._pending[qkey]
        elig = [r for r in rungs[rung]
                if now is None or r.not_before <= now]
        if self.tenancy is not None and n < len(elig):
            took = self.tenancy.fair_select(elig, n)
        else:
            took = elig[:n]
        taken = {id(r) for r in took}
        rest = [r for r in rungs[rung] if id(r) not in taken]
        if rest:
            rungs[rung] = rest
        else:
            del rungs[rung]
            if not rungs:
                del self._pending[qkey]
        self._n_pending -= len(took)
        return took

    def _take_solo(self, now: Optional[float]) -> List[MicroBatch]:
        """Quarantined requests flush alone, as soon as their backoff
        elapses (all of them when ``now`` is None — drain)."""
        out: List[MicroBatch] = []
        rest: List[_Request] = []
        for r in self._solo:
            if now is None or r.not_before <= now:
                self._n_pending -= 1
                out.append(MicroBatch([r], r.t_rung, "quarantine",
                                      self._cap(r.tier, r.model),
                                      tier=r.tier, model=r.model))
            else:
                rest.append(r)
        self._solo = rest
        return out

    def _fill_free_rows(self, mb: MicroBatch,
                        now: Optional[float] = None) -> None:
        """Deadline/drain flushes: rows up to the batch rung are padded
        (computed) anyway — fill them with the most urgent requests
        from smaller T rungs of the SAME (model, tier) queue
        (homogeneity: a premium row must never ride a bulk batch onto
        an int8 replica, and a model-a row must never decode on
        model b's weights). Never grows the B rung."""
        qkey = (mb.model or "", mb.tier or "")
        free = mb.b_rung - len(mb.requests)
        while free > 0:
            donors = [rung for rung in self._pending.get(qkey, ())
                      if rung < mb.t_rung
                      and (self._eligible(qkey, rung, now)
                           if now is not None
                           else self._pending[qkey][rung])]
            if not donors:
                return
            def urgency(g):
                pool = (self._eligible(qkey, g, now) if now is not None
                        else self._pending[qkey][g])
                return min(r.deadline for r in pool)
            rung = min(donors, key=urgency)
            mb.requests.extend(self._take(qkey, rung, 1, now))
            self.telemetry.count("filled_free_rows")
            free = mb.b_rung - len(mb.requests)

    def _cap(self, tier: Optional[str], model: Optional[str] = None,
             degrade: bool = True) -> int:
        """Flush cap for one (tier, model) — the model group's ladder
        when it defines one (``ModelGroup.max_batch`` /
        ``.tier_max_batch``), else the scheduler-global heights,
        halved by the brownout controller unless ``degrade=False``
        (shutdown drain flushes at full height)."""
        cap = self.max_batch
        tmb = self.tier_max_batch
        if self.registry is not None and model is not None:
            group = self.registry.group(model)
            if group.max_batch is not None:
                cap = group.max_batch
            if group.tier_max_batch:
                tmb = group.tier_max_batch
        if tier is not None:
            cap = tmb.get(tier, cap)
        if degrade and self.brownout is not None:
            cap = self.brownout.effective_max_batch(cap)
        return cap

    def poll(self, now: Optional[float] = None) -> List[MicroBatch]:
        """Micro-batches due NOW under the flush rules."""
        now = self.clock() if now is None else now
        self._expire(now)
        if self.brownout is not None:
            self.brownout.update(self._n_pending / self.max_queue,
                                 now=now)
        if self.pool is not None:
            self.pool.maintain(now)
            if self.brownout is not None:
                self.pool.apply_brownout(self.brownout.level, now)
        if self.registry is not None:
            self.registry.maintain(now)
            if self.brownout is not None:
                self.registry.apply_brownout(self.brownout.level, now)
        # Quarantined retries first: they already waited a full failed
        # batch and must not re-couple with healthy peers.
        out: List[MicroBatch] = self._take_solo(now)
        # Rung-full flushes next: no padding and no waiting.
        for qkey in sorted(self._pending):
            mkey, tkey = qkey
            cap = self._cap(tkey or None, mkey or None)
            for rung in sorted(self._pending.get(qkey, ())):
                while len(self._eligible(qkey, rung, now)) >= cap:
                    out.append(MicroBatch(
                        self._take(qkey, rung, cap, now),
                        rung, "full", cap, tier=tkey or None,
                        model=mkey or None))
        # Oldest-deadline flushes, most urgent (model, tier, rung)
        # first.
        while True:
            due = [(qkey, rung)
                   for qkey, rungs in self._pending.items()
                   for rung in rungs
                   if any(r.deadline - now <= self.flush_slack
                          for r in self._eligible(qkey, rung, now))]
            if not due:
                break
            qkey, rung = min(due, key=lambda tr: min(
                r.deadline for r in self._eligible(*tr, now)))
            mkey, tkey = qkey
            cap = self._cap(tkey or None, mkey or None)
            mb = MicroBatch(self._take(qkey, rung, cap, now), rung,
                            "deadline", cap, tier=tkey or None,
                            model=mkey or None)
            self._fill_free_rows(mb, now)
            out.append(mb)
        self.telemetry.gauge("queue_depth", self._n_pending)
        return out

    def flush_all(self, now: Optional[float] = None) -> List[MicroBatch]:
        """Everything pending, regardless of deadlines and retry
        backoff (shutdown/drain)."""
        now = self.clock() if now is None else now
        self._expire(now)
        out: List[MicroBatch] = self._take_solo(None)
        for qkey in sorted(self._pending):
            mkey, tkey = qkey
            cap = self._cap(tkey or None, mkey or None, degrade=False)
            for rung in sorted(self._pending.get(qkey, ()),
                               reverse=True):
                while self._pending.get(qkey, {}).get(rung):
                    mb = MicroBatch(self._take(qkey, rung, cap), rung,
                                    "drain", cap, tier=tkey or None,
                                    model=mkey or None)
                    self._fill_free_rows(mb)
                    out.append(mb)
        self.telemetry.gauge("queue_depth", self._n_pending)
        return out

    # -- dispatch / retry ----------------------------------------------
    def _finish(self, req: _Request, result: GatewayResult,
                now: float) -> None:
        """Record the terminal result. ``now`` is the SAME clock value
        the caller used for ``result.latency`` — the trace context
        closes on it, so the phase ledger telescopes to the measured
        latency exactly."""
        self.results[req.rid] = result
        labels = self._tenant_labels(req.model, req.tenant, req.tier)
        self.telemetry.count(f"requests_{result.status}", labels=labels)
        if result.latency is not None:
            # Exemplar: the latency histogram's extreme sample carries
            # the trace id, so "what was the worst request" answers
            # itself from the metrics snapshot.
            self.telemetry.observe(f"latency_{result.status}",
                                   result.latency, labels=labels,
                                   exemplar=req.rid)
        # SLO attainment: a request met its SLO iff it succeeded
        # inside its own deadline (timeouts and errors are misses by
        # definition). serve_traffic reports the attainment % as the
        # headline metric, per tier when tiers are active.
        inside = (result.status == "ok" and result.latency is not None
                  and result.latency <= req.deadline - req.submitted)
        self.telemetry.count("slo_ok" if inside else "slo_miss",
                             labels=labels)
        ctx = req.ctx
        if ctx is not None:
            ctx.note(attempts=result.attempts, slo_ok=inside,
                     deadline_ms=round(
                         (req.deadline - req.submitted) * 1e3, 6))
            if result.error:
                ctx.note(error=result.error)
            ctx.finish(now, result.status)
            rec = ctx.summary()
            self.flight_recorder.record(rec)
            obs.tracer.emit(rec)
        if req.tenant is not None and self.tenancy is not None:
            self.tenancy.release(req.tenant)
        if (self.rescorer is not None and result.status == "ok"
                and result.nbest):
            # After release: the first-pass quota slot is free before
            # the rescorer charges its own batch-class tenant. The
            # offer is O(1) and sheds internally — the fast path never
            # waits on (or fails because of) the slow path.
            self.rescorer.offer(result.rid, result.nbest, result.text,
                                model=req.model, tenant=req.tenant,
                                now=now)

    def _requeue(self, r: _Request, now: float,
                 delay: float = 0.0) -> None:
        r.not_before = now + delay
        if r.solo:
            self._solo.append(r)
        else:
            self._pending.setdefault((r.model or "", r.tier or ""), {}) \
                .setdefault(r.t_rung, []).append(r)
        self._n_pending += 1

    def _defer(self, mb: MicroBatch) -> None:
        """Requeue a batch without burning attempts — the backend (or
        every replica) is known-bad, the requests aren't."""
        self.telemetry.count("breaker_deferred")
        now = self.clock()
        for r in mb.requests:
            if r.ctx is not None:
                r.ctx.to(PHASE_BREAKER, now)
                r.ctx.event("breaker_defer", now, attempts=r.attempts)
            self._requeue(r, now,
                          delay=self._retry.delay(max(r.attempts, 1)))

    def _pre_dispatch(self, mb: MicroBatch, replica) -> None:
        """Serial bookkeeping before decode. Pooled dispatches skip the
        unlabeled occupancy series — the replica records the labeled
        variant, and the schema lint forbids a family carrying both."""
        self.telemetry.rung(mb.b_rung, mb.t_rung)
        if replica is None:
            self.telemetry.observe("batch_occupancy", mb.occupancy)
        waste = mb.padding_waste()
        self.telemetry.observe("padding_waste", waste)
        self.telemetry.count(f"flush_{mb.reason}")
        now = self.clock()
        for r in mb.requests:
            r.attempts += 1
            if r.ctx is not None:
                # Queue (or backoff/defer) wait ends here; everything
                # until the terminal transition is decode time.
                r.ctx.to(PHASE_DECODE, now)
                r.ctx.note(rung=f"{mb.b_rung}x{mb.t_rung}",
                           flush=mb.reason,
                           occupancy=round(mb.occupancy, 6),
                           padding_waste=round(waste, 6),
                           replica=(replica.rid if replica is not None
                                    else None))

    def _run_decode(self, mb: MicroBatch, replica,
                    decode_fn) -> List[str]:
        if replica is not None:
            return replica.decode(mb)
        with obs.span("gateway.dispatch",
                      rung=f"{mb.b_rung}x{mb.t_rung}",
                      reason=mb.reason, occupancy=mb.occupancy):
            faults.inject("gateway.dispatch")
            return decode_fn(mb.batch(), mb.plan())

    def _dispatch_failed(self, mb: MicroBatch, e: Exception, breaker,
                         t_dispatch: Optional[float],
                         replica) -> List[GatewayResult]:
        self.telemetry.count("batch_errors")
        if breaker is not None:
            was_open = breaker.state == STATE_OPEN
            breaker.record_failure()
            if breaker.state == STATE_OPEN and not was_open:
                # Rising edge: the failure that tripped the breaker,
                # with the flight recorder's recent traces as evidence
                # of what traffic looked like going in.
                _postmortem.record(
                    "breaker_open", "failure_threshold",
                    breaker=breaker.name,
                    error=f"{type(e).__name__}: {e}",
                    recent_traces=[
                        slim_trace(t) for t in
                        self.flight_recorder.recent(8)],
                    **({"replica": replica.rid}
                       if replica is not None else {}))
        done: List[GatewayResult] = []
        now = self.clock()
        if replica is None and t_dispatch is not None:
            # Device-side time is spent whether decode succeeds or
            # not; the brownout controller's device_pressure reads
            # this. (A replica records its own labeled series.)
            self.telemetry.observe("gateway.dispatch_s",
                                   now - t_dispatch)
        quarantine = len(mb.requests) > 1
        labels = replica.labels if replica is not None else None
        for r in mb.requests:
            if r.attempts < self.max_attempts:
                self.telemetry.count("retries")
                if r.ctx is not None:
                    r.ctx.to(PHASE_BACKOFF, now)
                    r.ctx.event("retry", now, attempts=r.attempts,
                                error=type(e).__name__)
                if quarantine and not r.solo:
                    r.solo = True
                    self.telemetry.count("quarantined", labels=labels)
                    # Audit trail shared with the training-side
                    # quarantine: the postmortem JSONL is where all
                    # automatic interventions land.
                    self.telemetry.count("postmortems_written")
                    _postmortem.record(
                        "quarantined_request", "batch_error",
                        rid=r.rid, rung=f"{mb.b_rung}x{mb.t_rung}",
                        attempts=r.attempts,
                        error=f"{type(e).__name__}: {e}",
                        **({"replica": replica.rid}
                           if replica is not None else {}))
                self._requeue(r, now,
                              delay=self._retry.delay(r.attempts))
            else:
                res = GatewayResult(
                    r.rid, "error", latency=now - r.submitted,
                    attempts=r.attempts,
                    error=f"{type(e).__name__}: {e}")
                self._finish(r, res, now)
                done.append(res)
        return done

    def _dispatch_ok(self, mb: MicroBatch, texts: List[str], breaker,
                     t_dispatch: Optional[float],
                     replica) -> List[GatewayResult]:
        texts, nbest = _split_decode_result(texts)
        if len(texts) < len(mb.requests):
            raise ValueError(
                f"decode_fn returned {len(texts)} texts for "
                f"{len(mb.requests)} requests")
        if nbest is not None and len(nbest) < len(mb.requests):
            raise ValueError(
                f"decode_fn returned {len(nbest)} n-best lists for "
                f"{len(mb.requests)} requests")
        if breaker is not None:
            breaker.record_success()
        now = self.clock()
        if replica is None and t_dispatch is not None:
            self.telemetry.observe("gateway.dispatch_s",
                                   now - t_dispatch)
        out = []
        for i, (r, text) in enumerate(zip(mb.requests, texts)):
            res = GatewayResult(r.rid, "ok", text=text,
                                latency=now - r.submitted,
                                attempts=r.attempts,
                                nbest=(list(nbest[i])
                                       if nbest is not None else None))
            self._finish(r, res, now)
            out.append(res)
        return out

    def _pool_for(self, mb: MicroBatch):
        """The replica pool serving this batch's model: the group's
        pool in registry mode (batches are model-homogeneous, so one
        batch never straddles pools), else the single shared pool."""
        if self.registry is not None:
            return self.registry.group(mb.model).pool
        return self.pool

    def dispatch(self, mb: MicroBatch,
                 decode_fn: Optional[Callable[
                     [Dict[str, np.ndarray], InferBucketPlan],
                     List[str]]] = None) -> List[GatewayResult]:
        """Decode one micro-batch. On error: backoff-requeue each
        request until ``max_attempts``, then fail it — a multi-request
        batch is quarantined first (each request retries alone) so one
        poison request can't keep killing its batchmates. An open
        circuit breaker defers the batch without burning attempts.

        With a pool, the batch routes to the least-loaded routable
        replica (``decode_fn`` is ignored — each replica owns its
        backend); with none routable the batch defers like an open
        breaker."""
        replica = None
        pool = self._pool_for(mb)
        if pool is not None:
            replica = pool.route(now=self.clock(), tier=mb.tier,
                                 model=mb.model)
            breaker = replica.breaker if replica is not None else None
        else:
            if decode_fn is None:
                raise TypeError("dispatch() needs decode_fn without "
                                "a pool")
            breaker = self.breaker
        if (pool is not None and replica is None) or (
                breaker is not None and not breaker.allow()):
            self._defer(mb)
            return []
        self._pre_dispatch(mb, replica)
        t_dispatch = self.clock()
        try:
            texts = self._run_decode(mb, replica, decode_fn)
        except Exception as e:
            return self._dispatch_failed(mb, e, breaker, t_dispatch,
                                         replica)
        return self._dispatch_ok(mb, texts, breaker, t_dispatch,
                                 replica)

    def dispatch_many(self, mbs: Sequence[MicroBatch],
                      decode_fn=None) -> List[GatewayResult]:
        """Dispatch a set of due micro-batches. Without a pool this is
        serial :meth:`dispatch`. With one, batches are routed serially
        (spreading planned rows so one poll's worth of work doesn't
        pile on a single replica), decoded with one worker thread per
        involved replica (a replica's own batches stay serialized on
        its thread), and finalized serially — scheduler state is only
        ever touched from the calling thread."""
        if self.pool is None and self.registry is None:
            out: List[GatewayResult] = []
            for mb in mbs:
                out.extend(self.dispatch(mb, decode_fn))
            return out
        now = self.clock()
        planned: Dict[str, int] = {}
        routed: List[Tuple[MicroBatch, object]] = []
        for mb in mbs:
            rep = self._pool_for(mb).route(now=now, planned=planned,
                                           tier=mb.tier,
                                           model=mb.model)
            if rep is None or (rep.breaker is not None
                               and not rep.breaker.allow()):
                self._defer(mb)
                continue
            planned[rep.rid] = planned.get(rep.rid, 0) + len(mb.requests)
            self._pre_dispatch(mb, rep)
            routed.append((mb, rep))
        if not routed:
            return []
        groups: Dict[str, Tuple[object, List[MicroBatch]]] = {}
        for mb, rep in routed:
            groups.setdefault(rep.rid, (rep, []))[1].append(mb)
        # id(mb) keys are written once each from exactly one worker.
        outcomes: Dict[int, Tuple[str, object]] = {}

        def _work(rep, batches):
            for mb in batches:
                try:
                    outcomes[id(mb)] = ("ok", rep.decode(mb))
                except Exception as e:  # finalized on the main thread
                    outcomes[id(mb)] = ("err", e)

        if len(groups) == 1:
            (rep, batches), = groups.values()
            _work(rep, batches)
        else:
            threads = [threading.Thread(target=_work, args=g,
                                        daemon=True)
                       for g in groups.values()]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        out = []
        for mb, rep in routed:
            kind, val = outcomes[id(mb)]
            if kind == "ok":
                out.extend(self._dispatch_ok(mb, val, rep.breaker,
                                             None, rep))
            else:
                out.extend(self._dispatch_failed(mb, val, rep.breaker,
                                                 None, rep))
        return out

    def pump(self, decode_fn=None) -> List[GatewayResult]:
        """One scheduler turn: dispatch everything currently due."""
        return self.dispatch_many(self.poll(), decode_fn)

    def drain(self, decode_fn=None) -> Dict[str, GatewayResult]:
        """Run until the queue is empty (retries included); returns all
        terminal results recorded so far."""
        while self._n_pending:
            batches = self.poll() or self.flush_all()
            self.dispatch_many(batches, decode_fn)
        return self.results
