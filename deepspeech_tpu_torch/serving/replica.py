"""One serving executor: a model replica with its own health envelope.

The port's own copy of the JAX package's ``serving/replica.py``. A
:class:`Replica` is the unit the :class:`~.pool.ReplicaPool` schedules
over:

- **its own backend handle** — ``decode_fn(batch, plan) -> texts``
  (typically a bound ``Inferencer.decode_batch_bucketed``; use
  :meth:`Replica.from_inferencer`) with its own
  :class:`~..utils.cache.ShapeBucketCache` rung ladder, so one
  replica's rung churn never evicts another's warm set. A replica
  bound to a CUDA inferencer decodes on a CUDA stream of its own, so
  the gateway's worker threads (``MicroBatchScheduler.dispatch_many``)
  overlap on the card instead of queueing on the default stream;
- **its own** :class:`~..resilience.CircuitBreaker` — replica-level
  health, so one sick executor opens alone and the pool routes around
  it instead of the whole gateway tripping;
- **its own load accounting** — in-flight row slots (``inflight``,
  lock-guarded: the pool's threaded fan-out dispatches replicas
  concurrently) and cumulative busy seconds, plus the dispatch-latency
  histogram it feeds under a ``replica`` label. The pool's
  least-loaded spill reads exactly these;
- **a lifecycle** — ``active`` (routable), ``draining`` (finishing
  in-flight work behind a drain window: breaker opened, or the
  brownout controller is parking it), ``parked`` (drained and held out
  of routing until re-admitted).

Every metric a replica emits carries a ``replica`` label
(``gateway.dispatch_s{replica="r0"}``, ``batch_occupancy{...}``,
``compiles{rung=...,replica=...}``); labeled series never mix with
unlabeled ones — single-replica deployments keep the unlabeled names,
pooled ones are labeled throughout.

Quality tiers: a replica constructed with ``tier="bulk"`` owns an
int8-quantized backend (PTQ once at replica init —
``Inferencer(quantize="int8")``, never per-request) and only takes
``tier="bulk"`` requests; ``tier="premium"`` marks the bf16 replicas.
Tiered replicas add a ``tier`` label to every metric and span they
emit (the same all-labeled-or-all-unlabeled rule as ``replica``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import obs
from ..obs.metrics import _labeled
from ..resilience import CircuitBreaker
from ..resilience import faults
from .telemetry import ServingTelemetry

def _own_stream(inferencer) -> Optional["torch.cuda.Stream"]:
    """A new CUDA stream on the inferencer's device, or None when it
    runs on the CPU."""
    dev = getattr(inferencer, "device", None)
    if dev is None or torch.device(dev).type != "cuda":
        return None
    return torch.cuda.Stream(torch.device(dev))


STATE_ACTIVE = "active"
STATE_DRAINING = "draining"
STATE_PARKED = "parked"


class Replica:
    """See module docstring. The scheduler's dispatch protocol::

        r = pool.route()                  # least-loaded / pinned
        if r is not None and r.breaker.allow():
            texts = r.decode(mb)          # spans + labeled telemetry
            r.breaker.record_success()
    """

    def __init__(self, rid: str,
                 decode_fn: Optional[Callable] = None, *,
                 breaker: Optional[CircuitBreaker] = None,
                 telemetry: Optional[ServingTelemetry] = None,
                 session_factory: Optional[Callable[[], object]] = None,
                 tier: Optional[str] = None,
                 model: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.rid = str(rid)
        self.decode_fn = decode_fn
        # Quality tier this replica serves ("premium" = bf16 beam,
        # "bulk" = int8 greedy). None = untiered: serves any request,
        # metrics stay unlabeled — the single-tier deployment shape.
        self.tier = tier
        # Model group this replica belongs to (serving/registry.py
        # tags it at registration). None = single-model deployment:
        # serves anything, metrics stay model-unlabeled. Like ``tier``
        # it joins ``labels``, so every metric/span from a grouped
        # replica carries the model dimension.
        self.model = model
        # Model version this replica currently serves (set by the
        # rollout controller; None outside a rollout). Deliberately
        # NOT part of ``labels``: per-replica metric families predate
        # any rollout, and adding the label mid-run would mix labeled
        # and unlabeled series in one family — exactly what the schema
        # lint forbids. Version-labeled metrics live on the rollout's
        # own families instead.
        self.version: Optional[str] = None
        self.clock = clock
        self.telemetry = telemetry if telemetry is not None \
            else ServingTelemetry()
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            name=f"replica_{self.rid}", clock=clock,
            registry=self.telemetry)
        # A factory, not an instance: streaming state is expensive and
        # only replicas that actually host sessions should pay for it.
        self.session_factory = session_factory
        self._session_manager = None
        self.state = STATE_ACTIVE
        self.drain_until: Optional[float] = None
        # Parking is a two-phase move: drain first, park when drained.
        self._park_when_drained = False
        # Who parked this replica ("brownout" | "rollout" | None).
        # apply_brownout only counts and recovers its OWN parks — a
        # rollout-parked candidate must neither suppress the rung-3
        # park nor be silently re-admitted on brownout recovery.
        self.park_reason: Optional[str] = None
        # Drain started with handoff=True: the streaming router should
        # migrate this replica's pinned sessions by live snapshot
        # (serving/migration.py) instead of waiting out the drain.
        self.handoff = False
        self._lock = threading.Lock()
        # The CUDA stream this replica's decodes run on (None: the
        # caller's current stream, as for a CPU or synthetic backend).
        self.stream = None
        self.inflight = 0          # rows currently dispatched
        self.busy_s = 0.0          # cumulative decode wall seconds
        self.dispatches = 0
        self.rows = 0

    # -- identity / labels ----------------------------------------------
    @property
    def labels(self) -> Dict[str, str]:
        lab = {"replica": self.rid}
        if self.tier is not None:
            lab["tier"] = self.tier
        if self.model is not None:
            lab["model"] = self.model
        return lab

    def serves(self, tier: Optional[str],
               model: Optional[str] = None) -> bool:
        """May this replica serve a request of ``tier`` (and, when
        given, ``model``)? A tierless replica serves anything; a
        tiered one serves exactly its own tier — the bit-identity
        contract (bulk requests always land on an int8 backend, never
        "upgraded" to a bf16 one, so mixed-tier traffic matches
        single-tier runs transcript-for-transcript). The model rule is
        identical and stricter in spirit: a request for model "a" must
        never decode on model "b"'s weights, so two tagged-but-unequal
        ids never match. A None on either side carries no
        constraint."""
        if self.tier is not None and tier is not None \
                and self.tier != tier:
            return False
        return (self.model is None or model is None
                or self.model == model)

    @classmethod
    def from_inferencer(cls, rid: str, inferencer, *,
                        nbest: bool = False, warmstore=None,
                        **kw) -> "Replica":
        """Bind a replica to one ``Inferencer``: the replica's backend
        is its bucketed decode, and the inferencer's private
        ``ShapeBucketCache`` reports compiles under this replica's
        label (per-replica rung-ladder attribution in ``obs``). An
        inferencer on a CUDA device gets a stream of its own for the
        replica's decodes (:meth:`decode`).

        ``nbest=True`` switches the backend to the ``(texts, nbest)``
        decode contract (scheduler ``_split_decode_result``): beam
        modes return their stashed per-row hypothesis lists (one
        device-to-host copy a micro-batch, no extra launch), greedy
        degrades to 1-best ``[(text, 0.0)]`` — the feed for the async
        rescoring plane. Texts are identical either way.

        ``warmstore`` (a :class:`~.warmstore.WarmStore`) makes the
        replica's rung ladder ready BEFORE it is routable — each stored
        rung captured as a CUDA graph on the card — and arms the
        first-use export hook so run-time first uses land back in the
        store. ``None`` falls back to the process default
        (``DS2_WARMSTORE_DIR``); no store configured = the pre-store
        behavior, untouched."""
        if nbest:
            def _decode(batch, plan):
                texts = inferencer.decode_batch_bucketed(
                    batch, plans=[plan])
                nb = inferencer._last_nbest
                if nb is None:  # greedy path: degrade to 1-best
                    nb = [[(t, 0.0)] for t in texts]
                return texts, nb
        else:
            def _decode(batch, plan):
                return inferencer.decode_batch_bucketed(
                    batch, plans=[plan])

        rep = cls(rid, _decode, **kw)
        rep.inferencer = inferencer
        rep.stream = _own_stream(inferencer)
        inferencer.shape_cache.labels = dict(rep.labels)
        if warmstore is None:
            from .warmstore import default_store

            warmstore = default_store()
        if warmstore is not None:
            warmstore.preload_replica(rep, trigger="replica_init")
            warmstore.install_export_hook(rep)
        return rep

    # -- lifecycle -------------------------------------------------------
    def can_route(self, now: Optional[float] = None) -> bool:
        """May the pool hand this replica NEW work? Draining and parked
        replicas never take new work; an open breaker keeps the replica
        out until its cooldown would admit a half-open probe (the probe
        itself is still gated by ``breaker.allow()`` at dispatch)."""
        if self.state != STATE_ACTIVE:
            return False
        b = self.breaker
        if b is not None and b.state == "open":
            now = self.clock() if now is None else now
            return now - b.opened_at >= b.cooldown_s
        return True

    def begin_drain(self, now: float, window_s: float,
                    park: bool = False,
                    reason: Optional[str] = None,
                    handoff: bool = False) -> None:
        """Stop taking new work; in-flight work finishes inside the
        drain window. ``park=True`` parks the replica once drained
        (brownout rung 3, or a rollout taking it out for a backend
        swap — ``reason`` records which) instead of returning it to
        routing. ``handoff=True`` additionally asks the streaming
        router to live-migrate this replica's pinned sessions
        (snapshot handoff, zero drain wait) rather than letting them
        drain out as segments."""
        if self.state == STATE_PARKED:
            return
        self.state = STATE_DRAINING
        self.drain_until = now + window_s
        self._park_when_drained = self._park_when_drained or park
        self.handoff = self.handoff or handoff
        if park:
            self.park_reason = reason if reason is not None \
                else (self.park_reason or "brownout")
        self.telemetry.count("replica_drains", labels=self.labels)
        self.telemetry.gauge("replica_state", 1, labels=self.labels)

    @property
    def parking(self) -> bool:
        """Draining toward parked (brownout rung 3 / rollout swap)?"""
        return self._park_when_drained

    def unpark(self) -> None:
        """Re-admit a parked or draining-to-park replica. A replica
        that is merely draining (breaker opened; ``park=False``) is
        left alone — cutting its drain window short would hand it new
        work while its in-flight work is still failing out."""
        if self.state == STATE_PARKED or \
                (self.state == STATE_DRAINING and self._park_when_drained):
            self._park_when_drained = False
            self.park_reason = None
            self.handoff = False
            self.state = STATE_ACTIVE
            self.drain_until = None
            self.telemetry.count("replica_unparked", labels=self.labels)
            self.telemetry.gauge("replica_state", 0, labels=self.labels)

    def tick(self, now: Optional[float] = None) -> None:
        """Advance the lifecycle: a draining replica whose window has
        elapsed and whose in-flight work is done either parks or
        returns to routing."""
        if self.state != STATE_DRAINING:
            return
        now = self.clock() if now is None else now
        with self._lock:
            drained = self.inflight == 0
        if drained and (self.drain_until is None
                        or now >= self.drain_until):
            if self._park_when_drained:
                self.state = STATE_PARKED
                self.telemetry.count("replica_parked", labels=self.labels)
                self.telemetry.gauge("replica_state", 2,
                                     labels=self.labels)
            else:
                self.state = STATE_ACTIVE
                self.handoff = False
                self.telemetry.gauge("replica_state", 0,
                                     labels=self.labels)
            self.drain_until = None

    # -- load ------------------------------------------------------------
    def dispatch_p95(self) -> Optional[float]:
        hist = self.telemetry.hists.get(
            _labeled("gateway.dispatch_s", self.labels))
        return hist.percentile(95) if hist is not None else None

    def load_key(self, index: int) -> tuple:
        """Least-loaded ordering: in-flight row slots first, dispatch
        p95 second (an idle-but-slow replica loses to an idle-and-fast
        one), construction index as the deterministic tie-break."""
        with self._lock:
            inflight = self.inflight
        p95 = self.dispatch_p95()
        return (inflight, p95 if p95 is not None else 0.0, index)

    # -- the guarded decode ---------------------------------------------
    def decode(self, mb) -> List[str]:
        """Run one micro-batch on this replica's backend, under the
        shared ``gateway.dispatch`` span/fault point, with every metric
        carrying this replica's label. Breaker bookkeeping stays with
        the caller (the scheduler owns attempt/requeue semantics).
        Returns whatever the backend returns — plain texts or the
        ``(texts, nbest)`` tuple contract; the scheduler normalizes at
        finalization (``_split_decode_result``)."""
        if self.decode_fn is None:
            raise RuntimeError(f"replica {self.rid!r} has no decode_fn")
        rows = len(mb.requests)
        # Snapshot under the lock: the pool's threaded fan-out runs
        # decode() concurrently, so a bare read here could publish a
        # neighbour's in-between value.
        with self._lock:
            self.inflight += rows
            inflight_snap = self.inflight
        self.telemetry.gauge("inflight", inflight_snap,
                             labels=self.labels)
        t0 = self.clock()
        try:
            with obs.span("gateway.dispatch",
                          rung=f"{mb.b_rung}x{mb.t_rung}",
                          reason=mb.reason, occupancy=mb.occupancy,
                          replica=self.rid,
                          **({"tier": self.tier}
                             if self.tier is not None else {}),
                          **({"model": self.model}
                             if self.model is not None else {})):
                faults.inject("gateway.dispatch", replica=self.rid)
                return self._on_stream(self.decode_fn, mb.batch(),
                                       mb.plan())
        finally:
            dt = self.clock() - t0
            with self._lock:
                self.inflight -= rows
                self.busy_s += dt
                self.dispatches += 1
                self.rows += rows
                inflight_snap = self.inflight
            # Exemplar: the slowest dispatch's first-request trace id
            # rides the histogram max, so the per-replica device
            # latency series names its own worst offender.
            self.telemetry.observe("gateway.dispatch_s", dt,
                                   labels=self.labels,
                                   exemplar=getattr(mb.requests[0],
                                                    "rid", None)
                                   if mb.requests else None)
            self.telemetry.observe("batch_occupancy", mb.occupancy,
                                   labels=self.labels)
            self.telemetry.gauge("inflight", inflight_snap,
                                 labels=self.labels)

    def _on_stream(self, fn, *args):
        """``fn(*args)`` on this replica's stream, if it has one. The
        stream first waits for the work queued on the device's current
        stream (the weights' upload), so the decode reads them whole.
        The backend returns host values (texts), whose copy from the
        card waits for the stream, so nothing of the call is left
        running when it returns."""
        stream = self.stream
        if stream is None:
            return fn(*args)
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        with torch.cuda.stream(stream):
            return fn(*args)

    # -- streaming half --------------------------------------------------
    @property
    def session_manager(self):
        """This replica's StreamingSessionManager, created on first
        use via ``session_factory`` (None when the replica is
        offline-only)."""
        if self._session_manager is None and self.session_factory:
            self._session_manager = self.session_factory()
        return self._session_manager

    def peek_session_manager(self):
        """The manager if it exists, without creating one."""
        return self._session_manager

    def stats(self) -> dict:
        with self._lock:
            return {
                "rid": self.rid,
                "state": self.state,
                "version": self.version,
                "inflight": self.inflight,
                "dispatches": self.dispatches,
                "rows": self.rows,
                "busy_s": round(self.busy_s, 6),
                "breaker_state": self.breaker.state
                if self.breaker is not None else None,
            }

    # -- backend swap (rollout controller) -------------------------------
    def backend_snapshot(self) -> dict:
        """The currently-installed backend, in the shape
        :meth:`swap_backend` accepts — the rollout controller stashes
        this before a swap so a canary failure or mid-swap fault can
        restore it bit-exactly."""
        return {
            "decode_fn": self.decode_fn,
            "session_factory": self.session_factory,
            "inferencer": getattr(self, "inferencer", None),
            "version": self.version,
        }

    def swap_backend(self, *, decode_fn=None, session_factory=None,
                     inferencer=None,
                     version: Optional[str] = None) -> None:
        """Install a new backend on a PARKED replica (the rollout
        controller's swap step). Only legal while parked: a live
        backend may have in-flight work or live streaming sessions.
        Replacing ``session_factory`` drops the lazily-built manager so
        the next session lands on the new weights — the caller must
        have drained it first (the rollout gates on the manager being
        empty). Before the old backend is dropped, the replica's CUDA
        stream is synchronized: kernels queued there may still read
        the old weights, whose blocks the caching allocator would
        otherwise hand out again."""
        if self.state != STATE_PARKED:
            raise RuntimeError(
                f"swap_backend on {self.rid!r} while {self.state} "
                "(park it first)")
        mgr = self._session_manager
        if mgr is not None and session_factory is not self.session_factory:
            st = mgr.stats() if hasattr(mgr, "stats") else {}
            if st.get("active") or st.get("draining"):
                raise RuntimeError(
                    f"swap_backend on {self.rid!r}: session manager "
                    f"still holds sessions ({st})")
            self._session_manager = None
        if self.stream is not None:
            self.stream.synchronize()
        self.decode_fn = decode_fn
        self.session_factory = session_factory
        self.inferencer = inferencer
        if inferencer is not None:
            if self.stream is None:
                self.stream = _own_stream(inferencer)
            if getattr(inferencer, "shape_cache", None) is not None:
                inferencer.shape_cache.labels = dict(self.labels)
        self.version = version

    def __repr__(self) -> str:  # debugging logs
        return (f"Replica({self.rid!r}, state={self.state}, "
                f"inflight={self.inflight})")


def synthetic_replicas(n: int, service_s_per_row: float = 0.0, *,
                       base_s: float = 0.0,
                       telemetry: Optional[ServingTelemetry] = None,
                       tier: Optional[str] = None,
                       model: Optional[str] = None,
                       rid_prefix: str = "r",
                       clock: Callable[[], float] = time.monotonic
                       ) -> List[Replica]:
    """N replicas over a synthetic timed backend (``sleep``-based cost
    model, texts deterministic in the request lengths) — for tests and
    scripts that need wall-clock overlap without a model."""
    tel = telemetry if telemetry is not None else ServingTelemetry()

    def make_fn():
        def fn(batch, plan):
            n_valid = int(plan.n_valid)
            cost = base_s + service_s_per_row * plan.batch_pad
            if cost > 0:
                time.sleep(cost)
            lens = np.asarray(batch["feat_lens"])[:n_valid]
            return [f"len{int(v)}" for v in lens]
        return fn

    return [Replica(f"{rid_prefix}{i}", make_fn(), telemetry=tel,
                    tier=tier, model=model, clock=clock)
            for i in range(n)]
