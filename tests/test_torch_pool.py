"""The port's ``ReplicaPool``, ``PooledSessionRouter`` and
``MigrationController`` against the JAX package's:

- ``ring_owner`` and ``ring_order`` for 1000 keys across
  ``add_replica`` and ``remove_replica``, and the pins a live resize
  moves;
- the least-loaded spill order (in-flight rows, planned rows, dispatch
  p95, tiers), the breaker drain and re-pin with no lost chunk (drain
  fallback and snapshot handoff, over model-free managers), brownout
  parking and re-admission;
- the router over tiny streaming weights (2 uni-GRU layers, H=32, f32;
  the JAX side on its Pallas GRU kernel in interpret mode): equal
  partials, finals, homes and counters with no fault, with a forced
  drain, and with a forced drain under a ``MigrationController`` — whose
  finals equal the never-drained run's, as the JAX package's own tests
  hold them.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeech_tpu.obs as jax_obs
import deepspeech_tpu.resilience as jax_res
import deepspeech_tpu.serving as jax_serving
import deepspeech_tpu_torch.obs as port_obs
import deepspeech_tpu_torch.resilience as port_res
import deepspeech_tpu_torch.serving as port_serving
from deepspeech_tpu.config import apply_overrides as jax_apply_overrides
from deepspeech_tpu.config import get_config as jax_get_config
from deepspeech_tpu.data import CharTokenizer as JaxCharTokenizer
from deepspeech_tpu.models import create_model as jax_create_model
from deepspeech_tpu_torch.config import apply_overrides, get_config
from deepspeech_tpu_torch.data import CharTokenizer
from test_torch_model import random_flax_variables

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

JAX = types.SimpleNamespace(serving=jax_serving, res=jax_res, obs=jax_obs)
PORT = types.SimpleNamespace(serving=port_serving, res=port_res,
                             obs=port_obs)


class Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _trip(breaker):
    while breaker.state != "open":
        breaker.record_failure()


def _replicas(m, clock, tel, n, tiers=None, factory=None):
    return [m.serving.Replica(
        f"r{k}", (lambda batch, plan: []), telemetry=tel, clock=clock,
        tier=None if tiers is None else tiers[k],
        breaker=m.res.CircuitBreaker(name=f"b{k}", failure_threshold=2,
                                     cooldown_s=1.0, clock=clock,
                                     registry=tel),
        session_factory=factory) for k in range(n)]


# -- the ring -------------------------------------------------------------

def _ring(m):
    clock = Clock()
    tel = m.serving.ServingTelemetry()
    pool = m.serving.ReplicaPool(_replicas(m, clock, tel, 4), clock=clock,
                                 telemetry=tel)
    keys = [f"sess-{k}" for k in range(1000)]
    out = [[pool.ring_owner(k) for k in keys]]
    for k in keys[:200]:
        pool.route(session_id=k)
    pool.add_replica(_replicas(m, clock, tel, 5)[4])
    out.append([pool.ring_owner(k) for k in keys])
    out.append([pool.pin_of(k) for k in keys[:200]])
    out.append(pool.repins)
    pool.remove_replica("r1")
    out.append([pool.ring_owner(k) for k in keys])
    out.append([pool.ring_order(k) for k in keys[:50]])
    out.append([pool.pin_of(k) for k in keys[:200]])
    out.append(pool.stats())
    return out


def test_ring_matches_jax():
    want, got = _ring(JAX), _ring(PORT)
    assert got == want
    # A resize moves about 1/N of the keys, no more.
    before, after = got[0], got[1]
    moved = sum(a != b for a, b in zip(before, after))
    assert 0 < moved < 400 and all(b == "r4" for a, b in
                                   zip(before, after) if a != b)


# -- spill order, drains, parking -----------------------------------------

def _spill(m):
    clock = Clock()
    tel = m.serving.ServingTelemetry()
    reps = _replicas(m, clock, tel, 4,
                     tiers=["premium", "premium", "bulk", None])
    pool = m.serving.ReplicaPool(reps, clock=clock, telemetry=tel,
                                 drain_window_s=0.5)
    for rep, lat in zip(reps, (0.03, 0.01, 0.02, 0.05)):
        for v in (lat, lat * 2, lat / 2):
            rep.telemetry.observe("gateway.dispatch_s", v,
                                  labels=rep.labels)
    seq = []
    plans = [{}, {"r1": 3}, {"r1": 3, "r0": 1}, {"r0": 5, "r1": 5},
             {"r3": 9}]
    for inflight in ((0, 0, 0, 0), (2, 0, 1, 0), (0, 4, 0, 1),
                     (3, 3, 3, 3)):
        for rep, n in zip(reps, inflight):
            rep.inflight = n
        for planned in plans:
            for tier in (None, "premium", "bulk"):
                r = pool.route(planned=planned, tier=tier)
                seq.append(None if r is None else r.rid)
    for rep in reps:
        rep.inflight = 0
    # Breaker drain: r1 opens, drains, then its cooldown half-opens it.
    _trip(reps[1].breaker)
    for k in range(12):
        pool.maintain()
        seq.append([(r.rid, r.state, r.can_route()) for r in reps])
        seq.append(pool.route(tier="premium").rid)
        clock.advance(0.2)
    # Brownout parking and recovery.
    for level in (3, 3, 2, 3, 0, 1):
        pool.apply_brownout(level)
        for _ in range(3):
            pool.maintain()
            clock.advance(0.3)
        seq.append([(r.rid, r.state, r.park_reason, r.parking)
                    for r in reps])
    snap = tel.snapshot()
    return seq, snap["counters"], snap["gauges"], pool.stats()


def test_spill_drain_and_parking_match_jax():
    want, got = _spill(JAX), _spill(PORT)
    assert got == want
    seq = got[0]
    assert {"r0", "r1", "r2", "r3"} <= set(x for x in seq
                                           if isinstance(x, str))
    assert any(s == "parked" for row in seq if isinstance(row, list)
               for _, s, *_ in row)


class FakeMgr:
    """Model-free manager without the snapshot surface."""

    def __init__(self, log):
        self.log = log
        self.active = {}
        self.done = {}

    def join(self, sid, raw_len=None):
        self.active[sid] = []

    def leave(self, sid, tail=None):
        self.done[sid] = " ".join(self.active.pop(sid))

    def step(self, chunks):
        assert set(chunks) == set(self.active)
        for sid, c in chunks.items():
            self.active[sid].append(str(c))
            self.log.append((sid, str(c)))
        return {sid: " ".join(v) for sid, v in self.active.items()}

    def flush(self):
        pass

    def final(self, sid):
        return self.done[sid]

    def stats(self):
        return {"active": len(self.active), "draining": 0}


class PortableFakeMgr(FakeMgr):
    """FakeMgr plus the snapshot surface — a model-free handoff."""

    def snapshot_fingerprint(self):
        return "fake"

    def export_session(self, sid):
        return ("snap", sid, self.active.pop(sid))

    def import_session(self, snap, sid=None):
        _, sid0, seen = snap
        self.active[sid0] = seen


@pytest.mark.parametrize("mgr,migrate", [
    (FakeMgr, False), (FakeMgr, True), (PortableFakeMgr, True)],
    ids=["drain", "unsupported-fallback", "handoff"])
def test_repin_loses_no_chunk_and_matches_jax(mgr, migrate):
    def run(m):
        clock = Clock()
        tel = m.serving.ServingTelemetry()
        log, pms = [], []
        pool = m.serving.ReplicaPool(
            _replicas(m, clock, tel, 3, factory=lambda: mgr(log)),
            clock=clock, telemetry=tel, drain_window_s=0.25,
            handoff=migrate)
        mig = m.serving.MigrationController(
            telemetry=tel, clock=clock,
            postmortem_fn=lambda kind, trigger="", **kw:
                pms.append((kind, trigger, kw))) if migrate else None
        router = m.serving.PooledSessionRouter(
            pool, migrator=mig, flight_recorder=m.obs.FlightRecorder())
        sids = [f"s{k}" for k in range(9)]
        homes = [router.join(s) for s in sids]
        outs = []
        for i in range(6):
            if i == 2:
                _trip(pool.replica(homes[0]).breaker)
            outs.append(router.step({s: f"c{i}" for s in sids}))
            clock.advance(0.1)
        for s in sids:
            router.leave(s)
        router.flush()
        finals = [router.final(s) for s in sids]
        return (homes, outs, finals, log, router.stats(),
                mig.stats() if mig else None, pms,
                tel.snapshot()["counters"])

    want, got = run(JAX), run(PORT)
    assert got == want
    finals = got[2]
    assert finals == [" ".join(f"c{i}" for i in range(6))] * 9
    if mgr is PortableFakeMgr:
        assert got[5]["migrations"] >= 1 and got[5]["fallbacks"] == 0


# -- the router over real streaming managers --------------------------------

NF = 32
OVER = {"model.rnn_hidden": "32", "model.rnn_layers": "2",
        "model.conv_channels": "4,4", "model.lookahead_context": "4",
        "model.dtype": "float32", "model.rnn_impl": "pallas",
        "features.num_features": str(NF)}


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_apply_overrides(jax_get_config("ds2_streaming"), OVER)
    tcfg = apply_overrides(get_config("ds2_streaming"), OVER)
    params, stats = random_flax_variables(
        jax_create_model(jcfg.model), jnp.zeros((1, 64, NF), jnp.float32),
        jnp.full((1,), 64, jnp.int32), np.random.default_rng(7))
    params = jax.tree.map(np.asarray, params)
    params["head"]["kernel"] = params["head"]["kernel"] * 8.0
    return jcfg, tcfg, params, stats


def _streams():
    rng = np.random.default_rng(12)
    return {f"u{k}": rng.standard_normal((64 * n, NF)).astype(np.float32)
            for k, n in enumerate((5, 3, 4, 5))}


def _router_run(m, factory, trip_at, migrate):
    clock = Clock()
    tel = m.serving.ServingTelemetry()
    pms = []
    pool = m.serving.ReplicaPool(
        _replicas(m, clock, tel, 2, factory=lambda: factory(tel)),
        clock=clock, telemetry=tel, drain_window_s=0.25, handoff=migrate)
    mig = m.serving.MigrationController(
        telemetry=tel, clock=clock,
        postmortem_fn=lambda kind, trigger="", **kw:
            pms.append((kind, trigger, kw.get("outcome"), kw.get("sid"))),
    ) if migrate else None
    router = m.serving.PooledSessionRouter(
        pool, migrator=mig, flight_recorder=m.obs.FlightRecorder())
    feats = _streams()
    homes = {sid: router.join(sid) for sid in feats}
    n_chunks = {sid: f.shape[0] // 64 for sid, f in feats.items()}
    partials = []
    for i in range(max(n_chunks.values())):
        if i == trip_at:
            _trip(pool.replica(homes["u0"]).breaker)
        chunks = {sid: f[i * 64:(i + 1) * 64] for sid, f in feats.items()
                  if i < n_chunks[sid]}
        partials.append(router.step(chunks))
        for sid in feats:
            if n_chunks[sid] == i + 1:
                router.leave(sid)
        clock.advance(0.1)
    router.flush()
    finals = {sid: router.final(sid) for sid in feats}
    counters = {k: v for k, v in tel.snapshot()["counters"].items()
                if "migration" in k or "repin" in k or "session" in k}
    return (homes, partials, finals, router.stats(),
            mig.stats() if mig else None, pms, counters)


@pytest.mark.parametrize("trip_at,migrate", [(None, False), (2, False),
                                             (2, True)],
                         ids=["steady", "drain", "migrate"])
def test_router_matches_jax(tiny, trip_at, migrate):
    jcfg, tcfg, params, stats = tiny

    def jax_mgr(tel):
        return jax_serving.StreamingSessionManager(
            jcfg, params, stats, JaxCharTokenizer.english(),
            chunk_frames=64, capacity=1, telemetry=tel)

    def port_mgr(tel):
        return port_serving.StreamingSessionManager(
            tcfg, params, stats, CharTokenizer.english(), chunk_frames=64,
            capacity=1, telemetry=tel, device="cpu")

    want = _router_run(JAX, jax_mgr, trip_at, migrate)
    got = _router_run(PORT, port_mgr, trip_at, migrate)
    assert got == want
    homes, partials, finals, rstats, mstats, pms, counters = got
    assert any(finals.values())
    if trip_at is not None:
        assert rstats["repins"] >= 1
    if migrate:
        assert mstats["migrations"] >= 1 and mstats["fallbacks"] == 0
        assert ("migration", "breaker", "handoff", "u0") in pms
        steady = _router_run(PORT, port_mgr, None, False)
        # A live handoff keeps the segment: the finals equal the
        # never-drained run's.
        assert finals == steady[2]
