"""The port's gateway (``serving/scheduler.py`` over ``serving/pool.py``
and ``serving/replica.py``) against the JAX package's:

- a seeded trace of 200 requests (lengths over ds2_small's edges and
  past them, mixed deadlines and timeouts, two tiers, a burst that
  overflows the bounded queue, a brownout controller, a
  ``gateway.dispatch`` fault plan that trips one replica's breaker) on
  synthetic replicas and a fake clock: the micro-batches (rids, rung,
  reason, tier), every result, every rejection, the postmortem records,
  the flight recorder's summaries and the telemetry snapshot are equal;
- ``Replica.from_inferencer`` over a tiny ds2_small-shaped model (2
  BiGRU layers, H=32, f32) loaded into both packages' ``Inferencer``
  from the same numpy weights, one premium replica and one int8 bulk
  replica: 24 requests give equal micro-batches, equal texts per rid and
  equal ``shape_cache.stats()``;
- the port's telemetry of a pooled, tiered run passes the JAX
  package's schema lint (``tools/check_obs_schema.validate_record``),
  which holds the all-labelled-or-none rule for ``replica`` and
  ``tier``;
- ``ModelRegistry`` routing two model groups (their own pools and
  ladders) behind one gateway on synthetic replicas;
- ``warm_rung_chooser``, the scheduler's refusals (tenancy, rescoring)
  and ``from_inferencer``'s warm store refusal.
"""

import dataclasses
import io
import json
import os
import random
import sys
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
from deepspeech_tpu.infer import Inferencer as JaxInferencer
from deepspeech_tpu.models import create_model as jax_create_model
from deepspeech_tpu.serving.scheduler import \
    warm_rung_chooser as jax_warm_rung_chooser
from deepspeech_tpu_torch.config import apply_overrides, get_config
from deepspeech_tpu_torch.data import CharTokenizer
from deepspeech_tpu_torch.infer import Inferencer
from test_torch_model import random_flax_variables

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from check_obs_schema import validate_record  # noqa: E402

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

JAX = types.SimpleNamespace(serving=jax_serving, res=jax_res, obs=jax_obs)
PORT = types.SimpleNamespace(serving=port_serving, res=port_res,
                             obs=port_obs)
EDGES = (400, 800, 1200, 1700)   # ds2_small's data.bucket_frames


class Clock:
    def __init__(self, t=50.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _requests(n=200, seed=0, nf=4):
    """(features, tier, deadline, timeout, gap, pump) per request; the
    features are zeros: synthetic replicas read only the lengths."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        length = int(rng.integers(30, 1900))
        tier = "bulk" if rng.random() < 0.4 else "premium"
        deadline = float(rng.choice([0.02, 0.15, 0.6]))
        timeout = float(rng.choice([0.05, 2.0])) \
            if rng.random() < 0.3 else None
        gap = float(rng.exponential(0.01))
        pump = not (120 <= k < 160) and k % 3 == 0
        out.append((np.zeros((length, nf), np.float32), tier, deadline,
                    timeout, gap, pump))
    return out


def _mb_key(mb):
    return (tuple(r.rid for r in mb.requests), mb.b_rung, mb.t_rung,
            mb.reason, mb.tier)


def _no_ts(rec):
    return {k: v for k, v in rec.items() if k != "ts"}


def _synthetic_run(m, trace_sink=None):
    """The 200-request trace through one package's gateway."""
    clock = Clock()
    tel = m.serving.ServingTelemetry()
    pm = m.res.postmortem.configure(sink=io.StringIO(), registry=tel)
    reps = (m.serving.synthetic_replicas(2, telemetry=tel, tier="premium",
                                         rid_prefix="r", clock=clock)
            + m.serving.synthetic_replicas(1, telemetry=tel, tier="bulk",
                                           rid_prefix="b", clock=clock))
    for rep in reps:
        rep.breaker = m.res.CircuitBreaker(
            name=f"replica_{rep.rid}", failure_threshold=3, cooldown_s=0.5,
            clock=clock, registry=tel)
    pool = m.serving.ReplicaPool(reps, clock=clock, telemetry=tel,
                                 drain_window_s=0.1)
    brown = m.res.BrownoutController(
        enter_pressure=0.5, exit_pressure=0.1, shed_pressure=0.9,
        hold_s=0.1, clock=clock, registry=tel)
    recorder = m.obs.FlightRecorder(capacity=512)
    sched = m.serving.MicroBatchScheduler(
        EDGES, 8, max_queue=32, flush_slack=0.005, default_timeout=1.0,
        max_attempts=3, clock=clock, telemetry=tel,
        retry_backoff=m.res.Retry(base_s=0.02, max_s=0.2, jitter=0.25,
                                  rng=random.Random(5), name="gw"),
        brownout=brown, pool=pool, tier_max_batch={"bulk": 16},
        flight_recorder=recorder)
    plan = m.res.FaultPlan([m.res.FaultSpec("gateway.dispatch", "error",
                                            target="r0", count=4)],
                           seed=3, clock=clock, registry=tel)
    batches, rejected = [], []

    def pump():
        mbs = sched.poll()
        batches.append([_mb_key(mb) for mb in mbs])
        sched.dispatch_many(mbs)

    if trace_sink is not None:
        m.obs.tracer.configure(enabled=True, sink=trace_sink)
    m.res.faults.install(plan)
    try:
        for k, (f, tier, dl, to, gap, do_pump) in enumerate(_requests()):
            clock.advance(gap)
            try:
                sched.submit(f, deadline=dl, timeout=to, tier=tier,
                             rid=f"q{k}")
            except m.serving.OverloadRejected as e:
                rejected.append((k, str(e)))
            if do_pump:
                pump()
        while sched.pending:
            clock.advance(0.05)
            mbs = sched.poll() or sched.flush_all()
            batches.append([_mb_key(mb) for mb in mbs])
            sched.dispatch_many(mbs)
    finally:
        m.res.faults.clear()
        if trace_sink is not None:
            m.obs.tracer.configure(enabled=False)
    # The JAX result also carries an n-best for LM rescoring (slice 6 of
    # the port); the greedy gateway's is None.
    results = {rid: {k: v for k, v in dataclasses.asdict(r).items()
                     if not (k == "nbest" and v is None)}
               for rid, r in sorted(sched.results.items())}
    snap = tel.snapshot()
    out = {
        "batches": batches, "rejected": rejected, "results": results,
        "postmortems": [_no_ts(r) for r in pm.recent()],
        "traces": [_no_ts(r) for r in recorder.recent()],
        "counters": snap["counters"], "gauges": snap["gauges"],
        "per_rung": snap["per_rung"], "histograms": snap["histograms"],
        "pool": pool.stats(), "fired": plan.fired(),
    }
    m.res.postmortem.configure()
    return out, tel


@pytest.fixture(scope="module")
def synthetic():
    return _synthetic_run(JAX)[0], _synthetic_run(PORT)[0]


@pytest.mark.parametrize("key", [
    "batches", "rejected", "results", "postmortems", "traces", "counters",
    "gauges", "per_rung", "histograms", "pool", "fired"])
def test_gateway_matches_jax(synthetic, key):
    want, got = synthetic
    assert got[key] == want[key]


def test_gateway_trace_reaches_every_path(synthetic):
    """The trace is not vacuous: rung-full, deadline, quarantine and
    drain flushes, free-row fill, timeouts, retries, a tripped breaker
    and its drain, brownout sheds and downgrades, queue-full rejections,
    both tiers on their own replicas."""
    _, got = synthetic
    reasons = {mb[3] for step in got["batches"] for mb in step}
    assert reasons == {"full", "deadline", "quarantine", "drain"}
    assert {mb[4] for step in got["batches"] for mb in step} == \
        {"premium", "bulk"}
    statuses = {r["status"] for r in got["results"].values()}
    assert statuses == {"ok", "timeout"}
    assert any(r["attempts"] > 1 for r in got["results"].values())
    c = got["counters"]
    for key in ("filled_free_rows", "retries", "brownout_shed",
                "batch_errors",
                'replica_drains{replica="r0",tier="premium"}'):
        assert c.get(key, 0) > 0, key
    assert any(k.startswith("tier_degraded") for k in c)
    assert any("queue full" in msg for _, msg in got["rejected"])
    kinds = {r["kind"] for r in got["postmortems"]}
    assert kinds == {"quarantined_request", "breaker_open"}
    assert got["fired"] == 4
    for rid, res in got["results"].items():
        if res["status"] == "ok":
            assert res["text"].startswith("len")


def test_pooled_tiered_telemetry_passes_schema_lint():
    """Every record of a pooled, tiered port run (span and trace records,
    the telemetry snapshot, the postmortems) passes the JAX package's
    schema lint."""
    sink = io.StringIO()
    _, tel = _synthetic_run(PORT, trace_sink=sink)
    tel.emit_jsonl(sink)
    lines = [json.loads(x) for x in sink.getvalue().splitlines()]
    events = {rec["event"] for rec in lines}
    assert {"span", "trace", "serving_telemetry"} <= events
    snap = lines[-1]
    assert any('replica="r0"' in k for k in snap["histograms"])
    assert any('tier="bulk"' in k for k in snap["counters"])
    problems = [(rec.get("event"), p) for rec in lines
                for p in validate_record(rec)]
    assert problems == []


def _registry_run(m):
    """Two model groups behind one gateway, each with its own pool of
    synthetic replicas and its own ladder; a typo'd model sheds."""
    clock = Clock()
    tel = m.serving.ServingTelemetry()
    reg = m.serving.ModelRegistry()
    reg.add_group("a", m.serving.ReplicaPool(
        m.serving.synthetic_replicas(2, telemetry=tel, rid_prefix="a",
                                     clock=clock),
        clock=clock, telemetry=tel))
    reg.add_group("b", m.serving.ReplicaPool(
        m.serving.synthetic_replicas(1, telemetry=tel, rid_prefix="b",
                                     clock=clock, tier="bulk"),
        clock=clock, telemetry=tel), bucket_frames=(300, 900),
        max_batch=4, tier_max_batch={"bulk": 2})
    errors = []
    for bad in (lambda: reg.add_group("a", reg.group("a").pool),
                lambda: reg.add_group("c", m.serving.ReplicaPool(
                    m.serving.synthetic_replicas(1, rid_prefix="a")))):
        try:
            bad()
        except ValueError as e:
            errors.append(str(e))
    sched = m.serving.MicroBatchScheduler(
        EDGES, 8, clock=clock, telemetry=tel, registry=reg,
        retry_backoff=m.res.Retry(rng=random.Random(2)),
        flight_recorder=m.obs.FlightRecorder())
    rng = np.random.default_rng(4)
    batches = []
    for k in range(60):
        model = (None, "a", "b")[k % 3]
        tier = "bulk" if model == "b" else None
        clock.advance(0.003)
        try:
            sched.submit(np.zeros((int(rng.integers(20, 1500)), 4),
                                  np.float32),
                         deadline=float(rng.choice([0.01, 0.1])),
                         model=model, tier=tier, rid=f"m{k}",
                         tenant="t1" if k % 5 == 0 and model else None)
        except KeyError as e:
            errors.append(str(e))
        if k % 7 == 6:
            mbs = sched.poll()
            batches.append([_mb_key(mb) + (mb.model,) for mb in mbs])
            sched.dispatch_many(mbs)
    try:
        sched.submit(np.zeros((10, 4), np.float32), model="zz")
    except KeyError as e:
        errors.append(str(e))
    while sched.pending:
        clock.advance(0.05)
        mbs = sched.poll() or sched.flush_all()
        batches.append([_mb_key(mb) + (mb.model,) for mb in mbs])
        sched.dispatch_many(mbs)
    results = {rid: (r.status, r.text, r.attempts)
               for rid, r in sorted(sched.results.items())}
    models = {rep.rid: rep.model for g in reg for rep in g.pool}
    return (batches, results, errors, models, reg.models(),
            [(g.model_id, g.pool.stats()) for g in reg],
            tel.snapshot()["counters"])


def test_model_registry_matches_jax():
    want, got = _registry_run(JAX), _registry_run(PORT)
    assert got == want
    batches, results, errors, models, *_ = got
    assert models == {"a0": "a", "a1": "a", "b0": "b"}
    assert len(errors) == 3
    # Every batch is one model's, on its own ladder.
    for step in batches:
        for rids, b, t, reason, tier, model in step:
            # Past the largest edge: the next multiple of it.
            assert t in ((300, 900, 1800) if model == "b"
                         else EDGES + (3400,))
            assert b <= (2 if model == "b" else 8)
    assert all(st == "ok" for st, _, _ in results.values())


def test_warm_rung_chooser_matches_jax():
    usage = {(4, 800): 3.0, (8, 1700): 1.0}
    lens = list(range(1, 3500, 37))
    rungs = {}
    for name, make in (("jax", jax_warm_rung_chooser),
                       ("port", port_serving.warm_rung_chooser)):
        rungs[name] = [make(EDGES, lambda: usage, max_frames_over=over)(n)
                       for over in (0.0, 0.5, 1.2) for n in lens]
    assert rungs["port"] == rungs["jax"]
    assert {400, 800, 1200, 1700, 3400} <= set(rungs["port"])


def test_scheduler_refuses_later_slices():
    with pytest.raises(NotImplementedError, match="slice 4b"):
        port_serving.MicroBatchScheduler(EDGES, 4, tenancy=object())
    with pytest.raises(NotImplementedError, match="slice 6"):
        port_serving.MicroBatchScheduler(EDGES, 4, rescorer=object())
    pool = port_serving.ReplicaPool(port_serving.synthetic_replicas(1))
    with pytest.raises(NotImplementedError, match="slice 4b"):
        port_serving.PooledSessionRouter(pool, tenancy=object())


# -- replicas bound to real inferencers -----------------------------------

OVER = {"model.rnn_hidden": "32", "model.rnn_layers": "2",
        "model.conv_channels": "4,4", "model.dtype": "float32",
        "model.rnn_impl": "pallas", "data.batch_size": "4",
        "data.bucket_frames": "24,40"}


@pytest.fixture(scope="module")
def tiny_small():
    jcfg = jax_apply_overrides(jax_get_config("ds2_small"), OVER)
    tcfg = apply_overrides(get_config("ds2_small"), OVER)
    params, stats = random_flax_variables(
        jax_create_model(jcfg.model), jnp.zeros((1, 40, 161), jnp.float32),
        jnp.full((1,), 40, jnp.int32), np.random.default_rng(21))
    params = jax.tree.map(np.asarray, params)
    # Spread the logits so no frame's argmax is a near tie.
    params["head"]["kernel"] = params["head"]["kernel"] * 8.0
    return jcfg, tcfg, params, stats


def _inferencer_run(m, make_inferencer, cfg):
    clock = Clock()
    tel = m.serving.ServingTelemetry()
    infs = {"r0": make_inferencer(""), "r1": make_inferencer("int8")}
    reps = [m.serving.Replica.from_inferencer(
        rid, inf, tier="premium" if rid == "r0" else "bulk", clock=clock,
        telemetry=tel) for rid, inf in infs.items()]
    pool = m.serving.ReplicaPool(reps, clock=clock, telemetry=tel)
    sched = m.serving.MicroBatchScheduler(
        cfg.data.bucket_frames, cfg.data.batch_size, clock=clock,
        telemetry=tel, pool=pool,
        retry_backoff=m.res.Retry(rng=random.Random(1)))
    rng = np.random.default_rng(8)
    batches = []
    for k in range(24):
        n = int(rng.integers(8, 41))
        feats = rng.standard_normal((n, 161)).astype(np.float32)
        clock.advance(0.004)
        sched.submit(feats, deadline=float(rng.choice([0.01, 0.05])),
                     tier="bulk" if k % 3 == 1 else "premium",
                     rid=f"u{k}")
        if k % 4 == 3:
            mbs = sched.poll()
            batches.append([_mb_key(mb) for mb in mbs])
            sched.dispatch_many(mbs)
    while sched.pending:
        clock.advance(0.02)
        mbs = sched.poll() or sched.flush_all()
        batches.append([_mb_key(mb) for mb in mbs])
        sched.dispatch_many(mbs)
    texts = {rid: (r.status, r.text) for rid, r in sched.results.items()}
    stats = {rid: inf.shape_cache.stats() for rid, inf in infs.items()}
    labels = {rid: inf.shape_cache.labels for rid, inf in infs.items()}
    return batches, texts, stats, labels


def test_inferencer_replicas_match_jax(tiny_small):
    jcfg, tcfg, params, stats = tiny_small
    want = _inferencer_run(
        JAX, lambda q: JaxInferencer(jcfg, JaxCharTokenizer.english(),
                                     params, stats, quantize=q), jcfg)
    got = _inferencer_run(
        PORT, lambda q: Inferencer(tcfg, CharTokenizer.english(), params,
                                   stats, device="cpu", quantize=q), tcfg)
    batches, texts, shape_stats, labels = got
    assert batches == want[0]
    assert texts == want[1]
    assert shape_stats == want[2]
    assert labels == want[3] == {"r0": {"replica": "r0", "tier": "premium"},
                                 "r1": {"replica": "r1", "tier": "bulk"}}
    assert {s for s, _ in texts.values()} == {"ok"} and len(texts) == 24
    assert any(t for _, t in texts.values())
    assert all(st["compiles"] >= 1 for st in shape_stats.values())


def test_from_inferencer_refuses_warm_store(tiny_small):
    _, tcfg, params, stats = tiny_small
    inf = Inferencer(tcfg, CharTokenizer.english(), params, stats,
                     device="cpu")
    with pytest.raises(NotImplementedError, match="item 17"):
        port_serving.Replica.from_inferencer("r0", inf, warmstore=object())
    rep = port_serving.Replica.from_inferencer("r0", inf)
    # A CPU inferencer decodes on the caller's stream.
    assert rep.stream is None
    assert inf.shape_cache.max_shapes == len(inf.ladder())
