"""The port's asynchronous LM second pass (``serving/rescoring.py``)
against the JAX package's, and the gateway's n-best path into it.

- The pool on scripted offers (the JAX ``tests/test_rescoring.py``
  scripts, run over both packages): revision events equal, each
  ``score_delta`` within 1e-9, sheds by reason (empty n-best, brownout
  rung, quota, full queue), worker assignment, trace ledgers and the
  telemetry counters; two replays give the same revision stream.
- The gateway with ``Replica.from_inferencer(nbest=True)`` on a small
  f32 ``ds2_beam_lm``-shaped ``Inferencer`` (the same numpy weights on
  both sides), with ``rescorer=`` over a character trigram: texts equal
  the JAX gateway's and the port's own ``nbest=False`` run, the n-bests'
  texts equal and their scores within 1e-4, and the revisions equal
  host ``rescore_nbest`` over each request's n-best.
"""

import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeech_tpu.obs.context as jax_ctx
import deepspeech_tpu.resilience as jax_res
import deepspeech_tpu.serving as jax_serving
import deepspeech_tpu_torch.obs.context as port_ctx
import deepspeech_tpu_torch.resilience as port_res
import deepspeech_tpu_torch.serving as port_serving
from deepspeech_tpu.config import apply_overrides as jax_apply_overrides
from deepspeech_tpu.config import get_config as jax_get_config
from deepspeech_tpu.data import CharTokenizer as JaxCharTokenizer
from deepspeech_tpu.decode.ngram import load_lm as jax_load_lm
from deepspeech_tpu.infer import Inferencer as JaxInferencer
from deepspeech_tpu.models import create_model as jax_create_model
from deepspeech_tpu_torch.config import apply_overrides, get_config
from deepspeech_tpu_torch.data import CharTokenizer
from deepspeech_tpu_torch.decode.ngram import load_lm, rescore_nbest
from deepspeech_tpu_torch.infer import Inferencer
from test_torch_model import random_flax_variables
from test_torch_ngram import write_char_arpa

torch.set_num_threads(1)

PKGS = {
    "jax": types.SimpleNamespace(S=jax_serving, R=jax_res, C=jax_ctx,
                                 Inferencer=JaxInferencer,
                                 tok=JaxCharTokenizer, load_lm=jax_load_lm),
    "port": types.SimpleNamespace(S=port_serving, R=port_res, C=port_ctx,
                                  Inferencer=Inferencer, tok=CharTokenizer,
                                  load_lm=load_lm),
}


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class PreferGood:
    """A toy LM: +2 per 'good' token, -0.25 per word."""

    def score_sentence(self, s):
        words = s.split()
        return 2.0 * sum(w == "good" for w in words) - 0.25 * len(words)


# Under PreferGood at alpha=1 the LM flips the order of the two.
NB = [("bad x", 1.0), ("good x", 0.9)]


def _pool(P, clock, **kw):
    kw.setdefault("lm", PreferGood())
    kw.setdefault("alpha", 1.0)
    kw.setdefault("telemetry", P.S.ServingTelemetry())
    return P.S.RescoringPool(clock=clock, **kw)


def _events(evs):
    return [(e.rid, e.old_text, e.new_text, e.score_delta,
             e.rescore_latency, e.model, e.tenant, e.worker, e.to_json())
            for e in evs]


def _try(fn, *a, **kw):
    try:
        return ("ok", fn(*a, **kw))
    except Exception as e:  # the scenario records every outcome
        return (type(e).__name__,)


# -- pool scenarios -----------------------------------------------------------

def scn_offer_pump(P):
    clock = Clock()
    pool = _pool(P, clock)
    out = [pool.offer("r1", NB, "bad x", now=0.0), pool.depth]
    clock.advance(0.5)
    out.append(_events(pool.pump()))
    out.append(pool.offer("r2", [("good x", 1.0), ("bad x", 0.9)],
                          "good x", now=0.5))
    out.append(_events(pool.pump(now=0.5)))
    pool.offer("r3", NB, "bad x", model="a", tenant="gold", now=0.5)
    out.append(_events(pool.pump(now=0.75)))
    # A first-pass text missing from its own n-best (a joined segment).
    pool.offer("r4", NB, "joined segment text", now=1.0)
    out.append(_events(pool.pump(now=1.0)))
    out.append(pool.stats())
    out.append(pool.telemetry.snapshot()["counters"])
    return out


def scn_sheds(P):
    out = []
    pool = _pool(P, Clock(), max_queue=1)
    out += [pool.offer("r1", [], now=0.0), pool.offer("r2", None, now=0.0)]
    out += [pool.offer("r3", NB, now=0.0), pool.offer("r4", NB, now=0.0)]
    out.append(dict(pool.shed))
    out.append(_events(pool.drain(now=0.0)))
    out.append(_try(P.S.RescoringQueue, max_depth=0)[0])
    out.append(_try(P.S.RescoringPool)[0])
    out.append(_try(P.S.RescoringPool, lm=PreferGood(),
                    lm_factory=PreferGood)[0])
    out.append(pool.telemetry.snapshot()["counters"])
    return out


def scn_workers_and_replay(P):
    def run():
        clock = Clock()
        pool = _pool(P, clock, workers=2)
        evs = []
        for i in range(6):
            pool.offer(f"r{i}", [(f"bad {i}", 1.0), (f"good {i}", 0.9)],
                       now=clock())
            clock.advance(0.01)
            evs.extend(pool.pump(now=clock(), max_jobs=1 + i % 2))
        evs.extend(pool.drain(now=clock()))
        return _events(evs)

    made = []
    pool = P.S.RescoringPool(lm_factory=lambda: made.append(1) or
                             PreferGood(), workers=3, clock=Clock())
    return [run(), run(), len(made), len({id(x) for x in pool._lms})]


def scn_to_lm_text(P):
    seen = []

    class SpyLM:
        def score_sentence(self, s):
            seen.append(s)
            return float(len(s))

    pool = P.S.RescoringPool(lm=SpyLM(), alpha=1.0, clock=Clock(),
                             to_lm_text=lambda t: " ".join(t))
    pool.offer("r1", [("ab", 0.0), ("cde", -1.0)], now=0.0)
    return [_events(pool.pump(now=0.0)), seen]


def scn_brownout_rung(P):
    clock = Clock()
    tel = P.S.ServingTelemetry()
    bro = P.R.BrownoutController(enter_pressure=0.75, exit_pressure=0.0,
                                 shed_pressure=0.9, hold_s=0.0,
                                 rescore_pressure=0.4, clock=clock,
                                 registry=tel)
    pool = _pool(P, clock, brownout=bro, telemetry=tel)
    out = []
    for p in (0.5, 0.0, 0.8, 0.3, 0.0):
        clock.advance(1.0)
        bro.update(p, now=clock())
        out.append((bro.level, bro.should_rescore(),
                    pool.offer(f"r{p}", NB, now=clock())))
    out.append(dict(pool.shed))
    bro2 = P.R.BrownoutController(enter_pressure=0.5, exit_pressure=0.0,
                                  shed_pressure=0.9, hold_s=0.0,
                                  clock=clock)
    pool2 = _pool(P, clock, brownout=bro2)
    bro2.update(0.6, now=clock())
    out.append((bro2.level, pool2.offer("q", NB, now=clock()),
                dict(pool2.shed)))
    out.append(_try(P.R.BrownoutController, enter_pressure=0.5,
                    rescore_pressure=0.6)[0])
    snap = tel.snapshot()
    out.append((snap["counters"], snap["gauges"]))
    return out


def scn_tenancy(P):
    clock = Clock()
    ten = P.S.AdmissionController(
        [P.S.TenantConfig("rescore", quota=1, priority="batch")])
    pool = _pool(P, clock, tenancy=ten)
    out = [pool.offer("r1", NB, now=0.0), ten.inflight("rescore"),
           pool.offer("r2", NB, now=0.0), dict(pool.shed)]
    pool.drain(now=0.0)
    out.append(ten.inflight("rescore"))
    stray = _pool(P, Clock(), tenancy=P.S.AdmissionController(
        [P.S.TenantConfig("gold", quota=4, priority="realtime")]),
        tenant="nonexistent")
    out += [stray.offer("r1", NB, now=0.0), dict(stray.shed)]
    # Brownout with tenancy: the batch class sheds at level 1.
    bro = P.R.BrownoutController(enter_pressure=0.5, exit_pressure=0.0,
                                 shed_pressure=0.9, hold_s=0.0,
                                 rescore_pressure=0.5, clock=clock)
    both = _pool(P, clock, tenancy=ten, brownout=bro)
    bro.update(0.55, now=0.0)
    out += [bro.level, both.offer("r3", NB, now=0.0), dict(both.shed)]
    return out


def scn_trace_ledger(P):
    clock = Clock()
    fr = P.C.FlightRecorder(capacity=8)
    pool = _pool(P, clock, flight_recorder=fr)
    pool.offer("r1", NB, "bad x", now=0.0)
    clock.advance(0.2)
    pool.pump()
    # Every field but the wall-clock stamp of the record.
    return [{k: v for k, v in r.items() if k != "ts"}
            for r in fr.recent() if r.get("kind") == "rescore"]


SCENARIOS = [scn_offer_pump, scn_sheds, scn_workers_and_replay,
             scn_to_lm_text, scn_brownout_rung, scn_tenancy,
             scn_trace_ledger]


def _flat(x):
    """Floats of a nested result, and the rest of it with each float
    replaced by a marker, so floats compare within a tolerance."""
    floats = []

    def walk(v):
        if isinstance(v, float):
            floats.append(v)
            return "<f>"
        if isinstance(v, dict):
            return {k: walk(w) for k, w in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(walk(w) for w in v)
        return v

    return walk(x), floats


@pytest.mark.parametrize("scn", SCENARIOS, ids=lambda f: f.__name__[4:])
def test_pool_matches_jax(scn):
    want, wf = _flat(scn(PKGS["jax"]))
    got, gf = _flat(scn(PKGS["port"]))
    assert got == want
    np.testing.assert_allclose(gf, wf, atol=1e-9, rtol=0)


def test_revision_contract():
    out = scn_offer_pump(PKGS["port"])
    (ev,) = out[2]
    assert ev[:3] == ("r1", "bad x", "good x")
    assert ev[3] == pytest.approx(1.9) and ev[4] == pytest.approx(0.5)
    assert out[4] == []                        # the first pass won
    assert out[5][0][8] == {"rid": "r3", "old_text": "bad x",
                            "new_text": "good x", "score_delta": 1.9,
                            "rescore_latency_ms": 250.0, "model": "a",
                            "tenant": "gold"}
    runs = scn_workers_and_replay(PKGS["port"])
    assert runs[0] == runs[1] and runs[2:] == [3, 3]
    assert [e[7] for e in runs[0]] == [0, 1, 0, 1, 0, 1]


# -- the gateway with n-best into the second pass ---------------------------

OVER = {"model.rnn_hidden": "32", "model.rnn_layers": "2",
        "model.conv_channels": "4,4", "model.dtype": "float32",
        "model.rnn_impl": "pallas", "data.batch_size": "4",
        "data.bucket_frames": "24,40", "decode.mode": "beam",
        "decode.beam_width": "8", "decode.nbest": "4"}
ALPHA, BETA = 1.5, 0.5


@pytest.fixture(scope="module")
def beam_setup(tmp_path_factory):
    jcfg = jax_apply_overrides(jax_get_config("ds2_beam_lm"), OVER)
    tcfg = apply_overrides(get_config("ds2_beam_lm"), OVER)
    params, stats = random_flax_variables(
        jax_create_model(jcfg.model), jnp.zeros((1, 40, 161), jnp.float32),
        jnp.full((1,), 40, jnp.int32), np.random.default_rng(31))
    params = jax.tree.map(np.asarray, params)
    params["head"]["kernel"] = params["head"]["kernel"] * 3.0
    arpa = write_char_arpa(tmp_path_factory.mktemp("lm"), with_unk=True)
    return jcfg, tcfg, params, stats, arpa


def _gateway_run(P, cfg, params, stats, arpa, nbest, rescore):
    clock = Clock()
    tel = P.S.ServingTelemetry()
    inf = P.Inferencer(cfg, P.tok.english(), params, stats,
                       **({"device": "cpu"} if P is PKGS["port"] else {}))
    rep = P.S.Replica.from_inferencer("r0", inf, nbest=nbest, clock=clock,
                                      telemetry=tel)
    revisions = []
    rescorer = (P.S.RescoringPool(
        lm=P.load_lm(arpa), alpha=ALPHA, beta=BETA, clock=clock,
        to_lm_text=lambda t: " ".join(t), telemetry=tel)
        if rescore else None)
    sched = P.S.MicroBatchScheduler(
        cfg.data.bucket_frames, cfg.data.batch_size, clock=clock,
        telemetry=tel, pool=P.S.ReplicaPool([rep], clock=clock,
                                            telemetry=tel),
        retry_backoff=P.R.Retry(rng=random.Random(1)), rescorer=rescorer)
    rng = np.random.default_rng(12)
    for k in range(10):
        n = int(rng.integers(8, 41))
        clock.advance(0.004)
        sched.submit(rng.standard_normal((n, 161)).astype(np.float32),
                     deadline=0.01, rid=f"u{k}")
        if k % 4 == 3:
            sched.dispatch_many(sched.poll())
            if rescorer is not None:
                revisions += rescorer.pump()
    while sched.pending:
        clock.advance(0.02)
        sched.dispatch_many(sched.poll() or sched.flush_all())
    if rescorer is not None:
        revisions += rescorer.drain()
    results = {rid: (r.status, r.text, r.nbest)
               for rid, r in sorted(sched.results.items())}
    return results, revisions, rescorer


def test_gateway_nbest_and_revisions_match_jax(beam_setup):
    jcfg, tcfg, params, stats, arpa = beam_setup
    want, want_rev, _ = _gateway_run(PKGS["jax"], jcfg, params, stats,
                                     arpa, True, True)
    got, got_rev, pool = _gateway_run(PKGS["port"], tcfg, params, stats,
                                      arpa, True, True)
    plain, _, _ = _gateway_run(PKGS["port"], tcfg, params, stats, arpa,
                               False, False)
    assert len(got) == 10 and {s for s, _, _ in got.values()} == {"ok"}
    assert ({rid: t for rid, (_, t, _) in got.items()}
            == {rid: t for rid, (_, t, _) in want.items()}
            == {rid: t for rid, (_, t, _) in plain.items()})
    assert all(nb is None for _, _, nb in plain.values())
    for rid, (_, text, nb) in got.items():
        wnb = want[rid][2]
        assert nb[0][0] == text and 1 <= len(nb) <= 4
        assert [t for t, _ in nb] == [t for t, _ in wnb]
        np.testing.assert_allclose([s for _, s in nb], [s for _, s in wnb],
                                   atol=1e-4, rtol=0)
    # Revisions: the same requests, texts and latencies as the JAX pool.
    assert got_rev, "the trigram revised no request: raise ALPHA"
    assert ([(e.rid, e.old_text, e.new_text, e.rescore_latency)
             for e in got_rev]
            == [(e.rid, e.old_text, e.new_text, e.rescore_latency)
                for e in want_rev])
    np.testing.assert_allclose([e.score_delta for e in got_rev],
                               [e.score_delta for e in want_rev],
                               atol=1e-4, rtol=0)
    # Each revision is host rescore_nbest's pick over that n-best.
    lm = load_lm(arpa)
    for e in got_rev:
        best = rescore_nbest(got[e.rid][2], lm, ALPHA, BETA,
                             to_lm_text=lambda t: " ".join(t))[0][0]
        assert e.new_text == best != e.old_text
    st = pool.stats()
    assert st["submitted"] == st["completed"] == 10
    assert st["revised"] == len(got_rev) and st["shed"] == {}


def test_gateway_revisions_replay_identically(beam_setup):
    _, tcfg, params, stats, arpa = beam_setup
    runs = [_gateway_run(PKGS["port"], tcfg, params, stats, arpa, True,
                         True)[1] for _ in range(2)]
    assert _events(runs[0]) == _events(runs[1])


def test_greedy_replica_feeds_one_best(beam_setup):
    """A greedy backend with ``nbest=True`` degrades to 1-best lists:
    offered to the pool, accounted, never revised."""
    _, tcfg, params, stats, arpa = beam_setup
    cfg = apply_overrides(tcfg, {"decode.mode": "greedy"})
    got, revs, pool = _gateway_run(PKGS["port"], cfg, params, stats, arpa,
                                   True, True)
    assert all(nb == [(t, 0.0)] for _, t, nb in got.values())
    assert revs == [] and pool.stats()["completed"] == 10
