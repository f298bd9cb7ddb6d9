"""The port's warm store (``serving/warmstore.py`` over
``utils/aotstore.py`` and ``utils/rung_graph.py``) against the JAX
package's, on the JAX test's tiny inferencer (``tests/test_warmstore.py``:
dev_slice, H=32, 1 layer, conv (4, 4), f32, the ladder ``[(1, 64), (2,
64)]``), the same weights in both packages:

- four scenarios through both packages' ``Replica.from_inferencer`` and
  ``WarmStore`` — the cold run with first-use export, a foreign
  fingerprint, one entry's ``sig`` changed, an ineligible replica — give
  equal summaries, ``compile_cache_*`` counters and labels, ``warm_pct``
  gauges, ``warm_start`` postmortems and ``warm_preload`` timeline
  events;
- the port's restart held to its own contract (the JAX test's restart
  assertion fails in the reference package): texts equal to the cold
  decode, both rungs preloaded, no first use, two hits; a recipe whose
  kernels differ from the capture's, or an entry of another format,
  rejects;
- the records pass ``tools/check_obs_schema.py``'s lint;
- rollout re-admission and autoscale scale-up preload (triggers
  ``rollout_readmit`` and ``scale_up``), a streaming-mode Inferencer is
  ineligible, ``store_tier`` and ``default_store``.

On the CPU a rung is the eager forward, run once (no graph); the card's
capture is ``chip_smoke.py``'s ``warm_restart_phase``.
"""

import dataclasses
import gc
import io
import json
import os
import sys
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeech_tpu.obs.timeline as jax_timeline
import deepspeech_tpu.serving as jax_serving
import deepspeech_tpu_torch.obs.timeline as port_timeline
import deepspeech_tpu_torch.serving as port_serving
from deepspeech_tpu.config import get_config as jax_get_config
from deepspeech_tpu.data import CharTokenizer as JaxCharTokenizer
from deepspeech_tpu.data.infer_bucket import \
    InferBucketPlan as JaxInferBucketPlan
from deepspeech_tpu.infer import Inferencer as JaxInferencer
from deepspeech_tpu.models import create_model as jax_create_model
from deepspeech_tpu.utils import aotstore as jax_aot
from deepspeech_tpu_torch.config import get_config
from deepspeech_tpu_torch.data import CharTokenizer
from deepspeech_tpu_torch.data.infer_bucket import InferBucketPlan
from deepspeech_tpu_torch.infer import Inferencer
from deepspeech_tpu_torch.serving.warmstore import default_store, store_tier
from deepspeech_tpu_torch.utils import aotstore as port_aot

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from check_obs_schema import validate_record  # noqa: E402

torch.set_num_threads(1)

NF = 13
LADDER = [(1, 64), (2, 64)]
FOREIGN = "torch=9.9|cuda=9.9|driver=1|plat=cuda|device=other"


def _tiny(cfg):
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, rnn_hidden=32, rnn_layers=1,
                                  conv_channels=(4, 4), dtype="float32"),
        data=dataclasses.replace(cfg.data, bucket_frames=(64,),
                                 batch_size=2),
        features=dataclasses.replace(cfg.features, num_features=NF),
        decode=dataclasses.replace(cfg.decode, mode="greedy"))


@pytest.fixture(scope="module")
def tiny():
    """The JAX test's tiny inferencer's config and weights, and a maker
    of each package's ``Inferencer`` on them."""
    jcfg = _tiny(jax_get_config("dev_slice"))
    pcfg = _tiny(get_config("dev_slice"))
    variables = jax_create_model(jcfg.model).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, NF), jnp.float32),
        jnp.full((1,), 64, jnp.int32), train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables.get("batch_stats", {}))

    def jax_inf(**kw):
        return JaxInferencer(jcfg, JaxCharTokenizer.english(), params,
                             stats, **kw)

    def port_inf(**kw):
        return Inferencer(pcfg, CharTokenizer.english(), params, stats,
                          device="cpu", **kw)

    return types.SimpleNamespace(
        jax=types.SimpleNamespace(S=jax_serving, tl=jax_timeline,
                                  aot=jax_aot, make=jax_inf,
                                  plan=JaxInferBucketPlan),
        port=types.SimpleNamespace(S=port_serving, tl=port_timeline,
                                   aot=port_aot, make=port_inf,
                                   plan=InferBucketPlan),
        pcfg=pcfg)


def _decode_ladder(P, inf):
    rng = np.random.default_rng(7)
    texts = []
    for b, t in LADDER:
        feats = rng.standard_normal((b, t, NF)).astype(np.float32)
        batch = {"features": feats,
                 "feat_lens": np.full((b,), t, np.int32)}
        texts.extend(inf.decode_batch_bucketed(
            batch, plans=[P.plan(np.arange(b), b, t)]))
    return texts


def _family(tel, family):
    return int(sum(v for k, v in tel.counters.items()
                   if k.split("{", 1)[0] == family))


class _Recorder:
    """Postmortems (``postmortem_fn``) and timeline events of one run."""

    def __init__(self, P):
        self.pms = []
        self.log = P.tl.install(P.tl.EventLog())

    def __call__(self, kind, **ev):
        self.pms.append({"kind": kind, **ev})

    def events(self):
        return [{k: v for k, v in ev.items()
                 if k not in ("t_mono", "t_wall")}
                for ev in self.log.recent() if ev["kind"] == "warm_preload"]


def _observe(tel, summary=None):
    return {"summary": summary, "counters": dict(tel.counters),
            "gauges": dict(tel.gauges)}


def _scenarios(P, root):
    """The four scenarios on one package; returns what each observed."""
    rec = _Recorder(P)
    out = {}
    try:
        # 1. The cold run: every rung a miss, exported at first use.
        tel = P.S.ServingTelemetry()
        ws = P.S.WarmStore(root, preset="dev_slice", background=False,
                           postmortem_fn=rec)
        inf = P.make()
        # The replica stays referenced while it serves: the port's
        # export hook holds it weakly.
        rep = P.S.Replica.from_inferencer("r0", inf, telemetry=tel,
                                          warmstore=ws)
        _decode_ladder(P, inf)
        ws.flush()
        out["cold"] = {**_observe(tel), "compiles": inf.shape_cache.compiles,
                       "keys": [k.filename() for k in ws.store.keys()]}
        # 2. A foreign fingerprint: every rung rejects, nothing loads.
        tel = P.S.ServingTelemetry()
        foreign = P.S.WarmStore(root, preset="dev_slice", background=False,
                                fingerprint=FOREIGN, postmortem_fn=rec)
        inf = P.make()
        rep = P.S.Replica.from_inferencer("r0", inf, telemetry=tel,
                                          warmstore=None)
        out["foreign"] = {**_observe(tel, foreign.preload_replica(rep)),
                          "preloaded": sorted(inf.preloaded_forwards)}
        # 3. One entry's sig changed: exactly that rung rejects.
        key = P.aot.StoreKey("dev_slice", "fp", "base", *LADDER[0])
        meta, payload = ws.store.get(key)
        ws.store.put(key, payload, meta["format"], sig="0000deadbeef0000")
        try:
            tel = P.S.ServingTelemetry()
            inf = P.make()
            P.S.Replica.from_inferencer("r0", inf, telemetry=tel,
                                        warmstore=ws)
        finally:
            ws.store.put(key, payload, meta["format"], sig=meta["sig"])
        out["sig"] = {**_observe(tel),
                      "preloaded": sorted(inf.preloaded_forwards)}
        # 4. A replica without an Inferencer is ineligible.
        rep = P.S.Replica("stream0", decode_fn=lambda batch, plan: [])
        out["ineligible"] = {**_observe(rep.telemetry,
                                        ws.preload_replica(rep)),
                             "hook": ws.install_export_hook(rep)}
        out["postmortems"] = [{k: v for k, v in pm.items()}
                              for pm in rec.pms]
        out["timeline"] = rec.events()
    finally:
        P.tl.clear()
    return out


@pytest.fixture(scope="module")
def scenarios(tiny, tmp_path_factory):
    # Scenario 2 builds its replica with no store, so it must see no
    # process default ("" is none in both packages).
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DS2_WARMSTORE_DIR", "")
        return {name: _scenarios(getattr(tiny, name),
                                 str(tmp_path_factory.mktemp(name)))
                for name in ("jax", "port")}


@pytest.mark.parametrize("part", ["cold", "foreign", "sig", "ineligible",
                                  "postmortems", "timeline"])
def test_scenarios_match_jax(scenarios, part):
    got, want = scenarios["port"][part], scenarios["jax"][part]
    assert got == want


def test_scenarios_are_not_vacuous(scenarios):
    got = scenarios["port"]
    cold = got["cold"]
    assert _sum(cold["counters"], "compile_cache_miss") == 2
    assert _sum(cold["counters"], "compile_cache_export") == 2
    assert cold["compiles"] == 2 and len(cold["keys"]) == 2
    assert got["foreign"]["summary"]["rejects"] == 2
    assert got["foreign"]["preloaded"] == []
    assert _sum(got["sig"]["counters"], "compile_cache_reject") == 1
    assert got["sig"]["preloaded"] == [LADDER[1]]
    assert got["ineligible"]["summary"] == {"eligible": False, "hits": 0}
    assert not got["ineligible"]["hook"]
    assert [pm["kind"] for pm in got["postmortems"]] == ["warm_start"] * 3
    assert [ev["detail"]["warm_pct"] for ev in got["timeline"]] == [
        0.0, 0.0, 50.0]


def _sum(counters, family):
    return sum(v for k, v in counters.items()
               if k.split("{", 1)[0] == family)


@pytest.fixture(scope="module")
def populated(tiny, tmp_path_factory):
    """The port's cold run: export both rungs at first use; returns the
    store's root and the cold texts."""
    root = str(tmp_path_factory.mktemp("populated"))
    ws = port_serving.WarmStore(root, preset="dev_slice", background=False)
    inf = tiny.port.make()
    rep = port_serving.Replica.from_inferencer("r0", inf, warmstore=ws)
    texts = _decode_ladder(tiny.port, inf)
    ws.flush()
    assert len(ws.store.keys()) == len(LADDER)
    return root, texts


def test_restart_preloads_ladder_and_decodes_the_same(tiny, populated):
    """The port's own restart contract: every rung preloaded before
    admission, texts equal to the cold decode, no first use, a hit a
    rung, labelled counters and a full warm_pct."""
    root, cold = populated
    tel = port_serving.ServingTelemetry()
    ws = port_serving.WarmStore(root, preset="dev_slice", background=False)
    inf = tiny.port.make()
    rep = port_serving.Replica.from_inferencer("r0", inf, telemetry=tel,
                                               warmstore=ws)
    assert sorted(inf.preloaded_forwards) == LADDER
    assert inf.shape_cache.preloaded == len(LADDER)
    # The eager forward of each rung ran once at preload: the store's
    # contract on the CPU, where there is no graph.
    assert all(g.graph is None and g.kernels == {}
               for g in inf.preloaded_forwards.values())
    assert _decode_ladder(tiny.port, inf) == cold
    assert inf.shape_cache.compiles == 0
    assert _family(tel, "compile_cache_hit") == len(LADDER)
    assert all("rung=" in k and "tier=" in k for k in tel.counters)
    assert tel.gauges['warm_pct{replica="r0",tier="fp"}'] == 100.0
    assert rep.can_route(0.0)


@pytest.mark.parametrize("store", ["preloaded", "exported"])
def test_dropped_replica_frees_its_inferencer_at_once(tiny, populated,
                                                      tmp_path, store):
    """No reference cycle through the store's wiring: once its replica
    is dropped, a preloaded Inferencer (its rungs hold its forward) or
    one whose export hook fired (the hook names the replica) is freed by
    reference counting, with the cyclic GC off; on the card that frees
    its weights and graph pool when a rollout or scale-down lets go."""
    root = populated[0] if store == "preloaded" else str(tmp_path)
    ws = port_serving.WarmStore(root, preset="dev_slice")
    gc.collect()
    gc.disable()
    try:
        inf = tiny.port.make()
        rep = port_serving.Replica.from_inferencer("r0", inf, warmstore=ws)
        assert inf.export_hook is not None
        texts = _decode_ladder(tiny.port, inf)
        ws.flush()
        if store == "preloaded":
            assert sorted(inf.preloaded_forwards) == LADDER
            assert inf.shape_cache.compiles == 0
        else:
            assert sorted(inf.rung_kernels) == LADDER
            assert sorted(ws.store.rungs("dev_slice", "fp", "base")) == \
                LADDER
        gone = weakref.ref(inf)
        del inf, rep
        assert gone() is None
    finally:
        gc.enable()
    assert texts == populated[1]


def test_recipe_is_what_the_first_use_ran(tiny, populated):
    root, _ = populated
    store = port_aot.AotStore(root)
    inf = tiny.port.make()
    for b, t in LADDER:
        meta, payload = store.get(port_aot.StoreKey("dev_slice", "fp",
                                                    "base", b, t))
        recipe = port_aot.deserialize_entry(meta, payload)
        assert recipe == {"args": [[[b, t, NF], "float32"], [[b], "int64"]],
                          "kernel_regime": "fp", "kernels": {},
                          "pool_bytes": None}
        assert meta["sig"] == inf.forward_signature()
        assert meta["format"] == "cuda_graph"


@pytest.mark.parametrize("tamper", ["kernels", "kernel_regime", "args",
                                    "format"])
def test_recipe_mismatch_rejects_and_installs_nothing(tiny, populated,
                                                      tmp_path, tamper):
    """A capture that launched other kernels than the recipe records (or
    another argument shape or regime), or an entry of another format,
    counts a reject and leaves the rung eager."""
    import shutil

    root = str(tmp_path / "store")
    shutil.copytree(populated[0], root)
    store = port_aot.AotStore(root)
    key = port_aot.StoreKey("dev_slice", "fp", "base", *LADDER[1])
    meta, payload = store.get(key)
    recipe = port_aot.deserialize_entry(meta, payload)
    fmt = meta["format"]
    if tamper == "kernels":
        recipe["kernels"] = {"gru_fwd": 1}
    elif tamper == "kernel_regime":
        recipe["kernel_regime"] = "resident-q"
    elif tamper == "args":
        recipe["args"][0][0][2] = NF + 1
    store.put(key, port_aot.serialize_recipe(recipe), fmt, sig=meta["sig"])
    if tamper == "format":
        path = os.path.join(store.fp_dir, key.filename())
        with open(path, "rb") as fh:
            meta = json.loads(fh.readline())
        with open(path, "wb") as fh:
            fh.write(json.dumps({**meta, "format": "xc"}).encode() + b"\n")
    tel = port_serving.ServingTelemetry()
    inf = tiny.port.make()
    rep = port_serving.Replica.from_inferencer(
        "r0", inf, telemetry=tel, warmstore=port_serving.WarmStore(
            root, preset="dev_slice", background=False))
    assert sorted(inf.preloaded_forwards) == [LADDER[0]]
    assert _family(tel, "compile_cache_reject") == 1
    assert 'compile_cache_reject{replica="r0",rung="2x64",tier="fp"}' \
        in tel.counters
    assert _decode_ladder(tiny.port, inf) == populated[1]
    assert inf.shape_cache.compiles == 1


def test_records_pass_schema_lint(tiny, populated):
    """The telemetry snapshot, the warm_start postmortems and the
    timeline records of a preload pass the JAX package's lint."""
    root, _ = populated
    pms = []
    log = port_timeline.install(port_timeline.EventLog())
    try:
        tel = port_serving.ServingTelemetry()
        for rid, tier, q in (("r0", "premium", ""), ("r1", "bulk", "int8")):
            port_serving.Replica.from_inferencer(
                rid, tiny.port.make(quantize=q), tier=tier, telemetry=tel,
                warmstore=port_serving.WarmStore(
                    root, preset="dev_slice", background=False,
                    postmortem_fn=lambda kind, **ev: pms.append(
                        {"event": "postmortem", "ts": 1.0, "kind": kind,
                         **ev})))
        events = [port_timeline.EventLog.to_record(ev)
                  for ev in log.recent()]
    finally:
        port_timeline.clear()
    sink = io.StringIO()
    tel.emit_jsonl(sink)
    records = [json.loads(x) for x in sink.getvalue().splitlines()]
    records += pms + events
    assert [p for r in records for p in validate_record(r)] == []
    assert {r["kind"] for r in pms} == {"warm_start"}
    assert any('tier="bulk"' in k and k.startswith("compile_cache_miss")
               for k in records[0]["counters"])


def test_streaming_inferencer_is_ineligible(tiny, tmp_path):
    """A decode.mode='streaming' Inferencer never runs the offline
    forward: it has no preloaded_forwards, and the store passes it by
    (the JAX one would install executables it never calls)."""
    cfg = dataclasses.replace(tiny.pcfg, decode=dataclasses.replace(
        tiny.pcfg.decode, mode="streaming", chunk_frames=32))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, bidirectional=False, lookahead_context=2))
    from deepspeech_tpu_torch.bridge import init_params

    inf = Inferencer(cfg, CharTokenizer.english(),
                     *init_params(cfg, torch.Generator().manual_seed(0)),
                     device="cpu")
    assert not hasattr(inf, "preloaded_forwards")
    ws = port_serving.WarmStore(str(tmp_path), background=False)
    tel = port_serving.ServingTelemetry()
    rep = port_serving.Replica.from_inferencer("s0", inf, telemetry=tel,
                                               warmstore=ws)
    assert ws.preload_replica(rep) == {"eligible": False, "hits": 0}
    assert ws.install_export_hook(rep) is False
    assert ws.export_ladder(rep) == 0
    assert not tel.counters
    with pytest.raises(ValueError, match="streaming"):
        inf.compile_rung(1, 64)


def test_export_ladder_captures_offline(tiny, tmp_path):
    """``export_ladder`` writes every rung with no first use (the
    rung's recipe from its capture), and a restart preloads it."""
    root = str(tmp_path)
    ws = port_serving.WarmStore(root, preset="dev_slice", background=False)
    inf = tiny.port.make()
    rep = port_serving.Replica.from_inferencer("r0", inf, warmstore=None)
    assert ws.export_ladder(rep) == len(LADDER)
    assert inf.shape_cache.compiles == 0
    meta, payload = ws.store.get(port_aot.StoreKey("dev_slice", "fp",
                                                   "base", *LADDER[0]))
    assert port_aot.deserialize_entry(meta, payload)["pool_bytes"] == 0
    tel = port_serving.ServingTelemetry()
    port_serving.Replica.from_inferencer("r1", tiny.port.make(),
                                         telemetry=tel, warmstore=ws)
    assert _family(tel, "compile_cache_hit") == len(LADDER)


def test_background_export_waits_for_the_first_use(tiny, tmp_path):
    """The hook fires once the rung's first forward has run and been
    tallied; with background threads the recipe is written after it."""
    ws = port_serving.WarmStore(str(tmp_path), preset="dev_slice")
    inf = tiny.port.make()
    tel = port_serving.ServingTelemetry()
    rep = port_serving.Replica.from_inferencer("r0", inf, telemetry=tel,
                                               warmstore=ws)
    _decode_ladder(tiny.port, inf)
    ws.flush()
    assert sorted(ws.store.rungs("dev_slice", "fp", "base")) == LADDER
    assert _family(tel, "compile_cache_export") == len(LADDER)
    assert sorted(inf.rung_kernels) == LADDER


def _inferencer_pool(P, tiny, n, clock, tel, version="v1"):
    reps = [P.S.Replica.from_inferencer(f"r{k}", tiny.port.make(),
                                        telemetry=tel, clock=clock)
            for k in range(n)]
    pool = P.S.ReplicaPool(reps, clock=clock, telemetry=tel,
                           drain_window_s=0.0)
    for rep in pool:
        rep.version = version
    return pool


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _v2_store(tiny, root):
    """A store holding the v2 ladder, written offline."""
    ws = port_serving.WarmStore(root, preset="dev_slice", background=False)
    rep = port_serving.Replica.from_inferencer("w", tiny.port.make())
    rep.version = "v2"
    assert ws.export_ladder(rep) == len(LADDER)
    return ws


def test_rollout_readmission_preloads(tiny, tmp_path):
    """A rolling swap re-admits each replica with the new version's
    ladder preloaded (trigger rollout_readmit) into the swapped-in
    Inferencer; the old Inferencer keeps its own."""
    P = tiny.port
    clock, tel, pms = _Clock(), P.S.ServingTelemetry(), []
    pool = _inferencer_pool(P, tiny, 2, clock, tel)
    old = {rep.rid: rep.inferencer for rep in pool}
    ws = _v2_store(tiny, str(tmp_path))
    ws._postmortem = lambda kind, **ev: pms.append((kind, ev))

    def factory(rep):
        inf = tiny.port.make()
        return {"decode_fn": lambda batch, plan, inf=inf:
                inf.decode_batch_bucketed(batch, plans=[plan]),
                "inferencer": inf, "session_factory": None}

    ro = P.S.RolloutController(pool, factory, to_version="v2", clock=clock,
                               warmstore=ws, postmortem_fn=lambda *a, **k:
                               None)
    ro.start()
    for _ in range(50):
        if ro.state in ("done", "rolled_back"):
            break
        clock.t += 0.3
        ro.tick()
    assert ro.state == "done"
    assert [(k, ev["trigger"], ev["version"], ev["warm_pct"])
            for k, ev in pms] == [("warm_start", "rollout_readmit", "v2",
                                   100.0)] * 2
    for rep in pool:
        assert rep.version == "v2"
        assert sorted(rep.inferencer.preloaded_forwards) == LADDER
        assert not old[rep.rid].preloaded_forwards
    assert _family(tel, "compile_cache_hit") == 2 * len(LADDER)


def test_autoscale_scale_up_preloads(tiny, tmp_path):
    """A scale-up newcomer preloads its ladder (trigger scale_up) before
    the pool routes to it."""
    P = tiny.port
    clock, tel, pms = _Clock(), P.S.ServingTelemetry(), []
    pool = _inferencer_pool(P, tiny, 1, clock, tel, version=None)
    root = str(tmp_path)
    ws = port_serving.WarmStore(root, preset="dev_slice", background=False,
                                postmortem_fn=lambda kind, **ev: pms.append(
                                    (kind, ev)))
    assert ws.export_ladder(list(pool)[0]) == len(LADDER)
    admitted = []
    add = pool.add_replica

    def add_replica(rep):
        # What the newcomer holds when the pool makes it routable.
        admitted.append((rep.rid, sorted(rep.inferencer.preloaded_forwards)))
        return add(rep)

    pool.add_replica = add_replica

    def factory(rid):
        return P.S.Replica.from_inferencer(rid, tiny.port.make(),
                                           telemetry=tel, clock=clock)

    class Sched:
        max_queue, pending, max_batch = 8, 8, 2
        tier_max_batch, tier_shift = {}, {}

        def set_max_queue(self, n):
            self.max_queue = max(int(n), self.pending, 1)
            return self.max_queue

    ctrl = P.S.AutoscaleController(
        pool, factory, telemetry=tel, clock=clock, min_replicas=1,
        max_replicas=2, hold_s=0.05, cooldown_s=1.0, scheduler=Sched(),
        warmstore=ws, postmortem_fn=lambda *a, **k: None)
    for t in (0.0, 0.1, 0.2):
        clock.t = t
        ctrl.tick()
    assert ctrl.scale_ups == 1 and len(pool) == 2
    rid, forwards = admitted[0]
    assert forwards == LADDER
    assert [(k, ev["trigger"], ev["replica"], ev["warm_pct"])
            for k, ev in pms] == [("warm_start", "scale_up", rid, 100.0)]


def test_store_tier_keys_by_quality_then_numeric_family(tiny):
    assert store_tier(tiny.port.make(quantize="int8"), None) == "int8"
    assert store_tier(tiny.port.make(), None) == "fp"
    assert store_tier(tiny.port.make(quantize="int8"), "premium") == \
        "premium"


def test_default_store_reads_env(tiny, tmp_path, monkeypatch):
    monkeypatch.delenv("DS2_WARMSTORE_DIR", raising=False)
    assert default_store() is None
    monkeypatch.setenv("DS2_WARMSTORE_DIR", str(tmp_path / "ws"))
    ws = default_store()
    assert isinstance(ws, port_serving.WarmStore)
    assert ws.store.root == str(tmp_path / "ws")
    # from_inferencer takes the process default when given none.
    tel = port_serving.ServingTelemetry()
    port_serving.Replica.from_inferencer("r0", tiny.port.make(),
                                         telemetry=tel)
    assert _family(tel, "compile_cache_miss") == len(LADDER)
