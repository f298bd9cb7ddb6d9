"""The port's multi-tenant admission (``serving/tenancy.py``), the
registry's controller bookkeeping (``GroupState``'s hold-off scans), and
the tenancy branches of its gateway and streaming router, against the
JAX package's on the same scripts and the same virtual clock.

Each scenario runs once over the JAX package's modules and once over the
port's, and returns what it observed: admission decisions, sheds by
reason, the fair order of a contended flush, quota counts, results and
the telemetry counters. The two must be equal item for item.
"""

import json
import types

import numpy as np
import pytest
import torch

import deepspeech_tpu.resilience as jax_res
import deepspeech_tpu.serving as jax_serving
import deepspeech_tpu_torch.resilience as port_res
import deepspeech_tpu_torch.serving as port_serving

torch.set_num_threads(1)

PKGS = {"jax": types.SimpleNamespace(S=jax_serving, R=jax_res),
        "port": types.SimpleNamespace(S=port_serving, R=port_res)}
EDGES = (16, 32)
NF = 8


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _feat(n=8):
    return np.zeros((n, NF), np.float32)


def _echo(tag):
    def fn(batch, plan):
        return [f"{tag}"] * plan.n_valid
    return fn


def _replica(P, rid, tag, tel, clock, **kw):
    return P.S.Replica(rid, _echo(tag), telemetry=tel, clock=clock,
                       breaker=P.R.CircuitBreaker(
                           name=f"b_{rid}", failure_threshold=2,
                           cooldown_s=1.0, clock=clock, registry=tel),
                       **kw)


def _registry(P, clock, tel, models=("a", "b"), n=2):
    reg = P.S.ModelRegistry()
    for mid in models:
        pool = P.S.ReplicaPool(
            [_replica(P, f"{mid}-r{k}", mid, tel, clock)
             for k in range(n)], clock=clock, telemetry=tel)
        reg.add_group(mid, pool)
    return reg


def _tenancy(P, **quotas):
    T = P.S.TenantConfig
    return P.S.AdmissionController([
        T("gold", quota=quotas.get("gold", 4), priority="realtime",
          weight=2.0),
        T("silver", quota=quotas.get("silver", 4), priority="standard"),
        T("bulk", quota=quotas.get("bulk", 8), priority="batch",
          weight=0.5)])


def _sched(P, clock, tel, reg=None, ten=None, **kw):
    return P.S.MicroBatchScheduler(EDGES, 4, max_queue=16,
                                   default_deadline=0.05, clock=clock,
                                   telemetry=tel, registry=reg,
                                   tenancy=ten, **kw)


def _try(fn, *a, **kw):
    """What a call gave: ("ok", value) or (exception type name, text)."""
    try:
        return ("ok", fn(*a, **kw))
    except Exception as e:  # the scenario records every outcome
        return (type(e).__name__, str(e))


def _results(sched):
    return {rid: (r.status, r.text, r.attempts)
            for rid, r in sorted(sched.results.items())}


class _Req:
    def __init__(self, tenant, n):
        self.tenant = tenant
        self.n = n


# -- the scenarios -----------------------------------------------------------

def scn_controller(P, tmp_path):
    """Quotas, peaks, defaults, the staged shed table, from_file."""
    out = []
    ten = P.S.AdmissionController([P.S.TenantConfig("acme", quota=2)])
    for _ in range(3):
        out.append(_try(ten.charge, "acme")[0])
    out.append((ten.inflight("acme"), ten.peak("acme")))
    for _ in range(4):
        ten.release("acme")
        ten.release("ghost")
    out.append(_try(ten.charge, "ghost")[0])
    out.append(ten.stats())
    ten = _tenancy(P)
    out.append([ten.default_deadline(t) for t in ("gold", "silver",
                                                  "bulk")])
    out.append([[ten.sheds_at(t, lvl) for lvl in range(4)]
                for t in ("gold", "silver", "bulk")])
    ten2 = P.S.AdmissionController([P.S.TenantConfig(
        "t", deadline=0.123, tier="bulk")])
    out.append((ten2.default_deadline("t"), ten2.default_tier("t")))
    for bad in ({"tenant": ""}, {"tenant": "x", "quota": 0},
                {"tenant": "x", "priority": "vip"},
                {"tenant": "x", "weight": 0.0}):
        out.append(_try(P.S.TenantConfig, **bad)[0])
    p = tmp_path / f"tenants_{P.S.__name__}.json"
    p.write_text(json.dumps({"tenants": [
        {"tenant": "acme", "quota": 8, "priority": "realtime",
         "weight": 2.0}, {"tenant": "zed"}]}))
    ft = P.S.AdmissionController.from_file(str(p))
    out.append((ft.tenants(), ft.weight("acme"), ft.quota("zed")
                if hasattr(ft, "quota") else None))
    return out


def scn_fair_select(P, tmp_path):
    """Stride order: a 2:1 split, an idle tenant re-entering at the
    floor, and the passthrough that still advances virtual time."""
    out = []
    ten = P.S.AdmissionController([P.S.TenantConfig("heavy", weight=2.0),
                                   P.S.TenantConfig("light")])
    reqs = ([_Req("heavy", i) for i in range(6)]
            + [_Req("light", i) for i in range(6)])
    for n in (6, 5, 3):
        out.append([(r.tenant, r.n) for r in ten.fair_select(reqs, n)])
    ten = P.S.AdmissionController([P.S.TenantConfig("busy"),
                                   P.S.TenantConfig("idle")])
    for _ in range(4):
        ten.fair_select([_Req("busy", 0), _Req("busy", 1)], 1)
    reqs = ([_Req("busy", i) for i in range(4)]
            + [_Req("idle", i) for i in range(4)])
    out.append([(r.tenant, r.n) for r in ten.fair_select(reqs, 4)])
    ten = P.S.AdmissionController([P.S.TenantConfig("a"),
                                   P.S.TenantConfig("b")])
    ten.fair_select([_Req("b", 0)], 8)
    ten.fair_select([_Req("a", i) for i in range(4)], 8)
    out.append([r.tenant for r in ten.fair_select(
        [_Req("a", 0), _Req("b", 0), _Req("b", 1)], 2)])
    return out


def scn_group_state(P, tmp_path):
    """The breaker scans and the controllers' hold-off probes."""
    out = []
    clock = Clock()
    tel = P.S.ServingTelemetry()
    rep = _replica(P, "r0", "x", tel, clock)
    gs = P.S.GroupState()
    gs.note_replica(rep)
    rep.breaker.record_failure()
    rep.breaker.record_failure()
    out.append([r.rid for r in gs.newly_opened([rep])])
    out.append(gs.newly_opened([rep]))
    out.append(gs.breaker_cooldown_reason([rep], clock()))
    out.append(gs.breaker_cooldown_reason([rep], clock(), skip=(rep,)))
    out.append(gs.breaker_holds_out(rep, clock()))
    clock.t += 2.0
    out.append(gs.breaker_cooldown_reason([rep], clock.t))
    reasons = {"rollout": None, "autoscale": None}
    gs.attach("rollout", lambda: reasons["rollout"])
    gs.attach("autoscale", lambda: reasons["autoscale"])
    out.append(gs.holdoff_reason())
    reasons["rollout"] = "rollout_running"
    out.append(gs.holdoff_reason())
    out.append(gs.holdoff_reason(exclude=("rollout",)))
    reasons["autoscale"] = "autoscale_drain_r1"
    out.append(gs.holdoff_reason(exclude=("rollout",)))
    gs.detach("autoscale")
    out.append(gs.holdoff_reason(exclude=("rollout",)))
    # Both controllers attach their probes to the pool's shared state,
    # and the group's stats carry them.
    pool = P.S.ReplicaPool([_replica(P, f"m-r{k}", "m", tel, clock)
                            for k in range(3)], clock=clock,
                           telemetry=tel)
    group = P.S.ModelGroup("m", pool)
    group.rollout = P.S.RolloutController(
        pool, lambda rep: {"decode_fn": _echo("v2")}, to_version="v2",
        clock=clock, telemetry=tel)
    group.autoscale = P.S.AutoscaleController(
        pool, lambda rid: _replica(P, rid, "m", tel, clock),
        min_replicas=1, max_replicas=4, clock=clock, telemetry=tel)
    out.append(sorted(pool.group._probes))
    out.append(pool.group.holdoff_reason())
    st = group.stats()
    out.append((st["rollout"], st["autoscale"]["state"]))
    return out


def scn_quota_lifecycle(P, tmp_path):
    """Charge at submit, release at the terminal result, the shed on
    quota with its counters, and the tenant's defaults."""
    out = []
    clock = Clock()
    tel = P.S.ServingTelemetry()
    reg = _registry(P, clock, tel)
    ten = _tenancy(P, gold=2)
    sched = _sched(P, clock, tel, reg=reg, ten=ten)
    for _ in range(3):
        out.append(_try(sched.submit, _feat(), model="a", tenant="gold"))
    out.append(_try(sched.submit, _feat(), model="typo")[0])
    out.append(_try(sched.submit, _feat(), tenant="ghost")[0])
    out.append(ten.inflight("gold"))
    sched.drain()
    out.append((ten.inflight("gold"), ten.peak("gold")))
    rt = P.S.AdmissionController([P.S.TenantConfig(
        "t", quota=4, priority="realtime", tier="bulk")])
    s2 = _sched(P, clock, tel, reg=_registry(P, clock, tel,
                                             models=("c",)), ten=rt)
    s2.submit(_feat(), model="c", tenant="t")
    ((qkey, rungs),) = s2._pending.items()
    ((_, (req,)),) = rungs.items()
    out.append((qkey, req.deadline, req.tier))
    s2.drain()
    out.append(_results(sched))
    out.append(_results(s2))
    out.append(tel.snapshot()["counters"])
    return out


def scn_staged_shed(P, tmp_path):
    """Brownout sheds by priority class: batch at level 1, standard at
    level 2, realtime never."""
    out = []
    clock = Clock()
    tel = P.S.ServingTelemetry()
    reg = _registry(P, clock, tel)
    ten = _tenancy(P, gold=8, silver=8, bulk=16)
    bro = P.R.BrownoutController(enter_pressure=0.5, exit_pressure=0.0,
                                 shed_pressure=0.75, hold_s=0.0,
                                 clock=clock, registry=tel)
    sched = _sched(P, clock, tel, reg=reg, ten=ten, brownout=bro)
    script = ([("a", "bulk")] * 9 + [("b", "silver")] + [("a", "gold")] * 3
              + [("b", "silver"), ("a", "gold"), ("a", "bulk")])
    for mid, tenant in script:
        out.append((_try(sched.submit, _feat(), model=mid,
                         tenant=tenant)[0], bro.level))
    sched.drain()
    out.append([ten.inflight(t) for t in ("gold", "silver", "bulk")])
    out.append(_results(sched))
    out.append(tel.snapshot()["counters"])
    return out


def scn_fair_flush(P, tmp_path):
    """A contended rung flushes weighted-fair: gold is not starved by
    eight bulk requests queued ahead of it."""
    clock = Clock()
    tel = P.S.ServingTelemetry()
    reg = _registry(P, clock, tel, models=("a",))
    ten = _tenancy(P, gold=8, bulk=16)
    sched = _sched(P, clock, tel, reg=reg, ten=ten)
    for _ in range(8):
        sched.submit(_feat(8), model="a", tenant="bulk")
    for _ in range(4):
        sched.submit(_feat(8), model="a", tenant="gold")
    mbs = sched.poll()
    order = [[(r.rid, r.tenant) for r in mb.requests] for mb in mbs]
    sched.dispatch_many(mbs)
    sched.drain()
    return [order, _results(sched), ten.stats()]


def scn_set_max_queue(P, tmp_path):
    """The autoscaler's capacity shrink, landing inside a submit, never
    cuts below the admitted backlog, and the racing submit sheds before
    its quota charge."""
    out = []
    tel = P.S.ServingTelemetry()
    vclock = Clock()
    box, fire = {}, {"arm": False, "applied": None}

    def clock():
        if fire["arm"]:
            fire["arm"] = False
            fire["applied"] = box["s"].set_max_queue(2)
        return vclock()

    reg = _registry(P, clock, tel, models=("a",))
    ten = _tenancy(P, gold=8, bulk=8)
    sched = P.S.MicroBatchScheduler(EDGES, 4, max_queue=16,
                                    default_deadline=0.05, clock=clock,
                                    telemetry=tel, registry=reg,
                                    tenancy=ten)
    box["s"] = sched
    for t in ("bulk", "gold") * 3:
        sched.submit(_feat(), model="a", tenant=t)
    fire["arm"] = True
    out.append(_try(sched.submit, _feat(), model="a", tenant="bulk")[0])
    out.append((fire["applied"], sched.max_queue, ten.inflight("bulk")))
    sched.drain()
    out.append(sched.set_max_queue(2))
    out.append(sched.set_max_queue(40))
    out.append(_results(sched))
    out.append(tel.snapshot()["counters"])
    out.append(tel.snapshot()["gauges"].get("gateway_capacity"))
    return out


class _FakeMgr:
    """A session manager good enough for routing."""

    def __init__(self):
        self._text = {}

    def join(self, sid):
        self._text[sid] = []

    def step(self, chunks):
        out = {}
        for sid in chunks:
            if sid in self._text:
                self._text[sid].append("p")
                out[sid] = "p"
        return out

    def flush(self):
        return {}

    def leave(self, sid, tail=None):
        pass

    def final(self, sid):
        return " ".join(self._text.pop(sid))

    def stats(self):
        return {"active": len(self._text), "draining": 0}


def scn_router_quota(P, tmp_path):
    """The streaming router charges one unit a session at join and
    releases it at leave; an over-quota join sheds."""
    out = []
    clock = Clock()
    tel = P.S.ServingTelemetry()
    reg = P.S.ModelRegistry()
    for mid in ("a", "b"):
        reg.add_group(mid, P.S.ReplicaPool(
            [P.S.Replica(f"{mid}-r{k}", _echo(mid), telemetry=tel,
                         clock=clock, session_factory=_FakeMgr)
             for k in range(2)], clock=clock, telemetry=tel))
    ten = P.S.AdmissionController([P.S.TenantConfig("acme", quota=1)])
    router = P.S.PooledSessionRouter(registry=reg, tenancy=ten)
    out.append(router.join("s1", model="b", tenant="acme"))
    out.append(_try(router.join, "s2", model="a", tenant="acme")[0])
    out.append(ten.inflight("acme"))
    router.step({"s1": np.zeros((4, NF), np.float32)})
    router.leave("s1")
    router.flush()
    out.append((router.final("s1"), router.final_nbest("s1")))
    out.append(ten.inflight("acme"))
    out.append(router.join("s3", model="a", tenant="acme"))
    router.leave("s3")
    out.append((ten.inflight("acme"), ten.stats()))
    return out


SCENARIOS = [scn_controller, scn_fair_select, scn_group_state,
             scn_quota_lifecycle, scn_staged_shed, scn_fair_flush,
             scn_set_max_queue, scn_router_quota]


@pytest.mark.parametrize("scn", SCENARIOS, ids=lambda f: f.__name__[4:])
def test_port_matches_jax(scn, tmp_path):
    want = scn(PKGS["jax"], tmp_path)
    got = scn(PKGS["port"], tmp_path)
    assert got == want


def test_quota_exceeded_is_an_overload_shed():
    ten = port_serving.AdmissionController(
        [port_serving.TenantConfig("acme", quota=1)])
    ten.charge("acme")
    with pytest.raises(port_serving.TenantQuotaExceeded) as err:
        ten.charge("acme")
    assert isinstance(err.value, port_serving.OverloadRejected)


def test_staged_shed_keeps_realtime_and_releases_quotas():
    """The port's own outcome of the staged shed, beside the equality:
    both batch and standard shed, realtime never, no quota leaks."""
    out = scn_staged_shed(PKGS["port"], None)
    outcomes = [o for o, _ in out[:16]]
    assert outcomes[8] == "OverloadRejected"      # batch at level 1
    assert outcomes[13] == "OverloadRejected"     # standard at level 2
    assert outcomes[14] == "ok"                   # realtime admitted
    assert out[16] == [0, 0, 0]
    assert any(k.startswith("brownout_shed") for k in out[-1])
