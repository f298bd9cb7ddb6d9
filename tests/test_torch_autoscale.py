"""The port's closed-loop autoscaler (``serving/autoscale.py``) against
the JAX package's, on echo backends, stub schedulers and the same
virtual clock.

Each scenario (the JAX ``tests/test_autoscale.py`` scripts) runs over
both packages and returns the controller's event stream (action,
victim, reason, fleet sizes, times), its episodes and postmortems, the
fleet, the scheduler knobs it moved and the telemetry; the two must be
equal. The scripts cover hysteresis and blips, the cooldown, the fleet
bounds, rollout and breaker hold-off, scale-down as drain-before-remove
over pinned sessions, each pressure signal, the capacity coupling, both
vertical rungs (ladder, tier mix) up and down, and the drain cancel.
"""

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
EDGES = (64, 128)
NF = 13


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _echo(tag):
    def fn(batch, plan):
        return [f"{tag}:B{plan.batch_pad}T{plan.bucket_frames}"
                ] * plan.n_valid
    return fn


def _feat(n):
    return np.zeros((n, NF), np.float32)


def _replica(P, rid, clock, tel, **kw):
    return P.S.Replica(rid, _echo(rid), telemetry=tel, clock=clock,
                       breaker=P.R.CircuitBreaker(
                           name=f"b{rid}", failure_threshold=2,
                           cooldown_s=1.0, clock=clock, registry=tel),
                       **kw)


def _pool(P, n, clock, tel, drain_window_s=0.25, **rep_kw):
    return P.S.ReplicaPool([_replica(P, f"r{k}", clock, tel, **rep_kw)
                            for k in range(n)], clock=clock,
                           telemetry=tel, drain_window_s=drain_window_s)


class StubSched:
    """The surface the controller reads and writes, with the real
    bounded-shrink clamp, the rung ladder and the tier-shift map."""

    def __init__(self, max_queue=8, pending=0, max_batch=4):
        self.max_queue = max_queue
        self.pending = pending
        self.applied = []
        self.max_batch = max_batch
        self.tier_max_batch = {}
        self.tier_shift = {}

    def set_max_queue(self, n):
        got = max(int(n), self.pending, 1)
        self.max_queue = got
        self.applied.append(got)
        return got

    def knobs(self):
        return (self.max_queue, list(self.applied), self.max_batch,
                dict(self.tier_max_batch), dict(self.tier_shift))


def _ctrl(P, pool, clock, tel, pms, **kw):
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 3)
    kw.setdefault("hold_s", 0.05)
    kw.setdefault("cooldown_s", 1.0)
    factory = kw.pop("factory", None) or (
        lambda rid: _replica(P, rid, clock, tel))
    return P.S.AutoscaleController(
        pool, factory, telemetry=tel, clock=clock,
        postmortem_fn=lambda kind, **ev: pms.append((kind, ev)), **kw)


def _observe(ctrl, pool, tel, pms, sched=None):
    snap = tel.snapshot()
    return {"events": ctrl.events, "episodes": ctrl.episodes,
            "status": ctrl.status(), "postmortems": pms,
            "fleet": [(r.rid, r.state, r.park_reason) for r in pool],
            "counts": (ctrl.scale_ups, ctrl.scale_downs, ctrl.holdoffs,
                       ctrl.drain_cancels, ctrl.vertical_ups,
                       ctrl.vertical_downs),
            "sched": sched.knobs() if sched is not None else None,
            "counters": {k: v for k, v in snap["counters"].items()
                         if k.startswith(("autoscale", "capacity"))},
            "gauges": {k: v for k, v in snap["gauges"].items()
                       if k.startswith(("autoscale", "gateway_cap"))}}


def _tick_at(ctrl, clock, times):
    for t in times:
        clock.t = t
        ctrl.tick()


# -- scenarios ---------------------------------------------------------------

def scn_validation(P):
    clock, tel = Clock(), P.S.ServingTelemetry()
    pool = _pool(P, 1, clock, tel)
    out = []
    for kw in ({"min_replicas": 0}, {"min_replicas": 3, "max_replicas": 2},
               {"up_pressure": 0.3, "down_pressure": 0.5},
               {"rows_per_replica": 0}, {"dispatch_budget_s": -1},
               {"slo_burn_budget": 0}, {"vertical_max_batch": 8},
               {"tier_shift": {"premium": "bulk"}}):
        try:
            P.S.AutoscaleController(pool, lambda rid: None, **kw)
            out.append("ok")
        except ValueError as e:
            out.append(str(e))
    return out


def scn_hysteresis(P):
    clock, tel, pms = Clock(), P.S.ServingTelemetry(), []
    pool = _pool(P, 1, clock, tel)
    sched = StubSched(max_queue=8, pending=8)
    ctrl = _ctrl(P, pool, clock, tel, pms, scheduler=sched)
    out = []
    for t, pending in ((0.0, 8), (0.03, 4), (0.04, 8), (0.08, 8),
                       (0.10, 8), (0.2, 16), (0.9, 16), (1.15, 24),
                       (1.25, 24)):
        sched.pending = pending
        clock.t = t
        ctrl.tick()
        out.append(len(pool))
    return [out, _observe(ctrl, pool, tel, pms, sched)]


def scn_bounds_and_holdoff(P):
    class RO:
        state = "running"

    clock, tel, pms = Clock(), P.S.ServingTelemetry(), []
    pool = _pool(P, 2, clock, tel)
    sched = StubSched(max_queue=8, pending=8)
    fixed = _ctrl(P, pool, clock, tel, pms, scheduler=sched,
                  min_replicas=2, max_replicas=2, cooldown_s=0.0)
    _tick_at(fixed, clock, (0.0, 0.1, 0.2))
    sched.pending = 0
    _tick_at(fixed, clock, (0.3, 0.4, 0.5))
    out = [_observe(fixed, pool, tel, pms, sched)]
    clock2, tel2, pms2 = Clock(), P.S.ServingTelemetry(), []
    pool2 = _pool(P, 1, clock2, tel2)
    sched2 = StubSched(max_queue=8, pending=8)
    ro = RO()
    ctrl = _ctrl(P, pool2, clock2, tel2, pms2, scheduler=sched2,
                 rollout=ro)
    _tick_at(ctrl, clock2, (0.0, 0.1, 0.2))
    ro.state = "paused"
    _tick_at(ctrl, clock2, (0.3,))
    ro.state = "done"
    _tick_at(ctrl, clock2, (0.4, 0.5))
    out.append(_observe(ctrl, pool2, tel2, pms2, sched2))
    # A real rollout on the same pool holds off through the group.
    clock3, tel3, pms3 = Clock(), P.S.ServingTelemetry(), []
    pool3 = _pool(P, 2, clock3, tel3)
    real = P.S.RolloutController(pool3, lambda rep: {
        "decode_fn": _echo("v2")}, clock=clock3, telemetry=tel3)
    real.start()
    ctrl3 = _ctrl(P, pool3, clock3, tel3, pms3,
                  scheduler=StubSched(max_queue=8, pending=8))
    _tick_at(ctrl3, clock3, (0.0, 0.1))
    out.append(_observe(ctrl3, pool3, tel3, pms3))
    return out


def scn_breaker_holdoff(P):
    clock, tel, pms = Clock(), P.S.ServingTelemetry(), []
    pool = _pool(P, 2, clock, tel)
    sched = StubSched(max_queue=8, pending=8)
    ctrl = _ctrl(P, pool, clock, tel, pms, scheduler=sched)
    r0 = pool.replicas[0]
    while r0.breaker.state != "open":
        r0.breaker.record_failure()
    _tick_at(ctrl, clock, (0.0, 0.1, 1.2, 1.3))
    return _observe(ctrl, pool, tel, pms, sched)


class FakeMgr:
    """A session manager whose left session finalizes at once."""

    def __init__(self):
        self.active = {}
        self.done = {}

    def join(self, sid, raw_len=None):
        self.active[sid] = []

    def leave(self, sid, tail=None):
        self.done[sid] = " ".join(self.active.pop(sid))

    def step(self, chunks):
        for sid, c in chunks.items():
            self.active[sid].append(str(c))
        return {sid: " ".join(v) for sid, v in self.active.items()}

    def flush(self):
        pass

    def final(self, sid):
        return self.done[sid]

    def stats(self):
        return {"active": len(self.active), "draining": 0}


def scn_scale_down_sessions(P):
    clock, tel, pms = Clock(), P.S.ServingTelemetry(), []
    pool = _pool(P, 2, clock, tel, session_factory=FakeMgr)
    router = P.S.PooledSessionRouter(pool)
    sids = [f"s{k}" for k in range(40)]
    for sid in sids:
        router.join(sid)
    router.step({sid: "c0" for sid in sids})
    sched = StubSched(max_queue=16, pending=0)
    ctrl = _ctrl(P, pool, clock, tel, pms, scheduler=sched)
    _tick_at(ctrl, clock, (0.0, 0.06))
    out = [ctrl.status()["victim"],
           router.step({sid: "c1" for sid in sids})]
    sched.pending = 16
    _tick_at(ctrl, clock, (0.1,))
    sched.pending = 0
    _tick_at(ctrl, clock, (0.4,))
    out.append(len(pool))
    router.step({sid: "c2" for sid in sids})
    for sid in sids:
        router.leave(sid)
    router.flush()
    out.append([router.final(sid) for sid in sids])
    out.append(_observe(ctrl, pool, tel, pms, sched))
    return out


def scn_session_quiet_and_last_routable(P):
    clock, tel, pms = Clock(), P.S.ServingTelemetry(), []
    pool = _pool(P, 2, clock, tel, drain_window_s=0.1,
                 session_factory=FakeMgr)
    router = P.S.PooledSessionRouter(pool)
    for k in range(10):
        router.join(f"s{k}")
    router.step({f"s{k}": "c0" for k in range(10)})
    ctrl = _ctrl(P, pool, clock, tel, pms, scheduler=StubSched(pending=0))
    _tick_at(ctrl, clock, (0.0, 0.06, 0.5))
    out = [len(pool), ctrl.state]
    router.step({f"s{k}": "c1" for k in range(10)})
    _tick_at(ctrl, clock, (0.6,))
    out.append(_observe(ctrl, pool, tel, pms))
    clock2, tel2, pms2 = Clock(), P.S.ServingTelemetry(), []
    pool2 = _pool(P, 2, clock2, tel2)
    r1 = pool2.replicas[1]
    while r1.breaker.state != "open":
        r1.breaker.record_failure()
    ctrl2 = _ctrl(P, pool2, clock2, tel2, pms2,
                  scheduler=StubSched(pending=0))
    _tick_at(ctrl2, clock2, (5.0, 5.1, 5.2))
    out.append(_observe(ctrl2, pool2, tel2, pms2))
    return out


def scn_signals(P):
    class BO:
        level = 0

    clock, tel, pms = Clock(), P.S.ServingTelemetry(), []
    pool = _pool(P, 2, clock, tel)
    bo = BO()
    ctrl = _ctrl(P, pool, clock, tel, pms,
                 scheduler=StubSched(max_queue=10, pending=3),
                 rows_per_replica=4, dispatch_budget_s=1.0,
                 slo_burn_budget=2.0, brownout=bo)
    out = [ctrl.signals()]
    pool.replicas[0].inflight = 4
    tel.observe("gateway.dispatch_s", 0.2, labels={"replica": "r0"})
    tel.observe("gateway.dispatch_s", 0.6, labels={"replica": "r1"})
    tel.gauge("slo_burn_rate", 0.5, labels={"window": "5m"})
    tel.gauge("slo_burn_rate", 1.0, labels={"window": "1h"})
    tel.gauge("slo_burn_rate_limit", 99.0)
    out.append(ctrl.signals())
    bo.level = 3
    r1 = pool.replicas[1]
    while r1.breaker.state != "open":
        r1.breaker.record_failure()
    tel.observe("gateway.dispatch_s", 5.0, labels={"replica": "r1"})
    out.append(ctrl.signals())
    return out


def scn_capacity(P):
    clock, tel, pms = Clock(), P.S.ServingTelemetry(), []
    s = P.S.MicroBatchScheduler(EDGES, 4, clock=clock, telemetry=tel,
                                max_queue=8, default_deadline=9.0)
    for _ in range(3):
        s.submit(_feat(50))
    out = [s.set_max_queue(1), s.set_max_queue(10)]
    pool = _pool(P, 1, clock, tel)
    sched = P.S.MicroBatchScheduler(EDGES, 4, clock=clock, telemetry=tel,
                                    max_queue=12, default_deadline=9.0,
                                    pool=pool)
    for _ in range(12):
        sched.submit(_feat(50))
    ctrl = _ctrl(P, pool, clock, tel, pms, scheduler=sched,
                 max_replicas=2)
    out.append(ctrl.capacity_per_replica)
    _tick_at(ctrl, clock, (0.0, 0.06))
    out += [sched.max_queue, _observe(ctrl, pool, tel, pms)]
    return out


def scn_vertical_up(P):
    clock, tel, pms = Clock(), P.S.ServingTelemetry(), []
    pool = _pool(P, 1, clock, tel)
    sched = StubSched(max_queue=8, pending=8, max_batch=4)
    ctrl = _ctrl(P, pool, clock, tel, pms, scheduler=sched,
                 vertical_max_batch=8, tier_shift={"premium": "bulk"},
                 vertical_hold_s=0.02, vertical_cooldown_s=0.1)
    out = []
    for t, pending in ((0.0, 8), (0.03, 8), (0.06, 8), (0.2, 16)):
        sched.pending = pending
        clock.t = t
        ctrl.tick()
        out.append((len(pool), sched.knobs()))
    return [out, _observe(ctrl, pool, tel, pms, sched)]


def scn_vertical_down(P):
    clock, tel, pms = Clock(), P.S.ServingTelemetry(), []
    pool = _pool(P, 2, clock, tel, drain_window_s=0.05)
    sched = StubSched(max_queue=16, pending=16, max_batch=4)
    ctrl = _ctrl(P, pool, clock, tel, pms, scheduler=sched,
                 max_replicas=2, cooldown_s=0.05, vertical_max_batch=8,
                 vertical_tier_max_batch={"premium": 8},
                 tier_shift={"premium": "bulk"},
                 vertical_hold_s=0.02, vertical_cooldown_s=0.5)
    out = []
    for t, pending in ((0.0, 16), (0.03, 16), (0.6, 16), (0.7, 0),
                       (0.76, 0), (1.2, 0), (1.25, 0), (1.8, 0),
                       (1.9, 0), (2.0, 0), (2.2, 0)):
        sched.pending = pending
        clock.t = t
        ctrl.tick()
        out.append((len(pool), ctrl.status()["victim"], sched.knobs()))
    return [out, _observe(ctrl, pool, tel, pms, sched)]


def scn_drain_cancel(P):
    clock, tel, pms = Clock(), P.S.ServingTelemetry(), []
    pool = _pool(P, 2, clock, tel)
    ctrl = _ctrl(P, pool, clock, tel, pms, scheduler=StubSched(pending=0))
    _tick_at(ctrl, clock, (0.0, 0.06))
    victim = ctrl.status()["victim"]
    peer = next(r for r in pool.replicas if r.rid != victim)
    while peer.breaker.state != "open":
        peer.breaker.record_failure()
    _tick_at(ctrl, clock, (0.1, 0.12))
    return [victim, _observe(ctrl, pool, tel, pms)]


def scn_run_until_steady(P):
    clock, tel, pms = Clock(), P.S.ServingTelemetry(), []
    pool = _pool(P, 2, clock, tel, drain_window_s=0.1)
    ctrl = _ctrl(P, pool, clock, tel, pms, scheduler=StubSched(pending=0))
    _tick_at(ctrl, clock, (0.0, 0.06))

    def pump():
        clock.t += 0.05

    return [ctrl.run_until_steady(pump=pump),
            _observe(ctrl, pool, tel, pms)]


def scn_slo_burn_episodes(P):
    """The serve loop's drive: the worst slo_burn_rate gauge over a
    budget of 1 pushes one scale-up; then its fall, one scale-down; then
    a mid-band burn holds the fleet."""
    clock, tel, pms = Clock(), P.S.ServingTelemetry(), []
    pool = _pool(P, 2, clock, tel, drain_window_s=0.05)
    ctrl = _ctrl(P, pool, clock, tel, pms, max_replicas=3,
                 slo_burn_budget=1.0, cooldown_s=0.2)
    out = []
    for k in range(30):
        clock.t = 0.04 * k
        burn = (2.0 if ctrl.scale_ups == 0
                else 0.0 if ctrl.scale_downs == 0 else 0.5)
        tel.gauge("slo_burn_rate", burn, labels={"window": "5m"})
        ctrl.tick()
        out.append(len(pool))
    return [out, _observe(ctrl, pool, tel, pms)]


SCENARIOS = [scn_validation, scn_hysteresis, scn_bounds_and_holdoff,
             scn_breaker_holdoff, scn_scale_down_sessions,
             scn_session_quiet_and_last_routable, scn_signals,
             scn_capacity, scn_vertical_up, scn_vertical_down,
             scn_drain_cancel, scn_run_until_steady, scn_slo_burn_episodes]


@pytest.mark.parametrize("scn", SCENARIOS, ids=lambda f: f.__name__[4:])
def test_port_matches_jax(scn):
    assert scn(PKGS["port"]) == scn(PKGS["jax"])


def test_autoscale_outcomes():
    """The port's own outcomes beside the equality: both vertical rungs
    engage before the fleet grows and disengage before it shrinks, the
    drain cancel re-admits its victim, and the burn-driven run makes
    exactly one episode each way."""
    P = PKGS["port"]
    steps, obs = scn_vertical_up(P)
    ups = [e["actuator"] for e in obs["events"]
           if e["action"] == "vertical_up"]
    assert ups == ["ladder", "tier_mix"] and obs["counts"][0] == 1
    assert steps[-1][1][4] == {"premium": "bulk"}
    steps, obs = scn_vertical_down(P)
    downs = [e["actuator"] for e in obs["events"]
             if e["action"] == "vertical_down"]
    assert downs and obs["counts"][5] == len(downs)
    first_drain = next(i for i, s in enumerate(steps) if s[1] is not None)
    assert all(s[2][2] == 4 and s[2][4] == {} for s in steps[first_drain:])
    victim, obs = scn_drain_cancel(P)
    assert obs["counts"][3] == 1 and len(obs["fleet"]) == 2
    assert [e for e in obs["events"] if e["action"] == "drain_cancel"
            ][0]["replica"] == victim
    sizes, obs = scn_slo_burn_episodes(P)
    assert obs["counts"][:2] == (1, 1) and max(sizes) == 3
    assert sizes[-1] == 2
    assert [p[1]["direction"] for p in obs["postmortems"]] == ["up",
                                                               "down"]
