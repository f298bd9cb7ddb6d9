"""The port's rolling model swap (``serving/rollout.py``) against the
JAX package's, on fake backends and the same virtual clock.

Each scenario (the JAX ``tests/test_rollout.py`` scripts) runs over
both packages and returns the controller's event stream (action,
replica, reason, versions, times), the replicas' versions and states,
the postmortems it wrote, and the telemetry; the two must be equal.
The scripts cover the accept path, the WER guardrail, rollback on a
canary regression and on a swap fault, pause on brownout and on a
foreign breaker, the min-routable floor, and pinned sessions that
re-pin at most once.
"""

import types

import pytest
import torch

import deepspeech_tpu.resilience as jax_res
import deepspeech_tpu.serving as jax_serving
import deepspeech_tpu_torch.resilience as port_res
import deepspeech_tpu_torch.serving as port_serving

torch.set_num_threads(1)

PKGS = {"jax": types.SimpleNamespace(S=jax_serving, R=jax_res),
        "port": types.SimpleNamespace(S=port_serving, R=port_res)}
CANARY = [({}, None)]  # echo backends ignore (batch, plan)


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _echo(tag):
    def fn(batch, plan):
        return [f"{tag}"]
    return fn


def _pool(P, n, clock, tel, drain_window_s=0.25, **rep_kw):
    reps = [P.S.Replica(f"r{k}", _echo(f"r{k}"), telemetry=tel,
                        clock=clock,
                        breaker=P.R.CircuitBreaker(
                            name=f"b{k}", failure_threshold=2,
                            cooldown_s=1.0, clock=clock, registry=tel),
                        **rep_kw)
            for k in range(n)]
    pool = P.S.ReplicaPool(reps, clock=clock, telemetry=tel,
                           drain_window_s=drain_window_s)
    for rep in pool:
        rep.version = "v1"
    return pool


def _same_backend(rep):
    return {"decode_fn": _echo(rep.rid), "session_factory": None,
            "inferencer": None}


def _drive(ro, clock, max_ticks=50, dt=0.3):
    for _ in range(max_ticks):
        if ro.state in ("done", "rolled_back"):
            return ro.state
        clock.t += dt
        ro.tick()
    return ro.state


def _ro(P, pool, factory, clock, pms, **kw):
    kw.setdefault("canary_set", CANARY)
    return P.S.RolloutController(
        pool, factory, clock=clock,
        postmortem_fn=lambda kind, **ev: pms.append(
            (kind, {k: v for k, v in ev.items()
                    if k != "recent_traces"})), **kw)


def _observe(ro, pool, tel, pms):
    snap = tel.snapshot()
    return {"events": ro.events, "status": ro.status(),
            "replicas": [(r.rid, r.version, r.state, r.park_reason)
                         for r in pool],
            "prefer": sorted(pool.prefer_rids), "postmortems": pms,
            "counters": {k: v for k, v in snap["counters"].items()
                         if k.startswith("rollout")},
            "gauges": {k: v for k, v in snap["gauges"].items()
                       if k.startswith("rollout")},
            "canary": snap["histograms"].get(
                'canary_wer_delta{version="v2"}', {}).get("count")}


# -- scenarios ---------------------------------------------------------------

def scn_full_swap(P):
    clock, tel, pms = Clock(), P.S.ServingTelemetry(), []
    pool = _pool(P, 3, clock, tel)
    ro = _ro(P, pool, _same_backend, clock, pms, to_version="v2")
    ro.start()
    first = ro.state
    _drive(ro, clock)
    again = _ro(P, pool, _same_backend, clock, pms, to_version="v2")
    again.start()
    return [first, _observe(ro, pool, tel, pms), again.state,
            again.upgraded]


def scn_drain_window(P):
    clock, tel, pms = Clock(), P.S.ServingTelemetry(), []
    pool = _pool(P, 2, clock, tel)
    ro = _ro(P, pool, _same_backend, clock, pms)
    ro.start()
    out = []
    for t in (0.0, 0.1, 0.3, 0.35, 0.7):
        clock.t = t
        ro.tick()
        out.append([(r.rid, r.state, r.version) for r in pool])
        out.append(pool.route() is not None)
    return [out, _observe(ro, pool, tel, pms)]


def scn_guardrail(P):
    def near_miss(rep):
        return {"decode_fn": lambda b, p: [f"{rep.rid} a b X"]}

    out = []
    for guardrail in (0.30, 0.10):
        clock, tel, pms = Clock(), P.S.ServingTelemetry(), []
        pool = _pool(P, 2, clock, tel)
        for rep in pool:
            rep.decode_fn = (lambda tag: lambda b, p:
                             [f"{tag} a b c"])(rep.rid)
        ro = _ro(P, pool, near_miss, clock, pms,
                 wer_guardrail=guardrail)
        ro.start()
        out.append((_drive(ro, clock), ro.last_wer_delta,
                    _observe(ro, pool, tel, pms)))
    # No canary configured, and a canary_fn in place of a canary set.
    clock, tel, pms = Clock(), P.S.ServingTelemetry(), []
    pool = _pool(P, 2, clock, tel)
    ro = _ro(P, pool, _same_backend, clock, pms, canary_set=None)
    ro.start()
    out.append((_drive(ro, clock), ro.last_wer_delta))
    calls = []
    pool = _pool(P, 2, clock, tel)
    ro = _ro(P, pool, _same_backend, clock, pms, canary_set=None,
             canary_fn=lambda o, n: calls.append(1) or (["s"], ["s"]))
    ro.start()
    out.append((_drive(ro, clock), len(calls)))
    return out


def scn_canary_rollback(P):
    clock, tel, pms = Clock(), P.S.ServingTelemetry(), []
    pool = _pool(P, 2, clock, tel)
    old = {r.rid: r.decode_fn for r in pool}
    ro = _ro(P, pool, lambda rep: {"decode_fn": lambda b, p: [
        "totally different words"]}, clock, pms, to_version="v2",
        wer_guardrail=0.0)
    ro.start()
    state = _drive(ro, clock)
    restored = all(r.decode_fn is old[r.rid] for r in pool)
    return [state, restored, ro.rollbacks,
            ro.parked_candidate is not None, _observe(ro, pool, tel, pms)]


def scn_swap_fault(P):
    clock, tel, pms = Clock(), P.S.ServingTelemetry(), []
    pool = _pool(P, 2, clock, tel)
    ro = _ro(P, pool, _same_backend, clock, pms)
    P.R.faults.install(P.R.FaultPlan(
        [P.R.FaultSpec("rollout.swap", "error", count=1)], clock=clock))
    try:
        ro.start()
        state = _drive(ro, clock)
    finally:
        P.R.faults.clear()
    # The error text names the package's own exception class path.
    obs = _observe(ro, pool, tel, pms)
    for _, ev in obs["postmortems"]:
        ev["error"] = ev["error"].split("(")[0]
    for ev in obs["events"]:
        if "error" in ev:
            ev["error"] = ev["error"].split("(")[0]
    return [state, pool.route() is not None, obs]


def scn_partial_rollback(P):
    clock, tel, pms = Clock(), P.S.ServingTelemetry(), []
    pool = _pool(P, 3, clock, tel)
    hits = []

    def flaky(rep):
        hits.append(rep.rid)
        if len(hits) == 3:
            raise RuntimeError("checkpoint load failed")
        return _same_backend(rep)

    ro = _ro(P, pool, flaky, clock, pms, to_version="v2")
    ro.start()
    return [_drive(ro, clock), hits, _observe(ro, pool, tel, pms)]


class FakeBrownout:
    def __init__(self, level=0):
        self.level = level


def scn_pause_brownout(P):
    clock, tel, pms = Clock(), P.S.ServingTelemetry(), []
    pool = _pool(P, 2, clock, tel)
    bo = FakeBrownout()
    ro = _ro(P, pool, _same_backend, clock, pms, brownout=bo)
    ro.start()
    ro.tick()
    out = []
    for t, level in ((0.1, 1), (5.0, 1), (5.3, 0)):
        bo.level = level
        clock.t = t
        ro.tick()
        out.append((ro.state, [(r.rid, r.state, r.version) for r in pool]))
    out.append(_drive(ro, clock))
    out.append(_observe(ro, pool, tel, pms))
    return out


def scn_pause_breaker(P):
    clock, tel, pms = Clock(), P.S.ServingTelemetry(), []
    pool = _pool(P, 3, clock, tel)
    ro = _ro(P, pool, _same_backend, clock, pms)
    ro.start()
    bad = pool.replicas[2]
    while bad.breaker.state != "open":
        bad.breaker.record_failure()
    ro.tick()
    out = [ro.state, ro.status()["pause_reason"]]
    clock.t = 1.5
    out += [_drive(ro, clock), _observe(ro, pool, tel, pms)]
    return out


def scn_floor(P):
    clock, tel, pms = Clock(), P.S.ServingTelemetry(), []
    pool = _pool(P, 2, clock, tel)
    ro = _ro(P, pool, _same_backend, clock, pms, min_routable=2)
    ro.start()
    for _ in range(5):
        clock.t += 0.3
        ro.tick()
    return [ro.state, _observe(ro, pool, tel, pms)]


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


def scn_pinned_sessions(P):
    clock, tel, pms = Clock(), P.S.ServingTelemetry(), []
    pool = _pool(P, 2, clock, tel, session_factory=FakeMgr)
    router = P.S.PooledSessionRouter(pool)
    sids, k = [], 0
    while len(sids) < 3:
        if pool.ring_owner(f"s{k}") == "r0":
            sids.append(f"s{k}")
        k += 1
    homes = [router.join(sid) for sid in sids]
    ro = _ro(P, pool, lambda rep: {"decode_fn": _echo(rep.rid),
                                   "session_factory": FakeMgr},
             clock, pms, to_version="v2")
    ro.start()
    trail, fed = [], 0
    for _ in range(40):
        if ro.state in ("done", "rolled_back"):
            break
        clock.t += 0.3
        router.step({sid: f"c{fed}" for sid in sids})
        fed += 1
        trail.append([router.home_of(sid) for sid in sids])
        ro.tick()
    for sid in sids:
        router.leave(sid)
    router.flush()
    return [homes, trail, [router.final(sid) for sid in sids],
            [pool.pins_on(r.rid) for r in pool],
            _observe(ro, pool, tel, pms)]


SCENARIOS = [scn_full_swap, scn_drain_window, scn_guardrail,
             scn_canary_rollback, scn_swap_fault, scn_partial_rollback,
             scn_pause_brownout, scn_pause_breaker, scn_floor,
             scn_pinned_sessions]


@pytest.mark.parametrize("scn", SCENARIOS, ids=lambda f: f.__name__[4:])
def test_port_matches_jax(scn):
    assert scn(PKGS["port"]) == scn(PKGS["jax"])


def test_rollout_outcomes():
    """The port's own outcomes beside the equality: the swap finishes,
    the rollbacks restore the old backend, pause/resume and the
    pinned sessions' single move."""
    P = PKGS["port"]
    first, obs, again, upgraded = scn_full_swap(P)
    assert first == "running" and again == "done" and upgraded == []
    assert obs["status"]["state"] == "done"
    assert [a["action"] for a in obs["events"]].count("swap") == 3
    assert all(v == "v2" for _, v, _, _ in obs["replicas"])
    state, restored, n, parked, obs = scn_canary_rollback(P)
    assert (state, restored, n, parked) == ("rolled_back", True, 1, True)
    assert obs["postmortems"][0][1]["trigger"] == "canary_regression"
    state, routable, obs = scn_swap_fault(P)
    assert state == "rolled_back" and routable
    assert obs["postmortems"][0][1]["trigger"] == "swap_fault"
    out = scn_pause_brownout(P)
    assert out[0][0] == "paused" and out[3] == "done"
    actions = [e["action"] for e in out[4]["events"]]
    assert "pause" in actions and "resume" in actions
    homes, trail, finals, _, obs = scn_pinned_sessions(P)
    for s in range(3):
        moves = sum(a[s] != b[s] for a, b in zip([homes] + trail, trail))
        assert moves <= 1
    assert all(f == " ".join(f"c{i}" for i in range(len(trail)))
               for f in finals)


def _swap_guard(P):
    """``swap_backend`` on a routable replica, on one still draining,
    and on a parked one: what each call raises, and the backend after."""
    clock, tel = Clock(), P.S.ServingTelemetry()
    pool = _pool(P, 2, clock, tel)
    rep = pool.replicas[0]
    new = {"decode_fn": _echo("new"), "version": "v2"}
    out = []

    def attempt():
        try:
            rep.swap_backend(**new)
            out.append((rep.state, "swapped"))
        except RuntimeError as e:
            out.append((rep.state, str(e)))

    attempt()
    rep.begin_drain(clock(), 0.25, park=True, reason="rollout")
    attempt()
    clock.t += 0.3
    rep.tick(clock())
    attempt()
    return out, rep.version, rep.decode_fn({}, None)


def test_swap_backend_only_on_a_parked_replica():
    """The parked-state guard holds in both packages alike: a routable or
    draining replica refuses the swap, a parked one takes it."""
    got = _swap_guard(PKGS["port"])
    assert got == _swap_guard(PKGS["jax"])
    (s0, e0), (s1, e1), (s2, e2) = got[0]
    assert "park it first" in e0 and "park it first" in e1
    assert e2 == "swapped" and got[1:] == ("v2", ["new"])
