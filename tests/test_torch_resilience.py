"""The port's ``resilience/`` (``retry.py``, ``brownout.py``,
``faults.py``) against the JAX package's on the same scripts: ``Retry``
delays under a seed and its ``call`` loop, the ``CircuitBreaker`` state
sequence, ``BrownoutController`` levels and actions, and ``FaultPlan``
firing (windows, probability, skip/count, episode arming, targets, the
load gate, plan validation) must be equal, counters included.
"""

import random
import types

import pytest
import torch

import deepspeech_tpu.obs as jax_obs
import deepspeech_tpu.resilience as jax_res
import deepspeech_tpu_torch.obs as port_obs
import deepspeech_tpu_torch.resilience as port_res
from deepspeech_tpu.obs import timeline as jax_timeline
from deepspeech_tpu_torch.obs import timeline as port_timeline

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

JAX = types.SimpleNamespace(res=jax_res, obs=jax_obs, timeline=jax_timeline)
PORT = types.SimpleNamespace(res=port_res, obs=port_obs,
                             timeline=port_timeline)


class Clock:
    def __init__(self, t=10.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _retry(m):
    reg = m.obs.MetricsRegistry()
    pol = m.res.Retry(attempts=4, base_s=0.02, max_s=0.1, jitter=0.25,
                      rng=random.Random(11), registry=reg, name="t")
    delays = [round(pol.delay(k), 12) for k in range(1, 9)]
    slept = []
    pol = m.res.Retry(attempts=3, base_s=0.5, jitter=0.1, budget_s=10.0,
                      rng=random.Random(3), sleep=slept.append,
                      registry=reg, name="call")
    calls = []

    def flaky():
        calls.append(len(calls))
        if len(calls) < 3:
            raise RuntimeError("flaky")
        return "done"

    value = pol.call(flaky)
    errs = []
    pol = m.res.Retry(attempts=5, base_s=1.0, budget_s=2.5, jitter=0.0,
                      sleep=slept.append, registry=reg, name="budget")
    try:
        pol.call(lambda: (_ for _ in ()).throw(ValueError("always")))
    except ValueError as e:
        errs.append(str(e))
    return delays, value, calls, slept, errs, reg.snapshot()


def _breaker(m):
    clock = Clock()
    reg = m.obs.MetricsRegistry()
    b = m.res.CircuitBreaker(failure_threshold=3, cooldown_s=2.0,
                             half_open_probes=1, clock=clock,
                             registry=reg, name="b")
    seq = []
    script = "ffsfff" + "a" * 2 + "w" + "a" + "f" + "w" + "a" + "s" + "ff"
    for op in script:
        if op == "f":
            b.record_failure()
        elif op == "s":
            b.record_success()
        elif op == "a":
            seq.append(("allow", b.allow()))
        elif op == "w":
            clock.advance(2.5)
        seq.append((op, b.state, b.failures))
    calls = []

    def boom():
        raise RuntimeError("x")

    for _ in range(2):
        try:
            b.call(boom)
        except m.res.CircuitOpen as e:
            calls.append(("open", str(e)))
        except RuntimeError as e:
            calls.append(("err", str(e)))
    return seq, calls, b.transitions, b.opens, b.recovery_s(), \
        reg.snapshot()


def _brownout(m):
    clock = Clock()
    reg = m.obs.MetricsRegistry()
    ctl = m.res.BrownoutController(
        enter_pressure=0.6, exit_pressure=0.2, shed_pressure=0.8,
        park_pressure=0.95, rescore_pressure=0.4, hold_s=0.5, clock=clock,
        registry=reg, device_budget_s=0.1, slo_burn_budget=4.0)
    pressures = [0.1, 0.5, 0.65, 0.7, 0.7, 0.85, 0.9, 0.97, 0.99, 0.99,
                 0.5, 0.3, 0.1, 0.1, 0.05, 0.05, 0.0, 0.0, 0.0, 0.0, 0.0,
                 0.0, 0.0, 0.0]
    out = []
    for k, p in enumerate(pressures):
        if k == 3:
            for v in (0.005, 0.01, 0.012):
                reg.observe("gateway.dispatch_s", v,
                            labels={"replica": "r1"})
        if k == 12:
            reg.gauge("slo_burn_rate", 6.0, labels={"window": "fast"})
        if k == 15:
            reg.gauge("slo_burn_rate", 0.4, labels={"window": "fast"})
        clock.advance(0.3)
        level = ctl.update(p)
        out.append((level, ctl.decode_mode(), ctl.effective_tier("premium"),
                    ctl.effective_tier(None), ctl.effective_max_batch(32),
                    ctl.should_shed(), ctl.should_rescore(),
                    ctl.should_park_replica(),
                    round(ctl.device_pressure(), 9),
                    round(ctl.slo_burn_pressure(), 9)))
    return out, reg.snapshot()


def _faults(m):
    clock = Clock(0.0)
    reg = m.obs.MetricsRegistry()
    slept = []
    f = m.res.faults
    plan = f.FaultPlan([
        f.FaultSpec("gateway.dispatch", "error", prob=0.5, after_s=1.0,
                    until_s=6.0),
        f.FaultSpec("gateway.dispatch", "latency", latency_s=0.25,
                    skip=2, count=2),
        f.FaultSpec("gateway.dispatch", "unavailable", on_event="burst",
                    arm_for_s=1.5, target="@event"),
        f.FaultSpec("gateway.dispatch", "error", target="r2",
                    min_load=0.8),
        f.FaultSpec("pipeline.materialize", "corrupt_batch", count=1),
    ], seed=7, clock=clock, sleep=slept.append, registry=reg)
    log = m.timeline.install(m.timeline.EventLog(
        clock=clock, wall=lambda: clock() + 100.0))
    fired = []
    try:
        f.install(plan)
        for k in range(40):
            clock.advance(0.25)
            if k == 10:
                fired.append(("armed", f.notify("burst", replica="r1",
                                                cause_seq=None)))
            if k == 20:
                f.note_load(0.9)
            if k == 30:
                f.note_load(0.1)
            for rid in ("r0", "r1", "r2"):
                try:
                    spec = f.inject("gateway.dispatch", replica=rid)
                    fired.append((k, rid, spec.kind if spec else None))
                except f.InjectedFault as e:
                    fired.append((k, rid, "raised", e.kind, str(e)))
            spec = f.inject("pipeline.materialize")
            fired.append((k, spec.kind if spec else None))
    finally:
        f.clear()
        m.timeline.clear()
    events = [m.timeline.EventLog.to_record(e) for e in log.recent()]
    bad = {"seed": 1, "faults": [
        {"point": "gateway.dispatch", "kind": "error", "on_event": "x",
         "after_s": 1.0},
        {"point": "nowhere", "kind": "bogus"},
        {"point": "gateway.dispatch", "kind": "latency", "prob": 2.0}]}
    return (fired, slept, plan.fired(), plan.to_dict(), events,
            f.validate_plan_dict(bad), f.lint_plan_points(bad),
            f.active() is None, reg.snapshot())


@pytest.mark.parametrize("script", [_retry, _breaker, _brownout, _faults],
                         ids=["retry", "breaker", "brownout", "faults"])
def test_resilience_matches_jax(script):
    want, got = script(JAX), script(PORT)
    assert got == want


def test_scripts_reach_every_state():
    """The scripts are not vacuous: the breaker opens, half-opens and
    closes; brownout climbs to the park level and back; the plan fires
    each kind, and the episode spec only while armed."""
    seq, _, transitions, opens, _, _ = _breaker(PORT)
    assert {s for _, s in transitions} == {"open", "half_open", "closed"}
    assert opens >= 2
    levels = [row[0] for row in _brownout(PORT)[0]]
    assert max(levels) == port_res.LEVEL_REPLICA_DRAIN and levels[-1] == 0
    fired = _faults(PORT)[0]
    kinds = {row[3] for row in fired if len(row) == 5}
    assert kinds == {"error", "unavailable"}
    assert any(row[1:] == ("latency",) or row[-1] == "latency"
               for row in fired if len(row) == 3)
    unavailable = [row for row in fired
                   if len(row) == 5 and row[3] == "unavailable"]
    assert unavailable and {row[1] for row in unavailable} == {"r1"}
