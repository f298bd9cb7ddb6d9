"""The port's observability plane (``obs/context.py``, ``obs/timeline.py``,
``obs/slo.py``, ``resilience/postmortem.py``) against the JAX package's:
one scripted sequence of requests, fleet events and SLO counters, on an
injected clock, goes through both, and every summary, incident, burn
rate, alert, postmortem record and registry snapshot must be equal.
"""

import io
import json
import types

import pytest
import torch

import deepspeech_tpu.obs as jax_obs
import deepspeech_tpu.resilience.postmortem as jax_pm
import deepspeech_tpu_torch.obs as port_obs
import deepspeech_tpu_torch.resilience.postmortem as port_pm
from deepspeech_tpu.obs import context as jax_context
from deepspeech_tpu.obs import slo as jax_slo
from deepspeech_tpu.obs import timeline as jax_timeline
from deepspeech_tpu_torch.obs import context as port_context
from deepspeech_tpu_torch.obs import slo as port_slo
from deepspeech_tpu_torch.obs import timeline as port_timeline

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

JAX = types.SimpleNamespace(obs=jax_obs, context=jax_context, slo=jax_slo,
                            timeline=jax_timeline, pm=jax_pm)
PORT = types.SimpleNamespace(obs=port_obs, context=port_context,
                             slo=port_slo, timeline=port_timeline,
                             pm=port_pm)


class Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _traces(m, clock, recorder):
    """Ten requests through every phase, finished ok/timeout/error."""
    out = []
    for k in range(10):
        ctx = m.context.TraceContext(f"r{k}", clock(), tier="bulk"
                                     if k % 3 == 0 else None)
        clock.advance(0.01 * (k + 1))
        if k % 4 == 1:
            ctx.to(m.context.PHASE_BREAKER, clock())
            ctx.event("breaker_defer", clock(), attempts=0)
            clock.advance(0.05)
        if k % 5 == 2:
            ctx.to(m.context.PHASE_BACKOFF, clock())
            ctx.event("retry", clock(), attempts=1, error="InjectedFault")
            clock.advance(0.02 * k)
        ctx.to(m.context.PHASE_DECODE, clock())
        ctx.note(rung="4x128", replica=f"r{k % 2}", occupancy=0.75)
        clock.advance(0.003 * k)
        ctx.finish(clock(), ("ok", "timeout", "ok", "error")[k % 4])
        ctx.finish(clock() + 1.0, "ok")            # idempotent
        rec = ctx.summary(wall=lambda: 7.0)
        recorder.record(rec)
        out.append((rec, ctx.cause(), ctx.complete(), ctx.phase))
    return out


def _script(m):
    """Drive one package's modules through the script; returns what the
    comparison reads."""
    clock = Clock()
    reg = m.obs.MetricsRegistry()
    sink = io.StringIO()
    writer = m.pm.PostmortemWriter(sink=sink, registry=reg,
                                   wall=lambda: 5.0)
    recorder = m.obs.FlightRecorder(capacity=8)
    traces = _traces(m, clock, recorder)

    pms = []

    def record(kind, trigger="", **evidence):
        rec = writer.write(kind, trigger, **evidence)
        pms.append(rec)
        return rec

    log = m.timeline.install(m.timeline.EventLog(
        capacity=64, clock=clock, wall=lambda: 1000.0 + clock(),
        registry=reg))
    try:
        series = m.timeline.MetricSeries(reg, interval_s=0.5, clock=clock)
        corr = m.timeline.IncidentCorrelator(
            quiet_s=2.0, clock=clock, postmortem_fn=record, series=series,
            registry=reg).attach(log)
        seen = []
        log.add_listener(lambda ev: seen.append(m.timeline.EventLog
                                                .to_record(ev)))
        reg.gauge("queue_depth", 3)
        arm = log.publish("fault_arm", "faults", replica="r0", point="x")
        fire = log.publish("fault_fire", "faults", replica="r0",
                           cause_seq=arm, fault="error")
        clock.advance(0.4)
        reg.gauge("queue_depth", 9)
        opened = log.publish("breaker_open", "pool", replica="r0",
                             cause_seq=m.timeline.last_for("r0"))
        clock.advance(0.7)
        log.publish("migration", "migration", replica="r1",
                    cause_seq=opened, sid="a", src="r0")
        log.publish("migration_fallback", "migration", replica="r1",
                    sid="b")                               # an orphan
        clock.advance(0.6)
        fire2 = log.publish("fault_fire", "faults", replica="r0",
                            cause_seq=arm, fault="error")
        clock.advance(0.5)
        log.publish("breaker_close", "pool", replica="r0",
                    cause_seq=opened)
        clock.advance(3.0)
        corr.poll()
        slo_root = log.publish("slo_alert", "slo", tier="bulk",
                               window="fast")
        corr.flush()

        # SLO burn over tierless and tier-labeled counters.
        engine = m.slo.SloBurnEngine(
            target=0.9, windows={"fast": 10.0, "slow": 60.0},
            thresholds={"fast": 2.0, "slow": 1.5}, registry=reg,
            clock=clock, recorder=recorder, postmortem_fn=record,
            slowest_n=3)
        burns = []
        for step in range(15):
            ok = 9 if step < 4 or step > 8 else 2
            miss = 1 if step < 4 or step > 8 else 6
            reg.count("slo_ok", ok)
            reg.count("slo_miss", miss)
            reg.count("slo_ok", ok + 1, labels={"tier": "bulk"})
            reg.count("slo_miss", miss // 2, labels={"tier": "bulk"})
            clock.advance(3.0)
            burns.append(sorted(engine.update().items()))
        writer.write("quarantined_request", "batch_error", rid="r3",
                     rung="4x128", attempts=1)
    finally:
        m.timeline.clear()
    alerts = [{k: v for k, v in a.items() if k != "t"}
              for a in engine.alerts]
    return {
        "traces": traces,
        "recent": recorder.recent(),
        "slowest": recorder.slowest(3),
        "events": seen,
        "log_recent": [m.timeline.EventLog.to_record(e)
                       for e in log.recent()],
        "seqs": (arm, fire, opened, fire2, slo_root),
        "incidents": corr.status(),
        "orphans": corr.orphans,
        "burns": burns,
        "alerts": alerts,
        "slo_status": engine.status(),
        "worst": (engine.worst_burn(), engine.worst_burn("slow")),
        "postmortems": pms,
        "pm_recent": writer.recent(),
        "pm_kinds": writer.recent("incident"),
        "pm_lines": [json.loads(x) for x in sink.getvalue().splitlines()],
        "written": writer.written(),
        "registry": reg.snapshot(),
    }


@pytest.fixture(scope="module")
def both():
    return _script(JAX), _script(PORT)


@pytest.mark.parametrize("key", [
    "traces", "recent", "slowest", "events", "log_recent", "seqs",
    "incidents", "orphans", "burns", "alerts", "slo_status", "worst",
    "postmortems", "pm_recent", "pm_kinds", "pm_lines", "written",
    "registry"])
def test_obs_plane_matches_jax(both, key):
    want, got = both
    assert got[key] == want[key]


def test_script_reaches_every_path(both):
    """The script is not vacuous: it opens and resolves incidents, counts
    an orphan, fires and re-arms SLO alerts, and writes postmortems of
    each kind."""
    _, got = both
    closed = got["incidents"]["closed"]
    assert len(closed) >= 2 and any(c["resolution"] == "resolved"
                                    for c in closed)
    assert got["orphans"] == 1
    assert {a["window"] for a in got["alerts"]} == {"fast", "slow"}
    assert any(a["tier"] == "bulk" for a in got["alerts"])
    kinds = {r["kind"] for r in got["postmortems"]}
    assert kinds == {"incident", "slo_burn"}
    assert {r["status"] for r, *_ in got["traces"]} == {"ok", "timeout",
                                                       "error"}
    assert all(complete for _, _, complete, _ in got["traces"])
    assert got["registry"]["counters"]["slo_alerts_recovered"
                                       '{window="fast"}'] >= 1


def test_postmortem_seam_registered():
    """Importing the port's ``resilience.postmortem`` registers its
    recorder in the port's obs seam, not the JAX package's."""
    assert port_obs.postmortem_recorder() is port_pm.record
    assert jax_obs.postmortem_recorder() is jax_pm.record
