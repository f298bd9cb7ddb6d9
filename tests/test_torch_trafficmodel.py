"""The port's traffic model (``serving/trafficmodel.py``) against the JAX
package's: for a seed, the same arrivals (time, length, tier), sessions,
burst chain and summary, item for item."""

import dataclasses

import pytest

from deepspeech_tpu.serving.trafficmodel import \
    TrafficModel as JaxTrafficModel
from deepspeech_tpu_torch.serving import TrafficModel

SHAPES = {
    "diurnal": dict(duration_s=6.0, base_rps=24.0, day_s=6.0,
                    diurnal_amplitude=0.9),
    "bursty-tiered": dict(duration_s=8.0, base_rps=16.0,
                          burst_rate_mult=4.0, burst_enter_p=0.2,
                          burst_exit_p=0.3,
                          tier_mix={"premium": 0.3, "bulk": 0.7},
                          session_rate=2.0, session_mean_chunks=12.0),
    "capped": dict(duration_s=20.0, base_rps=40.0, max_arrivals=100,
                   len_log_sigma=1.2, len_max=3000),
}


def _plain(sched):
    return {"arrivals": [dataclasses.astuple(a) for a in sched.arrivals],
            "sessions": [dataclasses.astuple(s) for s in sched.sessions],
            "duration_s": sched.duration_s, "seed": sched.seed,
            "burst_states": list(sched.burst_states),
            "burst_step_s": sched.burst_step_s,
            "per_bin_rps": sched.per_bin_rps(0.5),
            "summary": sched.summary()}


@pytest.mark.parametrize("seed", [0, 7, 1234])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_schedule_matches_jax(seed, shape):
    want = JaxTrafficModel(seed=seed, **SHAPES[shape]).schedule()
    got = TrafficModel(seed=seed, **SHAPES[shape]).schedule()
    assert _plain(got) == _plain(want)
    assert got.arrivals and all(a.t < got.duration_s for a in got.arrivals)
    assert [a.t for a in got.arrivals] == sorted(a.t for a in got.arrivals)


def test_rate_curve_matches_jax():
    kw = SHAPES["bursty-tiered"]
    jm, pm = JaxTrafficModel(seed=3, **kw), TrafficModel(seed=3, **kw)
    ts = [0.25 * k for k in range(32)]
    assert [pm.diurnal_rate(t) for t in ts] == [jm.diurnal_rate(t)
                                                for t in ts]
    states = jm.schedule().burst_states
    assert [pm.rate(t, states) for t in ts] == [jm.rate(t, states)
                                                for t in ts]
