"""The port's live ops surface (``obs/status.py``): a ``StatusServer``
on port 0 of ``127.0.0.1`` answers ``/metrics``, ``/healthz``, ``/slo``,
``/traces``, ``/timeline`` and ``/incidents`` in the JAX server's JSON
shapes — the same bodies from the same providers — maps a raising
provider to a 500 and an unknown route to a 404, and stops cleanly."""

import json
import urllib.error
import urllib.request

import pytest

from deepspeech_tpu.obs import StatusServer as JaxStatusServer
from deepspeech_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from deepspeech_tpu_torch.obs import StatusServer
from deepspeech_tpu_torch.obs import timeline as port_timeline
from deepspeech_tpu_torch.obs.metrics import MetricsRegistry

ROUTES = ["/metrics", "/healthz", "/slo", "/traces", "/traces?n=2",
          "/timeline", "/timeline?n=1", "/incidents"]


def _get(srv, path):
    try:
        with urllib.request.urlopen(srv.url(path), timeout=5) as r:
            return r.status, r.headers.get_content_type(), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get_content_type(), e.read().decode()


def _serve(cls, reg_cls, providers):
    reg = reg_cls()
    reg.count("admitted", 3)
    reg.gauge("slo_burn_rate", 0.5, labels={"window": "5m"})
    reg.observe("gateway.dispatch_s", 0.25)
    with cls(port=0, registry=reg, **providers) as srv:
        assert srv.url("/").startswith("http://127.0.0.1:")
        return {path: _get(srv, path) for path in ROUTES + ["/nope"]}


def _providers():
    traces = [{"rid": "q0"}, {"rid": "q1"}, {"rid": "q2"}]
    events = [{"seq": 1, "kind": "breaker_open"},
              {"seq": 2, "kind": "autoscale_scale_up"}]
    return {"health_fn": lambda: {"status": "ok", "replicas": 2},
            "slo_fn": lambda: {"burn": {"fast": 0.5}},
            "traces_fn": lambda: list(traces),
            "timeline_fn": lambda: list(events),
            "incidents_fn": lambda: {"open": [], "closed": [
                {"incident_id": 1}], "orphans": 0}}


def test_routes_match_jax():
    want = _serve(JaxStatusServer, JaxRegistry, _providers())
    got = _serve(StatusServer, MetricsRegistry, _providers())
    assert got == want
    assert got["/metrics"][:2] == (200, "text/plain")
    assert "ds2_admitted 3" in got["/metrics"][2]
    assert json.loads(got["/traces?n=2"][2]) == {
        "traces": [{"rid": "q1"}, {"rid": "q2"}]}
    assert json.loads(got["/timeline?n=1"][2])["events"][0]["seq"] == 2
    assert got["/nope"][0] == 404


def test_defaults_match_jax():
    """With no providers: health ok, empty SLO, the process flight
    recorder's traces, the installed event log's events, no incidents."""
    want = _serve(JaxStatusServer, JaxRegistry, {})
    got = _serve(StatusServer, MetricsRegistry, {})
    for path in ("/metrics", "/healthz", "/slo", "/incidents", "/nope"):
        assert got[path] == want[path]
    assert json.loads(got["/healthz"][2]) == {"status": "ok"}
    assert json.loads(got["/timeline"][2]) == {"events": []}
    log = port_timeline.install(port_timeline.EventLog())
    try:
        log.publish("breaker_open", "pool", replica="r1")
        got = _serve(StatusServer, MetricsRegistry, {})
    finally:
        port_timeline.clear()
    (ev,) = json.loads(got["/timeline"][2])["events"]
    assert ev["kind"] == "breaker_open" and ev["replica"] == "r1"


def test_raising_provider_is_a_500_and_server_lives_on():
    srv = StatusServer(port=0, registry=MetricsRegistry(),
                       slo_fn=lambda: 1 / 0)
    port = srv.start()
    try:
        assert srv.start() == port              # idempotent
        code, _, body = _get(srv, "/slo")
        assert code == 500 and "ZeroDivisionError" in body
        srv.slo_fn = lambda: {"ok": True}
        assert _get(srv, "/slo")[0] == 200
    finally:
        srv.stop()
    assert srv.port is None
    srv.stop()                                  # a second stop is inert
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                               timeout=2)
