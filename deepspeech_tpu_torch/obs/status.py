"""Live ops surface: a stdlib-HTTP status server for the serving plane.

Production serving needs a scrape/poke surface that works while the
process is busy: a tiny :class:`ThreadingHTTPServer` on a daemon
thread (stdlib only — the serving host gets no new dependencies)
serving four read-only endpoints:

- ``/metrics``  — Prometheus text exposition
  (:meth:`MetricsRegistry.render_text` of the wired registry);
- ``/healthz``  — JSON from the caller's ``health_fn`` (replica /
  breaker / brownout / rollout state; ``{"status": "ok"}`` default);
- ``/slo``      — JSON from ``slo_fn`` (typically
  :meth:`~.slo.SloBurnEngine.status`);
- ``/traces``   — JSON ``{"traces": [...]}`` from ``traces_fn``
  (typically :meth:`~.context.FlightRecorder.recent`); ``?n=K``
  limits to the newest K;
- ``/timeline`` — JSON ``{"events": [...]}`` from ``timeline_fn``
  (default: the installed fleet :class:`~.timeline.EventLog`'s recent
  events); ``?n=K`` limits to the newest K;
- ``/incidents`` — JSON from ``incidents_fn`` (typically
  :meth:`~.timeline.IncidentCorrelator.status`: open + closed
  incidents and the orphan count).

Everything is pull: the handlers call the provider functions at
request time, so the endpoints serve *live* state with zero
bookkeeping on the hot path. A provider that raises maps to a 500
with the error text — an unhealthy health endpoint should look
unhealthy, not crash the server thread. ``serve.py --status-port``
wires this up for the streaming CLI; benches start one against their
private registries to prove the surface stays live mid-chaos.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional
from urllib.parse import parse_qs, urlparse

from . import timeline as _timeline
from .context import flight_recorder
from .metrics import MetricsRegistry
from .metrics import registry as _default_registry


class StatusServer:
    """See module docstring. ``port=0`` binds an ephemeral port
    (tests, scripts); :meth:`start` returns the bound port."""

    def __init__(self, *, port: int = 0, host: str = "127.0.0.1",
                 registry: Optional[MetricsRegistry] = None,
                 health_fn: Optional[Callable[[], dict]] = None,
                 slo_fn: Optional[Callable[[], dict]] = None,
                 traces_fn: Optional[Callable[[], List[dict]]] = None,
                 timeline_fn: Optional[Callable[[], List[dict]]]
                 = None,
                 incidents_fn: Optional[Callable[[], dict]] = None):
        self._host = host
        self._want_port = int(port)
        self._registry = registry
        self.health_fn = health_fn
        self.slo_fn = slo_fn
        self.traces_fn = traces_fn
        self.timeline_fn = timeline_fn
        self.incidents_fn = incidents_fn
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def _reg(self) -> MetricsRegistry:
        return self._registry if self._registry is not None \
            else _default_registry()

    @property
    def port(self) -> Optional[int]:
        return (self._httpd.server_address[1]
                if self._httpd is not None else None)

    def url(self, path: str = "/") -> str:
        return f"http://{self._host}:{self.port}{path}"

    # -- lifecycle -------------------------------------------------------
    def start(self) -> int:
        if self._httpd is not None:
            return self.port
        server = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # keep stdout JSONL-clean
                pass

            def _send(self, code: int, body: str,
                      ctype: str = "application/json") -> None:
                payload = body.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type",
                                 f"{ctype}; charset=utf-8")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                url = urlparse(self.path)
                try:
                    if url.path == "/metrics":
                        self._send(200, server._reg().render_text(),
                                   ctype="text/plain")
                    elif url.path == "/healthz":
                        health = (server.health_fn()
                                  if server.health_fn is not None
                                  else {"status": "ok"})
                        self._send(200, json.dumps(health,
                                                   default=str))
                    elif url.path == "/slo":
                        slo = (server.slo_fn()
                               if server.slo_fn is not None else {})
                        self._send(200, json.dumps(slo, default=str))
                    elif url.path == "/traces":
                        traces = (server.traces_fn()
                                  if server.traces_fn is not None
                                  else flight_recorder().recent())
                        q = parse_qs(url.query)
                        if "n" in q:
                            traces = traces[-int(q["n"][0]):]
                        self._send(200, json.dumps(
                            {"traces": traces}, default=str))
                    elif url.path == "/timeline":
                        if server.timeline_fn is not None:
                            events = server.timeline_fn()
                        else:
                            log = _timeline.active()
                            events = (log.recent()
                                      if log is not None else [])
                        q = parse_qs(url.query)
                        if "n" in q:
                            events = events[-int(q["n"][0]):]
                        self._send(200, json.dumps(
                            {"events": events}, default=str))
                    elif url.path == "/incidents":
                        inc = (server.incidents_fn()
                               if server.incidents_fn is not None
                               else {"open": [], "closed": [],
                                     "orphans": 0})
                        self._send(200, json.dumps(inc, default=str))
                    else:
                        self._send(404, json.dumps(
                            {"error": f"no route {url.path!r}"}))
                except Exception as e:  # surface, don't kill the thread
                    self._send(500, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}))

        self._httpd = ThreadingHTTPServer((self._host, self._want_port),
                                          _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval":
                                                      0.05},
            name="ds2-status", daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self._httpd, self._thread = None, None

    def __enter__(self) -> "StatusServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
