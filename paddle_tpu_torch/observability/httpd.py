"""Opt-in telemetry HTTP endpoint: GET /metrics (Prometheus text),
/metrics.json (registry snapshot), /trace (Chrome/Perfetto trace JSON)
— the port of ``paddle_tpu/observability/httpd.py`` (stdlib only).

A small ``http.server`` on a daemon thread, never started unless asked
(``serve_http``), bound to localhost: it exposes process internals, not
a public API.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .metrics import REGISTRY
from .tracing import TRACER


class _Handler(BaseHTTPRequestHandler):
    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (http.server API)
        reg = getattr(self.server, "registry", REGISTRY)
        tracer = getattr(self.server, "tracer", TRACER)
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            self._send(200, reg.render_prometheus().encode(),
                       "text/plain; version=0.0.4")
        elif path == "/metrics.json":
            self._send(200, json.dumps(reg.snapshot()).encode(),
                       "application/json")
        elif path == "/trace":
            self._send(200, json.dumps(tracer.to_chrome()).encode(),
                       "application/json")
        else:
            self._send(404, b"paddle_tpu_torch telemetry: use /metrics, "
                            b"/metrics.json or /trace\n", "text/plain")

    def log_message(self, fmt, *args):  # quiet: the service logs enough
        pass


class TelemetryServer:
    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry=None, tracer=None):
        if host not in ("127.0.0.1", "localhost", "::1"):
            raise ValueError(f"telemetry endpoint binds to localhost "
                             f"only, not {host!r}")
        self._srv = ThreadingHTTPServer((host, port), _Handler)
        self._srv.daemon_threads = True
        if registry is not None:
            self._srv.registry = registry
        if tracer is not None:
            self._srv.tracer = tracer
        self.host, self.port = self._srv.server_address[:2]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True,
                                        name="ptt-telemetry")

    def start(self) -> "TelemetryServer":
        self._thread.start()
        return self

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()


def serve_http(port: int = 0, host: str = "127.0.0.1",
               registry=None, tracer=None) -> TelemetryServer:
    """Start the telemetry endpoint; returns the running server (read
    ``.port`` for the bound port when 0 was requested)."""
    return TelemetryServer(port, host, registry, tracer).start()
