"""Stdlib-HTTP scrape endpoint for the health plane, as ``repro.obs.server``
serves it.

Three routes, provider-agnostic (each backed by a zero-argument callable,
so the same server fronts a live :class:`~repro_torch.obs.health.HealthMonitor`
or a directory of exported artifacts in ``--watch`` mode):

* ``GET /metrics`` — Prometheus text exposition (the registry's
  ``export_prometheus``, strict-parser clean);
* ``GET /health`` — the JSON health verdict; HTTP 200 while ``status`` is
  ``ok``, 503 once alerting (load balancers and probes get the verdict for
  free);
* ``GET /telemetry`` — the precision-telemetry JSON document.

``ThreadingHTTPServer`` on a daemon thread, ephemeral port by default —
the serving loop stays single-process and synchronous; the scrape path
only ever *reads* host-side state the monitor already holds, never the card
(passivity, DESIGN.md §15). Callables that raise turn into HTTP 500 with the
error text instead of killing the thread.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

__all__ = ["HealthServer"]


class HealthServer:
    """The scrape server (see module docstring)."""

    def __init__(
        self,
        metrics_fn: Callable[[], str],
        health_fn: Callable[[], Dict[str, Any]],
        telemetry_fn: Callable[[], Dict[str, Any]],
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # silence per-request stderr
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                try:
                    if path == "/metrics":
                        self._send(200, outer._metrics_fn().encode(),
                                   "text/plain; version=0.0.4")
                    elif path == "/health":
                        verdict = outer._health_fn()
                        code = 200 if verdict.get("status") == "ok" else 503
                        self._send(code, _json_bytes(verdict),
                                   "application/json")
                    elif path == "/telemetry":
                        self._send(200, _json_bytes(outer._telemetry_fn()),
                                   "application/json")
                    else:
                        self._send(404, _json_bytes(
                            {"error": f"unknown route {path!r}",
                             "routes": ["/metrics", "/health", "/telemetry"]},
                        ), "application/json")
                except Exception as e:  # a broken provider must not kill the thread
                    self._send(500, _json_bytes({"error": repr(e)}),
                               "application/json")

        self._metrics_fn = metrics_fn
        self._health_fn = health_fn
        self._telemetry_fn = telemetry_fn
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None
        self.host = self._httpd.server_address[0]
        self.port = self._httpd.server_address[1]

    @classmethod
    def for_monitor(cls, monitor, host: str = "127.0.0.1", port: int = 0):
        """Wire the three routes to a live HealthMonitor's scope."""

        def telemetry_doc() -> Dict[str, Any]:
            tel = monitor.obs.telemetry
            return tel.to_dict() if tel is not None else {"error": "telemetry off"}

        return cls(
            metrics_fn=monitor.obs.registry.export_prometheus,
            health_fn=monitor.verdict,
            telemetry_fn=telemetry_doc,
            host=host,
            port=port,
        )

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "HealthServer":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="repro-health-scrape",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._httpd.shutdown()
        self._thread.join(timeout=5)
        self._httpd.server_close()
        self._thread = None


def _sanitize(x):
    """Non-finite floats become null — NaN/inf are not valid JSON and the
    verdict uses NaN for 'no data yet'."""
    if isinstance(x, float) and not (x == x and abs(x) != float("inf")):
        return None
    if isinstance(x, dict):
        return {k: _sanitize(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_sanitize(v) for v in x]
    return x


def _json_bytes(doc: Dict[str, Any]) -> bytes:
    return json.dumps(_sanitize(doc), indent=2, sort_keys=True, default=str,
                      allow_nan=False).encode()
