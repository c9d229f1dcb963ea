"""Live export of the metrics registry + trace buffer (the port's copy
of ``repro.obs.export``).

A stdlib ``ThreadingHTTPServer`` on a daemon thread -- no third-party
dependency -- serving:

  * ``GET /metrics``       Prometheus text exposition (format 0.0.4)
  * ``GET /metrics.json``  the registry ``snapshot()`` as JSON
  * ``GET /trace``         the tracer buffer as Chrome trace-event JSON
                           (load in Perfetto / ``chrome://tracing``)
  * ``GET /healthz``       liveness probe (``ok``)

``repro_torch.launch.serve --metrics-port N`` starts one of these next
to the search server; ``--metrics-port 0`` binds an ephemeral port
(printed on startup, readable from ``exporter.port``).  Request handling
never touches the serving hot path: scrapes read the registry under its
own locks.
"""

from __future__ import annotations

import http.server
import json
import threading
from typing import Optional

from .metrics import MetricsRegistry, get_registry
from .trace import Tracer, get_tracer


class MetricsExporter:
    """Owns the HTTP server thread; ``close()`` (or context exit) stops it."""

    def __init__(self, *, port: int = 0, host: str = "127.0.0.1",
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        self.registry = registry if registry is not None else get_registry()
        self.tracer = tracer if tracer is not None else get_tracer()
        exporter = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):      # silence per-request spam
                pass

            def _send(self, body: bytes, ctype: str, code: int = 200):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        self._send(exporter.registry.prometheus_text()
                                   .encode(),
                                   "text/plain; version=0.0.4; "
                                   "charset=utf-8")
                    elif path == "/metrics.json":
                        self._send(json.dumps(exporter.registry.snapshot())
                                   .encode(), "application/json")
                    elif path == "/trace":
                        self._send(json.dumps(exporter.tracer.to_json())
                                   .encode(), "application/json")
                    elif path == "/healthz":
                        self._send(b"ok", "text/plain")
                    else:
                        self._send(b"not found", "text/plain", 404)
                except (BrokenPipeError, ConnectionResetError):
                    pass        # scraper went away mid-response
                except Exception as e:      # never kill the server thread
                    try:
                        self._send(f"error: {e}".encode(),
                                   "text/plain", 500)
                    except OSError:
                        pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]   # resolved if port=0
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"metrics-exporter:{self.port}", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "MetricsExporter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def start_http_exporter(port: int = 0, host: str = "127.0.0.1", *,
                        registry: Optional[MetricsRegistry] = None,
                        tracer: Optional[Tracer] = None) -> MetricsExporter:
    """Start the exporter thread; returns the handle (``.port``,
    ``.url``, ``.close()``)."""
    return MetricsExporter(port=port, host=host, registry=registry,
                           tracer=tracer)
