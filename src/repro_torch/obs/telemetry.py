"""Live telemetry (counterpart of ``repro.obs.telemetry``): Prometheus
text exposition and a stdlib ``/metrics`` server.

:func:`prometheus_text` renders a
:class:`~repro_torch.obs.metrics.MetricsRegistry` snapshot in the
Prometheus text exposition format (0.0.4), the reference's text for the
same instruments, and :class:`TelemetryServer` serves it over the
standard library's ``http.server``, so a long streamed decomposition or a
serving engine can be watched by any Prometheus, curl or watch loop:

    with tracing() as tr:
        rep = ProgressReporter("status.json")
        with TelemetryServer(registry=tr.metrics, progress=rep) as srv:
            print(srv.url)                      # http://127.0.0.1:<port>
            rid_streamed(seed, src, k, progress=rep)

Routes (a dispatch dict, one handler per path):

  ``/metrics``   Prometheus text: every registry instrument (counters as
                 ``<ns>_<name>_total``, histograms as summaries), the
                 server's uptime and, with a reporter attached, the job's
                 done/total/retries/failures/eta.
  ``/healthz``   liveness JSON (``{"status": "ok", ...}``).
  ``/progress``  the reporter's status snapshot as JSON, the dict its
                 status file holds.

This file is the port's one socket/server module: ``lint.socket-server``
(``analysis/lint.py``) refuses ``http.server`` / ``socketserver`` /
``socket`` imports everywhere else in the library.  Uptime comes from an
injected :class:`~repro_torch.obs.clock.Clock`.  The server binds
``127.0.0.1`` on an ephemeral port by default.

:class:`PrometheusExporter` (registered as ``"prometheus"`` in the
exporter registry) writes the same text to a file when a trace finishes,
for runs with no live server.
"""
from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

from .clock import Clock, MONOTONIC
from .export import register_exporter

__all__ = ["prometheus_text", "TelemetryServer", "PrometheusExporter"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str, namespace: str) -> str:
    """``stream.h2d_bytes`` -> ``repro_stream_h2d_bytes``."""
    return f"{namespace}_{_NAME_RE.sub('_', name)}"


def _num(v) -> str:
    if v is None:
        return "NaN"
    return repr(float(v))


def _render_counter(base: str, m: dict) -> list[str]:
    return [f"# TYPE {base}_total counter",
            f"{base}_total {_num(m['value'])}"]


def _render_gauge(base: str, m: dict) -> list[str]:
    return [f"# TYPE {base} gauge", f"{base} {_num(m['value'])}"]


def _render_histogram(base: str, m: dict) -> list[str]:
    lines = [f"# TYPE {base} summary",
             f"{base}_count {_num(m['count'])}",
             f"{base}_sum {_num(m['sum'])}"]
    for stat in ("min", "max"):
        lines.append(f"# TYPE {base}_{stat} gauge")
        lines.append(f"{base}_{stat} {_num(m.get(stat))}")
    return lines


_RENDERERS = {"counter": _render_counter, "gauge": _render_gauge,
              "histogram": _render_histogram}


def prometheus_text(metrics, *, namespace: str = "repro") -> str:
    """Render metric snapshots in Prometheus text exposition 0.0.4.

    ``metrics`` is a :class:`MetricsRegistry` (or anything with
    ``snapshot() -> list[dict]``) or an already-taken snapshot list.
    Counters get the conventional ``_total`` suffix, histograms render
    as summaries (``_count`` / ``_sum``) plus ``_min`` / ``_max``
    gauges, gauges pass through.
    """
    snaps = metrics.snapshot() if hasattr(metrics, "snapshot") else metrics
    lines: list[str] = []
    for m in snaps:
        render = _RENDERERS.get(m["type"])
        if render is None:
            raise ValueError(f"unknown metric snapshot type {m['type']!r}")
        lines.extend(render(_prom_name(m["name"], namespace), m))
    return "\n".join(lines) + ("\n" if lines else "")


def _progress_prom(status: dict, namespace: str) -> str:
    """Project the reporter snapshot onto a few well-known gauges."""
    pairs = [("progress_done", status.get("done")),
             ("progress_total", status.get("total")),
             ("progress_fraction", status.get("fraction")),
             ("progress_eta_seconds", status.get("eta_s")),
             ("progress_retries", status.get("retries")),
             ("progress_failures", status.get("failures")),
             ("progress_checkpoint_age_seconds",
              status.get("checkpoint_age_s"))]
    lines = []
    for suffix, v in pairs:
        if v is None:
            continue
        name = f"{namespace}_{suffix}"
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {_num(v)}")
    return "\n".join(lines) + ("\n" if lines else "")


class TelemetryServer:
    """Scrapeable ``/metrics`` + ``/healthz`` + ``/progress`` over a
    daemon-threaded stdlib HTTP server.

    ``port=0`` (the default) binds an ephemeral port, read back via
    ``.port`` / ``.url`` after :meth:`start`.  ``registry`` is a live
    :class:`MetricsRegistry` (snapshots are taken per scrape, so the
    scraper always sees current values); ``progress`` is an optional
    :class:`~repro_torch.obs.progress.ProgressReporter`.  Use as a context
    manager or call :meth:`start` / :meth:`stop` explicitly.
    """

    def __init__(self, *, registry=None, progress=None,
                 host: str = "127.0.0.1", port: int = 0,
                 clock: Clock = MONOTONIC, namespace: str = "repro"):
        self.registry = registry
        self.progress = progress
        self.host = host
        self.port = port
        self.clock = clock
        self.namespace = namespace
        self._t_start = clock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # Dispatch dict, not an if/elif chain: one handler per route.
        self.routes = {"/metrics": self._route_metrics,
                       "/healthz": self._route_healthz,
                       "/progress": self._route_progress}

    # ------------------------------------------------------------- routes
    def _route_metrics(self):
        body = ""
        if self.registry is not None:
            body += prometheus_text(self.registry, namespace=self.namespace)
        up = f"{self.namespace}_uptime_seconds"
        body += (f"# TYPE {up} gauge\n"
                 f"{up} {_num(self.clock() - self._t_start)}\n")
        if self.progress is not None:
            body += _progress_prom(self.progress.status(), self.namespace)
        return 200, "text/plain; version=0.0.4; charset=utf-8", body

    def _route_healthz(self):
        payload = {"status": "ok",
                   "uptime_s": self.clock() - self._t_start}
        return 200, "application/json", json.dumps(payload) + "\n"

    def _route_progress(self):
        if self.progress is None:
            return 404, "application/json", '{"error": "no reporter"}\n'
        return (200, "application/json",
                json.dumps(self.progress.status(), sort_keys=True) + "\n")

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "TelemetryServer":
        if self._httpd is not None:
            raise RuntimeError("telemetry server already started")
        server = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802  (stdlib casing)
                path = self.path.split("?", 1)[0]
                route = server.routes.get(path)
                if route is None:
                    code, ctype, body = 404, "application/json", \
                        json.dumps({"error": "not found",
                                    "routes": sorted(server.routes)}) + "\n"
                else:
                    code, ctype, body = route()
                raw = body.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def log_message(self, fmt, *args):
                pass                   # scrapes must not spam stderr

        self._httpd = ThreadingHTTPServer((self.host, self.port), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="repro-telemetry", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def __enter__(self) -> "TelemetryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


@register_exporter("prometheus")
class PrometheusExporter:
    """Write the final metric registry as Prometheus text when the trace
    finishes, for runs without a live server."""

    def __init__(self, path, *, namespace: str = "repro"):
        self.path = Path(path)
        self.namespace = namespace

    def export(self, tracer) -> None:
        self.path.write_text(
            prometheus_text(tracer.metrics, namespace=self.namespace))
