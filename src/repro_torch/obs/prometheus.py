"""Prometheus text-exposition rendering and a stdlib scrape endpoint.

``render(registry)`` emits text format version 0.0.4 (``# HELP`` /
``# TYPE`` headers, cumulative ``_bucket{le=...}`` histogram lines with
a ``+Inf`` bucket, ``_sum``/``_count``), and :class:`MetricsServer`
serves it from a background :class:`~http.server.ThreadingHTTPServer`
— no third-party client library, per the no-new-deps rule.  Enable it
with ``--metrics-port`` on ``launch/serve.py`` / ``launch/cluster.py``
and scrape with ``curl localhost:<port>/metrics``.
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .registry import Counter, Gauge, Histogram, MetricsRegistry

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class _ReuseAddrServer(ThreadingHTTPServer):
    # back-to-back replays on a fixed --metrics-port must not trip over
    # the previous run's TIME_WAIT socket
    allow_reuse_address = True
    daemon_threads = True


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _fmt_labels(names, values, extra=()) -> str:
    pairs = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    pairs.extend(f'{n}="{_escape(v)}"' for n, v in extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _fmt_num(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def render(registry: MetricsRegistry) -> str:
    """Render every registered metric as Prometheus text exposition."""
    out = []
    for m in registry.collect():
        out.append(f"# HELP {m.name} {_escape(m.help)}")
        out.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, Histogram):
            for key, child in m.children():
                total, s, counts = child.snapshot()
                acc = 0
                for bound, c in zip(m.buckets, counts):
                    acc += c
                    le = _fmt_labels(m.label_names, key,
                                     extra=[("le", _fmt_num(bound))])
                    out.append(f"{m.name}_bucket{le} {acc}")
                le = _fmt_labels(m.label_names, key, extra=[("le", "+Inf")])
                out.append(f"{m.name}_bucket{le} {total}")
                lbl = _fmt_labels(m.label_names, key)
                out.append(f"{m.name}_sum{lbl} {_fmt_num(s)}")
                out.append(f"{m.name}_count{lbl} {total}")
        elif isinstance(m, (Counter, Gauge)):
            for key, child in m.children():
                lbl = _fmt_labels(m.label_names, key)
                out.append(f"{m.name}{lbl} {_fmt_num(child.value)}")
    return "\n".join(out) + "\n"


class MetricsServer:
    """Background scrape endpoint: ``GET /metrics`` renders the
    registry; anything else 404s.  Daemon threads, so a hung scraper
    never blocks interpreter exit; still, call :meth:`close` (or use as
    a context manager) to release the port deterministically.

    ``port=0`` binds an ephemeral port — read it back from
    :attr:`port` (the tests do this to avoid collisions).
    """

    def __init__(self, registry: MetricsRegistry, *, port: int = 0,
                 host: str = "0.0.0.0"):
        self.registry = registry

        srv_registry = registry

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):                      # noqa: N802 (stdlib API)
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                body = render(srv_registry).encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):     # silence per-scrape spam
                pass

        self._httpd = _ReuseAddrServer((host, port), _Handler)
        self.port = self._httpd.server_address[1]
        self._closed = False
        self._close_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-server",
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop serving and release the port.  Idempotent — launchers
        and tests may close from both a finally block and an exit
        handler."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def maybe_serve(registry: Optional[MetricsRegistry],
                port: Optional[int]) -> Optional[MetricsServer]:
    """``--metrics-port`` helper: start a server iff both a real
    registry and a port were given."""
    if registry is None or port is None:
        return None
    return MetricsServer(registry, port=port)
