"""Telemetry sinks: JSONL metrics snapshots, Chrome trace files,
Prometheus text exposition — plus the live scrape surface for
long-running jobs: ``serve_metrics`` exposes ``prometheus_text()`` from
a real HTTP endpoint (stdlib ``http.server`` on a daemon thread;
``train --metrics_port``) and ``start_periodic_snapshots`` appends a
JSONL snapshot every interval so a job is observable without code
changes OR a scraper.

File layout convention (overridable per call):
  $TMPDIR/paddle_tpu_telemetry/metrics.jsonl  — one snapshot object per line
  $TMPDIR/paddle_tpu_telemetry/trace.json     — Chrome trace-event JSON

``python -m paddle_tpu_torch metrics|trace`` reads these back (see cli.py).  The formats are the JAX package's, so either package's
verbs read the other's files.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import List, Optional

from paddle_tpu_torch.observability import metrics as _metrics
from paddle_tpu_torch.observability import tracing as _tracing

DEFAULT_DIR = os.path.join(tempfile.gettempdir(), "paddle_tpu_telemetry")
DEFAULT_METRICS_PATH = os.path.join(DEFAULT_DIR, "metrics.jsonl")
DEFAULT_TRACE_PATH = os.path.join(DEFAULT_DIR, "trace.json")

# serializes the read-modify-write JSONL appends below: two writer
# threads (periodic snapshotter + flight recorder sheds) racing the
# atomic replace would silently drop one thread's lines
_APPEND_LOCK = threading.Lock()


def append_jsonl_atomic(path: str, records, max_lines=None) -> str:
    """Append JSON records to a JSONL file through ``io/atomic.py``:
    the whole (existing + new, optionally bounded to the newest
    ``max_lines``) content lands via tmp+fsync+rename, so a SIGKILL
    mid-write can never publish a torn or half-appended telemetry file
    (the discipline of every model artifact).
    Same-process appends are serialized by a module lock; appends from
    SEPARATE processes sharing one file (two ``--telemetry_dir`` runs
    on the default path) are serialized by an ``flock`` on a sidecar
    ``<path>.lock`` — without it, two concurrent read-modify-rename
    cycles would silently drop one writer's lines (the failure mode a
    plain ``O_APPEND`` never had)."""
    import fcntl

    from paddle_tpu_torch.io import atomic as _atomic

    path = os.path.abspath(path)
    new_lines = [json.dumps(r) for r in records]
    with _APPEND_LOCK:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        lock_fd = os.open(path + ".lock",
                          os.O_CREAT | os.O_WRONLY, 0o600)
        try:
            try:
                fcntl.flock(lock_fd, fcntl.LOCK_EX)
            except OSError:
                pass                     # best effort (odd filesystems)
            lines: List[str] = []
            try:
                with open(path) as f:
                    lines = [ln for ln in f.read().splitlines() if ln]
            except OSError:
                pass
            lines.extend(new_lines)
            if max_lines is not None and len(lines) > max_lines:
                lines = lines[-int(max_lines):]
            payload = ("\n".join(lines) + "\n").encode()
            _atomic.atomic_write_file(path,
                                      lambda f: f.write(payload))
        finally:
            os.close(lock_fd)            # closing releases the flock
    return path


def _refresh_derived(registry) -> None:
    """Recompute derived gauges (executable MFU / bandwidth rollups)
    right before an export, so scrapes and snapshots see values that
    reflect dispatches since the last export.  Only meaningful for the
    global registry — ``executables.refresh_gauges`` writes through the
    module-level helpers, which always target ``_metrics.REGISTRY``."""
    if registry is not None and registry is not _metrics.REGISTRY:
        return
    try:
        from paddle_tpu_torch.observability import executables as _executables

        _executables.refresh_gauges()
    except Exception:                     # noqa: BLE001 — an exporter
        pass                              # must never die on a gauge


def write_metrics_snapshot(path: Optional[str] = None, registry=None,
                           extra: Optional[dict] = None,
                           max_lines: Optional[int] = 8192) -> dict:
    """Append one snapshot line to a JSONL file (atomically — see
    ``append_jsonl_atomic``); returns the record.  The file is bounded
    to the newest ``max_lines`` snapshots (the atomic append rewrites
    the whole file, so an unbounded time series would make each
    periodic snapshot cost O(run length); ~5.7 days at the default
    60 s cadence — pass ``max_lines=None`` to keep everything)."""
    path = path or DEFAULT_METRICS_PATH
    reg = registry or _metrics.REGISTRY
    _refresh_derived(reg)
    rec = {"ts": time.strftime("%Y-%m-%dT%H:%M:%S")}
    rec.update(reg.snapshot())
    if extra:
        rec.update(extra)
    append_jsonl_atomic(path, [rec], max_lines=max_lines)
    return rec


def read_snapshots(path: Optional[str] = None) -> List[dict]:
    path = path or DEFAULT_METRICS_PATH
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def write_chrome_trace(path: Optional[str] = None, tracer=None) -> str:
    """Write the tracer's ring buffer as Chrome trace-event JSON
    (atomic tmp+rename — a reader never sees a torn trace file)."""
    from paddle_tpu_torch.io import atomic as _atomic

    path = path or DEFAULT_TRACE_PATH
    tr = tracer or _tracing.TRACER
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = json.dumps(tr.to_chrome()).encode()
    _atomic.atomic_write_file(path, lambda f: f.write(payload))
    return path


def read_chrome_trace(path: Optional[str] = None) -> dict:
    path = path or DEFAULT_TRACE_PATH
    with open(path) as f:
        return json.load(f)


def prometheus_text(registry=None) -> str:
    """Prometheus text-format exposition of the live registry — serve it
    from any HTTP handler (or dump to a node-exporter textfile dir)."""
    reg = registry or _metrics.REGISTRY
    _refresh_derived(reg)
    return reg.to_prometheus()


def _handler_arity(fn) -> int:
    """Positional parameter count of an extra handler — decided once
    at mount time: 2 = ``(method, body)``, 3 = ``+ headers``, 4 =
    ``+ rest`` (the subpath of a prefix mount, or the query string of
    a query-delegated exact mount)."""
    import inspect

    try:
        params = list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):
        return 2
    if any(p.kind == p.VAR_POSITIONAL for p in params):
        return 4
    positional = [p for p in params if p.kind in
                  (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    return min(4, max(2, len(positional)))


def _server_class():
    from http.server import ThreadingHTTPServer

    class _Server(ThreadingHTTPServer):
        # a flood of callers (the serving engine's /infer shares this
        # server) queues in the listen backlog instead of being reset
        # (socketserver's default backlog is 5)
        request_queue_size = 1024
        daemon_threads = True

        def handle_error(self, request, client_address):
            # a caller that hung up before its answer (a client's own
            # timeout) is not a server fault
            import sys
            if isinstance(sys.exc_info()[1], (BrokenPipeError,
                                               ConnectionResetError)):
                return
            super().handle_error(request, client_address)

    return _Server


def serve_metrics(port: int, host: str = "127.0.0.1", registry=None,
                  extra_handlers=None, health_fn=None):
    """Serve the live registry over HTTP from a daemon thread
    (``train --metrics_port``): ``/metrics`` is Prometheus text format,
    ``/metrics.json`` the raw snapshot, ``/healthz`` a liveness probe.
    ``port=0`` binds an ephemeral port — read ``server.server_port``.
    Returns the ``ThreadingHTTPServer``; call ``.shutdown()`` to stop.

    ``extra_handlers`` mounts additional paths on the SAME server (the
    serving engine's ``/infer`` and ``/stats`` share the metrics port
    instead of opening a second one): a dict mapping an exact path to
    ``fn(method, body) -> (status, content_type, payload_bytes)``.
    A handler declaring a third parameter receives the request headers
    (an ``email.message.Message`` — case-insensitive ``get``), and any
    handler may return a 4-tuple whose last element is a dict of extra
    response headers (the serving engine's ``Retry-After`` on 429).
    A key ENDING in ``/`` is a PREFIX mount: it matches every path
    under it, and a handler declaring a fourth parameter receives the
    remainder (the fleet router's ``/trace/<id>`` timeline assembly).
    Built-in BARE paths always win, so ``/metrics``, ``/metrics.json``
    and ``/healthz`` behave identically with or without extras — with
    ONE deliberate exception: a query-string request to a built-in
    path that is ALSO mounted as an extra (``/metrics?fleet=1`` on the
    router) goes to the extra, which receives the query string as its
    fourth parameter; handler exceptions answer 500 without killing
    the server thread.

    ``health_fn`` upgrades ``/healthz`` from the unconditional ``ok``
    to a real readiness probe: ``health_fn() -> (status_code, body_str)``
    (the serving engine answers ``200 ok`` / ``503 overloaded|dead`` so
    fleet orchestration can act on it); a raising ``health_fn`` answers
    503 — an unhealthy prober must read as unhealthy, not crash.

    The endpoint is unauthenticated, so it binds loopback by default;
    pass an explicit ``host`` (``train --metrics_host``) to expose it
    to a scraper on another machine — deliberately, not by accident.
    """
    from http.server import BaseHTTPRequestHandler

    _Server = _server_class()
    reg = registry or _metrics.REGISTRY
    extras = dict(extra_handlers or {})
    arity = {path: _handler_arity(fn) for path, fn in extras.items()}
    # prefix mounts (keys ending "/"), longest first so the most
    # specific mount wins
    prefixes = sorted((p for p in extras if p.endswith("/")),
                      key=len, reverse=True)

    class _Handler(BaseHTTPRequestHandler):
        def _send(self, body: bytes, ctype: str, code: int = 200,
                  extra_headers=None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra_headers or {}).items():
                self.send_header(k, str(v))
            self.end_headers()
            self.wfile.write(body)

        def _try_extra(self, path: str, query: str,
                       method: str) -> bool:
            fn = extras.get(path)
            rest = query                     # exact mount: the query
            if fn is None:
                for pref in prefixes:
                    if path.startswith(pref):
                        fn = extras[pref]
                        rest = path[len(pref):]   # prefix: the subpath
                        path = pref
                        break
                else:
                    return False
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            hdrs = None
            try:
                n = arity[path]
                if n >= 4:
                    res = fn(method, body, self.headers, rest)
                elif n == 3:
                    res = fn(method, body, self.headers)
                else:
                    res = fn(method, body)
                if len(res) == 4:
                    code, ctype, payload, hdrs = res
                else:
                    code, ctype, payload = res
            except Exception as e:          # noqa: BLE001 — isolate
                code, ctype = 500, "text/plain"
                payload = f"handler error: {e!r}\n".encode()
            self._send(payload, ctype, code, extra_headers=hdrs)
            return True

        def _healthz(self):
            if health_fn is None:
                self._send(b"ok\n", "text/plain")
                return
            try:
                code, body = health_fn()
            except Exception as e:          # noqa: BLE001 — isolate
                code, body = 503, f"health probe error: {e!r}\n"
            self._send(body.encode(), "text/plain", code)

        def do_GET(self):
            path, _, query = self.path.partition("?")
            # a query-string request to a mounted built-in path is the
            # one delegation: bare built-ins stay byte-identical with
            # or without extras (the fleet rollup's /metrics?fleet=1)
            delegated = (query and path in extras
                         and path in ("/metrics", "/metrics.json"))
            if path in ("/", "/metrics") and not delegated:
                self._send(prometheus_text(reg).encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/metrics.json" and not delegated:
                _refresh_derived(reg)
                snap = {"ts": time.strftime("%Y-%m-%dT%H:%M:%S")}
                snap.update(reg.snapshot())
                self._send(json.dumps(snap).encode(),
                           "application/json")
            elif path == "/healthz":
                self._healthz()
            elif self._try_extra(path, query, "GET"):
                pass
            else:
                self._send(b"not found\n", "text/plain", 404)

        def do_POST(self):
            path, _, query = self.path.partition("?")
            if not self._try_extra(path, query, "POST"):
                # match the BaseHTTPRequestHandler answer a server
                # without do_POST would give, so adding extras never
                # changes behavior for unmounted paths
                self.send_error(501, "Unsupported method ('POST')")

        def log_message(self, *a):        # scrapes must not spam stdout
            pass

    server = _Server((host, port), _Handler)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="ptpu-metrics-http").start()
    return server


class PeriodicSnapshotter:
    """Daemon thread appending a metrics snapshot line to a JSONL file
    every ``interval_s`` — the scrape-free observability floor for a
    long-running trainer (``train --telemetry_dir`` starts one).  The
    final snapshot on ``stop()`` captures the end-of-run state."""

    def __init__(self, path: str, interval_s: float = 60.0,
                 registry=None):
        self.path = path
        self.interval_s = float(interval_s)
        self.registry = registry
        self._warned = False
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="ptpu-metrics-snapshot")

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                write_metrics_snapshot(self.path, registry=self.registry)
            except Exception as e:         # noqa: BLE001
                # a full disk or an unserializable metric value must
                # not kill the time series for the rest of the run —
                # warn once, keep ticking
                if not self._warned:
                    self._warned = True
                    import warnings

                    warnings.warn(
                        f"periodic metrics snapshot to {self.path} "
                        f"failing: {e!r} (will keep retrying silently)")

    def start(self) -> "PeriodicSnapshotter":
        self._thread.start()
        return self

    def stop(self, final_snapshot: bool = True) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        if final_snapshot:
            try:
                write_metrics_snapshot(self.path, registry=self.registry)
            except Exception:              # noqa: BLE001
                pass


def start_periodic_snapshots(path: Optional[str] = None,
                             interval_s: float = 60.0,
                             registry=None) -> PeriodicSnapshotter:
    return PeriodicSnapshotter(path or DEFAULT_METRICS_PATH, interval_s,
                               registry).start()
