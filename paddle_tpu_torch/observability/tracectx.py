"""Fleet-wide distributed tracing: request ids that survive
client -> router -> replica, plus the tail-based flight recorder.

PR 2's span ring answers "where did THIS PROCESS spend its time"; a
fleet request crosses three processes (``ServingClient`` retry loop,
the router's P2C pick + forward, a replica's admission/WFQ/batcher/
decode path) and each keeps its own unlinked ring.  This module is the
Dapper-style glue (Sigelman et al., 2010): a ``TraceContext`` (trace
id, parent span id, sampling bit) minted at the outermost edge that
sees the request, carried as the ``X-Ptpu-Trace`` header hop to hop,
so every process's spans record under ONE trace id and a single
``python -m paddle_tpu_torch trace --request <id>`` reconstructs the whole
timeline.

Three layers, all serving-path only (training telemetry is untouched):

  * **Propagation** — ``TraceContext.parse``/``to_header`` speak the
    ``<trace_id>-<span_id>-<flags>`` wire format; ``mint()`` creates a
    fresh context with the head-sampling decision baked into the
    flags bit so every downstream hop agrees on whether the trace is
    kept (the Dapper invariant: sample at the edge, propagate the
    verdict).
  * **Recording** — a ``SpanBuffer`` rides each request
    (``_Request.trace`` in the engine; a local in the router/client
    handlers): sub-spans parent to the buffer's root span, and the
    completed buffer publishes into the process-global bounded
    ``TraceStore`` that the ``/trace`` HTTP handlers serve.  Spans
    carry wall-clock (epoch) timestamps so cross-process timelines
    line up without a shared monotonic clock.
  * **Tail-based flight recorder** — publication is decided at
    REQUEST COMPLETION, not submission: head-sampled traces (default
    ~1%) always keep, and anomalous requests — shed, typed error,
    deadline-exceeded, or latency above a rolling-p99-derived
    threshold — keep UNCONDITIONALLY, flushed to
    ``<telemetry_dir>/flight.jsonl`` (bounded, atomic-write) so an
    incident is reconstructable after the fact even at 1% head
    sampling.

Everything is inert until a serving edge is constructed with tracing
on (``InferenceEngine(trace_sample=...)``, ``Router(trace_sample=...)``,
``ServingClient(trace_sample=...)``, or the serve CLI's default): the
disabled path allocates nothing per request and is bit-identical.
"""

from __future__ import annotations

import json
import os
import queue as _queue_mod
import random
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["TraceContext", "SpanBuffer", "TraceStore", "FlightRecorder",
           "HEADER", "STORE", "mint", "new_span_id", "set_process_info",
           "process_info", "push_spans", "spans_to_chrome",
           "CAPTURE_REASONS", "DEFAULT_SAMPLE"]

#: the propagation header: ``<trace_id>-<parent_span_id>-<flags>``
#: (16 lowercase hex chars, 16 hex chars, ``1``/``0`` sampled bit).
HEADER = "X-Ptpu-Trace"
ENV_SAMPLE = "PADDLE_TPU_TRACE_SAMPLE"
#: always-on head-sampling rate when tracing is enabled without an
#: explicit rate — ~1% keeps steady-state overhead negligible while
#: the flight recorder catches every anomalous request regardless.
DEFAULT_SAMPLE = 0.01

#: why a completed request's spans were kept (the flight recorder's
#: capture taxonomy): ``sampled`` = the head-sampling bit, the rest
#: are tail-based anomaly captures independent of that bit.
CAPTURE_REASONS = ("sampled", "shed", "error", "deadline", "slow")


def make_recorder(trace_sample, telemetry_dir):
    """The ONE construction policy every tracing edge (engine, router,
    client) shares: validate the sample rate, return a
    ``FlightRecorder`` when tracing is asked for (either knob) and
    None when both are absent — the bit-identical disabled path."""
    if trace_sample is not None and not 0.0 <= trace_sample <= 1.0:
        raise ValueError(f"trace_sample must be in [0, 1], got "
                         f"{trace_sample}")
    if trace_sample is None and not telemetry_dir:
        return None
    return FlightRecorder(telemetry_dir, sample=trace_sample)

_rng = random.Random()
_rng_lock = threading.Lock()


def new_span_id() -> str:
    """16 lowercase hex chars (64 random bits)."""
    with _rng_lock:
        return f"{_rng.getrandbits(64):016x}"


class TraceContext:
    """One request's propagated identity: the trace id every process
    records under, the parent span id of the upstream hop, and the
    head-sampling verdict (decided once at mint time, honored by every
    hop — Dapper's consistent-sampling invariant)."""

    __slots__ = ("trace_id", "parent_span_id", "sampled")

    def __init__(self, trace_id: str, parent_span_id: str = "",
                 sampled: bool = False):
        self.trace_id = trace_id
        self.parent_span_id = parent_span_id
        self.sampled = bool(sampled)

    def to_header(self) -> str:
        return (f"{self.trace_id}-{self.parent_span_id or '0' * 16}-"
                f"{'1' if self.sampled else '0'}")

    def child(self, parent_span_id: str) -> "TraceContext":
        """The context a downstream hop receives: same trace id and
        sampling verdict, parented under one of OUR spans."""
        return TraceContext(self.trace_id, parent_span_id, self.sampled)

    @classmethod
    def parse(cls, value) -> Optional["TraceContext"]:
        """A context from a header value, or None when absent or
        malformed (garbage from an untrusted client must never 500 a
        request — untagged traffic is minted a fresh context at the
        edge instead)."""
        if not value or not isinstance(value, str):
            return None
        parts = value.strip().split("-")
        if len(parts) != 3:
            return None
        tid, psid, flags = parts
        if not (_is_hex(tid) and _is_hex(psid) and flags in ("0", "1")):
            return None
        return cls(tid.lower(), psid.lower(), flags == "1")

    def __repr__(self) -> str:
        return (f"TraceContext({self.trace_id}, "
                f"parent={self.parent_span_id or '-'}, "
                f"sampled={self.sampled})")


def _is_hex(s: str) -> bool:
    if not s or len(s) > 32:
        return False
    try:
        int(s, 16)
        return True
    except ValueError:
        return False


def mint(sample_rate: Optional[float] = None) -> TraceContext:
    """A fresh root context for untagged traffic (or a client-side
    call): the head-sampling decision is made HERE and propagated."""
    if sample_rate is None:
        sample_rate = DEFAULT_SAMPLE
    with _rng_lock:
        sampled = sample_rate > 0 and _rng.random() < sample_rate
        tid = f"{_rng.getrandbits(64):016x}"
    return TraceContext(tid, "", sampled)


# ---------------------------------------------------------- process info

# set once by the serving edges (engine.serve / router.serve / client)
# so every span says WHICH process of the fleet produced it
_proc_lock = threading.Lock()
_proc = {"role": "proc", "port": 0, "pid": os.getpid()}


def set_process_info(role: str, port: int = 0) -> None:
    with _proc_lock:
        _proc["role"] = str(role)
        _proc["port"] = int(port)
        _proc["pid"] = os.getpid()


def process_info() -> dict:
    with _proc_lock:
        return dict(_proc)


# ---------------------------------------------------------- span buffer

class _OpenSpan:
    """Handle yielded by ``SpanBuffer.span`` — its pre-minted ``id`` is
    what a downstream hop's context parents under, available BEFORE the
    call completes (the header must carry it on the wire)."""

    __slots__ = ("id", "args")

    def __init__(self, span_id: str):
        self.id = span_id
        self.args = None          # set to a dict to add args at close


class SpanBuffer:
    """Per-request span accumulator: one root span covering this
    process's part of the request, sub-spans parented under it.
    Completed spans are plain dicts (JSON-ready) with epoch-µs
    timestamps; nothing is published until ``FlightRecorder.finish``
    (or ``TraceStore.publish``) decides the request is worth keeping —
    the tail-based half of the sampling story.

    Thread tolerance matches the request lifecycle: the submitting
    thread builds it, the batcher/delivery threads append via
    ``add_span``/``event`` (list.append is atomic under the GIL), and
    exactly one resolution path calls finish."""

    __slots__ = ("ctx", "root_id", "root_name", "root_args", "spans",
                 "role", "port", "pid", "_epoch0_us", "_perf0_ns",
                 "finished", "push_url")

    def __init__(self, ctx: TraceContext, root_name: str,
                 role: Optional[str] = None, port: Optional[int] = None,
                 **root_args):
        self.ctx = ctx
        self.root_id = new_span_id()
        self.root_name = root_name
        self.root_args = root_args or None
        self.spans: List[dict] = []
        info = process_info()
        # per-buffer overrides: a ServingClient's spans must say
        # "client" even when it lives inside a replica process (tests,
        # in-process benches), and an engine knows its bound port
        self.role = role or info["role"]
        self.port = info["port"] if port is None else int(port)
        self.pid = info["pid"]
        # epoch<->perf anchors: spans are timed with perf_counter_ns
        # (monotonic, cheap) and exported on the epoch timeline so
        # cross-process assembly lines up without a shared clock
        self._epoch0_us = time.time_ns() // 1000
        self._perf0_ns = time.perf_counter_ns()
        self.finished = False
        # where kept spans should be pushed (the ServingClient sets it
        # to the endpoint that actually ANSWERED, so a failover trace's
        # client side isn't pushed at the dead endpoint)
        self.push_url: Optional[str] = None

    # ---- recording
    def _mk(self, name: str, span_id: str, parent_id: str,
            start_perf_ns: int, dur_ns: int, args) -> dict:
        start_us = self._epoch0_us + (start_perf_ns
                                      - self._perf0_ns) // 1000
        return {"trace_id": self.ctx.trace_id, "span_id": span_id,
                "parent_id": parent_id, "name": name,
                "role": self.role, "pid": self.pid, "port": self.port,
                "start_us": start_us,
                "dur_us": round(dur_ns / 1000, 1),
                "args": args or None}

    def add_span(self, name: str, start_perf_ns: int, dur_ns: int,
                 parent_id: Optional[str] = None,
                 span_id: Optional[str] = None, **args) -> str:
        """Record one completed sub-span from explicit perf_counter_ns
        timings (the engine's hot paths already hold them).
        ``span_id`` accepts a pre-minted id — the client's attempt
        spans put their id on the wire BEFORE the attempt completes so
        the downstream hop can parent under it."""
        sid = span_id or new_span_id()
        self.spans.append(self._mk(name, sid, parent_id or self.root_id,
                                   start_perf_ns, dur_ns, args))
        return sid

    def event(self, name: str, **args) -> str:
        """A zero-duration marker (shed, failover) at 'now'."""
        return self.add_span(name, time.perf_counter_ns(), 0, **args)

    def span(self, name: str, **args):
        """``with trace.span("router/forward", replica=url) as sp:``
        — ``sp.id`` is available inside the block (set it as the
        downstream parent); ``sp.args`` may be set to a dict to attach
        results (status, error) at close.  The convenience form for
        new instrumentation; the serving hot paths use ``add_span``
        with explicit perf_counter timings instead (they already hold
        them, and their failure paths span multiple blocks).  CM spans
        always parent to the buffer's root span."""
        return _SpanCM(self, name, args)

    # ---- completion
    def finish(self, outcome: str = "ok", **args) -> List[dict]:
        """Close the root span; returns the full span list (root
        last).  Idempotent — a shed path and a delivery path can race
        to finish, only the first closes the root."""
        if self.finished:
            return self.spans
        self.finished = True
        merged = dict(self.root_args or {})
        merged.update(args)
        merged["outcome"] = outcome
        root = self._mk(self.root_name, self.root_id,
                        self.ctx.parent_span_id, self._perf0_ns,
                        time.perf_counter_ns() - self._perf0_ns, merged)
        self.spans.append(root)
        return self.spans


class _SpanCM:
    __slots__ = ("_buf", "_name", "_args", "_sp", "_t0")

    def __init__(self, buf: SpanBuffer, name: str, args: dict):
        self._buf = buf
        self._name = name
        self._args = args

    def __enter__(self) -> _OpenSpan:
        self._sp = _OpenSpan(new_span_id())
        self._t0 = time.perf_counter_ns()
        return self._sp

    def __exit__(self, exc_type, exc, tb) -> None:
        dur = time.perf_counter_ns() - self._t0
        args = dict(self._args)
        if self._sp.args:
            args.update(self._sp.args)
        if exc is not None:
            args["error"] = repr(exc)
        buf = self._buf
        buf.spans.append(buf._mk(self._name, self._sp.id, buf.root_id,
                                 self._t0, dur, args))


# ----------------------------------------------------------- trace store

class TraceStore:
    """Process-global bounded span store behind the ``/trace`` HTTP
    surface: the newest ``capacity`` spans, queryable by trace id.
    Old traces age out — durability is the flight recorder's job, the
    store only has to outlive a ``trace --request`` issued seconds
    after the request it asks about."""

    def __init__(self, capacity: int = 8192):
        self._spans: deque = deque(maxlen=int(capacity))
        self._lock = threading.Lock()

    def publish(self, spans: List[dict]) -> None:
        with self._lock:
            self._spans.extend(spans)

    def get(self, trace_id: str) -> List[dict]:
        with self._lock:
            return [s for s in self._spans
                    if s.get("trace_id") == trace_id]

    def recent_ids(self, n: int = 32) -> List[str]:
        """Most-recent trace ids, newest first, deduplicated."""
        with self._lock:
            snap = list(self._spans)
        out: List[str] = []
        seen = set()
        for s in reversed(snap):
            tid = s.get("trace_id")
            if tid and tid not in seen:
                seen.add(tid)
                out.append(tid)
                if len(out) >= n:
                    break
        return out

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()


STORE = TraceStore()


# ------------------------------------------------------- flight recorder

class FlightRecorder:
    """Tail-based keep/drop decision + durable capture.

    Every completed request reports its outcome and latency; the spans
    are KEPT when the trace was head-sampled, the outcome is anomalous
    (shed / typed error / deadline), or the latency exceeds a rolling
    p99-derived threshold (``latency_factor`` × the p99 of the last
    ``window`` completions, armed once ``min_completions`` latencies
    are in the window so a cold start doesn't flag everything).  Kept
    spans publish to the process ``TraceStore`` (the ``/trace``
    surface) and, when ``telemetry_dir`` is set, append to
    ``flight.jsonl`` — bounded to the newest ``max_records`` lines,
    written through ``io/atomic.py`` so a SIGKILL mid-flush can never
    publish a torn incident log."""

    def __init__(self, telemetry_dir: Optional[str] = None,
                 sample: Optional[float] = None,
                 latency_factor: float = 1.5,
                 window: int = 2048,
                 min_completions: int = 128,
                 max_records: int = 1024,
                 store: Optional[TraceStore] = None):
        self.telemetry_dir = telemetry_dir
        # per-process file: fleet replicas share one --telemetry_dir,
        # and the atomic read-modify-write append is only serialized
        # within a process
        self.flight_path = (os.path.join(
            telemetry_dir, f"flight-{os.getpid()}.jsonl")
            if telemetry_dir else None)
        self.sample = DEFAULT_SAMPLE if sample is None else float(sample)
        self.latency_factor = float(latency_factor)
        self.min_completions = int(min_completions)
        self.max_records = int(max_records)
        self._lat = deque(maxlen=int(window))
        self._lock = threading.Lock()
        self._store = store or STORE
        self.captured = {r: 0 for r in CAPTURE_REASONS}
        # the slow threshold is consulted on EVERY unsampled
        # completion — sorting the whole window there would cost more
        # than the rest of tracing combined (measured ~100+ µs/req),
        # so it is cached and recomputed every _THR_REFRESH notes
        self._n_lat = 0
        self._thr_cache: Optional[float] = None
        self._thr_at = 0

    _THR_REFRESH = 128

    # ---- rolling latency threshold
    def note_latency(self, us: float) -> None:
        with self._lock:
            self._lat.append(us)
            self._n_lat += 1

    def threshold_us(self) -> Optional[float]:
        """The slow-request capture bound, or None while unarmed.
        Cached: recomputed from the rolling window at most every
        ``_THR_REFRESH`` completions."""
        with self._lock:
            n = self._n_lat
            if (self._thr_cache is not None
                    and n - self._thr_at < self._THR_REFRESH):
                return self._thr_cache
            lat = sorted(self._lat)
        if len(lat) < self.min_completions:
            return None
        p99 = lat[min(len(lat) - 1, int(0.99 * len(lat)))]
        thr = p99 * self.latency_factor
        with self._lock:
            self._thr_cache = thr
            self._thr_at = n
        return thr

    def _capture_reason(self, ctx: TraceContext, outcome: str,
                        latency_us) -> Optional[str]:
        if outcome in ("shed", "error", "deadline"):
            return outcome
        if ctx is not None and ctx.sampled:
            return "sampled"
        if latency_us is not None:
            thr = self.threshold_us()
            if thr is not None and latency_us > thr:
                return "slow"
        return None

    # ---- the one completion entry point
    def finish(self, buf: Optional[SpanBuffer], outcome: str,
               latency_us: Optional[float] = None, **args) -> bool:
        """Close ``buf`` and keep or drop its spans (see class doc).
        Returns True when the trace was kept.  ``buf`` may be None
        (tracing off for this request) — only the latency window is
        fed then."""
        if latency_us is not None and outcome == "ok":
            self.note_latency(latency_us)
        if buf is None or buf.finished:
            return False
        if latency_us is not None:
            args.setdefault("latency_us", round(latency_us, 1))
        reason = self._capture_reason(buf.ctx, outcome, latency_us)
        spans = buf.finish(outcome, **args)
        if reason is None:
            return False
        with self._lock:
            self.captured[reason] += 1
        self._store.publish(spans)
        if self.telemetry_dir:
            self._flush(buf.ctx.trace_id, reason, outcome, spans)
        return True

    def _flush(self, trace_id: str, reason: str, outcome: str,
               spans: List[dict]) -> None:
        rec = {"ts": time.strftime("%Y-%m-%dT%H:%M:%S"),
               "trace_id": trace_id, "reason": reason,
               "outcome": outcome, **process_info(), "spans": spans}
        # OFF the request path: sheds/errors are captured
        # unconditionally, so a synchronous read-rewrite-fsync here
        # would make the microsecond fast-shed path disk-bound exactly
        # during an overload storm — the background writer coalesces
        # and pays the I/O instead (full queue drops, counted)
        FLIGHT_WRITER.push(self.flight_path, rec, self.max_records)

    def stats(self) -> dict:
        with self._lock:
            lat_n = len(self._lat)
            captured = dict(self.captured)
        thr = self.threshold_us()
        return {"sample": self.sample,
                "latency_factor": self.latency_factor,
                "slow_threshold_us": round(thr, 1) if thr else None,
                "window_fill": lat_n,
                "captured": captured}


# ----------------------------------------------------- flight writer

class _FlightWriter:
    """Background disk writer for flight-recorder captures: handler
    threads enqueue records; ONE daemon thread drains the queue,
    coalescing everything pending for the same file into one atomic
    rewrite (``sinks.append_jsonl_atomic``).  A full queue drops the
    record (counted) — durability is best-effort, the serving path is
    not."""

    def __init__(self, capacity: int = 256):
        self._q: _queue_mod.Queue = _queue_mod.Queue(maxsize=capacity)
        self._started = False
        self._lock = threading.Lock()
        self.written = 0
        self.dropped = 0
        self._warned = False

    def push(self, path: str, rec: dict, max_lines: int) -> None:
        with self._lock:
            if not self._started:
                self._started = True
                threading.Thread(target=self._loop, daemon=True,
                                 name="ptpu-flight-write").start()
        try:
            self._q.put_nowait((path, rec, max_lines))
        except _queue_mod.Full:
            self.dropped += 1

    def drain(self, timeout_s: float = 10.0) -> None:
        """Block until everything enqueued so far has been written
        (tests; close paths)."""
        t0 = time.monotonic()
        while not self._q.empty():
            if time.monotonic() - t0 > timeout_s:
                return
            time.sleep(0.01)
        time.sleep(0.02)              # let the in-flight write land

    def _loop(self) -> None:
        from paddle_tpu_torch.observability import sinks

        while True:
            path, rec, max_lines = self._q.get()
            batch = [rec]
            # coalesce everything queued for the SAME file into one
            # read-rewrite cycle; a different file goes back
            while True:
                try:
                    p2, r2, m2 = self._q.get_nowait()
                except _queue_mod.Empty:
                    break
                if p2 == path:
                    batch.append(r2)
                    max_lines = min(max_lines, m2)
                else:
                    try:
                        self._q.put_nowait((p2, r2, m2))
                    except _queue_mod.Full:
                        self.dropped += 1
                    break
            try:
                sinks.append_jsonl_atomic(path, batch,
                                          max_lines=max_lines)
                self.written += len(batch)
            except Exception as e:        # noqa: BLE001 — never fatal
                # a full disk must not fail the requests being
                # recorded; warn once, keep draining (the in-memory
                # store still works)
                self.dropped += len(batch)
                if not self._warned:
                    self._warned = True
                    import warnings

                    warnings.warn(f"flight recorder flush to {path} "
                                  f"failing: {e!r}")


FLIGHT_WRITER = _FlightWriter()


# ------------------------------------------------------------- span push

class _TracePusher:
    """Fire-and-forget span delivery from a CLIENT process to a
    serving endpoint's ``POST /trace`` collector, off the caller's
    latency path (a daemon thread drains a small queue; full queue or
    dead endpoint drops the push — tracing must never add a failure
    mode to the request path).  Consecutive pushes to the same
    collector coalesce into one POST, and a collector that fails is
    backed off for ``backoff_s`` (drops counted, no network touched):
    a dead or misconfigured collector must not burn a DNS/connect
    stall per sampled request."""

    def __init__(self, capacity: int = 256, backoff_s: float = 5.0):
        self._q: _queue_mod.Queue = _queue_mod.Queue(maxsize=capacity)
        self._started = False
        self._lock = threading.Lock()
        self.backoff_s = float(backoff_s)
        self._dead_until: Dict[str, float] = {}
        self.pushed = 0
        self.dropped = 0

    def push(self, url: str, spans: List[dict]) -> None:
        with self._lock:
            if not self._started:
                self._started = True
                threading.Thread(target=self._loop, daemon=True,
                                 name="ptpu-trace-push").start()
        try:
            self._q.put_nowait((url, spans))
        except _queue_mod.Full:
            self.dropped += 1

    def _loop(self) -> None:
        import urllib.request

        while True:
            url, spans = self._q.get()
            batch = list(spans)
            # coalesce everything already queued for the SAME url
            # into one POST; other urls go back on the queue
            while True:
                try:
                    u2, s2 = self._q.get_nowait()
                except _queue_mod.Empty:
                    break
                if u2 == url:
                    batch.extend(s2)
                else:
                    try:
                        self._q.put_nowait((u2, s2))
                    except _queue_mod.Full:
                        self.dropped += 1
                    break
            if self._dead_until.get(url, 0.0) > time.monotonic():
                self.dropped += 1
                continue
            body = json.dumps({"spans": batch}).encode()
            req = urllib.request.Request(
                url.rstrip("/") + "/trace", data=body,
                headers={"Content-Type": "application/json"},
                method="POST")
            try:
                with urllib.request.urlopen(req, timeout=5.0) as resp:
                    resp.read()
                self.pushed += 1
                self._dead_until.pop(url, None)
            except Exception:             # noqa: BLE001 — best effort
                self.dropped += 1
                self._dead_until[url] = (time.monotonic()
                                         + self.backoff_s)


PUSHER = _TracePusher()


def push_spans(url: str, spans: List[dict]) -> None:
    PUSHER.push(url, spans)


# ------------------------------------------------------- HTTP surface

def _trace_id_from(rest: str) -> str:
    """The trace id out of a ``/trace/`` subpath or a ``?id=`` query
    string (both mounts route here)."""
    rest = (rest or "").strip().strip("/")
    if "=" in rest:
        for part in rest.split("&"):
            k, _, v = part.partition("=")
            if k == "id":
                return v.strip()
        return ""
    return rest


def http_trace_handler(method: str, body: bytes, headers=None,
                       rest: str = ""):
    """The per-process ``/trace`` surface every serving process mounts
    (``sinks.serve_metrics extra_handlers``): GET ``/trace/<id>`` (or
    ``/trace?id=<id>``) answers this process's spans for one trace,
    bare GET ``/trace`` the most recent trace ids, and POST ``/trace``
    ingests pushed spans (how a ServingClient's spans reach the fleet
    — the router's assembly then sees all three roles)."""
    if method == "POST":
        try:
            doc = json.loads(body or b"{}")
            if not isinstance(doc, dict):
                raise ValueError("body must be a JSON object")
            spans = doc.get("spans")
            if not (isinstance(spans, list) and spans and all(
                    isinstance(s, dict) and s.get("trace_id")
                    and s.get("span_id") and s.get("name")
                    and isinstance(s.get("start_us"), (int, float))
                    for s in spans)):
                raise ValueError(
                    "'spans' must be a non-empty list of span objects "
                    "with trace_id/span_id/name/start_us")
        except (ValueError, UnicodeDecodeError) as e:
            return (400, "application/json",
                    json.dumps({"error": f"bad ingest: {e}"}).encode())
        # bounded ingest: an abusive pusher cannot flush the store
        STORE.publish(spans[:256])
        return (200, "application/json",
                json.dumps({"ok": True,
                            "accepted": min(len(spans), 256)}).encode())
    tid = _trace_id_from(rest)
    if not tid:
        return (200, "application/json",
                json.dumps({"traces": STORE.recent_ids(),
                            **process_info()}).encode())
    return (200, "application/json",
            json.dumps({"trace_id": tid, "spans": STORE.get(tid),
                        **process_info()}).encode())


# ------------------------------------------------------------ assembly

def spans_to_chrome(spans: List[dict]) -> dict:
    """Chrome trace-event JSON of an assembled cross-process span set
    (the PR 2 export format — opens in Perfetto next to the per-process
    host traces): one pid per fleet role/process, epoch-µs timeline."""
    evs = []
    pids: Dict[tuple, int] = {}
    for s in spans:
        who = (s.get("role", "?"), s.get("pid", 0), s.get("port", 0))
        if who not in pids:
            pid = len(pids) + 1
            pids[who] = pid
            evs.append({"ph": "M", "pid": pid, "tid": 0,
                        "name": "process_name",
                        "args": {"name": f"{who[0]} pid={who[1]}"
                                         f" port={who[2]}"}})
        args = dict(s.get("args") or {})
        args["span_id"] = s.get("span_id")
        args["parent_id"] = s.get("parent_id")
        evs.append({"name": s.get("name", "?"), "cat": "trace",
                    "ph": "X", "pid": pids[who], "tid": 0,
                    "ts": s.get("start_us", 0),
                    "dur": s.get("dur_us", 0), "args": args})
    return {"traceEvents": evs, "displayTimeUnit": "ms"}


def render_tree(spans: List[dict]) -> str:
    """Human tree of an assembled trace: spans indented under their
    parents, ordered by start time, annotated with role/pid/port —
    what ``python -m paddle_tpu_torch trace --request <id>`` prints."""
    if not spans:
        return "(no spans)"
    by_id = {s["span_id"]: s for s in spans}
    children: Dict[str, List[dict]] = {}
    roots: List[dict] = []
    for s in spans:
        parent = s.get("parent_id") or ""
        if parent in by_id:
            children.setdefault(parent, []).append(s)
        else:
            roots.append(s)
    t0 = min(s.get("start_us", 0) for s in spans)
    total = max(s.get("start_us", 0) + s.get("dur_us", 0)
                for s in spans) - t0
    lines = [f"trace {spans[0].get('trace_id', '?')}  "
             f"{len(spans)} span(s)  wall {total / 1e3:.2f} ms"]

    def emit(s: dict, depth: int) -> None:
        args = dict(s.get("args") or {})
        outcome = args.pop("outcome", None)
        extra = " ".join(f"{k}={v}" for k, v in sorted(args.items()))
        lines.append(
            f"  {'  ' * depth}{s.get('name', '?'):<{max(2, 28 - 2 * depth)}} "
            f"+{(s.get('start_us', 0) - t0) / 1e3:8.2f} ms "
            f"{s.get('dur_us', 0) / 1e3:9.2f} ms  "
            f"[{s.get('role', '?')} pid={s.get('pid', 0)}"
            f" port={s.get('port', 0)}]"
            + (f"  {outcome}" if outcome else "")
            + (f"  {extra}" if extra else ""))
        for c in sorted(children.get(s["span_id"], ()),
                        key=lambda x: x.get("start_us", 0)):
            emit(c, depth + 1)

    for r in sorted(roots, key=lambda x: x.get("start_us", 0)):
        emit(r, 0)
    return "\n".join(lines)
