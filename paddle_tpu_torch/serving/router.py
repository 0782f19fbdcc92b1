"""Serving-fleet router: one HTTP front over N replica engines
(counterpart of ``paddle_tpu/serving/router.py``).

  * **Health-aware balancing**: a background poller reads each replica's
    ``/healthz`` and ``/stats`` every ``poll_interval_s``; ``/infer`` picks
    a replica by power-of-two-choices over the polled ``queue_depth`` plus
    the router's own forwards since that poll.
  * **Staleness eviction**: a replica whose last good poll is older than
    ``staleness_s`` leaves rotation (a frozen ``snapshot_seq`` with work
    queued is a wedged replica: its freshness is withheld); a 503
    ``/healthz`` leaves at once and is polled every tick; a dead socket
    marks the replica down and re-probes it on an exponential backoff.
  * **Failover**: a forward that dies at the socket (refused, reset, cut
    mid-response, timed out) marks the replica down and retries the same
    request on another one within the caller's deadline (inference is
    stateless); with none left the router answers a typed, retryable 503
    (``reason="no_replica"``).
  * **Pass-through**: tenant, lane and deadline ride end to end (the
    ``X-Ptpu-*`` headers and the JSON body are forwarded as they are), and
    a replica's 429 with ``Retry-After`` comes back unchanged.
  * **Global tenant quotas**: the engine's per-tenant quota is per
    process; the router counts each tenant's admitted requests in flight
    fleet-wide and sheds past ``tenant_quota`` with a 429
    (``reason="tenant_quota_global"``) before a replica sees the request,
    reading the tenant with the engine's precedence (body, then header).

Replicas register on start (``POST /register``, the ``serve
--router_url`` flag) and deregister on drain (``POST /deregister``).
``stats()`` keeps plain counters beside the JAX router's ``router_*``
metrics (``router_replicas_up``, ``router_picks_total{policy}``,
``router_failovers_total``, ``router_shed_total{reason}``,
``router_tenant_depth{tenant}``).  ``serve`` mounts the surface on
``observability.sinks.serve_metrics``, with the fleet's observability:
``/trace/<id>`` assembles one request's timeline from the router's own
spans (``trace_sample=``, ``telemetry_dir=``: a ``router/infer`` span
and one ``router/forward`` span a forward, whose id the replica's spans
parent under), the spans a client pushed (``POST /trace``) and every
replica's ``/trace/<id>``; ``/metrics?fleet=1`` merges every replica's
``/metrics.json`` with the router's registry, each row labelled
``replica``.

    from paddle_tpu_torch.serving import Router
    router = Router(["http://127.0.0.1:8081", "http://127.0.0.1:8082"],
                    tenant_quota=32)
    server = router.serve(8080)
    ...
    router.close()
"""

from __future__ import annotations

import http.client
import json
import math
import random
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from typing import Dict, List, Optional, Sequence

from paddle_tpu_torch.observability import metrics as _metrics
from paddle_tpu_torch.observability import tracectx as _tracectx
from paddle_tpu_torch.utils import lockcheck as _lockcheck

__all__ = ["Router", "PICK_POLICIES", "ROUTER_SHED_REASONS"]

#: how a pick chose its replica: between two sampled candidates, the only
#: eligible one, or again after a dead-socket forward
PICK_POLICIES = ("p2c", "single", "failover")
#: router-side shed reasons (a router shed never reached a replica)
ROUTER_SHED_REASONS = ("tenant_quota_global", "no_replica")
DEFAULT_TENANT = "default"

_G_UP = _metrics.gauge(
    "router_replicas_up",
    "replicas currently in rotation (healthy and fresh)")
_C_PICKS = {p: _metrics.counter(
    "router_picks_total",
    "replica picks by the /infer balancer, by policy",
    policy=p) for p in PICK_POLICIES}
_C_FAILOVERS = _metrics.counter(
    "router_failovers_total",
    "forwards retried on another replica after a dead socket")
_C_SHED = {reason: _metrics.counter(
    "router_shed_total",
    "requests shed at the router, by reason",
    reason=reason) for reason in ROUTER_SHED_REASONS}


def _tenant_depth_gauge(tenant: str):
    return _metrics.gauge(
        "router_tenant_depth",
        "per-tenant requests admitted by the router and not yet "
        "answered — the GLOBAL quota gate's fleet-wide counter",
        tenant=tenant)


# request headers forwarded to the replica as they are (the body passes
# through untouched, so its tenant, lane and deadline fields ride too);
# x-ptpu-trace passes through so a client-minted trace id reaches the
# replica with the router's tracing off (on, the router rewrites it to
# parent the replica under its forward span)
_FWD_HEADERS = ("content-type", "x-ptpu-lane", "x-ptpu-tenant",
                "x-ptpu-deadline-ms", "x-ptpu-trace")


class _UpstreamDead(Exception):
    """A forward died at the socket; the replica is marked down and the
    request fails over (the original exception is the ``__cause__``)."""


class _Replica:
    """One replica's polled state; every field but ``url`` mutates under
    the router's lock."""

    __slots__ = ("url", "up", "state", "depth", "inflight", "since_poll",
                 "snapshot_seq", "uptime_s", "last_ok", "fails",
                 "next_probe", "forwards", "probing", "model_version")

    def __init__(self, url: str):
        self.url = url
        self.up = False
        self.state = "new"       # ok | unhealthy | wedged | dead | new
        self.depth = 0           # last polled queue_depth
        self.inflight = 0        # the router's forwards in flight
        self.since_poll = 0      # forwards since that poll
        self.snapshot_seq = -1
        self.uptime_s = 0.0
        self.model_version = ""
        self.last_ok = 0.0       # perf_counter of the last fresh poll
        self.fails = 0           # consecutive dead-socket failures
        self.next_probe = 0.0    # a down replica re-probes after this
        self.forwards = 0        # requests it answered
        self.probing = False     # a probe thread is in flight


class _GTenant:
    """One tenant's fleet-wide admission state."""

    __slots__ = ("name", "depth", "shedding", "admitted", "shed", "gauge")

    def __init__(self, name: str):
        self.name = name
        self.depth = 0
        self.shedding = False
        self.admitted = 0
        self.shed = 0
        self.gauge = _tenant_depth_gauge(name)


class Router:
    """Health-aware ``/infer`` front over replica engines (module
    docstring).  Give it base URLs (``http://127.0.0.1:8081``) or let
    replicas register; ``serve(port)`` mounts the HTTP surface,
    ``close()`` stops the poller and the server.  A context manager."""

    def __init__(self, replicas: Sequence[str] = (), *,
                 poll_interval_s: float = 0.05,
                 staleness_s: float = 0.5,
                 probe_backoff_s: float = 0.2,
                 probe_backoff_cap_s: float = 2.0,
                 poll_timeout_s: float = 1.0,
                 forward_timeout_s: float = 30.0,
                 tenant_quota: int = 0,
                 hysteresis: float = 0.25,
                 max_tenants: int = 256,
                 trace_sample: Optional[float] = None,
                 telemetry_dir: Optional[str] = None,
                 rng: Optional[random.Random] = None):
        if poll_interval_s <= 0 or staleness_s <= 0:
            raise ValueError("poll_interval_s and staleness_s must be > 0")
        if staleness_s < poll_interval_s:
            raise ValueError(
                f"staleness_s ({staleness_s}) must cover at least one poll "
                f"interval ({poll_interval_s})")
        if tenant_quota < 0:
            raise ValueError(f"tenant_quota must be >= 0 (0 = unbounded), "
                             f"got {tenant_quota}")
        if not 0.0 <= hysteresis < 1.0:
            raise ValueError(f"hysteresis must be in [0, 1), got "
                             f"{hysteresis}")
        self.poll_interval_s = float(poll_interval_s)
        self.staleness_s = float(staleness_s)
        self.probe_backoff_s = float(probe_backoff_s)
        self.probe_backoff_cap_s = float(probe_backoff_cap_s)
        self.poll_timeout_s = float(poll_timeout_s)
        self.forward_timeout_s = float(forward_timeout_s)
        self.tenant_quota = int(tenant_quota)
        self.hysteresis = float(hysteresis)
        self._tenant_resume = int(self.tenant_quota * (1.0 - hysteresis))
        self.max_tenants = max(1, int(max_tenants))
        self._rng = rng or random.Random()
        # ONE lock for the replica map and records, the tenants, the
        # counters and the rate estimate; no socket is touched under it
        self._lock = _lockcheck.make_lock("serving.router")
        # the router is a tracing edge: it honours an upstream
        # X-Ptpu-Trace (or mints one), records its own spans and
        # parents each forward's replica spans under them
        self._flight = _tracectx.make_recorder(trace_sample, telemetry_dir)
        self._replicas: Dict[str, _Replica] = {}
        self._tenants: Dict[str, _GTenant] = {
            DEFAULT_TENANT: _GTenant(DEFAULT_TENANT)}
        self._done_log: deque = deque(maxlen=256)
        self._rps = 0.0
        self.session = {"forwarded": 0, "failovers": 0,
                        "tenant_overflow": 0,
                        "picks": {p: 0 for p in PICK_POLICIES},
                        "shed": {r: 0 for r in ROUTER_SHED_REASONS}}
        self._server = None
        self._closed = False
        self._bound_port = 0
        for url in replicas:
            self.add_replica(url)
        self._stop = threading.Event()
        self._poller = threading.Thread(target=self._poll_loop, daemon=True,
                                        name="ptt-router-poll")
        self._poller.start()

    # -------------------------------------------------------- membership
    def add_replica(self, url: str, probe: bool = True) -> bool:
        """Add (or re-arm) a replica; probed inline, so a healthy new one
        is eligible before the next tick.  True when the entry is new."""
        url = str(url).rstrip("/")
        with self._lock:
            new = url not in self._replicas
            if new:
                self._replicas[url] = _Replica(url)
            else:
                self._replicas[url].next_probe = 0.0
            rep = self._replicas[url]
        if probe:
            self._probe(rep)
        return new

    def remove_replica(self, url: str) -> bool:
        """Drop a replica from rotation (deregistration on drain); its
        forwards in flight complete."""
        url = str(url).rstrip("/")
        with self._lock:
            return self._replicas.pop(url, None) is not None

    def replica_urls(self) -> List[str]:
        with self._lock:
            return sorted(self._replicas)

    def replicas_up(self) -> int:
        """Replicas in rotation: up and fresh."""
        now = time.perf_counter()
        stale = self.staleness_s
        with self._lock:
            return sum(1 for r in self._replicas.values()
                       if r.up and now - r.last_ok <= stale)

    # ----------------------------------------------------------- polling
    def _poll_loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            self._poll_once()

    def _poll_once(self) -> None:
        now = time.perf_counter()
        with self._lock:
            # probes run concurrently, one thread each and at most one a
            # replica: a blackholed replica's timeouts must not age the
            # healthy ones out of rotation
            due = []
            for rep in self._replicas.values():
                if (rep.up or now >= rep.next_probe) and not rep.probing:
                    rep.probing = True
                    due.append(rep)
        for rep in due:
            threading.Thread(target=self._probe_async, args=(rep,),
                             daemon=True, name="ptt-router-probe").start()
        _G_UP.set(self.replicas_up())

    def _probe_async(self, rep: _Replica) -> None:
        try:
            self._probe(rep)
        finally:
            with self._lock:
                rep.probing = False

    def _poll_replica(self, base: str):
        """One poll round trip, no lock held: ``(ok, healthy, depth, seq,
        uptime, model_version)``; ``ok`` False is a dead socket."""
        try:
            req = urllib.request.Request(base + "/healthz", method="GET")
            try:
                with urllib.request.urlopen(
                        req, timeout=self.poll_timeout_s) as resp:
                    healthy = resp.status == 200
                    resp.read()
            except urllib.error.HTTPError as e:
                with e:
                    healthy = False           # 503 overloaded|closed|dead
                    e.read()
            req = urllib.request.Request(base + "/stats", method="GET")
            with urllib.request.urlopen(
                    req, timeout=self.poll_timeout_s) as resp:
                doc = json.loads(resp.read().decode())
            return (True, healthy, int(doc.get("queue_depth", 0)),
                    doc.get("snapshot_seq"),
                    float(doc.get("uptime_s", 0.0)),
                    str(doc.get("model_version") or ""))
        except (urllib.error.URLError, http.client.HTTPException, OSError,
                ValueError):
            return False, False, 0, None, 0.0, ""

    def _probe_backoff(self, fails: int) -> float:
        """The re-probe delay after ``fails`` consecutive dead-socket
        failures, shared by the probe and the forward paths."""
        return min(self.probe_backoff_cap_s,
                   self.probe_backoff_s * (2.0 ** min(fails - 1, 6)))

    def _probe(self, rep: _Replica) -> None:
        ok, healthy, depth, seq, uptime, mv = self._poll_replica(rep.url)
        now = time.perf_counter()
        with self._lock:
            if not ok:
                rep.up = False
                rep.state = "dead"
                rep.fails += 1
                rep.next_probe = now + self._probe_backoff(rep.fails)
                return
            # progress frozen since the last poll while work is queued: a
            # wedged replica (its HTTP thread answers, its engine resolves
            # nothing) keeps no freshness and ages out at staleness_s; an
            # idle one (frozen, empty queue) is healthy
            wedged = (seq is not None and seq == rep.snapshot_seq
                      and depth > 0 and rep.state in ("ok", "wedged"))
            rep.depth = depth
            rep.since_poll = 0
            rep.snapshot_seq = seq if seq is not None else -1
            rep.uptime_s = uptime
            rep.model_version = mv
            rep.fails = 0
            if not healthy:
                rep.up = False
                rep.state = "unhealthy"
                rep.last_ok = now
            elif wedged:
                rep.state = "wedged"
            else:
                rep.up = True
                rep.state = "ok"
                rep.last_ok = now

    # ----------------------------------------------------------- tenants
    @staticmethod
    def _retry_after_est(depth: int, rps: float) -> float:
        est = depth / rps if rps > 0 else 1.0
        return round(min(30.0, max(0.05, est)), 3)

    def _count_shed(self, reason: str) -> None:
        with self._lock:
            self.session["shed"][reason] += 1
        _C_SHED[reason].inc()

    @staticmethod
    def _peek(body: bytes, headers) -> tuple:
        """(tenant, deadline_ms) with the engine's precedence: the JSON
        body's field, then the ``X-Ptpu-*`` header (a hog pinning its body
        tenant while rotating header tenants must not split its
        accounting between the two tiers)."""
        h_tenant = h_dl = None
        if headers is not None:
            h_tenant = headers.get("X-Ptpu-Tenant")
            h_dl = headers.get("X-Ptpu-Deadline-Ms")
        tenant, deadline_ms = None, h_dl
        try:
            doc = json.loads(body or b"{}")
        except (ValueError, UnicodeDecodeError):
            doc = None
        if isinstance(doc, dict):
            tenant = doc.get("tenant")
            deadline_ms = doc.get("deadline_ms", h_dl)
        tenant = tenant or h_tenant
        try:
            deadline_ms = (float(deadline_ms) if deadline_ms is not None
                           else None)
        except (TypeError, ValueError):
            deadline_ms = None
        return (str(tenant) if tenant else DEFAULT_TENANT), deadline_ms

    # ------------------------------------------------------------ picking
    def _pick(self, exclude: set):
        """``(replica, policy)`` with an in-flight slot reserved on it, or
        ``(None, None)``.  The score is the polled depth plus the
        router's forwards since that poll."""
        now = time.perf_counter()
        stale = self.staleness_s
        with self._lock:
            up = [r for r in self._replicas.values()
                  if r.url not in exclude and r.up
                  and now - r.last_ok <= stale]
            if not up:
                return None, None
            if len(up) == 1:
                rep = up[0]
                policy = "failover" if exclude else "single"
            else:
                a, b = self._rng.sample(up, 2)
                rep = (a if a.depth + a.since_poll <= b.depth + b.since_poll
                       else b)
                policy = "failover" if exclude else "p2c"
            rep.inflight += 1
            rep.since_poll += 1
            self.session["picks"][policy] += 1
        _C_PICKS[policy].inc()
        return rep, policy

    def _finish(self, rep: _Replica, ok: bool) -> None:
        now = time.perf_counter()
        with self._lock:
            rep.inflight -= 1
            if ok:
                rep.forwards += 1
                self.session["forwarded"] += 1
                log = self._done_log
                log.append(now)
                span = now - log[0]
                if span > 0 and len(log) > 1:
                    self._rps = (len(log) - 1) / span

    # --------------------------------------------------------- forwarding
    def _forward(self, base: str, body: bytes, headers: Dict[str, str],
                 timeout_s: float):
        """One POST to a replica's ``/infer``: ``(status, headers,
        payload)``; ``_UpstreamDead`` on a connection-level failure."""
        req = urllib.request.Request(base + "/infer", data=body,
                                     headers=headers, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                return resp.status, dict(resp.headers.items()), resp.read()
        except urllib.error.HTTPError as e:
            try:
                with e:
                    return e.code, dict(e.headers.items()), e.read()
            except (OSError, http.client.HTTPException) as e2:
                raise _UpstreamDead(f"replica {base} died reading an error "
                                    f"body: {e2!r}") from e2
        except urllib.error.URLError as e:
            raise _UpstreamDead(f"connection to replica {base} failed: "
                                f"{e.reason}") from e
        except (OSError, http.client.HTTPException) as e:
            raise _UpstreamDead(f"transport to replica {base} failed: "
                                f"{e!r}") from e

    @staticmethod
    def _shed_response(reason: str, retry_after_s: float,
                       status: int = 429):
        retry = max(1, int(math.ceil(retry_after_s)))
        return (status, "application/json",
                json.dumps({"error": "overloaded", "reason": reason,
                            "retry_after_s": retry_after_s}).encode(),
                {"Retry-After": str(retry)})

    def handle_infer(self, method: str, body: bytes, headers=None):
        """``/infer``: the global tenant gate, a pick, the forward with
        dead-socket failover, the answer passed through."""
        if method != "POST":
            return 405, "text/plain", b"POST a JSON body\n"
        tenant, deadline_ms = self._peek(body, headers)
        fl = self._flight
        trace = None
        if fl is not None:
            ctx = _tracectx.TraceContext.parse(
                headers.get(_tracectx.HEADER) if headers is not None
                else None)
            if ctx is None:
                # untagged traffic: the router is its tracing edge
                ctx = _tracectx.mint(fl.sample)
            trace = _tracectx.SpanBuffer(ctx, "router/infer", role="router",
                                         port=self._bound_port,
                                         tenant=tenant)
            t_req0 = time.perf_counter()
        retry = 1.0
        shed = False
        with self._lock:
            ts = self._tenants.get(tenant)
            if ts is None:
                # untrusted ids: past max_tenants they collapse onto the
                # default record, as in the engine
                if len(self._tenants) >= self.max_tenants:
                    self.session["tenant_overflow"] += 1
                    ts = self._tenants[DEFAULT_TENANT]
                else:
                    ts = self._tenants[tenant] = _GTenant(tenant)
            if self.tenant_quota:
                if ts.shedding:
                    if ts.depth <= self._tenant_resume:
                        ts.shedding = False
                elif ts.depth >= self.tenant_quota:
                    ts.shedding = True
                if ts.shedding:
                    ts.shed += 1
                    retry = self._retry_after_est(ts.depth, self._rps)
                    shed = True
            if not shed:
                ts.depth += 1
                ts.admitted += 1
                depth_now = ts.depth
        if shed:
            self._count_shed("tenant_quota_global")
            if fl is not None:
                trace.event("router/shed", reason="tenant_quota_global")
                fl.finish(trace, "shed", reason="tenant_quota_global")
            return self._shed_response("tenant_quota_global", retry)
        ts.gauge.set(depth_now)
        try:
            res = self._route(body, headers, deadline_ms, trace)
        except Exception as e:                # noqa: BLE001 - answer 500
            # a routing fault is what the flight recorder is for: the
            # trace finishes as an error before the 500
            if fl is not None:
                fl.finish(trace, "error", error=repr(e))
            return (500, "application/json",
                    json.dumps({"error": repr(e)}).encode())
        finally:
            with self._lock:
                ts.depth -= 1
                depth_now = ts.depth
            ts.gauge.set(depth_now)
        if fl is not None:
            status = res[0]
            outcome = ("ok" if status == 200
                       else "shed" if status in (429, 503)
                       else "deadline" if status == 504 else "error")
            fl.finish(trace, outcome, status=status, latency_us=round(
                (time.perf_counter() - t_req0) * 1e6, 1))
        return res

    def _route(self, body: bytes, headers, deadline_ms, trace=None):
        fwd_headers = {"Content-Type": "application/json"}
        if headers is not None:
            for k, v in headers.items():
                if k.lower() in _FWD_HEADERS:
                    fwd_headers[k] = v
        deadline = (time.perf_counter() + deadline_ms / 1e3
                    if deadline_ms and deadline_ms > 0 else None)
        tried: set = set()
        doc = False                           # the body, parsed lazily
        while True:
            rep, _ = self._pick(tried)
            if rep is None:
                with self._lock:
                    retry = self._retry_after_est(1, self._rps)
                self._count_shed("no_replica")
                if trace is not None:
                    trace.event("router/shed", reason="no_replica")
                # retryable: the fleet may be mid-restart
                return self._shed_response("no_replica", retry, status=503)
            timeout = self.forward_timeout_s
            if deadline is not None:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    self._finish(rep, ok=False)
                    return (504, "application/json", json.dumps(
                        {"error": "router deadline exceeded before a "
                                  "replica answered"}).encode())
                timeout = min(timeout, remaining)
                if tried:
                    # failover: advertise the shrunk budget (the body's
                    # field wins in the engine, so both are rewritten)
                    rem_ms = round(remaining * 1e3, 3)
                    if doc is False:
                        try:
                            parsed = json.loads(body or b"{}")
                            doc = parsed if isinstance(parsed, dict) else None
                        except (ValueError, UnicodeDecodeError):
                            doc = None
                    if doc is not None and "deadline_ms" in doc:
                        doc["deadline_ms"] = rem_ms
                        body = json.dumps(doc).encode()
                    for k in list(fwd_headers):
                        if k.lower() == "x-ptpu-deadline-ms":
                            fwd_headers[k] = str(rem_ms)
            if trace is not None:
                # the forward span's id rides the wire, so the replica's
                # spans parent under this forward
                fwd_id = _tracectx.new_span_id()
                fwd_headers[_tracectx.HEADER] = \
                    trace.ctx.child(fwd_id).to_header()
                t_fwd0 = time.perf_counter_ns()
            try:
                status, rheaders, payload = self._forward(
                    rep.url, body, fwd_headers, timeout)
            except _UpstreamDead:
                now = time.perf_counter()
                with self._lock:
                    rep.inflight -= 1
                    rep.up = False
                    rep.state = "dead"
                    rep.fails += 1
                    rep.next_probe = now + self._probe_backoff(rep.fails)
                    self.session["failovers"] += 1
                _C_FAILOVERS.inc()
                if trace is not None:
                    trace.add_span("router/forward", t_fwd0,
                                   time.perf_counter_ns() - t_fwd0,
                                   span_id=fwd_id, replica=rep.url,
                                   status="dead_socket")
                    trace.event("router/failover", replica=rep.url)
                tried.add(rep.url)
                continue
            if trace is not None:
                trace.add_span("router/forward", t_fwd0,
                               time.perf_counter_ns() - t_fwd0,
                               span_id=fwd_id, replica=rep.url,
                               status=status)
            self._finish(rep, ok=status == 200)
            retry = next((v for k, v in rheaders.items()
                          if k.lower() == "retry-after"), None)
            ctype = rheaders.get("Content-Type") or "application/json"
            return (status, ctype, payload,
                    {"Retry-After": retry} if retry is not None else None)

    # --------------------------------------------------------------- http
    def handle_register(self, method: str, body: bytes, headers=None):
        if method != "POST":
            return 405, "text/plain", b"POST {\"url\": ...}\n"
        try:
            url = json.loads(body or b"{}")["url"]
            if not isinstance(url, str) or not url.startswith("http"):
                raise ValueError(f"bad replica url {url!r}")
        except (ValueError, KeyError, TypeError, UnicodeDecodeError) as e:
            return (400, "application/json",
                    json.dumps({"error": f"bad request: {e}"}).encode())
        new = self.add_replica(url)
        return (200, "application/json", json.dumps(
            {"ok": True, "new": new,
             "replicas": self.replica_urls()}).encode())

    def handle_deregister(self, method: str, body: bytes, headers=None):
        if method != "POST":
            return 405, "text/plain", b"POST {\"url\": ...}\n"
        try:
            url = json.loads(body or b"{}")["url"]
        except (ValueError, KeyError, TypeError, UnicodeDecodeError) as e:
            return (400, "application/json",
                    json.dumps({"error": f"bad request: {e}"}).encode())
        removed = self.remove_replica(url)
        return (200, "application/json", json.dumps(
            {"ok": True, "removed": removed,
             "replicas": self.replica_urls()}).encode())

    def _fetch_json(self, url: str, timeout_s: Optional[float] = None):
        """One GET decoded as JSON, or None on any failure (no lock
        held: a dead replica never stalls a handler)."""
        req = urllib.request.Request(url, method="GET")
        try:
            with urllib.request.urlopen(
                    req, timeout=timeout_s or self.poll_timeout_s) as r:
                return json.loads(r.read().decode())
        except (urllib.error.URLError, http.client.HTTPException,
                OSError, ValueError):
            return None

    def _fetch_json_many(self, urls, suffix: str) -> Dict[str, object]:
        """``_fetch_json(url + suffix)`` across replicas concurrently (a
        daemon thread each), so a scrape or a trace assembly costs about
        one poll timeout, not one a replica; a straggler past the join
        budget reads as down (None)."""
        results: Dict[str, object] = {u: None for u in urls}

        def one(u: str) -> None:
            results[u] = self._fetch_json(u + suffix)

        threads = [threading.Thread(target=one, args=(u,), daemon=True,
                                    name="ptt-router-fanout")
                   for u in urls]
        for t in threads:
            t.start()
        deadline = time.perf_counter() + self.poll_timeout_s + 0.5
        for t in threads:
            t.join(max(0.0, deadline - time.perf_counter()))
        return dict(results)

    def handle_trace(self, method: str, body: bytes, headers=None,
                     rest: str = ""):
        """``GET /trace/<id>``: one request's cross-process timeline, the
        router's own spans (and those a client pushed to ``POST /trace``)
        merged with every registered replica's ``/trace/<id>`` answer,
        deduplicated by span id, in start order.  POST ingests pushed
        spans; a bare GET lists this process's recent trace ids."""
        tid = _tracectx._trace_id_from(rest)
        if method == "POST" and self._flight is None:
            # no tracing means no span-ingest surface, not an open one
            return (404, "text/plain",
                    b"tracing is disabled on this router\n")
        if method == "POST" or not tid:
            return _tracectx.http_trace_handler(method, body, headers,
                                                rest)
        spans = {s["span_id"]: s for s in _tracectx.STORE.get(tid)}
        sources: Dict[str, Optional[int]] = {"router": len(spans)}
        fetched = self._fetch_json_many(self.replica_urls(),
                                        "/trace/" + tid)
        for url, doc in sorted(fetched.items()):
            got = (doc or {}).get("spans") if doc else None
            if not isinstance(got, list):
                sources[url] = None       # unreachable or a bad answer
                continue
            n = 0
            for sp in got:
                if isinstance(sp, dict) and sp.get("span_id"):
                    spans.setdefault(sp["span_id"], sp)
                    n += 1
            sources[url] = n
        ordered = sorted(spans.values(), key=lambda sp: sp.get("start_us", 0))
        return (200, "application/json",
                json.dumps({"trace_id": tid, "spans": ordered,
                            "sources": sources}).encode())

    def handle_metrics(self, method: str, body: bytes, headers=None,
                       query: str = ""):
        """``GET /metrics?fleet=1``: one scrape for the fleet, every
        registered replica's ``/metrics.json`` merged with the router's
        registry, each row labelled with its ``replica`` (its base URL;
        ``"router"`` for the router's own).  Without ``fleet=1``: the
        router's own exposition."""
        from paddle_tpu_torch.observability import sinks
        if method != "GET":
            return 405, "text/plain", b"GET /metrics[?fleet=1]\n"
        ctype = "text/plain; version=0.0.4; charset=utf-8"
        if "fleet=1" not in (query or ""):
            return 200, ctype, sinks.prometheus_text().encode()
        merged = {"counters": [], "gauges": [], "histograms": []}

        def absorb(snap: dict, label: str) -> None:
            for sect in ("counters", "gauges", "histograms"):
                for m in snap.get(sect, ()):
                    m = dict(m)
                    labels = dict(m.get("labels") or {})
                    labels["replica"] = label
                    m["labels"] = labels
                    merged[sect].append(m)

        absorb(_metrics.REGISTRY.snapshot(), "router")
        polled = unreachable = 0
        fetched = self._fetch_json_many(self.replica_urls(),
                                        "/metrics.json")
        for url, snap in sorted(fetched.items()):
            if not isinstance(snap, dict):
                unreachable += 1
                continue
            absorb(snap, url)
            polled += 1
        text = _metrics.prometheus_from_snapshot(merged)
        text += (f"# fleet rollup: {polled} replica(s) polled, "
                 f"{unreachable} unreachable\n")
        return 200, ctype, text.encode()

    def stats(self) -> dict:
        now = time.perf_counter()
        stale = self.staleness_s
        with self._lock:
            replicas = {
                rep.url: {"up": rep.up and now - rep.last_ok <= stale,
                          "state": rep.state,
                          "queue_depth": rep.depth,
                          "inflight": rep.inflight,
                          "snapshot_seq": rep.snapshot_seq,
                          "uptime_s": round(rep.uptime_s, 3),
                          "snapshot_age_s": round(now - rep.last_ok, 3),
                          "fails": rep.fails,
                          "forwards": rep.forwards,
                          "model_version": rep.model_version}
                for rep in self._replicas.values()}
            # the fleet's version skew: which versions serve, on how many
            model_versions: Dict[str, int] = {}
            for rep in self._replicas.values():
                if rep.model_version:
                    model_versions[rep.model_version] = \
                        model_versions.get(rep.model_version, 0) + 1
            tenants = {ts.name: {"depth": ts.depth,
                                 "shedding": ts.shedding,
                                 "admitted": ts.admitted, "shed": ts.shed}
                       for ts in self._tenants.values()}
            session = {"forwarded": self.session["forwarded"],
                       "failovers": self.session["failovers"],
                       "tenant_overflow": self.session["tenant_overflow"],
                       "picks": dict(self.session["picks"]),
                       "shed": dict(self.session["shed"])}
            rps = round(self._rps, 1)
        return {"role": "router",
                "replicas": replicas,
                "replicas_up": sum(1 for r in replicas.values() if r["up"]),
                "model_versions": model_versions,
                "model_version_skew": len(model_versions) > 1,
                "poll_interval_s": self.poll_interval_s,
                "staleness_s": self.staleness_s,
                "tenant_quota_global": self.tenant_quota,
                "tenants": tenants,
                "forward_rps": rps,
                **({"trace": self._flight.stats()}
                   if self._flight is not None else {}),
                **session}

    def handle_stats(self, method: str, body: bytes, headers=None):
        return (200, "application/json", json.dumps(self.stats()).encode())

    def _healthz(self):
        ups = self.replicas_up()
        if self._closed:
            return 503, "closed\n"
        if ups == 0:
            return 503, "no_replicas\n"
        return 200, f"ok {ups} replica(s)\n"

    def http_handlers(self) -> dict:
        return {"/infer": self.handle_infer, "/stats": self.handle_stats,
                "/register": self.handle_register,
                "/deregister": self.handle_deregister,
                "/trace": self.handle_trace,
                "/trace/": self.handle_trace,
                "/metrics": self.handle_metrics}

    def serve(self, port: int, host: str = "127.0.0.1", registry=None):
        """Mount ``/infer``, ``/stats``, ``/register``, ``/deregister``,
        ``/trace`` and the metrics surface (``/metrics``,
        ``/metrics.json``, ``/healthz``) on one stdlib HTTP server
        (``sinks.serve_metrics``; a daemon thread, loopback by default);
        ``port=0`` binds a free port (read ``server.server_address[1]``).
        Returns the server."""
        from paddle_tpu_torch.observability import sinks

        self._server = sinks.serve_metrics(
            port, host=host, registry=registry,
            extra_handlers=self.http_handlers(), health_fn=self._healthz)
        self._bound_port = self._server.server_address[1]
        if self._flight is not None:
            _tracectx.set_process_info("router", self._bound_port)
        return self._server

    # ----------------------------------------------------------- shutdown
    def close(self) -> None:
        self._closed = True
        self._stop.set()
        self._poller.join(5.0)
        if self._flight is not None and self._flight.telemetry_dir:
            _tracectx.FLIGHT_WRITER.drain(timeout_s=2.0)
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
