"""Resilient serving client: the caller-side half of the overload
contract (the port's copy of ``paddle_tpu/serving/client.py``).

The engine's HTTP surface speaks in typed statuses — 429
``Overloaded`` with a computed ``Retry-After``, 503 while closed or
unhealthy, 504 past a deadline, 400 for caller faults — but a status
code is only half a contract; the other half is a client that actually
honors it.  ``ServingClient`` wraps ``POST /infer`` with the retry
policy every caller would otherwise hand-roll (and get wrong):

* **Capped exponential backoff + full jitter** on retryable statuses
  (429, 503) and transport-level connection failures.  The jittered
  delay is ``uniform(0, min(cap, base * 2**attempt))`` — full jitter
  desynchronizes a fleet of retrying clients so a shed burst doesn't
  come back as a synchronized thundering herd.
* **Retry-After is honored as a floor**: when the server says when the
  backlog will have drained, the client never retries earlier (jitter
  still rides on top, never below).
* **Deadline propagation**: one deadline covers the whole call.  The
  remaining budget shrinks across retries, each attempt advertises it
  to the server (``deadline_ms``), the per-attempt socket timeout is
  clamped to it, and a backoff sleep that would overrun it raises
  ``DeadlineExceeded`` immediately instead — the client NEVER retries
  past the caller's deadline.
* **Only retryable statuses retry**: 4xx is the caller's fault and
  5xx other than 503 is a server fault a retry won't fix; both raise
  immediately (``ServingHTTPError``).  504 maps to the typed
  ``DeadlineExceeded`` — the budget is gone, retrying is lying.
* **Client-side concurrency limiter** (``max_concurrency``): a
  semaphore bounds in-flight calls per client so one process cannot
  open-loop a server that is already telling it to back off.
* **Multi-endpoint failover**: construct with a LIST of endpoints (N
  replicas, or routers) and a shed / open breaker / connection failure
  on replica A retries on B — immediately when B has no pending
  Retry-After floor, all inside the SAME deadline budget.  Floors are
  tracked per endpoint, so one overloaded replica's 429 never delays a
  retry against an idle neighbor, while a fleet-wide shed still backs
  the whole call off.  A replica that dies mid-call (connection reset,
  response truncated mid-read) fails over the same way — zero untyped
  errors.  Calls rotate their starting endpoint round-robin.
* **Distributed tracing** (``trace_sample=``, or the
  ``PADDLE_TPU_TRACE_SAMPLE`` environment variable): each call mints a
  ``TraceContext`` (trace id and head-sampling verdict) and carries it
  in ``X-Ptpu-Trace`` on every attempt, so router and replica spans
  join the same trace (failovers included); a kept trace's spans
  (``client/infer`` and one ``client/attempt`` an attempt) are pushed,
  off the latency path, to the ``POST /trace`` collector of the last
  endpoint that answered, so the router's ``/trace/<id>`` shows the
  client's side of the timeline.

Transport is pluggable (``transport=``): the default speaks
``urllib.request`` over HTTP; tests and in-process benches inject a
callable (e.g. ``local_transport(engine)``) that invokes the engine's
``/infer`` handler directly — same contract, no socket.

    from paddle_tpu_torch.serving import ServingClient
    client = ServingClient("http://127.0.0.1:8080", tenant="search",
                           max_concurrency=16)
    outputs = client.infer(samples, deadline_s=0.5)   # dict name->np
    fleet = ServingClient(["http://10.0.0.1:8080",    # failover pair
                           "http://10.0.0.2:8080"])
"""

from __future__ import annotations

import http.client
import itertools
import json
import os
import random
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Union

from paddle_tpu_torch.observability import tracectx as _tracectx
from paddle_tpu_torch.serving.engine import (DeadlineExceeded, Overloaded,
                                             ServingError)

__all__ = ["ServingClient", "ServingHTTPError", "local_transport",
           "RETRYABLE_STATUSES"]

#: statuses the client retries (with backoff); everything else raises.
RETRYABLE_STATUSES = frozenset({429, 503})


class ServingHTTPError(ServingError):
    """A non-OK ``/infer`` response the retry policy will not (or may
    no longer) retry: ``status`` carries the HTTP status, ``body`` the
    decoded JSON document (or raw text), ``retryable`` whether the
    status was in the retry set (True means attempts ran out)."""

    def __init__(self, msg: str, status: int, body=None,
                 retryable: bool = False):
        super().__init__(msg)
        self.status = int(status)
        self.body = body
        self.retryable = bool(retryable)


def _json_fallback(o):
    """json.dumps default: numpy scalars/arrays anywhere in the payload
    serialize as their python values instead of raising."""
    if hasattr(o, "tolist"):
        return o.tolist()
    raise TypeError(f"Object of type {type(o).__name__} "
                    f"is not JSON serializable")


class _TransportError(Exception):
    """Internal: a connection-level failure (refused, reset, DNS, read
    timeout) the default transport normalizes to — always retryable;
    the original exception rides as ``__cause__``."""


def _urllib_transport(url: str, body: bytes, headers: Dict[str, str],
                      timeout_s: float):
    """Default transport: one POST over urllib.  Returns
    ``(status, response_headers_dict, body_bytes)``; raises
    ``_TransportError`` on connection-level failures."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, headers=headers,
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return (resp.status, dict(resp.headers.items()),
                    resp.read())
    except urllib.error.HTTPError as e:
        # non-2xx WITH a response: that's a status, not a transport
        # failure — the retry policy decides.  Reading the error BODY
        # can still die at the socket (replica killed mid-response);
        # that is a connection-level failure like any other.
        try:
            with e:
                return e.code, dict(e.headers.items()), e.read()
        except (OSError, http.client.HTTPException) as e2:
            raise _TransportError(
                f"transport to {url} died reading the error body: "
                f"{e2!r}") from e2
    except urllib.error.URLError as e:
        raise _TransportError(f"connection to {url} failed: "
                              f"{e.reason}") from e
    except (OSError, TimeoutError, http.client.HTTPException) as e:
        # OSError/TimeoutError cover connect-phase failures; the
        # http.client exceptions (IncompleteRead, BadStatusLine,
        # RemoteDisconnected before it became ConnectionResetError)
        # are the response-READ deaths — a replica SIGKILLed
        # mid-transfer must classify as a retryable connection
        # failure, not surface as an untyped raw exception
        raise _TransportError(f"transport to {url} failed: {e!r}") from e


def local_transport(engine) -> Callable:
    """An in-process transport driving ``engine``'s ``/infer`` handler
    directly — the full HTTP contract (status codes, Retry-After,
    JSON bodies) with no socket.  What the unit tests and
    ``bench_serving``'s tenants lap inject."""
    handler = engine.http_handlers()["/infer"]

    def transport(url: str, body: bytes, headers: Dict[str, str],
                  timeout_s: float):
        res = handler("POST", body, headers)
        status, _ctype, payload = res[0], res[1], res[2]
        resp_headers = res[3] if len(res) > 3 else {}
        return status, dict(resp_headers), payload

    return transport


class ServingClient:
    """Retrying ``/infer`` caller (module doc has the policy).  Thread-
    safe: one instance is meant to be shared by every caller thread in
    a process — that is what makes ``max_concurrency`` a process-level
    backpressure bound rather than a per-thread one."""

    def __init__(self, base_url: Union[str, Sequence[str]], *,
                 tenant: Optional[str] = None,
                 lane: Optional[str] = None,
                 deadline_s: Optional[float] = None,
                 max_attempts: int = 6,
                 backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 5.0,
                 timeout_s: float = 30.0,
                 max_concurrency: int = 0,
                 transport: Optional[Callable] = None,
                 trace_sample: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Optional[random.Random] = None):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got "
                             f"{max_attempts}")
        if backoff_base_s < 0 or backoff_cap_s < 0:
            raise ValueError("backoff base/cap must be >= 0")
        # one base URL or a failover LIST (replicas, or routers); a
        # single endpoint keeps the exact pre-fleet retry behavior
        urls = ([base_url] if isinstance(base_url, str)
                else [str(u) for u in base_url])
        if not urls:
            raise ValueError("ServingClient needs at least one "
                             "endpoint URL")
        self.endpoints = [u.rstrip("/") for u in urls]
        self.base_url = self.endpoints[0]
        # round-robin start index so a shared client spreads calls
        # across the endpoint list (count.__next__ is atomic)
        self._rr = itertools.count()
        self.tenant = tenant
        self.lane = lane
        self.deadline_s = deadline_s        # default per-call budget
        self.max_attempts = int(max_attempts)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.timeout_s = float(timeout_s)
        self._transport = transport or _urllib_transport
        self._clock = clock
        self._sleep = sleep
        self._rng = rng or random.Random()
        self._sem = (threading.BoundedSemaphore(max_concurrency)
                     if max_concurrency and max_concurrency > 0 else None)
        self.max_concurrency = int(max_concurrency or 0)
        # distributed tracing: off unless asked for (the knob or
        # PADDLE_TPU_TRACE_SAMPLE); off, no header is sent and nothing
        # is allocated a call
        if trace_sample is None:
            env = os.environ.get(_tracectx.ENV_SAMPLE)
            try:
                trace_sample = float(env) if env else None
            except ValueError:
                # a garbage host-wide variable must not make every client
                # unconstructable: untraced, loudly
                import warnings

                warnings.warn(
                    f"ignoring non-numeric {_tracectx.ENV_SAMPLE}="
                    f"{env!r} (tracing stays off)")
                trace_sample = None
        self.trace_sample = trace_sample
        self._recorder = _tracectx.make_recorder(trace_sample, None)
        # session counters (informational; lock-guarded, read via stats)
        self._stats_lock = threading.Lock()
        self.session = {"requests": 0, "attempts": 0, "retries": 0,
                        "retry_sleep_s": 0.0, "deadline_exceeded": 0,
                        "gave_up": 0, "failovers": 0,
                        "status_counts": {},
                        # responses by the server's model_version —
                        # a client-side view of a rolling reload
                        "model_versions": {},
                        # per-endpoint counters: WHICH replica of the
                        # list is misbehaving (aggregates hide it)
                        "endpoints": {u: {"attempts": 0, "failovers": 0,
                                          "sheds": 0,
                                          "connect_errors": 0}
                                      for u in self.endpoints}}

    # ------------------------------------------------------------ policy
    def _backoff_s(self, attempt: int, retry_after_s: float) -> float:
        """Delay before retry number ``attempt`` (0-based): full-jitter
        exponential backoff, floored at the server's Retry-After."""
        ceiling = min(self.backoff_cap_s,
                      self.backoff_base_s * (2.0 ** attempt))
        jittered = self._rng.uniform(0.0, ceiling)
        return max(retry_after_s, jittered)

    @staticmethod
    def _retry_after_from(headers: Dict[str, str], doc) -> float:
        """Server-advertised wait: the JSON body's fractional
        ``retry_after_s`` wins over the integral Retry-After header."""
        if isinstance(doc, dict):
            v = doc.get("retry_after_s")
            if isinstance(v, (int, float)) and v >= 0:
                return float(v)
        for k, v in headers.items():
            if k.lower() == "retry-after":
                try:
                    return max(0.0, float(v))
                except (TypeError, ValueError):
                    return 0.0
        return 0.0

    def _count(self, key: str, n=1) -> None:
        with self._stats_lock:
            self.session[key] += n

    def _count_status(self, status) -> None:
        with self._stats_lock:
            sc = self.session["status_counts"]
            sc[str(status)] = sc.get(str(status), 0) + 1

    def _count_ep(self, url: str, key: str) -> None:
        with self._stats_lock:
            self.session["endpoints"][url][key] += 1

    # ------------------------------------------------------------- calls
    def infer(self, samples, *, tenant: Optional[str] = None,
              lane: Optional[str] = None,
              deadline_s: Optional[float] = None,
              max_tokens: Optional[int] = None,
              temperature: Optional[float] = None,
              top_k: Optional[int] = None,
              top_p: Optional[float] = None,
              seed: Optional[int] = None,
              as_numpy: bool = True):
        """POST ``samples`` (the ``/infer`` ``input`` document: a list
        of samples, each a list of JSON-serializable fields) and return
        the ``outputs`` dict (name → np.ndarray, or nested lists with
        ``as_numpy=False``).  Retries per the module-doc policy;
        ``deadline_s`` (defaulting to the client's) bounds the WHOLE
        call including backoff sleeps.

        Decode servers: pass ONE
        prompt as the single sample and ``max_tokens`` to bound the
        generation; the returned dict carries ``"tokens"`` (the
        generated ids) plus the reserved key ``"generated"`` (their
        count, a plain int).  The deadline budget covers the WHOLE
        generation — a server-side mid-generation expiry surfaces as
        typed ``DeadlineExceeded`` (the 504 is never retried: the
        budget is spent), with the server's partial progress count in
        the exception message and the partial output itself discarded
        per the documented policy.  ``temperature``/``top_k``/``top_p``/
        ``seed`` ride along for sampling-enabled decode servers (greedy
        when all absent; a non-sampling server answers 400)."""
        doc = {"input": [
            [f.tolist() if hasattr(f, "tolist") else f for f in
             (s if isinstance(s, (tuple, list)) else (s,))]
            for s in samples]}
        if max_tokens is not None:
            doc["max_tokens"] = int(max_tokens)
        if temperature is not None:
            doc["temperature"] = float(temperature)
        if top_k is not None:
            doc["top_k"] = int(top_k)
        if top_p is not None:
            doc["top_p"] = float(top_p)
        if seed is not None:
            doc["seed"] = int(seed)
        if tenant is None:
            tenant = self.tenant
        if tenant is not None:
            doc["tenant"] = tenant
        if lane is None:
            lane = self.lane
        if lane is not None:
            doc["lane"] = lane
        if deadline_s is None:
            deadline_s = self.deadline_s
        clock = self._clock
        deadline = (clock() + deadline_s
                    if deadline_s is not None else None)
        self._count("requests")
        trace = None
        if self._recorder is not None:
            # the outermost tracing edge: the trace id and sampling
            # verdict are minted here and ride every attempt
            args = {} if tenant is None else {"tenant": tenant}
            trace = _tracectx.SpanBuffer(
                _tracectx.mint(self.trace_sample), "client/infer",
                role="client", **args)
            t_req0 = time.perf_counter()
        if self._sem is not None:
            budget = (None if deadline is None
                      else max(0.0, deadline - clock()))
            if not self._sem.acquire(timeout=budget):
                self._count("deadline_exceeded")
                self._trace_done(trace, "deadline")
                raise DeadlineExceeded(
                    f"deadline ({deadline_s:g}s) exhausted waiting for "
                    f"a client concurrency slot "
                    f"(max_concurrency={self.max_concurrency})")
        try:
            out = self._infer_retrying(doc, deadline, deadline_s,
                                       as_numpy, trace)
        except Overloaded:
            self._trace_done(trace, "shed")
            raise
        except DeadlineExceeded:
            self._trace_done(trace, "deadline")
            raise
        except Exception as e:
            self._trace_done(trace, "error", error=repr(e))
            raise
        else:
            if trace is not None:
                self._trace_done(trace, "ok", latency_us=round(
                    (time.perf_counter() - t_req0) * 1e6, 1))
            return out
        finally:
            if self._sem is not None:
                self._sem.release()

    def _trace_done(self, trace, outcome: str, **args) -> None:
        """Close a call's span buffer; a kept trace (head-sampled or
        anomalous) publishes locally and is pushed to the ``/trace``
        collector of the endpoint that last answered (never the dead
        one a failover left)."""
        rec = self._recorder
        if rec is None or trace is None:
            return
        if rec.finish(trace, outcome, **args):
            _tracectx.push_spans(trace.push_url or self.endpoints[0],
                                 trace.spans)

    def _infer_retrying(self, doc: dict, deadline, deadline_s,
                        as_numpy: bool, trace=None):
        clock = self._clock
        eps = self.endpoints
        n_ep = len(eps)
        idx = next(self._rr) % n_ep      # rotate the starting endpoint
        prev_url = None
        # Retry-After / backoff floors are PER ENDPOINT (per call): a
        # 429 from replica A must not delay an immediate failover to an
        # idle replica B, while a single-endpoint client backs the
        # whole call off exactly as before the fleet work.
        not_before = [0.0] * n_ep
        last = None                      # (status, doc_or_text)
        for attempt in range(self.max_attempts):
            now = clock()
            remaining = None
            if deadline is not None:
                remaining = deadline - now
                if remaining <= 0:
                    self._count("deadline_exceeded")
                    raise DeadlineExceeded(
                        f"deadline ({deadline_s:g}s) exceeded after "
                        f"{attempt} attempt(s)")
            if n_ep > 1 and attempt > 0:
                # the endpoint that can be tried soonest; ties broken
                # in rotation order starting AFTER the one just tried
                # (so an equal-floor tie — e.g. backoff_base_s=0 after
                # a connection error — fails over instead of re-hitting
                # the same dead endpoint)
                idx = min(range(n_ep),
                          key=lambda i, _c=idx: (
                              max(0.0, not_before[i] - now),
                              (i - _c - 1) % n_ep))
            wait = max(0.0, not_before[idx] - now)
            if attempt > 0:
                if wait > 0 and deadline is not None \
                        and now + wait >= deadline:
                    self._count("deadline_exceeded")
                    raise DeadlineExceeded(
                        f"deadline ({deadline_s:g}s) would elapse "
                        f"during the {wait:.3f}s backoff before retry "
                        f"{attempt + 1}/{self.max_attempts} "
                        f"(last: {last[0] or 'connection error'})")
                self._count("retries")
                self._count("retry_sleep_s", wait)
                if n_ep == 1 or wait > 0:
                    # a ready alternate endpoint fails over with NO
                    # sleep — the point of carrying an endpoint list
                    self._sleep(wait)
                if n_ep > 1 and eps[idx] != prev_url:
                    self._count("failovers")
                    self._count_ep(eps[idx], "failovers")
                    if trace is not None:
                        trace.event("client/failover", endpoint=eps[idx])
                if deadline is not None:
                    # re-check AFTER the sleep: a scheduler overshoot
                    # can land past the deadline, and a negative
                    # remaining would reach the socket timeout as an
                    # untyped ValueError instead of the typed error
                    remaining = deadline - clock()
                    if remaining <= 0:
                        self._count("deadline_exceeded")
                        raise DeadlineExceeded(
                            f"deadline ({deadline_s:g}s) exceeded "
                            f"after {attempt} attempt(s) (backoff "
                            f"sleep overshot the budget)")
            if remaining is not None:
                # the server sheds what it cannot finish in time —
                # propagate the SHRUNK budget, not the original
                doc["deadline_ms"] = round(remaining * 1e3, 3)
            body = json.dumps(doc, default=_json_fallback).encode()
            timeout = (self.timeout_s if remaining is None
                       else min(self.timeout_s, remaining))
            self._count("attempts")
            prev_url = eps[idx]
            self._count_ep(prev_url, "attempts")
            req_headers = {"Content-Type": "application/json"}
            if trace is not None:
                # the attempt span's id rides the header, so the next
                # hop's spans parent under this attempt
                att_id = _tracectx.new_span_id()
                req_headers[_tracectx.HEADER] = \
                    trace.ctx.child(att_id).to_header()
                t_att0 = time.perf_counter_ns()
            try:
                status, headers, payload = self._transport(
                    prev_url + "/infer", body, req_headers, timeout)
            except _TransportError as e:
                status, headers, payload = None, {}, None
                last = (None, repr(e))
                self._count_ep(prev_url, "connect_errors")
            if trace is not None:
                trace.add_span(
                    "client/attempt", t_att0,
                    time.perf_counter_ns() - t_att0, span_id=att_id,
                    endpoint=prev_url,
                    status=status if status is not None
                    else "connect_error")
                if status is not None:
                    # the last endpoint that answered gets the push
                    trace.push_url = prev_url
            if status is not None:
                self._count_status(status)
                try:
                    rdoc = json.loads(payload.decode())
                except (ValueError, UnicodeDecodeError, AttributeError):
                    rdoc = (payload or b"").decode("replace")
                if status == 200:
                    outs = rdoc["outputs"]
                    if as_numpy:
                        import numpy as np
                        outs = {k: np.asarray(v)
                                for k, v in outs.items()}
                    if "generated" in rdoc:
                        # decode servers report the generated token
                        # count alongside the outputs ("generated" is
                        # a reserved key — no output layer may use it)
                        outs["generated"] = int(rdoc["generated"])
                    if "model_version" in rdoc:
                        # which weights answered (zero-downtime
                        # reload, where the server has it) —
                        # "model_version" is a reserved key like
                        # "generated"; stats() aggregates the
                        # versions this client has been served by
                        mv = str(rdoc["model_version"])
                        outs["model_version"] = mv
                        with self._stats_lock:
                            vc = self.session["model_versions"]
                            vc[mv] = vc.get(mv, 0) + 1
                    return outs
                if status == 504:
                    # the server spent the budget we advertised; a
                    # retry would re-spend a smaller one and lose again
                    self._count("deadline_exceeded")
                    raise DeadlineExceeded(
                        f"server reported deadline exceeded (504): "
                        f"{rdoc}")
                if status not in RETRYABLE_STATUSES:
                    raise ServingHTTPError(
                        f"/infer answered {status} (not retryable): "
                        f"{rdoc}", status, rdoc)
                self._count_ep(prev_url, "sheds")
                last = (status, rdoc)
            # retryable (429/503/transport): floor THIS endpoint out,
            # honoring its Retry-After; the next loop picks whichever
            # endpoint is ready soonest, never past the deadline
            retry_after = (self._retry_after_from(headers, last[1])
                           if status is not None else 0.0)
            not_before[idx] = clock() + self._backoff_s(attempt,
                                                        retry_after)
        self._count("gave_up")
        status, rdoc = last
        if status == 429:
            retry_after = self._retry_after_from({}, rdoc)
            raise Overloaded(
                f"server still overloaded after {self.max_attempts} "
                f"attempts: {rdoc}",
                retry_after_s=retry_after or 1.0,
                reason=(rdoc.get("reason", "queue_full")
                        if isinstance(rdoc, dict) else "queue_full"))
        raise ServingHTTPError(
            f"/infer still failing after {self.max_attempts} attempts "
            f"(last: {status if status is not None else 'connection error'}"
            f"): {rdoc}", status or 0, rdoc, retryable=True)

    def stats(self) -> dict:
        """Client-side session counters (requests, attempts, retries,
        cumulative backoff, give-ups) — the caller half of the
        observability story.  ``endpoints`` breaks attempts /
        failovers / sheds (429+503) / connect errors down PER
        ENDPOINT, so a caller can tell WHICH replica of its failover
        list is misbehaving."""
        with self._stats_lock:
            out = dict(self.session)
            out["status_counts"] = dict(out["status_counts"])
            out["model_versions"] = dict(out["model_versions"])
            out["endpoints"] = {u: dict(c) for u, c
                                in out["endpoints"].items()}
        return out
