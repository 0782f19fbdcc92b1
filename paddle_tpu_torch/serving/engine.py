"""Continuous-batching decode server over a ``SlotDecoder`` or a
``PagedDecoder``, hardened for overload and shared by tenants.

The decode half of ``paddle_tpu/serving/engine.py``'s ``InferenceEngine``:
``submit`` returns a ``Future``; one batcher thread runs an Orca-style
iteration-level scheduler over KV-cache slots.  With a ``SlotDecoder``
(``_decode_loop``) each turn admits queued prompts into free slots (one
prefill each) and runs ONE decode step over the resident set; with a
``PagedDecoder`` (``_paged_loop``) each turn admits into free slots
(prefix cache consulted), grows the residents' block lists, and runs ONE
mixed iteration - every resident's decode step fused with the head join's
next prefill chunk.  Finished sequences (EOS or ``max_tokens``) free their
slot mid-flight; ``decode_policy="static"`` admits only once the whole
batch drained (the request-level baseline).  A dry KV pool sheds that one
sequence with ``Overloaded(reason="kv_blocks")``; a fault in the forward
(or in a prefill) fails every resident and resets the caches, and the
engine keeps serving.

Overload is a designed state:

  * admission control: with ``max_queue_depth`` set, ``submit`` fails the
    Future at once with ``Overloaded`` when the backlog reaches the cap,
    and keeps shedding until it drains to the ``hysteresis`` watermark;
  * per-request deadlines (``deadline_us`` or ``default_deadline_us``)
    cover the whole generation and are reaped every iteration;
  * two priority lanes (``"high"``, ``"normal"``): strict priority with an
    anti-starvation credit (``starvation_limit``);
  * tenants: inside each lane deficit round robin by ``tenant_weights``,
    charged in decode steps (a request's ``max_tokens``, refunded on an
    early EOS); per-tenant quotas (``max_queue_depth_per_tenant``, a
    fraction of the global cap or a count) over queued plus slot-holding
    sequences, so a quota caps a tenant's KV slots; a per-tenant
    error-rate breaker (``BreakerOpen``, a half-open probe to close);
  * ``close(drain_timeout_s)`` sheds what cannot finish instead of
    hanging, and a watchdog fails every in-flight future with
    ``EngineUnhealthy`` when the batcher thread dies.

A ``PagedDecoder(sampling=True)`` serves seeded sampling
(``temperature``, ``top_k``, ``top_p``, ``seed``); requests without those
knobs decode greedily, bit-equal to a decoder without sampling.

``serve`` adds a stdlib HTTP front end on the JAX engine's wire format:
``POST /infer`` ``{"input": [prompt], "max_tokens": N}`` (optional
``lane``, ``tenant``, ``deadline_ms``, ``temperature``, ``top_k``,
``top_p``, ``seed``; headers ``X-Ptpu-Lane``, ``X-Ptpu-Tenant``,
``X-Ptpu-Deadline-Ms``, ``X-Ptpu-Max-Tokens``) ->
``{"outputs": {"tokens": [...]}, "generated": N}`` (400 bad request, 429
``Overloaded`` with ``Retry-After`` and the shed reason, 504 deadline, 503
closed or dead, 500 server fault), ``GET /healthz``, ``GET /stats`` and
``GET /kernels`` (each kernel's launch count).  ``serving.client`` is the
caller's half of the contract.

Not ported (each keyword raises ``NotImplementedError`` naming its
``ROADMAP.md`` item when set): the whole-forward micro-batching mode and
model versions (item 8), tracing and the compile cache (item 13), mesh
slices (item 14).
"""

from __future__ import annotations

import heapq
import json
import math
import queue
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

from paddle_tpu_torch import ops
from paddle_tpu_torch.serving.blocks import KVPoolExhausted

LANES = ("high", "normal")
SHED_REASONS = ("queue_full", "tenant_quota", "breaker_open", "deadline",
                "drain", "thread_death", "abandoned", "kv_blocks")
# why a KV slot went back to the free list; "kv_blocks" = the paged
# decoder's block pool ran dry and the sequence was shed
SLOT_FREE_REASONS = ("finished", "deadline", "abandoned", "error",
                     "drain", "kv_blocks")
DEFAULT_TENANT = "default"

_WHOLE_FORWARD = "ROADMAP.md §1 item 8 (the whole-forward mode)"
_VERSIONS = "ROADMAP.md §1 item 8 (model versions and canary)"
# keyword -> (its JAX default, the ROADMAP item that ports it)
_UNPORTED = {
    "output_layer": (None, _WHOLE_FORWARD),
    "parameters": (None, _WHOLE_FORWARD),
    "inference": (None, _WHOLE_FORWARD),
    "feeding": (None, _WHOLE_FORWARD),
    "max_batch": (32, _WHOLE_FORWARD),
    "max_wait_us": (2000.0, _WHOLE_FORWARD),
    "batch_buckets": (None, _WHOLE_FORWARD),
    "overload_wait_scale": (8.0, _WHOLE_FORWARD),
    "seq_buckets": (None, _WHOLE_FORWARD),
    "model_version": ("boot", _VERSIONS),
    "canary_fraction": (0.0, _VERSIONS),
    "canary_promote_requests": (64, _VERSIONS),
    "reload_key": (None, _VERSIONS),
    "mesh": (None, "ROADMAP.md §1 item 14 (parallel)"),
    "mesh_slices": (0, "ROADMAP.md §1 item 14 (parallel)"),
    "mesh_rules": (None, "ROADMAP.md §1 item 14 (parallel)"),
    "trace_sample": (None, "ROADMAP.md §1 item 13 (tracing)"),
    "telemetry_dir": (None, "ROADMAP.md §1 item 13 (tracing)"),
    "compile_cache_dir": (None, "ROADMAP.md §1 item 13 (the compile "
                                "cache)"),
}


class ServingError(RuntimeError):
    """Base of the engine's typed request-failure exceptions."""


class Overloaded(ServingError):
    """Shed for lack of capacity; ``reason`` says which gate fired
    (``"queue_full"``, ``"tenant_quota"``, ``"breaker_open"``,
    ``"kv_blocks"``).  ``retry_after_s`` estimates when capacity frees
    up."""

    def __init__(self, msg: str, retry_after_s: float = 1.0,
                 reason: str = "queue_full"):
        super().__init__(msg)
        self.retry_after_s = retry_after_s
        self.reason = reason


class BreakerOpen(Overloaded):
    """The tenant's error-rate breaker is open: its traffic is shed at
    admission until the cooldown elapses and a half-open probe succeeds.
    An ``Overloaded``, so retry policies (429 + Retry-After) apply."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg, retry_after_s, reason="breaker_open")


class DeadlineExceeded(ServingError):
    """The request's deadline passed (``generated``, when set, says how
    many tokens the discarded partial output held), or its caller gave
    up."""


class EngineClosed(ServingError):
    """Submitted after ``close()``, or shed by a drain timeout."""


class EngineUnhealthy(ServingError):
    """The batcher thread died; the watchdog failed every in-flight future
    rather than leaving callers blocked forever."""


def _pctile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1, int(q * len(sorted_vals)))]


def _bucket_rows(n: int, buckets) -> int:
    """The smallest bucket holding ``n`` rows (the last when none does)."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


class _Request:
    __slots__ = ("prompt", "cost", "future", "t_submit", "deadline", "lane",
                 "tenant", "tstate", "probe", "abandoned", "sampling",
                 "__weakref__")

    def __init__(self, prompt, cost, future, t_submit, deadline, lane,
                 tenant, tstate, probe=False, sampling=None):
        self.prompt = prompt
        # the WFQ deficit charged at board time: the decode-step budget
        self.cost = cost                  # max_tokens
        self.future = future
        self.t_submit = t_submit
        self.deadline = deadline          # absolute perf_counter seconds
        self.lane = lane
        self.tenant = tenant
        self.tstate = tstate              # the engine's _Tenant record
        self.probe = probe                # the breaker's half-open probe
        self.abandoned = False
        # (temperature, top_k, top_p, seed), or None for greedy
        self.sampling = sampling


class _SlotAllocator:
    """Lowest-index-first KV-slot free list, so residents stay packed in
    ``[0, highwater)`` and the decode rows track occupancy."""

    __slots__ = ("n", "_free", "occupied", "highwater")

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"need at least one slot, got {n}")
        self.n = int(n)
        self._free = list(range(self.n))
        self.occupied: set = set()
        self.highwater = 0

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        s = heapq.heappop(self._free)
        self.occupied.add(s)
        self.highwater = max(self.highwater, s + 1)
        return s

    def free(self, s: int) -> None:
        if s not in self.occupied:
            raise ValueError(f"slot {s} is not allocated")
        self.occupied.remove(s)
        heapq.heappush(self._free, s)
        while self.highwater and (self.highwater - 1) not in self.occupied:
            self.highwater -= 1

    def __len__(self) -> int:
        return len(self.occupied)


class _DecodeSeq:
    """A resident sequence: request, slot, write position (== length),
    last token, generated output so far."""

    __slots__ = ("req", "slot", "pos", "last", "out")

    def __init__(self, req, slot, pos, last):
        self.req, self.slot, self.pos, self.last = req, slot, pos, last
        self.out = [last]


class _PagedJoin:
    """A sequence mid-prefill: its prompt's chunks run one per mixed
    iteration from ``written`` (the prefix-cache match) on."""

    __slots__ = ("req", "slot", "written")

    def __init__(self, req, slot, matched):
        self.req, self.slot, self.written = req, slot, matched


_BR_CLOSED, _BR_OPEN, _BR_HALF_OPEN = "closed", "open", "half_open"


class _Tenant:
    """Per-tenant state: admitted depth (the quota gate), its hysteresis
    flag, the breaker's rolling window, and the ``tenant_stats`` mirrors.
    ``lock`` guards the cross-thread updates."""

    __slots__ = ("name", "weight", "lock", "depth", "shedding", "br_state",
                 "br_window", "br_errors", "br_opened_at",
                 "br_probe_inflight", "br_probe_at", "goodput", "requests",
                 "shed", "errors", "lat_us")

    def __init__(self, name: str, weight: float, window: int):
        self.name = name
        self.weight = float(weight)
        self.lock = threading.Lock()
        self.depth = 0                 # admitted, not yet resolved
        self.shedding = False
        self.br_state = _BR_CLOSED
        self.br_window: deque = deque(maxlen=window) if window else None
        self.br_errors = 0
        self.br_opened_at = 0.0
        self.br_probe_inflight = False
        self.br_probe_at = 0.0
        self.goodput = 0
        self.requests = 0
        self.shed = 0
        self.errors = 0
        self.lat_us: deque = deque(maxlen=1024)

    def _br_push(self, err: bool) -> None:
        w = self.br_window
        if w is None:
            return
        if len(w) == w.maxlen and w[0]:
            self.br_errors -= 1
        w.append(err)
        if err:
            self.br_errors += 1

    def _br_reset(self) -> None:
        if self.br_window is not None:
            self.br_window.clear()
        self.br_errors = 0


class _Lane:
    """One priority lane: per-tenant FIFO deques drained by deficit round
    robin.  A tenant whose deficit covers its head request's cost serves
    it; otherwise it banks ``weight`` and the ring rotates, so backlogged
    tenants get service in proportion to their weights.  One active tenant
    (untagged traffic) is a plain FIFO pop.  Only the batcher appends and
    pops; ``drain`` runs when it is dead or draining."""

    __slots__ = ("q", "rr", "ringset", "deficit", "quanta", "n")

    def __init__(self, quanta: Dict[str, float]):
        self.q: Dict[str, deque] = {}
        self.rr: deque = deque()       # tenants that may have work
        self.ringset: set = set()      # rr membership (removal is lazy)
        self.deficit: Dict[str, float] = {}
        self.quanta = quanta           # tenant -> weight
        self.n = 0

    def __len__(self) -> int:
        return self.n

    def append(self, r: _Request) -> None:
        t = r.tenant
        d = self.q.get(t)
        if d is None:
            d = self.q[t] = deque()
            self.deficit[t] = 0.0
        if t not in self.ringset:
            self.ringset.add(t)
            self.rr.append(t)
        d.append(r)
        self.n += 1

    def popleft(self) -> Optional[_Request]:
        rr, q, deficit, quanta = self.rr, self.q, self.deficit, self.quanta
        fruitless = 0
        while rr:
            t = rr[0]
            d = q.get(t)
            if not d:
                # idle tenant: leaves the ring, forfeits its deficit
                rr.popleft()
                self.ringset.discard(t)
                deficit[t] = 0.0
                continue
            # a concurrent drain (watchdog, drain timeout) may empty the
            # deques between the check and the access
            try:
                if len(rr) == 1:
                    r = d.popleft()
                    deficit[t] = 0.0
                    self.n -= 1
                    return r
                cost = d[0].cost
                have = deficit[t]
                if have >= cost:
                    r = d.popleft()
                    deficit[t] = have - cost
                    self.n -= 1
                    return r
                deficit[t] = have + quanta.get(t, 1.0)
                rr.rotate(-1)
                fruitless += 1
                if fruitless > len(rr):
                    # a full cycle served nobody: fast-forward k rounds
                    k = min(-(-(q[tt][0].cost - deficit[tt])
                              // quanta.get(tt, 1.0))
                            for tt in rr if q.get(tt))
                    if k > 0:
                        for tt in rr:
                            if q.get(tt):
                                deficit[tt] += k * quanta.get(tt, 1.0)
                    fruitless = 0
            except (IndexError, ValueError):
                continue
        self.n = 0
        self.ringset.clear()
        return None

    def credit(self, tenant: str, amount: float) -> None:
        """Refund unused boarded cost (an early EOS) while the tenant is
        still backlogged."""
        if amount > 0 and self.q.get(tenant):
            self.deficit[tenant] = self.deficit.get(tenant, 0.0) + amount

    def drain(self) -> List[_Request]:
        out = []
        for d in list(self.q.values()):
            while True:
                try:
                    out.append(d.popleft())
                except IndexError:
                    break
        self.rr.clear()
        self.ringset.clear()
        self.n = 0
        for t in self.deficit:
            self.deficit[t] = 0.0
        return out


class _HTTPServer(ThreadingHTTPServer):
    # a flood of callers must queue in the listen backlog, not be reset
    # (socketserver's default backlog is 5)
    request_queue_size = 1024
    daemon_threads = True


class InferenceEngine:
    """Decode server over a ``SlotDecoder`` or ``PagedDecoder`` (module
    docstring).  ``eos_id`` ends a sequence when emitted;
    ``default_max_tokens`` is the budget of a request that names none (0:
    every request must name one).  Close with ``close()``; also a context
    manager."""

    http_timeout_s = 300.0

    def __init__(self, decoder=None, parameters=None, *,
                 output_layer=None, inference=None, feeding=None,
                 max_batch: int = 32, max_wait_us: float = 2000.0,
                 batch_buckets=None, compile_cache_dir=None,
                 max_queue_depth: int = 0, hysteresis: float = 0.25,
                 default_deadline_us: Optional[float] = None,
                 starvation_limit: int = 4,
                 overload_wait_scale: float = 8.0,
                 watchdog_interval_s: float = 0.25,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 max_queue_depth_per_tenant: float = 0.0,
                 breaker_window: int = 64,
                 breaker_threshold: float = 0.5,
                 breaker_min_requests: int = 16,
                 breaker_cooldown_s: float = 5.0,
                 max_tenants: int = 256,
                 mesh=None, mesh_slices: int = 0, mesh_rules=None,
                 trace_sample: Optional[float] = None,
                 telemetry_dir: Optional[str] = None,
                 decode_policy: str = "continuous",
                 eos_id: Optional[int] = None,
                 default_max_tokens: int = 0,
                 seq_buckets=None,
                 model_version: str = "boot",
                 canary_fraction: float = 0.0,
                 canary_promote_requests: int = 64,
                 reload_key=None):
        given = dict(output_layer=output_layer, parameters=parameters,
                     inference=inference, feeding=feeding,
                     max_batch=max_batch, max_wait_us=max_wait_us,
                     batch_buckets=batch_buckets,
                     overload_wait_scale=overload_wait_scale,
                     seq_buckets=seq_buckets, model_version=model_version,
                     canary_fraction=canary_fraction,
                     canary_promote_requests=canary_promote_requests,
                     reload_key=reload_key, mesh=mesh,
                     mesh_slices=mesh_slices, mesh_rules=mesh_rules,
                     trace_sample=trace_sample, telemetry_dir=telemetry_dir,
                     compile_cache_dir=compile_cache_dir)
        if decoder is not None and not (hasattr(decoder, "max_slots")
                                        and hasattr(decoder, "step")):
            # a layer where the JAX engine takes its output_layer
            given["output_layer"], decoder = decoder, None
        for kw, value in given.items():
            default, item = _UNPORTED[kw]
            if value is not default and value != default:
                raise NotImplementedError(
                    f"InferenceEngine({kw}=...) is not ported to "
                    f"paddle_tpu_torch yet: {item}")
        if decoder is None:
            raise ValueError("InferenceEngine needs decoder= (a SlotDecoder "
                             "or PagedDecoder)")
        if decode_policy not in ("continuous", "static"):
            raise ValueError(
                f"decode_policy must be 'continuous' or 'static' (the "
                f"benchmark baseline), got {decode_policy!r}")
        if default_max_tokens < 0:
            raise ValueError(f"default_max_tokens must be >= 0, got "
                             f"{default_max_tokens}")
        self._decoder = decoder
        self._paged = bool(getattr(decoder, "paged", False))
        self.decode_policy = decode_policy
        self.eos_id = None if eos_id is None else int(eos_id)
        self.default_max_tokens = int(default_max_tokens)
        self._slot_alloc = _SlotAllocator(decoder.max_slots)
        self._ttft_us: deque = deque(maxlen=4096)

        # ---- overload policy knobs
        if max_queue_depth < 0:
            raise ValueError(f"max_queue_depth must be >= 0 (0 = "
                             f"unbounded), got {max_queue_depth}")
        if not 0.0 <= hysteresis < 1.0:
            raise ValueError(f"hysteresis must be in [0, 1), got "
                             f"{hysteresis}")
        self.max_queue_depth = int(max_queue_depth)
        # once shedding, shed until the backlog drains to this depth
        self._resume_depth = int(self.max_queue_depth * (1.0 - hysteresis))
        self.default_deadline_us = (float(default_deadline_us)
                                    if default_deadline_us else None)
        self._default_deadline_s = (self.default_deadline_us / 1e6
                                    if self.default_deadline_us else None)
        self.starvation_limit = int(starvation_limit)
        self.watchdog_interval_s = float(watchdog_interval_s)

        # ---- tenant isolation knobs
        self.tenant_weights = {str(t): float(w)
                               for t, w in (tenant_weights or {}).items()}
        if any(w <= 0 for w in self.tenant_weights.values()):
            raise ValueError(
                f"tenant weights must be > 0, got {self.tenant_weights}")
        if max_queue_depth_per_tenant < 0:
            raise ValueError(f"max_queue_depth_per_tenant must be >= 0, "
                             f"got {max_queue_depth_per_tenant}")
        # < 1: a fraction of the global cap; >= 1: a request count
        if 0 < max_queue_depth_per_tenant < 1:
            if not self.max_queue_depth:
                raise ValueError(
                    "fractional max_queue_depth_per_tenant needs "
                    "max_queue_depth set (it is a fraction of that cap)")
            self.tenant_cap = max(
                1, int(self.max_queue_depth * max_queue_depth_per_tenant))
        else:
            self.tenant_cap = int(max_queue_depth_per_tenant)
        self._tenant_resume = int(self.tenant_cap * (1.0 - hysteresis))
        if not 0.0 <= breaker_threshold <= 1.0:
            raise ValueError(f"breaker_threshold must be in [0, 1], got "
                             f"{breaker_threshold}")
        self.breaker_window = int(breaker_window)       # 0 disables
        self.breaker_threshold = float(breaker_threshold)
        self.breaker_min_requests = max(1, int(breaker_min_requests))
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        # untrusted ids: configured tenants always get a record, first-seen
        # ids past the cap collapse onto "default"
        self.max_tenants = max(1, int(max_tenants),
                               len(tenant_weights or {}) + 1)
        self._quanta: Dict[str, float] = dict(self.tenant_weights)
        self._tenants: Dict[str, _Tenant] = {}
        self._tenant_make_lock = threading.Lock()

        self._inq: "queue.SimpleQueue" = queue.SimpleQueue()
        self._lane_high = _Lane(self._quanta)
        self._lane_normal = _Lane(self._quanta)
        self._lane_credit = 0              # high pops past waiting normal
        self._shedding = False             # admission gate state
        self._stopping = False             # the batcher saw the sentinel
        self._abort = False                # stop decoding, shed the rest
        self._closed = False
        self._healthy = True
        self._health_reason = ""
        self._inflight = ()                # the residents' requests
        # orders submit's {closed check, put} against close's {set closed,
        # put sentinel}: a request put under it is ahead of the sentinel
        self._close_lock = threading.Lock()
        self._err_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.session = {"requests": 0, "rows": 0, "errors": 0,
                        "goodput": 0, "lane_credit_pops": 0,
                        "tenant_overflow": 0,
                        "shed": {reason: 0 for reason in SHED_REASONS},
                        # iterations: the /stats progress beat
                        "iterations": 0, "tokens": 0, "slot_allocs": 0,
                        "slot_frees": 0, "slot_steps": 0,
                        "kv_cells_live": 0, "kv_cells_alloc": 0}
        if self._paged:
            self.session.update({"prefix_hits": 0,
                                 "prefix_blocks_shared": 0})
        self._tenant(DEFAULT_TENANT)       # pre-bind the untagged path
        self._lat_us: deque = deque(maxlen=2048)
        self._t_start = time.perf_counter()
        self._bound_port = 0
        # (t_done, n) per finished sequence; _rps feeds Retry-After
        self._done_log: deque = deque(maxlen=256)
        self._rps = 0.0
        self._server = None
        self._batcher = threading.Thread(
            target=self._paged_loop if self._paged else self._decode_loop,
            name="ptt-serving-batcher", daemon=True)
        self._watchdog_stop = threading.Event()
        self._watchdog = threading.Thread(target=self._watchdog_loop,
                                          name="ptt-serving-watchdog",
                                          daemon=True)
        self._batcher.start()
        self._watchdog.start()

    # ------------------------------------------------------------ tenants
    def _tenant(self, name: str) -> _Tenant:
        """The tenant's record, made on first sight (weight from
        ``tenant_weights``, else 1).  Past ``max_tenants`` records, ids
        without a configured weight collapse onto ``"default"``
        (counted)."""
        ts = self._tenants.get(name)
        if ts is None:
            with self._tenant_make_lock:
                ts = self._tenants.get(name)
                if ts is None:
                    if (len(self._tenants) >= self.max_tenants
                            and name not in self.tenant_weights):
                        self.session["tenant_overflow"] += 1
                        return self._tenants[DEFAULT_TENANT]
                    weight = self.tenant_weights.get(name, 1.0)
                    self._quanta.setdefault(name, weight)
                    ts = _Tenant(name, weight, self.breaker_window)
                    self._tenants[name] = ts
        return ts

    def _breaker_sheds(self, ts: _Tenant, now: float):
        """Breaker admission check (under ``ts.lock``): ``(wait_s,
        is_probe)``; ``wait_s`` is the cooldown left when the tenant is
        shed (else None), ``is_probe`` True for the one half-open probe."""
        st = ts.br_state
        if st == _BR_CLOSED:
            return None, False
        cooldown = self.breaker_cooldown_s
        if st == _BR_OPEN:
            elapsed = now - ts.br_opened_at
            if elapsed < cooldown:
                return max(0.05, cooldown - elapsed), False
            ts.br_state = _BR_HALF_OPEN
            ts.br_probe_inflight = False
        # half-open: one probe rides through; a probe whose outcome never
        # lands expires after a cooldown
        if ts.br_probe_inflight and now - ts.br_probe_at < cooldown:
            return max(0.05, cooldown), False
        ts.br_probe_inflight = True
        ts.br_probe_at = now
        return None, True

    def _tenant_outcome(self, r: _Request, err: bool) -> None:
        """One finished request's outcome into its tenant's breaker: a
        closed breaker opens once the windowed error rate reaches the
        threshold (with ``breaker_min_requests`` in the window); only the
        half-open probe's outcome closes or re-opens it."""
        ts = r.tstate
        if ts is None:
            return
        with ts.lock:
            if err:
                ts.errors += 1
            if ts.br_window is None:
                return
            st = ts.br_state
            if st == _BR_HALF_OPEN:
                if not r.probe:
                    return                # a stale pre-open request
                if err:
                    ts.br_state = _BR_OPEN
                    ts.br_opened_at = time.perf_counter()
                else:
                    ts.br_state = _BR_CLOSED
                    ts._br_reset()
                ts.br_probe_inflight = False
                return
            if st == _BR_OPEN:
                return
            ts._br_push(err)
            w = ts.br_window
            if (err and len(w) >= self.breaker_min_requests
                    and ts.br_errors >= self.breaker_threshold * len(w)):
                ts.br_state = _BR_OPEN
                ts.br_opened_at = time.perf_counter()

    # ------------------------------------------------------------ intake
    def queue_depth(self) -> int:
        """Requests backlogged ahead of the batcher: in the submission
        queue or parked in a lane."""
        return (self._inq.qsize() + len(self._lane_high)
                + len(self._lane_normal))

    def _decode_request(self, samples, max_tokens):
        """(prompt, max_tokens) for a submit: a bare 1-D int sequence,
        ``[prompt]``, or the ``[(prompt,)]`` sample-tuple form; raises
        ValueError on anything else."""
        if isinstance(samples, np.ndarray) and samples.ndim == 1:
            seqs = [samples]
        else:
            seqs = list(samples)
            if seqs and isinstance(seqs[0], (int, np.integer)):
                seqs = [seqs]             # a bare token-id list
        if len(seqs) != 1:
            raise ValueError(
                "decode requests carry exactly ONE sequence per "
                "submit(); split multi-prompt requests client-side")
        s = seqs[0]
        if (isinstance(s, (tuple, list)) and len(s) == 1
                and isinstance(s[0], (tuple, list, np.ndarray))):
            s = s[0]                      # (prompt,) sample-tuple form
        prompt = np.asarray(s, np.int32).reshape(-1)
        plen = len(prompt)
        mt = (int(max_tokens) if max_tokens is not None
              else self.default_max_tokens)
        if mt < 1:
            raise ValueError("decode submit needs max_tokens >= 1 (or the "
                             "engine's default_max_tokens)")
        if plen < 1:
            raise ValueError("empty prompt")
        vocab = self._decoder.model.vocab
        if prompt.min() < 0 or prompt.max() >= vocab:
            raise ValueError(f"token ids must lie in [0, {vocab})")
        if plen + mt > self._decoder.max_len:
            raise ValueError(
                f"prompt ({plen}) + max_tokens ({mt}) exceeds the "
                f"decoder's max_len {self._decoder.max_len}; shorten "
                f"one of them")
        return prompt, mt

    def _decode_sampling(self, temperature, top_k, top_p, seed):
        """Validated (temperature, top_k, top_p, seed), or None when every
        knob is absent (greedy).  A decoder without sampling refuses the
        knobs with a typed ValueError."""
        if (temperature is None and top_k is None and top_p is None
                and seed is None):
            return None
        if not getattr(self._decoder, "sampling", False):
            raise ValueError(
                "temperature/top_k/top_p/seed need a sampling-enabled "
                "decoder (construct with PagedDecoder(..., "
                "sampling=True)); this decoder picks greedily")
        # a knob without a temperature means "sample at 1.0";
        # temperature=0 pins greedy
        temp = float(temperature) if temperature is not None else 1.0
        if not temp >= 0.0:               # also catches NaN
            raise ValueError(
                f"temperature must be >= 0, got {temperature!r}")
        tk = int(top_k) if top_k is not None else 0
        if tk < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k!r}")
        tp = float(top_p) if top_p is not None else 0.0
        if not 0.0 <= tp <= 1.0:
            raise ValueError(f"top_p must be in [0, 1], got {top_p!r}")
        sd = int(seed) if seed is not None else 0
        return (temp, tk, tp, sd)

    def submit(self, samples, *, deadline_us: Optional[float] = None,
               lane: str = "normal", tenant: Optional[str] = None,
               max_tokens: Optional[int] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               seed: Optional[int] = None,
               version: Optional[str] = None,
               trace=None) -> Future:
        """Enqueue one prompt.  The Future resolves to the generated token
        ids (1-D int32, EOS included when emitted) or fails with a typed
        ``ServingError`` (``ValueError`` for a malformed request).

        ``deadline_us`` (default ``default_deadline_us``; <= 0: none)
        covers the whole generation.  ``lane``: ``"normal"`` or
        ``"high"``.  ``tenant`` names the unit of fair queuing, quotas and
        the breaker (untagged traffic rides ``"default"``).  Under
        overload the Future fails at once with ``Overloaded`` (an open
        breaker: ``BreakerOpen``).  ``temperature`` / ``top_k`` /
        ``top_p`` / ``seed`` sample on a ``sampling=True`` decoder; the
        stream is deterministic in (seed, position)."""
        if version is not None:
            raise NotImplementedError(
                f"submit(version=...) is not ported to paddle_tpu_torch "
                f"yet: {_VERSIONS}")
        if trace is not None:
            raise NotImplementedError(
                "submit(trace=...) is not ported to paddle_tpu_torch yet: "
                "ROADMAP.md §1 item 13 (tracing)")
        fut: Future = Future()
        try:
            prompt, cost = self._decode_request(samples, max_tokens)
            sampling = self._decode_sampling(temperature, top_k, top_p,
                                             seed)
        except (ValueError, TypeError) as e:
            fut.set_exception(e)
            self._count_error()
            return fut
        if lane not in LANES:
            fut.set_exception(ValueError(
                f"lane must be one of {LANES}, got {lane!r}"))
            self._count_error()
            return fut
        if not self._healthy:
            fut.set_exception(EngineUnhealthy(
                f"engine unhealthy: {self._health_reason}"))
            self._count_error()
            return fut
        # the admission gate, before the enqueue: a shed costs microseconds
        if self.max_queue_depth:
            depth = self.queue_depth()
            if self._gate_sheds(depth):
                retry = self._retry_after_s(depth)
                fut.set_exception(Overloaded(
                    f"queue full: depth {depth} >= max_queue_depth "
                    f"{self.max_queue_depth} (retry after ~{retry}s)",
                    retry_after_s=retry))
                self._count_shed("queue_full")
                return fut
        # tenant ids are untrusted input: coerced to str, capped in number
        tenant = str(tenant) if tenant else DEFAULT_TENANT
        ts = self._tenants.get(tenant)
        if ts is None:
            ts = self._tenant(tenant)
            tenant = ts.name              # cap overflow maps to default
        t = time.perf_counter()
        probe = False
        # the breaker first, then the per-tenant quota
        if ts.br_state != _BR_CLOSED and self.breaker_window:
            with ts.lock:
                wait_s, probe = self._breaker_sheds(ts, t)
            if wait_s is not None:
                fut.set_exception(BreakerOpen(
                    f"tenant {tenant!r} breaker open: recent error rate "
                    f">= {self.breaker_threshold:g} (retry after "
                    f"~{round(wait_s, 3)}s)", retry_after_s=wait_s))
                with ts.lock:
                    ts.shed += 1
                self._count_shed("breaker_open")
                return fut
        if self.tenant_cap:
            with ts.lock:
                depth_t = ts.depth
                if ts.shedding:
                    if depth_t <= self._tenant_resume:
                        ts.shedding = False
                elif depth_t >= self.tenant_cap:
                    ts.shedding = True
                shed_t = ts.shedding
                if shed_t:
                    ts.shed += 1
                    if probe:
                        # the half-open probe never ran: release it
                        ts.br_probe_inflight = False
            if shed_t:
                retry = self._retry_after_s(depth_t)
                fut.set_exception(Overloaded(
                    f"tenant {tenant!r} over quota: depth {depth_t} >= "
                    f"max_queue_depth_per_tenant {self.tenant_cap} "
                    f"(retry after ~{retry}s)",
                    retry_after_s=retry, reason="tenant_quota"))
                self._count_shed("tenant_quota")
                return fut
        if deadline_us is None:
            ds = self._default_deadline_s
            deadline = t + ds if ds is not None else None
        elif deadline_us > 0:
            deadline = t + deadline_us / 1e6
        else:
            deadline = None
        req = _Request(prompt, cost, fut, t, deadline, lane, tenant, ts,
                       probe=probe, sampling=sampling)
        with ts.lock:
            ts.depth += 1
            ts.requests += 1
        # weak: a strong ref would close a future <-> request cycle
        fut._ptt_request = weakref.ref(req)
        with self._close_lock:
            closed = self._closed
            if not closed:
                self._inq.put(req)
        if closed and self._resolve(req, exc=EngineClosed(
                "engine is closed")):
            self._count_error()
        return fut

    def infer(self, samples, timeout: Optional[float] = None, *,
              deadline_us: Optional[float] = None, lane: str = "normal",
              tenant: Optional[str] = None,
              max_tokens: Optional[int] = None,
              temperature: Optional[float] = None,
              top_k: Optional[int] = None,
              top_p: Optional[float] = None,
              seed: Optional[int] = None):
        """submit + wait.  On a wait timeout the request is cancelled
        (shed ``"abandoned"``), so an abandoned caller never keeps its KV
        slot."""
        fut = self.submit(samples, deadline_us=deadline_us, lane=lane,
                          tenant=tenant, max_tokens=max_tokens,
                          temperature=temperature, top_k=top_k,
                          top_p=top_p, seed=seed)
        try:
            return fut.result(timeout)
        except FutureTimeout:
            self.cancel(fut)
            raise

    def cancel(self, fut: Future) -> bool:
        """Mark a submitted request abandoned: the batcher fails it with
        ``DeadlineExceeded`` (shed ``"abandoned"``) at its next turn and
        frees its slot.  False when the future already resolved or did not
        come from ``submit``."""
        ref = getattr(fut, "_ptt_request", None)
        req = ref() if ref is not None else None
        if req is None or fut.done():
            return False
        req.abandoned = True
        return True

    # ------------------------------------------------------- accounting
    def _count_error(self, n: int = 1) -> None:
        with self._err_lock:
            self.session["errors"] += n

    def _count_shed(self, reason: str, n: int = 1) -> None:
        with self._err_lock:
            self.session["shed"][reason] += n

    def _note_done(self, t_done: float, n: int) -> None:
        """A delivery into the rolling requests/s behind ``retry_after_s``
        (call under ``_stats_lock``)."""
        log = self._done_log
        log.append((t_done, n))
        span = t_done - log[0][0]
        if span > 0:
            self._rps = sum(m for _, m in log) / span

    def _retry_after_s(self, depth: int) -> float:
        """Backlog drain estimate from the recent completion rate: the
        Retry-After a 429 advertises."""
        rps = self._rps
        est = depth / rps if rps > 0 else 1.0
        return round(min(30.0, max(0.05, est)), 3)

    def _gate_sheds(self, depth: int) -> bool:
        """The hysteresis state machine shared by submit() and health():
        start shedding at max_queue_depth, keep shedding until the backlog
        drains to the resume watermark."""
        if not self.max_queue_depth:
            return False
        if self._shedding:
            if depth <= self._resume_depth:
                self._shedding = False
        elif depth >= self.max_queue_depth:
            self._shedding = True
        return self._shedding

    @staticmethod
    def _resolve(r: _Request, value=None, exc: Exception = None) -> bool:
        """Resolve a request's future exactly once, retiring it from its
        tenant's depth at the same point; False when another path got
        there first."""
        try:
            if exc is not None:
                r.future.set_exception(exc)
            else:
                r.future.set_result(value)
        except InvalidStateError:
            return False
        finally:
            r.prompt = None
        ts = r.tstate
        if ts is not None:
            with ts.lock:
                ts.depth -= 1
        return True

    def _fail(self, r: _Request, exc: Exception, reason: str) -> None:
        if self._resolve(r, exc=exc):
            self._count_shed(reason)

    def _abort_exc(self, drain_msg: str = "engine closed before "
                                          "admission") -> tuple:
        """(exception, shed reason) for why ``_abort`` was raised: an
        unhealthy engine sheds ``EngineUnhealthy`` / ``thread_death``, a
        healthy close ``EngineClosed`` / ``drain``."""
        if not self._healthy:
            return (EngineUnhealthy(
                f"engine unhealthy: {self._health_reason}"), "thread_death")
        return EngineClosed(drain_msg), "drain"

    def _reap(self, r: _Request) -> bool:
        """Pop-time shed check: True when the request is dead (deadline
        passed, caller gone) and its future failed."""
        if r.abandoned:
            self._fail(r, DeadlineExceeded(
                "request abandoned (caller timed out before admission)"),
                "abandoned")
            return True
        if r.deadline is not None and time.perf_counter() > r.deadline:
            self._fail(r, DeadlineExceeded(
                "deadline exceeded before admission"), "deadline")
            return True
        return False

    def _lane_put(self, item) -> None:
        if item is None:                  # close() sentinel
            self._stopping = True
            return
        (self._lane_high if item.lane == "high"
         else self._lane_normal).append(item)

    def _pump(self) -> None:
        """Move everything in the submission queue into the lanes (the
        batcher is its only consumer)."""
        q = self._inq
        while q.qsize():
            try:
                item = q.get_nowait()
            except queue.Empty:
                return
            self._lane_put(item)

    def _lane_pop(self) -> Optional[_Request]:
        """Strict-priority pop with an anti-starvation credit: after
        ``starvation_limit`` high pops while normal traffic waited, one
        normal request is popped anyway (counted).  Within a lane, DRR
        over tenants.  Dead requests are reaped here."""
        while True:
            hi, no = self._lane_high, self._lane_normal
            if (hi.n and no.n and self.starvation_limit > 0
                    and self._lane_credit >= self.starvation_limit):
                r = no.popleft()
                if r is None:
                    continue
                self._lane_credit = 0
                with self._err_lock:
                    self.session["lane_credit_pops"] += 1
            elif hi.n:
                r = hi.popleft()
                if r is None:
                    continue
                if no.n:
                    self._lane_credit += 1
            elif no.n:
                r = no.popleft()
                if r is None:
                    continue
                self._lane_credit = 0
            else:
                return None
            if not self._reap(r):
                return r

    # ------------------------------------------------- slot bookkeeping
    def _slot_free(self, holder: dict, slot: int, reason: str) -> None:
        """The one slot-free path: every exit (finish, shed, deadline,
        fault) releases the sequence's KV blocks."""
        holder.pop(slot, None)
        if self._paged:
            try:
                self._decoder.release_sequence(slot)
            except Exception:             # noqa: BLE001 - best effort
                pass
        try:
            self._slot_alloc.free(slot)
        except ValueError:                # already freed
            return
        self.session["slot_frees"] += 1

    def _batch_fault(self, holders, e: Exception) -> None:
        """A fault in a forward or a prefill: the caches every resident
        lives in are suspect - fail them all (never attributed to a
        tenant's breaker), re-zero the caches, keep serving."""
        n = 0
        for holder in holders:
            for slot, s in list(holder.items()):
                if self._resolve(s.req, exc=e):
                    n += 1
                self._slot_free(holder, slot, "error")
        self._count_error(n)
        try:
            self._decoder.reset()
        except Exception:                 # noqa: BLE001 - best effort
            pass
        self._inflight = ()

    def _abort_residents(self, holders) -> None:
        exc, reason = self._abort_exc()
        for holder in holders:
            for slot, s in list(holder.items()):
                self._fail(s.req, exc, reason)
                self._slot_free(holder, slot, "drain")
        self._inflight = ()
        self._fail_pending(exc, reason)

    def _reap_residents(self, holder: dict, now: float) -> None:
        """Iteration-granular reaping: a deadline that passes or a caller
        that gives up mid-generation frees the slot now."""
        for slot, s in list(holder.items()):
            r = s.req
            generated = len(s.out) if isinstance(s, _DecodeSeq) else 0
            if r.abandoned:
                if self._resolve(r, exc=DeadlineExceeded(
                        "request abandoned mid-generation (caller timed "
                        "out)")):
                    self._count_shed("abandoned")
                self._slot_free(holder, slot, "abandoned")
            elif r.deadline is not None and now > r.deadline:
                exc = DeadlineExceeded(
                    f"deadline exceeded after {generated} of {r.cost} "
                    f"tokens (partial output discarded)")
                exc.generated = generated
                if self._resolve(r, exc=exc):
                    self._count_shed("deadline")
                self._slot_free(holder, slot, "deadline")

    def _admit_all(self, busy: bool, admit) -> None:
        """Admission: continuous joins whenever a slot is free; static
        refills only once the whole batch drained."""
        alloc = self._slot_alloc
        if self.decode_policy == "continuous" or not busy:
            while len(alloc) < alloc.n:
                r = self._lane_pop()
                if r is None:
                    break
                admit(r)

    def _idle(self) -> bool:
        """Nothing resident: block for work.  True when the loop should
        exit (stopping and drained)."""
        if self._stopping:
            return not self.queue_depth()
        self._lane_put(self._inq.get())
        return False

    def _first_token(self, active, r: _Request, slot: int, first: int,
                     t_first: float) -> None:
        with self._stats_lock:
            self._ttft_us.append((t_first - r.t_submit) * 1e6)
        seq = _DecodeSeq(r, slot, len(r.prompt), int(first))
        active[slot] = seq
        # the first token can already finish the sequence
        if (self.eos_id is not None and int(first) == self.eos_id) \
                or r.cost <= 1:
            self._decode_finish(active, slot, seq, t_first)

    def _advance(self, active, nxt, t_done: float) -> None:
        for slot, seq in list(active.items()):
            tok = int(nxt[slot])
            seq.out.append(tok)
            seq.pos += 1
            seq.last = tok
            if (self.eos_id is not None and tok == self.eos_id) \
                    or len(seq.out) >= seq.req.cost:
                self._decode_finish(active, slot, seq, t_done)

    def _decode_finish(self, active, slot: int, seq: _DecodeSeq,
                       t_done: float) -> None:
        """Retire one finished sequence: resolve its future, free its
        slot, refund the WFQ deficit an early finish left unused."""
        r = seq.req
        delivered = self._resolve(r, np.asarray(seq.out, np.int32))
        self._slot_free(active, slot, "finished")
        sess = self.session
        sess["requests"] += 1
        sess["rows"] += 1
        if delivered:
            if r.deadline is None or t_done <= r.deadline:
                sess["goodput"] += 1
                r.tstate.goodput += 1
            self._tenant_outcome(r, False)
        lane = self._lane_high if r.lane == "high" else self._lane_normal
        lane.credit(r.tenant, r.cost - len(seq.out))
        with self._stats_lock:
            v = (t_done - r.t_submit) * 1e6
            self._lat_us.append(v)
            r.tstate.lat_us.append(v)
            self._note_done(t_done, 1)

    def _request_fault(self, holder, slot, r: _Request,
                       e: ValueError) -> None:
        """A decoder's ValueError before execution (the caches untouched):
        the request's own fault, counted against its tenant's breaker."""
        if self._resolve(r, exc=e):
            self._count_error()
            self._tenant_outcome(r, True)
        self._slot_free(holder, slot, "error")

    # ----------------------------------------------------- slab scheduler
    def _decode_loop(self) -> None:
        """Batcher-thread body over a ``SlotDecoder``: iteration-level
        scheduler turns until close() drained everything.  A scheduler bug
        fails the residents, re-zeroes the caches, and the loop keeps
        serving."""
        active: Dict[int, _DecodeSeq] = {}
        while True:
            try:
                if self._decode_iteration(active):
                    return
            except Exception as e:        # noqa: BLE001 - last resort
                self._batch_fault((active,), e)

    def _decode_iteration(self, active: Dict[int, _DecodeSeq]) -> bool:
        """One scheduler turn: intake, reap, admit (one prefill each),
        ONE decode step over the resident set, retire.  True when the loop
        should exit."""
        dec = self._decoder
        alloc = self._slot_alloc
        self._pump()
        if self._abort:
            self._abort_residents((active,))
            return True
        self._reap_residents(active, time.perf_counter())
        self._admit_all(bool(active), lambda r: self._decode_admit(active, r))
        self._inflight = tuple(seq.req for seq in active.values())
        if not active:
            return self._idle()
        m = alloc.highwater
        tokens = np.zeros(m, np.int32)
        pos = np.zeros(m, np.int32)
        for slot, seq in active.items():
            tokens[slot] = seq.last
            pos[slot] = seq.pos
        try:
            nxt = dec.step(m, tokens, pos)
        except Exception as e:            # noqa: BLE001 - a batch fault
            self._batch_fault((active,), e)
            return False
        t_done = time.perf_counter()
        n_active = len(active)
        sess = self.session
        sess["iterations"] += 1
        sess["tokens"] += n_active
        sess["slot_steps"] += _bucket_rows(m, dec.step_buckets)
        # each resident owns a whole [max_len] slab row
        sess["kv_cells_live"] += sum(s.pos for s in active.values())
        sess["kv_cells_alloc"] += n_active * dec.max_len
        self._advance(active, nxt, t_done)
        self._inflight = tuple(seq.req for seq in active.values())
        return False

    def _decode_admit(self, active: Dict[int, _DecodeSeq],
                      r: _Request) -> None:
        """Prefill one admitted request into a free slot.  A prefill that
        fails in execution leaves every resident's cache suspect: a batch
        fault (the admitting request and the residents fail, the caches
        re-zero).  The decoder's ValueErrors come before execution and
        stay the request's own."""
        slot = self._slot_alloc.alloc()
        self.session["slot_allocs"] += 1
        try:
            first = self._decoder.prefill(slot, r.prompt)
        except ValueError as e:
            self._request_fault(active, slot, r, e)
            return
        except Exception as e:            # noqa: BLE001 - a batch fault
            n = self._resolve(r, exc=e)
            self._slot_free(active, slot, "error")
            self._count_error(n)
            self._batch_fault((active,), e)
            return
        self._first_token(active, r, slot, first, time.perf_counter())

    # ---------------------------------------------------- paged scheduler
    def _paged_loop(self) -> None:
        """Batcher-thread body over a ``PagedDecoder``: the slab loop's
        scheduler with block-grain allocation, mixed iterations and the
        prefix cache."""
        active: Dict[int, _DecodeSeq] = {}
        joins: Dict[int, _PagedJoin] = {}
        while True:
            try:
                if self._paged_iteration(active, joins):
                    return
            except Exception as e:        # noqa: BLE001 - last resort
                self._batch_fault((active, joins), e)

    def _shed_kv(self, holder: dict, slot: int, req: _Request,
                 generated: int) -> None:
        """Shed ONE sequence on pool exhaustion; its blocks free now, so
        co-residents keep decoding."""
        dec = self._decoder
        retry = self._retry_after_s(self.queue_depth())
        exc = Overloaded(
            f"kv block pool exhausted: {dec.blocks.used} of "
            f"{dec.blocks.capacity} blocks hold live sequences (retry "
            f"after ~{retry}s)", retry_after_s=retry, reason="kv_blocks")
        if generated:
            exc.generated = generated
        if self._resolve(req, exc=exc):
            self._count_shed("kv_blocks")
            with req.tstate.lock:
                req.tstate.shed += 1
        self._slot_free(holder, slot, "kv_blocks")

    def _paged_admit(self, active, joins, r: _Request) -> None:
        """Admit one request: take a slot, arm its block-table row (prefix
        cache consulted; a mid-block match copies one block), and queue it
        as a join."""
        slot = self._slot_alloc.alloc()
        self.session["slot_allocs"] += 1
        try:
            matched = self._decoder.alloc_sequence(slot, r.prompt)
        except KVPoolExhausted:
            self._shed_kv(joins, slot, r, 0)
            return
        except ValueError as e:
            self._request_fault(joins, slot, r, e)
            return
        except Exception as e:            # noqa: BLE001 - a batch fault
            self._slot_free(joins, slot, "error")
            self._count_error(1 if self._resolve(r, exc=e) else 0)
            self._batch_fault((active, joins), e)
            return
        if matched:
            sess = self.session
            sess["prefix_hits"] += 1
            sess["prefix_blocks_shared"] += -(-matched
                                              // self._decoder.block_size)
        joins[slot] = _PagedJoin(r, slot, matched)

    def _paged_iteration(self, active, joins) -> bool:
        """One paged turn: intake, reap, admit, grow block lists, then ONE
        mixed dispatch.  True when the loop should exit."""
        dec = self._decoder
        alloc = self._slot_alloc
        self._pump()
        if self._abort:
            self._abort_residents((active, joins))
            return True
        now = time.perf_counter()
        self._reap_residents(active, now)
        self._reap_residents(joins, now)
        self._admit_all(bool(active or joins),
                        lambda r: self._paged_admit(active, joins, r))
        self._inflight = (tuple(s.req for s in active.values())
                          + tuple(j.req for j in joins.values()))
        if not active and not joins:
            return self._idle()
        # grow resident block lists for this iteration's writes; a dry
        # pool sheds THAT sequence, co-residents keep decoding
        for slot, seq in list(active.items()):
            try:
                dec.ensure_blocks(slot, seq.pos)
            except KVPoolExhausted:
                self._shed_kv(active, slot, seq.req, len(seq.out))
        chunk = cj = None
        if joins:
            cj = joins[next(iter(joins))]     # FIFO: insertion order
            plen = len(cj.req.prompt)
            clen = min(plen - cj.written, dec.prefill_buckets[-1])
            try:
                dec.ensure_blocks(cj.slot, cj.written + clen - 1)
            except KVPoolExhausted:
                self._shed_kv(joins, cj.slot, cj.req, 0)
                cj = None
            else:
                chunk = (cj.slot,
                         cj.req.prompt[cj.written:cj.written + clen],
                         cj.written)
        if not active and chunk is None:
            return False                      # everything shed this turn
        m = alloc.highwater
        tokens = np.zeros(m, np.int32)
        pos = np.zeros(m, np.int32)
        live = np.zeros(m, bool)
        sample_rows = sample_chunk = None
        if getattr(dec, "sampling", False):
            sample_rows = (np.zeros(m, np.float32), np.zeros(m, np.int32),
                           np.zeros(m, np.float32), np.zeros(m, np.int32))
            if cj is not None:
                sample_chunk = cj.req.sampling
        for slot, seq in active.items():
            tokens[slot] = seq.last
            pos[slot] = seq.pos
            live[slot] = True
            if sample_rows is not None and seq.req.sampling is not None:
                for arr, v in zip(sample_rows, seq.req.sampling):
                    arr[slot] = v
        try:
            nxt, cnxt = dec.mixed_step(m, tokens, pos, live=live,
                                       chunk=chunk, sample_rows=sample_rows,
                                       sample_chunk=sample_chunk)
        except Exception as e:                # noqa: BLE001 - a batch fault
            self._batch_fault((active, joins), e)
            return False
        t_done = time.perf_counter()
        n_active = len(active)
        sess = self.session
        sess["iterations"] += 1
        sess["tokens"] += n_active
        sess["slot_steps"] += _bucket_rows(max(m, 1), dec.step_buckets)
        # live positions against block-grain reservation
        sess["kv_cells_live"] += (sum(s.pos for s in active.values())
                                  + sum(j.written for j in joins.values()))
        sess["kv_cells_alloc"] += dec.blocks.used * dec.block_size
        self._advance(active, nxt, t_done)
        if cj is not None:
            cj.written += len(chunk[1])
            if cj.written >= len(cj.req.prompt):
                # prompt complete: cnxt is the first generated token
                joins.pop(cj.slot, None)
                dec.register_prefix(cj.slot)
                self._first_token(active, cj.req, cj.slot, cnxt,
                                  time.perf_counter())
        self._inflight = (tuple(s.req for s in active.values())
                          + tuple(j.req for j in joins.values()))
        return False

    # ----------------------------------------------------------- watchdog
    def _watchdog_loop(self) -> None:
        """A dead batcher (a BaseException escaping a forward) must not
        strand callers: mark the engine unhealthy, fail everything in
        flight with the typed error, refuse new work."""
        while not self._watchdog_stop.wait(self.watchdog_interval_s):
            if self._closed:
                return
            if self._batcher.is_alive():
                continue
            if self._closed:
                return                    # a clean close() raced the probe
            self._healthy = False
            self._health_reason = "batcher thread died"
            self._abort = True
            with self._close_lock:
                self._closed = True
            self._fail_pending(EngineUnhealthy(
                "engine unhealthy: batcher thread died; in-flight request "
                "failed"), "thread_death")
            return

    def _fail_pending(self, exc: Exception, reason: str) -> None:
        """Fail every request not yet resolved: the residents, both lanes
        and the submission queue."""
        for r in self._inflight:
            self._fail(r, exc, reason)
        self._inflight = ()
        for lane in (self._lane_high, self._lane_normal):
            for r in lane.drain():
                self._fail(r, exc, reason)
        while True:
            try:
                item = self._inq.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                self._fail(item, exc, reason)

    # -------------------------------------------------------------- stats
    @property
    def healthy(self) -> bool:
        return self._healthy

    def health(self) -> tuple:
        """(http_status, state): ``200 "ok"``; ``503 "overloaded"`` while
        the admission gate sheds, ``"closed"`` after ``close()``,
        ``"dead"`` once the batcher died."""
        if not self._healthy:
            return 503, "dead"
        if self._closed:
            return 503, "closed"
        if not self._batcher.is_alive():
            return 503, "dead"
        if self._gate_sheds(self.queue_depth()):
            return 503, "overloaded"
        return 200, "ok"

    def _healthz(self):
        code, state = self.health()
        detail = f": {self._health_reason}" if state == "dead" else ""
        return code, f"{state}{detail}\n"

    def tenant_stats(self) -> dict:
        """Per tenant: weight, depth and quota state, breaker state,
        admitted / goodput / shed / error counts, rolling p50 / p99."""
        out = {}
        with self._tenant_make_lock:
            tenants = sorted(self._tenants.items())
        for name, ts in tenants:
            with self._stats_lock:
                lat = sorted(ts.lat_us)
            with ts.lock:
                rec = {"weight": ts.weight, "depth": ts.depth,
                       "shedding": ts.shedding, "breaker": ts.br_state,
                       "requests": ts.requests, "goodput": ts.goodput,
                       "shed": ts.shed, "errors": ts.errors}
            rec["request_us_p50"] = round(_pctile(lat, 0.50), 1)
            rec["request_us_p99"] = round(_pctile(lat, 0.99), 1)
            out[name] = rec
        return out

    def stats(self) -> dict:
        """The JAX decode engine's ``stats()`` less the unported features'
        keys.  ``snapshot_seq`` moves with resolved work and with every
        iteration, so a frozen value under a nonzero queue is a wedge."""
        with self._stats_lock:
            lat = sorted(self._lat_us)
            ttft = sorted(self._ttft_us)
        sess = self.session
        with self._err_lock:
            seq = (sess["errors"] + sum(sess["shed"].values())
                   + sess["iterations"])
            session = {k: (dict(v) if isinstance(v, dict) else v)
                       for k, v in sess.items()}
        depth = self.queue_depth()
        _, state = self.health()
        dec, alloc = self._decoder, self._slot_alloc
        it, toks, steps = (session["iterations"], session["tokens"],
                           session["slot_steps"])
        rec = {
            "snapshot_seq": seq,
            "uptime_s": round(time.perf_counter() - self._t_start, 3),
            "port": self._bound_port,
            "queue_depth": depth,
            "closed": self._closed,
            "health": state,
            "healthy": self._healthy,
            "health_reason": self._health_reason,
            "batcher_alive": self._batcher.is_alive(),
            "max_queue_depth": self.max_queue_depth,
            "shedding": self._shedding,
            "queue_saturation": (round(depth / self.max_queue_depth, 3)
                                 if self.max_queue_depth else 0.0),
            "lane_depth": {"high": len(self._lane_high),
                           "normal": len(self._lane_normal)},
            "tenant_weights": dict(self.tenant_weights),
            "max_queue_depth_per_tenant": self.tenant_cap,
            "tenants": self.tenant_stats(),
            "default_deadline_us": self.default_deadline_us,
            "request_us_p50": round(_pctile(lat, 0.50), 1),
            "request_us_p99": round(_pctile(lat, 0.99), 1),
            **session,
        }
        rec["decode"] = {
            "policy": self.decode_policy,
            "kernel": dec.decode_kernel,
            "max_slots": alloc.n,
            "slots_occupied": len(alloc),
            "occupancy": round(len(alloc) / alloc.n, 3),
            "eos_id": self.eos_id,
            "default_max_tokens": self.default_max_tokens,
            "max_len": dec.max_len,
            "step_buckets": list(dec.step_buckets),
            "prefill_buckets": list(dec.prefill_buckets),
            "iterations": it,
            "tokens": toks,
            "slot_allocs": session["slot_allocs"],
            "slot_frees": session["slot_frees"],
            "slot_steps": steps,
            "tokens_per_iteration": round(toks / it, 2) if it else 0.0,
            "slot_utilization_pct": (round(toks / steps * 100, 2)
                                     if steps else 0.0),
            "ttft_us_p50": round(_pctile(ttft, 0.50), 1),
            "ttft_us_p99": round(_pctile(ttft, 0.99), 1),
            "kv_utilization_pct": (round(session["kv_cells_live"]
                                         / session["kv_cells_alloc"] * 100,
                                         2)
                                   if session["kv_cells_alloc"] else 0.0),
        }
        if self._paged:
            pool = dec.pool_stats()
            rec["decode"].update({
                "paged": True,
                "block_size": pool["block_size"],
                "num_blocks": pool["num_blocks"],
                "blocks_used": pool["used"],
                "blocks_free": pool["free"],
                "blocks_cached": pool["cached"],
                "blocks_shared": pool["shared"],
                "pool_utilization_pct": pool["utilization_pct"],
                "cow_copies": pool["cow_copies"],
                "evictions": pool["evictions"],
                "prefix_hits": session["prefix_hits"],
                "prefix_blocks_shared": session["prefix_blocks_shared"],
            })
        return rec

    def kernel_stats(self) -> dict:
        """``GET /kernels``: the decoder's device and each kernel's launch
        count (``ops.launch_counts()``)."""
        return {"device": str(self._decoder.device),
                "decode_kernel": self._decoder.decode_kernel,
                "launches": ops.launch_counts()}

    # -------------------------------------------------------------- http
    def http_handlers(self) -> dict:
        """Path -> handler, each ``(method, body, headers) -> (status,
        content type, payload bytes[, headers])``: ``/infer`` (the module
        docstring's fields and headers), ``/stats``, ``/kernels``."""

        def reply(code, doc, headers=None):
            out = (code, "application/json", json.dumps(doc).encode())
            return out + (headers,) if headers else out

        def handle_infer(method: str, body: bytes, headers=None):
            headers = headers or {}
            if method != "POST":
                return 405, "text/plain", b"POST a JSON body\n"
            try:
                doc = json.loads(body or b"{}")
                samples = doc["input"]
                if not isinstance(samples, list):
                    raise ValueError("'input' must be a list of samples")
                lane = (doc.get("lane") or headers.get("X-Ptpu-Lane")
                        or "normal")
                tenant = (doc.get("tenant")
                          or headers.get("X-Ptpu-Tenant") or None)
                dl_ms = doc.get("deadline_ms",
                                headers.get("X-Ptpu-Deadline-Ms"))
                deadline_us = (float(dl_ms) * 1000.0
                               if dl_ms is not None else None)
                mt = doc.get("max_tokens", headers.get("X-Ptpu-Max-Tokens"))
                max_tokens = int(mt) if mt is not None else None
                # sampling knobs ride the body only; submit() validates
                knobs = {}
                for name, cast in (("temperature", float), ("top_k", int),
                                   ("top_p", float), ("seed", int)):
                    v = doc.get(name)
                    knobs[name] = cast(v) if v is not None else None
                pinned = (doc.get("model_version")
                          or headers.get("X-Ptpu-Model-Version"))
            except Exception as e:            # noqa: BLE001
                return reply(400, {"error": f"bad request: {e}"})
            if pinned:
                return reply(501, {"error": f"model_version pins are not "
                                            f"ported: {_VERSIONS}"})
            fut = None
            try:
                fut = self.submit(samples, deadline_us=deadline_us,
                                  lane=lane, tenant=tenant,
                                  max_tokens=max_tokens, **knobs)
                result = fut.result(timeout=self.http_timeout_s)
            except Overloaded as e:
                # tell retry policies WHEN, and which gate fired
                retry = max(1, int(math.ceil(e.retry_after_s)))
                return reply(429, {"error": "overloaded",
                                   "reason": e.reason,
                                   "retry_after_s": e.retry_after_s},
                             {"Retry-After": str(retry)})
            except DeadlineExceeded as e:
                out = {"error": repr(e)}
                if getattr(e, "generated", None) is not None:
                    out["generated"] = int(e.generated)
                return reply(504, out)
            except FutureTimeout:
                if fut is not None:
                    self.cancel(fut)
                return reply(504, {"error": "inference timed out"})
            except (EngineClosed, EngineUnhealthy) as e:
                return reply(503, {"error": repr(e)})
            except ValueError as e:
                return reply(400, {"error": repr(e)})
            except Exception as e:            # noqa: BLE001 - server fault
                # a 4xx would teach retry policies not to retry
                return reply(500, {"error": repr(e)})
            return reply(200, {"outputs": {"tokens": result.tolist()},
                               "generated": int(len(result))})

        def handle_stats(method: str, body: bytes, headers=None):
            return reply(200, self.stats())

        def handle_kernels(method: str, body: bytes, headers=None):
            return reply(200, self.kernel_stats())

        return {"/infer": handle_infer, "/stats": handle_stats,
                "/kernels": handle_kernels}

    def serve(self, port: int, host: str = "127.0.0.1"):
        """Serve ``/infer``, ``/stats``, ``/kernels`` and ``/healthz`` from
        a stdlib threading HTTP server on a daemon thread (loopback by
        default).  Returns the server; ``close()`` shuts it down."""
        handlers = self.http_handlers()
        engine = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code, ctype, payload: bytes, headers=None):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(payload)

            def _route(self, method, body=b""):
                path = self.path.split("?", 1)[0]
                if method == "GET" and path == "/healthz":
                    code, text = engine._healthz()
                    self._send(code, "text/plain", text.encode())
                    return
                fn = handlers.get(path)
                if fn is None:
                    self._send(404, "application/json", json.dumps(
                        {"error": f"no route {path}"}).encode())
                    return
                self._send(*fn(method, body, self.headers))

            def do_GET(self):
                self._route("GET")

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                self._route("POST", self.rfile.read(n))

            def log_message(self, *args):
                pass

        server = _HTTPServer((host, port), Handler)
        threading.Thread(target=server.serve_forever, name="ptt-http",
                         daemon=True).start()
        self._server = server
        self._bound_port = server.server_address[1]
        return server

    # ----------------------------------------------------------- shutdown
    def close(self, drain_timeout_s: Optional[float] = 30.0) -> None:
        """Stop accepting requests and finish what is queued or resident.
        Work still unfinished after ``drain_timeout_s`` is shed
        (``EngineClosed``, reason ``"drain"``) instead of hanging the
        caller.  Shuts the HTTP server down.  Idempotent."""
        with self._close_lock:
            already, self._closed = self._closed, True
            if not already:
                self._inq.put(None)           # the batcher's drain sentinel
        self._watchdog_stop.set()
        self._batcher.join(drain_timeout_s)
        if self._batcher.is_alive():
            # a wedged forward or an over-long backlog: shed the rest (a
            # forward in flight finishes first and frees its slots)
            self._abort = True
            exc, reason = self._abort_exc(
                f"engine closed: drain timed out after {drain_timeout_s}s")
            self._fail_pending(exc, reason)
        # a submit that raced the closed flag past the sentinel
        while True:
            try:
                r = self._inq.get_nowait()
            except queue.Empty:
                break
            if r is not None:
                self._fail(r, *self._abort_exc("engine closed"))
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    def __enter__(self) -> "InferenceEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
