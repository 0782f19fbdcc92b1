"""Serving engine (counterpart of ``paddle_tpu/serving/engine.py``'s
``InferenceEngine``): shape-bucketed micro-batches of whole forwards, or
continuous-batching decode over a ``SlotDecoder`` or a ``PagedDecoder``,
hardened for overload, shared by tenants, and serving model versions.

Whole forwards (``InferenceEngine(output_layer, parameters)`` or
``inference=``): ``submit`` returns a ``Future``; one batcher thread
coalesces queued requests (lists of v2 sample tuples) into micro-batches of
up to ``max_batch`` rows, or until the oldest has waited ``max_wait_us``
(times the overload wait scale), pads the rows up to a ``batch_buckets``
bucket by repeating the last sample and, with ``seq_buckets``, the sequence
axis up to a (rows, T) bucket, and launches ONE forward
(``Inference.run_feed``) without waiting for it; a delivery thread pays the
device-to-host copy and slices each request's rows out, so batch k's copy
overlaps the launch of batch k+1.  A request whose samples do not convert
fails alone; a forward fault fails that batch only.  A topology with a
scalar output (a cost) runs one request a batch, unpadded.

Decode (``InferenceEngine(decoder)``): with a ``SlotDecoder``
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

Overload is a designed state, in both modes:

  * admission control: with ``max_queue_depth`` set, ``submit`` fails the
    Future at once with ``Overloaded`` when the backlog reaches the cap,
    and keeps shedding until it drains to the ``hysteresis`` watermark;
  * per-request deadlines (``deadline_us`` or ``default_deadline_us``),
    reaped at pop and assembly time (whole forwards: dead work never
    takes a batch row) or every iteration (decode: they cover the whole
    generation);
  * two priority lanes (``"high"``, ``"normal"``): strict priority with an
    anti-starvation credit (``starvation_limit``);
  * tenants: inside each lane deficit round robin by ``tenant_weights``,
    charged in rows (whole forwards) or decode steps (a request's
    ``max_tokens``, refunded on an early EOS); per-tenant quotas
    (``max_queue_depth_per_tenant``, a fraction of the global cap or a
    count); a per-tenant error-rate breaker (``BreakerOpen``, a half-open
    probe to close);
  * the wait scale widens ``max_wait_us`` under backlog and narrows back;
    ``close(drain_timeout_s)`` sheds what cannot finish instead of
    hanging, and a watchdog fails every in-flight future with
    ``EngineUnhealthy`` when the batcher or the delivery thread dies.

Model versions: every request resolves against a version (``boot``, or
``model_version=``; ``install_version`` and ``serving.reload`` feed new
weights in).  Whole forwards resolve it at submit and never mix versions
in a batch, so in-flight requests finish on the weights they were
admitted against; the previous version stays resident (``rollback`` is a
pointer flip), ``canary_fraction`` routes a deterministic share of
untagged traffic to a new version first (an error-rate breach rolls it
back, ``canary_promote_requests`` healthy answers promote it), and
``submit(version=)`` pins ``"prev"`` or a resident id.  Decode serves one
weight set: a swap drains (admission pauses, residents finish on the old
weights), then swaps; a canary or a pin to another version is refused.

A ``PagedDecoder(sampling=True)`` serves seeded sampling
(``temperature``, ``top_k``, ``top_p``, ``seed``); requests without those
knobs decode greedily, bit-equal to a decoder without sampling.

``serve`` adds a stdlib HTTP front end on the JAX engine's wire format:
``POST /infer`` ``{"input": [...]}`` (decode: ``[prompt]`` and
``max_tokens``; optional ``lane``, ``tenant``, ``deadline_ms``,
``model_version``, ``temperature``, ``top_k``, ``top_p``, ``seed``;
headers ``X-Ptpu-Lane``, ``X-Ptpu-Tenant``, ``X-Ptpu-Deadline-Ms``,
``X-Ptpu-Model-Version``, ``X-Ptpu-Max-Tokens``) -> ``{"outputs": {name:
[...]}, "model_version": id}`` (decode adds ``"generated"``; 400 bad
request, 429 ``Overloaded`` with ``Retry-After`` and the shed reason, 504
deadline, 503 closed or dead, 500 server fault); ``POST /reload``
(``?rollback=1``, ``?promote=1``, a ``{"dir": ...}`` body, or the attached
watcher's check; HMAC-signed with ``reload_key``, else 403), ``GET
/healthz``, ``GET /stats`` and ``GET /kernels`` (each kernel's launch
count).  ``serving.client`` is the caller's half of the contract,
``serving.router`` the fleet's front.

``serve`` mounts these on ``observability.sinks.serve_metrics``, so one
server also answers ``/metrics`` (Prometheus text of the JAX engine's
``serving_*`` and ``serving_decode_*`` catalog), ``/metrics.json``,
``/executables`` (each decoder iteration kind and whole-forward bucket,
with its device time) and, with tracing on, ``/trace`` and
``/trace/<id>``.  Tracing (``trace_sample=``, ``telemetry_dir=``,
``submit(trace=)``) follows the JAX engine: an ``X-Ptpu-Trace`` header
is honoured or minted at ``/infer``, the engine's queue-wait, prefill
and decode spans go into the request's span buffer, and the tail-based
flight recorder keeps sampled and anomalous traces
(``<telemetry_dir>/flight-<pid>.jsonl``).  The locks are
``lockcheck.make_lock`` with the JAX engine's class names.

Not ported (each keyword raises ``NotImplementedError`` naming its
``ROADMAP.md`` item when set): mesh slices (item 8.5, with item 14), the
compile cache and ``prewarm`` (item 8.6, with item 13b).
"""

from __future__ import annotations

import heapq
import json
import math
import queue
import threading
import time
import urllib.parse
import weakref
from collections import deque
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch.inference import Inference, bucket_rows
from paddle_tpu_torch.observability import executables as _executables
from paddle_tpu_torch.observability import metrics as _metrics
from paddle_tpu_torch.observability import tracectx as _tracectx
from paddle_tpu_torch.serving.blocks import KVPoolExhausted
from paddle_tpu_torch.utils import lockcheck as _lockcheck

LANES = ("high", "normal")
SHED_REASONS = ("queue_full", "tenant_quota", "breaker_open", "deadline",
                "drain", "thread_death", "abandoned", "kv_blocks")
# weight-update outcomes: a version went live (install or promote), a
# candidate snapshot failed its checksums and the weights were not
# touched, the active or canary version was demoted
RELOAD_RESULTS = ("swapped", "verify_failed", "rolled_back")
# why a KV slot went back to the free list; "kv_blocks" = the paged
# decoder's block pool ran dry and the sequence was shed
SLOT_FREE_REASONS = ("finished", "deadline", "abandoned", "error",
                     "drain", "kv_blocks")
DEFAULT_TENANT = "default"

# The JAX engine's serving catalog (no-ops while telemetry is off; the
# mesh-slice pair waits for item 8.5).
_G_QUEUE = _metrics.gauge(
    "serving_queue_depth", "requests waiting for the batcher")
_G_LANE = {lane: _metrics.gauge(
    "serving_lane_depth",
    "requests waiting in one intake lane", lane=lane) for lane in LANES}
_C_REQS = _metrics.counter(
    "serving_requests_total", "requests accepted by submit()")
_C_ROWS = _metrics.counter(
    "serving_rows_total", "sample rows across accepted requests")
_C_ERRS = _metrics.counter(
    "serving_request_errors_total",
    "requests failed (bad feed, forward error, engine shutdown)")
_C_SHED = {reason: _metrics.counter(
    "serving_shed_total",
    "requests shed by overload protection, by reason",
    reason=reason) for reason in SHED_REASONS}
_C_GOODPUT = _metrics.counter(
    "serving_goodput_total",
    "requests completed within their deadline (or with none)")
_C_TENANT_OVERFLOW = _metrics.counter(
    "serving_tenant_overflow_total",
    "first-seen tenant ids past max_tenants collapsed onto the "
    "default record (untrusted-id cardinality cap)")
_C_CREDIT = _metrics.counter(
    "serving_lane_credit_pops_total",
    "normal-lane pops forced by the anti-starvation credit while the "
    "high lane was non-empty")
_C_BATCHES = _metrics.counter(
    "serving_batches_total", "micro-batches dispatched (one forward each)")
_H_BATCH = _metrics.histogram(
    "serving_batch_rows", "real rows per dispatched micro-batch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))
_H_WASTE = _metrics.histogram(
    "serving_padding_waste_pct",
    "pad rows as % of the bucket's rows, per micro-batch",
    buckets=(0, 1, 2, 5, 10, 15, 20, 30, 40, 50, 75, 100))
_H_REQ = _metrics.histogram(
    "serving_request_us",
    "end-to-end request latency: submit() to future resolution")
_H_SLACK = _metrics.histogram(
    "serving_deadline_slack_us",
    "deadline minus completion time for delivered requests that carried "
    "one (clamped at 0: a 0 observation is a late delivery)")
_G_P50 = _metrics.gauge(
    "serving_request_us_p50",
    "rolling p50 of serving_request_us (last 2048 requests)")
_G_P99 = _metrics.gauge(
    "serving_request_us_p99",
    "rolling p99 of serving_request_us (last 2048 requests)")
_G_WAIT_SCALE = _metrics.gauge(
    "serving_wait_scale",
    "current overload multiplier on max_wait_us (1.0 = nominal)")
_G_SLOTS = _metrics.gauge(
    "serving_decode_slots_occupied",
    "KV-cache slots holding a resident sequence (continuous-batching "
    "decode; sampled per iteration)")
_C_SLOT_ALLOC = _metrics.counter(
    "serving_decode_slot_allocs_total",
    "KV slots allocated — one per admitted sequence reaching prefill")
_C_SLOT_FREE = {reason: _metrics.counter(
    "serving_decode_slot_frees_total",
    "KV slots returned to the free list, by reason",
    reason=reason) for reason in SLOT_FREE_REASONS}
_C_ITER = _metrics.counter(
    "serving_decode_iterations_total",
    "decode iterations — one forward over the resident slot set each")
_C_TOKENS = _metrics.counter(
    "serving_decode_tokens_total",
    "tokens emitted for resident sequences (useful work per iteration)")
_H_TTFT = _metrics.histogram(
    "serving_decode_ttft_us",
    "time to first token: submit() to the prefill that emits it")
_H_STEP = _metrics.histogram(
    "serving_decode_step_us",
    "wall time of one decode iteration (step dispatch + host sync)")
# ---- paged KV (PagedDecoder)
_C_PREFIX_HITS = _metrics.counter(
    "serving_prefix_hits_total",
    "admitted sequences whose prompt prefix was served from the "
    "paged-KV prefix cache (>= 1 block skipped prefill)")
_C_PREFIX_SHARED = _metrics.counter(
    "serving_prefix_blocks_shared",
    "prompt KV blocks served from the prefix cache instead of "
    "recomputed (cumulative, across admitted sequences)")
_G_KV_BLOCKS = _metrics.gauge(
    "serving_kv_pool_blocks_used",
    "paged-KV pool blocks holding live (refcounted) sequence data; "
    "sampled per iteration")
_G_KV_UTIL = _metrics.gauge(
    "serving_kv_cache_utilization_pct",
    "live paged-KV blocks as % of pool capacity; sampled per "
    "iteration")
_C_RELOADS = {result: _metrics.counter(
    "serving_reloads_total",
    "zero-downtime weight-update outcomes, by result",
    result=result) for result in RELOAD_RESULTS}
_C_RELOAD_UNAUTH = _metrics.counter(
    "serving_reload_unauthorized_total",
    "POST /reload pushes refused for a missing or mismatched HMAC key "
    "(typed 403; --reload_key_file)")
_H_SWAP = _metrics.histogram(
    "serving_swap_pause_us",
    "hot-swap apply pause: the version-pointer flip for whole-forward "
    "engines, the resident-sequence drain wait for decode engines")


def _model_version_gauge(version: str):
    """Info gauge: 1 on the ACTIVE version's label, 0 on every other
    resident (prev/canary/retired) version — the fleet-visible 'what
    is this replica serving' signal."""
    return _metrics.gauge(
        "serving_model_version",
        "1 for the version currently serving untagged traffic, 0 for "
        "other resident versions", version=version)


def _tenant_depth_gauge(tenant: str):
    """Per-tenant backlog gauge, created lazily the first time a tenant
    appears (the registry is idempotent per label set)."""
    return _metrics.gauge(
        "serving_tenant_depth",
        "requests a tenant has admitted but not yet resolved "
        "(queued + in a dispatched batch)", tenant=tenant)



_MESH = "ROADMAP.md §1 item 14 (parallel; the serving part is item 8.5)"
_CACHE = ("ROADMAP.md §1 item 13b (the compile cache; the serving part, "
          "prewarm, is item 8.6)")
# keyword -> (its JAX default, the ROADMAP item that ports it)
_UNPORTED = {
    "mesh": (None, _MESH), "mesh_slices": (0, _MESH),
    "mesh_rules": (None, _MESH),
    "compile_cache_dir": (None, _CACHE),
}

# intake-queue wake token: install_version nudges an idle decode loop
# (blocked in the queue's get) to apply a pending swap
_WAKE = object()


def default_buckets(max_batch: int) -> tuple:
    """Powers of two from 2 up to (and always including) max_batch."""
    out = []
    b = 2
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


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
    __slots__ = ("prompt", "samples", "rows", "cost", "future", "t_submit",
                 "deadline", "lane", "tenant", "tstate", "probe",
                 "abandoned", "sampling", "version", "trace",
                 "__weakref__")

    def __init__(self, prompt, cost, future, t_submit, deadline, lane,
                 tenant, tstate, probe=False, sampling=None, samples=None,
                 rows=1, version=None, trace=None):
        self.prompt = prompt              # decode: the prompt's token ids
        self.samples = samples            # whole forwards: sample tuples
        self.rows = rows
        # the WFQ deficit charged at board time: rows (whole forwards) or
        # the decode-step budget, max_tokens (decode)
        self.cost = cost
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
        # the model version this request resolved against: at submit
        # (whole forwards) or at prefill (decode)
        self.version = version
        # distributed tracing: the request's tracectx.SpanBuffer, or None
        self.trace = trace


class _ModelVersion:
    """One resident weight set: ``values`` (``{layer: {param: tensor}}``
    on the engine's device), its state (active | prev | canary | resident
    | rolled_back), request and error counts, and the canary's breach
    window.  Mutated under the engine's ``_version_lock``."""

    __slots__ = ("id", "values", "state", "source", "requests", "errors",
                 "window", "win_errors")

    def __init__(self, vid: str, values, state: str = "resident",
                 source: str = "", window: int = 0):
        self.id = vid
        self.values = values
        self.state = state
        self.source = source              # snapshot dir ("" for boot)
        self.requests = 0
        self.errors = 0
        self.window: deque = deque(maxlen=window) if window else None
        self.win_errors = 0

    def push_outcome(self, err: bool) -> None:
        w = self.window
        if w is None:
            return
        if len(w) == w.maxlen and w[0]:
            self.win_errors -= 1
        w.append(err)
        if err:
            self.win_errors += 1


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

    __slots__ = ("req", "slot", "written", "t_pre0")

    def __init__(self, req, slot, matched):
        self.req, self.slot, self.written = req, slot, matched
        self.t_pre0 = 0       # its first chunk's start (a traced request)


_BR_CLOSED, _BR_OPEN, _BR_HALF_OPEN = "closed", "open", "half_open"


class _Tenant:
    """Per-tenant state: admitted depth (the quota gate), its hysteresis
    flag, the breaker's rolling window, and the ``tenant_stats`` mirrors.
    ``lock`` guards the cross-thread updates."""

    __slots__ = ("name", "weight", "lock", "depth", "shedding", "br_state",
                 "br_window", "br_errors", "br_opened_at",
                 "br_probe_inflight", "br_probe_at", "goodput", "requests",
                 "shed", "errors", "lat_us", "gauge")

    def __init__(self, name: str, weight: float, window: int):
        self.name = name
        self.gauge = _tenant_depth_gauge(name)
        self.weight = float(weight)
        self.lock = _lockcheck.make_lock("serving.engine.tenant")
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


class InferenceEngine:
    """``InferenceEngine(output_layer, parameters)`` (or ``inference=``)
    serves whole forwards; ``InferenceEngine(decoder)`` (a
    ``SlotDecoder`` or ``PagedDecoder``, positionally or as ``decoder=``)
    serves decode (module docstring); a whole-forward engine runs where
    its ``Inference`` does (the ``device`` option, else the card).
    ``eos_id`` ends a decoded sequence when emitted;
    ``default_max_tokens`` is the budget of a decode request that names
    none (0: every request must name one).  Close with ``close()``; also
    a context manager."""

    http_timeout_s = 300.0

    def __init__(self, output_layer=None, parameters=None, *,
                 inference: Optional[Inference] = None,
                 feeding: Optional[dict] = None,
                 max_batch: int = 32, max_wait_us: float = 2000.0,
                 batch_buckets: Optional[Sequence[int]] = None,
                 compile_cache_dir=None,
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
                 decoder=None,
                 trace_sample: Optional[float] = None,
                 telemetry_dir: Optional[str] = None,
                 decode_policy: str = "continuous",
                 eos_id: Optional[int] = None,
                 default_max_tokens: int = 0,
                 seq_buckets: Optional[Sequence[int]] = None,
                 model_version: str = "boot",
                 canary_fraction: float = 0.0,
                 canary_promote_requests: int = 64,
                 reload_key=None):
        if (decoder is None and hasattr(output_layer, "max_slots")
                and hasattr(output_layer, "step")):
            # a decoder in the first position
            decoder, output_layer = output_layer, None
        given = dict(mesh=mesh, mesh_slices=mesh_slices,
                     mesh_rules=mesh_rules,
                     compile_cache_dir=compile_cache_dir)
        for kw, value in given.items():
            default, item = _UNPORTED[kw]
            if value is not default and value != default:
                raise NotImplementedError(
                    f"InferenceEngine({kw}=...) is not ported to "
                    f"paddle_tpu_torch yet: {item}")
        self._decoder = decoder
        self._paged = bool(getattr(decoder, "paged", False))
        self._inf = self._feeder = None
        self._slot_alloc = None
        self.seq_buckets = None
        self._seq_inputs: tuple = ()
        self._one_per_batch = False
        if decoder is not None:
            if not (hasattr(decoder, "max_slots")
                    and hasattr(decoder, "step")):
                raise ValueError("decoder= takes a SlotDecoder or "
                                 "PagedDecoder")
            if output_layer is not None or inference is not None:
                raise ValueError(
                    "decoder= is exclusive with output_layer/inference=")
            if seq_buckets is not None:
                raise ValueError("seq_buckets is a whole-forward knob; "
                                 "decode buckets ride the decoder")
            if decode_policy not in ("continuous", "static"):
                raise ValueError(
                    f"decode_policy must be 'continuous' or 'static' (the "
                    f"benchmark baseline), got {decode_policy!r}")
            if canary_fraction:
                raise ValueError(
                    "decode mode serves ONE resident weight set (the KV "
                    "caches bind to it): canary_fraction needs the "
                    "whole-forward engine; decode swaps drain, then swap")
            if default_max_tokens < 0:
                raise ValueError(f"default_max_tokens must be >= 0, got "
                                 f"{default_max_tokens}")
            self.decode_policy = decode_policy
            self.eos_id = None if eos_id is None else int(eos_id)
            self.default_max_tokens = int(default_max_tokens)
            self._slot_alloc = _SlotAllocator(decoder.max_slots)
            self._ttft_us: deque = deque(maxlen=4096)
            # a "row" is one sequence
            self.max_batch = int(decoder.max_slots)
            self.max_wait_us = float(max_wait_us)
            buckets = tuple(decoder.step_buckets)
            self.output_names = ["tokens"]
            self._device = decoder.device
        else:
            if decode_policy != "continuous" or eos_id is not None \
                    or default_max_tokens:
                raise ValueError(
                    "decode_policy/eos_id/default_max_tokens need "
                    "decoder= (a KV-slot decode surface)")
            if inference is None:
                if output_layer is None or parameters is None:
                    raise ValueError(
                        "InferenceEngine needs (output_layer, parameters), "
                        "inference=, or decoder=")
                inference = Inference(output_layer, parameters)
            self._inf = inference
            self._feeder = DataFeeder(inference.topology, feeding)
            # a scalar output (a cost) folds its batch: one request a
            # batch, unpadded, so every answer is the request's own
            self._one_per_batch = not inference._pad_ok
            self.decode_policy = "continuous"
            self.eos_id = None
            self.default_max_tokens = 0
            if max_batch < 1:
                raise ValueError(f"max_batch must be >= 1, got {max_batch}")
            self.max_batch = int(max_batch)
            self.max_wait_us = float(max_wait_us)
            buckets = tuple(sorted({
                int(b) for b in (batch_buckets
                                 or default_buckets(max_batch))}))
            if not buckets or buckets[0] < 1:
                raise ValueError(f"bad batch_buckets {buckets}")
            if buckets[-1] < self.max_batch:
                # the coalescer fills up to max_batch rows: some bucket
                # must hold a full batch
                buckets = buckets + (self.max_batch,)
            self.output_names = list(inference.output_names)
            self._device = inference.device
            if seq_buckets is not None:
                self._set_seq_buckets(seq_buckets)
        self.batch_buckets = buckets

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
        self.overload_wait_scale = float(overload_wait_scale)
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
        self._tenant_make_lock = _lockcheck.make_lock(
            "serving.engine.tenant_make")

        # ---- model versions: the active one, the previous one (the
        # rollback target) and an optional canary stay resident
        if not 0.0 <= canary_fraction <= 1.0:
            raise ValueError(f"canary_fraction must be in [0, 1], got "
                             f"{canary_fraction}")
        if canary_promote_requests < 1:
            raise ValueError(f"canary_promote_requests must be >= 1, got "
                             f"{canary_promote_requests}")
        self.canary_fraction = float(canary_fraction)
        self.canary_promote_requests = int(canary_promote_requests)
        if isinstance(reload_key, str):
            reload_key = reload_key.encode()
        self._reload_key = reload_key or None
        self._version_lock = _lockcheck.make_lock(
            "serving.engine.version")
        self._watcher = None
        vals0 = (decoder.values() if decoder is not None
                 else inference.parameters.values)
        # the probation window must hold canary_promote_requests outcomes
        self._canary_window = max(self.breaker_window or 64,
                                  self.canary_promote_requests)
        ver0 = _ModelVersion(str(model_version), vals0, state="active",
                             window=self._canary_window)
        self._versions: Dict[str, _ModelVersion] = {ver0.id: ver0}
        self._version_active = ver0.id
        _model_version_gauge(ver0.id).set(1)
        self._version_prev: Optional[str] = None
        self._version_canary: Optional[str] = None
        self._bad_versions: set = set()   # ids a watcher must not re-install
        self._canary_seq = 0              # the deterministic fraction split
        self._decode_pending = None       # (version, t0, result kind)

        self._inq: "queue.SimpleQueue" = queue.SimpleQueue()
        self._lane_high = _Lane(self._quanta)
        self._lane_normal = _Lane(self._quanta)
        self._lane_credit = 0              # high pops past waiting normal
        self._carry: List[_Request] = []   # overflow of the last collect
        self._carry_rows = 0
        self._shedding = False             # admission gate state
        self._wait_scale = 1.0             # overload max_wait multiplier
        self._stopping = False             # the batcher saw the sentinel
        self._abort = False                # stop dispatching, shed the rest
        self._closed = False
        self._healthy = True
        self._health_reason = ""
        self._inflight = ()                # what the batcher holds
        self._delivering = ()              # the batch delivery holds
        # orders submit's {closed check, put} against close's {set closed,
        # put sentinel}: a request put under it is ahead of the sentinel
        self._close_lock = _lockcheck.make_lock("serving.engine.close")
        self._err_lock = _lockcheck.make_lock("serving.engine.err")
        self._stats_lock = _lockcheck.make_lock("serving.engine.stats")
        self.session = {"requests": 0, "rows": 0, "errors": 0,
                        "batches": 0, "padded_rows": 0, "batched_rows": 0,
                        "goodput": 0, "lane_credit_pops": 0,
                        "tenant_overflow": 0, "real_cells": 0,
                        "pad_cells": 0, "version_fallbacks": 0,
                        "reloads": {r: 0 for r in RELOAD_RESULTS},
                        "reload_unauthorized": 0,
                        "shed": {reason: 0 for reason in SHED_REASONS}}
        if decoder is not None:
            # iterations: the /stats progress beat
            self.session.update({"iterations": 0, "tokens": 0,
                                 "slot_allocs": 0, "slot_frees": 0,
                                 "slot_steps": 0, "kv_cells_live": 0,
                                 "kv_cells_alloc": 0})
            if self._paged:
                self.session.update({"prefix_hits": 0,
                                     "prefix_blocks_shared": 0})
        self._tenant(DEFAULT_TENANT)       # pre-bind the untagged path
        self._buckets_used: set = set()
        self._lat_us: deque = deque(maxlen=2048)
        # each applied swap's pause: the pointer flip (whole forwards) or
        # the drain wait (decode)
        self._swap_pauses_us: deque = deque(maxlen=256)
        self._t_start = time.perf_counter()
        self._bound_port = 0
        # distributed tracing: inert unless trace_sample= or
        # telemetry_dir= is given (the off path allocates nothing a
        # request).  On, every /infer request carries a
        # tracectx.SpanBuffer; head-sampled traces and anomalous ones
        # (shed, error, deadline, slow) are kept by the tail-based
        # flight recorder
        self._flight = _tracectx.make_recorder(trace_sample, telemetry_dir)
        self._trace_role = "replica"      # the fleet-facing span role
        # the decoder iteration's registry rows, by kind (telemetry)
        self._step_exes: dict = {}
        # (t_done, n) per delivery; _rps feeds Retry-After
        self._done_log: deque = deque(maxlen=256)
        self._rps = 0.0
        self._server = None
        # the batcher launches each forward and hands its device outputs
        # here; the delivery thread pays the copy to the host.  The bound
        # is backpressure when delivery falls behind
        self._out_q: "queue.Queue" = queue.Queue(maxsize=8)
        self._batcher = threading.Thread(
            target=(self._paged_loop if self._paged
                    else self._decode_loop if decoder is not None
                    else self._dispatch_loop),
            name="ptt-serving-batcher", daemon=True)
        self._delivery = threading.Thread(target=self._delivery_loop,
                                          name="ptt-serving-delivery",
                                          daemon=True)
        self._watchdog_stop = threading.Event()
        self._watchdog = threading.Thread(target=self._watchdog_loop,
                                          name="ptt-serving-watchdog",
                                          daemon=True)
        self._batcher.start()
        self._delivery.start()
        self._watchdog.start()

    def _set_seq_buckets(self, seq_buckets) -> None:
        """2-D (rows, T) buckets: each micro-batch's sequence axis pads to
        the smallest seqlen bucket covering the batch's longest sample
        (capped at the largest declared max_len) instead of max_len."""
        topo = self._inf.topology
        infos = []
        for name in topo.input_names:
            if not topo.is_seq.get(name):
                continue
            if topo.get_layer(name).attrs.get("seq_type", 0) != 1:
                continue
            max_len = topo.shapes[name][0]
            if max_len is None:
                raise ValueError(
                    f"seq_buckets needs max_len declared on sequence input "
                    f"{name!r} (an unsized T axis already buckets per "
                    f"batch at feed time)")
            idx = self._feeder.feeding.get(name)
            if idx is None:
                continue
            infos.append((name, idx, int(max_len)))
        if not infos:
            raise ValueError("seq_buckets set but the topology has no "
                             "max_len-declared sequence inputs to bucket")
        cap = max(n for _, _, n in infos)
        tb = sorted({int(b) for b in seq_buckets if 0 < int(b) <= cap})
        if not tb or tb[-1] < cap:
            tb.append(cap)                # any length must fit a bucket
        self.seq_buckets = tuple(tb)
        self._seq_inputs = tuple(infos)

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
                        _C_TENANT_OVERFLOW.inc()
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

    # ----------------------------------------------------- model versions
    def attach_watcher(self, watcher) -> None:
        """Bind a ``serving.reload.WeightWatcher``: ``POST /reload`` pushes
        its check and ``close()`` joins it before draining."""
        self._watcher = watcher

    def _reload_authorized(self, body: bytes, headers,
                           query: str = "") -> bool:
        """``/reload`` auth: with no key every push is accepted; with one,
        the ``X-Ptpu-Reload-Key`` header must carry the hex HMAC-SHA256 of
        ``<query>\\n<body>`` under the key (the query carries the action,
        so a signed push cannot be replayed as ``?rollback=1``).
        Constant-time compare; never raises."""
        key = self._reload_key
        if not key:
            return True
        import hashlib
        import hmac

        given = (headers or {}).get("X-Ptpu-Reload-Key")
        if not given:
            return False
        msg = (query or "").encode() + b"\n" + (body or b"")
        want = hmac.new(key, msg, hashlib.sha256).hexdigest()
        return hmac.compare_digest(str(given).strip(), want)

    def _place(self, values) -> dict:
        """A parameter tree (numpy arrays or tensors, or a ``Parameters``)
        as tensors on the engine's device."""
        if not isinstance(values, dict):
            values = values.values        # a Parameters
        dev = self._device

        def leaf(v):
            t = v.detach() if torch.is_tensor(v) else torch.as_tensor(
                np.asarray(v))
            return t.to(dev)

        return {lname: {name: leaf(v) for name, v in ps.items()}
                for lname, ps in values.items()}

    def install_version(self, version: str, values, *,
                        canary: Optional[bool] = None,
                        source: str = "") -> dict:
        """Install ``values`` (a parameter tree of the serving tree's
        names and shapes) as a resident model version; the copy to the
        device runs on the calling thread, never the batcher's.

        Whole forwards: the version goes live between micro-batches
        (requests resolve their version at submit and batches never mix
        versions, so in-flight work finishes on its weights); with
        ``canary_fraction > 0`` (or ``canary=True``) it enters as the
        canary.  Decode: drain-then-swap (admission pauses, residents
        finish on the old weights, then the decoder's values swap).

        Returns ``{"result": "swapped" | "canary" | "pending" | "no_new" |
        "refused" | "refused_bad", "model_version": ...}``."""
        version = str(version)
        if self._closed:
            return {"result": "refused", "error": "engine closed",
                    "model_version": self._active_version()}
        with self._version_lock:
            if version in self._bad_versions:
                return {"result": "refused_bad",
                        "error": f"version {version!r} was rolled back "
                                 f"(canary breach or operator rollback); "
                                 f"refusing re-install",
                        "model_version": self._version_active}
            if version in self._versions:
                return {"result": "no_new",
                        "model_version": self._version_active}
        placed = self._place(values)
        with self._version_lock:
            served = self._versions[self._version_active].values
        mismatch = sorted(
            f"{lname}.{name}" for lname, ps in served.items()
            for name, t in ps.items()
            if tuple(getattr(placed.get(lname, {}).get(name), "shape",
                             ())) != tuple(t.shape))
        if mismatch:
            # same names and shapes or nothing: a tree that does not fit
            # would fail every request of the version (decode: the swap)
            return {"result": "refused",
                    "error": f"not the served tree's names and shapes: "
                             f"{mismatch[:4]}",
                    "model_version": self._active_version()}
        rec = _ModelVersion(version, placed, source=source,
                            window=self._canary_window)
        t0 = time.perf_counter()
        if self._decoder is not None:
            with self._version_lock:
                self._versions[version] = rec
                self._decode_pending = (version, t0, "swapped")
            self._inq.put(_WAKE)          # nudge an idle decode loop
            return {"result": "pending", "model_version": version}
        with self._version_lock:
            self._versions[version] = rec
            go_canary = (bool(canary) if canary is not None
                         else self.canary_fraction > 0)
            if go_canary:
                old = self._version_canary
                if old is not None:
                    # a newer candidate supersedes an unpromoted canary
                    self._versions[old].state = "resident"
                self._version_canary = version
                rec.state = "canary"
        if go_canary:
            return {"result": "canary", "model_version": version}
        self._promote(version)
        self._note_swap(version, time.perf_counter() - t0)
        return {"result": "swapped", "model_version": version}

    def promote(self) -> dict:
        """Promote the canary to active; the old active stays resident
        as the rollback target."""
        t0 = time.perf_counter()
        with self._version_lock:
            can = self._version_canary
        if can is None or not self._promote(can, only_if_canary=True):
            return {"result": "refused",
                    "error": "no canary version resident",
                    "model_version": self._active_version()}
        self._note_swap(can, time.perf_counter() - t0)
        return {"result": "swapped", "model_version": can}

    def _mark_bad(self, version: str) -> None:
        """(under ``_version_lock``) a demoted id a watcher must not
        re-install; the set is bounded."""
        self._bad_versions.add(version)
        while len(self._bad_versions) > 256:
            self._bad_versions.pop()

    def rollback(self) -> dict:
        """Demote a live canary, else flip the active pointer back to the
        resident previous version (decode: through drain-then-swap).  The
        demoted version is marked bad."""
        t0 = time.perf_counter()
        with self._version_lock:
            can = self._version_canary
            if can is not None:
                self._version_canary = None
                self._mark_bad(can)
                self._versions[can].state = "rolled_back"
                target = self._version_active
            elif self._version_prev is not None:
                bad, target = self._version_active, self._version_prev
                self._mark_bad(bad)
                self._versions[bad].state = "rolled_back"
                self._versions[target].state = "active"
                self._version_active = target
                self._version_prev = None
                if self._decoder is not None:
                    # the decoder still holds the bad weights
                    self._decode_pending = (target, t0, "rolled_back")
            else:
                return {"result": "refused",
                        "error": "no previous/canary version resident to "
                                 "roll back to",
                        "model_version": self._version_active}
        if self._decoder is not None and can is None:
            self._inq.put(_WAKE)
            return {"result": "pending", "model_version": target}
        self._note_swap(target, time.perf_counter() - t0,
                        result="rolled_back")
        return {"result": "rolled_back", "model_version": target}

    def _promote(self, version: str, only_if_canary: bool = False) -> bool:
        """The pointer flip: ``version`` becomes active, the old active
        prev; residents beyond {active, prev, canary} and one grace entry
        retire (requests pinned to a retired id fall back to the active
        weights, counted ``version_fallbacks``).  ``only_if_canary``: flip
        only while it is still the canary (a racing rollback wins).
        False when the flip did not happen."""
        with self._version_lock:
            rec = self._versions.get(version)
            if rec is None or version in self._bad_versions:
                return False
            if only_if_canary and self._version_canary != version:
                return False
            old = self._version_active
            if version == self._version_canary:
                self._version_canary = None
            if old != version:
                self._version_prev = old
                self._versions[old].state = "prev"
            rec.state = "active"
            self._version_active = version
            keep = {self._version_active, self._version_prev,
                    self._version_canary}
            extra = [v for v in self._versions if v not in keep]
            while len(extra) > 1:
                del self._versions[extra.pop(0)]     # oldest first
        return True

    def _active_version(self) -> str:
        with self._version_lock:
            return self._version_active

    def _note_swap(self, version: str, pause_s: float,
                   result: str = "swapped") -> None:
        """Count one applied swap or rollback and keep its pause."""
        self._version_gauges()
        with self._err_lock:
            self.session["reloads"][result] += 1
        _C_RELOADS[result].inc()
        _H_SWAP.observe(pause_s * 1e6)
        with self._stats_lock:
            self._swap_pauses_us.append(pause_s * 1e6)
        if self._flight is not None:
            # a weight swap is an operational event worth a timeline row
            trace = _tracectx.SpanBuffer(_tracectx.mint(1.0), "engine/swap",
                                         role=self._trace_role)
            trace.add_span("engine/swap", time.perf_counter_ns()
                           - int(pause_s * 1e9), int(pause_s * 1e9),
                           version=version, result=result)
            self._flight.finish(trace, "ok", version=version)

    def _version_gauges(self) -> None:
        """``serving_model_version``: 1 on the active version, 0 on the
        other resident ones."""
        with self._version_lock:
            active, vids = self._version_active, list(self._versions)
        for vid in vids:
            _model_version_gauge(vid).set(1 if vid == active else 0)

    def _resolve_version(self, pinned: Optional[str]) -> str:
        """Submit-time resolution: a pin names a resident version (or
        ``"prev"``, the rollback target); untagged traffic takes the
        active version, a deterministic ``canary_fraction`` of it the
        canary (every 4th request at 0.25).  ValueError on an unknown
        pin."""
        with self._version_lock:
            if pinned is not None:
                if pinned == "prev" and self._version_prev is not None:
                    pinned = self._version_prev
                if pinned not in self._versions:
                    raise ValueError(
                        f"unknown model_version {pinned!r} (resident: "
                        f"{sorted(self._versions)})")
                self._versions[pinned].requests += 1
                return pinned
            ver = self._version_active
            can = self._version_canary
            if can is not None:
                f = self.canary_fraction
                n = self._canary_seq
                self._canary_seq = n + 1
                if int((n + 1) * f) - int(n * f):
                    ver = can
            self._versions[ver].requests += 1
            return ver

    def _version_inputs(self, version: str):
        """(values, actual version) of a batch's version: a retired id
        (swaps raced the queue) falls back to the active weights,
        counted; the caller re-stamps the batch with the actual id."""
        with self._version_lock:
            rec = self._versions.get(version)
            fallback = rec is None
            if fallback:
                rec = self._versions[self._version_active]
        if fallback:
            with self._err_lock:
                self.session["version_fallbacks"] += 1
        return rec.values, rec.id

    def _version_outcome(self, r: _Request, err: bool) -> None:
        """One finished request's outcome against its version: the
        canary's probation.  A canary whose windowed error rate reaches
        the breaker threshold (with ``breaker_min_requests`` outcomes)
        rolls back; one that survives ``canary_promote_requests``
        outcomes promotes.  Only per-request errors count."""
        ver = r.version
        if ver is None:
            return
        breached = promoted = False
        with self._version_lock:
            rec = self._versions.get(ver)
            if rec is None:
                return
            if err:
                rec.errors += 1
            if ver != self._version_canary:
                return
            rec.push_outcome(err)
            n = len(rec.window)
            if (err and n >= self.breaker_min_requests
                    and rec.win_errors >= self.breaker_threshold * n):
                self._version_canary = None
                self._mark_bad(ver)
                rec.state = "rolled_back"
                breached = True
            elif (not err and n >= self.canary_promote_requests
                    and rec.win_errors < self.breaker_threshold * n):
                promoted = True
        if breached:
            with self._err_lock:
                self.session["reloads"]["rolled_back"] += 1
                _C_RELOADS["rolled_back"].inc()
        elif promoted and self._promote(ver, only_if_canary=True):
            self._note_swap(ver, 0.0)

    def _swap_gate(self, busy: bool) -> bool:
        """Decode drain-then-swap (batcher thread): True while a swap is
        pending and residents still decode on the old weights (admission
        pauses; nothing is shed); with none resident, the decoder takes
        the new values, the drain wait is the swap's pause."""
        with self._version_lock:
            pend = self._decode_pending
            if pend is None:
                return False
            if busy:
                return True
            ver, t0, kind = pend
            self._decode_pending = None
            rec = self._versions.get(ver)
        if rec is None:
            return False
        # rollback flipped the pointers already; a version marked bad
        # since its install must not flip
        if kind != "rolled_back" and not self._promote(ver):
            return False
        self._decoder.set_values(rec.values)
        self._note_swap(ver, time.perf_counter() - t0, result=kind)
        return False

    def _board_decode(self, r: _Request) -> None:
        """Decode resolves a request's version at prefill: the one
        resident weight set."""
        with self._version_lock:
            ver = self._version_active
            self._versions[ver].requests += 1
        r.version = ver
        r.future._ptt_model_version = ver

    # ------------------------------------------------------------ intake
    def queue_depth(self) -> int:
        """Requests backlogged ahead of the batcher: in the submission
        queue, parked in a lane, or carried over from the last collect."""
        return (self._inq.qsize() + len(self._lane_high)
                + len(self._lane_normal) + len(self._carry))

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
        """Enqueue one request.  Whole forwards: ``samples`` is a list of
        v2 sample tuples, and the Future resolves to what
        ``Inference.infer`` returns for them (one array for one output,
        else a list).  Decode: ``samples`` is ONE prompt (bare 1-D ints,
        ``[prompt]`` or ``[(prompt,)]``), ``max_tokens`` bounds the
        generation, and the Future resolves to the generated token ids
        (1-D int32, EOS included when emitted).  A malformed request fails
        with ``ValueError``, the rest with a typed ``ServingError``.

        ``deadline_us`` (default ``default_deadline_us``; <= 0: none)
        bounds the wait for a batch row (decode: the whole generation).
        ``lane``: ``"normal"`` or ``"high"``.  ``tenant`` names the unit
        of fair queuing, quotas and the breaker (untagged traffic rides
        ``"default"``).  Under overload the Future fails at once with
        ``Overloaded`` (an open breaker: ``BreakerOpen``).  ``version``
        pins a resident model version (``"prev"``: the rollback target;
        decode: only the active one).  ``temperature`` / ``top_k`` /
        ``top_p`` / ``seed`` sample on a ``sampling=True`` decoder; the
        stream is deterministic in (seed, position).  ``trace`` (a
        ``tracectx.SpanBuffer``) collects the request's engine spans."""
        fut: Future = Future()
        prompt = sampling = None
        if self._decoder is not None:
            try:
                prompt, cost = self._decode_request(samples, max_tokens)
                sampling = self._decode_sampling(temperature, top_k, top_p,
                                                 seed)
            except (ValueError, TypeError) as e:
                fut.set_exception(e)
                self._count_error()
                return fut
            samples, rows = None, 1
        else:
            bad = None
            if max_tokens is not None:
                bad = ("max_tokens is a decode-mode field; this engine "
                       "serves whole forwards (construct with decoder=)")
            elif (temperature is not None or top_k is not None
                  or top_p is not None or seed is not None):
                bad = ("temperature/top_k/top_p/seed are decode-mode "
                       "sampling fields; this engine serves whole forwards "
                       "(construct with decoder=)")
            else:
                samples = list(samples)
                rows = cost = len(samples)
                if rows == 0:
                    bad = "empty request"
                elif rows > self.max_batch:
                    bad = (f"request of {rows} rows exceeds max_batch="
                           f"{self.max_batch}; split it client-side")
            if bad is not None:
                fut.set_exception(ValueError(bad))
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
        # whole forwards resolve the version here (pins must name a
        # resident one); decode at prefill, against its one weight set
        ver = None
        try:
            if self._decoder is None:
                ver = self._resolve_version(
                    str(version) if version is not None else None)
            elif version is not None:
                act = self._active_version()
                if str(version) != act:
                    raise ValueError(
                        f"decode serves one resident version ({act!r}); "
                        f"cannot pin model_version={version!r}")
        except ValueError as e:
            if probe:
                # the half-open probe never ran: release it
                with ts.lock:
                    ts.br_probe_inflight = False
            fut.set_exception(e)
            self._count_error()
            return fut
        req = _Request(prompt, cost, fut, t, deadline, lane, tenant, ts,
                       probe=probe, sampling=sampling, samples=samples,
                       rows=rows, version=ver, trace=trace)
        if ver is not None:
            fut._ptt_model_version = ver
        with ts.lock:
            ts.depth += 1
            ts.requests += 1
            ts.gauge.set(ts.depth)
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
              seed: Optional[int] = None,
              version: Optional[str] = None):
        """submit + wait.  On a wait timeout the request is cancelled
        (shed ``"abandoned"``), so an abandoned caller never takes a batch
        row or keeps its KV slot."""
        fut = self.submit(samples, deadline_us=deadline_us, lane=lane,
                          tenant=tenant, max_tokens=max_tokens,
                          temperature=temperature, top_k=top_k,
                          top_p=top_p, seed=seed, version=version)
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
        _C_ERRS.inc(n)

    def _count_shed(self, reason: str, n: int = 1) -> None:
        with self._err_lock:
            self.session["shed"][reason] += n
        _C_SHED[reason].inc(n)

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
                ts.gauge.set(ts.depth)
        return True

    def _fail(self, r: _Request, exc: Exception, reason: str) -> None:
        if r.trace is not None:
            # the shed marker before the resolve wakes the waiter that
            # finishes (and may publish) the request's span buffer
            r.trace.event("engine/shed", reason=reason)
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
        if item is _WAKE:                 # install_version's nudge
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
                    _C_CREDIT.inc()
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

    # --------------------------------------------- whole-forward batcher
    def _shed_batch(self, batch: List[_Request]) -> None:
        exc, reason = self._abort_exc()
        for r in batch:
            self._fail(r, exc, reason)

    def _send_out_sentinel(self, give_up_s: Optional[float] = 30.0) -> None:
        """Hand the delivery thread its shutdown sentinel, waiting out a
        full queue while delivery lives to drain it; bounded by
        ``give_up_s`` (a delivery wedged with a full queue is left to its
        daemon thread)."""
        t0 = time.perf_counter()
        while self._delivery.is_alive():
            try:
                self._out_q.put(None, timeout=1.0)
                return
            except queue.Full:
                if (give_up_s is not None
                        and time.perf_counter() - t0 >= give_up_s):
                    return

    def _update_wait_scale(self, depth: int) -> None:
        """Under sustained backlog widen the effective ``max_wait_us``
        toward full buckets (throughput mode); narrow back geometrically
        once the queue clears."""
        if self.overload_wait_scale <= 1.0:
            return
        high = self.max_queue_depth or 4 * self.max_batch
        if depth >= max(1, high // 2):
            self._wait_scale = min(self.overload_wait_scale,
                                   self._wait_scale * 1.5)
        elif self._wait_scale > 1.0:
            self._wait_scale = max(1.0, self._wait_scale * 0.75)
        _G_WAIT_SCALE.set(round(self._wait_scale, 2))

    def _collect(self) -> Optional[List[_Request]]:
        """Block until a micro-batch is due: ``max_batch`` rows, the
        oldest request's (overload-scaled) ``max_wait_us`` passed, or
        shutdown.  None when stopped and drained.  A request of another
        model version, or one that overflows the rows, opens the next
        batch.  The fill loop inlines the pump, pop and reap chain: it
        runs once per request; the high lane and dead requests take the
        full ``_lane_pop`` path."""
        q = self._inq
        hi, no = self._lane_high, self._lane_normal
        batch, rows = self._carry, self._carry_rows
        self._carry, self._carry_rows = [], 0
        while not batch:
            self._pump()
            r = self._lane_pop()
            if r is not None:
                batch, rows = [r], r.rows
                break
            if self._stopping or self._abort:
                return None
            self._lane_put(q.get())           # block for the first
        self._update_wait_scale(self.queue_depth())
        deadline = (batch[0].t_submit
                    + self.max_wait_us * self._wait_scale / 1e6)
        max_batch = 1 if self._one_per_batch else self.max_batch
        while rows < max_batch and not self._stopping and not self._abort:
            while q.qsize():                  # inline _pump
                try:
                    item = q.get_nowait()
                except queue.Empty:           # a _fail_pending raced it
                    break
                if item is None:
                    self._stopping = True
                elif item is not _WAKE:
                    (hi if item.lane == "high" else no).append(item)
            if hi.n:
                r = self._lane_pop()          # priority, credit, reap
            elif no.n:
                r = no.popleft()              # DRR (one tenant: FIFO)
                if r is None:                 # raced a _fail_pending
                    continue
                self._lane_credit = 0
                if r.abandoned or (r.deadline is not None
                                   and time.perf_counter() > r.deadline):
                    self._reap(r)
                    continue
            else:
                r = None
            if r is None:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                # a short relative sleep and a re-pump, not a timed get:
                # the fill window keeps its deadline whatever the queue's
                # wake-up does
                time.sleep(min(remaining, 5e-5))
                continue
            if (rows + r.rows > self.max_batch or self._one_per_batch
                    or r.version != batch[0].version):
                self._carry, self._carry_rows = [r], r.rows
                break
            batch.append(r)
            rows += r.rows
        return batch

    def _drain_after_stop(self) -> None:
        """Past the sentinel: dispatch what beat the closed flag, then
        hand delivery its sentinel; with ``_abort`` set shed the rest."""
        while True:
            if self._abort:
                exc, reason = self._abort_exc()
                self._fail_pending(exc, reason, drain_out_q=False)
                self._send_out_sentinel()
                return
            batch, rows = self._carry, self._carry_rows
            self._carry, self._carry_rows = [], 0
            self._pump()
            while not (batch and self._one_per_batch):
                r = self._lane_pop()
                if r is None:
                    break
                if (rows + r.rows > self.max_batch
                        or (batch and (r.version != batch[0].version
                                       or self._one_per_batch))):
                    self._carry, self._carry_rows = [r], r.rows
                    break
                batch.append(r)
                rows += r.rows
            if not batch:
                self._send_out_sentinel()
                return
            self._run_batch(batch)

    def _dispatch_loop(self) -> None:
        """Batcher-thread body of the whole-forward mode."""
        while True:
            batch = None
            try:
                batch = self._collect()
                if batch:
                    self._run_batch(batch)
                if self._stopping or self._abort:
                    self._drain_after_stop()
                    return
            except Exception as e:            # noqa: BLE001 - last resort
                # a batcher bug fails what it held, never the thread
                self._count_error(sum(
                    self._resolve(r, exc=e) for r in (batch or [])))

    def _survivors(self, batch: List[_Request]) -> List[_Request]:
        """The error-isolation boundary: a request whose samples do not
        convert fails its own future (counted against its tenant and its
        version) and drops out."""
        ok = []
        for r in batch:
            try:
                self._feeder.feed(r.samples)
                ok.append(r)
            except Exception as e:            # noqa: BLE001 - isolate
                if self._resolve(r, exc=e):
                    self._count_error()
                    self._tenant_outcome(r, True)
                    self._version_outcome(r, True)
        return ok

    def _batch_samples(self, batch: List[_Request]):
        """(samples, real rows, row bucket, seq_pad, real cells, cells):
        the coalesced samples padded up to the row bucket by repeating
        the last sample (pad rows hold valid data; delivery slices them
        away).  With ``seq_buckets`` the T axis is the smallest seqlen
        bucket covering the batch's longest sample, each length clamped at
        the grid's cap (an over-long sample is cut to max_len at feed
        time), and cells count rows x T; otherwise cells are rows."""
        real = sum(r.rows for r in batch)
        bucket = (real if self._one_per_batch
                  else bucket_rows(real, self.batch_buckets))
        samples = [s for r in batch for s in r.samples]
        if bucket > real:
            samples.extend(samples[-1:] * (bucket - real))
        if not self._seq_inputs:
            return samples, real, bucket, None, real, bucket
        cap = self.seq_buckets[-1]
        seq_idx = [idx for _, idx, _ in self._seq_inputs]
        need, cells = 1, 0
        for s in samples[:real]:
            m = min(max(len(s[idx]) for idx in seq_idx), cap)
            cells += m
            need = max(need, m)
        seq_pad = bucket_rows(need, self.seq_buckets)
        return samples, real, bucket, seq_pad, cells, bucket * seq_pad

    def _run_batch(self, batch: List[_Request]) -> None:
        # assembly-time shed: a request can expire between pop and
        # assembly (it rode the carry, or the window was wide)
        if any(r.abandoned or r.deadline is not None for r in batch):
            batch = [r for r in batch if not self._reap(r)]
            if not batch:
                return
        # not try/finally: a BaseException killing this thread must leave
        # _inflight naming the batch, for the watchdog to fail
        self._inflight = batch
        self._run_batch_inner(batch)
        self._inflight = ()

    def _run_batch_inner(self, batch: List[_Request]) -> None:
        if self._flight is not None:
            # board time closes each traced request's queue-wait span
            t_board = time.perf_counter_ns()
            for r in batch:
                if r.trace is not None:
                    t0 = int(r.t_submit * 1e9)
                    r.trace.add_span("engine/queue_wait", t0, t_board - t0,
                                     lane=r.lane, tenant=r.tenant)
        # one feed conversion over the coalesced padded samples; on
        # failure re-probe per request, so only the poison request fails
        (samples, real, bucket, seq_pad, real_cells,
         cells) = self._batch_samples(batch)
        try:
            feed = self._feeder.feed(samples, seq_pad=seq_pad)
        except Exception:                     # noqa: BLE001 - isolate
            batch = self._survivors(batch)
            self._inflight = batch
            if not batch:
                return
            (samples, real, bucket, seq_pad, real_cells,
             cells) = self._batch_samples(batch)
            try:
                feed = self._feeder.feed(samples, seq_pad=seq_pad)
            except Exception as e:            # noqa: BLE001 - isolate
                self._count_error(sum(
                    self._resolve(r, exc=e) for r in batch))
                return
        # the batch's weights are read here, between micro-batches: a swap
        # changes what the next batch resolves, never a running forward
        vals, actual = self._version_inputs(batch[0].version)
        if actual != batch[0].version:
            # the eviction fallback ran on the active weights: the answers
            # must say so
            for r in batch:
                r.version = actual
                r.future._ptt_model_version = actual
        try:
            # the launch is asynchronous on the card; the delivery thread
            # pays the copy to the host
            t_fwd0 = (time.perf_counter_ns()
                      if self._flight is not None else 0)
            out = self._observed_forward(
                (bucket, seq_pad), lambda: self._inf.run_feed(feed,
                                                              params=vals))
            devs = [out[n] for n in self.output_names]
            if self._flight is not None:
                dur = time.perf_counter_ns() - t_fwd0
                for r in batch:
                    if r.trace is not None:
                        r.trace.add_span("engine/forward", t_fwd0, dur,
                                         rows=real, bucket=bucket)
            with self._stats_lock:
                # the 2-D key (rows, padded T) with seqlen buckets
                self._buckets_used.add(
                    bucket if seq_pad is None else (bucket, seq_pad))
        except Exception as e:                # noqa: BLE001 - isolate
            self._count_error(sum(self._resolve(r, exc=e) for r in batch))
            return
        sess = self.session
        sess["requests"] += len(batch)
        sess["rows"] += real
        sess["batches"] += 1
        if _metrics._enabled:
            _metrics.record(
                ((_C_BATCHES, 1), (_C_REQS, len(batch)), (_C_ROWS, real)),
                ((_H_BATCH, real),
                 (_H_WASTE, (bucket - real) / bucket * 100.0)))
        sess["batched_rows"] += real
        sess["padded_rows"] += bucket - real
        sess["real_cells"] += real_cells
        sess["pad_cells"] += cells - real_cells
        if self._abort:
            # the watchdog or the drain fired during the forward: no
            # consumer is guaranteed, shed instead of stranding
            self._shed_batch(batch)
            return
        item = (devs, batch)
        while True:
            try:
                self._out_q.put(item, timeout=0.25)
                break
            except queue.Full:
                if self._abort:
                    self._shed_batch(batch)
                    return
        if self._abort and not self._delivery.is_alive():
            # abort raced the put and nobody will pop it: reclaim and shed
            while True:
                try:
                    it = self._out_q.get_nowait()
                except queue.Empty:
                    break
                if it is not None:
                    self._shed_batch(it[1])

    def _delivery_loop(self) -> None:
        """Delivery-thread body: ONE copy to the host per output (it
        waits for the device), then each request's rows sliced out; a
        scalar output goes whole to its batch's one request."""
        while True:
            item = self._out_q.get()
            if item is None:
                return
            devs, batch = item
            self._delivering = batch
            t_del0 = (time.perf_counter_ns()
                      if self._flight is not None else 0)
            try:
                host = [d.detach().cpu().numpy() for d in devs]
            except Exception as e:            # noqa: BLE001 - isolate
                self._count_error(sum(
                    self._resolve(r, exc=e) for r in batch))
                self._delivering = ()
                continue
            t_done = time.perf_counter()
            if self._flight is not None:
                # the copy to the host, recorded before the resolves wake
                # the waiters that finish the buffers
                dur = time.perf_counter_ns() - t_del0
                for r in batch:
                    if r.trace is not None:
                        r.trace.add_span("engine/delivery", t_del0, dur,
                                         rows=r.rows)
            off = good = 0
            for r in batch:
                try:
                    fields = [h if h.ndim == 0 else h[off:off + r.rows]
                              for h in host]
                    delivered = self._resolve(
                        r, fields[0] if len(fields) == 1 else fields)
                except Exception as e:        # noqa: BLE001 - isolate
                    if self._resolve(r, exc=e):
                        self._count_error()
                        self._tenant_outcome(r, True)
                        self._version_outcome(r, True)
                else:
                    # False: a shed path (drain timeout, watchdog) got
                    # there first; the rows are dropped
                    if delivered:
                        if r.deadline is None or t_done <= r.deadline:
                            good += 1
                            r.tstate.goodput += 1
                        self._tenant_outcome(r, False)
                        self._version_outcome(r, False)
                off += r.rows
            self.session["goodput"] += good
            self._delivering = ()
            with self._stats_lock:
                for r in batch:
                    v = (t_done - r.t_submit) * 1e6
                    self._lat_us.append(v)
                    r.tstate.lat_us.append(v)
                self._note_done(t_done, len(batch))
                lat = sorted(self._lat_us) if _metrics._enabled else None
            if lat is not None:
                _metrics.record(
                    ((_C_GOODPUT, good),),
                    tuple((_H_REQ, (t_done - r.t_submit) * 1e6)
                          for r in batch)
                    + tuple((_H_SLACK, max(0.0, (r.deadline - t_done)
                                           * 1e6))
                            for r in batch if r.deadline is not None))
                _G_P50.set(round(_pctile(lat, 0.50), 1))
                _G_P99.set(round(_pctile(lat, 0.99), 1))
                _G_QUEUE.set(self.queue_depth())
                _G_LANE["high"].set(len(self._lane_high))
                _G_LANE["normal"].set(len(self._lane_normal))

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
        _C_SLOT_FREE[reason].inc()

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
        refills only once the whole batch drained; none while a weight
        swap waits for the residents to finish."""
        if self._swap_gate(busy):
            return                        # a swap waits for the drain
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
                     t_first: float, t_pre0: int = 0) -> None:
        ttft = (t_first - r.t_submit) * 1e6
        if r.trace is not None:
            t0 = int(r.t_submit * 1e9)
            r.trace.add_span("engine/queue_wait", t0, t_pre0 - t0,
                             lane=r.lane, tenant=r.tenant)
            r.trace.add_span("engine/prefill", t_pre0,
                             time.perf_counter_ns() - t_pre0,
                             slot=slot, ttft_us=round(ttft, 1))
        with self._stats_lock:
            self._ttft_us.append(ttft)
        _H_TTFT.observe(ttft)
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
        if r.trace is not None:
            # the whole generation, closed before the resolve wakes the
            # waiter that publishes the buffer
            t0 = int(r.t_submit * 1e9)
            r.trace.add_span("engine/decode", t0, int(t_done * 1e9) - t0,
                             slot=slot, generated=len(seq.out))
        delivered = self._resolve(r, np.asarray(seq.out, np.int32))
        self._slot_free(active, slot, "finished")
        sess = self.session
        sess["requests"] += 1
        sess["rows"] += 1
        if _metrics._enabled:
            _metrics.record(((_C_REQS, 1), (_C_ROWS, 1)),
                            ((_H_REQ, (t_done - r.t_submit) * 1e6),))
        if delivered:
            if r.deadline is None or t_done <= r.deadline:
                sess["goodput"] += 1
                _C_GOODPUT.inc()
                r.tstate.goodput += 1
            self._tenant_outcome(r, False)
            self._version_outcome(r, False)
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
            self._version_outcome(r, True)
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
                    self._send_out_sentinel()
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
        t0 = time.perf_counter()
        try:
            nxt = self._observed(
                "decode_step", lambda: dec.step(m, tokens, pos))
        except Exception as e:            # noqa: BLE001 - a batch fault
            self._batch_fault((active,), e)
            return False
        t_done = time.perf_counter()
        n_active = len(active)
        b = _bucket_rows(m, dec.step_buckets)
        sess = self.session
        sess["iterations"] += 1
        sess["tokens"] += n_active
        sess["slot_steps"] += b
        # each resident owns a whole [max_len] slab row
        sess["kv_cells_live"] += sum(s.pos for s in active.values())
        sess["kv_cells_alloc"] += n_active * dec.max_len
        self._advance(active, nxt, t_done)
        self._inflight = tuple(seq.req for seq in active.values())
        if _metrics._enabled:
            self._observe_iteration(t0, t_done, b, n_active, active)
        return False

    def _observed(self, kind: str, step):
        """``step()`` (one decoder iteration) as a dispatch of the
        decoder's ``serving`` / ``kind`` registry row while telemetry is
        on: its first such call is the row's build, counted for its
        cost; each call is timed by a CUDA event pair."""
        if not _metrics._enabled:
            return step()
        dec = self._decoder
        return _executables.observe(
            self._step_exes, kind, dec.device, step,
            lambda: _executables.register(
                stack="serving", kind=kind,
                fingerprint=_executables.fingerprint(
                    type(dec).__name__, kind, dec.max_slots,
                    dec.max_len, str(dec.device)),
                feed_sig=f"slots={dec.max_slots} max_len={dec.max_len}"))[0]

    def _observed_forward(self, key, forward):
        """One whole forward as a dispatch of its (rows, T) bucket's
        ``serving`` / ``forward`` registry row while telemetry is on (the
        first is the row's build, counted for its cost)."""
        if not _metrics._enabled:
            return forward()
        return _executables.observe(
            self._step_exes, key, self._inf.device, forward,
            lambda: _executables.register(
                stack="serving", kind="forward",
                fingerprint=_executables.fingerprint(
                    self._inf.topology.proto(), "forward", key),
                feed_sig=f"bucket={key}"))[0]

    def _observe_iteration(self, t0: float, t_done: float, b: int,
                           n_active: int, active) -> None:
        """One decode iteration's telemetry (the JAX engine's record)."""
        waste = (b - n_active) / b * 100.0 if b else 0.0
        _metrics.record(
            ((_C_ITER, 1), (_C_TOKENS, n_active)),
            ((_H_STEP, (t_done - t0) * 1e6), (_H_BATCH, n_active),
             (_H_WASTE, waste)))
        _G_SLOTS.set(len(active))
        _G_QUEUE.set(self.queue_depth())
        if self._paged:
            bs = self._decoder.blocks
            _G_KV_BLOCKS.set(bs.used)
            _G_KV_UTIL.set(bs.used / bs.capacity * 100.0
                           if bs.capacity else 0.0)

    def _decode_admit(self, active: Dict[int, _DecodeSeq],
                      r: _Request) -> None:
        """Prefill one admitted request into a free slot.  A prefill that
        fails in execution leaves every resident's cache suspect: a batch
        fault (the admitting request and the residents fail, the caches
        re-zero).  The decoder's ValueErrors come before execution and
        stay the request's own."""
        slot = self._slot_alloc.alloc()
        self.session["slot_allocs"] += 1
        _C_SLOT_ALLOC.inc()
        self._board_decode(r)
        t_pre0 = time.perf_counter_ns() if r.trace is not None else 0
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
        self._first_token(active, r, slot, first, time.perf_counter(),
                          t_pre0)

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
                    self._send_out_sentinel()
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
        _C_SLOT_ALLOC.inc()
        self._board_decode(r)
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
            nsh = -(-matched // self._decoder.block_size)
            sess["prefix_hits"] += 1
            sess["prefix_blocks_shared"] += nsh
            _C_PREFIX_HITS.inc()
            _C_PREFIX_SHARED.inc(nsh)
        joins[slot] = _PagedJoin(r, slot, matched)
        if r.trace is not None:
            joins[slot].t_pre0 = time.perf_counter_ns()

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
        t0 = time.perf_counter()
        try:
            nxt, cnxt = self._observed("paged_step", lambda: dec.mixed_step(
                m, tokens, pos, live=live, chunk=chunk,
                sample_rows=sample_rows, sample_chunk=sample_chunk))
        except Exception as e:                # noqa: BLE001 - a batch fault
            self._batch_fault((active, joins), e)
            return False
        t_done = time.perf_counter()
        n_active = len(active)
        b = _bucket_rows(max(m, 1), dec.step_buckets)
        sess = self.session
        sess["iterations"] += 1
        sess["tokens"] += n_active
        sess["slot_steps"] += b
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
                                  time.perf_counter(), cj.t_pre0)
        self._inflight = (tuple(s.req for s in active.values())
                          + tuple(j.req for j in joins.values()))
        if _metrics._enabled:
            self._observe_iteration(t0, t_done, b, n_active, active)
        return False

    # ----------------------------------------------------------- watchdog
    def _watchdog_loop(self) -> None:
        """A dead batcher or delivery thread (a BaseException escaping a
        forward or a copy) must not strand callers: mark the engine
        unhealthy, fail everything in flight with the typed error, refuse
        new work."""
        while not self._watchdog_stop.wait(self.watchdog_interval_s):
            if self._closed:
                return
            b_alive = self._batcher.is_alive()
            d_alive = self._delivery.is_alive()
            if b_alive and d_alive:
                continue
            if self._closed:
                return                    # a clean close() raced the probe
            who = "batcher" if not b_alive else "delivery"
            self._healthy = False
            self._health_reason = f"{who} thread died"
            self._abort = True
            with self._close_lock:
                self._closed = True
            # a live delivery thread still flushes computed results: leave
            # its queue alone and hand it a sentinel after
            self._fail_pending(EngineUnhealthy(
                f"engine unhealthy: {who} thread died; in-flight request "
                f"failed"), "thread_death", drain_out_q=not d_alive)
            if d_alive:
                self._send_out_sentinel()
            if b_alive:
                self._inq.put(None)       # wake a blocked collect
            return

    def _fail_pending(self, exc: Exception, reason: str,
                      drain_out_q: bool = True) -> None:
        """Fail every request not yet resolved: what the batcher holds (the
        residents, or the batch in hand), both lanes, the carry, the
        submission queue and, with ``drain_out_q``, the delivery thread's
        batch and the batches computed but not delivered."""
        for r in self._inflight:
            self._fail(r, exc, reason)
        self._inflight = ()
        if drain_out_q:
            for r in self._delivering:
                self._fail(r, exc, reason)
            self._delivering = ()
        for lane in (self._lane_high, self._lane_normal):
            for r in lane.drain():
                self._fail(r, exc, reason)
        carry, self._carry, self._carry_rows = self._carry, [], 0
        for r in carry:
            self._fail(r, exc, reason)
        while True:
            try:
                item = self._inq.get_nowait()
            except queue.Empty:
                break
            if item is not None and item is not _WAKE:
                self._fail(item, exc, reason)
        if drain_out_q:
            while True:
                try:
                    item = self._out_q.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    for r in item[1]:
                        self._fail(r, exc, reason)

    # -------------------------------------------------------------- stats
    @property
    def healthy(self) -> bool:
        return self._healthy

    def health(self) -> tuple:
        """(http_status, state): ``200 "ok"``; ``503 "overloaded"`` while
        the admission gate sheds, ``"closed"`` after ``close()``,
        ``"dead"`` once the batcher or the delivery thread died."""
        if not self._healthy:
            return 503, "dead"
        if self._closed:
            return 503, "closed"
        if not (self._batcher.is_alive() and self._delivery.is_alive()):
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

    def swap_pauses_us(self) -> list:
        """Each applied swap's pause, oldest first: the pointer flip
        (whole forwards) or the drain wait (decode)."""
        with self._stats_lock:
            return list(self._swap_pauses_us)

    def stats(self) -> dict:
        """The JAX engine's ``stats()`` less the unported features' keys
        (the compile count, mesh slices).  ``snapshot_seq`` moves
        with resolved work (and every decode iteration), so a frozen
        value under a nonzero queue is a wedge."""
        with self._stats_lock:
            lat = sorted(self._lat_us)
            buckets_used = sorted(self._buckets_used,
                                  key=lambda b: b if isinstance(b, tuple)
                                  else (b,))
        sess = self.session
        with self._err_lock:
            seq = (sess["batches"] + sess["errors"]
                   + sum(sess["shed"].values()) + sess.get("iterations", 0))
            session = {k: (dict(v) if isinstance(v, dict) else v)
                       for k, v in sess.items()}
        depth = self.queue_depth()
        _, state = self.health()
        with self._version_lock:
            versions = {vid: {"state": v.state, "requests": v.requests,
                              "errors": v.errors, "source": v.source}
                        for vid, v in self._versions.items()}
            mv, mv_prev = self._version_active, self._version_prev
            mv_canary = self._version_canary
            mv_pending = (self._decode_pending[0]
                          if self._decode_pending else None)
        batched, padded = session["batched_rows"], session["padded_rows"]
        real_cells, pad_cells = session["real_cells"], session["pad_cells"]
        rec = {
            "snapshot_seq": seq,
            "uptime_s": round(time.perf_counter() - self._t_start, 3),
            "model_version": mv,
            "model_versions": versions,
            "model_version_prev": mv_prev,
            "model_version_canary": mv_canary,
            "model_version_pending": mv_pending,
            "canary_fraction": self.canary_fraction,
            "port": self._bound_port,
            "queue_depth": depth,
            "max_batch": self.max_batch,
            "max_wait_us": self.max_wait_us,
            "batch_buckets": list(self.batch_buckets),
            "buckets_used": [list(b) if isinstance(b, tuple) else b
                             for b in buckets_used],
            "closed": self._closed,
            "health": state,
            "healthy": self._healthy,
            "health_reason": self._health_reason,
            "batcher_alive": self._batcher.is_alive(),
            "delivery_alive": self._delivery.is_alive(),
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
            "wait_scale": round(self._wait_scale, 2),
            "request_us_p50": round(_pctile(lat, 0.50), 1),
            "request_us_p99": round(_pctile(lat, 0.99), 1),
            "seq_buckets": (list(self.seq_buckets)
                            if self.seq_buckets else None),
            "avg_batch_rows": (round(batched / session["batches"], 2)
                               if session["batches"] else 0.0),
            # cells (rows x T) when seqlen buckets pad; rows otherwise
            "padding_waste_pct": (
                round(pad_cells / (real_cells + pad_cells) * 100, 2)
                if real_cells + pad_cells
                else (round(padded / (batched + padded) * 100, 2)
                      if batched + padded else 0.0)),
            **session,
        }
        if self._flight is not None:
            rec["trace"] = self._flight.stats()
        if self._decoder is None:
            return rec
        with self._stats_lock:
            ttft = sorted(self._ttft_us)
        dec, alloc = self._decoder, self._slot_alloc
        it, toks, steps = (session["iterations"], session["tokens"],
                           session["slot_steps"])
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
        """``GET /kernels``: the engine's device, the decode kernel
        (decode), and each kernel's launch count
        (``ops.launch_counts()``)."""
        out = {"device": str(self._device), "launches": ops.launch_counts()}
        if self._decoder is not None:
            out["decode_kernel"] = self._decoder.decode_kernel
        return out

    def prewarm(self):
        raise NotImplementedError(
            f"InferenceEngine.prewarm() is not ported to paddle_tpu_torch "
            f"yet: {_CACHE}")

    # -------------------------------------------------------------- http
    def http_handlers(self) -> dict:
        """Path -> handler, each ``(method, body, headers[, query]) ->
        (status, content type, payload bytes[, headers])``: ``/infer``
        (the module docstring's fields and headers), ``/reload``,
        ``/stats``, ``/kernels``."""

        def reply(code, doc, headers=None):
            out = (code, "application/json", json.dumps(doc).encode())
            return out + (headers,) if headers else out

        def handle_infer(method: str, body: bytes, headers=None):
            headers = headers or {}
            if method != "POST":
                return 405, "text/plain", b"POST a JSON body\n"
            fl = self._flight
            trace = None
            if fl is not None:
                # the propagation edge: an upstream X-Ptpu-Trace (minted
                # by a client or a router) is honoured, untagged traffic
                # gets one sampled at the head rate; anomalies are kept
                # regardless by the tail-based flight recorder
                ctx = _tracectx.TraceContext.parse(
                    headers.get(_tracectx.HEADER))
                if ctx is None:
                    ctx = _tracectx.mint(fl.sample)
                trace = _tracectx.SpanBuffer(
                    ctx, "engine/request", role=self._trace_role,
                    port=self._bound_port)
                t_req0 = time.perf_counter()
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
                pin = (doc.get("model_version")
                       or headers.get("X-Ptpu-Model-Version") or None)
                pin = str(pin) if pin is not None else None
                # sampling knobs ride the body only; submit() validates
                knobs = {}
                for name, cast in (("temperature", float), ("top_k", int),
                                   ("top_p", float), ("seed", int)):
                    v = doc.get(name)
                    knobs[name] = cast(v) if v is not None else None
            except Exception as e:            # noqa: BLE001
                if fl is not None:
                    fl.finish(trace, "error", error=f"bad request: {e}")
                return reply(400, {"error": f"bad request: {e}"})
            fut = None
            try:
                fut = self.submit(samples, deadline_us=deadline_us,
                                  lane=lane, tenant=tenant,
                                  max_tokens=max_tokens, version=pin,
                                  trace=trace, **knobs)
                result = fut.result(timeout=self.http_timeout_s)
            except Overloaded as e:
                # tell retry policies WHEN, and which gate fired
                retry = max(1, int(math.ceil(e.retry_after_s)))
                if fl is not None:
                    trace.event("engine/shed", reason=e.reason)
                    fl.finish(trace, "shed", reason=e.reason)
                return reply(429, {"error": "overloaded",
                                   "reason": e.reason,
                                   "retry_after_s": e.retry_after_s},
                             {"Retry-After": str(retry)})
            except DeadlineExceeded as e:
                out = {"error": repr(e)}
                if getattr(e, "generated", None) is not None:
                    out["generated"] = int(e.generated)
                if fl is not None:
                    fl.finish(trace, "deadline")
                return reply(504, out)
            except FutureTimeout:
                if fut is not None:
                    self.cancel(fut)
                if fl is not None:
                    fl.finish(trace, "deadline", error="http timeout")
                return reply(504, {"error": "inference timed out"})
            except (EngineClosed, EngineUnhealthy) as e:
                if fl is not None:
                    fl.finish(trace, "error", error=repr(e))
                return reply(503, {"error": repr(e)})
            except ValueError as e:
                if fl is not None:
                    fl.finish(trace, "error", error=repr(e))
                return reply(400, {"error": repr(e)})
            except Exception as e:            # noqa: BLE001 - server fault
                # a 4xx would teach retry policies not to retry
                if fl is not None:
                    fl.finish(trace, "error", error=repr(e))
                return reply(500, {"error": repr(e)})
            if fl is not None:
                fl.finish(trace, "ok", latency_us=round(
                    (time.perf_counter() - t_req0) * 1e6, 1))
            fields = result if isinstance(result, list) else [result]
            out = {"outputs": {n: np.asarray(f).tolist()
                               for n, f in zip(self.output_names, fields)}}
            if self._decoder is not None:
                out["generated"] = int(len(result))
            mv = getattr(fut, "_ptt_model_version", None)
            if mv is not None:
                out["model_version"] = mv
            return reply(200, out)

        def handle_stats(method: str, body: bytes, headers=None):
            return reply(200, self.stats())

        def handle_kernels(method: str, body: bytes, headers=None):
            return reply(200, self.kernel_stats())

        def handle_reload(method: str, body: bytes, headers=None,
                          query: str = ""):
            """``POST /reload``: a bare POST runs the attached watcher's
            check now (or, with a ``{"dir": ...}`` body, loads that
            checkpoint dir once); ``?rollback=1`` rolls back;
            ``?promote=1`` promotes the canary.  With a reload key the
            request carries ``X-Ptpu-Reload-Key`` (the hex HMAC-SHA256 of
            ``<query>\n<body>``), else 403, counted."""
            if method != "POST":
                return (405, "text/plain",
                        b"POST [?rollback=1|?promote=1]\n")
            if not self._reload_authorized(body, headers, query):
                with self._err_lock:
                    self.session["reload_unauthorized"] += 1
                _C_RELOAD_UNAUTH.inc()
                return reply(403, {"error": "reload unauthorized",
                                   "reason": "bad_key"})
            qs = urllib.parse.parse_qs(query or "")
            try:
                doc = json.loads(body or b"{}")
                if not isinstance(doc, dict):
                    doc = {}
            except (ValueError, UnicodeDecodeError):
                doc = {}

            def flag(name):
                v = qs[name][0] if name in qs else doc.get(name)
                return str(v).lower() in ("1", "true", "yes")

            if flag("rollback"):
                res = self.rollback()
            elif flag("promote"):
                res = self.promote()
            elif doc.get("dir"):
                from paddle_tpu_torch.serving import reload
                res = reload.load_from(self, str(doc["dir"]))
            elif self._watcher is not None:
                res = self._watcher.check_now()
            else:
                return reply(400, {"error": "no weight watcher attached "
                                            "(serve --watch_dir) and no "
                                            "\"dir\" in the body"})
            status = (409 if str(res.get("result", "")).startswith(
                "refused") else 200)
            return reply(status, res)

        handlers = {"/infer": handle_infer, "/reload": handle_reload,
                    "/stats": handle_stats, "/kernels": handle_kernels,
                    # every prepared program of this process, with its
                    # cost and MFU (?top=N, ?table=1)
                    "/executables": _executables.http_handler}
        if self._flight is not None:
            # the /trace surface (its unauthenticated POST span ingest
            # included) exists only while tracing is on
            handlers["/trace"] = _tracectx.http_trace_handler
            handlers["/trace/"] = _tracectx.http_trace_handler
        return handlers

    def serve(self, port: int, host: str = "127.0.0.1", registry=None):
        """Serve ``http_handlers()`` and the metrics surface (``/metrics``,
        ``/metrics.json``, ``/healthz`` with this engine's liveness and
        admission state) from ONE stdlib HTTP server on a daemon thread
        (``sinks.serve_metrics``; loopback by default).  Returns the
        server; ``close()`` shuts it down."""
        from paddle_tpu_torch.observability import sinks

        self._server = sinks.serve_metrics(
            port, host=host, registry=registry,
            extra_handlers=self.http_handlers(), health_fn=self._healthz)
        self._bound_port = self._server.server_address[1]
        if self._flight is not None:
            # this process's spans carry its role and bound port, so a
            # stitched fleet timeline says which replica each came from
            _tracectx.set_process_info(self._trace_role, self._bound_port)
        return self._server

    # ----------------------------------------------------------- shutdown
    def close(self, drain_timeout_s: Optional[float] = 30.0) -> None:
        """Stop accepting requests and finish what is queued or resident.
        Work still unfinished after ``drain_timeout_s`` is shed
        (``EngineClosed``, reason ``"drain"``) instead of hanging the
        caller.  Joins an attached weight watcher first and shuts the
        HTTP server down.  Idempotent."""
        watcher, self._watcher = self._watcher, None
        if watcher is not None:
            try:
                watcher.close()
            except Exception:                 # noqa: BLE001 - best effort
                pass
        with self._close_lock:
            already, self._closed = self._closed, True
            if not already:
                self._inq.put(None)           # the batcher's drain sentinel
        self._watchdog_stop.set()
        self._batcher.join(drain_timeout_s)
        if self._batcher.is_alive():
            # a wedged forward or an over-long backlog: shed the rest (a
            # forward in flight finishes first)
            self._abort = True
            exc, reason = self._abort_exc(
                f"engine closed: drain timed out after {drain_timeout_s}s")
            self._fail_pending(exc, reason, drain_out_q=False)
            self._send_out_sentinel(give_up_s=5.0)
        else:
            self._delivery.join(drain_timeout_s)
            if self._delivery.is_alive():
                self._abort = True
                exc, reason = self._abort_exc(
                    f"engine closed: delivery did not drain within "
                    f"{drain_timeout_s}s")
                self._fail_pending(exc, reason)
                # the drained queue took the batcher's sentinel: put one
                # back so a delivery that unwedges exits
                self._send_out_sentinel(give_up_s=5.0)
        # a submit that raced the closed flag past the sentinel
        while True:
            try:
                r = self._inq.get_nowait()
            except queue.Empty:
                break
            if r is not None and r is not _WAKE:
                self._fail(r, *self._abort_exc("engine closed"))
        if self._flight is not None and self._flight.telemetry_dir:
            # incident records must survive a clean shutdown
            _tracectx.FLIGHT_WRITER.drain(timeout_s=2.0)
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    def __enter__(self) -> "InferenceEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
