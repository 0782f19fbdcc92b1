"""Continuous-batching decode server over a ``PagedDecoder``.

The decode core of ``paddle_tpu/serving/engine.py``'s ``InferenceEngine``:
``submit`` returns a ``Future``; one batcher thread runs the paged
scheduler (``_paged_loop``), which each turn admits queued prompts into free
KV slots (prefix cache consulted), grows the residents' block lists, and
runs ONE mixed iteration - every resident's decode step fused with the head
join's next prefill chunk.  A dry KV pool sheds that one sequence with
``Overloaded(reason="kv_blocks")``; a fault in the forward fails the
iteration's sequences and resets the pool, and the engine keeps serving.

``serve`` adds a stdlib HTTP front end on the reference wire format:
``POST /infer`` ``{"input": [prompt], "max_tokens": N}`` ->
``{"outputs": {"tokens": [...]}, "generated": N}`` (400 bad request, 429
overloaded with ``Retry-After``, 504 deadline, 503 closed, 500 server
fault), ``GET /healthz`` and ``GET /stats`` (iterations, tokens, pool
state, each kernel's launch count).

Tenancy, priority lanes, breakers, model versions and reload, mesh slices,
tracing and the whole-forward mode are not ported yet.
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
from typing import Dict, Optional

import numpy as np

from paddle_tpu_torch import ops
from paddle_tpu_torch.serving.blocks import KVPoolExhausted


class ServingError(RuntimeError):
    """Base of the engine's typed request-failure exceptions."""


class Overloaded(ServingError):
    """Shed for lack of capacity; ``reason`` says which
    (``"kv_blocks"``: the KV pool is dry).  ``retry_after_s`` estimates
    when capacity frees up."""

    def __init__(self, msg: str, retry_after_s: float = 1.0,
                 reason: str = "queue_full"):
        super().__init__(msg)
        self.retry_after_s = retry_after_s
        self.reason = reason


class DeadlineExceeded(ServingError):
    """The request's deadline passed (``generated`` says how many tokens
    the discarded partial output held), or its caller gave up."""


class EngineClosed(ServingError):
    """Submitted after ``close()``, or shed by a drain timeout."""


class _Request:
    __slots__ = ("prompt", "cost", "future", "t_submit", "deadline",
                 "abandoned", "__weakref__")

    def __init__(self, prompt, cost, future, t_submit, deadline):
        self.prompt = prompt
        self.cost = cost                  # max_tokens
        self.future = future
        self.t_submit = t_submit
        self.deadline = deadline          # absolute perf_counter seconds
        self.abandoned = False


class _SlotAllocator:
    """Lowest-index-first KV-slot free list, so residents stay packed in
    ``[0, highwater)`` and the decode rows track occupancy."""

    def __init__(self, n: int):
        self.n = int(n)
        self._free = list(range(self.n))
        self.occupied: set = set()
        self.highwater = 0

    def alloc(self) -> int:
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


class InferenceEngine:
    """Decode server over a ``PagedDecoder`` (module docstring).

    ``eos_id`` ends a sequence when emitted; ``default_max_tokens`` is the
    budget of a request that names none."""

    http_timeout_s = 300.0

    def __init__(self, decoder, *, eos_id: Optional[int] = None,
                 default_max_tokens: int = 64):
        if not getattr(decoder, "paged", False):
            raise TypeError("the engine schedules a PagedDecoder; the slab "
                            "SlotDecoder loop is not ported yet")
        if default_max_tokens < 1:
            raise ValueError(f"default_max_tokens must be >= 1, got "
                             f"{default_max_tokens}")
        self._decoder = decoder
        self.eos_id = None if eos_id is None else int(eos_id)
        self.default_max_tokens = int(default_max_tokens)
        self._slot_alloc = _SlotAllocator(decoder.max_slots)
        self._inq: "queue.Queue" = queue.Queue()
        self._pending: deque = deque()
        self._close_lock = threading.Lock()
        self._closed = False
        self._stopping = False
        self._abort = False
        self._stats_lock = threading.Lock()
        self._ttft_us: deque = deque(maxlen=4096)
        self._done_log: deque = deque(maxlen=256)
        self.session = {"requests": 0, "errors": 0, "iterations": 0,
                        "tokens": 0, "prefix_hits": 0,
                        "prefix_blocks_shared": 0,
                        "shed": {"kv_blocks": 0, "deadline": 0,
                                 "abandoned": 0, "drain": 0}}
        self._server = None
        self._batcher = threading.Thread(target=self._paged_loop,
                                         name="ptt-batcher", daemon=True)
        self._batcher.start()

    # ------------------------------------------------------------ intake
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
            raise ValueError("decode submit needs max_tokens >= 1")
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

    def submit(self, samples, *, max_tokens: Optional[int] = None,
               deadline_us: Optional[float] = None) -> Future:
        """Enqueue one prompt.  The Future resolves to the generated token
        ids (1-D int32, EOS included when emitted) or fails with a typed
        ``ServingError`` (or ``ValueError`` for a malformed request)."""
        fut: Future = Future()
        try:
            prompt, cost = self._decode_request(samples, max_tokens)
        except (ValueError, TypeError) as e:
            fut.set_exception(e)
            self._count_error()
            return fut
        t = time.perf_counter()
        deadline = t + deadline_us / 1e6 if deadline_us else None
        req = _Request(prompt, cost, fut, t, deadline)
        # weak: a strong ref would close a future <-> request cycle
        fut._ptt_request = weakref.ref(req)
        with self._close_lock:
            if not self._closed:
                self._inq.put(req)
                return fut
        if self._resolve(req, exc=EngineClosed("engine is closed")):
            self._count_error()
        return fut

    def infer(self, samples, timeout: Optional[float] = None, *,
              max_tokens: Optional[int] = None,
              deadline_us: Optional[float] = None):
        """submit + wait.  On a wait timeout the request is cancelled, so
        an abandoned caller never keeps its KV slot."""
        fut = self.submit(samples, max_tokens=max_tokens,
                          deadline_us=deadline_us)
        try:
            return fut.result(timeout)
        except FutureTimeout:
            self.cancel(fut)
            raise

    def cancel(self, fut: Future) -> bool:
        ref = getattr(fut, "_ptt_request", None)
        req = ref() if ref is not None else None
        if req is None or fut.done():
            return False
        req.abandoned = True
        return True

    # ------------------------------------------------------- accounting
    def _count_error(self, n: int = 1) -> None:
        with self._stats_lock:
            self.session["errors"] += n

    def _count_shed(self, reason: str) -> None:
        with self._stats_lock:
            self.session["shed"][reason] += 1

    def _retry_after_s(self) -> float:
        """Backlog drain estimate from the recent completion rate - the
        Retry-After a 429 advertises."""
        with self._stats_lock:
            log = list(self._done_log)
        depth = len(self._pending) + self._inq.qsize()
        span = log[-1] - log[0] if len(log) > 1 else 0.0
        rps = (len(log) - 1) / span if span > 0 else 0.0
        est = depth / rps if rps > 0 else 1.0
        return round(min(30.0, max(0.05, est)), 3)

    @staticmethod
    def _resolve(r: _Request, value=None, exc: Exception = None) -> bool:
        """Resolve a request's future exactly once; False when another
        path (drain, cancel) got there first."""
        try:
            if exc is not None:
                r.future.set_exception(exc)
            else:
                r.future.set_result(value)
        except InvalidStateError:
            return False
        finally:
            r.prompt = None
        return True

    # -------------------------------------------------- paged scheduler
    def _paged_loop(self) -> None:
        """Batcher-thread body: paged scheduler turns until close()
        drained everything.  An unexpected error fails the in-flight
        sequences and resets the pool; the loop keeps serving."""
        active: Dict[int, _DecodeSeq] = {}
        joins: Dict[int, _PagedJoin] = {}
        while True:
            try:
                if self._paged_iteration(active, joins):
                    return
            except Exception as e:            # noqa: BLE001 - last resort
                self._paged_fault(active, joins, e)

    def _pump(self) -> None:
        while self._inq.qsize():
            try:
                item = self._inq.get_nowait()
            except queue.Empty:
                return
            self._take(item)

    def _take(self, item) -> None:
        if item is None:                      # close() sentinel
            self._stopping = True
        else:
            self._pending.append(item)

    def _pop(self) -> Optional[_Request]:
        """Next live queued request; dead ones (deadline passed, caller
        gone) are failed here and never take a slot."""
        while self._pending:
            r = self._pending.popleft()
            if r.abandoned:
                if self._resolve(r, exc=DeadlineExceeded(
                        "request abandoned before admission")):
                    self._count_shed("abandoned")
            elif r.deadline is not None and time.perf_counter() > r.deadline:
                if self._resolve(r, exc=DeadlineExceeded(
                        "deadline exceeded before admission")):
                    self._count_shed("deadline")
            else:
                return r
        return None

    def _slot_free(self, holder: dict, slot: int) -> None:
        """The one slot-free path: every exit (finish, shed, deadline,
        fault) releases the sequence's KV blocks."""
        holder.pop(slot, None)
        self._decoder.release_sequence(slot)
        self._slot_alloc.free(slot)

    def _paged_fault(self, active, joins, e: Exception) -> None:
        """A fault in the forward: the pool every resident and join lives
        in is suspect - fail them all, re-zero the pool, keep serving."""
        n = 0
        for holder in (active, joins):
            for slot, s in list(holder.items()):
                if self._resolve(s.req, exc=e):
                    n += 1
                self._slot_free(holder, slot)
        self._count_error(n)
        self._decoder.reset()

    def _shed_kv(self, holder: dict, slot: int, req: _Request,
                 generated: int) -> None:
        """Shed ONE sequence on pool exhaustion; its blocks free now, so
        co-residents keep decoding."""
        dec = self._decoder
        retry = self._retry_after_s()
        exc = Overloaded(
            f"kv block pool exhausted: {dec.blocks.used} of "
            f"{dec.blocks.capacity} blocks hold live sequences (retry "
            f"after ~{retry}s)", retry_after_s=retry, reason="kv_blocks")
        exc.generated = generated
        if self._resolve(req, exc=exc):
            self._count_shed("kv_blocks")
        self._slot_free(holder, slot)

    def _decode_finish(self, active, slot: int, seq: _DecodeSeq,
                       t_done: float) -> None:
        self._resolve(seq.req, np.asarray(seq.out, np.int32))
        self._slot_free(active, slot)
        with self._stats_lock:
            self.session["requests"] += 1
            self._done_log.append(t_done)

    def _reap(self, holder: dict, now: float) -> None:
        """Fail residents/joins whose caller gave up or whose deadline
        passed (partial output discarded)."""
        for slot, s in list(holder.items()):
            r = s.req
            generated = len(s.out) if isinstance(s, _DecodeSeq) else 0
            if r.abandoned:
                reason = "abandoned"
                exc = DeadlineExceeded("request abandoned mid-generation")
            elif r.deadline is not None and now > r.deadline:
                reason = "deadline"
                exc = DeadlineExceeded(
                    f"deadline exceeded after {generated} of {r.cost} "
                    f"tokens (partial output discarded)")
            else:
                continue
            exc.generated = generated
            if self._resolve(r, exc=exc):
                self._count_shed(reason)
            self._slot_free(holder, slot)

    def _shed_all(self, active, joins) -> None:
        """close() timed out: fail residents, joins and the queue."""
        exc = EngineClosed("engine closed: drain timed out")
        for holder in (active, joins):
            for slot, s in list(holder.items()):
                if self._resolve(s.req, exc=exc):
                    self._count_shed("drain")
                self._slot_free(holder, slot)
        while self._pending:
            if self._resolve(self._pending.popleft(), exc=exc):
                self._count_shed("drain")

    def _paged_admit(self, active, joins, r: _Request) -> None:
        """Admit one request: take a slot, arm its block-table row
        (prefix cache consulted; a mid-block match copies one block), and
        queue it as a join."""
        slot = self._slot_alloc.alloc()
        try:
            matched = self._decoder.alloc_sequence(slot, r.prompt)
        except KVPoolExhausted:
            self._shed_kv(joins, slot, r, 0)
            return
        except ValueError as e:           # the request's own fault
            if self._resolve(r, exc=e):
                self._count_error()
            self._slot_free(joins, slot)
            return
        if matched:
            with self._stats_lock:
                self.session["prefix_hits"] += 1
                self.session["prefix_blocks_shared"] += (
                    -(-matched // self._decoder.block_size))
        joins[slot] = _PagedJoin(r, slot, matched)

    def _paged_iteration(self, active, joins) -> bool:
        """One scheduler turn: intake, reap, admit, grow block lists, then
        ONE mixed dispatch.  Returns True when the loop should exit."""
        dec = self._decoder
        alloc = self._slot_alloc
        self._pump()
        if self._abort:
            self._shed_all(active, joins)
            return True
        now = time.perf_counter()
        self._reap(active, now)
        self._reap(joins, now)
        while len(alloc) < alloc.n:
            r = self._pop()
            if r is None:
                break
            self._paged_admit(active, joins, r)
        if not active and not joins:
            if self._stopping and not self._pending:
                return True
            self._take(self._inq.get())   # idle: block for work
            return False
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
        for slot, seq in active.items():
            tokens[slot] = seq.last
            pos[slot] = seq.pos
            live[slot] = True
        try:
            nxt, cnxt = dec.mixed_step(m, tokens, pos, live=live,
                                       chunk=chunk)
        except Exception as e:                # noqa: BLE001 - isolate
            self._paged_fault(active, joins, e)
            return False
        t_done = time.perf_counter()
        with self._stats_lock:
            self.session["iterations"] += 1
            self.session["tokens"] += len(active)
        for slot, seq in list(active.items()):
            tok = int(nxt[slot])
            seq.out.append(tok)
            seq.pos += 1
            seq.last = tok
            if (self.eos_id is not None and tok == self.eos_id) \
                    or len(seq.out) >= seq.req.cost:
                self._decode_finish(active, slot, seq, t_done)
        if cj is not None:
            cj.written += len(chunk[1])
            if cj.written >= len(cj.req.prompt):
                # prompt complete: cnxt is the first generated token
                r = cj.req
                joins.pop(cj.slot)
                dec.register_prefix(cj.slot)
                with self._stats_lock:
                    self._ttft_us.append((t_done - r.t_submit) * 1e6)
                seq = _DecodeSeq(r, cj.slot, len(r.prompt), int(cnxt))
                active[cj.slot] = seq
                if (self.eos_id is not None and int(cnxt) == self.eos_id) \
                        or r.cost <= 1:
                    self._decode_finish(active, cj.slot, seq, t_done)
        return False

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._stats_lock:
            sess = json.loads(json.dumps(self.session))
            ttft = sorted(self._ttft_us)
        dec = self._decoder
        sess["ttft_us"] = {
            "count": len(ttft),
            "p50": ttft[len(ttft) // 2] if ttft else None,
            "max": ttft[-1] if ttft else None}
        sess["device"] = str(dec.device)
        sess["decode_kernel"] = dec.decode_kernel
        sess["kv"] = dec.pool_stats()
        sess["kernels"] = ops.launch_counts()
        sess["queue_depth"] = len(self._pending) + self._inq.qsize()
        return sess

    # -------------------------------------------------------------- http
    def _handle_infer(self, body: bytes):
        """(status, json body, extra headers) for one POST /infer."""
        try:
            doc = json.loads(body or b"{}")
            samples = doc["input"]
            if not isinstance(samples, list):
                raise ValueError("'input' must be a list of samples")
            mt = doc.get("max_tokens")
            max_tokens = int(mt) if mt is not None else None
            dl = doc.get("deadline_ms")
            deadline_us = float(dl) * 1000.0 if dl is not None else None
        except Exception as e:                # noqa: BLE001
            return 400, {"error": f"bad request: {e}"}, {}
        fut = None
        try:
            fut = self.submit(samples, max_tokens=max_tokens,
                              deadline_us=deadline_us)
            result = fut.result(timeout=self.http_timeout_s)
        except Overloaded as e:
            retry = max(1, int(math.ceil(e.retry_after_s)))
            return (429, {"error": "overloaded", "reason": e.reason,
                          "retry_after_s": e.retry_after_s},
                    {"Retry-After": str(retry)})
        except DeadlineExceeded as e:
            out = {"error": repr(e)}
            if getattr(e, "generated", None) is not None:
                out["generated"] = int(e.generated)
            return 504, out, {}
        except FutureTimeout:
            if fut is not None:
                self.cancel(fut)
            return 504, {"error": "inference timed out"}, {}
        except EngineClosed as e:
            return 503, {"error": repr(e)}, {}
        except ValueError as e:
            return 400, {"error": repr(e)}, {}
        except Exception as e:                # noqa: BLE001 - server fault
            return 500, {"error": repr(e)}, {}
        return (200, {"outputs": {"tokens": result.tolist()},
                      "generated": int(len(result))}, {})

    def _healthz(self):
        if self._closed or not self._batcher.is_alive():
            return 503, "draining\n" if self._closed else "dead\n"
        return 200, "ok\n"

    def serve(self, port: int, host: str = "127.0.0.1"):
        """Serve ``/infer``, ``/stats`` and ``/healthz`` from a stdlib
        threading HTTP server on a daemon thread (loopback by default).
        Returns the server; ``close()`` shuts it down."""
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

            def _json(self, code, doc, headers=None):
                self._send(code, "application/json",
                           json.dumps(doc).encode(), headers)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/healthz":
                    code, text = engine._healthz()
                    self._send(code, "text/plain", text.encode())
                elif path == "/stats":
                    self._json(200, engine.stats())
                else:
                    self._json(404, {"error": f"no route {path}"})

            def do_POST(self):
                path = self.path.split("?", 1)[0]
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n)
                if path != "/infer":
                    self._json(404, {"error": f"no route {path}"})
                    return
                code, doc, headers = engine._handle_infer(body)
                self._json(code, doc, headers)

            def log_message(self, *args):
                pass

        server = ThreadingHTTPServer((host, port), Handler)
        server.daemon_threads = True
        threading.Thread(target=server.serve_forever, name="ptt-http",
                         daemon=True).start()
        self._server = server
        return server

    # ----------------------------------------------------------- shutdown
    def close(self, drain_timeout_s: Optional[float] = 30.0) -> None:
        """Stop accepting requests and finish what is queued or resident.
        Work still unfinished after ``drain_timeout_s`` fails with
        ``EngineClosed``.  Shuts the HTTP server down.  Idempotent."""
        with self._close_lock:
            already, self._closed = self._closed, True
            if not already:
                self._inq.put(None)           # batcher drain sentinel
        self._batcher.join(drain_timeout_s)
        if self._batcher.is_alive():
            # the batcher sheds everything left at its next turn (a forward
            # in flight finishes first)
            self._abort = True
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    def __enter__(self) -> "InferenceEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
