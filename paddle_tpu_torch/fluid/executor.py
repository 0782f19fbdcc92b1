"""Executor: runs a Program's block op by op (counterpart of
``paddle_tpu/fluid/executor.py``).

The reference's ``Executor::Run`` (``paddle/fluid/framework/executor.cc:80``)
interprets the op list: per op, create it, pick its kernel, launch.  This
executor is that interpreter over torch: ``run_block`` calls each op's
function eagerly on the executor's place, with the persistable variables
(parameters, optimizer slots, BN statistics) read from a ``Scope`` and the
rewritten ones written back after the block.  The JAX package instead
lowers the whole block to one jitted computation, and ``run_n`` to one
scan of n steps; the counterpart here is ``run_n`` (and
``prepare(...).run_n``) as one captured CUDA graph of the n steps
(``core/prepared.py``).

Gradient ops (``<type>_grad``, built by ``backward.py``) recompute their
forward op once, under autograd, and take ``torch.autograd.grad`` of it:
one forward launch more per grad op, not the two of a probe and a vjp.
A control-flow op's sub-block runs inside its op with the caller's grad
mode (``run_sub_block``), so the recomputation inside a grad op records
the loop for autograd.

Random ops draw from a counter-based stream (``OpRunCtx``): each draw is a
hash of (seed, step, the loop indices folded in, the op's ``__rng_id__``,
the draw's number in the op) and the element's index, computed on the
op's device.  The step is a device tensor under ``run_n``, so a captured
graph's replays draw what the same steps draw eagerly, and a dropout
mask recomputed inside its grad op equals the forward's.  (Torch cannot
reproduce JAX's streams: the draws are the port's own.)

Telemetry is the JAX executor's ``fluid_*`` catalog (no-ops while it is
off): plan cache hits, misses and evictions (a stale plan replaced),
``fluid_steps_total``, ``fluid_compiles_total{cause="fresh_feed_shape"}``
(the port's builds: a run plan's first run of a feed signature, a
``run_n`` capture), the ``run_n`` chunks, steps and stand-downs by reason
(``fluid_run_n_fallback_steps_total``: ``check_nan_inf``,
``capture_vars`` and ``host_sync``, the last the debugger's ``print``
and the other host-reading ops), the feed, dispatch, run and chunk
histograms, and the ``fluid/plan_lookup|feed_coerce|dispatch|run_n_chunk``
spans with their step ids.  Each (plan, feed signature) is a
``fluid`` / ``run_plan`` row of the executable registry and each
``run_n`` chunk a ``fluid`` / ``run_n`` row.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch.fluid import framework
from paddle_tpu_torch.fluid.framework import Block, Program, Variable
from paddle_tpu_torch.fluid.ops import OPS, get_op, torch_dtype
from paddle_tpu_torch.observability import executables as _executables
from paddle_tpu_torch.observability import metrics as _metrics
from paddle_tpu_torch.observability import tracing as _tracing

# the reasons run_n stands down to n eager runs (the JAX package's
# _M_RUN_N_FALLBACK reasons, and "host_sync")
STANDDOWN_REASONS = ("check_nan_inf", "capture_vars", "aliased_buffer",
                     "host_sync")

# The JAX executor's telemetry handles, pre-bound at import.
_M_PLAN_HITS = _metrics.counter(
    "fluid_plan_cache_hits_total", "run-plan cache hits (steady state)")
_M_PLAN_MISSES = _metrics.counter(
    "fluid_plan_cache_misses_total",
    "run-plan builds (fresh program/fetch set or version bump)")
_M_PLAN_EVICT = _metrics.counter(
    "fluid_plan_cache_evictions_total",
    "stale-version executables dropped on program mutation")
_M_STEPS = _metrics.counter(
    "fluid_steps_total", "Executor._run_plan invocations")
_M_COMPILE = _metrics.counter(
    "fluid_compiles_total", "XLA compiles by cause",
    cause="fresh_feed_shape")
_M_RUN_N_CHUNKS = _metrics.counter(
    "fluid_run_n_chunks_total",
    "scan-amortized run_n chunk dispatches (one executable launch each)")
_M_RUN_N_STEPS = _metrics.counter(
    "fluid_run_n_steps_total",
    "train steps executed inside scan-amortized run_n chunks")
_M_RUN_N_FALLBACK = {r: _metrics.counter(
    "fluid_run_n_fallback_steps_total",
    "run_n steps that stood down to the per-step path, by reason",
    reason=r) for r in STANDDOWN_REASONS}
_H_FEED = _metrics.histogram(
    "fluid_feed_coerce_us", "feed dtype coercion + shape-signature time")
_H_DISPATCH = _metrics.histogram(
    "fluid_dispatch_us",
    "executable lookup + dispatch wall time (compile steps included)")
_H_RUN = _metrics.histogram(
    "fluid_run_us", "end-to-end _run_plan wall time")
_H_RUN_N = _metrics.histogram(
    "fluid_run_n_chunk_us", "end-to-end run_n chunk wall time (n steps)")
_ns = time.perf_counter_ns
_get_ident = threading.get_ident


class Scope:
    """Name -> tensor store for persistable variables (reference
    ``framework/scope.h:38``).  ``set`` takes a tensor or an array; the
    executor moves a value to its place when a run reads it."""

    def __init__(self):
        self.vars: Dict[str, object] = {}

    def set(self, name: str, value):
        self.vars[name] = value

    def get(self, name: str):
        return self.vars[name]

    def has(self, name: str) -> bool:
        return name in self.vars

    def find_var(self, name: str):
        return self.vars.get(name)


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


# ---------------------------------------------------------------------------
# the counter-based random stream: lowbias32 (a 32-bit integer hash) in
# int64 arithmetic that never overflows, on python ints and torch tensors
# alike
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """x * c mod 2^32 for 0 <= x, c < 2^32, every product below 2^49."""
    return ((x & 0xFFFF) * c + (((x >> 16) * c) & 0xFFFF) * 65536) & _M32


def _mix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


class OpRunCtx:
    """Per-op context: the train flag, the place, the run's values and
    the op's random stream.

    Each stateful-RNG op carries a stable ``__rng_id__`` attr; the forward
    op and its grad op derive the same keys from (seed, step, fold,
    rng_id, draw number), so a dropout mask recomputed inside the grad op
    equals the forward's.  ``step`` is an int, or a 0-d int64 tensor on
    the device inside ``run_n`` (the same keys, computed on the card).
    ``fold`` holds the loop indices of the sub-blocks the op runs in, as
    the JAX package folds a scan index into its key.  ``values`` is the
    run's top-level values (a grad op's replay reads a captured trip count
    there)."""

    def __init__(self, train: bool, device: torch.device, seed: int,
                 step, rng_id: int, values: Optional[dict] = None,
                 fold: tuple = ()):
        self.train = train
        self.device = device
        self.values = values
        self._base = (seed, step, rng_id)
        self._fold = tuple(fold)
        self._calls = 0

    def sub_block_ctx(self, t: Optional[int] = None) -> Callable:
        """``mk_ctx`` for the ops of a sub-block this op runs (iteration
        ``t`` of a loop, or None for a branch)."""
        seed, step, _ = self._base
        fold = self._fold + (() if t is None else (t,))
        return lambda rng_id: OpRunCtx(self.train, self.device, seed, step,
                                       rng_id, self.values, fold)

    def _key(self):
        seed, step, rng_id = self._base
        k = _mix32((seed ^ (seed >> 32)) & _M32)
        for part in (step,) + self._fold + (rng_id, self._calls):
            k = _mix32(k ^ (part & _M32))
        self._calls += 1
        return k

    def _bits(self, shape) -> torch.Tensor:
        """uniform 32-bit words (int64) of ``shape``, one draw."""
        k1 = self._key()
        k2 = _mix32(k1 ^ 0x9E3779B9)
        n = int(np.prod(shape)) if len(shape) else 1
        idx = torch.arange(n, dtype=torch.int64, device=self.device)
        return _mix32(_mix32(idx ^ k1) ^ k2).reshape(shape)

    def uniform(self, shape) -> torch.Tensor:
        """float32 uniform on [0, 1), 24 bits each."""
        return (self._bits(shape) >> 8).to(torch.float32) * 2.0 ** -24

    def normal(self, shape) -> torch.Tensor:
        """float32 standard normal (Box-Muller on two draws)."""
        u1 = ((self._bits(shape) >> 8) + 1).to(torch.float32) * 2.0 ** -24
        u2 = self.uniform(shape)
        return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
            2.0 * np.pi * u2)

    def randint(self, high: int, shape) -> torch.Tensor:
        """int64 uniform on [0, high)."""
        return self._bits(shape) % high


def _run_forward_op(op, env, mk_ctx):
    opdef = get_op(op.type)
    ins = {slot: [env[n] for n in op.inputs.get(slot, []) if n]
           for slot in opdef.inputs}
    outs = opdef.fn(mk_ctx(op.attrs.get("__rng_id__", 0)), op.attrs, ins)
    for slot, names in op.outputs.items():
        for name, val in zip(names, outs.get(slot, [])):
            if name:
                env[name] = val


def _run_grad_op(op, env, mk_ctx):
    """The input gradients of one forward op: its forward recomputed once
    under autograd (the same random stream as the forward's), then one
    ``torch.autograd.grad`` with the output gradients found in ``env``;
    an output with no gradient contributes none."""
    opdef = get_op(op.attrs["fwd_type"])
    fwd_ins = {slot: [env[n] for n in op.inputs.get(slot, [])]
               for slot in opdef.inputs}
    diff_pos = [(slot, i, gname) for slot in opdef.inputs
                for i, gname in enumerate(op.outputs.get(slot + "@GRAD", []))
                if gname]
    if not diff_pos:
        return
    leaves = []
    with torch.enable_grad():
        ins = {s: list(vs) for s, vs in fwd_ins.items()}
        for slot, i, _ in diff_pos:
            ins[slot][i] = ins[slot][i].detach().requires_grad_(True)
            leaves.append(ins[slot][i])
        outs = opdef.fn(mk_ctx(op.attrs.get("__rng_id__", 0)), op.attrs,
                        ins)
    ys, cots = [], []
    for slot in opdef.outputs:
        gnames = op.inputs.get(slot + "@GRAD", [])
        for i, val in enumerate(outs.get(slot, [])):
            gname = gnames[i] if i < len(gnames) else ""
            if val.requires_grad and gname and gname in env:
                ys.append(val)
                cots.append(env[gname].to(val.dtype))
    grads = (torch.autograd.grad(ys, leaves, cots, allow_unused=True)
             if ys else [None] * len(leaves))
    for (_, _, gname), leaf, g in zip(diff_pos, leaves, grads):
        env[gname] = torch.zeros_like(leaf) if g is None else g


class _CaptureError(RuntimeError):
    pass


def run_sub_block(block: Block, env: dict, mk_ctx) -> None:
    """Run every op of a block in order, eagerly, writing ``env``, in the
    caller's grad mode: a control-flow op recomputed inside its grad op
    records its sub-block for autograd.  Inside a CUDA graph capture an
    op that fails is named."""
    capturing = (torch.cuda.is_available()
                 and torch.cuda.is_current_stream_capturing())
    for op in block.ops:
        try:
            if op.type.endswith("_grad") and "fwd_type" in op.attrs:
                _run_grad_op(op, env, mk_ctx)
            else:
                _run_forward_op(op, env, mk_ctx)
        except Exception as e:
            if not capturing or isinstance(e, _CaptureError):
                raise
            raise _CaptureError(
                f"fluid op {op.type!r} cannot be captured in a CUDA graph "
                f"(the steps do not run eagerly instead): {e}") from e


def run_block(block: Block, env: dict, mk_ctx) -> None:
    """Run a program's block: ``run_sub_block`` with autograd off (each
    grad op turns it on for its own recomputation).  ``mk_ctx(rng_id)``
    makes an op's ``OpRunCtx``."""
    with torch.no_grad():
        run_sub_block(block, env, mk_ctx)


class _Plan:
    """What a run needs that depends only on the program's structure and
    the fetch set: built once per (program, version, fetches) and cached
    on the executor."""

    def __init__(self, program: Program, fetch_names: tuple):
        self.program = program
        self.version = program.version
        self.fetch_names = fetch_names
        self.block = program.global_block()
        ops = [op for blk in program.blocks for op in blk.ops]
        types = [op.attrs["fwd_type"] if op.type.endswith("_grad")
                 and "fwd_type" in op.attrs else op.type for op in ops]
        for t in types:               # an unknown op refuses the program
            get_op(t)
        read = {n for op in ops for n in op.input_names()}
        self.written = {n for op in ops for n in op.output_names()}
        self.persist = [v for v in program.list_vars() if v.persistable
                        and (v.name in read or v.name in self.written
                             or v.name in fetch_names)]
        self.persist_out = [v.name for v in self.persist
                            if v.name in self.written]
        # a bounded_while replay whose bound is the forward's trip count
        self.capture_vars = [op.attrs["trips_var"] for op in ops
                             if op.attrs.get("max_trip_count")
                             == "__capture__"]
        self.host_sync = any(OPS[t].host_sync for t in types)
        # the executable registry's rows of this plan, by feed signature
        self.exes: dict = {}
        self._sha = None

    def feed_dtype(self, name: str) -> str:
        return self.block.var(name).dtype

    def identity(self) -> tuple:
        """The plan's identity parts of its registry fingerprints: the
        sha-256 of the program's canonical JSON, and the fetches."""
        if self._sha is None:
            data = json.dumps(self.program.to_json_dict(),
                              sort_keys=True).encode()
            self._sha = hashlib.sha256(data).hexdigest()
        return (self._sha, self.fetch_names)


class CompiledProgram:
    """A prepared (program, fetch set), made by ``Executor.prepare``:
    ``run(feed)`` skips the per-call program walk, ``run_n(feed, n)``
    runs n steps as one captured CUDA graph on the card.  A program
    changed after ``prepare`` gets a fresh plan (its version moved)."""

    def __init__(self, exe: "Executor", program: Program,
                 fetch_names: tuple, scope: Optional[Scope], seed: int,
                 train: bool = True):
        self._exe = exe
        self._program = program
        self._fetch_names = fetch_names
        self._scope = scope
        self._seed = seed
        self._train = train
        self._plan = exe._plan_for(program, fetch_names)

    @property
    def program(self) -> Program:
        return self._program

    def _resolve_plan(self) -> _Plan:
        if self._plan.version != self._program.version:
            self._plan = self._exe._plan_for(self._program,
                                             self._fetch_names)
        return self._plan

    def run(self, feed: Optional[Dict[str, np.ndarray]] = None,
            scope: Optional[Scope] = None, return_numpy: bool = True,
            check_nan_inf: bool = False):
        # the prepared path skips the plan lookup by design, so it never
        # counts a plan-cache hit
        if _metrics._enabled:
            t0 = _ns()
            plan = self._resolve_plan()
            plan_ns = (t0, _ns() - t0, False)
        else:
            plan, plan_ns = self._resolve_plan(), None
        return self._exe._run_plan(
            plan, feed or {}, scope or self._scope or global_scope(),
            return_numpy, self._seed, check_nan_inf, self._train, plan_ns)

    def run_n(self, feed, n: int, scope: Optional[Scope] = None,
              return_numpy: bool = True, check_nan_inf: bool = False):
        """n steps as one dispatch (see ``Executor.run_n``)."""
        return self._exe._run_plan_n(
            self._resolve_plan(), feed, n,
            scope or self._scope or global_scope(), return_numpy,
            self._seed, check_nan_inf, self._train)


def _unported_option(name: str, item: str):
    raise NotImplementedError(
        f"Executor({name}=...) is not ported to paddle_tpu_torch yet "
        f"(ROADMAP.md section 1, item {item})")


class Executor:
    """Runs programs (reference ``v2/fluid/executor.py:166``,
    ``framework/executor.cc:80``) on ``place``: ``CUDAPlace(0)`` when
    none is given, which raises with no card; ``CPUPlace()`` runs on the
    host.  ``mesh`` (and its ``mesh_rules`` / ``param_axes``, item 14),
    ``donate``, ``compile_cache`` and ``bake_key`` (item 13b) are taken
    only at their defaults, which raise nothing: the eager executor
    rebinds names and a captured chunk updates the scope's tensors in
    place, so no buffer is donated, and no executable is cached."""

    def __init__(self, place: Optional[object] = None, mesh=None,
                 donate: bool = True, compile_cache=None, bake_key=None,
                 mesh_rules=None, param_axes=None):
        if mesh is not None or mesh_rules is not None \
                or param_axes is not None:
            _unported_option("mesh", "14")
        if donate is not True:
            _unported_option("donate", "13b")
        if compile_cache is not None:
            _unported_option("compile_cache", "13b")
        if bake_key is not None:
            _unported_option("bake_key", "13b")
        self.place = framework.CUDAPlace(0) if place is None else place
        self.device = self.place.torch_device()
        self._step = 0
        self._plans: Dict[tuple, _Plan] = {}
        self._family = None
        #: run_n steps that ran as n eager runs instead, by reason
        self.run_n_standdowns = {r: 0 for r in STANDDOWN_REASONS}

    # ------------------------------------------------------------ plans
    def _plan_for(self, program: Program, fetch_names: tuple) -> _Plan:
        key = (id(program), fetch_names)
        plan = self._plans.get(key)
        if plan is None or plan.version != program.version \
                or plan.program is not program:
            if plan is not None:
                _M_PLAN_EVICT.inc()
            _M_PLAN_MISSES.inc()
            plan = self._plans[key] = _Plan(program, fetch_names)
        return plan

    @staticmethod
    def _fetch_names(fetch_list) -> tuple:
        return tuple(v.name if isinstance(v, Variable) else str(v)
                     for v in (fetch_list or []))

    def prepare(self, program: Optional[Program] = None,
                feed_names: Optional[List[str]] = None,
                fetch_list: Optional[List] = None,
                scope: Optional[Scope] = None, seed: int = 0,
                for_test: bool = False) -> CompiledProgram:
        """The plan for (program, fetch_list), held by a
        ``CompiledProgram``.  ``for_test=True`` runs the ops in inference
        mode (dropout passes through, batch_norm reads its running
        statistics).  ``feed_names`` is accepted for the JAX signature."""
        program = program or framework.default_main_program()
        return CompiledProgram(self, program,
                               self._fetch_names(fetch_list), scope, seed,
                               train=not for_test)

    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict[str, np.ndarray]] = None,
            fetch_list: Optional[List] = None,
            scope: Optional[Scope] = None,
            return_numpy: bool = True,
            seed: int = 0,
            check_nan_inf: bool = False):
        """Run the program's global block once: feeds are cast to their
        variables' dtypes and copied to the place, the fetched values come
        back as numpy arrays (tensors with ``return_numpy=False``), and the
        persistables the block wrote go back into ``scope``.

        ``check_nan_inf``: every fetched and rewritten floating value must
        be finite (reference FLAGS_check_nan_inf, executor.cc:67), else
        ``FloatingPointError`` before anything is committed to the scope,
        which keeps its tensors as they were (no op writes a scope tensor
        in place: each returns new ones)."""
        program = program or framework.default_main_program()
        fetch_names = self._fetch_names(fetch_list)
        if _metrics._enabled:
            t0 = _ns()
            cached = self._plans.get((id(program), fetch_names))
            plan = self._plan_for(program, fetch_names)
            # a hit iff the lookup returned the probed plan
            plan_ns = (t0, _ns() - t0, cached is plan)
        else:
            plan = self._plan_for(program, fetch_names)
            plan_ns = None
        return self._run_plan(plan, feed or {}, scope or global_scope(),
                              return_numpy, seed, check_nan_inf, True,
                              plan_ns)

    def run_n(self, program: Optional[Program] = None, feed=None,
              n: int = 1, fetch_list: Optional[List] = None,
              scope: Optional[Scope] = None, return_numpy: bool = True,
              seed: int = 0, check_nan_inf: bool = False):
        """Run ``n`` sequential steps as one dispatch: on the card one
        captured CUDA graph of the n steps (``core/prepared.py``), on the
        CPU the n steps one after the other.

        ``feed`` is a dict of arrays with a leading ``[n]`` axis (step i
        takes ``feed[name][i]``) or a callable ``feed_fn(i)`` returning
        step i's feed.  Fetches come back with a leading ``[n]`` axis.
        The scope after the chunk equals n ``run()`` calls bit for bit
        (the random stream included) and the step counter moves by n.

        A program that cannot be captured runs as n ``run()`` calls,
        counted in ``run_n_standdowns`` by reason: ``check_nan_inf``
        (abort before commit is per step), ``capture_vars`` (a While
        gradient replayed at the forward's trip count) and ``host_sync``
        (an op that reads a value back to the host: the unbounded
        ``while``, ``conditional_block``'s branch, ``print``).  A capture
        that fails for any other reason raises, naming the op."""
        program = program or framework.default_main_program()
        plan = self._plan_for(program, self._fetch_names(fetch_list))
        return self._run_plan_n(plan, feed, n, scope or global_scope(),
                                return_numpy, seed, check_nan_inf, True)

    # ------------------------------------------------------------ one run
    def _persistables(self, plan: _Plan, scope: Scope) -> dict:
        env = {}
        for var in plan.persist:
            name = var.name
            if scope.has(name):
                env[name] = self._to_place(scope.get(name))
                scope.set(name, env[name])
            elif name in plan.written:
                # written before it is read: a placeholder
                env[name] = torch.zeros(var.shape,
                                        dtype=torch_dtype(var.dtype),
                                        device=self.device)
            else:
                raise RuntimeError(
                    f"persistable var {name!r} is not initialized — "
                    f"run the startup program first")
        return env

    def _feed_tensors(self, plan: _Plan, feed: dict) -> dict:
        return {name: torch.as_tensor(
            np.asarray(val, dtype=plan.feed_dtype(name)), device=self.device)
            for name, val in feed.items()}

    def _observed_block(self, plan: _Plan, feed_tensors: dict, train: bool,
                        run: Callable):
        """``run()`` (the block) as a dispatch of ``plan``'s registry row
        at this feed signature; a new signature is a build."""
        from paddle_tpu_torch.core.prepared import feed_signature
        sig = (train, feed_signature(feed_tensors))

        def register():
            _M_COMPILE.inc()
            return _executables.register(
                stack="fluid", kind="run_plan",
                fingerprint=_executables.fingerprint(*plan.identity(), sig),
                feed_sig=sig[1])

        return _executables.observe(plan.exes, sig, self.device, run,
                                    register)[1]

    def _run_plan(self, plan: _Plan, feed: dict, scope: Scope,
                  return_numpy: bool, seed: int, check_nan_inf: bool,
                  train: bool, plan_ns=None):
        obs = _metrics._enabled
        if obs:
            t0 = _ns()
        env = self._persistables(plan, scope)
        feed_t = self._feed_tensors(plan, feed)
        env.update(feed_t)
        step = self._step
        self._step += 1

        def mk_ctx(rng_id):
            return OpRunCtx(train, self.device, seed, step, rng_id, env)

        if obs:
            t1 = t2 = _ns()
            ent = self._observed_block(
                plan, feed_t, train,
                lambda: run_block(plan.block, env, mk_ctx))
            t3 = _ns()
        else:
            run_block(plan.block, env, mk_ctx)
        fetched = [env[n] for n in plan.fetch_names]
        new = {n: env[n] for n in plan.persist_out if n in env}
        if check_nan_inf:
            _check_finite(list(zip(plan.fetch_names, fetched))
                          + list(new.items()))
        for name, val in new.items():
            scope.set(name, val)
        out = ([v.detach().cpu().numpy() for v in fetched] if return_numpy
               else fetched)
        if obs:
            # one fused flush (see metrics.record for the span layout)
            t_end = _ns()
            tid = _get_ident()
            spans = [("fluid/feed_coerce", "host", t0, t1 - t0, step, tid,
                      None),
                     ("fluid/dispatch", "host", t2, t3 - t2, step, tid,
                      {"exe": ent.short})]
            counters = [(_M_STEPS, 1)]
            if plan_ns is not None:
                spans.append(("fluid/plan_lookup", "host", plan_ns[0],
                              plan_ns[1], step, tid, None))
                if plan_ns[2]:
                    counters.append((_M_PLAN_HITS, 1))
            _metrics.record(counters,
                            ((_H_FEED, (t1 - t0) / 1e3),
                             (_H_DISPATCH, (t3 - t2) / 1e3),
                             (_H_RUN, (t_end - t0) / 1e3)),
                            spans, _tracing.TRACER)
        return out

    # ------------------------------------------------------------ n runs
    def _stacked_feed(self, plan: _Plan, feed, n: int) -> dict:
        if callable(feed):
            per_step = [feed(i) for i in range(n)]
            return {name: np.stack([np.asarray(d[name],
                                               dtype=plan.feed_dtype(name))
                                    for d in per_step])
                    for name in (per_step[0] if per_step else {})}
        vals = {name: np.asarray(v, dtype=plan.feed_dtype(name))
                for name, v in (feed or {}).items()}
        for name, v in vals.items():
            if v.ndim < 1 or v.shape[0] != n:
                raise ValueError(
                    f"run_n feed {name!r} needs a leading [{n}] step "
                    f"axis, got shape {v.shape}")
        return vals

    def _run_plan_n(self, plan: _Plan, feed, n: int, scope: Scope,
                    return_numpy: bool, seed: int, check_nan_inf: bool,
                    train: bool):
        n = int(n)
        if n < 1:
            raise ValueError(f"run_n needs n >= 1, got {n}")
        obs = _metrics._enabled
        if obs:
            step_id = self._step
            t0 = _ns()
        feeds = self._stacked_feed(plan, feed, n)
        reason = ("check_nan_inf" if check_nan_inf
                  else "capture_vars" if plan.capture_vars
                  else "host_sync" if plan.host_sync else None)
        if reason is not None:
            self.run_n_standdowns[reason] += n
            _M_RUN_N_FALLBACK[reason].inc(n)
            outs = [self._run_plan(plan, {k: v[i] for k, v in feeds.items()},
                                   scope, return_numpy, seed, check_nan_inf,
                                   train) for i in range(n)]
            stack = np.stack if return_numpy else torch.stack
            return [stack([o[j] for o in outs])
                    for j in range(len(plan.fetch_names))]
        from paddle_tpu_torch.core.prepared import (PreparedFamily,
                                                    feed_signature)

        if self._family is None:
            self._family = PreparedFamily(self.device, stack="fluid")
        state = self._persistables(plan, scope)
        feeds = {k: torch.as_tensor(v, device=self.device)
                 for k, v in feeds.items()}
        feeds["__step__"] = torch.arange(self._step, self._step + n,
                                         dtype=torch.int64,
                                         device=self.device)
        kind = ("fluid", id(plan.program), plan.version, plan.fetch_names,
                seed, train)
        entry = self._family.entries.get((kind, n, feed_signature(feeds)))
        if entry is None:
            # the chunk's state: copies of the scope's tensors, which the
            # chunk's steps update in place
            own = {k: v.clone() for k, v in state.items()}
            entry = self._family.get(
                kind, n, feeds, _chunk_step(plan, own, self.device, seed,
                                            train),
                lambda: list(own.values()), exe_kind="run_n",
                identity=plan.identity() + (seed, train))
            entry.fluid_state = own
            _M_COMPILE.inc()
        # a run() between chunks rebinds the scope: its values go into
        # the chunk's tensors, which the scope then holds
        for name, t in entry.fluid_state.items():
            if state[name] is not t:
                t.copy_(state[name])
            scope.set(name, t)
        self._step += n
        fetched = entry(feeds)
        out = ([v.detach().cpu().numpy() for v in fetched] if return_numpy
               else fetched)
        if obs:
            t_end = _ns()
            args = {"n": n}
            if entry.exe is not None:
                args["exe"] = entry.exe.short
            _metrics.record(
                ((_M_RUN_N_CHUNKS, 1), (_M_RUN_N_STEPS, n)),
                ((_H_RUN_N, (t_end - t0) / 1e3),),
                (("fluid/run_n_chunk", "host", t0, t_end - t0, step_id,
                  _get_ident(), args),),
                _tracing.TRACER)
        return out

    def _to_place(self, value) -> torch.Tensor:
        if isinstance(value, torch.Tensor):
            return value.to(self.device)
        return torch.as_tensor(np.array(value), device=self.device)


def _check_finite(pairs) -> None:
    """FloatingPointError naming the first non-finite value; one fused
    reduction (one host read) when all are finite."""
    pairs = [(n, v) for n, v in pairs if v.is_floating_point()]
    if not pairs:
        return
    if bool(torch.stack([torch.isfinite(v).all() for _, v in pairs]).all()):
        return
    for name, v in pairs:
        if not bool(torch.isfinite(v).all()):
            raise FloatingPointError(
                f"var {name!r} contains NaN/Inf (check_nan_inf); state not "
                f"committed")


def _chunk_step(plan: _Plan, state: dict, device, seed: int, train: bool):
    """One step of a run_n chunk over the chunk's own state tensors: the
    block runs as in ``run()``, then every rewritten persistable is copied
    into its state tensor in place (a captured graph's buffers are
    static), and the fetches come back as new tensors."""
    owned = {id(t) for t in state.values()}

    def step(feed: dict) -> list:
        env = dict(state)
        env.update({k: v for k, v in feed.items() if k != "__step__"})

        def mk_ctx(rng_id):
            return OpRunCtx(train, device, seed, feed["__step__"], rng_id,
                            env)

        run_block(plan.block, env, mk_ctx)
        fetched = [env[n].clone() if id(env[n]) in owned else env[n]
                   for n in plan.fetch_names]
        new = {n: (env[n].clone() if id(env[n]) in owned else env[n])
               for n in plan.persist_out if n in env}
        for name, val in new.items():
            state[name].copy_(val)
        return fetched

    return step
