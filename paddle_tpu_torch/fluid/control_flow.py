"""Control flow: StaticRNN, DynamicRNN, While, ConditionalBlock, IfElse,
Switch, the tensor arrays and ParallelDo (counterpart of
``paddle_tpu/fluid/control_flow.py``; the same ops, sub-blocks and attrs,
so the program JSON is the JAX package's byte for byte).

The reference implements these as ops that re-enter the Executor on a
sub-block per iteration (``operators/recurrent_op.cc:222``,
``while_op.cc:35``).  So does this port, eagerly: each control-flow op
runs its sub-block with ``executor.run_sub_block`` in a Python loop, in
the caller's grad mode, so that a grad op's recomputation of the op
records every iteration for autograd (BPTT falls out of
``torch.autograd.grad``, as it falls out of ``jax.vjp`` through a scan in
the JAX package):

- ``recurrent`` (StaticRNN, DynamicRNN) iterates over the padded T, as
  ``lax.scan`` does, and folds the step index into each iteration's
  random stream, as ``fold_in(key, t)`` does;
- ``while`` (an unbounded While) reads its condition on the host before
  each iteration (a sync) and emits its trip count; its gradient replays
  the loop as a ``bounded_while`` at that count (``backward.py``);
- ``bounded_while`` runs all ``max_trip_count`` iterations and keeps the
  carry with a device ``where`` once the condition is false, as the JAX
  masked scan does: no host read, the truncated state and the zero
  cotangents past the fixed point match the JAX package's;
- ``conditional_block`` takes its branch on the host (the condition is
  read back, a sync), so the untaken branch never runs, as under
  ``lax.cond``; ``Executor.run_n`` stands down for it (``host_sync``).
  ``IfElse`` needs no such op: both branches run on the full batch and
  ``where`` merges the rows, so an IfElse program captures.

The ops' inputs are made explicit at build time (step inputs, boot
memories and the sub-block's external reads), which is what lets the
generic grad op differentiate them.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

from paddle_tpu_torch.fluid import framework
from paddle_tpu_torch.fluid.executor import run_sub_block
from paddle_tpu_torch.fluid.framework import Variable, unique_name
from paddle_tpu_torch.fluid.ops import register_op


def _external_reads(block) -> List[str]:
    """Names read by the block's ops that are not produced locally and not
    declared as block-local vars — these must become explicit op inputs."""
    written = set()
    reads = []
    local = set(block.vars)
    for op in block.ops:
        for n in op.input_names():
            if n and n not in written and n not in local and n not in reads:
                reads.append(n)
        written.update(n for n in op.output_names() if n)
    return reads


def _escaping_writes(block) -> List[str]:
    """Names the block's ops write that are NOT block-local — the vars
    that must be carried in/out of the enclosing control-flow op."""
    written = []
    for op in block.ops:
        for n in op.output_names():
            if n and n not in written and n not in block.vars:
                written.append(n)
    return written


def _truth(v: torch.Tensor) -> bool:
    """a condition read on the host (the sync of while and
    conditional_block): all of it true."""
    return bool(torch.all(v.to(torch.bool)))


@register_op("recurrent", inputs=("StepInputs", "Boot", "Params"),
             outputs=("Out", "FinalMem"),
             list_slots=("StepInputs", "Boot", "Params", "Out", "FinalMem"))
def _recurrent(ctx, attrs, ins):
    blk = attrs["sub_block"]
    seqs = ins.get("StepInputs", [])
    base_env = dict(zip(attrs["param_names"], ins.get("Params", [])))
    length = seqs[0].shape[0] if seqs else attrs["max_len"]
    order = (range(length - 1, -1, -1) if attrs.get("reverse", False)
             else range(length))
    carry = list(ins.get("Boot", []))
    outs = [[None] * length for _ in attrs["out_local"]]
    for t in order:
        env = dict(base_env)
        env.update(zip(attrs["mem_local"], carry))
        env.update(zip(attrs["in_local"], (s[t] for s in seqs)))
        run_sub_block(blk, env, ctx.sub_block_ctx(t))
        carry = [env[n] for n in attrs["mem_update"]]
        for k, n in enumerate(attrs["out_local"]):
            outs[k][t] = env[n]
    return {"Out": [torch.stack(o) for o in outs], "FinalMem": carry}


@register_op("while", inputs=("Carry", "Params"),
             outputs=("CarryOut", "Trips"),
             list_slots=("Carry", "Params", "CarryOut"),
             differentiable=(), host_sync=True)
def _while(ctx, attrs, ins):
    """Unbounded While: the exact trip count, the condition read on the
    host before each iteration; not differentiable itself.  Also emits its
    TRIP COUNT ("Trips"), which its gradient's ``bounded_while`` replay
    reads (the two-phase analogue of the reference's saved-step-scope
    replay, while_op.cc:227).  Iteration t folds t into the random
    stream, as the bounded replay does."""
    blk = attrs["sub_block"]
    carry_names = attrs["carry_names"]
    base_env = dict(zip(attrs["param_names"], ins.get("Params", [])))
    carry = list(ins["Carry"])
    trips = 0
    while _truth(carry[attrs["cond_idx"]]):
        env = dict(base_env)
        env.update(zip(carry_names, carry))
        run_sub_block(blk, env, ctx.sub_block_ctx(trips))
        carry = [env[n] for n in carry_names]
        trips += 1
    return {"CarryOut": carry,
            "Trips": [torch.full((), trips, dtype=torch.int32,
                                 device=ctx.device)]}


@register_op("bounded_while", inputs=("Carry", "Params"),
             outputs=("CarryOut",),
             list_slots=("Carry", "Params", "CarryOut"),
             differentiable=("Carry", "Params"))
def _bounded_while(ctx, attrs, ins):
    """Differentiable While: max_trip_count iterations, each keeping the
    carry where the condition is already false (a device ``where``, as
    the JAX masked scan's select), so no value comes back to the host.

    If the condition is STILL true after max_trip_count iterations the
    result is the truncated state; fetch the cond var (it is a loop
    carry) and assert it is false when trip counts are not statically
    known.

    Gradient hazard (the where-vjp NaN trap, as in the JAX package):
    iterations past the fixed point still EXECUTE the body on the frozen
    carry, and the select only discards their outputs.  An op that is
    non-finite off the active range (a division whose denominator hits
    zero once cond is false, the log of an exhausted countdown) gives a
    NaN whose zero cotangent still poisons the backward (0 * NaN = NaN).
    Guard such ops inside the body (``maximum(x, eps)`` the denominator).

    ``max_trip_count="__capture__"`` is the gradient replay of an
    unbounded ``while`` (``backward.py``): the bound is the trip count
    the forward ``while`` wrote to ``trips_var`` earlier in the same run
    (the eager executor needs no probe run to learn it)."""
    blk = attrs["sub_block"]
    carry_names = attrs["carry_names"]
    cond_idx = attrs["cond_idx"]
    base_env = dict(zip(attrs["param_names"], ins.get("Params", [])))
    max_trips = attrs["max_trip_count"]
    if max_trips == "__capture__":
        name = attrs["trips_var"]
        if ctx.values is None or name not in ctx.values:
            raise RuntimeError(
                f"bounded_while: trip count for {name!r} was not "
                f"captured — gradients through an unbounded While need "
                f"the forward while op to run first in the same run; "
                f"running the grad block without its forward cannot "
                f"resolve the data-dependent bound")
        max_trips = int(ctx.values[name])
    carry = list(ins["Carry"])
    for t in range(max_trips):
        active = carry[cond_idx].reshape(()).to(torch.bool)
        env = dict(base_env)
        env.update(zip(carry_names, carry))
        run_sub_block(blk, env, ctx.sub_block_ctx(t))
        carry = [torch.where(active, env[n].to(c.dtype), c)
                 for n, c in zip(carry_names, carry)]
    return {"CarryOut": carry}


@register_op("conditional_block", inputs=("Cond", "Carry", "Params"),
             outputs=("CarryOut",), list_slots=("Carry", "Params",
                                                "CarryOut"),
             differentiable=("Carry", "Params"), host_sync=True)
def _conditional_block(ctx, attrs, ins):
    """run the sub-block only when Cond holds (reference:
    conditional_block_op.cc): the condition is read on the host and the
    false branch passes the carried vars through unchanged, so every var
    the block writes must already exist outside (its else-value)."""
    carry = list(ins["Carry"])
    if not _truth(ins["Cond"][0]):
        return {"CarryOut": carry}
    env = dict(zip(attrs["param_names"], ins.get("Params", [])))
    env.update(zip(attrs["carry_names"], carry))
    run_sub_block(attrs["sub_block"], env, ctx.sub_block_ctx())
    return {"CarryOut": [env[n] for n in attrs["carry_names"]]}


def _index(i: torch.Tensor, n: int) -> torch.Tensor:
    """a step index as a one-hot row mask over [n] (no host read)."""
    idx = torch.clamp(i.reshape(()).to(torch.int64), 0, n - 1)
    return torch.arange(n, device=i.device) == idx


@register_op("array_write", inputs=("X", "I", "Array"), outputs=("Out",),
             differentiable=("X", "Array"))
def _array_write(ctx, attrs, ins):
    x, i, arr = ins["X"][0], ins["I"][0], ins["Array"][0]
    hit = _index(i, arr.shape[0]).reshape((-1,) + (1,) * (arr.ndim - 1))
    return {"Out": [torch.where(hit, x.to(arr.dtype).unsqueeze(0), arr)]}


@register_op("array_read", inputs=("I", "Array"), outputs=("Out",),
             differentiable=("Array",))
def _array_read(ctx, attrs, ins):
    i, arr = ins["I"][0], ins["Array"][0]
    idx = torch.clamp(i.reshape(1).to(torch.int64), 0, arr.shape[0] - 1)
    return {"Out": [arr.index_select(0, idx)[0]]}


# ---------------------------------------------------------------------------
# build-time helpers
# ---------------------------------------------------------------------------

class StaticRNN:
    """Static RNN over time-major sequences, one ``recurrent`` op (reference
    ``layers/control_flow.py:380``).

    Usage::

        rnn = StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)          # x: [T, batch, d]
            prev = rnn.memory(init=boot)     # boot: [batch, h]
            h = layers.fc(input=[x_t, prev], size=h, act="tanh")
            rnn.update_memory(prev, h)
            rnn.step_output(h)
        out = rnn()                          # [T, batch, h]
    """

    def __init__(self, reverse: bool = False):
        self.program = framework.default_main_program()
        self.sub_block = None
        self._seq_vars: List[Variable] = []
        self._in_local: List[str] = []
        self._boot_vars: List[Variable] = []
        self._mem_local: List[str] = []
        self._mem_update: Dict[str, str] = {}
        self._out_local: List[str] = []
        self._outputs: List[Variable] = []
        self.reverse = reverse

    @contextlib.contextmanager
    def step(self):
        self.sub_block = self.program.create_block()
        try:
            yield
        finally:
            self.program.rollback()
            self._finalize()

    def step_input(self, x: Variable) -> Variable:
        local = self.sub_block.create_var(
            name=unique_name("rnn_step_in"), shape=x.shape[1:],
            dtype=x.dtype)
        self._seq_vars.append(x)
        self._in_local.append(local.name)
        return local

    def memory(self, init: Optional[Variable] = None, shape=None,
               batch_ref: Optional[Variable] = None,
               init_value: float = 0.0) -> Variable:
        from paddle_tpu_torch.fluid import layers
        if init is None:
            if shape is None:
                raise ValueError("memory needs init var or shape")
            # boot created in the parent block
            cur = self.program._current_block_idx
            self.program._current_block_idx = self.sub_block.parent_idx
            try:
                if batch_ref is not None:
                    init = layers.fill_constant_batch_size_like(
                        batch_ref, [-1] + list(shape), "float32",
                        init_value)
                else:
                    init = layers.fill_constant(shape, "float32",
                                                init_value)
            finally:
                self.program._current_block_idx = cur
        local = self.sub_block.create_var(
            name=unique_name("rnn_mem"), shape=init.shape,
            dtype=init.dtype)
        self._boot_vars.append(init)
        self._mem_local.append(local.name)
        self._mem_update[local.name] = local.name  # default: unchanged
        return local

    def update_memory(self, mem: Variable, new: Variable):
        self._mem_update[mem.name] = new.name

    def step_output(self, out: Variable):
        self._out_local.append(out.name)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _finalize(self):
        parent = self.program.blocks[self.sub_block.parent_idx]
        param_names = [
            n for n in _external_reads(self.sub_block)
            if n not in self._in_local and n not in self._mem_local]
        self._outputs = []
        for name in self._out_local:
            v = self.sub_block.var(name)
            out = parent.create_var(
                name=unique_name("rnn_out"),
                shape=(-1,) + tuple(v.shape), dtype=v.dtype)
            self._outputs.append(out)
        finals = []
        for name in self._mem_local:
            v = self.sub_block.var(name)
            fv = parent.create_var(name=unique_name("rnn_final"),
                                   shape=v.shape, dtype=v.dtype)
            finals.append(fv)
        parent.append_op(
            "recurrent",
            inputs={"StepInputs": self._seq_vars,
                    "Boot": self._boot_vars,
                    "Params": param_names},
            outputs={"Out": self._outputs, "FinalMem": finals},
            attrs={"sub_block": self.sub_block,
                   "in_local": list(self._in_local),
                   "mem_local": list(self._mem_local),
                   "mem_update": [self._mem_update[n]
                                  for n in self._mem_local],
                   "out_local": list(self._out_local),
                   "param_names": param_names,
                   "reverse": self.reverse})

    def __call__(self):
        if len(self._outputs) == 1:
            return self._outputs[0]
        return self._outputs


class DynamicRNN:
    """Variable-length RNN over padded batch-major sequences
    (reference ``layers/control_flow.py:1344``).

    The reference shrinks the batch as LoD sequences finish
    (lod_rank_table + shrink_rnn_memory); the static-shape equivalent
    keeps the full [B, T, d] batch and freezes finished rows with a per-step
    mask derived from `lens`: memories stop updating and outputs are
    zeroed past each row's length.

    Usage::

        drnn = DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(x, lens)     # x: [B, T, d]; lens: [B]
            prev = drnn.memory(shape=[h], batch_ref=lens)
            out = layers.fc(input=[x_t, prev], size=h, act="tanh")
            drnn.update_memory(prev, out)
            drnn.output(out)
        seq_out = drnn()                       # [B, T, h], zero-padded
    """

    def __init__(self):
        self.program = framework.default_main_program()
        self._rnn = StaticRNN()
        self._mask_t = None

    @contextlib.contextmanager
    def block(self):
        with self._rnn.step():
            yield

    def _in_parent(self, fn):
        cur = self.program._current_block_idx
        self.program._current_block_idx = self._rnn.sub_block.parent_idx
        try:
            return fn()
        finally:
            self.program._current_block_idx = cur

    def step_input(self, x: Variable, lens: Optional[Variable] = None
                   ) -> Variable:
        from paddle_tpu_torch.fluid import layers

        t = x.shape[1]

        def build():
            xt = layers.transpose(x, [1, 0] + list(range(2, len(x.shape))))
            mask = None
            if lens is not None and self._mask_t is None:
                m = layers.sequence_mask(lens, t)          # [B, T]
                mask = layers.reshape(layers.transpose(m, [1, 0]),
                                      [t, -1, 1])          # [T, B, 1]
            return xt, mask

        xt, mask = self._in_parent(build)
        if mask is not None:
            self._mask_t = self._rnn.step_input(mask)      # [B, 1]
        return self._rnn.step_input(xt)

    def memory(self, init: Optional[Variable] = None, shape=None,
               batch_ref: Optional[Variable] = None,
               init_value: float = 0.0) -> Variable:
        return self._rnn.memory(init=init, shape=shape,
                                batch_ref=batch_ref, init_value=init_value)

    def update_memory(self, mem: Variable, new: Variable):
        from paddle_tpu_torch.fluid import layers

        if self._mask_t is not None:
            # finished rows freeze: new*m + old*(1-m); axis=0 pins the
            # [B,1] mask to the batch dim whatever the value rank
            keep = layers.elementwise_mul(new, self._mask_t, axis=0)
            hold = layers.elementwise_mul(
                mem, layers.scale(self._mask_t, scale=-1.0, bias=1.0),
                axis=0)
            new = layers.elementwise_add(keep, hold)
        self._rnn.update_memory(mem, new)

    def output(self, *outputs):
        from paddle_tpu_torch.fluid import layers

        for o in outputs:
            if self._mask_t is not None:
                o = layers.elementwise_mul(o, self._mask_t, axis=0)
            self._rnn.step_output(o)

    def __call__(self):
        from paddle_tpu_torch.fluid import layers

        outs = self._rnn()
        if not isinstance(outs, (list, tuple)):
            outs = [outs]
        # block context already exited: current block IS the parent here
        res = [layers.transpose(o, [1, 0] + list(range(2, len(o.shape))))
               for o in outs]
        return res[0] if len(res) == 1 else res


def _dealiased_inputs(parent, carry_names, tag):
    """Snapshot each carry into a fresh ``@in`` var (via assign ops) and
    feed THOSE to the control-flow op, whose outputs keep the original
    names. Round-2's self-aliased Carry/CarryOut broke the generic vjp:
    the op overwrote its own inputs, so by backward time the env held
    post-loop values under the input names. The snapshots are never
    overwritten, so the grad op re-runs the forward from true pre-loop
    values; append_backward's redefinition-kill keeps the name-level
    cotangent bookkeeping straight."""
    ins = []
    for n in carry_names:
        v = parent.var(n)
        snap = parent.create_var(name=unique_name(n + "@" + tag),
                                 shape=v.shape, dtype=v.dtype)
        parent.append_op("assign", inputs={"X": [n]},
                         outputs={"Out": [snap.name]})
        ins.append(snap.name)
    return ins


class While:
    """Loop over a sub-block (reference ``layers/control_flow.py:604``).
    Loop-carried vars are those written in the body that also exist
    outside; cond must be updated in the body.

    ``max_trip_count=None`` is the ``while`` op: the exact data-dependent
    trip count, its condition read on the host each iteration; gradients
    replay the loop as a ``bounded_while`` at the forward's trip count
    (``backward.py``).  A static ``max_trip_count`` is ``bounded_while``
    directly: no host read, so ``run_n`` can capture it (the reference
    trains through While by while_grad's step-scope replay,
    while_op.cc:227)."""

    def __init__(self, cond: Variable, max_trip_count: Optional[int] = None):
        self.cond = cond
        self.max_trip_count = max_trip_count
        self.program = framework.default_main_program()
        self.sub_block = None

    @contextlib.contextmanager
    def block(self):
        self.sub_block = self.program.create_block()
        try:
            yield
        finally:
            self.program.rollback()
            self._finalize()

    def _finalize(self):
        parent = self.program.blocks[self.sub_block.parent_idx]
        carry_names = _escaping_writes(self.sub_block)
        if self.cond.name not in carry_names:
            carry_names.append(self.cond.name)
        param_names = [n for n in _external_reads(self.sub_block)
                       if n not in carry_names]
        attrs = {"sub_block": self.sub_block,
                 "carry_names": carry_names,
                 "param_names": param_names,
                 "cond_idx": carry_names.index(self.cond.name)}
        op_type = "while"
        outputs = {"CarryOut": carry_names}
        if self.max_trip_count is not None:
            op_type = "bounded_while"
            attrs["max_trip_count"] = int(self.max_trip_count)
        else:
            # emit the trip count so gradients (if requested later) can
            # be taken via the two-phase capture-and-replay (backward.py)
            trips = parent.create_var(
                name=unique_name("while_trips"), shape=(), dtype="int32")
            trips.stop_gradient = True
            outputs["Trips"] = [trips.name]
        in_names = _dealiased_inputs(parent, carry_names, op_type + "_in")
        parent.append_op(
            op_type,
            inputs={"Carry": in_names, "Params": param_names},
            outputs=outputs, attrs=attrs)


class ConditionalBlock(While):
    """Guarded sub-block (reference ``layers/control_flow.py``
    ConditionalBlock / conditional_block_op.cc): the ops inside run only
    when the condition holds. Vars written inside must be initialized
    OUTSIDE first (e.g. via fill_constant) — they carry through unchanged
    when the condition is false (the op's outputs are those vars either
    way).  Differentiable (reference: conditional_block_op.cc:128 grad):
    only the taken branch runs, so gradients reach only it;
    carries and the assign-back use de-aliased names (round-2's
    self-aliased Carry/CarryOut produced wrong gradients).

        cb = ConditionalBlock(cond)
        with cb.block():
            ...ops assigning to pre-created vars...
    """

    def _finalize(self):
        parent = self.program.blocks[self.sub_block.parent_idx]
        carry_names = _escaping_writes(self.sub_block)
        # the condition stays readable inside the block (it is fed via
        # Params if any op reads it)
        param_names = [n for n in _external_reads(self.sub_block)
                       if n not in carry_names]
        in_names = _dealiased_inputs(parent, carry_names, "cond_in")
        parent.append_op(
            "conditional_block",
            inputs={"Cond": [self.cond.name], "Carry": in_names,
                    "Params": param_names},
            outputs={"CarryOut": carry_names},
            attrs={"sub_block": self.sub_block,
                   "carry_names": carry_names,
                   "param_names": param_names})


# ---------------------------------------------------------------------------
# tensor-array helpers (fixed-capacity buffers — the static-shape stand-in
# for the reference's LoDTensorArray)
# ---------------------------------------------------------------------------

def create_array(dtype, capacity: int, element_shape) -> Variable:
    from paddle_tpu_torch.fluid import layers
    return layers.fill_constant([capacity] + list(element_shape), dtype, 0.0)


def array_write(x: Variable, i: Variable,
                array: Variable) -> Variable:
    block = framework.default_main_program().current_block()
    out = block.create_var(name=unique_name("array"), shape=array.shape,
                           dtype=array.dtype)
    block.append_op("array_write",
                    inputs={"X": [x], "I": [i], "Array": [array]},
                    outputs={"Out": [out]})
    return out


def array_read(array: Variable, i: Variable) -> Variable:
    block = framework.default_main_program().current_block()
    out = block.create_var(name=unique_name("array_elem"),
                           shape=array.shape[1:], dtype=array.dtype)
    block.append_op("array_read", inputs={"I": [i], "Array": [array]},
                    outputs={"Out": [out]})
    return out


def array_length(array: Variable) -> int:
    return array.shape[0]


class IfElse:
    """Batch-row conditional (reference: control_flow.py IfElse — splits
    rows by a bool cond, runs each block on its subset, merges).

    Both branches run on the full padded batch and rows are selected by
    the condition mask with a ``where`` (NaN-safe: an unselected row's
    NaN does not leak); no value comes back to the host, so a program
    with an IfElse captures under ``run_n``.
    """

    def __init__(self, cond):
        self.cond = cond
        self._true_out = None
        self._false_out = None
        self._in_true = None
        self._inputs = []

    class _Branch:
        def __init__(self, ie, is_true):
            self.ie = ie
            self.is_true = is_true

        def __enter__(self):
            self.ie._in_true = self.is_true
            return self

        def __exit__(self, *exc):
            self.ie._in_true = None
            return False

    def true_block(self):
        return IfElse._Branch(self, True)

    def false_block(self):
        return IfElse._Branch(self, False)

    def input(self, x):
        """reference: ie.input(x) splits x by cond; here the branch sees
        the full batch (selection happens at merge)."""
        return x

    def output(self, *outs):
        if self._in_true is None:
            raise RuntimeError("IfElse.output() outside a block")
        if self._in_true:
            self._true_out = outs
        else:
            self._false_out = outs

    def __call__(self):
        from paddle_tpu_torch.fluid import layers as L
        if self._true_out is None or self._false_out is None:
            raise RuntimeError("IfElse needs both true_block and "
                               "false_block outputs")
        outs = []
        for t, f in zip(self._true_out, self._false_out):
            outs.append(L.merge_lod_tensor(t, f, self.cond))
        return outs if len(outs) > 1 else outs[0]


class Switch:
    """sequential case selection (reference: control_flow.py Switch, used
    for piecewise learning-rate schedules). Cases become a chain of
    merge_lod_tensor selects over scalar conditions."""

    def __init__(self):
        self._cases = []          # (cond_var_or_None, assignments)
        self._current = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    class _Case:
        def __init__(self, sw, cond):
            self.sw = sw
            self.cond = cond

        def __enter__(self):
            self.sw._current = (self.cond, [])
            return self

        def __exit__(self, *exc):
            self.sw._cases.append(self.sw._current)
            self.sw._current = None
            return False

    def case(self, cond):
        return Switch._Case(self, cond)

    def default(self):
        return Switch._Case(self, None)

    def assign(self, target, value):
        """record target := value under the current case; resolve() folds
        the chain into selects."""
        if self._current is None:
            raise RuntimeError("Switch.assign outside a case")
        self._current[1].append((target, value))

    @staticmethod
    def _target_key(target):
        return target.name if hasattr(target, "name") else str(target)

    def resolve(self, init):
        """fold cases into ONE value: first matching cond wins, else
        default (reference executes the first true case block). Every
        case must assign the same single target; for cases assigning
        several targets use resolve_all."""
        names = {self._target_key(t)
                 for _c, assigns in self._cases for t, _v in assigns}
        if len(names) > 1:
            raise ValueError(
                f"Switch.resolve is single-target but cases assign "
                f"{sorted(names)}; use resolve_all")
        name = names.pop() if names else "_"
        return self.resolve_all({name: init})[name]

    def resolve_all(self, inits):
        """fold cases into one value PER TARGET: first matching cond
        wins for each target, else its default-case assignment, else its
        init (reference Switch case blocks may assign any number of
        vars, control_flow.py Switch). inits maps target (Variable or
        name) -> pre-switch value; returns {name: folded value}."""
        from paddle_tpu_torch.fluid import layers as L

        def one():
            return L.fill_constant([1], "float32", 1.0)

        def select(val, result, gate):
            return L.elementwise_add(
                L.elementwise_mul(val, gate),
                L.elementwise_mul(result, L.elementwise_sub(one(), gate)))

        results = {self._target_key(t): v for t, v in inits.items()}
        taken = None
        default_assigns = []
        for cond, assigns in self._cases:
            if cond is None:
                default_assigns = assigns
                continue
            fresh = L.cast(cond, "float32")
            take_now = fresh if taken is None else \
                L.elementwise_mul(fresh, L.elementwise_sub(one(), taken))
            # a true case CONSUMES the switch even when its block assigns
            # nothing (the reference executes the first true case and
            # stops — an empty block is a no-op, not a fall-through):
            # `taken` below updates unconditionally, never skipped for
            # empty blocks
            for tgt, value in assigns:
                key = self._target_key(tgt)
                if key not in results:
                    raise KeyError(
                        f"Switch case assigns {key!r} but resolve_all "
                        f"got no init for it")
                results[key] = select(value, results[key], take_now)
            taken = fresh if taken is None else \
                L.elementwise_add(taken, L.elementwise_mul(
                    take_now, L.elementwise_sub(one(), taken)))
        if default_assigns:
            none_taken = one() if taken is None else \
                L.elementwise_sub(one(), taken)
            for tgt, value in default_assigns:
                key = self._target_key(tgt)
                if key not in results:
                    raise KeyError(
                        f"Switch default assigns {key!r} but resolve_all "
                        f"got no init for it")
                results[key] = select(value, results[key], none_taken)
        return results


class ParallelDo:
    """reference: parallel_do_op.cc multi-device data parallelism.  As in
    the JAX package this shim runs the block inline, so legacy programs
    still execute with single-program semantics (the sharded executor is
    ROADMAP.md section 1, item 14)."""

    def __init__(self, places=None, use_nccl=False):
        self.places = places

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def read_input(self, x):
        return x

    def write_output(self, x):
        self._out = x

    def __call__(self):
        return self._out
