"""Executor: runs a Program's block op by op (counterpart of
``paddle_tpu/fluid/executor.py``).

The reference's ``Executor::Run`` (``paddle/fluid/framework/executor.cc:80``)
interprets the op list: per op, create it, pick its kernel, launch.  This
executor is that interpreter over torch: ``run_block`` calls each op's
function eagerly on the executor's place, with the persistable variables
(parameters, optimizer slots, BN statistics) read from a ``Scope`` and the
rewritten ones written back after the block.  The JAX package instead
lowers the whole block to one jitted computation; the counterpart here, a
captured CUDA graph of a run (``prepare`` / ``run_n``), is ``ROADMAP.md``
section 1, item 12b, as are control flow and ``check_nan_inf``.

Gradient ops (``<type>_grad``, built by ``backward.py``) recompute their
forward op once, under autograd, and take ``torch.autograd.grad`` of it:
one forward launch more per grad op, not the two of a probe and a vjp.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch.fluid import framework
from paddle_tpu_torch.fluid.framework import Block, Program, Variable
from paddle_tpu_torch.fluid.ops import get_op, torch_dtype


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


class OpRunCtx:
    """Per-op context: the train flag, the place, and the op's random
    stream.

    Each stateful-RNG op carries a stable ``__rng_id__`` attr; the forward
    op and its grad op derive the same generator seeds from (seed, step,
    rng_id, call number), so a dropout mask recomputed inside the grad op
    equals the forward's.  (Torch cannot reproduce JAX's streams: the seeds
    are derived as the JAX package derives its keys, not equal to them.)
    """

    def __init__(self, train: bool, device: torch.device, seed: int,
                 step: int, rng_id: int):
        self.train = train
        self.device = device
        self._base = (seed, step, rng_id)
        self._calls = 0

    def next_generator(self) -> torch.Generator:
        key = "/".join(str(v) for v in self._base + (self._calls,))
        self._calls += 1
        seed = int.from_bytes(
            hashlib.blake2b(key.encode(), digest_size=8).digest(), "little")
        return torch.Generator(device=self.device).manual_seed(
            seed & (2 ** 63 - 1))


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


def run_block(block: Block, env: dict, mk_ctx) -> None:
    """Run every op of a block in order, eagerly, writing ``env``.
    ``mk_ctx(rng_id)`` makes an op's ``OpRunCtx``."""
    with torch.no_grad():
        for op in block.ops:
            if op.type.endswith("_grad") and "fwd_type" in op.attrs:
                _run_grad_op(op, env, mk_ctx)
            else:
                _run_forward_op(op, env, mk_ctx)


class Executor:
    """Runs programs (reference ``v2/fluid/executor.py:166``,
    ``framework/executor.cc:80``) on ``place``: ``CUDAPlace(0)`` when
    none is given, which raises with no card; ``CPUPlace()`` runs on the
    host."""

    def __init__(self, place: Optional[object] = None):
        self.place = framework.CUDAPlace(0) if place is None else place
        self.device = self.place.torch_device()
        self._step = 0

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
        persistables the block wrote go back into ``scope``."""
        if check_nan_inf:
            raise NotImplementedError(
                "Executor.run(check_nan_inf=True) is not ported to "
                "paddle_tpu_torch yet (ROADMAP.md section 1, item 12b)")
        program = program or framework.default_main_program()
        scope = scope or global_scope()
        block = program.global_block()
        ops = [op for blk in program.blocks for op in blk.ops]
        for op in ops:            # refuse an unported op before any runs
            get_op(op.attrs["fwd_type"] if op.type.endswith("_grad")
                   and "fwd_type" in op.attrs else op.type)
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        read = {n for op in ops for n in op.input_names()}
        written = {n for op in ops for n in op.output_names()}
        env = {}
        for var in program.list_vars():
            name = var.name
            if not var.persistable or not (name in read or name in written
                                           or name in fetch_names):
                continue
            if scope.has(name):
                env[name] = self._to_place(scope.get(name))
                scope.set(name, env[name])
            elif name in written:
                # written before it is read: a placeholder
                env[name] = torch.zeros(var.shape,
                                        dtype=torch_dtype(var.dtype),
                                        device=self.device)
            else:
                raise RuntimeError(
                    f"persistable var {name!r} is not initialized — "
                    f"run the startup program first")
        for name, val in (feed or {}).items():
            dt = block.var(name).dtype
            env[name] = torch.as_tensor(np.asarray(val, dtype=dt),
                                        device=self.device)
        step = self._step
        self._step += 1

        def mk_ctx(rng_id):
            return OpRunCtx(True, self.device, seed, step, rng_id)

        run_block(block, env, mk_ctx)
        for var in program.list_vars():
            if var.persistable and var.name in written and var.name in env:
                scope.set(var.name, env[var.name])
        fetched = [env[n] for n in fetch_names]
        if return_numpy:
            return [v.detach().cpu().numpy() for v in fetched]
        return fetched

    def _to_place(self, value) -> torch.Tensor:
        if isinstance(value, torch.Tensor):
            return value.to(self.device)
        return torch.as_tensor(np.array(value), device=self.device)
