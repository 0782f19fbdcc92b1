"""append_backward: IR-level reverse-mode autodiff over the op graph
(counterpart of ``paddle_tpu/fluid/backward.py``; the same grad ops and
``@GRAD`` names, so the JSON is the JAX package's).

Mirrors ``python/paddle/v2/fluid/backward.py`` (``_append_backward_ops_
:202``): walk ops in reverse, append one ``<type>_grad`` op per forward op,
accumulate fan-in gradients with ``sum`` ops.  Unlike the reference, grad ops
carry no hand-written kernel: the executor derives each one from the forward
op by autograd (``executor._run_grad_op``), so this module only does the
graph surgery: names, accumulation and stop-gradient pruning.  A
control-flow op is one op here: its grad op recomputes the whole loop
under autograd, sub-block included.  An unbounded ``while`` is replayed
as a ``bounded_while_grad`` (the JAX package's two-phase replay, the
same JSON).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from paddle_tpu_torch.fluid import framework
from paddle_tpu_torch.fluid.framework import Parameter, Program, Variable
from paddle_tpu_torch.fluid.ops import get_op

_FLOAT_DTYPES = ("float16", "bfloat16", "float32", "float64")


def _is_float(var: Variable) -> bool:
    return var.dtype in _FLOAT_DTYPES


def append_backward(loss: Variable, parameter_list: Optional[List] = None,
                    no_grad_set=None) -> List[Tuple[Variable, Variable]]:
    """Append grad ops for ``loss``; returns [(param, grad_var), ...]."""
    program = loss.program
    block = program.global_block()
    no_grad = set(no_grad_set or ())

    # seed: d loss / d loss = 1
    loss_grad = framework.grad_var_name(loss.name)
    block.create_var(name=loss_grad, shape=loss.shape, dtype=loss.dtype)
    block.append_op("fill_constant", outputs={"Out": [loss_grad]},
                    attrs={"shape": list(loss.shape), "value": 1.0,
                           "dtype": loss.dtype})

    # var name -> list of partial-grad names awaiting accumulation
    partials: Dict[str, List[str]] = {loss.name: [loss_grad]}
    fwd_ops = [op for op in list(block.ops)
               if not op.type.endswith("_grad")
               and op.outputs.get("Out", [None])[0] != loss_grad]

    def resolve_grad(name: str) -> str:
        """Cotangent name for var ``name``, emitting a sum op if several
        partials fanned in."""
        plist = partials.get(name, [])
        if not plist:
            return ""
        if len(plist) == 1:
            return plist[0]
        total = framework.grad_var_name(name)
        if total in plist:  # avoid self-referential sum
            total = total + "@SUM"
        var = block.var(name)
        block.create_var(name=total, shape=var.shape, dtype=var.dtype)
        block.append_op("sum", inputs={"X": list(plist)},
                        outputs={"Out": [total]})
        partials[name] = [total]
        return total

    def kill_outputs(op):
        """An op (re)defines its outputs: once the reverse walk passes it,
        pending cotangents for those names belong to THIS definition and
        were just consumed — an earlier op writing the same name (e.g. the
        pre-initialized carry of a While/ConditionalBlock, overwritten by
        the de-aliasing assign) must not also receive them."""
        for names in op.outputs.values():
            for n in names:
                if n != loss.name:
                    partials.pop(n, None)

    for op in reversed(fwd_ops):
        try:
            opdef = get_op(op.type)
        except KeyError:
            kill_outputs(op)
            continue
        # does any output of this op have a pending gradient?
        out_has_grad = any(
            n in partials for names in op.outputs.values() for n in names)
        if not out_has_grad:
            kill_outputs(op)
            continue

        if op.type == "while":    # out_has_grad held above
            # the two-phase replay of the unbounded While gradient (the
            # JAX package's, and its JSON): the grad op replays the loop
            # as the differentiable bounded_while whose bound is the
            # forward's trip count ("__capture__", read from trips_var;
            # the forward while op writes it earlier in the same run)
            import types as _types

            trips_names = op.outputs.get("Trips", [])
            if not trips_names:
                raise NotImplementedError(
                    "gradients through an unbounded While require its "
                    "trip-count output (programs built before the "
                    "two-phase replay landed must be rebuilt); "
                    "alternatively give the loop a max_trip_count")
            op = _types.SimpleNamespace(
                type="bounded_while",
                attrs={**op.attrs, "max_trip_count": "__capture__",
                       "trips_var": trips_names[0]},
                inputs=op.inputs,
                outputs={"CarryOut": op.outputs["CarryOut"]})
            opdef = get_op(op.type)   # Carry/Params become differentiable

        # which input slots can receive grads
        diff_slots = (set(opdef.differentiable)
                      if opdef.differentiable is not None
                      else set(opdef.inputs))

        grad_inputs = {slot: list(names)
                       for slot, names in op.inputs.items()}
        for slot, names in op.outputs.items():
            grad_inputs[slot + "@GRAD"] = [resolve_grad(n) for n in names]
        kill_outputs(op)

        grad_outputs = {}
        any_grad = False
        for slot, names in op.inputs.items():
            gnames = []
            for n in names:
                var = block.var(n)
                skip = (slot not in diff_slots or not _is_float(var)
                        or var.stop_gradient or n in no_grad
                        or (isinstance(var, Parameter)
                            and not var.trainable))
                if skip:
                    gnames.append("")
                    continue
                base = framework.grad_var_name(n)
                existing = partials.setdefault(n, [])
                gname = base if not existing \
                    else f"{base}@RENAME@{len(existing)}"
                block.create_var(name=gname, shape=var.shape,
                                 dtype=var.dtype)
                existing.append(gname)
                gnames.append(gname)
                any_grad = True
            grad_outputs[slot + "@GRAD"] = gnames
        if not any_grad:
            continue

        attrs = dict(op.attrs)
        attrs["fwd_type"] = op.type
        block.append_op(op.type + "_grad", inputs=grad_inputs,
                        outputs=grad_outputs, attrs=attrs)

    # final accumulation for parameters + build (param, grad) pairs
    params = (parameter_list if parameter_list is not None
              else block.all_parameters())
    result = []
    for p in params:
        if isinstance(p, str):
            p = block.var(p)
        if p.name not in partials:
            continue
        gname = resolve_grad(p.name)
        program.param_grad_names[p.name] = gname
        result.append((p, block.var(gname)))
    return result
