"""Operator overloads + unary math helpers on LayerOutput.

Reference: python/paddle/trainer_config_helpers/layer_math.py — enables
`net + 1`, `a - b`, `0.5 * net`, and exp/log/abs/... as graph functions.
Imported for side effects by the trainer_config_helpers package (the
reference's `import layer_math` in its __init__).
"""

from __future__ import annotations

import numbers

from paddle_tpu_torch import layer as _l
from paddle_tpu_torch.core.ir import LayerOutput

__all__ = []


def _register_unary(op_name, act_name):
    def op(input, name=None):
        return _l.mixed(size=input.size,
                        input=[_l.identity_projection(input)],
                        act=act_name, name=name)

    op.__name__ = op_name
    globals()[op_name] = op
    __all__.append(op_name)


for _n, _a in [("exp", "exp"), ("log", "log"), ("abs", "abs"),
               ("sigmoid", "sigmoid"), ("tanh", "tanh"),
               ("square", "square"), ("relu", "relu"), ("sqrt", "sqrt"),
               ("reciprocal", "reciprocal")]:
    _register_unary(_n, _a)


def _add(a, other):
    if isinstance(other, numbers.Number):
        return _l.slope_intercept(a, slope=1.0, intercept=float(other))
    if not isinstance(other, LayerOutput):
        return NotImplemented
    if a.size == other.size:
        return _l.mixed(size=a.size,
                        input=[_l.identity_projection(a),
                               _l.identity_projection(other)])
    if other.size != 1 and a.size != 1:
        raise ValueError(
            f"LayerOutput + LayerOutput needs equal sizes or one side of "
            f"size 1; got {a.size} and {other.size}")
    if a.size == 1:
        a, other = other, a
    other = _l.repeat(other, a.size)
    return _l.mixed(size=a.size,
                    input=[_l.identity_projection(a),
                           _l.identity_projection(other)])


def _sub(a, other):
    if isinstance(other, numbers.Number):
        return _l.slope_intercept(a, slope=1.0, intercept=-float(other))
    if not isinstance(other, LayerOutput):
        return NotImplemented
    return _add(a, _l.slope_intercept(other, slope=-1.0))


def _rsub(a, other):
    return _add(_l.slope_intercept(a, slope=-1.0), other)


def _mul(a, other):
    if isinstance(other, numbers.Number):
        return _l.slope_intercept(a, slope=float(other))
    if not isinstance(other, LayerOutput):
        return NotImplemented
    if a.size == 1:
        return _l.scaling(weight=a, input=other)
    if other.size == 1:
        return _l.scaling(weight=other, input=a)
    raise ValueError("LayerOutput '*' needs a number operand or a "
                     "LayerOutput of size 1")


LayerOutput.__add__ = _add
LayerOutput.__radd__ = _add
LayerOutput.__sub__ = _sub
LayerOutput.__rsub__ = _rsub
LayerOutput.__mul__ = _mul
LayerOutput.__rmul__ = _mul
