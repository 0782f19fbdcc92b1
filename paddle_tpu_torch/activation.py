"""Activation functions (counterpart of ``paddle_tpu/activation.py``).

Each activation is a named torch function under the JAX package's names,
so ``resolve`` writes the same ``act`` attribute into the IR.  ``gelu`` is
the tanh form, as ``jax.nn.gelu`` defaults to; on a reduced-precision
input it is ``jax.nn.gelu``'s formula evaluated op by op in that dtype,
its constants rounded to it, which is how XLA evaluates it under ``jit``
(bit-equal on bf16 and float16: at float16 the term ``x + 0.044715 x^3``
is one float32 multiply-add rounded once, as XLA's CPU backend contracts
it), where ``F.gelu`` would round once at the end.  The gradient is
autograd through those ops, which rounds at other places than XLA's
fused backward (within a few ulps of it, not bit-equal).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


class BaseActivation:
    name: str = None

    def __call__(self, x):
        return apply(self.name, x)


def _gelu(x):
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")

    def c(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    if x.dtype == torch.float16:
        # XLA's CPU backend contracts this one term of the jitted formula
        # into a float32 multiply-add on the float16 x^3, rounded once
        # (bf16 it evaluates op by op, as below)
        t = (c(0.044715).float() * (x * x * x).float() + x.float()).to(
            x.dtype)
    else:
        t = x + c(0.044715) * (x * x * x)
    inner = c(math.sqrt(2.0 / math.pi)) * t
    return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))


def _make(name):
    return type(name.capitalize() + "Activation", (BaseActivation,),
                {"name": name})


_FNS = {
    "linear": lambda x: x,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "brelu": lambda x: torch.clamp(x, 0.0, 24.0),
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "sequence_softmax": lambda x: torch.softmax(x, dim=-1),
    "exp": torch.exp,
    "log": torch.log,
    "abs": torch.abs,
    "square": torch.square,
    "sqrt": torch.sqrt,
    "reciprocal": lambda x: 1.0 / x,
    "softrelu": lambda x: torch.log(1.0 + torch.exp(torch.clamp(x, -40.0,
                                                                40.0))),
    "stanh": lambda x: 1.7159 * torch.tanh(2.0 / 3.0 * x),
    "softsign": lambda x: x / (1.0 + torch.abs(x)),
    "swish": F.silu,
    "gelu": _gelu,
    "elu": F.elu,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
}


def apply(name: str, x):
    try:
        return _FNS[name](x)
    except KeyError:
        raise KeyError(f"unknown activation {name!r}; have "
                       f"{sorted(_FNS)}") from None


def resolve(act) -> str:
    """Accept an activation object, a name string, or None (linear)."""
    if act is None:
        return "linear"
    if isinstance(act, str):
        if act not in _FNS:
            raise KeyError(f"unknown activation {act!r}")
        return act
    if isinstance(act, BaseActivation) or hasattr(act, "name"):
        return act.name
    raise TypeError(f"cannot resolve activation from {act!r}")


# class-style API parity with trainer_config_helpers.activations
Linear = LinearActivation = _make("linear")
Sigmoid = SigmoidActivation = _make("sigmoid")
Tanh = TanhActivation = _make("tanh")
Relu = ReluActivation = _make("relu")
BRelu = BReluActivation = _make("brelu")
Softmax = SoftmaxActivation = _make("softmax")
SequenceSoftmax = SequenceSoftmaxActivation = _make("sequence_softmax")
Exp = ExpActivation = _make("exp")
Log = LogActivation = _make("log")
Abs = AbsActivation = _make("abs")
Square = SquareActivation = _make("square")
SoftRelu = SoftReluActivation = _make("softrelu")
STanh = STanhActivation = _make("stanh")
Identity = IdentityActivation = _make("linear")
Sqrt = SqrtActivation = _make("sqrt")
Reciprocal = ReciprocalActivation = _make("reciprocal")
SoftSign = SoftSignActivation = _make("softsign")
