"""Parameter initializers — emit init ops into the startup program.

Mirrors ``python/paddle/v2/fluid/initializer.py``: an initializer is applied
to a parameter at creation time and appends the corresponding random/constant
op to the startup program's global block.
"""

from __future__ import annotations

import numpy as np


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = float(value)

    def __call__(self, var, block):
        block.append_op("fill_constant", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "value": self.value,
                               "dtype": var.dtype})


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0, seed: int = 0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op("uniform_random", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "min": self.low,
                               "max": self.high, "dtype": var.dtype})


class Normal(Initializer):
    def __init__(self, loc: float = 0.0, scale: float = 1.0, seed: int = 0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op("gaussian_random", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "mean": self.loc,
                               "std": self.scale, "dtype": var.dtype})


def _fans(shape):
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    return shape[1] * receptive, shape[0] * receptive


class Xavier(Initializer):
    """Glorot init (reference ``initializer.py`` XavierInitializer)."""

    def __init__(self, uniform: bool = True, fan_in=None, fan_out=None,
                 seed: int = 0):
        self.uniform, self.fan_in, self.fan_out = uniform, fan_in, fan_out

    def __call__(self, var, block):
        fan_in, fan_out = _fans(var.shape)
        fan_in = self.fan_in if self.fan_in is not None else fan_in
        fan_out = self.fan_out if self.fan_out is not None else fan_out
        if self.uniform:
            limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
            Uniform(-limit, limit)(var, block)
        else:
            std = float(np.sqrt(2.0 / (fan_in + fan_out)))
            Normal(0.0, std)(var, block)


class MSRA(Initializer):
    """He init (reference MSRAInitializer)."""

    def __init__(self, uniform: bool = True, fan_in=None, seed: int = 0):
        self.uniform, self.fan_in = uniform, fan_in

    def __call__(self, var, block):
        fan_in, _ = _fans(var.shape)
        fan_in = self.fan_in if self.fan_in is not None else fan_in
        if self.uniform:
            limit = float(np.sqrt(6.0 / fan_in))
            Uniform(-limit, limit)(var, block)
        else:
            Normal(0.0, float(np.sqrt(2.0 / fan_in)))(var, block)


ConstantInitializer = Constant
UniformInitializer = Uniform
NormalInitializer = Normal
XavierInitializer = Xavier
MSRAInitializer = MSRA
