"""Parameter initializers (counterpart of ``paddle_tpu/initializer.py``).

Each is a function of (generator, shape) drawing float32 on the CPU from a
``torch.Generator`` (seeded by ``init(seed=)``); the caller moves the result
to its device, so the same seed gives the same weights on any device.  The
numbers differ from JAX's PRNG streams: tests carry weights across from the
JAX package instead.
"""

from __future__ import annotations

import math

import torch


class Initializer:
    def __call__(self, generator: torch.Generator, shape) -> torch.Tensor:
        raise NotImplementedError


def _uniform(generator, shape, low, high):
    return torch.rand(tuple(shape), generator=generator) * (high - low) + low


def _normal(generator, shape):
    return torch.randn(tuple(shape), generator=generator)


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, generator, shape):
        return torch.full(tuple(shape), float(self.value))


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, generator, shape):
        return _uniform(generator, shape, self.low, self.high)


class Normal(Initializer):
    def __init__(self, loc: float = 0.0, scale: float = 1.0):
        self.loc, self.scale = loc, scale

    def __call__(self, generator, shape):
        return self.loc + self.scale * _normal(generator, shape)


def _fans(shape):
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels stored HWIO: receptive * in, receptive * out
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


class Xavier(Initializer):
    """Glorot init, the legacy default."""

    def __init__(self, uniform: bool = True, gain: float = 1.0):
        self.uniform, self.gain = uniform, gain

    def __call__(self, generator, shape):
        fan_in, fan_out = _fans(shape)
        if self.uniform:
            limit = self.gain * math.sqrt(6.0 / (fan_in + fan_out))
            return _uniform(generator, shape, -limit, limit)
        std = self.gain * math.sqrt(2.0 / (fan_in + fan_out))
        return std * _normal(generator, shape)


class MSRA(Initializer):
    """He init."""

    def __init__(self, uniform: bool = False):
        self.uniform = uniform

    def __call__(self, generator, shape):
        fan_in, _ = _fans(shape)
        if self.uniform:
            limit = math.sqrt(6.0 / fan_in)
            return _uniform(generator, shape, -limit, limit)
        return math.sqrt(2.0 / fan_in) * _normal(generator, shape)


_NAMED = {
    "zeros": Constant(0.0),
    "ones": Constant(1.0),
    "xavier": Xavier(),
    "msra": MSRA(),
    "normal": Normal(0.0, 0.01),
    "uniform": Uniform(-0.05, 0.05),
}


def resolve(init) -> Initializer:
    """Accept an Initializer, a name, or a float (constant)."""
    if isinstance(init, Initializer):
        return init
    if isinstance(init, str):
        return _NAMED[init]
    if isinstance(init, (int, float)):
        return Constant(float(init))
    if callable(init):  # raw fn(generator, shape)
        class _Wrap(Initializer):
            def __call__(self, generator, shape):
                return init(generator, shape)
        return _Wrap()
    raise TypeError(f"cannot resolve initializer from {init!r}")
