"""Pooling type descriptors for sequence pooling and spatial pooling DSL
(a copy of ``paddle_tpu/pooling.py``, which the port does not import).

Reference: python/paddle/trainer_config_helpers/poolings.py — MaxPooling,
AvgPooling, SumPooling, SqrtAvgPooling (sequence pooling over timesteps),
and the spatial pool types used by img_pool_layer.
"""

from __future__ import annotations


class BasePoolingType:
    name: str = None


class MaxPooling(BasePoolingType):
    name = "max"

    def __init__(self, output_max_index: bool = False):
        self.output_max_index = output_max_index


class AvgPooling(BasePoolingType):
    name = "avg"


class SumPooling(BasePoolingType):
    name = "sum"


class SqrtAvgPooling(BasePoolingType):
    """sum / sqrt(len) — reference: AverageLayer "squarerootn" mode."""
    name = "sqrt_avg"


class CudnnMaxPooling(MaxPooling):   # parity alias
    pass


class CudnnAvgPooling(AvgPooling):
    pass


def resolve(p) -> str:
    if p is None:
        return "max"
    if isinstance(p, str):
        return p
    if isinstance(p, BasePoolingType) or (isinstance(p, type) and
                                          issubclass(p, BasePoolingType)):
        return p.name
    raise TypeError(f"cannot resolve pooling from {p!r}")


class MaxWithMaskPooling(MaxPooling):
    """max pooling that also emits argmax indices (reference:
    MaxWithMaskPooling; pool layer attrs output the mask)."""
    name = "max"

    def __init__(self):
        super().__init__(output_max_index=True)


class SquareRootNPooling(SqrtAvgPooling):
    """reference alias: SquareRootNPooling == sum/sqrt(n)."""


class CudnnAvgInclPadPooling(AvgPooling):
    """parity alias (include-padding average; the pool layer's average
    leaves the padding out of its divisor, layers/conv.py)."""
    name = "avg_incl_pad"
