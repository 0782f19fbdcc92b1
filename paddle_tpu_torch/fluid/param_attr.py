"""ParamAttr: per-parameter configuration (reference
``python/paddle/v2/fluid/param_attr.py``)."""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch.fluid import initializer as init_mod


class ParamAttr:
    def __init__(self, name: Optional[str] = None, initializer=None,
                 learning_rate: float = 1.0, regularizer=None,
                 trainable: bool = True, gradient_clip=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip

    @staticmethod
    def to_attr(arg) -> "ParamAttr":
        if arg is None or arg is True:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, init_mod.Initializer):
            return ParamAttr(initializer=arg)
        raise TypeError(f"cannot convert {arg!r} to ParamAttr")
