"""Weight-decay regularizers appended as IR ops (reference
``python/paddle/v2/fluid/regularizer.py``)."""

from __future__ import annotations

from paddle_tpu_torch.fluid import layers


class WeightDecayRegularizer:
    def append_regularization_op(self, param, grad):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff: float = 0.0):
        self.coeff = regularization_coeff

    def append_regularization_op(self, param, grad):
        decay = layers.scale(param, scale=self.coeff)
        return layers.elementwise_add(grad, decay)


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff: float = 0.0):
        self.coeff = regularization_coeff

    def append_regularization_op(self, param, grad):
        from paddle_tpu_torch.fluid.framework import unique_name
        block = param.program.global_block()
        sign_var = block.create_var(name=unique_name("sign"),
                                    shape=param.shape, dtype=param.dtype)
        block.append_op("sign", inputs={"X": [param]},
                        outputs={"Out": [sign_var]})
        decay = layers.scale(sign_var, scale=self.coeff)
        return layers.elementwise_add(grad, decay)


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer


def append_regularization_ops(params_grads, regularization=None):
    """Apply per-param or global regularizer; returns new (param, grad)
    pairs (reference ``regularizer.py append_regularization_ops``)."""
    result = []
    for param, grad in params_grads:
        regular = getattr(param, "regularizer", None) or regularization
        if regular is None:
            result.append((param, grad))
            continue
        result.append((param, regular.append_regularization_op(param, grad)))
    return result
