"""Gradient clipping attrs and the ops that apply them (reference
``python/paddle/v2/fluid/clip.py``: error clip + gradient clip)."""

from __future__ import annotations

from paddle_tpu_torch.fluid import layers


class BaseGradientClipAttr:
    def create_operators(self, param, grad):
        raise NotImplementedError


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def create_operators(self, param, grad):
        return param, layers.clip(grad, self.min, self.max)


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def create_operators(self, param, grad):
        return param, layers.clip_by_norm(grad, self.clip_norm)


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Scale all grads by clip_norm/max(global_norm, clip_norm)."""

    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def create_operators_group(self, params_grads):
        sq_norms = []
        for _, grad in params_grads:
            block = grad.program.global_block()
            from paddle_tpu_torch.fluid.framework import unique_name
            sq = block.create_var(name=unique_name("sq_norm"), shape=(1,),
                                  dtype=grad.dtype)
            block.append_op("squared_l2_norm", inputs={"X": [grad]},
                            outputs={"Out": [sq]})
            sq_norms.append(sq)
        total = layers.sums(sq_norms)
        global_norm = layers._apply_act(total, "sqrt")
        clip_var = layers.fill_constant((1,), "float32", self.clip_norm)
        denom = layers.elementwise_max(global_norm, clip_var)
        scale_factor = layers.elementwise_div(clip_var, denom)
        out = []
        for param, grad in params_grads:
            out.append((param,
                        layers.elementwise_mul(grad, scale_factor)))
        return out


class ErrorClipByValue:
    """Clip on the *gradient of an activation* (error clip). Applied via
    set in var attrs; provided for API parity."""

    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max


def append_gradient_clip_ops(params_grads, global_clip=None):
    if isinstance(global_clip, GradientClipByGlobalNorm):
        return global_clip.create_operators_group(params_grads)
    result = []
    for param, grad in params_grads:
        clip_attr = getattr(param, "gradient_clip", None) or global_clip
        if clip_attr is None:
            result.append((param, grad))
        else:
            result.append(clip_attr.create_operators(param, grad))
    return result
