"""Precision policy: float32 master parameters, reduced-precision compute
(counterpart of ``paddle_tpu/core/precision.py``).

A policy names four things, as the JAX package's does:

  - ``param_dtype``: master parameters and optimizer slots, always
    float32 (the optimizer updates the float32 masters; the cast to the
    compute dtype happens inside each layer's forward);
  - ``compute_dtype``: matmul activations (the layers consult
    ``ApplyContext.compute_dtype``);
  - ``output_dtype``: loss math (cost layers return float32);
  - ``loss_scaling``: dynamic loss scaling.  The loss is multiplied by a
    scale before the backward and the gradients are divided by it; a step
    whose loss or gradients are not finite is skipped (parameters,
    optimizer slots, step counter and model state kept bit for bit) and
    the scale backs off; after ``growth_interval`` clean steps in a row
    it grows.  The trainer keeps the state on the device, in its
    optimizer state under ``"loss_scale"``.

Surface: ``paddle_tpu_torch.init(precision="fp32"|"bf16"|"fp16"|"mixed")``
or ``train --precision``; ``init(compute_dtype=)`` is the deprecated alias
that maps onto the equivalent policy without loss scaling (``bfloat16`` ->
``bf16``), warned once.  ``fp32`` is bit-equal to no policy at all.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import torch

# canonical policy names -> (compute dtype, loss scaling), and the dtype
# names the legacy compute_dtype option accepted
_PRESETS = {
    "fp32": ("float32", False),
    "bf16": ("bfloat16", False),
    "fp16": ("float16", False),
    "mixed": ("bfloat16", True),
}
_ALIASES = {
    "float32": "fp32",
    "bfloat16": "bf16",
    "float16": "fp16",
}

# loss-scaling defaults (torch.amp's and Micikevicius et al.'s choices);
# each is overridable through init(loss_scale_*=)
DEFAULT_INIT_SCALE = 2.0 ** 15
DEFAULT_GROWTH_INTERVAL = 2000
DEFAULT_GROWTH_FACTOR = 2.0
DEFAULT_BACKOFF_FACTOR = 0.5
DEFAULT_MAX_SCALE = 2.0 ** 24
DEFAULT_MIN_SCALE = 1.0

_legacy_warned = False


def canonical_name(name: str) -> str:
    """'bfloat16' -> 'bf16' etc.; raises on an unknown policy name."""
    n = str(name)
    n = _ALIASES.get(n, n)
    if n not in _PRESETS:
        raise ValueError(
            f"unknown precision {name!r}; expected one of "
            f"{sorted(_PRESETS)} (or a dtype alias {sorted(_ALIASES)})")
    return n


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


@dataclass(frozen=True)
class Policy:
    """A resolved precision policy: scalars only, hashable."""

    name: str
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    output_dtype: str = "float32"
    loss_scaling: bool = False
    init_scale: float = DEFAULT_INIT_SCALE
    growth_interval: int = DEFAULT_GROWTH_INTERVAL
    growth_factor: float = DEFAULT_GROWTH_FACTOR
    backoff_factor: float = DEFAULT_BACKOFF_FACTOR
    max_scale: float = DEFAULT_MAX_SCALE
    min_scale: float = DEFAULT_MIN_SCALE

    def ctx_compute_dtype(self):
        """The ``ApplyContext.compute_dtype`` value: the torch dtype of
        reduced-precision compute, or None under float32 (the layers then
        skip their casts entirely, which keeps ``fp32`` bit-equal)."""
        if self.compute_dtype == "float32":
            return None
        return torch_dtype(self.compute_dtype)

    def signature(self) -> tuple:
        """Every field that changes the step: the key a prepared step
        (or anything cached per policy) is stored under."""
        sig = (self.param_dtype, self.compute_dtype, self.output_dtype,
               self.loss_scaling)
        if self.loss_scaling:
            sig += (self.init_scale, self.growth_interval,
                    self.growth_factor, self.backoff_factor,
                    self.max_scale, self.min_scale)
        return sig

    def init_loss_scale_state(self, device) -> dict:
        """Fresh loss-scale state on ``device``: the scale, the clean
        steps since the last change, and the skipped steps."""
        return {"scale": torch.tensor(self.init_scale, dtype=torch.float32,
                                      device=device),
                "good_steps": torch.zeros((), dtype=torch.int32,
                                          device=device),
                "skipped": torch.zeros((), dtype=torch.int32,
                                       device=device)}


def resolve(options: dict) -> Policy:
    """The policy of the options dict.  An explicit ``precision`` option
    wins; otherwise the legacy ``compute_dtype`` option names the
    equivalent policy without loss scaling."""
    name = options.get("precision")
    if name is None:
        name = _ALIASES.get(options.get("compute_dtype", "float32"),
                            "fp32")
    name = canonical_name(name)
    compute, scaling = _PRESETS[name]
    return Policy(
        name=name, compute_dtype=compute, loss_scaling=scaling,
        init_scale=float(options.get("loss_scale_init",
                                     DEFAULT_INIT_SCALE)),
        growth_interval=int(options.get("loss_scale_growth_interval",
                                        DEFAULT_GROWTH_INTERVAL)),
        growth_factor=float(options.get("loss_scale_growth_factor",
                                        DEFAULT_GROWTH_FACTOR)),
        backoff_factor=float(options.get("loss_scale_backoff_factor",
                                         DEFAULT_BACKOFF_FACTOR)),
        max_scale=float(options.get("loss_scale_max", DEFAULT_MAX_SCALE)),
        min_scale=float(options.get("loss_scale_min", DEFAULT_MIN_SCALE)))


def apply_policy_name(name: str) -> None:
    """Make ``name`` the active policy, keeping the legacy
    ``compute_dtype`` option in step with it."""
    from paddle_tpu_torch.core import config

    n = canonical_name(name)
    config.set_option("precision", n)
    config.set_option("compute_dtype", _PRESETS[n][0])


def apply_legacy_compute_dtype(dtype_name: str) -> None:
    """``init(compute_dtype=)``: warn once, then apply the equivalent
    policy (``bfloat16``: float32 masters, bf16 compute, no loss
    scaling)."""
    global _legacy_warned
    if not _legacy_warned:
        _legacy_warned = True
        warnings.warn(
            "init(compute_dtype=...) is deprecated; use "
            "init(precision='fp32'|'bf16'|'fp16'|'mixed') - compute_dtype "
            "maps onto the equivalent non-scaling policy",
            DeprecationWarning, stacklevel=3)
    apply_policy_name(dtype_name)
