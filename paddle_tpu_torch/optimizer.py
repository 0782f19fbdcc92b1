"""Optimizers over ``{layer: {param: tensor}}`` trees (counterpart of
``paddle_tpu/optimizer.py``: the ``Optimizer`` base, ``Momentum`` and
``Adam``; the rest of the family comes with a later slice).

``update(params, grads, state, meta)`` applies, in order: global-norm clip,
per-parameter clip, l1/l2 decay, then the rule's step with the
per-parameter learning-rate scale, as the JAX package does.  Unlike the
JAX package, whose arrays are immutable, the updates run under
``torch.no_grad()`` IN PLACE: each parameter tensor and each slot tensor
is overwritten, so a step holds no second copy of the model or of its
optimizer state (at the LM's full width, 0.7 GB of Adam slots).
``update`` returns the same (now updated) trees.

The step counter ``t`` is a 0-dim int32 tensor on the parameters' device,
as the JAX package carries it, and the bias corrections and the
learning-rate schedules are computed from it there, in float32, with no
host read.  It is updated in place, like every slot: a CUDA graph that
captured a step (``core/prepared.py``) replays with the counter's
current value, where a host int would stay frozen at its capture.  Under
dynamic loss scaling (the ``mixed`` precision policy) the trainer passes
``update`` a device boolean ``finite``: every leaf's new value and slots,
and ``t``, are then selected against the old ones with ``torch.where``,
so a skipped step leaves the masters, the slots and the counter bit for
bit as they were.  Masters and slots are float32 under every policy.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def _lr_schedule(args: dict) -> Callable:
    """Learning-rate decay schedules (reference:
    parameter/LearningRateScheduler.cpp registry: constant, poly, exp,
    discexp, linear, inv), of the float32 step tensor."""
    a = args.get("learning_rate_decay_a", 0.0)
    b = args.get("learning_rate_decay_b", 0.0)
    kind = args.get("learning_rate_schedule", "constant")
    base = args["learning_rate"]
    if kind == "constant":
        return lambda t: base
    if kind == "poly":
        return lambda t: base * (1.0 + a * t) ** -b
    if kind == "exp":
        return lambda t: base * a ** (t / b)
    if kind == "discexp":
        return lambda t: base * a ** torch.floor(t / b)
    if kind == "linear":
        return lambda t: torch.clamp(base - a * t, min=b)
    if kind == "inv":
        return lambda t: base / (1.0 + a * t) ** b
    raise ValueError(f"unknown learning_rate_schedule {kind!r}")


def _leaf_meta(meta: Optional[dict], layer: str, pname: str) -> dict:
    if meta and layer in meta and pname in meta[layer]:
        return meta[layer][pname]
    return {}


class Optimizer:
    """Base: subclasses define ``slots()`` and ``leaf_update()``."""

    def __init__(self, learning_rate=0.01, regularization=None,
                 gradient_clipping_threshold=0.0, model_average=None,
                 **sched_args):
        if model_average is not None:
            raise NotImplementedError(
                "model_average is not ported to paddle_tpu_torch yet")
        self.hp = {"learning_rate": learning_rate, **sched_args}
        self.lr_fn = _lr_schedule(self.hp)
        self.l1 = getattr(regularization, "l1", 0.0) if regularization else 0.0
        self.l2 = getattr(regularization, "l2", 0.0) if regularization else 0.0
        self.global_clip = gradient_clipping_threshold

    # ---- subclass interface ----
    def slots(self, p: torch.Tensor) -> dict:
        return {}

    def step_terms(self, t):
        """What ``leaf_update`` needs of the step count ``t`` (a float32
        device scalar), computed once per update."""
        return t

    def leaf_update(self, p, g, s: dict, lr: float, terms) -> None:
        """Update ``p`` and the slot tensors of ``s`` in place; ``terms``
        is ``step_terms(t)``."""
        raise NotImplementedError

    # ---- tree plumbing ----
    def init_state(self, params: dict) -> dict:
        slot_tree = {
            l: {pn: self.slots(p) for pn, p in ps.items() if p is not None}
            for l, ps in params.items()
        }
        dev = next((p.device for ps in params.values() for p in ps.values()
                    if p is not None), None)
        return {"t": torch.zeros((), dtype=torch.int32, device=dev),
                "slots": slot_tree}

    @torch.no_grad()
    def update(self, params: dict, grads: dict, state: dict,
               meta: Optional[dict] = None, sparse_grads=None,
               finite: Optional[torch.Tensor] = None):
        """One step over every parameter with a gradient, in place.
        Returns ``(params, state)`` (the same trees and tensors, updated).
        With ``finite`` (a 0-dim bool tensor) the step takes effect only
        where it is true: otherwise every parameter, slot and ``t`` keeps
        its old value."""
        if sparse_grads:
            raise NotImplementedError(
                "sparse (SelectedRows) updates are not ported to "
                "paddle_tpu_torch yet")
        t = state["t"] + 1
        tf = t.float()
        lr_t = self.lr_fn(tf)
        if self.global_clip and self.global_clip > 0:
            leaves = [g for ps in grads.values() for g in ps.values()
                      if g is not None]
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g))
                                   for g in leaves))
            scale = torch.clamp(self.global_clip / (gnorm + 1e-12), max=1.0)
        else:
            scale = None
        work = [(l, pn, p, grads[l][pn]) for l, ps in params.items()
                for pn, p in ps.items()
                if p is not None and grads[l][pn] is not None]
        if finite is not None:
            # every tensor the step writes, and a copy of each (one
            # multi-tensor launch; x * 1 is x bit for bit)
            kept = [x for l, pn, p, _ in work
                    for x in (p, *state["slots"][l][pn].values())]
            old = torch._foreach_mul(kept, 1.0)
        terms = self.step_terms(tf)
        for l, pn, p, g in work:
            if scale is not None:
                g = g * scale
            m = _leaf_meta(meta, l, pn)
            clip = m.get("clip", 0.0)
            if clip and clip > 0:
                g = torch.clamp(g, -clip, clip)
            l2 = m.get("l2", 0.0) or self.l2
            l1 = m.get("l1", 0.0) or self.l1
            if l2:
                g = g + l2 * p
            if l1:
                g = g + l1 * torch.sign(p)
            lr = lr_t * m.get("learning_rate", 1.0)
            self.leaf_update(p, g, state["slots"][l][pn], lr, terms)
        if finite is not None:
            for new, was in zip(kept, old):
                torch.where(finite, new, was, out=new)
            t = torch.where(finite, t, state["t"])
        state["t"].copy_(t)
        return params, state

    def __repr__(self):
        return f"{type(self).__name__}({self.hp})"


class Momentum(Optimizer):
    """SGD with (optionally Nesterov) momentum."""

    def __init__(self, momentum=0.0, nesterov=False, **kw):
        super().__init__(**kw)
        self.mom = momentum
        self.nesterov = nesterov

    def slots(self, p):
        return {"momentum": torch.zeros_like(p)} if self.mom else {}

    def leaf_update(self, p, g, s, lr, terms):
        if not self.mom:
            p.sub_(lr * g)
            return
        v = s["momentum"]
        v.mul_(self.mom).sub_(lr * g)          # v = mom * v - lr * g
        if self.nesterov:
            p.add_(self.mom * v - lr * g)
        else:
            p.add_(v)


SGD = Momentum


class Adam(Optimizer):
    """reference: AdamParameterOptimizer (adamApply, bias-corrected)."""

    def __init__(self, beta1=0.9, beta2=0.999, epsilon=1e-8, **kw):
        super().__init__(**kw)
        self.b1, self.b2, self.eps = beta1, beta2, epsilon

    def slots(self, p):
        return {"momentum": torch.zeros_like(p),
                "second_momentum": torch.zeros_like(p)}

    def step_terms(self, t):
        """The bias corrections (1 - b1^t, 1 - b2^t), float32 as the JAX
        package computes them."""
        return (1 - torch.pow(self.b1, t)), (1 - torch.pow(self.b2, t))

    def leaf_update(self, p, g, s, lr, terms):
        m, v = s["momentum"], s["second_momentum"]
        m.mul_(self.b1).add_(g, alpha=1 - self.b1)
        v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
        bc1, bc2 = terms
        mhat = m / bc1
        denom = torch.sqrt(v / bc2).add_(self.eps)
        p.sub_(mhat.mul_(lr).div_(denom))


class L2Regularization:
    """reference: settings(regularization=L2Regularization(rate))."""

    def __init__(self, rate: float):
        self.l2 = rate
        self.l1 = 0.0


class L1Regularization:
    def __init__(self, rate: float):
        self.l1 = rate
        self.l2 = 0.0


MomentumOptimizer = Momentum
AdamOptimizer = Adam
BaseSGDOptimizer = Optimizer
