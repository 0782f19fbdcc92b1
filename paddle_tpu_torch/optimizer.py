"""Optimizers over ``{layer: {param: tensor}}`` trees (counterpart of
``paddle_tpu/optimizer.py``: the ``Optimizer`` base, Momentum, Adagrad,
DecayedAdagrad, AdaDelta, RMSProp, Adam, Adamax, Ftrl, the l1 / l2
regularizers, ModelAverage, the legacy class names and ``settings()``).

``update(params, grads, state, meta)`` applies, in order: global-norm clip,
per-parameter clip, l1/l2 decay, then the rule's step with the
per-parameter learning-rate scale, as the JAX package does.  Unlike the
JAX package, whose arrays are immutable, the updates run under
``torch.no_grad()`` IN PLACE: each parameter tensor and each slot tensor
is overwritten, so a step holds no second copy of the model or of its
optimizer state (at the LM's full width, 0.7 GB of Adam slots).
``update`` returns the same (now updated) trees.  With a ``ModelAverage``
the state also holds ``avg`` (a running mean of the parameters after
each step, a copy of the parameters at the start) and its count
``avg_n``, updated in place the same way.

The step counter ``t`` is a 0-dim int32 tensor on the parameters' device,
as the JAX package carries it, and the bias corrections and the
learning-rate schedules are computed from it there, in float32, with no
host read.  It is updated in place, like every slot: a CUDA graph that
captured a step (``core/prepared.py``) replays with the counter's
current value, where a host int would stay frozen at its capture.  Under
dynamic loss scaling (the ``mixed`` precision policy) the trainer passes
``update`` a device boolean ``finite``: every leaf's new value and slots,
``t`` and the average are then selected against the old ones with
``torch.where``, so a skipped step leaves them bit for bit as they were.
Masters and slots are float32 under every policy.
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
        self.hp = {"learning_rate": learning_rate, **sched_args}
        self.lr_fn = _lr_schedule(self.hp)
        self.l1 = getattr(regularization, "l1", 0.0) if regularization else 0.0
        self.l2 = getattr(regularization, "l2", 0.0) if regularization else 0.0
        self.global_clip = gradient_clipping_threshold
        self.model_average = model_average

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
        state = {"t": torch.zeros((), dtype=torch.int32, device=dev),
                 "slots": slot_tree}
        if self.model_average:
            state["avg"] = {l: {pn: (None if p is None else p.clone())
                                for pn, p in ps.items()}
                            for l, ps in params.items()}
            state["avg_n"] = torch.zeros((), dtype=torch.float32,
                                         device=dev)
        return state

    @staticmethod
    def state_tensors(state: dict) -> list:
        """Every tensor of ``state`` that ``update`` writes in place: the
        slots, the step counter and the average."""
        out = [s for ps in state["slots"].values() for ss in ps.values()
               for s in ss.values()]
        out.append(state["t"])
        if "avg" in state:
            out += [a for ps in state["avg"].values() for a in ps.values()
                    if a is not None]
            out.append(state["avg_n"])
        return out

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
                "paddle_tpu_torch yet (ROADMAP.md section 1, item 4)")
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
        avg = state.get("avg") if self.model_average else None
        if finite is not None:
            # every tensor the step writes, and a copy of each (one
            # multi-tensor launch; x * 1 is x bit for bit)
            kept = [x for l, pn, p, _ in work
                    for x in (p, *state["slots"][l][pn].values())]
            if avg is not None:
                kept += [a for ps in avg.values() for a in ps.values()
                         if a is not None]
                kept.append(state["avg_n"])
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
        if avg is not None:
            # avg += (p - avg) / n over the updated parameters
            n = state["avg_n"] + 1.0
            for l, ps in params.items():
                for pn, p in ps.items():
                    if p is not None:
                        a = avg[l][pn]
                        a.add_((p - a) / n)
            state["avg_n"].copy_(n)
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


class Adagrad(Optimizer):
    """reference: AdagradParameterOptimizer (adagradApply)."""

    def __init__(self, epsilon=1e-6, **kw):
        super().__init__(**kw)
        self.eps = epsilon

    def slots(self, p):
        return {"accum": torch.zeros_like(p)}

    def leaf_update(self, p, g, s, lr, terms):
        acc = s["accum"]
        acc.add_(torch.square(g))
        p.sub_(lr * g / (torch.sqrt(acc) + self.eps))


class DecayedAdagrad(Optimizer):
    """reference: DecayedAdagradParameterOptimizer (a rho-decayed
    accumulator)."""

    def __init__(self, rho=0.95, epsilon=1e-6, **kw):
        super().__init__(**kw)
        self.rho, self.eps = rho, epsilon

    def slots(self, p):
        return {"accum": torch.zeros_like(p)}

    def leaf_update(self, p, g, s, lr, terms):
        acc = s["accum"]
        acc.mul_(self.rho).add_((1 - self.rho) * torch.square(g))
        p.sub_(lr * g / (torch.sqrt(acc) + self.eps))


class AdaDelta(Optimizer):
    """reference: AdaDeltaParameterOptimizer (adadeltaApply)."""

    def __init__(self, rho=0.95, epsilon=1e-6, **kw):
        super().__init__(**kw)
        self.rho, self.eps = rho, epsilon

    def slots(self, p):
        return {"accum": torch.zeros_like(p),
                "accum_update": torch.zeros_like(p)}

    def leaf_update(self, p, g, s, lr, terms):
        acc, accu = s["accum"], s["accum_update"]
        acc.mul_(self.rho).add_((1 - self.rho) * torch.square(g))
        upd = torch.sqrt(accu + self.eps) / torch.sqrt(acc + self.eps) * g
        accu.mul_(self.rho).add_((1 - self.rho) * torch.square(upd))
        p.sub_(lr * upd)


class RMSProp(Optimizer):
    """reference: RMSPropParameterOptimizer (rmspropApply, with the
    mean-gradient correction term; ``momentum`` adds a velocity slot)."""

    def __init__(self, rho=0.95, epsilon=1e-6, momentum=0.0, **kw):
        super().__init__(**kw)
        self.rho, self.eps, self.mom = rho, epsilon, momentum

    def slots(self, p):
        s = {"mean_square": torch.zeros_like(p),
             "mean_grad": torch.zeros_like(p)}
        if self.mom:
            s["momentum"] = torch.zeros_like(p)
        return s

    def leaf_update(self, p, g, s, lr, terms):
        ms, mg = s["mean_square"], s["mean_grad"]
        ms.mul_(self.rho).add_((1 - self.rho) * torch.square(g))
        mg.mul_(self.rho).add_((1 - self.rho) * g)
        step = lr * g / torch.sqrt(ms - torch.square(mg) + self.eps)
        if self.mom:
            v = s["momentum"]
            v.mul_(self.mom).add_(step)
            p.sub_(v)
        else:
            p.sub_(step)


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


class Adamax(Optimizer):
    """reference: AdamaxParameterOptimizer (adamaxApply)."""

    def __init__(self, beta1=0.9, beta2=0.999, **kw):
        super().__init__(**kw)
        self.b1, self.b2 = beta1, beta2

    def slots(self, p):
        return {"momentum": torch.zeros_like(p), "u": torch.zeros_like(p)}

    def step_terms(self, t):
        """The bias correction 1 - b1^t, float32 on the device."""
        return 1 - torch.pow(self.b1, t)

    def leaf_update(self, p, g, s, lr, terms):
        m, u = s["momentum"], s["u"]
        m.mul_(self.b1).add_((1 - self.b1) * g)
        torch.maximum(self.b2 * u, torch.abs(g), out=u)
        p.sub_(lr / terms * m / (u + 1e-12))


class Ftrl(Optimizer):
    """reference: fluid ftrl_op (``l1``, ``l2`` and ``lr_power`` are the
    rule's own, not the regularizer's)."""

    def __init__(self, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(**kw)
        self.ftrl_l1, self.ftrl_l2, self.lr_power = l1, l2, lr_power

    def slots(self, p):
        return {"squared": torch.zeros_like(p),
                "linear": torch.zeros_like(p)}

    def leaf_update(self, p, g, s, lr, terms):
        sq, lin = s["squared"], s["linear"]
        new_sq = sq + torch.square(g)
        sigma = (torch.pow(new_sq, -self.lr_power)
                 - torch.pow(sq + 1e-12, -self.lr_power)) / lr
        lin.add_(g - sigma * p)
        quad = torch.pow(new_sq, -self.lr_power) / lr + 2 * self.ftrl_l2
        pre = torch.clamp(lin, -self.ftrl_l1, self.ftrl_l1) - lin
        p.copy_(pre / quad)
        sq.copy_(new_sq)


class L2Regularization:
    """reference: settings(regularization=L2Regularization(rate))."""

    def __init__(self, rate: float):
        self.l2 = rate
        self.l1 = 0.0


class L1Regularization:
    def __init__(self, rate: float):
        self.l1 = rate
        self.l2 = 0.0


class ModelAverage:
    """reference: AverageOptimizer / ModelAverage(average_window).  The
    averaged weights live in the optimizer state (``avg``, ``avg_n``)."""

    def __init__(self, average_window: float = 0.0,
                 max_average_window: int = 0):
        self.average_window = average_window
        self.max_average_window = max_average_window


# ------------------------------------------------------------------ legacy
# trainer_config_helpers/optimizers.py class names and settings()

MomentumOptimizer = Momentum
AdamOptimizer = Adam
AdamaxOptimizer = Adamax
AdaGradOptimizer = Adagrad
DecayedAdaGradOptimizer = DecayedAdagrad
AdaDeltaOptimizer = AdaDelta
RMSPropOptimizer = RMSProp
BaseSGDOptimizer = Optimizer
BaseRegularization = L2Regularization


def settings(batch_size=None, learning_rate=None, learning_rate_decay_a=0.0,
             learning_rate_decay_b=0.0, learning_rate_schedule=None,
             learning_method=None, regularization=None, is_async=False,
             model_average=None, gradient_clipping_threshold=None):
    """The legacy config entry (reference: trainer_config_helpers
    settings()): returns the configured Optimizer, to hand to
    ``trainer.SGD``.  ``batch_size`` is taken for the signature's sake and
    sets nothing: the port's trainer batches as its reader does, and no
    command of the port reads a configured batch size."""
    opt = learning_method or Momentum(
        learning_rate=learning_rate if learning_rate is not None else 1e-3)
    if learning_rate is not None:
        opt.hp["learning_rate"] = learning_rate
    if learning_rate_schedule:
        opt.hp.update(learning_rate_schedule=learning_rate_schedule,
                      learning_rate_decay_a=learning_rate_decay_a,
                      learning_rate_decay_b=learning_rate_decay_b)
    opt.lr_fn = _lr_schedule(opt.hp)
    if regularization is not None:
        opt.l1 = getattr(regularization, "l1", 0.0)
        opt.l2 = getattr(regularization, "l2", 0.0)
    if gradient_clipping_threshold:
        opt.global_clip = gradient_clipping_threshold
    if model_average is not None:
        opt.model_average = model_average
    return opt
