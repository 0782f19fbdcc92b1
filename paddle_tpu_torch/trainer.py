"""Trainer: the v2-style event-loop trainer (counterpart of
``paddle_tpu/trainer.py``).

The step mirrors the JAX package's ``_build_step`` on its fp32, no-sparse,
no-probe path: ``Topology.forward`` under autograd, the gradient of the
cost with respect to every trainable parameter (``torch.autograd.grad``),
then ``optimizer.update`` in place.  The running state (batch-norm moving
statistics) is ``model_state``: each training step's forward replaces it
with the new, detached state, and ``test`` runs on it in eval mode.  Where the JAX step is one jitted
program with donated buffers, here each layer's kernels launch eagerly
from the Python loop; the attention layers reach the CUDA flash kernels
(forward, dK/dV, dQ) on the card.

The precision policy (``core/precision.py``) is read at every step, as
the JAX trainer's ``_sync_precision_policy`` does: under ``bf16`` the
layers compute in bf16 on the float32 masters; under ``mixed`` the step
also scales the float32 loss by the loss scale before the backward,
divides the gradients by it, and tests the loss and every gradient for
finiteness.  A non-finite step keeps the parameters, the optimizer slots,
Adam's step counter and ``model_state`` bit for bit, and backs the scale
off; ``growth_interval`` clean steps in a row grow it.  That state lives
in the optimizer state under ``"loss_scale"`` (``scale``, ``good_steps``,
``skipped``) and every decision is a ``torch.where`` on the device, so a
step reads nothing back to the host.  Under ``fp32`` none of this runs.

Events fire in the JAX package's order: ``BeginPass``, then per batch
``BeginIteration``, ``EndForwardBackward``, ``EndIteration`` (with the
cost, read lazily), and ``EndPass``.  Parameters are updated in place, so
the ``Parameters`` given to ``SGD`` hold the trained values; ``train``
also re-merges them at the end of every pass, as ``_sync_parameters``
does.

Not ported yet, and refused: ``steps_per_dispatch``, ``seq_buckets``,
``prefetch_depth``, ``checkpoint_config``, ``mesh``, ``remat`` and
``check_nan_inf``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from paddle_tpu_torch import event as v2_event
from paddle_tpu_torch import parameters as params_mod
from paddle_tpu_torch.core import config as cfg
from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch.topology import Topology


def _refuse(**flags) -> None:
    for name, value in flags.items():
        if value:
            raise NotImplementedError(
                f"{name} is not ported to paddle_tpu_torch yet "
                f"(ROADMAP.md section 1)")


class SGD:
    """trainer = SGD(cost, parameters, update_equation); trainer.train(...).

    API parity with python/paddle/v2/trainer.py:37.  ``update_equation`` is
    a ``paddle_tpu_torch.optimizer.Optimizer``.  The trainer runs where the
    parameters lie, which must be ``device`` (default: the ``device``
    option, else the card)."""

    def __init__(self, cost, parameters, update_equation, extra_layers=None,
                 is_local: bool = True, mesh=None, remat: bool = False,
                 check_nan_inf: bool = False, mesh_rules=None, device=None):
        _refuse(mesh=mesh, remat=remat, check_nan_inf=check_nan_inf,
                mesh_rules=mesh_rules)
        self.device = cfg.default_device(device)
        self.topology = (cost if isinstance(cost, Topology)
                         else Topology(cost, extra_inputs=extra_layers))
        self.parameters = parameters
        self.optimizer = update_equation
        self.cost_name = self.topology.output_names[0]
        for key in parameters.keys():
            layer, _, pname = key.rpartition(".")
            if parameters.values[layer][pname].device.type \
                    != self.device.type:
                raise ValueError(
                    f"parameter {key} lies on "
                    f"{parameters.values[layer][pname].device}, the "
                    f"trainer runs on {self.device}")
        self.model_state = self.topology.create_state(device=self.device)
        self._mask = parameters.trainable_mask()
        self._trainable, self._frozen = params_mod.partition(
            parameters.values, self._mask)
        self._opt_state = self.optimizer.init_state(self._trainable)
        self._generator = torch.Generator().manual_seed(
            int(cfg.get_option("seed", 0)) + 17)

    # ------------------------------------------------------------- step
    def _leaves(self):
        return [(l, pn, p) for l, ps in self._trainable.items()
                for pn, p in ps.items() if p is not None]

    def forward_backward(self, feed, scale: Optional[torch.Tensor] = None):
        """Cost and gradients of one batch, parameters untouched: returns
        (cost tensor, ``{layer: {param: grad}}`` over the trainable
        parameters; zeros for a parameter the cost does not reach, as
        ``jax.grad`` gives).  With ``scale`` (the loss scale, a float32
        tensor) the backward runs on the float32 cost times ``scale`` and
        the gradients come back divided by it; the cost is unscaled."""
        loss, tree, _ = self._grads(feed, scale)
        return loss, tree

    def _grads(self, feed, scale):
        """``forward_backward``, and under a loss scale a float32 [1]
        flag on the device, nonzero when a gradient is not finite (the
        division by the scale and the test are one multi-tensor pass:
        ``torch.amp``'s unscale)."""
        leaves = self._leaves()
        tensors = [p.detach().requires_grad_(True) for _, _, p in leaves]
        trainable = {l: dict(ps) for l, ps in self._trainable.items()}
        for (l, pn, _), t in zip(leaves, tensors):
            trainable[l][pn] = t
        params = params_mod.merge(trainable, self._frozen)
        outs, self.model_state = self.topology.forward(
            params, self.model_state, feed, train=True,
            outputs=[self.cost_name], generator=self._generator,
            device=self.device)
        loss = outs[self.cost_name]
        # scaled after the float32 cost, so the backward carries the
        # scaled cotangent through the whole bf16 stack
        obj = loss if scale is None else loss.float() * scale
        grads = list(torch.autograd.grad(obj, tensors, allow_unused=True))
        found = None
        if scale is not None:
            found = torch.zeros(1, device=self.device)
            live = [g for g in grads if g is not None]
            if live:
                torch._amp_foreach_non_finite_check_and_unscale_(
                    live, found, (1.0 / scale).reshape(1))
        tree = {l: {pn: None for pn in ps}
                for l, ps in self._trainable.items()}
        for (l, pn, p), g in zip(leaves, grads):
            tree[l][pn] = torch.zeros_like(p) if g is None else g
        return loss.detach(), tree, found

    def _sync_precision_policy(self):
        """Align the optimizer state with the active policy: attach the
        loss-scale state (and move the step counter to the device) when
        the policy scales, drop it (and bring the counter back to the
        host) when it does not."""
        policy = cfg.precision_policy()
        state = self._opt_state
        if policy.loss_scaling and "loss_scale" not in state:
            state["loss_scale"] = policy.init_loss_scale_state(self.device)
            state["t"] = torch.tensor(state["t"], dtype=torch.int32,
                                      device=self.device)
        elif not policy.loss_scaling and "loss_scale" in state:
            del state["loss_scale"]
            state["t"] = int(state["t"])
        return policy

    def _step(self, feed):
        policy = self._sync_precision_policy()
        if not policy.loss_scaling:
            loss, grads = self.forward_backward(feed)
            self.optimizer.update(self._trainable, grads, self._opt_state,
                                  self.parameters.meta)
            return loss
        return self._scaled_step(feed, policy)

    @torch.no_grad()
    def _scaled_step(self, feed, policy):
        """One step under dynamic loss scaling (the JAX step's
        ``scaling`` branch), every decision on the device."""
        ls = self._opt_state["loss_scale"]
        scale = ls["scale"]
        old_state = self.model_state
        with torch.enable_grad():
            loss, grads, found = self._grads(feed, scale)
        finite = torch.isfinite(loss).all() & (found[0] == 0)
        self.optimizer.update(self._trainable, grads, self._opt_state,
                              self.parameters.meta, finite=finite)
        self.model_state = {
            l: {k: torch.where(finite, v, old_state[l][k])
                for k, v in ps.items()}
            for l, ps in self.model_state.items()}
        good = torch.where(finite, ls["good_steps"] + 1, 0)
        grow = good >= policy.growth_interval
        new_scale = torch.where(
            finite,
            torch.where(grow, torch.clamp(scale * policy.growth_factor,
                                          max=policy.max_scale), scale),
            torch.clamp(scale * policy.backoff_factor,
                        min=policy.min_scale))
        self._opt_state["loss_scale"] = {
            "scale": new_scale,
            "good_steps": torch.where(grow & finite, 0, good),
            "skipped": ls["skipped"] + (~finite).to(torch.int32)}
        return loss

    # ------------------------------------------------------------ train
    def train(self, reader, num_passes: int = 1,
              event_handler: Optional[Callable] = None,
              feeding: Optional[Dict[str, int]] = None,
              checkpoint_config=None,
              prefetch_depth: Optional[int] = None,
              steps_per_dispatch: Optional[int] = None,
              seq_buckets=None):
        """``reader`` yields batches (lists of sample tuples) per the v2
        ``paddle.batch(...)`` protocol, or feed dicts directly."""
        _refuse(checkpoint_config=checkpoint_config,
                prefetch_depth=prefetch_depth,
                steps_per_dispatch=(steps_per_dispatch
                                    not in (None, 1)),
                seq_buckets=seq_buckets)
        if event_handler is None:
            event_handler = _default_event_handler
        feeder = DataFeeder(self.topology, feeding)
        for pass_id in range(num_passes):
            event_handler(v2_event.BeginPass(pass_id))
            for batch_id, data_batch in enumerate(reader()):
                feed = (data_batch if isinstance(data_batch, dict)
                        else feeder.feed(data_batch))
                event_handler(v2_event.BeginIteration(pass_id, batch_id))
                loss = self._step(feed)
                event_handler(v2_event.EndForwardBackward(
                    pass_id, batch_id, self))
                event_handler(v2_event.EndIteration(
                    pass_id, batch_id, loss, {}))
            self._sync_parameters()
            event_handler(v2_event.EndPass(pass_id, metrics={}))

    @torch.no_grad()
    def test(self, reader, feeding: Optional[Dict[str, int]] = None):
        """average cost over a reader (reference: Tester / trainer.test)."""
        feeder = DataFeeder(self.topology, feeding)
        params = params_mod.merge(self._trainable, self._frozen)
        total, n = 0.0, 0
        for data_batch in reader():
            feed = (data_batch if isinstance(data_batch, dict)
                    else feeder.feed(data_batch))
            outs, _ = self.topology.forward(params, self.model_state, feed,
                                            train=False,
                                            outputs=[self.cost_name],
                                            device=self.device)
            total += float(outs[self.cost_name])
            n += 1
        return v2_event.TestResult(total / max(n, 1), metrics={})

    def _sync_parameters(self) -> None:
        """Reflect the trained tree back into the Parameters object."""
        self.parameters.values = params_mod.merge(self._trainable,
                                                  self._frozen)


def _default_event_handler(evt) -> None:
    period = cfg.get_option("log_period", 100)
    if isinstance(evt, v2_event.EndIteration):
        if evt.batch_id % period == 0:
            print(f"Pass {evt.pass_id}, Batch {evt.batch_id}, "
                  f"Cost {evt.cost:.6f}")
