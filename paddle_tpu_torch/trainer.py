"""Trainer: the v2-style event-loop trainer (counterpart of
``paddle_tpu/trainer.py``).

The step mirrors the JAX package's ``_build_step`` on its no-sparse,
no-probe path: ``Topology.forward`` under autograd, the gradient of the
cost with respect to every trainable parameter (``torch.autograd.grad``),
then ``optimizer.update``.  Every tensor a step changes is changed in
place: the parameters, the optimizer's slots and its step counter ``t``
(a device tensor), the running state ``model_state`` (batch-norm moving
statistics, which ``test`` reads in eval mode) and the loss-scale state.
So a CUDA graph that captured steps carries the training forward at each
replay, and the eager step and the captured one are one arithmetic.
Where the JAX step is one jitted program with donated buffers, here each
layer's kernels launch eagerly from the Python loop; the attention
layers reach the CUDA flash kernels (forward, dK/dV, dQ) on the card.

The precision policy (``core/precision.py``) is read at every step, as
the JAX trainer's ``_sync_precision_policy`` does: under ``bf16`` the
layers compute in bf16 on the float32 masters; under ``mixed`` the step
also scales the float32 loss by the loss scale before the backward,
divides the gradients by it, and tests the loss and every gradient for
finiteness.  A non-finite step keeps the parameters, the optimizer slots,
the step counter and ``model_state`` bit for bit, and backs the scale
off; ``growth_interval`` clean steps in a row grow it.  That state lives
in the optimizer state under ``"loss_scale"`` (``scale``, ``good_steps``,
``skipped``) and every decision is a ``torch.where`` on the device, so a
step reads nothing back to the host.  Under ``fp32`` none of this runs.
A change of policy drops the prepared chunks.

Events fire in the JAX package's order: ``BeginPass``, then per batch
``BeginIteration``, ``EndForwardBackward``, ``EndIteration`` (with the
cost, read lazily), and ``EndPass``.  Parameters are updated in place, so
the ``Parameters`` given to ``SGD`` hold the trained values; ``train``
also re-merges them at the end of every pass, as ``_sync_parameters``
does.

The dispatch options are the JAX package's:

- ``train(steps_per_dispatch=k)`` draws k batches at a time and runs a
  full group of one feed signature as one prepared chunk
  (``core/prepared.py``): on the card one CUDA graph of the k steps, one
  replay per chunk, bit for bit the k eager steps; on the CPU the k
  steps eagerly.  A short or ragged group runs per step.  The per-batch
  events fire after the chunk, in the JAX order.  ``step_capture_count``
  counts the chunks prepared (the JAX ``step_compile_count``).
  ``build_multi_step`` and ``timed_multi_dispatch`` time the same chunk
  (``--job=time``, ``bench.py``'s ``bench_lstm``).  The default k = 1
  step is eager;
- ``train(seq_buckets=)`` pads each batch's plain sequence inputs to the
  smallest bucket covering its longest sequence (``_make_feed_converter``);
- ``train(prefetch_depth=)`` converts and copies batches ahead on a
  producer thread (``reader/prefetch.py``);
- ``SGD(check_nan_inf=True)`` tests the loss and every gradient (only the
  loss under loss scaling) at every step, one host read a step, and
  raises ``FloatingPointError`` naming them; it runs the chunks per step;
- ``SGD(remat=True | "blocks")`` recomputes layers in the backward
  (``Topology.forward``).

Not ported yet, and refused: ``checkpoint_config``, ``mesh`` and
``mesh_rules``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from paddle_tpu_torch import event as v2_event
from paddle_tpu_torch import parameters as params_mod
from paddle_tpu_torch.core import config as cfg
from paddle_tpu_torch.core import prepared
from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch.topology import Topology


def _refuse(**flags) -> None:
    for name, value in flags.items():
        if value:
            raise NotImplementedError(
                f"{name} is not ported to paddle_tpu_torch yet "
                f"(ROADMAP.md section 1)")


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _stack(values, device):
    """One feed entry of a group, stacked on a leading axis."""
    if all(isinstance(v, np.ndarray) for v in values):
        return torch.from_numpy(np.stack(values))
    return torch.stack([torch.as_tensor(v, device=device) for v in values])


class SGD:
    """trainer = SGD(cost, parameters, update_equation); trainer.train(...).

    API parity with python/paddle/v2/trainer.py:37.  ``update_equation`` is
    a ``paddle_tpu_torch.optimizer.Optimizer``.  The trainer runs where the
    parameters lie, which must be ``device`` (default: the ``device``
    option, else the card)."""

    def __init__(self, cost, parameters, update_equation, extra_layers=None,
                 is_local: bool = True, mesh=None, remat: bool = False,
                 check_nan_inf: bool = False, mesh_rules=None, device=None):
        _refuse(mesh=mesh, mesh_rules=mesh_rules)
        self.device = cfg.default_device(device)
        self.topology = (cost if isinstance(cost, Topology)
                         else Topology(cost, extra_inputs=extra_layers))
        self.parameters = parameters
        self.optimizer = update_equation
        self.cost_name = self.topology.output_names[0]
        self.remat = remat
        # --check_nan_inf parity (reference: FLAGS_check_nan_inf): the
        # step tests the loss and every gradient, and the loop raises
        # naming the non-finite ones
        self.check_nan_inf = check_nan_inf
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
        # the forward's random stream (dropout, NCE), on the trainer's
        # device; a captured chunk registers it with its graph
        self._generator = torch.Generator(device=self.device).manual_seed(
            int(cfg.get_option("seed", 0)) + 17)
        # the prepared k-step chunks (train(steps_per_dispatch=k))
        self._chunks = prepared.PreparedFamily(self.device)
        self._built_policy_sig = None
        self._sync_precision_policy()

    @property
    def step_capture_count(self) -> int:
        """The k-step chunks prepared so far (on the card, CUDA graphs
        captured), as the JAX trainer counts its step compiles."""
        return self._chunks.prepared

    # ------------------------------------------------------------- step
    def _leaves(self):
        return [(l, pn, p) for l, ps in self._trainable.items()
                for pn, p in ps.items() if p is not None]

    def _state_tensors(self):
        """Every tensor a step updates in place: the trainable
        parameters, the optimizer's slots and step counter, the
        loss-scale state and the running state."""
        o = self._opt_state
        out = [p for _, _, p in self._leaves()]
        out += self.optimizer.state_tensors(o)
        out += list(o.get("loss_scale", {}).values())
        out += [v for ks in self.model_state.values() for v in ks.values()]
        return out

    def forward_backward(self, feed, scale: Optional[torch.Tensor] = None):
        """Cost and gradients of one batch, parameters untouched: returns
        (cost tensor, ``{layer: {param: grad}}`` over the trainable
        parameters; zeros for a parameter the cost does not reach, as
        ``jax.grad`` gives).  With ``scale`` (the loss scale, a float32
        tensor) the backward runs on the float32 cost times ``scale`` and
        the gradients come back divided by it; the cost is unscaled.  The
        running state takes the batch's update."""
        loss, tree, _, new_state = self._grads(feed, scale)
        self._commit_state(new_state)
        return loss, tree

    def _grads(self, feed, scale):
        """``forward_backward`` without the state's commit: (loss, grads,
        flag, new running state), the flag under a loss scale a float32
        [1] tensor on the device, nonzero when a gradient is not finite
        (the division by the scale and the test are one multi-tensor
        pass: ``torch.amp``'s unscale)."""
        leaves = self._leaves()
        tensors = [p.detach().requires_grad_(True) for _, _, p in leaves]
        trainable = {l: dict(ps) for l, ps in self._trainable.items()}
        for (l, pn, _), t in zip(leaves, tensors):
            trainable[l][pn] = t
        params = params_mod.merge(trainable, self._frozen)
        outs, new_state = self.topology.forward(
            params, self.model_state, feed, train=True,
            outputs=[self.cost_name], remat=self.remat,
            generator=self._generator, device=self.device)
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
        return loss.detach(), tree, found, new_state

    @torch.no_grad()
    def _commit_state(self, new_state: dict, finite=None) -> None:
        """Write the forward's running state into ``model_state``'s own
        tensors (where ``finite``, when given)."""
        for l, ks in new_state.items():
            for k, v in ks.items():
                dst = self.model_state[l][k]
                if v is not dst:
                    dst.copy_(v if finite is None
                              else torch.where(finite, v, dst))

    def _sync_precision_policy(self):
        """Align the optimizer state with the active policy: attach the
        loss-scale state when the policy scales, drop it when it does
        not; a change of policy drops the prepared chunks, whose graphs
        hold the old policy's kernels."""
        policy = cfg.precision_policy()
        state = self._opt_state
        if policy.loss_scaling and "loss_scale" not in state:
            state["loss_scale"] = policy.init_loss_scale_state(self.device)
        elif not policy.loss_scaling and "loss_scale" in state:
            del state["loss_scale"]
        if self._built_policy_sig != policy.signature():
            self._built_policy_sig = policy.signature()
            self._chunks.clear()
        return policy

    def _step(self, feed):
        """One training step; returns the loss (a device tensor)."""
        return self._run_step(feed)[0]

    def _run_step(self, feed, check: bool = False):
        """One training step: (loss, flags), the flags (``check``) the
        ``check_nan_inf`` test as ``([names], bool tensor)``, else None."""
        policy = self._sync_precision_policy()
        if policy.loss_scaling:
            return self._scaled_step(feed, policy, check)
        loss, grads, _, new_state = self._grads(feed, None)
        flags = self._nan_flags(loss, grads) if check else None
        self._commit_state(new_state)
        self.optimizer.update(self._trainable, grads, self._opt_state,
                              self.parameters.meta)
        return loss, flags

    @torch.no_grad()
    def _scaled_step(self, feed, policy, check=False):
        """One step under dynamic loss scaling (the JAX step's
        ``scaling`` branch), every decision on the device."""
        ls = self._opt_state["loss_scale"]
        scale = ls["scale"]
        with torch.enable_grad():
            loss, grads, found, new_state = self._grads(feed, scale)
        finite = torch.isfinite(loss).all() & (found[0] == 0)
        # under loss scaling a non-finite scaled gradient is the overflow
        # the skip consumes: only the loss counts as a divergence
        flags = self._nan_flags(loss, None) if check else None
        self.optimizer.update(self._trainable, grads, self._opt_state,
                              self.parameters.meta, finite=finite)
        self._commit_state(new_state, finite)
        good = torch.where(finite, ls["good_steps"] + 1, 0)
        grow = good >= policy.growth_interval
        new_scale = torch.where(
            finite,
            torch.where(grow, torch.clamp(scale * policy.growth_factor,
                                          max=policy.max_scale), scale),
            torch.clamp(scale * policy.backoff_factor,
                        min=policy.min_scale))
        skipped = ls["skipped"] + (~finite).to(torch.int32)
        ls["scale"].copy_(new_scale)
        ls["good_steps"].copy_(torch.where(grow & finite, 0, good))
        ls["skipped"].copy_(skipped)
        return loss, flags

    def _nan_flags(self, loss, grads):
        """The finiteness of the loss and, given ``grads``, of every
        ``{layer}.{param}@GRAD``: (names, one bool tensor)."""
        names, tests = ["loss"], [torch.isfinite(loss).all()]
        for l, ps in (grads or {}).items():
            for pn, g in ps.items():
                if g is not None:
                    names.append(f"{l}.{pn}@GRAD")
                    tests.append(torch.isfinite(g).all())
        return names, torch.stack(tests)

    @staticmethod
    def _raise_on_nonfinite(flags, pass_id, batch_id):
        names, ok = flags
        bad = [n for n, good in zip(names, ok.tolist()) if not good]
        if bad:
            raise FloatingPointError(
                f"--check_nan_inf: non-finite values at pass {pass_id} "
                f"batch {batch_id} in: {', '.join(sorted(bad))}")

    # --------------------------------------------------- k steps at once
    @staticmethod
    def _stackable(group) -> bool:
        """True when every feed dict in the group has the same keys and
        per-key shapes and dtypes: the condition for one stacked chunk.
        A ragged group (a short final batch, another bucket) runs per
        step."""
        def sig(v):
            if not hasattr(v, "shape"):
                v = np.asarray(v)
            return tuple(v.shape), str(v.dtype).removeprefix("torch.")

        first = {name: sig(v) for name, v in group[0].items()}
        for feed in group[1:]:
            if feed.keys() != group[0].keys():
                return False
            for name, v in feed.items():
                if sig(v) != first[name]:
                    return False
        return True

    def _stack_group(self, group) -> dict:
        return {name: _stack([f[name] for f in group], self.device)
                for name in group[0]}

    def _chunk(self, feeds: dict, k: int):
        """The prepared chunk of k steps for these stacked feeds."""
        self._sync_precision_policy()
        return self._chunks.get("train_chunk", k, feeds, self._step,
                                self._state_tensors, self._generator)

    def release_chunks(self) -> None:
        """Free every prepared chunk (on the card: the graphs and their
        memory pool)."""
        self._chunks.clear()

    def build_multi_step(self, k: int):
        """k sequential train steps as one dispatch over stacked feeds
        (every array with a leading [k] axis), for timing
        (``timed_multi_dispatch``, ``--job=time``): returns
        ``fn(feeds) -> losses[k]``, not kept in the trainer's chunks and
        not counted.  It runs on the trainer's own state; on the card it
        is prepared (captured) at its first call."""
        entry = None

        def multi(feeds):
            nonlocal entry
            if entry is None:
                self._sync_precision_policy()
                entry = prepared.chunk_entry(self._step, k, feeds,
                                             self._state_tensors(),
                                             self.device,
                                             generator=self._generator)
            return entry(feeds)

        multi.release = lambda: entry is not None and entry.release()
        return multi

    def timed_multi_dispatch(self, feed, k: int, *, iters: int = 5,
                             warmup: int = 2):
        """The measurement of the k-steps-per-dispatch path (shared by
        ``bench.py``-style timing and ``--job=time``): the feed broadcast
        to a leading [k] axis, ``warmup`` dispatches, then ``iters`` timed
        with ONE host read at the end.  Returns (seconds, iters * k).  It
        works on copies of the trainer's state, which it leaves as it
        was."""
        feeds = {name: torch.stack([torch.as_tensor(v, device=self.device)]
                                   * k) for name, v in feed.items()}
        with self.on_copies():
            multi = self.build_multi_step(k)
            try:
                return self._time_dispatches(multi, feeds, k, iters,
                                             warmup)
            finally:
                multi.release()

    @staticmethod
    def _time_dispatches(multi, feeds, k, iters, warmup):
        for _ in range(warmup):
            losses = multi(feeds)
        if warmup and not np.isfinite(float(losses[-1])):
            raise FloatingPointError("warmup loss not finite")
        t0 = time.perf_counter()
        for _ in range(iters):
            losses = multi(feeds)
        last = float(losses[-1])
        dt = time.perf_counter() - t0
        if not np.isfinite(last):
            raise FloatingPointError("timed loss not finite")
        return dt, iters * k

    @contextlib.contextmanager
    def on_copies(self):
        """Run the block on copies of the trainer's state (parameters,
        optimizer state, running state), which is as it was after it."""
        own = (self._trainable, self._opt_state, self.model_state)
        self._trainable, self._opt_state, self.model_state = (
            _clone_tree(t) for t in own)
        try:
            yield
        finally:
            self._trainable, self._opt_state, self.model_state = own

    # ------------------------------------------------------------ train
    def _make_feed_converter(self, feeder, seq_buckets):
        """batch -> feed dict for the train loop.  With ``seq_buckets``
        falsy this is the plain ``feeder.feed``; else the trainer's 2-D
        (rows x seqlen) bucketing: each batch pads its plain sequence
        inputs to the smallest bucket covering the batch's longest
        sequence instead of the declared ``max_len``, so short batches
        stop paying for the padding.  ``True`` / ``"auto"``: powers of two
        >= 8, capped at the declared max_len; a list pins the bucket set,
        and a batch that outgrows every bucket takes the plain path.  One
        prepared chunk per bucket."""
        if not seq_buckets:
            return (lambda b: b if isinstance(b, dict)
                    else feeder.feed(b))
        seq_inputs = []
        for name, idx in feeder.feeding.items():
            attrs = self.topology.get_layer(name).attrs
            if attrs.get("seq_type", 0) == 1:
                seq_inputs.append(
                    (name, idx, int(attrs.get("max_len", 0) or 0)))
        if not seq_inputs:
            raise ValueError(
                "train(seq_buckets=) needs at least one variable-length "
                "(plain sequence) data input; this topology has none")
        declared = [m for _, _, m in seq_inputs if m]
        cap = max(declared) if declared else 0
        if seq_buckets is True or seq_buckets == "auto":
            buckets = None   # powers of two >= 8, capped at max_len
        else:
            buckets = sorted({int(b) for b in seq_buckets})
            if not buckets or buckets[0] < 1:
                raise ValueError(
                    f"seq_buckets must be positive lengths, got "
                    f"{seq_buckets!r}")

        def convert(batch):
            if isinstance(batch, dict):
                return batch   # a built feed: the caller owns the padding
            need = 1
            for _name, idx, _m in seq_inputs:
                for sample in batch:
                    need = max(need, len(sample[idx]))
            if buckets is None:
                pad = 8
                while pad < need:
                    pad *= 2
                if cap:
                    pad = min(pad, cap)
            else:
                cands = [b for b in buckets if b >= need]
                # outgrows every bucket: the plain path (declared
                # max_len) rather than a truncation
                pad = cands[0] if cands else None
            return (feeder.feed(batch, seq_pad=pad) if pad
                    else feeder.feed(batch))

        return convert

    def train(self, reader, num_passes: int = 1,
              event_handler: Optional[Callable] = None,
              feeding: Optional[Dict[str, int]] = None,
              checkpoint_config=None,
              prefetch_depth: Optional[int] = None,
              steps_per_dispatch: Optional[int] = None,
              seq_buckets=None):
        """``reader`` yields batches (lists of sample tuples) per the v2
        ``paddle.batch(...)`` protocol, or feed dicts directly.

        ``prefetch_depth``: a producer thread runs the reader and the feed
        conversion (``seq_buckets`` padding included) and copies up to
        this many batches to the device ahead of the step.

        ``steps_per_dispatch``: k batches drawn at a time; a full group
        of one feed signature runs as one prepared chunk (on the card one
        CUDA graph replay), bit for bit the per-step loop; a short or
        ragged group runs per step.  The group's per-batch events fire
        after the chunk.  ``check_nan_inf`` stands it down to one step
        at a time.

        ``seq_buckets``: ``True`` / ``"auto"`` or a list of lengths, as
        ``_make_feed_converter`` says."""
        _refuse(checkpoint_config=checkpoint_config)
        if event_handler is None:
            event_handler = _default_event_handler
        feeder = DataFeeder(self.topology, feeding)
        convert = self._make_feed_converter(feeder, seq_buckets)
        self._sync_precision_policy()
        if steps_per_dispatch is not None and steps_per_dispatch < 1:
            raise ValueError(
                f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
        k = int(steps_per_dispatch or 1)
        if k > 1 and self.check_nan_inf:
            # the per-step test must not commit the later steps of a chunk
            k = 1
        if prefetch_depth:
            if prefetch_depth < 1:
                raise ValueError(
                    f"prefetch_depth must be >= 1, got {prefetch_depth}")
            from paddle_tpu_torch.reader import prefetch

            def _feed_dicts():
                for data_batch in reader():
                    yield convert(data_batch)

            batch_source = prefetch.prefetch_to_device(
                _feed_dicts, depth=prefetch_depth, device=self.device)
        else:
            batch_source = reader
        for pass_id in range(num_passes):
            event_handler(v2_event.BeginPass(pass_id))
            batch_id = 0
            batch_iter = iter(batch_source())
            try:
                while True:
                    group = []
                    while len(group) < k:
                        try:
                            data_batch = next(batch_iter)
                        except StopIteration:
                            break
                        group.append(convert(data_batch))
                    if not group:
                        break
                    if k > 1 and len(group) == k \
                            and self._stackable(group):
                        feeds = self._stack_group(group)
                        losses = self._chunk(feeds, k)(feeds)
                        for i in range(k):
                            event_handler(v2_event.BeginIteration(
                                pass_id, batch_id))
                            event_handler(v2_event.EndForwardBackward(
                                pass_id, batch_id, self))
                            event_handler(v2_event.EndIteration(
                                pass_id, batch_id, losses[i], {}))
                            batch_id += 1
                        continue
                    for feed in group:
                        event_handler(v2_event.BeginIteration(pass_id,
                                                              batch_id))
                        loss, flags = self._run_step(feed,
                                                     self.check_nan_inf)
                        if flags is not None:
                            self._raise_on_nonfinite(flags, pass_id,
                                                     batch_id)
                        event_handler(v2_event.EndForwardBackward(
                            pass_id, batch_id, self))
                        event_handler(v2_event.EndIteration(
                            pass_id, batch_id, loss, {}))
                        batch_id += 1
            finally:
                # ends a prefetch producer on every way out of the pass
                close = getattr(batch_iter, "close", None)
                if close is not None:
                    close()
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
