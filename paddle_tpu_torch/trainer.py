"""Trainer: the v2-style event-loop trainer (counterpart of
``paddle_tpu/trainer.py``).

The step mirrors the JAX package's ``_build_step``: ``Topology.forward``
under autograd, the gradient of the cost with respect to every trainable
parameter (``torch.autograd.grad``), then ``optimizer.update``.  A
``sparse_update`` embedding table (``Topology.sparse_embeddings``) stays
out of the dense gradients: its lookups get a zero probe shaped
``[ids in the feed, dim]``, the gradient comes out on the probe, one row
per lookup, and the optimizer updates the touched rows only
(``sparse_grads``; SelectedRows), so no [V, D] gradient is made.  The
declared evaluators' statistics come out of every step, on the device,
and add up over the pass: ``EndPass.metrics`` and ``TestResult.metrics``
hold their results.  Every tensor a step changes is changed in
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
finiteness (the probes' gradients, unscaled, among them).  A non-finite
step keeps the parameters, the optimizer slots,
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
- ``SGD(check_nan_inf=True)`` tests the loss and every gradient, a
  sparse table's rows too (only the loss under loss scaling), at every
  step, one host read a step, and raises ``FloatingPointError`` naming
  them; it runs the chunks per step;
- ``SGD(remat=True | "blocks")`` recomputes layers in the backward
  (``Topology.forward``).

Checkpoints (``train(checkpoint_config=)``, ``io/checkpoint.py``) are
the JAX package's: at its start ``train`` resumes from the newest
snapshot under ``dirname`` that verifies (falling back past corrupt ones
with a warning, or starting fresh when none verifies); a step snapshot
resumes mid-pass, the reader replayed up to its ``batches_done``, bit for
bit the uninterrupted run.  Step snapshots come every
``save_period_steps`` global steps (at a chunk's edge where the period's
boundary falls inside it), pass snapshots every ``saving_period`` passes,
after which the step snapshots go.  ``restore`` copies a snapshot INTO
the live tensors, so a captured chunk's graph replays from the restored
state, and sets the trainer's generator (a snapshot of its own device
type) in place, so the graphs that registered it draw on from there.  A
step snapshot on the hot path is one stream-ordered copy of the state a
dtype (``_snapshot_copy``) and, on the card, a copy to pinned host
memory on a side stream; the writer thread waits for that copy's event
and writes, so the step loop neither syncs nor waits on the disk.

Telemetry (``observability/``, on with ``PADDLE_TPU_TELEMETRY=1`` or
``observability.enable()``) is the JAX trainer's catalog: the
``trainer_feed_us``, ``trainer_step_dispatch_us``, ``trainer_eval_us`` and
``trainer_pass_us`` histograms, ``trainer_batches_total``,
``trainer_passes_total``, ``trainer_padding_waste_pct`` under
``seq_buckets``, ``train_loss_scale`` and ``train_skipped_steps_total``
under loss scaling, the checkpoint hand-off histogram and
``trainer_checkpoint_restore_fallbacks_total``, and the
``trainer/feed|step|eval|pass`` spans, ``trainer/step`` naming its
executable (``exe=``); under ``steps_per_dispatch=k`` one span covers
the chunk.  Each step's feed signature is a row of the executable
registry (``trainer`` / ``v2_train_step``, a chunk's ``train_chunk``),
its dispatches timed by CUDA event pairs.  The step loop adds no device
sync: the loss scale's values come back on a copy read once its event
has run.  Off, each site costs one flag test.

Not ported yet, and refused: ``mesh`` and ``mesh_rules`` (``ROADMAP.md``
section 1, item 14, with the vocab-parallel lookup of a sparse table).
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from paddle_tpu_torch import event as v2_event
from paddle_tpu_torch import parameters as params_mod
from paddle_tpu_torch.core import config as cfg
from paddle_tpu_torch.core import prepared
from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch.observability import executables as _executables
from paddle_tpu_torch.observability import metrics as _metrics
from paddle_tpu_torch.observability import tracing as _tracing
from paddle_tpu_torch.topology import Topology
from paddle_tpu_torch.utils import profiler as _profiler

# The JAX trainer's telemetry handles, pre-bound at import; every
# mutator is a flag test while telemetry is off.
_H_TR_FEED = _metrics.histogram(
    "trainer_feed_us", "batch -> feed-dict conversion (DataFeeder)")
_H_TR_STEP = _metrics.histogram(
    "trainer_step_dispatch_us",
    "train-step dispatch (async; excludes device wait)")
_H_TR_EVAL = _metrics.histogram(
    "trainer_eval_us", "evaluator stat accumulation")
_H_TR_PASS = _metrics.histogram(
    "trainer_pass_us", "whole-pass wall time")
_M_TR_BATCHES = _metrics.counter(
    "trainer_batches_total", "train batches dispatched")
_M_TR_PASSES = _metrics.counter(
    "trainer_passes_total", "completed training passes")
_H_CKPT_HANDOFF = _metrics.histogram(
    "trainer_checkpoint_save_us",
    "step-snapshot cost split by phase: hot-path hand-off vs the "
    "background device_get + fsync'd write", phase="handoff")
_M_CKPT_FALLBACK = _metrics.counter(
    "trainer_checkpoint_restore_fallbacks_total",
    "auto-resume restores that skipped past a corrupt newest snapshot "
    "to an older valid one")
_G_LOSS_SCALE = _metrics.gauge(
    "train_loss_scale",
    "current dynamic loss scale (mixed-precision policy)")
_M_SKIPPED_STEPS = _metrics.counter(
    "train_skipped_steps_total",
    "optimizer updates skipped on non-finite gradients (loss scaling "
    "halved and retried next step)")
_H_TR_PAD = _metrics.histogram(
    "trainer_padding_waste_pct",
    "per-batch padded-but-dead cell percentage on sequence inputs "
    "under train(seq_buckets=) 2-D bucketing",
    buckets=(0, 1, 2, 5, 10, 15, 20, 30, 40, 50, 75, 100))
_ns = time.perf_counter_ns


class _ScaleReads:
    """The loss-scale metrics read off the device without a sync: each
    step queues a copy of (scale, skipped) to pinned host memory and an
    event; a copy is read once its event has run (at a later step).  On
    the CPU the values are read at once."""

    def __init__(self):
        self._pending = []
        self._skipped = None

    def push(self, ls: dict) -> None:
        vals = (ls["scale"], ls["skipped"])
        if vals[0].device.type != "cuda":
            self._apply([float(v) for v in vals])
            return
        host = [torch.empty((), dtype=v.dtype, pin_memory=True)
                for v in vals]
        for h, v in zip(host, vals):
            h.copy_(v, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._pending.append((ev, host))
        self.poll()

    def poll(self) -> None:
        while self._pending and self._pending[0][0].query():
            _, host = self._pending.pop(0)
            self._apply([float(h) for h in host])

    def _apply(self, vals) -> None:
        scale, skipped = vals
        _G_LOSS_SCALE.set(scale)
        if self._skipped is not None and skipped > self._skipped:
            _M_SKIPPED_STEPS.inc(int(skipped - self._skipped))
        self._skipped = skipped


def _refuse(item: int, **flags) -> None:
    for name, value in flags.items():
        if value:
            raise NotImplementedError(
                f"{name} is not ported to paddle_tpu_torch yet "
                f"(ROADMAP.md section 1, item {item})")


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _tensor_leaves(tree, path=()):
    """(path, tensor) of every tensor leaf of a nested dict, in order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tensor_leaves(v, path + (k,))
        elif isinstance(v, torch.Tensor):
            yield path + (k,), v


@torch.no_grad()
def _copy_into(live: dict, loaded: dict, where: str) -> None:
    """Copy ``loaded``'s arrays into ``live``'s tensors in place, leaf by
    leaf; a leaf the snapshot lacks keeps its value."""
    for path, t in _tensor_leaves(live):
        node = loaded
        for k in path:
            node = node.get(k) if isinstance(node, dict) else None
        if node is None:
            continue
        src = torch.as_tensor(np.asarray(node))
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(
                f"checkpoint {where} {'::'.join(map(str, path))}: shape "
                f"{tuple(src.shape)}, the trainer's is {tuple(t.shape)}")
        t.copy_(src)


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
        _refuse(14, mesh=mesh, mesh_rules=mesh_rules)
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
        # SelectedRows tables: updated by their touched rows only
        self._sparse = self.topology.sparse_embeddings()
        for lname, _src, _dim in self._sparse:
            if self._trainable.get(lname, {}).get("w") is None:
                raise ValueError(
                    f"embedding layer {lname!r} has sparse_update=True but "
                    f"its table is not trainable (is_static / learning_rate"
                    f"=0 param attr?) — sparse updates only apply to "
                    f"trainable tables; drop sparse_update or unfreeze it")
        self._sparse_keys = {(lname, "w") for lname, _, _ in self._sparse}
        # the layers the evaluators read, beside the cost
        self._eval_outputs = []
        for ev in self.topology.evaluators:
            for lo in ev.layers.values():
                if (lo.name != self.cost_name
                        and lo.name not in self._eval_outputs):
                    self._eval_outputs.append(lo.name)
        # gradient_printer's layers: their output cotangents come back as
        # "<layer>@grad" beside the evaluators' outputs
        self._grad_layers = sorted({n for ev in self.topology.evaluators
                                    for n in getattr(ev, "grad_layers", [])})
        self._opt_state = self.optimizer.init_state(self._trainable)
        # the forward's random stream (dropout, NCE), on the trainer's
        # device; a captured chunk registers it with its graph
        self._generator = torch.Generator(device=self.device).manual_seed(
            int(cfg.get_option("seed", 0)) + 17)
        # the prepared k-step chunks (train(steps_per_dispatch=k)), each a
        # row of the executable registry
        self._chunks = prepared.PreparedFamily(self.device, stack="trainer")
        # the eager step's registry rows, by feed signature (telemetry)
        self._step_exes: dict = {}
        self._scale_reads = _ScaleReads()
        # checkpoints: the monotonic step counter the snapshots are named
        # by, the background writer, and (on the card) the pinned host
        # buffers of the step snapshots in flight and free
        self._global_step = 0
        self._ckpt_writer = None
        self._ckpt_stream = None
        self._pinned_free = []
        self._built_policy_sig = None
        self._sync_precision_policy()

    @property
    def step_capture_count(self) -> int:
        """The k-step chunks prepared so far (on the card, CUDA graphs
        captured), as the JAX trainer counts its step compiles."""
        return self._chunks.prepared

    # ------------------------------------------------------------- step
    def _leaves(self):
        """The trainable parameters of the dense gradient (no sparse
        table)."""
        return [(l, pn, p) for l, ps in self._trainable.items()
                for pn, p in ps.items()
                if p is not None and (l, pn) not in self._sparse_keys]

    def _state_tensors(self):
        """Every tensor a step updates in place: the trainable
        parameters, the optimizer's slots and step counter, the
        loss-scale state and the running state."""
        o = self._opt_state
        out = [p for ps in self._trainable.values() for p in ps.values()
               if p is not None]
        out += self.optimizer.state_tensors(o)
        out += list(o.get("loss_scale", {}).values())
        out += [v for ks in self.model_state.values() for v in ks.values()]
        return out

    def forward_backward(self, feed, scale: Optional[torch.Tensor] = None):
        """Cost and gradients of one batch, parameters untouched: returns
        (cost tensor, ``{layer: {param: grad}}`` over the trainable
        parameters; zeros for a parameter the cost does not reach, as
        ``jax.grad`` gives; for a ``sparse_update`` table its SelectedRows
        gradient, the pair (ids, one gradient row per id)).  With
        ``scale`` (the loss scale, a float32 tensor) the backward runs on
        the float32 cost times ``scale`` and the gradients come back
        divided by it; the cost is unscaled.  The running state takes the
        batch's update."""
        g = self._grads(feed, scale)
        self._commit_state(g.new_state)
        tree = {l: dict(ps) for l, ps in g.grads.items()}
        for (l, pn), pair in g.sparse.items():
            tree[l][pn] = pair
        return g.loss, tree

    def _grads(self, feed, scale):
        """``forward_backward`` without the state's commit: a ``_Grads``
        (loss, dense gradients with None for the sparse tables, the
        sparse tables' ``{(layer, "w"): (ids, rows)}``, the evaluators'
        outputs, the new running state and, under a loss scale, a float32
        [1] flag on the device, nonzero when a gradient is not finite; the
        division by the scale and the test are one multi-tensor pass,
        ``torch.amp``'s unscale)."""
        leaves = self._leaves()
        tensors = [p.detach().requires_grad_(True) for _, _, p in leaves]
        trainable = {l: dict(ps) for l, ps in self._trainable.items()}
        for (l, pn, _), t in zip(leaves, tensors):
            trainable[l][pn] = t
        params = params_mod.merge(trainable, self._frozen)
        feed = dict(feed)
        ids, probes = {}, {}
        for lname, src, dim in self._sparse:
            if src not in ids:
                ids[src] = feed[src] = torch.as_tensor(feed[src],
                                                       device=self.device)
            # flat [lookups, D]: the layer reshapes it to its rows' view
            probes[lname] = torch.zeros(
                (ids[src].numel(), dim), device=self.device,
                dtype=self._trainable[lname]["w"].dtype, requires_grad=True)
        gprobes = dict.fromkeys(self._grad_layers)
        outs, new_state = self.topology.forward(
            params, self.model_state, feed, train=True,
            outputs=[self.cost_name] + self._eval_outputs, remat=self.remat,
            generator=self._generator, device=self.device,
            sparse_probes=probes, grad_probes=gprobes)
        loss = outs[self.cost_name]
        # scaled after the float32 cost, so the backward carries the
        # scaled cotangent through the whole bf16 stack
        obj = loss if scale is None else loss.float() * scale
        outs = {k: v.detach() for k, v in outs.items()}
        for n, p in gprobes.items():
            if p is None:       # an index input: zeros, as the JAX package
                outs[n + "@grad"] = torch.zeros(outs[n].shape,
                                                device=self.device)
        gprobes = {n: p for n, p in gprobes.items() if p is not None}
        grads = list(torch.autograd.grad(obj, tensors + list(
            probes.values()) + list(gprobes.values()), allow_unused=True))
        for n, g in zip(gprobes, grads[len(grads) - len(gprobes):]):
            g = torch.zeros_like(gprobes[n]) if g is None else g
            outs[n + "@grad"] = g if scale is None else g / scale
        grads = grads[:len(grads) - len(gprobes)]
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
        sparse = {}
        for (lname, src, _), g in zip(self._sparse, grads[len(leaves):]):
            sparse[(lname, "w")] = (
                ids[src], torch.zeros_like(probes[lname]) if g is None
                else g)
        return _Grads(loss.detach(), tree, sparse, found, new_state,
                      outs, feed)

    def _eval_stats(self, outs, feed) -> dict:
        """The evaluators' statistics of one batch, on the device."""
        return {ev.name: ev.stats(outs, feed)
                for ev in self.topology.evaluators}

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

    def _step_stats(self, feed):
        """One training step: (loss, the evaluators' statistics), both on
        the device (the train loop's chunk step)."""
        loss, _, stats = self._run_step(feed)
        return loss, stats

    def _run_step(self, feed, check: bool = False):
        """One training step: (loss, flags, evaluator statistics), the
        flags (``check``) the ``check_nan_inf`` test as ``([names], bool
        tensor)``, else None."""
        policy = self._sync_precision_policy()
        if policy.loss_scaling:
            return self._scaled_step(feed, policy, check)
        g = self._grads(feed, None)
        flags = self._nan_flags(g.loss, g.grads, g.sparse) if check else None
        self._commit_state(g.new_state)
        self.optimizer.update(self._trainable, g.grads, self._opt_state,
                              self.parameters.meta, sparse_grads=g.sparse)
        return g.loss, flags, self._eval_stats(g.outs, g.feed)

    @torch.no_grad()
    def _scaled_step(self, feed, policy, check=False):
        """One step under dynamic loss scaling (the JAX step's
        ``scaling`` branch), every decision on the device."""
        ls = self._opt_state["loss_scale"]
        scale = ls["scale"]
        with torch.enable_grad():
            g = self._grads(feed, scale)
        loss = g.loss
        finite = torch.isfinite(loss).all() & (g.found[0] == 0)
        # under loss scaling a non-finite scaled gradient is the overflow
        # the skip consumes: only the loss counts as a divergence
        flags = self._nan_flags(loss, None) if check else None
        self.optimizer.update(self._trainable, g.grads, self._opt_state,
                              self.parameters.meta, sparse_grads=g.sparse,
                              finite=finite)
        self._commit_state(g.new_state, finite)
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
        return loss, flags, self._eval_stats(g.outs, g.feed)

    def _nan_flags(self, loss, grads, sparse=None):
        """The finiteness of the loss and, given ``grads``, of every
        ``{layer}.{param}@GRAD`` (a sparse table's: its rows): (names, one
        bool tensor)."""
        names, tests = ["loss"], [torch.isfinite(loss).all()]
        for l, ps in (grads or {}).items():
            for pn, g in ps.items():
                if g is not None:
                    names.append(f"{l}.{pn}@GRAD")
                    tests.append(torch.isfinite(g).all())
        for (l, pn), (_ids, rows) in (sparse or {}).items():
            names.append(f"{l}.{pn}@GRAD")
            tests.append(torch.isfinite(rows).all())
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

    def _identity(self) -> tuple:
        """The program's identity parts of its registry fingerprints: the
        topology's JSON, the precision policy and the optimizer."""
        return (self.topology.proto(), self._built_policy_sig,
                type(self.optimizer).__name__)

    def _chunk(self, feeds: dict, k: int):
        """The prepared chunk of k steps for these stacked feeds: it
        returns the k losses, and with evaluators ``(losses, their k
        statistics)``."""
        self._sync_precision_policy()
        step = self._step_stats if self.topology.evaluators else self._step
        return self._chunks.get("train_chunk", k, feeds, step,
                                self._state_tensors, self._generator,
                                identity=self._identity())

    def _observed_step(self, feed, check: bool):
        """``_run_step`` as one dispatch of its feed signature's registry
        row (telemetry on): the first step of a signature is its build,
        counted for the row's cost; each step is timed by an event pair.
        Returns (step result, the row)."""
        self._sync_precision_policy()
        sig = prepared.feed_signature(feed)
        return _executables.observe(
            self._step_exes, (self._built_policy_sig, sig), self.device,
            lambda: self._run_step(feed, check),
            lambda: _executables.register(
                stack="trainer", kind="v2_train_step",
                fingerprint=_executables.fingerprint(
                    *self._identity(), "v2_train_step", sig),
                feed_sig=sig))

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

    # ------------------------------------------------------- checkpoints
    def _snapshot_leaves(self) -> list:
        """(tree, path, tensor) of every tensor a step snapshot copies:
        the trainable parameters, the optimizer state and the running
        state (the frozen partition never changes while training)."""
        return [(name, path, t) for name, tree in (
            ("trainable", self._trainable), ("opt_state", self._opt_state),
            ("model_state", self.model_state))
            for path, t in _tensor_leaves(tree)]

    def _pinned(self, sizes: dict) -> dict:
        """A free set of pinned host buffers ``{dtype: [n]}`` of these
        sizes (one is allocated when none is free)."""
        while self._pinned_free:
            bufs = self._pinned_free.pop()
            if {dt: b.numel() for dt, b in bufs.items()} == sizes:
                return bufs
        return {dt: torch.empty(n, dtype=dt, pin_memory=True)
                for dt, n in sizes.items()}

    @torch.no_grad()
    def _snapshot_copy(self) -> "_StateCopy":
        """The live state as it stands at this point of the stream, one
        concatenated copy a dtype (the JAX trainer's one-dispatch device
        copy): on the card the next step, which updates the state in
        place, is ordered after it, and a side stream copies it to pinned
        host memory behind an event, so the hot path neither syncs nor
        copies through pageable memory.  The generator's state is read
        here too: after a chunk's replays, the offset the next one uses."""
        leaves = self._snapshot_leaves()
        order: dict = {}
        for i, (_, _, t) in enumerate(leaves):
            order.setdefault(t.dtype, []).append(i)
        staged = {dt: torch.cat([leaves[i][2].reshape(-1) for i in idx])
                  for dt, idx in order.items()}
        rng = self._generator.get_state()
        done = None
        if self.device.type == "cuda":
            host = self._pinned({dt: b.numel() for dt, b in staged.items()})
            if self._ckpt_stream is None:
                self._ckpt_stream = torch.cuda.Stream(self.device)
            side = self._ckpt_stream
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                for dt, buf in staged.items():
                    buf.record_stream(side)
                    host[dt].copy_(buf, non_blocking=True)
                done = torch.cuda.Event()
                done.record(side)
        else:
            host = staged
        return _StateCopy(leaves, order, host, done, rng,
                          self._pinned_free if done is not None else None)

    def _rng_extra(self, rng: torch.Tensor) -> dict:
        return {"torch_rng": {"device": self.device.type,
                              "state": rng.tolist()}}

    def _save_step_snapshot(self, ckpt_cfg, pass_id: int,
                            batches_done: int) -> float:
        """The hot-path half of a step snapshot: the stream-ordered copy
        and the hand-off to the writer (inline when ``async_save`` is
        off).  Returns the host seconds it took."""
        from paddle_tpu_torch.io import checkpoint as ckpt
        t0 = time.perf_counter()
        t0_ns = _ns()
        copy = self._snapshot_copy()
        frozen = self._frozen
        gstep = self._global_step
        dirname, keep = ckpt_cfg.dirname, ckpt_cfg.keep_step_snapshots
        extra = self._rng_extra(copy.rng)

        def job():
            try:
                flat = copy.payloads()
                ckpt.save_step(dirname, gstep, pass_id=pass_id,
                               batches_done=batches_done,
                               trainable=flat.get("trainable", {}),
                               opt_state=flat.get("opt_state", {}),
                               model_state=flat.get("model_state", {}),
                               frozen=frozen, extra=extra)
            finally:
                copy.release()
            ckpt.prune_steps(dirname, keep)

        if ckpt_cfg.async_save:
            if self._ckpt_writer is None:
                # its idle loop is the scrubber when reverify_period_s
                # is set
                self._ckpt_writer = ckpt.AsyncCheckpointWriter(
                    reverify_period_s=ckpt_cfg.reverify_period_s,
                    reverify_dir=dirname)
            self._ckpt_writer.submit(job)
        else:
            job()
        _H_CKPT_HANDOFF.observe((_ns() - t0_ns) / 1e3)
        return time.perf_counter() - t0

    def _flush_ckpt_writer(self) -> None:
        if self._ckpt_writer is not None:
            for e in self._ckpt_writer.flush():
                warnings.warn(f"async checkpoint save failed: {e!r}",
                              RuntimeWarning)

    def _save_pass_snapshot(self, ckpt_cfg, pass_id: int) -> None:
        """The pass-end snapshot, after the writer drained (so it and the
        step snapshots' prune cannot interleave); it supersedes every
        step snapshot."""
        from paddle_tpu_torch.io import checkpoint as ckpt
        self._flush_ckpt_writer()
        ckpt.save(ckpt_cfg.dirname, pass_id, trainable=self._trainable,
                  opt_state=self._opt_state, model_state=self.model_state,
                  frozen=self._frozen,
                  extra={**self._rng_extra(self._generator.get_state()),
                         "global_step": self._global_step})
        ckpt.prune_steps(ckpt_cfg.dirname, keep=0)
        if ckpt_cfg.save_only_one:
            ckpt.prune_old(ckpt_cfg.dirname, pass_id)

    def _auto_resume(self, ckpt_cfg) -> tuple:
        """Restore the newest snapshot under ``ckpt_cfg.dirname`` that
        verifies; returns (first pass, batches of it already done)."""
        from paddle_tpu_torch.io import checkpoint as ckpt
        try:
            snap = ckpt.load(ckpt_cfg.dirname)
        except FileNotFoundError:
            return 0, 0
        except ckpt.CheckpointCorrupt as e:
            # every snapshot failed and was quarantined: a fresh start
            # beats a crash loop
            warnings.warn(f"auto-resume found no valid checkpoint: {e}",
                          RuntimeWarning)
            return 0, 0
        if snap["fallbacks"]:
            _M_CKPT_FALLBACK.inc(snap["fallbacks"])
            warnings.warn(f"auto-resume fell back past {snap['fallbacks']} "
                          f"corrupt snapshot(s) to {snap['kind']} "
                          f"pass={snap['pass_id']}", RuntimeWarning)
        self.restore(snap)
        if snap["kind"] == "step":
            man = snap["manifest"]
            return (int(man.get("pass_id", snap["pass_id"])),
                    int(man.get("batches_done", 0)))
        return snap["pass_id"] + 1, 0

    @torch.no_grad()
    def restore(self, snap: dict) -> None:
        """Adopt a checkpoint snapshot (``io.checkpoint.load``'s result,
        the JAX package's too): its values are copied into the live
        parameters, optimizer state (what the policy carries of it),
        running state and frozen parameters, so every captured chunk
        replays from them; a snapshot saved under the other
        ``fuse_conv_bn`` setting raises.  The port's generator state
        (``torch_rng``, of this device type) is set in place; a snapshot
        without it (the JAX package's) leaves the generator as it is.
        ``global_step`` is taken over."""
        self._sync_precision_policy()
        params_mod.check_fuse_conv_bn_mismatch(
            set(self._trainable) | set(self._frozen) | set(self.model_state),
            params_mod.tree_keys(snap["trainable"], snap.get("frozen"),
                                 snap.get("model_state")))
        _copy_into(self._trainable, snap["trainable"], "params")
        _copy_into(self._opt_state, snap.get("opt_state") or {},
                   "opt_state")
        _copy_into(self.model_state, snap.get("model_state") or {},
                   "model_state")
        _copy_into(self._frozen, snap.get("frozen") or {}, "frozen")
        man = snap.get("manifest") or {}
        rng = man.get("torch_rng")
        if rng and rng.get("device") == self.device.type:
            self._generator.set_state(torch.tensor(rng["state"],
                                                   dtype=torch.uint8))
        if man.get("global_step") is not None:
            self._global_step = int(man["global_step"])
        self._sync_parameters()

    def save_parameter_to_tar(self, f) -> None:
        """Write the live parameters as a tar.  Given a path the write is
        atomic (tmp, fsync, rename: ``io/atomic.py``); a file object is
        written directly (its owner keeps it durable)."""
        self._sync_parameters()
        if isinstance(f, (str, os.PathLike)):
            from paddle_tpu_torch.io import atomic
            atomic.atomic_write_file(f, self.parameters.to_tar)
        else:
            self.parameters.to_tar(f)

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
            feed = (feeder.feed(batch, seq_pad=pad) if pad
                    else feeder.feed(batch))
            if _metrics._enabled:
                real = total = 0
                for name, _idx, _m in seq_inputs:
                    lens, arr = feed.get(name + "@len"), feed.get(name)
                    if lens is None or arr is None:
                        continue
                    real += int(np.asarray(lens).sum())
                    total += int(arr.shape[0]) * int(arr.shape[1])
                if total:
                    _H_TR_PAD.observe(100.0 * (1.0 - real / total))
            return feed

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
        ``_make_feed_converter`` says.

        ``checkpoint_config`` (``io.checkpoint.CheckpointConfig``):
        auto-resume from its ``dirname`` and snapshots into it, as the
        module docstring says."""
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
        start_pass, skip_batches, every = 0, 0, None
        if checkpoint_config is not None:
            every = checkpoint_config.save_period_steps
            start_pass, skip_batches = self._auto_resume(checkpoint_config)
            if every and self.device.type == "cuda" \
                    and not self._pinned_free:
                # two copies off the step path: they make the pinned
                # buffers, the device memory and the side stream of two
                # snapshots in flight
                for copy in [self._snapshot_copy() for _ in range(2)]:
                    copy.payloads()
                    copy.release()
        from paddle_tpu_torch.evaluator import EvalAccumulator
        acc = EvalAccumulator(self.topology.evaluators)
        for pass_id in range(start_pass, num_passes):
            event_handler(v2_event.BeginPass(pass_id))
            acc.reset()
            batch_id = 0
            obs = _metrics._enabled
            tp0 = _ns() if obs else 0
            batch_iter = iter(batch_source())
            if pass_id == start_pass and skip_batches:
                # mid-pass resume: replay the reader to the snapshot's
                # position (drawn and dropped, no step)
                for _ in range(skip_batches):
                    if next(batch_iter, None) is None:
                        break
                batch_id = skip_batches
            try:
                while True:
                    gstep = self._global_step
                    tf0 = _ns() if obs else 0
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
                        if obs:
                            tf1 = _ns()
                            _H_TR_FEED.observe((tf1 - tf0) / 1e3)
                            _tracing.TRACER.add("trainer/feed", tf0,
                                                tf1 - tf0, step=gstep)
                        chunk = self._chunk(feeds, k)
                        ts0 = _ns() if obs else 0
                        with _profiler.range_scope("trainer/step"):
                            out = chunk(feeds)
                        losses, stats_k = (out if isinstance(out, tuple)
                                           else (out, {}))
                        if obs:
                            self._observe_step(ts0, gstep, chunk.exe, k)
                        for i in range(k):
                            event_handler(v2_event.BeginIteration(
                                pass_id, batch_id))
                            te0 = _ns() if obs else 0
                            acc.update({n: tuple(s[i] for s in st)
                                        for n, st in stats_k.items()})
                            if obs and acc.evaluators:
                                self._observe_eval(te0, self._global_step)
                            event_handler(v2_event.EndForwardBackward(
                                pass_id, batch_id, self))
                            event_handler(v2_event.EndIteration(
                                pass_id, batch_id, losses[i], {}))
                            batch_id += 1
                            self._global_step += 1
                        if every and (gstep // every
                                      != self._global_step // every):
                            # the period's boundary fell inside the chunk:
                            # the state exists only at its edges
                            self._save_step_snapshot(checkpoint_config,
                                                     pass_id, batch_id)
                        continue
                    first = True
                    for feed in group:
                        gstep = self._global_step
                        if obs and first:
                            tf1 = _ns()
                            _H_TR_FEED.observe((tf1 - tf0) / 1e3)
                            _tracing.TRACER.add("trainer/feed", tf0,
                                                tf1 - tf0, step=gstep)
                        first = False
                        event_handler(v2_event.BeginIteration(pass_id,
                                                              batch_id))
                        with _profiler.range_scope("trainer/step"):
                            if obs:
                                ts0 = _ns()
                                (loss, flags, stats), ent = \
                                    self._observed_step(
                                        feed, self.check_nan_inf)
                                self._observe_step(ts0, gstep, ent, 1)
                            else:
                                loss, flags, stats = self._run_step(
                                    feed, self.check_nan_inf)
                        if flags is not None:
                            self._raise_on_nonfinite(flags, pass_id,
                                                     batch_id)
                        te0 = _ns() if obs else 0
                        acc.update(stats)
                        if obs and acc.evaluators:
                            self._observe_eval(te0, gstep)
                        event_handler(v2_event.EndForwardBackward(
                            pass_id, batch_id, self))
                        event_handler(v2_event.EndIteration(
                            pass_id, batch_id, loss, {}))
                        batch_id += 1
                        self._global_step += 1
                        if every and self._global_step % every == 0:
                            self._save_step_snapshot(checkpoint_config,
                                                     pass_id, batch_id)
            finally:
                # ends a prefetch producer on every way out of the pass
                close = getattr(batch_iter, "close", None)
                if close is not None:
                    close()
            self._sync_parameters()
            if (checkpoint_config is not None
                    and pass_id % checkpoint_config.saving_period == 0):
                self._save_pass_snapshot(checkpoint_config, pass_id)
            if obs:
                tp1 = _ns()
                _H_TR_PASS.observe((tp1 - tp0) / 1e3)
                # the pass id rides in args["pass"], not args["step"]
                # (the per-batch correlation ids)
                _tracing.TRACER.add("trainer/pass", tp0, tp1 - tp0,
                                    cat="pass", args={"pass": pass_id})
                _M_TR_PASSES.inc()
            event_handler(v2_event.EndPass(pass_id, metrics=acc.results()))
        # every snapshot promised is on disk when train returns; after an
        # error the daemon writer finishes its job (or the process dies:
        # the atomic publish makes either safe)
        self._flush_ckpt_writer()

    def _observe_step(self, ts0: int, gstep: int, ent, k: int) -> None:
        """The step dispatch's telemetry: its histogram, the
        ``trainer/step`` span naming its executable (one span a chunk),
        the batch counter and the loss scale's queued read."""
        ts1 = _ns()
        _H_TR_STEP.observe((ts1 - ts0) / 1e3)
        args = {"exe": ent.short} if ent is not None else None
        if k > 1:
            args = dict(args or {}, steps_per_dispatch=k)
        _tracing.TRACER.add("trainer/step", ts0, ts1 - ts0, step=gstep,
                            args=args)
        _M_TR_BATCHES.inc(k)
        ls = self._opt_state.get("loss_scale")
        if ls is not None:
            self._scale_reads.push(ls)

    @staticmethod
    def _observe_eval(te0: int, gstep: int) -> None:
        te1 = _ns()
        _H_TR_EVAL.observe((te1 - te0) / 1e3)
        _tracing.TRACER.add("trainer/eval", te0, te1 - te0, step=gstep)

    @torch.no_grad()
    def test(self, reader, feeding: Optional[Dict[str, int]] = None):
        """average cost over a reader (reference: Tester / trainer.test),
        with the evaluators' metrics."""
        from paddle_tpu_torch.evaluator import EvalAccumulator
        feeder = DataFeeder(self.topology, feeding)
        params = params_mod.merge(self._trainable, self._frozen)
        acc = EvalAccumulator(self.topology.evaluators)
        total, n = 0.0, 0
        for data_batch in reader():
            feed = (data_batch if isinstance(data_batch, dict)
                    else feeder.feed(data_batch))
            outs, _ = self.topology.forward(
                params, self.model_state, feed, train=False,
                outputs=[self.cost_name] + self._eval_outputs,
                device=self.device)
            total += float(outs[self.cost_name])
            acc.update(self._eval_stats(outs, feed))
            n += 1
        return v2_event.TestResult(total / max(n, 1), metrics=acc.results())

    def _sync_parameters(self) -> None:
        """Reflect the trained tree back into the Parameters object."""
        self.parameters.values = params_mod.merge(self._trainable,
                                                  self._frozen)


class _StateCopy:
    """A step snapshot's copy of the trainer's state (``_snapshot_copy``):
    ``payloads()`` waits for its copy to land and returns ``{tree: {"a::b":
    host array}}``, the payloads' keys as ``io/checkpoint.py`` writes them;
    ``release()`` hands its pinned buffers back to the trainer's pool."""

    def __init__(self, leaves, order, host, done, rng, pool):
        from paddle_tpu_torch.io.checkpoint import _SEP
        self.meta = [(name, _SEP.join(path), tuple(t.shape))
                     for name, path, t in leaves]
        self.order, self.host, self.done = order, host, done
        self.rng, self.pool = rng, pool

    def payloads(self) -> dict:
        if self.done is not None:
            self.done.synchronize()
        out: dict = {}
        for dt, idx in self.order.items():
            flat, off = self.host[dt].numpy(), 0
            for i in idx:
                name, key, shape = self.meta[i]
                n = int(np.prod(shape))
                out.setdefault(name, {})[key] = flat[off:off + n].reshape(
                    shape)
                off += n
        return out

    def release(self) -> None:
        if self.pool is not None:
            self.pool.append(self.host)
        self.pool = self.host = None


class _Grads:
    """What ``SGD._grads`` gives of one batch's forward and backward."""

    __slots__ = ("loss", "grads", "sparse", "found", "new_state", "outs",
                 "feed")

    def __init__(self, loss, grads, sparse, found, new_state, outs, feed):
        self.loss, self.grads, self.sparse = loss, grads, sparse
        self.found, self.new_state = found, new_state
        self.outs, self.feed = outs, feed


def _default_event_handler(evt) -> None:
    period = cfg.get_option("log_period", 100)
    if isinstance(evt, v2_event.EndIteration):
        if evt.batch_id % period == 0:
            print(f"Pass {evt.pass_id}, Batch {evt.batch_id}, "
                  f"Cost {evt.cost:.6f}")
