"""Topology: a layer graph run as one eager PyTorch forward (counterpart of
``paddle_tpu/topology.py``).

The JAX package traces every layer's ``apply()`` into one jaxpr that XLA
compiles; here ``forward`` runs the same per-layer steps eagerly, under
autograd, so the trainer's backward is ``torch.autograd.grad`` over the
cost.  Shape inference, parameter specs, the JSON IR (``proto()``),
sequence masks from ``<name>@len`` feeds and the fold of plain layers over
sequence inputs are the JAX package's, and so is rematerialisation
(``forward(remat=True | "blocks")``): the layers it may recompute, by the
JAX package's eligibility sets, run under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, so the
backward recomputes their activations from their inputs instead of
keeping them.

Layers that draw random numbers (dropout, NCE) draw them from the
``generator`` given to ``forward``, which must lie on the forward's
device; the trainer passes its own.

A sparse (ids + values) data layer is fed as ``<name>@ids`` and
``<name>@vals`` (``DataFeeder``'s fixed-nnz packing): its value is the
ids, and the values ride ``ApplyContext.sparse_vals`` to the ``fc`` that
consumes it, the only layer that may.  ``forward(sparse_probes=)`` hands
each ``sparse_update`` embedding a zero probe shaped like its gathered
rows (the trainer's SelectedRows path, ``sparse_embeddings``).
Evaluators declared on the graph's layers attach to the topology
(``evaluator.match_graph``), and their layers join it.

A nested-sequence data layer (``seq_type`` 2) is [B, S, T, ...]: its
``@len`` masks the outer axis, and its ``@sublen`` feed, the inner lengths
[B, S], rides ``ApplyContext.sublens`` to the ``recurrent_group`` that
scans it (``SubsequenceInput``).

Not ported yet, and refused: gradient printers' probes, mesh placement
and ``prepare_forward``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch import initializer as init_mod
from paddle_tpu_torch import layers as _layers  # noqa: F401 (registers kinds)
from paddle_tpu_torch.core import config as cfg
from paddle_tpu_torch.core.ir import (LayerOutput, LayerSpec, ModelSpec,
                                      collect_topology)
from paddle_tpu_torch.core.registry import ApplyContext, get_layer_def
from paddle_tpu_torch.layers.sequence import SeqLayerDef
from paddle_tpu_torch.parameters import (Parameters,
                                         check_fuse_conv_bn_mismatch,
                                         tree_keys)


# the layer scopes open (``layer_scope``), innermost last: each a
# factory ``spec -> context manager`` entered around every layer's apply
_LAYER_SCOPES: list = []


@contextlib.contextmanager
def layer_scope(factory):
    """Enter ``factory(spec)`` around each layer's apply while open: the
    per-layer FLOP count and the ``record_function`` ranges of
    ``utils/profiler.layer_cost_report``.  With none open a layer pays
    one list test."""
    _LAYER_SCOPES.append(factory)
    try:
        yield
    finally:
        _LAYER_SCOPES.remove(factory)


@contextlib.contextmanager
def _layer_error_context(spec, in_vals):
    """Annotate failures with the offending layer (the reference keeps a
    layer-name CustomStackTrace for exactly this)."""
    try:
        yield
    except Exception as e:
        shapes = [tuple(getattr(v, "shape", ())) for v in in_vals]
        e.add_note(f"  [in layer {spec.name!r} kind={spec.kind!r} "
                   f"input_shapes={shapes}]")
        raise


# cost kinds whose seq-folded form receives the flattened mask as the
# per-sample weight input (token-level losses over padded sequences)
_MASK_WEIGHT_COSTS = {"classification_cost", "cross_entropy", "mse_cost",
                      "lm_head_cost"}

# the JAX package's remat eligibility (paddle_tpu/topology.py), copied.
# Layers whose apply uses side channels that must not replay under a
# recompute: the random stream (dropout, sampling_id, nce_cost,
# recurrent_group), running state (batch_norm), the mask side channel
# (seq_concat, seq_reshape, seq_slice) or host effects (print)
_REMAT_UNSAFE_KINDS = frozenset({
    "dropout", "sampling_id", "batch_norm", "print", "beam_search",
    "nce_cost", "recurrent_group", "seq_concat", "seq_reshape",
    "seq_slice",
})

# block segments return their state updates explicitly, so batch_norm is
# safe inside them
_BLOCK_REMAT_UNSAFE_KINDS = _REMAT_UNSAFE_KINDS - {"batch_norm"}

# sequence layers that are pure functions of (params, inputs, masks) and
# may live inside a block segment (when every boundary mask is None)
_BLOCK_REMAT_SEQ_OK = frozenset({
    "position_embedding", "multi_head_attention",
})


class _Segment:
    __slots__ = ("members", "inputs", "outputs")

    def __init__(self, members, inputs, outputs):
        self.members = members
        self.inputs = inputs
        self.outputs = outputs


def _clone_ctx(ctx):
    sub = ApplyContext(train=ctx.train, generator=ctx.generator,
                       device=ctx.device, compute_dtype=ctx.compute_dtype)
    sub.params_tree = ctx.params_tree
    sub.state_in = ctx.state_in
    sub.sparse_probes = ctx.sparse_probes
    sub.sparse_vals = ctx.sparse_vals
    sub.sublens = ctx.sublens
    return sub


def _remat_eligible(spec) -> bool:
    if spec.kind in _REMAT_UNSAFE_KINDS:
        return False
    # cross-layer parameter access goes around the recomputed function's
    # inputs, and so do sparse tables
    if spec.attrs.get("share_from") or spec.attrs.get("param_layer"):
        return False
    if spec.attrs.get("param_sparse"):
        return False
    return True


def _meta(p) -> dict:
    return {"learning_rate": p.learning_rate, "is_static": p.is_static,
            "l1": p.l1_decay, "l2": p.l2_decay,
            "clip": p.gradient_clipping_threshold,
            "sparse_update": p.sparse_update}


def _float_feed(x: torch.Tensor, policy) -> torch.Tensor:
    """A float feed in the dtype the layers compute in: float32, except
    the compute dtypes, which keep theirs, as in the JAX package (a
    recurrent group's step feeds its bf16 statics back in here).  The
    float64 grad sweep (``tests/test_torch_layer_grad_sweep.py``) replaces
    this rule to keep its float64 feeds."""
    if (x.dtype in (torch.bfloat16, torch.float32)
            or (policy.compute_dtype == "float16"
                and x.dtype == torch.float16)):
        return x
    return x.float()


def _add_probe(grad_probes: dict, name: str, values: dict) -> None:
    """Add ``name``'s zero gradient probe to its value, made here in the
    output's shape (``Topology.forward(grad_probes=)``)."""
    if name not in grad_probes:
        return
    v = values[name]
    probe = torch.zeros(v.shape, dtype=torch.float32, device=v.device,
                        requires_grad=True)
    grad_probes[name] = probe
    values[name] = v + probe.to(v.dtype)


class Topology:
    """A model handle built from output LayerOutputs (parity surface:
    python/paddle/v2/topology.py Topology; the "proto" is the JSON
    ModelSpec)."""

    def __init__(self, outputs, extra_inputs: Optional[Sequence] = None,
                 evaluators: Optional[Sequence] = None,
                 collect_evaluators: bool = True):
        from paddle_tpu_torch import evaluator as eval_mod

        if isinstance(outputs, LayerOutput):
            outputs = [outputs]
        self.outputs: List[LayerOutput] = list(outputs)
        extra = list(extra_inputs or [])
        # evaluators declared on this graph's layers attach (matched by
        # layer identity, so every Topology over the same layers gets
        # them), and their layers join the graph; an inference topology
        # passes collect_evaluators=False, or the labels would join its
        # feeds
        self.evaluators = list(evaluators or [])
        if collect_evaluators:
            have = {id(e) for e in self.evaluators}
            for ev in eval_mod.match_graph(
                    collect_topology(self.outputs + extra)):
                if id(ev) not in have:
                    self.evaluators.append(ev)
        for ev in self.evaluators:
            extra.extend(ev.layers.values())
        self._nodes = collect_topology(self.outputs + extra)
        self.specs: List[LayerSpec] = [n.spec() for n in self._nodes]
        self._spec_by_name = {s.name: s for s in self.specs}
        self.input_names = [s.name for s in self.specs if s.kind == "data"]
        self.output_names = [o.name for o in self.outputs]
        self.model_spec = ModelSpec(self.specs, self.input_names,
                                    self.output_names)
        self._seg_cache: dict = {}
        self._infer()

    # ---------------------------------------------------------------- shapes
    def _infer(self) -> None:
        """Shape + sequence-ness inference over the topo order."""
        self.shapes: Dict[str, tuple] = {}
        self.is_seq: Dict[str, bool] = {}
        self.param_specs: Dict[str, list] = {}
        for spec in self.specs:
            ldef = get_layer_def(spec.kind)
            if spec.kind == "data":
                seq = spec.attrs.get("seq_type", 0) != 0
                shape = tuple(spec.attrs["shape"])
                if spec.attrs.get("seq_type", 0) == 2:
                    # nested sequence [B, S, T, ...]: the outer axis
                    # carries the sequence mask; the inner lengths come
                    # in the @sublen feed
                    shape = (spec.attrs.get("sub_max") or None,
                             spec.attrs.get("max_len") or None) + shape
                elif seq:
                    # T is static (max_len) or None (the batch max at feed
                    # time; param shapes never depend on T)
                    shape = (spec.attrs.get("max_len") or None,) + shape
                self.shapes[spec.name] = shape
                self.is_seq[spec.name] = seq
                self.param_specs[spec.name] = []
                continue
            in_shapes = [self.shapes[i] for i in spec.inputs]
            in_seq = [self.is_seq[i] for i in spec.inputs]
            for src in spec.inputs:
                sspec = self._spec_by_name.get(src)
                if (sspec is not None and sspec.kind == "data"
                        and sspec.attrs.get("sparse_kind")
                        and spec.kind != "fc"):
                    raise ValueError(
                        f"layer {spec.name!r} ({spec.kind}) cannot "
                        f"consume the sparse input {src!r}: sparse "
                        f"(ids+values) inputs lower to a weight-row "
                        f"gather and are only understood by fc")
            if hasattr(ldef, "check_inputs"):
                ldef.check_inputs(spec.attrs, in_seq)
            if isinstance(ldef, SeqLayerDef):
                out_shape = ldef.infer_shape(spec.attrs, in_shapes)
                self.is_seq[spec.name] = bool(ldef.out_is_seq)
                self.param_specs[spec.name] = list(
                    ldef.param_specs(spec.attrs, in_shapes))
            elif any(in_seq):
                # fold T into batch for plain layers
                t = None
                step_shapes = []
                for s, sq in zip(in_shapes, in_seq):
                    if sq:
                        t = s[0]
                        step_shapes.append(tuple(s[1:]))
                    else:
                        step_shapes.append(tuple(s))
                out_step = ldef.infer_shape(spec.attrs, step_shapes)
                self.param_specs[spec.name] = list(
                    ldef.param_specs(spec.attrs, step_shapes))
                if out_step == ():        # cost layer -> scalar, not a seq
                    out_shape = ()
                    self.is_seq[spec.name] = False
                else:
                    out_shape = (t,) + tuple(out_step)
                    self.is_seq[spec.name] = True
            else:
                out_shape = ldef.infer_shape(spec.attrs, in_shapes)
                self.is_seq[spec.name] = False
                self.param_specs[spec.name] = list(
                    ldef.param_specs(spec.attrs, in_shapes))
            self.shapes[spec.name] = tuple(out_shape)

    # ---------------------------------------------------------------- params
    def create_parameters(self, generator: Optional[torch.Generator] = None,
                          *, device=None, values: Optional[dict] = None
                          ) -> Parameters:
        """Parameters on ``device`` (default: the ``device`` option, else
        the card).  Fresh ones are drawn in spec order from ``generator``
        (default: a CPU generator seeded with ``init(seed=)``); with
        ``values`` (a numpy tree ``{layer: {param: ndarray}}``) they are
        those arrays instead, which must match the specs exactly."""
        dev = cfg.default_device(device)
        if values is not None:
            check_fuse_conv_bn_mismatch(
                (s.name for s in self.specs), tree_keys(values))
        if values is None and generator is None:
            generator = torch.Generator().manual_seed(
                int(cfg.get_option("seed", 0)))
        out, meta = {}, {}
        for spec in self.specs:
            pspecs = [p for p in self.param_specs[spec.name]
                      if not p.is_state]
            if not pspecs:
                continue
            out[spec.name], meta[spec.name] = {}, {}
            for p in pspecs:
                if values is None:
                    t = init_mod.resolve(p.initializer)(generator, p.shape)
                else:
                    arr = np.asarray(values[spec.name][p.name], np.float32)
                    if arr.shape != tuple(p.shape):
                        raise ValueError(
                            f"{spec.name}.{p.name}: got shape {arr.shape}, "
                            f"the topology wants {tuple(p.shape)}")
                    t = torch.from_numpy(arr.copy())
                out[spec.name][p.name] = t.to(dev, torch.float32)
                meta[spec.name][p.name] = _meta(p)
        if values is not None:
            extra = sorted(f"{l}.{p}" for l, ps in values.items()
                           for p in ps if p not in out.get(l, {}))
            if extra:
                raise ValueError(f"parameters the topology does not have: "
                                 f"{extra[:8]}")
        return Parameters(out, meta)

    def sparse_embeddings(self):
        """``[(layer, ids data layer, emb_dim)]`` for every embedding whose
        table is ``sparse_update``: the tables the trainer updates by
        SelectedRows.  The ids must come straight from a data layer, so
        that the trainer reads the touched rows from the feed; a table
        another embedding shares raises, since the sharer's lookups would
        reach the table around the probe and their gradient be lost."""
        out = []
        owners = {s.name for s in self.specs
                  if s.kind == "embedding" and s.attrs.get("param_sparse")
                  and not s.attrs.get("share_from")}
        for spec in self.specs:
            if spec.kind != "embedding":
                continue
            if spec.attrs.get("share_from") in owners:
                raise ValueError(
                    f"embedding {spec.name!r} shares the sparse_update "
                    f"table {spec.attrs['share_from']!r}; tied lookups on "
                    f"a sparse table are not supported — drop "
                    f"sparse_update or untie the tables")
            if spec.name in owners:
                src = spec.inputs[0]
                if src not in self.input_names:
                    raise ValueError(
                        f"sparse_update embedding {spec.name!r} needs its "
                        f"ids straight from a data layer (got {src!r}); "
                        f"precompute ids into the feed or drop "
                        f"sparse_update")
                out.append((spec.name, src, spec.attrs["size"]))
        return out

    def create_state(self, *, device=None,
                     values: Optional[dict] = None) -> dict:
        """Initial running-state tree (batch-norm moving statistics) on
        ``device`` (default: the ``device`` option, else the card), from
        each ``is_state`` spec's initializer; with ``values`` (a numpy tree
        ``{layer: {name: ndarray}}``, e.g. the JAX package's
        ``trainer.model_state``) those arrays instead, which must match
        the specs exactly."""
        dev = cfg.default_device(device)
        state: dict = {}
        for spec in self.specs:
            for p in self.param_specs[spec.name]:
                if not p.is_state:
                    continue
                if values is None:
                    t = init_mod.resolve(p.initializer)(None, p.shape)
                else:
                    t = torch.from_numpy(np.array(
                        values[spec.name][p.name], np.float32))
                    if tuple(t.shape) != tuple(p.shape):
                        raise ValueError(
                            f"{spec.name}.{p.name}: got state of shape "
                            f"{tuple(t.shape)}, the topology wants "
                            f"{tuple(p.shape)}")
                state.setdefault(spec.name, {})[p.name] = t.to(
                    dev, torch.float32)
        if values is not None:
            extra = sorted(f"{l}.{k}" for l, ks in values.items()
                           for k in ks if k not in state.get(l, {}))
            if extra:
                raise ValueError(f"state the topology does not have: "
                                 f"{extra[:8]}")
        return state

    # ---------------------------------------------------------------- forward
    def forward(self, params: dict, state: dict, feed: dict, *,
                train: bool = False,
                outputs: Optional[Sequence[str]] = None,
                with_masks: bool = False, remat=None,
                generator: Optional[torch.Generator] = None, device=None,
                sparse_probes: Optional[dict] = None,
                grad_probes: Optional[dict] = None):
        """Eager forward under autograd.  Returns ({name: value},
        new_state): ``state`` with the entries the layers wrote (train-mode
        batch norm's moving statistics) replaced by detached tensors, so
        no autograd graph lives from one step to the next.
        ``with_masks=True`` adds a third result, ``{name: mask or None}``
        for the requested outputs: the sequence masks the layers
        propagated, which the evaluators consume.

        ``feed`` maps data-layer names to arrays or tensors; sequence data
        layers also accept ``<name>@len`` (default: full length).  Feeds
        move to ``device`` (default: the ``device`` option, else the
        card), where ``params`` must already lie.  A float feed becomes
        float32 unless it is bf16 (or float16 under the ``fp16`` policy),
        which it keeps.  The layers compute in the precision policy's
        compute dtype (``ApplyContext.compute_dtype``); ``params`` stay
        float32.

        ``remat=True`` recomputes each eligible layer in the backward
        (``_remat_eligible``: no random stream, running state, mask side
        channel or cross-layer parameters; layers folded over a sequence
        run plain, as in the JAX package); ``"blocks"`` recomputes
        segments of layers that close where a value fans out, is asked
        for or ends (``_block_segments``; on ResNet a bottleneck block),
        whose state updates come out as results, so batch norm may be
        inside; None reads the ``remat`` option.  The values and the
        gradients are the same bit for bit; the backward relaunches the
        recomputed layers' kernels.

        ``sparse_probes``: ``{embedding layer: zeros [lookups, dim]}``, the
        trainer's SelectedRows probes (``sparse_embeddings``).

        ``grad_probes``: ``{layer name: None}``, gradient_printer's
        channel.  The forward fills each entry with a float32 zero tensor
        shaped like the layer's output (``requires_grad``) and adds it to
        that output, so the gradient with respect to the probe is the
        output's cotangent.  An integer data layer takes no probe (its
        entry stays None; the trainer reports zeros, as the JAX package
        does)."""
        if remat is None:
            remat = cfg.get_option("remat", False)
            if remat not in ("blocks",):
                remat = bool(remat)
        dev = cfg.default_device(device)
        policy = cfg.precision_policy()
        ctx = ApplyContext(train=train, generator=generator, device=dev,
                           compute_dtype=policy.ctx_compute_dtype())
        ctx.state_in = state
        ctx.params_tree = params   # cross-layer access (tied weights)
        ctx.sparse_probes = sparse_probes or {}
        ctx.sparse_vals = {}
        values: Dict[str, torch.Tensor] = {}
        masks: Dict[str, Optional[torch.Tensor]] = {}
        want = list(outputs or self.output_names)
        seg_of = (self._block_segments(want) if remat == "blocks" else {})
        inline_segs: set = set()
        grad_probes = {} if grad_probes is None else grad_probes
        for n in grad_probes:
            # a probed layer inside a segment would not take its probe
            # (only the boundary values surface): that segment runs inline
            if n in seg_of:
                inline_segs.add(id(seg_of[n]))
        for spec in self.specs:
            if spec.kind != "data":
                seg = seg_of.get(spec.name)
                if seg is not None and id(seg) not in inline_segs:
                    # the tail member runs the whole segment: by then
                    # every external input has been produced
                    if spec.name != seg.members[-1]:
                        continue
                    if all(masks.get(i) is None for i in seg.inputs):
                        self._run_segment(seg, params, values, masks, ctx)
                        continue
                    # boundary masks (padded feeds) do not pass through
                    # a segment: its members run inline
                    inline_segs.add(id(seg))
                    for m in seg.members[:-1]:
                        self._run_spec(self._spec_by_name[m], params,
                                       values, masks, ctx)
                        _add_probe(grad_probes, m, values)
                self._run_spec(spec, params, values, masks, ctx,
                               layer_remat=(remat is True))
                _add_probe(grad_probes, spec.name, values)
                continue
            if spec.attrs.get("sparse_kind"):
                # fixed-nnz packing: the value is the ids [B, nnz]; the
                # per-id values ride the context to the consuming fc
                ids = torch.as_tensor(feed[spec.name + "@ids"],
                                      device=dev).long()
                vals = feed.get(spec.name + "@vals")
                ctx.sparse_vals[spec.name] = (
                    torch.ones(ids.shape, device=dev) if vals is None
                    else torch.as_tensor(vals, device=dev).float())
                values[spec.name] = ids
                masks[spec.name] = None
                continue
            x = torch.as_tensor(feed[spec.name], device=dev)
            x = (x.long() if spec.attrs.get("is_index", False)
                 else _float_feed(x, policy))
            values[spec.name] = x
            if x.is_floating_point():
                _add_probe(grad_probes, spec.name, values)
            masks[spec.name] = None
            if spec.attrs.get("seq_type", 0) == 2:
                sub = feed.get(spec.name + "@sublen")
                ctx.sublens[spec.name] = (
                    None if sub is None
                    else torch.as_tensor(sub, device=dev).to(torch.int32))
            lens = feed.get(spec.name + "@len")
            if self.is_seq[spec.name] and lens is not None:
                # None = statically full, which lets attention skip kv_lens
                lens = torch.as_tensor(lens, device=dev).to(torch.int32)
                pos = torch.arange(x.shape[1], device=dev)
                masks[spec.name] = (pos[None, :]
                                    < lens[:, None]).to(torch.float32)
        outs = {name: values[name] for name in want}
        new_state = _merge_state(state, ctx.state_out)
        if with_masks:
            return outs, new_state, {n: masks.get(n) for n in want}
        return outs, new_state

    def _run_spec(self, spec, params, values, masks, ctx, *,
                  layer_remat=False):
        """Execute one non-data spec, writing its value and mask (the
        per-layer step of the inline path and of block segments); with
        ``layer_remat`` an eligible layer runs under a checkpoint."""
        ldef = get_layer_def(spec.kind)
        in_vals = [values[i] for i in spec.inputs]
        in_masks = [masks[i] for i in spec.inputs]
        in_seq = [self.is_seq[i] for i in spec.inputs]
        lparams = params.get(spec.name, {})
        ctx._cur_layer = spec.name
        ctx.in_names = spec.inputs
        use_remat = layer_remat and _remat_eligible(spec)
        scope = (_LAYER_SCOPES[-1](spec) if _LAYER_SCOPES
                 else contextlib.nullcontext())
        with _layer_error_context(spec, in_vals), scope:
            if isinstance(ldef, SeqLayerDef):
                if use_remat:
                    out = self._recomputed(
                        spec, lambda *v: ldef.apply_seq(
                            spec.attrs, lparams, list(v), in_masks, ctx),
                        in_vals, ctx)
                else:
                    out = ldef.apply_seq(spec.attrs, lparams, in_vals,
                                         in_masks, ctx)
                masks[spec.name] = self._seq_out_mask(spec.name, ldef,
                                                      in_masks, ctx)
            elif any(in_seq):
                out, masks[spec.name] = self._apply_folded(
                    ldef, spec, lparams, in_vals, in_masks, in_seq, ctx)
            else:
                if use_remat:
                    out = self._recomputed(
                        spec, lambda *v: ldef.apply(
                            spec.attrs, lparams, list(v), ctx),
                        in_vals, ctx)
                else:
                    out = ldef.apply(spec.attrs, lparams, in_vals, ctx)
                masks[spec.name] = None
        values[spec.name] = out

    @staticmethod
    def _seq_out_mask(name, ldef, in_masks, ctx):
        """A sequence layer's output mask: the one it wrote to
        ``__mask__`` (taken out of the running state), else the mask of
        the input its ``mask_from()`` names (the first by default), or
        None for a layer whose output is not a sequence."""
        written = ctx.state_out.get(name, {})
        new_mask = written.pop("__mask__", None)
        if name in ctx.state_out and not written:
            del ctx.state_out[name]
        if new_mask is not None:
            return new_mask
        if ldef.out_is_seq:
            src = ldef.mask_from() if hasattr(ldef, "mask_from") else 0
            return in_masks[src]
        return None

    @staticmethod
    def _recomputed(spec, fn, in_vals, ctx):
        """``fn(*in_vals)`` under a checkpoint: the backward runs it again
        (as the layer ``spec``) for its activations."""
        def run(*vals):
            ctx._cur_layer = spec.name
            ctx.in_names = spec.inputs
            return fn(*vals)
        return checkpoint(run, *in_vals, use_reentrant=False)

    def _run_segment(self, seg, params, values, masks, ctx):
        """Run one block segment under a checkpoint as a function of its
        boundary inputs to (boundary outputs, state updates).  The state
        comes out as a result, not through the context, which is what
        lets batch norm live inside a recomputed region: the backward
        recomputes the members from the boundary inputs, and only the
        boundary values and the state updates are kept."""
        member_specs = [self._spec_by_name[n] for n in seg.members]
        seg_params = {n: params.get(n, {}) for n in seg.members}

        def seg_fn(*in_vals):
            sub = _clone_ctx(ctx)
            local_vals = dict(zip(seg.inputs, in_vals))
            local_masks = {n: masks.get(n) for n in seg.inputs}
            for m in member_specs:
                self._run_spec(m, seg_params, local_vals, local_masks, sub)
            return (tuple(local_vals[n] for n in seg.outputs),
                    sub.state_out)

        outs, state_updates = checkpoint(
            seg_fn, *(values[n] for n in seg.inputs), use_reentrant=False)
        for name, val in zip(seg.outputs, outs):
            values[name] = val
            masks[name] = None
        for lname, ps in state_updates.items():
            ctx.state_out.setdefault(lname, {}).update(ps)

    def _block_segments(self, want):
        """Partition the non-data specs into block segments.  A segment
        closes after a spec whose value crosses a boundary: consumed by
        more than one later spec (a residual fan-out; on ResNet the
        bottleneck adds), asked for as an output, or feeding nothing
        later.  Segments holding a spec unsafe to recompute
        (``_segment_spec_ok``) run inline, and so do single-spec ones
        (nothing to save)."""
        key = frozenset(want)
        cached = self._seg_cache.get(key)
        if cached is not None:
            return cached
        specs = [s for s in self.specs if s.kind != "data"]
        consumers = {}
        for s in specs:
            for i in s.inputs:
                consumers.setdefault(i, []).append(s.name)
        segments, cur = [], []
        for spec in specs:
            cur.append(spec)
            if len(consumers.get(spec.name, [])) != 1 or spec.name in want:
                segments.append(cur)
                cur = []
        if cur:
            segments.append(cur)
        out = {}
        for seg_specs in segments:
            names = [s.name for s in seg_specs]
            if len(names) < 2 or not all(
                    self._segment_spec_ok(s) for s in seg_specs):
                continue
            member_set = set(names)
            inputs = []
            for s in seg_specs:
                for i in s.inputs:
                    if i not in member_set and i not in inputs:
                        inputs.append(i)
            outputs = [n for n in names
                       if n in want or any(c not in member_set
                                           for c in consumers.get(n, []))]
            seg = _Segment(members=names, inputs=inputs,
                           outputs=outputs or [names[-1]])
            for n in names:
                out[n] = seg
        self._seg_cache[key] = out
        return out

    def _segment_spec_ok(self, spec) -> bool:
        if spec.kind in _BLOCK_REMAT_UNSAFE_KINDS:
            return False
        if spec.attrs.get("share_from") or spec.attrs.get("param_layer"):
            return False
        if spec.attrs.get("param_sparse"):
            return False
        # a sequence layer may write masks of its own: only the pure
        # ones segment; plain layers folded over a sequence are fine
        # (the boundary masks are None whenever a segment runs)
        return (not isinstance(get_layer_def(spec.kind), SeqLayerDef)
                or spec.kind in _BLOCK_REMAT_SEQ_OK)

    def _apply_folded(self, ldef, spec, lparams, in_vals, in_masks, in_seq,
                      ctx):
        """Apply a plain layer per timestep by folding T into batch."""
        t = b = mask = None
        folded = []
        for x, sq, m in zip(in_vals, in_seq, in_masks):
            if sq:
                b, t = x.shape[0], x.shape[1]
                folded.append(x.reshape((b * t,) + tuple(x.shape[2:])))
                if mask is None and m is not None:
                    mask = m
            else:
                folded.append(x)
        # broadcast non-seq inputs across time
        folded = [
            (torch.repeat_interleave(x, t, dim=0)
             if (not sq) and x.ndim >= 1 and x.shape[0] == b else x)
            for x, sq in zip(folded, in_seq)
        ]
        if self.shapes[spec.name] == () and not self.is_seq[spec.name]:
            if spec.kind in _MASK_WEIGHT_COSTS and mask is not None \
                    and len(folded) == 2:
                folded.append(mask.reshape(-1))
            return ldef.apply(spec.attrs, lparams, folded, ctx), None
        out = ldef.apply(spec.attrs, lparams, folded, ctx)
        return out.reshape((b, t) + tuple(out.shape[1:])), mask

    # ---------------------------------------------------------------- misc
    def proto(self) -> str:
        """Serialized ModelSpec (golden-file testable, reference:
        .protostr); byte-equal to the JAX package's for the same config."""
        return self.model_spec.to_json()

    def data_layers(self) -> Dict[str, LayerSpec]:
        """{name: spec} of the data layers, in input order."""
        return {n: self._spec_by_name[n] for n in self.input_names}

    def get_layer(self, name: str) -> LayerSpec:
        return self._spec_by_name[name]


def _merge_state(state: dict, updates: dict) -> dict:
    """``state`` with ``updates`` laid over it, detached."""
    if not updates:
        return state
    new = {l: dict(ps) for l, ps in state.items()}
    for l, ps in updates.items():
        for k, v in ps.items():
            new.setdefault(l, {})[k] = v.detach()
    return new
