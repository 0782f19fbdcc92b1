"""Topology: a layer graph run as one eager PyTorch forward (counterpart of
``paddle_tpu/topology.py``).

The JAX package traces every layer's ``apply()`` into one jaxpr that XLA
compiles; here ``forward`` runs the same per-layer steps eagerly, under
autograd, so the trainer's backward is ``torch.autograd.grad`` over the
cost.  Shape inference, parameter specs, the JSON IR (``proto()``),
sequence masks from ``<name>@len`` feeds and the fold of plain layers over
sequence inputs are the JAX package's.

Not ported yet, and refused: remat segments, sparse (ids + values) inputs,
nested sequences, SelectedRows and gradient probes, mesh placement,
evaluators and ``prepare_forward``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch import initializer as init_mod
from paddle_tpu_torch import layers as _layers  # noqa: F401 (registers kinds)
from paddle_tpu_torch.core import config as cfg
from paddle_tpu_torch.core.ir import (LayerOutput, LayerSpec, ModelSpec,
                                      collect_topology)
from paddle_tpu_torch.core.registry import ApplyContext, get_layer_def
from paddle_tpu_torch.layers.sequence import SeqLayerDef
from paddle_tpu_torch.parameters import Parameters


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
# per-sample weight input (token-level losses over padded sequences; the
# JAX package lists more, not ported yet)
_MASK_WEIGHT_COSTS = {"classification_cost"}


def _meta(p) -> dict:
    return {"learning_rate": p.learning_rate, "is_static": p.is_static,
            "l1": p.l1_decay, "l2": p.l2_decay,
            "clip": p.gradient_clipping_threshold,
            "sparse_update": p.sparse_update}


class Topology:
    """A model handle built from output LayerOutputs (parity surface:
    python/paddle/v2/topology.py Topology; the "proto" is the JSON
    ModelSpec)."""

    def __init__(self, outputs, extra_inputs: Optional[Sequence] = None,
                 evaluators: Optional[Sequence] = None,
                 collect_evaluators: bool = True):
        if evaluators:
            raise NotImplementedError(
                "evaluators are not ported to paddle_tpu_torch yet")
        if isinstance(outputs, LayerOutput):
            outputs = [outputs]
        self.outputs: List[LayerOutput] = list(outputs)
        self.evaluators: list = []
        self._nodes = collect_topology(self.outputs
                                       + list(extra_inputs or []))
        self.specs: List[LayerSpec] = [n.spec() for n in self._nodes]
        self._spec_by_name = {s.name: s for s in self.specs}
        self.input_names = [s.name for s in self.specs if s.kind == "data"]
        self.output_names = [o.name for o in self.outputs]
        self.model_spec = ModelSpec(self.specs, self.input_names,
                                    self.output_names)
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
                if spec.attrs.get("sparse_kind"):
                    raise NotImplementedError(
                        f"data layer {spec.name!r}: sparse inputs are not "
                        f"ported to paddle_tpu_torch yet")
                if spec.attrs.get("seq_type", 0) == 2:
                    raise NotImplementedError(
                        f"data layer {spec.name!r}: nested sequences are "
                        f"not ported to paddle_tpu_torch yet")
                seq = spec.attrs.get("seq_type", 0) != 0
                shape = tuple(spec.attrs["shape"])
                if seq:
                    # T is static (max_len) or None (the batch max at feed
                    # time; param shapes never depend on T)
                    shape = (spec.attrs.get("max_len") or None,) + shape
                self.shapes[spec.name] = shape
                self.is_seq[spec.name] = seq
                self.param_specs[spec.name] = []
                continue
            in_shapes = [self.shapes[i] for i in spec.inputs]
            in_seq = [self.is_seq[i] for i in spec.inputs]
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
                outputs: Optional[Sequence[str]] = None, remat=None,
                generator: Optional[torch.Generator] = None, device=None):
        """Eager forward under autograd.  Returns ({name: value},
        new_state): ``state`` with the entries the layers wrote (train-mode
        batch norm's moving statistics) replaced by detached tensors, so
        no autograd graph lives from one step to the next.

        ``feed`` maps data-layer names to arrays or tensors; sequence data
        layers also accept ``<name>@len`` (default: full length).  Feeds
        move to ``device`` (default: the ``device`` option, else the
        card), where ``params`` must already lie."""
        if remat:
            raise NotImplementedError(
                "remat is not ported to paddle_tpu_torch yet")
        dev = cfg.default_device(device)
        ctx = ApplyContext(train=train, generator=generator, device=dev)
        ctx.state_in = state
        ctx.params_tree = params   # cross-layer access (tied weights)
        values: Dict[str, torch.Tensor] = {}
        masks: Dict[str, Optional[torch.Tensor]] = {}
        want = list(outputs or self.output_names)
        for spec in self.specs:
            if spec.kind != "data":
                self._run_spec(spec, params, values, masks, ctx)
                continue
            x = torch.as_tensor(feed[spec.name], device=dev)
            x = (x.long() if spec.attrs.get("is_index", False)
                 else x.float())
            values[spec.name] = x
            masks[spec.name] = None
            lens = feed.get(spec.name + "@len")
            if self.is_seq[spec.name] and lens is not None:
                # None = statically full, which lets attention skip kv_lens
                lens = torch.as_tensor(lens, device=dev).to(torch.int32)
                pos = torch.arange(x.shape[1], device=dev)
                masks[spec.name] = (pos[None, :]
                                    < lens[:, None]).to(torch.float32)
        return ({name: values[name] for name in want},
                _merge_state(state, ctx.state_out))

    def _run_spec(self, spec, params, values, masks, ctx):
        """Execute one non-data spec, writing its value and mask."""
        ldef = get_layer_def(spec.kind)
        in_vals = [values[i] for i in spec.inputs]
        in_masks = [masks[i] for i in spec.inputs]
        in_seq = [self.is_seq[i] for i in spec.inputs]
        lparams = params.get(spec.name, {})
        ctx._cur_layer = spec.name
        with _layer_error_context(spec, in_vals):
            if isinstance(ldef, SeqLayerDef):
                out = ldef.apply_seq(spec.attrs, lparams, in_vals,
                                     in_masks, ctx)
                masks[spec.name] = in_masks[0] if ldef.out_is_seq else None
            elif any(in_seq):
                out, masks[spec.name] = self._apply_folded(
                    ldef, spec, lparams, in_vals, in_masks, in_seq, ctx)
            else:
                out = ldef.apply(spec.attrs, lparams, in_vals, ctx)
                masks[spec.name] = None
        values[spec.name] = out

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
