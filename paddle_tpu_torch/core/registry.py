"""Layer registry: name -> LayerDef.

Counterpart of ``paddle_tpu/core/registry.py``.  A LayerDef does three jobs:
shape inference, parameter specs, and ``apply()`` - here eager PyTorch
under autograd, so the backward comes from ``loss.backward()`` (or
``torch.autograd.grad``) over the whole topology.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

_LAYER_REGISTRY: Dict[str, "LayerDef"] = {}


class ApplyContext:
    """Per-forward context threaded through layer ``apply()`` calls: train
    or test mode, the ``torch.Generator`` of the forward (dropout's masks,
    NCE's negatives: ``rng()``; it lies on the forward's device), the device, the
    compute dtype of the precision policy (None under float32: the layers
    then cast nothing), the full parameter tree (tied weights), and the
    running-state namespace
    (batch-norm moving mean and variance): a layer reads its own entries
    of ``state_in`` with ``get_state`` and writes new ones to ``state_out``
    with ``set_state``; ``Topology.forward`` sets the current layer and
    the names of its inputs (``in_names``).  The sparse side channels:
    ``sparse_vals`` maps a sparse data layer to its per-id values, and
    ``sparse_probes`` a ``sparse_update`` embedding to the trainer's zero
    probe.  ``sublens`` maps a nested-sequence data layer to its inner
    lengths [B, S] (its ``@sublen`` feed; None when it has none)."""

    def __init__(self, train: bool, generator: Optional[torch.Generator]
                 = None, device=None, compute_dtype=None):
        self.train = train
        self.generator = generator
        self.device = device
        self.compute_dtype = compute_dtype
        self.params_tree: dict = {}   # full parameter tree (tied weights)
        self.state_in: dict = {}      # {layer_name: {key: tensor}}
        self.state_out: dict = {}
        self.sparse_vals: dict = {}     # {sparse data layer: values}
        self.sparse_probes: dict = {}   # {embedding layer: zero probe}
        self.sublens: dict = {}         # {nested data layer: [B, S] lens}
        self.in_names: Sequence[str] = ()
        self._cur_layer: Optional[str] = None

    def rng(self) -> torch.Generator:
        """The forward's generator, which a layer that draws random
        numbers advances (the JAX package's ``next_rng``); none given
        raises."""
        if self.generator is None:
            raise ValueError(
                "layer needs an rng (dropout?) but no rng was provided; "
                "pass generator= to Topology.forward / use trainer which "
                "threads one")
        return self.generator

    # -- running state (BN et al.) -------------------------------------
    def get_state(self, key: str):
        return self.state_in[self._cur_layer][key]

    def set_state(self, key: str, value) -> None:
        self.state_out.setdefault(self._cur_layer, {})[key] = value


class LayerDef:
    """Base class for layer definitions: subclass and register."""

    kind: str = None

    def infer_shape(self, attrs: dict, in_shapes: Sequence[tuple]) -> tuple:
        """Per-sample output shape (batch dim excluded)."""
        raise NotImplementedError

    def param_specs(self, attrs: dict, in_shapes: Sequence[tuple]):
        """Return list[ParamSpec] (possibly empty)."""
        return []

    def apply(self, attrs: dict, params: dict, inputs: list,
              ctx: ApplyContext):
        """Forward computation. inputs/outputs carry a leading batch dim."""
        raise NotImplementedError


def register_layer(layer_def) -> LayerDef:
    if isinstance(layer_def, type):
        layer_def = layer_def()
    kind = layer_def.kind
    assert kind, f"LayerDef {layer_def} must set .kind"
    if kind in _LAYER_REGISTRY:
        raise ValueError(f"layer kind {kind!r} already registered")
    _LAYER_REGISTRY[kind] = layer_def
    return layer_def


def registered_layers():
    return dict(_LAYER_REGISTRY)


def get_layer_def(kind: str) -> LayerDef:
    try:
        return _LAYER_REGISTRY[kind]
    except KeyError:
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported to paddle_tpu_torch yet "
            f"(ROADMAP.md section 1); ported: {sorted(_LAYER_REGISTRY)}"
            ) from None
