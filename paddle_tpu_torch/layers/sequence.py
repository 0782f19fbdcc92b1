"""Sequence plumbing on padded batches with masks (the part of
``paddle_tpu/layers/sequence.py`` the ported layers ride on).

Sequences are padded to a length T and every sequence tensor [B, T, ...]
travels with a validity mask [B, T] (1.0 = real step), built from the
``<name>@len`` feed and propagated parent to child by ``Topology``; a
statically full sequence (no ``@len``) carries ``None``.  Of the
sequence layers, ``last_seq`` and ``first_seq`` are ported; pooling,
expand, seq_concat and the rest come later.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import LayerDef, register_layer


def _expand_mask(mask, x):
    """[B,T] -> broadcastable to x:[B,T,...]."""
    return mask.reshape(tuple(mask.shape) + (1,) * (x.ndim - 2))


class SeqLayerDef(LayerDef):
    """Base for layers that consume the input's sequence mask.

    Topology passes masks via ``apply_seq(attrs, params, inputs, masks,
    ctx)`` where masks[i] is [B,T] or None.
    """

    #: None -> propagate first input's mask; False -> output is not a sequence
    out_is_seq = True

    def apply(self, attrs, params, inputs, ctx):  # pragma: no cover
        raise RuntimeError("sequence layers are applied via apply_seq")


@register_layer
class LastSeqLayer(SeqLayerDef):
    """last real timestep (reference: SequenceLastInstanceLayer)."""

    kind = "last_seq"
    out_is_seq = False

    def infer_shape(self, attrs, in_shapes):
        return tuple(in_shapes[0][1:])

    def apply_seq(self, attrs, params, inputs, masks, ctx):
        x, mask = inputs[0], masks[0]
        if mask is None:
            return x[:, -1]
        idx = torch.clamp(mask.sum(dim=1).long() - 1, min=0)
        return x[torch.arange(x.shape[0], device=x.device), idx]


@register_layer
class FirstSeqLayer(SeqLayerDef):
    """first timestep (reference: SequenceFirstInstanceLayer)."""

    kind = "first_seq"
    out_is_seq = False

    def infer_shape(self, attrs, in_shapes):
        return tuple(in_shapes[0][1:])

    def apply_seq(self, attrs, params, inputs, masks, ctx):
        return inputs[0][:, 0]
