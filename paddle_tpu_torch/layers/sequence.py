"""Sequence plumbing on padded batches with masks (the part of
``paddle_tpu/layers/sequence.py`` the ported layers ride on).

Sequences are padded to a length T and every sequence tensor [B, T, ...]
travels with a validity mask [B, T] (1.0 = real step), built from the
``<name>@len`` feed and propagated parent to child by ``Topology``; a
statically full sequence (no ``@len``) carries ``None``.  The sequence
layers themselves (pooling, expand, concat, ...) come with the recurrent
slice.
"""

from __future__ import annotations

from paddle_tpu_torch.core.registry import LayerDef


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
