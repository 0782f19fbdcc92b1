"""Sub-sequence extraction layers (counterpart of
``paddle_tpu/layers/subseq.py``).

Reference: SubSequenceLayer (slice each sequence by per-sample offset and
size inputs) and SubNestedSequenceLayer (keep chosen steps of a sequence).
As in the JAX package, the output's time dim is the input's (an upper
bound) and the output mask carries the true lengths.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import register_layer
from paddle_tpu_torch.layers.sequence import SeqLayerDef


def _take_steps(x, idx):
    """x [B, T, ...] at the per-row step indices idx [B, K]."""
    idx = idx.long().reshape(tuple(idx.shape) + (1,) * (x.ndim - 2))
    return torch.gather(x, 1, idx.expand(tuple(idx.shape[:2])
                                         + tuple(x.shape[2:])))


@register_layer
class SubSeqLayer(SeqLayerDef):
    """inputs: [seq [B, T, d], offsets [B], sizes [B]] -> the per-sample
    slice seq[b, off:off+size], left-aligned, masked to ``sizes``."""

    kind = "sub_seq"
    out_is_seq = True

    def infer_shape(self, attrs, in_shapes):
        return in_shapes[0]

    def apply_seq(self, attrs, params, inputs, masks, ctx):
        x, off, size = inputs[0], inputs[1], inputs[2]
        t = x.shape[1]
        # negative offsets clamp to 0, so every mask stays a prefix mask
        # (a left-aligned run of real steps)
        off = off.reshape(-1).to(torch.int32).clamp_min(0)
        size = size.reshape(-1).to(torch.int32)
        pos = torch.arange(t, device=x.device)[None, :]
        idx = pos + off[:, None]                            # [B, T]
        out = _take_steps(x, idx.clamp(0, t - 1))
        # real = within the requested size and the source's true extent
        true_len = (masks[0].sum(dim=1).to(torch.int32)
                    if masks[0] is not None
                    else torch.full((x.shape[0],), t, dtype=torch.int32,
                                    device=x.device))
        new_mask = ((pos < size[:, None])
                    & (idx < true_len[:, None])).to(torch.float32)
        out = out * new_mask.reshape(tuple(new_mask.shape)
                                     + (1,) * (x.ndim - 2))
        ctx.set_state("__mask__", new_mask)
        return out


@register_layer
class KmaxSelectLayer(SeqLayerDef):
    """sub_nested_seq through selection scores: keep the k top-scoring
    timesteps of a sequence in time order.  inputs: [seq [B, T, d],
    scores [B, T, 1]]; attr k.  A padded step's score never competes; a
    stable descending sort breaks ties by the lower step first, as
    ``jax.lax.top_k`` does."""

    kind = "sub_nested_seq"
    out_is_seq = True

    def infer_shape(self, attrs, in_shapes):
        if in_shapes[1][0] != in_shapes[0][0]:
            raise ValueError(
                f"sub_nested_seq: scores time dim {in_shapes[1][0]} must "
                f"match the sequence's {in_shapes[0][0]} (pass raw "
                f"per-step scores, not kmax indices)")
        return (attrs["k"],) + tuple(in_shapes[0][1:])

    def apply_seq(self, attrs, params, inputs, masks, ctx):
        x, scores = inputs[0], inputs[1]
        k = attrs["k"]
        s = scores.reshape(scores.shape[0], scores.shape[1])
        m = masks[1] if masks[1] is not None else masks[0]
        if m is not None:
            s = torch.where(m > 0, s, torch.full_like(s, float("-inf")))
        order = torch.sort(s, dim=1, descending=True, stable=True)[1]
        top = torch.sort(order[:, :k], dim=1)[0]         # time order
        out = _take_steps(x, top)
        if m is not None:
            ctx.set_state("__mask__", torch.gather(m, 1, top))
        return out
