"""Sequence layers on padded batches with masks (counterpart of
``paddle_tpu/layers/sequence.py``).

Sequences are padded to a length T and every sequence tensor [B, T, ...]
travels with a validity mask [B, T] (1.0 = real step), built from the
``<name>@len`` feed and propagated parent to child by ``Topology``; a
statically full sequence (no ``@len``) carries ``None``.  A layer whose
output follows another input's steps names it with ``mask_from()``
(``expand``, ``seq_scale``); one that makes new steps (``seq_concat``,
``seq_reshape``, ``seq_slice``) writes its mask with
``ctx.set_state("__mask__", ...)``, which ``Topology`` takes as the
output's mask and keeps out of the running state.  Sequence pooling
consumes the mask and emits a plain [B, ...] tensor.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.ir import ParamSpec
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


def _full_mask(x):
    return torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)


@register_layer
class SequencePoolLayer(SeqLayerDef):
    """pool over time: max / avg / sum / sqrt_avg (reference:
    SequencePoolLayer); any other name averages, as in the JAX package."""

    kind = "seq_pool"
    out_is_seq = False

    def infer_shape(self, attrs, in_shapes):
        return tuple(in_shapes[0][1:])       # drop T

    def apply_seq(self, attrs, params, inputs, masks, ctx):
        x, mask = inputs[0], masks[0]
        ptype = attrs.get("pool_type", "max")
        if mask is None:
            mask = torch.ones(x.shape[:2], dtype=x.dtype, device=x.device)
        m = _expand_mask(mask, x)
        if ptype == "max":
            neg = torch.full((), torch.finfo(x.dtype).min, dtype=x.dtype,
                             device=x.device)
            return torch.amax(torch.where(m > 0, x, neg), dim=1)
        s = torch.sum(x * m, dim=1)
        if ptype == "sum":
            return s
        n = torch.clamp(torch.sum(mask, dim=1), min=1.0)
        n = n.reshape((-1,) + (1,) * (s.ndim - 1))
        if ptype == "sqrt_avg":
            return s / torch.sqrt(n)
        return s / n                          # avg


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


@register_layer
class ExpandLayer(SeqLayerDef):
    """broadcast a per-sample vector across the steps of a reference
    sequence (reference: ExpandLayer.cpp); the mask is the reference's."""

    kind = "expand"
    out_is_seq = True

    def infer_shape(self, attrs, in_shapes):
        # inputs: [vec_shape, (T,) + ref_shape] -> (T,) + vec_shape
        return (in_shapes[1][0],) + tuple(in_shapes[0])

    def mask_from(self):
        return 1                              # the mask follows input 2

    def apply_seq(self, attrs, params, inputs, masks, ctx):
        vec, ref = inputs
        t = ref.shape[1]
        return vec[:, None].expand((vec.shape[0], t) + tuple(vec.shape[1:]))


@register_layer
class SeqConcatLayer(SeqLayerDef):
    """concatenate two sequences in time (reference: SequenceConcatLayer),
    b's steps written after a's real length so the result is a
    left-aligned padded batch again."""

    kind = "seq_concat"
    out_is_seq = True

    def infer_shape(self, attrs, in_shapes):
        a, b = in_shapes
        t = (a[0] + b[0]) if (a[0] is not None and b[0] is not None) \
            else None
        return (t,) + tuple(a[1:])

    def apply_seq(self, attrs, params, inputs, masks, ctx):
        a, b = inputs
        ma = masks[0] if masks[0] is not None else _full_mask(a)
        mb = masks[1] if masks[1] is not None else _full_mask(b)
        bsz, ta = a.shape[:2]
        tb = b.shape[1]
        len_a = torch.sum(ma, dim=1).long()
        # out[i, len_a[i] + j] = b[i, j]
        out = torch.cat([a, a.new_zeros((bsz, tb) + tuple(a.shape[2:]))],
                        dim=1)
        pos = torch.arange(tb, device=a.device)[None, :] + len_a[:, None]
        bidx = torch.arange(bsz, device=a.device)[:, None].expand(bsz, tb)
        out = out.index_put((bidx, pos), b * _expand_mask(mb, b).to(b.dtype))
        new_len = len_a + torch.sum(mb, dim=1).long()
        new_mask = (torch.arange(ta + tb, device=a.device)[None, :]
                    < new_len[:, None])
        ctx.set_state("__mask__", new_mask.float())
        return out


@register_layer
class SeqReshapeLayer(SeqLayerDef):
    """reshape (T, D) -> (T * D / new_dim, new_dim) (reference:
    SequenceReshapeLayer)."""

    kind = "seq_reshape"
    out_is_seq = True

    def infer_shape(self, attrs, in_shapes):
        t, d = in_shapes[0]
        nd = attrs["reshape_size"]
        return (t * d // nd if t is not None else None, nd)

    def apply_seq(self, attrs, params, inputs, masks, ctx):
        x, mask = inputs[0], masks[0]
        b, t, d = x.shape
        nd = attrs["reshape_size"]
        out = x.reshape(b, -1, nd)
        if mask is not None:
            # a length-L sequence of width d becomes ceil(L * d / nd) steps
            new_len = torch.ceil(torch.sum(mask, dim=1) * d / nd).long()
            ctx.set_state("__mask__", (
                torch.arange(out.shape[1], device=x.device)[None, :]
                < new_len[:, None]).float())
        return out


@register_layer
class ContextProjectionLayer(SeqLayerDef):
    """sliding-window concat of neighbouring steps (reference:
    ContextProjectionOp).  attrs: context_len, context_start (negative =
    look-back), trainable_padding (a learnt pad row for each step read
    outside the sequence)."""

    kind = "context_projection"
    out_is_seq = True

    def infer_shape(self, attrs, in_shapes):
        t, d = in_shapes[0]
        return (t, d * attrs["context_len"])

    @staticmethod
    def _pads(attrs):
        clen = attrs["context_len"]
        cstart = attrs.get("context_start", -(clen // 2))
        begin_pad = max(0, -cstart)
        end_pad = max(0, cstart + clen - 1)
        return cstart, begin_pad, end_pad

    def param_specs(self, attrs, in_shapes):
        if attrs.get("trainable_padding", False):
            d = in_shapes[0][-1]
            _, begin_pad, end_pad = self._pads(attrs)
            if begin_pad + end_pad:
                return [ParamSpec("pad", (begin_pad + end_pad, d), "zeros")]
        return []

    def apply_seq(self, attrs, params, inputs, masks, ctx):
        x = inputs[0]                          # (B, T, D)
        clen = attrs["context_len"]
        cstart, begin_pad, _ = self._pads(attrs)
        b, t, d = x.shape
        cols = []
        for k in range(clen):
            off = cstart + k
            if off < 0:
                # out position p < -off reads the begin-pad row
                # p + off + begin_pad
                if "pad" in params:
                    pad = params["pad"][begin_pad + off:begin_pad][None] \
                        .expand(b, -off, d).to(x.dtype)
                else:
                    pad = x.new_zeros((b, -off, d))
                col = torch.cat([pad, x[:, :t + off]], dim=1)
            elif off > 0:
                # out position p >= T - off reads the end-pad row
                # begin_pad + (p + off - T)
                if "pad" in params:
                    pad = params["pad"][begin_pad:begin_pad + off][None] \
                        .expand(b, off, d).to(x.dtype)
                else:
                    pad = x.new_zeros((b, off, d))
                col = torch.cat([x[:, off:], pad], dim=1)
            else:
                col = x
            cols.append(col)
        return torch.cat(cols, dim=-1)


@register_layer
class SeqSoftmaxLayer(SeqLayerDef):
    """softmax over the time axis under the mask (reference:
    SequenceSoftmax)."""

    kind = "seq_softmax"
    out_is_seq = True

    def infer_shape(self, attrs, in_shapes):
        return in_shapes[0]

    def apply_seq(self, attrs, params, inputs, masks, ctx):
        x, mask = inputs[0], masks[0]
        squeeze = x.ndim == 3 and x.shape[-1] == 1
        xs = x[..., 0] if squeeze else x
        if mask is not None:
            xs = torch.where(_expand_mask(mask, xs) > 0, xs,
                             torch.full((), -1e30, dtype=xs.dtype,
                                        device=xs.device))
        p = torch.softmax(xs, dim=1)
        if mask is not None:
            p = p * _expand_mask(mask, p)
        return p[..., None] if squeeze else p


@register_layer
class KmaxSeqScoreLayer(SeqLayerDef):
    """the top-k steps' indices by score (reference: KmaxSeqScoreLayer)."""

    kind = "kmax_seq_score"
    out_is_seq = False

    def infer_shape(self, attrs, in_shapes):
        return (attrs["beam_size"],)

    def apply_seq(self, attrs, params, inputs, masks, ctx):
        x, mask = inputs[0], masks[0]
        scores = x[..., 0] if x.ndim == 3 else x
        if mask is not None:
            scores = torch.where(mask > 0, scores,
                                 torch.full((), -torch.inf,
                                            dtype=scores.dtype,
                                            device=scores.device))
        # lax.top_k: descending, ties to the lower index
        idx = torch.argsort(-scores.detach(), dim=1, stable=True)
        return idx[:, :attrs["beam_size"]].to(torch.int32)


@register_layer
class SeqScaleLayer(SeqLayerDef):
    """per-step scalar weights x sequence vectors (the attention helper);
    inputs: weights [B, T, 1] (or [B, T]), seq [B, T, D]."""

    kind = "seq_scale"
    out_is_seq = True

    def infer_shape(self, attrs, in_shapes):
        return in_shapes[1]

    def mask_from(self):
        return 1

    def apply_seq(self, attrs, params, inputs, masks, ctx):
        w, x = inputs
        if w.ndim == 2:
            w = w[..., None]
        return w * x


@register_layer
class SeqDotLayer(SeqLayerDef):
    """per-step dot product of two sequences -> [B, T, 1] scores."""

    kind = "seq_dot"
    out_is_seq = True

    def infer_shape(self, attrs, in_shapes):
        return (in_shapes[0][0], 1)

    def apply_seq(self, attrs, params, inputs, masks, ctx):
        a, b = inputs
        return torch.sum(a * b, dim=-1, keepdim=True)


@register_layer
class SeqSliceLayer(SeqLayerDef):
    """a fixed window of steps [start, end) (static offsets, as in the JAX
    package)."""

    kind = "seq_slice"
    out_is_seq = True

    def infer_shape(self, attrs, in_shapes):
        s = list(in_shapes[0])
        s[0] = attrs["end"] - attrs["start"]
        return tuple(s)

    def apply_seq(self, attrs, params, inputs, masks, ctx):
        if masks[0] is not None:
            ctx.set_state("__mask__",
                          masks[0][:, attrs["start"]:attrs["end"]])
        return inputs[0][:, attrs["start"]:attrs["end"]]
