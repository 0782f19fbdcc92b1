"""``paddle_tpu/layers/attention.py`` on the port: the attention layers of
the DSL (``PositionEmbeddingLayer``, ``BahdanauAttentionLayer``,
``MultiHeadAttentionLayer``) and the KV-slot and paged-KV inner loop of
the decoders (models/transformer.py).

``MultiHeadAttentionLayer`` keeps its projections as ``torch.matmul`` (the
JAX package leaves them to XLA) and runs the attention itself through
``flash_attention``: the CUDA forward and backward kernels on the card,
the plain version on the CPU, or the plain version anywhere when the
``attention_impl`` option is ``"torch"``.  Padded batches ride the kernels
through per-sample ``kv_lens`` derived from the key mask.  Ring attention
(``context_parallel=True``) is not ported yet and raises.

KV slots: per-layer caches ``[max_slots, max_len, heads, dh]``, one slot per
resident sequence.  Paged KV: one pool ``[num_blocks, block_size, heads,
dh]`` per layer and a block-table row per sequence; block 0 is the scratch
sink that pad and hole rows write to.

Where JAX donates the cache buffers and returns fresh arrays, these
functions write the caches IN PLACE (``index_put_``) and return them, so no
step ever holds two copies of a pool.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core import config as cfg
from paddle_tpu_torch.core.ir import ParamSpec
from paddle_tpu_torch.core.registry import register_layer
from paddle_tpu_torch.layers.sequence import SeqLayerDef
from paddle_tpu_torch.ops.bahdanau import bahdanau_step
from paddle_tpu_torch.ops.flash_attention import flash_attention


def slot_kv_append(ck, cv, k, v, pos):
    """Write one new K/V row per slot, each at its own position, in
    place.  ``ck``/``cv``: ``[S, T, heads, dh]``; ``k``/``v``: ``[S, heads,
    dh]``; ``pos``: ``[S]`` - slot ``i``'s row lands at ``ck[i, pos[i]]``."""
    rows = torch.arange(ck.shape[0], device=ck.device)
    pos = pos.long()
    ck[rows, pos] = k
    cv[rows, pos] = v
    return ck, cv


def slot_decode_attention(q, ck, cv, pos, scale):
    """Single-query attention per slot against its cache prefix.  ``q``:
    ``[S, heads, dh]``; ``ck``/``cv``: ``[S, T, heads, dh]``; ``pos``:
    ``[S]`` - slot ``i`` attends cache positions ``<= pos[i]`` (stale rows
    of a previous occupant are masked).  Returns ``[S, heads, dh]``."""
    s = torch.einsum("shd,skhd->shk", q, ck) * scale
    kpos = torch.arange(ck.shape[1], device=ck.device)[None, None, :]
    s = s.masked_fill(kpos > pos[:, None, None], float("-inf"))
    att = torch.softmax(s, dim=-1)
    return torch.einsum("shk,skhd->shd", att, cv)


def paged_kv_scatter(pk, pv, k, v, block_ids, offsets):
    """Scatter one new K/V row per entry into the pool, in place.
    ``pk``/``pv``: ``[NB, BS, heads, dh]``; ``k``/``v``: ``[n, heads,
    dh]``; row ``i`` lands at ``pk[block_ids[i], offsets[i]]``.  Pad rows
    route to scratch block 0, offset 0; duplicate scratch writes are
    unordered but never read by a live sequence."""
    idx = (block_ids.long(), offsets.long())
    pk.index_put_(idx, k)
    pv.index_put_(idx, v)
    return pk, pv


def paged_gather(pool, table, t_max):
    """One sequence's logical K (or V) view out of the pool: ``table``
    ``[MB]`` (or ``[S, MB]``) block ids -> ``[(S,) t_max, heads, dh]``."""
    g = pool[table.long()]                    # [(S,) MB, BS, heads, dh]
    g = g.reshape(*g.shape[:-4], -1, *g.shape[-2:])
    return g[..., :t_max, :, :]


def paged_chunk_attention(q, ck, cv, q_offset: int, scale, *, impl=None):
    """Causal attention of one prefill CHUNK against its sequence's
    gathered cache (which already holds the chunk's own rows).  ``q``:
    ``[c, heads, dh]``; ``ck``/``cv``: ``[T, heads, dh]``; query ``j`` sits
    at position ``q_offset + j`` and attends ``kpos <= q_offset + j``.
    ``q_offset`` is the chunk start as a host int (the JAX version takes
    the positions array; here the kernel gets the int with no device
    sync).  Returns ``[c, heads, dh]``."""
    out = flash_attention(q[None], ck[None], cv[None], causal=True,
                          scale=scale, q_offset=int(q_offset), impl=impl)
    return out[0]


@register_layer
class PositionEmbeddingLayer(SeqLayerDef):
    """Learnable absolute position embeddings broadcast over the batch.
    Input: any sequence [B, T, D]; output [B, T, size] (size defaults to
    D).  The table covers max_len rows; T must not exceed it."""

    kind = "position_embedding"
    out_is_seq = True

    def infer_shape(self, attrs, in_shapes):
        t, d = in_shapes[0][0], in_shapes[0][-1]
        return (t, attrs.get("size") or d)

    def param_specs(self, attrs, in_shapes):
        size = attrs.get("size") or in_shapes[0][-1]
        return [ParamSpec("w", (attrs["max_len"], size), "normal")]

    def apply_seq(self, attrs, params, inputs, masks, ctx):
        x = inputs[0]
        t = x.shape[1]
        if t > params["w"].shape[0]:
            raise ValueError(
                f"sequence length {t} exceeds position_embedding "
                f"max_len {params['w'].shape[0]}")
        pos = params["w"][:t]
        return pos[None].expand((x.shape[0],) + tuple(pos.shape))


@register_layer
class BahdanauAttentionLayer(SeqLayerDef):
    """Fused additive-attention step: inputs [enc_seq, enc_proj_seq,
    decoder_state] -> context [B, De], one layer in place of the
    simple_attention composite inside a recurrent group; its backward
    recomputes the [B, Te, H] tanh row (ops/bahdanau.py)."""

    kind = "bahdanau_attention"
    out_is_seq = False

    def infer_shape(self, attrs, in_shapes):
        return (in_shapes[0][-1],)

    def param_specs(self, attrs, in_shapes):
        return [ParamSpec("w_dp", (in_shapes[2][-1], in_shapes[1][-1]),
                          "xavier"),
                ParamSpec("v", (in_shapes[1][-1],), "xavier")]

    def apply_seq(self, attrs, params, inputs, masks, ctx):
        enc, enc_proj, state = inputs
        mask = masks[0]
        if mask is None:
            mask = torch.ones(enc.shape[:2], device=enc.device)
        return bahdanau_step(enc, enc_proj, state, params["w_dp"],
                             params["v"], mask)


@register_layer
class MultiHeadAttentionLayer(SeqLayerDef):
    """inputs: [query_seq, key_seq, value_seq] (self-attention passes the
    same layer thrice).  attrs: size (output width), num_heads, causal."""

    kind = "multi_head_attention"
    out_is_seq = True

    def infer_shape(self, attrs, in_shapes):
        return (in_shapes[0][0], attrs["size"])

    def param_specs(self, attrs, in_shapes):
        size = attrs["size"]
        heads = attrs["num_heads"]
        if size % heads:
            raise ValueError(f"attention size {size} not divisible by "
                             f"num_heads {heads}")
        return [
            ParamSpec("wq", (in_shapes[0][-1], size), "xavier"),
            ParamSpec("wk", (in_shapes[1][-1], size), "xavier"),
            ParamSpec("wv", (in_shapes[2][-1], size), "xavier"),
            ParamSpec("wo", (size, size), "xavier"),
        ]

    def apply_seq(self, attrs, params, inputs, masks, ctx):
        if attrs.get("context_parallel", False):
            raise NotImplementedError(
                "context_parallel attention (ring attention over a device "
                "mesh) is not ported to paddle_tpu_torch yet")
        q_in, k_in, v_in = inputs
        kv_mask = masks[1]
        heads = attrs["num_heads"]
        size = attrs["size"]
        dh = size // heads
        b, lq = q_in.shape[0], q_in.shape[1]
        lk = k_in.shape[1]
        q = (q_in @ params["wq"]).reshape(b, lq, heads, dh)
        k = (k_in @ params["wk"]).reshape(b, lk, heads, dh)
        v = (v_in @ params["wv"]).reshape(b, lk, heads, dh)
        # prefix masks (the only kind Topology builds, from @len) reduce
        # to per-sample KV lengths
        kv_lens = (kv_mask.sum(dim=-1).to(torch.int32)
                   if kv_mask is not None else None)
        out = flash_attention(q, k, v, causal=attrs.get("causal", False),
                              kv_lens=kv_lens,
                              impl=cfg.get_option("attention_impl"))
        return out.reshape(b, lq, size) @ params["wo"]
