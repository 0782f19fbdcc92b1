"""The serving half of ``paddle_tpu/layers/attention.py``: the KV-slot and
paged-KV inner loop of the decoders (models/transformer.py).

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
