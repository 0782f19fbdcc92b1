"""Decoder-only transformer LM (counterpart of
``paddle_tpu/models/transformer.py``): ``build``, the training graph in the
layer DSL, and the serving half.

``TransformerLM`` holds the parameter tree under the JAX package's names and
``[in, out]`` weight layout (``tok_emb.w``, ``pos_emb.w``,
``attn_i.{wq,wk,wv,wo}``, ``ln1_i``/``ln2_i``/``ln_f.{scale,bias}``,
``ffn_up{i}``/``ffn_down{i}.{w0,b}``, ``logits.{w0,b}``), so checkpoints
carry across with no transposes, and the per-position math every cached
decode path shares (``_tree_ops`` there).

``SlotDecoder`` (whole-sequence KV slabs) and ``PagedDecoder`` (one block
pool, mixed prefill/decode iterations, prefix cache, copy-on-write) are the
decode surfaces the serving engine schedules.  Decode attention goes through
``ops/paged_attention.py`` and prefill chunks through
``ops/flash_attention.py``: the CUDA kernels on the card, their plain
versions on the CPU, or the plain versions anywhere with
``decode_kernel="torch"``.  The dense projections stay ``torch.matmul``.

Shapes pad to ``step_buckets`` / ``prefill_buckets`` as in the JAX
decoders, so the two agree step for step and a later CUDA-graph capture
has fixed shapes.  Decoders run in float32, as the JAX ones do.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from paddle_tpu_torch import data_type, layer
from paddle_tpu_torch.core.config import resolve_device
from paddle_tpu_torch.layers.attention import (paged_chunk_attention,
                                               paged_gather,
                                               paged_kv_scatter,
                                               slot_kv_append)
from paddle_tpu_torch.ops.paged_attention import paged_decode_attention
from paddle_tpu_torch.serving.blocks import BlockAllocator, chain_hash

DECODE_KERNELS = ("auto", "torch")


def build(vocab_size: int = 1000, max_len: int = 128, dim: int = 128,
          num_heads: int = 4, num_layers: int = 2, ffn_mult: int = 4,
          context_parallel: bool = False, fused_head: bool = False):
    """Next-token LM, pre-LN blocks over ``multi_head_attention``: the same
    graph, names and JSON as the JAX package's ``build``.  Feeds: tokens
    [B,T] (+ tokens@len), targets [B,T].  Returns (cost, logits_seq).

    ``fused_head``: the chunked-CE head (``lm_head_cost``,
    ``ops/chunked_ce.py``), which keeps no [T, vocab] logits for the
    backward.  The cost layer owns the head's weights under the name
    ``logits`` (fc naming), so the decoders and checkpoints find them as
    in the unfused graph; ``logits_view``, an fc sharing them, is the
    logits output.  ``context_parallel`` (ring attention) is not ported
    yet and raises."""
    if context_parallel:
        raise NotImplementedError(
            "context_parallel (ring attention) is not ported to "
            "paddle_tpu_torch yet")
    seq = data_type.integer_value_sequence
    tokens = layer.data("tokens", seq(vocab_size, max_len=max_len))
    targets = layer.data("targets", seq(vocab_size, max_len=max_len))

    x = layer.embedding(tokens, size=dim, name="tok_emb")
    pos = layer.position_embedding(x, max_len=max_len, name="pos_emb")
    x = layer.addto([x, pos], act=None, name="h0")

    for i in range(num_layers):
        ln1 = layer.layer_norm(x, name=f"ln1_{i}")
        att = layer.multi_head_attention(
            ln1, size=dim, num_heads=num_heads, causal=True,
            context_parallel=context_parallel, name=f"attn_{i}")
        x = layer.addto([x, att], act=None, name=f"res_a{i}")
        ln2 = layer.layer_norm(x, name=f"ln2_{i}")
        ffn = layer.fc(layer.fc(ln2, size=dim * ffn_mult, act="gelu",
                                name=f"ffn_up{i}"),
                       size=dim, act=None, name=f"ffn_down{i}")
        x = layer.addto([x, ffn], act=None, name=f"res_f{i}")

    x = layer.layer_norm(x, name="ln_f")
    if fused_head:
        cost = layer.lm_head_cost(x, targets, vocab_size, name="logits")
        logits = layer.fc(x, size=vocab_size, act=None,
                          name="logits_view", share_from="logits")
        return cost, logits
    logits = layer.fc(x, size=vocab_size, act=None, name="logits")
    cost = layer.classification_cost(logits, targets, name="cost")
    return cost, logits


class TransformerLM(nn.Module):
    """The LM's parameter tree plus its per-position math.  ``values``:
    ``{layer: {param: tensor}}`` under the JAX names; dims are read from
    the shapes, as ``_decode_dims`` does."""

    def __init__(self, values: dict, *, num_heads: int, eps: float = 1e-5):
        super().__init__()
        self.p = nn.ModuleDict({
            layer: nn.ParameterDict({
                name: nn.Parameter(t, requires_grad=False)
                for name, t in params.items()})
            for layer, params in values.items()})
        self.n_layers = sum(1 for k in values if k.startswith("attn_"))
        self.dim = int(values["attn_0"]["wq"].shape[0])
        self.max_len = int(values["pos_emb"]["w"].shape[0])
        self.vocab = int(values["tok_emb"]["w"].shape[0])
        if num_heads < 1 or self.dim % num_heads:
            raise ValueError(f"num_heads={num_heads} does not divide "
                             f"dim {self.dim}")
        self.num_heads = int(num_heads)
        self.head_dim = self.dim // self.num_heads
        self.eps = float(eps)

    def ln(self, x, layer: str):
        """LayerNorm with population variance, ``rsqrt(v + eps)``, float32."""
        p = self.p[layer]
        xf = x.float()
        m = xf.mean(dim=-1, keepdim=True)
        v = xf.var(dim=-1, keepdim=True, unbiased=False)
        return ((xf - m) * torch.rsqrt(v + self.eps) * p["scale"]
                + p["bias"]).to(x.dtype)

    def ffn(self, x, i: int):
        # jax.nn.gelu defaults to the tanh approximation
        up, down = self.p[f"ffn_up{i}"], self.p[f"ffn_down{i}"]
        h = F.gelu(x @ up["w0"] + up["b"], approximate="tanh")
        return h @ down["w0"] + down["b"]

    def logits(self, h):
        p = self.p["logits"]
        return self.ln(h, "ln_f") @ p["w0"] + p["b"]

    def embed(self, tokens, pos):
        return self.p["tok_emb"]["w"][tokens] + self.p["pos_emb"]["w"][pos]

    def qkv(self, h, i: int):
        """Per-head q, k, v ``[rows, heads, dh]`` of layer ``i``."""
        a = self.p[f"attn_{i}"]
        shape = (h.shape[0], self.num_heads, self.head_dim)
        return ((h @ a["wq"]).reshape(shape), (h @ a["wk"]).reshape(shape),
                (h @ a["wv"]).reshape(shape))

    def attn_out(self, att, i: int):
        return att.reshape(att.shape[0], self.dim) @ self.p[f"attn_{i}"]["wo"]


def params_from_jax(values, *, num_heads: int,
                    eps: float = 1e-5) -> TransformerLM:
    """A float32 ``TransformerLM`` from a parameter tree: a JAX one
    (``{layer: {param: array}}``, e.g. ``Parameters.values`` or a
    checkpoint's ``trainable``), copied onto the CPU, or the port's own
    ``Parameters`` (e.g. after ``trainer.SGD.train``), whose tensors are
    shared where they lie, with no copy."""
    from paddle_tpu_torch.parameters import Parameters

    if isinstance(values, Parameters):
        values = {lname: {name: t.detach() for name, t in params.items()}
                  for lname, params in values.values.items()}
    tree = {}
    for lname, params in values.items():
        if not isinstance(params, dict):
            raise ValueError(f"{lname!r}: expected a dict of parameters")
        tree[lname] = {name: (arr.float() if torch.is_tensor(arr)
                              else torch.from_numpy(np.array(
                                  arr, dtype=np.float32, copy=True)))
                       for name, arr in params.items()}
    for need in ("tok_emb", "pos_emb", "attn_0", "ln_f", "logits"):
        if need not in tree:
            raise ValueError(f"not a transformer LM parameter tree: no "
                             f"{need!r} (has {sorted(tree)[:8]})")
    return TransformerLM(tree, num_heads=num_heads, eps=eps)


def _pow2_buckets(lo: int, hi: int) -> tuple:
    out = []
    b = lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return tuple(sorted(set(out)))


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"{n} exceeds the largest bucket {buckets[-1]}")


class SlotDecoder:
    """KV-slot decode surface: per-layer caches ``[max_slots, max_len,
    heads, dh]``, one slot per resident sequence.

      * ``prefill(slot, prompt)``: one causal forward over the prompt
        (padded to ``prefill_buckets``) writes the slot's cache rows and
        returns the first generated token;
      * ``step(n, tokens, pos)``: one decode iteration over slots
        ``[0, n)`` (padded to ``step_buckets``): each slot appends K/V at
        its own position and attends its own prefix through the paged
        decode kernel with an identity table.

    ``decode_kernel``: ``"auto"`` (the CUDA kernels on the card, their
    plain versions on the CPU) or ``"torch"`` (the plain versions on any
    device: the reference the kernels are held against).  ``last_logits`` holds the logits of the
    last call's rows.  Single-threaded: only the engine's batcher thread
    (or one test thread) may call the decode verbs."""

    paged = False

    def __init__(self, model: TransformerLM, *, max_slots: int = 8,
                 step_buckets=None, prefill_buckets=None,
                 decode_kernel: str = "auto", device=None):
        if decode_kernel not in DECODE_KERNELS:
            raise ValueError(f"decode_kernel must be one of "
                             f"{DECODE_KERNELS}, got {decode_kernel!r}")
        self.device = resolve_device(device)
        self.decode_kernel = decode_kernel
        self._impl = "torch" if decode_kernel == "torch" else None
        self.model = model.to(self.device)
        t_max = model.max_len
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.max_slots = int(max_slots)
        self.max_len = t_max
        self.scale = 1.0 / math.sqrt(model.head_dim)
        self.step_buckets = tuple(sorted(set(
            int(b) for b in (step_buckets
                             or _pow2_buckets(min(2, max_slots),
                                              max_slots)))))
        if self.step_buckets[-1] < self.max_slots:
            self.step_buckets += (self.max_slots,)
        if self.step_buckets[0] < 1 or \
                self.step_buckets[-1] > self.max_slots:
            raise ValueError(f"bad step_buckets {self.step_buckets} "
                             f"for max_slots {self.max_slots}")
        self.prefill_buckets = tuple(sorted(set(
            int(b) for b in (prefill_buckets
                             or _pow2_buckets(min(8, t_max), t_max)))))
        if self.prefill_buckets[-1] > t_max:
            raise ValueError(
                f"prefill bucket {self.prefill_buckets[-1]} exceeds "
                f"max_len {t_max}")
        self.last_logits = None
        self._caches = self._fresh_caches()

    def _fresh_caches(self):
        m = self.model
        shape = (self.max_slots, self.max_len, m.num_heads, m.head_dim)
        return [(torch.zeros(shape, device=self.device),
                 torch.zeros(shape, device=self.device))
                for _ in range(m.n_layers)]

    def reset(self) -> None:
        """Re-zero the caches (after a fault every slot's state is lost)."""
        self._caches = self._fresh_caches()

    def _ints(self, a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.device)

    @torch.no_grad()
    def prefill(self, slot: int, prompt) -> int:
        """Write ``prompt``'s K/V into ``slot``'s cache rows and return the
        first generated token.  ``prompt``: 1-D ints, ``1 <= len <
        max_len``."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        plen = len(prompt)
        if not 0 < plen < self.max_len:
            raise ValueError(f"prompt length {plen} outside "
                             f"[1, {self.max_len})")
        pb = _bucket(plen, self.prefill_buckets)
        padded = np.zeros(pb, np.int32)
        padded[:plen] = prompt
        m = self.model
        kpos = torch.arange(pb, device=self.device)
        x = m.embed(self._ints(padded).long(), kpos)            # [pb, dim]
        # causal AND real-prefix: pad tokens must not leak into any real
        # position's attention
        mask = (kpos[None, :] <= kpos[:, None]) & (kpos[None, :] < plen)
        slot = max(0, int(slot))
        for i in range(m.n_layers):
            q, k, v = m.qkv(m.ln(x, f"ln1_{i}"), i)             # [pb, H, dh]
            s = torch.einsum("qhd,khd->hqk", q, k) * self.scale
            s = s.masked_fill(~mask, float("-inf"))
            att = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)
            ck, cv = self._caches[i]
            ck[slot, :pb] = k
            cv[slot, :pb] = v
            x = x + m.attn_out(att, i)
            x = x + m.ffn(m.ln(x, f"ln2_{i}"), i)
        lg = m.logits(x[plen - 1])
        self.last_logits = lg
        return int(torch.argmax(lg))

    @torch.no_grad()
    def step(self, n: int, tokens, pos):
        """One decode iteration over slots ``[0, n)``: ``tokens[i]`` is
        slot ``i``'s last token, ``pos[i]`` its write position.  Returns
        the next token per slot (``[n]`` int32); hole slots return
        garbage the caller ignores."""
        b = _bucket(n, self.step_buckets)
        tk = np.zeros(b, np.int32)
        ps = np.zeros(b, np.int32)
        tk[:n] = tokens
        ps[:n] = pos
        m = self.model
        ps_t = self._ints(ps)
        ident = self._ints(np.arange(b)[:, None])
        x = m.embed(self._ints(tk).long(), ps_t.long())          # [b, dim]
        for i in range(m.n_layers):
            q, k, v = m.qkv(m.ln(x, f"ln1_{i}"), i)
            ck, cv = self._caches[i]
            sck, scv = slot_kv_append(ck[:b], cv[:b], k, v, ps_t)
            att = paged_decode_attention(q, sck, scv, ident, ps_t,
                                         scale=self.scale,
                                         t_max=self.max_len,
                                         impl=self._impl)
            x = x + m.attn_out(att, i)
            x = x + m.ffn(m.ln(x, f"ln2_{i}"), i)
        lg = m.logits(x)
        self.last_logits = lg[:n]
        return torch.argmax(lg, dim=-1).to(torch.int32).cpu().numpy()[:n]


class PagedDecoder(SlotDecoder):
    """Paged-KV decode surface (PagedAttention, Kwon et al. 2023; Orca
    mixed iterations, Yu et al. 2022): ONE pool of ``[num_blocks,
    block_size, heads, dh]`` blocks per layer and a block-table row per
    slot.

      * allocation at block grain (``ensure_blocks``);
      * mixed iterations: ``mixed_step`` runs every resident's decode step
        AND at most one joining sequence's prefill chunk;
      * prefix caching: full prompt blocks register under chained content
        hashes (``serving/blocks.py``) and are then shared refcounted; a
        divergence mid-block copies exactly one block (copy-on-write).

    Block 0 is the scratch sink for pad and hole rows.  ``sampling=True``
    is not ported yet and raises ``NotImplementedError``.  Single-threaded,
    like ``SlotDecoder``."""

    paged = True

    def __init__(self, model: TransformerLM, *, max_slots: int = 8,
                 block_size: int = 16, num_blocks: int = None,
                 step_buckets=None, chunk_buckets=None,
                 sampling: bool = False, decode_kernel: str = "auto",
                 device=None):
        if sampling:
            raise NotImplementedError(
                "sampling is not ported yet: the greedy decoder is the "
                "only family (JAX's PRNG streams cannot be reproduced)")
        t_max = model.max_len
        self.block_size = int(block_size)
        if not 1 <= self.block_size <= t_max:
            raise ValueError(f"block_size must be in [1, {t_max}] "
                             f"(max_len), got {block_size}")
        self.blocks_per_seq = -(-t_max // self.block_size)
        nb = (int(num_blocks) if num_blocks is not None
              else 1 + int(max_slots) * self.blocks_per_seq)
        if nb < 2:
            raise ValueError(f"num_blocks must be >= 2 (block 0 is the "
                             f"reserved scratch sink), got {nb}")
        self.num_blocks = nb
        super().__init__(model, max_slots=max_slots,
                         step_buckets=step_buckets,
                         prefill_buckets=chunk_buckets,
                         decode_kernel=decode_kernel, device=device)
        self.blocks = BlockAllocator(self.num_blocks, self.block_size)
        self._table = np.zeros((self.max_slots, self.blocks_per_seq),
                               np.int32)
        self._seqs = {}

    @property
    def chunk_buckets(self):
        return self.prefill_buckets

    def _fresh_caches(self):
        m = self.model
        shape = (self.num_blocks, self.block_size, m.num_heads, m.head_dim)
        return [(torch.zeros(shape, device=self.device),
                 torch.zeros(shape, device=self.device))
                for _ in range(m.n_layers)]

    def reset(self) -> None:
        """Re-zero the pool and drop all host block state (allocator,
        tables, sequences, prefix cache)."""
        self._caches = self._fresh_caches()
        self.blocks = BlockAllocator(self.num_blocks, self.block_size)
        self._table = np.zeros((self.max_slots, self.blocks_per_seq),
                               np.int32)
        self._seqs = {}

    # ---------------------------------------------------- host block state
    def alloc_sequence(self, slot: int, prompt) -> int:
        """Admit one sequence into ``slot``: consult the prefix cache over
        the prompt's full blocks, take refs on every hit, copy-on-write
        the divergence block when the match ends mid-block, arm the
        slot's table row.  Returns the prompt positions served from cache
        (capped at ``len(prompt) - 1``).  Raises ``KVPoolExhausted``
        (nothing held) when the copy cannot get a block."""
        prompt = np.ascontiguousarray(
            np.asarray(prompt, np.int32).reshape(-1))
        plen = len(prompt)
        if not 0 < plen < self.max_len:
            raise ValueError(f"prompt length {plen} outside "
                             f"[1, {self.max_len})")
        if slot in self._seqs:
            raise ValueError(f"slot {slot} already holds a sequence")
        bs = self.block_size
        hashes = []
        h = None
        for i in range(plen // bs):
            h = chain_hash(h, prompt[i * bs:(i + 1) * bs])
            hashes.append(h)
        hit_blocks = []
        for h in hashes:
            b = self.blocks.lookup(h)     # takes a ref on hit
            if b is None:
                break
            hit_blocks.append(b)
        matched = min(len(hit_blocks) * bs, plen - 1)
        nshared = -(-matched // bs) if matched else 0
        for b in hit_blocks[nshared:]:    # surplus full-block hits
            self.blocks.release(b)
        row = self._table[slot]
        row[:] = 0
        row[:nshared] = hit_blocks[:nshared]
        if matched % bs:
            # divergence mid-block: the writes starting at ``matched``
            # land in a SHARED block - copy it, point the row at the copy
            bm = matched // bs
            try:
                dst = self.blocks.alloc()
            except Exception:
                for i in range(nshared):
                    self.blocks.release(int(row[i]))
                row[:] = 0
                raise
            self._cow_copy(int(row[bm]), dst)
            self.blocks.release(int(row[bm]))
            row[bm] = dst
            self.blocks.cow_copies += 1
        self._seqs[slot] = {"hashes": hashes, "nblocks": nshared,
                            "plen": plen, "registered": False}
        return matched

    def ensure_blocks(self, slot: int, upto_pos: int) -> None:
        """Grow ``slot``'s table row to cover position ``upto_pos``.
        Raises ``KVPoolExhausted`` with the row untouched past what was
        already allocated."""
        st = self._seqs[slot]
        need = upto_pos // self.block_size + 1
        row = self._table[slot]
        while st["nblocks"] < need:
            row[st["nblocks"]] = self.blocks.alloc()
            st["nblocks"] += 1

    def register_prefix(self, slot: int) -> int:
        """Publish ``slot``'s written full prompt blocks into the prefix
        cache (once, after its prefill completed).  Returns how many
        blocks became newly shareable."""
        st = self._seqs.get(slot)
        if st is None or st["registered"]:
            return 0
        st["registered"] = True
        row = self._table[slot]
        n = 0
        for i, h in enumerate(st["hashes"]):
            if i >= st["nblocks"]:
                break
            n += self.blocks.register(h, int(row[i]))
        return n

    def release_sequence(self, slot: int) -> None:
        """Return ``slot``'s blocks (one deref each) and clear its table
        row.  Idempotent."""
        st = self._seqs.pop(slot, None)
        if st is None:
            return
        row = self._table[slot]
        for i in range(st["nblocks"]):
            self.blocks.release(int(row[i]))
        row[:] = 0

    def pool_stats(self) -> dict:
        return self.blocks.stats()

    @torch.no_grad()
    def _cow_copy(self, src: int, dst: int) -> None:
        for pk, pv in self._caches:
            pk[dst] = pk[src]
            pv[dst] = pv[src]

    # ------------------------------------------------------------ forward
    @torch.no_grad()
    def _mixed_forward(self, tk, ps, btab, chunk):
        """The fused iteration over ``b`` decode rows and an optional
        prefill chunk ``(ctok [c], ctab [MB], cstart, clen)``.  Writes the
        pool in place; returns (next tokens [b], chunk next token or
        None)."""
        m = self.model
        bs, mb, t_max = self.block_size, self.blocks_per_seq, self.max_len
        b = len(tk)
        rows = np.arange(b)
        ps_t, btab_t = self._ints(ps), self._ints(btab)
        sb_t = self._ints(btab[rows, ps // bs])
        so_t = self._ints(ps % bs)
        x = m.embed(self._ints(tk).long(), ps_t.long())         # [b, dim]
        if chunk is not None:
            ctok, ctab, cstart, clen = chunk
            c = len(ctok)
            cposj = cstart + np.arange(c)
            cvalid = np.arange(c) < clen
            cx = m.embed(self._ints(ctok).long(),
                         self._ints(np.clip(cposj, 0, t_max - 1)).long())
            cb_t = self._ints(np.where(
                cvalid, ctab[np.clip(cposj // bs, 0, mb - 1)], 0))
            co_t = self._ints(np.where(cvalid, cposj % bs, 0))
            ctab_t = self._ints(ctab)
        for i in range(m.n_layers):
            q, k, v = m.qkv(m.ln(x, f"ln1_{i}"), i)             # [b, H, dh]
            pk, pv = self._caches[i]
            paged_kv_scatter(pk, pv, k, v, sb_t, so_t)
            if chunk is not None:
                cq, ck, cv = m.qkv(m.ln(cx, f"ln1_{i}"), i)     # [c, H, dh]
                paged_kv_scatter(pk, pv, ck, cv, cb_t, co_t)
            att = paged_decode_attention(q, pk, pv, btab_t, ps_t,
                                         scale=self.scale, t_max=t_max,
                                         impl=self._impl)
            x = x + m.attn_out(att, i)
            x = x + m.ffn(m.ln(x, f"ln2_{i}"), i)
            if chunk is not None:
                catt = paged_chunk_attention(
                    cq, paged_gather(pk, ctab_t, t_max),
                    paged_gather(pv, ctab_t, t_max), cstart, self.scale,
                    impl=self._impl)
                cx = cx + m.attn_out(catt, i)
                cx = cx + m.ffn(m.ln(cx, f"ln2_{i}"), i)
        lg = m.logits(x)
        nxt = torch.argmax(lg, dim=-1).to(torch.int32).cpu().numpy()
        if chunk is None:
            self.last_logits = (lg, None)
            return nxt, None
        clg = m.logits(cx[clen - 1])
        self.last_logits = (lg, clg)
        return nxt, int(torch.argmax(clg))

    # ------------------------------------------------------------ surface
    def mixed_step(self, n: int, tokens, pos, live=None, chunk=None):
        """ONE mixed iteration: a decode step over slots ``[0, n)`` AND at
        most one prefill chunk.  ``live[i]`` marks slot ``i`` resident -
        non-live rows ride the scratch block.  ``chunk`` is ``None`` or
        ``(slot, chunk_tokens, start)`` with the slot's blocks already
        ensured through the chunk's last position.  Returns
        ``(next_tokens[:n], chunk_next)``; ``chunk_next`` is the token
        after the chunk's last position, or ``None``.  ``last_logits``
        then holds ``(decode-row logits [b, V], chunk logits [V] or
        None)``."""
        b = _bucket(max(n, 1), self.step_buckets)
        tk = np.zeros(b, np.int32)
        ps = np.zeros(b, np.int32)
        btab = np.zeros((b, self.blocks_per_seq), np.int32)
        if n:
            tk[:n] = np.asarray(tokens, np.int32)[:n]
            ps[:n] = np.asarray(pos, np.int32)[:n]
        for i in range(min(n, self.max_slots)):
            if (live[i] if live is not None else i in self._seqs):
                btab[i] = self._table[i]
        args = None
        if chunk is not None:
            slot, ctok, cstart = chunk
            ctok = np.asarray(ctok, np.int32).reshape(-1)
            clen = len(ctok)
            ct = np.zeros(_bucket(clen, self.prefill_buckets), np.int32)
            ct[:clen] = ctok
            args = (ct, self._table[slot].copy(), int(cstart), clen)
        nxt, cnxt = self._mixed_forward(tk, ps, btab, args)
        return nxt[:n], cnxt

    def prefill(self, slot: int, prompt) -> int:
        """Whole-prompt prefill: admit the sequence (prefix cache
        consulted), run its chunks through ``mixed_step`` with zero
        resident rows, publish its prompt blocks, return the first
        generated token."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        matched = self.alloc_sequence(slot, prompt)
        plen = len(prompt)
        cap = self.prefill_buckets[-1]
        written = matched
        first = None
        while written < plen:
            clen = min(plen - written, cap)
            self.ensure_blocks(slot, written + clen - 1)
            _, first = self.mixed_step(
                0, (), (), live=(),
                chunk=(slot, prompt[written:written + clen], written))
            written += clen
        self.register_prefix(slot)
        return int(first)

    def step(self, n: int, tokens, pos):
        """Decode iteration (no chunk): slots holding a live sequence get
        their blocks ensured and advance; holes ride the scratch block."""
        for i in range(n):
            if i in self._seqs:
                self.ensure_blocks(i, int(pos[i]))
        nxt, _ = self.mixed_step(n, tokens, pos)
        return nxt
