"""recurrent_group / memory / beam_search: a step network run over every
timestep, or expanded beam by beam to generate (counterpart of
``paddle_tpu/layers/rnn_group.py``).

As in the JAX package, the user's step function is called once, at graph
build time, on per-step placeholder data layers; what it returns is a
static sub-topology (``SubGraph``).  Where the JAX package runs that
sub-topology as the body of one ``lax.scan``, ``RecurrentGroupLayer`` runs
it eagerly once per timestep, under autograd: memories are float32
tensors carried from step to step, fed to their placeholders as they are
(no copy cuts the graph), and a pad step freezes both the memories and the
emitted output.  Static sequence inputs are fed whole every step, with
their ``@len`` from the outer masks.  The group's parameters are flat
``"<step layer>::<param>"`` names under the group's layer.

A ``SubsequenceInput`` scans a nested sequence [B, S, T, ...]: each outer
step feeds its inner sequence [B, T, ...] whole, with ``@len`` from the
data layer's ``@sublen`` feed (none: full), so the step may hold an inner
``recurrent_group``.  Step layers with running state (batch norm's moving
statistics) carry it from step to step, and the group writes the last
values back as its own state ``"<step layer>::<key>"``.  Under the
``rnn_group_remat`` option (or the group's ``remat`` attr) each step runs
under ``torch.utils.checkpoint``: the backward recomputes it from its
carries, bit for bit the plain group's values and gradients.

``beam_search`` generates: [B, beam, max_length] ids from a fixed-shape
beam search, the previous token's embedding fed back through a
``GeneratedInput`` (a table of its own, or a trained embedding named by
``embedding_name``), the vocab projection of a trained fc
(``output_layer``) applied in float32 inside the loop.  The candidates are
ranked by a stable descending sort, so equal scores keep the lower flat
index first, as ``jax.lax.top_k`` orders them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch.core import config as cfg
from paddle_tpu_torch.core.ir import LayerOutput, ParamSpec
from paddle_tpu_torch.core.registry import LayerDef, register_layer
from paddle_tpu_torch.layers.recurrent import _masked
from paddle_tpu_torch.layers.sequence import SeqLayerDef

# build-time context: memory() registers itself with the group being built
_BUILD_STACK: list = []

# a dead beam's or dropped candidate's score, as the JAX package uses it
_NEG_INF = -1e30


@dataclasses.dataclass
class _MemoryDecl:
    placeholder: LayerOutput      # data-kind node feeding the step graph
    ref_name: str                 # sub-layer whose output is the next state
    size: int
    boot: Optional[LayerOutput]   # outer layer providing the t=0 state


class StaticInput:
    """Read-only input visible unchanged at every step (reference:
    trainer_config_helpers/layers.py StaticInput)."""

    def __init__(self, input: LayerOutput, is_seq: bool = False):
        self.input = input
        self.is_seq = is_seq


class SubsequenceInput:
    """Marks a nested-sequence input of recurrent_group: the group scans
    its subsequences, and the step receives each one as a whole inner
    sequence (reference: RecurrentGradientMachine::createInFrameInfo_subseq,
    SubsequenceInput in trainer_config_helpers)."""

    def __init__(self, input: LayerOutput):
        self.input = input


class GeneratedInput:
    """Marks the generated-token input of beam_search: the embedding of
    the previous step's chosen word."""

    def __init__(self, size: int, embedding_name: Optional[str] = None,
                 embedding_size: int = 0):
        if embedding_size <= 0:
            raise ValueError(
                "GeneratedInput requires embedding_size > 0 (the width of "
                "the previous-token embedding fed back into the step)")
        self.size = size                      # vocabulary size
        self.embedding_name = embedding_name  # outer embedding layer to tie
        self.embedding_size = embedding_size


def memory(name: str, size: int, boot_layer: Optional[LayerOutput] = None):
    """Declare a recurrent state: the value of sub-layer ``name`` at t-1.
    Must be called inside a recurrent_group / beam_search step function
    (reference: trainer_config_helpers/layers.py memory())."""
    if not _BUILD_STACK:
        raise RuntimeError("memory() must be called inside a "
                           "recurrent_group/beam_search step function")
    ph = LayerOutput("data", [], {
        "shape": [size], "seq_type": 0, "max_len": None,
        "is_index": False, "dim": size}, size=size)
    _BUILD_STACK[-1].append(_MemoryDecl(ph, name, size, boot_layer))
    return ph


def _make_placeholder(size: int, is_seq: bool, is_index: bool = False):
    shape = [] if is_index else [size]
    return LayerOutput("data", [], {
        "shape": shape, "seq_type": 1 if is_seq else 0, "max_len": None,
        "is_index": is_index, "dim": size}, size=size)


class SubGraph:
    """The step sub-topology plus its wiring.

    Stored in the group LayerSpec's attrs; ``__call__`` exists only so the
    IR serializer renders it as the opaque marker ``<callable:SubGraph>``,
    as the JAX package's does."""

    def __init__(self, topo, out_names, seq_phs: List[str],
                 static_phs: List[str], static_seq: List[bool],
                 memories: List[_MemoryDecl], seq_sub=None):
        self.topo = topo
        self.out_names = list(out_names)
        self.out_name = self.out_names[0]
        self.seq_phs = seq_phs          # placeholder names fed per step
        self.static_phs = static_phs    # placeholder names fed every step
        self.static_seq = static_seq    # is each static input a sequence?
        # nested (subsequence) inputs, aligned with seq_phs
        self.seq_sub = list(seq_sub) if seq_sub else [False] * len(seq_phs)
        self.memories = memories

    __name__ = "SubGraph"

    def __call__(self):  # pragma: no cover - serialization marker only
        raise TypeError("SubGraph is not callable")

    def flat_param_specs(self):
        return [dataclasses.replace(p, name=f"{lname}::{p.name}")
                for lname, ps in self.topo.param_specs.items() for p in ps]

    @staticmethod
    def nest_params(flat: dict) -> dict:
        nested: dict = {}
        for key, val in flat.items():
            if "::" not in key:       # a layer-owned extra (gen_emb)
                continue
            lname, pname = key.split("::", 1)
            nested.setdefault(lname, {})[pname] = val
        return nested

    def state_slots(self):
        """[(layer, key)] of the step layers' running state (batch norm's
        moving statistics), which the group exposes flat as its own state
        ``"<layer>::<key>"``."""
        return [(l, p.name) for l, ps in self.topo.param_specs.items()
                for p in ps if p.is_state]

    def step_forward(self, nested_params, feed, ctx, state=None,
                     train=None):
        """One step of the sub-topology: ([outputs], [next memories],
        new state)."""
        refs = [m.ref_name for m in self.memories]
        outs, new_state = self.topo.forward(
            nested_params, state or {}, feed,
            train=ctx.train if train is None else train,
            outputs=list(dict.fromkeys(self.out_names + refs)),
            generator=ctx.generator, device=ctx.device)
        return ([outs[n] for n in self.out_names], [outs[r] for r in refs],
                new_state)


def _build_subgraph(step: Callable, inputs: Sequence, *, generating: bool):
    """Run the user's step function on placeholders; capture the
    sub-topology.  ``inputs`` entries: a LayerOutput (a sequence scanned
    step by step), a SubsequenceInput, a StaticInput, or a GeneratedInput
    (generation only).  Returns (SubGraph, parents, n_seq, n_static,
    GeneratedInput or None, step outputs)."""
    from paddle_tpu_torch.topology import Topology

    seq_parents, static_parents, static_seq, seq_sub = [], [], [], []
    phs, seq_ph_names, static_ph_names = [], [], []
    gen: Optional[GeneratedInput] = None
    for item in inputs:
        if isinstance(item, SubsequenceInput):
            if generating:
                raise ValueError(
                    "SubsequenceInput is not valid in beam_search")
            lo = item.input
            if lo.kind != "data" or lo.attrs.get("seq_type") != 2:
                raise ValueError(
                    f"SubsequenceInput must wrap a nested-sequence DATA "
                    f"layer (dense_vector_sub_sequence / "
                    f"integer_value_sub_sequence); got {lo.kind!r} "
                    f"{lo.name!r} - inner lengths (@sublen) are only "
                    f"tracked for data layers")
            ph = _make_placeholder(
                lo.size or 1, is_seq=True,
                is_index=bool(lo.attrs.get("is_index", False)))
            seq_parents.append(lo)
            seq_ph_names.append(ph.name)
            seq_sub.append(True)
        elif isinstance(item, GeneratedInput):
            if not generating:
                raise ValueError("GeneratedInput only valid in beam_search")
            if gen is not None:
                raise ValueError("only one GeneratedInput allowed")
            gen = item
            ph = _make_placeholder(item.embedding_size, is_seq=False)
            seq_ph_names.append(ph.name)     # fed each step's embeddings
        elif isinstance(item, StaticInput):
            ph = _make_placeholder(item.input.size or 1, is_seq=item.is_seq)
            static_parents.append(item.input)
            static_seq.append(item.is_seq)
            static_ph_names.append(ph.name)
        else:   # plain LayerOutput -> scanned sequence input
            ph = _make_placeholder(item.size or 1, is_seq=False)
            seq_parents.append(item)
            seq_ph_names.append(ph.name)
            seq_sub.append(False)
        phs.append(ph)

    _BUILD_STACK.append([])
    try:
        out = step(*phs) if len(phs) > 1 else step(phs[0])
    finally:
        mem_decls: List[_MemoryDecl] = _BUILD_STACK.pop()
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    if generating and len(outs) != 1:
        raise ValueError(
            "beam_search step must return a single output layer (the "
            "per-step vocab distribution)")

    sub_topo = Topology(outs, collect_evaluators=False)
    for m in mem_decls:
        if m.ref_name not in sub_topo._spec_by_name:
            raise ValueError(
                f"memory(name={m.ref_name!r}): no layer of that name is "
                f"reachable from the step outputs - the next-state layer "
                f"must be an ancestor of (or equal to) a returned layer")
    sub = SubGraph(sub_topo, [o.name for o in outs], seq_ph_names,
                   static_ph_names, static_seq, mem_decls, seq_sub=seq_sub)
    boot_parents = [m.boot for m in mem_decls if m.boot is not None]
    parents = seq_parents + static_parents + boot_parents
    return sub, parents, len(seq_parents), len(static_parents), gen, outs


def recurrent_group(step: Callable, input, reverse: bool = False,
                    name: Optional[str] = None):
    """Run ``step`` over every timestep of the sequence inputs.

    A step returning a tuple/list yields a LIST of sequence outputs, each
    a ``col_slice`` view of the group's concatenated per-step emission.
    reference: trainer_config_helpers/layers.py recurrent_group."""
    if not isinstance(input, (list, tuple)):
        input = [input]
    sub, parents, n_seq, n_static, _, outs = _build_subgraph(
        step, input, generating=False)
    if n_seq == 0:
        raise ValueError("recurrent_group needs at least one sequence input")
    multi = len(outs) > 1
    if multi:
        sizes = []
        for o in outs:
            shp = tuple(sub.topo.shapes[o.name])
            if len(shp) != 1:
                raise ValueError(
                    f"multi-output recurrent_group outputs must be "
                    f"per-step vectors; {o.name!r} has step shape {shp}")
            sizes.append(shp[0])
        total = sum(sizes)
    else:
        total = outs[0].size
    group = LayerOutput(
        "recurrent_group", parents,
        {"_sub": sub, "n_seq": n_seq, "n_static": n_static,
         "reverse": reverse},
        name=name, size=total)
    if not multi:
        return group
    views, lo = [], 0
    for i, s in enumerate(sizes):
        views.append(LayerOutput(
            "col_slice", [group], {"lo": lo, "hi": lo + s},
            name=f"{group.name}@out{i}", size=s))
        lo += s
    return views


def beam_search(step: Callable, input, bos_id: int, eos_id: int,
                beam_size: int = 1, max_length: int = 100,
                output_layer: Optional[str] = None,
                candidate_adjust: Optional[Callable] = None,
                drop_node: Optional[Callable] = None,
                name: Optional[str] = None) -> LayerOutput:
    """Beam-search generation over the step network.

    The step's output is a per-step distribution (softmax) over the
    vocabulary, or, with ``output_layer=<top-level fc name>``, the hidden
    state that fc projects: its trained weights, resolved by name, are
    applied inside the loop.  Returns int32 ids [B, beam_size,
    max_length]; the beams' log-prob scores are the running state
    ``"scores"`` under the layer's name.

    Hooks, torch callables: ``candidate_adjust(logp [B, k, V],
    prev_tokens [B, k], t) -> logp`` rewrites the step's log-probs before
    the expansion; ``drop_node(cand [B, k, V], prev_tokens [B, k], t) ->
    bool [B, k, V]`` drops the True candidates (a finished beam's eos
    continuation is never dropped).  reference: trainer_config_helpers/
    layers.py beam_search -> RecurrentGradientMachine::beamSearch."""
    if not isinstance(input, (list, tuple)):
        input = [input]
    sub, parents, n_seq, n_static, gen, _ = _build_subgraph(
        step, input, generating=True)
    if gen is None:
        raise ValueError("beam_search needs a GeneratedInput")
    if n_seq != 0:
        raise ValueError("beam_search takes exactly one GeneratedInput and "
                         "no plain sequence inputs")
    if not parents:
        raise ValueError(
            "beam_search needs at least one StaticInput or memory "
            "boot_layer - the batch size is taken from it; for "
            "unconditional generation pass a dummy StaticInput")
    attrs = {"_sub": sub, "n_seq": 0, "n_static": n_static,
             "bos_id": bos_id, "eos_id": eos_id, "beam_size": beam_size,
             "max_length": max_length, "vocab_size": gen.size,
             "embedding_name": gen.embedding_name,
             "embedding_size": gen.embedding_size,
             "output_layer": output_layer,
             "candidate_adjust": candidate_adjust,
             "drop_node": drop_node}
    return LayerOutput("beam_search", parents, attrs, name=name,
                       size=gen.size)


@register_layer
class ColSliceLayer(LayerDef):
    """Feature-column view [..., lo:hi]: the out_link extractor of
    multi-output recurrent groups."""

    kind = "col_slice"

    def infer_shape(self, attrs, in_shapes):
        return (attrs["hi"] - attrs["lo"],)

    def apply(self, attrs, params, inputs, ctx):
        return inputs[0][..., attrs["lo"]:attrs["hi"]]


def _seq_lens(val, m):
    """[B] int32 lengths of a static sequence input from its mask."""
    if m is not None:
        return m.sum(dim=1).to(torch.int32)
    return torch.full((val.shape[0],), val.shape[1], dtype=torch.int32,
                      device=val.device)


@register_layer
class RecurrentGroupLayer(SeqLayerDef):
    kind = "recurrent_group"
    out_is_seq = True

    def check_inputs(self, attrs, in_seq):
        if not all(in_seq[:attrs["n_seq"]]):
            raise ValueError(
                "recurrent_group scanned inputs must be sequences; wrap "
                "per-batch tensors in StaticInput(...) instead")

    def infer_shape(self, attrs, in_shapes):
        sub: SubGraph = attrs["_sub"]
        t = in_shapes[0][0]
        if len(sub.out_names) > 1:
            return (t, sum(sub.topo.shapes[n][0] for n in sub.out_names))
        return (t,) + tuple(sub.topo.shapes[sub.out_name])

    def param_specs(self, attrs, in_shapes):
        return attrs["_sub"].flat_param_specs()

    def apply_seq(self, attrs, params, inputs, masks, ctx):
        sub: SubGraph = attrs["_sub"]
        n_seq, n_static = attrs["n_seq"], attrs["n_static"]
        seq_vals = inputs[:n_seq]
        bsz, t_len = seq_vals[0].shape[0], seq_vals[0].shape[1]
        dev = seq_vals[0].device
        nested = sub.nest_params(params)

        static_feed = {}
        for ph, val, is_seq, m in zip(sub.static_phs,
                                      inputs[n_seq:n_seq + n_static],
                                      sub.static_seq,
                                      masks[n_seq:n_seq + n_static]):
            static_feed[ph] = val
            if is_seq:
                static_feed[ph + "@len"] = _seq_lens(val, m)

        boots = iter(inputs[n_seq + n_static:])
        # float32 carries, as the JAX package keeps them
        mems = [next(boots).float() if m.boot is not None
                else torch.zeros((bsz, m.size), device=dev)
                for m in sub.memories]
        if len(sub.out_names) > 1:
            y = torch.zeros((bsz, sum(sub.topo.shapes[n][0]
                                      for n in sub.out_names)), device=dev)
        else:
            y = torch.zeros((bsz,) + tuple(sub.topo.shapes[sub.out_name]),
                            device=dev)
        xs_t = [x.transpose(0, 1) for x in seq_vals]
        m_t = (masks[0].transpose(0, 1) if masks[0] is not None
               else torch.ones((t_len, bsz), device=dev))
        # nested inputs: each outer step's inner lengths, from the data
        # layer's @sublen feed; none means every inner sequence is full
        sublens_t = []
        for i, flag in enumerate(sub.seq_sub):
            if flag:
                lens = ctx.sublens.get(ctx.in_names[i])
                sublens_t.append(None if lens is None
                                 else lens.transpose(0, 1))
        # step layers' running state rides the loop (pad steps would fold
        # padded rows into train-mode batch statistics, so they refuse)
        slots = sub.state_slots()
        if slots and masks[0] is not None:
            raise ValueError(
                "state-carrying layers (batch_norm) inside a "
                "recurrent_group require full-length sequences: drop the "
                "@len feed (all rows run every step) or move the "
                "batch_norm outside the group")
        st = {}
        for lname, key in slots:
            st.setdefault(lname, {})[key] = ctx.get_state(f"{lname}::{key}")

        def body(t, st, y_prev, *mems):
            feed = dict(static_feed)
            sl = iter(sublens_t)
            for ph, x, flag in zip(sub.seq_phs, xs_t, sub.seq_sub):
                feed[ph] = x[t]
                if flag:
                    lens = next(sl)
                    feed[ph + "@len"] = (
                        torch.full((bsz,), x.shape[2], dtype=torch.int32,
                                   device=dev) if lens is None
                        else torch.where(lens[t] < 0, x.shape[2], lens[t]))
            for mem, c in zip(sub.memories, mems):
                feed[mem.placeholder.name] = c
            outs, new_mems, new_st = sub.step_forward(nested, feed, ctx,
                                                      state=st)
            # pad steps freeze both the memories and the emitted output
            new_mems = [_masked(nm.float(), c, m_t[t])
                        for nm, c in zip(new_mems, mems)]
            y_t = torch.cat([o.float() for o in outs], dim=-1)
            return (new_st if slots else st,
                    _masked(y_t, y_prev, m_t[t]), *new_mems)

        remat = attrs.get("remat", cfg.get_option("rnn_group_remat", False))
        if remat:
            body = _recomputed_step(body, ctx.generator)
        ys = [None] * t_len
        reverse = attrs.get("reverse", False)
        for t in (range(t_len - 1, -1, -1) if reverse else range(t_len)):
            st, y, *mems = body(t, st, y, *mems)
            ys[t] = y
        for lname, key in slots:
            ctx.set_state(f"{lname}::{key}", st[lname][key])
        return torch.stack(ys, 1)


def _recomputed_step(body, generator):
    """``body`` under ``torch.utils.checkpoint``: the forward keeps only
    each step's carries, and the backward runs the step again from them.
    A step that draws from ``generator`` (dropout) draws the same numbers
    again: the generator is set back to its state before the step for the
    recompute, then restored."""
    def step(t, st, y_prev, *mems):
        before = generator.get_state() if generator is not None else None
        calls = [0]

        def run(y_prev, *mems):
            calls[0] += 1
            if calls[0] == 1 or before is None:
                return body(t, st, y_prev, *mems)
            now = generator.get_state()
            generator.set_state(before)
            try:
                return body(t, st, y_prev, *mems)
            finally:
                generator.set_state(now)
        return checkpoint(run, y_prev, *mems, use_reentrant=False)
    return step


@register_layer
class BeamSearchLayer(SeqLayerDef):
    """Fixed-shape beam search (generation only, evaluation mode): each of
    the ``max_length`` steps expands every beam over the vocabulary and
    keeps the best ``beam_size`` candidates of each sample."""

    kind = "beam_search"
    out_is_seq = False

    def infer_shape(self, attrs, in_shapes):
        return (attrs["beam_size"], attrs["max_length"])

    def param_specs(self, attrs, in_shapes):
        specs = attrs["_sub"].flat_param_specs()
        if attrs.get("embedding_name") is None:
            specs.append(ParamSpec(
                "gen_emb", (attrs["vocab_size"], attrs["embedding_size"]),
                "xavier"))
        return specs

    @staticmethod
    def _tree_param(ctx, layer, pname, what):
        tree = ctx.params_tree or {}
        if layer not in tree or pname not in tree[layer]:
            raise ValueError(
                f"beam_search {what}={layer!r} not found in the parameter "
                f"tree" + (" (it must be a trained top-level fc layer)"
                           if what == "output_layer" else ""))
        return tree[layer]

    def apply_seq(self, attrs, params, inputs, masks, ctx):
        with torch.no_grad():
            return self._search(attrs, params, inputs, masks, ctx)

    def _search(self, attrs, params, inputs, masks, ctx):
        sub: SubGraph = attrs["_sub"]
        n_static = attrs["n_static"]
        k, vocab = attrs["beam_size"], attrs["vocab_size"]
        max_len = attrs["max_length"]
        bos, eos = attrs["bos_id"], attrs["eos_id"]
        static_vals, boot_vals = inputs[:n_static], inputs[n_static:]
        first = static_vals[0] if static_vals else boot_vals[0]
        bsz, dev = first.shape[0], first.device
        nested = sub.nest_params(params)

        # generation is evaluation: the step layers' running state is
        # read-only, from this layer's state
        gen_state = {}
        for lname, key in sub.state_slots():
            gen_state.setdefault(lname, {})[key] = ctx.get_state(
                f"{lname}::{key}")
        emb_name = attrs.get("embedding_name")
        emb_table = (params["gen_emb"] if emb_name is None else
                     self._tree_param(ctx, emb_name, "w",
                                      "embedding_name")["w"])
        out_layer = attrs.get("output_layer")
        if out_layer is not None:
            fc = self._tree_param(ctx, out_layer, "w0", "output_layer")
            out_w = fc["w0"].float()
            out_b = fc.get("b")

        def tile_k(x):
            """[B, ...] -> [B*k, ...], beam-major within each sample."""
            return torch.repeat_interleave(x, k, dim=0)

        def gather_beams(x, beam_idx):
            """x [B*k, ...] reordered by beam_idx [B, k]."""
            xr = x.reshape((bsz, k) + tuple(x.shape[1:]))
            rows = torch.arange(bsz, device=dev)[:, None]
            return xr[rows, beam_idx].reshape(x.shape)

        static_feed = {}
        for ph, val, is_seq, m in zip(sub.static_phs, static_vals,
                                      sub.static_seq, masks[:n_static]):
            static_feed[ph] = tile_k(val)
            if is_seq:
                static_feed[ph + "@len"] = tile_k(_seq_lens(val, m))
        boots = iter(boot_vals)
        mems = [tile_k(next(boots)) if m.boot is not None
                else torch.zeros((bsz * k, m.size), device=dev)
                for m in sub.memories]

        neg_inf = torch.tensor(_NEG_INF, dtype=torch.float32, device=dev)
        # beam 0 live, the others dead: the first expansion is beam 0's
        scores = torch.full((bsz, k), _NEG_INF, dtype=torch.float32,
                            device=dev)
        scores[:, 0] = 0.0
        tokens = torch.full((bsz, k), bos, dtype=torch.long, device=dev)
        finished = torch.zeros((bsz, k), dtype=torch.bool, device=dev)
        seqs = torch.full((bsz, k, max_len), eos, dtype=torch.long,
                          device=dev)
        is_eos = (torch.arange(vocab, device=dev) == eos)[None, None, :]
        gen_ph = sub.seq_phs[0]
        adjust, dropper = attrs.get("candidate_adjust"), attrs.get(
            "drop_node")
        for t in range(max_len):
            feed = dict(static_feed)
            feed[gen_ph] = emb_table[tokens.reshape(-1)].float()
            for mdecl, c in zip(sub.memories, mems):
                feed[mdecl.placeholder.name] = c
            (out,), new_mems, _ = sub.step_forward(
                nested, feed, ctx, state=gen_state, train=False)
            if out_layer is not None:
                logits = out.float() @ out_w
                if out_b is not None:
                    logits = logits + out_b
                logp = torch.log_softmax(logits, dim=-1)
            else:
                logp = torch.log(out.float() + 1e-12)
            logp = logp.reshape(bsz, k, vocab)
            if adjust is not None:
                logp = adjust(logp, tokens, t)
            # finished beams may only continue with eos, at their score
            stay = torch.where(is_eos, scores[:, :, None], neg_inf)
            cand = torch.where(finished[:, :, None], stay,
                               scores[:, :, None] + logp)
            if dropper is not None:
                drop = dropper(cand, tokens, t)
                # a finished beam's eos continuation is bookkeeping, never
                # a droppable expansion
                drop = drop & ~(finished[:, :, None] & is_eos)
                cand = torch.where(drop, neg_inf, cand)
            # the k best of each sample; a stable descending sort keeps
            # equal scores in flat-index order, as jax.lax.top_k does
            vals, order = torch.sort(cand.reshape(bsz, k * vocab), dim=1,
                                     descending=True, stable=True)
            top_scores, top_idx = vals[:, :k], order[:, :k]
            beam_idx = torch.div(top_idx, vocab, rounding_mode="floor")
            new_tokens = top_idx % vocab
            live = 1.0 - gather_beams(finished.reshape(-1).float(),
                                      beam_idx)
            mems = [_masked(gather_beams(nm, beam_idx),
                            gather_beams(om, beam_idx), live)
                    for nm, om in zip(new_mems, mems)]
            finished = finished.gather(1, beam_idx) | (new_tokens == eos)
            seqs = seqs.gather(1, beam_idx[:, :, None].expand(-1, -1,
                                                              max_len))
            seqs[:, :, t] = new_tokens
            scores, tokens = top_scores, new_tokens
        ctx.set_state("scores", scores)
        return seqs.to(torch.int32)
