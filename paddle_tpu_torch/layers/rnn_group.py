"""recurrent_group / memory: a step network run over every timestep
(counterpart of ``paddle_tpu/layers/rnn_group.py``, training side).

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

Not ported yet, and refused with NotImplementedError: ``beam_search`` and
``GeneratedInput`` (generation), ``SubsequenceInput`` and nested
sequences, step layers that keep running state, and ``rnn_group_remat``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import torch

from paddle_tpu_torch.core import config as cfg
from paddle_tpu_torch.core.ir import LayerOutput
from paddle_tpu_torch.core.registry import LayerDef, register_layer
from paddle_tpu_torch.layers.recurrent import _masked
from paddle_tpu_torch.layers.sequence import SeqLayerDef

_UNPORTED = "is not ported to paddle_tpu_torch yet (ROADMAP.md section 1)"

# build-time context: memory() registers itself with the group being built
_BUILD_STACK: list = []


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
    """A nested-sequence input of recurrent_group: not ported yet."""

    def __init__(self, input: LayerOutput):
        raise NotImplementedError(f"SubsequenceInput (nested sequences) "
                                  f"{_UNPORTED}")


class GeneratedInput:
    """The generated-token input of beam_search: not ported yet."""

    def __init__(self, size: int, embedding_name: Optional[str] = None,
                 embedding_size: int = 0):
        raise NotImplementedError(f"GeneratedInput (beam generation) "
                                  f"{_UNPORTED}")


def beam_search(step: Callable, input, bos_id: int, eos_id: int,
                beam_size: int = 1, max_length: int = 100, **kwargs):
    """Beam-search generation: not ported yet."""
    raise NotImplementedError(f"beam_search {_UNPORTED}")


def memory(name: str, size: int, boot_layer: Optional[LayerOutput] = None):
    """Declare a recurrent state: the value of sub-layer ``name`` at t-1.
    Must be called inside a recurrent_group step function (reference:
    trainer_config_helpers/layers.py memory())."""
    if not _BUILD_STACK:
        raise RuntimeError("memory() must be called inside a "
                           "recurrent_group step function")
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
                 memories: List[_MemoryDecl]):
        self.topo = topo
        self.out_names = list(out_names)
        self.out_name = self.out_names[0]
        self.seq_phs = seq_phs          # placeholder names fed per step
        self.static_phs = static_phs    # placeholder names fed every step
        self.static_seq = static_seq    # is each static input a sequence?
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
            lname, pname = key.split("::", 1)
            nested.setdefault(lname, {})[pname] = val
        return nested

    def step_forward(self, nested_params, feed, ctx):
        """One step of the sub-topology: ([outputs], [next memories])."""
        refs = [m.ref_name for m in self.memories]
        outs, _ = self.topo.forward(
            nested_params, {}, feed, train=ctx.train,
            outputs=list(dict.fromkeys(self.out_names + refs)),
            generator=ctx.generator, device=ctx.device)
        return [outs[n] for n in self.out_names], [outs[r] for r in refs]


def _build_subgraph(step: Callable, inputs: Sequence):
    """Run the user's step function on placeholders; capture the
    sub-topology.  ``inputs`` entries: a LayerOutput (a sequence scanned
    step by step) or a StaticInput.  Returns (SubGraph, parents, n_seq,
    n_static, step outputs)."""
    from paddle_tpu_torch.topology import Topology

    seq_parents, static_parents, static_seq = [], [], []
    phs, seq_ph_names, static_ph_names = [], [], []
    for item in inputs:
        if isinstance(item, StaticInput):
            ph = _make_placeholder(item.input.size or 1, is_seq=item.is_seq)
            static_parents.append(item.input)
            static_seq.append(item.is_seq)
            static_ph_names.append(ph.name)
        else:   # plain LayerOutput -> scanned sequence input
            ph = _make_placeholder(item.size or 1, is_seq=False)
            seq_parents.append(item)
            seq_ph_names.append(ph.name)
        phs.append(ph)

    _BUILD_STACK.append([])
    try:
        out = step(*phs) if len(phs) > 1 else step(phs[0])
    finally:
        mem_decls: List[_MemoryDecl] = _BUILD_STACK.pop()
    outs = list(out) if isinstance(out, (list, tuple)) else [out]

    sub_topo = Topology(outs, collect_evaluators=False)
    for m in mem_decls:
        if m.ref_name not in sub_topo._spec_by_name:
            raise ValueError(
                f"memory(name={m.ref_name!r}): no layer of that name is "
                f"reachable from the step outputs - the next-state layer "
                f"must be an ancestor of (or equal to) a returned layer")
    if any(p.is_state for ps in sub_topo.param_specs.values() for p in ps):
        raise NotImplementedError(
            f"step layers that keep running state (batch_norm) inside a "
            f"recurrent_group {_UNPORTED}")
    sub = SubGraph(sub_topo, [o.name for o in outs], seq_ph_names,
                   static_ph_names, static_seq, mem_decls)
    boot_parents = [m.boot for m in mem_decls if m.boot is not None]
    parents = seq_parents + static_parents + boot_parents
    return sub, parents, len(seq_parents), len(static_parents), outs


def recurrent_group(step: Callable, input, reverse: bool = False,
                    name: Optional[str] = None):
    """Run ``step`` over every timestep of the sequence inputs.

    A step returning a tuple/list yields a LIST of sequence outputs, each
    a ``col_slice`` view of the group's concatenated per-step emission.
    reference: trainer_config_helpers/layers.py recurrent_group."""
    if not isinstance(input, (list, tuple)):
        input = [input]
    sub, parents, n_seq, n_static, outs = _build_subgraph(step, input)
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


@register_layer
class ColSliceLayer(LayerDef):
    """Feature-column view [..., lo:hi]: the out_link extractor of
    multi-output recurrent groups."""

    kind = "col_slice"

    def infer_shape(self, attrs, in_shapes):
        return (attrs["hi"] - attrs["lo"],)

    def apply(self, attrs, params, inputs, ctx):
        return inputs[0][..., attrs["lo"]:attrs["hi"]]


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
        if attrs.get("remat", cfg.get_option("rnn_group_remat", False)):
            raise NotImplementedError(f"rnn_group_remat {_UNPORTED}")
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
                static_feed[ph + "@len"] = (
                    m.sum(dim=1).to(torch.int32) if m is not None
                    else torch.full((val.shape[0],), val.shape[1],
                                    dtype=torch.int32, device=dev))

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
        ys = [None] * t_len
        reverse = attrs.get("reverse", False)
        for t in (range(t_len - 1, -1, -1) if reverse else range(t_len)):
            feed = dict(static_feed)
            for ph, x in zip(sub.seq_phs, xs_t):
                feed[ph] = x[t]
            for mem, c in zip(sub.memories, mems):
                feed[mem.placeholder.name] = c
            outs, new_mems = sub.step_forward(nested, feed, ctx)
            # pad steps freeze both the memories and the emitted output
            mems = [_masked(nm.float(), c, m_t[t])
                    for nm, c in zip(new_mems, mems)]
            y_t = torch.cat([o.float() for o in outs], dim=-1)
            y = ys[t] = _masked(y_t, y, m_t[t])
        return torch.stack(ys, 1)
