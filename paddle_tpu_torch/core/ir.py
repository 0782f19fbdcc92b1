"""Graph IR: the port's copy of ``paddle_tpu/core/ir.py``.

The JSON it writes (``ModelSpec.to_json``, ``Topology.proto()``) must be
byte-equal to the JAX package's for the same config; nothing here touches
tensors, so the copy is verbatim apart from this paragraph.


Reference encodes topology as protobuf messages (reference:
proto/ModelConfig.proto:364 LayerConfig, :661 ModelConfig) generated by
config_parser.py and walked by NeuralNetwork::init
(paddle/gserver/gradientmachines/NeuralNetwork.cpp:78). Here the same
information lives in plain dataclasses that serialize to canonical JSON —
used both as the lowering input for Topology and for golden-file IR tests
(the `.protostr` test style of trainer_config_helpers/tests/configs).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One learnable (or static) tensor owned by a layer.

    Mirrors ParameterConfig (reference: proto/ParameterConfig.proto:34):
    shape, initializer, and the per-parameter attribute knobs the optimizer
    reads (learning-rate scale, decay multipliers, static flag).
    """

    name: str                       # local name within the layer, e.g. "w"
    shape: tuple                    # full shape (no batch dim)
    initializer: Any = "xavier"     # name or Initializer instance
    is_static: bool = False         # excluded from gradient updates
    learning_rate: float = 1.0      # per-param lr multiplier
    l2_decay: float = 0.0           # per-param decay-rate override
    l1_decay: float = 0.0
    gradient_clipping_threshold: float = 0.0
    is_state: bool = False          # non-trainable running state (e.g. BN stats)
    dtype: str = "float32"
    # SelectedRows semantics (reference: math/SparseRowMatrix.h,
    # lookup_table_op.cc): gradients exist only for the rows a batch
    # touches; the optimizer updates those rows in place.
    sparse_update: bool = False


@dataclasses.dataclass
class LayerSpec:
    """One node of the model graph (reference: LayerConfig proto).

    `attrs` must be JSON-serializable; anything callable (custom
    initializers, user hooks) is carried out-of-band on the LayerOutput.
    """

    name: str
    kind: str                        # registered layer type, e.g. "fc"
    inputs: tuple                    # parent layer names, in order
    attrs: dict                      # static configuration

    def to_json_dict(self) -> dict:
        def _clean(v):
            if callable(v):
                return f"<callable:{getattr(v, '__name__', 'fn')}>"
            if isinstance(v, (list, tuple)):
                return [_clean(x) for x in v]
            if isinstance(v, dict):
                return {k: _clean(x) for k, x in sorted(v.items())}
            return v

        return {
            "name": self.name,
            "type": self.kind,
            "inputs": list(self.inputs),
            "attrs": {k: _clean(v) for k, v in sorted(self.attrs.items())},
        }


@dataclasses.dataclass
class ModelSpec:
    """Ordered (topo-sorted) layer list plus graph metadata.

    The serialized form is this framework's ModelConfig: stable across runs,
    diffable, and checked against golden files in tests (mirroring the
    reference's .protostr golden tests).
    """

    layers: list                     # list[LayerSpec], topo order
    input_names: list                # data layers, feed order
    output_names: list               # requested outputs (cost last)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(
            {
                "layers": [l.to_json_dict() for l in self.layers],
                "inputs": self.input_names,
                "outputs": self.output_names,
            },
            indent=indent,
            sort_keys=False,
        )

    def layer(self, name: str) -> LayerSpec:
        for l in self.layers:
            if l.name == name:
                return l
        raise KeyError(name)


class LayerOutput:
    """User-facing handle returned by every DSL layer function.

    The v2 DSL builds the graph by value flow: each call records its parents,
    and Topology(cost) later walks the parent links to recover the full graph
    (reference: python/paddle/v2/config_base.py:50, layer.py:81). `size` is
    the layer width convenience the reference DSL exposes.
    """

    _COUNTERS: dict = {}

    def __init__(self, kind: str, parents: Sequence["LayerOutput"],
                 attrs: dict, name: Optional[str] = None,
                 size: Optional[int] = None):
        if name is None:
            idx = LayerOutput._COUNTERS.get(kind, 0)
            LayerOutput._COUNTERS[kind] = idx + 1
            name = f"__{kind}_{idx}__"
        self.name = name
        self.kind = kind
        self.parents = list(parents)
        self.attrs = dict(attrs)
        self.size = size

    def spec(self) -> LayerSpec:
        return LayerSpec(
            name=self.name,
            kind=self.kind,
            inputs=tuple(p.name for p in self.parents),
            attrs=self.attrs,
        )

    def __repr__(self):
        return f"LayerOutput({self.kind}:{self.name})"


def reset_name_counters() -> None:
    """Reset auto-naming — call between independent model builds in tests."""
    LayerOutput._COUNTERS = {}


def collect_topology(outputs: Sequence[LayerOutput]) -> list:
    """Walk parent links from the outputs; return topo-ordered LayerOutputs.

    Equivalent of the reference's config-parser graph collection + the
    topo-ordered layer walk NeuralNetwork executes
    (reference: paddle/gserver/gradientmachines/NeuralNetwork.cpp:272).
    """
    order: list = []
    seen: set = set()

    def visit(node: LayerOutput):
        if node.name in seen:
            return
        seen.add(node.name)
        for p in node.parents:
            visit(p)
        order.append(node)

    for out in outputs:
        visit(out)
    return order
