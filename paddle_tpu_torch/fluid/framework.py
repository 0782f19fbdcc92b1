"""Program IR: Variable / Operator / Block / Program / Parameter
(counterpart of ``paddle_tpu/fluid/framework.py``).

Mirrors the reference's proto-backed IR (``python/paddle/v2/fluid/
framework.py:127,362,630,827,988`` and ``paddle/fluid/framework/
framework.proto``) with a plain-python in-memory representation.  This
module keeps no execution logic (``executor.py`` interprets a block op by
op): only graph structure, names, shapes, dtypes and attributes.  A
program built by the same DSL calls serializes (``to_json_dict``) to the
same JSON as the JAX package's, byte for byte, and either package loads
the other's.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

# ---------------------------------------------------------------------------
# dtypes & places
# ---------------------------------------------------------------------------

_DTYPE_ALIASES = {
    "float32": "float32", "fp32": "float32", "float": "float32",
    "float64": "float64", "fp64": "float64", "double": "float64",
    "float16": "float16", "bfloat16": "bfloat16",
    "int32": "int32", "int64": "int64", "int8": "int8", "uint8": "uint8",
    "bool": "bool",
}


def convert_dtype(dtype) -> str:
    if isinstance(dtype, str):
        key = dtype
    else:
        key = np.dtype(dtype).name
    if key not in _DTYPE_ALIASES:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return _DTYPE_ALIASES[key]


class CPUPlace:
    """Host execution (reference ``platform/place.h:53`` CPUPlace)."""

    def torch_device(self):
        return torch.device("cpu")


class CUDAPlace:
    """The card (reference ``platform/place.h`` CUDAPlace), the default
    place of ``Executor``.  With no card it raises rather than run on
    the host."""

    def __init__(self, device_id: int = 0):
        self.device_id = device_id

    def torch_device(self):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDAPlace: no CUDA device is available; pass "
                "fluid.CPUPlace() to run on the host")
        return torch.device("cuda", self.device_id)


#: the JAX package's name for the accelerator place, kept for user code
#: that imports it: here it is ``CUDAPlace``
TPUPlace = CUDAPlace


# ---------------------------------------------------------------------------
# unique names
# ---------------------------------------------------------------------------

class _UniqueNameGenerator:
    def __init__(self):
        self.ids: Dict[str, int] = {}

    def __call__(self, prefix: str) -> str:
        idx = self.ids.get(prefix, 0)
        self.ids[prefix] = idx + 1
        return f"{prefix}_{idx}"


_name_gen = _UniqueNameGenerator()


def unique_name(prefix: str) -> str:
    return _name_gen(prefix)


# ---------------------------------------------------------------------------
# Variable
# ---------------------------------------------------------------------------

class Variable:
    """A named tensor slot in a Block (reference ``framework.py:127``).

    Shape may contain -1 in the leading (batch) dimension only; the executor
    takes the shapes of the fed arrays.
    """

    def __init__(self, block: "Block", name: str, shape: Sequence[int],
                 dtype="float32", persistable: bool = False,
                 stop_gradient: bool = False, initializer=None,
                 is_feed: bool = False):
        self.block = block
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        self.dtype = convert_dtype(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.initializer = initializer
        self.is_feed = is_feed

    @property
    def program(self) -> "Program":
        return self.block.program

    def __repr__(self):
        return (f"Variable(name={self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype})")

    # operator sugar so user code reads like the reference's fluid layers
    def _binary(self, other, op):
        from paddle_tpu_torch.fluid import layers
        return layers.elementwise_op(op, self, other)

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    def __truediv__(self, other):
        return self._binary(other, "elementwise_div")


class Parameter(Variable):
    """Persistable trainable variable (reference ``framework.py:988``)."""

    def __init__(self, block, name, shape, dtype="float32", initializer=None,
                 trainable: bool = True, regularizer=None, gradient_clip=None):
        super().__init__(block, name, shape, dtype, persistable=True,
                         initializer=initializer)
        self.trainable = trainable
        self.regularizer = regularizer
        self.gradient_clip = gradient_clip


# ---------------------------------------------------------------------------
# Operator
# ---------------------------------------------------------------------------

# op types that draw from the PRNG stream; populated by the ops module at
# registration time (keeps the IR free of execution-layer imports) and used
# to stamp a per-program-unique __rng_id__ attr on construction
STATEFUL_RNG_OPS: set = set()


class Operator:
    """One node of the op graph (reference ``framework.py:362``).

    ``inputs`` / ``outputs`` map slot names to lists of variable names —
    exactly the proto's repeated-var slots, so multi-input slots like
    ``sum``'s ``X`` work naturally.
    """

    def __init__(self, block: "Block", type: str,
                 inputs: Optional[Dict[str, Any]] = None,
                 outputs: Optional[Dict[str, Any]] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.block = block
        self.type = type
        self.inputs = {k: _to_name_list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: _to_name_list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})
        if type in STATEFUL_RNG_OPS and "__rng_id__" not in self.attrs:
            # stateful-RNG ops need a per-program-unique id so two dropout /
            # random ops of the same shape draw different streams (the
            # executor folds this id into the step key)
            prog = block.program
            prog._rng_op_count = getattr(prog, "_rng_op_count", 0) + 1
            self.attrs["__rng_id__"] = prog._rng_op_count

    def input_names(self) -> List[str]:
        return [n for vs in self.inputs.values() for n in vs]

    def output_names(self) -> List[str]:
        return [n for vs in self.outputs.values() for n in vs]

    def __repr__(self):
        return f"Operator({self.type}, in={self.inputs}, out={self.outputs})"


def _to_name_list(v) -> List[str]:
    if v is None:
        return []
    if isinstance(v, (Variable, str)):
        v = [v]
    return [x.name if isinstance(x, Variable) else str(x) for x in v]


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------

class Block:
    """A straight-line op list + symbol table (reference ``framework.py:630``).

    Sub-blocks (control flow bodies) reference their parent for name lookup,
    mirroring the proto's ``parent_idx``.
    """

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def parent(self) -> Optional["Block"]:
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    def create_var(self, name: Optional[str] = None, shape=(),
                   dtype="float32", persistable=False, stop_gradient=False,
                   initializer=None, is_feed=False) -> Variable:
        if name is None:
            name = unique_name("tmp")
        var = Variable(self, name, shape, dtype, persistable=persistable,
                       stop_gradient=stop_gradient, initializer=initializer,
                       is_feed=is_feed)
        self.vars[name] = var
        # var creation can change executor run plans (a new persistable
        # enters the program's state set), so it invalidates cached
        # plans the same way op mutation does
        self.program._bump_version()
        return var

    def create_parameter(self, name: Optional[str] = None, shape=(),
                         dtype="float32", initializer=None, trainable=True,
                         regularizer=None, gradient_clip=None) -> Parameter:
        if name is None:
            name = unique_name("param")
        # parameters always live in the global block (reference semantics)
        gblock = self.program.global_block()
        p = Parameter(gblock, name, shape, dtype, initializer=initializer,
                      trainable=trainable, regularizer=regularizer,
                      gradient_clip=gradient_clip)
        gblock.vars[name] = p
        self.program._bump_version()
        # startup program gets the init op
        startup = self.program.startup_program
        if startup is not None and initializer is not None:
            sb = startup.global_block()
            if name not in sb.vars:
                sv = sb.create_var(name=name, shape=shape, dtype=dtype,
                                   persistable=True)
                initializer(sv, sb)
        return p

    def var(self, name: str) -> Variable:
        blk: Optional[Block] = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent
        raise KeyError(f"variable {name!r} not found in block {self.idx}")

    def has_var(self, name: str) -> bool:
        try:
            self.var(name)
            return True
        except KeyError:
            return False

    def append_op(self, type: str, inputs=None, outputs=None,
                  attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._bump_version()
        return op

    def prepend_op(self, type: str, inputs=None, outputs=None,
                   attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(0, op)
        self.program._bump_version()
        return op

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]


# The module names a program file records for the initializer, regularizer
# and clip objects of its parameters: the JAX package's (one JSON format
# for both packages), each read as the port's module of the same path.
_OBJ_MODULES = {
    "paddle_tpu.fluid.initializer": "paddle_tpu_torch.fluid.initializer",
    "paddle_tpu.fluid.regularizer": "paddle_tpu_torch.fluid.regularizer",
    "paddle_tpu.fluid.clip": "paddle_tpu_torch.fluid.clip",
    "paddle_tpu.initializer": "paddle_tpu_torch.initializer",
    "paddle_tpu.attr": "paddle_tpu_torch.attr",
}


# ---------------------------------------------------------------------------
# Program
# ---------------------------------------------------------------------------

class Program:
    """The whole-model IR: a list of blocks (reference ``framework.py:827``).

    ``startup_program`` back-pointer lets ``create_parameter`` register init
    ops the way fluid's layer helpers do implicitly.
    """

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self._current_block_idx = 0
        self._version = 0
        self.startup_program: Optional[Program] = None
        # set by append_backward: param name -> grad var name
        self.param_grad_names: Dict[str, str] = {}

    def _bump_version(self):
        self._version += 1

    @property
    def version(self) -> int:
        return self._version

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self._current_block_idx]

    def create_block(self) -> Block:
        parent = self._current_block_idx
        blk = Block(self, len(self.blocks), parent_idx=parent)
        self.blocks.append(blk)
        self._current_block_idx = blk.idx
        self._bump_version()
        return blk

    def rollback(self):
        self._current_block_idx = self.current_block().parent_idx

    def clone(self) -> "Program":
        memo: dict = {}
        # block back-references make deepcopy safe only with a fresh memo
        return copy.deepcopy(self, memo)

    def list_vars(self):
        for blk in self.blocks:
            yield from blk.vars.values()

    # -- ProgramDesc serialization (reference: proto-backed ProgramDesc
    # round-trips through framework.proto; here canonical JSON) ---------
    @staticmethod
    def _enc_obj(obj):
        """initializer/regularizer/clip objects → {"__obj__": cls, kwargs}
        (simple numeric-attr classes, matching the proto's attr fields).
        The class is named under the JAX package's module (``_OBJ_MODULES``),
        so both packages write the same JSON."""
        if obj is None:
            return None
        state = dict(vars(obj))
        for k, v in state.items():
            if not isinstance(v, (int, float, bool, str, type(None))):
                raise ValueError(
                    f"cannot serialize {type(obj).__name__}.{k}={v!r}")
        mod = type(obj).__module__
        wire = {port: name for name, port in _OBJ_MODULES.items()}.get(mod)
        if wire is None:
            # fail at SAVE time, not at a far-away later load
            raise ValueError(
                f"cannot serialize {mod}.{type(obj).__name__}: only "
                f"initializer/regularizer/clip classes from "
                f"{sorted(_OBJ_MODULES.values())} survive a JSON "
                f"round-trip (deserialization refuses other modules)")
        return {"__obj__": f"{wire}.{type(obj).__name__}",
                "state": state}

    @staticmethod
    def _dec_obj(data):
        """The object ``_enc_obj`` wrote, of the port's class of that name;
        anything outside ``_OBJ_MODULES`` is refused, so a program file
        cannot import arbitrary modules or forge objects of other
        classes."""
        if data is None:
            return None
        import importlib

        mod_name, cls_name = data["__obj__"].rsplit(".", 1)
        if mod_name not in _OBJ_MODULES:
            raise ValueError(
                f"refusing to deserialize object of {data['__obj__']!r}: "
                f"only initializer/regularizer/clip classes from "
                f"{sorted(_OBJ_MODULES)} are allowed")
        cls = getattr(importlib.import_module(_OBJ_MODULES[mod_name]),
                      cls_name)
        obj = cls.__new__(cls)
        vars(obj).update(data["state"])
        return obj

    def to_json_dict(self) -> dict:
        """The canonical JSON ProgramDesc (the JAX package's format,
        ``paddle_tpu-program-v1``)."""
        def enc_attr(v):
            if isinstance(v, Block):
                return {"__block__": v.idx}
            if isinstance(v, np.ndarray):
                return {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
            if isinstance(v, (list, tuple)):
                return [enc_attr(x) for x in v]
            if isinstance(v, dict):
                return {k: enc_attr(x) for k, x in v.items()}
            if callable(v):
                raise ValueError(
                    f"attr {v!r} is a callable — programs holding python "
                    f"callbacks cannot be serialized")
            return v

        blocks = []
        for blk in self.blocks:
            bvars = []
            for v in blk.vars.values():
                bvars.append({
                    "name": v.name, "shape": list(v.shape),
                    "dtype": v.dtype, "persistable": v.persistable,
                    "stop_gradient": v.stop_gradient,
                    "is_feed": v.is_feed,
                    "is_parameter": isinstance(v, Parameter),
                    "trainable": getattr(v, "trainable", None),
                    "initializer": self._enc_obj(v.initializer),
                    "regularizer": self._enc_obj(
                        getattr(v, "regularizer", None)),
                    "gradient_clip": self._enc_obj(
                        getattr(v, "gradient_clip", None)),
                })
            bops = [{"type": op.type, "inputs": op.inputs,
                     "outputs": op.outputs,
                     "attrs": {k: enc_attr(a)
                               for k, a in op.attrs.items()}}
                    for op in blk.ops]
            blocks.append({"idx": blk.idx, "parent_idx": blk.parent_idx,
                           "vars": bvars, "ops": bops})
        return {"format": "paddle_tpu-program-v1", "blocks": blocks,
                "param_grad_names": dict(self.param_grad_names),
                "rng_op_count": getattr(self, "_rng_op_count", 0)}

    @staticmethod
    def from_json_dict(data: dict) -> "Program":
        if data.get("format") != "paddle_tpu-program-v1":
            raise ValueError("not a serialized paddle_tpu-program-v1 "
                             "Program")
        prog = Program()
        # materialize all blocks first so __block__ refs resolve
        for bd in data["blocks"][1:]:
            blk = Block(prog, bd["idx"], parent_idx=bd["parent_idx"])
            prog.blocks.append(blk)
        prog._current_block_idx = 0

        def dec_attr(v):
            if isinstance(v, dict) and "__block__" in v:
                return prog.blocks[v["__block__"]]
            if isinstance(v, dict) and "__ndarray__" in v:
                return np.asarray(v["__ndarray__"],
                                  dtype=np.dtype(v["dtype"]))
            if isinstance(v, dict):
                return {k: dec_attr(x) for k, x in v.items()}
            if isinstance(v, list):
                return [dec_attr(x) for x in v]
            return v

        for bd in data["blocks"]:
            blk = prog.blocks[bd["idx"]]
            for vd in bd["vars"]:
                if vd["is_parameter"]:
                    p = Parameter(
                        blk, vd["name"], vd["shape"], vd["dtype"],
                        trainable=bool(vd.get("trainable", True)),
                        initializer=Program._dec_obj(
                            vd.get("initializer")),
                        regularizer=Program._dec_obj(
                            vd.get("regularizer")),
                        gradient_clip=Program._dec_obj(
                            vd.get("gradient_clip")))
                    blk.vars[vd["name"]] = p
                else:
                    blk.create_var(
                        name=vd["name"], shape=vd["shape"],
                        dtype=vd["dtype"],
                        persistable=vd["persistable"],
                        stop_gradient=vd["stop_gradient"],
                        is_feed=vd["is_feed"],
                        initializer=Program._dec_obj(
                            vd.get("initializer")))
            for od in bd["ops"]:
                op = Operator.__new__(Operator)
                op.block = blk
                op.type = od["type"]
                op.inputs = {k: list(v) for k, v in od["inputs"].items()}
                op.outputs = {k: list(v)
                              for k, v in od["outputs"].items()}
                op.attrs = {k: dec_attr(a)
                            for k, a in od["attrs"].items()}
                blk.ops.append(op)
        prog.param_grad_names = dict(data.get("param_grad_names", {}))
        prog._rng_op_count = int(data.get("rng_op_count", 0))
        # advance the global name generator past every loaded name so
        # extending the program cannot collide/overwrite
        import re as _re

        for blk in prog.blocks:
            for name in blk.vars:
                m = _re.fullmatch(r"(.+)_(\d+)", name)
                if m:
                    prefix, n = m.group(1), int(m.group(2))
                    _name_gen.ids[prefix] = max(
                        _name_gen.ids.get(prefix, 0), n + 1)
        prog._bump_version()
        return prog

    def __repr__(self):
        lines = []
        for blk in self.blocks:
            lines.append(f"block {blk.idx} (parent {blk.parent_idx}):")
            for op in blk.ops:
                lines.append(f"  {op}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# default programs & guards (reference ``framework.py:1046,1057``)
# ---------------------------------------------------------------------------

_main_program = Program()
_startup_program = Program()
_main_program.startup_program = _startup_program


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def reset_default_programs():
    """Fresh default programs (used by tests)."""
    global _main_program, _startup_program
    _main_program = Program()
    _startup_program = Program()
    _main_program.startup_program = _startup_program
    _name_gen.ids.clear()


@contextlib.contextmanager
def program_guard(main_program: Program,
                  startup_program: Optional[Program] = None):
    global _main_program, _startup_program
    prev_main, prev_startup = _main_program, _startup_program
    _main_program = main_program
    if startup_program is not None:
        _startup_program = startup_program
    main_program.startup_program = _startup_program
    try:
        yield
    finally:
        _main_program, _startup_program = prev_main, prev_startup


def grad_var_name(name: str) -> str:
    return name + "@GRAD"
