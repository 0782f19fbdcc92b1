"""Fluid: the operator-graph framework with a Program IR (counterpart of
``paddle_tpu/fluid``).

The reference ships a second framework ("Fluid") beside the v2 layer stack: a
``ProgramDesc`` IR of blocks/ops/vars (reference
``paddle/fluid/framework/framework.proto``), a ``Scope``/``Variable`` runtime,
and an ``Executor`` that walks the op list (``framework/executor.cc:80``).

Here: the IR (Program / Block / Operator / Variable, byte-equal JSON with
the JAX package's), ``append_backward``, the DSL modules (``layers``,
``nets``, ``optimizer``, ``regularizer``, ``clip``, ``initializer``,
``param_attr``), control flow (``control_flow``), the whole op catalog,
save / load (``io``), ``DataFeeder``, ``debugger``, and an ``Executor``
that interprets a block op by op on ``CUDAPlace(0)`` (the default; it
raises with no card) or ``CPUPlace()``, with ``check_nan_inf``,
``prepare`` / ``CompiledProgram`` and ``run_n`` (n steps as one captured
CUDA graph on the card), and ``profiler`` over the framework profiler
(``utils/profiler.py``).
"""

from paddle_tpu_torch.fluid import framework
from paddle_tpu_torch.fluid import ops  # registers the op catalog
from paddle_tpu_torch.fluid import layers
from paddle_tpu_torch.fluid import nets
from paddle_tpu_torch.fluid import backward
from paddle_tpu_torch.fluid import optimizer
from paddle_tpu_torch.fluid import regularizer
from paddle_tpu_torch.fluid import clip
from paddle_tpu_torch.fluid import initializer
from paddle_tpu_torch.fluid import io
from paddle_tpu_torch.fluid import control_flow
from paddle_tpu_torch.fluid import debugger
from paddle_tpu_torch.fluid import profiler
from paddle_tpu_torch.fluid import executor
from paddle_tpu_torch.fluid.framework import (
    Program,
    Block,
    Operator,
    Variable,
    Parameter,
    default_main_program,
    default_startup_program,
    program_guard,
    CPUPlace,
    CUDAPlace,
    TPUPlace,
)
from paddle_tpu_torch.fluid.executor import (CompiledProgram, Executor, Scope,
                                             global_scope)
from paddle_tpu_torch.fluid.data_feeder import DataFeeder

__all__ = [
    "framework", "ops", "layers", "nets", "backward", "optimizer",
    "regularizer", "clip", "initializer", "io", "control_flow",
    "debugger", "CompiledProgram",
    "Program", "Block", "Operator", "Variable", "Parameter",
    "default_main_program", "default_startup_program", "program_guard",
    "CPUPlace", "CUDAPlace", "TPUPlace", "Executor", "Scope",
    "global_scope", "DataFeeder", "DistributeTranspiler",
    "memory_optimize",
]


class DistributeTranspiler:
    """API-compat shim (reference: v2/fluid/distribute_transpiler.py:133
    rewrites the Program into trainer + pserver halves with send/recv).

    As in the JAX package, one program runs on every worker and no
    rewrite is made: ``transpile()`` returns the program unchanged and
    ``get_trainer_program`` hands back that same program, so legacy call
    sites keep working.  There is no parameter-server program.
    """

    def __init__(self):
        self._program = None

    def transpile(self, trainer_id=0, program=None, pservers="",
                  trainers=1, split_method=None, **kw):
        self._program = program or framework.default_main_program()
        self.trainer_id = trainer_id
        self.trainers = trainers
        return self._program

    def get_trainer_program(self):
        return self._program

    def get_pserver_program(self, endpoint=None, *a, **kw):
        raise NotImplementedError(
            "no parameter-server program exists: one program runs on "
            "every worker (the mesh executor of ROADMAP.md section 1, "
            "item 14)")


def memory_optimize(input_program=None, *a, **kw):
    """API-compat shim (reference:
    v2/fluid/memory_optimization_transpiler.py, liveness-based buffer
    reuse): the program is returned as it is; the eager executor frees
    each value when the run drops its last reference."""
    return input_program
