"""Model persistence: save/load persistables + inference-model export
(counterpart of ``paddle_tpu/fluid/io.py``).

Reference ``python/paddle/v2/fluid/io.py`` (save_persistables,
save_inference_model pruning train-only ops) and ``paddle/fluid/inference/
io.cc:118`` (C++ load).  Parameters are stored as an ``.npz`` (one entry per
persistable var); the inference program is the pruned, test-mode IR pickled
beside them (the ``__model__`` file).  The pickle holds this package's
classes, so a bundle of one package does not load in the other; the npz
persistables and the JSON program (``save_program`` / ``load_program``)
are the same files in both, and are how a model crosses between them.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional

import numpy as np
import torch

from paddle_tpu_torch.fluid import framework
from paddle_tpu_torch.fluid.executor import Executor, Scope, global_scope
from paddle_tpu_torch.fluid.framework import Program, Variable

PARAMS_FILE = "params.npz"
MODEL_FILE = "__model__"


def save_persistables(executor: Executor, dirname: str,
                      main_program: Optional[Program] = None,
                      scope: Optional[Scope] = None):
    main_program = main_program or framework.default_main_program()
    scope = scope or global_scope()
    os.makedirs(dirname, exist_ok=True)
    arrays = {}
    for var in main_program.list_vars():
        if var.persistable and scope.has(var.name):
            val = scope.get(var.name)
            if isinstance(val, torch.Tensor):
                val = val.detach().cpu().numpy()
            arrays[var.name] = np.asarray(val)
    # atomic tmp+fsync+rename (io/atomic.py): a crash mid-save leaves
    # the previous params file intact instead of a truncated npz
    from paddle_tpu_torch.io import atomic as _atomic
    _atomic.atomic_write_file(os.path.join(dirname, PARAMS_FILE),
                              lambda f: np.savez(f, **arrays))


save_params = save_persistables


def load_persistables(executor: Executor, dirname: str,
                      main_program: Optional[Program] = None,
                      scope: Optional[Scope] = None):
    scope = scope or global_scope()
    data = np.load(os.path.join(dirname, PARAMS_FILE))
    for name in data.files:
        scope.set(name, data[name])


load_params = load_persistables


def _prune_for_inference(program: Program, feed_names: List[str],
                         fetch_names: List[str]) -> Program:
    """Backward-reachable slice from fetches, with train-only behavior
    switched off (reference ``io.py`` prune + inference_optimize)."""
    pruned = program.clone()
    block = pruned.global_block()
    needed = set(fetch_names)
    kept = []
    for op in reversed(block.ops):
        if op.type.endswith("_grad") or op.type in (
                "sgd", "momentum", "adam", "adagrad", "adamax", "adadelta",
                "decayed_adagrad", "rmsprop", "ftrl"):
            continue
        if any(n in needed for n in op.output_names()):
            kept.append(op)
            needed.update(n for n in op.input_names() if n)
    kept.reverse()
    for op in kept:
        if op.type in ("dropout", "batch_norm"):
            op.attrs["is_test"] = True
    block.ops = kept
    pruned._bump_version()
    return pruned


def save_inference_model(dirname: str, feeded_var_names: List[str],
                         target_vars: List[Variable], executor: Executor,
                         main_program: Optional[Program] = None,
                         scope: Optional[Scope] = None):
    main_program = main_program or framework.default_main_program()
    fetch_names = [v.name if isinstance(v, Variable) else str(v)
                   for v in target_vars]
    pruned = _prune_for_inference(main_program, feeded_var_names,
                                  fetch_names)
    os.makedirs(dirname, exist_ok=True)
    from paddle_tpu_torch.io import atomic as _atomic
    _atomic.atomic_write_file(
        os.path.join(dirname, MODEL_FILE),
        lambda f: pickle.dump({"program": pruned,
                               "feed_names": feeded_var_names,
                               "fetch_names": fetch_names}, f))
    save_persistables(executor, dirname, pruned, scope=scope)


def load_inference_model(dirname: str, executor: Executor,
                         scope: Optional[Scope] = None):
    with open(os.path.join(dirname, MODEL_FILE), "rb") as f:
        bundle = pickle.load(f)
    load_persistables(executor, dirname, bundle["program"], scope=scope)
    return bundle["program"], bundle["feed_names"], bundle["fetch_names"]


def save_program(program: Program, path: str) -> None:
    """Serialize a Program's full IR to JSON (reference: ProgramDesc
    proto written by save_inference_model / fluid.io; framework.proto)."""
    import json

    from paddle_tpu_torch.io import atomic as _atomic

    blob = json.dumps(program.to_json_dict(), indent=1,
                      sort_keys=True).encode()
    _atomic.atomic_write_file(path, lambda f: f.write(blob))


def load_program(path: str) -> Program:
    """Inverse of save_program: rebuild the Program (blocks, vars, ops,
    sub-block references) from its JSON ProgramDesc."""
    import json

    with open(path) as f:
        return Program.from_json_dict(json.load(f))
