"""The PyTorch port stands alone: no module under paddle_tpu_torch/, and not
``chip_smoke.py``, imports JAX, anything of the JAX package ``paddle_tpu``
or its ``tools``, by source (an AST scan) and at run time (importing every
port module, or ``chip_smoke``, in a fresh interpreter adds no such entry
to ``sys.modules``)."""

import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "paddle_tpu_torch")


def _modules():
    for root, _, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                path = os.path.join(root, f)
                rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
                yield path, rel.removesuffix(".__init__")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top.startswith("jax") or top in ("paddle_tpu", "tools")


def _forbidden_imports(path: str) -> list:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad += [f"{path}: {n}" for n in names if _forbidden(n)]
    return bad


def test_no_port_source_imports_jax_or_the_jax_package():
    bad = []
    for path, _ in _modules():
        bad += _forbidden_imports(path)
    assert not bad, bad
    mods = {m for _, m in _modules()}
    assert len(mods) >= 15
    assert {"paddle_tpu_torch.evaluator", "paddle_tpu_torch.inference",
            "paddle_tpu_torch.dataset", "paddle_tpu_torch.dataset.common",
            "paddle_tpu_torch.dataset.mnist",
            "paddle_tpu_torch.reader.creator", "paddle_tpu_torch.models.ctr",
            "paddle_tpu_torch.models.mlp", "paddle_tpu_torch.io.atomic",
            "paddle_tpu_torch.io.checkpoint",
            "paddle_tpu_torch.io.recordio",
            "paddle_tpu_torch.serving.client"} <= mods


def _loaded_after(code: str) -> list:
    """sys.modules of a fresh interpreter after running ``code``."""
    code += "\nimport json, sys\nprint(json.dumps(sorted(sys.modules)))\n"
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    """Nor do the helpers it loads from tests/ (the golden configs, the
    networks helpers' models, the Fluid programs)."""
    path = os.path.join(REPO, "chip_smoke.py")
    assert not _forbidden_imports(path)
    for helper in ("torch_layer_configs", "torch_networks_configs",
                   "torch_fluid_programs"):
        assert not _forbidden_imports(
            os.path.join(REPO, "tests", helper + ".py"))
    loaded = _loaded_after("import chip_smoke\n"
                           "chip_smoke.flash_bwd_phase, chip_smoke.train_path"
                           "\nassert chip_smoke._layer_configs().CONFIGS"
                           "\nassert chip_smoke._tests_module("
                           "'torch_networks_configs').CONFIGS"
                           "\nassert chip_smoke._tests_module("
                           "'torch_fluid_programs').PROGRAMS"
                           "\nimport paddle_tpu_torch.fluid")
    assert "chip_smoke" in loaded
    assert not [m for m in loaded if _forbidden(m)]


def test_importing_every_port_module_loads_no_jax():
    mods = [m for _, m in _modules()]
    loaded = _loaded_after(f"for m in {mods!r}:\n    __import__(m)\n")
    assert "paddle_tpu_torch.serving.engine" in loaded
    assert "paddle_tpu_torch.serving.client" in loaded
    assert "paddle_tpu_torch.trainer" in loaded
    assert "paddle_tpu_torch.tools.flash_variants" in loaded
    assert not [m for m in loaded if _forbidden(m)]


def test_the_serving_client_loads_no_jax():
    """The client is the port's own copy: importing it (and through it the
    port's engine, whose errors it raises) loads neither JAX nor the JAX
    package's client or tracing."""
    loaded = _loaded_after("from paddle_tpu_torch.serving import client\n"
                           "assert client.Overloaded.__module__ == "
                           "'paddle_tpu_torch.serving.engine'")
    assert "paddle_tpu_torch.serving.client" in loaded
    assert not [m for m in loaded if _forbidden(m)]


def test_the_sweep_entry_point_loads_no_jax():
    """``python -m paddle_tpu_torch.tools.flash_variants`` imports only the
    port: neither JAX nor the JAX package's own ``tools``."""
    loaded = _loaded_after("import paddle_tpu_torch.tools.flash_variants")
    assert "paddle_tpu_torch.ops.flash_variants" in loaded
    assert not [m for m in loaded if _forbidden(m)]


def _public(module) -> set:
    """A module's public names, less the modules it imported."""
    return {n for n in dir(module) if not n.startswith("_")
            and not isinstance(getattr(module, n), type(ast))}


def test_the_port_has_every_public_name_of_the_v2_layer_dsl_and_models():
    """Every public name of the JAX package's ``layer``, ``models``,
    ``evaluator``, ``networks``, reader decorators, ``py_data_provider2``,
    ``plot``, ``trainer_config_helpers``, datasets and the Fluid modules
    (``control_flow`` and ``debugger`` among them; of ``executor`` the
    user-facing names) exists in the port, and no evaluator factory is
    refused."""
    import inspect

    import paddle_tpu
    import paddle_tpu.fluid
    import paddle_tpu.fluid.control_flow
    import paddle_tpu.layer
    import paddle_tpu.models
    import paddle_tpu.trainer_config_helpers
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.fluid
    import paddle_tpu_torch.models
    import paddle_tpu_torch.trainer_config_helpers

    pairs = [(paddle_tpu.layer, pt.layer),
             (paddle_tpu.models, paddle_tpu_torch.models),
             (paddle_tpu.evaluator, pt.evaluator),
             (paddle_tpu.networks, pt.networks),
             (paddle_tpu.reader.decorator, pt.reader.decorator),
             (paddle_tpu.py_data_provider2, pt.py_data_provider2),
             (paddle_tpu.plot, pt.plot),
             (paddle_tpu.trainer_config_helpers,
              paddle_tpu_torch.trainer_config_helpers)]
    pairs += [(getattr(paddle_tpu.dataset, m), getattr(pt.dataset, m))
              for m in ("conll05", "imikolov", "movielens", "mq2007",
                        "sentiment", "uci_housing", "voc2012")]
    pairs += [(getattr(paddle_tpu.fluid, m), getattr(paddle_tpu_torch.fluid,
                                                     m))
              for m in ("framework", "layers", "nets", "backward",
                        "optimizer", "regularizer", "clip", "initializer",
                        "io", "control_flow", "debugger")]
    # the JAX executor's trace-time hooks (its two-phase While probe and
    # lowering table, its telemetry): the eager executor reads a While's
    # trip count from the run's values and has no lowering to hook
    jax_only = {"CONTROL_FLOW_LOWERERS", "captured_trips"}
    for jmod, tmod in pairs:
        missing = sorted(_public(jmod) - _public(tmod) - jax_only)
        assert not missing, (tmod.__name__, missing)
    for name in ("Executor", "CompiledProgram", "Scope", "OpRunCtx",
                 "global_scope", "run_block"):
        assert hasattr(paddle_tpu_torch.fluid.executor, name), name
    assert "11b" not in inspect.getsource(pt.evaluator)
