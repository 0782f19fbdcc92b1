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
    """Nor does the golden-config helper it loads from tests/."""
    path = os.path.join(REPO, "chip_smoke.py")
    assert not _forbidden_imports(path)
    assert not _forbidden_imports(
        os.path.join(REPO, "tests", "torch_layer_configs.py"))
    loaded = _loaded_after("import chip_smoke\n"
                           "chip_smoke.flash_bwd_phase, chip_smoke.train_path"
                           "\nassert chip_smoke._layer_configs().CONFIGS")
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
    """Every public name of the JAX package's ``layer``, ``models`` and the
    conll05, imikolov and movielens datasets exists in the port (each
    ported: none of them refuses), and the evaluator factories the port
    still refuses name the ROADMAP item that brings them (11b)."""
    import paddle_tpu
    import paddle_tpu.layer
    import paddle_tpu.models
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.models

    pairs = [(paddle_tpu.layer, pt.layer),
             (paddle_tpu.models, paddle_tpu_torch.models)]
    pairs += [(getattr(paddle_tpu.dataset, m), getattr(pt.dataset, m))
              for m in ("conll05", "imikolov", "movielens")]
    for jmod, tmod in pairs:
        missing = sorted(_public(jmod) - _public(tmod))
        assert not missing, (tmod.__name__, missing)
    refused = set()
    for name in sorted(_public(pt.evaluator)):
        fn = getattr(pt.evaluator, name)
        if getattr(fn, "__qualname__", "").startswith("_not_ported"):
            with pytest.raises(NotImplementedError, match="item 11b"):
                fn(None, None)
            refused.add(name)
    assert refused == {
        "pnpair", "rank_auc", "rankauc", "seq_classification_error",
        "value_printer", "gradient_printer", "maxid_printer",
        "maxframe_printer", "seqtext_printer",
        "classification_error_printer"}
