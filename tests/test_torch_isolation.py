"""The PyTorch port stands alone: no module under paddle_tpu_torch/ imports
JAX or anything of the JAX package ``paddle_tpu``, by source (an AST scan)
and at run time (importing every port module in a fresh interpreter adds no
such entry to ``sys.modules``)."""

import ast
import json
import os
import subprocess
import sys

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
    return top.startswith("jax") or top == "paddle_tpu"


def test_no_port_source_imports_jax_or_the_jax_package():
    bad = []
    for path, _ in _modules():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{path}: {n}" for n in names if _forbidden(n)]
    assert not bad, bad
    assert len(list(_modules())) >= 15


def test_importing_every_port_module_loads_no_jax():
    mods = [m for _, m in _modules()]
    code = ("import json, sys\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "paddle_tpu_torch.serving.engine" in loaded
    assert not [m for m in loaded if _forbidden(m)]
