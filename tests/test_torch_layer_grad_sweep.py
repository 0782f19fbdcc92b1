"""The port's gradient sweep over every differentiable layer kind: autograd
against central finite differences, in float64 on the CPU.

The cases are those of ``tests/test_layer_grad_sweep.py``, the JAX
package's sweep: its case functions are read from that file and run with
the port's ``layer`` DSL, with its tolerances, ``TRAIN_CASES``,
``DIFF_FEED`` and ``NONDIFF_KINDS``.  No JAX runs here: the port's
autograd is held against the port's own arithmetic.

Each case's loss is sum(out * cos(arange)) over its first output.  For
every parameter (and, where a topology has none, each ``DIFF_FEED``
input) a central difference along one seeded random direction d,
(L(p + eps d) - L(p - eps d)) / 2 eps, must equal <dL/dp, d> within the
case's tolerance (atol = rtol = tol, as ``jax.test_util.check_grads``).

The port computes in float32; this file runs it in float64: the default
dtype is float64, ``Tensor.float()`` (the layers' "at least float32"
upcast) gives float64, and float feeds keep float64.  The differences
then have error near 1e-10, so the tolerance measures the gradient and
not the rounding.
"""

import os
import re
import zlib

import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import layer
from paddle_tpu_torch import topology as topo_mod
from paddle_tpu_torch.core.registry import registered_layers

_JAX_SWEEP = os.path.join(os.path.dirname(__file__),
                          "test_layer_grad_sweep.py")
EPS = 1e-6
# the JAX file's per-case tolerances (test_layer_grad_sweep.py
# test_layer_grad)
LOOSE = ("ctc", "crf", "multibox_loss_priorbox", "nce_cost")


def _load_cases():
    """(CASES, TRAIN_CASES, DIFF_FEED, NONDIFF_KINDS) of the JAX sweep,
    its case functions bound to the port's DSL."""
    with open(_JAX_SWEEP) as f:
        src = f.read()
    body = src[src.index("def F(rng"):src.index("def _all_case_names")]
    body = re.sub(r"def _build\(name\):.*?\n\n\n", "", body, flags=re.S)
    body = re.sub(r"def _grad_check\(.*?\n\n\n", "", body, flags=re.S)
    body = body.replace("from paddle_tpu.", "from paddle_tpu_torch.")
    cases = {}

    def case(name):
        def deco(fn):
            cases[name] = fn
            return fn
        return deco

    dt = paddle.data_type
    ns = dict(np=np, paddle=paddle, layer=layer, case=case,
              dv=dt.dense_vector, dvs=dt.dense_vector_sequence,
              iv=dt.integer_value, ivs=dt.integer_value_sequence)
    exec(compile(body, _JAX_SWEEP, "exec"), ns)
    tail = src[src.index("TRAIN_CASES ="):
               src.index("def test_layer_kind_coverage")]
    exec(compile(tail, _JAX_SWEEP, "exec"), ns)
    return cases, ns["TRAIN_CASES"], ns["DIFF_FEED"], ns["NONDIFF_KINDS"]


CASES, TRAIN_CASES, DIFF_FEED, NONDIFF_KINDS = _load_cases()


@pytest.fixture(scope="module", autouse=True)
def float64():
    """Run the port in float64 for this file, and restore it after."""
    dtype, to_float = torch.get_default_dtype(), torch.Tensor.float
    feed = topo_mod._float_feed
    torch.set_default_dtype(torch.float64)
    torch.Tensor.float = lambda self, *a, **k: self.to(torch.float64)
    topo_mod._float_feed = lambda x, policy: x.to(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(dtype)
        torch.Tensor.float = to_float
        topo_mod._float_feed = feed


def _build(name):
    paddle.init(seed=0, device="cpu")
    rng = np.random.RandomState(zlib.crc32(name.encode()) % (2 ** 31))
    return CASES[name](rng)


def _check(name):
    cost, feed = _build(name)
    tol = 1e-1 if name in LOOSE else 5e-2
    train = name in TRAIN_CASES
    topo = paddle.Topology(cost, collect_evaluators=False)
    params = paddle.parameters.create(topo)
    state = topo.create_state()
    leaves = [(l, k, v.detach().double())
              for l, ps in params.values.items() for k, v in ps.items()]
    diff = {k: torch.as_tensor(np.asarray(feed[k], np.float64))
            for k in DIFF_FEED.get(name, ())}
    assert leaves or diff, "a parameterless case needs a DIFF_FEED key"

    def loss(ts):
        values = {l: dict(ps) for l, ps in params.values.items()}
        for (l, k, _), t in zip(leaves, ts):
            values[l][k] = t
        full = dict(feed)
        full.update(zip(diff, ts[len(leaves):]))
        # one seed a call: a dropout mask is the same in every difference
        gen = torch.Generator().manual_seed(7)
        outs, _ = topo.forward(values, state, full, train=train,
                               generator=gen, device="cpu")
        out = outs[topo.output_names[0]]
        w = torch.cos(torch.arange(out.numel(), dtype=torch.float64))
        return torch.sum(out.double() * w.reshape(out.shape))

    base = [v for _, _, v in leaves] + list(diff.values())
    ts = [t.clone().requires_grad_(True) for t in base]
    loss_v = loss(ts)
    assert loss_v.dtype == torch.float64
    grads = torch.autograd.grad(loss_v, ts, allow_unused=True)
    gen = torch.Generator().manual_seed(1)
    for i, (t, g) in enumerate(zip(base, grads)):
        d = torch.randn(t.shape, generator=gen, dtype=torch.float64)

        def at(sign):
            shifted = list(base)
            shifted[i] = t + sign * EPS * d
            return float(loss(shifted))

        numeric = (at(1.0) - at(-1.0)) / (2 * EPS)
        analytic = 0.0 if g is None else float(torch.sum(g * d))
        where = (f"{leaves[i][0]}.{leaves[i][1]}" if i < len(leaves)
                 else f"feed {list(diff)[i - len(leaves)]}")
        assert abs(numeric - analytic) <= tol + tol * abs(numeric), (
            f"{name}: {where}: autograd {analytic!r} vs central "
            f"difference {numeric!r}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_grad(name):
    _check(name)


def test_layer_kind_coverage():
    """Every registered kind of the port is swept (in a case's graph or a
    recurrent group's step graph) or is in the JAX file's
    non-differentiable list; the registry has the 113 kinds of the JAX
    package."""
    def collect(specs, covered):
        for s in specs:
            covered.add(s.kind)
            sub = s.attrs.get("_sub") if isinstance(s.attrs, dict) else None
            if sub is not None:
                collect(sub.topo.specs, covered)

    covered = set()
    for name in sorted(CASES):
        cost, _ = _build(name)
        collect(paddle.Topology(cost, collect_evaluators=False).specs,
                covered)
    kinds = set(registered_layers())
    assert len(kinds) == 113
    missing = sorted(kinds - covered - NONDIFF_KINDS)
    assert not missing, f"layer kinds not in the grad sweep: {missing}"
    assert len(covered - NONDIFF_KINDS) >= 90
