"""Rematerialisation in the PyTorch port (``Topology.forward(remat=True |
"blocks")``, ``SGD(remat=)``) against remat off and against the JAX
package, on the CPU.

Two models from the same numpy-seeded weights in both packages: a small
LM (vocab 50, dim 32, 2 heads, 2 layers, T 12) and a small residual conv
net (a 3x3 conv + batch norm stem and two of ResNet's bottlenecks, one
with a projection, one with an identity shortcut: batch norm inside each
block; 8 x 8 images).  Tolerances: the port's remat against remat off
bit for bit (the same ops recomputed on the same inputs); the port's
remat gradients against the JAX package's remat gradients within 1e-5
(the LM, as ``tests/test_torch_training.py``) and 1e-4 of max(1, max |g|)
(the conv net, whose batch-norm sums are taken in another order), the
running statistics within 1e-6.
"""

import io

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu import topology as jtopology
from paddle_tpu.core.ir import reset_name_counters as reset_jax_names
from paddle_tpu_torch import topology as ttopology
from paddle_tpu_torch.core.ir import reset_name_counters as reset_port_names


def _lm(paddle):
    mod = __import__(f"{paddle.__name__}.models.transformer",
                     fromlist=["build"])
    return mod.build(vocab_size=50, max_len=12, dim=32, num_heads=2,
                     num_layers=2)[0]


def _convnet(paddle):
    resnet = __import__(f"{paddle.__name__}.models.resnet",
                        fromlist=["bottleneck"])
    layer, dt = paddle.layer, paddle.data_type
    img = layer.data("image", dt.dense_vector(3 * 8 * 8), height=8, width=8)
    x = resnet.conv_bn(img, 8, 3, name="stem")
    x = resnet.bottleneck(x, 4, 1, name="b1", shortcut_proj=True)
    x = resnet.bottleneck(x, 4, 1, name="b2", shortcut_proj=False)
    x = layer.global_pool(x, pool_type="avg", name="gap")
    pred = layer.fc(x, size=3, name="pred")
    return layer.classification_cost(
        pred, layer.data("label", dt.integer_value(3)), name="cost")


MODELS = {"lm": _lm, "convnet": _convnet}


def _feed(model):
    rng = np.random.RandomState(7)
    if model == "lm":
        return {"tokens": rng.randint(0, 50, (3, 12)).astype(np.int32),
                "targets": rng.randint(0, 50, (3, 12)).astype(np.int32),
                "tokens@len": np.array([12, 7, 3], np.int32)}
    return {"image": rng.randn(4, 8, 8, 3).astype(np.float32),
            "label": rng.randint(0, 3, 4).astype(np.int32)}


def _both(model):
    reset_jax_names()
    reset_port_names()
    pj.init(seed=0)
    pt.init(seed=0, device="cpu")
    ttopo = pt.Topology(MODELS[model](pt))
    jtopo = pj.Topology(MODELS[model](pj), collect_evaluators=False)
    jparams = pj.parameters.create(jtopo)
    buf = io.BytesIO()
    jparams.to_tar(buf)
    buf.seek(0)
    tparams = pt.parameters.create(ttopo)
    tparams.from_tar(buf)
    return ttopo, jtopo, tparams, jparams


def _port_grads(topo, values, feed, remat):
    leaves = [(l, p, t.detach().clone().requires_grad_(True))
              for l, ps in values.items() for p, t in ps.items()]
    params = {}
    for l, p, t in leaves:
        params.setdefault(l, {})[p] = t
    outs, state = topo.forward(params, topo.create_state(), feed,
                               train=True, remat=remat, device="cpu")
    loss = outs[topo.output_names[0]]
    grads = torch.autograd.grad(loss, [t for _, _, t in leaves])
    return (loss.detach(), {(l, p): g for (l, p, _), g in
                            zip(leaves, grads)},
            {(l, k): v for l, ks in state.items() for k, v in ks.items()})


def _jax_grads(topo, values, feed, remat):
    import jax

    state = topo.create_state()

    def loss(v):
        outs, new_state = topo.forward(v, state, feed, train=True,
                                       remat=remat)
        return outs[topo.output_names[0]], new_state

    (val, new_state), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(values)
    return (float(val), {(l, p): np.asarray(g) for l, ps in grads.items()
                         for p, g in ps.items()},
            {(l, k): np.asarray(v) for l, ks in new_state.items()
             for k, v in ks.items()})


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("remat", [True, "blocks"])
def test_remat_bit_equal_to_remat_off(model, remat):
    ttopo, _, tparams, _ = _both(model)
    feed = _feed(model)
    l0, g0, s0 = _port_grads(ttopo, tparams.values, feed, False)
    l1, g1, s1 = _port_grads(ttopo, tparams.values, feed, remat)
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    assert s0.keys() == s1.keys() and (model == "lm" or s0)
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("remat", [True, "blocks"])
def test_remat_gradients_match_jax(model, remat):
    ttopo, jtopo, tparams, jparams = _both(model)
    feed = _feed(model)
    tl, tg, ts = _port_grads(ttopo, tparams.values, feed, remat)
    jl, jg, js = _jax_grads(jtopo, jparams.values, feed, remat)
    np.testing.assert_allclose(float(tl), jl, rtol=1e-5)
    assert tg.keys() == jg.keys()
    for k, g in tg.items():
        ref = jg[k]
        tol = 1e-5 if model == "lm" else 1e-4 * max(1.0,
                                                    np.abs(ref).max())
        np.testing.assert_allclose(g.numpy(), ref, atol=tol, rtol=0,
                                   err_msg=str(k))
    assert ts.keys() == js.keys()
    for k, v in ts.items():
        np.testing.assert_allclose(v.numpy(), js[k], atol=1e-6, rtol=0,
                                   err_msg=str(k))


def test_eligibility_sets_and_segments_are_the_jax_packages():
    for name in ("_REMAT_UNSAFE_KINDS", "_BLOCK_REMAT_UNSAFE_KINDS",
                 "_BLOCK_REMAT_SEQ_OK"):
        assert getattr(ttopology, name) == getattr(jtopology, name), name
    for model in MODELS:
        ttopo, jtopo, _, _ = _both(model)
        assert [ttopology._remat_eligible(s) for s in ttopo.specs] == \
            [jtopology._remat_eligible(s) for s in jtopo.specs]
        want = list(ttopo.output_names)

        def shape(segs):
            seen, out = set(), []
            for seg in segs.values():
                if id(seg) not in seen:
                    seen.add(id(seg))
                    out.append((seg.members, seg.inputs, seg.outputs))
            return out

        tsegs = shape(ttopo._block_segments(want))
        assert tsegs == shape(jtopo._block_segments(set(want)))
        if model == "convnet":
            # the two blocks segment with their batch norms inside
            assert len(tsegs) >= 2 and any(
                ttopo.get_layer(m).kind == "batch_norm"
                for members, _, _ in tsegs for m in members)


def test_sgd_remat_trains_the_same():
    """``SGD(remat=True)`` and the ``remat`` option (read when forward's
    argument is None) train the conv net as remat off does, bit for
    bit, batch-norm state included."""
    runs = []
    for kw, option in (({}, None), ({"remat": True}, None),
                       ({"remat": None}, "blocks")):
        ttopo, _, tparams, _ = _both("convnet")
        if option:
            pt.init(seed=0, device="cpu", remat=option)
        tr = pt.trainer.SGD(ttopo, tparams, pt.optimizer.Momentum(
            learning_rate=0.1, momentum=0.9), **kw)
        costs = []
        tr.train(lambda: iter([_feed("convnet")] * 3),
                 event_handler=lambda e: costs.append(e.cost)
                 if isinstance(e, pt.event.EndIteration) else None)
        pt.init(seed=0, device="cpu", remat=False)
        runs.append((costs, [t.clone() for t in tr._state_tensors()]))
    for costs, state in runs[1:]:
        assert costs == runs[0][0]
        assert all(torch.equal(a, b) for a, b in zip(state, runs[0][1]))
