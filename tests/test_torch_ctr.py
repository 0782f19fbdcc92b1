"""The wide-and-deep CTR model of the PyTorch port
(``paddle_tpu_torch/models/ctr.py``) against the JAX package's on the
CPU, with ``sparse_update`` on (every table on the SelectedRows path) and
off, and its captured-chunk contract.

Vocabularies (1000, 1000, 100), emb_dim 16, deep layers (64, 32), batch
32; the ids are drawn from a numpy Zipf distribution folded into each
field (hot ids repeat within a batch and across batches, as in click
logs); both packages start from the JAX package's weights, carried
across as numpy.  Tolerances: after 3 Adam steps every parameter and
slot within 1e-5 x max(1, max |ref|); the chunk against its eager steps
bit for bit (the same kernels on the same inputs, on the CPU); the golden
JSON byte for byte.
"""

import os

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
import torch_layer_configs as layer_configs
from paddle_tpu.core.ir import reset_name_counters as reset_jax_names
from paddle_tpu.models import ctr as jctr
from paddle_tpu_torch.core.ir import reset_name_counters as reset_port_names
from paddle_tpu_torch.models import ctr as tctr

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
VOCABS = (1000, 1000, 100)
BATCH = 32


def _feed(seed):
    """A batch of Zipf ids (a = 1.3, folded into each vocabulary) and
    clicks from a fixed rule over them."""
    rng = np.random.RandomState(seed)
    feed = {f"f{i}": ((rng.zipf(1.3, BATCH) - 1) % v).astype(np.int32)
            for i, v in enumerate(VOCABS)}
    score = sum(feed[f"f{i}"].astype(np.int64) * 2654435761 % 97 / 97.0
                - 0.5 for i in range(len(VOCABS)))
    feed["click"] = (score > 0).astype(np.int32)
    return feed


def _jax_run(sparse, feeds):
    import jax

    reset_jax_names()
    pj.init(seed=7)
    cost, _ = jctr.build(field_vocab_sizes=VOCABS, sparse_update=sparse)
    topo = pj.Topology(cost, collect_evaluators=False)
    params = pj.parameters.create(topo)
    values = {l: {p: np.array(v) for p, v in ps.items()}
              for l, ps in params.values.items()}
    tr = pj.trainer.SGD(topo, params, pj.optimizer.Adam(learning_rate=0.01))
    step = tr._build_step()
    t, o, m = tr._trainable, tr._opt_state, tr.model_state
    losses = []
    for i, feed in enumerate(feeds):
        t, o, m, loss, _ = step(t, o, m, feed, jax.random.PRNGKey(i))
        losses.append(float(loss))
    return values, t, o, losses


def _port_trainer(sparse, values, with_auc=False):
    reset_port_names()
    pt.init(seed=7, device="cpu")
    cost, pred = tctr.build(field_vocab_sizes=VOCABS, sparse_update=sparse)
    if with_auc:
        # the cost's second input is the click label
        pt.evaluator.auc(input=pred, label=cost.parents[1], name="auc")
    topo = pt.Topology(cost)
    return pt.trainer.SGD(topo, pt.parameters.from_numpy(topo, values),
                          pt.optimizer.Adam(learning_rate=0.01))


def _held(got, ref, what):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(np.asarray(got) - ref).max())
    assert err <= 1e-5 * scale, f"{what}: {err} > 1e-5 x {scale}"


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_ctr_adam_matches_jax(sparse):
    """3 Adam steps of ``ctr.build`` from the same weights: losses,
    parameters and slots as the JAX package's."""
    feeds = [_feed(s) for s in range(3)]
    repeats = 1 - len(np.unique(feeds[0]["f0"])) / BATCH
    assert repeats >= 0.25, repeats
    values, jt, jo, jlosses = _jax_run(sparse, feeds)
    tr = _port_trainer(sparse, values)
    tlosses = [float(tr._step(feed)) for feed in feeds]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5, atol=1e-6)
    assert len(tr._sparse) == (6 if sparse else 0)
    for l, ps in tr._trainable.items():
        for p, t in ps.items():
            _held(t.numpy(), jt[l][p], f"{l}.{p}")
            for k, s in tr._opt_state["slots"][l][p].items():
                _held(s.numpy(), jo["slots"][l][p][k], f"{l}.{p}.{k}")


def test_cpu_chunk_equals_its_eager_steps():
    """``steps_per_dispatch=2`` over 4 batches against 4 eager steps from
    the same weights, sparse tables and an AUC evaluator: the losses,
    every parameter and slot, and the pass's AUC, bit for bit."""
    feeds = [_feed(10 + s) for s in range(4)]
    values, _, _, _ = _jax_run(True, feeds[:1])
    runs = []
    for k in (1, 2):
        tr = _port_trainer(True, values, with_auc=True)
        out = {"losses": [], "auc": None}

        def handler(e, out=out):
            if isinstance(e, pt.event.EndIteration):
                out["losses"].append(e.cost)
            elif isinstance(e, pt.event.EndPass):
                out["auc"] = e.metrics["auc"]
        tr.train(lambda: iter(feeds), event_handler=handler,
                 steps_per_dispatch=k)
        runs.append((out, tr))
    (a, ta), (b, tb) = runs
    assert tb.step_capture_count == 1 and ta.step_capture_count == 0
    assert a["losses"] == b["losses"] and a["auc"] == b["auc"]
    assert 0.0 <= a["auc"] <= 1.0
    for x, y in zip(ta._state_tensors(), tb._state_tensors()):
        assert torch.equal(x, y)


def test_sparse_embedding_ctr_golden_is_byte_equal():
    """The port's JSON of ``sparse_embedding_ctr`` (a 100,000-row
    ``sparse_update`` table) is the pinned golden byte for byte, and the
    table is the topology's one SelectedRows table."""
    reset_port_names()
    pt.init(seed=0, device="cpu")
    topo = pt.Topology(layer_configs.CONFIGS["sparse_embedding_ctr"](pt,
                                                                    None))
    with open(os.path.join(GOLDEN_DIR, "sparse_embedding_ctr.json")) as f:
        assert topo.proto() + "\n" == f.read()
    assert topo.sparse_embeddings() == [("emb", "ids", 16)]
