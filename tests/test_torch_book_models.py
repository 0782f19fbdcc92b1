"""The five book models of the PyTorch port against the JAX package on the
CPU at small widths: semantic role labelling, OCR with CTC, SSD (train-mode
batch norm), the recommender and word2vec (softmax and hsigmoid).  From
the same weights and the same seeded feed: every output, the loss and
every parameter gradient within 1e-5 (absolute and relative), and
``crf_decoding``'s path equal.  Beside them: the Chunk and CTCError
evaluators against the JAX ones on the same statistics, the three
datasets sample for sample, and SRL snapshots crossing between the
packages both ways.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.io import checkpoint as jckpt
from paddle_tpu_torch.io import checkpoint as tckpt
from test_torch_layer_parity import assert_parity, both

SRL = dict(word_dim=8, hidden=16, depth=2, max_len=12)


def srl_feed(samples, max_len):
    """A padded SRL feed from conll05 samples (words, predicate, 5
    contexts, mark, labels): the predicate repeated over the sentence."""
    b = len(samples)
    lens = np.array([min(len(s[0]), max_len) for s in samples], np.int32)
    feed = {}
    for name, pick in (("word", lambda s: s[0]),
                       ("verb", lambda s: [s[1]] * len(s[0])),
                       ("mark", lambda s: s[7]), ("target", lambda s: s[8])):
        arr = np.zeros((b, max_len), np.int32)
        for i, s in enumerate(samples):
            arr[i, :lens[i]] = pick(s)[:lens[i]]
        feed[name], feed[name + "@len"] = arr, lens
    return feed


def _srl(paddle):
    return list(paddle.models.label_semantic_roles.build(**SRL))


def _ocr(paddle):
    return list(paddle.models.ocr_ctc.build(image_h=8, image_w=24,
                                            num_classes=5, hidden=16))


def _ssd(paddle):
    cost, det = paddle.models.ssd.build(image_size=32, num_classes=3,
                                        max_gt=3)
    return [cost, det]


def _recommender(paddle):
    return list(paddle.models.recommender.build(emb_dim=8, tower=12))


def _word2vec(paddle, hsig=False):
    return list(paddle.models.word2vec.build(
        vocab_size=pt.dataset.imikolov.VOCAB_SIZE, emb_dim=8, hidden=16,
        window=5, use_hsigmoid=hsig))


def _ocr_feed(rng, b=4):
    lens = np.array([3, 1, 2, 3], np.int32)[:b]
    return {"image": rng.rand(b, 8, 24, 1).astype(np.float32),
            "label": rng.randint(0, 5, (b, 8)).astype(np.int32),
            "label@len": lens}


def _ssd_feed(rng, b=4):
    lo = rng.uniform(0, 0.6, (b, 3, 2))
    gt = np.concatenate([lo, lo + rng.uniform(0.1, 0.4, (b, 3, 2))], -1)
    gl = rng.randint(1, 3, (b, 3)).astype(np.float32)
    gl[1, 2] = -1.0
    return {"image": rng.standard_normal((b, 32, 32, 3)).astype(np.float32),
            "gt_box": gt.reshape(b, 12).astype(np.float32), "gt_label": gl}


def _recommender_feed(rng, b=6):
    samples = list(pt.dataset.movielens.train(n=b)())
    keys = ("user_id", "gender", "age", "job", "movie_id", "categories",
            "title")
    feed = {k: np.asarray([s[i] for s in samples], np.int32)
            for i, k in enumerate(keys)}
    feed["score"] = np.stack([s[7] for s in samples]).astype(np.float32)
    return feed


def _word2vec_feed(rng, b=8):
    grams = np.asarray(list(pt.dataset.imikolov.train(samples=b)()))
    feed = {f"w{i}": grams[:, i].astype(np.int32) for i in range(4)}
    feed["next_word"] = grams[:, 4].astype(np.int32)
    return feed


MODELS = {
    "srl": (_srl, lambda rng: srl_feed(list(
        pt.dataset.conll05.test(n=5)()), SRL["max_len"]), False),
    "ocr_ctc": (_ocr, _ocr_feed, False),
    "ssd": (_ssd, _ssd_feed, True),
    "recommender": (_recommender, _recommender_feed, False),
    "word2vec": (_word2vec, _word2vec_feed, False),
    "word2vec_hsigmoid": (lambda p: _word2vec(p, True), _word2vec_feed,
                          False),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_book_model_matches_jax(name):
    build, make_feed, train = MODELS[name]
    ttopo, jtopo, values = both(build)
    feed = make_feed(np.random.RandomState(9))
    outs = assert_parity(ttopo, jtopo, values, feed, train=train)
    if name == "srl":
        path = outs["decoded"].numpy()
        assert path.dtype == np.int32
        assert (path[1, feed["word@len"][1]:] == 0).all()
    if name == "ssd":
        assert tuple(outs["detections"].shape) == (4, 100, 6)


@pytest.mark.parametrize("hidden", [128, 64])
def test_srl_takes_the_lstm_kernel_route_at_hidden_128(monkeypatch, hidden):
    """With the card's half of the route stood in (``_on_card`` True and
    kernel 5 stood in by its plain step, counted): at the book's width,
    hidden 128, every step of each of SRL's 2 x depth LSTMs goes to the
    kernel, and the forward equals the plain route's; at the JAX default
    of 64 none does."""
    from paddle_tpu_torch.layers import recurrent
    from paddle_tpu_torch.ops import fused_rnn

    calls = []

    def kernel(*args):
        calls.append(args[0].shape)
        return fused_rnn._lstm_step_ref(*args)

    pt.init(seed=0, device="cpu")
    cost, decoded = pt.models.label_semantic_roles.build(
        word_dim=8, hidden=hidden, depth=2, max_len=6, word_vocab=30,
        pred_vocab=5, num_labels=7)
    topo = pt.Topology([cost, decoded])
    params = pt.parameters.create(topo, device="cpu").values
    rng = np.random.RandomState(1)
    feed = {}
    for name, vocab in (("word", 30), ("verb", 5), ("mark", 2),
                        ("target", 7)):
        feed[name] = rng.randint(0, vocab, (3, 6)).astype(np.int32)
        feed[name + "@len"] = np.array([6, 2, 4], np.int32)
    plain = topo.forward(params, {}, feed, device="cpu")[0]
    monkeypatch.setattr(recurrent, "_on_card", lambda x: True)
    monkeypatch.setattr(fused_rnn, "lstm_step", kernel)
    routed = topo.forward(params, {}, feed, device="cpu")[0]
    assert len(calls) == (4 * 6 if hidden % 128 == 0 else 0)
    np.testing.assert_allclose(routed["crf"].item(), plain["crf"].item(),
                               rtol=1e-6)
    assert torch.equal(routed["decoded"], plain["decoded"])


def test_chunk_and_ctc_error_match_jax():
    """Both packages' evaluators merge the same statistics: Chunk under
    IOB, IOE, IOBES and plain, CTCError with its blank."""
    rng = np.random.RandomState(2)
    lo = {pkg: pkg.layer.data("x", pkg.data_type.integer_value_sequence(
        9, max_len=10)) for pkg in (pt, pj)}
    for scheme, types in (("IOB", 4), ("IOE", 4), ("IOBES", 2),
                          ("plain", 8)):
        evs = [pkg.evaluator.chunk(lo[pkg], lo[pkg], chunk_scheme=scheme,
                                   num_chunk_types=types, name="ch")
               for pkg in (pt, pj)]
        accs = [None, None]
        for _ in range(3):
            pred = rng.randint(0, 9, (6, 10)).astype(np.int32)
            lab = pred.copy()
            flip = rng.rand(6, 10) < 0.3
            lab[flip] = rng.randint(0, 9, flip.sum())
            mask = (np.arange(10)[None] < rng.randint(1, 11, (6, 1))).astype(
                np.float32)
            for i, e in enumerate(evs):
                accs[i] = e.merge(accs[i], (pred, lab, mask))
        got, want = evs[0].finish(accs[0]), evs[1].finish(accs[1])
        assert got == pytest.approx(want, rel=1e-12), scheme
        assert 0.0 < got["ch.F1"] < 1.0
    evs = [pkg.evaluator.ctc_error(lo[pkg], lo[pkg], blank=4, name="ctc")
           for pkg in (pt, pj)]
    accs = [None, None]
    for _ in range(3):
        ids = rng.randint(0, 5, (5, 12)).astype(np.int32)
        tmask = (np.arange(12)[None] < rng.randint(1, 13, (5, 1))).astype(
            np.float32)
        label = rng.randint(0, 4, (5, 4)).astype(np.int32)
        lmask = (np.arange(4)[None] < rng.randint(0, 5, (5, 1))).astype(
            np.float32)
        for i, e in enumerate(evs):
            accs[i] = e.merge(accs[i], (ids, tmask, label, lmask))
    assert evs[0].finish(accs[0]) == pytest.approx(evs[1].finish(accs[1]),
                                                   rel=1e-12)


def test_evaluators_report_through_the_trainer():
    """chunk over SRL's decoded path comes back in the ``EndPass``
    metrics of a port training pass."""
    pt.init(seed=0, device="cpu")
    cost, decoded = pt.models.label_semantic_roles.build(**SRL)
    pt.evaluator.chunk(input=decoded, label=cost.parents[1],
                       chunk_scheme="IOB", num_chunk_types=33,
                       name="srl_chunk")
    topo = pt.Topology([cost, decoded])
    tr = pt.trainer.SGD(topo, pt.parameters.create(topo),
                        pt.optimizer.Adam(learning_rate=1e-2))
    metrics = {}
    tr.train(_srl_reader(), event_handler=lambda e: metrics.update(
        e.metrics) if isinstance(e, pt.event.EndPass) else None)
    assert {"srl_chunk.precision", "srl_chunk.recall",
            "srl_chunk.F1"} <= set(metrics)


@pytest.mark.parametrize("mod", ["conll05", "imikolov", "movielens"])
def test_datasets_equal_jax_sample_for_sample(mod):
    tmod, jmod = getattr(pt.dataset, mod), getattr(pj.dataset, mod)
    readers = {"conll05": lambda m: m.test(n=20),
               "imikolov": lambda m: m.train(samples=20),
               "movielens": lambda m: m.test(n=20)}[mod]
    for a, b in zip(readers(tmod)(), readers(jmod)()):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    consts = {"conll05": ("WORD_VOCAB", "PRED_VOCAB", "LABEL_COUNT"),
              "imikolov": ("VOCAB_SIZE",),
              "movielens": ("MAX_USER", "MAX_MOVIE", "NUM_JOBS",
                            "NUM_AGES", "NUM_CATEGORIES", "TITLE_VOCAB")}[mod]
    assert [getattr(tmod, c) for c in consts] == [getattr(jmod, c)
                                                  for c in consts]
    real = tmod.train if mod == "imikolov" else tmod.test
    with pytest.raises(RuntimeError, match="not cached"):
        real(synthetic=False)


def _srl_pair():
    """Both packages' SGD trainers on SRL at SRL widths from the same
    weights (Adam)."""
    from paddle_tpu.core.ir import reset_name_counters as rj
    from paddle_tpu_torch.core.ir import reset_name_counters as rt
    import jax.numpy as jnp

    rj()
    rt()
    pj.init(seed=0)
    pt.init(seed=0, device="cpu")
    ttopo = pt.Topology(_srl(pt)[0])
    jtopo = pj.Topology(_srl(pj)[0], collect_evaluators=False)
    values = {l: {p: t.numpy().copy() for p, t in ps.items()}
              for l, ps in pt.parameters.create(ttopo).values.items()}
    jparams = pj.parameters.create(jtopo)
    jparams.values = {l: {p: jnp.asarray(values[l][p]) for p in ps}
                      for l, ps in jparams.values.items()}
    return (pj.trainer.SGD(jtopo, jparams,
                           pj.optimizer.Adam(learning_rate=1e-3)),
            pt.trainer.SGD(ttopo, pt.parameters.from_numpy(
                ttopo, values, device="cpu"),
                pt.optimizer.Adam(learning_rate=1e-3)))


def _trees_equal(a, b):
    assert a.keys() == b.keys()
    for l in a:
        assert a[l].keys() == b[l].keys(), l
        for p in a[l]:
            np.testing.assert_allclose(np.asarray(a[l][p]),
                                       np.asarray(b[l][p]), atol=1e-5,
                                       rtol=1e-5, err_msg=f"{l}.{p}")


def _srl_reader():
    feeds = [srl_feed(list(pt.dataset.conll05.test(n=8)())[i::2],
                      SRL["max_len"]) for i in range(2)]
    return lambda: iter(feeds)


def test_srl_snapshots_cross_both_ways(tmp_path):
    """A port pass snapshot of SRL (the crf weight beside the LSTMs)
    loads in the JAX package with the port trainer's parameters, and a
    JAX one in the port with the JAX trainer's, through the common
    format."""
    jtr, ttr = _srl_pair()
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    ttr.train(_srl_reader(), event_handler=lambda e: None,
              checkpoint_config=tckpt.CheckpointConfig(tdir))
    jtr.train(_srl_reader(), event_handler=lambda e: None,
              checkpoint_config=jckpt.CheckpointConfig(jdir, async_save=False))
    from_port = jckpt.load(tdir)
    from_jax = tckpt.load(jdir)
    assert "w" in from_port["trainable"]["crf"]
    _trees_equal(from_port["trainable"],
                 {l: {p: t.detach().numpy() for p, t in ps.items()}
                  for l, ps in ttr._trainable.items()})
    _trees_equal(tckpt.params_of(from_jax),
                 {l: {p: np.asarray(v) for p, v in ps.items()}
                  for l, ps in jtr._trainable.items()})
    # the two trainers took the same steps from the same weights
    _trees_equal(from_port["trainable"], tckpt.params_of(from_jax))
