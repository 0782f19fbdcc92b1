"""Beam generation in the PyTorch port (``layer.beam_search`` with
``GeneratedInput``, ``seq2seq.build(is_generating=True)`` and ``train
--job=gen``) against the JAX package on the CPU.

Both packages run from the same weights (the JAX package's own draw,
scaled so the beams spread, crossed over with ``parameters.from_numpy``).
The ids must be equal and the scores agree within 1e-5 absolute; the
ranking of exactly tied candidates (a planted tie, dead beams, a
``drop_node`` that leaves fewer finite candidates than beams) must be
JAX's: the lower flat index first.
"""

import json

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.core.ir import reset_name_counters as reset_jax_names
from paddle_tpu.models import seq2seq as jseq2seq
from paddle_tpu_torch.core import config as tconfig
from paddle_tpu_torch.core.ir import reset_name_counters as reset_port_names
from paddle_tpu_torch.layers import recurrent as trecurrent
from paddle_tpu_torch.models import seq2seq as tseq2seq

SCORE_TOL = 1e-5
SMALL = dict(src_vocab_size=50, trg_vocab_size=40, emb_dim=16, enc_dim=24,
             dec_dim=32, max_src_len=6, max_trg_len=6)
# enc_dim 128: the encoder's bigru is kernel-eligible
KERNEL_WIDE = dict(SMALL, enc_dim=128)


def _both(config, scale=1.0, seed=0):
    """``config(package)`` built in both packages (their JSON equal), and
    the JAX package's parameters times ``scale``, biases random, as
    numpy."""
    reset_jax_names()
    reset_port_names()
    pj.init(seed=0)
    pt.init(seed=0, device="cpu")
    jtopo = pj.Topology(config(pj), collect_evaluators=False)
    ttopo = pt.Topology(config(pt))
    assert ttopo.proto() == jtopo.proto()
    rng = np.random.default_rng(seed)
    values = {l: {p: (np.asarray(v) * scale if v.ndim == 2 else
                      rng.standard_normal(v.shape).astype(np.float32) * 0.3)
                  for p, v in ps.items()}
              for l, ps in pj.parameters.create(jtopo).values.items()}
    return jtopo, ttopo, values


def _generate(jtopo, ttopo, values, feed, name):
    """(port ids, port scores, JAX ids, JAX scores)."""
    # jitted: the beam search one compile, not one an op a step
    jouts, jstate = jax.jit(lambda v: jtopo.forward(v, {}, feed))(values)
    tparams = pt.parameters.from_numpy(ttopo, values, device="cpu")
    touts, tstate = ttopo.forward(tparams.values, {}, feed, device="cpu")
    return (touts[name].numpy(), tstate[name]["scores"].numpy(),
            np.asarray(jouts[name]), np.asarray(jstate[name]["scores"]))


def _assert_same(ids, scores, jids, jscores):
    assert ids.dtype == np.int32 and ids.shape == jids.shape
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(scores, jscores, atol=SCORE_TOL, rtol=0)


def _generator(vocab=30, emb_dim=6, hdim=8, beam=3, max_len=10,
               tied=False, **hooks):
    """``generator_beam_search``'s model (tests/test_golden_ir.py), or with
    ``tied`` the tied-embedding generator of
    tests/test_recurrent_group.py."""
    def config(paddle):
        layer = paddle.layer
        if tied:
            word = layer.data("word", paddle.data_type.integer_value_sequence(
                vocab, max_len=5))
            emb = layer.embedding(word, emb_dim, name="emb")
            enc = layer.fc(layer.pooling(emb, "avg"), hdim, act="tanh",
                           name="encfc")
        else:
            enc = layer.data("enc", paddle.data_type.dense_vector(hdim))

        def step(gemb):
            mem = layer.memory(name="h", size=hdim, boot_layer=enc)
            nxt = layer.fc([gemb, mem], hdim, act="tanh", name="h",
                           bias_attr=False)
            return layer.fc(nxt, vocab, act="softmax", name="probs",
                            bias_attr=False)

        return layer.beam_search(
            step, [layer.GeneratedInput(
                size=vocab, embedding_name="emb" if tied else None,
                embedding_size=emb_dim)],
            bos_id=0, eos_id=1, beam_size=beam, max_length=max_len,
            name="gen", **hooks.get(paddle.__name__, {}))
    return config


def _enc(b, hdim, seed):
    return {"enc": np.random.RandomState(seed).randn(b, hdim).astype(
        np.float32)}


# ------------------------------------------------------------ the engine
@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_generator_beam_search_matches_jax(scale):
    """The golden ``generator_beam_search`` model: ids equal, scores within
    1e-5; at scale 4 the beams finish early and ride on eos."""
    jtopo, ttopo, values = _both(_generator(), scale)
    ids, scores, jids, jscores = _generate(jtopo, ttopo, values,
                                           _enc(5, 8, 3), "gen")
    _assert_same(ids, scores, jids, jscores)
    assert ids.shape == (5, 3, 10)
    if scale == 4.0:
        assert (ids == 1).any()


def test_tied_embedding_matches_jax():
    """``embedding_name`` feeds the previous token through the trained
    embedding ``emb``: no ``gen_emb`` of the layer's own."""
    jtopo, ttopo, values = _both(_generator(vocab=6, emb_dim=4, hdim=5,
                                            beam=2, max_len=4, tied=True))
    tparams = pt.parameters.create(ttopo, device="cpu")
    assert "gen_emb" not in tparams.values.get("gen", {})
    feed = {"word": np.array([[2, 3, 4, 0, 0], [5, 1, 2, 2, 3]], np.int32),
            "word@len": np.array([3, 5], np.int32)}
    ids, scores, jids, jscores = _generate(jtopo, ttopo, values, feed, "gen")
    _assert_same(ids, scores, jids, jscores)
    assert ids.shape == (2, 2, 4)


def test_greedy_matches_numpy_oracle_and_jax():
    """beam_size 1 is the greedy argmax rollout of the same computation
    (tests/test_recurrent_group.py's oracle)."""
    vocab, emb_dim, hdim, max_len = 7, 5, 6, 4
    jtopo, ttopo, values = _both(_generator(vocab, emb_dim, hdim, 1,
                                            max_len), 2.0)
    feed = _enc(2, hdim, 3)
    ids, scores, jids, jscores = _generate(jtopo, ttopo, values, feed, "gen")
    _assert_same(ids, scores, jids, jscores)
    pv = values["gen"]
    for bi in range(2):
        h, tok, total = feed["enc"][bi], 0, 0.0
        for t in range(max_len):
            h = np.tanh(pv["gen_emb"][tok] @ pv["h::w0"] + h @ pv["h::w1"])
            logits = h @ pv["probs::w0"]
            p = np.exp(logits - logits.max())
            p = p / p.sum()
            tok = int(np.argmax(np.log(p + 1e-12)))
            assert ids[bi, 0, t] == tok, (bi, t, ids[bi], tok)
            total += np.log(p[tok] + 1e-12)
            if tok == 1:
                break
        np.testing.assert_allclose(scores[bi, 0], total, atol=1e-4)


def test_scores_ordered_and_eos_persistent():
    """Beams best first; after a beam's first eos, only eos."""
    vocab, beam, max_len = 9, 3, 6
    jtopo, ttopo, values = _both(_generator(vocab, 4, 5, beam, max_len),
                                 3.0)
    ids, scores, jids, jscores = _generate(jtopo, ttopo, values,
                                           _enc(3, 5, 4), "gen")
    _assert_same(ids, scores, jids, jscores)
    assert ((ids >= 0) & (ids < vocab)).all()
    assert (np.diff(scores, axis=1) <= 1e-5).all()
    ended = 0
    for seq in ids.reshape(-1, max_len):
        eos = np.where(seq == 1)[0]
        if len(eos):
            ended += 1
            assert (seq[eos[0]:] == 1).all()
    assert ended


def _hooks(adjust=None, drop=None):
    """The same hook for each package: ``adjust(logp, tokens, t, xp)`` and
    ``drop(cand, tokens, t, xp)`` written once over the array module
    ``xp`` (jax.numpy or torch)."""
    import jax.numpy as jnp

    out = {}
    for name, xp in (("paddle_tpu", jnp), ("paddle_tpu_torch", torch)):
        kw = {}
        if adjust is not None:
            kw["candidate_adjust"] = (
                lambda logp, tok, t, xp=xp: adjust(logp, tok, t, xp))
        if drop is not None:
            kw["drop_node"] = (
                lambda cand, tok, t, xp=xp: drop(cand, tok, t, xp))
        out[name] = kw
    return out


def _ban(logp, tok, t, xp):
    """-1e30 on token 5 (tests/test_nested_rnn.py's candidate_adjust)."""
    col = (xp.arange(logp.shape[-1]) == 5)[None, None, :]
    return xp.where(col, -1e30, logp)


def _no_repeat(cand, tok, t, xp):
    """drop a repeat of the previous token (the dropOneNode de-dup)."""
    return xp.arange(cand.shape[-1])[None, None, :] == tok[:, :, None]


def test_candidate_adjust_matches_jax():
    jtopo, ttopo, values = _both(_generator(9, 4, 5, 3, 6,
                                            **_hooks(adjust=_ban)))
    ids, scores, jids, jscores = _generate(jtopo, ttopo, values,
                                           _enc(3, 5, 4), "gen")
    _assert_same(ids, scores, jids, jscores)
    assert (ids != 5).all()
    # without the hook token 5 is chosen: the hook is load-bearing
    jtopo, ttopo, values = _both(_generator(9, 4, 5, 3, 6))
    assert (_generate(jtopo, ttopo, values, _enc(3, 5, 4),
                      "gen")[0] == 5).any()


def test_drop_node_matches_jax():
    jtopo, ttopo, values = _both(_generator(9, 4, 5, 2, 7,
                                            **_hooks(drop=_no_repeat)))
    ids, scores, jids, jscores = _generate(jtopo, ttopo, values,
                                           _enc(2, 5, 7), "gen")
    _assert_same(ids, scores, jids, jscores)
    for seq in ids.reshape(-1, 7):
        for t in range(1, 7):
            assert seq[t] != seq[t - 1] or seq[t] == 1, seq


def _tie(logp, tok, t, xp):
    """tokens 2, 3 and 4 get one log-prob, -1.0: exact ties"""
    col = (xp.arange(logp.shape[-1]) >= 2) & (xp.arange(logp.shape[-1]) < 5)
    return xp.where(col[None, None, :], -1.0, logp)


def _keep_one(cand, tok, t, xp):
    """at even steps drop all but token 3 of every beam: fewer finite
    candidates than beams, and the rest tie at -1e30"""
    drop = xp.arange(cand.shape[-1])[None, None, :] != 3
    return drop & (t % 2 == 0)


@pytest.mark.parametrize("hooks", ["tie", "tie_and_keep_one"])
def test_planted_ties_rank_as_jax(hooks):
    """Exact ties among finite candidates, dead beams at t = 0 (beams 1
    and 2 start at -1e30) and a drop_node that leaves one finite
    candidate a sample: the ids equal JAX's over 5 steps, so the ties go
    to the lower flat index first.  A 1-step run shows the first
    expansion: beam 0 alone, its three tied tokens (2, 3, 4) in that
    order, or its one finite candidate and then the -1e30 ties in flat
    order; no dead beam while a finite candidate is left."""
    kw = _hooks(adjust=_tie, drop=_keep_one if hooks != "tie" else None)
    for max_len in (5, 1):
        jtopo, ttopo, values = _both(_generator(9, 4, 5, 3, max_len, **kw),
                                     0.01)
        ids, scores, jids, jscores = _generate(jtopo, ttopo, values,
                                               _enc(4, 5, 2), "gen")
        _assert_same(ids, scores, jids, jscores)
    if hooks == "tie":
        # near-uniform probabilities (scale 0.01): the tied -1.0 beats
        # every other token's log(1/9)
        assert (ids[:, :, 0] == [2, 3, 4]).all()
        assert (scores == -1.0).all()
    else:
        # beam 0's token 3, then its tokens 0 and 1 (eos) at -1e30
        assert (ids[:, :, 0] == [3, 0, 1]).all()
        assert (scores[:, 0] == -1.0).all() and (scores[:, 1:] < -1e29).all()


# ------------------------------------------------------------ seq2seq
def _nmt_values(kw):
    """The JAX training graph's parameters (biases random), by name."""
    reset_jax_names()
    pj.init(seed=0)
    jtopo = pj.Topology(jseq2seq.build(**kw), collect_evaluators=False)
    rng = np.random.default_rng(1)
    return {l: {p: (np.asarray(v) * 2.0 if v.ndim == 2 else
                    rng.standard_normal(v.shape).astype(np.float32) * 0.3)
                for p, v in ps.items()}
            for l, ps in pj.parameters.create(jtopo).values.items()}


SRC_FEED = {"source_words": np.array([[2, 3, 4, 5, 0, 0],
                                      [6, 7, 8, 9, 10, 11],
                                      [12, 0, 0, 0, 0, 0],
                                      [3, 14, 15, 2, 0, 0]], np.int32),
            "source_words@len": np.array([4, 6, 1, 4], np.int32)}


def _nmt_gen(kw, values, beam=3):
    reset_port_names()
    pt.init(seed=0, device="cpu")
    ttopo = pt.Topology(tseq2seq.build(**kw, is_generating=True,
                                       beam_size=beam))
    tparams = {l: {p: torch.from_numpy(v.copy()) for p, v in ps.items()}
               for l, ps in values.items()}
    touts, tstate = ttopo.forward(tparams, {}, SRC_FEED, device="cpu")
    return ttopo, touts["decoder_group"].numpy(), \
        tstate["decoder_group"]["scores"].numpy()


@pytest.mark.parametrize("route", ["plain", "kernel_branch"])
def test_seq2seq_generation_matches_jax(route, monkeypatch):
    """``seq2seq.build(is_generating=True)`` from the trained tree: every
    generator parameter resolves by name in it (``trg_embedding`` and
    ``dec_out`` are the training graph's, read inside the loop), the ids
    equal the JAX package's and the scores agree within 1e-5.
    ``kernel_branch`` widens the encoder to 128 and declares the CPU the
    card, so the bigru takes its kernel-route branch."""
    kw = SMALL
    if route == "kernel_branch":
        kw = KERNEL_WIDE
        monkeypatch.setattr(trecurrent, "_on_card", lambda x: True)
    values = _nmt_values(kw)
    ttopo, ids, scores = _nmt_gen(kw, values)
    for lname, ps in pt.parameters.create(ttopo, device="cpu").values.items():
        assert set(ps) <= set(values[lname]), lname
    reset_jax_names()
    pj.init(seed=0)
    jtopo = pj.Topology(jseq2seq.build(**kw, is_generating=True,
                                       beam_size=3))
    assert ttopo.proto() == jtopo.proto()
    jouts, jstate = jax.jit(lambda v: jtopo.forward(v, {}, SRC_FEED))(values)
    _assert_same(ids, scores, np.asarray(jouts["decoder_group"]),
                 np.asarray(jstate["decoder_group"]["scores"]))
    assert ids.shape == (4, 3, kw["max_trg_len"])
    assert ((ids >= 0) & (ids < kw["trg_vocab_size"])).all()
    assert (np.diff(scores, axis=1) <= 1e-5).all()


def test_generation_refuses_a_missing_output_layer():
    values = _nmt_values(SMALL)
    del values["dec_out"]
    with pytest.raises(ValueError, match="output_layer='dec_out'"):
        _nmt_gen(SMALL, values)


# ------------------------------------------------------------ the CLI
GEN_CONFIG = """
import numpy as np
from paddle_tpu_torch.models import seq2seq

generator = seq2seq.build(src_vocab_size=50, trg_vocab_size=40, emb_dim=16,
                          enc_dim=24, dec_dim=32, max_src_len=6,
                          max_trg_len=6, is_generating=True, beam_size=3)


def gen_reader():
    yield {"source_words": np.array(%s, np.int32),
           "source_words@len": np.array(%s, np.int32)}
    # a batch as samples, through the DataFeeder
    yield [([5, 6, 7],), ([8, 9],)]
"""


def test_cli_gen_from_a_port_snapshot(tmp_path, capsys, monkeypatch):
    """``train --job=gen --device cpu --save_dir DIR``: the generator's
    parameters come from a snapshot the port's writer saved (union-merged:
    ``trg_embedding`` and ``dec_out``, which the generator does not own,
    are kept); one ``{"ids": ...}`` line a batch, the first equal to the
    in-process ids, the second to the JAX package's for those samples."""
    from paddle_tpu_torch import cli
    from paddle_tpu_torch.io import checkpoint

    monkeypatch.setitem(tconfig._options, "device", None)
    values = _nmt_values(SMALL)
    checkpoint.save_params(str(tmp_path / "ck"), values)
    _, ids, _ = _nmt_gen(SMALL, values)
    path = tmp_path / "gen_cfg.py"
    path.write_text(GEN_CONFIG % (SRC_FEED["source_words"].tolist(),
                                  SRC_FEED["source_words@len"].tolist()))
    reset_port_names()
    cli.main(["train", "--job=gen", "--config", str(path), "--device", "cpu",
              "--save_dir", str(tmp_path / "ck")])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    assert len(lines) == 2
    np.testing.assert_array_equal(np.asarray(lines[0]["ids"]), ids)
    reset_jax_names()
    pj.init(seed=0)
    jtopo = pj.Topology(jseq2seq.build(**SMALL, is_generating=True,
                                       beam_size=3))
    feed = pj.data_feeder.DataFeeder(jtopo).feed([([5, 6, 7],), ([8, 9],)])
    jouts, _ = jtopo.forward(values, {}, feed)
    np.testing.assert_array_equal(np.asarray(lines[1]["ids"]),
                                  np.asarray(jouts["decoder_group"]))


def test_cli_gen_needs_a_generator(tmp_path, monkeypatch):
    from paddle_tpu_torch import cli

    monkeypatch.setitem(tconfig._options, "device", None)
    path = tmp_path / "cfg.py"
    path.write_text("x = 1\n")
    with pytest.raises(SystemExit, match="generator"):
        cli.main(["train", "--job=gen", "--config", str(path),
                  "--device", "cpu"])
