"""The NMT training slice of the PyTorch port (``models/seq2seq.py`` through
``trainer.SGD``, the CLI ``train`` verb, and the parameter formats that
carry the recurrent group's ``::`` names) against the JAX package on the
CPU.

The model is small (vocab 50 / 40, emb 16, enc 24, dec 32, lengths <= 6,
batch 4) on a padded feed with a length-1 row; weights cross through
``parameters.from_numpy``.  Tolerances: 1e-5 for the loss and every
gradient, 1e-5 relative for a 3-step Adam trajectory.
"""

import io

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

SMALL = dict(src_vocab_size=50, trg_vocab_size=40, emb_dim=16, enc_dim=24,
             dec_dim=32, max_src_len=6, max_trg_len=6)
# enc_dim 128: the encoder's bigru is kernel-eligible
KERNEL_WIDE = dict(SMALL, enc_dim=128)
FEEDING = {"source_words": 0, "target_words": 1, "target_next_words": 2}
# bench_nmt's learning rate.  epsilon 1e-6: the gradients agree to float32
# rounding (~1e-9 absolute), and with the default 1e-8 Adam's normalisation
# would turn that rounding in components whose gradient is itself ~1e-9
# into a visible fraction of the learning rate
ADAM = dict(learning_rate=1e-3, epsilon=1e-6)


def _both(**kw):
    """The NMT training graph in both packages, and the JAX package's
    parameters (biases made random) as numpy."""
    reset_jax_names()
    reset_port_names()
    pj.init(seed=0)
    pt.init(seed=0, device="cpu")
    jtopo = pj.Topology(jseq2seq.build(**kw), collect_evaluators=False)
    ttopo = pt.Topology(tseq2seq.build(**kw))
    rng = np.random.default_rng(1)
    values = {l: {p: (np.asarray(v) if v.ndim == 2 else
                      rng.standard_normal(v.shape).astype(np.float32) * 0.3)
                  for p, v in ps.items()}
              for l, ps in pj.parameters.create(jtopo).values.items()}
    return jtopo, ttopo, values


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    src_len = np.array([6, 1, 4, 5], np.int32)
    trg_len = np.array([3, 6, 1, 5], np.int32)
    return {"source_words": rng.randint(0, 50, (4, 6)).astype(np.int32),
            "source_words@len": src_len,
            "target_words": rng.randint(0, 40, (4, 6)).astype(np.int32),
            "target_words@len": trg_len,
            "target_next_words": rng.randint(0, 40, (4, 6)).astype(
                np.int32),
            "target_next_words@len": trg_len}


@pytest.mark.parametrize("route", ["plain", "kernel_branch"])
def test_nmt_loss_and_grads_match_jax(route, monkeypatch):
    """From one set of weights: the IR JSON, the loss and every parameter
    gradient of ``seq2seq.build``.  ``kernel_branch`` widens the encoder to
    128 and declares the CPU the card, so the bigru runs its kernel-route
    branch (the plain step in the kernel's place)."""
    import jax

    kw = SMALL
    if route == "kernel_branch":
        kw = KERNEL_WIDE
        monkeypatch.setattr(trecurrent, "_on_card", lambda x: True)
    jtopo, ttopo, values = _both(**kw)
    assert ttopo.proto() == jtopo.proto()
    feed = _feed()

    def jloss(v):
        outs, _ = jtopo.forward(v, {}, feed, train=True)
        return outs["nmt_cost"]

    jcost, jgrads = jax.jit(jax.value_and_grad(jloss))(values)
    tr = pt.trainer.SGD(ttopo, pt.parameters.from_numpy(ttopo, values,
                                                        device="cpu"),
                        pt.optimizer.Adam())
    tcost, tgrads = tr.forward_backward(feed)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-5)
    assert sorted(tgrads) == sorted(jgrads)
    assert "decoder_group" in tgrads
    for lname, ps in tgrads.items():
        assert sorted(ps) == sorted(jgrads[lname])
        for pname, g in ps.items():
            np.testing.assert_allclose(
                g.numpy(), np.asarray(jgrads[lname][pname]), atol=1e-5,
                rtol=1e-5, err_msg=f"{lname}.{pname}")


def test_nmt_adam_trajectory_matches_jax():
    """Three Adam steps of ``SGD.train`` through the DataFeeder (which
    pads to max_len and writes the @len feeds): the same losses within
    1e-5 relative, and the trained parameters within 1e-5."""
    jtopo, ttopo, values = _both(**SMALL)
    rng = np.random.RandomState(2)
    rows = []
    for ls, lt in ((6, 3), (1, 6), (4, 1), (5, 5)):
        trg = rng.randint(2, 40, lt).tolist()
        rows.append((rng.randint(2, 50, ls).tolist(), trg, trg[1:] + [1]))
    reader = lambda: iter([rows] * 3)     # noqa: E731
    jl, tl = [], []
    jparams = pj.parameters.create(jtopo)
    for key in jparams.keys():
        layer, _, pname = key.rpartition(".")
        jparams[key] = values[layer][pname]
    pj.trainer.SGD(jtopo, jparams, pj.optimizer.Adam(**ADAM)) \
        .train(reader, feeding=FEEDING, event_handler=lambda e: (
            jl.append(e.cost) if isinstance(e, pj.event.EndIteration)
            else None))
    tparams = pt.parameters.from_numpy(ttopo, values, device="cpu")
    pt.trainer.SGD(ttopo, tparams, pt.optimizer.Adam(**ADAM)) \
        .train(reader, feeding=FEEDING, event_handler=lambda e: (
            tl.append(e.cost) if isinstance(e, pt.event.EndIteration)
            else None))
    assert len(tl) == 3 and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    for key in tparams.keys():
        np.testing.assert_allclose(tparams[key], jparams[key], atol=1e-5,
                                   err_msg=key)


def test_group_parameter_names_cross_both_ways(tmp_path):
    """The recurrent group's ``<step layer>::<param>`` names survive a tar
    in both directions, ``from_numpy``, and the port's snapshot writer and
    reader."""
    from paddle_tpu_torch.io import checkpoint

    jtopo, ttopo, values = _both(**SMALL)
    tparams = pt.parameters.from_numpy(ttopo, values, device="cpu")
    group = sorted(k for k in tparams.keys()
                   if k.startswith("decoder_group."))
    assert group == ["decoder_group.att::v", "decoder_group.att::w_dp",
                     "decoder_group.dec_gates::w0",
                     "decoder_group.dec_gates::w1",
                     "decoder_group.gru_decoder::b",
                     "decoder_group.gru_decoder::w_c",
                     "decoder_group.gru_decoder::w_g"]
    buf = io.BytesIO()
    tparams.to_tar(buf)
    buf.seek(0)
    jparams = pj.parameters.create(jtopo)
    jparams.from_tar(buf)
    for key in tparams.keys():
        np.testing.assert_array_equal(jparams[key], tparams[key])
    buf = io.BytesIO()
    jparams.to_tar(buf)
    buf.seek(0)
    back = pt.parameters.create(ttopo, device="cpu")
    back.from_tar(buf)
    for key in tparams.keys():
        np.testing.assert_array_equal(back[key], tparams[key])
    checkpoint.save_params(str(tmp_path), {
        l: {p: t.numpy() for p, t in ps.items()}
        for l, ps in tparams.values.items()})
    tree = checkpoint.params_of(checkpoint.load(str(tmp_path)))
    again = pt.parameters.from_numpy(ttopo, tree, device="cpu")
    for key in tparams.keys():
        np.testing.assert_array_equal(again[key], tparams[key])


# ---------------------------------------------------------------------- CLI
CLI_CONFIG = '''
import numpy as np
import paddle_tpu_torch as paddle
from paddle_tpu_torch.models import seq2seq

paddle.init(seed=0)
cost = seq2seq.build(30, 20, emb_dim=8, enc_dim=8, dec_dim=8,
                     max_src_len=5, max_trg_len=5)
optimizer = paddle.optimizer.Adam(learning_rate=1e-2)
feeding = {"source_words": 0, "target_words": 1, "target_next_words": 2}


def _samples():
    rng = np.random.RandomState(0)
    for n in (5, 2, 4, 1):
        src = rng.randint(2, 30, n).tolist()
        trg = rng.randint(2, 20, 6 - n).tolist()
        yield src, [0] + trg, trg + [1]


train_reader = paddle.batch(_samples, 2)
'''


def test_cli_trains_the_nmt_config_on_the_cpu(tmp_path, capsys,
                                               monkeypatch):
    """``python -m paddle_tpu_torch train --config`` runs a config that
    builds ``seq2seq.build`` and defines ``train_reader``: one pass, two
    batches, finite costs."""
    from paddle_tpu_torch import cli

    monkeypatch.setitem(tconfig._options, "device", None)
    monkeypatch.setitem(tconfig._options, "log_period", 100)
    path = tmp_path / "nmt_cfg.py"
    path.write_text(CLI_CONFIG)
    reset_port_names()
    cli.main(["train", "--config", str(path), "--num_passes", "1",
              "--log_period", "1", "--device", "cpu"])
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("Pass 0, Batch")]
    assert len(lines) == 2
    assert all(np.isfinite(float(l.rsplit(" ", 1)[1])) for l in lines)


# ------------------------------------------------------ what is refused
def test_unported_recurrent_paths_raise(tmp_path, monkeypatch):
    """What this test once expected to refuse now works: generation
    (``seq2seq.build(is_generating=True)``, ``GeneratedInput``,
    ``beam_search``), ``SubsequenceInput`` over a nested data layer and
    ``rnn_group_remat`` (bit for bit the plain group); the unfused
    attention composite builds.  ``train --job=checkgrad`` still refuses,
    naming its ROADMAP item."""
    from paddle_tpu_torch import cli

    reset_port_names()
    pt.init(seed=0, device="cpu")
    layer = pt.layer
    gen = tseq2seq.build(**SMALL, is_generating=True)
    assert gen.kind == "beam_search" and gen.name == "decoder_group"
    g = layer.GeneratedInput(size=10, embedding_size=4)
    assert (g.size, g.embedding_size) == (10, 4)
    enc = layer.data("enc", pt.data_type.dense_vector(3))

    def gstep(emb):
        mem = layer.memory(name="h", size=3, boot_layer=enc)
        nxt = layer.fc([emb, mem], 3, act="tanh", name="h")
        return layer.fc(nxt, 10, act="softmax", name="p")

    bs = layer.beam_search(gstep, [g], bos_id=0, eos_id=1, beam_size=2,
                           max_length=3, name="bs")
    bs_topo = pt.Topology(bs)
    outs, state = bs_topo.forward(
        pt.parameters.create(bs_topo, device="cpu").values, {},
        {"enc": np.ones((2, 3), np.float32)}, device="cpu")
    assert outs["bs"].shape == (2, 2, 3) and state["bs"]["scores"].shape \
        == (2, 2)
    doc = layer.data("doc", pt.data_type.dense_vector_sub_sequence(
        6, sub_max=2, max_len=4))
    assert layer.SubsequenceInput(doc).input is doc
    x = layer.data("x", pt.data_type.dense_vector_sequence(6, max_len=4))
    st = layer.data("st", pt.data_type.dense_vector(4))
    # the unfused attention composite is ported: it builds, under the
    # composite's names
    att = pt.networks.simple_attention(x, x, st, fused=False, name="att")
    assert att.kind == "seq_pool" and att.name == "att_context"

    def step(ipt):
        mem = layer.memory(name="s", size=2)
        return layer.gru_step_layer(ipt, mem, name="s")

    topo = pt.Topology(layer.sum_cost(layer.last_seq(
        layer.recurrent_group(step, x, name="grp"))))
    params = pt.parameters.create(topo, device="cpu")
    feed = {"x": np.random.RandomState(0).randn(1, 4, 6).astype(np.float32)}
    losses = []
    for remat in (True, False):
        monkeypatch.setitem(tconfig._options, "rnn_group_remat", remat)
        outs, _ = topo.forward(params.values, {}, feed, device="cpu")
        losses.append(outs[topo.output_names[0]])
    assert torch.equal(*losses)
    path = tmp_path / "cfg.py"
    path.write_text(CLI_CONFIG)
    monkeypatch.setitem(tconfig._options, "device", None)
    with pytest.raises(NotImplementedError, match="item 15"):
        cli.main(["train", "--job=checkgrad", "--config", str(path),
                  "--device", "cpu"])
