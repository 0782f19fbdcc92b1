"""The LM's three generate paths in the PyTorch port
(paddle_tpu_torch/models/transformer.py: ``greedy_generate``,
``incremental_generate``, ``beam_generate``) against the JAX package's on
the CPU, from the same weights: a small LM (vocab 48, dim 32, 2 heads, 2
layers, max_len 16) whose JAX parameters are carried across by tar.

In float32 the port's greedy re-forward and its KV-cache decode give the
same token streams, with and without ``eos_id``, and each equals the JAX
package's; the beam ids equal the JAX package's and the beam scores agree
within 1e-5 (float32 log-probabilities summed over the steps in another
order).  A checkpoint's numpy tree decodes on the ``device`` option's
device, the card unless the caller asked for the CPU."""

import io

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.core.ir import reset_name_counters as reset_jax_names
from paddle_tpu.models import transformer as jtr
from paddle_tpu_torch.core import config as port_config
from paddle_tpu_torch.core.ir import reset_name_counters as reset_port_names
from paddle_tpu_torch.io import checkpoint
from paddle_tpu_torch.models import transformer as ttr

LM = dict(vocab_size=48, max_len=16, dim=32, num_heads=2, num_layers=2)
PROMPTS = np.random.RandomState(3).randint(0, 48, (3, 4)).astype(np.int32)
MAX_NEW = 6
SCORE_TOL = 1e-5


@pytest.fixture(scope="module")
def lm():
    """(port topology, port Parameters, JAX topology, JAX Parameters)
    from the same weights."""
    reset_jax_names()
    reset_port_names()
    pj.init(seed=0)
    pt.init(seed=0, device="cpu")
    jcost, jlogits = jtr.build(**LM)
    jtopo = pj.Topology(jcost, extra_inputs=[jlogits],
                        collect_evaluators=False)
    jparams = pj.parameters.create(jtopo)
    tcost, tlogits = ttr.build(**LM)
    ttopo = pt.Topology(tcost, extra_inputs=[tlogits])
    buf = io.BytesIO()
    jparams.to_tar(buf)
    buf.seek(0)
    tparams = pt.parameters.create(ttopo, device="cpu")
    tparams.from_tar(buf)
    return ttopo, tparams, jtopo, jparams


def test_greedy_and_incremental_equal_each_other_and_jax(lm):
    ttopo, tparams, jtopo, jparams = lm
    greedy = ttr.greedy_generate(ttopo, tparams, PROMPTS, max_new=MAX_NEW)
    incr = ttr.incremental_generate(ttopo, tparams, PROMPTS,
                                    max_new=MAX_NEW)
    assert greedy.shape == (3, 4 + MAX_NEW) and greedy.dtype == np.int32
    np.testing.assert_array_equal(greedy[:, :4], PROMPTS)
    np.testing.assert_array_equal(greedy, incr)
    np.testing.assert_array_equal(
        incr, jtr.incremental_generate(jtopo, jparams, PROMPTS,
                                       max_new=MAX_NEW))
    np.testing.assert_array_equal(
        greedy, jtr.greedy_generate(jtopo, jparams.values, PROMPTS,
                                    max_new=MAX_NEW))


def test_eos_row_keeps_emitting_eos(lm):
    """eos is a token row 0 emits mid-stream: after it, that row emits
    only eos; the other rows are as the JAX package's."""
    ttopo, tparams, jtopo, jparams = lm
    free = ttr.incremental_generate(ttopo, tparams, PROMPTS,
                                    max_new=MAX_NEW)
    eos = int(free[0, 4 + 2])
    greedy = ttr.greedy_generate(ttopo, tparams, PROMPTS, max_new=MAX_NEW,
                                 eos_id=eos)
    incr = ttr.incremental_generate(ttopo, tparams, PROMPTS,
                                    max_new=MAX_NEW, eos_id=eos)
    np.testing.assert_array_equal(greedy, incr)
    first = 4 + int(np.argmax(free[0, 4:] == eos))
    assert (incr[0, first:] == eos).all()
    np.testing.assert_array_equal(
        incr, jtr.incremental_generate(jtopo, jparams, PROMPTS,
                                       max_new=MAX_NEW, eos_id=eos))


@pytest.mark.parametrize("eos", [None, "emitted"])
def test_beam_matches_jax(lm, eos):
    ttopo, tparams, jtopo, jparams = lm
    eos_id = None
    if eos:
        ids, _ = ttr.beam_generate(ttopo, tparams, PROMPTS, max_new=MAX_NEW,
                                   beam_size=3)
        eos_id = int(ids[0, 0, 1])         # the best beam's second token
    ids, scores = ttr.beam_generate(ttopo, tparams, PROMPTS,
                                    max_new=MAX_NEW, beam_size=3,
                                    eos_id=eos_id)
    jids, jscores = jtr.beam_generate(jtopo, jparams, PROMPTS,
                                      max_new=MAX_NEW, beam_size=3,
                                      eos_id=eos_id)
    assert ids.shape == (3, 3, MAX_NEW) and scores.shape == (3, 3)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(scores, jscores, atol=SCORE_TOL, rtol=0)
    assert (np.diff(scores, axis=1) <= 0).all()      # best first
    # beam 0 of the one-beam search is the greedy stream
    one, _ = ttr.beam_generate(ttopo, tparams, PROMPTS, max_new=MAX_NEW,
                               beam_size=1, eos_id=eos_id)
    np.testing.assert_array_equal(
        one[:, 0], ttr.incremental_generate(ttopo, tparams, PROMPTS,
                                            max_new=MAX_NEW,
                                            eos_id=eos_id)[:, 4:])


def test_generate_limits(lm):
    ttopo, tparams, _, _ = lm
    for fn in (ttr.greedy_generate, ttr.incremental_generate,
               ttr.beam_generate):
        with pytest.raises(ValueError, match="exceeds max_len"):
            fn(ttopo, tparams, PROMPTS, max_new=13)
    np.testing.assert_array_equal(
        ttr.incremental_generate(ttopo, tparams, PROMPTS, max_new=0),
        PROMPTS)
    with pytest.raises(ValueError, match="max_new >= 1"):
        ttr.beam_generate(ttopo, tparams, PROMPTS, max_new=0)


def test_checkpoint_tree_decodes_on_the_device_option(lm, tmp_path,
                                                      monkeypatch):
    """A loaded snapshot's numpy tree goes to the ``device`` option's
    device: the CPU when ``init`` named it, else the card, which raises
    with no card rather than decoding on the CPU; ``Parameters`` decode
    where they lie."""
    ttopo, tparams, _, _ = lm
    checkpoint.save_params(str(tmp_path), tparams.values)
    tree = checkpoint.params_of(checkpoint.load(str(tmp_path)))
    assert not any(torch.is_tensor(t) for ps in tree.values()
                   for t in ps.values())
    want = ttr.incremental_generate(ttopo, tparams, PROMPTS,
                                    max_new=MAX_NEW)
    for fn in (ttr.greedy_generate, ttr.incremental_generate):
        np.testing.assert_array_equal(
            fn(ttopo, tree, PROMPTS, max_new=MAX_NEW), want)
    ids, _ = ttr.beam_generate(ttopo, tree, PROMPTS, max_new=MAX_NEW,
                               beam_size=1)
    np.testing.assert_array_equal(ids[:, 0], want[:, 4:])

    monkeypatch.setitem(port_config._options, "device", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (ttr.greedy_generate, ttr.incremental_generate,
               ttr.beam_generate):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(ttopo, tree, PROMPTS, max_new=2)
        fn(ttopo, tparams, PROMPTS, max_new=2)
