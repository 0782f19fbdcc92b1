"""The CRF and CTC layers of the PyTorch port against the JAX package on the
CPU: the CRF negative log-likelihood and its gradients, Viterbi paths (ties
included), the decoding error indicator, and the CTC loss and its
gradients on padded batches (repeated labels, an empty label, another
blank, ``norm_by_times``), from the same seeded numpy inputs and weights.
Tolerance: 1e-5 absolute and relative (float32 sums in another order);
paths equal exactly.  The host helpers ``ctc_greedy_decode`` and
``edit_distance`` give the JAX package's answers.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.layers import crf_ctc as jcc
from paddle_tpu_torch.layers import crf_ctc as tcc
from test_torch_layer_parity import assert_parity, both

TOL = dict(atol=1e-5, rtol=1e-5)


def _padded(rng, b, t, lo=1):
    lens = rng.randint(lo, t + 1, b)
    lens[0] = t
    return lens, (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)


def _crf_inputs(seed, b=5, t=7, c=6):
    rng = np.random.RandomState(seed)
    lens, mask = _padded(rng, b, t)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    y = rng.randint(0, c, (b, t)).astype(np.int32)
    w = (rng.standard_normal((c + 2, c)) * 0.5).astype(np.float32)
    return x, y, mask, w


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crf_nll_and_gradients_match_jax(seed):
    import jax
    import jax.numpy as jnp

    x, y, mask, w = _crf_inputs(seed)

    def jf(x_, w_):
        return jnp.sum(jcc._crf_nll(x_, jnp.asarray(y), jnp.asarray(mask),
                                    w_[0], w_[1], w_[2:]))

    jval, (jdx, jdw) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(w))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    nll = tcc.crf_nll(tx, torch.tensor(y).long(), torch.tensor(mask),
                      tw[0], tw[1], tw[2:])
    nll.sum().backward()
    np.testing.assert_allclose(nll.sum().item(), float(jval), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **TOL)


def _jax_viterbi(x, mask, w):
    """The JAX layer's decoded path on the same inputs."""
    import jax.numpy as jnp

    class Ctx:
        params_tree = {}

    return np.asarray(jcc.CRFDecodingLayer.apply_seq(
        {}, {"w": jnp.asarray(w)}, [jnp.asarray(x)], [jnp.asarray(mask)],
        Ctx()))


@pytest.mark.parametrize("seed", [0, 3, 4])
def test_viterbi_paths_equal_jax(seed):
    x, _, mask, w = _crf_inputs(seed, b=8, t=9, c=5)
    got = tcc.viterbi(torch.tensor(x), torch.tensor(mask),
                      *(torch.tensor(v) for v in (w[0], w[1], w[2:])))
    np.testing.assert_array_equal(got.numpy(), _jax_viterbi(x, mask, w))


def test_viterbi_ties_take_the_first_maximum():
    """Zero emissions and transitions: every path scores the same, and
    both packages take the first maximum at each step (tag 0); half-tied
    scores pick the lower tag too."""
    b, t, c = 3, 5, 4
    x = np.zeros((b, t, c), np.float32)
    x[1, :, 2:] = 1.0                      # tags 2 and 3 tie at every step
    w = np.zeros((c + 2, c), np.float32)
    mask = np.ones((b, t), np.float32)
    mask[2, 3:] = 0.0
    got = tcc.viterbi(torch.tensor(x), torch.tensor(mask),
                      *(torch.tensor(v) for v in (w[0], w[1], w[2:])))
    want = _jax_viterbi(x, mask, w)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[1] == 2).all() and (want[0] == 0).all()


def _crf_config(paddle, with_label=True, weighted=False):
    layer = paddle.layer
    dt = paddle.data_type
    emis = layer.data("e", dt.dense_vector_sequence(6, max_len=7))
    tags = layer.data("t", dt.integer_value_sequence(6, max_len=7))
    proj = layer.fc(emis, size=6, name="proj")
    w = layer.data("wt", dt.dense_vector(1)) if weighted else None
    cost = layer.crf(proj, tags, weight=w, name="crf")
    dec = layer.crf_decoding(proj, param_layer="crf", name="dec")
    outs = [cost, dec]
    if with_label:
        outs.append(layer.crf_decoding(proj, label=tags, param_layer=cost,
                                       name="dec_err"))
    return outs


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["mean", "weighted"])
def test_crf_layers_in_a_topology_match_jax(weighted):
    """crf, crf_decoding sharing its transitions (by name and by layer),
    and the decoding error indicator with a label input: outputs and
    every gradient, padded."""
    ttopo, jtopo, values = both(lambda p: _crf_config(p, weighted=weighted))
    assert list(values) == ["proj", "crf"]
    assert values["crf"]["w"].shape == (8, 6)
    rng = np.random.RandomState(5)
    lens, _ = _padded(rng, 4, 7)
    feed = {"e": rng.standard_normal((4, 7, 6)).astype(np.float32),
            "e@len": lens.astype(np.int32),
            "t": rng.randint(0, 6, (4, 7)).astype(np.int32),
            "t@len": lens.astype(np.int32)}
    if weighted:
        feed["wt"] = rng.uniform(0.5, 2.0, (4, 1)).astype(np.float32)
    outs = assert_parity(ttopo, jtopo, values, feed)
    assert outs["dec"].dtype == torch.int32
    err = outs["dec_err"].numpy()
    assert set(np.unique(err)) <= {0.0, 1.0}
    assert err[3, lens[3]:].sum() == 0.0


def _ctc_inputs(seed, b=6, t=10, c=5, s=4, blank=0):
    rng = np.random.RandomState(seed)
    tlens, tmask = _padded(rng, b, t, lo=s + 1)
    llens = rng.randint(0, s + 1, b)
    llens[0] = s
    lmask = (np.arange(s)[None, :] < llens[:, None]).astype(np.float32)
    ids = [i for i in range(c) if i != blank]
    label = rng.choice(ids, (b, s)).astype(np.int32)
    label[1, :2] = label[1, 0]                  # a repeat: no skip
    logits = rng.standard_normal((b, t, c)).astype(np.float32)
    return logits, tmask, label, lmask


@pytest.mark.parametrize("blank", [0, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_loss_and_gradients_match_jax(seed, blank):
    """Padded frames and labels, an empty label sequence (row 2), a
    repeated label (row 1): the loss per sequence and the logits'
    gradient."""
    import jax
    import jax.numpy as jnp

    logits, tmask, label, lmask = _ctc_inputs(seed, blank=blank)
    lmask[2] = 0.0                              # an empty label sequence

    def jf(lg):
        return jnp.sum(jcc.ctc_loss(lg, jnp.asarray(tmask),
                                    jnp.asarray(label), jnp.asarray(lmask),
                                    blank=blank))

    jval, jgrad = jax.jit(jax.value_and_grad(jf))(jnp.asarray(logits))
    jper = np.asarray(jcc.ctc_loss(jnp.asarray(logits), jnp.asarray(tmask),
                                   jnp.asarray(label), jnp.asarray(lmask),
                                   blank=blank))
    tl = torch.tensor(logits, requires_grad=True)
    per = tcc.ctc_loss(tl, torch.tensor(tmask), torch.tensor(label),
                       torch.tensor(lmask), blank=blank)
    per.sum().backward()
    assert np.isfinite(per.detach().numpy()).all()
    np.testing.assert_allclose(per.detach().numpy(), jper, **TOL)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jgrad), **TOL)


@pytest.mark.parametrize("norm", [False, True], ids=["sum", "norm_by_times"])
def test_ctc_layer_matches_jax(norm):
    """``ctc`` (and its ``warp_ctc`` alias) over a projected padded
    sequence: the cost and every gradient."""
    def cfg(paddle):
        layer, dt = paddle.layer, paddle.data_type
        x = layer.data("x", dt.dense_vector_sequence(6, max_len=9))
        lab = layer.data("lab", dt.integer_value_sequence(5, max_len=3))
        logits = layer.fc(x, size=5, name="logits")
        fn = layer.warp_ctc if norm else layer.ctc
        return fn(logits, lab, blank=4, norm_by_times=norm, name="ctc")

    ttopo, jtopo, values = both(cfg)
    rng = np.random.RandomState(7)
    feed = {"x": rng.standard_normal((5, 9, 6)).astype(np.float32),
            "x@len": np.array([9, 7, 8, 9, 7], np.int32),
            "lab": rng.randint(0, 4, (5, 3)).astype(np.int32),
            "lab@len": np.array([3, 1, 2, 3, 2], np.int32)}
    assert_parity(ttopo, jtopo, values, feed)


def test_host_helpers_match_jax():
    rng = np.random.RandomState(3)
    for _ in range(30):
        ids = rng.randint(0, 4, rng.randint(0, 12))
        assert tcc.ctc_greedy_decode(ids, blank=0) == \
            jcc.ctc_greedy_decode(ids, blank=0)
        a = list(rng.randint(0, 3, rng.randint(0, 7)))
        b = list(rng.randint(0, 3, rng.randint(0, 7)))
        assert tcc.edit_distance(a, b) == jcc.edit_distance(a, b)
    assert tcc.edit_distance([1, 2, 3], [1, 3]) == 1
    assert tcc.ctc_greedy_decode([0, 1, 1, 0, 1, 2, 2]) == [1, 1, 2]
