"""The v2 layers, costs and sequence layers of the PyTorch port
(paddle_tpu_torch) against the JAX package on the CPU: forward and every
parameter and input gradient from the same weights
(``parameters.from_numpy``) and the same seeded numpy feeds.

Each golden config of ``tests/torch_layer_configs.py`` runs
full and with padded sequences; the configs below cover what the goldens
do not (lambda_cost, the conv projections and operator, data_norm, the
self-normalised and multi-label costs, weighted costs over a padded
sequence, the unfused attention composite, the misc math layers).
Tolerance: 1e-5 absolute and relative on every output and gradient
(float32 sums in another order); NCE's negatives are the port's, handed
to the JAX layer through ``jax.random.randint``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
import torch_layer_configs as layer_configs
from paddle_tpu.core.ir import reset_name_counters as reset_jax_names
from paddle_tpu.models import transformer as jt
from paddle_tpu_torch.core.ir import reset_name_counters as reset_port_names
from paddle_tpu_torch.models import transformer as tt

TOL = dict(atol=1e-5, rtol=1e-5)
SEED = 11


def _build(fn, paddle, reset):
    reset()
    paddle.init(seed=0, **({"device": "cpu"} if paddle is pt else {}))
    outs = fn(paddle)
    return outs if isinstance(outs, (list, tuple)) else [outs]


def golden(name):
    """The golden config ``name`` as ``fn(paddle)``, given each package
    its own LM builder."""
    lm = {pt: tt, pj: jt}
    return lambda paddle: layer_configs.CONFIGS[name](paddle, lm[paddle])


def both(fn):
    """(port topology, JAX topology, JAX parameter values) of ``fn``."""
    touts = _build(fn, pt, reset_port_names)
    jouts = _build(fn, pj, reset_jax_names)
    ttopo = pt.Topology(touts)
    jtopo = pj.Topology(jouts, collect_evaluators=False)
    assert ttopo.proto() == jtopo.proto()
    jparams = pj.parameters.create(jtopo)
    values = {l: {p: np.asarray(v) for p, v in ps.items()}
              for l, ps in jparams.values.items()}
    return ttopo, jtopo, values


def _scalar_sum(outs):
    total = 0.0
    for v in outs.values():
        if v.ndim == 0:
            total = total + v
    return total


def port_run(ttopo, values, feed, *, train=False, generator=None,
             state=None):
    """(outputs, parameter grads, float-feed grads) of the port."""
    params = pt.parameters.from_numpy(ttopo, values, device="cpu").values
    leaves = {}
    for l, ps in params.items():
        for p, t in ps.items():
            params[l][p] = leaves[(l, p)] = t.detach().requires_grad_(True)
    tfeed = {}
    for k, v in feed.items():
        t = torch.as_tensor(v)
        if t.dtype == torch.float32 and not k.endswith("@len"):
            t = t.clone().requires_grad_(True)
        tfeed[k] = t
    state = state or ttopo.create_state(device="cpu")
    outs, _ = ttopo.forward(params, state, tfeed, train=train,
                            generator=generator, device="cpu")
    wrt = list(leaves.values()) + [t for t in tfeed.values()
                                   if t.requires_grad]
    total = _scalar_sum(outs)
    grads = (torch.autograd.grad(total, wrt, allow_unused=True)
             if total.requires_grad else [None] * len(wrt))
    pgrads = dict(zip(leaves, grads[:len(leaves)]))
    fgrads = {k: g for (k, t), g in zip(
        [(k, t) for k, t in tfeed.items() if t.requires_grad],
        grads[len(leaves):])}
    return outs, pgrads, fgrads


def jax_run(jtopo, values, feed, *, train=False, rng=None, state=None):
    import jax
    import jax.numpy as jnp

    fkeys = [k for k, v in feed.items()
             if np.asarray(v).dtype == np.float32 and not k.endswith("@len")]

    def f(vals, fvals):
        fd = dict(feed)
        fd.update(fvals)
        outs, _ = jtopo.forward(vals, state or jtopo.create_state(), fd,
                                train=train, rng=rng)
        return _scalar_sum(outs), outs

    jvals = {l: {p: jnp.asarray(v) for p, v in ps.items()}
             for l, ps in values.items()}
    fvals = {k: jnp.asarray(feed[k]) for k in fkeys}
    (_, outs), (pgrads, fgrads) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jvals, fvals)
    return outs, pgrads, fgrads


def assert_parity(ttopo, jtopo, values, feed, tol=TOL, **kw):
    jkw = {k: v for k, v in kw.items() if k in ("train", "rng")}
    tkw = {k: v for k, v in kw.items() if k in ("train", "generator")}
    touts, tp, tf = port_run(ttopo, values, feed, **tkw)
    jouts, jp, jf = jax_run(jtopo, values, feed, **jkw)
    assert sorted(touts) == sorted(jouts)
    for name, v in touts.items():
        np.testing.assert_allclose(v.detach().float().numpy(),
                                   np.asarray(jouts[name], np.float32),
                                   err_msg=name, **tol)
    for (l, p), g in tp.items():
        want = np.asarray(jp[l][p])
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, err_msg=f"{l}.{p}", **tol)
    for k, g in tf.items():
        want = np.asarray(jf[k])
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, err_msg=f"d{k}", **tol)
    return touts


GOLDENS = sorted(set(layer_configs.CONFIGS) - layer_configs.PROTO_ONLY
                 - {"sampling_costs"})


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
@pytest.mark.parametrize("name", GOLDENS)
def test_golden_config_matches_jax(name, padded):
    ttopo, jtopo, values = both(golden(name))
    feed = layer_configs.feed(ttopo, batch=4, seed=SEED, padded=padded,
                              name=name)
    assert_parity(ttopo, jtopo, values, feed,
                  train=name in layer_configs.TRAIN)


def test_sampling_costs_match_jax_on_the_ports_negatives(monkeypatch):
    """NCE on the negatives the port drew (the JAX layer takes them
    through ``jax.random.randint``) and hsigmoid beside it."""
    import jax
    import jax.numpy as jnp

    ttopo, jtopo, values = both(golden("sampling_costs"))
    feed = layer_configs.feed(ttopo, batch=6, seed=SEED)
    drawn = torch.randint(0, 100, (5,),
                          generator=torch.Generator().manual_seed(7))
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(
                            drawn.numpy(), jnp.int32))
    assert_parity(ttopo, jtopo, values, feed,
                  generator=torch.Generator().manual_seed(7),
                  rng=jax.random.PRNGKey(0))
    # the port draws from the generator it is given and from nothing else
    with pytest.raises(ValueError, match="rng"):
        port_run(ttopo, values, feed)


def test_operators_config_builds_and_its_operators_match_jax():
    """the ``operators`` golden pins only its JSON; its conv and dotmul
    operators run here under a sum cost."""
    def cfg(paddle):
        layer, dv = paddle.layer, paddle.data_type.dense_vector
        img = layer.data("image", dv(2 * 6 * 6), height=6, width=6)
        flt = layer.data("flt", dv(3 * 2 * 3 * 3))
        a = layer.data("a", dv(8))
        b = layer.data("b", dv(8))
        m = layer.mixed(None, [layer.conv_operator(
            img, flt, filter_size=3, num_filters=3, padding=1)],
            name="convop")
        m2 = layer.mixed(None, [layer.conv_operator(
            img, flt, filter_size=3, num_filters=3, num_channels=2,
            stride=2)], name="convop2")
        d = layer.mixed(8, [layer.dotmul_operator(a, b, scale=2.0)],
                        name="dotop")
        return [layer.sum_cost(m, name="c1"), layer.sum_cost(m2, name="c2"),
                layer.sum_cost(d, name="c3")]

    ttopo, jtopo, values = both(cfg)
    assert_parity(ttopo, jtopo, values, layer_configs.feed(ttopo, seed=3))


def test_conv_projections_match_jax():
    def cfg(paddle):
        layer, dv = paddle.layer, paddle.data_type.dense_vector
        img = layer.data("image", dv(3 * 6 * 6), height=6, width=6)
        c = layer.mixed(None, [layer.conv_projection(
            img, filter_size=3, num_filters=4, padding=1)], name="cp")
        g = layer.mixed(None, [layer.conv_projection(
            img, filter_size=3, num_filters=3, stride=2, groups=3)],
            name="cpg")
        t = layer.mixed(None, [layer.conv_projection(
            img, filter_size=2, num_filters=2, stride=2, trans=True)],
            name="ct")
        t1 = layer.mixed(None, [layer.conv_projection(
            img, filter_size=3, num_filters=2, stride=2, padding=1,
            trans=True)], name="ct1")
        return [layer.sum_cost(x, name=f"c_{x.name}") for x in (c, g, t, t1)]

    ttopo, jtopo, values = both(cfg)
    assert_parity(ttopo, jtopo, values, layer_configs.feed(ttopo, seed=4))


def test_lambda_cost_matches_jax():
    """NDCG forward and the LambdaRank backward (an autograd Function
    here, a custom vjp there), over padded query lists."""
    def cfg(paddle):
        layer, dt = paddle.layer, paddle.data_type
        x = layer.data("x", dt.dense_vector_sequence(6, max_len=7))
        s = layer.data("score", dt.dense_vector_sequence(1, max_len=7))
        o = layer.fc(x, size=1, name="o")
        return [layer.lambda_cost(o, s, NDCG_num=3, name="lc"),
                layer.lambda_cost(o, s, NDCG_num=5, max_sort_size=4,
                                  name="lc4")]

    ttopo, jtopo, values = both(cfg)
    for padded in (False, True):
        feed = layer_configs.feed(ttopo, batch=5, seed=5, padded=padded)
        feed["score"] = np.random.RandomState(6).randint(
            0, 4, feed["score"].shape).astype(np.float32)
        assert_parity(ttopo, jtopo, values, feed)


def test_more_costs_match_jax():
    def cfg(paddle):
        layer, dt = paddle.layer, paddle.data_type
        x = layer.data("x", dt.dense_vector(12))
        lbl = layer.data("label", dt.integer_value(6))
        multi = layer.data("multi", dt.dense_vector(6))
        soft = layer.data("soft", dt.dense_vector(6))
        w = layer.data("w", dt.dense_vector(1))
        logits = layer.fc(x, size=6, name="logits")
        probs = layer.fc(x, size=6, act="softmax", name="probs")
        return [
            layer.cross_entropy_with_selfnorm(logits, lbl, name="sn"),
            layer.cross_entropy_with_selfnorm(
                probs, lbl, softmax_selfnorm_alpha=0.3, name="sn_prob"),
            layer.multi_binary_label_cross_entropy_cost(logits, multi,
                                                        name="mbce"),
            layer.cross_entropy_cost(probs, soft, soft_label=True,
                                     name="soft_ce"),
            layer.rank_cost(layer.fc(x, size=1, name="l"),
                            layer.fc(x, size=1, name="r"), w, weight=w,
                            name="rank_w"),
            layer.mse_cost(logits, multi, name="mse"),
        ]

    ttopo, jtopo, values = both(cfg)
    feed = layer_configs.feed(ttopo, batch=5, seed=7)
    rng = np.random.RandomState(8)
    feed["multi"] = rng.randint(0, 2, (5, 6)).astype(np.float32)
    soft = rng.random_sample((5, 6)).astype(np.float32)
    feed["soft"] = soft / soft.sum(1, keepdims=True)
    feed["w"] = rng.random_sample((5, 1)).astype(np.float32)
    assert_parity(ttopo, jtopo, values, feed)


def test_mask_weighted_costs_over_a_padded_sequence_match_jax():
    """cross_entropy and mse_cost folded over a padded sequence take the
    mask as their per-token weight, as classification_cost does."""
    def cfg(paddle):
        layer, dt = paddle.layer, paddle.data_type
        x = layer.data("x", dt.dense_vector_sequence(5, max_len=6))
        lbl = layer.data("label", dt.integer_value_sequence(4, max_len=6))
        tgt = layer.data("tgt", dt.dense_vector_sequence(4, max_len=6))
        probs = layer.fc(x, size=4, act="softmax", name="probs")
        return [layer.cross_entropy_cost(probs, lbl, name="xent"),
                layer.mse_cost(layer.fc(x, size=4, name="reg"), tgt,
                               name="mse"),
                layer.classification_cost(probs, lbl, name="ce")]

    ttopo, jtopo, values = both(cfg)
    feed = layer_configs.feed(ttopo, batch=4, seed=9, padded=True)
    for k in ("label@len", "tgt@len"):
        feed.pop(k)
    assert_parity(ttopo, jtopo, values, feed)


def test_misc_layers_match_jax():
    def cfg(paddle):
        layer, dt = paddle.layer, paddle.data_type
        a = layer.data("a", dt.dense_vector(6))
        b = layer.data("b", dt.dense_vector(6))
        w = layer.data("w", dt.dense_vector(1))
        m = layer.data("m", dt.dense_vector(12))
        outs = [
            layer.cos_sim(a, b, scale=5.0, name="cos"),
            layer.scaling(w, a, name="sc"),
            layer.slope_intercept(a, slope=2.0, intercept=-0.5, name="si"),
            layer.interpolation(w, a, b, name="interp"),
            layer.bilinear_tensor_product(a, b, size=3, name="btp"),
            layer.trans(layer.reshape(m, (3, 4), name="rs"), name="tr"),
            layer.activation(a, "tanh", name="act"),
            layer.data_norm(a, data_norm_strategy="z-score", name="dn_z"),
            layer.data_norm(a, data_norm_strategy="min-max", name="dn_m"),
            layer.data_norm(a, data_norm_strategy="decimal-scaling",
                            name="dn_d"),
            layer.dropout(a, rate=0.3, name="drop_eval"),
        ]
        return [layer.sum_cost(layer.fc(o, size=2, name=f"h_{o.name}"),
                               name=f"c_{o.name}") for o in outs]

    ttopo, jtopo, values = both(cfg)
    rng = np.random.RandomState(10)
    for dn in ("dn_z", "dn_m", "dn_d"):     # statistics that are not 1s
        values[dn]["stats"] = rng.uniform(
            0.5, 2.0, values[dn]["stats"].shape).astype(np.float32)
    feed = layer_configs.feed(ttopo, batch=5, seed=12)
    assert_parity(ttopo, jtopo, values, feed)


def test_context_projection_with_trainable_padding_matches_jax():
    def cfg(paddle):
        layer, dt = paddle.layer, paddle.data_type
        x = layer.data("x", dt.dense_vector_sequence(3, max_len=6))
        c = layer.context_projection(x, context_len=4, context_start=-2,
                                     trainable_padding=True, name="ctx")
        c2 = layer.context_projection(x, context_len=3, context_start=0,
                                      trainable_padding=True, name="ctx2")
        return [layer.sum_cost(layer.pooling(p, pooling_type="sum"),
                               name=f"c_{p.name}") for p in (c, c2)]

    ttopo, jtopo, values = both(cfg)
    rng = np.random.RandomState(13)
    for name in ("ctx", "ctx2"):
        values[name]["pad"] = rng.standard_normal(
            values[name]["pad"].shape).astype(np.float32)
    for padded in (False, True):
        feed = layer_configs.feed(ttopo, batch=3, seed=14, padded=padded)
        assert_parity(ttopo, jtopo, values, feed)


def test_unfused_simple_attention_matches_jax():
    """simple_attention(fused=False): fc, expand, addto, seq_softmax,
    seq_scale and sum pooling, under the composite's names."""
    def cfg(paddle):
        layer, dt = paddle.layer, paddle.data_type
        enc = layer.data("enc", dt.dense_vector_sequence(6, max_len=5))
        st = layer.data("st", dt.dense_vector(4))
        proj = layer.fc(enc, size=7, act=None, bias_attr=False,
                        name="proj")
        ctx = paddle.networks.simple_attention(enc, proj, st, name="att")
        return layer.sum_cost(layer.fc(ctx, size=2, name="out"))

    ttopo, jtopo, values = both(cfg)
    assert "att_expand" in [s.name for s in ttopo.specs]
    for padded in (False, True):
        feed = layer_configs.feed(ttopo, batch=3, seed=15, padded=padded)
        assert_parity(ttopo, jtopo, values, feed)


def test_sequence_masks_written_by_layers_follow_jax():
    """seq_concat, seq_reshape and seq_slice write the output's mask,
    expand and seq_scale take their second input's: the masks the JAX
    forward reports are the port's, and none reaches the running state."""
    def cfg(paddle):
        layer, dt = paddle.layer, paddle.data_type
        a = layer.data("a", dt.dense_vector_sequence(4, max_len=5))
        b = layer.data("b", dt.dense_vector_sequence(4, max_len=3))
        v = layer.data("v", dt.dense_vector(4))
        cat = layer.seq_concat(a, b, name="cat")
        resh = layer.seq_reshape(a, 2, name="resh")
        sl = layer.seq_slice(a, 1, 4, name="sl")
        ex = layer.expand(v, b, name="ex")
        return [layer.sum_cost(layer.last_seq(x), name=f"c_{x.name}")
                for x in (cat, resh, sl, ex)] + [cat, resh, sl, ex]

    ttopo, jtopo, values = both(cfg)
    feed = layer_configs.feed(ttopo, batch=4, seed=16, padded=True)
    assert_parity(ttopo, jtopo, values, feed)
    _, jmasks = None, None
    jouts, _, jmasks = jtopo.forward(values, {}, feed, with_masks=True,
                                     outputs=["cat", "resh", "sl", "ex"])
    masks = {}
    real = ttopo._run_spec

    def spy(spec, params, vals, mk, ctx, **kw):
        real(spec, params, vals, mk, ctx, **kw)
        masks[spec.name] = mk[spec.name]

    ttopo._run_spec = spy
    try:
        _, new_state = ttopo.forward(
            pt.parameters.from_numpy(ttopo, values, device="cpu").values,
            {}, feed, device="cpu")
    finally:
        del ttopo._run_spec
    assert new_state == {}
    for name in ("cat", "resh", "sl", "ex"):
        np.testing.assert_array_equal(masks[name].numpy(),
                                      np.asarray(jmasks[name]))


def test_legacy_layer_names_cover_the_ported_entries_only():
    """Every ``*_layer`` alias of the JAX package whose entry is ported
    names the same function in the port; no alias names an unported
    one."""
    import paddle_tpu.layer as jl

    ported = set(pt.layer.__all__)
    legacy = {}
    for name in dir(jl):
        target = getattr(jl, name)
        if callable(target) and name != getattr(target, "__name__", name):
            legacy[name] = target.__name__
    checked = 0
    for alias, entry in legacy.items():
        if not (alias.endswith("_layer") or alias == "cos_sim"):
            continue
        if entry in ported:
            assert getattr(pt.layer, alias) is getattr(pt.layer, entry), alias
            checked += 1
        else:
            assert not hasattr(pt.layer, alias), alias
    assert checked >= 25
    for alias in ("nce", "cross_entropy", "regression_cost", "huber_cost",
                  "gru_step_naive",
                  "multi_binary_label_cross_entropy", "mse_cost"):
        assert getattr(pt.layer, alias).__name__ == getattr(
            jl, alias).__name__
