"""The precision policy of the PyTorch port (paddle_tpu_torch/core/
precision.py through Topology, the layers, the optimizers and
trainer.SGD) against the JAX package on the CPU.

Counterparts of tests/test_mixed_precision.py and tests/test_float16.py
(the names, aliases and legacy warning; fp32 bit-equal to no policy;
mixed into the float32 loss band; the overflow skip, backoff and growth;
the clamps; fp16 on a kernel-free MLP), where the JAX package's metric
gauge reads the loss scale these tests read the trainer's state.  Then
the models of the slice, the transformer LM (2 layers, width 64, 2
heads, L 32), the seq2seq NMT model (vocab 50 / 40, emb 16, enc 24, dec
32, lengths <= 6) and the LSTM route (two lstmemory(peephole=False) of
width 24), from the same numpy-seeded weights in both packages under
``bf16``, ``mixed`` and ``fp16``: every layer's output dtype equal, its
values within one bf16 ulp (two float16 ulps under ``fp16``), the first
step's gradients and a 5-step Adam trajectory; the LM once more on the
port's kernel route, its kernels stood in for by their plain versions
(the tensor-core backward's arithmetic, ``_mma_bwd``, at bf16 and
float16), against the JAX package on its Pallas kernels under the
interpreter.  The reduced-precision GELU bit for bit against the jitted
JAX one.  And the float16 operands: the nine kernel wrappers with a
float16 instance take their ``*_f16`` entry, the two without one (kernel
4, the forward sweep) refuse it; bf16 reaches kernels 7a to 9 and the
conv layers (ResNet under ``bf16`` and ``fp16`` is in
tests/test_torch_resnet_bf16.py).

Tolerances, from readings on the CPU: bf16 layer outputs within
2^-8 * max(1, max |ref|) (one bf16 ulp at the top of the range; read:
bit-equal), float32 ones within 1e-5; first-step gradients within
2^-7 * max(1, max |g|) (read: at most 1.6e-3 on the LM, 4.9e-4 on the
NMT model, 3e-8 on the LSTM route: the bf16 backward's sums taken in
another order) and, each leaf against its own scale, within 2^-4 of the
leaf's norm (read, ||port - jax|| / ||jax||: at most 3.7e-2 on the LM,
at attn_1.wk, whose gradient norm at initialisation is 2.4e-4, then
3.1e-2 at attn_1.wq and 1.8e-2 at logits.b; 8.3e-3 on the NMT model, at
encoded_sequence.b_bw; 1.6e-7 on the LSTM route; a wrong backward for a
leaf is off by its whole norm); losses within 2e-3 relative over 5 steps (read: at most
7.6e-5 on the LM and the NMT model, 6.0e-4 on the LSTM route, where the
JAX package's jitted trainer and its own eager forward, which the port
matches exactly, already differ by that much on the first loss: XLA
rounds the fused bf16 ops of a jitted step differently from eager ones).
"""

import importlib
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.core import config as jconfig
from paddle_tpu.core import precision as jprecision
from paddle_tpu.core.ir import reset_name_counters as reset_jax_names
from paddle_tpu.models import seq2seq as jseq2seq
from paddle_tpu.models import transformer as jt
from paddle_tpu_torch.core import config as tconfig
from paddle_tpu_torch.core import precision as tprecision
from paddle_tpu_torch.core.ir import reset_name_counters as reset_port_names
from paddle_tpu_torch.models import seq2seq as tseq2seq
from paddle_tpu_torch.models import transformer as tt

BF16_ULP = 2.0 ** -8
F16_LAYER_TOL = 2.0 ** -9
ULP = {torch.bfloat16: BF16_ULP}
_DTYPE_NAME = {"bf16": "bfloat16", "fp16": "float16"}
GRAD_TOL = 2.0 ** -7
GRAD_LEAF_RTOL = 2.0 ** -4
TRAJ_RTOL = 2e-3
LM = dict(vocab_size=50, max_len=32, dim=64, num_heads=2, num_layers=2)
NMT = dict(src_vocab_size=50, trg_vocab_size=40, emb_dim=16, enc_dim=24,
           dec_dim=32, max_src_len=6, max_trg_len=6)


@pytest.fixture(autouse=True)
def _restore_options():
    """Every test leaves both packages' options (the policy among them)
    as it found them."""
    topts, jopts = dict(tconfig._options), dict(jconfig._options)
    warned = (tprecision._legacy_warned, jprecision._legacy_warned)
    yield
    for mod, saved in ((tconfig, topts), (jconfig, jopts)):
        mod._options.clear()
        mod._options.update(saved)
    jconfig._policy_cache = None
    tprecision._legacy_warned, jprecision._legacy_warned = warned


# ------------------------------------------------------------- the policy
@pytest.mark.parametrize("name", ["fp32", "bf16", "fp16", "mixed",
                                  "float32", "bfloat16", "float16"])
def test_policy_resolves_as_the_jax_package(name):
    """Each name and dtype alias resolves to the JAX package's policy,
    field for field, and to the same signature."""
    opts = {"precision": name, "loss_scale_growth_interval": 7}
    tp, jp = tprecision.resolve(opts), jprecision.resolve(opts)
    assert tp.__dict__ == jp.__dict__
    assert tp.signature() == jp.signature()
    cdt = tp.ctx_compute_dtype()
    assert (cdt is None) == (jp.ctx_compute_dtype() is None)
    if cdt is not None:
        assert str(cdt) == "torch." + str(jp.ctx_compute_dtype().dtype)


def test_unknown_precision_rejected():
    for init in (pj.init, lambda **kw: pt.init(device="cpu", **kw)):
        with pytest.raises(ValueError, match="unknown precision"):
            init(seed=0, precision="int8")
    assert pt.PRECISIONS == ("fp32", "bf16", "fp16", "mixed")


def test_compute_dtype_alias_maps_to_policy_and_warns_once():
    tprecision._legacy_warned = False
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        pt.init(seed=0, device="cpu", compute_dtype="bfloat16")
        assert any(issubclass(x.category, DeprecationWarning) for x in w)
    pol = tconfig.precision_policy()
    assert (pol.name, pol.compute_dtype, pol.loss_scaling) == (
        "bf16", "bfloat16", False)
    assert tconfig.get_option("compute_dtype") == "bfloat16"
    assert tconfig.compute_dtype() == torch.bfloat16
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        pt.init(seed=0, device="cpu", compute_dtype="float32")
        assert not any(issubclass(x.category, DeprecationWarning)
                       for x in w)
    assert tconfig.precision_policy().name == "fp32"
    # the later spelling wins a mixed call, as in the JAX package
    pt.init(seed=0, device="cpu", compute_dtype="bfloat16",
            precision="mixed")
    assert tconfig.precision_policy().name == "mixed"
    pt.init(seed=0, device="cpu", precision="mixed",
            compute_dtype="bfloat16")
    assert tconfig.precision_policy().name == "bf16"


def test_precision_fingerprints_differ():
    sigs = set()
    for name in ("fp32", "bf16", "mixed"):
        pt.init(seed=0, device="cpu", precision=name)
        sigs.add(tconfig.precision_policy().signature())
    assert len(sigs) == 3


def test_fc_activation_dtype_follows_compute_dtype():
    from paddle_tpu_torch.core.registry import ApplyContext, get_layer_def

    fcdef = get_layer_def("fc")
    for dt in (torch.bfloat16, torch.float16):
        out = fcdef.apply({"size": 2, "bias": True},
                          {"w0": torch.ones(4, 2), "b": torch.ones(2)},
                          [torch.ones(3, 4)],
                          ApplyContext(train=False, compute_dtype=dt))
        assert out.dtype == dt
    out = fcdef.apply({"size": 2, "bias": False}, {"w0": torch.ones(4, 2)},
                      [torch.ones(3, 4)], ApplyContext(train=False))
    assert out.dtype == torch.float32


# ------------------------------------------------ the MLP and loss scaling
def _mlp(paddle, seed=0, bn=False, **init_kwargs):
    """tests/test_mixed_precision.py's MLP in either package (``bn``: a
    batch norm on the input, so the step carries model state)."""
    if paddle is pt:
        reset_port_names()
        pt.init(seed=seed, device="cpu", **init_kwargs)
    else:
        reset_jax_names()
        pj.init(seed=seed, **init_kwargs)
    layer = paddle.layer
    x = layer.data("x", paddle.data_type.dense_vector(8))
    y = layer.data("y", paddle.data_type.integer_value(3))
    h = layer.batch_norm(x) if bn else x
    h = layer.fc(h, size=16, act="relu")
    cost = layer.classification_cost(layer.fc(h, size=3), y)
    if paddle is pt:
        topo = pt.Topology(cost)
    else:
        topo = pj.Topology(cost, collect_evaluators=False)
    params = paddle.parameters.create(topo)
    trainer = paddle.trainer.SGD(
        topo, params, paddle.optimizer.Momentum(learning_rate=0.1,
                                                momentum=0.9))
    return topo, params, trainer


def _data(n=64):
    rng = np.random.RandomState(0)
    xs = rng.randn(n, 8).astype(np.float32)
    ys = (xs[:, 0] > 0).astype(np.int32) + (xs[:, 1] > 0)
    return [(xs[i], int(ys[i])) for i in range(n)]


def _train(paddle, trainer, samples, num_passes=3, batch=16):
    costs = []
    trainer.train(
        paddle.reader.batched(lambda: iter(samples), batch),
        num_passes=num_passes,
        event_handler=lambda ev: costs.append(float(ev.cost))
        if isinstance(ev, paddle.event.EndIteration) else None,
        feeding={"x": 0, "y": 1})
    return costs


def _leaves(trainer):
    return {(l, p): v.detach().clone() for l, ps in trainer._trainable.items()
            for p, v in ps.items() if v is not None}


def _slots(trainer):
    return {(l, p, k): s.clone()
            for l, ps in trainer._opt_state["slots"].items()
            for p, ss in ps.items() for k, s in ss.items()}


def test_fp32_policy_bit_equal_to_default():
    samples = _data()
    _, _, tr_default = _mlp(pt)            # no precision argument at all
    _train(pt, tr_default, samples)
    _, _, tr_fp32 = _mlp(pt, precision="fp32")
    costs = _train(pt, tr_fp32, samples)
    a, b = _leaves(tr_default), _leaves(tr_fp32)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert "loss_scale" not in tr_fp32._opt_state
    assert tr_fp32._opt_state["t"] == 12        # a host int, as before
    assert np.isfinite(costs[-1])


def test_mixed_trains_to_fp32_loss_band():
    samples = _data()
    _, _, tr32 = _mlp(pt, precision="fp32")
    c32 = _train(pt, tr32, samples, num_passes=6)
    _, _, trmx = _mlp(pt, precision="mixed")
    cmx = _train(pt, trmx, samples, num_passes=6)
    assert "loss_scale" in trmx._opt_state
    assert cmx[-1] < cmx[0]
    # the same loss band, not bit-equality: bf16 rounding is the point
    assert abs(cmx[-1] - c32[-1]) < 0.15, (c32[-1], cmx[-1])
    # masters and slots stay float32
    for v in list(_leaves(trmx).values()) + list(_slots(trmx).values()):
        assert v.dtype == torch.float32


def _inf_feed(topo, paddle):
    xs = np.random.RandomState(0).randn(16, 8).astype(np.float32)
    xs[0, 0] = np.inf
    return paddle.data_feeder.DataFeeder(topo, {"x": 0, "y": 1}).feed(
        [(xs[i], 1) for i in range(16)])


def test_overflow_skips_update_and_halves_scale():
    """A planted inf sample: the step is skipped bit for bit (parameters,
    Momentum slots, the step counter and the batch norm's moving
    statistics), the scale halves, ``skipped`` counts it; the reported
    loss is the unscaled one (inf)."""
    topo, _, tr = _mlp(pt, bn=True, precision="mixed")
    _train(pt, tr, _data(32), num_passes=1)     # 2 clean steps: slots live
    before, slots = _leaves(tr), _slots(tr)
    state = {(l, k): v.clone() for l, ks in tr.model_state.items()
             for k, v in ks.items()}
    assert state and all(torch.isfinite(v).all() for v in state.values())
    ls = {k: v.clone() for k, v in tr._opt_state["loss_scale"].items()}
    t = tr._opt_state["t"].clone()
    loss = tr._step(_inf_feed(topo, pt))
    assert not torch.isfinite(loss)
    for k, v in _leaves(tr).items():
        assert torch.equal(v, before[k]), k
    for k, v in _slots(tr).items():
        assert torch.equal(v, slots[k]), k
    for (l, k), v in state.items():
        assert torch.equal(tr.model_state[l][k], v), (l, k)
    assert torch.equal(tr._opt_state["t"], t) and int(t) == 2
    new = tr._opt_state["loss_scale"]
    assert float(new["scale"]) == float(ls["scale"]) * 0.5
    assert int(new["skipped"]) == 1 and int(new["good_steps"]) == 0
    # the next clean step goes through again
    tr._step(pt.data_feeder.DataFeeder(topo, {"x": 0, "y": 1}).feed(
        _data(16)))
    assert int(tr._opt_state["t"]) == 3
    assert int(tr._opt_state["loss_scale"]["good_steps"]) == 1


def test_scale_recovers_after_growth_interval():
    _, _, tr = _mlp(pt, precision="mixed", loss_scale_growth_interval=2)
    _train(pt, tr, _data(16), num_passes=1)      # 1 clean step
    assert not isinstance(tr._opt_state["t"], int)
    init = float(tr._opt_state["loss_scale"]["scale"])
    assert int(tr._opt_state["loss_scale"]["good_steps"]) == 1
    _train(pt, tr, _data(16), num_passes=1)      # the 2nd clean step
    grown = float(tr._opt_state["loss_scale"]["scale"])
    assert grown == init * 2.0, (init, grown)
    assert int(tr._opt_state["loss_scale"]["good_steps"]) == 0


@pytest.mark.parametrize("bound", ["min", "max"])
def test_scale_clamps_at_its_bounds(bound):
    """A backoff from min_scale stays at min_scale; a growth from
    max_scale stays at max_scale."""
    if bound == "min":
        topo, _, tr = _mlp(pt, precision="mixed", loss_scale_init=4.0,
                           loss_scale_min=4.0)
        tr._step(_inf_feed(topo, pt))
        assert int(tr._opt_state["loss_scale"]["skipped"]) == 1
        assert float(tr._opt_state["loss_scale"]["scale"]) == 4.0
    else:
        _, _, tr = _mlp(pt, precision="mixed", loss_scale_init=2.0 ** 10,
                        loss_scale_max=2.0 ** 10,
                        loss_scale_growth_interval=1)
        _train(pt, tr, _data(32), num_passes=1)
        assert float(tr._opt_state["loss_scale"]["scale"]) == 2.0 ** 10
        assert int(tr._opt_state["loss_scale"]["skipped"]) == 0


def test_mixed_loss_scale_state_matches_jax():
    """The same MLP from the same weights in both packages under
    ``mixed``, with an inf sample in the second of four batches and a
    growth interval of 2: the losses (2e-3 relative; read: 3.2e-4) and,
    after every step, the scale, the clean-step count and the skip count
    equal."""
    samples = _data(64)
    samples[20] = (np.full(8, np.inf, np.float32), 1)
    kw = dict(precision="mixed", loss_scale_growth_interval=2)
    jtopo, jparams, jtr = _mlp(pj, **kw)
    ttopo, _, _ = _mlp(pt, **kw)
    tparams = pt.parameters.from_numpy(ttopo, jparams.values, device="cpu")
    ttr = pt.trainer.SGD(ttopo, tparams, pt.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9))
    logs = {}
    for name, paddle, tr in (("jax", pj, jtr), ("port", pt, ttr)):
        pol = (jconfig if paddle is pj else tconfig).precision_policy()
        assert pol.loss_scaling
        log = logs[name] = []

        def handler(ev, tr=tr, log=log, paddle=paddle):
            if isinstance(ev, paddle.event.EndIteration):
                ls = tr._opt_state["loss_scale"]
                log.append((float(ev.cost), float(ls["scale"]),
                            int(ls["good_steps"]), int(ls["skipped"])))

        tr.train(paddle.reader.batched(lambda: iter(samples), 16),
                 event_handler=handler, feeding={"x": 0, "y": 1})
    jlog, tlog = logs["jax"], logs["port"]
    assert len(tlog) == len(jlog) == 4
    assert [r[1:] for r in tlog] == [r[1:] for r in jlog]
    assert tlog[1][3] == 1 and not np.isfinite(tlog[1][0])
    for (tl, *_), (jl, *_) in zip(tlog, jlog):
        if np.isfinite(jl):
            assert abs(tl - jl) <= TRAJ_RTOL * abs(jl), (tlog, jlog)


@pytest.mark.parametrize("spelling", [dict(precision="fp16"),
                                      dict(compute_dtype="float16")])
def test_fp16_trains_a_kernel_free_mlp(spelling):
    """fp16 resolves and trains the MLP (no kernel on its path), with
    float32 masters: the counterpart of tests/test_float16.py."""
    topo, _, tr = _mlp(pt, **spelling)
    assert tconfig.precision_policy().name == "fp16"
    with torch.no_grad():
        outs, _ = topo.forward(
            tr.parameters.values, {},
            pt.data_feeder.DataFeeder(topo, {"x": 0, "y": 1}).feed(
                _data(4)),
            outputs=[[s.name for s in topo.specs if s.kind == "fc"][-1]],
            device="cpu")
    assert next(iter(outs.values())).dtype == torch.float16
    costs = _train(pt, tr, _data(), num_passes=6)
    assert costs[-1] < costs[0], (costs[0], costs[-1])
    for v in _leaves(tr).values():
        assert v.dtype == torch.float32


# ----------------------------------------------------------------- GELU
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_gelu_is_jitted_jax_gelu_bit_for_bit(dtype):
    """The port's reduced-precision GELU against ``jax.jit(jax.nn.gelu)``,
    which the JAX package's jitted steps evaluate, on 100,000 seeded
    normals at four scales: bit for bit (at float16 XLA's CPU backend
    contracts ``x + 0.044715 x^3`` into one float32 multiply-add; the port
    evaluated it op by op before, and read 464 to 640 of 100,000 one ulp
    off at scales 1 and 3).  The float16 gradient, autograd through those
    ops against ``jax.vjp`` of the jitted GELU, which XLA fuses and rounds
    elsewhere, is not bit-equal, nor within one ulp: each element within
    two float16 ulps of the largest |ref| (readings over 8 seeds and these
    scales: 1 to 2 ulps; bf16's gradient differs as much in its own
    ulps)."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu_torch.activation import _gelu

    tdt = getattr(torch, dtype)
    fwd = jax.jit(jax.nn.gelu)
    vjp = jax.jit(lambda x, g: jax.vjp(jax.nn.gelu, x)[1](g)[0])
    rng = np.random.default_rng(0)
    for scale in (0.1, 1.0, 3.0, 10.0):
        x = (rng.standard_normal(100_000) * scale).astype(np.float32)
        g = rng.standard_normal(100_000).astype(np.float32)
        want = np.asarray(fwd(jnp.asarray(x, dtype)).astype(jnp.float32))
        xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
        got = _gelu(xt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.detach().float().numpy(), want)
        if dtype != "float16":
            continue
        got.backward(torch.from_numpy(g).to(tdt))
        want_g = np.asarray(vjp(jnp.asarray(x, dtype), jnp.asarray(
            g, dtype)).astype(jnp.float32))
        ulp = float(np.spacing(np.float16(np.abs(want_g).max())))
        assert np.abs(xt.grad.float().numpy() - want_g).max() <= 2 * ulp, (
            scale)


def test_gelu_float32_is_unchanged():
    """At float32 the port's GELU is ``F.gelu``'s tanh form, untouched by
    the float16 repair."""
    import torch.nn.functional as F

    from paddle_tpu_torch.activation import _gelu

    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        10_000).astype(np.float32) * 3)
    assert torch.equal(_gelu(x), F.gelu(x, approximate="tanh"))


# ----------------------------------------------------- the slice's models
def _lm_build(paddle):
    return (tt if paddle is pt else jt).build(**LM)[0]


def _nmt_build(paddle):
    return (tseq2seq if paddle is pt else jseq2seq).build(**NMT)


def _lm_feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, 50, (3, 32)).astype(np.int32),
            "targets": rng.randint(0, 50, (3, 32)).astype(np.int32),
            "tokens@len": np.array([32, 20, 7], np.int32)}


def _nmt_feed(seed=0):
    rng = np.random.RandomState(seed)
    trg_len = np.array([3, 6, 1, 5], np.int32)
    return {"source_words": rng.randint(0, 50, (4, 6)).astype(np.int32),
            "source_words@len": np.array([6, 1, 4, 5], np.int32),
            "target_words": rng.randint(0, 40, (4, 6)).astype(np.int32),
            "target_words@len": trg_len,
            "target_next_words": rng.randint(0, 40, (4, 6)).astype(
                np.int32),
            "target_next_words@len": trg_len}


def _lstm_build(paddle):
    """The LSTM route (``bench_lstm``'s graph with peephole off), small."""
    layer = paddle.layer
    words = layer.data("data", paddle.data_type.integer_value_sequence(
        50, max_len=7))
    net = layer.embedding(words, size=16, vocab_size=50)
    for _ in range(2):
        net = layer.lstmemory(layer.fc(net, size=4 * 24, act=None,
                                       bias_attr=False), peephole=False)
    lab = layer.data("label", paddle.data_type.integer_value(2))
    return layer.classification_cost(layer.fc(layer.last_seq(net), size=2),
                                     lab)


def _lstm_feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"data": rng.randint(0, 50, (4, 7)).astype(np.int32),
            "data@len": np.array([7, 1, 4, 6], np.int32),
            "label": rng.randint(0, 2, 4).astype(np.int32)}


MODELS = {"lm": (_lm_build, _lm_feed), "nmt": (_nmt_build, _nmt_feed),
          "lstm_route": (_lstm_build, _lstm_feed)}


def _both(model, precision):
    """The model in both packages under ``precision``, and the JAX
    package's parameters (vectors made random) as numpy."""
    build, _ = MODELS[model]
    reset_jax_names()
    reset_port_names()
    pj.init(seed=0, precision=precision)
    pt.init(seed=0, device="cpu", precision=precision)
    jtopo = pj.Topology(build(pj), collect_evaluators=False)
    ttopo = pt.Topology(build(pt))
    assert ttopo.proto() == jtopo.proto()
    rng = np.random.default_rng(1)
    values = {l: {p: (np.asarray(v) if v.ndim == 2 else
                      rng.standard_normal(v.shape).astype(np.float32) * 0.3)
                  for p, v in ps.items()}
              for l, ps in pj.parameters.create(jtopo).values.items()}
    return jtopo, ttopo, values


def _and_fp16(values):
    """``(value, precision)`` parameters: each value under ``bf16`` with
    its own id, then under ``fp16`` as ``<value>-fp16``."""
    return ([pytest.param(v, "bf16", id=v) for v in values]
            + [pytest.param(v, "fp16", id=f"{v}-fp16") for v in values])


@pytest.mark.parametrize("model,precision", _and_fp16(sorted(MODELS)))
def test_bf16_layer_dtypes_and_values_match_jax(model, precision):
    """Under ``bf16``, every layer's output in both packages from the same
    weights and feed: the same dtype exactly (the guard against the two
    frameworks' promotion rules), bf16 values within one bf16 ulp of
    max(1, max |ref|), float32 ones within 1e-5.  Under ``fp16`` the same
    dtypes, and every value, float16 or float32, within F16_LAYER_TOL
    (two float16 ulps) of max(1, max |ref|): the float32 sums of the
    LayerNorm and the recurrences are taken in another order than XLA's
    (up to 3.6e-7), which now and then moves a float16 rounding by one
    ulp, as bf16's coarser grid does not, and later layers carry it
    (readings: at most 1.7 ulps, the LM's ffn_up1)."""
    import jax.numpy as jnp

    jtopo, ttopo, values = _both(model, precision)
    feed = MODELS[model][1]()
    names = [s.name for s in ttopo.specs if s.kind != "data"]
    jouts, _ = jtopo.forward(values, {}, feed, train=True, outputs=names)
    tparams = pt.parameters.from_numpy(ttopo, values, device="cpu")
    with torch.no_grad():
        touts, _ = ttopo.forward(tparams.values, {}, feed, train=True,
                                 outputs=names, device="cpu")
    kinds = set()
    for n in names:
        j, t = jouts[n], touts[n]
        assert str(t.dtype) == "torch." + str(j.dtype), (n, t.dtype,
                                                         j.dtype)
        kinds.add(str(j.dtype))
        want = np.asarray(j.astype(jnp.float32))
        err = np.abs(t.float().numpy() - want).max()
        tol = (F16_LAYER_TOL if precision == "fp16"
               else ULP.get(t.dtype, 1e-5)) * max(1.0, np.abs(want).max())
        assert err <= tol, (n, err, tol)
    assert kinds == {_DTYPE_NAME[precision], "float32"}


def _grads_jax(jtopo, values, feed):
    import jax

    def loss(v):
        outs, _ = jtopo.forward(v, {}, feed, train=True)
        return outs[jtopo.output_names[0]]

    return jax.grad(loss)(values)


@pytest.mark.parametrize("precision", ["bf16", "mixed", "fp16"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_training_matches_jax(model, precision):
    """From the same weights under ``precision``: the first step's
    gradients (float32 in both; the port's unscaled through the trainer's
    loss scale under ``mixed``) within 2^-7 of max(1, max |g|) and each
    leaf within 2^-4 of its own norm, then 5
    Adam steps of ``SGD.train`` on one batch with losses within 2e-3
    relative; masters and Adam slots float32 throughout."""
    _hold_training(model, precision)


@pytest.mark.parametrize("fwd_impl,precision",
                         _and_fp16(["upcast", "mma"]))
def test_lm_bf16_kernel_route_matches_jax_pallas(monkeypatch, fwd_impl,
                                                 precision):
    """The small LM under ``bf16`` (and ``fp16``: the float16 instances'
    arithmetic, P and dS rounded to float16) on the port's kernel route
    (``_FlashAttention``), each kernel stood in for by its plain version
    with the kernel's arithmetic: the forward by
    ``_torch_attention_upcast`` (the Pallas forward's arithmetic) or by
    ``_mma_fwd`` (the tensor-core forward's: P rounded to bf16 before
    P . V), both backward kernels by ``_mma_bwd`` (P and dS rounded to
    bf16, as the tensor-core kernels do), against the JAX package on its
    Pallas kernels under the interpreter (``default_impl`` patched to
    "interpret"): the limits of ``test_training_matches_jax``.  With
    ``_mma_fwd`` a leaf whose gradient is below the rounding noise of a
    bf16 P is held within twice the JAX package's own spread on it, the
    distance between its xla route (P rounded to bf16, as here) and its
    Pallas route: ``attn_1``'s wq and wk (norms 2.7e-4 and 3.0e-4) read
    0.48 and 0.45 of their norm here, 0.65 each between the JAX package's
    two routes; every other leaf within GRAD_LEAF_RTOL as before."""
    from paddle_tpu_torch.ops import flash_attention as tfa

    jfa = importlib.import_module("paddle_tpu.ops.flash_attention")
    calls = []

    def fwd(q, k, v, kv_lens, *, causal, scale, q_offset=0, kv_offset=0):
        calls.append(("fwd", q.dtype))
        kw = dict(causal=causal, scale=scale, q_offset=q_offset,
                  kv_offset=kv_offset)
        if fwd_impl == "mma":
            return tfa._mma_fwd(q, k, v, kv_lens, **kw)
        return tfa._torch_attention_upcast(q, k, v, kv_lens,
                                           return_lse=True, **kw)

    def bwd(which):
        def run(q, k, v, g, lse, delta, kv_lens, **kw):
            calls.append((which, g.dtype))
            # O = 0 and g_lse = -delta: _mma_bwd's delta is the wrapper's
            dq, dk, dv = tfa._mma_bwd(q, k, v, kv_lens, torch.zeros_like(q),
                                      lse, g, -delta, **kw)
            return dq if which == "dq" else (dk, dv)
        return run

    def interpret():
        calls.append(("jax", "interpret"))
        return "interpret"

    def xla_grads(jtopo, values, feed):
        with monkeypatch.context() as m:
            m.setattr(jfa, "default_impl", lambda: "xla")
            return _grads_jax(jtopo, values, feed)

    monkeypatch.setattr(jfa, "default_impl", interpret)
    monkeypatch.setattr(tfa, "resolve_impl", lambda impl, t: "cuda")
    monkeypatch.setattr(tfa, "flash_fwd_cuda", fwd)
    monkeypatch.setattr(tfa, "flash_bwd_dq_cuda", bwd("dq"))
    monkeypatch.setattr(tfa, "flash_bwd_dkdv_cuda", bwd("dkdv"))
    _hold_training("lm", precision,
                   spread_grads=xla_grads if fwd_impl == "mma" else None)
    dt = torch.float16 if precision == "fp16" else torch.bfloat16
    assert set(calls) == {("fwd", dt), ("dq", dt), ("dkdv", dt),
                          ("jax", "interpret")}


def _hold_training(model, precision, spread_grads=None):
    """The comparison of ``test_training_matches_jax``.  With
    ``spread_grads(jtopo, values, feed)``, the JAX package's gradients on
    another of its routes, each leaf is held within the larger of
    GRAD_LEAF_RTOL and twice the two JAX routes' distance on it."""
    jtopo, ttopo, values = _both(model, precision)
    feed = MODELS[model][1]()
    jgrads = _grads_jax(jtopo, values, feed)
    alt = None if spread_grads is None else spread_grads(jtopo, values, feed)
    tr = pt.trainer.SGD(ttopo, pt.parameters.from_numpy(ttopo, values,
                                                        device="cpu"),
                        pt.optimizer.Adam(learning_rate=1e-3))
    policy = tr._sync_precision_policy()
    scale = (tr._opt_state["loss_scale"]["scale"]
             if policy.loss_scaling else None)
    _, tgrads = tr.forward_backward(feed, scale=scale)
    assert sorted(tgrads) == sorted(jgrads)
    for lname, ps in tgrads.items():
        for pname, g in ps.items():
            want = np.asarray(jgrads[lname][pname])
            assert g.dtype == torch.float32
            err = np.abs(g.numpy() - want).max()
            assert err <= GRAD_TOL * max(1.0, np.abs(want).max()), (
                lname, pname, err)
            dist = np.linalg.norm(g.numpy().astype(np.float64) - want)
            rtol = GRAD_LEAF_RTOL
            if alt is not None:
                rtol = max(rtol, 2 * np.linalg.norm(
                    np.asarray(alt[lname][pname]).astype(np.float64) - want)
                    / np.linalg.norm(want))
            assert dist <= rtol * np.linalg.norm(want), (
                lname, pname, dist / np.linalg.norm(want), rtol)

    jparams = pj.parameters.create(jtopo)
    for key in jparams.keys():
        layer, _, pname = key.rpartition(".")
        jparams[key] = values[layer][pname]
    logs = {"jax": [], "port": []}
    for name, paddle, trainer in (
            ("jax", pj, pj.trainer.SGD(jtopo, jparams, pj.optimizer.Adam(
                learning_rate=1e-3))),
            ("port", pt, pt.trainer.SGD(
                ttopo, pt.parameters.from_numpy(ttopo, values,
                                                device="cpu"),
                pt.optimizer.Adam(learning_rate=1e-3)))):
        trainer.train(lambda: iter([feed] * 5), event_handler=(
            lambda ev, log=logs[name], paddle=paddle: log.append(
                float(ev.cost))
            if isinstance(ev, paddle.event.EndIteration) else None))
        if name == "port":
            assert ("loss_scale" in trainer._opt_state) == (
                precision == "mixed")
            for ps in trainer._trainable.values():
                assert all(v.dtype == torch.float32 for v in ps.values())
            for ps in trainer._opt_state["slots"].values():
                for ss in ps.values():
                    assert all(s.dtype == torch.float32
                               for s in ss.values())
    assert len(logs["port"]) == 5 and logs["port"][-1] < logs["port"][0]
    np.testing.assert_allclose(logs["port"], logs["jax"], rtol=TRAJ_RTOL)


# ------------------------------------------------------------- refusals
def _fp16_calls():
    """Every kernel wrapper, called with a float16 operand of a shape it
    would otherwise take: the nine with a float16 instance at the
    combination the fp16 path gives them, the two without one
    (``_NO_F16``) as they would be called."""
    from paddle_tpu_torch.ops import (conv_bn, flash_attention, flash_variants,
                                      fused_bn, fused_rnn, paged_attention)

    h = torch.float16
    q = torch.zeros(1, 8, 1, 8, dtype=h)
    lens = torch.full((1,), 8, dtype=torch.int32)
    lse = torch.zeros(1, 1, 8)
    bw = dict(causal=True, scale=1.0)
    x4 = torch.zeros(2, 4, 4, 8, dtype=h)
    q64 = torch.zeros(1, 64, 1, 64, dtype=h)
    return {
        "flash_fwd": lambda: flash_attention.flash_fwd_cuda(
            q, q, q, lens, **bw),
        "flash_bwd_dkdv": lambda: flash_attention.flash_bwd_dkdv_cuda(
            q, q, q, q, lse, lse, lens, **bw),
        "flash_bwd_dq": lambda: flash_attention.flash_bwd_dq_cuda(
            q, q, q, q, lse, lse, lens, **bw),
        "paged_decode": lambda: paged_attention.paged_decode_cuda(
            torch.zeros(1, 1, 8, dtype=h), torch.zeros(2, 4, 1, 8),
            torch.zeros(2, 4, 1, 8), torch.ones(1, 2, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), scale=1.0, kv_splits=1),
        "lstm_step": lambda: fused_rnn.lstm_step_cuda(
            torch.zeros(2, 32, dtype=h), torch.zeros(2, 8),
            torch.zeros(2, 8), torch.zeros(8, 32), torch.zeros(32),
            torch.ones(2, 1)),
        "gru_step": lambda: fused_rnn.gru_step_cuda(
            torch.zeros(2, 24, dtype=h), torch.zeros(2, 8),
            torch.zeros(8, 16), torch.zeros(8, 8), torch.zeros(24),
            torch.ones(2, 1, dtype=h)),
        "bn_fwd_stats": lambda: fused_bn.bn_fwd_stats_cuda(
            torch.zeros(16, 8, dtype=h)),
        "bn_bwd_stats": lambda: fused_bn.bn_bwd_stats_cuda(
            torch.zeros(16, 8, dtype=h), torch.zeros(16, 8, dtype=h),
            torch.ones(8), torch.zeros(8), torch.zeros(8), torch.ones(8),
            True),
        "matmul_stats": lambda: conv_bn.matmul_stats_cuda(
            torch.zeros(16, 8, dtype=h), torch.zeros(8, 8, dtype=h)),
        "conv3x3_stats": lambda: conv_bn.conv3x3_stats_cuda(
            x4, torch.zeros(3, 3, 8, 8, dtype=h)),
        "flash_variants": lambda: flash_variants.run_fwd_cuda(
            q64, q64, q64, causal=True, block_q=64, block_k=64, bf16_dots=True,
            use_exp2=True, split_loop=False, pipelined=False),
    }


# the wrappers with no float16 instance (ROADMAP.md section 2, K5)
_NO_F16 = ("flash_variants", "paged_decode")
# the C entry each other wrapper's float16 call above must take
_F16_ENTRIES = {
    "flash_fwd": "flash_fwd_f16", "flash_bwd_dkdv": "flash_bwd_dkdv_f16",
    "flash_bwd_dq": "flash_bwd_dq_f16", "lstm_step": "lstm_step_f16",
    "gru_step": "gru_step_f16_mf16", "bn_fwd_stats": "bn_fwd_stats_f16",
    "bn_bwd_stats": "bn_bwd_stats_f16", "matmul_stats": "matmul_stats_f16",
    "conv3x3_stats": "conv3x3_stats_f16"}


@pytest.mark.parametrize("kernel", _NO_F16)
def test_float16_operand_raises_at_every_kernel_wrapper(kernel):
    """Where no float16 instance exists (kernel 4 and the forward sweep,
    ``ROADMAP.md`` section 2, K5) a float16 operand raises TypeError naming
    the row, before anything is built; it never takes the plain route."""
    from paddle_tpu_torch import ops

    ops.reset_launch_counts()
    with pytest.raises(TypeError, match="K5"):
        _fp16_calls()[kernel]()
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("kernel", sorted(_F16_ENTRIES))
def test_float16_operand_takes_the_f16_entry(kernel, monkeypatch):
    """Each of the nine wrappers with a float16 instance, given the fp16
    path's operands, launches its ``*_f16`` C entry (``_build.load``
    stubbed: nothing is built or run here) and counts the launch under
    ``<name>_f16`` and in its total, not under ``<name>_bf16``."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops import _build, conv_bn, fused_bn

    called = []

    class _Lib:
        def __getattr__(self, entry):
            return lambda *args: called.append(entry) or 0

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "load", lambda name, signatures: _Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    for mod in (fused_bn, conv_bn):
        monkeypatch.setattr(mod, "on_card", lambda x: None)
    ops.reset_launch_counts()
    _fp16_calls()[kernel]()
    assert called == [_F16_ENTRIES[kernel]]
    counts = ops.launch_counts()
    assert (counts[kernel], counts[kernel + "_f16"],
            counts[kernel + "_bf16"]) == (1, 1, 0)
    assert sum(counts.values()) == 2


def test_bf16_reaches_kernels_7a_to_9_and_the_conv_layers():
    """Kernels 7a, 7b, 8 and 9 take bf16 operands: on a CPU tensor each
    wrapper's route takes its plain version (bf16 y, float32 sums) and
    counts no launch; the launch wrappers themselves still raise on a CPU
    tensor; and the conv layers compute under ``bf16``, their outputs
    bf16."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.core.registry import ApplyContext, get_layer_def
    from paddle_tpu_torch.ops import conv_bn, fused_bn

    b = torch.bfloat16
    ops.reset_launch_counts()
    x2 = torch.randn(16, 8).to(b)
    v = torch.ones(8)
    s, sq = fused_bn.fwd_stats(x2)
    assert s.dtype == sq.dtype == torch.float32
    sdy, sdyx = fused_bn.bwd_stats(x2, x2, v, v * 0, v * 0, v, True)
    assert sdy.dtype == sdyx.dtype == torch.float32
    y, s, ss = conv_bn.matmul_stats(x2, torch.randn(8, 4).to(b))
    assert y.dtype == b and s.dtype == ss.dtype == torch.float32
    y, s, ss = conv_bn.conv3x3_stats(torch.randn(2, 4, 4, 8).to(b),
                                     torch.randn(3, 3, 8, 4).to(b))
    assert y.dtype == b and s.dtype == ss.dtype == torch.float32
    assert not any(ops.launch_counts().values())
    for fn, args in (
            (fused_bn.bn_fwd_stats_cuda, (x2,)),
            (fused_bn.bn_bwd_stats_cuda, (x2, x2, v, v, v, v, True)),
            (conv_bn.matmul_stats_cuda, (x2, torch.zeros(8, 8, dtype=b))),
            (conv_bn.conv3x3_stats_cuda,
             (torch.zeros(2, 4, 4, 8, dtype=b),
              torch.zeros(3, 3, 8, 8, dtype=b)))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)
    with pytest.raises(ValueError, match="CUDA"):
        conv_bn.matmul_stats(x2, torch.zeros(8, 8, dtype=b), "cuda")
    assert not any(ops.launch_counts().values())
    ctx = ApplyContext(train=True, compute_dtype=b)
    x = torch.randn(2, 4, 4, 8)
    out = get_layer_def("conv").apply(
        {"num_filters": 8, "filter_size": 1},
        {"w": torch.randn(1, 1, 8, 8), "b": torch.zeros(8)}, [x], ctx)
    assert out.dtype == b
    ctx.state_in, ctx._cur_layer = {"l": {
        "moving_mean": torch.zeros(8), "moving_var": torch.ones(8)}}, "l"
    out = get_layer_def("conv_bn").apply(
        {"num_filters": 8, "filter_size": 3},
        {"w": torch.randn(3, 3, 8, 8), "scale": torch.ones(8),
         "bias": torch.zeros(8)}, [x], ctx)
    assert out.dtype == b
    assert ctx.state_out["l"]["moving_mean"].dtype == torch.float32


CLI_CONFIG = '''
import numpy as np
import paddle_tpu_torch as paddle
from paddle_tpu_torch.models import transformer

paddle.init(seed=0)
cost, _ = transformer.build(vocab_size=50, max_len=8, dim=32, num_heads=2,
                            num_layers=1)
optimizer = paddle.optimizer.Adam(learning_rate=1e-3)
rng = np.random.RandomState(0)
rows = [(rng.randint(0, 50, 8).tolist(), rng.randint(0, 50, 8).tolist())
        for _ in range(4)]
train_reader = paddle.batch(lambda: iter(rows), 2)
feeding = {"tokens": 0, "targets": 1}
'''


@pytest.mark.parametrize("precision", ["bf16", "mixed", "fp16"])
def test_cli_train_takes_precision(precision, tmp_path, capsys):
    """``train --precision`` is accepted and wins over the config's own
    ``init``: the policy is active while the trainer runs, and the
    costs are finite."""
    from paddle_tpu_torch import cli

    path = tmp_path / "cfg.py"
    path.write_text(CLI_CONFIG)
    reset_port_names()
    cli.main(["train", "--config", str(path), "--num_passes", "1",
              "--log_period", "1", "--device", "cpu", "--precision",
              precision])
    assert tconfig.precision_policy().name == precision
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("Pass 0, Batch")]
    assert len(lines) == 2
    assert all(np.isfinite(float(l.rsplit(" ", 1)[1])) for l in lines)
