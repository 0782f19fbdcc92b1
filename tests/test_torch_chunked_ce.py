"""The fused LM head of the PyTorch port (``ops/chunked_ce.py``
``lm_head_nll``, ``layers/cost.py`` ``LmHeadCost``,
``transformer.build(fused_head=True)``) against the JAX package on the
CPU, from the same numpy-seeded weights.

- ``lm_head_nll`` against the JAX custom vjp at chunks that divide the
  rows, that do not, and that exceed them, under float32 and bf16
  operands, with a cotangent that is zero on some rows (padding): the nll
  within 1e-5 (float32 logits either way; sums in another order), dx, dw
  and db within 1e-5 at float32; under bf16 dx within one bf16 ulp of
  max(1, max |ref|) (2^-8: each is one rounding of a float32 sum), dw
  leaves as bf16 and within one bf16 ulp of the JAX gradient, element by
  element (the same rounding of float32 sums taken in another order), db
  float32 within 1e-5.
- The fused LM (2 layers, width 32, 2 heads, T 12, vocab 50) against its
  JAX twin, full and padded, under ``fp32`` (loss and every gradient
  within 1e-5) and ``bf16`` (the loss within 2e-3 relative, as
  tests/test_torch_precision.py holds the LM; each gradient within
  2^-6 * max(1, max |g|) and, against its own scale, within 2^-4 of the
  leaf's norm, that file's leaf limit: at this width the bf16 LM's
  gradients are noisier than at that file's, read on the CPU at most
  9.2e-3 of max(1, max |g|) with the fused head and 1.03e-2 with the
  unfused one against its own JAX twin, both at the embeddings, and at
  most 1.2e-2 of a leaf's norm), and against the port's unfused head from the same weights
  (1e-5 under ``fp32``; under ``bf16``, where the unfused head rounds
  its logits to bf16 and the fused one does not, the loss within 2^-7
  relative and the gradients within the bf16 limits above).
- Serving: a fused-head LM initialised in the JAX package, carried
  across, decodes the JAX ``PagedDecoder``'s greedy streams token for
  token in the port's.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.core import config as jconfig
from paddle_tpu.core.ir import reset_name_counters as reset_jax_names
from paddle_tpu.models import transformer as jt
from paddle_tpu_torch.core import config as tconfig
from paddle_tpu_torch.core.ir import reset_name_counters as reset_port_names
from paddle_tpu_torch.models import transformer as tt
from paddle_tpu_torch.ops.chunked_ce import chunk_rows, lm_head_nll

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_ULP = 2.0 ** -8
GRAD_TOL = 2.0 ** -6
GRAD_LEAF_RTOL = 2.0 ** -4
SMALL = dict(vocab_size=50, max_len=12, dim=32, num_heads=2, num_layers=2)


@pytest.fixture(autouse=True)
def _restore_options():
    topts, jopts = dict(tconfig._options), dict(jconfig._options)
    yield
    for mod, saved in ((tconfig, topts), (jconfig, jopts)):
        mod._options.clear()
        mod._options.update(saved)
    jconfig._policy_cache = None


def _bf16_round(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


def _head_inputs(n, d, v, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) / np.sqrt(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(v)).astype(np.float32)
    labels = rng.randint(0, v, n).astype(np.int32)
    g = rng.random_sample(n).astype(np.float32)
    g[n // 3:n // 2] = 0.0                        # padded rows
    return x, w, b, labels, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,chunk", [(24, 8), (29, 10), (20, 64), (5, 4)],
                         ids=["divides", "ragged", "exceeds", "below8"])
def test_lm_head_nll_matches_jax(n, chunk, dtype):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.ops.chunked_ce import lm_head_nll as jnll

    d, v = 16, 37
    x, w, b, labels, g = _head_inputs(n, d, v, seed=n)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    jout, vjp = jax.vjp(lambda a, c, e: jnll(a, c, e, jnp.asarray(labels),
                                             chunk), jx, jw, jnp.asarray(b))
    jdx, jdw, jdb = vjp(jnp.asarray(g))

    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    tw = torch.from_numpy(w).to(tdt).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    out = lm_head_nll(tx, tw, tb, torch.from_numpy(labels), chunk)
    assert out.dtype == torch.float32 and out.shape == (n,)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jdb), **TOL)
    assert tx.grad.dtype == tw.grad.dtype == tdt
    assert tb.grad.dtype == torch.float32
    dx, dw = tx.grad.float().numpy(), tw.grad.float().numpy()
    jdx = np.asarray(jdx, np.float32)
    jdw = np.asarray(jdw, np.float32)
    # padded rows (g = 0) get no gradient at all
    assert not dx[n // 3:n // 2].any()
    if dtype == "float32":
        np.testing.assert_allclose(dx, jdx, **TOL)
        np.testing.assert_allclose(dw, jdw, **TOL)
        return
    assert np.abs(dx - jdx).max() <= BF16_ULP * max(1.0, np.abs(jdx).max())
    # dw is rounded to bf16 on the way out, as the JAX vjp rounds it
    np.testing.assert_array_equal(dw, _bf16_round(dw))
    assert (np.abs(dw - jdw) <= BF16_ULP * np.abs(jdw) + 1e-30).all()


def test_chunk_rule_and_dtypes():
    """the JAX chunk rule, min(chunk, max(8, n)), and float32 logits from
    bf16 operands: the nll of the rounded operands, not of rounded
    logits."""
    assert [chunk_rows(c, n) for c, n in
            ((8192, 65536), (8192, 100), (16, 5), (4, 5))] == [
        8192, 100, 8, 4]
    x, w, b, labels, _ = _head_inputs(12, 16, 300, seed=1)
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    logits = xb.double() @ wb.double() + torch.from_numpy(b).double()
    ref = torch.logsumexp(logits, -1) - logits.gather(
        -1, torch.from_numpy(labels).long()[:, None])[:, 0]
    got = lm_head_nll(xb, wb, torch.from_numpy(b),
                      torch.from_numpy(labels), 5)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5,
                               rtol=1e-5)


# ------------------------------------------------------------ the fused LM
def _lms(fused=True, policy="fp32", **kw):
    reset_jax_names()
    reset_port_names()
    pj.init(seed=0, precision=policy)
    pt.init(seed=0, device="cpu", precision=policy)
    ct, lt = tt.build(fused_head=fused, **kw)
    cj, lj = jt.build(fused_head=fused, **kw)
    return (pt.Topology(ct, extra_inputs=[lt]),
            pj.Topology(cj, extra_inputs=[lj], collect_evaluators=False),
            ct.name, lt.name)


def _feed(padded, seed=0):
    rng = np.random.RandomState(seed)
    feed = {"tokens": rng.randint(0, 50, (3, 12)).astype(np.int32),
            "targets": rng.randint(0, 50, (3, 12)).astype(np.int32)}
    if padded:
        feed["tokens@len"] = np.array([12, 7, 3], np.int32)
    return feed


def _np_values(jparams):
    return {l: {p: np.asarray(v, np.float32) for p, v in ps.items()}
            for l, ps in jparams.values.items()}


def _hold_bf16_grad(got, want, what):
    assert np.abs(got - want).max() <= GRAD_TOL * max(
        1.0, np.abs(want).max()), what
    dist = np.linalg.norm(got.astype(np.float64) - want)
    assert dist <= GRAD_LEAF_RTOL * np.linalg.norm(want), what


def _port_grads(ttopo, values, feed, cost):
    tr = pt.trainer.SGD(ttopo, pt.parameters.from_numpy(ttopo, values,
                                                        device="cpu"),
                        pt.optimizer.Adam())
    loss, grads = tr.forward_backward(feed)
    return float(loss), grads


def test_fused_lm_builds_the_jax_graph():
    ttopo, jtopo, cost, logits = _lms(**SMALL)
    assert ttopo.proto() == jtopo.proto()
    assert (cost, logits) == ("logits", "logits_view")
    spec = ttopo.get_layer("logits")
    assert spec.kind == "lm_head_cost" and spec.attrs["chunk"] == 8192
    assert sorted(ttopo.param_specs["logits"][i].name
                  for i in range(2)) == ["b", "w0"]
    assert ttopo.param_specs["logits_view"] == []


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
def test_fused_lm_matches_jax(padded, policy):
    import jax

    ttopo, jtopo, cost, logits = _lms(policy=policy, **SMALL)
    jparams = pj.parameters.create(jtopo)
    values = _np_values(jparams)
    feed = _feed(padded)

    def jloss(vals):
        outs, _ = jtopo.forward(vals, {}, feed, train=True,
                                outputs=[cost])
        return outs[cost]

    jcost, jgrads = jax.jit(jax.value_and_grad(jloss))(jparams.values)
    tcost, tgrads = _port_grads(ttopo, values, feed, cost)
    assert sorted(tgrads) == sorted(jgrads)
    if policy == "fp32":
        np.testing.assert_allclose(tcost, float(jcost), **TOL)
    else:
        np.testing.assert_allclose(tcost, float(jcost), rtol=2e-3, atol=0)
    for lname, ps in tgrads.items():
        for pname, g in ps.items():
            want = np.asarray(jgrads[lname][pname], np.float32)
            got = g.float().numpy()
            if policy == "fp32":
                np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                           err_msg=f"{lname}.{pname}")
            else:
                _hold_bf16_grad(got, want, (lname, pname))
    # the logits view shares the head: the fused forward's logits are the
    # unfused fc's
    with torch.no_grad():
        outs, _ = ttopo.forward(
            pt.parameters.from_numpy(ttopo, values, device="cpu").values,
            {}, feed, outputs=[logits], device="cpu")
    jouts, _ = jtopo.forward(jparams.values, {}, feed, outputs=[logits])
    lim = 1e-5 if policy == "fp32" else GRAD_TOL * max(
        1.0, float(np.abs(np.asarray(jouts[logits], np.float32)).max()))
    assert np.abs(outs[logits].float().numpy()
                  - np.asarray(jouts[logits], np.float32)).max() <= lim


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_fused_head_matches_the_unfused_head(policy):
    """The same weights through lm_head_cost and through fc +
    classification_cost: the two parameter trees have the same names."""
    ft, _, fcost, _ = _lms(policy=policy, **SMALL)
    ut, ujt, ucost, _ = _lms(fused=False, policy=policy, **SMALL)
    values = _np_values(pj.parameters.create(ujt))
    feed = _feed(True, seed=3)
    fl, fg = _port_grads(ft, values, feed, fcost)
    ul, ug = _port_grads(ut, values, feed, ucost)
    assert sorted(fg) == sorted(ug)
    if policy == "fp32":
        np.testing.assert_allclose(fl, ul, **TOL)
        for l, ps in fg.items():
            for p, g in ps.items():
                np.testing.assert_allclose(g.numpy(), ug[l][p].numpy(),
                                           atol=1e-5, rtol=0,
                                           err_msg=f"{l}.{p}")
    else:
        np.testing.assert_allclose(fl, ul, rtol=2.0 ** -7, atol=0)
        for l, ps in fg.items():
            for p, g in ps.items():
                _hold_bf16_grad(g.float().numpy(), ug[l][p].float().numpy(),
                                (l, p))


def test_lm_head_cost_needs_the_mask_weight_and_keeps_no_logits():
    """lm_head_cost folds over the sequence with the mask as its weight,
    and its backward keeps the [N] logsumexp, never an [N, V] tensor."""
    ttopo, _, cost, _ = _lms(**SMALL)
    values = _np_values(pj.parameters.create(_lms(**SMALL)[1]))
    params = pt.parameters.from_numpy(ttopo, values, device="cpu").values
    for ps in params.values():
        for t in ps.values():
            t.requires_grad_(True)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        ttopo.forward(params, {}, _feed(True), train=True, outputs=[cost],
                      device="cpu")
    n, v = 3 * 12, 50
    assert (n, v) not in saved and (n,) in saved


# ---------------------------------------------------------------- serving
def test_fused_head_lm_serves_the_jax_streams():
    """A fused-head LM initialised in the JAX package: its parameters carry
    across, and the port's PagedDecoder decodes the JAX PagedDecoder's
    greedy streams token for token."""
    paged = dict(max_slots=2, block_size=8, step_buckets=(2,),
                 chunk_buckets=(8, 16))
    reset_jax_names()
    pj.init(seed=0)
    cost, _ = jt.build(vocab_size=64, max_len=48, dim=32, num_heads=2,
                       num_layers=2, fused_head=True)
    topo = pj.Topology(cost, collect_evaluators=False)
    params = pj.parameters.create(topo)
    values = _np_values(params)
    assert sorted(values["logits"]) == ["b", "w0"]
    # a trained-looking head: the zero-initialised bias would tie tokens
    values["logits"]["b"] = np.random.RandomState(1).standard_normal(
        64).astype(np.float32)
    params.values["logits"]["b"] = values["logits"]["b"]
    jdec = jt.PagedDecoder(topo, params, decode_kernel="xla", **paged)
    tdec = tt.PagedDecoder(tt.params_from_jax(values, num_heads=2),
                           device="cpu", **paged)
    for seed, n in ((0, 5), (1, 13)):
        prompt = np.random.RandomState(seed).randint(0, 64, n).astype(
            np.int32)
        streams = []
        for dec in (jdec, tdec):
            dec.reset()
            toks = [int(dec.prefill(0, prompt))]
            pos = len(prompt)
            for _ in range(6):
                nxt = dec.step(1, np.array([toks[-1]], np.int32),
                               np.array([pos], np.int32))
                toks.append(int(nxt[0]))
                pos += 1
            streams.append(toks)
        assert streams[0] == streams[1]
