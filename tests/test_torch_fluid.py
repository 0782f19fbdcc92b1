"""The port's Fluid (``paddle_tpu_torch.fluid``) against the JAX package's
(``paddle_tpu.fluid``), on the CPU.

- Programs built by the same DSL calls serialize to byte-equal JSON.
- Each ported op's forward, and its gradient (a vjp with the same
  cotangent), equal the JAX op's on the same float32 inputs within 1e-5.
- fit_a_line, recognize_digits, Adam with L2 decay and global-norm
  clipping, and the five book programs of ``tests/test_fluid_book.py``
  train 5 steps in both packages from the JAX startup program's values
  (carried as numpy); the losses agree within 1e-5 relative on the first
  step and within 1e-4 relative over the 5 steps.  nce's negatives are
  the JAX package's draws, fed through ``ops.nce_negatives``; no program
  here has dropout (torch cannot reproduce JAX's streams).
- ``append_backward``'s gradients equal the JAX package's.
- A dropout mask recomputed inside its grad op equals the forward's.
- npz persistables and JSON programs cross between the packages both
  ways.
- An op no catalog registers is refused by name when the program runs,
  and the ``Executor`` runs on the card unless given ``CPUPlace()``.

The programs are those of ``tests/torch_fluid_programs.py``; the JAX
programs run once each, in module-scoped fixtures.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.fluid import executor as jexec
from paddle_tpu.fluid import ops as jops
from paddle_tpu_torch.fluid import ops as tops
from test_torch_fluid_grad_sweep import CASES as GRAD_CASES
from torch_fluid_programs import PROGRAMS, STEPS, TRAINED, build


def _json(prog):
    return json.dumps(prog.to_json_dict(), sort_keys=True)


def _jax_negatives(ctx, n, c):
    """The negatives the JAX nce op draws at the port op's (seed, step,
    rng_id, call): JAX's key derivation, OpRunCtx.next_key."""
    seed, step, rng_id = ctx._base
    key = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(seed), np.uint32(step)), rng_id), ctx._calls)
    ctx._calls += 1
    return torch.as_tensor(np.array(
        jax.random.randint(key, (n,), 0, c)), device=ctx.device)


@pytest.fixture(scope="module")
def jax_runs():
    """Per program: the JAX JSON, the startup values (numpy) and the
    fetched values of each step; one JAX run each."""
    out = {}
    for name in PROGRAMS:
        main, startup, fetch, feeds = build(jfluid, name)
        exe = jfluid.Executor(jfluid.CPUPlace())
        scope = jfluid.Scope()
        exe.run(startup, scope=scope)
        init = {k: np.array(v) for k, v in scope.vars.items()}
        steps = [exe.run(main, feed=feeds(i), fetch_list=fetch,
                         scope=scope)
                 for i in range(STEPS if name in TRAINED else 1)]
        out[name] = dict(main=_json(main), startup=_json(startup),
                         init=init, steps=steps)
    return out


def _port_run(name, init, monkeypatch):
    monkeypatch.setattr(tops, "nce_negatives", _jax_negatives)
    main, startup, fetch, feeds = build(tfluid, name)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe._step = 1                      # the JAX run's startup was step 0
    scope = tfluid.Scope()
    for k, v in init.items():
        scope.set(k, v)
    steps = [exe.run(main, feed=feeds(i), fetch_list=fetch, scope=scope)
             for i in range(STEPS if name in TRAINED else 1)]
    return main, startup, steps


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_json_is_byte_equal(name, jax_runs):
    main, startup, _, _ = build(tfluid, name)
    assert _json(main) == jax_runs[name]["main"]
    assert _json(startup) == jax_runs[name]["startup"]


@pytest.mark.parametrize("name", sorted(TRAINED))
def test_training_matches_jax(name, jax_runs, monkeypatch):
    """5 steps from the JAX starting values: the first loss within 1e-5,
    every loss within 1e-4 (relative); the other fetches (accuracy,
    logits, the nce part, the Viterbi path) alike."""
    ref = jax_runs[name]
    _, _, steps = _port_run(name, ref["init"], monkeypatch)
    losses = np.array([float(s[0]) for s in steps])
    jl = np.array([float(s[0]) for s in ref["steps"]])
    np.testing.assert_allclose(losses[0], jl[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(losses, jl, rtol=1e-4, atol=1e-6)
    for got, want in zip(steps, ref["steps"]):
        for g, w in zip(got[1:], want[1:]):
            if np.issubdtype(np.asarray(w).dtype, np.integer):
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def test_beam_decode_matches_jax(jax_runs, monkeypatch):
    """Machine translation's decode (no training): the beams' ids equal,
    their scores within 1e-5."""
    ref = jax_runs["machine_translation"]
    _, _, steps = _port_run("machine_translation", ref["init"], monkeypatch)
    (ids, sc), (jids, jsc) = steps[0], ref["steps"][0]
    assert ids.shape == (5, 3, 4)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(sc, jsc, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ op by op
# (ins, attrs) of the ops with no gradient: forward only
FORWARD_CASES = {
    "cast": ({"X": [np.arange(6.0).reshape(2, 3) - 2.5]},
             {"out_dtype": "int32"}),
    "increment": ({"X": [np.array([3.0])]}, {"step": 2.0}),
    "top_k": ({"X": [np.array([[1., 3., 3., 0.], [2., 2., 1., 5.]])]},
              {"k": 3}),
    "fill_zeros_like": ({"X": [np.ones((2, 3))]}, {}),
    "fill_constant": ({}, {"shape": [2, 3], "value": 1.5,
                           "dtype": "float32"}),
    "fill_constant_batch_size_like": (
        {"Input": [np.ones((4, 2))]},
        {"shape": [-1, 3], "value": 2.0, "dtype": "float32"}),
    "assign_value": ({}, {"values": [1.0, 2.0, 3.0, 4.0], "shape": [2, 2],
                          "dtype": "float32"}),
    "accuracy": ({"Out": [np.random.RandomState(5).rand(6, 4)],
                  "Indices": [np.array([[1, 0], [2, 3], [0, 1], [3, 2],
                                        [1, 2], [0, 3]], np.int64)],
                  "Label": [np.array([[1], [3], [2], [3], [0], [0]],
                                     np.int64)]}, {}),
    "crf_decoding": ({"Emission": [np.random.RandomState(6).randn(2, 4, 3)],
                      "Transition": [np.random.RandomState(7).randn(5, 3)],
                      "Length": [np.array([4, 2], np.int64)]}, {}),
    "beam_search": ({"pre_ids": [np.array([[2, 1], [3, 4]], np.int64)],
                     "pre_scores": [np.array([[-0.5, -0.2], [-1., -2.]])],
                     "scores": [np.random.RandomState(8).dirichlet(
                         np.ones(6), (2, 2))]},
                    {"end_id": 1}),
    "beam_search_decode": (
        {"Ids": [np.random.RandomState(9).randint(0, 9, (3, 2, 2))],
         "Parents": [np.random.RandomState(10).randint(0, 2, (3, 2, 2))],
         "Scores": [np.random.RandomState(11).randn(3, 2, 2)]}, {}),
}


def _optimizer_cases():
    rng = np.random.RandomState(12)

    def p():
        return rng.randn(3, 2)

    def pos():
        return rng.rand(3, 2) + 0.1

    lr = np.array([0.1])
    return {
        "sgd": ({"Param": [p()], "Grad": [p()], "LearningRate": [lr]}, {}),
        "momentum": ({"Param": [p()], "Grad": [p()], "Velocity": [p()],
                      "LearningRate": [lr]},
                     {"mu": 0.8, "use_nesterov": True}),
        "adagrad": ({"Param": [p()], "Grad": [p()], "Moment": [pos()],
                     "LearningRate": [lr]}, {}),
        "adam": ({"Param": [p()], "Grad": [p()], "Moment1": [p()],
                  "Moment2": [pos()], "LearningRate": [lr],
                  "Beta1Pow": [np.array([0.81])],
                  "Beta2Pow": [np.array([0.998])]}, {}),
        "adamax": ({"Param": [p()], "Grad": [p()], "Moment": [p()],
                    "InfNorm": [pos()], "LearningRate": [lr],
                    "Beta1Pow": [np.array([0.81])]}, {}),
        "adadelta": ({"Param": [p()], "Grad": [p()],
                      "AvgSquaredGrad": [pos()],
                      "AvgSquaredUpdate": [pos()]}, {}),
        "decayed_adagrad": ({"Param": [p()], "Grad": [p()],
                             "Moment": [pos()], "LearningRate": [lr]}, {}),
        "rmsprop": ({"Param": [p()], "Grad": [p()], "MeanSquare": [pos()],
                     "Moment": [p()], "LearningRate": [lr]},
                    {"momentum": 0.5}),
        "ftrl": ({"Param": [p()], "Grad": [p()],
                  "SquaredAccumulator": [pos()],
                  "LinearAccumulator": [p()], "LearningRate": [lr]},
                 {"l1": 0.1, "l2": 0.2}),
    }


FORWARD_CASES.update(_optimizer_cases())
# random draws: the port's streams are not JAX's, so their values are
# compared by their laws in test_random_ops_draw_their_laws
RANDOM_OPS = {"uniform_random", "gaussian_random", "dropout"}


def _f32(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == np.float64 else a


def _call(name, ins, attrs, diff=(), cot=None):
    """(forward outputs {slot: [numpy]}, grads {(slot, i): numpy}) of the
    JAX op and of the port op on the same float32 inputs; the grads are
    vjps with cotangent cos(arange) on every float output."""
    # step 1 of seed 0, rng id 1 in both (nce's negatives: _jax_negatives)
    jkey = jax.random.fold_in(jax.random.PRNGKey(0), np.uint32(1))
    jctx = jexec.OpRunCtx(True, jkey, 1)
    tctx = tfluid.executor.OpRunCtx(True, torch.device("cpu"), 0, 1, 1)
    jins = {s: [jnp.asarray(_f32(a)) for a in v] for s, v in ins.items()}
    tins = {s: [torch.as_tensor(_f32(a)) for a in v] for s, v in ins.items()}

    def jf(*vals):
        """the JAX op's float outputs (to differentiate) and all of them"""
        ins2 = {s: list(v) for s, v in jins.items()}
        for (s, i), v in zip(diff, vals):
            ins2[s][i] = v
        out = jops.get_op(name).fn(jexec.OpRunCtx(True, jkey, 1), attrs,
                                   ins2)
        # in sorted slot order: the order vjp's aux dict comes back in
        return [v for slot in sorted(out) for v in out[slot]
                if jnp.issubdtype(v.dtype, jnp.floating)], out

    if diff:     # one jitted JAX forward (the JAX executor jits a whole
        # block) serves the outputs and the vjp
        _, vjp, jout = jax.vjp(jax.jit(jf), *[jins[s][i] for s, i in diff],
                               has_aux=True)
    else:
        jout = jops.get_op(name).fn(jctx, attrs, jins)
    with torch.enable_grad():
        for s, i in diff:
            tins[s][i].requires_grad_(True)
        tout = tops.get_op(name).fn(tctx, attrs, tins)
    res = []
    for out in (jout, tout):
        res.append({s: [np.asarray(v.detach() if isinstance(v, torch.Tensor)
                                   else v) for v in vs]
                    for s, vs in out.items()})
    if not diff:
        return res, None

    def weights(v):
        return np.cos(np.arange(v.size, dtype=np.float32)).reshape(v.shape)

    floats = [(s, i) for s in sorted(res[0]) for i, v in enumerate(res[0][s])
              if np.issubdtype(v.dtype, np.floating)]
    jg = vjp([jnp.asarray(weights(res[0][s][i])) for s, i in floats])
    ys = [tout[s][i] for s, i in floats]
    cots = [torch.as_tensor(weights(res[1][s][i])) for s, i in floats]
    keep = [(y, c) for y, c in zip(ys, cots) if y.requires_grad]
    tg = torch.autograd.grad([y for y, _ in keep], [tins[s][i]
                                                    for s, i in diff],
                             [c for _, c in keep], allow_unused=True)
    grads = [(np.asarray(a), np.zeros_like(np.asarray(a)) if b is None
              else b.numpy()) for a, b in zip(jg, tg)]
    return res, grads


def _assert_outputs(res, name):
    jout, tout = res
    assert set(jout) == set(tout), name
    for s in jout:
        for a, b in zip(jout[s], tout[s]):
            assert a.shape == b.shape, (name, s, a.shape, b.shape)
            if np.issubdtype(a.dtype, np.floating):
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6,
                                           err_msg=f"{name}.{s}")
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"{name}.{s}")


@pytest.mark.parametrize("name", sorted(set(GRAD_CASES) - RANDOM_OPS))
def test_op_forward_and_grad_match_jax(name, monkeypatch):
    monkeypatch.setattr(tops, "nce_negatives", _jax_negatives)
    ins, attrs, _ = GRAD_CASES[name]
    spec = tops.get_op(name)
    slots = (spec.differentiable if spec.differentiable is not None
             else spec.inputs)
    diff = [(s, i) for s in slots for i, a in enumerate(ins.get(s, []))
            if np.asarray(a).dtype == np.float64
            and s not in ("Mask", "Mean", "Variance")]
    res, grads = _call(name, ins, attrs, diff)
    _assert_outputs(res, name)
    for (s, i), (a, b) in zip(diff, grads):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6,
                                   err_msg=f"{name} d{s}[{i}]")


@pytest.mark.parametrize("name", sorted(FORWARD_CASES))
def test_op_forward_matches_jax(name):
    ins, attrs = FORWARD_CASES[name]
    res, _ = _call(name, ins, attrs)
    _assert_outputs(res, name)


def test_random_ops_draw_their_laws():
    ctx = tfluid.executor.OpRunCtx(True, torch.device("cpu"), 0, 1, 1)
    u = tops.get_op("uniform_random").fn(
        ctx, {"shape": [20000], "min": -2.0, "max": 4.0}, {})["Out"][0]
    g = tops.get_op("gaussian_random").fn(
        ctx, {"shape": [20000], "mean": 1.0, "std": 2.0}, {})["Out"][0]
    assert u.min() >= -2.0 and u.max() < 4.0
    assert abs(float(u.mean()) - 1.0) < 0.05
    assert abs(float(g.mean()) - 1.0) < 0.05
    assert abs(float(g.std()) - 2.0) < 0.05
    x = torch.ones(20000)
    out, mask = tops.get_op("dropout").fn(ctx, {"dropout_prob": 0.3},
                                          {"X": [x]}).values()
    assert abs(float(mask[0].mean()) - 0.7) < 0.02
    torch.testing.assert_close(out[0], mask[0] / 0.7)


def test_catalog_is_the_jax_catalog():
    """Every JAX op (and control-flow op) is ported, with the JAX op's
    slots."""
    import paddle_tpu.fluid.control_flow  # noqa: F401 (registers its ops)
    assert set(tops.OPS) == set(jops.OPS)
    for name, op in tops.OPS.items():
        assert op.inputs == jops.OPS[name].inputs, name
        assert op.outputs == jops.OPS[name].outputs, name


# ------------------------------------------------------- the executor
def test_append_backward_grads_match_jax():
    def make(fl):
        fl.framework.reset_default_programs()
        L = fl.layers
        x = L.data(name="x", shape=[4])
        h = L.fc(input=x, size=3, act="tanh")
        h2 = L.fc(input=L.concat([h, x], axis=1), size=2, act="sigmoid")
        loss = L.mean(L.elementwise_mul(h2, h2))
        pg = fl.backward.append_backward(loss)
        return [loss.name] + [g.name for _, g in pg]

    fetch = make(jfluid)
    jmain, jstart = jfluid.default_main_program(), \
        jfluid.default_startup_program()
    assert make(tfluid) == fetch
    assert _json(tfluid.default_main_program()) == _json(jmain)
    jexe, js = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jstart, scope=js)
    xv = np.random.RandomState(0).rand(5, 4).astype(np.float32)
    want = jexe.run(jmain, feed={"x": xv}, fetch_list=fetch, scope=js)
    ts = tfluid.Scope()
    for k, v in js.vars.items():
        ts.set(k, np.array(v))
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tfluid.default_main_program(), feed={"x": xv}, fetch_list=fetch,
        scope=ts)
    assert len(got) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)


def test_dropout_mask_is_recomputed_equal_in_the_grad_op():
    """x -> dropout -> mean: x@GRAD, from the grad op's recomputed
    forward, is the forward's Mask / (1 - p) / N."""
    tfluid.framework.reset_default_programs()
    L = tfluid.layers
    x = L.data(name="x", shape=[50])
    x.stop_gradient = False
    d = L.dropout(x, dropout_prob=0.4)
    loss = L.mean(d)
    tfluid.backward.append_backward(loss)
    mask_name = tfluid.default_main_program().global_block().ops[0] \
        .outputs["Mask"][0]
    exe = tfluid.Executor(tfluid.CPUPlace())
    xv = np.random.RandomState(0).rand(4, 50).astype(np.float32)
    for _ in range(2):               # two steps: two different masks
        mask, gx = exe.run(feed={"x": xv},
                           fetch_list=[mask_name, "x@GRAD"],
                           scope=tfluid.Scope())
        assert 0 < mask.mean() < 1
        np.testing.assert_allclose(gx, mask / 0.6 / xv.size, rtol=1e-6)


def test_persistables_and_programs_cross_both_ways(tmp_path, jax_runs,
                                                   monkeypatch):
    """JAX npz + JSON -> the port, and the port's -> JAX: the loaded
    program runs and gives the other package's fetches."""
    ref = jax_runs["recognize_digits"]
    jmain, jstart, fetch, feeds = build(jfluid, "recognize_digits")
    jexe, js = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    for k, v in ref["init"].items():
        js.set(k, v)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jfluid.io.save_persistables(jexe, str(jdir), jmain, scope=js)
    jfluid.io.save_program(jmain, str(jdir / "main.json"))
    tmain = tfluid.io.load_program(str(jdir / "main.json"))
    texe, ts = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    tfluid.io.load_persistables(texe, str(jdir), tmain, scope=ts)
    assert _json(tmain) == ref["main"]
    got = texe.run(tmain, feed=feeds(0), fetch_list=fetch, scope=ts)
    np.testing.assert_allclose(got[0], ref["steps"][0][0], rtol=1e-5)
    # the port's files (after its step) back into JAX
    tfluid.io.save_persistables(texe, str(tdir), tmain, scope=ts)
    tfluid.io.save_program(tmain, str(tdir / "main.json"))
    jmain2 = jfluid.io.load_program(str(tdir / "main.json"))
    js2 = jfluid.Scope()
    jfluid.io.load_persistables(jexe, str(tdir), jmain2, scope=js2)
    want = jexe.run(jmain2, feed=feeds(1), fetch_list=fetch, scope=js2)
    got = texe.run(tmain, feed=feeds(1), fetch_list=fetch, scope=ts)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    with open(tdir / "main.json") as f:
        assert json.load(f) == json.loads(ref["main"])


def test_inference_model_round_trip(tmp_path):
    tfluid.framework.reset_default_programs()
    L = tfluid.layers
    img = L.data(name="img", shape=[1, 8, 8])
    t = L.batch_norm(L.conv2d(img, num_filters=4, filter_size=3, padding=1,
                              act="relu"))
    logits = L.fc(L.pool2d(t, pool_size=2, pool_stride=2), size=3)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(tfluid.default_startup_program(), scope=scope)
    xv = np.random.RandomState(0).rand(2, 1, 8, 8).astype(np.float32)
    tfluid.io.save_inference_model(str(tmp_path), ["img"], [logits], exe,
                                   scope=scope)
    want, = exe.run(tfluid.io._prune_for_inference(
        tfluid.default_main_program(), ["img"], [logits.name]),
        feed={"img": xv}, fetch_list=[logits], scope=scope)
    loaded = tfluid.Scope()
    prog, feed_names, fetch_names = tfluid.io.load_inference_model(
        str(tmp_path), exe, scope=loaded)
    assert feed_names == ["img"] and fetch_names == [logits.name]
    got, = exe.run(prog, feed={"img": xv}, fetch_list=fetch_names,
                   scope=loaded)
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_unported_op_is_refused_by_name():
    """An op no catalog registers is refused by name before the program's
    first op runs (no op of the JAX catalog is refused any more)."""
    L = tfluid.layers
    x = L.data(name="x", shape=[4], dtype="int64")
    y = L.one_hot(x, depth=5)
    blk = tfluid.default_main_program().global_block()
    out = blk.create_var(name="out", shape=(2, 4), dtype="float32")
    blk.append_op("no_such_op", inputs={"X": [y]}, outputs={"Out": [out]})
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with pytest.raises(KeyError, match="'no_such_op'"):
        exe.run(feed={"x": np.zeros((2, 4), np.int64)}, fetch_list=[y],
                scope=scope)
    assert L.While is tfluid.control_flow.While


def test_executor_runs_on_the_card_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfluid.Executor()
    assert tfluid.TPUPlace is tfluid.CUDAPlace
    assert tfluid.Executor(tfluid.CPUPlace()).device == torch.device("cpu")
