"""The port's Fluid control flow (``paddle_tpu_torch.fluid.control_flow``)
against the JAX package's, on the CPU: the counterparts of the 14 tests
of ``tests/test_fluid_control_flow.py`` and of the IfElse / Switch tests
of ``tests/test_fluid_surface2.py``.

Each program is built by the same DSL calls in both packages; its JSON
(sub-blocks, ``carry_names`` / ``param_names`` / ``cond_idx``, and the
``bounded_while_grad`` replay of an unbounded While included) is byte
equal, and from the JAX startup values the port's fetches (forward
values and gradients) equal the JAX package's within rtol 1e-5, atol
1e-6 (1e-4 relative over several training steps).  The JAX side of each
program runs once, in a module-scoped fixture.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from torch_fluid_pairs import (assert_steps_close, jax_side,
                               program_json, port_side)
from torch_fluid_programs import (ifelse, nmt_dynamic_rnn, switch_default,
                                  while_train)

RTOL, ATOL = 1e-5, 1e-6


def _static_rnn_accumulator(fl):
    L = fl.layers
    x = L.data(name="x", shape=[4, 3], append_batch_size=False)
    boot = L.data(name="boot", shape=[3], append_batch_size=False)
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        prev = rnn.memory(init=boot)
        acc = L.elementwise_add(x_t, prev)
        rnn.update_memory(prev, acc)
        rnn.step_output(acc)
    xv = np.arange(12, dtype=np.float32).reshape(4, 3)
    return [rnn()], [{"x": xv, "boot": np.zeros(3, np.float32)}]


def _static_rnn_fc(fl):
    """RNN with shared fc weights trained 3 SGD steps; the fetches are
    the loss and the gradient of the fc weight inside the step block."""
    L = fl.layers
    x = L.data(name="x", shape=[5, 4, 3], append_batch_size=False)
    y = L.data(name="y", shape=[4, 1], append_batch_size=False)
    boot = L.fill_constant([4, 6], "float32", 0.0)
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        prev = rnn.memory(init=boot)
        h = L.fc(input=[x_t, prev], size=6, act="tanh")
        rnn.update_memory(prev, h)
        rnn.step_output(h)
    last = L.reshape(L.crop(rnn(), shape=[1, 4, 6], offsets=[4, 0, 0]),
                     [4, 6])
    loss = L.mean(L.square_error_cost(L.fc(input=last, size=1), y))
    fl.optimizer.SGDOptimizer(0.2).minimize(loss)
    w_in = fl.default_main_program().global_block().all_parameters()[0]
    rng = np.random.RandomState(0)
    feeds = []
    for _ in range(3):
        xv = rng.rand(5, 4, 3).astype(np.float32)
        feeds.append({"x": xv, "y": xv.sum(axis=(0, 2)).reshape(4, 1)
                      .astype(np.float32) / 5.0})
    return [loss, w_in.name + "@GRAD"], feeds


def _counting_while(fl, max_trip_count=None):
    L = fl.layers
    i = L.fill_constant([1], "float32", 0.0)
    limit = L.fill_constant([1], "float32", 10.0)
    total = L.fill_constant([1], "float32", 0.0)
    cond = L.less_than(i, limit)
    w = L.While(cond=cond, max_trip_count=max_trip_count)
    with w.block():
        L.assign(L.elementwise_add(total, i), output=total)
        L.assign(L.elementwise_add(i, L.fill_constant([1], "float32", 1.0)),
                 output=i)
        L.less_than(i, limit, cond=cond)
    return [total], [{}]


def _tensor_array(fl):
    L = fl.layers
    arr = L.create_array("float32", capacity=4, element_shape=[2])
    x = L.data(name="x", shape=[2], append_batch_size=False)
    idx = L.fill_constant([1], "float32", 2.0)
    arr2 = L.array_write(x, idx, arr)
    return [arr2, L.array_read(arr2, idx)], [
        {"x": np.array([3.0, 4.0], np.float32)}]


def _dynamic_rnn(fl):
    L = fl.layers
    x = L.data(name="x", shape=[4, 3], dtype="float32")
    lens = L.data(name="lens", shape=[1], dtype="int32",
                  append_batch_size=False)
    drnn = L.DynamicRNN()
    with drnn.block():
        x_t = drnn.step_input(x, lens)
        prev = drnn.memory(shape=[3], batch_ref=lens)
        s = L.elementwise_add(x_t, prev)
        drnn.update_memory(prev, s)
        drnn.output(s)
    rng = np.random.RandomState(0)
    return [drnn()], [{"x": rng.rand(2, 4, 3).astype(np.float32),
                       "lens": np.asarray([2, 4], np.int32)}]


def _conditional_block(fl):
    L = fl.layers
    x = L.data(name="x", shape=[1], append_batch_size=False)
    flag = L.data(name="flag", shape=[1], append_batch_size=False)
    out = L.fill_constant([1], "float32", 2.0)
    cond = L.greater_than(flag, L.fill_constant([1], "float32", 0.5))
    cb = fl.control_flow.ConditionalBlock(cond)
    with cb.block():
        L.assign(L.scale(x, scale=3.0), out)
    return [out], [{"x": np.asarray([3.0], np.float32),
                    "flag": np.asarray([v], np.float32)} for v in (1.0, 0.0)]


def _serialized_while(fl):
    L = fl.layers
    x = L.data(name="x", shape=[4], dtype="float32")
    i = L.fill_constant([1], "int64", 0)
    limit = L.fill_constant([1], "int64", 3)
    acc = L.fill_constant([1], "float32", 0.0)
    cond = L.less_than(i, limit)
    w = L.While(cond)
    with w.block():
        s = L.reduce_sum(x)
        L.assign(L.elementwise_add(acc, L.reshape(s, [1])), acc)
        L.assign(L.increment(i, value=1), i)
        L.assign(L.less_than(i, limit), cond)
    y = L.fc(x, size=2, param_attr=fl.initializer.Constant(0.5),
             bias_attr=False)
    return [acc, y], [{"x": np.ones((2, 4), np.float32)}]


def _fc_while(fl, max_trip_count, limit_feed):
    """h := tanh(h W) while i < limit; loss mean(h * h); fetches the loss
    and dW (append_backward through the loop)."""
    L = fl.layers
    x = L.data(name="wx", shape=[4, 3], append_batch_size=False)
    h = L.elementwise_add(x, L.fill_constant([4, 3], "float32", 0.0))
    i = L.fill_constant([1], "float32", 0.0)
    if limit_feed:
        limit = L.data(name="wlimit", shape=[1], append_batch_size=False)
    else:
        limit = L.fill_constant([1], "float32", 3.0)
    cond = L.less_than(i, limit)
    w = L.While(cond=cond, max_trip_count=max_trip_count)
    with w.block():
        nh = L.fc(input=h, size=3, act="tanh", bias_attr=False,
                  param_attr=fl.initializer.Constant(0.25))
        L.assign(nh, output=h)
        L.assign(L.elementwise_add(i, L.fill_constant([1], "float32", 1.0)),
                 output=i)
        L.less_than(i, limit, cond=cond)
    loss = L.mean(L.elementwise_mul(h, h))
    (_, g), = fl.backward.append_backward(loss)
    xv = np.random.RandomState(0).rand(4, 3).astype(np.float32)
    return loss, g, xv


def _bounded_while_grad(fl):
    loss, g, xv = _fc_while(fl, 5, False)
    return [loss, g], [{"wx": xv}]


def _unbounded_while_grad(fl):
    loss, g, xv = _fc_while(fl, None, True)
    return [loss, g], [{"wx": xv, "wlimit": np.array([n], np.float32)}
                       for n in (3.0, 5.0)]


def _conditional_block_grad(fl):
    L = fl.layers
    x = L.data(name="x", shape=[4, 3], append_batch_size=False)
    flag = L.data(name="flag", shape=[1], append_batch_size=False)
    out = L.fill_constant([4, 2], "float32", 0.0)
    cond = L.less_than(L.fill_constant([1], "float32", 0.5), flag)
    cb = fl.control_flow.ConditionalBlock(cond)
    with cb.block():
        L.assign(L.fc(input=x, size=2, act="tanh", bias_attr=False,
                      param_attr=fl.initializer.Constant(0.3)), output=out)
    loss = L.mean(L.elementwise_mul(out, out))
    (_, g), = fl.backward.append_backward(loss)
    xv = np.random.RandomState(1).rand(4, 3).astype(np.float32)
    return [loss, g], [{"x": xv, "flag": np.array([v], np.float32)}
                       for v in (1.0, 0.0)]


def _switch_multi(fl):
    L = fl.layers
    step = L.data(name="st", shape=[1], append_batch_size=False)
    lr_v = L.create_global_var([1], 0.0, "float32", name="sw_lr")
    wd_v = L.create_global_var([1], 0.0, "float32", name="sw_wd")
    sw = L.Switch()
    with sw:
        with sw.case(L.less_than(step, L.fill_constant([1], "float32",
                                                       100.0))):
            sw.assign(lr_v, L.fill_constant([1], "float32", 0.1))
            sw.assign(wd_v, L.fill_constant([1], "float32", 1e-4))
        with sw.default():
            sw.assign(lr_v, L.fill_constant([1], "float32", 0.01))
            sw.assign(wd_v, L.fill_constant([1], "float32", 1e-5))
    folded = sw.resolve_all({lr_v: L.fill_constant([1], "float32", 0.0),
                             wd_v: L.fill_constant([1], "float32", 0.0)})
    return [folded["sw_lr"], folded["sw_wd"]], [
        {"st": np.array([v], np.float32)} for v in (50.0, 500.0)]


def _nmt(fl):
    """the slice's model (chip_smoke.py's fluid_cf trains it at
    bench_nmt's widths) at test widths: 3 Adam steps"""
    loss, feeds = nmt_dynamic_rnn(fl, 50, 8, 8, 6, 5, 4)
    return [loss], [feeds(i) for i in range(3)]


PROGRAMS = {
    "nmt_dynamic_rnn": _nmt,
    "static_rnn_accumulator": _static_rnn_accumulator,
    "static_rnn_fc": _static_rnn_fc,
    "while_counts": _counting_while,
    "bounded_while_counts": lambda fl: _counting_while(fl, 16),
    "tensor_array": _tensor_array,
    "dynamic_rnn": _dynamic_rnn,
    "conditional_block": _conditional_block,
    "serialized_while": _serialized_while,
    "bounded_while_grad": _bounded_while_grad,
    "unbounded_while_grad": _unbounded_while_grad,
    "conditional_block_grad": _conditional_block_grad,
    "ifelse": ifelse,
    "ifelse_nan_safe": lambda fl: ifelse(fl, True),
    "switch_default": switch_default,
    "while_train": while_train,
    "switch_multi": _switch_multi,
}


@pytest.fixture(scope="module")
def jax_runs():
    return {name: jax_side(jfluid, fn) for name, fn in PROGRAMS.items()}


@pytest.fixture(autouse=True)
def fresh_programs():
    tfluid.framework.reset_default_programs()
    yield


def _port(name, jax_runs):
    out = port_side(tfluid, PROGRAMS[name], jax_runs[name]["init"])
    assert out["main"] == jax_runs[name]["main"], name
    assert out["startup"] == jax_runs[name]["startup"], name
    return out


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_json_and_fetches_match_jax(name, jax_runs):
    out = _port(name, jax_runs)
    tol = ((1e-4, 1e-6) if name in ("static_rnn_fc", "nmt_dynamic_rnn")
           else (RTOL, ATOL))
    assert_steps_close(out["steps"], jax_runs[name]["steps"], *tol, name)


def test_translation_model_trains_and_run_n_equals_its_runs(jax_runs):
    """The DynamicRNN translation program: its 3 Adam steps are the JAX
    package's (the parametrized test), and run_n(3) from the same JAX
    starting values equals 3 run() calls bit for bit, losses and scope,
    with no stand-down (the program captures on the card)."""
    ref = jax_runs["nmt_dynamic_rnn"]
    runs = port_side(tfluid, _nmt, ref["init"])
    tfluid.framework.reset_default_programs()
    loss, feeds = nmt_dynamic_rnn(tfluid, 50, 8, 8, 6, 5, 4)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe._step = 1
    for k, v in ref["init"].items():
        scope.set(k, v)
    lv, = exe.run_n(feed=lambda i: feeds(i), n=3, fetch_list=[loss],
                    scope=scope)
    np.testing.assert_array_equal(lv, np.stack([s[0] for s in
                                                runs["steps"]]))
    for name in runs["scope"].vars:
        np.testing.assert_array_equal(np.asarray(scope.get(name)),
                                      np.asarray(runs["scope"].get(name)))
    assert sum(exe.run_n_standdowns.values()) == 0


def test_static_rnn_accumulator(jax_runs):
    res = _port("static_rnn_accumulator", jax_runs)["steps"][0][0]
    xv = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.testing.assert_allclose(res, np.cumsum(xv, axis=0))


def test_static_rnn_with_fc_trains_and_its_gradient_is_nonzero(jax_runs):
    """The gradient of the fc weight inside the step block is nonzero
    (the sub-block runs in the grad op's grad mode) and equals the JAX
    package's; the loss falls over the 3 steps in both."""
    steps = _port("static_rnn_fc", jax_runs)["steps"]
    grads = [s[1] for s in steps]
    assert all(np.abs(g).sum() > 0 for g in grads)
    for g, (_, jg) in zip(grads, jax_runs["static_rnn_fc"]["steps"]):
        np.testing.assert_allclose(g, jg, rtol=1e-4, atol=1e-6)


def test_static_rnn_gradient_through_the_sub_block_is_nonzero():
    """The grad op's recomputation keeps autograd on inside the loop:
    d(sum of outputs)/d(boot) of a 3-step tanh RNN is the BPTT sum."""
    L = tfluid.layers
    x = L.data(name="x", shape=[3, 2, 4], append_batch_size=False)
    boot = L.data(name="boot", shape=[2, 4], append_batch_size=False)
    boot.stop_gradient = False
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        prev = rnn.memory(init=boot)
        h = L.tanh(L.elementwise_add(x_t, prev))
        rnn.update_memory(prev, h)
        rnn.step_output(h)
    loss = L.reduce_sum(rnn())
    tfluid.backward.append_backward(loss)
    rng = np.random.RandomState(2)
    xv = rng.rand(3, 2, 4).astype(np.float32)
    bv = rng.rand(2, 4).astype(np.float32)
    g, = tfluid.Executor(tfluid.CPUPlace()).run(
        feed={"x": xv, "boot": bv}, fetch_list=["boot@GRAD"],
        scope=tfluid.Scope())
    xt, bt = torch.tensor(xv), torch.tensor(bv, requires_grad=True)
    h, total = bt, 0
    for t in range(3):
        h = torch.tanh(xt[t] + h)
        total = total + h.sum()
    want, = torch.autograd.grad(total, bt)
    assert np.abs(g).sum() > 0
    np.testing.assert_allclose(g, want.numpy(), rtol=1e-6)


def test_while_loop_counts(jax_runs):
    assert float(_port("while_counts", jax_runs)["steps"][0][0][0]) == 45.0


def test_bounded_while_forward_matches_unbounded(jax_runs):
    assert float(_port("bounded_while_counts",
                       jax_runs)["steps"][0][0][0]) == 45.0


def test_tensor_array_write_read(jax_runs):
    a, e = _port("tensor_array", jax_runs)["steps"][0]
    np.testing.assert_allclose(a[2], [3.0, 4.0])
    np.testing.assert_allclose(e, [3.0, 4.0])
    np.testing.assert_allclose(a[0], 0.0)


def test_dynamic_rnn_masks_and_freezes(jax_runs):
    got = _port("dynamic_rnn", jax_runs)["steps"][0][0]
    xv = np.random.RandomState(0).rand(2, 4, 3).astype(np.float32)
    want = np.zeros_like(xv)
    for b, n in enumerate((2, 4)):
        want[b, :n] = np.cumsum(xv[b, :n], axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_conditional_block_runs_only_when_true(jax_runs):
    steps = _port("conditional_block", jax_runs)["steps"]
    assert [float(s[0][0]) for s in steps] == [9.0, 2.0]


def test_program_serialization_roundtrip(tmp_path, jax_runs):
    """The JAX package's JSON of a While program loads into the port and
    runs to the JAX fetches; the port's saved JSON is the JAX one."""
    ref = jax_runs["serialized_while"]
    path = tmp_path / "prog.json"
    path.write_text(ref["main"])
    main = tfluid.io.load_program(str(path))
    assert program_json(main) == ref["main"]
    scope = tfluid.Scope()
    for k, v in ref["init"].items():
        scope.set(k, v)
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed={"x": np.ones((2, 4), np.float32)},
        fetch_list=ref["fetch"], scope=scope)
    assert float(got[0][0]) == 24.0
    assert_steps_close([got], ref["steps"], RTOL, ATOL)
    tfluid.io.save_program(main, str(tmp_path / "again.json"))
    assert program_json(tfluid.io.load_program(
        str(tmp_path / "again.json"))) == ref["main"]


def test_program_serialization_keeps_param_attrs():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        main.global_block().create_parameter(
            name="w", shape=(3, 2), dtype="float32",
            initializer=tfluid.initializer.Constant(0.5),
            regularizer=tfluid.regularizer.L2Decay(1e-4),
            gradient_clip=tfluid.clip.GradientClipByNorm(1.0))
    main2 = tfluid.Program.from_json_dict(main.to_json_dict())
    w = main2.global_block().vars["w"]
    assert type(w.regularizer).__name__ == "L2DecayRegularizer"
    assert w.regularizer.coeff == 1e-4
    assert w.gradient_clip.clip_norm == 1.0
    assert w.initializer.value == 0.5


def test_save_load_inference_model(tmp_path):
    """Train a step, save the inference model, load it: dropout is off in
    the pruned program, and no grad or optimizer op survives."""
    L = tfluid.layers
    x = L.data(name="x", shape=[4])
    h = L.fc(input=x, size=3, act="relu",
             param_attr=tfluid.initializer.Constant(0.2))
    pred = L.fc(input=L.dropout(h, dropout_prob=0.5), size=2,
                param_attr=tfluid.initializer.Constant(0.1))
    loss = L.mean(pred)
    tfluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(tfluid.default_startup_program(), scope=scope)
    xv = np.ones((2, 4), dtype=np.float32)
    exe.run(feed={"x": xv}, fetch_list=[loss], scope=scope)
    d = str(tmp_path / "model")
    tfluid.io.save_inference_model(d, ["x"], [pred], exe, scope=scope)
    scope2 = tfluid.Scope()
    prog, feeds, fetches = tfluid.io.load_inference_model(d, exe,
                                                          scope=scope2)
    out, = exe.run(prog, feed={"x": xv}, fetch_list=fetches, scope=scope2)
    out2, = exe.run(prog, feed={"x": xv}, fetch_list=fetches, scope=scope2)
    np.testing.assert_array_equal(out, out2)
    assert all(not op.type.endswith("_grad") and op.type != "sgd"
               for op in prog.global_block().ops)


def test_bounded_while_gradcheck_vs_finite_difference(jax_runs):
    """dW through a bounded While: the JAX package's, and central finite
    differences of the port's own loss (rtol 2e-2, as the JAX test)."""
    out = _port("bounded_while_grad", jax_runs)
    _, gv = out["steps"][0]
    assert np.abs(gv).sum() > 0
    _finite_difference_check(out, {"wx": _fc_while_x()}, gv, 2e-2, 1e-4)


def _fc_while_x():
    return np.random.RandomState(0).rand(4, 3).astype(np.float32)


def _finite_difference_check(out, feed, gv, rtol, atol):
    exe, scope, prog = out["exe"], out["scope"], out["program"]
    p = prog.global_block().all_parameters()[0].name
    loss_name = _loss_name(prog)
    base = np.array(scope.get(p))
    eps = 1e-3
    for idx in [(0, 0), (1, 2), (2, 1)]:
        vals = []
        for sgn in (1, -1):
            pert = base.copy()
            pert[idx] += sgn * eps
            scope.set(p, pert)
            v, = exe.run(prog, feed=feed, fetch_list=[loss_name],
                         scope=scope)
            vals.append(float(v))
        scope.set(p, base)
        np.testing.assert_allclose(gv[idx], (vals[0] - vals[1]) / (2 * eps),
                                   rtol=rtol, atol=atol)


def _loss_name(prog):
    """the loss: the mean op's output that append_backward seeded."""
    ops = prog.global_block().ops
    return [op for op in ops if op.type == "mean"][-1].outputs["Out"][0]


def test_conditional_block_gradient_follows_taken_branch(jax_runs):
    (lv, gv), (lv0, gv0) = _port("conditional_block_grad",
                                 jax_runs)["steps"]
    assert np.abs(gv).sum() > 0
    assert float(lv0) == 0.0
    np.testing.assert_allclose(gv0, 0.0, atol=1e-8)


def test_unbounded_while_grad_two_phase_replay(jax_runs):
    """The unbounded While's gradient (its bounded_while_grad replay at
    the trip count the forward wrote): equal to the JAX package's at two
    trip counts, the forward equal to a numpy unroll, and the grad op's
    JSON the JAX one (checked with the program)."""
    out = _port("unbounded_while_grad", jax_runs)
    ops = out["program"].global_block().ops
    replay = [op for op in ops if op.type == "bounded_while_grad"]
    assert len(replay) == 1
    assert replay[0].attrs["max_trip_count"] == "__capture__"
    w = np.full((3, 3), 0.25, np.float32)
    for (lv, gv), n in zip(out["steps"], (3, 5)):
        assert np.abs(gv).sum() > 0
        h = _fc_while_x()
        for _ in range(n):
            h = np.tanh(h @ w)
        np.testing.assert_allclose(float(lv), float((h * h).mean()),
                                   rtol=1e-5, atol=1e-6)


def test_unbounded_while_trains():
    """SGD through the unbounded While lowers the loss (12 steps)."""
    loss, g, xv = _fc_while(tfluid, None, True)
    p = tfluid.default_main_program().global_block().all_parameters()[0]
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(tfluid.default_startup_program(), scope=scope)
    lim = np.array([4.0], np.float32)
    losses = []
    for _ in range(12):
        lv, gv = exe.run(feed={"wx": xv, "wlimit": lim},
                         fetch_list=[loss, g], scope=scope)
        losses.append(float(lv))
        scope.set(p.name, np.array(scope.get(p.name)) - 0.5 * gv)
    assert losses[-1] < losses[0] * 0.7, losses


def test_replay_without_its_forward_raises():
    """The grad block's bounded_while replay run without the forward
    while op (no trip count in the run) raises, naming the var."""
    _fc_while(tfluid, None, True)
    prog = tfluid.default_main_program()
    op = [o for o in prog.global_block().ops
          if o.type == "bounded_while_grad"][0]
    fn = tfluid.ops.get_op("bounded_while").fn
    ctx = tfluid.executor.OpRunCtx(True, torch.device("cpu"), 0, 0, 0, {})
    with pytest.raises(RuntimeError, match="was not captured"):
        fn(ctx, op.attrs, {"Carry": [], "Params": []})


def test_ifelse_and_switch(jax_runs):
    ov = _port("ifelse", jax_runs)["steps"][0][0]
    np.testing.assert_allclose(ov[0], 2.0)
    np.testing.assert_allclose(ov[1], -1.0)
    low, high = (s[0] for s in _port("switch_default", jax_runs)["steps"])
    np.testing.assert_allclose(low, 0.1, rtol=1e-6)
    np.testing.assert_allclose(high, 0.01, rtol=1e-6)


def test_ifelse_nan_safe_merge(jax_runs):
    ov = _port("ifelse_nan_safe", jax_runs)["steps"][0][0]
    assert ov[0, 0] == 0.0 and np.isfinite(ov).all()
    np.testing.assert_allclose(ov[1, 0], np.log(2.0), rtol=1e-6)


def test_switch_multi_assign_per_case(jax_runs):
    (lr, wd), (lr2, wd2) = _port("switch_multi", jax_runs)["steps"]
    np.testing.assert_allclose([lr[0], wd[0]], [0.1, 1e-4], rtol=1e-6)
    np.testing.assert_allclose([lr2[0], wd2[0]], [0.01, 1e-5], rtol=1e-6)


def test_parallel_do_runs_inline():
    L = tfluid.layers
    x = L.data(name="x", shape=[2])
    pd = L.ParallelDo(L.get_places(device_type="CPU"))
    with pd:
        pd.write_output(L.scale(pd.read_input(x), scale=2.0))
    out = pd()
    got, = tfluid.Executor(tfluid.CPUPlace()).run(
        feed={"x": np.ones((3, 2), np.float32)}, fetch_list=[out],
        scope=tfluid.Scope())
    np.testing.assert_allclose(got, 2.0)
