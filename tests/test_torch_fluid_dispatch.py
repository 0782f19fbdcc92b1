"""The port's Fluid executor dispatch (``Executor.prepare`` /
``CompiledProgram``, ``run_n``, ``check_nan_inf``) on the CPU, the
counterpart of ``tests/test_fluid_dispatch.py`` for the port's own
semantics:

- ``prepare(...).run`` equals ``run``, and a prepared plan follows a
  change to its program;
- ``check_nan_inf`` aborts with ``FloatingPointError`` before anything
  is committed: every persistable is the same tensor with the same
  values, and a retry with clean data succeeds;
- ``run_n`` equals n ``run()`` calls bit for bit (fetches stacked on a
  leading ``[n]`` axis, the scope after, dropout's masks included, which
  differ from step to step), with ``feed_fn(i)`` feeds, interleaved with
  ``run()``, and under ``prepare(for_test=True)``;
- the leading-axis check on the feeds;
- ``run_n`` stands down to n runs, counted by reason in
  ``run_n_standdowns``, for ``check_nan_inf``, for an unbounded While's
  gradient (``capture_vars``) and for a host-synchronising op
  (``host_sync``).

On the CPU the chunk's n steps run one after the other through the
captured step's code (the chunk's own state tensors, updated in place);
on the card they are one CUDA graph, held by ``chip_smoke.py``.  The JAX
file's compile-count, donation, aliasing and compile-cache tests have no
counterpart: the port compiles nothing per program and donates nothing.
"""

import numpy as np
import pytest

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import layers


@pytest.fixture(autouse=True)
def fresh_programs():
    fluid.framework.reset_default_programs()
    yield


def _exe():
    return fluid.Executor(fluid.CPUPlace()), fluid.Scope()


def _build_model(dropout=0.0, adam=False):
    x = layers.data(name="x", shape=[4])
    label = layers.data(name="label", shape=[1])
    h = layers.fc(input=x, size=8, act="relu")
    mask = None
    if dropout:
        h = layers.dropout(h, dropout_prob=dropout)
        mask = fluid.default_main_program().global_block().ops[-1] \
            .outputs["Mask"][0]
    y = layers.fc(input=h, size=1)
    loss = layers.mean(layers.square_error_cost(y, label))
    opt = (fluid.optimizer.AdamOptimizer(learning_rate=0.05) if adam
           else fluid.optimizer.SGDOptimizer(learning_rate=0.1))
    opt.minimize(loss)
    return loss, mask


def _feed(rng, batch=8):
    xv = rng.rand(batch, 4).astype(np.float32)
    return {"x": xv, "label": xv.sum(1, keepdims=True).astype(np.float32)}


def _stack(feeds):
    return {k: np.stack([f[k] for f in feeds]) for k in feeds[0]}


def _two_scopes():
    """two executors and scopes with the same startup values"""
    exe_a, scope_a = _exe()
    exe_a.run(fluid.default_startup_program(), scope=scope_a)
    exe_b, scope_b = _exe()
    for k, v in scope_a.vars.items():
        scope_b.set(k, v.clone())
    exe_b._step = exe_a._step
    return exe_a, scope_a, exe_b, scope_b


def _assert_scopes_equal(a, b):
    assert set(a.vars) == set(b.vars)
    for name in a.vars:
        np.testing.assert_array_equal(np.asarray(a.get(name)),
                                      np.asarray(b.get(name)), err_msg=name)


def test_prepare_matches_run():
    loss, _ = _build_model()
    prog = fluid.default_main_program()
    exe_a, scope_a, exe_b, scope_b = _two_scopes()
    rng = np.random.RandomState(1)
    feeds = [_feed(rng) for _ in range(3)]
    cp = exe_b.prepare(prog, feed_names=["x", "label"], fetch_list=[loss],
                       scope=scope_b)
    assert isinstance(cp, fluid.CompiledProgram) and cp.program is prog
    for f in feeds:
        want, = exe_a.run(prog, feed=f, fetch_list=[loss], scope=scope_a)
        got, = cp.run(f)
        np.testing.assert_array_equal(got, want)
    _assert_scopes_equal(scope_a, scope_b)


def test_prepared_plan_survives_program_mutation():
    x = layers.data(name="x", shape=[4])
    loss = layers.mean(layers.fc(input=x, size=1))
    prog = fluid.default_main_program()
    exe, scope = _exe()
    exe.run(fluid.default_startup_program(), scope=scope)
    feed = {"x": np.random.RandomState(2).rand(8, 4).astype(np.float32)}
    cp = exe.prepare(prog, fetch_list=[loss], scope=scope)
    lv, = cp.run(feed)
    with fluid.program_guard(prog):
        doubled = layers.scale(loss, scale=2.0)
    dv, = exe.prepare(prog, fetch_list=[doubled], scope=scope).run(feed)
    np.testing.assert_allclose(float(dv), 2 * float(lv), rtol=1e-6)
    lv2, = cp.run(feed)             # the old handle, on the new version
    np.testing.assert_array_equal(lv2, lv)


def test_check_nan_inf_aborts_without_touching_the_scope():
    loss, _ = _build_model(adam=True)
    exe, scope = _exe()
    exe.run(fluid.default_startup_program(), scope=scope)
    rng = np.random.RandomState(5)
    feed = _feed(rng)
    exe.run(feed=feed, fetch_list=[loss], scope=scope)
    before = dict(scope.vars)
    snapshot = {n: np.array(v) for n, v in scope.vars.items()}
    bad = dict(feed, x=np.full_like(feed["x"], np.nan))
    with pytest.raises(FloatingPointError, match="check_nan_inf"):
        exe.run(feed=bad, fetch_list=[loss], scope=scope,
                check_nan_inf=True)
    for n, v in scope.vars.items():
        assert v is before[n], n
        np.testing.assert_array_equal(np.asarray(v), snapshot[n])
    lv, = exe.run(feed=feed, fetch_list=[loss], scope=scope,
                  check_nan_inf=True)
    assert np.isfinite(lv).all()
    # the JAX test's case: a NaN fetch raises, and passes without the flag
    fluid.framework.reset_default_programs()
    y = layers.log(layers.data(name="x", shape=[2]))
    badx = {"x": np.array([[-1.0, 1.0]], np.float32)}
    with pytest.raises(FloatingPointError):
        exe.run(feed=badx, fetch_list=[y], scope=scope, check_nan_inf=True)
    out, = exe.run(feed=badx, fetch_list=[y], scope=scope)
    assert np.isnan(out[0, 0])


def test_run_n_matches_sequential_runs_with_dropout():
    """n run() calls and one run_n(n) from the same start: the losses,
    the dropout masks and the scope after are equal bit for bit; the
    masks differ from step to step; the step counter moves by n."""
    loss, mask = _build_model(dropout=0.5, adam=True)
    prog = fluid.default_main_program()
    exe_a, scope_a, exe_b, scope_b = _two_scopes()
    rng = np.random.RandomState(0)
    feeds = [_feed(rng) for _ in range(4)]
    seq = [exe_a.run(prog, feed=f, fetch_list=[loss, mask], scope=scope_a)
           for f in feeds]
    step0 = exe_b._step
    lv, mv = exe_b.run_n(prog, feed=_stack(feeds), n=4,
                         fetch_list=[loss, mask], scope=scope_b)
    assert lv.shape == (4,) + seq[0][0].shape and mv.shape[0] == 4
    assert exe_b._step == step0 + 4
    np.testing.assert_array_equal(lv, np.stack([s[0] for s in seq]))
    np.testing.assert_array_equal(mv, np.stack([s[1] for s in seq]))
    assert not np.array_equal(mv[0], mv[1])
    assert 0.3 < mv.mean() < 0.7
    _assert_scopes_equal(scope_a, scope_b)
    assert sum(exe_b.run_n_standdowns.values()) == 0


def test_run_n_interleaves_with_run():
    """run, run_n(2), run, run_n(2) (the second chunk reuses the first's
    entry after run() rebound the scope) equals six runs."""
    loss, mask = _build_model(dropout=0.3)
    prog = fluid.default_main_program()
    exe_a, scope_a, exe_b, scope_b = _two_scopes()
    rng = np.random.RandomState(3)
    feeds = [_feed(rng) for _ in range(6)]
    want = [exe_a.run(prog, feed=f, fetch_list=[loss], scope=scope_a)[0]
            for f in feeds]
    got = [exe_b.run(prog, feed=feeds[0], fetch_list=[loss],
                     scope=scope_b)[0]]
    got += list(exe_b.run_n(prog, feed=_stack(feeds[1:3]), n=2,
                            fetch_list=[loss], scope=scope_b)[0])
    got += [exe_b.run(prog, feed=feeds[3], fetch_list=[loss],
                      scope=scope_b)[0]]
    got += list(exe_b.run_n(prog, feed=_stack(feeds[4:6]), n=2,
                            fetch_list=[loss], scope=scope_b)[0])
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    _assert_scopes_equal(scope_a, scope_b)
    assert len(exe_b._family.entries) == 1


def test_run_n_feed_fn_feeds():
    loss, _ = _build_model()
    prog = fluid.default_main_program()
    exe_a, scope_a, exe_b, scope_b = _two_scopes()
    rng = np.random.RandomState(4)
    feeds = [_feed(rng) for _ in range(3)]
    a, = exe_a.run_n(prog, feed=_stack(feeds), n=3, fetch_list=[loss],
                     scope=scope_a)
    cp = exe_b.prepare(prog, fetch_list=[loss], scope=scope_b)
    b, = cp.run_n(lambda i: feeds[i], 3)
    np.testing.assert_array_equal(a, b)
    _assert_scopes_equal(scope_a, scope_b)


def test_run_n_for_test_runs_inference_mode():
    """prepare(for_test=True): dropout passes every unit through, and
    run_n's fetches equal the prepared handle's runs."""
    x = layers.data(name="x", shape=[4])
    d = layers.dropout(layers.fc(input=x, size=6), dropout_prob=0.5)
    out = layers.mean(d)
    exe, scope = _exe()
    exe.run(fluid.default_startup_program(), scope=scope)
    feeds = [_feed(np.random.RandomState(i)) for i in range(2)]
    cp = exe.prepare(fluid.default_main_program(), fetch_list=[d, out],
                     scope=scope, for_test=True)
    dv, ov = cp.run_n(_stack([{"x": f["x"]} for f in feeds]), 2)
    ref = [cp.run({"x": f["x"]}) for f in feeds]
    np.testing.assert_array_equal(dv, np.stack([r[0] for r in ref]))
    np.testing.assert_array_equal(ov, np.stack([r[1] for r in ref]))
    assert (dv != 0).all()          # no unit dropped


def test_run_n_feed_shape_validation():
    loss, _ = _build_model()
    prog = fluid.default_main_program()
    exe, scope = _exe()
    exe.run(fluid.default_startup_program(), scope=scope)
    stacked = _stack([_feed(np.random.RandomState(7)) for _ in range(3)])
    with pytest.raises(ValueError, match="leading"):
        exe.run_n(prog, feed=stacked, n=4, fetch_list=[loss], scope=scope)
    with pytest.raises(ValueError, match="n >= 1"):
        exe.run_n(prog, feed=stacked, n=0, fetch_list=[loss], scope=scope)


def test_run_n_check_nan_inf_stands_down_and_aborts():
    loss, _ = _build_model()
    prog = fluid.default_main_program()
    exe, scope = _exe()
    exe.run(fluid.default_startup_program(), scope=scope)
    feeds = [_feed(np.random.RandomState(8)) for _ in range(3)]
    out, = exe.run_n(prog, feed=_stack(feeds), n=3, fetch_list=[loss],
                     scope=scope, check_nan_inf=True)
    assert np.isfinite(out).all() and out.shape[0] == 3
    assert exe.run_n_standdowns["check_nan_inf"] == 3
    snapshot = {n: np.array(v) for n, v in scope.vars.items()}
    bad = [dict(f) for f in feeds]
    bad[0]["x"] = np.full_like(feeds[0]["x"], np.nan)
    with pytest.raises(FloatingPointError):
        exe.run_n(prog, feed=_stack(bad), n=3, fetch_list=[loss],
                  scope=scope, check_nan_inf=True)
    for n, v in scope.vars.items():
        np.testing.assert_array_equal(np.asarray(v), snapshot[n])
    assert exe.run_n_standdowns["check_nan_inf"] == 6


def _while_model(grad):
    x = layers.data(name="wx", shape=[4, 3], append_batch_size=False)
    limit = layers.data(name="wlimit", shape=[1], append_batch_size=False)
    h = layers.elementwise_add(x, layers.fill_constant([4, 3], "float32",
                                                       0.0))
    i = layers.fill_constant([1], "float32", 0.0)
    cond = layers.less_than(i, limit)
    w = fluid.control_flow.While(cond=cond)
    with w.block():
        layers.assign(layers.fc(input=h, size=3, act="tanh",
                                bias_attr=False), output=h)
        layers.assign(layers.elementwise_add(
            i, layers.fill_constant([1], "float32", 1.0)), output=i)
        layers.less_than(i, limit, cond=cond)
    loss = layers.mean(layers.elementwise_mul(h, h))
    fetch = [loss]
    if grad:
        (_, g), = fluid.backward.append_backward(loss)
        fetch.append(g)
    return fetch


@pytest.mark.parametrize("grad", [True, False])
def test_run_n_stands_down_for_an_unbounded_while(grad):
    """The While gradient's replay (capture_vars) and the forward while
    alone (host_sync) run as n runs: counted, and equal to n runs."""
    fetch = _while_model(grad)
    prog = fluid.default_main_program()
    exe_a, scope_a, exe_b, scope_b = _two_scopes()
    f = {"wx": np.random.RandomState(6).rand(4, 3).astype(np.float32),
         "wlimit": np.array([3.0], np.float32)}
    want = [exe_a.run(prog, feed=f, fetch_list=fetch, scope=scope_a)
            for _ in range(2)]
    got = exe_b.run_n(prog, feed=_stack([f, f]), n=2, fetch_list=fetch,
                      scope=scope_b)
    for j in range(len(fetch)):
        np.testing.assert_array_equal(got[j], np.stack([w[j] for w in want]))
    reason = "capture_vars" if grad else "host_sync"
    assert exe_b.run_n_standdowns == {
        r: (2 if r == reason else 0)
        for r in fluid.executor.STANDDOWN_REASONS}


def test_unported_executor_options_raise_naming_their_item():
    with pytest.raises(NotImplementedError, match="item 14"):
        fluid.Executor(fluid.CPUPlace(), mesh=object())
    with pytest.raises(NotImplementedError, match="item 13b"):
        fluid.Executor(fluid.CPUPlace(), compile_cache=object())
    with pytest.raises(NotImplementedError, match="item 13b"):
        fluid.Executor(fluid.CPUPlace(), bake_key="k")
    with pytest.raises(NotImplementedError, match="item 13b"):
        fluid.Executor(fluid.CPUPlace(), donate=False)
    exe = fluid.Executor(fluid.CPUPlace(), donate=True, compile_cache=None)
    assert exe.run_n_standdowns == dict.fromkeys(
        ("check_nan_inf", "capture_vars", "aliased_buffer", "host_sync"), 0)
