"""The legacy config route of the port (counterpart of
``tests/test_legacy_config.py``): a config written like upstream's
``benchmark/paddle/rnn/rnn.py`` (``from ... trainer_config_helpers import
*``, a ``@provider`` data module, ``define_py_data_sources2``,
``settings()``, the ``*_layer`` DSL, ``outputs(loss)``) runs through
``python -m paddle_tpu_torch train --config=`` with only its import lines
changed.

Against the JAX package, on the CPU: the config's topology JSON is
byte-equal, the provider's batches are the same, and from the JAX
package's parameters the first three training batches' costs (the CLI's
default Momentum, as the JAX CLI: ``settings()`` returns its optimizer to
a config that assigns it, and this one does not) agree within 1e-5
relative.
"""

import sys
import textwrap

import numpy as np
import pytest

import paddle_tpu as pj
import paddle_tpu_torch as pt

PROVIDER_SRC = textwrap.dedent("""
    import numpy as np
    from {pkg}.py_data_provider2 import (provider, integer_value,
                                         integer_value_sequence)

    @provider(input_types={{'data': integer_value_sequence(30, max_len=6),
                            'label': integer_value(2)}},
              should_shuffle=False)
    def process(settings, file_name):
        rng = np.random.RandomState(7)
        for i in range(48):
            n = int(rng.randint(2, 6))
            yield {{'data': rng.randint(0, 30, n).astype('int32'),
                    'label': int(i % 2)}}
""")

CONFIG_SRC = textwrap.dedent("""
    from {pkg}.trainer_config_helpers import *

    settings(batch_size=16, learning_rate=5e-3,
             learning_method=AdamOptimizer(learning_rate=5e-3),
             regularization=L2Regularization(8e-4),
             gradient_clipping_threshold=25)

    define_py_data_sources2("{train_list}", "{train_list}",
                            module="{pkg}_legacy_provider", obj="process",
                            args={{}})

    net = data_layer('data', size=30)
    net = embedding_layer(input=net, size=8)
    net = simple_lstm(input=net, size=8)
    net = last_seq(input=net)
    net = fc_layer(input=net, size=2, act=SoftmaxActivation())
    lab = data_layer('label', size=2)
    loss = classification_cost(input=net, label=lab)
    outputs(loss)
""")


@pytest.fixture
def configs(tmp_path):
    """{package name: config path}, each with its own provider module."""
    train_list = tmp_path / "train.list"
    train_list.write_text("dummy\n")
    paths = {}
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        (tmp_path / f"{pkg}_legacy_provider.py").write_text(
            PROVIDER_SRC.format(pkg=pkg))
        cfg = tmp_path / f"{pkg}_config.py"
        cfg.write_text(CONFIG_SRC.format(pkg=pkg, train_list=train_list))
        paths[pkg] = str(cfg)
    sys.path.insert(0, str(tmp_path))
    try:
        yield paths
    finally:
        sys.path.remove(str(tmp_path))


def _load(pkg, path):
    """The config's globals through the package's CLI, from fresh layer
    names."""
    if pkg == "paddle_tpu":
        from paddle_tpu.cli import _load_config
        from paddle_tpu.core.ir import reset_name_counters
        pj.init(seed=0)
    else:
        from paddle_tpu_torch.cli import _load_config
        from paddle_tpu_torch.core.ir import reset_name_counters
        pt.init(seed=0, device="cpu")
    reset_name_counters()
    return _load_config(path)


def test_reference_style_config_trains(configs, capsys):
    from paddle_tpu_torch.cli import main
    main(["train", f"--config={configs['paddle_tpu_torch']}",
          "--job=train", "--num_passes=2", "--log_period=1",
          "--device=cpu"])
    out = capsys.readouterr().out
    assert "Pass 1" in out and "Cost" in out


def test_config_matches_jax(configs):
    jcfg = _load("paddle_tpu", configs["paddle_tpu"])
    jtopo = pj.Topology(jcfg["cost"])
    jparams = pj.parameters.create(jtopo)
    values = {l: {p: np.asarray(v) for p, v in ps.items()}
              for l, ps in jparams.values.items()}
    jbatches = list(jcfg["train_reader"]())
    jcosts = []
    jtrainer = pj.trainer.SGD(jtopo, jparams, pj.optimizer.Momentum(
        learning_rate=0.01, momentum=0.9))
    jtrainer.train(lambda: iter(jbatches[:3]), num_passes=1,
                   feeding=jcfg["feeding"],
                   event_handler=lambda e: jcosts.append(e.cost)
                   if isinstance(e, pj.event.EndIteration) else None)

    tcfg = _load("paddle_tpu_torch", configs["paddle_tpu_torch"])
    ttopo = pt.Topology(tcfg["cost"])
    assert ttopo.proto() == jtopo.proto()
    assert tcfg["feeding"] == jcfg["feeding"] == {"data": 0, "label": 1}
    tbatches = list(tcfg["train_reader"]())
    assert len(tbatches) == len(jbatches) == 3          # 48 at 16
    for tb, jb in zip(tbatches, jbatches):
        for ts, js in zip(tb, jb):
            np.testing.assert_array_equal(ts[0], js[0])
            assert ts[1] == js[1]
    assert len(list(tcfg["test_reader"]())) == 3
    params = pt.parameters.from_numpy(ttopo, values, device="cpu")
    tcosts = []
    ttrainer = pt.trainer.SGD(ttopo, params, pt.optimizer.Momentum(
        learning_rate=0.01, momentum=0.9))
    ttrainer.train(lambda: iter(tbatches[:3]), num_passes=1,
                   feeding=tcfg["feeding"],
                   event_handler=lambda e: tcosts.append(e.cost)
                   if isinstance(e, pt.event.EndIteration) else None)
    assert len(tcosts) == 3
    np.testing.assert_allclose(tcosts, jcosts, rtol=1e-5)


def test_settings_batch_size_and_calc_batch_size(tmp_path):
    """settings(batch_size=) is the provider readers' batch; a provider's
    calc_batch_size prices each sample (can_over_batch_size=False closes
    a batch before it would overflow)."""
    from paddle_tpu_torch import py_data_provider2 as pdp2
    from paddle_tpu_torch.cli import _load_config

    (tmp_path / "cbs_provider.py").write_text(textwrap.dedent("""
        from paddle_tpu_torch.py_data_provider2 import (provider,
                                                        integer_value_sequence)

        @provider(input_types={'w': integer_value_sequence(9)},
                  should_shuffle=False, can_over_batch_size=False,
                  calc_batch_size=lambda s: len(s[0]))
        def gen(settings, fname):
            for n in (3, 4, 2, 5, 1):
                yield {'w': list(range(n))}
    """))
    cfg = tmp_path / "cbs_config.py"
    cfg.write_text(textwrap.dedent("""
        from paddle_tpu_torch.trainer_config_helpers import *
        settings(batch_size=7)
        define_py_data_sources2(["a"], None, module="cbs_provider",
                                obj="gen")
        cost = sum_cost(fc_layer(input=data_layer('w', size=9), size=1))
    """))
    sys.path.insert(0, str(tmp_path))
    try:
        pt.init(seed=0, device="cpu")
        loaded = _load_config(str(cfg))
    finally:
        sys.path.remove(str(tmp_path))
    sizes = [[len(s[0]) for s in b] for b in loaded["train_reader"]()]
    assert sizes == [[3, 4], [2, 5], [1]]
    assert "test_reader" not in loaded
    assert pdp2.get_data_sources()["train_list"] == ["a"]


def test_provider_reader_protocol():
    from paddle_tpu_torch.py_data_provider2 import (CacheType, provider,
                                                    integer_value)

    calls = {"n": 0}

    @provider(input_types={'x': integer_value(5)},
              cache=CacheType.CACHE_PASS_IN_MEM, should_shuffle=False)
    def gen(settings, fname):
        calls["n"] += 1
        for i in range(4):
            yield {'x': i}

    r = gen.reader([None])
    a = list(r())
    b = list(r())                 # second pass served from cache
    assert a == b == [(0,), (1,), (2,), (3,)]
    assert calls["n"] == 1
    assert gen.feeding() == {'x': 0}


def test_tch_star_import_surface():
    import paddle_tpu.trainer_config_helpers as jtch
    import paddle_tpu_torch.trainer_config_helpers as tch
    for sym in ["fc_layer", "img_conv_layer", "lstmemory", "simple_lstm",
                "settings", "AdamOptimizer", "L2Regularization",
                "SoftmaxActivation", "ReluActivation", "MaxPooling",
                "ParamAttr", "ParameterAttribute", "ExtraLayerAttribute",
                "provider", "define_py_data_sources2", "data_layer",
                "outputs", "classification_error_evaluator",
                "recurrent_group", "beam_search", "memory",
                "cross_entropy_over_beam", "lambda_cost",
                "pnpair_evaluator", "gradient_printer_evaluator",
                "multi_head_attention", "lstmemory_group", "inputs"]:
        assert hasattr(tch, sym), sym
    public = {n for n in dir(jtch) if not n.startswith("_")}
    # the JAX module's own star-import also sweeps up jax / jnp
    assert public - {n for n in dir(tch)} == {"jax", "jnp"}


def test_layer_math_overloads():
    from paddle_tpu_torch.trainer_config_helpers import data_layer, sum_cost
    from paddle_tpu_torch.trainer_config_helpers import layer_math as lm
    import paddle_tpu_torch.trainer_config_helpers as tch

    pt.init(seed=0, device="cpu")
    x = data_layer('xm', size=3)
    s = lm.sqrt(lm.abs(lm.tanh(2.0 * x + 1.0) - x) + 0.5)
    assert not hasattr(tch, "abs") or tch.abs is lm.abs is not abs
    assert abs(-3) == 3
    topo = pt.Topology(sum_cost(s), collect_evaluators=False)
    params = pt.parameters.create(topo, device="cpu")
    xv = np.array([[0.1, 0.2, 0.3]], np.float32)
    outs, _ = topo.forward(params.values, topo.create_state(device="cpu"),
                           {"xm": xv}, train=False, device="cpu")
    expect = np.sqrt(np.abs(np.tanh(2 * xv + 1) - xv) + 0.5).sum()
    np.testing.assert_allclose(float(outs[topo.output_names[0]]), expect,
                               rtol=1e-5)


def test_top_level_exports():
    assert pt.default_main_program() is not None
    assert pt.default_startup_program() is not None
    assert callable(pt.batch)
    assert pt.plot.Ploter is not None


def _cli_out(pkg, argv, capsys):
    """a verb of the package's CLI, from fresh layer names"""
    if pkg == "paddle_tpu":
        from paddle_tpu.cli import main
        from paddle_tpu.core.ir import reset_name_counters
        pj.init(seed=0)
    else:
        from paddle_tpu_torch.cli import main
        from paddle_tpu_torch.core.ir import reset_name_counters
        pt.init(seed=0, device="cpu")
    reset_name_counters()
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out


def test_dump_config_prints_the_jax_packages_ir(configs, capsys):
    """``dump_config`` of the legacy config: the Topology.proto() JSON,
    the JAX CLI's text byte for byte."""
    outs = {pkg: _cli_out(pkg, ["dump_config", f"--config={path}"], capsys)
            for pkg, path in configs.items()}
    assert outs["paddle_tpu_torch"] == outs["paddle_tpu"]
    assert '"data"' in outs["paddle_tpu_torch"]


def test_version_and_pserver_verbs(capsys):
    """``version`` names the package with torch and CUDA where the JAX
    package names jax; ``pserver`` says, as the JAX CLI does, that there
    is no parameter-server process."""
    import torch

    got = _cli_out("paddle_tpu_torch", ["version"], capsys)
    want = _cli_out("paddle_tpu", ["version"], capsys)
    assert want.startswith(f"paddle_tpu {pj.__version__} (jax ")
    assert got.startswith(f"paddle_tpu_torch {pt.__version__} "
                          f"(torch {torch.__version__}, ")
    assert got.rstrip().endswith("device(s))")
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        msg = _cli_out(pkg, ["pserver"], capsys)
        assert f"{pkg} has no separate pserver process" in msg


def test_data_layers_and_forward_masks_match_jax(configs):
    """``Topology.data_layers()`` and ``forward(with_masks=True)``: the
    data layers in input order with the JAX specs, and from the JAX
    parameters every layer's value and propagated mask (None where the
    JAX package has none) on a padded batch."""
    jcfg = _load("paddle_tpu", configs["paddle_tpu"])
    jtopo = pj.Topology(jcfg["cost"])
    jparams = pj.parameters.create(jtopo)
    tcfg = _load("paddle_tpu_torch", configs["paddle_tpu_torch"])
    ttopo = pt.Topology(tcfg["cost"])
    jd, td = jtopo.data_layers(), ttopo.data_layers()
    assert list(td) == list(jd) == ["data", "label"]
    for name in jd:
        assert td[name].kind == jd[name].kind == "data"
        assert td[name].attrs == jd[name].attrs
    rng = np.random.RandomState(0)
    feed = {"data": rng.randint(0, 30, (4, 6)).astype(np.int32),
            "data@len": np.array([6, 3, 2, 5], np.int32),
            "label": np.array([0, 1, 1, 0], np.int32)}
    names = [s.name for s in jtopo.specs if s.kind != "data"]
    jouts, _, jmasks = jtopo.forward(jparams.values, jtopo.create_state(),
                                     feed, outputs=names, with_masks=True)
    values = {l: {p: np.asarray(v) for p, v in ps.items()}
              for l, ps in jparams.values.items()}
    params = pt.parameters.from_numpy(ttopo, values, device="cpu")
    touts, _, tmasks = ttopo.forward(params.values, ttopo.create_state(),
                                     feed, outputs=names, with_masks=True,
                                     device="cpu")
    assert set(tmasks) == set(jmasks) == set(names)
    assert any(m is not None for m in tmasks.values())
    for n in names:
        if jmasks[n] is None:
            assert tmasks[n] is None, n
        else:
            np.testing.assert_array_equal(tmasks[n].numpy(),
                                          np.asarray(jmasks[n]), err_msg=n)
        np.testing.assert_allclose(touts[n].detach().numpy(),
                                   np.asarray(jouts[n]), rtol=1e-5,
                                   atol=1e-6, err_msg=n)
    two = ttopo.forward(params.values, ttopo.create_state(), feed,
                        outputs=names, device="cpu")
    assert len(two) == 2
