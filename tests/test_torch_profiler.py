"""The port's profiler (``utils/profiler.py``, ``fluid/profiler.py``)
against ``tests/test_profiler.py``: the named host timers and their
report run the same cases in both packages (``prof``) and print the same
table for the same adds; the ``torch.profiler`` capture writes a Chrome
trace holding the trainer's ``trainer/step`` ranges; it warns once when
it cannot start; ``print_stats`` appends the metrics table while
telemetry is on; ``layer_cost_report`` gives each fc layer exactly
2 B in out forward FLOPs, and ``train --job=time --show_layer_stat``
prints them.  Timings are only checked for order and sign.
"""

import importlib
import json
import time

import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu_torch import event as v2_event
from paddle_tpu_torch.core.ir import reset_name_counters as reset_port_names
from paddle_tpu_torch.utils import profiler as tprof

PKGS = ("paddle_tpu", "paddle_tpu_torch")


@pytest.fixture(params=PKGS)
def prof(request):
    mod = importlib.import_module(f"{request.param}.utils.profiler")
    mod.reset_profiler()
    yield mod
    mod.reset_profiler()


def test_timer_accumulates(prof):
    stats = prof.StatSet()
    for _ in range(3):
        with prof.timer("work", stats):
            time.sleep(0.002)
    count, total, mx = stats.items()["work"]
    assert count == 3 and total >= 0.006 and mx <= total


def test_timed_decorator_metadata_and_report(prof):
    stats = prof.StatSet()

    @prof.timed("fn", stats)
    def my_documented_fn(x, y=2):
        """adds things"""
        return x + y

    assert my_documented_fn(1) == 3 and my_documented_fn(2) == 4
    assert my_documented_fn.__name__ == "my_documented_fn"
    assert my_documented_fn.__doc__ == "adds things"
    rep = stats.report()
    assert "fn" in rep and "count" in rep and stats.items()["fn"][0] == 2


def test_global_reset(prof):
    with prof.timer("g"):
        pass
    assert "g" in prof.GLOBAL_STATS.items()
    prof.reset_profiler()
    assert prof.GLOBAL_STATS.items() == {}


def test_report_sorted_key(prof):
    stats = prof.StatSet()
    for _ in range(3):
        stats.add("aa", 0.001)
    stats.add("bb", 0.005)

    def order(rep):
        return [ln.split()[0] for ln in rep.splitlines()[1:]]

    assert order(stats.report()) == ["bb", "aa"]
    for key, want in (("count", ["aa", "bb"]), ("calls", ["aa", "bb"]),
                      ("avg", ["bb", "aa"]), ("max", ["bb", "aa"])):
        assert order(stats.report(sorted_key=key)) == want
    with pytest.raises(ValueError):
        stats.report(sorted_key="zzz")


def test_report_text_equals_the_jax_packages():
    from paddle_tpu.utils import profiler as jprof

    tables = []
    for mod in (jprof, tprof):
        stats = mod.StatSet()
        for name, dt in (("feed", 0.0012), ("step", 0.0125), ("feed", 0.003),
                         ("eval", 0.0004)):
            stats.add(name, dt)
        tables.append([stats.report(sorted_key=k)
                       for k in ("total", "avg", "count")])
    assert tables[1] == tables[0]


def test_trainer_timers_hook(capsys):
    hook = tprof.TrainerTimers()
    for b in range(3):
        hook(v2_event.BeginIteration(0, b))
        time.sleep(0.001)
        hook(v2_event.EndIteration(0, b, 0.0, {}))
    hook(v2_event.EndPass(0))
    out = capsys.readouterr().out
    assert "batch" in out and "total_ms" in out


def test_fluid_profiler_honors_sorted_key(capsys, tmp_path):
    from paddle_tpu_torch.fluid import profiler as fprof

    tprof.reset_profiler()
    with fprof.profiler(sorted_key="count", log_dir=str(tmp_path)):
        with tprof.timer("aa"):
            pass
        with tprof.timer("aa"):
            pass
        with tprof.timer("bb"):
            time.sleep(0.005)
    out = capsys.readouterr().out
    assert out.index("aa") < out.index("bb")
    with pytest.raises(ValueError):
        with fprof.profiler(sorted_key="zzz"):
            pass
    tprof.reset_profiler()


def test_profiler_warns_once_when_the_capture_cannot_start(tmp_path,
                                                           monkeypatch):
    import warnings

    import torch

    def boom(*a, **k):
        raise RuntimeError("no profiler backend")

    monkeypatch.setattr(torch.profiler, "profile", boom)
    monkeypatch.setattr(tprof, "_START_TRACE_WARNED", False)
    with pytest.warns(RuntimeWarning, match="torch.profiler"):
        with tprof.profiler(str(tmp_path / "t")) as p:
            assert p is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with tprof.profiler(str(tmp_path / "t")):
            pass
    assert not (tmp_path / "t" / "trace.json").exists()


def test_print_stats_appends_metrics_table_when_enabled(capsys):
    from paddle_tpu_torch import observability as obs

    tprof.reset_profiler()
    with tprof.timer("host_section"):
        pass
    obs.reset()
    obs.enable()
    try:
        obs.metrics.counter("obs_print_total").inc(4)
        tprof.print_stats()
    finally:
        obs.disable()
    out = capsys.readouterr().out
    assert "host_section" in out and "obs_print_total" in out
    tprof.print_stats()
    assert "obs_print_total" not in capsys.readouterr().out
    obs.reset()
    tprof.reset_profiler()


def _mlp_trainer(batch=8):
    reset_port_names()
    pt.init(seed=0, device="cpu")
    x = pt.layer.data("x", pt.data_type.dense_vector(32))
    y = pt.layer.data("y", pt.data_type.integer_value(5))
    h = pt.layer.fc(x, size=64, act="relu", name="big_fc")
    cost = pt.layer.classification_cost(pt.layer.fc(h, size=5, name="head"),
                                        y)
    topo = pt.Topology(cost, collect_evaluators=False)
    params = pt.parameters.create(topo, device="cpu")
    tr = pt.trainer.SGD(topo, params, pt.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9))
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(batch, 32).astype(np.float32),
            "y": rng.randint(0, 5, (batch,)).astype(np.int32)}
    return tr, feed


def test_profiler_trace_holds_the_trainer_steps(tmp_path):
    """``profiler(log_dir)`` around two training steps: one Chrome trace
    with two ``trainer/step`` ranges and the steps' own ops."""
    tr, feed = _mlp_trainer()
    with tprof.profiler(str(tmp_path)) as p:
        assert p is not None and tprof.PROFILING
        tr.train(lambda: iter([feed, feed]), event_handler=lambda e: None)
    assert not tprof.PROFILING
    doc = json.load(open(tmp_path / "trace.json"))
    names = [e.get("name") for e in doc["traceEvents"]]
    assert names.count("trainer/step") == 2
    assert any(n and n.startswith("aten::") for n in names)


def test_layer_cost_report_attributes_layers():
    """Each fc layer's forward FLOPs are exactly 2 B in out (the flop
    counter inside its scope), the rest of the step is ``backward``, and
    every layer has a time from the profiled step; the trainer's state
    is as it was."""
    tr, feed = _mlp_trainer(batch=8)
    before = {k: v.clone() for k, v in tr._trainable["big_fc"].items()}
    rows = dict(tprof.layer_cost_report(tr, feed))
    assert rows["fc:big_fc"]["flops"] == 2 * 8 * 32 * 64
    assert rows["fc:head"]["flops"] == 2 * 8 * 64 * 5
    assert rows["backward"]["flops"] > 0
    assert rows["fc:big_fc"]["time_us"] > 0 and rows["fc:head"]["time_us"] > 0
    assert list(rows)[0] == "fc:big_fc" or list(rows)[0] == "backward"
    for k, v in tr._trainable["big_fc"].items():
        assert (v == before[k]).all()


def test_cli_time_show_layer_stat(tmp_path, capsys, monkeypatch):
    from paddle_tpu_torch import cli
    from paddle_tpu_torch.core import config as tconfig

    monkeypatch.setitem(tconfig._options, "device", None)
    path = tmp_path / "cfg.py"
    path.write_text(
        "import paddle_tpu_torch as paddle\n"
        "from paddle_tpu_torch import layer\n"
        "paddle.init(seed=0)\n"
        "x = layer.data('x', paddle.data_type.dense_vector(16))\n"
        "y = layer.data('y', paddle.data_type.integer_value(3))\n"
        "cost = layer.classification_cost(layer.fc(x, size=3, "
        "name='only_fc'), y)\n")
    reset_port_names()
    cli.main(["train", "--config", str(path), "--job=time", "--device",
              "cpu", "--batch_size", "4", "--iters", "2",
              "--show_layer_stat"])
    out = capsys.readouterr().out
    assert "gflops" in out and "fc:only_fc" in out
    assert json.loads(out.strip().splitlines()[-1])["batch_size"] == 4
