"""The port's telemetry spine (``paddle_tpu_torch/observability``) against
the JAX package's: the registry, span ring and sinks run the same cases
in both packages (``pkg``); the same mutations expose byte-equal
Prometheus text and equal JSONL snapshots; each package's ``metrics`` and
``trace`` verbs read the other's files and print what its own verb
prints; the same driven trainer (``seq_buckets``), Fluid program and
prefetch give equal counters, span names and step ids; the checkpoint
counters match; ``lockcheck`` raises on the same inverted acquisition,
and the port's engine and checkpoint writer observe no lock-order edge
the JAX engine's same sequence does not; every option still refused
names its item.  Counts and texts are compared exactly; the only
tolerance is the JAX file's ``pytest.approx`` on float sums.
"""

import importlib
import io
import json
import os
import threading
import time

import numpy as np
import pytest

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.core.ir import reset_name_counters as reset_jax_names
from paddle_tpu_torch.core.ir import reset_name_counters as reset_port_names

PKGS = ("paddle_tpu", "paddle_tpu_torch")


def _mods(root):
    return (importlib.import_module(f"{root}.observability"),
            importlib.import_module(f"{root}.observability.metrics"),
            importlib.import_module(f"{root}.observability.sinks"),
            importlib.import_module(f"{root}.observability.tracing"))


@pytest.fixture(params=PKGS)
def pkg(request):
    """(observability, metrics, sinks, tracing) of one package, telemetry
    on for the test and off after."""
    obs, m, sinks, tracing = _mods(request.param)
    obs.reset()
    obs.enable()
    yield obs, m, sinks, tracing
    obs.disable()
    obs.reset()


@pytest.fixture
def both():
    """Both packages' observability, telemetry on, off after."""
    out = [_mods(root) for root in PKGS]
    for obs, *_ in out:
        obs.reset()
        obs.enable()
    yield out
    for obs, *_ in out:
        obs.disable()
        obs.reset()


# ------------------------------------------------------------ primitives
def test_disabled_is_noop(pkg):
    obs, m, _, tracing = pkg
    obs.disable()
    c = m.counter("obs_noop_total")
    h = m.histogram("obs_noop_us")
    g = m.gauge("obs_noop_depth")
    c.inc()
    h.observe(5)
    g.set(3)
    m.record([(c, 1)], [(h, 5)])
    assert c.value == 0 and h.count == 0 and g.value == 0
    tr = tracing.Tracer(capacity=4)
    tr.add("x", 0, 10)
    with tr.span("y"):
        pass
    assert tr.events() == []


def test_counter_gauge_histogram_semantics(pkg):
    _, m, _, _ = pkg
    c = m.counter("obs_sem_total", "help text")
    c.inc()
    c.inc(2)
    assert c.value == 3 and m.counter("obs_sem_total") is c
    g = m.gauge("obs_sem_depth")
    g.set(7)
    g.set(3)
    g.add(2)
    assert g.value == 5
    h = m.histogram("obs_sem_us", buckets=(1, 10, 100))
    for v in (0.5, 1, 5, 50, 5000):
        h.observe(v)
    assert h.count == 5 and h.sum == pytest.approx(5056.5)
    assert h.bucket_counts == [2, 1, 1, 1]
    assert h.quantile(0.5) == 10.0 and h.quantile(0.99) == float("inf")


def test_fused_record_labels_conflict_and_reset(pkg):
    obs, m, _, tracing = pkg
    c = m.counter("obs_rec_total")
    h = m.histogram("obs_rec_us", buckets=(1, 10))
    tr = tracing.Tracer(capacity=8)
    m.record([(c, 2)], [(h, 5), (h, 50)],
             [("s", "host", 100, 10, 7, 1, None)], tr)
    assert c.value == 2 and h.bucket_counts == [0, 1, 1]
    assert [(e["name"], e["step"]) for e in tr.events()] == [("s", 7)]
    a = m.counter("obs_lbl_total", cause="x")
    a.inc(2)
    m.counter("obs_lbl_total", cause="y").inc()
    assert obs.REGISTRY.by_label("obs_lbl_total", "cause") == {"x": 2,
                                                              "y": 1}
    with pytest.raises(TypeError):
        m.gauge("obs_lbl_total", cause="x")
    obs.reset()
    assert c.value == 0 and h.count == 0 and h.sum == 0
    c.inc()
    assert m.counter("obs_rec_total") is c and c.value == 1


def test_thread_safety(pkg):
    _, m, _, _ = pkg
    c = m.counter("obs_thr_total")
    h = m.histogram("obs_thr_us")

    def work():
        for _ in range(500):
            c.inc()
            h.observe(3)
            m.record([(c, 1)], [(h, 7)])

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == 8000 and h.count == 8000


def test_ring_buffer_span_and_chrome_round_trip(pkg, tmp_path):
    _, _, sinks, tracing = pkg
    tr = tracing.Tracer(capacity=16)
    for i in range(40):
        tr.add(f"s{i}", i * 10, 5, step=i)
    assert [e["name"] for e in tr.events()] == [f"s{i}"
                                                for i in range(24, 40)]
    tr.clear()
    with tr.span("outer", step=2, tag="v"):
        time.sleep(0.001)
    (e,) = tr.events()
    assert e["step"] == 2 and e["dur_ns"] >= 1_000_000
    assert e["args"] == {"tag": "v"}
    tr.clear()
    tr.add("fluid/dispatch", 1000, 500, step=3)
    path = sinks.write_chrome_trace(str(tmp_path / "trace.json"), tracer=tr)
    doc = json.load(open(path))
    (x,) = [ev for ev in doc["traceEvents"] if ev.get("ph") == "X"]
    assert (x["ts"], x["dur"], x["args"]["step"]) == (1.0, 0.5, 3)
    assert any(ev.get("ph") == "M" for ev in doc["traceEvents"])


def test_jsonl_snapshots_and_periodic_snapshotter(pkg, tmp_path):
    _, m, sinks, _ = pkg
    c = m.counter("obs_snap_total")
    c.inc(5)
    path = str(tmp_path / "metrics.jsonl")
    sinks.write_metrics_snapshot(path, extra={"run": 1})
    c.inc()
    sinks.write_metrics_snapshot(path)
    snaps = sinks.read_snapshots(path)
    assert [m.snapshot_value(s, "obs_snap_total") for s in snaps] == [5, 6]
    assert snaps[0]["run"] == 1 and "ts" in snaps[0]
    ppath = str(tmp_path / "periodic.jsonl")
    snapper = sinks.start_periodic_snapshots(ppath, interval_s=0.05)
    deadline = time.time() + 5.0
    while time.time() < deadline and len(sinks.read_snapshots(ppath)) < 2:
        time.sleep(0.02)
    c.inc()
    snapper.stop()
    got = sinks.read_snapshots(ppath)
    assert len(got) >= 3
    assert m.snapshot_value(got[-1], "obs_snap_total") == 7


def test_metrics_http_endpoint(pkg):
    from urllib.error import HTTPError
    from urllib.request import urlopen

    _, m, sinks, _ = pkg
    m.counter("obs_http_total", "served").inc(5)
    server = sinks.serve_metrics(0, host="127.0.0.1")
    try:
        base = f"http://127.0.0.1:{server.server_port}"
        assert "obs_http_total 5" in urlopen(f"{base}/metrics").read() \
            .decode()
        snap = json.loads(urlopen(f"{base}/metrics.json").read())
        assert m.snapshot_value(snap, "obs_http_total") == 5
        assert urlopen(f"{base}/healthz").read() == b"ok\n"
        m.counter("obs_http_total").inc()
        assert "obs_http_total 6" in urlopen(f"{base}/metrics").read() \
            .decode()
        with pytest.raises(HTTPError):
            urlopen(f"{base}/nope")
    finally:
        server.shutdown()
        server.server_close()


def test_statset_thread_safety():
    from paddle_tpu_torch.utils.profiler import StatSet

    s = StatSet()

    def work():
        for _ in range(1000):
            s.add("t", 0.001)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    count, total, mx = s.items()["t"]
    assert count == 8000 and total == pytest.approx(8.0)


# ------------------------------------------------- exposition and files
def _mutate(m, reg):
    reg.counter("x_total", "a counter", cause="a").inc(3)
    reg.counter("x_total", "a counter", cause="b").inc()
    reg.gauge("x_depth", "a gauge").set(4)
    reg.gauge("x_ratio").set(0.25)
    h = reg.histogram("x_us", "a histogram", buckets=(1, 10, 100))
    for v in (0.5, 7, 7, 250.5):
        h.observe(v)
    m.record([(reg.counter("x_total", cause="a"), 2)], [(h, 3)])


def test_exposition_is_byte_equal_across_packages(both):
    (_, jm, _, _), (_, tm, _, _) = both
    jreg, treg = jm.MetricsRegistry(), tm.MetricsRegistry()
    _mutate(jm, jreg)
    _mutate(tm, treg)
    assert treg.snapshot() == jreg.snapshot()
    assert treg.to_prometheus() == jreg.to_prometheus()
    assert treg.render_table() == jreg.render_table()
    snap = jreg.snapshot()
    assert tm.prometheus_from_snapshot(snap) == \
        jm.prometheus_from_snapshot(snap)


def _write_files(obs, m, sinks, d):
    m.counter("obs_cli_total").inc(3)
    m.histogram("obs_cli_us").observe(12)
    obs.TRACER.add("fluid/dispatch", 5000, 2000, step=1)
    obs.TRACER.add("fluid/dispatch", 9000, 2500, step=2)
    obs.TRACER.add("trainer/pass", 1000, 9000, cat="pass", args={"pass": 0})
    sinks.write_metrics_snapshot(os.path.join(d, "metrics.jsonl"))
    sinks.write_chrome_trace(os.path.join(d, "trace.json"))


@pytest.mark.parametrize("writer", PKGS)
def test_cli_verbs_read_each_others_files(both, writer, tmp_path, capsys):
    """Files written by ``writer``: the port's and the JAX package's
    ``metrics`` (table, prom, json) and ``trace`` verbs print the same."""
    from paddle_tpu import cli as jcli
    from paddle_tpu_torch import cli as tcli

    mods = both[PKGS.index(writer)]
    _write_files(*mods[:3], str(tmp_path))
    mpath = str(tmp_path / "metrics.jsonl")
    tpath = str(tmp_path / "trace.json")
    for argv in (["metrics", "--file", mpath],
                 ["metrics", "--file", mpath, "--format", "prom"],
                 ["metrics", "--file", mpath, "--format", "json"],
                 ["trace", "--file", tpath],
                 ["trace", "--file", tpath, "--step", "1"]):
        outs = []
        for cli in (jcli, tcli):
            cli.main(argv)
            outs.append(capsys.readouterr().out)
        assert outs[1] == outs[0], argv
    assert "obs_cli_total" in outs[0] or "fluid/dispatch" in outs[0]
    with pytest.raises(SystemExit):
        tcli.main(["metrics", "--file", str(tmp_path / "nope.jsonl")])


# ------------------------------------------------------ driven parity
def _bucket_topo(paddle):
    layer = paddle.layer
    x = layer.data("x", paddle.data_type.dense_vector_sequence(4,
                                                               max_len=64))
    h = layer.last_seq(layer.fc(x, size=8, act="tanh", name="h"),
                       name="last")
    y = layer.data("y", paddle.data_type.integer_value(2))
    cost = layer.classification_cost(layer.fc(h, size=2, name="out"), y,
                                     name="cost")
    return paddle.Topology(cost, collect_evaluators=False)


def _trainer_counts(obs):
    reg = obs.REGISTRY
    pad = reg.get("trainer_padding_waste_pct")
    spans = [(e["name"], e["step"]) for e in obs.TRACER.events()
             if e["name"].startswith("trainer/") and e["name"] !=
             "trainer/pass"]
    return {"batches": reg.value("trainer_batches_total"),
            "passes": reg.value("trainer_passes_total"),
            "steps": reg.get("trainer_step_dispatch_us").count,
            "feeds": reg.get("trainer_feed_us").count,
            "pass_hist": reg.get("trainer_pass_us").count,
            "pad_count": pad.count, "pad_buckets": pad.bucket_counts,
            "spans": spans}


def test_trainer_counters_and_spans_match_jax(both):
    """The same 2 passes of 5 batches under ``seq_buckets=True``: equal
    batches, passes, feed / step / pass counts, the padding-waste
    histogram's bucket counts, and the spans' names and step ids."""
    (jobs, *_), (tobs, *_) = both
    reset_jax_names()
    reset_port_names()
    pj.init(seed=0)
    pt.init(seed=0, device="cpu")
    rng = np.random.RandomState(0)
    samples = [(rng.rand(n, 4).astype(np.float32), int(rng.randint(2)))
               for n in rng.randint(4, 29, size=20)]

    def reader():
        for i in range(0, len(samples), 4):
            yield samples[i:i + 4]

    counts = []
    for paddle, obs in ((pj, jobs), (pt, tobs)):
        topo = _bucket_topo(paddle)
        kw = {} if paddle is pj else {"device": "cpu"}
        params = paddle.parameters.create(topo, **kw)
        tr = paddle.trainer.SGD(topo, params, paddle.optimizer.Momentum(
            learning_rate=0.05, momentum=0.9))
        obs.reset()
        tr.train(reader, num_passes=2, event_handler=lambda e: None,
                 seq_buckets=True)
        counts.append(_trainer_counts(obs))
    assert counts[0]["batches"] == 10 and counts[0]["pad_count"] == 10
    assert counts[1] == counts[0]


def _sgd_program(fluid):
    from importlib import import_module
    layers = import_module(fluid.__name__ + ".layers")
    fluid.framework.reset_default_programs()
    x = layers.data(name="x", shape=[4])
    label = layers.data(name="label", shape=[1])
    y = layers.fc(input=x, size=1)
    loss = layers.mean(layers.square_error_cost(y, label))
    fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return loss


def _fluid_counts(obs):
    reg = obs.REGISTRY
    return {name: reg.value(name) for name in (
        "fluid_steps_total", "fluid_plan_cache_hits_total",
        "fluid_plan_cache_misses_total", "fluid_run_n_chunks_total",
        "fluid_run_n_steps_total")}, [
        (e["name"], e["step"]) for e in obs.TRACER.events()]


def test_fluid_counters_and_spans_match_jax(both):
    """Three ``run()`` steps, two prepared runs and one ``run_n`` chunk
    of 2 on the same SGD program: equal steps, plan hits and misses,
    ``run_n`` chunks and steps, and equal span names and step ids."""
    import paddle_tpu.fluid as jfluid
    import paddle_tpu_torch.fluid as tfluid

    (jobs, *_), (tobs, *_) = both
    rng = np.random.RandomState(0)
    xv = rng.rand(8, 4).astype(np.float32)
    feed = {"x": xv, "label": xv.sum(1, keepdims=True)}
    got = []
    for fluid, obs in ((jfluid, jobs), (tfluid, tobs)):
        loss = _sgd_program(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(fluid.default_startup_program(), scope=scope)
        obs.reset()
        for _ in range(3):
            exe.run(feed=feed, fetch_list=[loss], scope=scope)
        cp = exe.prepare(fluid.default_main_program(), feed_names=list(feed),
                         fetch_list=[loss], scope=scope)
        for _ in range(2):
            cp.run(feed)
        exe.run_n(feed={k: np.stack([v, v]) for k, v in feed.items()}, n=2,
                  fetch_list=[loss], scope=scope)
        got.append(_fluid_counts(obs))
    (jc, jspans), (tc, tspans) = got
    assert tc == jc
    assert jc["fluid_steps_total"] == 5 and jc["fluid_run_n_steps_total"] == 2
    assert tspans == jspans
    names = {n for n, _ in tspans}
    assert {"fluid/feed_coerce", "fluid/plan_lookup", "fluid/dispatch",
            "fluid/run_n_chunk"} <= names


def test_executor_plan_eviction_and_stand_down_labels(both):
    """A program changed between runs evicts its plan (counted, as in
    the JAX executor); ``run_n`` with ``check_nan_inf`` stands down
    under its label."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import layers

    _, (obs, *_) = both
    fluid.framework.reset_default_programs()
    x = layers.data(name="x", shape=[4])
    fetch = layers.mean(layers.fc(input=x, size=2))
    prog = fluid.default_main_program()
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(fluid.default_startup_program(), scope=scope)
    feed = {"x": np.ones((2, 4), np.float32)}
    obs.reset()
    for i in range(3):
        exe.run(prog, feed=feed, fetch_list=[fetch], scope=scope)
        with fluid.program_guard(prog):
            layers.fill_constant([1], "float32", float(i))
    assert obs.REGISTRY.value("fluid_plan_cache_evictions_total") == 2
    exe.run_n(prog, feed={"x": np.ones((3, 2, 4), np.float32)}, n=3,
              fetch_list=[fetch], scope=scope, check_nan_inf=True)
    assert obs.REGISTRY.value("fluid_run_n_fallback_steps_total",
                              reason="check_nan_inf") == 3


def test_prefetch_counters_match_jax(both):
    from paddle_tpu.reader.prefetch import prefetch_to_device as jpf
    from paddle_tpu_torch.reader.prefetch import prefetch_to_device as tpf

    (jobs, *_), (tobs, *_) = both
    feeds = [{"x": np.full((2, 3), i, np.float32)} for i in range(5)]
    for fn, obs, kw in ((jpf, jobs, {}), (tpf, tobs, {"device": "cpu"})):
        got = [f["x"] for f in fn(lambda: iter(feeds), depth=2, **kw)()]
        assert len(got) == 5
    for name in ("prefetch_batches_total", "dataloader_queue_depth"):
        assert tobs.REGISTRY.value(name) == jobs.REGISTRY.value(name), name
    assert tobs.REGISTRY.value("prefetch_batches_total") == 5


def test_checkpoint_counters_match_jax(both, tmp_path, monkeypatch):
    """The same saves, a quarantine and a scrub pass: equal
    ``checkpoints_total``, ``checkpoint_quarantined_total`` and
    ``checkpoint_reverified_total`` in both packages, and a background
    write lands in the save-time histogram.  Idle scrubs are held off
    meanwhile: a writer another test left scrubbing in this process
    would count its own directory into the same counters."""
    from paddle_tpu.io import checkpoint as jck
    from paddle_tpu_torch.io import checkpoint as tck

    for ck in (jck, tck):
        monkeypatch.setattr(ck.AsyncCheckpointWriter, "_maybe_scrub",
                            lambda self: None)
    tree = {"fc": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}}
    for ck, (obs, *_), d in ((jck, both[0], tmp_path / "j"),
                             (tck, both[1], tmp_path / "t")):
        d = str(d)
        for g in (1, 2):
            ck.save_step(d, g, pass_id=0, batches_done=g, trainable=tree,
                         opt_state={}, model_state={})
        with open(os.path.join(ck.step_dir(d, 2), "params.npz"), "r+b") as f:
            f.seek(40)
            f.write(b"\xff\xff\xff\xff")
        ck.reverify_steps(d)
        w = ck.AsyncCheckpointWriter()
        w.submit(lambda d=d: ck.save_step(d, 3, pass_id=0, batches_done=3,
                                          trainable=tree, opt_state={},
                                          model_state={}))
        assert w.flush() == []
    want = both[0][0].REGISTRY
    got = both[1][0].REGISTRY
    for name, labels in (("checkpoints_total", {"result": "ok"}),
                         ("checkpoints_total", {"result": "error"}),
                         ("checkpoint_quarantined_total", {}),
                         ("checkpoint_reverified_total", {"result": "ok"}),
                         ("checkpoint_reverified_total",
                          {"result": "corrupt"})):
        assert got.value(name, **labels) == want.value(name, **labels), name
    assert got.value("checkpoint_quarantined_total") == 1
    assert got.get("trainer_checkpoint_save_us",
                   phase="background_write").count == 1


# ------------------------------------------------------------ lockcheck
@pytest.mark.parametrize("root", PKGS)
def test_lockcheck_raises_on_the_inverted_acquisition(root, monkeypatch):
    lc = importlib.import_module(f"{root}.utils.lockcheck")
    monkeypatch.setenv("PADDLE_TPU_LOCKCHECK", "1")
    lc.reset()
    a, b = lc.make_lock("t.a"), lc.make_lock("t.b")
    assert isinstance(a, lc.DebugLock)
    with a:
        with b:
            pass
    with pytest.raises(lc.LockOrderError, match="t.a"):
        with b:
            with a:
                pass
    assert lc.violations()
    lc.reset()
    monkeypatch.delenv("PADDLE_TPU_LOCKCHECK")
    assert not isinstance(lc.make_lock("t.c"), lc.DebugLock)


def _drive_locks(root, dec, values, tmp):
    """Admission, a shed, a swap and close on a decode engine, then two
    writes through the async checkpoint writer."""
    eng_mod = importlib.import_module(f"{root}.serving.engine")
    ck = importlib.import_module(f"{root}.io.checkpoint")
    eng = eng_mod.InferenceEngine(decoder=dec, max_queue_depth=8,
                                  tenant_weights={"a": 2.0, "b": 1.0})
    try:
        for i, t in enumerate(("a", "b", None)):
            eng.infer([np.arange(3 + i) % 48], 60, max_tokens=2, tenant=t)
        fut = eng.submit([np.arange(4) % 48], max_tokens=2,
                         deadline_us=1)
        with pytest.raises(eng_mod.DeadlineExceeded):
            fut.result(60)
        eng.install_version("v2", values)
        eng.infer([np.arange(4) % 48], 60, max_tokens=2)
        eng.stats()
        eng.tenant_stats()
    finally:
        eng.close(drain_timeout_s=30)
    w = ck.AsyncCheckpointWriter()
    tree = {"fc": {"w": np.ones((2, 2), np.float32)}}
    for g in (1, 2):
        w.submit(lambda g=g: ck.save_step(tmp, g, pass_id=0, batches_done=g,
                                          trainable=tree, opt_state={},
                                          model_state={}))
    assert w.flush() == []


def test_lock_order_edges_are_a_subset_of_the_jax_engines(monkeypatch,
                                                          tmp_path):
    """With ``PADDLE_TPU_LOCKCHECK=1`` the port's engine (admission, a
    deadline shed, a swap, close) and async checkpoint writer raise no
    ``LockOrderError`` and observe only acquisition edges the JAX engine
    and writer observe in the same sequence."""
    from paddle_tpu.models import transformer as jtr
    from paddle_tpu.utils import lockcheck as jlc
    from paddle_tpu_torch.models import transformer as ttr
    from paddle_tpu_torch.utils import lockcheck as tlc
    from torch_serving_helpers import HEADS, lm, slab

    monkeypatch.setenv("PADDLE_TPU_LOCKCHECK", "1")
    topo, params, values = lm()
    model = ttr.params_from_jax(values, num_heads=HEADS)
    edges = []
    for root, lc, dec in (
            ("paddle_tpu", jlc,
             jtr.SlotDecoder(topo, params, decode_kernel="xla",
                             max_slots=2)),
            ("paddle_tpu_torch", tlc, slab(model, max_slots=2))):
        lc.reset()
        _drive_locks(root, dec, values, str(tmp_path / root))
        assert lc.violations() == [] and lc.acquires() > 0
        edges.append({(a, b) for a, bs in lc.edges().items() for b in bs})
    assert edges[1] <= edges[0], edges[1] - edges[0]


# ------------------------------------------------------------- refusals
def _engine(**kw):
    from paddle_tpu_torch.serving import InferenceEngine
    from torch_serving_helpers import HEADS, lm, slab
    from paddle_tpu_torch.models import transformer as ttr

    _, _, values = lm()
    return InferenceEngine(decoder=slab(ttr.params_from_jax(
        values, num_heads=HEADS)), **kw)


def _inference():
    from paddle_tpu_torch.inference import Inference
    reset_port_names()
    pt.init(seed=0, device="cpu")
    x = pt.layer.data("x", pt.data_type.dense_vector(4))
    out = pt.layer.fc(x, size=2)
    return Inference(out, pt.parameters.create(pt.Topology(out)),
                     compile_cache_dir="/x")


def _executor(**kw):
    import paddle_tpu_torch.fluid as fluid
    return fluid.Executor(fluid.CPUPlace(), **kw)


def _prewarm():
    eng = _engine()
    try:
        eng.prewarm()
    finally:
        eng.close()


def _cli(argv):
    from paddle_tpu_torch import cli
    cli.main(argv)


REFUSED = {
    "engine_compile_cache_dir": (lambda: _engine(compile_cache_dir="/x"),
                                 "item 13b"),
    "engine_prewarm": (_prewarm, "item 13b"),
    "engine_mesh": (lambda: _engine(mesh=object()), "item 14"),
    "inference_compile_cache_dir": (_inference, "item 13b"),
    "executor_compile_cache": (lambda: _executor(compile_cache=object()),
                               "item 13b"),
    "executor_bake_key": (lambda: _executor(bake_key="k"), "item 13b"),
    "executor_donate": (lambda: _executor(donate=False), "item 13b"),
    "executor_mesh": (lambda: _executor(mesh=object()), "item 14"),
    "cli_compile_cache_dir": (lambda: _cli(
        ["train", "--config", "x.py", "--device", "cpu",
         "--compile_cache_dir", "/x"]), "item 13b"),
    "cli_checkgrad": (lambda: _cli(
        ["train", "--config", "x.py", "--device", "cpu",
         "--job", "checkgrad"]), "item 15"),
}


@pytest.mark.parametrize("what", sorted(REFUSED))
def test_refusals_name_their_item(what):
    fn, item = REFUSED[what]
    with pytest.raises(NotImplementedError, match=item):
        fn()
