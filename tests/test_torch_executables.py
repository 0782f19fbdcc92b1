"""The port's executable observatory (``observability/executables.py``)
against ``tests/test_executables.py``: registry semantics, MFU against
hand-computed numbers (within 5%, the JAX file's tolerance), the
padding-discounted and the no-peak cases, the gauges, HTTP and CLI
surfaces, the cardinality cap; the JAX registry's entry schema and JSON
keys; the cost count (a single matmul counts exactly 2 M N K, a hand
kernel's reported work is its bound's formula exactly); and every stack
of the port reporting its rows with dispatches.
"""

import json
import threading

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import ops
from paddle_tpu_torch.core.ir import reset_name_counters as reset_port_names
from paddle_tpu_torch.observability import executables as ex
from paddle_tpu_torch.observability import metrics as m
from paddle_tpu_torch.observability import sinks


@pytest.fixture
def telemetry():
    obs.reset()
    ex.EXECUTABLES.reset()
    obs.enable()
    yield obs
    obs.disable()
    obs.reset()
    ex.EXECUTABLES.reset()


def _cost(flops, bytes_acc=None):
    out = {"flops": float(flops)}
    if bytes_acc is not None:
        out["bytes_accessed"] = float(bytes_acc)
    return out


# ------------------------------------------------------ registry semantics
def test_register_idempotent_on_identity(telemetry):
    a = ex.register(stack="s", kind="k", fingerprint="aa" * 16,
                    feed_sig="f", provenance="fresh", compile_us=100.0)
    a.record_dispatch(50.0)
    b = ex.register(stack="s", kind="k", fingerprint="aa" * 16,
                    feed_sig="f", provenance="warm", compile_us=7.0)
    assert b is a and a.provenance == "warm" and a.compile_us == 7.0
    assert a.dispatches == 1
    c = ex.register(stack="s", kind="k", fingerprint="bb" * 16, feed_sig="f")
    assert c is not a
    assert a.short == "s:aaaaaaaa" and c.short == "s:bbbbbbbb"
    assert ex.register(stack="s", kind="fallback").short.startswith(
        "s:fallback#")


def test_cost_degrades_to_none_without_estimate(telemetry):
    ent = ex.register(stack="s", kind="k", fingerprint="cc" * 16)
    ent.record_dispatch(100.0)
    assert ent.cost is None and ent.memory is None
    assert ent.flops_total() is None and ent.mfu(1e12) is None
    assert ex.EXECUTABLES.snapshot()["executables"][0]["mfu"] is None
    with ex.count_cost() as counted:
        torch.zeros(3).add_(1)          # no product, no kernel
    assert "flops" not in counted and ex.cost_of(counted) is None


def test_mfu_matches_hand_computed(telemetry, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "5e12")
    monkeypatch.setenv("PADDLE_TPU_PEAK_BYTES_PER_SEC", "1e12")
    flops, bytes_acc = 2.5e9, 4.0e9
    ent = ex.register(stack="trainer", kind="v2_train_step",
                      fingerprint="ab" * 16, feed_sig="sig",
                      provenance="fresh", compile_us=1234.5,
                      cost=_cost(flops, bytes_acc))
    for _ in range(8):
        ent.record_dispatch(2000.0)
    want_mfu = flops * 8 / (16000 * 1e-6) / 5e12
    want_bw = bytes_acc * 8 / (16000 * 1e-6) / 1e12
    assert ent.mfu(ex.peak_flops()) == pytest.approx(want_mfu, rel=0.05)
    assert ent.membw_util(ex.peak_membw()) == pytest.approx(want_bw,
                                                            rel=0.05)
    snap = ex.EXECUTABLES.snapshot()
    row = snap["executables"][0]
    assert row["mfu"] == pytest.approx(want_mfu, rel=0.05)
    assert row["membw_util"] == pytest.approx(want_bw, rel=0.05)
    assert (row["fingerprint"], row["dispatches"], row["compile_us"]) == (
        "ab" * 16, 8, 1234.5)
    assert snap["process"]["mfu"] == pytest.approx(want_mfu, rel=0.05)
    assert snap["stacks"]["trainer"]["mfu"] == pytest.approx(want_mfu,
                                                             rel=0.05)


def test_useful_mfu_discounts_padding_waste(telemetry, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "1e12")
    ent = ex.register(stack="trainer", kind="v2_train_step",
                      fingerprint="dd" * 16, feed_sig="s", cost=_cost(1e9))
    ent.record_dispatch(1000.0)
    m.histogram("trainer_padding_waste_pct").observe(20.0)
    m.histogram("trainer_padding_waste_pct").observe(30.0)
    tr = ex.EXECUTABLES.snapshot()["stacks"]["trainer"]
    assert tr["useful_fraction"] == pytest.approx(0.75)
    assert tr["mfu_useful"] == pytest.approx(tr["mfu"] * 0.75, rel=1e-3)


def test_no_peak_means_no_mfu(telemetry, monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_PEAK_FLOPS", raising=False)
    monkeypatch.setattr(ex, "_peak_from_table", lambda table: None)
    ent = ex.register(stack="s", kind="k", fingerprint="ee" * 16,
                      cost=_cost(1e9))
    ent.record_dispatch(1000.0)
    snap = ex.EXECUTABLES.snapshot()
    assert snap["peak_flops"] is None and snap["process"]["mfu"] is None
    assert snap["executables"][0]["mfu"] is None
    ex.refresh_gauges()
    assert obs.REGISTRY.get("process_mfu") is None


def test_peak_table_matches_the_h100_by_name(monkeypatch):
    """The card's peaks are the H100 constants of ``tools/timing.py``,
    matched by prefix on the device name; no card, no peak."""
    from paddle_tpu_torch.tools import timing

    monkeypatch.delenv("PADDLE_TPU_PEAK_FLOPS", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert ex.peak_flops() == timing.PEAK_BF16_FLOPS
    assert ex.peak_membw() == timing.PEAK_BYTES
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "Other")
    assert ex.peak_flops() is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ex.peak_flops() is None


def test_refresh_gauges_reach_prometheus(telemetry, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("PADDLE_TPU_PEAK_BYTES_PER_SEC", "1e12")
    ent = ex.register(stack="serving", kind="decode_step",
                      fingerprint="ff" * 16, feed_sig="b2",
                      cost=_cost(2e9, 1e9))
    ent.record_dispatch(4000.0)
    text = sinks.prometheus_text()
    assert 'executable_mfu{exe="serving:ffffffff"}' in text
    assert 'executable_membw_util{exe="serving:ffffffff"}' in text
    assert "process_mfu " in text and "serving_mfu " in text
    assert obs.REGISTRY.value("executable_mfu", exe="serving:ffffffff") \
        == pytest.approx(2e9 / (4000 * 1e-6) / 1e12, rel=0.05)


def test_entry_schema_and_table_are_the_jax_registrys(telemetry,
                                                      monkeypatch):
    """The same registration in both registries: equal row keys and
    snapshot keys, and either package renders the other's snapshot to
    the same table."""
    from paddle_tpu.observability import executables as jex

    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "1e12")

    class _Compiled:
        def cost_analysis(self):
            return [{"flops": 1e9}]

        def memory_analysis(self):
            raise RuntimeError("no memory model")

    jreg = jex.ExecutableRegistry()
    je = jreg.register(stack="trainer", kind="v2_train_step",
                       fingerprint="12" * 16, feed_sig="s",
                       compile_us=5.0, compiled=_Compiled())
    te = ex.register(stack="trainer", kind="v2_train_step",
                     fingerprint="12" * 16, feed_sig="s", compile_us=5.0,
                     cost=_cost(1e9))
    for e in (je, te):
        e.record_dispatch(250.0)
    jsnap, tsnap = jreg.snapshot(), ex.EXECUTABLES.snapshot()
    assert tsnap.keys() == jsnap.keys()
    assert tsnap["executables"][0].keys() == jsnap["executables"][0].keys()
    assert tsnap["executables"][0] == jsnap["executables"][0]
    assert ex.render_snapshot_table(jsnap) == \
        jex.render_snapshot_table(jsnap)
    assert ex.render_snapshot_table(tsnap) == \
        jex.render_snapshot_table(tsnap)


# ------------------------------------------------------------ cost counts
def test_single_matmul_counts_exactly_2mnk(telemetry):
    """The flop counter over one product, and over a graph whose only
    product is one linear fc layer: exactly 2 M N K."""
    M, K, N = 6, 10, 7
    a, b = torch.randn(M, K), torch.randn(K, N)
    with ex.count_cost() as counted:
        torch.mm(a, b)
    assert counted["flops"] == 2 * M * N * K
    reset_port_names()
    pt.init(seed=0, device="cpu")
    x = pt.layer.data("x", pt.data_type.dense_vector(K))
    out = pt.layer.fc(x, size=N, act="linear", bias_attr=False)
    topo = pt.Topology(out)
    params = pt.parameters.create(topo, device="cpu")
    with ex.count_cost() as counted:
        topo.forward(params.values, {}, {"x": np.ones((M, K), np.float32)},
                     train=False, device="cpu")
    assert counted["flops"] == counted["aten_flops"] == 2 * M * N * K


def test_visible_pairs_and_kernel_work_are_the_bounds_formulas():
    """``ops.visible_pairs`` counts the (query, key) pairs a causal,
    offset or length-limited attention visits (against a mask), and each
    flash wrapper's reported work is 4, 8 or 6 D a pair a head: the
    forward, dK/dV and dQ bounds of ``PERF.md``."""
    from paddle_tpu_torch.ops import flash_attention as fa

    for lq, lk, causal, qo, ko, lens in ((5, 5, True, 0, 0, None),
                                         (4, 9, True, 5, 0, [9, 6]),
                                         (3, 7, False, 0, 0, [7, 2]),
                                         (6, 6, True, 0, 2, [6])):
        rows = np.arange(lq)[:, None] + qo
        cols = np.arange(lk)[None, :] + ko
        want = 0
        for n in (lens or [lk]):
            vis = (np.arange(lk)[None, :] < n) & (
                (rows >= cols) if causal else True)
            want += int(np.broadcast_to(vis, (lq, lk)).sum())
        assert ops.visible_pairs(lq, lk, causal, qo, ko, lens) == want
    b, lq, h, d = 2, 8, 3, 16
    q, k = torch.zeros(b, lq, h, d), torch.zeros(b, lq, h, d)
    lens = torch.tensor([8, 5], dtype=torch.int32)
    pairs = ops.visible_pairs(lq, lq, True, 0, 0, [8, 5])
    with ops.recording_work() as work:
        for name, per in (("flash_fwd", 4.0), ("flash_bwd_dkdv", 8.0),
                          ("flash_bwd_dq", 6.0)):
            fa._add_work(name, per, q, k, lens, True, 0, 0)
    assert work == {"flash_fwd": 4.0 * d * h * pairs,
                    "flash_bwd_dkdv": 8.0 * d * h * pairs,
                    "flash_bwd_dq": 6.0 * d * h * pairs}
    fa._add_work("flash_fwd", 4.0, q, k, lens, True, 0, 0)   # no count open
    with ops.recording_work() as outer, ex.count_cost() as counted:
        ops.add_work("paged_decode", 96.0)
    assert outer == {"paged_decode": 96.0}
    assert counted["flops"] == counted["kernel_flops"] == 96.0


# ------------------------------------------------------- every stack reports
def test_stacks_register_and_account_dispatches(telemetry):
    """The trainer's eager step and its k-step chunk, a Fluid run plan and
    ``run_n`` chunk, a paged decoder's iterations and a whole-forward
    bucket: each a row with its dispatches, a build time (its first
    dispatch), device time from the others and, where a product ran, a
    cost."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import layers
    from paddle_tpu_torch.models import transformer as ttr
    from paddle_tpu_torch.serving import InferenceEngine
    from torch_serving_helpers import HEADS, lm, paged

    reset_port_names()
    pt.init(seed=0, device="cpu")
    x = pt.layer.data("x", pt.data_type.dense_vector(8))
    y = pt.layer.data("y", pt.data_type.integer_value(3))
    pred = pt.layer.fc(x, size=3, act="softmax", name="pred")
    cost = pt.layer.classification_cost(pred, y)
    topo = pt.Topology(cost, collect_evaluators=False)
    params = pt.parameters.create(topo, device="cpu")
    tr = pt.trainer.SGD(topo, params, pt.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9))
    rng = np.random.RandomState(0)
    batches = [{"x": rng.rand(4, 8).astype(np.float32),
                "y": rng.randint(0, 3, (4,)).astype(np.int32)}
               for _ in range(4)]
    tr.train(lambda: iter(batches), event_handler=lambda e: None)
    tr.train(lambda: iter(batches), event_handler=lambda e: None,
             steps_per_dispatch=2)

    fluid.framework.reset_default_programs()
    fx = layers.data(name="x", shape=[4])
    lbl = layers.data(name="label", shape=[1])
    loss = layers.mean(layers.square_error_cost(layers.fc(input=fx, size=1),
                                                lbl))
    fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(fluid.default_startup_program(), scope=scope)
    feed = {"x": np.ones((4, 4), np.float32),
            "label": np.ones((4, 1), np.float32)}
    for _ in range(2):
        exe.run(feed=feed, fetch_list=[loss], scope=scope)
    for _ in range(2):
        exe.run_n(feed={k: np.stack([v] * 3) for k, v in feed.items()},
                  n=3, fetch_list=[loss], scope=scope)

    _, _, values = lm()
    dec = paged(ttr.params_from_jax(values, num_heads=HEADS), max_slots=2,
                step_buckets=(2,))
    with InferenceEngine(decoder=dec) as eng:
        eng.infer([np.arange(5) % 48], 60, max_tokens=3)
    with InferenceEngine(pred, params, max_batch=2) as eng:
        for _ in range(2):
            eng.infer([(np.ones(8, np.float32),)], 60)

    rows = {(e.stack, e.kind): e for e in ex.EXECUTABLES.entries()}
    want = {("trainer", "v2_train_step"): 4, ("trainer", "train_chunk"): 2,
            ("fluid", "run_plan"): 2, ("fluid", "run_n"): 2,
            ("serving", "paged_step"): None, ("serving", "forward"): 2}
    assert set(want) <= set(rows), sorted(rows)
    for key, n in want.items():
        e = rows[key]
        assert e.dispatches == (n if n is not None else e.dispatches) > 0
        assert e.compile_us > 0 and e.device_us > 0 and e.fingerprint
    assert rows["serving", "paged_step"].dispatches >= 3
    # a product ran in each: a cost was counted (k steps for a chunk)
    step = rows["trainer", "v2_train_step"].cost["flops"]
    assert step > 0
    assert rows["trainer", "train_chunk"].cost["flops"] == 2 * step
    for key in (("fluid", "run_plan"), ("serving", "paged_step"),
                ("serving", "forward")):
        assert rows[key].cost["flops"] > 0, key
    # one row a (stack, kind, signature), one span a dispatch naming it
    exes = {ev["args"]["exe"] for ev in obs.TRACER.events()
            if ev["name"] == "trainer/step"}
    assert exes == {rows["trainer", "v2_train_step"].short,
                    rows["trainer", "train_chunk"].short}


# --------------------------------------------------------------- surfaces
def test_cli_executables_verb_and_empty_registry(telemetry, capsys,
                                                 monkeypatch):
    from paddle_tpu_torch import cli

    with pytest.raises(SystemExit):
        cli.main(["executables"])
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "1e12")
    ent = ex.register(stack="fluid", kind="step", fingerprint="12" * 16,
                      feed_sig="s", provenance="warm", compile_us=500.0,
                      cost=_cost(1e9))
    ent.record_dispatch(100.0)
    cli.main(["executables"])
    out = capsys.readouterr().out
    assert "fluid:12121212" in out and "warm" in out
    cli.main(["executables", "--json"])
    snap = json.loads(capsys.readouterr().out)
    assert snap["executables"][0]["exe"] == "fluid:12121212"
    assert snap["executables"][0]["dispatches"] == 1


def test_http_executables_endpoint(telemetry, monkeypatch, capsys):
    from urllib.request import urlopen

    from paddle_tpu_torch import cli

    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "1e12")
    for i in range(3):
        ent = ex.register(stack="serving", kind="decode_step",
                          fingerprint=f"{i:02d}" * 16, feed_sig=str(i),
                          cost=_cost(1e9))
        for _ in range(i + 1):
            ent.record_dispatch(100.0 * (i + 1))
    server = sinks.serve_metrics(
        0, host="127.0.0.1", extra_handlers={"/executables": ex.http_handler})
    try:
        base = f"http://127.0.0.1:{server.server_port}"
        snap = json.loads(urlopen(f"{base}/executables").read())
        assert len(snap["executables"]) == 3
        assert snap["process"]["dispatches"] == 6
        top = json.loads(urlopen(f"{base}/executables?top=1").read())
        assert [r["exe"] for r in top["executables"]] == ["serving:02020202"]
        assert top["process"]["dispatches"] == 6
        table = urlopen(f"{base}/executables?table=1").read().decode()
        assert "serving:02020202" in table and "disp" in table
        assert "serving_mfu " in urlopen(f"{base}/metrics").read().decode()
        cli.main(["executables", "--url", base, "--top", "2"])
        assert "serving:02020202" in capsys.readouterr().out
    finally:
        server.shutdown()
        server.server_close()


# --------------------------------------- metrics series-cardinality cap
def test_cardinality_cap_collapses_new_labels(telemetry):
    reg = m.MetricsRegistry(max_series=3)
    for i in range(8):
        reg.counter("cap_total", tenant=f"t{i}").inc()
    fams = [mm for (name, _), mm in reg._metrics.items()
            if name == "cap_total"]
    labels = {mm.labels["tenant"] for mm in fams}
    assert {"t0", "t1", "t2", "_overflow"} <= labels and "t7" not in labels
    assert sum(mm.value for mm in fams) == 8
    assert reg.value("cap_total", tenant="_overflow") == 5
    reg.counter("cap_total", tenant="t1").inc()
    assert reg.value("cap_total", tenant="t1") == 2
    with pytest.raises(TypeError):
        reg.gauge("cap_total", tenant="t99")
    assert reg.counter("cap_plain_total").labels == {}


def test_cardinality_cap_unbounded_when_zero(telemetry):
    reg = m.MetricsRegistry(max_series=0)
    for i in range(600):
        reg.counter("nocap_total", k=str(i)).inc()
    assert reg.value("nocap_total", k="599") == 1


def test_cardinality_cap_concurrent_first_seen_churn(telemetry):
    reg = m.MetricsRegistry(max_series=16)
    start = threading.Barrier(8)
    errors = []

    def work(tid):
        try:
            start.wait()
            for i in range(200):
                reg.counter("churn_total", req=f"{tid}-{i}").inc()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    fams = [mm for (name, _), mm in reg._metrics.items()
            if name == "churn_total"]
    assert sum(mm.value for mm in fams) == 1600 and len(fams) <= 17
    assert len({id(mm) for mm in fams}) == len(fams)


def test_remove_frees_series_accounting(telemetry):
    reg = m.MetricsRegistry(max_series=2)
    reg.counter("rm_total", v="a").inc()
    reg.counter("rm_total", v="b").inc()
    c = reg.counter("rm_total", v="c")
    assert c.labels["v"] == "_overflow"
    c.inc()
    assert reg.remove("rm_total", v="a") and not reg.remove("rm_total",
                                                           v="a")
    reg.counter("rm_total", v="d").inc()
    names = {mm.labels["v"] for (n, _), mm in reg._metrics.items()
             if n == "rm_total"}
    assert "a" not in names and "d" not in names
    assert reg.value("rm_total", v="_overflow") == 2
