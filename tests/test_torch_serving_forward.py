"""The port's whole-forward serving engine (``paddle_tpu_torch/serving/
engine.py``: micro-batches, row buckets, 2-D (rows, T) buckets, the
delivery thread) against the JAX engine on the same seeded weights, and
the whole-forward contracts of ``tests/test_serving.py`` and
``tests/test_serving_decode.py`` held on the port: bucket equivalence,
error isolation, empty and oversize requests, clean shutdown, a ragged
final batch, a scalar output, expired requests never boarding, lanes,
timeout cancel, the watchdog on batcher and delivery death, the drain
timeout, the wait scale, the HTTP overload surface, WFQ in rows, quotas
and breakers.  Orders are decided by a gate on the forward, never by the
clock.  Outputs are held to the JAX engine's within 1e-5 (relative) and
1e-6 (absolute), the LM's logits (values of order 1, two layers) within
1e-5 (absolute): float32 sums in another order."""

import json
import threading
import time
import urllib.request
from concurrent.futures import TimeoutError as FutTimeout
from urllib.error import HTTPError

import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.core import config
from paddle_tpu.models import transformer as jtr
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu_torch.inference import Inference, bucket_rows
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.serving import (BreakerOpen, DeadlineExceeded,
                                      EngineClosed, EngineUnhealthy,
                                      InferenceEngine, Overloaded,
                                      ServingClient, ServingError,
                                      ServingHTTPError, default_buckets,
                                      local_transport)
from paddle_tpu_torch.serving.engine import SHED_REASONS

RTOL, ATOL, LM_ATOL = 1e-5, 1e-6, 1e-5
WIDTH, CLASSES = 16, 4


def _mlp(name="srv"):
    """(JAX output, JAX params, port output, port params): one MLP in both
    packages, the port's weights the JAX package's seeded ones."""
    built = []
    for pkg, kw in ((jpaddle, {}), (tpaddle, {"device": "cpu"})):
        pkg.init(seed=0, **kw)
        x = pkg.layer.data("x", pkg.data_type.dense_vector(WIDTH))
        h = pkg.layer.fc(x, size=WIDTH, act="relu", name=f"{name}_h")
        built.append(pkg.layer.fc(h, size=CLASSES, act="softmax",
                                  name=f"{name}_out"))
    jparams = jpaddle.parameters.create(jpaddle.Topology(built[0]))
    tparams = _carried(built[1], jparams)
    return built[0], jparams, built[1], tparams


def _carried(out, jparams):
    values = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
              for k, v in jparams.values.items()}
    return tpaddle.parameters.from_numpy(
        tpaddle.Topology(out, collect_evaluators=False), values,
        device="cpu")


def _port_mlp(name="srv"):
    return _mlp(name)[2:]


def _requests(n, rows=(1, 3, 9), seed=0):
    rng = np.random.RandomState(seed)
    return [[(rng.rand(WIDTH).astype(np.float32),)
             for _ in range(rows[i % len(rows)])] for i in range(n)]


def _gate_forward(eng):
    """Hold the engine's forward behind a semaphore: the test decides
    when the batcher makes progress."""
    sem = threading.Semaphore(0)
    orig = eng._inf.run_feed
    eng._inf.run_feed = lambda feed, params=None: (
        sem.acquire(), orig(feed, params))[1]
    return sem


def _wait_until(cond, timeout=30.0, what="condition"):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if cond():
            return
        time.sleep(0.002)
    raise AssertionError(f"timed out waiting for {what}")


def _engine(out, params, **kw):
    config.set_option("device", "cpu")    # the engine's Inference runs here
    return InferenceEngine(out, params, **kw)


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read()


# --------------------------------------------------- the JAX engine's outputs
def test_default_buckets_and_bucket_rows():
    assert default_buckets(32) == (2, 4, 8, 16, 32)
    assert default_buckets(48) == (2, 4, 8, 16, 32, 48)
    assert default_buckets(1) == (1,)
    assert bucket_rows(3, (2, 4, 8)) == 4
    assert bucket_rows(9, (2, 4, 8)) == 9


def test_mlp_concurrent_clients_match_jax_engine():
    """48 requests of 1, 3 and 9 rows from 8 threads through both engines:
    the answers agree within float32 tolerance, and each answer is the
    port's own ``Inference.infer`` of that request over the bucket set."""
    jout, jparams, tout, tparams = _mlp("eq")
    reqs = _requests(48)

    def run(eng):
        results = [None] * len(reqs)
        it = iter(range(len(reqs)))
        lock = threading.Lock()

        def worker():
            while True:
                with lock:
                    i = next(it, None)
                if i is None:
                    return
                results[i] = eng.submit(reqs[i]).result(60)

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return results

    with JaxEngine(jout, jparams, max_batch=16, max_wait_us=500) as je:
        want = run(je)
    with _engine(tout, tparams, max_batch=16, max_wait_us=500) as te:
        got = run(te)
        buckets = te.batch_buckets
        st = te.stats()
    inf = Inference(tout, tparams, device="cpu")
    for r, w, g in zip(reqs, want, got):
        assert g.shape == w.shape == (len(r), CLASSES)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(
            g, inf.infer(input=r, bucket_batch=buckets), rtol=RTOL,
            atol=ATOL)
    assert st["requests"] == 48 and st["rows"] == sum(map(len, reqs))
    assert set(st["buckets_used"]) <= set(buckets)
    assert st["batched_rows"] == st["rows"]
    json.dumps(st)


@pytest.fixture(scope="module")
def lm():
    """A 2-layer LM's logits in both packages from the JAX seeded weights."""
    jpaddle.init(seed=0)
    _, jlog = jtr.build(vocab_size=48, max_len=64, dim=32, num_heads=2,
                        num_layers=2)
    jparams = jpaddle.parameters.create(
        jpaddle.Topology(jlog, collect_evaluators=False))
    tpaddle.init(seed=0, device="cpu")
    _, tlog = ttr.build(vocab_size=48, max_len=64, dim=32, num_heads=2,
                        num_layers=2)
    return jlog, jparams, tlog, _carried(tlog, jparams)


def _lm_reqs(n, seed, lo=3, hi=40):
    rng = np.random.RandomState(seed)
    return [[(rng.randint(0, 48, size=int(rng.randint(lo, hi))).tolist(),)]
            for _ in range(n)]


def test_lm_2d_buckets_match_jax_engine(lm):
    """The LM's logits with seq_buckets (8, 16, 32): one request at a time
    each lands in its own (rows, T) bucket in both engines, with the same
    T and values within float32 tolerance; the buckets used are 2-D keys
    on the grid and the cells count the T padding."""
    jlog, jparams, tlog, tparams = lm
    reqs = _lm_reqs(6, seed=1)
    kw = dict(max_batch=4, batch_buckets=(1, 2, 4), seq_buckets=(8, 16, 32),
              max_wait_us=100.0)
    with JaxEngine(jlog, jparams, **kw) as je:
        want = [np.asarray(je.infer(r, 60)) for r in reqs]
        jst = je.stats()
    with _engine(tlog, tparams, **kw) as te:
        got = [te.infer(r, 60) for r in reqs]
        st = te.stats()
        assert te.seq_buckets == (8, 16, 32, 64)
    for r, w, g in zip(reqs, want, got):
        n = len(r[0][0])
        assert g.shape == w.shape == (1, bucket_rows(n, (8, 16, 32)), 48)
        np.testing.assert_allclose(g[:, :n], w[:, :n], rtol=RTOL,
                                   atol=LM_ATOL)
    assert sorted(map(tuple, st["buckets_used"])) == sorted(
        map(tuple, jst["buckets_used"]))
    for key in ("real_cells", "pad_cells", "padded_rows", "batched_rows",
                "padding_waste_pct", "batches"):
        assert st[key] == jst[key], key


def test_lm_concurrent_requests_match_on_real_positions(lm):
    """Submitted at once, requests share micro-batches whose T is the
    batch's bucket; on every request's own positions the logits equal the
    JAX engine's within tolerance whatever the batching (causal attention
    with per-row kv_lens: the padding cannot reach a real position)."""
    jlog, jparams, tlog, tparams = lm
    reqs = _lm_reqs(12, seed=2)
    kw = dict(max_batch=8, batch_buckets=(2, 4, 8), seq_buckets=(8, 16, 32),
              max_wait_us=20000.0)
    with JaxEngine(jlog, jparams, **kw) as je:
        want = [f.result(60) for f in [je.submit(r) for r in reqs]]
    with _engine(tlog, tparams, **kw) as te:
        got = [f.result(60) for f in [te.submit(r) for r in reqs]]
        st = te.stats()
    for r, w, g in zip(reqs, want, got):
        n = len(r[0][0])
        assert g.shape[1] in (8, 16, 32, 64)
        np.testing.assert_allclose(g[:, :n], w[:, :n], rtol=RTOL,
                                   atol=LM_ATOL)
    assert all(b[0] in (2, 4, 8) and b[1] in (8, 16, 32, 64)
               for b in st["buckets_used"])


def test_2d_buckets_equal_max_len_padding_on_real_steps():
    """The port's 2-D bucketing on a sequence model: T pads to the batch's
    bucket, not max_len, and the real timesteps equal max_len padding's
    within tolerance; the waste counts cells."""
    tpaddle.init(seed=0, device="cpu")
    x = tpaddle.layer.data("x", tpaddle.data_type.dense_vector_sequence(
        8, max_len=64))
    att = tpaddle.layer.multi_head_attention(x, size=8, num_heads=2,
                                             causal=True, name="mha2d")
    params = tpaddle.parameters.create(
        tpaddle.Topology(att, collect_evaluators=False), device="cpu")
    rng = np.random.RandomState(0)

    def req(rows, tlen):
        return [([rng.rand(8).astype(np.float32) for _ in range(tlen)],)
                for _ in range(rows)]

    reqs = [req(1, 5), req(3, 12), req(2, 30), req(1, 7)]
    with _engine(att, params, max_batch=8, batch_buckets=(2, 4, 8),
                 seq_buckets=(8, 16, 32), max_wait_us=100.0) as eng:
        outs = [eng.infer(r, 60) for r in reqs]
        st = eng.stats()
    assert all(o.shape[1] < 64 for o in outs)
    assert all(len(b) == 2 for b in st["buckets_used"])
    assert 0 < st["padding_waste_pct"] < 100
    with _engine(att, params, max_batch=8, batch_buckets=(2, 4, 8),
                 max_wait_us=100.0) as eng:
        full = [eng.infer(r, 60) for r in reqs]
    for a, b in zip(outs, full):
        np.testing.assert_allclose(a, b[:, :a.shape[1]], rtol=RTOL,
                                   atol=ATOL)
    # one 1-row, 5-step request into a (2, 8) bucket: 11 of 16 cells pad
    with _engine(att, params, max_batch=8, batch_buckets=(2, 4, 8),
                 seq_buckets=(8, 16, 32), max_wait_us=100.0) as eng:
        eng.infer(req(1, 5), 60)
        st = eng.stats()
        assert (st["real_cells"], st["pad_cells"]) == (5, 11)
        assert st["padding_waste_pct"] == pytest.approx(68.75)
        # an over-long sample is cut at max_len: its key stays on the grid
        eng.infer(req(1, 100), 60)
        st = eng.stats()
        assert all(t <= 64 for _, t in st["buckets_used"])
        assert st["real_cells"] == 5 + 64
    with pytest.raises(ValueError, match="seq_buckets"):
        _engine(*_port_mlp("nsq"), max_batch=4, seq_buckets=(8, 16))


# ------------------------------------------------------- engine contracts
def test_per_request_error_isolation():
    """A poison request (wrong width) fails only its own future; its
    batch-mates answer and the batcher survives."""
    out, params = _port_mlp("iso")
    with _engine(out, params, max_batch=16, max_wait_us=20000) as eng:
        good1 = eng.submit(_requests(1)[0])
        bad = eng.submit([(np.zeros(7, np.float32),)])
        good2 = eng.submit(_requests(2, seed=1)[1])
        with pytest.raises(Exception):
            bad.result(30)
        assert good1.result(30).shape == (1, CLASSES)
        assert good2.result(30).shape == (3, CLASSES)
        assert eng.submit(_requests(1)[0]).result(30).shape == (1, CLASSES)
        assert eng.session["errors"] == 1


def test_empty_and_oversize_and_decode_fields_fail_fast():
    out, params = _port_mlp("sz")
    with _engine(out, params, max_batch=8) as eng:
        for kw, req in (({}, []), ({}, _requests(1, rows=(9,))[0]),
                        ({"max_tokens": 4}, _requests(1)[0]),
                        ({"temperature": 0.5}, _requests(1)[0])):
            f = eng.submit(req, **kw)
            assert f.done()
            with pytest.raises(ValueError):
                f.result(0)
        assert eng.session["errors"] == 4


def test_clean_shutdown_ragged_final_batch_and_context_manager():
    """close() drains what is queued (every future answers; the last
    batch is ragged and pads up to its bucket), later submits fail, close
    is idempotent, and the context manager closes."""
    out, params = _port_mlp("shut")
    eng = _engine(out, params, max_batch=8, max_wait_us=50000)
    reqs = _requests(24, rows=(1, 3, 5), seed=3)
    futs = [eng.submit(r) for r in reqs]
    eng.close()
    for r, f in zip(reqs, futs):
        assert f.done() and f.exception() is None
        assert f.result().shape == (len(r), CLASSES)
    st = eng.stats()
    assert st["batched_rows"] == sum(map(len, reqs)) and st["padded_rows"] > 0
    with pytest.raises(EngineClosed):
        eng.submit(_requests(1)[0]).result(5)
    eng.close()
    with _engine(out, params, max_batch=8, max_wait_us=100) as eng:
        assert eng.infer(_requests(1)[0], timeout=30).shape == (1, CLASSES)
    assert eng.stats()["closed"] and eng.health() == (503, "closed")


def test_scalar_output_stands_down_from_padding():
    """A cost output folds its batch: the engine runs one request a batch,
    unpadded, and each answer is that request's own cost."""
    tpaddle.init(seed=0, device="cpu")
    x = tpaddle.layer.data("xc", tpaddle.data_type.dense_vector(6))
    y = tpaddle.layer.data("yc", tpaddle.data_type.dense_vector(1))
    pred = tpaddle.layer.fc(x, size=1, act=None, name="costnet")
    cost = tpaddle.layer.mse_cost(pred, y, name="cost_out")
    params = tpaddle.parameters.create(tpaddle.Topology(cost), device="cpu")
    rng = np.random.RandomState(0)
    reqs = [[(rng.rand(6).astype(np.float32), rng.rand(1).astype(
        np.float32)) for _ in range(n)] for n in (2, 3, 1)]
    inf = Inference(cost, params, device="cpu")
    with _engine(cost, params, max_batch=8, max_wait_us=20000) as eng:
        got = [f.result(30) for f in [eng.submit(r) for r in reqs]]
        st = eng.stats()
    for r, g in zip(reqs, got):
        assert np.ndim(g) == 0
        want = list(inf.iter_infer(input=r))[0]["cost_out"]
        np.testing.assert_allclose(g, want, rtol=1e-6)
    assert st["batches"] == 3 and st["padded_rows"] == 0


def test_expired_request_never_occupies_a_batch_row():
    out, params = _port_mlp("ddl")
    eng = _engine(out, params, max_batch=4, max_wait_us=100)
    sem = _gate_forward(eng)
    try:
        held = eng.submit(_requests(1)[0])
        _wait_until(lambda: eng.queue_depth() == 0, what="batcher pickup")
        doomed = eng.submit(_requests(1, rows=(3,), seed=1)[0],
                            deadline_us=1e6)
        doomed_req = doomed._ptt_request()
        doomed_req.deadline = time.perf_counter() - 1.0   # now past
        sem.release()
        with pytest.raises(DeadlineExceeded):
            doomed.result(10)
        assert held.result(10).shape == (1, CLASSES)
        _wait_until(lambda: eng.session["shed"]["deadline"] == 1,
                    what="deadline shed count")
        assert eng.session["batches"] == 1
    finally:
        for _ in range(8):
            sem.release()
        eng.close(drain_timeout_s=5)


def test_priority_lanes_and_anti_starvation_credit():
    out, params = _port_mlp("lane")
    eng = _engine(out, params, max_batch=1, max_wait_us=100,
                  starvation_limit=2)
    sem = _gate_forward(eng)
    order, lock = [], threading.Lock()

    def tag(name):
        def cb(fut):
            with lock:
                order.append(name)
        return cb

    try:
        held = eng.submit(_requests(1)[0])
        _wait_until(lambda: eng.queue_depth() == 0, what="batcher pickup")
        reqs = _requests(4, rows=(1,), seed=2)
        futs = [eng.submit(reqs[0])]
        futs[0].add_done_callback(tag("n1"))
        for name, r in zip(("h1", "h2", "h3"), reqs[1:]):
            f = eng.submit(r, lane="high")
            f.add_done_callback(tag(name))
            futs.append(f)
        assert eng.queue_depth() == 4
        for _ in range(8):
            sem.release()
        held.result(10)
        for f in futs:
            f.result(10)
        assert order == ["h1", "h2", "n1", "h3"]
        assert eng.session["lane_credit_pops"] == 1
        assert eng.stats()["lane_depth"] == {"high": 0, "normal": 0}
    finally:
        for _ in range(8):
            sem.release()
        eng.close(drain_timeout_s=5)


def test_infer_timeout_cancels_abandoned_request():
    out, params = _port_mlp("aban")
    eng = _engine(out, params, max_batch=4, max_wait_us=100)
    sem = _gate_forward(eng)
    try:
        held = eng.submit(_requests(1)[0])
        _wait_until(lambda: eng.queue_depth() == 0, what="batcher pickup")
        with pytest.raises(FutTimeout):
            eng.infer(_requests(1, seed=3)[0], timeout=0.05)
        sem.release()
        assert held.result(10).shape == (1, CLASSES)
        _wait_until(lambda: eng.session["shed"]["abandoned"] == 1,
                    what="abandoned shed count")
        assert eng.session["batches"] == 1
    finally:
        for _ in range(8):
            sem.release()
        eng.close(drain_timeout_s=5)


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_watchdog_fails_inflight_on_batcher_death():
    out, params = _port_mlp("dog")
    eng = _engine(out, params, max_batch=1, max_wait_us=100,
                  watchdog_interval_s=0.05)
    assert eng.infer(_requests(1)[0], timeout=30).shape == (1, CLASSES)

    def boom(feed, params=None):
        raise SystemExit("injected batcher death")

    eng._inf.run_feed = boom
    futs = [eng.submit(r) for r in _requests(3, rows=(1,))]
    for f in futs:
        with pytest.raises(EngineUnhealthy):
            f.result(10)
    assert eng.healthy is False
    st = eng.stats()
    assert st["health"] == "dead" and st["batcher_alive"] is False
    code, body = eng._healthz()
    assert code == 503 and body.startswith("dead")
    with pytest.raises(EngineUnhealthy):
        eng.submit(_requests(1)[0]).result(5)
    assert eng.session["shed"]["thread_death"] >= 3
    eng.close(drain_timeout_s=1)
    counts = eng.session["shed"]
    assert counts["drain"] == 0
    assert sum(counts.values()) == counts["thread_death"]


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_watchdog_handles_delivery_death():
    out, params = _port_mlp("ddth")
    eng = _engine(out, params, max_batch=4, max_wait_us=100,
                  watchdog_interval_s=0.05)
    assert eng.infer(_requests(1)[0], timeout=30).shape == (1, CLASSES)
    eng._out_q.put(("poison",))               # unpacking kills delivery
    _wait_until(lambda: not eng._delivery.is_alive(), what="delivery death")
    _wait_until(lambda: not eng.healthy, what="watchdog detection")
    st = eng.stats()
    assert st["health"] == "dead" and st["delivery_alive"] is False
    assert "delivery" in st["health_reason"]
    with pytest.raises(EngineUnhealthy):
        eng.submit(_requests(1)[0]).result(5)
    eng.close(drain_timeout_s=1)
    _wait_until(lambda: not eng._batcher.is_alive(), what="batcher exit")


def test_close_drain_timeout_sheds_instead_of_hanging():
    out, params = _port_mlp("drn")
    eng = _engine(out, params, max_batch=1, max_wait_us=100)
    sem = _gate_forward(eng)
    held = eng.submit(_requests(1)[0])
    _wait_until(lambda: eng.queue_depth() == 0, what="batcher pickup")
    queued = [eng.submit(r) for r in _requests(3, rows=(1,))]
    t0 = time.perf_counter()
    eng.close(drain_timeout_s=0.3)
    assert time.perf_counter() - t0 < 10.0
    for f in queued + [held]:
        with pytest.raises(EngineClosed) as ei:
            f.result(1)
        assert not isinstance(ei.value, EngineUnhealthy)
    counts = eng.session["shed"]
    assert counts["drain"] == 4 and sum(counts.values()) == 4
    assert set(counts) == set(SHED_REASONS)
    with pytest.raises(ServingError):
        eng.submit(_requests(1)[0]).result(1)
    for _ in range(8):
        sem.release()


def test_wait_scale_widens_under_backlog_and_narrows_back():
    out, params = _port_mlp("ws")
    with _engine(out, params, max_batch=4, max_queue_depth=8,
                 overload_wait_scale=4.0) as eng:
        assert eng.stats()["wait_scale"] == 1.0
        for _ in range(10):
            eng._update_wait_scale(8)
        assert eng._wait_scale == 4.0
        for _ in range(20):
            eng._update_wait_scale(0)
        assert eng._wait_scale == 1.0


def test_http_overload_surface():
    """/healthz flips to 503 overloaded with the gate, /infer sheds 429
    with Retry-After, /stats carries the health fields, lane and deadline
    ride the body; the answer carries the model version."""
    out, params = _port_mlp("hov")
    eng = _engine(out, params, max_batch=1, max_wait_us=100,
                  max_queue_depth=2, hysteresis=0.5)
    sem = _gate_forward(eng)
    port = eng.serve(port=0).server_address[1]
    url = f"http://127.0.0.1:{port}"
    sample = [list(map(float, _requests(1)[0][0][0]))]
    try:
        assert _get(url + "/healthz") == (200, b"ok\n")
        held = eng.submit(_requests(1)[0])
        _wait_until(lambda: eng.queue_depth() == 0, what="batcher pickup")
        backlog = [eng.submit(r) for r in _requests(2, rows=(1,))]
        body = json.dumps({"input": [sample], "lane": "high"}).encode()
        with pytest.raises(HTTPError) as ei:
            urllib.request.urlopen(urllib.request.Request(
                url + "/infer", data=body), timeout=10)
        assert ei.value.code == 429
        assert int(ei.value.headers["Retry-After"]) >= 1
        assert json.loads(ei.value.read())["reason"] == "queue_full"
        with pytest.raises(HTTPError) as hi:
            urllib.request.urlopen(url + "/healthz", timeout=10)
        assert hi.value.code == 503
        assert hi.value.read().startswith(b"overloaded")
        st = json.loads(_get(url + "/stats")[1])
        assert st["shedding"] is True and st["shed"]["queue_full"] >= 1
        assert st["queue_saturation"] == 1.0 and st["health"] == "overloaded"
        for _ in range(8):
            sem.release()
        held.result(10)
        for f in backlog:
            f.result(10)
        _wait_until(lambda: eng.queue_depth() == 0, what="drain")
        assert _get(url + "/healthz") == (200, b"ok\n")
        body = json.dumps({"input": [sample], "lane": "high",
                           "deadline_ms": 5000}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                url + "/infer", data=body), timeout=10) as r:
            doc = json.loads(r.read())
        want = eng.infer(_requests(1)[0], timeout=10)
        np.testing.assert_allclose(doc["outputs"][eng.output_names[0]],
                                   want, rtol=RTOL, atol=ATOL)
        assert doc["model_version"] == "boot"
        with pytest.raises(HTTPError) as ei:
            urllib.request.urlopen(urllib.request.Request(
                url + "/infer", data=b"not json"), timeout=10)
        assert ei.value.code == 400
        kern = json.loads(_get(url + "/kernels")[1])
        assert kern["device"] == "cpu" and "flash_fwd" in kern["launches"]
    finally:
        for _ in range(16):
            sem.release()
        eng.close(drain_timeout_s=5)


def test_wfq_interleaves_tenants_by_weight_in_rows():
    """DRR inside a lane charges rows: with quanta vip 2, hog 1 the vip's
    two queued requests overtake the hog's backlog."""
    out, params = _port_mlp("wfq")
    eng = _engine(out, params, max_batch=1, max_wait_us=100,
                  tenant_weights={"vip": 2.0, "hog": 1.0})
    sem = _gate_forward(eng)
    order, lock = [], threading.Lock()

    def tag(name):
        def cb(fut):
            with lock:
                order.append(name)
        return cb

    try:
        held = eng.submit(_requests(1)[0], tenant="hog")
        _wait_until(lambda: eng.queue_depth() == 0, what="batcher pickup")
        futs = []
        for name, tenant, r in zip(["h2", "h3", "h4", "v1", "v2"],
                                   ["hog"] * 3 + ["vip"] * 2,
                                   _requests(5, rows=(1,), seed=3)):
            f = eng.submit(r, tenant=tenant)
            f.add_done_callback(tag(name))
            futs.append(f)
        for _ in range(8):
            sem.release()
        held.result(10)
        for f in futs:
            f.result(10)
        assert order == ["h2", "v1", "v2", "h3", "h4"]
        ts = eng.stats()["tenants"]
        assert ts["vip"]["weight"] == 2.0
        assert ts["hog"]["requests"] == 4 and ts["vip"]["requests"] == 2
        assert ts["hog"]["depth"] == ts["vip"]["depth"] == 0
    finally:
        for _ in range(8):
            sem.release()
        eng.close(drain_timeout_s=5)


def test_tenant_quota_sheds_hog_only():
    out, params = _port_mlp("quota")
    eng = _engine(out, params, max_batch=1, max_wait_us=100,
                  max_queue_depth=16, max_queue_depth_per_tenant=4,
                  hysteresis=0.5)
    sem = _gate_forward(eng)
    try:
        held = eng.submit(_requests(1)[0], tenant="hog")
        _wait_until(lambda: eng.queue_depth() == 0, what="batcher pickup")
        backlog = [eng.submit(r, tenant="hog")
                   for r in _requests(3, rows=(1,))]
        shed = eng.submit(_requests(1)[0], tenant="hog")
        assert shed.done()
        with pytest.raises(Overloaded) as ei:
            shed.result(0)
        assert not isinstance(ei.value, BreakerOpen)
        assert ei.value.reason == "tenant_quota"
        calm = eng.submit(_requests(1, seed=5)[0], tenant="calm")
        assert not calm.done()
        ts = eng.stats()["tenants"]
        assert ts["hog"]["shedding"] is True and ts["hog"]["shed"] == 1
        assert ts["calm"]["shedding"] is False
        sem.release()
        _wait_until(lambda: eng.stats()["tenants"]["hog"]["depth"] == 3,
                    what="first hog drain")
        with pytest.raises(Overloaded):
            eng.submit(_requests(1)[0], tenant="hog").result(0)
        sem.release()
        _wait_until(lambda: eng.stats()["tenants"]["hog"]["depth"] <= 2,
                    what="hog at its resume watermark")
        readmitted = eng.submit(_requests(1)[0], tenant="hog")
        assert not readmitted.done()
        for _ in range(8):
            sem.release()
        for f in [held] + backlog + [calm, readmitted]:
            assert f.result(10).shape == (1, CLASSES)
    finally:
        for _ in range(16):
            sem.release()
        eng.close(drain_timeout_s=5)


def test_breaker_open_half_open_close_cycle():
    """A poison tenant trips its breaker (typed sheds, no rows burned); a
    half-open probe decides; other tenants never notice.  The cooldown is
    moved into the past, not waited for."""
    out, params = _port_mlp("brk")
    eng = _engine(out, params, max_batch=4, max_wait_us=200,
                  breaker_window=8, breaker_threshold=0.5,
                  breaker_min_requests=4, breaker_cooldown_s=30.0)
    poison = [(np.zeros(7, np.float32),)]
    good = _requests(1)[0]

    def cool_down():
        ts = eng._tenants["tox"]
        with ts.lock:
            ts.br_opened_at -= 60.0

    try:
        for _ in range(4):
            with pytest.raises(Exception):
                eng.submit(poison, tenant="tox").result(10)
        _wait_until(lambda: eng.stats()["tenants"]["tox"]["breaker"]
                    == "open", what="breaker open")
        batches = eng.session["batches"]
        shed = eng.submit(poison, tenant="tox")
        assert shed.done()
        with pytest.raises(BreakerOpen) as ei:
            shed.result(0)
        assert ei.value.reason == "breaker_open"
        assert eng.infer(good, timeout=10, tenant="ok").shape == (1, CLASSES)
        assert eng.session["batches"] == batches + 1
        cool_down()
        with pytest.raises(Exception) as ei2:
            eng.submit(poison, tenant="tox").result(10)
        assert not isinstance(ei2.value, BreakerOpen)     # the probe ran
        assert eng.stats()["tenants"]["tox"]["breaker"] == "open"
        with pytest.raises(BreakerOpen):
            eng.submit(good, tenant="tox").result(0)
        cool_down()
        assert eng.infer(good, timeout=10, tenant="tox").shape == (1, CLASSES)
        assert eng.stats()["tenants"]["tox"]["breaker"] == "closed"
        assert eng.session["shed"]["breaker_open"] == 2
    finally:
        eng.close(drain_timeout_s=5)


def test_untagged_traffic_fifo_and_client_against_live_quota():
    """Untagged traffic rides "default" in FIFO order; ServingClient
    through the in-process transport eats the engine's real 429s, backs
    off and converges, and a 400 is not retried."""
    out, params = _port_mlp("dflt")
    eng = _engine(out, params, max_batch=1, max_wait_us=100,
                  max_queue_depth=16, max_queue_depth_per_tenant=2,
                  hysteresis=0.5)
    sem = _gate_forward(eng)
    order = []
    try:
        held = eng.submit(_requests(1)[0])
        _wait_until(lambda: eng.queue_depth() == 0, what="batcher pickup")
        futs = []
        for i, r in enumerate(_requests(1, rows=(1,), seed=7)):
            f = eng.submit(r)
            f.add_done_callback(lambda fut, i=i: order.append(i))
            futs.append(f)
        with pytest.raises(Overloaded):        # default's quota of 2
            eng.submit(_requests(1)[0]).result(0)
        client = ServingClient("http://in-process",
                               transport=local_transport(eng),
                               max_attempts=8, backoff_base_s=0.01,
                               backoff_cap_s=0.1)
        threading.Timer(0.15, lambda: [sem.release()
                                       for _ in range(8)]).start()
        sample = [list(np.random.RandomState(9).rand(WIDTH))]
        doc = client.infer([sample], deadline_s=10.0)
        assert doc[eng.output_names[0]].shape == (1, CLASSES)
        assert doc["model_version"] == "boot"
        s = client.stats()
        assert s["status_counts"].get("429", 0) >= 1 and s["retries"] >= 1
        held.result(10)
        for f in futs:
            f.result(10)
        assert order == [0]
        attempts = client.stats()["attempts"]
        with pytest.raises(ServingHTTPError) as ei:
            client.infer([], deadline_s=5.0)
        assert ei.value.status == 400
        assert client.stats()["attempts"] == attempts + 1
        assert set(eng.stats()["tenants"]) == {"default"}
    finally:
        for _ in range(8):
            sem.release()
        eng.close(drain_timeout_s=5)


def test_tenant_id_coercion_and_cardinality_cap():
    out, params = _port_mlp("card")
    with _engine(out, params, max_batch=8, max_wait_us=200,
                 tenant_weights={"vip": 2.0}, max_tenants=3) as eng:
        assert eng.infer(_requests(1)[0], timeout=10,
                         tenant=5).shape == (1, CLASSES)
        assert "5" in eng.stats()["tenants"]
        assert eng.infer(_requests(1)[0], timeout=10,
                         tenant=["a"]).shape == (1, CLASSES)
        assert eng.infer(_requests(1)[0], timeout=10,
                         tenant="rando").shape == (1, CLASSES)
        assert "rando" not in eng.stats()["tenants"]
        assert eng.session["tenant_overflow"] == 1
        assert eng.infer(_requests(1)[0], timeout=10,
                         tenant="vip").shape == (1, CLASSES)
        assert eng.stats()["tenants"]["vip"]["weight"] == 2.0


def test_stats_keys_match_jax_whole_forward_engine():
    """After the same traffic, stats() has the JAX engine's keys less the
    unported features' (the compile count, mesh slices), and the same
    counts."""
    jout, jparams, tout, tparams = _mlp("keys")
    reqs = _requests(3, rows=(1, 3), seed=4)
    stats = []
    for eng in (JaxEngine(jout, jparams, max_batch=4, max_wait_us=100),
                _engine(tout, tparams, max_batch=4, max_wait_us=100)):
        try:
            for r in reqs:
                eng.infer(r, 30, tenant="t")
            stats.append(eng.stats())
        finally:
            eng.close()
    want, got = stats
    left_out = {"compile_count", "mesh_slices", "slice_compile_counts",
                "slice_forwards"}
    assert set(got) == set(want) - left_out
    assert set(got["tenants"]["t"]) == set(want["tenants"]["t"])
    for key in ("requests", "rows", "batches", "batched_rows",
                "padded_rows", "real_cells", "pad_cells", "goodput",
                "buckets_used", "batch_buckets", "model_version",
                "reloads", "padding_waste_pct", "avg_batch_rows"):
        assert got[key] == want[key], key
