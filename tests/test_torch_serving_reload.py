"""Model versions on the port's engine (``install_version``, ``promote``,
``rollback``, the canary, version pins, ``POST /reload`` with its HMAC
key) and ``paddle_tpu_torch/serving/reload.py`` (``WeightWatcher``,
``load_from``) over the port's checkpoint stream: the contracts of
``tests/test_serving_reload.py`` held on the port, the decode
drain-then-swap included.  One ``serve`` subprocess is SIGKILLed
mid-reload.  Engine answers are compared bit for bit with the same
engine's answers at the same bucket, and within 1e-5 (relative) and 1e-6
(absolute) with ``Inference`` on the version's weights."""

import hashlib
import hmac
import json
import os
import signal
import threading
import time
import urllib.request

import numpy as np
import pytest

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.core import config
from paddle_tpu_torch.inference import Inference
from paddle_tpu_torch.io import checkpoint as ckpt
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.serving import (InferenceEngine, ServingClient,
                                      WeightWatcher, local_transport)
from paddle_tpu_torch.serving import reload as reload_mod

WIDTH = 8
RTOL, ATOL = 1e-5, 1e-6


def _mlp(name="rld"):
    tpaddle.init(seed=0, device="cpu")
    x = tpaddle.layer.data("x", tpaddle.data_type.dense_vector(WIDTH))
    h = tpaddle.layer.fc(x, size=WIDTH, act="relu", name=f"{name}_h")
    out = tpaddle.layer.fc(h, size=4, act="softmax", name=f"{name}_out")
    params = tpaddle.parameters.create(tpaddle.Topology(out), device="cpu")
    return out, params


def _numpy(values):
    return {k: {kk: vv.detach().cpu().numpy() for kk, vv in v.items()}
            for k, v in values.items()}


def _perturb(values, k):
    """Other weights of the same names and shapes (every leaf + 0.01 k)."""
    return {lname: {name: (np.asarray(a) + np.float32(0.01 * k)).astype(
        np.float32) for name, a in ps.items()}
        for lname, ps in _numpy_any(values).items()}


def _numpy_any(values):
    return {k: {kk: (vv.detach().cpu().numpy() if hasattr(vv, "detach")
                     else np.asarray(vv)) for kk, vv in v.items()}
            for k, v in values.items()}


def _requests(n, rows=(1, 3), seed=0):
    rng = np.random.RandomState(seed)
    return [[(rng.rand(WIDTH).astype(np.float32),)
             for _ in range(rows[i % len(rows)])] for i in range(n)]


def _ref(out, values):
    params = tpaddle.parameters.from_numpy(
        tpaddle.Topology(out, collect_evaluators=False), _numpy_any(values),
        device="cpu")
    inf = Inference(out, params, device="cpu")
    return lambda req: inf.infer(input=req)


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def _engine(out, params, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait_us", 100)
    config.set_option("device", "cpu")    # the engine's Inference runs here
    return InferenceEngine(out, params, **kw)


def _save(d, step, values):
    return ckpt.save_step(d, step, pass_id=0, batches_done=0,
                          trainable=_numpy_any(values), opt_state={},
                          model_state={})


def _corrupt(snap_dir):
    with open(os.path.join(snap_dir, "params.npz"), "r+b") as f:
        f.seek(12)
        f.write(b"\xff\xff\xff\xff")


def _wait(cond, timeout=30.0):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.01)
    return False


# ------------------------------------------------------------- hot swap
def test_hot_swap_prev_pin_rollback():
    out, params = _mlp("swap")
    vals_a = _numpy(params.values)
    vals_b = _perturb(vals_a, 1)
    reqs = _requests(6)
    ref_b = _ref(out, vals_b)
    with _engine(out, params, model_version="vA") as eng:
        outs_a = [eng.infer(r, timeout=30) for r in reqs]
        res = eng.install_version("vB", vals_b)
        assert res == {"result": "swapped", "model_version": "vB"}
        for r in reqs:
            _close(eng.infer(r, timeout=30), ref_b(r))
        # the previous version stays resident: pins by id and by "prev"
        for r, want in zip(reqs, outs_a):
            assert np.array_equal(eng.infer(r, timeout=30, version="vA"),
                                  want)
            assert np.array_equal(eng.infer(r, timeout=30, version="prev"),
                                  want)
        fut = eng.submit(reqs[0])
        fut.result(30)
        assert fut._ptt_model_version == "vB"
        st = eng.stats()
        assert st["model_version"] == "vB" and st["model_version_prev"] == "vA"
        assert st["model_versions"]["vA"]["state"] == "prev"
        assert st["reloads"]["swapped"] == 1
        assert len(eng.swap_pauses_us()) == 1
        rb = eng.rollback()
        assert rb == {"result": "rolled_back", "model_version": "vA"}
        for r, want in zip(reqs, outs_a):
            assert np.array_equal(eng.infer(r, timeout=30), want)
        assert eng.stats()["reloads"]["rolled_back"] == 1
        assert eng.install_version("vB", vals_b)["result"] == "refused_bad"
        assert eng.install_version("vA", vals_a)["result"] == "no_new"
        cut = {k: dict(v) for k, v in vals_a.items()}
        cut.pop(next(iter(cut)))
        res = eng.install_version("vD", cut)
        assert res["result"] == "refused" and "shapes" in res["error"]
        assert "vD" not in eng.stats()["model_versions"]
        assert eng.rollback()["result"] == "refused"
        with pytest.raises(ValueError, match="unknown model_version"):
            eng.infer(reqs[0], timeout=5, version="nope")
    assert eng.install_version("vC", vals_b)["result"] == "refused"


def test_inflight_requests_finish_on_old_weights():
    """Requests admitted before a swap run on the weights they resolved
    at submit, even when their forward runs after it; a micro-batch never
    mixes versions."""
    out, params = _mlp("inflight")
    vals_b = _perturb(params.values, 1)
    eng = _engine(out, params, max_batch=4, model_version="vA")
    reqs = _requests(4, rows=(1,))
    outs_a = [eng.infer(r, 30) for r in reqs]
    sem = threading.Semaphore(0)
    orig = eng._inf.run_feed
    eng._inf.run_feed = lambda feed, params=None: (
        sem.acquire(), orig(feed, params))[1]
    try:
        held = eng.submit(reqs[0])
        assert _wait(lambda: eng.queue_depth() == 0)
        backlog = [eng.submit(r) for r in reqs[1:]]
        assert eng.install_version("vB", vals_b)["result"] == "swapped"
        post = eng.submit(reqs[0])
        for _ in range(16):
            sem.release()
        assert np.array_equal(held.result(30), outs_a[0])
        for r, f, w in zip(reqs[1:], backlog, outs_a[1:]):
            _close(f.result(30), w)
            assert f._ptt_model_version == "vA"
        _close(post.result(30), _ref(out, vals_b)(reqs[0]))
        assert post._ptt_model_version == "vB"
        assert eng.stats()["batches"] >= 3
    finally:
        for _ in range(16):
            sem.release()
        eng._inf.run_feed = orig
        eng.close()


def test_canary_split_pin_promote_and_breach():
    out, params = _mlp("canary")
    vals_b = _perturb(params.values, 1)
    req = _requests(1)[0]
    with _engine(out, params, model_version="v0", canary_fraction=0.25,
                 canary_promote_requests=1000) as eng:
        assert eng.install_version("v1", vals_b)["result"] == "canary"
        vers = []
        for _ in range(8):
            f = eng.submit(req)
            f.result(30)
            vers.append(f._ptt_model_version)
        assert vers.count("v1") == 2            # exactly every 4th
        assert eng.stats()["model_version"] == "v0"
        f = eng.submit(req, version="v1")
        f.result(30)
        assert f._ptt_model_version == "v1"
        assert eng.promote()["result"] == "swapped"
        st = eng.stats()
        assert st["model_version"] == "v1"
        assert st["model_version_canary"] is None
        assert eng.promote()["result"] == "refused"
    out, params = _mlp("canary2")
    vals_b = _perturb(params.values, 2)
    with _engine(out, params, model_version="w0", canary_fraction=0.5,
                 breaker_window=0, breaker_min_requests=4,
                 breaker_threshold=0.5) as eng:
        assert eng.install_version("w1", vals_b)["result"] == "canary"
        poison = [(np.zeros(3, np.float32),)]
        for _ in range(6):
            f = eng.submit(poison, version="w1")
            with pytest.raises(Exception):
                f.result(30)
        assert _wait(lambda: eng.stats()["model_version_canary"] is None)
        st = eng.stats()
        assert st["model_version"] == "w0"
        assert st["reloads"]["rolled_back"] == 1
        assert st["model_versions"]["w1"]["state"] == "rolled_back"
        assert eng.install_version("w1", vals_b)["result"] == "refused_bad"
        assert eng.infer(req, timeout=30) is not None


def test_auto_promote_after_healthy_probation():
    out, params = _mlp("promo")
    vals_b = _perturb(params.values, 1)
    req = _requests(1)[0]
    with _engine(out, params, model_version="p0", canary_fraction=1.0,
                 canary_promote_requests=6) as eng:
        assert eng.install_version("p1", vals_b)["result"] == "canary"
        for _ in range(8):
            eng.infer(req, timeout=30)
        assert _wait(lambda: eng.stats()["model_version"] == "p1")
        st = eng.stats()
        assert st["model_version_canary"] is None
        assert st["model_versions"]["p0"]["state"] == "prev"
        assert st["reloads"]["swapped"] == 1


def test_eviction_fallback_restamps_the_answer():
    """A request pinned to a version that retires before its batch runs
    (swaps raced the queue) runs on the active weights, and its answer
    says so (counted ``version_fallbacks``)."""
    out, params = _mlp("evict")
    req = _requests(1)[0]
    eng = _engine(out, params, model_version="e0")
    sem = threading.Semaphore(0)
    orig = eng._inf.run_feed
    eng._inf.run_feed = lambda feed, params=None: (
        sem.acquire(), orig(feed, params))[1]
    try:
        held = eng.submit(req)
        assert _wait(lambda: eng.queue_depth() == 0)
        pinned = eng.submit(req, version="e0")
        for k in (1, 2, 3):
            assert eng.install_version(f"e{k}", _perturb(
                params.values, k))["result"] == "swapped"
        assert "e0" not in eng.stats()["model_versions"]
        for _ in range(8):
            sem.release()
        held.result(30)
        _close(pinned.result(30), _ref(out, _perturb(params.values, 3))(req))
        assert pinned._ptt_model_version == "e3"
        assert eng.stats()["version_fallbacks"] == 1
    finally:
        for _ in range(8):
            sem.release()
        eng._inf.run_feed = orig
        eng.close()


# ------------------------------------------------------------- watcher
def test_watcher_swaps_newest_valid_and_skips_corrupt(tmp_path):
    d = str(tmp_path)
    out, params = _mlp("watch")
    vals_a = _numpy(params.values)
    req = _requests(1)[0]
    with _engine(out, params, model_version="boot") as eng:
        w = WeightWatcher(eng, d, period_s=30.0, poll=False)
        assert w.check_now()["result"] == "empty"
        _save(d, 5, _perturb(vals_a, 1))
        r = w.check_now()
        assert r["result"] == "swapped" and r["global_step"] == 5
        v5 = r["model_version"]
        assert v5.startswith("5-") and eng.stats()["model_version"] == v5
        _close(eng.infer(req, timeout=30), _ref(out, _perturb(vals_a, 1))(req))
        assert w.check_now()["result"] == "no_new"
        _save(d, 9, _perturb(vals_a, 2))
        _corrupt(ckpt.step_dir(d, 9))
        with pytest.warns(RuntimeWarning):
            r = w.check_now()
        assert r["result"] in ("no_new", "verify_failed")
        assert eng.stats()["model_version"] == v5
        _save(d, 12, _perturb(vals_a, 3))
        r = w.check_now()
        assert r["result"] == "swapped" and r["global_step"] == 12
        w.close()
        assert w.stats()["swapped"] == 2


def test_watcher_all_corrupt_keeps_serving_loudly(tmp_path):
    d = str(tmp_path)
    out, params = _mlp("allcor")
    req = _requests(1)[0]
    with _engine(out, params, model_version="boot") as eng:
        before = eng.infer(req, timeout=30)
        _save(d, 4, _perturb(params.values, 1))
        _save(d, 8, _perturb(params.values, 2))
        _corrupt(ckpt.step_dir(d, 4))
        _corrupt(ckpt.step_dir(d, 8))
        w = WeightWatcher(eng, d, period_s=30.0, poll=False)
        with pytest.warns(RuntimeWarning):
            r = w.check_now()
        assert r["result"] == "verify_failed"
        st = eng.stats()
        assert st["model_version"] == "boot"
        assert st["reloads"]["verify_failed"] == 1
        assert st["reloads"]["swapped"] == 0
        assert np.array_equal(eng.infer(req, timeout=30), before)
        w.close()


def test_watcher_background_poll_and_engine_close_joins(tmp_path):
    d = str(tmp_path)
    out, params = _mlp("poll")
    eng = _engine(out, params, model_version="boot")
    w = WeightWatcher(eng, d, period_s=0.05)
    _save(d, 3, _perturb(params.values, 1))
    assert _wait(lambda: eng.stats()["model_version"].startswith("3-"))
    assert w.stats()["alive"]
    eng.close()
    assert not w._thread.is_alive()


def test_close_during_inflight_background_load(tmp_path, monkeypatch):
    d = str(tmp_path)
    out, params = _mlp("closing")
    _save(d, 6, _perturb(params.values, 1))
    eng = _engine(out, params, model_version="boot")
    in_load, release = threading.Event(), threading.Event()
    orig = ckpt.load_snapshot

    def slow_load(path, manifest=None):
        in_load.set()
        assert release.wait(20)
        return orig(path, manifest)

    monkeypatch.setattr(reload_mod._ckpt, "load_snapshot", slow_load)
    w = WeightWatcher(eng, d, period_s=0.05)
    assert in_load.wait(15)
    closer = threading.Thread(target=eng.close)
    closer.start()
    # close() joins the watcher first: it waits out the load in flight
    assert not _wait(lambda: not closer.is_alive(), 0.2)
    release.set()
    closer.join(20)
    assert not closer.is_alive() and not w._thread.is_alive()
    # the racing install landed before the closed flag, or was refused
    # after it: either way nothing hung and nothing failed
    assert w.stats()["errors"] == 0
    assert eng.install_version("late", params.values)["result"] == "refused"


# ----------------------------------------------------------- /reload verb
def _sign(key, query, body):
    return hmac.new(key, query.encode() + b"\n" + body,
                    hashlib.sha256).hexdigest()


def test_reload_verb_auth_rollback_promote(tmp_path):
    out, params = _mlp("verb")
    vals_b = _perturb(params.values, 1)
    key = b"reload-secret"
    with _engine(out, params, model_version="vA", reload_key=key) as eng:
        h = eng.http_handlers()["/reload"]
        res = h("POST", b"", {}, "")
        assert res[0] == 403
        assert json.loads(res[2])["error"] == "reload unauthorized"
        assert h("POST", b"", {"X-Ptpu-Reload-Key": "deadbeef"}, "")[0] == 403
        assert eng.stats()["reload_unauthorized"] == 2
        signed = {"X-Ptpu-Reload-Key": _sign(key, "rollback=1", b"")}
        assert h("POST", b"", signed, "rollback=1")[0] == 409
        # a signed bare push replayed as ?rollback=1 is refused
        assert h("POST", b"", {"X-Ptpu-Reload-Key": _sign(key, "", b"")},
                 "rollback=1")[0] == 403
        eng.install_version("vB", vals_b)
        res = h("POST", b"", signed, "rollback=1")
        assert res[0] == 200
        assert json.loads(res[2])["model_version"] == "vA"
        assert eng.stats()["model_version"] == "vA"
        assert h("GET", b"", {}, "")[0] == 405
        # over HTTP: the query rides the MAC
        url = f"http://127.0.0.1:{eng.serve(0).server_address[1]}"
        req = urllib.request.Request(url + "/reload?rollback=1", data=b"",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 403
    out, params = _mlp("verb2")
    d = str(tmp_path)
    _save(d, 7, _perturb(params.values, 2))
    with _engine(out, params, model_version="boot", canary_fraction=0.5,
                 canary_promote_requests=1000) as eng:
        h = eng.http_handlers()["/reload"]
        assert h("POST", b"", {}, "")[0] == 400
        res = h("POST", json.dumps({"dir": d}).encode(), {}, "")
        assert res[0] == 200
        doc = json.loads(res[2])
        assert doc["result"] == "canary" and doc["global_step"] == 7
        assert h("POST", b"", {}, "promote=1")[0] == 200
        assert eng.stats()["model_version"] == doc["model_version"]


def test_reload_verb_pushes_watcher_check(tmp_path):
    d = str(tmp_path)
    out, params = _mlp("push")
    with _engine(out, params, model_version="boot") as eng:
        WeightWatcher(eng, d, period_s=3600.0)
        _save(d, 11, _perturb(params.values, 1))
        res = eng.http_handlers()["/reload"]("POST", b"", {}, "")
        assert res[0] == 200
        assert json.loads(res[2])["result"] == "swapped"
        assert eng.stats()["model_version"].startswith("11-")


def test_reload_under_sustained_load_sheds_nothing():
    """Two swaps while four clients call without pause: nothing shed,
    every answer its version's, and the client's version trail spans
    them.  The swaps wait for progress (answers counted), not a clock."""
    out, params = _mlp("storm")
    vals = {"vA": _numpy(params.values), "vB": _perturb(params.values, 1),
            "vC": _perturb(params.values, 2)}
    refs = {v: _ref(out, vv) for v, vv in vals.items()}
    eng = _engine(out, params, max_wait_us=200, max_queue_depth=256,
                  model_version="vA")
    client = ServingClient("http://test", transport=local_transport(eng))
    reqs = _requests(2, rows=(1, 3))
    results, errors = [], []
    stop = threading.Event()

    def storm():
        i = 0
        while not stop.is_set():
            r = reqs[i % len(reqs)]
            try:
                results.append((r, client.infer(r, deadline_s=30)))
            except Exception as e:        # noqa: BLE001 - the check
                errors.append(repr(e))
                return
            i += 1

    threads = [threading.Thread(target=storm) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for ver in ("vB", "vC"):
            n = len(results)
            assert _wait(lambda: len(results) >= n + 20)
            assert eng.install_version(ver, vals[ver])["result"] == "swapped"
        n = len(results)
        assert _wait(lambda: len(results) >= n + 20)
    finally:
        stop.set()
        for t in threads:
            t.join(30)
    st = eng.stats()
    eng.close()
    assert not errors, errors
    assert sum(st["shed"].values()) == 0
    assert st["reloads"]["swapped"] == 2
    seen = set()
    for r, outs in results:
        ver = outs["model_version"]
        seen.add(ver)
        name = [n for n in outs if n != "model_version"][0]
        _close(outs[name], refs[ver](r))
    assert {"vA", "vC"} <= seen
    cst = client.stats()
    assert set(cst["model_versions"]) == seen
    assert sum(cst["model_versions"].values()) == len(results)


# -------------------------------------------------- SIGKILL mid-reload
def test_sigkill_mid_reload_leaves_the_stream_valid(tmp_path):
    """A ``serve --model --watch_dir`` child SIGKILLed while a reload may
    be in flight: the checkpoint stream stays valid (the reload path
    writes nothing but quarantine renames), and an engine booted from it
    as ``serve`` boots serves the newest valid snapshot."""
    from paddle_tpu_torch import cli
    from paddle_tpu_torch.serving import fleet

    cfg_path = tmp_path / "reload_cfg.py"
    cfg_path.write_text(
        "import paddle_tpu_torch as paddle\n"
        "from paddle_tpu_torch import layer\n"
        "x = layer.data('x', paddle.data_type.dense_vector(4))\n"
        "prediction = layer.fc(x, size=2, act='softmax',\n"
        "                      name='rld_kill_out')\n")
    d = str(tmp_path / "stream")
    os.makedirs(d)
    tpaddle.init(seed=0, device="cpu")
    x = tpaddle.layer.data("x", tpaddle.data_type.dense_vector(4))
    pred = tpaddle.layer.fc(x, size=2, act="softmax", name="rld_kill_out")
    params = tpaddle.parameters.create(
        tpaddle.Topology(pred, collect_evaluators=False), device="cpu")
    _save(d, 1, _perturb(params.values, 1))
    env = dict(os.environ, PYTHONPATH="")
    rep = fleet.spawn_replica(
        str(cfg_path), extra=["--max_batch", "2", "--watch_dir", d,
                              "--reload_period_s", "0.05", "--params", d,
                              "--device", "cpu"],
        env=env, log_dir=str(tmp_path))
    try:
        st = json.loads(urllib.request.urlopen(rep.url + "/stats",
                                               timeout=30).read())
        assert st["model_version"].startswith("1-")
        _save(d, 2, _perturb(params.values, 2))
        time.sleep(0.08)
    finally:
        os.kill(rep.pid, signal.SIGKILL)
        rep.proc.wait(30)
    audit = ckpt.audit(d)
    assert audit["corrupt"] == 0 and audit["ok"] == 2
    cand = ckpt.latest_valid(d)
    assert cand["global_step"] == 2
    args = cli.build_parser().parse_args(
        ["serve", "--model", str(cfg_path), "--params", d, "--device",
         "cpu"])
    out, params2, version, _, _ = cli._serve_weights(args)
    assert version == cand["model_version"]
    with _engine(out, params2, model_version=version) as eng:
        res = eng.http_handlers()["/infer"]("POST", json.dumps(
            {"input": [[list(np.zeros(4))]]}).encode())
        assert res[0] == 200
        assert json.loads(res[2])["model_version"] == version


# ------------------------------------------------------- decode swap
def _small_lm(seed=0):
    import paddle_tpu as jpaddle
    from paddle_tpu.models import transformer as jtr

    jpaddle.init(seed=seed)
    cost, _ = jtr.build(vocab_size=32, max_len=48, dim=16, num_heads=2,
                        num_layers=1)
    params = jpaddle.parameters.create(
        jpaddle.Topology(cost, collect_evaluators=False))
    return {k: {kk: np.asarray(vv) for kk, vv in v.items()}
            for k, v in params.values.items()}


def _perturb_rand(values, seed):
    """A random multiplicative change: greedy streams change too."""
    rng = np.random.RandomState(seed)
    return {lname: {name: (a * (1.0 + 0.2 * rng.standard_normal(a.shape)))
                    .astype(np.float32) for name, a in ps.items()}
            for lname, ps in values.items()}


def _slab(values):
    return ttr.SlotDecoder(ttr.params_from_jax(values, num_heads=2),
                           max_slots=2, step_buckets=(2,),
                           prefill_buckets=(8,), device="cpu")


@pytest.mark.parametrize("kind", ("slab", "paged"))
def test_decode_drain_then_swap_resident_finishes_on_old(kind):
    """A pending swap pauses admission (queued requests wait, nothing is
    shed); the resident finishes on the old weights; the decoder then
    swaps (its caches, the paged prefix cache too, re-zeroed) and queued
    work serves the new version; a rollback rides the same path."""
    vals_a = _small_lm()
    vals_b = _perturb_rand(vals_a, 7)
    prompt = np.array([3, 5, 7], np.int32)
    n_tok = 10

    def make(values):
        if kind == "slab":
            return _slab(values)
        return ttr.PagedDecoder(ttr.params_from_jax(values, num_heads=2),
                                max_slots=2, block_size=4,
                                step_buckets=(2,), chunk_buckets=(8,),
                                device="cpu")

    def ref(values):
        eng = InferenceEngine(make(values))
        try:
            return eng.infer([prompt], 60, max_tokens=n_tok).tolist()
        finally:
            eng.close()

    ref_a, ref_b = ref(vals_a), ref(vals_b)
    assert ref_a != ref_b
    dec = make(vals_a)
    name = "mixed_step" if kind == "paged" else "step"
    orig = getattr(dec, name)
    gate = threading.Semaphore(0)

    def gated(*a, **kw):
        gate.acquire()
        return orig(*a, **kw)

    setattr(dec, name, gated)
    eng = InferenceEngine(dec, model_version="dA")
    try:
        f1 = eng.submit([prompt], max_tokens=n_tok)
        assert _wait(lambda: eng.session["slot_allocs"] >= 1)
        assert eng.install_version("dB", vals_b)["result"] == "pending"
        assert eng.stats()["model_version_pending"] == "dB"
        f2 = eng.submit([prompt], max_tokens=n_tok)
        for _ in range(4 * n_tok):
            gate.release()
        assert f1.result(60).tolist() == ref_a
        setattr(dec, name, orig)
        for _ in range(4 * n_tok):
            gate.release()
        assert f2.result(60).tolist() == ref_b
        assert f1._ptt_model_version == "dA"
        assert f2._ptt_model_version == "dB"
        st = eng.stats()
        assert st["model_version"] == "dB"
        assert st["model_version_pending"] is None
        assert st["reloads"]["swapped"] == 1
        assert sum(st["shed"].values()) == 0
        assert eng.rollback()["result"] == "pending"
        assert eng.infer([prompt], 60, max_tokens=n_tok).tolist() == ref_a
        assert _wait(lambda: eng.stats()["model_version"] == "dA")
        assert eng.stats()["reloads"]["rolled_back"] == 1
    finally:
        setattr(dec, name, orig)
        for _ in range(8 * n_tok):
            gate.release()
        eng.close()


def test_decode_rejects_canary_and_foreign_pins():
    dec = _slab(_small_lm())
    with pytest.raises(ValueError, match="canary"):
        InferenceEngine(decoder=dec, canary_fraction=0.5)
    eng = InferenceEngine(decoder=dec, model_version="d0")
    try:
        f = eng.submit([np.array([1, 2], np.int32)], max_tokens=2,
                       version="elsewhere")
        with pytest.raises(ValueError, match="one resident version"):
            f.result(10)
        f = eng.submit([np.array([1, 2], np.int32)], max_tokens=2,
                       version="d0")
        assert f.result(60).shape == (2,) and f._ptt_model_version == "d0"
    finally:
        eng.close()
