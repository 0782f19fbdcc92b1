"""The overload and tenancy layer of the port's decode engine: the
decode-mode counterparts of ``tests/test_serving.py``'s admission gate,
lanes, WFQ, quotas, breaker, default tenant, shed reasons, tenant ids,
drain, timeout-cancel, watchdog and HTTP overload tests, plus the boarding
order of a scripted queue on one slot against the JAX engine's and the key
set of ``stats()`` against the JAX decode engine's.  Steps are held by
``Gate``; no test reads the clock for its verdict."""

import json
import threading
import time
import urllib.request
from concurrent.futures import TimeoutError as FutTimeout
from urllib.error import HTTPError

import numpy as np
import pytest

from paddle_tpu.models import transformer as jtr
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.serving import (BreakerOpen, DeadlineExceeded,
                                      EngineClosed, EngineUnhealthy,
                                      InferenceEngine, Overloaded,
                                      ServingError)
from paddle_tpu_torch.serving.engine import (DEFAULT_TENANT, LANES,
                                             SHED_REASONS, SLOT_FREE_REASONS)
from torch_serving_helpers import (HEADS, VOCAB, Gate, lm, paged,
                                   request_of, resident, slab, wait_until)

P = np.arange(4) % VOCAB


@pytest.fixture(scope="module")
def small():
    topo, params, values = lm()
    return topo, params, ttr.params_from_jax(values, num_heads=HEADS)


def _held(model, tenant=None, **engine_kw):
    """An engine on a 1-slot slab decoder whose steps the test releases,
    with one request of ``tenant`` (two tokens: one held step) resident."""
    dec = slab(model, max_slots=1, prefill_buckets=(8,))
    gate = Gate(dec)
    eng = InferenceEngine(decoder=dec, **engine_kw)
    held = eng.submit([P], max_tokens=2, tenant=tenant)
    resident(eng, gate, 1)
    return eng, gate, held


def _elapse_cooldown(eng, tenant):
    """Move the tenant's breaker opening a minute into the past: its
    cooldown has elapsed without the test sleeping through it."""
    eng._tenants[tenant].br_opened_at -= 60.0


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read()


def test_constants_are_the_jax_engines():
    assert LANES == ("high", "normal")
    assert SHED_REASONS == ("queue_full", "tenant_quota", "breaker_open",
                            "deadline", "drain", "thread_death",
                            "abandoned", "kv_blocks")
    assert SLOT_FREE_REASONS == ("finished", "deadline", "abandoned",
                                 "error", "drain", "kv_blocks")
    assert DEFAULT_TENANT == "default"


def test_admission_control_sheds_fast_and_flap_free(small):
    """At max_queue_depth the Future fails inside submit with a typed
    Overloaded, and the hysteresis band keeps the gate shut until the
    backlog drains to the resume watermark."""
    eng, gate, held = _held(small[2], max_queue_depth=4, hysteresis=0.5)
    try:
        backlog = [eng.submit([P + i], max_tokens=2) for i in range(4)]
        assert eng.queue_depth() == 4
        for _ in range(3):
            shed = eng.submit([P], max_tokens=2)
            assert shed.done()                 # resolved inside submit
            with pytest.raises(Overloaded) as ei:
                shed.result(0)
            assert ei.value.reason == "queue_full"
            assert ei.value.retry_after_s > 0
        assert eng.stats()["shedding"] is True
        assert eng.session["shed"]["queue_full"] == 3
        # depth 3 is above the watermark of 2: still shedding
        gate.step()                            # held done, one boards
        assert eng.queue_depth() == 3
        with pytest.raises(Overloaded):
            eng.submit([P], max_tokens=2).result(0)
        gate.step()
        assert eng.queue_depth() == 2          # at the watermark
        readmitted = eng.submit([P], max_tokens=2)
        assert not readmitted.done()
        gate.open()
        for f in [held] + backlog + [readmitted]:
            assert f.result(30).shape == (2,)
        assert eng.stats()["shedding"] is False
    finally:
        gate.open()
        eng.close(drain_timeout_s=5)


def test_expired_request_never_takes_a_slot(small):
    """A request whose deadline passes while queued is failed at pop time
    with DeadlineExceeded: no slot, no prefill."""
    eng, gate, held = _held(small[2])
    try:
        doomed = eng.submit([P + 1], max_tokens=2, deadline_us=60e6)
        request_of(doomed).deadline = time.perf_counter() - 1.0
        gate.open()
        with pytest.raises(DeadlineExceeded, match="before admission"):
            doomed.result(10)
        assert held.result(10).shape == (2,)
        st = eng.stats()
        assert st["shed"]["deadline"] == 1
        assert st["decode"]["slot_allocs"] == 1   # only the held one
    finally:
        gate.open()
        eng.close(drain_timeout_s=5)


def test_priority_lanes_and_anti_starvation_credit(small):
    """The high lane overtakes normal, but after starvation_limit high
    pops past waiting normal traffic the credit forces one normal pop."""
    eng, gate, held = _held(small[2], starvation_limit=2)
    order = []
    try:
        futs = [eng.submit([P], max_tokens=1)]     # normal, FIRST
        futs[0].add_done_callback(lambda _: order.append("n1"))
        for name in ("h1", "h2", "h3"):
            f = eng.submit([P], max_tokens=1, lane="high")
            f.add_done_callback(lambda _, n=name: order.append(n))
            futs.append(f)
        assert eng.queue_depth() == 4
        assert eng.stats()["lane_depth"] == {"high": 0, "normal": 0}
        gate.open()
        held.result(10)
        for f in futs:
            f.result(10)
        assert order == ["h1", "h2", "n1", "h3"]
        assert eng.session["lane_credit_pops"] == 1
        assert eng.stats()["lane_depth"] == {"high": 0, "normal": 0}
    finally:
        gate.open()
        eng.close(drain_timeout_s=5)


def test_infer_timeout_cancels_abandoned_request(small):
    """A timed-out infer() caller abandons its request: it is dropped at
    pop time (shed "abandoned") and never takes a slot."""
    eng, gate, held = _held(small[2])
    try:
        with pytest.raises(FutTimeout):
            eng.infer([P + 1], timeout=0.05, max_tokens=2)
        gate.open()
        assert held.result(10).shape == (2,)
        wait_until(lambda: eng.session["shed"]["abandoned"] == 1,
                   what="the abandoned shed")
        assert eng.stats()["decode"]["slot_allocs"] == 1
    finally:
        gate.open()
        eng.close(drain_timeout_s=5)


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_watchdog_fails_inflight_on_batcher_death(small):
    """A BaseException escaping a decode step kills the batcher thread: the
    watchdog fails every in-flight future (resident and queued) with
    EngineUnhealthy, marks the engine dead, and refuses new work; a fresh
    engine serves."""
    model = small[2]
    p = np.arange(5) % VOCAB
    with InferenceEngine(decoder=slab(model)) as eng0:
        want = eng0.infer([p], 30, max_tokens=4).tolist()
    dec = slab(model, max_slots=1)
    gate = Gate(dec)
    eng = InferenceEngine(decoder=dec, watchdog_interval_s=0.05)
    try:
        first = eng.submit([p], max_tokens=4)
        resident(eng, gate, 1)
        queued = [eng.submit([p + i], max_tokens=4) for i in range(2)]

        def die(n, tokens, pos):
            raise SystemExit("injected batcher death")

        gate.orig = die
        gate.open()
        for f in [first] + queued:
            with pytest.raises(EngineUnhealthy):
                f.result(10)
        assert eng.healthy is False
        st = eng.stats()
        assert st["health"] == "dead" and st["batcher_alive"] is False
        assert st["health_reason"] == "batcher thread died"
        code, body = eng._healthz()
        assert code == 503 and body.startswith("dead")
        with pytest.raises(EngineUnhealthy):
            eng.submit([p], max_tokens=4).result(5)
        assert eng.session["shed"]["thread_death"] == 3
    finally:
        eng.close(drain_timeout_s=1)
    eng2 = InferenceEngine(decoder=slab(model))
    try:
        assert eng2.infer([p], 30, max_tokens=4).tolist() == want
    finally:
        eng2.close()


def test_close_drain_timeout_sheds_instead_of_hanging(small):
    """close(drain_timeout_s=) on a wedged batcher sheds what cannot
    finish (EngineClosed, reason "drain") and returns."""
    eng, gate, held = _held(small[2])
    queued = [eng.submit([P + i], max_tokens=2) for i in range(3)]
    eng.close(drain_timeout_s=0.3)
    for f in queued + [held]:
        with pytest.raises(EngineClosed):
            f.result(1)
    assert eng.session["shed"]["drain"] == 4
    with pytest.raises(ServingError):
        eng.submit([P], max_tokens=2).result(1)
    assert eng._healthz() == (503, "closed\n")
    gate.open()                               # unwedge the batcher
    wait_until(lambda: not eng._batcher.is_alive(), what="batcher exit")
    assert eng.stats()["decode"]["slots_occupied"] == 0
    assert eng.session["shed"]["drain"] == 4  # nothing counted twice


def test_http_overload_surface(small):
    """/healthz flips 200 ok -> 503 overloaded with the admission gate,
    /infer sheds with 429 + Retry-After + reason, /stats carries the same
    health fields, lane / tenant / deadline / max_tokens ride the body or
    the headers, a deadline answers 504 and a closed engine 503."""
    model = small[2]
    dec = slab(model, max_slots=1, prefill_buckets=(8,))
    gate = Gate(dec)
    eng = InferenceEngine(decoder=dec, max_queue_depth=2, hysteresis=0.5)
    url = f"http://127.0.0.1:{eng.serve(0).server_address[1]}"
    doc = {"input": [P.tolist()], "max_tokens": 2}

    def post(body, headers=None):
        req = urllib.request.Request(
            url + "/infer", data=json.dumps(body).encode(),
            headers=dict({"Content-Type": "application/json"},
                         **(headers or {})))
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, json.loads(r.read()), dict(r.headers)
        except HTTPError as e:
            return e.code, json.loads(e.read()), dict(e.headers)

    try:
        assert _get(url + "/healthz") == (200, b"ok\n")
        held = eng.submit([P], max_tokens=2)
        resident(eng, gate, 1)
        backlog = [eng.submit([P + i], max_tokens=2) for i in range(2)]
        code, body, headers = post(dict(doc, lane="high"))
        assert code == 429 and body["error"] == "overloaded"
        assert body["reason"] == "queue_full"
        assert int(headers["Retry-After"]) >= 1
        with pytest.raises(HTTPError) as hi:
            _get(url + "/healthz")
        assert hi.value.code == 503
        assert hi.value.read().startswith(b"overloaded")
        st = json.loads(_get(url + "/stats")[1])
        assert st["shedding"] is True and st["shed"]["queue_full"] == 1
        assert st["queue_saturation"] == 1.0
        assert st["health"] == "overloaded"
        assert st["port"] == int(url.rsplit(":", 1)[1])
        gate.open()
        for f in [held] + backlog:
            f.result(10)
        wait_until(lambda: eng.queue_depth() == 0, what="drain")
        assert _get(url + "/healthz") == (200, b"ok\n")
        want = eng.infer([P], 30, max_tokens=3).tolist()
        code, body, _ = post({"input": [P.tolist()], "lane": "high",
                              "deadline_ms": 60000, "max_tokens": 3,
                              "tenant": "t1"})
        assert code == 200 and body == {"outputs": {"tokens": want},
                                        "generated": 3,
                                        "model_version": "boot"}
        code, body, _ = post({"input": [P.tolist()]}, {
            "X-Ptpu-Lane": "high", "X-Ptpu-Tenant": "t2",
            "X-Ptpu-Deadline-Ms": "60000", "X-Ptpu-Max-Tokens": "3"})
        assert code == 200 and body["outputs"]["tokens"] == want
        tenants = json.loads(_get(url + "/stats")[1])["tenants"]
        assert tenants["t1"]["requests"] == tenants["t2"]["requests"] == 1
        code, body, _ = post(dict(doc, deadline_ms=0.001))
        assert code == 504 and "deadline" in body["error"]
        assert post({"input": [[VOCAB]], "max_tokens": 2})[0] == 400
        assert post(dict(doc, lane="urgent"))[0] == 400
    finally:
        gate.open()
        eng.close(drain_timeout_s=5)
    code, _, body = eng.http_handlers()["/infer"](
        "POST", json.dumps(doc).encode())[:3]
    assert code == 503 and "EngineClosed" in json.loads(body)["error"]


def test_wfq_interleaves_tenants_by_weight(small):
    """Inside a lane, a weight-2 tenant's queued requests overtake a
    weight-1 hog's backlog at 2:1 (one-token requests, one slot: boarding
    order is completion order)."""
    eng, gate, held = _held(small[2], tenant_weights={"vip": 2.0,
                                                      "hog": 1.0},
                            tenant="hog")
    order = []
    try:
        for name, tenant in (("h2", "hog"), ("h3", "hog"), ("h4", "hog"),
                             ("v1", "vip"), ("v2", "vip")):
            f = eng.submit([P], max_tokens=1, tenant=tenant)
            f.add_done_callback(lambda _, n=name: order.append(n))
        assert eng.queue_depth() == 5
        gate.open()
        held.result(10)
        wait_until(lambda: len(order) == 5, what="five completions")
        assert order == ["h2", "v1", "v2", "h3", "h4"]
        ts = eng.stats()["tenants"]
        assert ts["vip"]["weight"] == 2.0
        assert ts["hog"]["requests"] == 4 and ts["vip"]["requests"] == 2
        assert ts["hog"]["depth"] == 0 and ts["vip"]["depth"] == 0
    finally:
        gate.open()
        eng.close(drain_timeout_s=5)


def test_tenant_quota_sheds_hog_only(small):
    """The over-quota tenant sheds with Overloaded(reason="tenant_quota")
    (HTTP: 429 with the reason) while another tenant is admitted; the
    hog's own hysteresis re-admits once ITS depth drains to the
    watermark.  The resident request counts toward its tenant's depth."""
    eng, gate, held = _held(small[2], max_queue_depth=16,
                            max_queue_depth_per_tenant=4, hysteresis=0.5,
                            tenant="hog")
    try:
        backlog = [eng.submit([P + i], max_tokens=2, tenant="hog")
                   for i in range(3)]
        assert not any(f.done() for f in backlog)
        shed = eng.submit([P], max_tokens=2, tenant="hog")
        assert shed.done()
        with pytest.raises(Overloaded) as ei:
            shed.result(0)
        assert not isinstance(ei.value, BreakerOpen)
        assert ei.value.reason == "tenant_quota"
        code, _, body, headers = eng.http_handlers()["/infer"](
            "POST", json.dumps({"input": [P.tolist()], "max_tokens": 2,
                                "tenant": "hog"}).encode())
        assert code == 429 and json.loads(body)["reason"] == "tenant_quota"
        assert int(headers["Retry-After"]) >= 1
        # one token: it finishes at its prefill, so whenever it boards,
        # each released step below retires one hog request
        calm = eng.submit([P + 5], max_tokens=1, tenant="calm")
        assert not calm.done()
        assert eng.session["shed"]["tenant_quota"] == 2
        assert eng.session["shed"]["queue_full"] == 0
        ts = eng.stats()["tenants"]
        assert ts["hog"]["shedding"] is True and ts["hog"]["shed"] == 2
        assert ts["calm"]["shedding"] is False and ts["calm"]["shed"] == 0
        gate.step()                            # held done: hog depth 3
        assert eng.stats()["tenants"]["hog"]["depth"] == 3
        with pytest.raises(Overloaded):
            eng.submit([P], max_tokens=2, tenant="hog").result(0)
        gate.step()                            # hog depth 2: watermark
        assert eng.stats()["tenants"]["hog"]["depth"] == 2
        readmitted = eng.submit([P], max_tokens=2, tenant="hog")
        assert not readmitted.done()
        gate.open()
        assert calm.result(10).shape == (1,)
        for f in [held] + backlog + [readmitted]:
            assert f.result(10).shape == (2,)
    finally:
        gate.open()
        eng.close(drain_timeout_s=5)


def test_breaker_open_half_open_close_cycle(small):
    """A poison-payload tenant (prompts longer than the decoder's one
    prefill bucket: the decoder's ValueError before execution) trips its
    breaker: immediate typed sheds, no slot taken.  After the cooldown one
    half-open probe decides - a poison probe re-opens, a good one closes -
    and other tenants never notice."""
    model = small[2]
    eng = InferenceEngine(decoder=slab(model, max_slots=2,
                                       prefill_buckets=(8,)),
                          breaker_window=8, breaker_threshold=0.5,
                          breaker_min_requests=4, breaker_cooldown_s=30.0)
    poison = np.arange(12) % VOCAB             # 12 > the 8-token bucket
    good = P

    def breaker():
        return eng.stats()["tenants"]["tox"]["breaker"]

    try:
        for _ in range(4):
            with pytest.raises(ValueError, match="bucket"):
                eng.submit([poison], max_tokens=2, tenant="tox").result(10)
        wait_until(lambda: breaker() == "open", what="breaker open")
        allocs = eng.stats()["decode"]["slot_allocs"]
        shed = eng.submit([poison], max_tokens=2, tenant="tox")
        assert shed.done()
        with pytest.raises(BreakerOpen) as ei:
            shed.result(0)
        assert ei.value.reason == "breaker_open"
        assert 0 < ei.value.retry_after_s <= 30.0
        code, _, body = eng.http_handlers()["/infer"]("POST", json.dumps(
            {"input": [good.tolist()], "max_tokens": 2,
             "tenant": "tox"}).encode())[:3]
        assert code == 429 and json.loads(body)["reason"] == "breaker_open"
        assert eng.session["shed"]["breaker_open"] == 2
        assert eng.stats()["decode"]["slot_allocs"] == allocs
        # invisible to other tenants
        assert eng.infer([good], 10, max_tokens=2, tenant="ok").shape == (2,)
        # half-open after the cooldown: a POISON probe runs and re-opens
        _elapse_cooldown(eng, "tox")
        with pytest.raises(ValueError):
            eng.submit([poison], max_tokens=2, tenant="tox").result(10)
        wait_until(lambda: breaker() == "open", what="breaker re-open")
        with pytest.raises(BreakerOpen):
            eng.submit([good], max_tokens=2, tenant="tox").result(0)
        # half-open again: a GOOD probe closes it
        _elapse_cooldown(eng, "tox")
        assert eng.infer([good], 10, max_tokens=2,
                         tenant="tox").shape == (2,)
        wait_until(lambda: breaker() == "closed", what="breaker closed")
        assert eng.infer([good], 10, max_tokens=2,
                         tenant="tox").shape == (2,)
        assert eng.session["shed"]["breaker_open"] == 3
        assert eng.stats()["tenants"]["tox"]["errors"] == 5
    finally:
        eng.close(drain_timeout_s=5)


def test_untagged_traffic_rides_default_tenant_unchanged(small):
    """No tenant anywhere: FIFO within the lane, streams equal to the
    JAX package's ``incremental_generate``, all accounting on
    "default"."""
    topo, params, model = small
    eng, gate, held = _held(model)
    order = []
    prompts = [np.arange(3 + i) % VOCAB for i in range(4)]
    try:
        futs = []
        for i, p in enumerate(prompts):
            f = eng.submit([p], max_tokens=3)
            f.add_done_callback(lambda _, i=i: order.append(i))
            futs.append(f)
        gate.open()
        held.result(10)
        outs = [f.result(10).tolist() for f in futs]
        assert order == [0, 1, 2, 3]
        for p, o in zip(prompts, outs):
            ref = jtr.incremental_generate(topo, params, p[None], max_new=3)
            assert o == ref[0, len(p):].tolist()
        st = eng.stats()
        assert set(st["tenants"]) == {"default"}
        assert st["tenants"]["default"]["requests"] == 5
        assert st["tenants"]["default"]["goodput"] == 5
        assert st["tenant_weights"] == {}
        assert st["max_queue_depth_per_tenant"] == 0
    finally:
        gate.open()
        eng.close(drain_timeout_s=5)


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_shed_reasons_are_canonical_and_exclusive(small):
    """Every shed carries ONE canonical reason matching its exception: a
    drain on a healthy engine sheds EngineClosed / "drain", a close after
    thread death EngineUnhealthy / "thread_death"."""
    model = small[2]
    eng, gate, held = _held(model)
    assert set(eng.session["shed"]) == set(SHED_REASONS)
    queued = [eng.submit([P + i], max_tokens=2) for i in range(3)]
    eng.close(drain_timeout_s=0.3)
    excs = []
    for f in queued + [held]:
        with pytest.raises(ServingError) as ei:
            f.result(1)
        excs.append(ei.value)
    assert all(isinstance(e, EngineClosed)
               and not isinstance(e, EngineUnhealthy) for e in excs)
    counts = eng.session["shed"]
    assert counts["drain"] == len(excs) == sum(counts.values())
    gate.open()

    dec = slab(model, max_slots=1)
    gate2 = Gate(dec)
    eng2 = InferenceEngine(decoder=dec, watchdog_interval_s=0.05)
    first = eng2.submit([P], max_tokens=3)
    resident(eng2, gate2, 1)
    futs = [first] + [eng2.submit([P + i], max_tokens=3) for i in range(2)]

    def die(n, tokens, pos):
        raise SystemExit("injected death")

    gate2.orig = die
    gate2.open()
    for f in futs:
        with pytest.raises(EngineUnhealthy):
            f.result(10)
    eng2.close(drain_timeout_s=0.5)
    counts2 = eng2.session["shed"]
    assert counts2["drain"] == 0
    assert counts2["thread_death"] == 3 == sum(counts2.values())


def test_tenant_id_coercion_and_cardinality_cap(small):
    """Non-string ids key their string form's record (no TypeError), and
    first-seen ids past max_tenants collapse onto "default" (counted)
    while configured tenants always get their own."""
    eng = InferenceEngine(decoder=slab(small[2]),
                          tenant_weights={"vip": 2.0}, max_tenants=3)
    try:
        assert eng.infer([P], 10, max_tokens=2, tenant=5).shape == (2,)
        assert "5" in eng.stats()["tenants"]
        assert eng.infer([P], 10, max_tokens=2, tenant=["a"]).shape == (2,)
        assert eng.infer([P], 10, max_tokens=2,
                         tenant="rando").shape == (2,)
        ts = eng.stats()["tenants"]
        assert "rando" not in ts and "['a']" in ts
        assert eng.session["tenant_overflow"] == 1
        assert ts["default"]["requests"] == 1
        assert eng.infer([P], 10, max_tokens=2, tenant="vip").shape == (2,)
        assert eng.stats()["tenants"]["vip"]["weight"] == 2.0
        code, _, body = eng.http_handlers()["/infer"]("POST", json.dumps(
            {"input": [P.tolist()], "max_tokens": 2,
             "tenant": 5}).encode())[:3]
        assert code == 200
        assert eng.stats()["tenants"]["5"]["requests"] == 2
    finally:
        eng.close(drain_timeout_s=5)


# (lane, tenant, max_tokens) of a scripted queue: DRR costs differ, two
# lanes, the credit after two high pops, an untagged request
SCRIPT = [("normal", "a", 4), ("normal", "a", 4), ("normal", "b", 2),
          ("high", "b", 3), ("normal", "a", 2), ("high", "a", 4),
          ("normal", "b", 5), ("high", "b", 2), ("normal", None, 3),
          ("high", "b", 2), ("normal", "a", 6), ("normal", "b", 2)]


def _boarding_order(engine, gate):
    """Completion order of SCRIPT, queued behind one held request on a
    1-slot engine (one slot: completion order is boarding order)."""
    held = engine.submit([P], max_tokens=2)
    resident(engine, gate, 1)
    order = []
    futs = []
    for i, (lane, tenant, mt) in enumerate(SCRIPT):
        f = engine.submit([P + i], max_tokens=mt, lane=lane, tenant=tenant)
        f.add_done_callback(lambda _, i=i: order.append(i))
        futs.append(f)
    gate.open()
    held.result(60)
    for f in futs:
        f.result(60)
    wait_until(lambda: len(order) == len(SCRIPT), what="every completion")
    return order


def test_boarding_order_matches_jax_engine(small):
    """Lanes, the credit and DRR in decode steps decide one boarding
    order; the JAX engine's and the port's are the same."""
    topo, params, model = small
    kw = dict(tenant_weights={"a": 3.0, "b": 1.0}, starvation_limit=2)
    jdec = jtr.SlotDecoder(topo, params, max_slots=1, decode_kernel="xla")
    jeng = JaxEngine(decoder=jdec, **kw)
    try:
        want = _boarding_order(jeng, Gate(jdec))
    finally:
        jeng.close()
    dec = slab(model, max_slots=1)
    eng = InferenceEngine(decoder=dec, **kw)
    try:
        got = _boarding_order(eng, Gate(dec))
        credit = eng.session["lane_credit_pops"]
    finally:
        eng.close()
    assert got == want
    assert got != sorted(got)                  # not FIFO
    assert credit >= 1


# keys of the JAX decode engine's stats() that belong to unported
# features: the compile cache and mesh slices
LEFT_OUT = {"compile_count", "mesh_slices", "slice_compile_counts",
            "slice_forwards"}


@pytest.mark.parametrize("kind", ("slab", "paged"))
def test_stats_keys_match_jax_decode_engine(small, kind):
    """stats() has the JAX decode engine's keys less LEFT_OUT, its
    ``decode`` and ``shed`` dicts all of theirs, after the same traffic."""
    topo, params, model = small
    if kind == "paged":
        kw = dict(max_slots=2, block_size=8, step_buckets=(2,),
                  chunk_buckets=(8, 16))
        jdec = jtr.PagedDecoder(topo, params, decode_kernel="xla", **kw)
        dec = paged(model, **kw)
    else:
        kw = dict(max_slots=2, step_buckets=(2,), prefill_buckets=(8, 16))
        jdec = jtr.SlotDecoder(topo, params, decode_kernel="xla", **kw)
        dec = slab(model, **kw)
    stats = []
    for engine in (JaxEngine(decoder=jdec), InferenceEngine(decoder=dec)):
        try:
            engine.infer([P], 60, max_tokens=3, tenant="t")
            stats.append(engine.stats())
        finally:
            engine.close()
    want, got = stats
    assert LEFT_OUT <= set(want)
    assert set(got) == set(want) - LEFT_OUT
    assert set(got["decode"]) == set(want["decode"])
    assert set(got["shed"]) == set(want["shed"])
    assert set(got["tenants"]["t"]) == set(want["tenants"]["t"])
    json.dumps(got)
    for key in ("requests", "rows", "goodput", "iterations", "tokens",
                "slot_allocs", "slot_frees", "slot_steps", "errors"):
        assert got[key] == want[key], key
    for key in ("tokens", "iterations", "slots_occupied", "max_slots",
                "step_buckets", "prefill_buckets", "policy",
                "tokens_per_iteration", "slot_utilization_pct",
                "kv_utilization_pct"):
        assert got["decode"][key] == want["decode"][key], key


def test_concurrent_submitters_all_resolve_once(small):
    """Eight threads submitting across tenants and lanes against a small
    queue cap: every future resolves exactly once, tenant depths return
    to zero, and served + shed + errors add up."""
    eng = InferenceEngine(decoder=slab(small[2], max_slots=2),
                          max_queue_depth=4,
                          tenant_weights={"a": 2.0, "b": 1.0},
                          max_queue_depth_per_tenant=0.5)
    futs = []
    lock = threading.Lock()

    def client(k):
        for i in range(6):
            f = eng.submit([P + (i % 3)], max_tokens=2,
                           tenant="ab"[k % 2], lane=LANES[i % 2])
            with lock:
                futs.append(f)

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        served = shed = 0
        for f in futs:
            try:
                assert f.result(60).shape == (2,)
                served += 1
            except Overloaded:
                shed += 1
        st = eng.stats()
        assert served + shed == len(futs) == 48
        assert st["requests"] == served
        assert sum(st["shed"].values()) == shed
        assert all(t["depth"] == 0 for t in st["tenants"].values())
        assert st["decode"]["slots_occupied"] == 0
    finally:
        eng.close()
