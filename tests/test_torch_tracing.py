"""Distributed tracing on the port (``observability/tracectx.py``, the
engine, router and client edges) against ``tests/test_tracing_distributed.py``
and the JAX package: ``TraceContext.parse`` / ``to_header`` agree with the
JAX package's on a grid of headers, garbage included; span buffers,
``render_tree`` and ``spans_to_chrome`` give the JAX package's output for
the same spans; the engine honours an upstream header and mints for
untagged traffic; the flight recorder keeps an unsampled shed, and its
rows' reasons equal the JAX engine's for the same shed and deadline;
the client stamps each attempt and records failovers; the router parents
replica spans under its forwards, survives a dead socket under one trace
and stitches ``/trace/<id>`` from router, replica and client spans; the
fleet rollup labels every row; and a paged engine's counters (requests,
sheds and slot frees by reason, slot allocs, decode tokens, prefix hits)
and greedy streams equal the JAX engine's after the same requests.
Counts, ids and texts are compared exactly.
"""

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu.observability import tracectx as jtc
from paddle_tpu_torch.core.ir import reset_name_counters as reset_port_names
from paddle_tpu_torch.observability import tracectx
from paddle_tpu_torch.serving import InferenceEngine, Router, ServingClient
from paddle_tpu_torch.serving.client import _TransportError


@pytest.fixture(autouse=True)
def _fresh_store():
    tracectx.STORE.clear()
    jtc.STORE.clear()
    yield
    tracectx.STORE.clear()
    jtc.STORE.clear()


def _mlp(name):
    reset_port_names()
    pt.init(seed=0, device="cpu")
    x = pt.layer.data("x", pt.data_type.dense_vector(4))
    out = pt.layer.fc(x, size=2, act="softmax", name=f"{name}_out")
    return out, pt.parameters.create(pt.Topology(out), device="cpu")


def _infer_body(width=4):
    return json.dumps({"input": [[[0.5] * width]]}).encode()


def _wait(predicate, timeout_s=10.0):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


# ------------------------------------------------------------ the wire
_T, _S = "0123456789abcdef", "fedcba9876543210"
HEADERS = [None, "", f"{_T}-{_S}-1", f"{_T}-{_S}-0", f"{_T}--1",
           f"{_T.upper()}-{_S}-1", "zz-aa-1", "abc", "a-b-c-d", "a-b-2",
           "g" * 16 + "-" + "0" * 16 + "-1", f"{_T}-{_S}-2",
           f" {_T}-{_S}-1 ", f"{_T}{_T}-{_S}-1", f"{_T}-{_S}"]


@pytest.mark.parametrize("header", HEADERS,
                         ids=[repr(h) for h in HEADERS])
def test_header_parse_and_to_header_agree_with_jax(header):
    want = jtc.TraceContext.parse(header)
    got = tracectx.TraceContext.parse(header)
    assert (got is None) == (want is None)
    if want is not None:
        assert (got.trace_id, got.parent_span_id, got.sampled) == (
            want.trace_id, want.parent_span_id, want.sampled)
        assert got.to_header() == want.to_header()
        assert got.child("ab" * 8).to_header() == \
            want.child("ab" * 8).to_header()


def test_mint_child_and_span_buffer():
    ctx = tracectx.mint(1.0)
    assert ctx.sampled and not tracectx.mint(0.0).sampled
    child = ctx.child("ab" * 8)
    assert tracectx.TraceContext.parse(child.to_header()).parent_span_id \
        == "ab" * 8
    buf = tracectx.SpanBuffer(ctx, "engine/request", role="replica")
    with buf.span("engine/forward", rows=2) as sp:
        inner = sp.id
    spans = buf.finish("ok")
    assert buf.finish("error") is spans
    root = spans[-1]
    assert root["name"] == "engine/request" and \
        root["args"]["outcome"] == "ok"
    assert spans[0]["span_id"] == inner and \
        spans[0]["parent_id"] == root["span_id"]
    assert {s["trace_id"] for s in spans} == {ctx.trace_id}


def test_render_tree_and_chrome_export_equal_the_jax_packages():
    ctx = jtc.mint(1.0)
    buf = jtc.SpanBuffer(ctx, "client/infer", role="client", tenant="t")
    with buf.span("client/attempt", endpoint="http://x"):
        buf.event("client/failover", endpoint="http://y")
    spans = buf.finish("ok", latency_us=12.5)
    assert tracectx.render_tree(spans) == jtc.render_tree(spans)
    assert tracectx.spans_to_chrome(spans) == jtc.spans_to_chrome(spans)


def test_trace_http_handler_query_ingest_and_validation():
    ctx = tracectx.mint(1.0)
    spans = tracectx.SpanBuffer(ctx, "client/infer", role="client") \
        .finish("ok")
    res = tracectx.http_trace_handler("POST",
                                      json.dumps({"spans": spans}).encode())
    assert res[0] == 200
    for rest in (ctx.trace_id, f"id={ctx.trace_id}"):
        doc = json.loads(tracectx.http_trace_handler("GET", b"", None,
                                                     rest)[2])
        assert [s["span_id"] for s in doc["spans"]] == [spans[0]["span_id"]]
    assert ctx.trace_id in json.loads(
        tracectx.http_trace_handler("GET", b"")[2])["traces"]
    for bad in (b"{", b"[1]", b'"x"',
                json.dumps({"spans": [{"nope": 1}]}).encode()):
        assert tracectx.http_trace_handler("POST", bad)[0] == 400


# -------------------------------------------------------- engine edge
def test_engine_header_precedence_and_untagged_minting():
    out, params = _mlp("prec")
    with InferenceEngine(out, params, max_batch=2, max_wait_us=100,
                         trace_sample=1.0) as eng:
        h = eng.http_handlers()["/infer"]
        ctx = tracectx.mint(1.0).child("cd" * 8)
        assert h("POST", _infer_body(),
                 {"X-Ptpu-Trace": ctx.to_header()})[0] == 200
        spans = tracectx.STORE.get(ctx.trace_id)
        assert {"engine/request", "engine/queue_wait", "engine/forward",
                "engine/delivery"} <= {s["name"] for s in spans}
        root = [s for s in spans if s["name"] == "engine/request"][0]
        assert root["parent_id"] == "cd" * 8 and root["role"] == "replica"
        before = set(tracectx.STORE.recent_ids(64))
        assert h("POST", _infer_body(), {})[0] == 200
        minted = set(tracectx.STORE.recent_ids(64)) - before
        assert len(minted) == 1 and minted != {ctx.trace_id}
        st = eng.stats()
        assert st["trace"]["sample"] == 1.0
        assert st["trace"]["captured"]["sampled"] >= 2


def test_engine_tracing_disabled_is_inert():
    out, params = _mlp("off")
    with InferenceEngine(out, params, max_batch=2, max_wait_us=100) as eng:
        handlers = eng.http_handlers()
        assert handlers["/infer"]("POST", _infer_body(), {})[0] == 200
        assert "trace" not in eng.stats()
        assert tracectx.STORE.recent_ids() == []
        assert "/trace" not in handlers and "/trace/" not in handlers


def test_flight_recorder_captures_shed_unsampled(tmp_path):
    out, params = _mlp("shed")
    eng = InferenceEngine(out, params, max_batch=1, max_wait_us=100,
                          max_queue_depth=2, hysteresis=0.5,
                          trace_sample=0.0, telemetry_dir=str(tmp_path))
    sem = threading.Semaphore(0)
    orig = eng._inf.run_feed
    eng._inf.run_feed = lambda feed, params=None: (
        sem.acquire(), orig(feed, params=params))[1]
    h = eng.http_handlers()["/infer"]
    try:
        held = eng.submit([(np.zeros(4, np.float32),)])
        _wait(lambda: eng.queue_depth() == 0)
        backlog = [eng.submit([(np.zeros(4, np.float32),)])
                   for _ in range(2)]
        assert eng.queue_depth() == 2
        ctx = tracectx.TraceContext(tracectx.new_span_id(), "",
                                    sampled=False)
        assert h("POST", _infer_body(),
                 {"X-Ptpu-Trace": ctx.to_header()})[0] == 429
        spans = tracectx.STORE.get(ctx.trace_id)
        shed = [s for s in spans if s["name"] == "engine/shed"]
        assert shed and shed[0]["args"]["reason"] == "queue_full"
        tracectx.FLIGHT_WRITER.drain()
        recs = [json.loads(ln) for ln in
                open(eng._flight.flight_path).read().splitlines()]
        assert [r["reason"] for r in recs
                if r["trace_id"] == ctx.trace_id] == ["shed"]
        assert os.path.basename(eng._flight.flight_path) == \
            f"flight-{os.getpid()}.jsonl"
        for _ in range(8):
            sem.release()
        held.result(30)
        for f in backlog:
            f.result(30)
        assert h("POST", _infer_body(), {})[0] == 200
        assert eng._flight.stats()["captured"]["sampled"] == 0
    finally:
        for _ in range(32):
            sem.release()
        eng.close(drain_timeout_s=5)


# -------------------------------------------------------- client edge
def test_client_spans_failover_and_per_endpoint_stats():
    seen = []

    def transport(url, body, headers, timeout_s):
        seen.append((url, dict(headers)))
        if "dead" in url:
            raise _TransportError("refused")
        return (200, {}, json.dumps({"outputs": {"y": [[1.0]]}}).encode())

    c = ServingClient(["http://dead", "http://live"], transport=transport,
                      max_attempts=3, backoff_base_s=0.0, trace_sample=1.0)
    assert c.infer([[0.5]], tenant="t0")["y"].tolist() == [[1.0]]
    st = c.stats()
    assert st["endpoints"]["http://dead"]["connect_errors"] == 1
    assert st["endpoints"]["http://live"]["failovers"] == 1
    hdrs = [tracectx.TraceContext.parse(h[tracectx.HEADER]) for _, h in seen]
    assert len({x.trace_id for x in hdrs}) == 1
    assert len({x.parent_span_id for x in hdrs}) == 2
    spans = tracectx.STORE.get(hdrs[0].trace_id)
    names = [s["name"] for s in spans]
    assert names.count("client/attempt") == 2
    assert "client/failover" in names and "client/infer" in names
    att = {s["span_id"]: s for s in spans if s["name"] == "client/attempt"}
    assert set(att) == {x.parent_span_id for x in hdrs}
    assert sorted(str(a["args"]["status"]) for a in att.values()) == [
        "200", "connect_error"]
    assert {s["role"] for s in spans} == {"client"}


def test_client_env_sample_garbage_and_off_path(monkeypatch):
    monkeypatch.setenv(tracectx.ENV_SAMPLE, "off")
    with pytest.warns(UserWarning, match="non-numeric"):
        assert ServingClient("http://x").trace_sample is None
    monkeypatch.setenv(tracectx.ENV_SAMPLE, "0.25")
    assert ServingClient("http://x").trace_sample == 0.25
    monkeypatch.delenv(tracectx.ENV_SAMPLE)

    def transport(url, body, headers, timeout_s):
        assert tracectx.HEADER not in headers
        return (200, {}, json.dumps({"outputs": {"y": [[1.0]]}}).encode())

    c = ServingClient("http://x", transport=transport)
    c.infer([[0.5]])
    assert tracectx.STORE.recent_ids() == []


def test_client_shed_trace_kept_unsampled():
    def transport(url, body, headers, timeout_s):
        ctx = tracectx.TraceContext.parse(headers[tracectx.HEADER])
        assert ctx is not None and not ctx.sampled
        transport.tid = ctx.trace_id
        return (429, {}, json.dumps(
            {"error": "overloaded", "retry_after_s": 0.0}).encode())

    c = ServingClient("http://x", transport=transport, max_attempts=2,
                      backoff_base_s=0.0, trace_sample=0.0)
    with pytest.raises(Exception):
        c.infer([[0.5]], deadline_s=5.0)
    spans = tracectx.STORE.get(transport.tid)
    root = [s for s in spans if s["name"] == "client/infer"][0]
    assert root["args"]["outcome"] == "shed"
    assert c.stats()["endpoints"]["http://x"]["sheds"] == 2


# -------------------------------------------------------- router edge
class _FakeReplicaHTTP:
    """A replica that answers /healthz, /stats and /infer, and records the
    trace headers it is sent."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        fake = self
        self.seq = 0
        self.trace_headers = []

        class H(BaseHTTPRequestHandler):
            def _send(self, code, body):
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/healthz":
                    self._send(200, b'"ok"')
                elif path == "/stats":
                    fake.seq += 1
                    self._send(200, json.dumps(
                        {"queue_depth": 0, "snapshot_seq": fake.seq,
                         "uptime_s": 1.0}).encode())
                else:
                    self._send(404, b"{}")

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                if n:
                    self.rfile.read(n)
                fake.trace_headers.append(self.headers.get(tracectx.HEADER))
                self._send(200, json.dumps(
                    {"outputs": {"out": [[1.0]]}}).encode())

            def log_message(self, *a):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.server.daemon_threads = True
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.server.server_port}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def test_router_failover_two_forward_spans_one_trace():
    a, b = _FakeReplicaHTTP(), _FakeReplicaHTTP()
    try:
        with Router([a.url, b.url], poll_interval_s=2.0, staleness_s=10.0,
                    probe_backoff_s=5.0, trace_sample=1.0) as router:
            assert router.replicas_up() == 2
            a.close()
            found = None
            for _ in range(12):
                ctx = tracectx.mint(1.0)
                assert router.handle_infer(
                    "POST", _infer_body(1),
                    {"X-Ptpu-Trace": ctx.to_header()})[0] == 200
                spans = tracectx.STORE.get(ctx.trace_id)
                if "router/failover" in [s["name"] for s in spans]:
                    found = spans
                    break
            assert found is not None, "no request exercised failover"
            fwd = [s for s in found if s["name"] == "router/forward"]
            assert sorted(str(f["args"]["status"]) for f in fwd) == [
                "200", "dead_socket"]
            assert len({s["trace_id"] for s in found}) == 1
            got = tracectx.TraceContext.parse(b.trace_headers[-1])
            ok_fwd = [f for f in fwd if f["args"]["status"] == 200][0]
            assert got.parent_span_id == ok_fwd["span_id"]
    finally:
        b.close()


def test_router_shed_no_replica_tail_captured():
    with Router([], poll_interval_s=0.05, staleness_s=0.5,
                trace_sample=0.0) as router:
        ctx = tracectx.TraceContext(tracectx.new_span_id(), "", False)
        assert router.handle_infer("POST", _infer_body(1),
                                   {"X-Ptpu-Trace": ctx.to_header()})[0] \
            == 503
        spans = tracectx.STORE.get(ctx.trace_id)
        assert "router/shed" in [s["name"] for s in spans]
        root = [s for s in spans if s["name"] == "router/infer"][0]
        assert root["args"]["outcome"] == "shed"
        assert router.stats()["trace"]["captured"]["shed"] == 1


def test_router_assembly_merges_local_replica_and_client_spans():
    out, params = _mlp("asm")
    eng = InferenceEngine(out, params, max_batch=2, max_wait_us=100,
                          trace_sample=1.0)
    url = f"http://127.0.0.1:{eng.serve(0).server_port}"
    try:
        with Router([url], poll_interval_s=0.05, staleness_s=2.0,
                    trace_sample=1.0) as router:
            assert _wait(lambda: router.replicas_up() == 1)
            ctx = tracectx.mint(1.0)
            assert router.handle_infer(
                "POST", _infer_body(),
                {"X-Ptpu-Trace": ctx.to_header()})[0] == 200
            pushed = tracectx.SpanBuffer(ctx, "client/infer",
                                         role="client").finish("ok")
            urllib.request.urlopen(urllib.request.Request(
                url + "/trace", method="POST",
                data=json.dumps({"spans": pushed}).encode()),
                timeout=5).read()
            doc = json.loads(router.handle_trace("GET", b"", None,
                                                 ctx.trace_id)[2])
            assert {"router", "replica", "client"} <= {
                s["role"] for s in doc["spans"]}
            assert {"router/infer", "router/forward", "engine/request",
                    "engine/queue_wait", "client/infer"} <= {
                s["name"] for s in doc["spans"]}
            assert doc["sources"]["router"] >= 2 and \
                doc["sources"][url] >= 5
            starts = [s["start_us"] for s in doc["spans"]]
            assert starts == sorted(starts)
    finally:
        eng.close(drain_timeout_s=5)


def test_metrics_fleet_rollup_labels_every_row():
    from paddle_tpu_torch import observability as obs

    obs.enable()
    try:
        out, params = _mlp("roll")
        eng = InferenceEngine(out, params, max_batch=2, max_wait_us=100)
        url = f"http://127.0.0.1:{eng.serve(0).server_port}"
        try:
            with Router([url], poll_interval_s=0.05,
                        staleness_s=2.0) as router:
                assert _wait(lambda: router.replicas_up() == 1)
                text = router.handle_metrics("GET", b"", None,
                                             "fleet=1")[2].decode()
                assert f'replica="{url}"' in text and \
                    'replica="router"' in text
                assert "# fleet rollup: 1 replica(s) polled, 0 " \
                       "unreachable" in text
                assert 'replica="' not in router.handle_metrics(
                    "GET", b"", None, "")[2].decode()
                assert router.handle_metrics("POST", b"", None,
                                             "fleet=1")[0] == 405
                # the poller sets the gauge a tick after the probe
                assert _wait(lambda: obs.REGISTRY.value(
                    "router_replicas_up") == 1)
        finally:
            eng.close(drain_timeout_s=5)
    finally:
        obs.disable()
        obs.reset()


# ------------------------------------------- the paged engine, both packages
DECODE_COUNTERS = (
    ("serving_requests_total", {}), ("serving_decode_tokens_total", {}),
    ("serving_decode_iterations_total", {}),
    ("serving_decode_slot_allocs_total", {}),
    ("serving_prefix_hits_total", {}), ("serving_prefix_blocks_shared", {}),
    ("serving_goodput_total", {}),
) + tuple(("serving_shed_total", {"reason": r})
          for r in ("queue_full", "deadline", "kv_blocks")) \
  + tuple(("serving_decode_slot_frees_total", {"reason": r})
          for r in ("finished", "deadline", "error"))


def _drive_paged(eng, prompts):
    out = [eng.infer([p], 60, max_tokens=4).tolist() for p in prompts]
    fut = eng.submit([prompts[0]], max_tokens=4, deadline_us=1)
    with pytest.raises(Exception, match="eadline"):
        fut.result(60)
    return out


def test_paged_engine_counters_and_streams_match_jax():
    """The same greedy requests (a prompt sharing two KV blocks with an
    earlier one) and one 1-µs deadline on a paged engine: the port's
    ``serving_*`` counters and token streams equal the JAX engine's."""
    from paddle_tpu import observability as jobs
    from paddle_tpu.models import transformer as jtr
    from paddle_tpu.serving import InferenceEngine as JaxEngine
    from paddle_tpu_torch import observability as tobs
    from paddle_tpu_torch.models import transformer as ttr
    from torch_serving_helpers import HEADS, lm, paged

    topo, params, values = lm()
    base = list(range(1, 17))
    prompts = [np.array(base, np.int32), np.array(base + [20, 21], np.int32),
               np.array([5, 6, 7], np.int32)]
    kw = dict(max_slots=2, block_size=8, step_buckets=(2,),
              chunk_buckets=(8, 16))
    got = []
    for obs, make in (
            (jobs, lambda: JaxEngine(decoder=jtr.PagedDecoder(
                topo, params, decode_kernel="xla", **kw))),
            (tobs, lambda: InferenceEngine(decoder=paged(
                ttr.params_from_jax(values, num_heads=HEADS), **kw)))):
        obs.reset()
        obs.enable()
        try:
            eng = make()
            try:
                streams = _drive_paged(eng, prompts)
            finally:
                eng.close()
            got.append((streams, {(n, tuple(l.items())):
                                  obs.REGISTRY.value(n, **l)
                                  for n, l in DECODE_COUNTERS}))
        finally:
            obs.disable()
            obs.reset()
    (jstreams, jc), (tstreams, tc) = got
    assert tstreams == jstreams
    assert tc == jc
    assert jc[("serving_prefix_hits_total", ())] == 1
    assert jc[("serving_shed_total", (("reason", "deadline"),))] == 1
    assert jc[("serving_decode_tokens_total", ())] > 0


def test_flight_rows_reasons_match_jax_and_decode_spans(tmp_path):
    """A traced paged engine: a greedy request's trace holds the queue
    wait, prefill and decode spans under one id; a 1 ms deadline is kept
    with reason ``deadline``, as the JAX engine keeps it."""
    from paddle_tpu.models import transformer as jtr
    from paddle_tpu.serving import InferenceEngine as JaxEngine
    from paddle_tpu_torch.models import transformer as ttr
    from torch_serving_helpers import HEADS, lm, paged

    topo, params, values = lm()
    kw = dict(max_slots=2, block_size=8, step_buckets=(2,),
              chunk_buckets=(8, 16))
    body_ok = json.dumps({"input": [[1, 2, 3]], "max_tokens": 3}).encode()
    body_late = json.dumps({"input": [[1, 2, 3]], "max_tokens": 30,
                            "deadline_ms": 1}).encode()
    reasons = []
    for tc, make, d in (
            (jtc, lambda d: JaxEngine(
                decoder=jtr.PagedDecoder(topo, params, decode_kernel="xla",
                                         **kw),
                trace_sample=1.0, telemetry_dir=d), "j"),
            (tracectx, lambda d: InferenceEngine(
                decoder=paged(ttr.params_from_jax(values, num_heads=HEADS),
                              **kw),
                trace_sample=1.0, telemetry_dir=d), "t")):
        d = str(tmp_path / d)
        eng = make(d)
        try:
            h = eng.http_handlers()["/infer"]
            ctx = tc.mint(1.0)
            assert h("POST", body_ok,
                     {"X-Ptpu-Trace": ctx.to_header()})[0] == 200
            names = [s["name"] for s in tc.STORE.get(ctx.trace_id)]
            late = tc.mint(1.0)
            assert h("POST", body_late,
                     {"X-Ptpu-Trace": late.to_header()})[0] == 504
        finally:
            eng.close()
        tc.FLIGHT_WRITER.drain()
        recs = [json.loads(ln) for ln in open(os.path.join(
            d, f"flight-{os.getpid()}.jsonl")).read().splitlines()]
        reasons.append([(r["trace_id"] == late.trace_id, r["reason"],
                         r["outcome"]) for r in recs])
        assert {"engine/request", "engine/queue_wait", "engine/prefill",
                "engine/decode"} <= set(names)
    assert reasons[1] == reasons[0]
    assert (True, "deadline", "deadline") in reasons[1]
