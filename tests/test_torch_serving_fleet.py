"""The port's fleet tier (``paddle_tpu_torch/serving/router.py`` and
``fleet.py``): the contracts of ``tests/test_serving_fleet.py`` that need
no compile cache, held on the port.  The Router's P2C balancing,
health and staleness eviction, dead-socket failover with its backoff
re-probe, the global tenant quota with the engine's tenant precedence,
429 and Retry-After passed through, the typed ``no_replica`` 503 and the
deadline bounding failover run against fake replica servers (stdlib
HTTP, at fake-server speed) and against in-process port engines; one
real ``serve --model`` replica process registers with a router on start,
answers through it, and deregisters on drain."""

import json
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.serving import (InferenceEngine, Router,
                                      ServingClient, fleet)
from paddle_tpu_torch.serving.router import (PICK_POLICIES,
                                             ROUTER_SHED_REASONS)


# ------------------------------------------------------- fake replicas

class FakeReplica:
    """A stdlib HTTP server speaking just enough of the replica
    contract (/healthz, /stats with snapshot_seq/uptime_s/queue_depth,
    POST /infer) for router tests — all knobs are plain attributes
    mutated by the test."""

    def __init__(self, depth=0, healthz=200, infer_status=200,
                 infer_delay_s=0.0, retry_after_s=None,
                 freeze_seq=False, truncate_response=False, port=0,
                 poll_delay_s=0.0):
        self.depth = depth
        self.healthz = healthz
        self.infer_status = infer_status
        self.infer_delay_s = infer_delay_s
        self.retry_after_s = retry_after_s
        self.freeze_seq = freeze_seq
        self.truncate_response = truncate_response
        self.poll_delay_s = poll_delay_s
        self.served = 0
        self.tenants = []
        self.seq = 0
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        fake = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code, body, headers=None):
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if fake.poll_delay_s:
                    # blackholed-host stand-in: the router's probe
                    # hangs for this long before an answer arrives
                    time.sleep(fake.poll_delay_s)
                if path == "/healthz":
                    code = fake.healthz
                    self._send(code, b'"ok"' if code == 200
                               else b'"overloaded"')
                elif path == "/stats":
                    with fake._lock:
                        if not fake.freeze_seq:
                            fake.seq += 1
                        doc = {"queue_depth": fake.depth,
                               "snapshot_seq": fake.seq,
                               "uptime_s": round(
                                   time.perf_counter() - fake._t0, 3),
                               "health": "ok"}
                    self._send(200, json.dumps(doc).encode())
                else:
                    self._send(404, b"{}")

            def do_POST(self):
                path = self.path.split("?", 1)[0]
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                if path != "/infer":
                    self._send(404, b"{}")
                    return
                if fake.infer_delay_s:
                    time.sleep(fake.infer_delay_s)
                try:
                    doc = json.loads(body or b"{}")
                except ValueError:
                    doc = {}
                with fake._lock:
                    fake.served += 1
                    fake.tenants.append(
                        doc.get("tenant")
                        or self.headers.get("X-Ptpu-Tenant"))
                if fake.truncate_response:
                    # mid-response death: promise more bytes than are
                    # sent, then drop the socket — the client's READ
                    # dies, not its connect
                    payload = b'{"outputs": {"out": [[1.0'
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/json")
                    self.send_header("Content-Length",
                                     str(len(payload) + 64))
                    self.end_headers()
                    self.wfile.write(payload)
                    self.wfile.flush()
                    self.connection.close()
                    return
                st = fake.infer_status
                if st == 200:
                    self._send(200, json.dumps(
                        {"outputs": {"out": [[1.0]]}}).encode())
                else:
                    hdrs = {}
                    doc = {"error": "overloaded",
                           "reason": "tenant_quota"}
                    if fake.retry_after_s is not None:
                        doc["retry_after_s"] = fake.retry_after_s
                        hdrs["Retry-After"] = str(int(
                            fake.retry_after_s))
                    self._send(st, json.dumps(doc).encode(), hdrs)

            def log_message(self, *a):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.server.daemon_threads = True
        self._thread = threading.Thread(
            target=self.server.serve_forever, daemon=True)
        self._thread.start()
        self.port = self.server.server_port
        self.url = f"http://127.0.0.1:{self.port}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def _wait(predicate, timeout_s=5.0, interval_s=0.02):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        if predicate():
            return True
        time.sleep(interval_s)
    return predicate()


def _infer_doc(tenant=None, deadline_ms=None, dim=1):
    doc = {"input": [[[0.5] * dim]]}
    if tenant:
        doc["tenant"] = tenant
    if deadline_ms:
        doc["deadline_ms"] = deadline_ms
    return json.dumps(doc).encode()


# ------------------------------------------------------------- routing

def test_p2c_prefers_shallower_replica():
    """Power-of-two-choices over polled /stats depth: with one shallow
    and one deep replica every pick lands on the shallow one."""
    shallow, deep = FakeReplica(depth=0), FakeReplica(depth=64)
    try:
        with Router([shallow.url, deep.url],
                    poll_interval_s=0.02, staleness_s=1.0) as router:
            assert _wait(lambda: router.replicas_up() == 2)
            for _ in range(20):
                res = router.handle_infer("POST", _infer_doc(), None)
                assert res[0] == 200
            assert shallow.served == 20
            assert deep.served == 0
            st = router.stats()
            assert st["picks"]["p2c"] == 20
            assert st["replicas"][shallow.url]["forwards"] == 20
            # the whole policy enum is accounted for
            assert set(st["picks"]) == set(PICK_POLICIES)
    finally:
        shallow.close()
        deep.close()


def test_unhealthy_healthz_leaves_and_rejoins_rotation():
    """A 503 /healthz (overload, drain) evicts immediately and rejoins
    the moment the probe sees 200 again — no backoff penalty, the
    socket was never dead."""
    a, b = FakeReplica(), FakeReplica()
    try:
        with Router([a.url, b.url], poll_interval_s=0.02,
                    staleness_s=1.0) as router:
            assert _wait(lambda: router.replicas_up() == 2)
            a.healthz = 503
            assert _wait(lambda: router.replicas_up() == 1)
            for _ in range(6):
                assert router.handle_infer(
                    "POST", _infer_doc(), None)[0] == 200
            assert a.served == 0 and b.served == 6
            a.healthz = 200
            assert _wait(lambda: router.replicas_up() == 2)
    finally:
        a.close()
        b.close()


def test_staleness_evicts_wedged_replica_and_recovers():
    """A replica whose /stats progress seq stops advancing WHILE work
    is queued (wedged — its HTTP thread answers but the engine
    resolves nothing) ages out of rotation at staleness_s even though
    every poll still succeeds; when the seq moves again it rejoins.
    An idle replica (frozen seq, empty queue) must NOT be evicted."""
    a, b = FakeReplica(), FakeReplica()
    try:
        with Router([a.url, b.url], poll_interval_s=0.02,
                    staleness_s=0.5) as router:
            assert _wait(lambda: router.replicas_up() == 2)
            # frozen seq with an EMPTY queue = idle, stays in rotation
            a.freeze_seq = True
            time.sleep(1.0)
            assert router.replicas_up() == 2
            # frozen seq with QUEUED work = wedged, ages out
            a.depth = 7
            assert _wait(lambda: router.replicas_up() == 1, 3.0)
            assert router.stats()["replicas"][a.url]["state"] == "wedged"
            for _ in range(4):
                assert router.handle_infer(
                    "POST", _infer_doc(), None)[0] == 200
            assert a.served == 0 and b.served == 4
            a.freeze_seq = False
            a.depth = 0
            assert _wait(lambda: router.replicas_up() == 2, 3.0)
    finally:
        a.close()
        b.close()


def test_dead_socket_fails_over_and_reprobes_on_backoff():
    """Killing a replica's socket mid-rotation: the next forward to it
    marks it down IMMEDIATELY and the request fails over to the
    survivor (no client-visible error); the downed endpoint re-probes
    on the backoff schedule and rejoins when it answers again."""
    a, b = FakeReplica(), FakeReplica()
    a_port = a.port
    try:
        # the poller is deliberately SLOW (2 s): the dead socket must
        # be discovered by a FORWARD, not a lucky poll racing ahead of
        # the requests — the mark-down-at-forward path under test
        with Router([a.url, b.url], poll_interval_s=2.0,
                    staleness_s=6.0, probe_backoff_s=0.05) as router:
            assert router.replicas_up() == 2
            a.close()                   # SIGKILL stand-in: dead socket
            ok = sheds = 0
            for _ in range(12):
                res = router.handle_infer("POST", _infer_doc(), None)
                if res[0] == 200:
                    ok += 1
                else:
                    sheds += 1
            # every request answered by the survivor — the failover
            # happened INSIDE the request, nothing surfaced untyped
            assert ok == 12 and sheds == 0
            st = router.stats()
            assert st["failovers"] >= 1
            assert st["replicas"][a.url]["state"] == "dead"
            # resurrect on the SAME port (allow_reuse_address is the
            # HTTPServer default): the backoff re-probe readmits it
            # at a later poller tick
            revived = FakeReplica(port=a_port)
            try:
                assert _wait(lambda: router.replicas_up() == 2, 8.0,
                             interval_s=0.1)
                assert router.stats()["replicas"][a.url]["state"] == "ok"
            finally:
                revived.close()
    finally:
        b.close()


def test_global_tenant_quota_sheds_hog_not_neighbor():
    """The router-enforced GLOBAL quota: a hog holding tenant_quota
    in-flight requests fleet-wide sheds with the typed
    tenant_quota_global 429 BEFORE any replica sees the request, while
    another tenant's traffic keeps flowing."""
    rep = FakeReplica(infer_delay_s=0.25)
    try:
        with Router([rep.url], poll_interval_s=0.02, staleness_s=1.0,
                    tenant_quota=2) as router:
            assert _wait(lambda: router.replicas_up() == 1)
            results = []
            lock = threading.Lock()

            def hog_call():
                res = router.handle_infer(
                    "POST", _infer_doc(tenant="hog"), None)
                with lock:
                    results.append(res)

            threads = [threading.Thread(target=hog_call)
                       for _ in range(6)]
            for t in threads:
                t.start()
            # while the hog's in-flight calls hold the quota, a shed
            # is instant and typed, and the neighbor still gets served
            assert _wait(lambda: len(results) >= 1, 5.0)
            wb = router.handle_infer(
                "POST", _infer_doc(tenant="wb"), None)
            assert wb[0] == 200
            for t in threads:
                t.join(10)
            sheds = [r for r in results if r[0] == 429]
            served = [r for r in results if r[0] == 200]
            assert sheds, "hog never hit the global quota"
            body = json.loads(sheds[0][2])
            assert body["reason"] == "tenant_quota_global"
            assert sheds[0][3]["Retry-After"]
            st = router.stats()
            assert st["tenants"]["hog"]["shed"] == len(sheds)
            assert st["shed"]["tenant_quota_global"] == len(sheds)
            assert st["tenants"]["wb"]["shed"] == 0
            assert set(st["shed"]) == set(ROUTER_SHED_REASONS)
            # hysteresis: with the backlog drained the hog re-admits
            assert _wait(lambda: router.stats()["tenants"]["hog"]
                         ["depth"] == 0)
            again = router.handle_infer(
                "POST", _infer_doc(tenant="hog"), None)
            assert again[0] == 200
            assert rep.served == len(served) + 2
    finally:
        rep.close()


def test_global_gate_tenant_precedence_matches_engine():
    """The router's global gate resolves the tenant with the ENGINE's
    precedence (body field first, header fallback): a hog pinning its
    body tenant while rotating X-Ptpu-Tenant headers is still billed
    as ONE tenant at the router, so it cannot split its accounting
    between the two tiers to dodge the global quota."""
    rep = FakeReplica(infer_delay_s=0.25)
    try:
        with Router([rep.url], poll_interval_s=0.02, staleness_s=1.0,
                    tenant_quota=2) as router:
            assert _wait(lambda: router.replicas_up() == 1)
            results = []
            lock = threading.Lock()

            def hog_call(i):
                res = router.handle_infer(
                    "POST", _infer_doc(tenant="hog"),
                    {"X-Ptpu-Tenant": f"rotated{i}"})
                with lock:
                    results.append(res)

            threads = [threading.Thread(target=hog_call, args=(i,))
                       for i in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(10)
            sheds = [r for r in results if r[0] == 429]
            assert sheds, "rotating headers dodged the global quota"
            st = router.stats()
            assert st["tenants"]["hog"]["shed"] == len(sheds)
            assert not any(t.startswith("rotated")
                           for t in st["tenants"])
            # header-only tenancy still works as the fallback
            res = router.handle_infer("POST", _infer_doc(),
                                      {"X-Ptpu-Tenant": "hdr_only"})
            assert res[0] == 200
            assert router.stats()["tenants"]["hdr_only"]["admitted"] == 1
    finally:
        rep.close()


def test_replica_429_and_retry_after_map_through_unchanged():
    """A replica's own shed (429 + Retry-After + reason body) passes
    through the router verbatim — the client retry contract survives
    the extra hop."""
    rep = FakeReplica(infer_status=429, retry_after_s=7)
    try:
        with Router([rep.url], poll_interval_s=0.02,
                    staleness_s=1.0) as router:
            assert _wait(lambda: router.replicas_up() == 1)
            res = router.handle_infer("POST", _infer_doc(), None)
            assert res[0] == 429
            assert json.loads(res[2])["reason"] == "tenant_quota"
            assert res[3]["Retry-After"] == "7"
    finally:
        rep.close()


def test_no_replica_sheds_typed_retryable():
    """An empty (or fully-down) rotation answers a typed retryable 503
    with Retry-After — the client backoff loop handles a fleet mid-
    restart; nothing hangs, nothing surfaces untyped."""
    with Router([], poll_interval_s=0.02, staleness_s=0.2) as router:
        res = router.handle_infer("POST", _infer_doc(), None)
        assert res[0] == 503
        body = json.loads(res[2])
        assert body["reason"] == "no_replica"
        assert res[3]["Retry-After"]
        assert router.stats()["shed"]["no_replica"] == 1
        code, _body = router._healthz()
        assert code == 503


def test_router_deadline_bounds_failover():
    """With every replica dead, a deadline-carrying request stops
    failing over when its budget is spent: 504, inside the budget."""
    a = FakeReplica()
    try:
        with Router([a.url], poll_interval_s=0.02,
                    staleness_s=5.0) as router:
            assert _wait(lambda: router.replicas_up() == 1)
            a.close()
            t0 = time.perf_counter()
            res = router.handle_infer(
                "POST", _infer_doc(deadline_ms=300), None)
            wall = time.perf_counter() - t0
            # dead socket -> failover finds nobody -> typed 503/504
            assert res[0] in (503, 504)
            assert wall < 3.0
    finally:
        pass


def test_blackholed_replica_does_not_starve_healthy_rotation():
    """Probes run concurrently with at most one in flight per replica:
    one replica whose sockets HANG (blackholed host, not refused) must
    not stall the poll loop and age every healthy replica out of
    rotation — the fleet keeps serving through the survivor with zero
    sheds."""
    a, b = FakeReplica(), FakeReplica()
    try:
        with Router([a.url, b.url], poll_interval_s=0.05,
                    staleness_s=0.6) as router:
            assert router.replicas_up() == 2
            a.poll_delay_s = 1.8       # probe hangs well past staleness
            t_end = time.perf_counter() + 2.0
            codes = []
            while time.perf_counter() < t_end:
                codes.append(router.handle_infer(
                    "POST", _infer_doc(), None)[0])
                time.sleep(0.03)
            # sequential probing would have starved B's freshness while
            # A's probe hung, shedding no_replica 503s mid-window
            assert codes and all(c == 200 for c in codes), codes
            assert router.stats()["shed"]["no_replica"] == 0
            assert router.replicas_up() >= 1
    finally:
        a.poll_delay_s = 0.0
        a.close()
        b.close()



# ------------------------------------------------ routers over port engines
def _port_mlp(name, width=4):
    tpaddle.init(seed=0, device="cpu")
    x = tpaddle.layer.data("x", tpaddle.data_type.dense_vector(width))
    out = tpaddle.layer.fc(x, size=2, act="softmax", name=name)
    params = tpaddle.parameters.create(
        tpaddle.Topology(out, collect_evaluators=False), device="cpu")
    return out, params


def test_router_over_port_engines_fails_over_when_one_closes():
    """Two in-process port engines behind a Router: answers equal the
    engine's own; when one closes (its socket gone) the next requests
    fail over inside the router, nothing surfaces to the client, and the
    router shows it dead; the client's version trail is the engine's."""
    out, params = _port_mlp("flt_route_out")
    engines = [InferenceEngine(out, params, max_batch=2,
                               max_wait_us=100, model_version="m1")
               for _ in range(2)]
    urls = [f"http://127.0.0.1:{e.serve(0).server_address[1]}"
            for e in engines]
    try:
        with Router(urls, poll_interval_s=2.0, staleness_s=6.0,
                    probe_backoff_s=0.05) as router:
            assert router.replicas_up() == 2
            rurl = f"http://127.0.0.1:{router.serve(0).server_address[1]}"
            client = ServingClient(rurl, max_attempts=4,
                                   backoff_base_s=0.01)
            sample = [[0.1, 0.2, 0.3, 0.4]]
            want = engines[0].infer([(np.asarray(sample[0], np.float32),)],
                                    30)
            for _ in range(4):
                got = client.infer([sample], deadline_s=30)
                np.testing.assert_allclose(got["flt_route_out"], want,
                                           rtol=1e-6)
                assert got["model_version"] == "m1"
            engines[0].close()
            for _ in range(6):
                got = client.infer([sample], deadline_s=30)
                np.testing.assert_allclose(got["flt_route_out"], want,
                                           rtol=1e-6)
            st = router.stats()
            assert st["replicas"][urls[0]]["state"] == "dead"
            assert st["replicas_up"] == 1
            assert st["model_versions"] == {"m1": 2}
            assert not st["model_version_skew"]
            assert client.stats()["model_versions"] == {"m1": 10}
            assert json.loads(urllib.request.urlopen(
                rurl + "/stats", timeout=10).read())["role"] == "router"
    finally:
        for e in engines:
            e.close()


def test_router_refuses_tracing_and_fleet_metrics():
    """Tracing and the fleet's /metrics are ported (item 8.4): a traced
    router arms its recorder, /trace lists trace ids, /metrics answers
    the registry's text and ?fleet=1 its rollup; an untraced router
    refuses span ingest (404), and bad arguments still raise."""
    with pytest.raises(ValueError, match="trace_sample"):
        Router(trace_sample=1.5)
    with Router([], poll_interval_s=0.05, staleness_s=0.2,
                trace_sample=0.5) as traced:
        assert traced._flight is not None
        code, _, body = traced.handle_trace("GET", b"")
        assert code == 200 and "traces" in json.loads(body)
    with Router([], poll_interval_s=0.05, staleness_s=0.2) as router:
        assert router.handle_trace("POST", b"[]")[0] == 404
        code, ctype, body = router.handle_metrics("GET", b"")
        assert code == 200 and ctype.startswith("text/plain")
        code, _, body = router.handle_metrics("GET", b"", None, "fleet=1")
        assert code == 200 and b"# fleet rollup: 0 replica(s)" in body
        assert router.handle_register("POST", b'{"url": 5}')[0] == 400
        assert router.handle_register("GET", b"")[0] == 405
        assert router.handle_deregister("POST", b"{}")[0] == 400
    with pytest.raises(ValueError):
        Router(poll_interval_s=1.0, staleness_s=0.5)
    with pytest.raises(ValueError):
        Router(tenant_quota=-1)


def test_engine_stats_snapshot_seq_uptime_and_port():
    """snapshot_seq moves with resolved work, not with polls; uptime_s is
    monotonic; the bound port shows once serve(0) picked one."""
    out, params = _port_mlp("flt_seq_out")
    with InferenceEngine(out, params, max_batch=2,
                         max_wait_us=100) as eng:
        s1, s2 = eng.stats(), eng.stats()
        assert s2["snapshot_seq"] == s1["snapshot_seq"]
        assert s2["uptime_s"] >= s1["uptime_s"] >= 0.0
        eng.infer([(np.zeros(4, np.float32),)], timeout=30)
        assert eng.stats()["snapshot_seq"] > s2["snapshot_seq"]
        assert s1["port"] == 0
        server = eng.serve(0)
        assert eng.stats()["port"] == server.server_address[1] > 0


# --------------------------------------------------- real fleet member
def test_replica_process_registers_answers_and_deregisters_on_drain(
        tmp_path):
    """A ``serve --model cfg.py --router_url`` replica process (the whole
    forward on the CPU) read through its ready line: it registers on
    start, a routed request answers with the in-process engine's output,
    and SIGINT drains it after deregistering."""
    cfg_path = tmp_path / "fleet_cfg.py"
    cfg_path.write_text(
        "import paddle_tpu_torch as paddle\n"
        "from paddle_tpu_torch import layer\n"
        "paddle.init(seed=0)\n"
        "x = layer.data('x', paddle.data_type.dense_vector(4))\n"
        "prediction = layer.fc(x, size=2, act='softmax',\n"
        "                      name='fleet_t_out')\n")
    tpaddle.init(seed=0, device="cpu")
    x = tpaddle.layer.data("x", tpaddle.data_type.dense_vector(4))
    pred = tpaddle.layer.fc(x, size=2, act="softmax", name="fleet_t_out")
    params = tpaddle.parameters.create(
        tpaddle.Topology(pred, collect_evaluators=False), device="cpu")
    sample = np.asarray([0.5, 0.5, 0.5, 0.5], np.float32)
    with InferenceEngine(pred, params, max_batch=2,
                         max_wait_us=100) as eng:
        want = eng.infer([(sample,)], 30)
    with Router(poll_interval_s=0.05, staleness_s=1.0) as router:
        rurl = f"http://127.0.0.1:{router.serve(0).server_address[1]}"
        rep = fleet.spawn_replica(
            str(cfg_path), router_url=rurl,
            extra=["--max_batch", "2", "--device", "cpu"],
            env=dict(os.environ, PYTHONPATH=""), log_dir=str(tmp_path))
        try:
            assert rep.port > 0 and rep.url.endswith(f":{rep.port}")
            assert _wait(lambda: rep.url in router.replica_urls(), 10)
            assert _wait(lambda: router.replicas_up() == 1, 10)
            res = router.handle_infer("POST", _infer_doc(dim=4), None)
            assert res[0] == 200, res
            doc = json.loads(res[2])
            np.testing.assert_allclose(doc["outputs"]["fleet_t_out"], want,
                                       rtol=1e-6)
            assert doc["model_version"] == "boot"
            st = json.loads(urllib.request.urlopen(
                rep.url + "/stats", timeout=10).read())
            assert st["port"] == rep.port and st["requests"] >= 1
        finally:
            code = rep.stop(timeout_s=60)
        assert code == 0, rep.log_tail()
        assert rep.url not in router.replica_urls()
        assert "deregistered" in rep.log_tail()
