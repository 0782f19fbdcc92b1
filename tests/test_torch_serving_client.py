"""The port's ServingClient (``paddle_tpu_torch/serving/client.py``) under
the contract of ``tests/test_serving_client.py`` (fake clock + fake
transport, no sockets, no engine): a flapping 429/503 server converges;
Retry-After is honored as a floor; the caller's deadline is NEVER violated
(attempts, socket timeouts and backoff sleeps all shrink to the remaining
budget); 4xx and 500 never retry; 504 maps to the typed DeadlineExceeded;
the concurrency limiter bounds in-flight calls.  Beyond it: multi-endpoint
failover, the unported tracing knob, the errors being the port engine's,
and the client against a live port engine whose tenant quota sheds, in
process and over real HTTP."""

import json
import random
import threading

import pytest

from paddle_tpu_torch.serving import (DeadlineExceeded, Overloaded,
                                      ServingClient, ServingHTTPError)
from paddle_tpu_torch.serving import local_transport
from paddle_tpu_torch.serving.client import _TransportError


class FakeClock:
    """Deterministic monotonic clock; sleep() advances it (and records
    every requested delay)."""

    def __init__(self):
        self.t = 0.0
        self.sleeps = []

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s


def _resp(status, doc, headers=None):
    return (status, dict(headers or {}), json.dumps(doc).encode())


def _ok(value=1.5):
    return _resp(200, {"outputs": {"y": [[value]]}})


class SeqTransport:
    """Scripted transport: pops one scripted response per attempt and
    records each attempt's request document + timeout."""

    def __init__(self, script):
        self.script = list(script)
        self.calls = []          # (decoded request doc, timeout_s)

    def __call__(self, url, body, headers, timeout_s):
        self.calls.append((json.loads(body.decode()), timeout_s))
        item = self.script.pop(0)
        if isinstance(item, Exception):
            raise item
        return item


def _client(transport, clock, **kw):
    kw.setdefault("max_attempts", 6)
    kw.setdefault("backoff_base_s", 0.1)
    kw.setdefault("rng", random.Random(0))
    return ServingClient("http://test", transport=transport,
                         clock=clock, sleep=clock.sleep, **kw)


def test_flapping_429_503_converges():
    """429 then 503 then 200: the client retries through the flap and
    returns the decoded outputs — two backoff sleeps, three attempts."""
    clock = FakeClock()
    tr = SeqTransport([
        _resp(429, {"error": "overloaded", "retry_after_s": 0.2},
              {"Retry-After": "1"}),
        _resp(503, {"error": "EngineUnhealthy('dead')"}),
        _ok(2.0),
    ])
    c = _client(tr, clock)
    out = c.infer([[0.5]])
    assert out["y"].tolist() == [[2.0]]
    s = c.stats()
    assert s["attempts"] == 3 and s["retries"] == 2
    assert s["status_counts"] == {"429": 1, "503": 1, "200": 1}
    # first sleep floored at the BODY's fractional retry_after_s (the
    # integral header is the coarse fallback)
    assert clock.sleeps[0] >= 0.2


def test_retry_after_is_a_floor_not_a_cap():
    """A Retry-After far above the jittered backoff still bounds the
    sleep from BELOW; jitter can ride above but never dips under."""
    clock = FakeClock()
    tr = SeqTransport([
        _resp(429, {"error": "overloaded", "retry_after_s": 3.0}),
        _ok(),
    ])
    c = _client(tr, clock, backoff_base_s=0.01)
    c.infer([[0.0]])
    assert len(clock.sleeps) == 1
    assert clock.sleeps[0] >= 3.0


def test_deadline_never_violated_while_server_sheds():
    """A server shedding 429 forever: the client gives up with
    DeadlineExceeded BEFORE the budget elapses — a backoff sleep that
    would overrun the deadline is never taken."""
    clock = FakeClock()
    tr = SeqTransport([
        _resp(429, {"error": "overloaded", "retry_after_s": 0.4})
    ] * 50)
    c = _client(tr, clock, max_attempts=50, deadline_s=1.0)
    with pytest.raises(DeadlineExceeded):
        c.infer([[0.0]])
    assert clock.t <= 1.0                      # never slept past it
    assert c.stats()["deadline_exceeded"] == 1
    # every attempt advertised the SHRUNK remaining budget
    budgets = [doc["deadline_ms"] for doc, _ in tr.calls]
    assert budgets == sorted(budgets, reverse=True)
    assert budgets[0] == pytest.approx(1000.0, abs=1.0)
    # per-attempt socket timeout clamped to the remaining budget too
    for (doc, timeout), _ in zip(tr.calls, budgets):
        assert timeout <= doc["deadline_ms"] / 1e3 + 1e-9


def test_4xx_never_retries():
    clock = FakeClock()
    tr = SeqTransport([_resp(400, {"error": "ValueError('empty')"}),
                       _ok()])
    c = _client(tr, clock)
    with pytest.raises(ServingHTTPError) as ei:
        c.infer([[0.0]])
    assert ei.value.status == 400 and not ei.value.retryable
    assert c.stats()["attempts"] == 1          # no retry, no sleep
    assert clock.sleeps == []


def test_500_is_not_retried():
    """Forward/XLA faults answer 500 — not in the retry set (a retry
    re-burns a padded batch row on the same poison payload)."""
    clock = FakeClock()
    tr = SeqTransport([_resp(500, {"error": "XlaRuntimeError"}), _ok()])
    c = _client(tr, clock)
    with pytest.raises(ServingHTTPError) as ei:
        c.infer([[0.0]])
    assert ei.value.status == 500
    assert c.stats()["attempts"] == 1


def test_504_maps_to_deadline_exceeded_without_retry():
    clock = FakeClock()
    tr = SeqTransport([_resp(504, {"error": "deadline"}), _ok()])
    c = _client(tr, clock, deadline_s=10.0)
    with pytest.raises(DeadlineExceeded):
        c.infer([[0.0]])
    assert c.stats()["attempts"] == 1


def test_connection_errors_retry_then_surface():
    clock = FakeClock()
    tr = SeqTransport([_TransportError("refused")] * 3)
    c = _client(tr, clock, max_attempts=3)
    with pytest.raises(ServingHTTPError) as ei:
        c.infer([[0.0]])
    assert ei.value.retryable and ei.value.status == 0
    assert c.stats()["attempts"] == 3 and c.stats()["gave_up"] == 1


def test_connection_error_then_recovery():
    clock = FakeClock()
    tr = SeqTransport([_TransportError("refused"), _ok(7.0)])
    c = _client(tr, clock)
    assert c.infer([[0.0]])["y"].tolist() == [[7.0]]


def test_exhausted_429_raises_typed_overloaded_with_reason():
    """Attempts exhausted on 429: the client re-raises the server's
    typed Overloaded, carrying the shed reason (tenant_quota,
    breaker_open, queue_full) so callers can distinguish their own
    quota from global pressure."""
    clock = FakeClock()
    tr = SeqTransport([
        _resp(429, {"error": "overloaded", "reason": "tenant_quota",
                    "retry_after_s": 0.1})] * 2)
    c = _client(tr, clock, max_attempts=2)
    with pytest.raises(Overloaded) as ei:
        c.infer([[0.0]])
    assert ei.value.reason == "tenant_quota"
    assert ei.value.retry_after_s == pytest.approx(0.1)
    assert c.stats()["attempts"] == 2


def test_tenant_lane_and_payload_serialization():
    """The request document carries tenant/lane (client default,
    per-call override) and numpy fields serialize to nested lists."""
    import numpy as np

    clock = FakeClock()
    tr = SeqTransport([_ok(), _ok()])
    c = _client(tr, clock, tenant="search", lane="high")
    c.infer([(np.array([0.25, 0.5], np.float32),)])
    doc = tr.calls[0][0]
    assert doc["tenant"] == "search" and doc["lane"] == "high"
    assert doc["input"] == [[[0.25, 0.5]]]
    assert "deadline_ms" not in doc            # no budget -> not sent
    c.infer([[1.0]], tenant="ads", lane="normal")
    doc2 = tr.calls[1][0]
    assert doc2["tenant"] == "ads" and doc2["lane"] == "normal"


def test_as_numpy_false_returns_nested_lists():
    clock = FakeClock()
    c = _client(SeqTransport([_ok(3.0)]), clock)
    out = c.infer([[0.0]], as_numpy=False)
    assert out == {"y": [[3.0]]}


def test_concurrency_limiter_bounds_inflight_calls():
    """max_concurrency=1: a second call cannot enter the transport
    while the first holds the slot; with a deadline, the wait for a
    slot raises DeadlineExceeded instead of blocking forever."""
    entered = threading.Event()
    release = threading.Event()
    peak = [0, 0]                              # current, max
    lock = threading.Lock()

    def blocking_transport(url, body, headers, timeout_s):
        with lock:
            peak[0] += 1
            peak[1] = max(peak[1], peak[0])
        entered.set()
        release.wait(5)
        with lock:
            peak[0] -= 1
        return _ok()

    c = ServingClient("http://test", transport=blocking_transport,
                      max_concurrency=1)
    t = threading.Thread(target=lambda: c.infer([[0.0]]), daemon=True)
    t.start()
    assert entered.wait(5)
    # slot held: a deadline-bounded call times out waiting for it
    with pytest.raises(DeadlineExceeded):
        c.infer([[0.0]], deadline_s=0.05)
    release.set()
    t.join(5)
    assert peak[1] == 1                        # never two in flight


def test_client_validates_construction():
    with pytest.raises(ValueError):
        ServingClient("http://x", max_attempts=0)
    with pytest.raises(ValueError):
        ServingClient("http://x", backoff_base_s=-1)


def test_errors_are_the_port_engines_and_tracing_is_refused():
    from paddle_tpu_torch.serving import engine
    assert Overloaded is engine.Overloaded
    assert DeadlineExceeded is engine.DeadlineExceeded
    assert issubclass(ServingHTTPError, engine.ServingError)
    # tracing is ported (item 13a): the knob arms the client's recorder,
    # and an out-of-range rate still raises
    traced = ServingClient("http://x", trace_sample=0.5)
    assert traced.trace_sample == 0.5 and traced._recorder is not None
    assert ServingClient("http://x")._recorder is None
    with pytest.raises(ValueError, match="trace_sample"):
        ServingClient("http://x", trace_sample=1.5)


def test_failover_to_a_ready_endpoint_without_sleeping():
    """Two endpoints: a 429 with a long Retry-After on the first fails
    over to the second at once (the floor is per endpoint); the next call
    starts on the second (round robin); a connection error fails over
    too."""
    clock = FakeClock()
    seen = []
    down = []

    def transport(url, body, headers, timeout_s):
        seen.append(url)
        if url.startswith("http://a"):
            return _resp(429, {"error": "overloaded", "retry_after_s": 5.0})
        if down:
            raise _TransportError("refused")
        return _ok(4.0)

    c = ServingClient(["http://a", "http://b"], transport=transport,
                      clock=clock, sleep=clock.sleep, rng=random.Random(0))
    for _ in range(2):
        assert c.infer([[0.0]])["y"].tolist() == [[4.0]]
    assert clock.sleeps == []
    s = c.stats()
    assert s["failovers"] == 1
    assert s["endpoints"]["http://a"]["sheds"] == 1
    assert seen == ["http://a/infer", "http://b/infer", "http://b/infer"]
    down.append(True)                         # b refuses: both fail
    with pytest.raises(ServingHTTPError) as ei:
        c.infer([[0.0]], deadline_s=30.0)
    assert ei.value.retryable and ei.value.status == 0
    assert c.stats()["endpoints"]["http://b"]["connect_errors"] >= 1


def _engine(**kw):
    import numpy as np

    from paddle_tpu_torch.models import transformer as ttr
    from paddle_tpu_torch.serving import InferenceEngine
    from torch_serving_helpers import HEADS, Gate, lm, slab

    model = ttr.params_from_jax(lm()[2], num_heads=HEADS)
    dec = slab(model, max_slots=1)
    gate = Gate(dec)
    return InferenceEngine(decoder=dec, **kw), gate, np.arange(4)


def test_client_against_live_engine_tenant_quota():
    """In process (``local_transport``): the client eats the port engine's
    real 429s with Retry-After, backs off, and gets through once the quota
    drains; a caller fault answers 400 and is not retried."""
    from torch_serving_helpers import resident

    eng, gate, p = _engine(max_queue_depth=16, max_queue_depth_per_tenant=2,
                           hysteresis=0.5)
    client = ServingClient("http://in-process",
                           transport=local_transport(eng), tenant="hog",
                           max_attempts=8, backoff_base_s=0.01,
                           backoff_cap_s=0.1)
    try:
        held = eng.submit([p], max_tokens=2, tenant="hog")
        resident(eng, gate, 1)
        filler = eng.submit([p + 1], max_tokens=2, tenant="hog")
        with pytest.raises(Overloaded):
            eng.submit([p], max_tokens=2, tenant="hog").result(0)
        # the quota drains once the held steps go; a retry gets through
        threading.Timer(0.05, gate.open).start()
        out = client.infer([p.tolist()], max_tokens=3, deadline_s=30.0)
        assert out["tokens"].shape == (3,) and out["generated"] == 3
        s = client.stats()
        assert s["status_counts"].get("429", 0) >= 1
        assert s["retries"] >= 1
        held.result(10)
        filler.result(10)
        attempts = client.stats()["attempts"]
        with pytest.raises(ServingHTTPError) as ei:
            client.infer([], max_tokens=2, deadline_s=5.0)
        assert ei.value.status == 400
        assert client.stats()["attempts"] == attempts + 1
    finally:
        gate.open()
        eng.close(drain_timeout_s=5)


def test_client_over_http_reasons_match_engine_sheds():
    """Over real HTTP with retries off: each 429's reason reaches the
    caller as Overloaded.reason, and the client's count per reason equals
    the engine's sheds."""
    from torch_serving_helpers import resident, wait_until

    eng, gate, p = _engine(max_queue_depth=3, max_queue_depth_per_tenant=2)
    url = f"http://127.0.0.1:{eng.serve(0).server_address[1]}"
    client = ServingClient(url, max_attempts=1)
    reasons = []
    waiting = []

    def call(tenant):
        try:
            return client.infer([p.tolist()], max_tokens=2, tenant=tenant)
        except Overloaded as e:
            reasons.append(e.reason)

    try:
        held = eng.submit([p], max_tokens=2, tenant="a")
        resident(eng, gate, 1)
        queued = eng.submit([p], max_tokens=2, tenant="a")
        call("a")                             # a holds 2: its quota
        for tenant in ("b", "c"):             # admitted, they wait
            depth = eng.queue_depth()
            t = threading.Thread(target=call, args=(tenant,))
            t.start()
            waiting.append(t)
            wait_until(lambda: eng.queue_depth() == depth + 1,
                       what=f"{tenant} queued")
        call("d")                             # the queue holds 3: full
        assert reasons == ["tenant_quota", "queue_full"]
        shed = eng.stats()["shed"]
        assert shed["tenant_quota"] == 1 and shed["queue_full"] == 1
        assert client.stats()["status_counts"] == {"429": 2}
        gate.open()
        for t in waiting:
            t.join(30)
        assert client.stats()["status_counts"] == {"429": 2, "200": 2}
        held.result(30)
        queued.result(30)
    finally:
        gate.open()
        eng.close(drain_timeout_s=5)
