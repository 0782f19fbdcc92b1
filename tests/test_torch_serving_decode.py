"""The port's continuous-batching decode engine over the slab
``SlotDecoder``: the contracts of ``tests/test_serving_decode.py`` (the slot
allocator, streams equal to ``incremental_generate`` and to the JAX engine's
under both policies, mid-flight joins, EOS, validation, iteration-granular
reaping, the progress beat, static against continuous, WFQ in decode steps,
quotas as KV-slot caps, prefill faults, HTTP and the client, drain) held on
the port.  Steps are held by ``Gate`` where an order matters, never timed."""

import json
import time

import numpy as np
import pytest

from paddle_tpu.models import transformer as jtr
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.serving import (DeadlineExceeded, InferenceEngine,
                                      Overloaded, ServingClient,
                                      local_transport)
from paddle_tpu_torch.serving.engine import _SlotAllocator
from torch_serving_helpers import (HEADS, LONG_MAXLEN, MAXLEN, VOCAB, Gate,
                                   lm, request_of, resident, slab,
                                   wait_until)

POLICIES = ("continuous", "static")


@pytest.fixture(scope="module")
def small():
    topo, params, values = lm()
    return topo, params, ttr.params_from_jax(values, num_heads=HEADS)


@pytest.fixture(scope="module")
def long_lm():
    """max_len 256: room for a long generation the tests cut short."""
    topo, params, values = lm(LONG_MAXLEN)
    return ttr.params_from_jax(values, num_heads=HEADS)


def _prompts(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, size=int(rng.randint(3, 12)))
            for _ in range(n)]


# --------------------------------------------------------- slot allocator
def test_slot_allocator_alloc_free_exhaustion():
    a = _SlotAllocator(3)
    assert [a.alloc(), a.alloc(), a.alloc()] == [0, 1, 2]
    assert a.highwater == 3 and len(a) == 3
    assert a.alloc() is None                    # exhausted, not an error
    a.free(1)
    assert len(a) == 2 and a.highwater == 3     # hole below the highwater
    assert a.alloc() == 1                       # lowest index first
    a.free(2)
    a.free(1)
    assert a.highwater == 1
    a.free(0)
    assert a.highwater == 0 and len(a) == 0
    with pytest.raises(ValueError):
        a.free(0)                               # double free
    with pytest.raises(ValueError):
        _SlotAllocator(0)


def test_slot_allocator_prefers_low_indices_after_churn():
    a = _SlotAllocator(4)
    for _ in range(4):
        a.alloc()
    a.free(0)
    a.free(3)
    assert a.alloc() == 0
    assert a.highwater == 3


# ------------------------------------------------- correctness + equality
@pytest.mark.parametrize("policy", POLICIES)
def test_streams_equal_incremental_generate_and_jax_engine(small, policy):
    """All in flight at once under each policy: the port's slab engine,
    the JAX slab engine and ``incremental_generate`` give equal
    streams."""
    topo, params, model = small
    prompts = _prompts(5, seed=1)
    mts = [10, 6, 8, 4, 7]
    oracle = [jtr.incremental_generate(topo, params, p[None],
                                       max_new=m)[0, len(p):].tolist()
              for p, m in zip(prompts, mts)]
    jeng = JaxEngine(decoder=jtr.SlotDecoder(topo, params, max_slots=4,
                                             decode_kernel="xla"),
                     decode_policy=policy)
    try:
        futs = [jeng.submit([p], max_tokens=m)
                for p, m in zip(prompts, mts)]
        jax_streams = [f.result(120).tolist() for f in futs]
    finally:
        jeng.close()
    eng = InferenceEngine(decoder=slab(model), decode_policy=policy)
    try:
        futs = [eng.submit([p], max_tokens=m)
                for p, m in zip(prompts, mts)]
        got = [f.result(60).tolist() for f in futs]
        st = eng.stats()
    finally:
        eng.close()
    assert got == jax_streams == oracle
    assert st["decode"]["policy"] == policy
    assert st["requests"] == len(prompts) and st["goodput"] == len(prompts)
    assert st["decode"]["slots_occupied"] == 0
    assert st["decode"]["slot_allocs"] == st["decode"]["slot_frees"] == 5


def test_join_mid_flight_bit_equality_vs_sequential(small):
    """A sequence that joins a running batch decodes bit-identically to
    the same prompt decoded alone."""
    _, _, model = small
    prompts = _prompts(8, seed=2)
    rng = np.random.RandomState(2)
    mts = [int(rng.randint(4, 16)) for _ in range(8)]
    eng = InferenceEngine(decoder=slab(model, max_slots=8))
    want = [eng.infer([p], 30, max_tokens=m).tolist()
            for p, m in zip(prompts, mts)]
    eng.close()
    eng = InferenceEngine(decoder=slab(model, max_slots=8))
    futs = [eng.submit([p], max_tokens=m) for p, m in zip(prompts, mts)]
    got = [f.result(60).tolist() for f in futs]
    st = eng.stats()
    eng.close()
    assert got == want
    # more than one sequence was resident at once
    assert st["decode"]["tokens"] > st["decode"]["iterations"]


def test_decode_eos_latches_and_is_included(small):
    _, _, model = small
    p = np.arange(5) % VOCAB
    eng = InferenceEngine(decoder=slab(model))
    free = eng.infer([p], 30, max_tokens=12).tolist()
    eng.close()
    eos = free[3]
    first = free.index(eos)
    eng = InferenceEngine(decoder=slab(model), eos_id=eos)
    got = eng.infer([p], 30, max_tokens=12).tolist()
    st = eng.stats()
    eng.close()
    assert got == free[:first + 1]    # stops AT the eos, eos included
    assert st["decode"]["eos_id"] == eos


def test_decode_submit_validation(small):
    _, _, model = small
    eng = InferenceEngine(decoder=slab(model))
    try:
        with pytest.raises(ValueError):   # no max_tokens, no default
            eng.submit([[1, 2, 3]]).result(5)
        with pytest.raises(ValueError):   # empty prompt
            eng.submit([[]], max_tokens=4).result(5)
        with pytest.raises(ValueError):   # over max_len
            eng.submit([[1] * 10], max_tokens=MAXLEN).result(5)
        with pytest.raises(ValueError):   # two prompts in one request
            eng.submit([[1, 2], [3, 4]], max_tokens=4).result(5)
        with pytest.raises(ValueError):   # a token outside the vocab
            eng.submit([[1, VOCAB]], max_tokens=4).result(5)
        with pytest.raises(ValueError):   # no such lane
            eng.submit([[1, 2]], max_tokens=4, lane="urgent").result(5)
        # bare prompt and sample-tuple forms both work
        a = eng.infer([1, 2, 3], 30, max_tokens=4)
        b = eng.infer([([1, 2, 3],)], 30, max_tokens=4)
        assert a.tolist() == b.tolist()
        assert eng.stats()["errors"] == 6
    finally:
        eng.close()
    with pytest.raises(ValueError, match="decode_policy"):
        InferenceEngine(decoder=slab(model), decode_policy="fifo")
    with pytest.raises(ValueError, match="default_max_tokens"):
        InferenceEngine(decoder=slab(model), default_max_tokens=-1)
    with pytest.raises(ValueError, match="decoder="):
        InferenceEngine()


# the JAX engine's keywords for features the port does not have yet, each
# with a non-default value and the ROADMAP item its error names
UNPORTED = [
    ("mesh", object(), "item 14"), ("mesh_slices", 2, "item 14"),
    ("mesh_rules", object(), "item 14"),
    ("compile_cache_dir", "/x", "item 13b")]


@pytest.mark.parametrize("kw,value,item", UNPORTED,
                         ids=[u[0] for u in UNPORTED])
def test_unported_engine_feature_raises(small, kw, value, item):
    """None is silently ignored: each raises naming its ROADMAP.md item;
    the default value is accepted."""
    _, _, model = small
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md §1 {item}"):
        InferenceEngine(decoder=slab(model), **{kw: value})


# the whole-forward and model-version keywords ported since: each works in
# the mode it belongs to (the whole-forward engine, or decode for the
# version keywords that decode shares), and the decode engine rejects the
# whole-forward-only ones as the JAX engine does
PORTED = [
    ("output_layer", None, "exclusive"), ("inference", None, "exclusive"),
    ("feeding", {"tokens": 0}, None), ("max_batch", 8, None),
    ("max_wait_us", 100.0, None), ("batch_buckets", (2, 4), None),
    ("overload_wait_scale", 2.0, None), ("seq_buckets", (8,), "seq_buckets"),
    ("model_version", "v2", None), ("canary_fraction", 0.1, "canary"),
    ("canary_promote_requests", 8, None), ("reload_key", b"k", None),
    ("trace_sample", 0.5, None), ("telemetry_dir", "<tmp>", None)]


@pytest.mark.parametrize("kw,value,decode_error", PORTED,
                         ids=[u[0] for u in PORTED])
def test_ported_engine_keyword_works(small, kw, value, decode_error,
                                     tmp_path):
    """A whole-forward engine on the small LM's logits takes the keyword
    and answers a request; a decode engine takes it too, or refuses it
    with the JAX engine's ValueError where it belongs to whole forwards.
    ``telemetry_dir`` ("<tmp>") is a fresh directory."""
    import paddle_tpu_torch as tpaddle
    from paddle_tpu_torch.inference import Inference
    from paddle_tpu_torch.models.transformer import build

    if value == "<tmp>":
        value = str(tmp_path)
    _, _, model = small
    tpaddle.init(seed=0, device="cpu")
    _, logits = build(vocab_size=VOCAB, max_len=MAXLEN, dim=32,
                      num_heads=HEADS, num_layers=1)
    params = tpaddle.parameters.create(tpaddle.Topology(logits))
    kw_fwd = {kw: value}
    if kw == "output_layer":
        kw_fwd = {"output_layer": logits, "parameters": params}
    elif kw == "inference":
        kw_fwd = {"inference": Inference(logits, params, device="cpu")}
    args = () if kw in ("output_layer", "inference") else (logits, params)
    with InferenceEngine(*args, **dict({"max_wait_us": 100.0}, **kw_fwd)) as eng:
        got = eng.infer([([1, 2, 3],)], timeout=60)
        assert got.shape == (1, eng.seq_buckets[0] if eng.seq_buckets
                             else MAXLEN, VOCAB)
        if kw == "model_version":
            assert eng.stats()["model_version"] == "v2"
    kw_dec = {kw: logits if kw == "output_layer" else
              Inference(logits, params, device="cpu")
              if kw == "inference" else value}
    if decode_error:
        with pytest.raises(ValueError, match=decode_error):
            InferenceEngine(decoder=slab(model), **kw_dec)
    else:
        InferenceEngine(decoder=slab(model), **kw_dec).close()


def test_unported_whole_forward_and_per_request_features_raise(small):
    """A trace is taken (item 13a: its span buffer gets the engine's
    queue-wait, prefill and decode spans); the prewarm raises naming item
    13b (the compile cache); a decode engine answers a pin on its active
    version and refuses any other, over HTTP as 200 and 400."""
    from paddle_tpu_torch.observability import tracectx
    _, _, model = small
    eng = InferenceEngine(slab(model), max_batch=32, max_wait_us=2000.0,
                          model_version="boot", mesh_slices=0)
    try:
        buf = tracectx.SpanBuffer(tracectx.mint(1.0), "engine/request")
        assert eng.submit([[1, 2]], max_tokens=2,
                          trace=buf).result(60).shape == (2,)
        assert {s["name"] for s in buf.spans} >= {
            "engine/queue_wait", "engine/prefill", "engine/decode"}
        with pytest.raises(NotImplementedError, match="item 13b"):
            eng.prewarm()
        assert eng.infer([[1, 2]], 60, max_tokens=2,
                         version="boot").shape == (2,)
        with pytest.raises(ValueError, match="one resident version"):
            eng.infer([[1, 2]], 60, max_tokens=2, version="other")
        handle = eng.http_handlers()["/infer"]
        code, _, body = handle("POST", json.dumps(
            {"input": [[1, 2]], "max_tokens": 2,
             "model_version": "boot"}).encode())[:3]
        assert code == 200 and json.loads(body)["model_version"] == "boot"
        code, _, body = handle("POST", json.dumps(
            {"input": [[1, 2]], "max_tokens": 2,
             "model_version": "v9"}).encode())[:3]
        assert code == 400 and "one resident version" in json.loads(
            body)["error"]
    finally:
        eng.close()


# ------------------------------------------------ iteration-level control
def test_iteration_granular_deadline_reaping_mid_generation(long_lm):
    """A deadline that passes MID-GENERATION frees the slot that
    iteration: typed DeadlineExceeded with the progress count, shed reason
    "deadline", and the co-resident finishes untouched."""
    dec = slab(long_lm, max_slots=2, step_buckets=(2,),
               prefill_buckets=(8,))
    gate = Gate(dec)
    eng = InferenceEngine(decoder=dec)
    try:
        p = np.arange(4) % VOCAB
        ok_fut = eng.submit([p], max_tokens=4)
        doomed = eng.submit([p + 1], max_tokens=248, deadline_us=60e6)
        resident(eng, gate, 2)
        request_of(doomed).deadline = time.perf_counter() - 1.0
        gate.open()
        with pytest.raises(DeadlineExceeded) as ei:
            doomed.result(30)
        assert ei.value.generated >= 1          # it HAD started
        assert ok_fut.result(30).shape == (4,)
        wait_until(lambda: eng.stats()["decode"]["slots_occupied"] == 0)
        st = eng.stats()
        assert st["shed"]["deadline"] == 1
        assert st["decode"]["slot_frees"] == 2
    finally:
        eng.close()


def test_decode_abandoned_caller_frees_slot(long_lm):
    dec = slab(long_lm, max_slots=2, step_buckets=(2,),
               prefill_buckets=(8,))
    gate = Gate(dec)
    eng = InferenceEngine(decoder=dec)
    try:
        fut = eng.submit([np.arange(6) % VOCAB], max_tokens=240)
        resident(eng, gate, 1)
        assert eng.cancel(fut)        # the caller walks away mid-generation
        gate.open()
        with pytest.raises(DeadlineExceeded):
            fut.result(20)
        wait_until(lambda: eng.stats()["decode"]["slots_occupied"] == 0)
        assert eng.stats()["shed"]["abandoned"] == 1
        assert not eng.cancel(fut)    # already resolved
    finally:
        eng.close()


def test_snapshot_seq_bumps_per_iteration_not_per_sequence(small):
    """The progress beat advances every iteration of ONE long generation,
    before any sequence completes."""
    _, _, model = small
    dec = slab(model, max_slots=2)
    gate = Gate(dec)
    eng = InferenceEngine(decoder=dec)
    try:
        p = np.arange(3) % VOCAB
        fut = eng.submit([p], max_tokens=MAXLEN - len(p))
        resident(eng, gate, 1)
        seqs = [eng.stats()["snapshot_seq"]]
        for _ in range(4):
            gate.step()
            seqs.append(eng.stats()["snapshot_seq"])
        assert all(b > a for a, b in zip(seqs, seqs[1:]))
        assert eng.stats()["requests"] == 0
        gate.open()
        fut.result(30)
        st = eng.stats()
        assert st["snapshot_seq"] >= st["decode"]["iterations"]
    finally:
        eng.close()


def _late_after_long(model, policy):
    """Order in which a short, a long and a late request finish on two
    slots, the late one submitted once the other two are resident (both
    queued behind a primer's held step, so one turn admits them)."""
    dec = slab(model, max_slots=2)
    gate = Gate(dec)
    eng = InferenceEngine(decoder=dec, decode_policy=policy)
    order = []
    try:
        p = np.arange(4) % VOCAB
        primer = eng.submit([p + 3], max_tokens=2)
        wait_until(lambda: gate.calls >= 1, what="the primer's step")
        futs = {"short": eng.submit([p], max_tokens=4),
                "long": eng.submit([p + 1], max_tokens=40)}
        for name, f in futs.items():
            f.add_done_callback(lambda _, n=name: order.append(n))
        gate.step()                   # the primer finishes, both board
        assert primer.result(10).shape == (2,)
        assert eng.stats()["decode"]["slots_occupied"] == 2
        late = eng.submit([p + 2], max_tokens=4)
        late.add_done_callback(lambda _: order.append("late"))
        gate.open()
        for f in (*futs.values(), late):
            assert f.result(30).shape[0] in (4, 40)
        return order
    finally:
        eng.close()


def test_static_policy_has_head_of_line_blocking(small):
    """Static admits nothing until the whole batch drained, so the late
    arrival finishes after the long neighbour; continuous slips it into the
    slot the short one freed."""
    _, _, model = small
    assert _late_after_long(model, "static") == ["short", "long", "late"]
    assert _late_after_long(model, "continuous") == ["short", "late", "long"]


# ------------------------------------------------------ fairness + quotas
def test_wfq_deficit_charged_in_decode_steps(small):
    """DRR's cost is the decode-step budget: with one slot and equal
    weights, a hog queueing long generations first cannot monopolize the
    slot - the other tenant's short requests interleave by token share."""
    _, _, model = small
    dec = slab(model, max_slots=1)
    gate = Gate(dec)
    eng = InferenceEngine(decoder=dec)
    try:
        order = []
        holder = eng.submit([np.arange(3) % VOCAB], max_tokens=12)
        resident(eng, gate, 1)
        p = np.arange(4) % VOCAB
        futs = []
        for i in range(3):
            f = eng.submit([p], max_tokens=16, tenant="hog")
            f.add_done_callback(lambda _, i=i: order.append(("hog", i)))
            futs.append(f)
        for i in range(8):
            f = eng.submit([p + 1], max_tokens=4, tenant="wb")
            f.add_done_callback(lambda _, i=i: order.append(("wb", i)))
            futs.append(f)
        gate.open()
        holder.result(60)
        for f in futs:
            f.result(60)
        # FIFO would finish the 3 hogs first; DRR in decode steps
        # interleaves about 4 wb per hog (16 against 4 tokens)
        assert sum(1 for t, _ in order[:6] if t == "wb") >= 3, order
        ts = eng.stats()["tenants"]
        assert ts["hog"]["requests"] == 3 and ts["wb"]["requests"] == 8
    finally:
        eng.close()


def test_tenant_admission_caps_become_kv_slot_caps(small):
    """The per-tenant quota counts queued plus slot-holding sequences, so
    it caps a tenant's KV slots with the same typed Overloaded."""
    _, _, model = small
    dec = slab(model, max_slots=4)
    gate = Gate(dec)
    eng = InferenceEngine(decoder=dec, max_queue_depth_per_tenant=2)
    try:
        p = np.arange(5) % VOCAB
        f1 = eng.submit([p], max_tokens=40, tenant="hog")
        f2 = eng.submit([p + 1], max_tokens=40, tenant="hog")
        resident(eng, gate, 2)            # both hold slots, none queued
        assert eng.queue_depth() == 0
        shed = eng.submit([p + 2], max_tokens=4, tenant="hog")
        with pytest.raises(Overloaded) as ei:
            shed.result(5)
        assert ei.value.reason == "tenant_quota"
        other = eng.submit([p + 3], max_tokens=4, tenant="wb")
        gate.open()
        assert other.result(30).shape == (4,)
        f1.result(60)
        f2.result(60)
        st = eng.stats()
        assert st["shed"]["tenant_quota"] == 1
        assert st["tenants"]["hog"]["shed"] == 1
        assert st["tenants"]["hog"]["depth"] == 0
    finally:
        eng.close()


def test_prefill_execution_fault_is_a_batch_fault_and_engine_survives(
        small):
    """A prefill that fails in execution: the residents fail WITH the
    admitting request, the caches re-zero, and the engine keeps serving,
    bit-equal."""
    _, _, model = small
    dec = slab(model, max_slots=4)
    eng = InferenceEngine(decoder=dec)
    gate = None
    try:
        p = np.arange(5) % VOCAB
        want = eng.infer([p], 30, max_tokens=6).tolist()
        gate = Gate(dec)
        resident_fut = eng.submit([p + 1], max_tokens=40)
        resident(eng, gate, 1)
        orig = dec.prefill

        def boom(slot, prompt):
            raise RuntimeError("device fault")

        dec.prefill = boom
        doomed = eng.submit([p + 2], max_tokens=6)
        gate.release()                # the next turn admits the doomed one
        with pytest.raises(RuntimeError):
            doomed.result(20)
        with pytest.raises(RuntimeError):   # the co-resident fails too
            resident_fut.result(20)
        dec.prefill = orig
        gate.open()
        assert eng.infer([p], 30, max_tokens=6).tolist() == want
        st = eng.stats()
        assert st["decode"]["slots_occupied"] == 0
        assert st["errors"] == 2
        assert st["tenants"]["default"]["breaker"] == "closed"
    finally:
        eng.close()


def test_step_fault_fails_residents_and_engine_survives(small):
    _, _, model = small
    dec = slab(model, max_slots=2)
    eng = InferenceEngine(decoder=dec)
    try:
        p = np.arange(5) % VOCAB
        want = eng.infer([p], 30, max_tokens=4).tolist()
        orig = dec.step

        def boom(n, tokens, pos):
            raise RuntimeError("step fault")

        dec.step = boom
        with pytest.raises(RuntimeError):
            eng.submit([p], max_tokens=4).result(20)
        dec.step = orig
        assert eng.infer([p], 30, max_tokens=4).tolist() == want
        assert eng.stats()["decode"]["slots_occupied"] == 0
    finally:
        eng.close()


# ---------------------------------------------------------- HTTP + client
def test_decode_http_and_client_roundtrip(small):
    _, _, model = small
    eng = InferenceEngine(decoder=slab(model), default_max_tokens=5)
    try:
        handler = eng.http_handlers()["/infer"]
        code, _, body = handler("POST", json.dumps(
            {"input": [[1, 2, 3]], "max_tokens": 4}).encode())[:3]
        doc = json.loads(body)
        assert code == 200
        assert len(doc["outputs"]["tokens"]) == 4 and doc["generated"] == 4
        # default_max_tokens applies when the body carries none
        code, _, body = handler(
            "POST", json.dumps({"input": [[1, 2, 3]]}).encode())[:3]
        assert code == 200 and json.loads(body)["generated"] == 5
        # the X-Ptpu-Max-Tokens header stands in for the body field
        code, _, body = handler("POST", json.dumps(
            {"input": [[1, 2, 3]]}).encode(), {"X-Ptpu-Max-Tokens": "3"})[:3]
        assert code == 200 and json.loads(body)["generated"] == 3
        client = ServingClient("http://in-process",
                               transport=local_transport(eng))
        out = client.infer([[1, 2, 3]], max_tokens=4)
        assert out["generated"] == 4
        assert out["tokens"].shape == (4,)
        assert handler("GET", b"")[0] == 405
    finally:
        eng.close()


def test_decode_client_deadline_covers_whole_generation(long_lm):
    """The client's deadline spans the WHOLE generation: the server reaps
    the request mid-generation (each step takes at least 2 ms, 250 of them
    cannot fit in 80 ms), answers 504, and the client raises
    DeadlineExceeded without a retry."""
    dec = slab(long_lm, max_slots=2, step_buckets=(2,),
               prefill_buckets=(8,))
    Gate(dec, throttle_s=0.002, closed=False)
    eng = InferenceEngine(decoder=dec)
    try:
        client = ServingClient("http://in-process",
                               transport=local_transport(eng))
        with pytest.raises(DeadlineExceeded):
            client.infer([[1, 2, 3]], max_tokens=250, deadline_s=0.08)
        assert client.stats()["retries"] == 0     # 504 is terminal
        wait_until(lambda: eng.stats()["decode"]["slots_occupied"] == 0)
        assert eng.stats()["shed"]["deadline"] == 1
    finally:
        eng.close()


def test_decode_drain_serves_queued_then_close(small):
    _, _, model = small
    eng = InferenceEngine(decoder=slab(model, max_slots=2))
    p = np.arange(4) % VOCAB
    futs = [eng.submit([p + i], max_tokens=6) for i in range(5)]
    eng.close(drain_timeout_s=60.0)
    for f in futs:
        assert f.result(0).shape == (6,)  # all served through the drain
    assert eng.stats()["health"] == "closed"
    assert eng.stats()["shed"]["drain"] == 0
