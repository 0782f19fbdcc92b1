"""Seeded sampling in the port's ``PagedDecoder(sampling=True)`` against the
JAX package's, on one small LM carried across with ``params_from_jax``.

The pick is the JAX decoder's ``pick_fn``: held token for token over a grid
of temperature x top_k x top_p with JAX's own Gumbel draws
(``jax.random.gumbel`` on the keys the JAX decoder folds from the seed and
the generated position) fed to the port in place of ``sample_noise``, and
the candidate sets compared with the ones the JAX decoder hands
``jax.random.categorical`` (read by a spy on it).  Seeded requests through
both engines give equal streams; greedy rows are bit-equal to the greedy
decoder's; the port's own noise makes a stream deterministic per seed and
independent of its batch companions; the knobs are validated with typed
errors, as ``tests/test_paged_decode.py``'s sampling tests require."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import transformer as jtr
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.serving import (InferenceEngine, ServingClient,
                                      local_transport)

VOCAB, MAXLEN, DIM, HEADS, LAYERS = 48, 64, 32, 2, 2
ROWS = 8
DECODER = dict(max_slots=ROWS, block_size=8, step_buckets=(ROWS,),
               chunk_buckets=(8, 16))
ENGINE_DECODER = dict(max_slots=4, block_size=8, step_buckets=(2, 4),
                      chunk_buckets=(8, 16))
TEMPS = (0.0, 1e-7, 0.7, 1.0)
TOP_KS = (0, 1, 5, VOCAB)
TOP_PS = (0.0, 0.3, 0.9, 1.0)
PROMPT_LEN = 6
# the logits of the two packages agree to float32 rounding (LOGIT_TOL in
# tests/test_torch_decoder.py); the masked values are compared in logit
# units, i.e. times max(temperature, 1e-6)
LOGIT_TOL = 1e-4


def _jax_key(seed: int, pos1: int):
    k0 = jax.random.PRNGKey(0)
    return jax.random.fold_in(jax.random.fold_in(k0, seed), pos1)


def jax_noise(seed, pos1, vocab):
    """The JAX decoder's draw for each row: ``jax.random.gumbel`` on
    ``fold_in(fold_in(PRNGKey(0), seed), pos1)`` (``categorical``'s own
    noise), as a tensor on ``seed``'s device."""
    rows = [np.asarray(jax.random.gumbel(_jax_key(int(s), int(p)), (vocab,),
                                         jnp.float32))
            for s, p in zip(seed.tolist(), pos1.tolist())]
    return torch.from_numpy(np.stack(rows)).to(seed.device)


@pytest.fixture(scope="module")
def lm():
    paddle.init(seed=0)
    cost, _ = jtr.build(vocab_size=VOCAB, max_len=MAXLEN, dim=DIM,
                        num_heads=HEADS, num_layers=LAYERS)
    topo = paddle.Topology(cost, collect_evaluators=False)
    params = paddle.parameters.create(topo)
    values = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
              for k, v in params.values.items()}
    return topo, params, values


def _model(lm):
    return ttr.params_from_jax(lm[2], num_heads=HEADS)


def _prompts(n, length=PROMPT_LEN, seed=0):
    return [np.random.RandomState(seed + i).randint(0, VOCAB, size=length)
            .astype(np.int32) for i in range(n)]


@pytest.fixture(scope="module")
def pair(lm):
    """JAX and port sampling decoders, each with the same ROWS sequences
    resident after their prompts' prefill; ``jax.random.categorical`` is
    spied on while the JAX executables trace, recording each row's masked
    logits under its PRNG key."""
    topo, params, _ = lm
    seen = {}
    orig = jax.random.categorical

    def spy(key, logits, *args, **kw):
        jax.debug.callback(
            lambda k, m: seen.__setitem__(tuple(np.asarray(k).tolist()),
                                          np.asarray(m)), key, logits)
        return orig(key, logits, *args, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "categorical", spy)
    jd = jtr.PagedDecoder(topo, params, decode_kernel="xla", sampling=True,
                          **DECODER)
    td = ttr.PagedDecoder(_model(lm), device="cpu", sampling=True, **DECODER)
    firsts = []
    for d in (jd, td):
        got = []
        for slot, p in enumerate(_prompts(ROWS)):
            d.alloc_sequence(slot, p)
            d.ensure_blocks(slot, PROMPT_LEN)
            _, first = d.mixed_step(0, (), (), live=(),
                                    chunk=(slot, p, 0))
            d.register_prefix(slot)
            got.append(int(first))
        firsts.append(got)
    assert firsts[0] == firsts[1]
    yield jd, td, np.asarray(firsts[0], np.int32), seen
    mp.undo()


@pytest.mark.parametrize("temp", TEMPS)
def test_pick_matches_jax_over_grid(pair, temp, monkeypatch):
    """Every (top_k, top_p) of the grid at this temperature, 8 rows a
    mixed step: the port's tokens equal the JAX decoder's under JAX's
    draws, and the candidate sets are equal."""
    jd, td, tokens, seen = pair
    monkeypatch.setattr(ttr, "sample_noise", jax_noise)
    combos = [(k, p) for k in TOP_KS for p in TOP_PS]
    pos = np.full(ROWS, PROMPT_LEN, np.int32)
    live = np.ones(ROWS, bool)
    base = 1000 * (TEMPS.index(temp) + 1)
    for half in range(len(combos) // ROWS):
        ks, ps = zip(*combos[half * ROWS:(half + 1) * ROWS])
        seeds = base + 10 * half + np.arange(ROWS, dtype=np.int32)
        rows = (np.full(ROWS, temp, np.float32), np.int32(ks),
                np.float32(ps), seeds)
        seen.clear()
        want = jd.mixed_step(ROWS, tokens, pos, live=live,
                             sample_rows=rows)[0]
        got = td.mixed_step(ROWS, tokens, pos, live=live,
                            sample_rows=rows)[0]
        assert got.tolist() == want.tolist(), (ks, ps)
        jmask = np.stack([seen[tuple(np.asarray(
            _jax_key(int(s), PROMPT_LEN + 1)).tolist())] for s in seeds])
        tmask = ttr.sample_mask(
            td.last_logits[0][:ROWS], torch.from_numpy(rows[0]),
            torch.from_numpy(rows[1]), torch.from_numpy(rows[2])).numpy()
        kept = np.isfinite(jmask)
        np.testing.assert_array_equal(kept, np.isfinite(tmask))
        scale = max(temp, 1e-6)
        np.testing.assert_allclose(tmask[kept] * scale, jmask[kept] * scale,
                                   rtol=0, atol=LOGIT_TOL)
        # top_k=1 keeps exactly the argmax
        for r, k in enumerate(ks):
            if k == 1:
                assert kept[r].sum() == 1


def test_zero_temperature_rows_are_bit_equal_greedy(pair, lm):
    """Rows at temperature 0 beside sampled rows: the greedy decoder's
    token and logits, bit for bit."""
    _, td, tokens, _ = pair
    greedy = ttr.PagedDecoder(_model(lm), device="cpu", **DECODER)
    for slot, p in enumerate(_prompts(ROWS)):
        greedy.alloc_sequence(slot, p)
        greedy.ensure_blocks(slot, PROMPT_LEN)
        greedy.mixed_step(0, (), (), live=(), chunk=(slot, p, 0))
    pos = np.full(ROWS, PROMPT_LEN, np.int32)
    live = np.ones(ROWS, bool)
    want = greedy.mixed_step(ROWS, tokens, pos, live=live)[0]
    temps = np.where(np.arange(ROWS) % 2, 0.9, 0.0).astype(np.float32)
    got = td.mixed_step(ROWS, tokens, pos, live=live, sample_rows=(
        temps, np.zeros(ROWS, np.int32), np.zeros(ROWS, np.float32),
        np.arange(ROWS, dtype=np.int32)))[0]
    assert torch.equal(greedy.last_logits[0], td.last_logits[0])
    assert got[temps == 0].tolist() == want[temps == 0].tolist()


def _knobs(i):
    return [dict(temperature=0.8, top_k=5, top_p=0.9, seed=11),
            dict(temperature=1.0, top_p=0.95, seed=12),
            dict(temperature=0.7, seed=13),
            dict(temperature=1.2, top_k=10, top_p=1.0, seed=14)][i]


def test_seeded_requests_match_jax_engine(lm, monkeypatch):
    """Four seeded requests, all in flight at once, through the JAX engine
    and the port's: equal streams with the JAX draws swapped in."""
    topo, params, _ = lm
    monkeypatch.setattr(ttr, "sample_noise", jax_noise)
    prompts = _prompts(4, seed=40)
    jeng = JaxEngine(decoder=jtr.PagedDecoder(
        topo, params, decode_kernel="xla", sampling=True, **ENGINE_DECODER))
    try:
        futs = [jeng.submit([p], max_tokens=8, **_knobs(i))
                for i, p in enumerate(prompts)]
        want = [f.result(120).tolist() for f in futs]
    finally:
        jeng.close()
    eng = InferenceEngine(ttr.PagedDecoder(_model(lm), device="cpu",
                                           sampling=True, **ENGINE_DECODER))
    try:
        futs = [eng.submit([p], max_tokens=8, **_knobs(i))
                for i, p in enumerate(prompts)]
        got = [f.result(60).tolist() for f in futs]
    finally:
        eng.close()
    assert got == want


def test_greedy_default_bit_equal(lm):
    """Requests without knobs, with temperature 0, and with top_k 1 at any
    temperature decode as the greedy engine does, which is the JAX
    package's ``incremental_generate``."""
    topo, params, _ = lm
    p = (np.arange(7, dtype=np.int32) % 40) + 1
    ref = jtr.incremental_generate(topo, params, p[None], max_new=6)
    eng_g = InferenceEngine(ttr.PagedDecoder(_model(lm), device="cpu",
                                             **ENGINE_DECODER))
    eng_s = InferenceEngine(ttr.PagedDecoder(_model(lm), device="cpu",
                                             sampling=True,
                                             **ENGINE_DECODER))
    try:
        want = eng_g.infer([p], 60, max_tokens=6).tolist()
        assert want == ref[0, len(p):].tolist()
        assert eng_s.infer([p], 60, max_tokens=6).tolist() == want
        assert eng_s.submit([p], max_tokens=6, temperature=0.0,
                            seed=5).result(60).tolist() == want
        assert eng_s.submit([p], max_tokens=6, temperature=2.0, top_k=1,
                            seed=5).result(60).tolist() == want
    finally:
        eng_g.close()
        eng_s.close()


def test_streams_deterministic_per_seed_and_free_of_companions(lm):
    """The port's own noise: a seeded request gives one stream alone, with
    companions (greedy and other seeds) and in a fresh engine; another seed
    gives another stream."""
    p = _prompts(1, seed=7)[0]
    kw = dict(max_tokens=10, temperature=0.9, top_p=0.95)

    def engine():
        return InferenceEngine(ttr.PagedDecoder(
            _model(lm), device="cpu", sampling=True, **ENGINE_DECODER))

    eng = engine()
    try:
        alone = eng.submit([p], seed=7, **kw).result(60).tolist()
        others = [eng.submit([q], max_tokens=10, **(
            dict(temperature=1.0, seed=100 + i) if i % 2 else {}))
            for i, q in enumerate(_prompts(3, seed=70))]
        crowded = eng.submit([p], seed=7, **kw)
        assert crowded.result(60).tolist() == alone
        for f in others:
            f.result(60)
        other_seed = eng.submit([p], seed=8, **kw).result(60).tolist()
        assert other_seed != alone
    finally:
        eng.close()
    eng = engine()
    try:
        assert eng.submit([p], seed=7, **kw).result(60).tolist() == alone
    finally:
        eng.close()


def test_sample_noise_depends_only_on_seed_position_and_index():
    """Counter-based: a row's draw is the same in any batch and on any
    row; seeds and positions move it; its mean is Gumbel's (Euler's
    constant)."""
    seed = torch.tensor([3, 3, 9], dtype=torch.int32)
    pos1 = torch.tensor([5, 6, 5], dtype=torch.int32)
    g = ttr.sample_noise(seed, pos1, 4096)
    assert g.dtype == torch.float32 and g.shape == (3, 4096)
    alone = ttr.sample_noise(seed[2:], pos1[2:], 4096)
    assert torch.equal(g[2:], alone)
    assert not torch.equal(g[0], g[1]) and not torch.equal(g[0], g[2])
    assert torch.isfinite(g).all()
    assert abs(float(g.mean()) - 0.5772) < 0.05
    assert torch.equal(ttr.sample_noise(seed, pos1, 4096), g)
    # the extreme hashes: u stays inside (0, 1), the noise finite (a
    # 24-bit u rounds to 1 at the top and gives +inf, and -inf + inf is a
    # NaN that argmax picks)
    ends = ttr._gumbel(torch.tensor([0, 2 ** 31, 2 ** 32 - 1]))
    assert torch.isfinite(ends).all() and ends[0] < ends[1] < ends[2]


def test_sampling_validation_typed(lm):
    """Mirrors ``tests/test_paged_decode.py::test_sampling_validation_typed``:
    the knobs on a greedy decoder (paged or slab) fail with a typed error
    naming the fix; out-of-range knobs fail typed."""
    model = _model(lm)
    eng_g = InferenceEngine(ttr.PagedDecoder(model, device="cpu",
                                             **ENGINE_DECODER))
    eng_slab = InferenceEngine(ttr.SlotDecoder(model, max_slots=2,
                                               device="cpu"))
    eng_s = InferenceEngine(ttr.PagedDecoder(model, device="cpu",
                                             sampling=True,
                                             **ENGINE_DECODER))
    try:
        p = np.arange(4, dtype=np.int32) + 1
        for eng in (eng_g, eng_slab):
            with pytest.raises(ValueError, match="sampling-enabled"):
                eng.submit([p], max_tokens=2, temperature=0.5).result(10)
            with pytest.raises(ValueError, match="sampling-enabled"):
                eng.submit([p], max_tokens=2, seed=3).result(10)
        for bad in (dict(temperature=-1.0), dict(top_k=-2),
                    dict(top_p=1.5), dict(top_p=-0.1),
                    dict(temperature=float("nan"))):
            with pytest.raises(ValueError):
                eng_s.submit([p], max_tokens=2, **bad).result(10)
        assert eng_s.stats()["errors"] == 5
        # a knob without a temperature samples at 1.0
        a = eng_s.submit([p], max_tokens=6, seed=21).result(60).tolist()
        b = eng_s.submit([p], max_tokens=6, temperature=1.0,
                         seed=21).result(60).tolist()
        assert a == b
    finally:
        for eng in (eng_g, eng_slab, eng_s):
            eng.close()


def test_sampling_http_and_client_roundtrip(lm):
    eng = InferenceEngine(ttr.PagedDecoder(_model(lm), device="cpu",
                                           sampling=True, **ENGINE_DECODER),
                          default_max_tokens=4)
    try:
        handler = eng.http_handlers()["/infer"]
        doc = {"input": [[1, 2, 3]], "temperature": 0.8, "seed": 11}
        code, _, body = handler("POST", json.dumps(doc).encode())[:3]
        assert code == 200
        a = json.loads(body)["outputs"]["tokens"]
        assert len(a) == 4
        code, _, body = handler("POST", json.dumps(doc).encode())[:3]
        assert json.loads(body)["outputs"]["tokens"] == a
        client = ServingClient("http://in-process",
                               transport=local_transport(eng))
        out = client.infer([[1, 2, 3]], max_tokens=4, temperature=0.8,
                           seed=11)
        assert out["tokens"].tolist() == a
        code, _, body = handler("POST", json.dumps(
            {"input": [[1, 2, 3]], "top_p": 2.0}).encode())[:3]
        assert code == 400 and "top_p" in json.loads(body)["error"]
    finally:
        eng.close()
