"""The PyTorch port's decoders (paddle_tpu_torch/models/transformer.py) on
the CPU against the JAX package's, on one small LM whose JAX parameters are
carried across with ``params_from_jax``: greedy token streams equal to JAX
``PagedDecoder`` / ``SlotDecoder`` (``decode_kernel="xla"``) and
``incremental_generate`` - multi-chunk prefill, co-resident joins, prefix
hit, copy-on-write at divergence, pool exhaustion - and per-step logits
within 1e-4 of a JAX causal forward over the same tokens (float32 rounding
across 2 layers of different summation order)."""

import numpy as np
import pytest

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.models import transformer as jtr
from paddle_tpu.serving.blocks import KVPoolExhausted as JKVPoolExhausted
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.serving.blocks import KVPoolExhausted

VOCAB, MAXLEN, DIM, HEADS, LAYERS = 64, 96, 32, 2, 2
LOGIT_TOL = 1e-4
PAGED = dict(max_slots=2, block_size=8, step_buckets=(2,),
             chunk_buckets=(8, 16))


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


@pytest.fixture(scope="module")
def jpaged(lm):
    """One JAX paged decoder for the module (its executables compile
    once); tests reset it."""
    topo, params, _ = lm
    return jtr.PagedDecoder(topo, params, decode_kernel="xla", **PAGED)


def _port(lm, cls=ttr.PagedDecoder, **kw):
    model = ttr.params_from_jax(lm[2], num_heads=HEADS)
    return cls(model, device="cpu", **(PAGED if not kw else kw))


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, VOCAB, size=n).astype(
        np.int32)


def _incremental(lm, prompt, n):
    topo, params, _ = lm
    out = jtr.incremental_generate(topo, params, prompt[None], max_new=n)
    return out[0, len(prompt):].tolist()


def _jax_logits(lm, tokens):
    """Logits at every position of one causal forward (JAX)."""
    topo, params, values = lm
    dims = jtr._decode_dims(topo, params.values)
    embed, blocks, logits_of, make_cache = jtr._decode_fwd(params.values,
                                                           dims)
    t = len(tokens)
    h, _ = blocks(embed(jnp.asarray(tokens, jnp.int32)[None], 0, t),
                  make_cache(1), 0, t, 1)
    return np.asarray(logits_of(h))[0]


def _stream(dec, prompt, n, logits=None):
    """prefill + n single-row steps in slot 0; port decoders also append
    each step's logits to ``logits``."""
    toks = [int(dec.prefill(0, prompt))]
    if logits is not None:
        lg = dec.last_logits
        logits.append((lg[1] if isinstance(lg, tuple) else lg).numpy())
    pos = len(prompt)
    for _ in range(n):
        nxt = dec.step(1, np.array([toks[-1]], np.int32),
                       np.array([pos], np.int32))
        toks.append(int(nxt[0]))
        if logits is not None:
            lg = dec.last_logits
            logits.append((lg[0] if isinstance(lg, tuple) else lg)[0]
                          .numpy())
        pos += 1
    return toks


def _check_logits(lm, prompt, toks, logits):
    ref = _jax_logits(lm, np.concatenate([prompt, toks[:-1]]))
    want = ref[len(prompt) - 1:]
    np.testing.assert_allclose(np.stack(logits), want, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def test_params_from_jax_keeps_names_layout_and_dims(lm):
    model = ttr.params_from_jax(lm[2], num_heads=HEADS)
    assert (model.n_layers, model.dim, model.max_len, model.vocab,
            model.head_dim) == (LAYERS, DIM, MAXLEN, VOCAB, DIM // HEADS)
    assert set(model.p) == set(lm[2])
    for layer, params in lm[2].items():
        for name, arr in params.items():
            np.testing.assert_array_equal(model.p[layer][name].numpy(), arr)
    with pytest.raises(ValueError, match="divide"):
        ttr.params_from_jax(lm[2], num_heads=3)


def test_multi_chunk_prefill_streams_and_logits(lm, jpaged):
    """A 40-token prompt prefills in three chunks (16, 16, 8)."""
    prompt = _prompt(1, 40)
    logits = []
    got = _stream(_port(lm), prompt, 8, logits)
    jpaged.reset()
    assert got == _stream(jpaged, prompt, 8)
    assert got == _incremental(lm, prompt, 9)
    _check_logits(lm, prompt, got, logits)


def test_slot_decoder_matches_jax_slot_decoder(lm):
    topo, params, _ = lm
    prompt = _prompt(2, 11)
    kw = dict(max_slots=2, step_buckets=(2,), prefill_buckets=(16,))
    logits = []
    got = _stream(_port(lm, ttr.SlotDecoder, **kw), prompt, 8, logits)
    want = _stream(jtr.SlotDecoder(topo, params, decode_kernel="xla", **kw),
                   prompt, 8)
    assert got == want == _incremental(lm, prompt, 9)
    _check_logits(lm, prompt, got, logits)


def _coresident(dec, pa, pb, steps):
    """Slot 0 decodes while slot 1 joins chunk by chunk (the mixed
    iteration), then both decode together.  Returns every call's output."""
    trace = []
    out = {0: [int(dec.prefill(0, pa))], 1: []}
    pos = {0: len(pa), 1: len(pb)}
    assert dec.alloc_sequence(1, pb) == 0
    written, cap = 0, dec.prefill_buckets[-1]
    cn = None
    while written < len(pb):
        clen = min(len(pb) - written, cap)
        dec.ensure_blocks(1, written + clen - 1)
        dec.ensure_blocks(0, pos[0])
        nxt, cn = dec.mixed_step(
            1, np.array([out[0][-1]], np.int32),
            np.array([pos[0]], np.int32), live=np.array([True]),
            chunk=(1, pb[written:written + clen], written))
        trace.append((np.asarray(nxt).tolist(), cn))
        out[0].append(int(nxt[0]))
        pos[0] += 1
        written += clen
    dec.register_prefix(1)
    out[1].append(int(cn))
    for _ in range(steps):
        for s in (0, 1):
            dec.ensure_blocks(s, pos[s])
        nxt, _ = dec.mixed_step(
            2, np.array([out[0][-1], out[1][-1]], np.int32),
            np.array([pos[0], pos[1]], np.int32),
            live=np.array([True, True]))
        trace.append((np.asarray(nxt).tolist(), None))
        for s in (0, 1):
            out[s].append(int(nxt[s]))
            pos[s] += 1
    return out, trace


def test_coresident_join_matches_jax_and_oracle(lm, jpaged):
    pa, pb = _prompt(3, 9), _prompt(4, 21)
    got, got_trace = _coresident(_port(lm), pa, pb, 5)
    jpaged.reset()
    want, want_trace = _coresident(jpaged, pa, pb, 5)
    assert got_trace == want_trace
    assert got[0] == _incremental(lm, pa, len(got[0]))
    assert got[1] == _incremental(lm, pb, len(got[1]))


def test_prefix_hit_and_cow_match_jax_and_oracle(lm, jpaged):
    """A registered 24-token prompt (3 full blocks) serves a later prompt
    sharing 2 blocks (prefix hit), then its own first 16 tokens (the
    match ends mid-block: one copy-on-write)."""
    pa = _prompt(5, 24)
    pc = np.concatenate([pa[:16], _prompt(6, 7)])
    results = []
    for dec in (_port(lm), jpaged):
        dec.reset()
        streams = []
        for prompt in (pa, pc, pa[:16]):
            streams.append(_stream(dec, prompt, 5))
            dec.release_sequence(0)
        st = dec.pool_stats()
        results.append((streams, st["prefix_hits"], st["cow_copies"]))
    assert results[0] == results[1]
    streams, hits, cows = results[0]
    assert hits >= 2 and cows == 1
    for prompt, s in zip((pa, pc, pa[:16]), streams):
        assert s == _incremental(lm, prompt, 6)


def test_pool_exhaustion_raises_typed(lm, jpaged):
    topo, params, _ = lm
    kw = dict(PAGED, num_blocks=3)
    prompt = _prompt(7, 30)                  # needs 4 blocks of 8
    with pytest.raises(KVPoolExhausted):
        _port(lm, **kw).prefill(0, prompt)
    with pytest.raises(JKVPoolExhausted):
        jtr.PagedDecoder(topo, params, decode_kernel="xla",
                         **kw).prefill(0, prompt)


def test_decoder_validation(lm):
    with pytest.raises(NotImplementedError, match="sampling"):
        _port(lm, sampling=True, **PAGED)
    with pytest.raises(ValueError, match="decode_kernel"):
        _port(lm, decode_kernel="pallas", **PAGED)
    with pytest.raises(ValueError, match="block_size"):
        _port(lm, max_slots=2, block_size=MAXLEN + 1)
