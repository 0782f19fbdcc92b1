"""2-D (rows x seqlen) bucketing on the port's training loop
(``train(seq_buckets=)`` and ``DataFeeder.feed(seq_pad=)``), mirroring
``tests/test_trainer_bucketing.py``, against the JAX package on the CPU.

The model: a dense sequence input (dim 4, max_len 64), fc 8 tanh over
each step, last_seq, fc 2, classification cost; samples of lengths 4 to
28 from a numpy seed.  Tolerances: feeds bit for bit; the port against
itself bit for bit; losses against the JAX package within 1e-5 relative.
"""

import io

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.core.ir import reset_name_counters as reset_jax_names
from paddle_tpu_torch.core.ir import reset_name_counters as reset_port_names

MAX_LEN = 64


def _topo(paddle, max_len=MAX_LEN, seq=True):
    layer = paddle.layer
    if seq:
        x = layer.data("x", paddle.data_type.dense_vector_sequence(
            4, max_len=max_len))
        h = layer.last_seq(layer.fc(x, size=8, act="tanh", name="h"),
                           name="last")
    else:
        x = layer.data("x", paddle.data_type.dense_vector(4))
        h = layer.fc(x, size=8, act="tanh", name="h")
    y = layer.data("y", paddle.data_type.integer_value(2))
    cost = layer.classification_cost(layer.fc(h, size=2, name="out"), y,
                                     name="cost")
    if paddle is pj:
        return pj.Topology(cost, collect_evaluators=False)
    return pt.Topology(cost)


def _both(**kw):
    reset_jax_names()
    reset_port_names()
    pj.init(seed=0)
    pt.init(seed=0, device="cpu")
    return _topo(pt, **kw), _topo(pj, **kw)


def _trainers(ttopo, jtopo):
    jparams = pj.parameters.create(jtopo)
    buf = io.BytesIO()
    jparams.to_tar(buf)
    buf.seek(0)
    tparams = pt.parameters.create(ttopo, device="cpu")
    tparams.from_tar(buf)
    return (pt.trainer.SGD(ttopo, tparams, pt.optimizer.Momentum(
                learning_rate=0.05, momentum=0.9)),
            pj.trainer.SGD(jtopo, jparams, pj.optimizer.Momentum(
                learning_rate=0.05, momentum=0.9)))


def _ragged_samples(n=64, lo=4, hi=28, seed=0):
    rng = np.random.RandomState(seed)
    lens = rng.randint(lo, hi + 1, size=n)
    return [(rng.randn(L, 4).astype(np.float32), int(L % 2)) for L in lens]


def _paired_samples():
    """8 batches of 8 whose longest sequences are 16, 16, 32, 32, 16, 16,
    32, 32: with k = 2 every pair is one chunk of one bucket."""
    rng = np.random.RandomState(1)
    out = []
    for top in (16, 16, 32, 32) * 2:
        for i in range(8):
            L = top if i == 0 else int(rng.randint(4, top))
            out.append((rng.randn(L, 4).astype(np.float32), int(L % 2)))
    return out


def _train(paddle, tr, samples, **kw):
    costs = []
    tr.train(paddle.reader.batched(lambda: iter(samples), 8),
             event_handler=lambda e: costs.append(e.cost)
             if isinstance(e, paddle.event.EndIteration) else None,
             feeding={"x": 0, "y": 1}, **kw)
    return costs


@pytest.mark.parametrize("buckets,pads", [
    (True, {8, 16, 32}), ("auto", {8, 16, 32}), ([16, 32], {16, 32}),
    ([8, 12], {8, 12, MAX_LEN})], ids=["true", "auto", "list", "outgrow"])
def test_bucketed_feeds_equal_jax(buckets, pads):
    """The converter's feeds, batch by batch, equal the JAX trainer's bit
    for bit: powers of two capped at max_len, a pinned list, and a list
    the longer batches outgrow (the plain path, padded to max_len)."""
    ttopo, jtopo = _both()
    ttr, jtr = _trainers(ttopo, jtopo)
    feeding = {"x": 0, "y": 1}
    tconv = ttr._make_feed_converter(pt.data_feeder.DataFeeder(
        ttopo, feeding), buckets)
    jconv = jtr._make_feed_converter(pj.data_feeder.DataFeeder(
        jtopo, feeding), buckets)
    samples = sorted(_ragged_samples(), key=lambda s: len(s[0]))
    seen = set()
    for i in range(0, len(samples), 8):
        batch = samples[i:i + 8]
        tf, jf = tconv(batch), jconv(batch)
        assert list(tf) == list(jf)
        for name in tf:
            assert tf[name].dtype == jf[name].dtype, name
            np.testing.assert_array_equal(tf[name], jf[name], err_msg=name)
        seen.add(tf["x"].shape[1])
    assert seen == pads


def test_index_sequences_pad_like_jax():
    """Integer sequences (the LM's tokens) through ``seq_pad``: the same
    arrays and lengths as the JAX feeder, capped at max_len."""
    from paddle_tpu.models import transformer as jt
    from paddle_tpu_torch.models import transformer as tt

    reset_jax_names()
    reset_port_names()
    kw = dict(vocab_size=50, max_len=12, dim=16, num_heads=2, num_layers=1)
    ttopo = pt.Topology(tt.build(**kw)[0])
    jtopo = pj.Topology(jt.build(**kw)[0], collect_evaluators=False)
    rng = np.random.RandomState(2)
    batch = [(rng.randint(0, 50, n).tolist(), rng.randint(0, 50, n).tolist())
             for n in (3, 9, 14)]
    feeding = {"tokens": 0, "targets": 1}
    for pad in (12, 16, 40):
        tf = pt.data_feeder.DataFeeder(ttopo, feeding).feed(batch,
                                                            seq_pad=pad)
        jf = pj.data_feeder.DataFeeder(jtopo, feeding).feed(batch,
                                                            seq_pad=pad)
        assert list(tf) == list(jf)
        for name in tf:
            np.testing.assert_array_equal(tf[name], jf[name])
        assert tf["tokens"].shape == (3, 12)


def test_feed_seq_pad_truncation_raises():
    """A pad below the batch's longest sequence raises naming the input in
    both packages; a covering pad gives the bucket's shape; truncation at
    the declared max_len stays the layer's contract."""
    ttopo, jtopo = _both()
    rng = np.random.RandomState(3)
    batch = [(rng.randn(20, 4).astype(np.float32), 1),
             (rng.randn(6, 4).astype(np.float32), 0)]
    for paddle, topo in ((pt, ttopo), (pj, jtopo)):
        feeder = paddle.data_feeder.DataFeeder(topo, {"x": 0, "y": 1})
        with pytest.raises(ValueError, match="'x'"):
            feeder.feed(batch, seq_pad=16)
        assert feeder.feed(batch, seq_pad=32)["x"].shape == (2, 32, 4)
        long = [(rng.randn(MAX_LEN + 9, 4).astype(np.float32), 1)]
        out = feeder.feed(long, seq_pad=MAX_LEN)
        assert out["x"].shape == (1, MAX_LEN, 4)
        assert out["x@len"][0] == MAX_LEN


@pytest.mark.parametrize("k", [None, 2])
def test_single_bucket_bit_equal_to_unbucketed(k):
    """A bucket list holding only the declared max_len is the plain path:
    the same feeds, the trajectory bit for bit, one chunk signature."""
    samples = _ragged_samples()
    runs = []
    for buckets in (None, [MAX_LEN]):
        ttopo, jtopo = _both()
        tr, _ = _trainers(ttopo, jtopo)
        costs = _train(pt, tr, samples, num_passes=2, seq_buckets=buckets,
                       steps_per_dispatch=k)
        runs.append((costs, [t.clone() for t in tr._state_tensors()],
                     tr.step_capture_count))
    (c0, s0, n0), (c1, s1, n1) = runs
    assert c0 == c1 and len(c0) == 16
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))
    assert n0 == n1 == (1 if k else 0)


def test_capture_count_pinned_at_bucket_set():
    """Chunks of k = 2 over batches in two buckets, drawn through the
    prefetch queue: one prepared chunk a bucket, and later passes add
    none; the trajectory equals the per-step bucketed run's."""
    samples = _paired_samples()
    ttopo, jtopo = _both()
    tr, _ = _trainers(ttopo, jtopo)
    costs = _train(pt, tr, samples, num_passes=1, seq_buckets=True,
                   steps_per_dispatch=2, prefetch_depth=2)
    assert tr.step_capture_count == 2
    costs += _train(pt, tr, samples, num_passes=2, seq_buckets=True,
                    steps_per_dispatch=2, prefetch_depth=2)
    assert tr.step_capture_count == 2
    ttopo, jtopo = _both()
    plain, _ = _trainers(ttopo, jtopo)
    ref = _train(pt, plain, samples, num_passes=3, seq_buckets=True)
    assert costs == ref
    assert all(torch.equal(a, b) for a, b in
               zip(tr._state_tensors(), plain._state_tensors()))


def test_seq_buckets_requires_sequence_input():
    """No plain sequence input, or a bucket below 1: both raise."""
    for seq, buckets in ((False, True), (True, [0, 8])):
        ttopo, _ = _both(seq=seq)
        tr = pt.trainer.SGD(ttopo, pt.parameters.create(ttopo,
                                                        device="cpu"),
                            pt.optimizer.Momentum(learning_rate=0.1))
        with pytest.raises(ValueError, match="seq_buckets"):
            tr.train(lambda: iter([]), feeding={"x": 0, "y": 1},
                     seq_buckets=buckets)


@pytest.mark.parametrize("k", [None, 2])
def test_bucketed_losses_match_jax(k):
    """From the same weights, two passes with ``seq_buckets=True`` (and
    k = 2 chunks): the port's losses and parameters match the JAX
    package's."""
    samples = sorted(_ragged_samples(), key=lambda s: len(s[0]))
    ttopo, jtopo = _both()
    ttr, jtr = _trainers(ttopo, jtopo)
    tc = _train(pt, ttr, samples, num_passes=2, seq_buckets=True,
                steps_per_dispatch=k)
    jc = _train(pj, jtr, samples, num_passes=2, seq_buckets=True,
                steps_per_dispatch=k)
    assert len(tc) == 16
    np.testing.assert_allclose(tc, jc, rtol=1e-5, atol=0)
    for key in ttr.parameters.keys():
        np.testing.assert_allclose(ttr.parameters[key], jtr.parameters[key],
                                   atol=1e-5, err_msg=key)
