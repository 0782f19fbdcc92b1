"""``reader/prefetch.py`` and ``train(prefetch_depth=)`` in the PyTorch
port, on the CPU (where the producer thread converts the feeds; on the
card it also copies them from pinned memory on its own stream).

The feeds come from numpy seeds; the trainer is a small LM.  Tolerance:
bit for bit, since a prefetched feed holds the same values.
"""

import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.ir import reset_name_counters
from paddle_tpu_torch.models import transformer as tt
from paddle_tpu_torch.reader import prefetch_to_device


def _feeds(n=6):
    out = []
    for i in range(n):
        rng = np.random.RandomState(10 + i)
        out.append({"tokens": rng.randint(0, 30, (2, 8)).astype(np.int32),
                    "targets": rng.randint(0, 30, (2, 8)).astype(np.int32)})
    return out


def _live_producers():
    return [t for t in threading.enumerate()
            if t.name == "prefetch" and t.is_alive()]


def _trainer():
    reset_name_counters()
    pt.init(seed=0, device="cpu")
    cost, _ = tt.build(vocab_size=30, max_len=8, dim=16, num_heads=2,
                       num_layers=1)
    topo = pt.Topology(cost)
    return pt.trainer.SGD(topo, pt.parameters.create(topo),
                          pt.optimizer.Adam(learning_rate=1e-2))


def test_feeds_arrive_in_order():
    feeds = _feeds()
    got = list(prefetch_to_device(lambda: iter(feeds), depth=2,
                                  device="cpu")())
    assert len(got) == len(feeds)
    for g, f in zip(got, feeds):
        assert list(g) == list(f)
        for name in f:
            assert isinstance(g[name], torch.Tensor)
            np.testing.assert_array_equal(g[name].numpy(), f[name])
    assert not _live_producers()


@pytest.mark.parametrize("k", [None, 2])
def test_trajectory_bit_equal_to_no_prefetch(k):
    runs = []
    for depth in (None, 2):
        tr = _trainer()
        costs = []
        tr.train(lambda: iter(_feeds()), num_passes=2,
                 event_handler=lambda e: costs.append(e.cost)
                 if isinstance(e, pt.event.EndIteration) else None,
                 prefetch_depth=depth, steps_per_dispatch=k)
        runs.append((costs, [t.clone() for t in tr._state_tensors()]))
    (c0, s0), (c1, s1) = runs
    assert c0 == c1 and len(c0) == 12
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))
    assert not _live_producers()


def test_producer_exception_is_reraised():
    def reader():
        yield from _feeds(2)
        raise RuntimeError("reader broke at batch 2")

    got = []
    with pytest.raises(RuntimeError, match="reader broke at batch 2"):
        for feed in prefetch_to_device(reader, depth=1, device="cpu")():
            got.append(feed)
    assert len(got) == 2
    tr = _trainer()
    with pytest.raises(RuntimeError, match="reader broke"):
        tr.train(reader, prefetch_depth=2, event_handler=lambda e: None)
    assert not _live_producers()


def test_consumer_that_stops_early_ends_the_producer():
    def endless():
        i = 0
        while True:
            yield {"x": np.full(3, i, np.float32)}
            i += 1

    gen = prefetch_to_device(endless, depth=2, device="cpu")()
    first = next(gen)
    assert first["x"][0] == 0
    time.sleep(0.05)              # the producer fills the queue, blocks
    gen.close()
    assert not _live_producers()
    # an error in the step ends the pass and the producer with it
    tr = _trainer()

    def handler(e):
        if isinstance(e, pt.event.EndIteration) and e.batch_id == 1:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        tr.train(lambda: iter(_feeds()), prefetch_depth=1,
                 event_handler=handler)
    assert not _live_producers()


def test_depth_below_one_raises():
    with pytest.raises(ValueError, match="depth"):
        prefetch_to_device(lambda: iter(_feeds(1)), depth=0, device="cpu")
    tr = _trainer()
    with pytest.raises(ValueError, match="prefetch_depth"):
        tr.train(lambda: iter(_feeds(1)), prefetch_depth=-1,
                 event_handler=lambda e: None)
