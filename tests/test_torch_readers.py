"""The port's reader decorators, ``plot`` and the datasets mq2007,
sentiment, uci_housing and voc2012 against the JAX package's on the CPU:
the same readers give the same samples (a seeded shuffle the same order),
the plot's text fallback the same lines, and the synthetic datasets the
same draws from the same seeds, value for value."""

import sys

import numpy as np
import pytest

import paddle_tpu as pj
import paddle_tpu_torch as pt


def _base():
    return lambda: iter(range(10))


def _letters():
    return lambda: iter("abcdefghij")


def _decorated(paddle):
    """name -> reader, from the package's decorators."""
    d = paddle.reader.decorator
    return {
        "map_readers": d.map_readers(lambda a, b: (a, b), _base(),
                                     _letters()),
        "shuffle": d.shuffle(_base(), 4, seed=3),
        "shuffle_tail": d.shuffle(lambda: iter(range(7)), 3, seed=5),
        "chain": d.chain(_base(), _letters()),
        "compose": d.compose(lambda: iter([(1, 2), (3, 4)]),
                             lambda: iter(["x", "y"])),
        "buffered": d.buffered(_base(), 2),
        "firstn": d.firstn(_base(), 4),
        "xmap_ordered": d.xmap_readers(lambda v: v * v, _base(), 3, 4,
                                       order=True),
        "cache": d.cache(_base()),
        "batched": d.batched(_base(), 4, drop_last=False),
    }


@pytest.mark.parametrize("name", sorted(_decorated(pt)))
def test_decorator_matches_jax(name):
    got, want = _decorated(pt)[name], _decorated(pj)[name]
    assert list(got()) == list(want())
    assert list(got()) == list(want())      # a second pass alike


def test_xmap_unordered_and_shuffle_pool():
    d = pt.reader.decorator
    out = list(d.xmap_readers(lambda v: -v, _base(), 4, 2)())
    assert sorted(out) == sorted(-v for v in range(10))
    # a pool shuffles within its buffer only
    s = list(d.shuffle(_base(), 5, seed=0)())
    assert sorted(s[:5]) == [0, 1, 2, 3, 4] and sorted(s[5:]) == [5, 6, 7,
                                                                   8, 9]


def test_provider_shuffles_its_pool():
    """A training provider with no should_shuffle shuffles (a pool of
    pool_size); a test provider keeps its order."""
    from paddle_tpu_torch.py_data_provider2 import provider, integer_value

    @provider(input_types={"x": integer_value(100)}, pool_size=100)
    def gen(settings, fname):
        for i in range(100):
            yield {"x": i}

    train = [s[0] for s in gen.reader([None], is_train=True)()]
    test = [s[0] for s in gen.reader([None], is_train=False)()]
    assert sorted(train) == test == list(range(100))
    assert train != test


@pytest.mark.parametrize("paddle", [pt, pj], ids=["port", "jax"])
def test_plot_without_matplotlib(paddle, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    p = paddle.plot.Ploter("train cost", "test cost")
    for step, v in enumerate([3.0, 2.0, 1.5, 1.0]):
        p.append("train cost", step, v)
    p.append("test cost", 3, 1.2)
    with pytest.raises(ValueError, match="unknown series"):
        p.append("other", 0, 1.0)
    p.plot()
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and lines[0].endswith("1.0000")
    p.reset()
    assert p.data == {"train cost": [], "test cost": []}


def test_plot_lines_match_jax(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = []
    for paddle in (pt, pj):
        p = paddle.plot.Ploter("cost")
        for step in range(70):
            p.append("cost", step, np.sin(step / 7.0))
        p.plot()
        out.append(capsys.readouterr().out)
    assert out[0] == out[1]


def _draws(paddle, name):
    ds = getattr(paddle.dataset, name)
    if name == "mq2007":
        readers = [ds.train(format=f, n=6) for f in
                   ("pointwise", "pairwise", "listwise")] + [
            ds.test(format="pairwise", n=4)]
    elif name == "voc2012":
        readers = [ds.train(n=5, image_size=16), ds.test(n=3)]
    else:
        readers = [ds.train(n=12), ds.test(n=5)]
    return [list(r()) for r in readers]


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [v for item in x for v in _flat(item)]
    return [np.asarray(x)]


@pytest.mark.parametrize("name", ["mq2007", "sentiment", "uci_housing",
                                  "voc2012"])
def test_dataset_draws_match_jax(name):
    # both packages read the same data cache (a cached housing.data
    # serves both), else draw the synthetic stream
    got, want = _draws(pt, name), _draws(pj, name)
    assert [len(r) for r in got] == [len(r) for r in want]
    assert all(len(r) for r in got)
    for a, b in zip(_flat(got), _flat(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
