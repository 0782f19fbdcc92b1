"""Paged decode attention of the PyTorch port (paddle_tpu_torch/ops/
paged_attention.py) against the JAX package on the cases of
tests/test_paged_attention.py: geometry sweep, kv-splits (even and uneven),
scratch-block hole rows, prefix-shared blocks, post-COW divergence and the
slab identity table.  The port's plain version (``impl="torch"``, and the
CPU route of ``impl=None``) is held against JAX ``impl="xla"`` and the
Pallas kernel under the interpreter.  The split arithmetic of the CUDA
kernel - its cut of each row's live blocks (``_split_bounds``), the
per-split state and its fixed-order fold (``fold_splits``) - is checked
on the CPU through a numpy model of each split's state, against the JAX
kernel at every case and split count.  Float32; tolerance 1e-5."""

import importlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.config import LOG2E, NEG_INF
from paddle_tpu_torch.ops import paged_attention as tpa

jpa = importlib.import_module("paddle_tpu.ops.paged_attention")

TOL = dict(atol=1e-5, rtol=1e-5)


def _rand_pool(rng, nb, bs, h, d):
    return (rng.randn(nb, bs, h, d).astype(np.float32),
            rng.randn(nb, bs, h, d).astype(np.float32))


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _check(q, pk, pv, table, pos, t_max):
    """Port plain version == JAX xla == JAX interpret; returns the port's
    output as numpy."""
    got = tpa.paged_decode_attention(*_torch(q, pk, pv, table, pos),
                                     t_max=t_max, impl="torch").numpy()
    for jimpl in ("xla", "interpret"):
        want = jpa.paged_decode_attention(q, pk, pv, table, pos,
                                          t_max=t_max, impl=jimpl)
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
    return got


def _case_geometry(bs, mb):
    rng = np.random.RandomState(bs * 31 + mb)
    s, h, d = 3, 2, 8
    nb = 1 + s * mb
    pk, pv = _rand_pool(rng, nb, bs, h, d)
    q = rng.randn(s, h, d).astype(np.float32)
    table = (rng.permutation(nb - 1)[:s * mb] + 1).reshape(s, mb)
    t_max = mb * bs
    pos = np.array([t_max - 1, t_max // 2, 0])
    return q, pk, pv, table.astype(np.int32), pos.astype(np.int32), t_max


def _case_holes():
    rng = np.random.RandomState(3)
    s, h, d, bs, mb = 4, 2, 8, 8, 2
    pk, pv = _rand_pool(rng, 6, bs, h, d)
    q = rng.randn(s, h, d).astype(np.float32)
    table = np.zeros((s, mb), np.int32)
    table[1] = [2, 3]
    pos = np.array([0, 11, 0, 0], np.int32)   # rows 0/2/3 are holes
    return q, pk, pv, table, pos, bs * mb


def _case_prefix_shared():
    rng = np.random.RandomState(11)
    h, d, bs, mb = 2, 8, 8, 3
    pk, pv = _rand_pool(rng, 8, bs, h, d)
    table = np.array([[4, 5, 6], [4, 5, 7]], np.int32)
    pos = np.array([bs * mb - 1, bs * mb - 1], np.int32)
    q1 = rng.randn(1, h, d).astype(np.float32)
    return np.concatenate([q1, q1]), pk, pv, table, pos, bs * mb


def _case_post_cow():
    rng = np.random.RandomState(13)
    h, d, bs, mb = 2, 8, 4, 2
    pk, pv = _rand_pool(rng, 6, bs, h, d)
    pk[3], pv[3] = pk[2], pv[2]               # COW copy of block 2...
    pk[3, -1] += 1.0                          # ...diverged in place
    table = np.array([[1, 2], [1, 3]], np.int32)
    pos = np.array([7, 7], np.int32)
    q1 = rng.randn(1, h, d).astype(np.float32)
    return np.concatenate([q1, q1]), pk, pv, table, pos, bs * mb


def _case_slab():
    rng = np.random.RandomState(17)
    s, t, h, d = 3, 16, 2, 8
    ck, cv = _rand_pool(rng, s, t, h, d)
    q = rng.randn(s, h, d).astype(np.float32)
    ident = np.arange(s, dtype=np.int32)[:, None]
    return q, ck, cv, ident, np.array([15, 6, 0], np.int32), t


CASES = {f"geometry_bs{bs}_mb{mb}": (lambda bs=bs, mb=mb:
                                     _case_geometry(bs, mb))
         for bs, mb in [(4, 2), (8, 4), (16, 2), (8, 1)]}
CASES.update(holes=_case_holes, prefix_shared=_case_prefix_shared,
             post_cow=_case_post_cow, slab_identity=_case_slab)


@pytest.mark.parametrize("case", sorted(CASES))
def test_paged_decode_matches_jax(case):
    q, pk, pv, table, pos, t_max = CASES[case]()
    got = _check(q, pk, pv, table, pos, t_max)
    assert np.isfinite(got).all()
    if case == "post_cow":
        # divergent block contents give divergent rows
        assert np.abs(got[0] - got[1]).max() > 1e-6


def _logical_bounds(pos, bs, mb, g):
    """The cut of the JAX kernel (and of the CUDA kernel before it folded
    its own splits): the logical blocks [0, MB) in ranges of ceil(MB / g),
    each cut at pos + 1."""
    bps = -(-mb // g)
    return np.array([[(gi * bps * bs,
                       min(min((gi + 1) * bps, mb) * bs, int(p) + 1))
                      for gi in range(g)] for p in pos])


def _kernel_partials(q, pk, pv, table, pos, g, cut="logical"):
    """Numpy model of each split's state: per (sequence, split, head) the
    normalized attention over the split's positions ``<= pos`` and its
    natural-log LSE, with the empty-split sentinel.  ``cut``: "logical"
    (``_logical_bounds``) or "live", the CUDA kernel's cut of the live
    blocks (``tpa._split_bounds``)."""
    s, h, d = q.shape
    bs, mb = pk.shape[1], table.shape[1]
    bounds = (tpa._split_bounds(pos, bs, mb, g).numpy() if cut == "live"
              else _logical_bounds(pos, bs, mb, g))
    scale = d ** -0.5
    o = np.zeros((s, g, h, d), np.float32)
    lse = np.zeros((s, g, h), np.float32)
    for si in range(s):
        for gi in range(g):
            lo, hi = bounds[si, gi]
            t = np.arange(lo, max(lo, hi))
            rows = table[si, t // bs] if len(t) else np.zeros(0, int)
            k = pk[rows, t % bs]                       # [n, h, d]
            v = pv[rows, t % bs]
            for hi_ in range(h):
                if not len(t):
                    lse[si, gi, hi_] = NEG_INF / LOG2E + np.log(1e-30)
                    continue
                sc = k[:, hi_] @ q[si, hi_] * scale
                m = sc.max()
                p = np.exp(sc - m)
                o[si, gi, hi_] = p @ v[:, hi_] / p.sum()
                lse[si, gi, hi_] = m + np.log(p.sum())
    return o, lse


@pytest.mark.parametrize("kv_splits", [1, 2, 3, 8])
def test_split_partials_fold_to_the_plain_version(kv_splits):
    """The fold of per-split partials (uneven tail split at 3, empty
    splits past short rows), at both cuts, gives the single-pass answer,
    and the JAX kernel agrees at every split count."""
    rng = np.random.RandomState(7)
    s, h, d, bs, mb = 2, 2, 8, 4, 8
    pk, pv = _rand_pool(rng, 1 + s * mb, bs, h, d)
    q = rng.randn(s, h, d).astype(np.float32)
    table = (np.arange(s * mb) + 1).reshape(s, mb).astype(np.int32)
    pos = np.array([31, 6], np.int32)
    want = tpa.paged_decode_attention(*_torch(q, pk, pv, table, pos),
                                      impl="torch").numpy()
    g = max(1, min(kv_splits, mb))
    for cut in ("logical", "live"):
        o_part, lse_part = _kernel_partials(q, pk, pv, table, pos, g, cut)
        got = tpa.fold_splits(*_torch(o_part, lse_part)).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    jint = jpa.paged_decode_attention(q, pk, pv, table, pos,
                                      impl="interpret", kv_splits=kv_splits)
    np.testing.assert_allclose(np.asarray(jint), want, **TOL)


@pytest.mark.parametrize("kv_splits", [1, 2, 3, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_live_cut_and_fold_match_jax(case, kv_splits):
    """The CUDA kernel's split arithmetic on the CPU - the cut of each
    row's live blocks, each split's state, the fold in split order -
    against the JAX kernel (interpret) at the same split count, on every
    case: rows with fewer live blocks than splits, hole rows, the slab."""
    q, pk, pv, table, pos, t_max = CASES[case]()
    g = max(1, min(kv_splits, table.shape[1]))
    o_part, lse_part = _kernel_partials(q, pk, pv, table, pos, g, "live")
    got = tpa.fold_splits(*_torch(o_part, lse_part)).numpy()
    want = jpa.paged_decode_attention(q, pk, pv, table, pos, t_max=t_max,
                                      impl="interpret", kv_splits=kv_splits)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("bs,mb", [(1, 9), (4, 8), (16, 256), (4096, 1)])
def test_split_bounds_tile_each_rows_live_blocks(bs, mb):
    """Each row's splits tile [0, pos + 1) in split order, start on block
    edges, hold at most ceil(n / G) of the row's n live blocks each, and
    only min(G, n) of them are non-empty."""
    t_max = bs * mb
    pos = np.unique(np.clip([0, 1, bs - 1, bs, 3 * bs + 1, t_max // 2,
                             t_max - 2, t_max - 1], 0, t_max - 1))
    for g in sorted({1, 2, 3, 8, mb}):
        b = tpa._split_bounds(pos, bs, mb, g).numpy()
        assert b.shape == (len(pos), g, 2)
        for p, row in zip(pos, b):
            n = min(mb, p // bs + 1)
            live = [(lo, hi) for lo, hi in row if hi > lo]
            assert len(live) == min(g, n)
            assert live[0][0] == 0 and live[-1][1] == p + 1
            assert all(a[1] == c[0] for a, c in zip(live, live[1:]))
            assert all(lo % bs == 0 and hi - lo <= -(-n // g) * bs
                       for lo, hi in live)


def test_default_kv_splits_policy_matches_jax():
    for mb in (1, 7, 8, 16, 63, 64, 256, 1024):
        assert tpa._default_kv_splits(mb) == jpa._default_kv_splits(mb)


def test_routing_and_validation():
    rng = np.random.RandomState(0)
    pk, pv = _rand_pool(rng, 2, 4, 1, 4)
    q = rng.randn(1, 1, 4).astype(np.float32)
    tq, tk, tv = _torch(q, pk, pv)
    before = tpa.paged_decode_cuda.launches
    got = tpa.paged_decode_attention(tq, tk, tv, [[1]], [2])
    want = tpa.paged_decode_attention(tq, tk, tv, [[1]], [2], impl="torch")
    assert torch.equal(got, want)             # CPU tensors: plain version
    assert tpa.paged_decode_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_decode_attention(tq, tk, tv, [[1]], [0], impl="cuda")
    with pytest.raises(ValueError, match="wants q"):
        tpa.paged_decode_attention(tq[0], tk, tv, [[1]], [0])
