"""The detection slice of the PyTorch port against the JAX package on the
CPU: the box helpers, batched NMS lane by lane, priorbox, roi_pool,
multibox_loss and detection_output with every gradient, and the
DetectionMAP evaluator on the same statistics.  Planted cases: two ground
truths sharing their best prior (the JAX scatter's last write, the larger
index, wins), padding ground-truth slots, equal scores in NMS, in the
final top-k and in the hard-negative ranking (both sorts stable), and a
keep_top_k larger than the NMS pool (padding rows).  Tolerance 1e-5
absolute and relative; indices and orders equal exactly.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.ops import boxes as jboxes
from paddle_tpu_torch.ops import boxes as tboxes
from test_torch_layer_parity import assert_parity, both

TOL = dict(atol=1e-5, rtol=1e-5)


def _boxes(rng, shape, lo=0.0, span=0.6):
    a = rng.uniform(lo, span, shape + (2,))
    wh = rng.uniform(0.05, 0.4, shape + (2,))
    return np.concatenate([a, a + wh], -1).astype(np.float32)


def test_box_helpers_match_jax():
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    a, b = _boxes(rng, (7,)), _boxes(rng, (5,))
    b[2] = a[3]                                  # an exact overlap
    b[4] = [0.9, 0.9, 0.9, 0.95]                 # a zero-area box
    np.testing.assert_allclose(
        tboxes.iou_matrix(torch.tensor(a), torch.tensor(b)).numpy(),
        np.asarray(jboxes.iou_matrix(jnp.asarray(a), jnp.asarray(b))),
        **TOL)
    var = np.array([0.1, 0.1, 0.2, 0.2], np.float32)
    enc = tboxes.encode_boxes(torch.tensor(a), torch.tensor(a[::-1].copy()),
                              torch.tensor(var))
    jenc = jboxes.encode_boxes(jnp.asarray(a), jnp.asarray(a[::-1].copy()),
                               jnp.asarray(var))
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), **TOL)
    dec = tboxes.decode_boxes(enc, torch.tensor(a[::-1].copy()),
                              torch.tensor(var))
    np.testing.assert_allclose(dec.numpy(), a, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_nms_matches_jax_lane_by_lane(seed):
    """3 images x 4 classes over 40 boxes at once, against the JAX nms of
    each lane: equal scores (the first index wins), scores under the
    threshold, a max_out larger than what survives (-1 and False)."""
    import jax.numpy as jnp

    rng = np.random.RandomState(seed)
    n = 40
    boxes = _boxes(rng, (3, n))
    scores = rng.rand(3, 4, n).astype(np.float32)
    scores[0, 0, 5] = scores[0, 0, 9] = scores[0, 0, 30] = 0.99   # ties
    boxes[0, 9] = boxes[0, 5]                    # the tie's twin box
    scores[1, 2] = np.round(scores[1, 2], 1)     # many ties
    scores[2, 3, :] = 0.001                      # under the threshold
    lanes = torch.tensor(boxes)[:, None].expand(3, 4, n, 4)
    idx, valid = tboxes.nms(lanes, torch.tensor(scores), iou_threshold=0.3,
                            score_threshold=0.01, max_out=30)
    for i in range(3):
        for c in range(4):
            jidx, jvalid = jboxes.nms(jnp.asarray(boxes[i]),
                                      jnp.asarray(scores[i, c]),
                                      iou_threshold=0.3,
                                      score_threshold=0.01, max_out=30)
            np.testing.assert_array_equal(idx[i, c].numpy(), np.asarray(jidx))
            np.testing.assert_array_equal(valid[i, c].numpy(),
                                          np.asarray(jvalid))
    assert not valid[2, 3].any() and (idx[2, 3] == -1).all()
    assert 5 in idx[0, 0].tolist() and 9 not in idx[0, 0].tolist()


def test_priorbox_and_roi_pool_match_jax():
    def cfg(paddle):
        l, dv = paddle.layer, paddle.data_type.dense_vector
        img = l.data("im", dv(2 * 12 * 10), height=12, width=10)
        feat = l.img_conv(img, filter_size=3, num_filters=3, padding=1,
                          stride=2, name="feat")
        pb = l.priorbox(feat, img, min_size=[3, 5], max_size=[6, 9],
                        aspect_ratio=[2.0, 3.0], clip=False, name="pb")
        pbc = l.priorbox(feat, img, min_size=[4], aspect_ratio=[],
                         name="pb_clip")
        rois = l.reshape(l.data("rois", dv(3 * 4)), (3, 4), name="rois_r")
        rp = l.roi_pool(feat, rois, pooled_width=3, pooled_height=2,
                        spatial_scale=0.5, name="roi")
        return [l.sum_cost(rp, name="c_roi"), pb, pbc]

    ttopo, jtopo, values = both(cfg)
    rng = np.random.RandomState(3)
    rois = np.concatenate([rng.uniform(0, 8, (4, 3, 2)),
                           rng.uniform(8, 22, (4, 3, 2))], -1)
    rois[0, 0] = [0, 0, 0.5, 0.5]                  # smaller than a bin
    rois[1, 1] = [30, 30, 40, 40]                  # off the map
    feed = {"im": rng.standard_normal((4, 12, 10, 2)).astype(np.float32),
            "rois": rois.reshape(4, 12).astype(np.float32)}
    outs = assert_parity(ttopo, jtopo, values, feed)
    # a cell: 2 min sizes x (1 + 2 aspects x 2) + 2 max sizes = 12
    assert tuple(outs["pb"].shape) == (4, 6 * 5 * 12, 8)


def _ssd_head(paddle, nms_top_k=10, keep_top_k=25):
    """Priors of a 4 x 4 map (4 a cell: 64), loc and conf fed, 3 ground
    truths; the multibox loss and the NMS output of 3 classes."""
    l, dv = paddle.layer, paddle.data_type.dense_vector
    img = l.data("im", dv(3 * 16 * 16), height=16, width=16)
    feat = l.img_conv(img, filter_size=3, num_filters=2, padding=1,
                      stride=4, name="feat")
    pb = l.priorbox(feat, img, min_size=[4], max_size=[8],
                    aspect_ratio=[2.0], name="pb")
    loc = l.data("loc", dv(64 * 4))
    conf = l.reshape(l.data("conf", dv(64 * 3)), (64, 3), name="conf_r")
    gt = l.reshape(l.data("gt", dv(3 * 4)), (3, 4), name="gt_r")
    gl = l.data("gl", dv(3))
    mb = l.multibox_loss(loc, conf, pb, gl, gt, overlap_threshold=0.35,
                         name="mbloss")
    det = l.detection_output(loc, conf, pb, num_classes=3,
                             nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                             nms_threshold=0.4, name="det")
    return [mb, l.sum_cost(det, name="c_det"), det]


def _ssd_feed(seed, batch=4):
    rng = np.random.RandomState(seed)
    conf = rng.standard_normal((batch, 64, 3)).astype(np.float32)
    conf[0, 10] = conf[0, 3]                      # equal scores, 2 priors
    conf[1, 7] = [0.0, 2.0, 2.0]                  # classes 1 and 2 equal
    conf[2, 20:40] = conf[2, 19]                  # equal negatives' ce
    gt = _boxes(rng, (batch, 3), span=0.5)
    gt[0, 1] = gt[0, 0]                           # a shared best prior
    gl = rng.randint(1, 3, (batch, 3)).astype(np.float32)
    gl[0, :2] = [1.0, 2.0]                        # ... of two labels
    gl[1, 2] = -1.0                               # a padding slot
    gl[3, :] = -1.0                               # no ground truth
    return {"im": rng.standard_normal((batch, 16, 16, 3)).astype(np.float32),
            "loc": (rng.standard_normal((batch, 256)) * 0.3).astype(
                np.float32),
            "conf": conf.reshape(batch, 192), "gt": gt.reshape(batch, 12),
            "gl": gl}


@pytest.mark.parametrize("keep", [25, 12], ids=["padded_pool", "cut_pool"])
@pytest.mark.parametrize("seed", [0, 1])
def test_multibox_loss_and_detection_output_match_jax(seed, keep):
    ttopo, jtopo, values = both(lambda p: _ssd_head(p, keep_top_k=keep))
    outs = assert_parity(ttopo, jtopo, values, _ssd_feed(seed))
    det = outs["det"].detach().numpy()
    assert det.shape == (4, keep, 6)
    if keep == 25:                  # 2 classes x 10: 5 rows of padding
        assert (det[:, 20:, 0] == -1).all()


def test_shared_best_prior_goes_to_the_larger_index():
    """Two ground truths of one box: the prior that is best for both is
    forced to the second (JAX's scatter keeps the last write), so its
    target label is the second's.  The port's loss equals the JAX loss
    with labels (1, 2) and differs from it with the labels swapped."""
    import jax
    import jax.numpy as jnp

    ttopo, jtopo, values = both(_ssd_head)
    feed = _ssd_feed(0)
    params = pt.parameters.from_numpy(ttopo, values, device="cpu").values

    def port(fd):
        return float(ttopo.forward(params, {}, fd, device="cpu")[0]["mbloss"])

    jv = {l: {p: jnp.asarray(v) for p, v in ps.items()}
          for l, ps in values.items()}
    jloss = jax.jit(lambda fd: jtopo.forward(jv, {}, fd,
                                             outputs=["mbloss"])[0]["mbloss"])

    def jax_(fd):
        return float(jloss({k: jnp.asarray(v) for k, v in fd.items()}))

    swapped = dict(feed, gl=feed["gl"].copy())
    swapped["gl"][0, :2] = [2.0, 1.0]
    np.testing.assert_allclose(port(feed), jax_(feed), **TOL)
    np.testing.assert_allclose(port(swapped), jax_(swapped), **TOL)
    assert abs(port(feed) - port(swapped)) > 1e-4


@pytest.mark.parametrize("ap_type", ["11point", "integral"])
def test_detection_map_matches_jax(ap_type):
    """Both evaluators on the same detection rows and ground truth over
    three batches: matched, duplicate, wrong-class and padding rows."""
    rng = np.random.RandomState(4)
    evals = []
    for pkg in (pt, pj):
        lo = pkg.layer.data("d", pkg.data_type.dense_vector(6))
        evals.append(pkg.evaluator.detection_map(
            lo, lo, lo, name="map", ap_type=ap_type,
            overlap_threshold=0.5))
    accs = [None, None]
    for _ in range(3):
        gt = _boxes(rng, (2, 4))
        gl = rng.randint(1, 4, (2, 4)).astype(np.int32)
        gl[1, 3] = -1
        dets = np.full((2, 10, 6), -1.0, np.float32)
        for b in range(2):
            for k in range(8):
                g = k % 4
                box = gt[b, g] + rng.uniform(-0.05, 0.05, 4) * (k // 4 + 1)
                lab = gl[b, g] if k != 6 else (gl[b, g] % 3) + 1
                dets[b, k] = [max(lab, 1), rng.rand(), *box]
        stats = (dets, gl, gt)
        for i, e in enumerate(evals):
            accs[i] = e.merge(accs[i], stats)
    got, want = evals[0].finish(accs[0]), evals[1].finish(accs[1])
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["map"], want["map"], rtol=1e-12)
    assert 0.0 < got["map"] <= 1.0
