"""The rest of the conv slice's layers and helpers in the PyTorch port
against the JAX package on the CPU: conv_transpose, maxout,
bilinear_interp, pad, crop, spp, featmap_expand, the 3-D conv, transposed
conv and pooling, a batch norm on a volume, the conv helpers of
``networks.py``, ``image.py``, the cifar and flowers streams, and the
fused / unfused checkpoint rule.

Each layer runs from the same weights (``parameters.from_numpy``) and the
same seeded numpy feed through both packages: its forward and the
gradients of its weights and its input within 1e-5 absolute and
relative, as ``tests/test_torch_layer_parity.py`` holds the goldens (the
eleven image goldens are among them).  Two planted faults show the
comparison is not blind: a transposed conv whose kernel is not flipped
and a shrinking resize without antialiasing each fail it.
"""

import io

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu import image as jimage
from paddle_tpu.dataset import cifar as jcifar
from paddle_tpu.dataset import flowers as jflowers
from paddle_tpu_torch import image as timage
from paddle_tpu_torch.dataset import cifar as tcifar
from paddle_tpu_torch.dataset import flowers as tflowers
from paddle_tpu_torch.ops import conv_bn as tcb
from test_torch_layer_parity import assert_parity, both
from torch_layer_configs import volume

SEED = 23


def _feed(ttopo, batch=3, seed=SEED):
    """Standard normals for every float data layer (NHWC or NDHWC)."""
    rng = np.random.RandomState(seed)
    return {s.name: rng.standard_normal(
        (batch,) + tuple(s.attrs["shape"])).astype(np.float32)
        for s in ttopo.specs if s.kind == "data"}


def _image(paddle, c, h, w):
    return paddle.layer.data("image", paddle.data_type.dense_vector(
        c * h * w), height=h, width=w)


def _random_values(values, seed=SEED):
    """Every parameter random (biases too, so a bias-free path shows)."""
    rng = np.random.RandomState(seed)
    return {l: {p: rng.standard_normal(v.shape).astype(np.float32) * 0.5
                for p, v in ps.items()} for l, ps in values.items()}


def _held(cfg, train=False, batch=3):
    ttopo, jtopo, values = both(cfg)
    assert_parity(ttopo, jtopo, _random_values(values),
                  _feed(ttopo, batch), train=train)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", [0, 1])
def test_conv_transpose_matches_jax(stride, padding):
    def cfg(paddle):
        x = _image(paddle, 3, 5, 6)
        y = paddle.layer.img_conv_transpose(
            x, filter_size=3, num_filters=4, stride=stride, padding=padding,
            act="tanh", name="deconv")
        return paddle.layer.sum_cost(y, name="c")

    _held(cfg)


def test_conv_transpose_without_the_flip_fails(monkeypatch):
    """A kernel handed to ``F.conv_transpose2d`` unflipped gives the same
    shape and other values: the comparison catches it."""
    def unflipped(x, w, stride, padding):
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.permute(2, 3, 0, 1),
                               None, stride, padding)
        return y.permute(0, 2, 3, 1)

    def cfg(paddle):
        y = paddle.layer.img_conv_transpose(
            _image(paddle, 2, 4, 4), filter_size=3, num_filters=2, stride=2,
            padding=1, name="deconv")
        return paddle.layer.sum_cost(y, name="c")

    monkeypatch.setattr(tcb, "conv_transpose_nhwc", unflipped)
    with pytest.raises(AssertionError):
        _held(cfg)


def _interp(out_y, out_x):
    def cfg(paddle):
        c = paddle.layer.img_conv(_image(paddle, 2, 8, 8), filter_size=3,
                                  num_filters=3, padding=1, name="conv")
        y = paddle.layer.bilinear_interp(c, out_x, out_y, name="interp")
        return paddle.layer.sum_cost(paddle.layer.fc(y, size=4, name="o"),
                                     name="c")
    return cfg


@pytest.mark.parametrize("out", [(13, 11), (6, 5)],
                         ids=["enlarge", "shrink"])
def test_bilinear_interp_matches_jax(out):
    _held(_interp(*out))


def test_bilinear_interp_without_antialias_fails_when_shrinking(
        monkeypatch):
    real = F.interpolate
    monkeypatch.setattr(F, "interpolate", lambda *a, **kw: real(
        *a, **dict(kw, antialias=False)))
    with pytest.raises(AssertionError):
        _held(_interp(6, 5))


@pytest.mark.parametrize("pool_type", ["max", "avg"])
def test_spp_matches_jax_at_sizes_no_bin_count_divides(pool_type):
    def cfg(paddle):
        c = paddle.layer.img_conv(_image(paddle, 2, 7, 10), filter_size=3,
                                  num_filters=3, padding=1, name="conv")
        s = paddle.layer.spp(c, pyramid_height=3, pool_type=pool_type,
                             name="spp")
        return paddle.layer.sum_cost(paddle.layer.fc(s, size=4, name="o"),
                                     name="c")

    _held(cfg)


def test_maxout_pad_crop_featmap_expand_match_jax():
    """maxout's groups are contiguous channels; pad pads H, W and C; crop
    takes an offset; featmap_expand broadcasts a vector over a map."""
    def cfg(paddle):
        layer = paddle.layer
        c = layer.img_conv(_image(paddle, 2, 6, 7), filter_size=3,
                           num_filters=6, padding=1, name="conv")
        mo = layer.maxout(c, groups=3, name="maxout")
        pd = layer.pad(mo, pad_c=(1, 2), pad_h=(2, 0), pad_w=(1, 3),
                       name="pad")
        cr = layer.crop(pd, 5, 6, offset=(2, 1), name="crop")
        v = layer.fc(layer.global_pool(cr, name="gp"), size=3, act="tanh",
                     name="v")
        fm = layer.LayerOutput("featmap_expand", [v], {"h": 2, "w": 3},
                               name="fm", size=3 * 2 * 3)
        return [layer.sum_cost(layer.fc(cr, size=4, name="o"), name="c1"),
                layer.sum_cost(layer.fc(fm, size=2, name="o2"), name="c2")]

    _held(cfg)


@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 0)])
def test_conv3d_and_deconv3d_match_jax(stride, padding):
    def cfg(paddle):
        layer = paddle.layer
        vol = volume(paddle, "vol", (5, 4, 6, 2))
        c = layer.img_conv3d(vol, filter_size=3, num_filters=3,
                             stride=stride, padding=padding, act="tanh",
                             name="c3d")
        d = layer.img_conv3d_transpose(c, filter_size=3, num_filters=2,
                                       stride=stride, padding=padding,
                                       name="d3d")
        return [layer.sum_cost(c, name="cc"), layer.sum_cost(
            layer.fc(d, size=3, name="o"), name="cd")]

    _held(cfg)


@pytest.mark.parametrize("pool_type", ["max", "avg"])
def test_pool3d_and_a_volumes_batch_norm_match_jax(pool_type):
    """VALID windows, avg over k^3; the rank-5 batch norm in train mode
    (the plain statistics in both packages) and its moving state."""
    def cfg(paddle):
        layer = paddle.layer
        vol = volume(paddle, "vol", (5, 6, 4, 3))
        bn = layer.batch_norm(vol, act="relu", name="bn3d")
        p = layer.img_pool3d(bn, pool_size=2, stride=2, pool_type=pool_type,
                             name="p3d")
        return layer.sum_cost(layer.fc(p, size=3, name="o"), name="c")

    _held(cfg, train=True, batch=4)


def test_conv_helpers_match_jax():
    """simple_img_conv_pool, img_conv_bn_pool, img_separable_conv (a
    grouped depthwise conv) and img_conv_group with per-conv lists."""
    def cfg(paddle):
        nets = paddle.networks
        x = _image(paddle, 4, 8, 8)
        a = nets.simple_img_conv_pool(x, 3, 4, 2, act="relu", name="a")
        b = nets.img_conv_bn_pool(a, 3, 6, 2, name="b")
        s = nets.img_separable_conv(b, num_channels=6, num_out_channels=5,
                                    name="s")
        g = nets.img_conv_group(s, [4, 6], 2, conv_padding=[1, 0],
                                conv_filter_size=[3, 1],
                                conv_with_batchnorm=[True, False])
        return paddle.layer.sum_cost(paddle.layer.fc(g, size=3, name="o"),
                                     name="c")

    _held(cfg, train=True, batch=4)


@pytest.mark.parametrize("net", ["small_vgg", "vgg_16_network"])
def test_vgg_networks_json_and_forward_match_jax(net):
    """Byte-equal JSON and one eval forward at 32 px (dropout off)."""
    def cfg(paddle):
        img = _image(paddle, 3, 32, 32)
        return getattr(paddle.networks, net)(img, num_classes=10)

    ttopo, jtopo, values = both(cfg)
    tfeed = _feed(ttopo, batch=2)
    params = pt.parameters.from_numpy(ttopo, values, device="cpu").values
    touts, _ = ttopo.forward(params, ttopo.create_state(device="cpu"),
                             tfeed, device="cpu")
    jouts, _ = jax.jit(lambda v, f: jtopo.forward(
        v, jtopo.create_state(), f))(values, tfeed)
    (name, got), = touts.items()
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(jouts[name]),
                               atol=1e-5, rtol=1e-5)


def test_image_transforms_equal_the_jax_packages_bit_for_bit():
    rng = np.random.RandomState(SEED)
    for h, w in ((37, 52), (64, 40)):
        img = rng.rand(h, w, 3).astype(np.float32)
        for fn, args in ((jimage.resize_short, (24,)),
                         (jimage.center_crop, (20,)),
                         (jimage.left_right_flip, ()),
                         (jimage.to_chw, ()),
                         (jimage.normalize, ([0.4, 0.5, 0.6],
                                             [0.2, 0.3, 0.25]))):
            want = fn(img, *args)
            got = getattr(timage, fn.__name__)(img, *args)
            assert got.dtype == want.dtype and np.array_equal(got, want)
        np.testing.assert_array_equal(
            timage.to_hwc(timage.to_chw(img)), img)
        np.testing.assert_array_equal(
            timage.random_crop(img, 16, np.random.RandomState(1)),
            jimage.random_crop(img, 16, np.random.RandomState(1)))
        for is_train in (True, False):
            np.testing.assert_array_equal(
                timage.simple_transform(img, 32, 24, is_train, mean=0.5,
                                        rng=np.random.RandomState(2)),
                jimage.simple_transform(img, 32, 24, is_train, mean=0.5,
                                        rng=np.random.RandomState(2)))
    assert sorted(timage.__all__) == sorted(jimage.__all__)
    assert pt.image is timage


def _samples(reader, n):
    out = []
    for i, s in enumerate(reader()):
        if i == n:
            break
        out.append(s)
    return out


def _cache_at(monkeypatch, path):
    """Both packages' dataset cache directory at ``path``."""
    for mod in (jcifar, tcifar):
        monkeypatch.setattr(mod.common, "DATA_HOME", str(path))


@pytest.mark.parametrize("name", ["train10", "test10", "train100",
                                  "test100"])
def test_synthetic_cifar_equals_the_jax_packages(name, monkeypatch,
                                                 tmp_path):
    _cache_at(monkeypatch, tmp_path)
    got = _samples(getattr(tcifar, name)(n=6), 6)
    want = _samples(getattr(jcifar, name)(n=6), 6)
    assert len(got) == 6
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gl == wl and gi.shape == (3072,)
        np.testing.assert_array_equal(gi, wi)


def test_cifar_reads_the_cached_archive_and_raises_without_it(
        monkeypatch, tmp_path):
    """With the archive in the cache directory both packages read it;
    without it and with ``synthetic=False`` both raise."""
    import pickle
    import tarfile

    _cache_at(monkeypatch, tmp_path)
    with pytest.raises(Exception) as jerr:
        jcifar.train10(synthetic=False)
    with pytest.raises(type(jerr.value)):
        tcifar.train10(synthetic=False)
    rng = np.random.RandomState(0)
    batch = {"data": rng.randint(0, 256, (5, 3072)).astype(np.uint8),
             "labels": list(rng.randint(0, 10, 5))}
    (tmp_path / "cifar").mkdir()
    with tarfile.open(tmp_path / "cifar" / "cifar-10-python.tar.gz",
                      "w:gz") as tar:
        data = pickle.dumps(batch)
        info = tarfile.TarInfo("cifar-10-batches-py/data_batch_1")
        info.size = len(data)
        tar.addfile(info, io.BytesIO(data))
    got = _samples(tcifar.train10(), 10)
    want = _samples(jcifar.train10(), 10)
    assert len(got) == len(want) == 5
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gl == wl
        np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize("image_size", [32, 20])
def test_synthetic_flowers_equals_the_jax_packages(image_size):
    for split in ("train", "test"):
        got = _samples(getattr(tflowers, split)(n=4,
                                                image_size=image_size), 4)
        want = _samples(getattr(jflowers, split)(n=4,
                                                 image_size=image_size), 4)
        for (gi, gl), (wi, wl) in zip(got, want):
            assert gl == wl and gi.shape == (image_size, image_size, 3)
            np.testing.assert_array_equal(gi, wi)
    assert tflowers.valid is tflowers.test


# ------------------------------------------- the fused / unfused rule
def _params(values):
    return pt.parameters.Parameters(
        {l: {p: torch.from_numpy(v) for p, v in ps.items()}
         for l, ps in values.items()},
        {l: {p: {} for p in ps} for l, ps in values.items()})


def test_checkpoint_fuse_mismatch_fails_loudly():
    """A tar saved with the other ``fuse_conv_bn`` setting raises, both
    ways, naming the layer (as ``tests/test_conv_bn_fused.py`` holds the
    JAX package); matching ones still round-trip."""
    unfused = _params({
        "res_a_conv": {"w": np.zeros((3, 3), np.float32)},
        "res_a_bn": {"scale": np.ones((3,), np.float32)}})
    fused = _params({
        "res_a_fused": {"w": np.full((3, 3), 2.0, np.float32)}})
    saved_unfused, saved_fused = io.BytesIO(), io.BytesIO()
    unfused.to_tar(saved_unfused)
    fused.to_tar(saved_fused)
    saved_unfused.seek(0)
    with pytest.raises(ValueError, match="fuse_conv_bn.*'res_a'"):
        fused.from_tar(saved_unfused)
    saved_fused.seek(0)
    with pytest.raises(ValueError, match="fuse_conv_bn.*'res_a'"):
        unfused.from_tar(saved_fused)
    saved_fused.seek(0)
    reload = _params({"res_a_fused": {"w": np.zeros((3, 3), np.float32)}})
    reload.from_tar(saved_fused)
    np.testing.assert_array_equal(reload["res_a_fused.w"],
                                  np.full((3, 3), 2.0, np.float32))


def _small_resnet(fuse):
    from paddle_tpu_torch.core import config
    from paddle_tpu_torch.core.ir import reset_name_counters
    from paddle_tpu_torch.models import resnet

    reset_name_counters()
    pt.init(seed=0, device="cpu", fuse_conv_bn=fuse)
    try:
        layer = pt.layer
        img = _image(pt, 3, 8, 8)
        lbl = layer.data("label", pt.data_type.integer_value(3))
        x = resnet.conv_bn(img, 4, 3, name="stem")
        x = layer.global_pool(x, name="gap")
        cost = layer.classification_cost(layer.fc(x, size=3, name="p"), lbl,
                                         name="cost")
        return pt.Topology(cost)
    finally:
        config.set_option("fuse_conv_bn", False)


def test_every_restore_route_refuses_the_other_fusion():
    """``from_numpy``, ``SGD.restore`` and the serving reload's graft
    refuse a snapshot of the other setting, both ways."""
    from paddle_tpu_torch.serving import reload

    topos = {f: _small_resnet(f) for f in (False, "all")}
    assert {s.kind for s in topos["all"].specs} >= {"conv_bn"}
    trees = {f: {l: {p: v.numpy() for p, v in ps.items()} for l, ps in
                 t.create_parameters(device="cpu").values.items()}
             for f, t in topos.items()}
    for here, saved in ((False, "all"), ("all", False)):
        topo = topos[here]
        with pytest.raises(ValueError, match="fuse_conv_bn.*'stem'"):
            pt.parameters.from_numpy(topo, trees[saved], device="cpu")
        trainer = pt.trainer.SGD(topo, topo.create_parameters(device="cpu"),
                                 pt.optimizer.Momentum(learning_rate=0.1,
                                                       momentum=0.9))
        with pytest.raises(ValueError, match="fuse_conv_bn"):
            trainer.restore({"trainable": trees[saved], "manifest": {}})

        class _Engine:
            import threading
            _version_lock = threading.Lock()
            _version_active = "v"
            _versions = {"v": type("V", (), {"values": trees[here]})}

        with pytest.raises(ValueError, match="fuse_conv_bn"):
            reload.snapshot_values(_Engine(), {"trainable": trees[saved]})
        # the matching snapshot goes through every route
        pt.parameters.from_numpy(topo, trees[here], device="cpu")
        trainer.restore({"trainable": trees[here], "manifest": {}})
        reload.snapshot_values(_Engine(), {"trainable": trees[here]})
