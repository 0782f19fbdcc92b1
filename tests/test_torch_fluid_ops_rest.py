"""The rest of the port's Fluid op catalog against the JAX package's, on
the CPU: the counterparts of ``tests/test_fluid_op_catalog.py``,
``tests/test_fluid_op_extras.py``, the Fluid tests of
``tests/test_fluid_surface2.py`` (its v2 ones are the v2 files'), and
``tests/test_fluid_fixes.py``'s check_nan_inf, SSD-loss and random-stream
tests; and ``debugger``'s text against the JAX package's.

Each program is built by the same DSL calls in both packages: its JSON
is byte equal, and from the JAX startup values the port's fetches equal
the JAX package's, integers exactly and floats within rtol 1e-5, atol
1e-6 (rtol 1e-4 over the 5 CRF training steps).  Each JAX program runs
once, in a module-scoped fixture; the tests then hold the port's values
against the reference's oracles as the JAX tests do.  Op-level cases
call both ops directly on the same float32 inputs.  Programs with nce's
or dropout's draws run in the port alone: torch cannot reproduce JAX's
streams.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.fluid import executor as jexec
from paddle_tpu.fluid import ops as jops
from paddle_tpu_torch.fluid import ops as tops
from torch_fluid_pairs import assert_steps_close, jax_side, port_side
from torch_fluid_programs import ctc_edit, ssd

RTOL, ATOL = 1e-5, 1e-6


def _rank_margin(fl):
    L = fl.layers
    lab = L.data(name="l", shape=[1])
    left, right = L.data(name="a", shape=[1]), L.data(name="b", shape=[1])
    return [L.rank_loss(lab, left, right),
            L.margin_rank_loss(lab, left, right, margin=0.1)], [{
        "l": np.array([[1.0], [0.0]], np.float32),
        "a": np.array([[0.6], [0.2]], np.float32),
        "b": np.array([[0.4], [0.9]], np.float32)}]


def _huber_smooth(fl):
    L = fl.layers
    x, y = L.data(name="x", shape=[1]), L.data(name="y", shape=[1])
    oh = L.data(name="oh", shape=[4])
    return [L.modified_huber_loss(x, y), L.label_smooth(oh, epsilon=0.2)], [{
        "x": np.array([[2.0], [0.5], [-3.0]], np.float32),
        "y": np.array([[1.0], [0.0], [1.0]], np.float32),
        "oh": np.eye(4, dtype=np.float32)[:3]}]


def _bilinear_norm_prelu(fl):
    L = fl.layers
    x, y = L.data(name="x", shape=[3]), L.data(name="y", shape=[4])
    btp = L.bilinear_tensor_product(
        x, y, size=2, param_attr=fl.initializer.Constant(0.1),
        bias_attr=fl.initializer.Constant(0.0))
    rng = np.random.RandomState(3)
    return [btp, L.norm(x, axis=1), L.prelu(x, mode="all")], [{
        "x": np.ones((2, 3), np.float32) * np.array([1, -2, 3], np.float32),
        "y": rng.rand(2, 4).astype(np.float32)}]


def _row_conv_shift(fl):
    L = fl.layers
    x = L.data(name="x", shape=[4, 3])
    rc = L.row_conv(x, future_context_size=1,
                    param_attr=fl.initializer.Constant(1.0))
    cs = L.conv_shift(L.data(name="a", shape=[5]), L.data(name="s", shape=[3]))
    return [rc, cs], [{"x": np.arange(12, dtype=np.float32).reshape(1, 4, 3),
                       "a": np.eye(5, dtype=np.float32)[:1],
                       "s": np.array([[0.0, 1.0, 0.0]], np.float32)}]


def _rnn_units(fl):
    L = fl.layers
    x, c0 = L.data(name="x", shape=[8]), L.data(name="c0", shape=[2])
    hid, cell = L.lstm_unit(x, c0)
    xs = L.data(name="xs", shape=[3, 8])
    proj, pc = L.dynamic_lstmp(xs, size=2, proj_size=3,
                               param_attr=fl.initializer.Constant(0.1),
                               bias_attr=False)
    g = L.data(name="g", shape=[6])
    hp = L.data(name="hp", shape=[2])
    gh = L.gru_unit(g, hp, size=2)
    rng = np.random.RandomState(1)
    return [hid, cell, proj, pc] + list(gh), [{
        "x": rng.randn(2, 8).astype(np.float32),
        "c0": rng.randn(2, 2).astype(np.float32),
        "xs": rng.randn(2, 3, 8).astype(np.float32),
        "g": rng.randn(2, 6).astype(np.float32),
        "hp": rng.randn(2, 2).astype(np.float32)}]


def _dynamic_lstm_gru(fl):
    L = fl.layers
    x, mask = L.data(name="x", shape=[5, 16]), L.data(name="m", shape=[5])
    h, c = L.dynamic_lstm(x, size=4, mask=mask,
                          param_attr=fl.initializer.Constant(0.05),
                          bias_attr=fl.initializer.Constant(0.0))
    gh = L.dynamic_gru(L.data(name="g", shape=[5, 12]), size=4, mask=mask,
                       param_attr=fl.initializer.Constant(0.05),
                       bias_attr=fl.initializer.Constant(0.0))
    rng = np.random.RandomState(0)
    return [h, c, gh], [{
        "x": rng.randn(2, 5, 16).astype(np.float32),
        "g": rng.randn(2, 5, 12).astype(np.float32),
        "m": np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.float32)}]


def _sequence_ops(fl):
    L = fl.layers
    x = L.data(name="x", shape=[3], dtype="int64")
    s = L.data(name="s", shape=[4, 2])
    ssl = L.sequence_slice(s, L.data(name="off", shape=[1], dtype="int64"),
                           L.data(name="len", shape=[1], dtype="int64"))
    return [L.sequence_erase(x, tokens=[0, 2]), ssl,
            L.sequence_reshape(s, new_dim=4),
            L.sequence_mask(L.data(name="n", shape=[], dtype="int64"),
                            maxlen=4)], [{
        "x": np.array([[1, 0, 2], [2, 5, 0]], np.int64),
        "s": np.arange(16, dtype=np.float32).reshape(2, 4, 2),
        "off": np.array([[1], [0]], np.int64),
        "len": np.array([[2], [1]], np.int64),
        "n": np.array([3, 1], np.int64)}]


def _sequence_concat_conv(fl):
    L = fl.layers
    a, b = L.data(name="a", shape=[3, 2]), L.data(name="b", shape=[2, 2])
    cat = L.sequence_concat(a, b, L.data(name="al", shape=[], dtype="int64"),
                            L.data(name="bl", shape=[], dtype="int64"))
    sc = L.sequence_conv(a, num_filters=4, filter_size=3,
                         param_attr=fl.initializer.Constant(0.1))
    return [cat, sc], [{
            "a": np.arange(12, dtype=np.float32).reshape(2, 3, 2),
            "b": 100 + np.arange(8, dtype=np.float32).reshape(2, 2, 2),
            "al": np.array([2, 3], np.int64),
            "bl": np.array([1, 2], np.int64)}]


def _detection(fl):
    L = fl.layers
    gt = L.data(name="gt", shape=[4], append_batch_size=False)
    pr = L.data(name="pr", shape=[3, 4], append_batch_size=False)
    iou = L.iou_similarity(gt, pr)
    match, mdist = L.bipartite_match(iou)
    return [iou, match, mdist], [{
        "gt": np.array([[0.1, 0.1, 0.5, 0.5], [0.5, 0.5, 0.9, 0.9]],
                       np.float32),
        "pr": np.array([[0.1, 0.1, 0.5, 0.5], [0.5, 0.5, 0.9, 0.9],
                        [0.0, 0.0, 0.2, 0.2]], np.float32)}]


def _prior_box_nms(fl):
    L = fl.layers
    boxes, var = L.prior_box(L.data(name="f", shape=[4, 4, 8]),
                             L.data(name="im", shape=[32, 32, 3]),
                             min_sizes=[8.0], max_sizes=[16.0],
                             aspect_ratios=[1.0, 2.0])
    det = L.multiclass_nms(L.data(name="bb", shape=[4, 4],
                                  append_batch_size=False),
                           L.data(name="sc", shape=[2, 4],
                                  append_batch_size=False),
                           keep_top_k=6, background_label=0)
    return [boxes, var, det], [{
        "f": np.zeros((1, 4, 4, 8), np.float32),
        "im": np.zeros((1, 32, 32, 3), np.float32),
        "bb": np.array([[0, 0, 1, 1], [0, 0, 1, 1], [0.5, 0.5, 1, 1],
                        [0, 0, 0.1, 0.1]], np.float32),
        "sc": np.array([[0.9, 0.8, 0.7, 0.6], [0.1, 0.9, 0.2, 0.8]],
                       np.float32)}]


def _metrics(fl):
    L = fl.layers
    p = L.data(name="p", shape=[1])
    a = L.auc(p, L.data(name="l", shape=[1], dtype="int64"),
              num_thresholds=500)
    prf = L.precision_recall(L.data(name="mp", shape=[1]),
                             L.data(name="idx", shape=[1], dtype="int64"),
                             L.data(name="lab", shape=[1], dtype="int64"),
                             class_number=3)
    pv = np.array([[0.9], [0.8], [0.3], [0.1]], np.float32)
    return [a, prf], [{"p": pv, "l": np.array([[1], [1], [0], [0]],
                                              np.int64),
                       "mp": pv,
                       "idx": np.array([[0], [1], [2], [1]], np.int64),
                       "lab": np.array([[0], [1], [2], [2]], np.int64)}]


def _lod_reset_empty(fl):
    L = fl.layers
    x = L.data(name="x", shape=[3])
    return [L.lod_reset(x), L.is_empty(x)], [{"x": np.ones((2, 3),
                                                           np.float32)}]


def _im2seq_spp(fl):
    L = fl.layers
    x = L.data(name="x", shape=[1, 4, 4])
    return [L.im2sequence(x, filter_size=2, stride=2),
            L.spp(x, pyramid_height=2)], [
        {"x": np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)}]


def _pool_unpool(fl):
    L = fl.layers
    pooled, mask = L.max_pool2d_with_index(L.data(name="x", shape=[1, 4, 4]),
                                           pool_size=2)
    return [pooled, mask, L.unpool(pooled, mask, unpool_size=4)], [
        {"x": 2.0 * np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)}]


def _pn_pair(fl):
    L = fl.layers
    return list(L.positive_negative_pair(
        L.data(name="s", shape=[1]), L.data(name="l", shape=[1],
                                            dtype="int64"),
        L.data(name="q", shape=[1], dtype="int64"))), [{
            "s": np.array([[0.9], [0.3], [0.5], [0.2]], np.float32),
            "l": np.array([[1], [0], [1], [0]], np.int64),
            "q": np.array([[7], [7], [7], [9]], np.int64)}]


def _crf_decode(fl):
    L = fl.layers
    em = L.data(name="em", shape=[4, 3])
    lens = L.data(name="len", shape=[], dtype="int64")
    ll = L.linear_chain_crf(em, L.data(name="lab", shape=[4], dtype="int64"),
                            length=lens)
    path = L.crf_decoding(em, transition=ll.transition_param, length=lens)
    emv = np.random.RandomState(0).randn(2, 4, 3).astype(np.float32)
    emv[..., 1] += 5.0
    return [ll, path], [{"em": emv, "lab": np.full((2, 4), 1, np.int64),
                         "len": np.array([4, 3], np.int64)}]


def _crf_train(fl):
    L = fl.layers
    em = L.data(name="em", shape=[4, 3])
    ll = L.linear_chain_crf(em, L.data(name="lab", shape=[4], dtype="int64"))
    loss = L.scale(L.mean(ll), scale=-1.0)
    fl.optimizer.SGD(learning_rate=0.5).minimize(loss)
    f = {"em": np.random.RandomState(0).randn(2, 4, 3).astype(np.float32),
         "lab": np.array([[0, 1, 2, 0], [1, 1, 0, 2]], np.int64)}
    return [loss], [f] * 5


def _chunk_iob(fl):
    L = fl.layers
    outs = L.chunk_eval(L.data(name="p", shape=[6], dtype="int64"),
                        L.data(name="l", shape=[6], dtype="int64"),
                        chunk_scheme="IOB", num_chunk_types=2,
                        seq_length=L.data(name="n", shape=[],
                                          dtype="int64"))
    return list(outs), [{"l": np.array([[0, 1, 4, 2, 3, 4]], np.int64),
                         "p": np.array([[0, 1, 4, 2, 4, 4]], np.int64),
                         "n": np.array([6], np.int64)}]


def _chunk_random(fl):
    L = fl.layers
    ntypes, t, b = 3, 12, 4
    rng = np.random.RandomState(7)
    outs = L.chunk_eval(L.data(name="p", shape=[t], dtype="int64"),
                        L.data(name="l", shape=[t], dtype="int64"),
                        chunk_scheme="IOB", num_chunk_types=ntypes,
                        seq_length=L.data(name="n", shape=[],
                                          dtype="int64"))
    return list(outs), [{
        "p": rng.randint(0, ntypes * 2 + 1, (b, t)).astype(np.int64),
        "l": rng.randint(0, ntypes * 2 + 1, (b, t)).astype(np.int64),
        "n": np.array([t, t - 3, t - 5, 2], np.int64)}]


def _beam_ops(fl):
    L = fl.layers
    k, v = 2, 5
    ids, sc, par = L.beam_search(L.data(name="pi", shape=[k], dtype="int64"),
                                 L.data(name="ps", shape=[k]),
                                 L.data(name="pr", shape=[k, v]),
                                 beam_size=k, end_id=0)
    prv = np.full((2, k, v), 0.01, np.float32)
    prv[0, 0, 4], prv[0, 1, 3], prv[1, 1, 2] = 0.9, 0.8, 0.9
    sent, ssc = L.beam_search_decode(
        L.data(name="i", shape=[1, 2], dtype="int64"),
        L.data(name="pp", shape=[1, 2], dtype="int64"),
        L.data(name="s", shape=[1, 2]))
    return [ids, sc, par, sent, ssc], [{
        "pi": np.array([[2, 3], [0, 2]], np.int64),
        "ps": np.array([[0.0, -1.0], [-0.5, -0.7]], np.float32),
        "pr": prv,
        "i": np.array([[[5, 6]], [[7, 8]], [[9, 10]]], np.int64),
        "pp": np.array([[[0, 1]], [[1, 0]], [[0, 1]]], np.int64),
        "s": np.zeros((3, 1, 2), np.float32)}]


def _lod_functional(fl):
    L = fl.layers
    lens = L.data(name="n", shape=[], dtype="int64")
    x = L.data(name="x", shape=[3])
    table = L.lod_rank_table(lens)
    arr = L.lod_tensor_to_array(L.data(name="s", shape=[3, 2]))
    return [L.reorder_lod_tensor_by_rank(x, table),
            L.max_sequence_len(lens), arr, L.array_to_lod_tensor(arr),
            L.sequence_first_step(L.data(name="q", shape=[4, 3])),
            L.sequence_last_step(L.data(name="q", shape=[4, 3]))], [{
        "n": np.array([2, 5, 3], np.int64),
        "x": np.arange(9, dtype=np.float32).reshape(3, 3),
        "s": np.arange(12, dtype=np.float32).reshape(2, 3, 2),
        "q": np.arange(24, dtype=np.float32).reshape(2, 4, 3)}]


def _box_coder_variances(fl):
    L = fl.layers
    pb = L.data(name="pb", shape=[3, 4], append_batch_size=False)
    pbv = L.data(name="pbv", shape=[3, 4], append_batch_size=False)
    tb = L.data(name="tb", shape=[3, 4], append_batch_size=False)
    enc = L.box_coder(pb, pbv, tb, code_type="encode_center_size")
    dec = L.box_coder(pb, pbv, enc, code_type="decode_center_size")
    base = np.random.RandomState(0).rand(3, 2) * 0.5
    return [enc, dec], [{
        "pb": np.concatenate([base, base + 0.3], 1).astype(np.float32),
        "pbv": np.full((3, 4), 0.1, np.float32),
        "tb": np.concatenate([base + 0.05, base + 0.25], 1)
        .astype(np.float32)}]


PROGRAMS = {
    "rank_margin": _rank_margin, "huber_smooth": _huber_smooth,
    "bilinear_norm_prelu": _bilinear_norm_prelu,
    "row_conv_shift": _row_conv_shift, "rnn_units": _rnn_units,
    "dynamic_lstm_gru": _dynamic_lstm_gru, "sequence_ops": _sequence_ops,
    "sequence_concat_conv": _sequence_concat_conv, "ctc_edit": ctc_edit,
    "detection": _detection, "prior_box_nms": _prior_box_nms,
    "metrics": _metrics, "lod_reset_empty": _lod_reset_empty,
    "im2seq_spp": _im2seq_spp, "pool_unpool": _pool_unpool,
    "pn_pair": _pn_pair, "crf_decode": _crf_decode, "crf_train": _crf_train,
    "chunk_iob": _chunk_iob, "chunk_random": _chunk_random,
    "beam_ops": _beam_ops, "lod_functional": _lod_functional,
    "box_coder_variances": _box_coder_variances, "ssd": ssd,
}


@pytest.fixture(scope="module")
def jax_runs():
    return {name: jax_side(jfluid, fn) for name, fn in PROGRAMS.items()}


@pytest.fixture(autouse=True)
def fresh_programs():
    tfluid.framework.reset_default_programs()
    yield


def _port(name, jax_runs):
    out = port_side(tfluid, PROGRAMS[name], jax_runs[name]["init"])
    assert out["main"] == jax_runs[name]["main"], name
    assert out["startup"] == jax_runs[name]["startup"], name
    return out["steps"]


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_json_and_fetches_match_jax(name, jax_runs):
    rtol = 1e-4 if name == "crf_train" else RTOL
    assert_steps_close(_port(name, jax_runs), jax_runs[name]["steps"],
                       rtol, ATOL, name)


def test_rank_and_margin_rank_loss(jax_runs):
    rv, mv = _port("rank_margin", jax_runs)[0]
    lv = np.array([[1.0], [0.0]])
    o = np.array([[0.6], [0.2]]) - np.array([[0.4], [0.9]])
    np.testing.assert_allclose(
        rv, np.log1p(np.exp(-np.abs(o))) + np.maximum(o, 0) - lv * o,
        rtol=1e-5)
    np.testing.assert_allclose(mv, np.maximum(0.1 - lv * o, 0), rtol=1e-5,
                               atol=1e-7)


def test_modified_huber_and_label_smooth(jax_runs):
    ov, sv = _port("huber_smooth", jax_runs)[0]
    xv = np.array([[2.0], [0.5], [-3.0]])
    z = xv * (2 * np.array([[1.0], [0.0], [1.0]]) - 1)
    np.testing.assert_allclose(
        ov, np.where(z < -1, -4 * z, np.square(np.maximum(0, 1 - z))),
        rtol=1e-5)
    np.testing.assert_allclose(sv, 0.8 * np.eye(4)[:3] + 0.05, rtol=1e-5)


def test_bilinear_norm_prelu(jax_runs):
    bv, nv, pv = _port("bilinear_norm_prelu", jax_runs)[0]
    assert bv.shape == (2, 2)
    xv = np.ones((2, 3)) * np.array([1, -2, 3])
    np.testing.assert_allclose(nv, xv / np.sqrt(14), rtol=1e-5)
    assert (pv[:, 1] < 0).all() and (pv[:, [0, 2]] == xv[:, [0, 2]]).all()


def test_row_conv_and_conv_shift(jax_runs):
    rv, cv = _port("row_conv_shift", jax_runs)[0]
    xv = np.arange(12, dtype=np.float32).reshape(1, 4, 3)
    ref = xv.copy()
    ref[:, :-1] += xv[:, 1:]
    np.testing.assert_allclose(rv, ref, rtol=1e-5)
    np.testing.assert_allclose(cv, np.eye(5)[:1], atol=1e-6)


def test_lstm_unit_gru_unit_lstmp(jax_runs):
    hv, cellv, pv, pcv, gh, rhp, gate = _port("rnn_units", jax_runs)[0]
    rng = np.random.RandomState(1)
    xv, cv = rng.randn(2, 8), rng.randn(2, 2)
    i, f, ct, o = np.split(xv, 4, axis=1)
    sig = lambda v: 1 / (1 + np.exp(-v))
    c_ref = sig(f) * cv + sig(i) * np.tanh(ct)
    np.testing.assert_allclose(cellv, c_ref, rtol=1e-4)
    np.testing.assert_allclose(hv, sig(o) * np.tanh(c_ref), rtol=1e-4)
    assert pv.shape == (2, 3, 3) and gh.shape == (2, 2)


def test_dynamic_lstm_gru_state_carry(jax_runs):
    hv, cv, ghv = _port("dynamic_lstm_gru", jax_runs)[0]
    np.testing.assert_allclose(hv[0, 4], hv[0, 2], rtol=1e-6)
    np.testing.assert_allclose(ghv[0, 4], ghv[0, 2], rtol=1e-6)
    assert not np.allclose(ghv[1, 4], ghv[1, 2])


def test_sequence_ops(jax_runs):
    (ev, elen), slv, srv, mv = (lambda s: ((s[0], None), s[1], s[2], s[3]))(
        _port("sequence_ops", jax_runs)[0])
    sv = np.arange(16, dtype=np.float32).reshape(2, 4, 2)
    np.testing.assert_array_equal(ev, [[1, 0, 0], [5, 0, 0]])
    np.testing.assert_allclose(slv[0, :2], sv[0, 1:3])
    np.testing.assert_allclose(slv[0, 2:], 0)
    assert srv.shape == (2, 2, 4)
    np.testing.assert_array_equal(mv, [[1, 1, 1, 0], [1, 0, 0, 0]])


def test_sequence_concat_and_conv(jax_runs):
    steps = _port("sequence_concat_conv", jax_runs)[0]
    cv, scv = steps[0], steps[-1]
    av = np.arange(12, dtype=np.float32).reshape(2, 3, 2)
    bv = 100 + np.arange(8, dtype=np.float32).reshape(2, 2, 2)
    np.testing.assert_allclose(cv[0, :2], av[0, :2])
    np.testing.assert_allclose(cv[0, 2], bv[0, 0])
    np.testing.assert_allclose(cv[0, 3:], 0)
    np.testing.assert_allclose(cv[1, 3:5], bv[1])
    assert scv.shape == (2, 3, 4)


def test_warpctc_and_align_and_edit_distance(jax_runs):
    lossv, alv, alenv, dv, n = _port("ctc_edit", jax_runs)[0]
    assert lossv.shape == (2, 1) and np.all(lossv > 0)
    np.testing.assert_allclose(dv.reshape(-1), [1.0, 4.0])
    assert float(n) == 2.0


def test_detection_ops(jax_runs):
    iouv, mv, mdv = _port("detection", jax_runs)[0]
    assert iouv.shape == (2, 3)
    assert mv[0] == 0 and mv[1] == 1 and mv[2] == -1
    np.testing.assert_allclose(mdv[:2], 1.0, rtol=1e-5)


def test_prior_box_and_nms(jax_runs):
    bv, vv, dv = _port("prior_box_nms", jax_runs)[0]
    assert bv.shape == (4 * 4 * 3, 4) and vv.shape == bv.shape
    assert np.all((bv >= 0) & (bv <= 1))
    assert dv.shape == (6, 6)
    kept = dv[dv[:, 0] >= 0]
    assert len(kept) >= 1 and np.all(kept[:, 1] > 0)
    assert (dv[len(kept):, :2] == -1).all()   # the static -1 padding


def test_metric_ops(jax_runs):
    av, prfv = _port("metrics", jax_runs)[0]
    assert 0.95 <= float(av) <= 1.0
    assert prfv.shape == (6,)
    np.testing.assert_allclose(prfv[3:], 0.75, rtol=1e-5)


def _op_pair(name, ins, attrs):
    """the JAX op and the port op on the same float32 inputs."""
    jctx = jexec.OpRunCtx(False, jax.random.PRNGKey(0), 0)
    tctx = tfluid.executor.OpRunCtx(False, torch.device("cpu"), 0, 0, 0)
    jout = jops.get_op(name).fn(jctx, attrs, {
        s: [jnp.asarray(v) for v in vs] for s, vs in ins.items()})
    tout = tops.get_op(name).fn(tctx, attrs, {
        s: [torch.as_tensor(v) for v in vs] for s, vs in ins.items()})
    for s in jout:
        for a, b in zip(jout[s], tout[s]):
            a, b = np.asarray(a), b.numpy()
            assert a.shape == b.shape, (name, s)
            if np.issubdtype(a.dtype, np.floating):
                np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
            else:
                np.testing.assert_array_equal(b, a)
    return {s: [v.numpy() for v in vs] for s, vs in tout.items()}


def test_proximal_optimizer_ops():
    p, g = np.array([1.0, -2.0, 0.05], np.float32), np.full(3, 0.1,
                                                            np.float32)
    lr = np.array([0.5], np.float32)
    out = _op_pair("proximal_gd", {"Param": [p], "Grad": [g],
                                   "LearningRate": [lr]},
                   {"l1": 0.1, "l2": 0.0})
    prox = p - 0.5 * g
    np.testing.assert_allclose(
        out["ParamOut"][0], np.sign(prox) * np.maximum(np.abs(prox) - 0.05,
                                                       0), rtol=1e-5)
    out2 = _op_pair("proximal_adagrad", {
        "Param": [p], "Grad": [g], "LearningRate": [lr],
        "Moment": [np.ones(3, np.float32)]}, {"l1": 0.01, "l2": 0.02})
    assert out2["MomentOut"][0].shape == (3,)


def test_lod_reset_and_is_empty(jax_runs):
    yv, ev = _port("lod_reset_empty", jax_runs)[0]
    np.testing.assert_allclose(yv, 1.0)
    assert not bool(ev)


def test_im2sequence_and_spp(jax_runs):
    sv, pv = _port("im2seq_spp", jax_runs)[0]
    assert sv.shape == (1, 4, 4)
    np.testing.assert_allclose(sv[0, 0], [0, 1, 4, 5])
    np.testing.assert_allclose(sorted(pv[0]), [5, 7, 13, 15, 15])


def test_pool_with_index_and_unpool_roundtrip(jax_runs):
    pv, mv, rv = _port("pool_unpool", jax_runs)[0]
    np.testing.assert_allclose(pv[0, 0], [[10, 14], [26, 30]])
    np.testing.assert_array_equal(mv[0, 0], [[5, 7], [13, 15]])
    expect = np.zeros((4, 4), np.float32)
    for i in (5, 7, 13, 15):
        expect[i // 4, i % 4] = 2.0 * i
    np.testing.assert_allclose(rv[0, 0], expect)


def test_positive_negative_pair(jax_runs):
    pv, nv, uv = _port("pn_pair", jax_runs)[0]
    assert (pv.item(), nv.item(), uv.item()) == (2.0, 0.0, 0.0)


def test_dynamic_lstm_default_attrs_unique_params():
    L = tfluid.layers
    x = L.data(name="x", shape=[4, 16])
    h1, _ = L.dynamic_lstm(x, size=4)
    h2, _ = L.dynamic_lstm(x, size=4)
    names = [p.name for p in
             tfluid.default_main_program().global_block().all_parameters()]
    assert len(names) == len(set(names)) == 4
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(tfluid.default_startup_program(), scope=scope)
    out = exe.run(feed={"x": np.ones((2, 4, 16), np.float32)},
                  fetch_list=[h1, h2], scope=scope)
    assert all(np.isfinite(o).all() for o in out)
    assert not np.allclose(out[0], out[1])


def test_rank_loss_int_label_gradients_flow():
    L = tfluid.layers
    x = L.data(name="x", shape=[4])
    loss = L.mean(L.rank_loss(L.data(name="l", shape=[1], dtype="int64"),
                              L.fc(x, size=1), L.fc(x, size=1)))
    assert len(tfluid.backward.append_backward(loss)) == 4


# --------------------------------------------------- test_fluid_op_extras
def test_minus():
    out = _op_pair("minus", {"X": [np.full((2, 2), 5.0, np.float32)],
                             "Y": [np.full((2, 2), 2.0, np.float32)]}, {})
    np.testing.assert_allclose(out["Out"][0], 3.0)


def test_roi_pool_known_maxes():
    out = _op_pair("roi_pool", {
        "X": [np.arange(16, dtype=np.float32).reshape(1, 4, 4, 1)],
        "ROIs": [np.array([[0, 0, 0, 4, 4], [0, 1, 1, 3, 2]], np.float32)]},
        {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 1.0})
    np.testing.assert_allclose(out["Out"][0][0].reshape(2, 2),
                               [[5, 7], [13, 15]])
    np.testing.assert_array_equal(out["Argmax"][0][0].reshape(2, 2),
                                  [[5, 7], [13, 15]])


@pytest.mark.parametrize("ap_type", ["11point", "integral"])
def test_detection_map_11point_hand_case(ap_type):
    gt = np.array([[1, 0.0, 0.0, 0.4, 0.4], [1, 0.6, 0.6, 1.0, 1.0]],
                  np.float32)
    det = np.array([[1, 0.9, 0.0, 0.0, 0.4, 0.4],
                    [1, 0.8, 0.0, 0.6, 0.3, 0.9],
                    [-1, 0, 0, 0, 0, 0]], np.float32)
    out = _op_pair("detection_map", {"DetectRes": [det], "Label": [gt]},
                   {"overlap_threshold": 0.5, "ap_type": ap_type,
                    "class_num": 3})
    if ap_type == "11point":
        np.testing.assert_allclose(float(out["Out"][0][0]), 6.0 / 11.0,
                                   rtol=1e-5)


def test_shrink_rnn_memory_masks_finished_rows():
    out = _op_pair("shrink_rnn_memory", {
        "X": [np.ones((3, 2), np.float32)],
        "Lens": [np.array([3, 2, 1], np.int32)],
        "I": [np.array([1], np.int32)]}, {})
    np.testing.assert_allclose(out["Out"][0], [[1, 1], [1, 1], [0, 0]])


def test_lod_tensor_array_roundtrip(jax_runs):
    steps = _port("lod_functional", jax_runs)[0]
    arr, back = steps[2], steps[3]
    xv = np.arange(12, dtype=np.float32).reshape(2, 3, 2)
    assert arr.shape == (3, 2, 2)
    np.testing.assert_allclose(back, xv)


def test_split_selected_rows_routes_and_localizes():
    vals = np.arange(8, dtype=np.float32).reshape(4, 2)
    out = _op_pair("split_selected_rows", {
        "Ids": [np.array([1, 7, 3, 9], np.int32)], "Values": [vals]},
        {"height_sections": [5, 5]})
    np.testing.assert_array_equal(out["OutIds"][0], [1, -1, 3, -1])
    np.testing.assert_array_equal(out["OutIds"][1], [-1, 2, -1, 4])
    np.testing.assert_allclose(out["OutValues"][1][1], vals[1])


# ------------------------------------------------------ test_fluid_surface2
def test_linear_chain_crf_and_decoding(jax_runs):
    llv, pv = _port("crf_decode", jax_runs)[0]
    assert llv.shape == (2, 1) and np.all(llv <= 0.0)
    np.testing.assert_array_equal(pv[0], [1, 1, 1, 1])
    assert pv[1, 3] == 0


def test_crf_trains_toward_labels(jax_runs):
    losses = [float(s[0]) for s in _port("crf_train", jax_runs)]
    assert losses[-1] < losses[0]


def test_chunk_eval_iob(jax_runs):
    p_, r_, f_, ni, nl, nc = _port("chunk_iob", jax_runs)[0]
    assert (int(ni), int(nl), int(nc)) == (2, 2, 1)
    np.testing.assert_allclose([p_, r_], 0.5)


def test_chunk_eval_matches_host_evaluator(jax_runs):
    """the op's counts against the port's host-side evaluator.Chunk."""
    from paddle_tpu_torch import evaluator as ev
    got = _port("chunk_random", jax_runs)[0][3:]
    feed = _chunk_random(tfluid)[1][0]
    t = feed["p"].shape[1]
    mask = (np.arange(t)[None, :] < feed["n"][:, None]).astype(np.float32)
    acc = ev.Chunk(None, None, chunk_scheme="IOB", num_chunk_types=3).merge(
        None, (feed["p"], feed["l"], mask))
    assert [int(g) for g in got] == [int(acc[1]), int(acc[2]), int(acc[0])]


def test_beam_search_ops_roundtrip(jax_runs):
    idv, scv, pv, sentv, _ = _port("beam_ops", jax_runs)[0]
    assert idv[0, 0] == 4 and pv[0, 0] == 0
    row1 = list(zip(idv[1], pv[1]))
    assert (0, 0) in row1
    np.testing.assert_allclose(scv[1, row1.index((0, 0))], -0.5, rtol=1e-5)
    np.testing.assert_array_equal(sentv[0, 0], [6, 7, 9])
    np.testing.assert_array_equal(sentv[0, 1], [5, 8, 10])


def test_lod_functional_equivalents(jax_runs):
    rv, mv, _, _, fv, lv = _port("lod_functional", jax_runs)[0]
    xv = np.arange(9, dtype=np.float32).reshape(3, 3)
    np.testing.assert_allclose(rv, xv[[1, 2, 0]])
    assert int(mv) == 5
    qv = np.arange(24, dtype=np.float32).reshape(2, 4, 3)
    np.testing.assert_allclose(fv, qv[:, 0])
    np.testing.assert_allclose(lv, qv[:, -1])


def test_box_coder_per_prior_variances(jax_runs):
    enc, dec = _port("box_coder_variances", jax_runs)[0]
    base = np.random.RandomState(0).rand(3, 2) * 0.5
    np.testing.assert_allclose(dec, np.concatenate([base + 0.05,
                                                    base + 0.25], 1),
                               atol=1e-5)


def test_nce_trains():
    L = tfluid.layers
    x = L.data(name="x", shape=[8])
    h = L.fc(x, size=16, act="tanh")
    cost = L.mean(L.nce(h, L.data(name="l", shape=[1], dtype="int64"),
                        num_total_classes=50, num_neg_samples=5))
    tfluid.optimizer.SGD(learning_rate=0.1).minimize(cost)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(tfluid.default_startup_program(), scope=scope)
    rng = np.random.RandomState(0)
    f = {"x": rng.randn(16, 8).astype(np.float32),
         "l": rng.randint(0, 50, (16, 1)).astype(np.int64)}
    costs = [float(exe.run(feed=f, fetch_list=[cost], scope=scope)[0])
             for _ in range(25)]
    assert costs[-1] < costs[0]


def test_distribute_transpiler_and_memory_optimize_shims():
    L = tfluid.layers
    L.mean(L.fc(L.data(name="x", shape=[4]), size=2))
    t = tfluid.DistributeTranspiler()
    prog = t.transpile(trainer_id=0, trainers=2, pservers="h1:6174,h2:6174")
    assert prog is tfluid.default_main_program()
    assert t.get_trainer_program() is prog
    with pytest.raises(NotImplementedError):
        t.get_pserver_program("h1:6174")
    assert tfluid.memory_optimize(prog) is prog


# -------------------------------------------------------- test_fluid_fixes
def test_two_same_shape_random_inits_differ():
    L = tfluid.layers
    L.fc(L.fc(L.data(name="x", shape=[8]), size=8), size=8)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(tfluid.default_startup_program(), scope=scope)
    ws = [np.asarray(scope.get(p.name)) for p in
          tfluid.default_main_program().global_block().all_parameters()
          if p.shape == (8, 8)]
    assert len(ws) == 2 and not np.allclose(ws[0], ws[1])


def test_two_dropouts_draw_different_masks():
    L = tfluid.layers
    x = L.data(name="x", shape=[64])
    d1, d2 = L.dropout(x, dropout_prob=0.5), L.dropout(x, dropout_prob=0.5)
    a, b = tfluid.Executor(tfluid.CPUPlace()).run(
        feed={"x": np.ones((4, 64), np.float32)}, fetch_list=[d1, d2],
        scope=tfluid.Scope())
    assert not np.allclose(a, b)


def test_check_nan_inf_raises():
    L = tfluid.layers
    y = L.log(L.data(name="x", shape=[2]))
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    bad = {"x": np.asarray([[-1.0, 1.0]], np.float32)}
    with pytest.raises(FloatingPointError):
        exe.run(feed=bad, fetch_list=[y], scope=scope, check_nan_inf=True)
    out, = exe.run(feed=bad, fetch_list=[y], scope=scope)
    assert np.isnan(out[0, 0])


def test_ssd_loss_with_1d_gt_labels_and_detection_output(jax_runs):
    """ssd_loss (1-D gt labels lifted to [N, 1]) and detection_output run
    end to end: a finite scalar loss and a [keep_top_k, 6] detection
    block, both the JAX package's."""
    loss, det = _port("ssd", jax_runs)[0]
    assert np.prod(loss.shape) == 1 and np.isfinite(loss).all()
    assert det.shape == (10, 6)


# ---------------------------------------------------------------- debugger
def test_debugger_text_equals_the_jax_packages():
    """pprint_program and to_dot of a program with a While sub-block, a
    StaticRNN and a backward: the same text in both packages."""
    def build(fl):
        fl.framework.reset_default_programs()
        L = fl.layers
        x = L.data(name="x", shape=[3, 2, 4], append_batch_size=False)
        boot = L.fill_constant([2, 4], "float32", 0.0)
        rnn = L.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            prev = rnn.memory(init=boot)
            h = L.fc(input=[x_t, prev], size=4, act="tanh")
            rnn.update_memory(prev, h)
            rnn.step_output(h)
        loss = L.mean(rnn())
        i = L.fill_constant([1], "float32", 0.0)
        cond = L.less_than(i, L.fill_constant([1], "float32", 2.0))
        w = L.While(cond=cond)
        with w.block():
            L.assign(L.increment(i, value=1.0), output=i)
            L.less_than(i, L.fill_constant([1], "float32", 2.0), cond=cond)
        fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
        prog = fl.default_main_program()
        return (fl.debugger.pprint_program(prog),
                [fl.debugger.to_dot(prog, b) for b in range(len(
                    prog.blocks))], fl.debugger.draw_block_graphviz(prog))

    want, got = build(jfluid), build(tfluid)
    assert got == want
    assert "block 1 (parent 0)" in got[0] and got[1][0].startswith("digraph")
