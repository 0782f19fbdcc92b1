"""Resume across the checkpoint write side of the PyTorch port, on the CPU.

- Same layout: from one config, optimizer and set of weights, the port's
  trainer writes its pass snapshot and the JAX package's ``save`` writes
  the JAX trainer's state (the call its ``train`` makes at a pass's end):
  the same files, the same npz keys, shapes and dtypes in every payload,
  the same manifest fields but the generator's (``torch_rng`` against
  ``rng``).  The LM under ``fp32``, ``bf16`` and ``mixed`` (its
  ``loss_scale``), ResNet-50 at 32 px (``model_state``), the CTR model
  with ``sparse_update`` tables and ``ModelAverage`` (``avg``,
  ``avg_n``), the NMT model (a recurrent group).  The step snapshots of
  both trainers take the same global-step names at k = 1 and k = 2.
- Resume is bit-equal in the port: a run stopped after a step snapshot
  and resumed by a trainer seeded otherwise ends with the uninterrupted
  run's losses, parameters, slots, ``t``, loss scale, running state,
  global step and generator state, bit for bit: an MLP with batch norm and
  dropout under ``mixed``, at k = 1, k = 2 and ``prefetch_depth=2``.
- Both ways across the packages (the LM at ``fp32``, no dropout: the JAX
  package's random stream is its own): the JAX trainer restores a port
  snapshot whole (every leaf bit for bit, none left at the template's),
  auto-resumes the port's directory mid-pass without a warning, and both
  packages then take the same 2 steps, losses within 1e-5 relative and
  parameters within 1e-5 (``tests/test_torch_training.py``'s trajectory
  tolerances); the port restores a JAX snapshot whole.
- A reference caveat: the JAX package's loader splits a key at every
  ``::``, so a recurrent group's ``<group>::<step layer>::<param>``
  parameters (and their slots) come back a level too deep and its
  ``graft`` keeps the template's; the NMT test asserts exactly that, and
  that the port restores them.
"""

import os
import shutil
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.core import config as jconfig
from paddle_tpu.core import precision as jprecision
from paddle_tpu.core.ir import reset_name_counters as reset_jax_names
from paddle_tpu.io import checkpoint as jckpt
from paddle_tpu.models import ctr as jctr
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.models import seq2seq as jseq2seq
from paddle_tpu.models import transformer as jtr
from paddle_tpu_torch.core import config as tconfig
from paddle_tpu_torch.core import precision as tprecision
from paddle_tpu_torch.core.ir import reset_name_counters as reset_port_names
from paddle_tpu_torch.io import checkpoint as tckpt
from paddle_tpu_torch.models import ctr as tctr
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models import seq2seq as tseq2seq
from paddle_tpu_torch.models import transformer as ttr

SMALL_LM = dict(vocab_size=50, max_len=12, dim=32, num_heads=2,
                num_layers=2)
SMALL_NMT = dict(src_vocab_size=50, trg_vocab_size=40, emb_dim=16,
                 enc_dim=24, dec_dim=32, max_src_len=6, max_trg_len=6)
CTR_VOCABS = (1000, 1000, 100)
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _restore_options():
    topts, jopts = dict(tconfig._options), dict(jconfig._options)
    warned = (tprecision._legacy_warned, jprecision._legacy_warned)
    yield
    for mod, saved in ((tconfig, topts), (jconfig, jopts)):
        mod._options.clear()
        mod._options.update(saved)
    jconfig._policy_cache = None
    tprecision._legacy_warned, jprecision._legacy_warned = warned


class _Stop(Exception):
    """Raised by an event handler: a run cut short."""


def _init(seed=0, precision=None):
    reset_jax_names()
    reset_port_names()
    kw = {} if precision is None else {"precision": precision}
    pj.init(seed=seed, **kw)
    pt.init(seed=seed, device="cpu", **kw)


# ------------------------------------------------------------ the models
def _lm_feed(seed):
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, 50, (3, 12)).astype(np.int32),
            "targets": rng.randint(0, 50, (3, 12)).astype(np.int32)}


def _nmt_feed(seed):
    rng = np.random.RandomState(seed)
    trg_len = np.array([3, 6, 1, 5], np.int32)
    return {"source_words": rng.randint(0, 50, (4, 6)).astype(np.int32),
            "source_words@len": np.array([6, 1, 4, 5], np.int32),
            "target_words": rng.randint(0, 40, (4, 6)).astype(np.int32),
            "target_words@len": trg_len,
            "target_next_words": rng.randint(0, 40, (4, 6)).astype(
                np.int32),
            "target_next_words@len": trg_len}


def _ctr_feed(seed):
    rng = np.random.RandomState(seed)
    feed = {f"f{i}": ((rng.zipf(1.3, 32) - 1) % v).astype(np.int32)
            for i, v in enumerate(CTR_VOCABS)}
    feed["click"] = rng.randint(0, 2, 32).astype(np.int32)
    return feed


def _resnet_feed(seed):
    rng = np.random.RandomState(seed)
    return {"image": rng.randn(2, 32, 32, 3).astype(np.float32),
            "label": rng.randint(0, 10, 2).astype(np.int32)}


MODELS = {
    # name: (the cost of a module, the optimizer of a package, feed(seed),
    #        precision)
    "lm_fp32": (lambda m: m.build(**SMALL_LM)[0],
                lambda p: p.optimizer.Adam(learning_rate=1e-2), _lm_feed,
                "fp32"),
    "lm_bf16": (lambda m: m.build(**SMALL_LM)[0],
                lambda p: p.optimizer.Adam(learning_rate=1e-2), _lm_feed,
                "bf16"),
    "lm_mixed": (lambda m: m.build(**SMALL_LM)[0],
                 lambda p: p.optimizer.Adam(learning_rate=1e-2), _lm_feed,
                 "mixed"),
    "resnet": (lambda m: m.build(depth=50, image_size=32,
                                 num_classes=10)[0],
               lambda p: p.optimizer.Momentum(learning_rate=0.1,
                                              momentum=0.9),
               _resnet_feed, None),
    "ctr": (lambda m: m.build(field_vocab_sizes=CTR_VOCABS,
                              sparse_update=True)[0],
            lambda p: p.optimizer.Adam(
                learning_rate=1e-2,
                model_average=p.optimizer.ModelAverage(0.5)),
            _ctr_feed, None),
    "nmt": (lambda m: m.build(**SMALL_NMT),
            lambda p: p.optimizer.Adam(learning_rate=1e-3), _nmt_feed,
            None),
}
MODULES = {"lm": (jtr, ttr), "resnet": (jresnet, tresnet),
           "ctr": (jctr, tctr), "nmt": (jseq2seq, tseq2seq)}


def _jax_params(jtopo, values):
    """The JAX package's ``Parameters`` of ``jtopo`` holding ``values``
    (its meta as ``Topology.create_parameters`` makes it, without running
    its initializers: ResNet-50's take seconds)."""
    import jax.numpy as jnp

    meta = {}
    for spec in jtopo.specs:
        for p in jtopo.param_specs[spec.name]:
            if not p.is_state:
                meta.setdefault(spec.name, {})[p.name] = {
                    "learning_rate": p.learning_rate,
                    "is_static": p.is_static, "l1": p.l1_decay,
                    "l2": p.l2_decay,
                    "clip": p.gradient_clipping_threshold,
                    "sparse_update": p.sparse_update}
    return pj.parameters.Parameters(
        {l: {p: jnp.asarray(values[l][p]) for p in ps}
         for l, ps in meta.items()}, meta)


def _pair(name, seed=0):
    """Both packages' trainers of MODELS[name] from the same weights (the
    port's initializers')."""
    build, opt, _, precision = MODELS[name]
    jmod, tmod = MODULES[name.split("_")[0]]
    _init(seed, precision=precision)
    jtopo = pj.Topology(build(jmod), collect_evaluators=False)
    ttopo = pt.Topology(build(tmod), collect_evaluators=False)
    values = {l: {p: t.numpy().copy() for p, t in ps.items()}
              for l, ps in pt.parameters.create(ttopo).values.items()}
    jtrainer = pj.trainer.SGD(jtopo, _jax_params(jtopo, values), opt(pj))
    ttrainer = pt.trainer.SGD(
        ttopo, pt.parameters.from_numpy(ttopo, values, device="cpu"),
        opt(pt))
    return jtrainer, ttrainer


def _layout(d):
    files = sorted(os.listdir(d))
    arrays = {}
    for f in files:
        if f.endswith(".npz"):
            with np.load(os.path.join(d, f)) as z:
                arrays[f] = {k: (z[k].shape, z[k].dtype.str) for k in z.files}
    return files, arrays


@pytest.mark.parametrize("name", sorted(MODELS))
def test_same_layout_as_jax(tmp_path, name):
    jtrainer, ttrainer = _pair(name)
    feed = MODELS[name][2](0)
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    ttrainer.train(lambda: iter([feed]), event_handler=lambda e: None,
                   checkpoint_config=tckpt.CheckpointConfig(tdir))
    # the JAX trainer's pass-end save, on its state
    jtrainer._sync_precision_policy()
    jckpt.save(jdir, 0, trainable=jtrainer._trainable,
               opt_state=jtrainer._opt_state,
               model_state=jtrainer.model_state, frozen=jtrainer._frozen,
               extra={"rng": np.asarray(jtrainer._rng).tolist(),
                      "global_step": 1})
    tfiles, tarrays = _layout(tckpt.pass_dir(tdir, 0))
    jfiles, jarrays = _layout(jckpt.pass_dir(jdir, 0))
    assert tfiles == jfiles
    assert tarrays == jarrays
    tman = tckpt.verify_snapshot(tckpt.pass_dir(tdir, 0))
    jman = jckpt.verify_snapshot(jckpt.pass_dir(jdir, 0))
    assert set(tman) - {"torch_rng"} == set(jman) - {"rng"}
    assert {k: tman[k] for k in ("pass_id", "format", "process_count",
                                 "global_step")} == {
        k: jman[k] for k in ("pass_id", "format", "process_count",
                             "global_step")}
    opt = tarrays["opt_state.npz"]
    if name == "lm_mixed":
        assert opt["loss_scale::scale"] == ((), "<f4")
        assert opt["loss_scale::good_steps"] == ((), "<i4")
    if name == "ctr":
        assert opt["avg_n"] == ((), "<f4") and any(
            k.startswith("avg::") for k in opt)
    if name == "resnet":
        assert tarrays["model_state.npz"]
    if name == "nmt":
        assert any(k.count("::") == 2 for k in tarrays["params.npz"])
    # every leaf is float32 or int32 (numpy reads them without ml_dtypes)
    assert {dt for f in tarrays.values() for _, dt in f.values()} <= {
        "<f4", "<i4"}


def _mlp_pair():
    """The same MLP in each package (its own initial weights)."""
    _init()
    outs = []
    for pkg in (pj, pt):
        reset_jax_names() if pkg is pj else reset_port_names()
        layer = pkg.layer
        x = layer.data("x", pkg.data_type.dense_vector(8))
        y = layer.data("y", pkg.data_type.integer_value(4))
        cost = layer.classification_cost(
            layer.fc(layer.fc(x, size=16, act="relu"), size=4), y)
        topo = (pj.Topology(cost, collect_evaluators=False) if pkg is pj
                else pt.Topology(cost))
        outs.append(pkg.trainer.SGD(
            topo, pkg.parameters.create(topo),
            pkg.optimizer.Momentum(learning_rate=0.05, momentum=0.9)))
    return outs


def _mlp_batches(n=6, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(16, 8).astype(np.float32),
             "y": rng.randint(0, 4, 16).astype(np.int32)} for _ in range(n)]


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("every", [2, 3])
def test_step_names_as_jax(tmp_path, k, every):
    """Stopped at the pass's last batch (its chunk-edge snapshot not yet
    taken), each package's step snapshots carry the same global steps:
    at k = 2 a period boundary inside a chunk snapshots at its edge."""
    batches = _mlp_batches()
    names = []
    for i, tr in enumerate(_mlp_pair()):
        mod = jckpt if i == 0 else tckpt
        d = str(tmp_path / f"ck{i}")

        with pytest.raises(_Stop):
            tr.train(lambda: iter(batches), event_handler=_stop_at(5),
                     steps_per_dispatch=k,
                     checkpoint_config=mod.CheckpointConfig(
                         d, save_period_steps=every, async_save=False,
                         keep_step_snapshots=5))
        names.append(mod.list_steps(d))
    assert names[0] == names[1]
    assert names[1] == {(1, 2): [2, 4], (2, 2): [2, 4], (1, 3): [3],
                        (2, 3): [4]}[(k, every)]


def _stop_at(batch, event="EndIteration"):
    """An event handler of either package that raises at ``event`` of
    batch ``batch`` (BeginIteration: before that batch's step)."""
    def handler(e):
        if type(e).__name__ == event and e.batch_id >= batch:
            raise _Stop
    return handler


# -------------------------------------------------- bit-equal in the port
def _bn_drop(seed):
    """An MLP with a batch norm (running state) and a dropout (the
    generator) under ``mixed`` (the loss scale), Adam."""
    reset_port_names()
    pt.init(seed=seed, device="cpu", precision="mixed")
    layer = pt.layer
    x = layer.data("x", pt.data_type.dense_vector(8))
    y = layer.data("y", pt.data_type.integer_value(4))
    h = layer.fc(layer.batch_norm(x), size=16, act="relu")
    h = layer.dropout(h, rate=0.3)
    topo = pt.Topology(layer.classification_cost(layer.fc(h, size=4), y))
    return pt.trainer.SGD(topo, pt.parameters.create(topo),
                          pt.optimizer.Adam(learning_rate=1e-2))


def _state(tr):
    """Every tensor of the trainer's state, with its path, and the
    generator's state and the global step."""
    out = {}
    for name, tree in (("params", tr._trainable), ("opt", tr._opt_state),
                       ("model", tr.model_state)):
        stack = [((name,), tree)]
        while stack:
            path, node = stack.pop()
            for k, v in node.items():
                if isinstance(v, dict):
                    stack.append((path + (k,), v))
                elif v is not None:
                    out["/".join(path + (k,))] = v.clone()
    out["rng"] = tr._generator.get_state()
    out["global_step"] = torch.tensor(tr._global_step)
    return out


def _losses(log):
    def handler(e):
        if isinstance(e, pt.event.EndIteration):
            log.append((e.pass_id, e.batch_id, float(e.cost)))
    return handler


@pytest.mark.parametrize("mode", ["k1", "k2", "prefetch2"])
def test_port_resume_is_bit_equal(tmp_path, mode):
    kw = {"k1": {}, "k2": {"steps_per_dispatch": 2},
          "prefetch2": {"prefetch_depth": 2}}[mode]
    batches = _mlp_batches(6)
    reader = lambda: iter(batches)         # noqa: E731
    ref_log = []
    ref = _bn_drop(0)
    ref.train(reader, num_passes=2, event_handler=_losses(ref_log), **kw)
    want = _state(ref)

    d = str(tmp_path / "ck")
    cfg = lambda: tckpt.CheckpointConfig(d, save_period_steps=2)  # noqa
    stopped = _bn_drop(0)

    def stop(e):
        if isinstance(e, pt.event.EndIteration) and e.pass_id == 1 \
                and e.batch_id >= 3:
            raise _Stop

    with pytest.raises(_Stop):
        stopped.train(reader, num_passes=2, event_handler=stop,
                      checkpoint_config=cfg(), **kw)
    assert stopped._ckpt_writer.flush() == []
    assert tckpt.list_steps(d) == [8]
    man = tckpt.load(d)["manifest"]
    assert (man["pass_id"], man["batches_done"], man["global_step"]) == (
        1, 2, 8)

    log = []
    resumed = _bn_drop(5)                  # other weights, another stream
    resumed.train(reader, num_passes=2, event_handler=_losses(log),
                  checkpoint_config=cfg(), **kw)
    assert [r[:2] for r in log] == [(1, b) for b in range(2, 6)]
    assert [r[2] for r in log] == [r[2] for r in ref_log[-4:]]
    got = _state(resumed)
    assert got.keys() == want.keys()
    assert "opt/loss_scale/scale" in got and "model/" in "".join(got)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0,
                                   msg=key)
    assert int(got["global_step"]) == 12
    # the pass snapshot superseded the step snapshots
    assert tckpt.list_steps(d) == [] and tckpt.list_passes(d) == [0, 1]


# ------------------------------------------------------ across packages
def _leaves_of(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}::{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_leaves_of(v, key))
        elif v is not None:
            out[key] = np.array(v.detach() if torch.is_tensor(v) else v)
    return out


def _jax_state(jtrainer):
    return {name: _leaves_of(tree) for name, tree in (
        ("trainable", jtrainer._trainable), ("opt", jtrainer._opt_state),
        ("model", jtrainer.model_state))}


def _port_state(ttrainer):
    return {name: _leaves_of(tree) for name, tree in (
        ("trainable", ttrainer._trainable), ("opt", ttrainer._opt_state),
        ("model", ttrainer.model_state))}


def _lm_reader(n=4):
    feeds = [_lm_feed(s) for s in range(n)]
    return lambda: iter(feeds)




def _assert_whole(got, want, template=None):
    """``got`` holds every leaf of ``want`` bit for bit; with
    ``template``, none of them is still the template's (after two Adam
    steps every parameter, slot and ``t`` has moved)."""
    for name in ("trainable", "opt", "model"):
        assert got[name].keys() == want[name].keys(), name
        for key, arr in want[name].items():
            np.testing.assert_array_equal(got[name][key], arr, err_msg=key)
            if template is not None:
                assert not np.array_equal(template[name][key], arr), key


def _continue(tmp_path, d, jlog, tlog):
    """A fresh trainer of each package auto-resumes ``d`` (the port on a
    copy) and runs the pass out; returns (JAX trainer, port trainer)."""
    port_dir = str(tmp_path / "continue_port")
    shutil.copytree(d, port_dir)
    _, tfresh = _pair("lm_fp32", seed=3)
    jfresh, _ = _pair("lm_fp32", seed=3)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        jfresh.train(_lm_reader(), event_handler=_jax_losses(jlog),
                     checkpoint_config=jckpt.CheckpointConfig(
                         d, save_period_steps=2, async_save=False))
        tfresh.train(_lm_reader(), event_handler=_losses(tlog),
                     checkpoint_config=tckpt.CheckpointConfig(
                         port_dir, save_period_steps=2))
    assert not [w for w in caught
                if issubclass(w.category, RuntimeWarning)], caught
    return jfresh, tfresh


def _held_together(jtrainer, ttrainer, jlog, tlog):
    assert [r[:2] for r in jlog] == [r[:2] for r in tlog] == [(0, 2),
                                                               (0, 3)]
    np.testing.assert_allclose([r[2] for r in tlog], [r[2] for r in jlog],
                               rtol=LOSS_RTOL, atol=0)
    assert jtrainer._global_step == ttrainer._global_step == 4
    jv = _jax_state(jtrainer)["trainable"]
    for key, arr in _port_state(ttrainer)["trainable"].items():
        np.testing.assert_allclose(arr, jv[key], atol=PARAM_ATOL,
                                   err_msg=key)


def test_jax_restores_and_resumes_a_port_snapshot(tmp_path):
    jtrainer, ttrainer = _pair("lm_fp32")
    template = _jax_state(jtrainer)
    d = str(tmp_path / "ck")
    with pytest.raises(_Stop):
        ttrainer.train(_lm_reader(), event_handler=_stop_at(
            2, "BeginIteration"), checkpoint_config=tckpt.CheckpointConfig(
                d, save_period_steps=2, async_save=False))
    assert tckpt.list_steps(d) == [2]
    jtrainer.restore(jckpt.load(d))
    _assert_whole(_jax_state(jtrainer), _port_state(ttrainer), template)
    assert jtrainer._global_step == 2
    jlog, tlog = [], []
    jfresh, tfresh = _continue(tmp_path, d, jlog, tlog)
    _held_together(jfresh, tfresh, jlog, tlog)


def _jax_losses(log):
    def handler(e):
        if isinstance(e, pj.event.EndIteration):
            log.append((e.pass_id, e.batch_id, float(e.cost)))
    return handler


def test_port_restores_and_resumes_a_jax_snapshot(tmp_path):
    jtrainer, _ = _pair("lm_fp32")
    d = str(tmp_path / "ck")
    with pytest.raises(_Stop):
        jtrainer.train(_lm_reader(), event_handler=_stop_at(
            2, "BeginIteration"), checkpoint_config=jckpt.CheckpointConfig(
                d, save_period_steps=2, async_save=False))
    assert jckpt.list_steps(d) == [2]
    _, ttrainer = _pair("lm_fp32", seed=3)
    template = _port_state(ttrainer)
    rng_before = ttrainer._generator.get_state()
    ttrainer.restore(tckpt.load(d))
    _assert_whole(_port_state(ttrainer), _jax_state(jtrainer), template)
    assert ttrainer._global_step == 2
    # the JAX snapshot holds no torch_rng: the generator stays its own
    assert torch.equal(ttrainer._generator.get_state(), rng_before)
    jlog, tlog = [], []
    jfresh, tfresh = _continue(tmp_path, d, jlog, tlog)
    _held_together(jfresh, tfresh, jlog, tlog)


def test_nmt_group_caveat(tmp_path):
    """The JAX package restores every leaf of a port NMT snapshot but the
    recurrent group's parameters and slots, which it leaves at the
    template's (its loader splits ``decoder_group::att::v`` three
    levels deep); the port restores the JAX package's snapshot whole,
    the group included."""
    jtrainer, ttrainer = _pair("nmt")
    template = _jax_state(jtrainer)
    d = str(tmp_path / "port")
    ttrainer.train(lambda: iter([_nmt_feed(0)]), event_handler=lambda e: 0,
                   checkpoint_config=tckpt.CheckpointConfig(d))
    port = _port_state(ttrainer)
    jtrainer.restore(jckpt.load(d))
    got = _jax_state(jtrainer)
    group = [k for k in port["trainable"] if k.count("::") == 2]
    assert group and all(k.startswith("decoder_group::") for k in group)
    for name in ("trainable", "opt"):
        for key, want in port[name].items():
            in_group = any(key.endswith(g) or f"{g}::" in key
                           for g in group)
            if in_group:
                # the caveat: still the template's, not the snapshot's
                np.testing.assert_array_equal(got[name][key],
                                              template[name][key])
                if name == "trainable":
                    assert not np.array_equal(want, template[name][key])
            else:
                np.testing.assert_array_equal(got[name][key], want,
                                              err_msg=key)
    # the other way: a JAX NMT snapshot comes back whole in the port
    jdir = str(tmp_path / "jax")
    jckpt.save(jdir, 0, trainable=jtrainer._trainable,
               opt_state=jtrainer._opt_state,
               model_state=jtrainer.model_state, frozen=jtrainer._frozen,
               extra={"global_step": 7})
    _, other = _pair("nmt", seed=4)
    other.restore(tckpt.load(jdir))
    back = _port_state(other)
    for name in ("trainable", "opt"):
        for key, want in got[name].items():
            np.testing.assert_array_equal(back[name][key], want,
                                          err_msg=key)
    assert other._global_step == 7
