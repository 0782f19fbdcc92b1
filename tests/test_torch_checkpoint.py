"""The checkpoint write side of the PyTorch port
(paddle_tpu_torch/io/checkpoint.py, io/atomic.py, ``trainer.SGD.train(
checkpoint_config=)``, the ``checkpoint`` CLI verb) held to the
single-process contracts of tests/test_checkpoint.py, on the CPU: the
pass-dir layout and its pruning, ``save_only_one`` / ``saving_period``,
step snapshots and their prune, quarantine and fallback (checksum
failure, a torn legacy npz, a concurrently removed dir), the async
writer's errors surfaced once, auto-resume's fallback and fresh start, a
SIGKILL mid-save never half-finalized (a child process), republishing,
``atomic_write_file``, the frozen dedup store and its collection, the
scrubber, the read-only audit, and a prune that unlists before it
deletes.  Where the JAX test reads a metrics counter (not ported: item
13), the test here asserts what the counter counts: the rename to
``*.corrupt``, the warning, the error list.  A multi-host JAX snapshot's
sharded payloads are read back whole; writing them is refused.  The
payload writer (``_savez``, which hands each array to the zip as one
buffer) writes the bytes ``np.savez`` writes."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import layer
from paddle_tpu_torch.core.ir import reset_name_counters
from paddle_tpu_torch.io import checkpoint as ckpt
from paddle_tpu_torch.io.checkpoint import CheckpointConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _build():
    reset_name_counters()
    paddle.init(seed=0, device="cpu")
    x = layer.data("x", paddle.data_type.dense_vector(8))
    y = layer.data("y", paddle.data_type.integer_value(4))
    pred = layer.fc(layer.fc(x, size=16, act="relu"), size=4)
    cost = layer.classification_cost(pred, y)
    topo = paddle.Topology(cost, collect_evaluators=False)
    params = paddle.parameters.create(topo)
    opt = paddle.optimizer.Momentum(learning_rate=0.05, momentum=0.9)
    return paddle.trainer.SGD(topo, params, opt)


def _reader():
    rng = np.random.RandomState(0)
    protos = rng.randn(4, 8).astype(np.float32)
    batches = []
    for _ in range(6):
        ys = rng.randint(0, 4, 16)
        xs = protos[ys] + 0.1 * rng.randn(16, 8).astype(np.float32)
        batches.append([(xs[i], int(ys[i])) for i in range(16)])
    return lambda: iter(batches)


def _quiet(e):
    return None


def _passes(seen):
    return lambda e: (seen.append(e.pass_id)
                      if isinstance(e, paddle.event.BeginPass) else None)


def _leaves(tr):
    return [t.clone() for ps in tr._trainable.values()
            for t in ps.values() if t is not None]


def _flip_byte(path):
    with open(path, "rb") as f:
        blob = bytearray(f.read())
    blob[len(blob) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(blob)


class _Stop(Exception):
    pass


def _stop_after(batch):
    def handler(e):
        if isinstance(e, paddle.event.EndIteration) and e.batch_id >= batch:
            raise _Stop
    return handler


# ------------------------------------------------------------ pass dirs
@pytest.mark.parametrize("arr", [
    np.arange(12, dtype=np.float32).reshape(3, 4),
    np.float32(2.5),
    np.array(3, np.int32),
    np.zeros((0, 5), np.int64),
    np.asfortranarray(np.arange(12.0).reshape(4, 3)),
    np.arange(60.0).reshape(3, 4, 5).transpose(1, 0, 2),
    np.arange(7, dtype=np.uint16)[::2],
    np.array([True, False]),
], ids=["c", "scalar", "0d", "empty", "fortran", "strided", "sliced",
        "bool"])
def test_savez_writes_np_savez_bytes(tmp_path, arr):
    tree = {"l": {"w": arr}, "g": {"step::w": torch.ones(2, 3)}}
    ckpt._savez(str(tmp_path / "a.npz"), tree)
    np.savez(str(tmp_path / "b.npz"), **ckpt._flatten(tree))
    assert (tmp_path / "a.npz").read_bytes() == \
        (tmp_path / "b.npz").read_bytes()


def test_save_layout_and_prune(tmp_path):
    d = str(tmp_path / "ck")
    _build().train(_reader(), num_passes=3, event_handler=_quiet,
                   checkpoint_config=CheckpointConfig(d))
    assert ckpt.list_passes(d) == [0, 1, 2]
    for f in ("params.npz", "opt_state.npz", "frozen.npz", "manifest.json"):
        assert os.path.exists(os.path.join(d, "pass-00002", f)), f
    man = ckpt.verify_snapshot(ckpt.pass_dir(d, 2))
    assert man["pass_id"] == 2 and man["global_step"] == 18
    assert man["format"] == 2 and man["process_count"] == 1
    assert "rng" not in man and man["torch_rng"]["device"] == "cpu"
    ckpt.prune_old(d, 2)
    assert ckpt.list_passes(d) == [2]


@pytest.mark.parametrize("kw, want", [
    (dict(save_only_one=True), [2]),
    (dict(saving_period=2), [0, 2]),
], ids=["save_only_one", "saving_period"])
def test_save_only_one_and_saving_period(tmp_path, kw, want):
    d = str(tmp_path / "ck")
    _build().train(_reader(), num_passes=4 if "saving_period" in kw else 3,
                   event_handler=_quiet,
                   checkpoint_config=CheckpointConfig(d, **kw))
    assert ckpt.list_passes(d) == want


def test_resume_matches_uninterrupted(tmp_path):
    """2 passes with snapshots, then a fresh trainer resumes at pass 2:
    its parameters are bit for bit those of 4 passes straight through."""
    d = str(tmp_path / "ck")
    tr_a = _build()
    tr_a.train(_reader(), num_passes=4, event_handler=_quiet)
    _build().train(_reader(), num_passes=2, event_handler=_quiet,
                   checkpoint_config=CheckpointConfig(d))
    tr_c = _build()
    seen = []
    tr_c.train(_reader(), num_passes=4, event_handler=_passes(seen),
               checkpoint_config=CheckpointConfig(d))
    assert seen == [2, 3]
    for a, c in zip(_leaves(tr_a), _leaves(tr_c)):
        torch.testing.assert_close(c, a, rtol=0, atol=0)
    assert tr_c._global_step == 24


def test_load_specific_pass(tmp_path):
    d = str(tmp_path / "ck")
    _build().train(_reader(), num_passes=3, event_handler=_quiet,
                   checkpoint_config=CheckpointConfig(d))
    snap = ckpt.load(d, pass_id=1)
    assert snap["pass_id"] == 1 and snap["kind"] == "pass"
    assert int(snap["opt_state"]["t"]) == 12
    with pytest.raises(FileNotFoundError):
        ckpt.load(d, pass_id=9)
    with pytest.raises(FileNotFoundError):
        ckpt.load(str(tmp_path / "nope"))


def test_sharded_payload_is_read_and_its_write_refused(tmp_path):
    """Two simulated hosts of the JAX package each write their own shards
    of one payload; the port reassembles the global tree, and a missing
    host's file raises.  The port refuses to write sharded snapshots."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from paddle_tpu.io import checkpoint as jckpt

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8), ("dp",))
    big = np.arange(64, dtype=np.float32).reshape(8, 8)
    sharded = jax.device_put(big, NamedSharding(mesh, P("dp", None)))
    tree = {"layer": {"w": sharded, "b": np.ones(3, np.float32)}}
    base = str(tmp_path / "params.npz")

    def owned(lo, hi):
        return lambda s: lo <= list(mesh.devices).index(s.device) < hi

    jckpt._save_tree(base, tree, process_count=2, process_index=0,
                     shard_pred=owned(0, 4))
    jckpt._save_tree(base, tree, process_count=2, process_index=1,
                     shard_pred=owned(4, 8))
    got = ckpt._load_tree(base)
    np.testing.assert_array_equal(got["layer"]["w"], big)
    np.testing.assert_array_equal(got["layer"]["b"], np.ones(3))
    os.remove(base + ".shard1.npz")
    os.remove(base + ".shard1.meta.json")
    with pytest.raises(IOError, match="incomplete"):
        ckpt._load_tree(base)
    with pytest.raises(NotImplementedError, match="item 14"):
        ckpt.save(str(tmp_path / "multi"), 0, trainable={"w": big},
                  opt_state={}, model_state={}, process_count=2)


# ------------------------------------------------------- step snapshots
def test_step_snapshot_layout_and_prune(tmp_path):
    d = str(tmp_path / "ck")
    with pytest.raises(_Stop):
        _build().train(_reader(), num_passes=1, event_handler=_stop_after(4),
                       checkpoint_config=CheckpointConfig(
                           d, save_period_steps=2, async_save=False,
                           keep_step_snapshots=2))
    # 5 batches ran, period 2: snapshots at steps 2 and 4
    assert ckpt.list_steps(d) == [2, 4]
    man = ckpt.verify_snapshot(ckpt.step_dir(d, 4))
    assert man["mid_pass"] and man["global_step"] == 4
    assert man["batches_done"] == 4 and man["pass_id"] == 0
    assert set(man["files"]) == {"params.npz", "opt_state.npz",
                                 "frozen.npz"}
    # a finished pass supersedes the step snapshots
    _build().train(_reader(), num_passes=1, event_handler=_quiet,
                   checkpoint_config=CheckpointConfig(d, save_period_steps=2,
                                                      async_save=False))
    assert ckpt.list_steps(d) == []
    assert 0 in ckpt.list_passes(d)


def test_step_snapshots_keep_the_newest(tmp_path):
    d = str(tmp_path / "ck")
    tr = _build()
    with pytest.raises(_Stop):
        tr.train(_reader(), num_passes=1, event_handler=_stop_after(5),
                 checkpoint_config=CheckpointConfig(
                     d, save_period_steps=1, keep_step_snapshots=3))
    assert tr._ckpt_writer.flush() == []    # the writer outlives a crash
    assert ckpt.list_steps(d) == [3, 4, 5]
    assert tr._ckpt_writer.session["writes"] == 5


# --------------------------------------------------- quarantine, fallback
def test_corrupt_newest_quarantined_and_fallback(tmp_path):
    d = str(tmp_path / "ck")
    _build().train(_reader(), num_passes=2, event_handler=_quiet,
                   checkpoint_config=CheckpointConfig(d))
    _flip_byte(os.path.join(d, "pass-00001", "params.npz"))
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.load(d, pass_id=1)
    with pytest.warns(RuntimeWarning, match="quarantined"):
        snap = ckpt.load(d)
    assert snap["pass_id"] == 0 and snap["fallbacks"] == 1
    assert not os.path.exists(os.path.join(d, "pass-00001"))
    assert any(n.startswith("pass-00001.corrupt") for n in os.listdir(d))


def test_legacy_torn_npz_quarantined_and_fallback(tmp_path):
    """A format-1 snapshot (no checksums) with a truncated npz fails at
    read time; auto mode quarantines it and falls back."""
    d = str(tmp_path / "ck")
    t = {"w": np.arange(16, dtype=np.float32)}
    o = {"m": np.zeros(16, np.float32)}
    ckpt.save(d, 0, trainable=t, opt_state=o, model_state={})
    ckpt.save(d, 1, trainable=t, opt_state=o, model_state={})
    p1 = os.path.join(d, "pass-00001")
    with open(os.path.join(p1, "manifest.json")) as f:
        m = json.load(f)
    m.pop("files")
    m["format"] = 1
    with open(os.path.join(p1, "manifest.json"), "w") as f:
        json.dump(m, f)
    pz = os.path.join(p1, "params.npz")
    with open(pz, "r+b") as f:
        f.truncate(os.path.getsize(pz) // 2)
    with pytest.warns(RuntimeWarning):
        snap = ckpt.load(d)
    assert snap["pass_id"] == 0 and snap["fallbacks"] == 1
    np.testing.assert_array_equal(snap["trainable"]["w"], t["w"])
    assert any(n.startswith("pass-00001.corrupt") for n in os.listdir(d))


def test_quarantine_tolerates_concurrently_removed_dir(tmp_path):
    gone = str(tmp_path / "step-000000007")
    assert ckpt.quarantine(gone) == gone
    assert not os.path.exists(gone + ".corrupt")


def test_load_skips_concurrently_pruned_snapshot(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    t = {"w": np.arange(8, dtype=np.float32)}
    for g in (5, 9):
        ckpt.save_step(d, g, pass_id=0, batches_done=g, trainable=t,
                       opt_state={"m": t["w"]}, model_state={})
    real = ckpt.verify_snapshot

    def racing(p):
        if p.endswith("step-000000009"):
            shutil.rmtree(p)               # the prune wins the race
            raise ckpt.CheckpointCorrupt(f"{p}: unreadable manifest")
        return real(p)

    monkeypatch.setattr(ckpt, "verify_snapshot", racing)
    snap = ckpt.load(d)
    assert snap["manifest"]["global_step"] == 5 and snap["fallbacks"] == 0
    assert not any(".corrupt" in n for n in os.listdir(d))


def test_trainer_auto_resume_falls_back(tmp_path):
    d = str(tmp_path / "ck")
    _build().train(_reader(), num_passes=2, event_handler=_quiet,
                   checkpoint_config=CheckpointConfig(d))
    _flip_byte(os.path.join(d, "pass-00001", "params.npz"))
    seen = []
    with pytest.warns(RuntimeWarning, match="fell back past 1 corrupt"):
        tr = _build()
        tr.train(_reader(), num_passes=3, event_handler=_passes(seen),
                 checkpoint_config=CheckpointConfig(d))
    assert seen[0] == 1           # resumed after pass 0, no crash loop
    assert [n for n in os.listdir(d) if ".corrupt" in n] == [
        "pass-00001.corrupt"]
    assert ckpt.list_passes(d) == [0, 1, 2]


def test_trainer_fresh_start_when_all_snapshots_corrupt(tmp_path):
    d = str(tmp_path / "ck")
    _build().train(_reader(), num_passes=1, event_handler=_quiet,
                   checkpoint_config=CheckpointConfig(d))
    _flip_byte(os.path.join(d, "pass-00000", "params.npz"))
    seen = []
    with pytest.warns(RuntimeWarning, match="no valid checkpoint"):
        _build().train(_reader(), num_passes=1, event_handler=_passes(seen),
                       checkpoint_config=CheckpointConfig(d))
    assert seen == [0]


# ------------------------------------------------------------ the writer
def test_async_save_error_surfaced_exactly_once(tmp_path):
    blocker = str(tmp_path / "not_a_dir")    # dirname is a file: the tmp
    with open(blocker, "w") as f:            # dir cannot be made
        f.write("x")
    w = ckpt.AsyncCheckpointWriter()
    w.submit(lambda: ckpt.save_step(
        blocker, 0, pass_id=0, batches_done=0,
        trainable={"w": np.zeros(4, np.float32)}, opt_state={},
        model_state={}))
    errs = w.flush()
    assert len(errs) == 1 and isinstance(errs[0], OSError)
    assert w.flush() == [] and w.take_errors() == []
    assert w.session["errors"] == 1 and w.session["writes"] == 0


def test_async_writer_surfaces_errors_on_next_save():
    w = ckpt.AsyncCheckpointWriter()

    def bad():
        raise RuntimeError("disk full")

    assert w.submit(bad) == []
    w._q.join()
    with pytest.warns(RuntimeWarning, match="disk full"):
        errs = w.submit(lambda: None)
    assert len(errs) == 1 and isinstance(errs[0], RuntimeError)
    assert w.flush() == []
    assert w.session["errors"] == 1 and w.session["writes"] == 1


def test_sigkill_mid_save_never_half_finalized(tmp_path):
    """SIGKILL a child that saves step snapshots in a tight loop: at
    whatever instant the kill lands, every dir visible to ``list_steps``
    verifies."""
    import random
    import signal
    import subprocess
    import sys
    import time

    d = str(tmp_path / "ck")
    script = (
        "import sys\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import numpy as np\n"
        "from paddle_tpu_torch.io import checkpoint as ckpt\n"
        "d = sys.argv[2]\n"
        "t = {'w': np.arange(120000, dtype=np.float32)}\n"
        "o = {'m': np.zeros(120000, np.float32)}\n"
        "g = 0\n"
        "while True:\n"
        "    ckpt.save_step(d, g, pass_id=0, batches_done=g,\n"
        "                   trainable=t, opt_state=o, model_state={})\n"
        "    ckpt.prune_steps(d, keep=3)\n"
        "    if g == 0:\n"
        "        print('saved', flush=True)\n"
        "    g += 1\n")
    rng = random.Random(0)
    for _ in range(2):
        proc = subprocess.Popen(
            [sys.executable, "-c", script, REPO, d], stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, env=dict(os.environ, PYTHONPATH=""))
        try:
            assert proc.stdout.readline().strip() == b"saved"
            time.sleep(rng.uniform(0.02, 0.3))
        finally:
            proc.send_signal(signal.SIGKILL)
            proc.wait()
        for g in ckpt.list_steps(d):
            ckpt.verify_snapshot(ckpt.step_dir(d, g))
    assert ckpt.list_steps(d)
    assert ckpt.load(d)["kind"] == "step"


def test_save_parameter_to_tar_path_is_atomic_and_loadable(tmp_path):
    p = str(tmp_path / "params.tar")
    tr = _build()
    tr.save_parameter_to_tar(p)
    params2 = paddle.parameters.create(tr.topology)
    with open(p, "rb") as f:
        params2.from_tar(f)
    for key in tr.parameters.keys():
        np.testing.assert_array_equal(tr.parameters[key], params2[key])
    assert not [n for n in os.listdir(str(tmp_path))
                if n.startswith(".params.tar.tmp-")]


def test_republish_same_name_keeps_old_until_swap(tmp_path):
    d = str(tmp_path / "ck")
    t1 = {"w": np.arange(8, dtype=np.float32)}
    t2 = {"w": np.arange(8, dtype=np.float32) * 2}
    ckpt.save(d, 0, trainable=t1, opt_state={}, model_state={})
    swaps = []
    real = ckpt.os.replace

    def spy(src, dst):
        swaps.append((os.path.basename(src), os.path.basename(dst),
                      sorted(os.listdir(d))))
        return real(src, dst)

    ckpt.os.replace = spy
    try:
        ckpt.save(d, 0, trainable=t2, opt_state={}, model_state={})
    finally:
        ckpt.os.replace = real
    # the old snapshot moves aside before the new one is swapped in
    moved = [s for s in swaps if s[1] == "pass-00000.old"]
    assert moved and "pass-00000" in moved[0][2]
    published = [s for s in swaps if s[0] == "pass-00000.tmp"]
    assert published and "pass-00000.old" in published[0][2]
    snap = ckpt.load(d, pass_id=0)
    np.testing.assert_array_equal(snap["trainable"]["w"], t2["w"])
    assert not os.path.exists(os.path.join(d, "pass-00000.old"))


def test_atomic_write_file_modes_and_failure(tmp_path):
    from paddle_tpu_torch.io import atomic

    p = str(tmp_path / "artifact.npz")
    atomic.atomic_write_file(p, lambda f: f.write(b"v1"))
    assert (os.stat(p).st_mode & 0o777) == (0o666 & ~atomic._UMASK)
    os.chmod(p, 0o640)
    atomic.atomic_write_file(p, lambda f: f.write(b"v2"))
    assert (os.stat(p).st_mode & 0o777) == 0o640

    def torn(f):
        f.write(b"half")
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError):
        atomic.atomic_write_file(p, torn)
    with open(p, "rb") as f:
        assert f.read() == b"v2"
    assert os.listdir(str(tmp_path)) == ["artifact.npz"]
    assert atomic.sha256_file(p) == __import__("hashlib").sha256(
        b"v2").hexdigest()


# --------------------------------------------------- dedup, scrub, audit
def test_step_snapshot_frozen_dedup_and_gc(tmp_path):
    d = str(tmp_path / "ck")
    w = np.arange(8, dtype=np.float32)
    frozen = {"emb": np.arange(64, dtype=np.float32).reshape(8, 8)}
    for g in (2, 4, 6):
        ckpt.save_step(d, g, pass_id=0, batches_done=g,
                       trainable={"w": w + g}, opt_state={"m": w},
                       model_state={}, frozen=frozen)
    paths = [os.path.join(ckpt.step_dir(d, g), "frozen.npz")
             for g in (2, 4, 6)]
    assert len({os.stat(p).st_ino for p in paths}) == 1
    store = os.path.join(d, ckpt.OBJECTS_DIR)
    (obj_name,) = os.listdir(store)
    obj = os.path.join(store, obj_name)
    assert os.stat(obj).st_nlink == 4          # the store + 3 snapshots
    for g in (2, 4, 6):
        man = ckpt.verify_snapshot(ckpt.step_dir(d, g))
        assert (man["files"]["frozen.npz"]["ref"]
                == f"{ckpt.OBJECTS_DIR}/{obj_name}")
        assert "ref" not in man["files"]["params.npz"]
    snap = ckpt.load(d)
    np.testing.assert_array_equal(snap["frozen"]["emb"], frozen["emb"])
    ckpt.prune_steps(d, keep=1)
    assert os.stat(obj).st_nlink == 2
    assert ckpt.verify_snapshot(ckpt.step_dir(d, 6))
    ckpt.prune_steps(d, keep=0)
    assert os.listdir(store) == []


def _two_step_snapshots(tmp_path, name="scrub"):
    d = str(tmp_path / name)
    tree = {"w": np.arange(8, dtype=np.float32)}
    for g in (2, 4):
        ckpt.save_step(d, g, pass_id=0, batches_done=g, trainable=tree,
                       opt_state={"m": np.ones(8, np.float32)},
                       model_state=None)
    assert ckpt.list_steps(d) == [2, 4]
    return d


def test_reverify_steps_quarantines_silent_corruption(tmp_path):
    d = _two_step_snapshots(tmp_path)
    assert ckpt.reverify_steps(d) == {"ok": [2, 4], "corrupt": []}
    _flip_byte(os.path.join(ckpt.step_dir(d, 4), "params.npz"))
    with pytest.warns(RuntimeWarning, match="quarantined"):
        res = ckpt.reverify_steps(d)
    assert res == {"ok": [2], "corrupt": [4]}
    assert ckpt.list_steps(d) == [2]
    assert any(n.startswith("step-000000004.corrupt")
               for n in os.listdir(d))
    _flip_byte(os.path.join(ckpt.step_dir(d, 2), "params.npz"))
    res = ckpt.reverify_steps(d, quarantine_corrupt=False)
    assert res == {"ok": [], "corrupt": [2]}
    assert ckpt.list_steps(d) == [2]


def test_async_writer_idle_loop_scrubs_between_saves(tmp_path):
    import time

    d = _two_step_snapshots(tmp_path, name="scrub_async")
    w = ckpt.AsyncCheckpointWriter(reverify_period_s=0.15, reverify_dir=d)
    w.submit(lambda: None)
    w.flush()
    deadline = time.time() + 10
    while w.session["scrubs"] == 0 and time.time() < deadline:
        time.sleep(0.05)
    assert w.session["scrubs"] >= 1 and w.session["reverified_ok"] >= 2
    assert w.session["reverified_corrupt"] == 0
    _flip_byte(os.path.join(ckpt.step_dir(d, 2), "opt_state.npz"))
    with pytest.warns(RuntimeWarning, match="quarantined"):
        deadline = time.time() + 10
        while (w.session["reverified_corrupt"] == 0
               and time.time() < deadline):
            time.sleep(0.05)
    assert w.session["reverified_corrupt"] >= 1
    assert ckpt.list_steps(d) == [4]


def test_checkpoint_config_validation():
    for kw in (dict(reverify_period_s=0), dict(reverify_period_s=-1),
               dict(save_period_steps=0)):
        with pytest.raises(ValueError):
            CheckpointConfig("d", **kw)
    assert CheckpointConfig("d", reverify_period_s=30.0).reverify_period_s \
        == 30.0
    cfg = CheckpointConfig("d", keep_step_snapshots=0)
    assert cfg.reverify_period_s is None and cfg.keep_step_snapshots == 1


def test_checkpoint_cli_verify_and_latest(tmp_path, capsys):
    """``checkpoint verify DIR``: a read-only audit, exit 1 on
    corruption; ``checkpoint latest DIR``: the newest that verifies,
    skipped read-only past a corrupt one."""
    from paddle_tpu_torch import cli

    d = _two_step_snapshots(tmp_path, name="scrub_cli")
    cli.main(["checkpoint", "verify", d])
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] == 2 and rep["corrupt"] == 0
    assert rep["snapshots"]["step-000000002"]["status"] == "ok"
    cli.main(["checkpoint", "latest", d])
    latest = json.loads(capsys.readouterr().out)
    assert latest["global_step"] == 4 and latest["skipped_corrupt"] == 0
    _flip_byte(os.path.join(ckpt.step_dir(d, 4), "params.npz"))
    with pytest.raises(SystemExit) as ei:
        cli.main(["checkpoint", "verify", d])
    assert ei.value.code == 1
    rep = json.loads(capsys.readouterr().out)
    assert rep["corrupt"] == 1
    assert rep["snapshots"]["step-000000004"]["status"] == "corrupt"
    cli.main(["checkpoint", "latest", d])
    latest = json.loads(capsys.readouterr().out)
    assert latest["global_step"] == 2 and latest["skipped_corrupt"] == 1
    assert latest["model_version"].startswith("2-")
    assert ckpt.list_steps(d) == [2, 4]        # nothing quarantined
    with pytest.raises(SystemExit):
        cli.main(["checkpoint", "verify", str(tmp_path / "missing")])


def test_prune_unlists_atomically_before_deleting(tmp_path, monkeypatch):
    d = _two_step_snapshots(tmp_path, name="scrub_prune")
    # a crash inside the deletion: rmtree does nothing
    monkeypatch.setattr(ckpt.shutil, "rmtree", lambda *a, **k: None)
    ckpt.prune_steps(d, keep=1)
    assert ckpt.list_steps(d) == [4]
    assert [n for n in os.listdir(d) if n.endswith(".pruned")] == [
        "step-000000002.pruned"]
    ckpt.verify_snapshot(ckpt.step_dir(d, 4))
    loaded = ckpt.load(d)
    assert loaded["kind"] == "step"
    assert loaded["manifest"]["global_step"] == 4
    monkeypatch.undo()
    ckpt.prune_steps(d, keep=1)
    assert not [n for n in os.listdir(d) if n.endswith(".pruned")]
    assert ckpt.list_steps(d) == [4]


def test_snapshot_version_and_peek(tmp_path):
    d = _two_step_snapshots(tmp_path, name="versions")
    man = ckpt.verify_snapshot(ckpt.step_dir(d, 4))
    assert ckpt.peek_version(d) == ckpt.snapshot_version(man)
    assert ckpt.snapshot_version(man).startswith("4-")
    assert ckpt.peek_version(str(tmp_path / "none")) is None
    snap = ckpt.load_snapshot(ckpt.step_dir(d, 2))
    np.testing.assert_array_equal(snap["opt_state"]["m"], np.ones(8))


CLI_CONFIG = '''
import numpy as np
import paddle_tpu_torch as paddle
from paddle_tpu_torch import layer

paddle.init(seed=0)
x = layer.data("x", paddle.data_type.dense_vector(8))
y = layer.data("y", paddle.data_type.integer_value(4))
cost = layer.classification_cost(layer.fc(x, size=4), y)
optimizer = paddle.optimizer.Momentum(learning_rate=0.05, momentum=0.9)
feeding = {"x": 0, "y": 1}


def _samples():
    rng = np.random.RandomState(0)
    for _ in range(12):
        yield rng.randn(8).astype(np.float32), int(rng.randint(4))


train_reader = paddle.batch(_samples, 4)
test_reader = paddle.batch(_samples, 6)
'''


def test_cli_save_dir_resume_and_job_test(tmp_path, capsys, monkeypatch):
    """``train --save_dir`` writes step and pass snapshots and a second
    run resumes after the last pass; ``--job=test`` evaluates the
    snapshot."""
    from paddle_tpu_torch import cli
    from paddle_tpu_torch.core import config

    monkeypatch.setitem(config._options, "device", None)
    path = tmp_path / "cfg.py"
    path.write_text(CLI_CONFIG)
    d = str(tmp_path / "ck")
    base = ["train", "--config", str(path), "--device", "cpu",
            "--log_period", "1", "--save_dir", d]
    reset_name_counters()
    cli.main(base + ["--num_passes", "1", "--save_period_steps", "2",
                     "--sync_save"])
    assert ckpt.list_passes(d) == [0] and ckpt.list_steps(d) == []
    capsys.readouterr()
    reset_name_counters()
    cli.main(base + ["--num_passes", "2", "--save_only_one"])
    out = capsys.readouterr().out
    assert "Pass 0," not in out and "Pass 1, Batch 0" in out
    assert ckpt.list_passes(d) == [1]
    assert ckpt.load(d)["manifest"]["global_step"] == 6
    reset_name_counters()
    cli.main(["train", "--config", str(path), "--device", "cpu",
              "--job", "test", "--save_dir", d])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(rec["cost"])
