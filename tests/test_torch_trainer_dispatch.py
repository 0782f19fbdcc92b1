"""``train(steps_per_dispatch=k)``, ``timed_multi_dispatch`` and the CLI's
dispatch flags in the PyTorch port against its own per-step loop and the
JAX package, on the CPU (where a chunk runs its k steps eagerly; on the
card it is one CUDA graph, held by ``chip_smoke.py``).

The LM is small (vocab 50, dim 32, 2 heads of 16, 2 layers, T 12) and the
seven feeds come from numpy seeds, the fourth with two rows instead of
three (a ragged group), the seventh a short tail.  Tolerances: the
chunked port against its per-step run bit for bit; against the JAX
package's chunked run, the losses within 1e-5 relative and the
parameters within 1e-5, as ``tests/test_torch_training.py`` holds a
trajectory.
"""

import io
import json

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.core.ir import reset_name_counters as reset_jax_names
from paddle_tpu.models import transformer as jt
from paddle_tpu_torch.core import config as tconfig
from paddle_tpu_torch.core.ir import reset_name_counters as reset_port_names
from paddle_tpu_torch.models import transformer as tt

SMALL = dict(vocab_size=50, max_len=12, dim=32, num_heads=2, num_layers=2)


def _lm_both():
    reset_jax_names()
    reset_port_names()
    pj.init(seed=0)
    pt.init(seed=0, device="cpu")
    ct, lt = tt.build(**SMALL)
    cj, lj = jt.build(**SMALL)
    return (pt.Topology(ct, extra_inputs=[lt]),
            pj.Topology(cj, extra_inputs=[lj], collect_evaluators=False))


def _cross(jparams, ttopo):
    buf = io.BytesIO()
    jparams.to_tar(buf)
    buf.seek(0)
    tparams = pt.parameters.create(ttopo, device="cpu")
    tparams.from_tar(buf)
    return tparams


def _feeds(n=7):
    out = []
    for i in range(n):
        rows = 2 if i == 3 else 3
        rng = np.random.RandomState(i)
        out.append({"tokens": rng.randint(0, 50, (rows, 12)).astype(np.int32),
                    "targets": rng.randint(0, 50, (rows, 12)).astype(np.int32),
                    "tokens@len": rng.randint(1, 13, rows).astype(np.int32)})
    return out


def _log(log):
    def handler(e):
        rec = [type(e).__name__, getattr(e, "pass_id", None),
               getattr(e, "batch_id", None)]
        if type(e).__name__ == "EndIteration":
            rec.append(e.cost)
        log.append(rec)
    return handler


def _port_run(jparams, ttopo, passes=1, **kw):
    tr = pt.trainer.SGD(ttopo, _cross(jparams, ttopo),
                        pt.optimizer.Adam(learning_rate=1e-2))
    log = []
    tr.train(lambda: iter(_feeds()), num_passes=passes,
             event_handler=_log(log), **kw)
    return tr, log


def _state(tr):
    return [t.clone() for t in tr._state_tensors()]


@pytest.mark.parametrize("k", [2, 3])
def test_chunks_equal_per_step_and_match_jax(k):
    """k = 2: two chunks, a ragged pair and a tail; k = 3: one chunk, a
    ragged group and a tail.  The losses, the events and every state
    tensor equal the per-step run bit for bit; the losses, the event
    order and the parameters match the JAX package's chunked run."""
    ttopo, jtopo = _lm_both()
    jparams = pj.parameters.create(jtopo)
    plain, plain_log = _port_run(jparams, ttopo, passes=2)
    chunked, log = _port_run(jparams, ttopo, passes=2, steps_per_dispatch=k)
    assert log == plain_log
    for a, b in zip(_state(plain), _state(chunked)):
        assert torch.equal(a, b)
    assert chunked.step_capture_count == 1      # one feed signature
    assert plain.step_capture_count == 0        # k = 1 stays eager
    jlog = []
    jtr = pj.trainer.SGD(jtopo, jparams, pj.optimizer.Adam(
        learning_rate=1e-2))
    jtr.train(lambda: iter(_feeds()), num_passes=2, event_handler=_log(jlog),
              steps_per_dispatch=k)
    assert [r[:3] for r in log] == [r[:3] for r in jlog]
    np.testing.assert_allclose([r[3] for r in log if len(r) == 4],
                               [r[3] for r in jlog if len(r) == 4],
                               rtol=1e-5, atol=0)
    for key in chunked.parameters.keys():
        np.testing.assert_allclose(chunked.parameters[key], jparams[key],
                                   atol=1e-5, err_msg=key)


def test_chunk_events_fire_after_the_chunk():
    """The chunk's per-batch events fire after its k steps ran, in the
    JAX order: every BeginIteration of a chunk sees the chunk's last
    update already in the parameters."""
    ttopo, jtopo = _lm_both()
    jparams = pj.parameters.create(jtopo)
    tr = pt.trainer.SGD(ttopo, _cross(jparams, ttopo),
                        pt.optimizer.Adam(learning_rate=1e-2))
    seen = []

    def handler(e):
        if isinstance(e, pt.event.BeginIteration):
            seen.append((e.batch_id, int(tr._opt_state["t"])))

    tr.train(lambda: iter(_feeds(4)), event_handler=handler,
             steps_per_dispatch=2)
    # batches 0 and 1 ran as one chunk (t 2 at both events); 2 and 3 are
    # ragged (3 rows, then 2) and run per step
    assert seen == [(0, 2), (1, 2), (2, 2), (3, 3)]


def test_check_nan_inf_stands_the_chunk_down():
    ttopo, jtopo = _lm_both()
    jparams = pj.parameters.create(jtopo)
    tr = pt.trainer.SGD(ttopo, _cross(jparams, ttopo),
                        pt.optimizer.Adam(learning_rate=1e-2),
                        check_nan_inf=True)
    log = []
    tr.train(lambda: iter(_feeds()), event_handler=_log(log),
             steps_per_dispatch=2)
    assert tr.step_capture_count == 0
    plain, plain_log = _port_run(jparams, ttopo)
    assert log == plain_log


def test_steps_per_dispatch_below_one_raises():
    ttopo, _ = _lm_both()
    tr = pt.trainer.SGD(ttopo, pt.parameters.create(ttopo, device="cpu"),
                        pt.optimizer.Adam())
    for k in (0, -2):
        with pytest.raises(ValueError, match="steps_per_dispatch"):
            tr.train(lambda: iter(_feeds(1)), steps_per_dispatch=k,
                     event_handler=lambda e: None)


def test_timed_multi_dispatch_leaves_the_state_alone():
    ttopo, jtopo = _lm_both()
    jparams = pj.parameters.create(jtopo)
    tr, _ = _port_run(jparams, ttopo)
    before = _state(tr)
    values = tr.parameters.values
    dt, n = tr.timed_multi_dispatch(_feeds(1)[0], 3, iters=2, warmup=1)
    assert n == 6 and dt > 0
    for a, b in zip(before, tr._state_tensors()):
        assert torch.equal(a, b)
    assert tr.parameters.values is values
    assert tr.step_capture_count == 0           # not one of the chunks
    # and the multi-step function is k steps of the trainer
    multi = tr.build_multi_step(2)
    feed = _feeds(1)[0]
    stacked = {k: torch.from_numpy(np.stack([v, v])) for k, v in
               feed.items()}
    with tr.on_copies():
        losses = multi(stacked)
    with tr.on_copies():
        ref = [float(tr._step(feed)) for _ in range(2)]
    assert losses.tolist() == ref


# ---------------------------------------------------------------------- CLI
CLI_CONFIG = '''
import numpy as np
import paddle_tpu_torch as paddle
from paddle_tpu_torch.models import transformer

paddle.init(seed=0)
cost, _ = transformer.build(vocab_size=20, max_len=8, dim=16, num_heads=2,
                            num_layers=1)
optimizer = paddle.optimizer.Adam(learning_rate=1e-2)
feeding = {"tokens": 0, "targets": 1}


def _samples():
    rng = np.random.RandomState(0)
    for n in (8, 3, 5, 2, 7, 4):
        toks = rng.randint(0, 20, n).tolist()
        yield toks, toks


train_reader = paddle.batch(_samples, 2)
'''


@pytest.fixture
def cli_cfg(tmp_path, monkeypatch):
    monkeypatch.setitem(tconfig._options, "device", None)
    monkeypatch.setitem(tconfig._options, "log_period", 100)
    path = tmp_path / "lm_cfg.py"
    path.write_text(CLI_CONFIG)
    reset_port_names()
    return str(path)


def _costs(out):
    return [float(l.rsplit(" ", 1)[1]) for l in out.splitlines()
            if l.startswith("Pass 0, Batch")]


@pytest.mark.parametrize("flags", [
    ["--steps_per_dispatch", "2", "--seq_buckets", "auto",
     "--prefetch_depth", "2"],
    ["--steps_per_dispatch", "3", "--seq_buckets", "8,16"],
    ["--check_nan_inf", "--steps_per_dispatch", "2"],
], ids=["chunk_buckets_prefetch", "chunk_list", "nan_check"])
def test_cli_train_with_dispatch_flags(cli_cfg, capsys, flags):
    """The dispatch flags train the config on the CPU to the per-step
    run's costs, bit for bit (a single declared length, 8, makes every
    bucket the plain padding)."""
    from paddle_tpu_torch import cli

    base = ["train", "--config", cli_cfg, "--log_period", "1",
            "--device", "cpu"]
    cli.main(base)
    plain = _costs(capsys.readouterr().out)
    reset_port_names()
    cli.main(base + flags)
    got = _costs(capsys.readouterr().out)
    assert len(plain) == 3 and got == plain


@pytest.mark.parametrize("k", [1, 2])
def test_cli_job_time_prints_the_jax_keys(cli_cfg, capsys, k):
    from paddle_tpu_torch import cli

    cli.main(["train", "--job=time", "--config", cli_cfg, "--device", "cpu",
              "--batch_size", "2", "--iters", "2", "--steps_per_dispatch",
              str(k)])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys = {"ms_per_batch", "samples_per_sec", "steps_per_dispatch",
            "batch_size", "iters"}
    if k > 1:
        keys |= {"ms_per_batch_single_dispatch", "dispatch_amortization"}
    assert set(rec) == keys
    assert rec["steps_per_dispatch"] == k and rec["batch_size"] == 2
    assert rec["ms_per_batch"] > 0 and rec["samples_per_sec"] > 0


@pytest.mark.parametrize("job", ["test", "checkgrad", "gen", "bogus"])
def test_cli_other_jobs_raise(cli_cfg, job, capsys):
    """The JAX command's jobs this port lacks raise; ``test`` is ported
    and prints the config's cost as one JSON line; ``gen`` is ported and,
    as the JAX command does, exits on a config without a ``generator``
    (tests/test_torch_generation.py generates through it)."""
    from paddle_tpu_torch import cli

    argv = ["train", f"--job={job}", "--config", cli_cfg, "--device", "cpu"]
    if job == "test":
        cli.main(argv)
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert np.isfinite(rec["cost"]) and rec["metrics"] == {}
        return
    if job == "gen":
        with pytest.raises(SystemExit, match="`generator`"):
            cli.main(argv)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cli.main(argv)


# ------------------------------------------------------- launch counters
def test_launch_counts_count_executions_not_captures(monkeypatch):
    """A launch under a CUDA graph capture runs nothing: it goes to the
    capture's record and not to the counts, and each replay adds the
    record (``ops.add_launches``).  Eager launches count as before, by
    dtype too."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops.fused_rnn import lstm_step_cuda
    from paddle_tpu_torch.ops.paged_attention import paged_decode_cuda

    ops.reset_launch_counts()
    ops.count_launch(lstm_step_cuda, torch.bfloat16)
    monkeypatch.setattr(ops, "capturing", lambda: True)
    with ops.recording_launches() as rec:
        for _ in range(3):
            ops.count_launch(lstm_step_cuda, torch.float32)
        ops.count_launch(paged_decode_cuda)
    ops.count_launch(lstm_step_cuda, torch.float32)   # no record: dropped
    monkeypatch.undo()
    counts = ops.launch_counts()
    assert (counts["lstm_step"], counts["lstm_step_bf16"],
            counts["paged_decode"]) == (1, 1, 0)
    for _ in range(2):                                 # two replays
        ops.add_launches(rec)
    counts = ops.launch_counts()
    assert (counts["lstm_step"], counts["lstm_step_bf16"],
            counts["lstm_step_f16"], counts["paged_decode"]) == (7, 1, 0, 2)
    ops.reset_launch_counts()
    assert not any(ops.launch_counts().values())


def test_arrival_counters_do_not_grow_under_capture(monkeypatch):
    """A capture must find its stream's arrival counters sized by its
    warm-up: growing them would free a buffer the graph bakes in."""
    from paddle_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cpu")
    monkeypatch.setattr(pa, "_ARRIVED", {})
    buf = pa._arrived(dev, 7, 300)
    assert buf.numel() == 300 and pa._arrived(dev, 7, 12) is buf
    monkeypatch.setattr(pa.ops, "capturing", lambda: True)
    assert pa._arrived(dev, 7, 300) is buf
    with pytest.raises(RuntimeError, match="warmed up"):
        pa._arrived(dev, 7, 301)
    with pytest.raises(RuntimeError, match="warmed up"):
        pa._arrived(dev, 8, 1)


def test_a_new_precision_policy_drops_the_chunks(monkeypatch):
    """The chunks are prepared under one policy: naming another drops
    them, and the next chunk is prepared (counted) again under it."""
    monkeypatch.setitem(tconfig._options, "precision", None)
    ttopo, jtopo = _lm_both()
    jparams = pj.parameters.create(jtopo)
    tr, _ = _port_run(jparams, ttopo, steps_per_dispatch=2)
    assert tr.step_capture_count == 1 and len(tr._chunks.entries) == 1
    tr.train(lambda: iter(_feeds(2)), steps_per_dispatch=2,
             event_handler=lambda e: None)
    assert tr.step_capture_count == 1
    pt.init(seed=0, device="cpu", precision="bf16")
    try:
        tr.train(lambda: iter(_feeds(2)), steps_per_dispatch=2,
                 event_handler=lambda e: None)
        assert tr.step_capture_count == 2 and len(tr._chunks.entries) == 1
    finally:
        pt.init(seed=0, device="cpu", precision="fp32")
