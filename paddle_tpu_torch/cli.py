"""Command line: ``python -m paddle_tpu_torch {train,serve,checkpoint} ...``.

``train --config CFG --num_passes N [--device cpu]`` is the counterpart of
``python -m paddle_tpu train`` (``cmd_train``): the config defines
``cost``, ``train_reader`` and optionally ``optimizer`` (default Momentum,
lr 0.01, momentum 0.9) and ``feeding``, and is trained through
``trainer.SGD``; ``--precision`` names the precision policy, which wins
over the config's own ``init``.  ``--steps_per_dispatch K``,
``--seq_buckets auto|L1,L2,..``, ``--prefetch_depth N`` and
``--check_nan_inf`` are the trainer's dispatch options.  ``--save_dir
DIR`` checkpoints into DIR and resumes from it (``--saving_period``,
``--save_only_one``, ``--save_period_steps N`` for mid-pass step
snapshots, ``--reverify_period_s``, ``--sync_save``).  ``--job=test``
evaluates the config's ``test_reader`` (else ``train_reader``) on the
snapshot under ``--save_dir`` and prints one JSON line.  ``--job=time``
(``cmd_time``, TrainerBenchmark) times the step on a synthetic batch of
``--batch_size`` for ``--iters`` iterations, and with K > 1 the K-step
chunk beside it, and prints one JSON line.  The JAX command's telemetry
and compile-cache flags and its other jobs are not ported yet and raise.

``checkpoint verify DIR`` audits every snapshot under DIR read-only
(a JSON report; exit 1 on corruption); ``checkpoint latest DIR`` prints
the newest snapshot that verifies as one JSON line, quarantining nothing.

``serve --decode`` serves a transformer LM checkpoint as ``python -m
paddle_tpu serve --decode`` does: through the slab ``SlotDecoder``, or the
paged decoder with ``--paged_kv`` (``--sampling`` for seeded sampling),
under ``--decode_policy``, with the engine's admission, tenant and breaker
flags (``--max_queue_depth``, ``--tenant_weights a=3,b=1``,
``--max_queue_depth_per_tenant``, ``--breaker_*``, ``--default_deadline_us``,
``--drain_timeout_s``) at the JAX defaults.  The JAX command builds the
model from a DSL config (``--model cfg.py``); here the dims come from the
parameter shapes and the caller names ``--num_heads``.  The snapshot is the
newest under ``--params`` that verifies (``load``, which quarantines a
corrupt newer one, as the JAX server does).
"""

from __future__ import annotations

import argparse
import json
import os
import runpy
import sys
import threading
import time

# flags of the JAX ``train`` verb this port does not have yet
_UNPORTED_TRAIN_FLAGS = ("telemetry_dir", "metrics_port",
                         "compile_cache_dir")
# the JAX ``train`` verb's jobs this port runs
_JOBS = ("train", "test", "time")


def _serve_ready_line(role, host, port, **extra):
    """ONE machine-readable ready line on stdout: with ``--port 0`` it is
    the only reliable way to learn the bound port."""
    url_host = "127.0.0.1" if host in ("0.0.0.0", "::", "") else host
    rec = {"role": role, "url": f"http://{url_host}:{port}", "port": port,
           "host": host, "pid": os.getpid(), **extra}
    print(json.dumps({"ptpu_serve": rec}), flush=True)
    return rec


def _tenant_weights(spec):
    """``--tenant_weights 'a=3,b=1'`` -> ``{"a": 3.0, "b": 1.0}``."""
    if not spec:
        return None
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise SystemExit(f"--tenant_weights wants tenant=weight pairs, "
                             f"got {part!r}")
        name, _, w = part.partition("=")
        try:
            out[name.strip()] = float(w)
        except ValueError:
            raise SystemExit(f"--tenant_weights: weight for {name!r} is not "
                             f"a number: {w!r}")
    return out


def cmd_serve(args) -> None:
    from paddle_tpu_torch.io import checkpoint
    from paddle_tpu_torch.models.transformer import (PagedDecoder,
                                                     SlotDecoder,
                                                     params_from_jax)
    from paddle_tpu_torch.serving import InferenceEngine

    if not args.decode:
        raise NotImplementedError(
            "serve without --decode (the whole-forward micro-batching "
            "mode) is not ported to paddle_tpu_torch yet: ROADMAP.md §1 "
            "item 8")
    if args.sampling and not args.paged_kv:
        raise SystemExit("--sampling needs the paged decoder: add "
                         "--paged_kv")
    tenant_weights = _tenant_weights(args.tenant_weights)
    snap = checkpoint.load(args.params)
    model = params_from_jax(checkpoint.params_of(snap),
                            num_heads=args.num_heads)
    if args.paged_kv:
        decoder = PagedDecoder(model, max_slots=args.max_slots,
                               block_size=args.kv_block_size,
                               num_blocks=args.kv_blocks,
                               sampling=args.sampling,
                               decode_kernel=args.decode_kernel,
                               device=args.device)
    else:
        decoder = SlotDecoder(model, max_slots=args.max_slots,
                              decode_kernel=args.decode_kernel,
                              device=args.device)
    engine = InferenceEngine(
        decoder, decode_policy=args.decode_policy, eos_id=args.eos_id,
        default_max_tokens=args.default_max_tokens,
        max_queue_depth=args.max_queue_depth,
        default_deadline_us=args.default_deadline_us or None,
        tenant_weights=tenant_weights,
        max_queue_depth_per_tenant=args.max_queue_depth_per_tenant,
        breaker_window=args.breaker_window,
        breaker_threshold=args.breaker_threshold,
        breaker_min_requests=args.breaker_min_requests,
        breaker_cooldown_s=args.breaker_cooldown_s)
    server = engine.serve(args.port, host=args.host)
    port = server.server_address[1]
    _serve_ready_line("engine", args.host, port, snapshot=snap["dir"],
                      model_version=checkpoint.snapshot_version(
                          snap["manifest"]),
                      device=str(decoder.device),
                      decode_kernel=decoder.decode_kernel,
                      paged=bool(args.paged_kv),
                      sampling=bool(args.sampling))
    kv = (f"kv_block_size={decoder.block_size} "
          f"kv_blocks={decoder.num_blocks} " if args.paged_kv else "")
    print(f"serving on http://{args.host}:{port}  (POST /infer, GET "
          f"/stats /healthz /kernels)  max_slots={decoder.max_slots} {kv}"
          f"decode_policy={args.decode_policy} "
          f"max_queue_depth={engine.max_queue_depth or 'unbounded'} "
          f"default_deadline_us={engine.default_deadline_us or 'none'} "
          f"tenant_weights={engine.tenant_weights or '{}'} "
          f"device={decoder.device}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        engine.close(drain_timeout_s=args.drain_timeout_s)


def _load_config(path: str) -> dict:
    """Run a config file (it builds its graph with the DSL) and return its
    globals, as ``paddle_tpu/cli.py`` ``_load_config`` does for the v2
    declaration style."""
    path = os.path.abspath(path)
    cfg_dir = os.path.dirname(path)
    if cfg_dir not in sys.path:
        sys.path.insert(0, cfg_dir)
    return runpy.run_path(path)


def _build(args):
    """The config's trainer, as ``paddle_tpu/cli.py``'s ``_build`` makes
    it: (paddle, config globals, topology, trainer)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import config

    unported = [f"--{f}" for f in _UNPORTED_TRAIN_FLAGS
                if getattr(args, f) not in (None, 0)]
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)}: not ported to paddle_tpu_torch yet "
            f"(ROADMAP.md section 1)")
    if args.job not in _JOBS:
        raise NotImplementedError(
            f"--job={args.job}: not ported to paddle_tpu_torch yet (ported: "
            f"{', '.join(_JOBS)}; ROADMAP.md section 1)")
    # before the config runs: its own paddle.init() keeps this device
    config.set_option("device", args.device)
    config.default_device()
    cfg = _load_config(args.config)
    if args.precision:
        # after the config ran its own init (the flag wins), before the
        # trainer is built under the policy
        from paddle_tpu_torch.core import precision
        precision.apply_policy_name(args.precision)
    topo = paddle.Topology(cfg["cost"])
    params = paddle.parameters.create(topo)
    opt = cfg.get("optimizer") or paddle.optimizer.Momentum(
        learning_rate=0.01, momentum=0.9)
    trainer = paddle.trainer.SGD(topo, params, opt,
                                 check_nan_inf=args.check_nan_inf)
    return paddle, cfg, topo, trainer


def cmd_train(args) -> None:
    if args.job == "time":
        return cmd_time(args)
    if args.job == "test":
        return cmd_test(args)
    paddle, cfg, _, trainer = _build(args)
    reader = cfg.get("train_reader")
    if reader is None:
        raise SystemExit("config must define train_reader for --job=train")
    paddle.core.config.set_option("log_period", args.log_period)
    # an invalid --steps_per_dispatch (0, negative) reaches the trainer's
    # ValueError; 1, the default, is off
    spd = args.steps_per_dispatch
    sb = args.seq_buckets
    seq_buckets = ((True if sb == "auto"
                    else [int(x) for x in sb.split(",") if x.strip()])
                   if sb else None)
    ckpt = None
    if args.save_dir:
        from paddle_tpu_torch.io.checkpoint import CheckpointConfig
        ckpt = CheckpointConfig(
            args.save_dir, saving_period=args.saving_period,
            save_only_one=args.save_only_one,
            save_period_steps=args.save_period_steps or None,
            async_save=not args.sync_save,
            reverify_period_s=args.reverify_period_s or None)
    trainer.train(reader, num_passes=args.num_passes,
                  feeding=cfg.get("feeding"), checkpoint_config=ckpt,
                  prefetch_depth=args.prefetch_depth or None,
                  steps_per_dispatch=None if spd == 1 else spd,
                  seq_buckets=seq_buckets)


def cmd_test(args) -> None:
    """``--job=test``: the config's cost (and its evaluators' metrics)
    over ``test_reader`` (else ``train_reader``), on the newest snapshot
    under ``--save_dir`` when one is given; one JSON line."""
    _, cfg, _, trainer = _build(args)
    if args.save_dir:
        from paddle_tpu_torch.io import checkpoint
        trainer.restore(checkpoint.load(args.save_dir))
    reader = cfg.get("test_reader") or cfg.get("train_reader")
    if reader is None:
        raise SystemExit("config must define test_reader (or "
                         "train_reader) for --job=test")
    result = trainer.test(reader, feeding=cfg.get("feeding"))
    print(json.dumps({"cost": result.cost, "metrics": result.metrics}))


def cmd_checkpoint(args) -> None:
    """``checkpoint verify DIR``: a read-only audit of every snapshot
    (pass and step) against its manifest's SHA-256s, printed as JSON;
    exits 1 when one fails or none exists.  ``checkpoint latest DIR``:
    the newest snapshot that verifies (the policy of auto-resume and
    ``serve``), read-only, as one JSON line; exits 1 when none does."""
    from paddle_tpu_torch.io import checkpoint

    if not os.path.isdir(args.dir):
        raise SystemExit(f"checkpoint {args.action}: no such directory: "
                         f"{args.dir}")
    if args.action == "latest":
        try:
            cand = checkpoint.latest_valid(args.dir,
                                           quarantine_corrupt=False)
        except (FileNotFoundError, checkpoint.CheckpointCorrupt) as e:
            print(json.dumps({"dir": args.dir, "error": str(e)}))
            raise SystemExit(1)
        print(json.dumps({"dir": cand["dir"], "kind": cand["kind"],
                          "global_step": cand["global_step"],
                          "model_version": cand["model_version"],
                          "skipped_corrupt": cand["fallbacks"]}))
        return
    rep = checkpoint.audit(args.dir)
    print(json.dumps(rep, indent=1))
    if rep["corrupt"]:
        raise SystemExit(1)
    if not rep["snapshots"]:
        raise SystemExit(f"checkpoint verify: no snapshots under "
                         f"{args.dir}")


def _synthetic_feed(topo, batch_size: int):
    """A synthetic batch from the topology's feed signature (--job=time),
    as the JAX command draws it."""
    import numpy as np

    feed = {}
    for name in topo.input_names:
        spec = topo.get_layer(name)
        shape = topo.shapes[name]
        if any(d is None for d in shape):
            raise SystemExit(
                f"synthetic feed needs max_len on data layer {name!r} "
                f"(unsized sequence dim) for --job=time")
        full = (batch_size,) + tuple(shape)
        if spec.attrs.get("is_index"):
            feed[name] = np.random.randint(
                0, max(spec.attrs.get("dim", 2), 2), size=full
            ).astype(np.int32)
        else:
            feed[name] = np.random.rand(*full).astype(np.float32)
        if topo.is_seq[name]:
            feed[name + "@len"] = np.full((batch_size,), shape[0],
                                          np.int32)
    return feed


def cmd_time(args) -> None:
    """TrainerBenchmark parity: the training step on a synthetic batch,
    reported as ms a batch and samples a second in one JSON line.  With
    --steps_per_dispatch K > 1 the K-step chunk is timed too
    (``timed_multi_dispatch``: on the card one CUDA graph replay a
    chunk), and the line carries the single-step figure and the
    amortization.  Each lap ends with one host read; the laps run on
    copies of the trainer's state."""
    import numpy as np
    import torch

    _, _, topo, trainer = _build(args)
    feed = {k: torch.as_tensor(v, device=trainer.device)
            for k, v in _synthetic_feed(topo, args.batch_size).items()}
    k = args.steps_per_dispatch or 1
    with trainer.on_copies():
        for _ in range(3):                      # warm-up, kernel builds
            loss = trainer._step(feed)
        if not np.isfinite(float(loss)):
            raise FloatingPointError("warmup loss not finite")
        t0 = time.perf_counter()
        for _ in range(args.iters):
            loss = trainer._step(feed)
        last = float(loss)
        dt_single = time.perf_counter() - t0
    if not np.isfinite(last):
        raise FloatingPointError("timed loss not finite")
    if k > 1:
        dt, n_batches = trainer.timed_multi_dispatch(feed, k,
                                                     iters=args.iters)
    else:
        dt, n_batches = dt_single, args.iters
    rec = {"ms_per_batch": round(dt / n_batches * 1e3, 3),
           "samples_per_sec": round(args.batch_size * n_batches / dt, 2),
           "steps_per_dispatch": k,
           "batch_size": args.batch_size,
           "iters": args.iters}
    if k > 1:
        ms_single = dt_single / args.iters * 1e3
        rec["ms_per_batch_single_dispatch"] = round(ms_single, 3)
        rec["dispatch_amortization"] = round(
            ms_single / (dt / n_batches * 1e3), 2)
    print(json.dumps(rec))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m paddle_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("train", help="train a DSL config through "
                                      "trainer.SGD")
    tr.add_argument("--config", required=True,
                    help="python file defining cost and train_reader "
                         "(optimizer, feeding optional)")
    tr.add_argument("--job", default="train",
                    help="train (default), test (the cost on test_reader "
                         "from the --save_dir snapshot, one JSON line) or "
                         "time (TrainerBenchmark: the step on a synthetic "
                         "batch, one JSON line); the JAX command's other "
                         "jobs raise")
    tr.add_argument("--num_passes", type=int, default=1)
    tr.add_argument("--log_period", type=int, default=100,
                    help="print the cost every N batches")
    tr.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises with no card) or 'cpu'")
    tr.add_argument("--precision", default=None,
                    choices=["fp32", "bf16", "fp16", "mixed"],
                    help="precision policy (overrides the config's init): "
                         "fp32 = full precision; bf16/fp16 = "
                         "reduced-precision compute on float32 master "
                         "parameters; mixed = bf16 compute with dynamic "
                         "loss scaling")
    tr.add_argument("--batch_size", type=int, default=64,
                    help="--job=time synthetic batch size")
    tr.add_argument("--iters", type=int, default=20,
                    help="--job=time timed iterations")
    tr.add_argument("--steps_per_dispatch", type=int, default=1,
                    help="train steps per dispatch: --job=train draws K "
                         "batches at a time and runs a full group as one "
                         "prepared chunk (on the card one CUDA graph "
                         "replay; bit-equal to per-step); --job=time "
                         "times the K-step chunk")
    tr.add_argument("--seq_buckets", default=None,
                    help="2-D (rows x seqlen) bucketing of variable-length "
                         "sequence inputs: 'auto' pads each batch to the "
                         "smallest power of two >= 8 covering it (capped "
                         "at max_len), a comma list (16,32,64) pins the "
                         "bucket set")
    tr.add_argument("--prefetch_depth", type=int, default=0,
                    help="convert and copy up to this many batches ahead "
                         "on a producer thread (0 = off)")
    tr.add_argument("--check_nan_inf", action="store_true",
                    help="raise naming the loss or gradients that went "
                         "non-finite (reference: FLAGS_check_nan_inf)")
    tr.add_argument("--save_dir", default=None,
                    help="checkpoint dir: pass snapshots (and step "
                         "snapshots with --save_period_steps) go here, "
                         "and training resumes from the newest that "
                         "verifies")
    tr.add_argument("--saving_period", type=int, default=1,
                    help="a pass snapshot every N passes")
    tr.add_argument("--save_only_one", action="store_true",
                    help="keep only the newest pass snapshot")
    tr.add_argument("--save_period_steps", type=int, default=0,
                    help="also snapshot every N global steps (step-%%09d "
                         "dirs with the reader position: a SIGKILL loses "
                         "at most N steps, resume is mid-pass bit-equal; "
                         "0 = per-pass only)")
    tr.add_argument("--reverify_period_s", type=float, default=0,
                    help="the async writer's idle loop re-verifies the "
                         "retained step snapshots this many seconds "
                         "apart and quarantines corruption (0 = off)")
    tr.add_argument("--sync_save", action="store_true",
                    help="write step snapshots in the step loop instead "
                         "of the background writer thread")
    for flag in _UNPORTED_TRAIN_FLAGS:
        tr.add_argument(f"--{flag}", default=None,
                        help="not ported yet: raises")
    tr.set_defaults(fn=cmd_train)
    sv = sub.add_parser("serve", help="serve a transformer LM checkpoint "
                                      "through the decode engine")
    sv.add_argument("--params", required=True,
                    help="checkpoint dir (pass-%%05d / step-%%09d "
                         "snapshots); the newest that verifies is served")
    sv.add_argument("--num_heads", type=int, required=True,
                    help="attention heads (dim / num_heads = head dim)")
    sv.add_argument("--decode", action="store_true",
                    help="continuous-batching autoregressive decode "
                         "(required: the whole-forward mode is not "
                         "ported): the slab SlotDecoder, or the paged one "
                         "with --paged_kv")
    sv.add_argument("--paged_kv", action="store_true",
                    help="paged KV cache: one block pool, mixed "
                         "prefill/decode iterations, prefix caching")
    sv.add_argument("--sampling", action="store_true",
                    help="paged decode: requests may carry "
                         "temperature/top_k/top_p/seed (greedy stays the "
                         "bit-equal default)")
    sv.add_argument("--decode_kernel", default="auto",
                    choices=("auto", "torch"),
                    help="decode attention: 'auto' = the CUDA kernels on "
                         "the card (their plain versions on the CPU), "
                         "'torch' = the plain versions anywhere")
    sv.add_argument("--decode_policy", default="continuous",
                    choices=("continuous", "static"),
                    help="'continuous' (iteration-level joins and exits) "
                         "or 'static' (no join until the whole batch "
                         "drains: the request-level baseline)")
    sv.add_argument("--max_slots", type=int, default=8,
                    help="resident sequences (decode rows)")
    sv.add_argument("--kv_block_size", type=int, default=16,
                    help="paged decode: positions per KV block")
    sv.add_argument("--kv_blocks", type=int, default=None,
                    help="paged decode: pool blocks incl. the scratch "
                         "block (default: 1 + max_slots x ceil(max_len / "
                         "block_size))")
    sv.add_argument("--default_max_tokens", type=int, default=64,
                    help="generation budget of a request naming none")
    sv.add_argument("--eos_id", type=int, default=None,
                    help="token id that ends a sequence")
    sv.add_argument("--max_queue_depth", type=int, default=0,
                    help="admission control: shed (429 + Retry-After) once "
                         "this many requests are backlogged; 0 = unbounded")
    sv.add_argument("--default_deadline_us", type=float, default=0,
                    help="deadline of a request that carries none; it "
                         "covers the whole generation (0 = none)")
    sv.add_argument("--drain_timeout_s", type=float, default=30.0,
                    help="on shutdown, drain in-flight work this long, "
                         "then shed the rest")
    sv.add_argument("--tenant_weights", default=None,
                    help="tenant=weight pairs ('search=3,ads=1'): weighted "
                         "fair queuing inside each lane, in decode steps; "
                         "unknown tenants weigh 1, untagged traffic rides "
                         "'default'")
    sv.add_argument("--max_queue_depth_per_tenant", type=float,
                    default=0.0,
                    help="per-tenant quota over queued and slot-holding "
                         "sequences: < 1 a fraction of --max_queue_depth, "
                         ">= 1 a count (429 reason=tenant_quota; 0 = none)")
    sv.add_argument("--breaker_window", type=int, default=64,
                    help="per-tenant error-rate breaker: rolling window in "
                         "requests (0 = off)")
    sv.add_argument("--breaker_threshold", type=float, default=0.5,
                    help="windowed error rate that opens a tenant's "
                         "breaker (429 reason=breaker_open until a "
                         "half-open probe succeeds)")
    sv.add_argument("--breaker_min_requests", type=int, default=16,
                    help="requests in the window before the breaker may "
                         "open")
    sv.add_argument("--breaker_cooldown_s", type=float, default=5.0,
                    help="seconds an open breaker waits before one "
                         "half-open probe")
    sv.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises with no card) or 'cpu'")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8080,
                    help="0 picks a free port (see the ready line)")
    sv.set_defaults(fn=cmd_serve)
    ck = sub.add_parser("checkpoint", help="read-only snapshot audit "
                                           "(verify) or newest-valid "
                                           "resolution (latest)")
    ck.add_argument("action", choices=["verify", "latest"])
    ck.add_argument("dir", help="checkpoint dir (pass-NNNNN / "
                                "step-NNNNNNNNN snapshots)")
    ck.set_defaults(fn=cmd_checkpoint)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
