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
chunk beside it, and prints one JSON line.  ``--job=gen`` (``cmd_gen``)
runs the config's ``generator`` (a ``beam_search`` layer) over
``gen_reader`` (else ``test_reader``), with the parameters of the snapshot
under ``--save_dir`` laid over fresh ones (layers the generator does not
own, such as a trained embedding or output fc it names, are kept), and
prints one ``{"ids": ...}`` JSON line a batch.  The JAX command's
telemetry and compile-cache flags and ``--job=checkgrad`` are not ported
yet and raise.

``checkpoint verify DIR`` audits every snapshot under DIR read-only
(a JSON report; exit 1 on corruption); ``checkpoint latest DIR`` prints
the newest snapshot that verifies as one JSON line, quarantining nothing.

``serve --model cfg.py`` serves the config's ``prediction`` (else its
``cost``) as ``python -m paddle_tpu serve`` does: through the whole-forward
engine (micro-batches of ``--max_batch`` rows, ``--max_wait_us``,
``--buckets``, 2-D ``--seq_buckets``), with the weights of ``--params`` (a
snapshot directory, the newest that verifies, or a parameters tar).
``--decode`` serves the config's transformer LM through the slab
``SlotDecoder``, or the paged decoder with ``--paged_kv`` (``--sampling``
for seeded sampling), under ``--decode_policy``; the heads come from the
config, or, with no ``--model``, from ``--num_heads`` and the dims from
the snapshot's shapes.  Both modes take the engine's admission, tenant and
breaker flags (``--max_queue_depth``, ``--tenant_weights a=3,b=1``,
``--max_queue_depth_per_tenant``, ``--breaker_*``,
``--default_deadline_us``, ``--drain_timeout_s``) at the JAX defaults,
``--watch_dir`` (hot reloads from a checkpoint stream,
``--reload_period_s``, ``--canary_fraction``, ``--reload_key_file``) and
``--router_url`` (register with a fleet router, deregister on drain).
``--fleet N`` serves a ``Router`` on ``--port`` and N replica processes
behind it (``--tenant_quota_global``, ``--router_staleness_s``,
``--router_poll_interval_s``, ``--fleet_log_dir``).  The compile cache,
mesh slices, ``--prewarm`` and tracing are not ported yet.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import runpy
import sys
import threading
import time

# flags of the JAX ``train`` verb this port does not have yet (the
# compile cache is ROADMAP.md section 1, item 13b)
_UNPORTED_TRAIN_FLAGS = ("compile_cache_dir",)
# the JAX ``train`` verb's jobs this port runs (its ``checkgrad`` comes
# with ROADMAP.md section 1, item 15)
_JOBS = ("train", "test", "time", "gen")


def _serve_ready_line(role, host, port, **extra):
    """ONE machine-readable ready line on stdout: with ``--port 0`` it is
    the only reliable way to learn the bound port."""
    rec = {"role": role, "url": f"http://{_connect_host(host)}:{port}",
           "port": port,
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


def _connect_host(host):
    """A dialable address for a bind host (a wildcard bind is listen-side
    only)."""
    return "127.0.0.1" if host in ("0.0.0.0", "::", "") else host


def _router_post(router_url, path, doc, timeout_s=10.0):
    """POST a small JSON document to the fleet router (register,
    deregister); the decoded answer, or raises."""
    import urllib.request

    req = urllib.request.Request(
        router_url.rstrip("/") + path, data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        return json.loads(resp.read().decode())


def _replica_passthrough_argv(args):
    """The serve flags a fleet replica inherits from ``serve --fleet N``
    (all but --fleet, --port, --host and --router_url, which the fleet
    owns)."""
    argv = []
    if args.params:
        argv += ["--params", args.params]
    if args.num_heads:
        argv += ["--num_heads", str(args.num_heads)]
    argv += ["--device", args.device,
             "--max_batch", str(args.max_batch),
             "--max_wait_us", str(args.max_wait_us),
             "--drain_timeout_s", str(args.drain_timeout_s)]
    if args.buckets:
        argv += ["--buckets", args.buckets]
    if args.max_queue_depth:
        argv += ["--max_queue_depth", str(args.max_queue_depth)]
    if args.default_deadline_us:
        argv += ["--default_deadline_us", str(args.default_deadline_us)]
    if args.tenant_weights:
        argv += ["--tenant_weights", args.tenant_weights]
    if args.max_queue_depth_per_tenant:
        argv += ["--max_queue_depth_per_tenant",
                 str(args.max_queue_depth_per_tenant)]
    argv += ["--breaker_window", str(args.breaker_window),
             "--breaker_threshold", str(args.breaker_threshold),
             "--breaker_min_requests", str(args.breaker_min_requests),
             "--breaker_cooldown_s", str(args.breaker_cooldown_s)]
    if args.watch_dir:
        # every replica watches the same stream: a fleet reload is N
        # swaps, seen as version skew in the router's /stats as it rolls
        argv += ["--watch_dir", args.watch_dir,
                 "--reload_period_s", str(args.reload_period_s)]
    if args.canary_fraction:
        argv += ["--canary_fraction", str(args.canary_fraction)]
    if args.reload_key_file:
        argv += ["--reload_key_file", args.reload_key_file]
    if args.seq_buckets:
        argv += ["--seq_buckets", args.seq_buckets]
    if args.no_trace:
        argv += ["--no_trace"]
    else:
        argv += ["--trace_sample", str(args.trace_sample)]
        if args.telemetry_dir:
            argv += ["--telemetry_dir", args.telemetry_dir]
    if args.decode:
        argv += ["--decode", "--max_slots", str(args.max_slots),
                 "--default_max_tokens", str(args.default_max_tokens),
                 "--decode_policy", args.decode_policy,
                 "--decode_kernel", args.decode_kernel]
        if args.eos_id is not None:
            argv += ["--eos_id", str(args.eos_id)]
        if args.paged_kv:
            argv += ["--paged_kv", "--kv_block_size",
                     str(args.kv_block_size)]
            if args.kv_blocks:
                argv += ["--kv_blocks", str(args.kv_blocks)]
        if args.sampling:
            argv += ["--sampling"]
    return argv


def cmd_serve_fleet(args) -> None:
    """``serve --fleet N``: a ``Router`` on --port and N replica serve
    processes on free ports, each registering on start and deregistering
    on drain; a replica that dies is reported and left out of rotation."""
    import tempfile

    from paddle_tpu_torch.serving import fleet as fleet_mod
    from paddle_tpu_torch.serving.router import Router

    if not args.model:
        raise SystemExit("serve --fleet needs --model (the replicas' "
                         "config)")
    router = Router(tenant_quota=args.tenant_quota_global,
                    poll_interval_s=args.router_poll_interval_s,
                    staleness_s=args.router_staleness_s,
                    **_trace_kwargs(args))
    server = router.serve(args.port, host=args.host)
    port = server.server_address[1]
    router_url = f"http://{_connect_host(args.host)}:{port}"
    log_dir = args.fleet_log_dir or tempfile.mkdtemp(prefix="ptt_fleet_")
    _serve_ready_line("router", args.host, port, fleet=args.fleet,
                      log_dir=log_dir)
    print(f"fleet router on {router_url}  (POST /infer /register "
          f"/deregister, GET /stats /healthz)  tenant_quota_global="
          f"{args.tenant_quota_global or 'off'} staleness_s="
          f"{args.router_staleness_s:g}  replica logs in {log_dir}",
          flush=True)
    replicas = []
    try:
        replicas = fleet_mod.spawn_fleet(
            args.fleet, os.path.abspath(args.model), router_url=router_url,
            extra=_replica_passthrough_argv(args), log_dir=log_dir)
        for rep in replicas:
            print(f"replica up: {rep.url} (pid {rep.pid}, log "
                  f"{rep.log_path})", flush=True)
        try:
            # supervise: reap a replica that dies and say so; the router
            # ages it out of rotation by itself
            down = set()
            while len(down) < len(replicas):
                time.sleep(2.0)
                for rep in replicas:
                    code = rep.proc.poll()
                    if code is not None and rep.url not in down:
                        down.add(rep.url)
                        print(f"replica DOWN: {rep.url} exited {code} "
                              f"(pid {rep.pid}, log {rep.log_path}); "
                              f"respawn with `serve --router_url "
                              f"{router_url}` to restore capacity",
                              flush=True)
            print("every replica is down: leaving fleet mode", flush=True)
        except KeyboardInterrupt:
            pass
    finally:
        for rep in replicas:
            try:
                rep.stop(timeout_s=args.drain_timeout_s + 15.0)
            except Exception as e:          # noqa: BLE001 - best effort
                print(f"stopping {rep.url}: {e!r}", flush=True)
        router.close()


def _num_heads_of(topo) -> int:
    """The heads of the graph's attention layers."""
    heads = {spec.attrs["num_heads"] for spec in topo.specs
             if "num_heads" in spec.attrs}
    if len(heads) != 1:
        raise SystemExit(f"serve --decode: the config's graph must hold "
                         f"attention layers of one head count, found "
                         f"{sorted(heads)}")
    return heads.pop()


def _serve_weights(args):
    """(output layer or None, Parameters or a snapshot's tree, model
    version, heads or None, config globals) for ``serve``: with ``--model`` the config's
    graph, its parameters fresh from the seed and overlaid by
    ``--params`` (a snapshot dir, the newest that verifies, or a
    parameters tar); without it the snapshot's tree alone (decode)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import config
    from paddle_tpu_torch.io import checkpoint

    snap = None
    if args.params and os.path.isdir(args.params):
        snap = checkpoint.load(args.params)
    version = (checkpoint.snapshot_version(snap["manifest"]) if snap
               else "boot")
    if not args.model:
        if snap is None or not args.num_heads:
            raise SystemExit("serve --decode without --model needs "
                             "--params (a checkpoint dir) and --num_heads")
        return (None, checkpoint.params_of(snap), version, args.num_heads,
                {})
    # before the config runs: its own paddle.init() keeps this device
    config.set_option("device", args.device)
    cfg = _load_config(args.model)
    out_layer = cfg.get("prediction") or cfg.get("cost")
    if out_layer is None:
        raise SystemExit("serve config must define `prediction` (an output "
                         "layer) or `cost`")
    topo = paddle.Topology(out_layer, collect_evaluators=False)
    params = paddle.parameters.create(topo, device=args.device)
    if snap is not None:
        # the snapshot overlays the fresh tree: what it lacks stays
        paddle.parameters.check_fuse_conv_bn_mismatch(
            params.values, paddle.parameters.tree_keys(
                checkpoint.params_of(snap)))
        for lname, ps in checkpoint.params_of(snap).items():
            for name, v in ps.items():
                if f"{lname}.{name}" in params:
                    params[f"{lname}.{name}"] = v
    elif args.params:
        with open(args.params, "rb") as f:
            params.from_tar(f)
    heads = _num_heads_of(topo) if args.decode else None
    return out_layer, params, version, heads, cfg


def _trace_kwargs(args) -> dict:
    """``trace_sample`` / ``telemetry_dir`` of a serving edge: head
    sampling at ``--trace_sample`` with the tail-based flight recorder,
    or nothing with ``--no_trace``."""
    if args.no_trace:
        return {}
    return dict(trace_sample=args.trace_sample,
                telemetry_dir=args.telemetry_dir or None)


def _reload_key(path):
    if not path:
        return None
    try:
        with open(path, "rb") as f:
            key = f.read().strip()
    except OSError as e:
        raise SystemExit(f"cannot read --reload_key_file {path!r}: {e}")
    if not key:
        raise SystemExit(f"--reload_key_file {path!r} is empty")
    return key


def cmd_serve(args) -> None:
    from paddle_tpu_torch.models.transformer import (PagedDecoder,
                                                     SlotDecoder,
                                                     params_from_jax)
    from paddle_tpu_torch.serving import InferenceEngine, WeightWatcher

    if args.fleet:
        return cmd_serve_fleet(args)
    if args.decode and args.seq_buckets:
        raise SystemExit("--decode is exclusive with --seq_buckets: decode "
                         "buckets ride the decoder (step/prefill buckets)")
    if args.decode and args.canary_fraction:
        raise SystemExit("--decode is exclusive with --canary_fraction: "
                         "decode serves ONE resident weight set "
                         "(drain-then-swap); canary lanes need the "
                         "whole-forward engine")
    if args.sampling and not args.paged_kv:
        raise SystemExit("--sampling needs the paged decoder: add "
                         "--paged_kv")
    if not args.decode and not args.model:
        raise SystemExit("serve needs --model cfg.py (or --decode with "
                         "--params and --num_heads)")
    tenant_weights = _tenant_weights(args.tenant_weights)
    reload_key = _reload_key(args.reload_key_file)
    out_layer, params, version, heads, cfg = _serve_weights(args)
    common = dict(
        max_wait_us=args.max_wait_us,
        max_queue_depth=args.max_queue_depth,
        default_deadline_us=args.default_deadline_us or None,
        model_version=version, canary_fraction=args.canary_fraction,
        reload_key=reload_key, tenant_weights=tenant_weights,
        max_queue_depth_per_tenant=args.max_queue_depth_per_tenant,
        breaker_window=args.breaker_window,
        breaker_threshold=args.breaker_threshold,
        breaker_min_requests=args.breaker_min_requests,
        breaker_cooldown_s=args.breaker_cooldown_s,
        **_trace_kwargs(args))
    ready_extra = {}
    if args.decode:
        model = params_from_jax(params, num_heads=heads)
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
            default_max_tokens=args.default_max_tokens, **common)
        ready_extra = dict(decode_kernel=decoder.decode_kernel,
                           paged=bool(args.paged_kv),
                           sampling=bool(args.sampling))
        shape = (f"max_slots={decoder.max_slots} "
                 + (f"kv_block_size={decoder.block_size} kv_blocks="
                    f"{decoder.num_blocks} " if args.paged_kv else "")
                 + f"decode_policy={args.decode_policy}")
    else:
        buckets = ([int(b) for b in args.buckets.split(",") if b.strip()]
                   if args.buckets else None)
        seq_buckets = ([int(b) for b in args.seq_buckets.split(",")
                        if b.strip()] if args.seq_buckets else None)
        engine = InferenceEngine(
            out_layer, params, feeding=cfg.get("feeding"),
            max_batch=args.max_batch, batch_buckets=buckets,
            seq_buckets=seq_buckets, **common)
        shape = (f"buckets={list(engine.batch_buckets)} seq_buckets="
                 f"{list(engine.seq_buckets or []) or 'max_len'} "
                 f"max_wait_us={engine.max_wait_us:g}")
    if args.watch_dir:
        # the watcher attaches to the engine: POST /reload pushes a check
        # and engine.close() joins it
        WeightWatcher(engine, args.watch_dir, period_s=args.reload_period_s)
        print(f"watching {args.watch_dir} for new snapshots every "
              f"{args.reload_period_s:g}s (canary_fraction="
              f"{args.canary_fraction:g}, reload key "
              f"{'set' if reload_key else 'none'})", flush=True)
    server = engine.serve(args.port, host=args.host)
    port = server.server_address[1]
    ready = _serve_ready_line(
        "replica" if args.router_url else "engine", args.host, port,
        snapshot=args.params, model_version=engine._active_version(),
        device=str(engine._device), decode=bool(args.decode),
        **ready_extra)
    print(f"serving on http://{args.host}:{port}  (POST /infer /reload, GET "
          f"/stats /healthz /kernels)  {shape} "
          f"max_queue_depth={engine.max_queue_depth or 'unbounded'} "
          f"default_deadline_us={engine.default_deadline_us or 'none'} "
          f"tenant_weights={engine.tenant_weights or '{}'} "
          f"model_version={engine._active_version()} "
          f"device={engine._device}", flush=True)
    registered = False
    try:
        if args.router_url:
            # register once the port answers, retried: a router briefly
            # down must not take a healthy replica past its drain path
            for attempt in range(5):
                try:
                    _router_post(args.router_url, "/register",
                                 {"url": ready["url"]})
                    registered = True
                    print(f"registered with router {args.router_url}",
                          flush=True)
                    break
                except Exception as e:      # noqa: BLE001 - keep serving
                    print(f"register with {args.router_url} failed "
                          f"({e!r}), retry {attempt + 1}/5", flush=True)
                    time.sleep(1.0)
            if not registered:
                print(f"WARNING: serving UNREGISTERED; POST "
                      f"{args.router_url}/register {{\"url\": "
                      f"\"{ready['url']}\"}} to add this replica",
                      flush=True)
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        if registered:
            # out of rotation before the in-flight work drains
            try:
                _router_post(args.router_url, "/deregister",
                             {"url": ready["url"]})
                print(f"deregistered from router {args.router_url}",
                      flush=True)
            except Exception as e:          # noqa: BLE001 - drain anyway
                print(f"deregister from {args.router_url} failed: {e!r}",
                      flush=True)
        engine.close(drain_timeout_s=args.drain_timeout_s)


def _load_config(path: str) -> dict:
    """Run a config file (it builds its graph with the DSL) and return its
    globals, as ``paddle_tpu/cli.py`` ``_load_config`` does.  A config in
    the legacy style (``from paddle_tpu_torch.trainer_config_helpers import
    *``) that declares its cost with ``outputs(cost)`` and its data with
    ``define_py_data_sources2`` gets ``cost`` from the first declared
    output, ``train_reader`` / ``test_reader`` from the provider, batched
    at ``settings(batch_size=)`` (default 128) under the provider's
    ``calc_batch_size`` and ``can_over_batch_size``, and ``feeding`` from
    the provider's ``input_types``.  As in the JAX package, the optimizer
    that ``settings()`` returns is used only where the config assigns it
    to ``optimizer``."""
    from paddle_tpu_torch import networks
    from paddle_tpu_torch import py_data_provider2 as pdp2
    from paddle_tpu_torch.core import config
    from paddle_tpu_torch.reader.decorator import batched

    networks._DECLARED_OUTPUTS[:] = []
    pdp2._SOURCES.clear()
    config.set_option("legacy_batch_size", None)
    path = os.path.abspath(path)
    # legacy configs import sibling provider modules by bare name
    cfg_dir = os.path.dirname(path)
    if cfg_dir not in sys.path:
        sys.path.insert(0, cfg_dir)
    cfg = runpy.run_path(path)
    if "cost" not in cfg and networks._DECLARED_OUTPUTS:
        cfg["cost"] = networks._DECLARED_OUTPUTS[0]
    src = pdp2.get_data_sources()
    if src is not None:
        prov = src["provider"]
        bs = config.get_option("legacy_batch_size") or 128
        batch_kw = dict(batch_size=bs, drop_last=False,
                        calc_batch_size=getattr(prov, "calc_batch_size",
                                                None),
                        can_over_batch_size=getattr(
                            prov, "can_over_batch_size", True))
        for key, lst, train in (("train_reader", "train_list", True),
                                ("test_reader", "test_list", False)):
            if key not in cfg and src.get(lst):
                cfg[key] = batched(prov.reader(src[lst], is_train=train,
                                               args=src.get("args")),
                                   **batch_kw)
        if "feeding" not in cfg and prov.feeding() is not None:
            cfg["feeding"] = prov.feeding()
    return cfg


def _config_for(args) -> dict:
    """Refuse what is not ported, put the device in place and run the
    config (its globals), under the ``--precision`` policy."""
    from paddle_tpu_torch.core import config

    unported = [f"--{f}" for f in _UNPORTED_TRAIN_FLAGS
                if getattr(args, f) not in (None, 0)]
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)}: not ported to paddle_tpu_torch yet "
            f"(ROADMAP.md section 1, item 13b: the compile cache)")
    if args.job not in _JOBS:
        raise NotImplementedError(
            f"--job={args.job}: not ported to paddle_tpu_torch yet (ported: "
            f"{', '.join(_JOBS)}; ROADMAP.md section 1, item 15)")
    # before the config runs: its own paddle.init() keeps this device
    config.set_option("device", args.device)
    config.default_device()
    cfg = _load_config(args.config)
    if args.precision:
        # after the config ran its own init (the flag wins), before the
        # graph runs under the policy
        from paddle_tpu_torch.core import precision
        precision.apply_policy_name(args.precision)
    return cfg


def _build(args):
    """The config's trainer, as ``paddle_tpu/cli.py``'s ``_build`` makes
    it: (paddle, config globals, topology, trainer)."""
    import paddle_tpu_torch as paddle

    cfg = _config_for(args)
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
    if args.job == "gen":
        return cmd_gen(args)
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
    with _train_telemetry(args):
        trainer.train(reader, num_passes=args.num_passes,
                      feeding=cfg.get("feeding"), checkpoint_config=ckpt,
                      prefetch_depth=args.prefetch_depth or None,
                      steps_per_dispatch=None if spd == 1 else spd,
                      seq_buckets=seq_buckets)


@contextlib.contextmanager
def _train_telemetry(args):
    """``--telemetry_dir`` / ``--metrics_port`` around a training run (the
    JAX CLI's): either turns telemetry on; the port serves ``/metrics``,
    ``/metrics.json``, ``/healthz`` and ``/executables`` while it runs;
    the dir gets a ``metrics.jsonl`` snapshot every ``--snapshot_period``
    seconds and, at exit (a crashed run's too), a last snapshot and the
    span trace ``trace.json``."""
    telemetry_dir = args.telemetry_dir
    metrics_port = args.metrics_port
    server = snapshotter = None
    if telemetry_dir or metrics_port is not None:
        from paddle_tpu_torch import observability as obs
        obs.enable()
    if metrics_port is not None:
        from paddle_tpu_torch.observability import executables, sinks
        host = args.metrics_host or "127.0.0.1"
        server = sinks.serve_metrics(
            metrics_port, host=host,
            extra_handlers={"/executables": executables.http_handler})
        print(f"metrics endpoint: "
              f"http://{host}:{server.server_port}/metrics", flush=True)
    if telemetry_dir and args.snapshot_period > 0:
        from paddle_tpu_torch.observability import sinks
        os.makedirs(telemetry_dir, exist_ok=True)
        snapshotter = sinks.start_periodic_snapshots(
            os.path.join(telemetry_dir, "metrics.jsonl"),
            interval_s=args.snapshot_period)
    try:
        yield
    finally:
        if snapshotter is not None:
            snapshotter.stop(final_snapshot=False)
        if server is not None:
            server.shutdown()
            server.server_close()
        if telemetry_dir:
            from paddle_tpu_torch.observability import sinks
            os.makedirs(telemetry_dir, exist_ok=True)
            sinks.write_metrics_snapshot(
                os.path.join(telemetry_dir, "metrics.jsonl"))
            sinks.write_chrome_trace(
                os.path.join(telemetry_dir, "trace.json"))
            print(f"telemetry written to {telemetry_dir} (inspect: python "
                  f"-m paddle_tpu_torch metrics --file "
                  f"{os.path.join(telemetry_dir, 'metrics.jsonl')})")


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


def cmd_gen(args) -> None:
    """``--job=gen``: sequence generation, as ``paddle_tpu/cli.py``'s
    ``cmd_gen`` (reference: gen configs run via paddle train).  The config
    defines ``generator`` and ``gen_reader`` (or ``test_reader``), whose
    batches are sample lists or ready feed dicts; the snapshot under
    ``--save_dir`` is union-merged into fresh parameters, because the
    generator resolves shared layers (embeddings, the hoisted vocab
    projection) from the trained tree by name.  One ``{"ids": ...}`` JSON
    line a batch."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import config

    cfg = _config_for(args)
    gen = cfg.get("generator")
    if gen is None:
        raise SystemExit("config must define `generator` for --job=gen")
    topo = paddle.Topology(gen, collect_evaluators=False)
    values = topo.create_parameters().values
    if args.save_dir:
        import torch

        from paddle_tpu_torch.io import checkpoint
        dev = config.default_device()
        snap = checkpoint.params_of(checkpoint.load(args.save_dir))
        values = dict(values)
        for lname, ps in snap.items():
            merged = dict(values.get(lname, {}))
            merged.update({k: torch.as_tensor(v, dtype=torch.float32,
                                              device=dev)
                           for k, v in ps.items() if v is not None})
            values[lname] = merged
    reader = cfg.get("gen_reader") or cfg.get("test_reader")
    if reader is None:
        raise SystemExit("config must define gen_reader for --job=gen")
    feeder = paddle.data_feeder.DataFeeder(topo, cfg.get("feeding"))
    state = topo.create_state()
    for batch in reader():
        feed = feeder.feed(batch) if not isinstance(batch, dict) else batch
        outs, _ = topo.forward(values, state, feed, train=False)
        ids = outs[topo.output_names[0]].cpu().numpy()
        print(json.dumps({"ids": ids.tolist()}), flush=True)


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
    if args.show_layer_stat:
        # per-layer FLOPs (the flop counter, layer by layer) and time
        # (one profiled step, a record_function range a layer)
        from paddle_tpu_torch.utils import profiler as prof
        prof.print_layer_stats(trainer, feed)
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


def cmd_version(args) -> None:
    """``paddle version`` (the JAX package's verb, with torch and CUDA in
    place of jax): the package, torch's and CUDA's versions, the device
    count."""
    import torch

    import paddle_tpu_torch

    cuda = torch.version.cuda if torch.cuda.is_available() else None
    n = torch.cuda.device_count() if cuda else 0
    print(f"paddle_tpu_torch {paddle_tpu_torch.__version__} "
          f"(torch {torch.__version__}, "
          f"{'cuda ' + cuda if cuda else 'no cuda'}, {n} device(s))")


def cmd_dump_config(args) -> None:
    """``paddle dump_config``: the config's lowered model IR, the
    ``Topology.proto()`` JSON (the reference dumps its ModelConfig
    proto), for a DSL or a legacy config alike."""
    import paddle_tpu_torch as paddle

    print(paddle.Topology(_load_config(args.config)["cost"]).proto())


def cmd_pserver(args) -> None:
    print("paddle_tpu_torch has no separate pserver process: one program "
          "runs on every worker and gradients ride collectives over the "
          "cards (the sharded executor is ROADMAP.md section 1, item 14).")


def cmd_metrics(args) -> None:
    """``metrics``: recorded snapshots (``observability.sinks`` JSONL,
    either package's) as a table, Prometheus text or raw JSON."""
    from paddle_tpu_torch.observability import metrics as m
    from paddle_tpu_torch.observability import sinks

    snaps = sinks.read_snapshots(args.file)
    if not snaps:
        raise SystemExit(f"no metrics snapshots in {args.file} — enable "
                         f"telemetry (PADDLE_TPU_TELEMETRY=1 or "
                         f"--telemetry_dir) and write a snapshot first")
    for snap in (snaps if args.all else [snaps[-1]]):
        if args.format == "json":
            print(json.dumps(snap))
        elif args.format == "prom":
            print(m.prometheus_from_snapshot(snap), end="")
        else:
            if snap.get("ts", ""):
                print(f"# snapshot {snap['ts']}")
            print(m.render_snapshot_table(snap))


def cmd_executables(args) -> None:
    """``executables [--json] [--top N] [--url URL]``: the executable
    observatory, from a live process's ``/executables`` (``--url``: a
    trainer's ``--metrics_port`` or a serving engine) or this process's
    own registry."""
    from paddle_tpu_torch.observability import executables as ex

    if args.url:
        import urllib.request

        endpoint = args.url.rstrip("/") + "/executables"
        if args.top:
            endpoint += f"?top={args.top}"
        try:
            with urllib.request.urlopen(endpoint, timeout=15.0) as resp:
                snap = json.loads(resp.read().decode())
        except Exception as e:          # noqa: BLE001 - the CLI surface
            raise SystemExit(f"executables: GET {endpoint} failed: {e!r}")
        print(json.dumps(snap) if args.json
              else ex.render_snapshot_table(snap))
        return
    snap = ex.EXECUTABLES.snapshot(top=args.top or None)
    if args.json:
        print(json.dumps(snap))
        return
    if not snap["executables"]:
        raise SystemExit(
            "no executables registered in this process — the registry "
            "is per-process; point --url at a live trainer "
            "(--metrics_port) or serving engine to read its "
            "/executables endpoint")
    print(ex.render_snapshot_table(snap))


def cmd_trace_request(args) -> None:
    """``trace --request <id> [--url URL]``: one request's cross-process
    timeline from a router's (or any serving process's) ``/trace/<id>``,
    rendered as a span tree; ``--out`` writes it as Chrome trace JSON."""
    import urllib.request

    from paddle_tpu_torch.io import atomic
    from paddle_tpu_torch.observability import tracectx

    url = (args.url or "http://127.0.0.1:8080").rstrip("/")
    endpoint = f"{url}/trace/{args.request}"
    try:
        req = urllib.request.Request(endpoint, method="GET")
        with urllib.request.urlopen(req, timeout=15.0) as resp:
            doc = json.loads(resp.read().decode())
    except Exception as e:              # noqa: BLE001 - the CLI surface
        raise SystemExit(f"trace --request: GET {endpoint} failed: {e!r}")
    spans = doc.get("spans") or []
    if not spans:
        raise SystemExit(
            f"no spans recorded for trace {args.request} at {url} — "
            f"was the request sampled (trace_sample) or anomalous?  "
            f"GET {url}/trace lists recent trace ids")
    print(tracectx.render_tree(spans))
    sources = doc.get("sources")
    if sources:
        parts = [f"{src}={'down' if n is None else n}"
                 for src, n in sorted(sources.items())]
        print("sources: " + "  ".join(parts))
    if args.out:
        payload = json.dumps(tracectx.spans_to_chrome(spans)).encode()
        atomic.atomic_write_file(args.out, lambda f: f.write(payload))
        print(f"Chrome trace written to {args.out} — open in Perfetto "
              f"(one row per fleet process)")


def cmd_trace(args) -> None:
    """``trace``: a recorded host span trace (Chrome trace-event JSON,
    either package's) as a per-span table, optionally one step's and
    re-exported; with ``--request <id>`` a live fleet's request timeline
    (``cmd_trace_request``)."""
    from paddle_tpu_torch.observability import sinks

    if args.request:
        return cmd_trace_request(args)
    doc = sinks.read_chrome_trace(args.file)
    evs = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    if args.step is not None:
        evs = [e for e in evs
               if e.get("args", {}).get("step") == args.step]
    if not evs:
        raise SystemExit(f"no spans in {args.file}"
                         + (f" for step {args.step}"
                            if args.step is not None else ""))
    agg = {}
    for e in evs:
        a = agg.setdefault(e["name"], [0, 0.0, 0.0])
        a[0] += 1
        a[1] += float(e.get("dur", 0.0))
        a[2] = max(a[2], float(e.get("dur", 0.0)))
    width = max([len(n) for n in agg] + [len("span")])
    print(f"{'span':<{width}} {'count':>7} {'total_ms':>10} "
          f"{'avg_us':>9} {'max_us':>9}")
    for name, (cnt, tot, mx) in sorted(agg.items(),
                                       key=lambda kv: -kv[1][1]):
        print(f"{name:<{width}} {cnt:>7} {tot / 1e3:>10.3f} "
              f"{tot / cnt:>9.1f} {mx:>9.1f}")
    steps = {e.get("args", {}).get("step") for e in evs}
    steps.discard(None)
    print(f"{len(evs)} spans across {len(steps)} correlated steps")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"traceEvents": evs,
                       "displayTimeUnit": doc.get("displayTimeUnit",
                                                  "ms")}, f)
        print(f"Chrome trace written to {args.out} — open in Perfetto "
              f"next to a torch.profiler capture (utils/profiler.py)")


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
                         "batch, one JSON line) or gen (the config's "
                         "generator over gen_reader, one {\"ids\": ...} "
                         "line a batch); checkgrad raises")
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
    tr.add_argument("--show_layer_stat", action="store_true",
                    help="--job=time: per-layer FLOPs and time of one step "
                         "(reference: FLAGS_show_layer_stat)")
    tr.add_argument("--telemetry_dir", default=None,
                    help="enable step-level telemetry and write "
                         "metrics.jsonl + trace.json here at exit")
    tr.add_argument("--metrics_port", type=int, default=None,
                    help="serve live Prometheus metrics (and "
                         "/executables) on this port while training (0 = "
                         "ephemeral).  Implies telemetry on")
    tr.add_argument("--metrics_host", default="127.0.0.1",
                    help="bind address for --metrics_port — loopback by "
                         "default; the endpoint is unauthenticated, so "
                         "widen (e.g. 0.0.0.0) deliberately")
    tr.add_argument("--snapshot_period", type=float, default=60.0,
                    help="with --telemetry_dir: append a metrics.jsonl "
                         "snapshot every this many seconds during "
                         "training (0 = only at exit)")
    for flag in _UNPORTED_TRAIN_FLAGS:
        tr.add_argument(f"--{flag}", default=None,
                        help="not ported yet (ROADMAP.md section 1, item "
                             "13b): raises")
    tr.set_defaults(fn=cmd_train)
    sv = sub.add_parser("serve", help="serve a DSL config through the "
                                      "whole-forward engine, or a "
                                      "transformer LM through the decode "
                                      "engine")
    sv.add_argument("--model", default=None,
                    help="config .py defining `prediction` (or `cost`); "
                         "--decode needs a transformer LM's graph")
    sv.add_argument("--params", default=None,
                    help="weights: a checkpoint dir (pass-%%05d / "
                         "step-%%09d snapshots; the newest that verifies "
                         "is served) or a parameters tar")
    sv.add_argument("--num_heads", type=int, default=None,
                    help="--decode without --model: attention heads (dim "
                         "/ num_heads = head dim); with --model the config "
                         "names them")
    sv.add_argument("--max_batch", type=int, default=32,
                    help="row budget of a coalesced micro-batch")
    sv.add_argument("--max_wait_us", type=float, default=2000.0,
                    help="the longest the oldest queued request waits "
                         "before a partial batch dispatches")
    sv.add_argument("--buckets", default=None,
                    help="comma-separated batch-row buckets (default: "
                         "powers of two from 2 to max_batch)")
    sv.add_argument("--seq_buckets", default=None,
                    help="comma-separated padded-seqlen buckets: each "
                         "micro-batch's T axis pads to the smallest bucket "
                         "covering its longest sample, not max_len")
    sv.add_argument("--watch_dir", default=None,
                    help="poll this checkpoint dir for newer snapshots "
                         "that verify and swap them in between "
                         "micro-batches (decode: drain, then swap); "
                         "POST /reload?rollback=1 rolls back")
    sv.add_argument("--reload_period_s", type=float, default=2.0,
                    help="the watcher's poll period (POST /reload checks "
                         "at once)")
    sv.add_argument("--canary_fraction", type=float, default=0.0,
                    help="route this share of untagged traffic to a new "
                         "version before promoting it (an error-rate "
                         "breach rolls it back; 0 = swap at once)")
    sv.add_argument("--reload_key_file", default=None,
                    help="key file: POST /reload must carry "
                         "X-Ptpu-Reload-Key = hex HMAC-SHA256 of "
                         "<query>\\n<body> under it, else 403")
    sv.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="serve a Router on --port and N replica serve "
                         "processes behind it on free ports (each "
                         "inherits the engine flags, registers on start, "
                         "deregisters on drain)")
    sv.add_argument("--router_url", default=None,
                    help="register with the fleet router at this base URL "
                         "on start and deregister on drain")
    sv.add_argument("--tenant_quota_global", type=int, default=0,
                    help="fleet mode: the router sheds a tenant (429, "
                         "reason=tenant_quota_global) holding this many "
                         "unanswered requests fleet-wide (0 = off)")
    sv.add_argument("--router_staleness_s", type=float, default=0.5,
                    help="fleet mode: a replica whose last fresh /stats is "
                         "older than this leaves rotation")
    sv.add_argument("--router_poll_interval_s", type=float, default=0.05,
                    help="fleet mode: the router's /healthz + /stats poll "
                         "period")
    sv.add_argument("--fleet_log_dir", default=None,
                    help="fleet mode: directory of the replicas' logs "
                         "(default: a fresh temp dir, printed)")
    sv.add_argument("--decode", action="store_true",
                    help="continuous-batching autoregressive decode: the "
                         "slab SlotDecoder, or the paged one with "
                         "--paged_kv")
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
    sv.add_argument("--trace_sample", type=float, default=0.01,
                    help="distributed tracing head-sample rate "
                         "(X-Ptpu-Trace propagation and /trace timelines; "
                         "shed, error, deadline and slow requests are "
                         "kept regardless by the tail-based flight "
                         "recorder)")
    sv.add_argument("--no_trace", action="store_true",
                    help="disable distributed tracing entirely (the "
                         "untraced request path)")
    sv.add_argument("--telemetry_dir", default=None,
                    help="flush flight-recorder captures (sampled and "
                         "anomalous request traces) to flight-<pid>.jsonl "
                         "in this directory")
    sv.set_defaults(fn=cmd_serve)
    ck = sub.add_parser("checkpoint", help="read-only snapshot audit "
                                           "(verify) or newest-valid "
                                           "resolution (latest)")
    ck.add_argument("action", choices=["verify", "latest"])
    ck.add_argument("dir", help="checkpoint dir (pass-NNNNN / "
                                "step-NNNNNNNNN snapshots)")
    ck.set_defaults(fn=cmd_checkpoint)
    sub.add_parser("version", help="print version info").set_defaults(
        fn=cmd_version)
    dc = sub.add_parser("dump_config",
                        help="print the lowered model IR JSON")
    dc.add_argument("--config", required=True)
    dc.set_defaults(fn=cmd_dump_config)
    sub.add_parser("pserver", help="(subsumed) the reference's "
                                   "parameter-server process").set_defaults(
        fn=cmd_pserver)
    from paddle_tpu_torch.observability import sinks
    met = sub.add_parser(
        "metrics", help="render recorded telemetry metrics snapshots")
    met.add_argument("--file", default=sinks.DEFAULT_METRICS_PATH,
                     help="metrics JSONL path (observability.sinks)")
    met.add_argument("--format", default="table",
                     choices=["table", "prom", "json"])
    met.add_argument("--all", action="store_true",
                     help="every snapshot line, not just the last")
    met.set_defaults(fn=cmd_metrics)
    exs = sub.add_parser(
        "executables",
        help="the executable observatory: each prepared program's cost, "
             "dispatches, device time and MFU")
    exs.add_argument("--json", action="store_true",
                     help="raw snapshot JSON instead of the table")
    exs.add_argument("--top", type=int, default=0, metavar="N",
                     help="only the N busiest executables by device time "
                          "(rollups always cover everything)")
    exs.add_argument("--url", default=None,
                     help="read a live process's /executables endpoint "
                          "(train --metrics_port or a serving engine) "
                          "instead of this process's empty registry")
    exs.set_defaults(fn=cmd_executables)
    trc = sub.add_parser(
        "trace", help="summarize a captured host span trace (Chrome "
                      "trace-event JSON), or reconstruct a distributed "
                      "request timeline with --request")
    trc.add_argument("--file", default=sinks.DEFAULT_TRACE_PATH)
    trc.add_argument("--step", type=int, default=None,
                     help="only spans with this correlation id")
    trc.add_argument("--request", default=None, metavar="TRACE_ID",
                     help="one request's cross-process timeline from a "
                          "live serving fleet: GET <url>/trace/<id>")
    trc.add_argument("--url", default="http://127.0.0.1:8080",
                     help="with --request: the router (or replica) base "
                          "URL to assemble from")
    trc.add_argument("--out", default=None,
                     help="re-export (filtered or assembled) Chrome trace "
                          "JSON here")
    trc.set_defaults(fn=cmd_trace)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
