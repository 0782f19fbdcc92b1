"""Command line: ``python -m paddle_tpu_torch {train,serve} ...``.

``train --config CFG --num_passes N [--device cpu]`` is the counterpart of
``python -m paddle_tpu train`` (``cmd_train``): the config defines
``cost``, ``train_reader`` and optionally ``optimizer`` (default Momentum,
lr 0.01, momentum 0.9) and ``feeding``, and is trained through
``trainer.SGD``; ``--precision`` names the precision policy, which wins
over the config's own ``init``.  The JAX command's checkpoint, telemetry, prefetch,
bucketing and steps-per-dispatch flags are not ported yet and raise.

``serve`` serves a transformer LM checkpoint through the paged decoder, as
``python -m paddle_tpu serve --decode --paged_kv`` does.  The JAX command
builds the model from a DSL config (``--model cfg.py``); here the dims
come from the parameter shapes and the caller names ``--num_heads``.
"""

from __future__ import annotations

import argparse
import json
import os
import runpy
import sys
import threading

# flags of the JAX ``train`` verb this port does not have yet
_UNPORTED_TRAIN_FLAGS = ("save_dir", "telemetry_dir", "metrics_port",
                         "prefetch_depth", "seq_buckets",
                         "steps_per_dispatch", "compile_cache_dir")


def _serve_ready_line(role, host, port, **extra):
    """ONE machine-readable ready line on stdout: with ``--port 0`` it is
    the only reliable way to learn the bound port."""
    url_host = "127.0.0.1" if host in ("0.0.0.0", "::", "") else host
    rec = {"role": role, "url": f"http://{url_host}:{port}", "port": port,
           "host": host, "pid": os.getpid(), **extra}
    print(json.dumps({"ptpu_serve": rec}), flush=True)
    return rec


def cmd_serve(args) -> None:
    from paddle_tpu_torch.io import checkpoint
    from paddle_tpu_torch.models.transformer import (PagedDecoder,
                                                     params_from_jax)
    from paddle_tpu_torch.serving import InferenceEngine

    if not (args.decode and args.paged_kv):
        raise SystemExit("this port serves only continuous-batching paged "
                         "decode: pass --decode --paged_kv")
    snap = checkpoint.load(args.params)
    model = params_from_jax(checkpoint.params_of(snap),
                            num_heads=args.num_heads)
    decoder = PagedDecoder(model, max_slots=args.max_slots,
                           block_size=args.kv_block_size,
                           num_blocks=args.kv_blocks,
                           device=args.device)
    engine = InferenceEngine(decoder, eos_id=args.eos_id,
                             default_max_tokens=args.default_max_tokens)
    server = engine.serve(args.port, host=args.host)
    port = server.server_address[1]
    _serve_ready_line("engine", args.host, port, snapshot=snap["dir"],
                      device=str(decoder.device),
                      decode_kernel=decoder.decode_kernel)
    print(f"serving on http://{args.host}:{port}  (POST /infer, GET "
          f"/stats /healthz)  max_slots={decoder.max_slots} "
          f"kv_block_size={decoder.block_size} "
          f"kv_blocks={decoder.num_blocks} device={decoder.device}",
          flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        engine.close()


def _load_config(path: str) -> dict:
    """Run a config file (it builds its graph with the DSL) and return its
    globals, as ``paddle_tpu/cli.py`` ``_load_config`` does for the v2
    declaration style."""
    path = os.path.abspath(path)
    cfg_dir = os.path.dirname(path)
    if cfg_dir not in sys.path:
        sys.path.insert(0, cfg_dir)
    return runpy.run_path(path)


def cmd_train(args) -> None:
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import config

    unported = [f"--{f}" for f in _UNPORTED_TRAIN_FLAGS
                if getattr(args, f) not in (None, 0)]
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)}: not ported to paddle_tpu_torch yet "
            f"(ROADMAP.md section 1)")
    # before the config runs: its own paddle.init() keeps this device
    config.set_option("device", args.device)
    config.default_device()
    cfg = _load_config(args.config)
    if args.precision:
        # after the config ran its own init (the flag wins), before the
        # trainer is built under the policy
        from paddle_tpu_torch.core import precision
        precision.apply_policy_name(args.precision)
    cost = cfg["cost"]
    topo = paddle.Topology(cost)
    params = paddle.parameters.create(topo)
    opt = cfg.get("optimizer") or paddle.optimizer.Momentum(
        learning_rate=0.01, momentum=0.9)
    trainer = paddle.trainer.SGD(topo, params, opt)
    reader = cfg.get("train_reader")
    if reader is None:
        raise SystemExit("config must define train_reader for train")
    config.set_option("log_period", args.log_period)
    trainer.train(reader, num_passes=args.num_passes,
                  feeding=cfg.get("feeding"))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m paddle_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("train", help="train a DSL config through "
                                      "trainer.SGD")
    tr.add_argument("--config", required=True,
                    help="python file defining cost and train_reader "
                         "(optimizer, feeding optional)")
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
    for flag in _UNPORTED_TRAIN_FLAGS:
        tr.add_argument(f"--{flag}", default=None,
                        help="not ported yet: raises")
    tr.set_defaults(fn=cmd_train)
    sv = sub.add_parser("serve", help="serve a transformer LM checkpoint "
                                      "through the paged decoder")
    sv.add_argument("--params", required=True,
                    help="checkpoint dir (pass-%%05d / step-%%09d "
                         "snapshots); the newest that verifies is served")
    sv.add_argument("--num_heads", type=int, required=True,
                    help="attention heads (dim / num_heads = head dim)")
    sv.add_argument("--decode", action="store_true",
                    help="continuous-batching autoregressive decode "
                         "(required: the only mode ported)")
    sv.add_argument("--paged_kv", action="store_true",
                    help="paged KV cache (required: the only decoder "
                         "the engine schedules)")
    sv.add_argument("--max_slots", type=int, default=8,
                    help="resident sequences (decode rows)")
    sv.add_argument("--kv_block_size", type=int, default=16,
                    help="positions per KV block")
    sv.add_argument("--kv_blocks", type=int, default=None,
                    help="pool blocks incl. the scratch block (default: "
                         "1 + max_slots x ceil(max_len / block_size))")
    sv.add_argument("--default_max_tokens", type=int, default=64,
                    help="generation budget of a request naming none")
    sv.add_argument("--eos_id", type=int, default=None,
                    help="token id that ends a sequence")
    sv.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises with no card) or 'cpu'")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8000,
                    help="0 picks a free port (see the ready line)")
    sv.set_defaults(fn=cmd_serve)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
