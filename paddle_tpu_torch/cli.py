"""Command line: ``python -m paddle_tpu_torch serve ...``.

Serves a transformer LM checkpoint through the paged decoder, as
``python -m paddle_tpu serve --decode --paged_kv`` does.  The JAX command
builds the model from a DSL config (``--model cfg.py``), which is not
ported yet; here the dims come from the parameter shapes and the caller
names ``--num_heads``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading


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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m paddle_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
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
