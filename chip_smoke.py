#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

Usage: ``python3 chip_smoke.py`` from the root of a checkout, on a machine
with an NVIDIA H100 and the CUDA toolkit.  Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build both CUDA kernels (``ops/csrc/*.cu``, one ``nvcc`` each, in
   parallel) and print ptxas' register / shared-memory / spill lines;
3. hold each kernel against its plain PyTorch version at the serving
   slice's full-width shapes (float32, max |error| <= 1e-4);
4. time kernel, plain version and, for flash, the library call
   (``F.scaled_dot_product_attention``, a yardstick the port never calls),
   with CUDA events, L2 flushed between launches;
5. the main path: the full-width transformer LM (vocab 32000, dim 512,
   4 x 128 heads, 8 layers, max_len 4096; random weights from a numpy
   seed) written as a checkpoint, loaded, and served through
   ``PagedDecoder`` + ``InferenceEngine`` over HTTP; 8 concurrent requests
   of 32 tokens; both kernels' launch counters must move, and every stream
   must equal a plain-PyTorch (``decode_kernel="torch"``) run on the card
   except where that run's top-2 logit margin was below 1e-4 (reported);
6. one JSON line listing each kernel's numbers, then the card line again
   and, last, ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout.  The tokens/s and time-to-first-token it prints are a smoke
figure, not a benchmark.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

TOL = 1e-4
PEAK_F32_FLOPS = 67e12        # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
# the serving slice's model: bench.py bench_transformer defaults
VOCAB, DIM, HEADS, LAYERS, FFN_MULT, MAX_LEN = 32000, 512, 4, 8, 4, 4096
SLOTS, BLOCK = 8, 16
MAX_TOKENS = 32
SEED = 1234


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, flush, iters=20, warmup=3) -> float:
    """Median device time of one call, L2 flushed before each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) for s, e in events)[iters // 2]


# ---------------------------------------------------------------- kernels
def flash_phase(dev, gen, flush):
    from paddle_tpu_torch.ops import flash_attention as fa

    B, LK, D = 1, MAX_LEN, DIM // HEADS
    k = torch.randn(B, LK, HEADS, D, device=dev, generator=gen)
    v = torch.randn(B, LK, HEADS, D, device=dev, generator=gen)
    cases = [(lq, off, None) for lq in (8, 256, 2048) for off in (0, 1000)]
    cases.append((256, 1000, 1100))
    max_err, timed = 0.0, None
    for lq, off, kv_len in cases:
        q = torch.randn(B, lq, HEADS, D, device=dev, generator=gen)
        lens = torch.full((B,), kv_len or LK, dtype=torch.int32, device=dev)
        kw = dict(causal=True, scale=D ** -0.5, q_offset=off, kv_offset=0)
        o, lse = fa.flash_fwd_cuda(q, k, v, lens, **kw)
        ro, rlse = fa._torch_attention(q, k, v, lens, return_lse=True, **kw)
        torch.cuda.synchronize()
        err = max((o - ro).abs().max().item(),
                  (lse - rlse).abs().max().item())
        print(f"flash_fwd Lq={lq} q_offset={off} kv_len={kv_len or LK}: "
              f"max|err| {err:.3e}", flush=True)
        if not err <= TOL:
            raise AssertionError(f"flash_fwd disagrees with its plain "
                                 f"version: {err} > {TOL}")
        max_err = max(max_err, err)
        ms = time_ms(lambda: fa.flash_fwd_cuda(q, k, v, lens, **kw), flush)
        plain_ms = time_ms(lambda: fa._torch_attention(q, k, v, lens, **kw),
                           flush)
        kl = kv_len or LK
        pairs = sum(min(max(off + r + 1, 0), kl) for r in range(lq))
        kneed = min(kl, off + lq)
        flops = 4.0 * D * HEADS * B * pairs
        nbytes = 4.0 * (2 * B * lq * HEADS * D + 2 * B * kneed * HEADS * D
                        + B * HEADS * lq + B)
        b_ms, b_by = bound(flops, nbytes)
        print(f"  ms {ms:.4f}  plain_ms {plain_ms:.4f}  bound_ms "
              f"{b_ms:.4f} ({b_by})", flush=True)
        if (lq, off, kv_len) == (2048, 0, None):
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib_ms = time_ms(lambda: torch.nn.functional
                             .scaled_dot_product_attention(
                                 qt, kt, vt, is_causal=True,
                                 scale=D ** -0.5), flush)
            print(f"  library_ms (scaled_dot_product_attention, causal, "
                  f"same shapes) {lib_ms:.4f}", flush=True)
            timed = dict(lq=lq, q_offset=off, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    return max_err, timed


def paged_phase(dev, gen, flush):
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.layers.attention import (paged_gather,
                                                   slot_decode_attention)

    D = DIM // HEADS
    mb = MAX_LEN // BLOCK
    nb = 1 + SLOTS * mb
    scale = D ** -0.5
    pos_list = [0, 5, 100, 1000, 1500, 2047, 3000, 4095]   # row 0: a hole
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    q = torch.randn(SLOTS, HEADS, D, device=dev, generator=gen)
    pk = torch.randn(nb, BLOCK, HEADS, D, device=dev, generator=gen)
    pv = torch.randn(nb, BLOCK, HEADS, D, device=dev, generator=gen)
    perm = np.random.RandomState(SEED).permutation(nb - 1) + 1
    table = perm.reshape(SLOTS, mb).astype(np.int32)
    table[0] = 0                                  # hole row: scratch block
    table = torch.from_numpy(table).to(dev)
    slab_k = torch.randn(SLOTS, MAX_LEN, HEADS, D, device=dev, generator=gen)
    slab_v = torch.randn(SLOTS, MAX_LEN, HEADS, D, device=dev, generator=gen)
    ident = torch.arange(SLOTS, dtype=torch.int32, device=dev)[:, None]
    splits = pa._default_kv_splits(mb)

    def plain(k_, v_, t_):
        return slot_decode_attention(q, paged_gather(k_, t_, MAX_LEN),
                                     paged_gather(v_, t_, MAX_LEN), pos,
                                     scale)

    max_err = 0.0
    for name, k_, v_, t_ in (("pool BS=16", pk, pv, table),
                             ("slab BS=4096", slab_k, slab_v, ident)):
        g = pa._default_kv_splits(t_.shape[1])
        out = pa.paged_decode_cuda(q, k_, v_, t_, pos, scale=scale,
                                   kv_splits=g)
        ref = plain(k_, v_, t_)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        print(f"paged_decode {name} kv_splits={g}: max|err| {err:.3e}",
              flush=True)
        if not (err <= TOL and torch.isfinite(out).all()):
            raise AssertionError(f"paged_decode disagrees with its plain "
                                 f"version: {err} > {TOL}")
        max_err = max(max_err, err)

    ms = time_ms(lambda: pa.paged_decode_cuda(
        q, pk, pv, table, pos, scale=scale, kv_splits=splits), flush)
    plain_ms = time_ms(lambda: plain(pk, pv, table), flush)
    # the kernel launch alone, without the merge_partial fold
    lib = _build.load("paged_decode", pa._SIGNATURES)
    o_part = torch.empty(SLOTS, splits, HEADS, D, device=dev)
    lse_part = torch.empty(SLOTS, splits, HEADS, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def kernel_only():
        _build.check(lib, lib.paged_decode_f32(
            q.data_ptr(), pk.data_ptr(), pv.data_ptr(), table.data_ptr(),
            pos.data_ptr(), o_part.data_ptr(), lse_part.data_ptr(), SLOTS,
            HEADS, D, BLOCK, mb, splits, float(scale * 1.4426950408889634),
            stream), "paged_decode")

    kernel_ms = time_ms(kernel_only, flush)
    keys = sum(p + 1 for p in pos_list)
    flops = 4.0 * HEADS * D * keys
    nbytes = 4.0 * (2 * SLOTS * HEADS * D + 2 * keys * HEADS * D + SLOTS
                    + sum(-(-(p + 1) // BLOCK) for p in pos_list))
    b_ms, b_by = bound(flops, nbytes)
    print(f"paged_decode S={SLOTS} pos={pos_list} kv_splits={splits}: ms "
          f"{ms:.4f} (kernel alone {kernel_ms:.4f})  plain_ms "
          f"{plain_ms:.4f}  bound_ms {b_ms:.4f} ({b_by})", flush=True)
    return max_err, dict(ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, kv_splits=splits,
                         pos=pos_list)


# -------------------------------------------------------------- main path
def random_values(seed: int) -> dict:
    """The full-width LM's parameter tree under the JAX package's names,
    N(0, 0.02) matrices, unit LayerNorm scales, zero biases."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * 0.02

    def ln():
        return {"scale": np.ones(DIM, np.float32),
                "bias": np.zeros(DIM, np.float32)}

    hid = DIM * FFN_MULT
    vals = {"tok_emb": {"w": normal(VOCAB, DIM)},
            "pos_emb": {"w": normal(MAX_LEN, DIM)}}
    for i in range(LAYERS):
        vals[f"ln1_{i}"] = ln()
        vals[f"attn_{i}"] = {n: normal(DIM, DIM)
                             for n in ("wq", "wk", "wv", "wo")}
        vals[f"ln2_{i}"] = ln()
        vals[f"ffn_up{i}"] = {"w0": normal(DIM, hid),
                              "b": np.zeros(hid, np.float32)}
        vals[f"ffn_down{i}"] = {"w0": normal(hid, DIM),
                                "b": np.zeros(DIM, np.float32)}
    vals["ln_f"] = ln()
    vals["logits"] = {"w0": normal(DIM, VOCAB),
                      "b": np.zeros(VOCAB, np.float32)}
    return vals


def prompts():
    rng = np.random.RandomState(SEED)
    shared = rng.randint(0, VOCAB, size=64)
    out = [rng.randint(0, VOCAB, size=n) for n in (5, 17, 200, 513, 1000,
                                                   1500)]
    out.insert(2, np.concatenate([shared, rng.randint(0, VOCAB, size=7)]))
    out.insert(3, np.concatenate([shared, rng.randint(0, VOCAB, size=30)]))
    return [p.astype(np.int32) for p in out]


def post(url, doc, timeout=900):
    req = urllib.request.Request(url + "/infer",
                                 data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def reference_streams(dec, reqs):
    """Each prompt decoded alone through ``dec`` (the plain-PyTorch path
    on the card); per token, the top-2 logit margin of the step that
    chose it."""
    out = []
    for p in reqs:
        toks = [dec.prefill(0, p)]
        margins = [dec.last_logits[1]]
        pos = len(p)
        for _ in range(MAX_TOKENS - 1):
            toks.append(int(dec.step(1, [toks[-1]], [pos])[0]))
            margins.append(dec.last_logits[0][0])
            pos += 1
        dec.release_sequence(0)
        top2 = [torch.topk(m, 2).values for m in margins]
        out.append((toks, [float(t[0] - t[1]) for t in top2]))
    return out


def iteration_ms(dec, reqs):
    """Host-clock median of one mixed iteration at full residency (8 rows
    decoding just past their prompts), alone and with the longest
    prompt's prefill chunk fused in.  Leaves the decoder reset."""
    dec.reset()
    pos = np.array([len(p) + MAX_TOKENS // 2 for p in reqs], np.int32)
    for s, p in enumerate(reqs):
        dec.alloc_sequence(s, p)
        dec.ensure_blocks(s, int(pos[s]))
    toks = np.ones(SLOTS, np.int32)
    live = np.ones(SLOTS, bool)

    def median_ms(chunk):
        times = []
        for i in range(13):
            t0 = time.perf_counter()
            dec.mixed_step(SLOTS, toks, pos, live=live, chunk=chunk)
            torch.cuda.synchronize()
            if i >= 3:                                # 3 warm-up calls
                times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[len(times) // 2]

    decode = median_ms(None)
    longest = int(np.argmax([len(p) for p in reqs]))
    chunk = median_ms((longest, reqs[longest], 0))
    dec.reset()
    return decode, chunk


def main_path():
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.io import checkpoint
    from paddle_tpu_torch.models.transformer import (PagedDecoder,
                                                     params_from_jax)
    from paddle_tpu_torch.serving import InferenceEngine

    with tempfile.TemporaryDirectory(prefix="ptt_smoke_") as tmp:
        t0 = time.perf_counter()
        checkpoint.save_params(tmp, random_values(SEED))
        snap = checkpoint.load(tmp)
        model = params_from_jax(checkpoint.params_of(snap), num_heads=HEADS)
        print(f"checkpoint written and loaded in "
              f"{time.perf_counter() - t0:.1f}s: "
              f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M "
              f"float32 parameters", flush=True)
    decoder = PagedDecoder(model, max_slots=SLOTS, block_size=BLOCK,
                           device="cuda")
    print(f"PagedDecoder: {decoder.num_blocks} blocks of {BLOCK}, chunk "
          f"buckets {decoder.chunk_buckets}, pool "
          f"{2 * LAYERS * decoder._caches[0][0].numel() * 4 / 1e9:.2f} GB",
          flush=True)
    engine = InferenceEngine(decoder, default_max_tokens=MAX_TOKENS)
    reqs = prompts()
    try:
        url = f"http://127.0.0.1:{engine.serve(0).server_address[1]}"
        results = [None] * len(reqs)

        def call(i):
            results[i] = post(url, {"input": [reqs[i].tolist()],
                                    "max_tokens": MAX_TOKENS})

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(reqs))]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        engine.close()
    if any(t.is_alive() for t in threads):
        raise AssertionError("an HTTP request did not finish")
    for i, (code, body) in enumerate(results):
        toks = body["outputs"]["tokens"]
        if code != 200 or len(toks) != MAX_TOKENS \
                or not all(0 <= t < VOCAB for t in toks):
            raise AssertionError(f"request {i}: {code} {body}")
    if stats["kernels"] != launches or min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched on the main "
                             f"path: {launches} (/stats {stats['kernels']})")
    gen = sum(len(b["outputs"]["tokens"]) for _, b in results)
    print(f"main path: {len(reqs)} HTTP requests, prompts "
          f"{[len(p) for p in reqs]}, {gen} tokens in {wall:.2f}s = "
          f"{gen / wall:.1f} tokens/s; iterations {stats['iterations']}, "
          f"prefix hits {stats['prefix_hits']}, ttft_us p50 "
          f"{stats['ttft_us']['p50']:.0f} max {stats['ttft_us']['max']:.0f} "
          f"(smoke figure, not a benchmark); launches {launches}",
          flush=True)

    t0 = time.perf_counter()
    ref_dec = PagedDecoder(model, max_slots=SLOTS, block_size=BLOCK,
                           decode_kernel="torch", device="cuda")
    ref = reference_streams(ref_dec, reqs)
    print(f"plain-PyTorch reference run: {time.perf_counter() - t0:.1f}s",
          flush=True)
    near_ties = 0
    for i, ((code, body), (rtoks, margins)) in enumerate(zip(results, ref)):
        toks = body["outputs"]["tokens"]
        if toks == rtoks:
            continue
        j = next(j for j, (a, b) in enumerate(zip(toks, rtoks)) if a != b)
        if margins[j] >= TOL:
            raise AssertionError(
                f"request {i} diverges from the plain path at token {j} "
                f"where its top-2 margin is {margins[j]:.3e} >= {TOL}")
        near_ties += 1
        print(f"request {i}: diverges at token {j}, a near tie (top-2 "
              f"margin {margins[j]:.3e} < {TOL}) - reported, not failed",
              flush=True)
    print(f"streams equal to the plain path: {len(reqs) - near_ties} of "
          f"{len(reqs)}", flush=True)
    iters = {"kernels": iteration_ms(decoder, reqs),
             "plain": iteration_ms(ref_dec, reqs)}
    for name, (dec_ms, chunk_ms) in iters.items():
        print(f"mixed iteration, {SLOTS} residents, {name} path: decode "
              f"only {dec_ms:.3f} ms; with a {max(map(len, reqs))}-token "
              f"prefill chunk {chunk_ms:.3f} ms", flush=True)
    return launches, stats, iters


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from paddle_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    # the plain versions are the reference: full float32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)

    t0 = time.perf_counter()
    logs = _build.build(["flash_fwd", "paged_decode"])
    print(f"built both kernels in {time.perf_counter() - t0:.1f}s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "Compiling entry")):
                print(f"[{name}] {line.strip()}", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > L2
    flash_err, flash_t = flash_phase(dev, gen, flush)
    paged_err, paged_t = paged_phase(dev, gen, flush)
    del flush
    torch.cuda.empty_cache()

    launches, _, iters = main_path()
    share = LAYERS * paged_t["kernel_ms"] / iters["kernels"][0]
    print(f"paged_decode kernel launches (alone, timed above) cover about "
          f"{share:.1%} of a decode-only iteration", flush=True)
    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "paddle_tpu_torch/ops/csrc/flash_fwd.cu",
         "replaces": "paddle_tpu/ops/flash_attention.py:90",
         "launches": launches["flash_fwd"], "max_abs_err": flash_err,
         "ms": flash_t["ms"], "plain_ms": flash_t["plain_ms"],
         "bound_ms": flash_t["bound_ms"], "bound_by": flash_t["bound_by"],
         "library_ms": flash_t["library_ms"],
         "shape": {"B": 1, "H": HEADS, "D": DIM // HEADS,
                   "Lq": flash_t["lq"], "Lk": MAX_LEN, "causal": True,
                   "q_offset": flash_t["q_offset"]}},
        {"name": "paged_decode", "route": "cuda",
         "source": "paddle_tpu_torch/ops/csrc/paged_decode.cu",
         "replaces": "paddle_tpu/ops/paged_attention.py:59",
         "launches": launches["paged_decode"], "max_abs_err": paged_err,
         "ms": paged_t["ms"], "kernel_ms": paged_t["kernel_ms"],
         "plain_ms": paged_t["plain_ms"], "bound_ms": paged_t["bound_ms"],
         "bound_by": paged_t["bound_by"], "library_ms": None,
         "shape": {"S": SLOTS, "H": HEADS, "D": DIM // HEADS, "BS": BLOCK,
                   "MB": MAX_LEN // BLOCK, "NB": 1 + SLOTS * MAX_LEN // BLOCK,
                   "pos": paged_t["pos"], "kv_splits": paged_t["kv_splits"]}},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
