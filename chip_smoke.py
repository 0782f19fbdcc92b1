#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

Usage: ``python3 chip_smoke.py`` from the root of a checkout, on a machine
with an NVIDIA H100 and the CUDA toolkit.  Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build the three CUDA kernel sources (``ops/csrc/*.cu``: flash forward,
   flash backward, paged decode; one ``nvcc`` each, in parallel) and print
   ptxas' register / shared-memory / spill lines;
3. hold each kernel against its plain PyTorch version at the main paths'
   full-width shapes (float32): the forward and the decode kernel within
   max |error| <= 1e-4; the backward kernels' dQ, dK and dV against
   autograd through the plain attention within 1e-4 * max(1, max |ref|)
   each (the training shape [8, 4096, 4, 128] causal, a kv_lens case, an
   offset-causal case, a cross-attention case, a return_lse case with a
   nonzero LSE cotangent);
4. time kernel, plain version and the library call (the forward and
   backward of ``F.scaled_dot_product_attention``, a yardstick the port
   never calls), with CUDA events, L2 flushed between launches, each
   beside its bound;
5. the serving path: the full-width transformer LM (vocab 32000, dim 512,
   4 x 128 heads, 8 layers, max_len 4096; random weights from a numpy
   seed) written as a checkpoint, loaded, and served through
   ``PagedDecoder`` + ``InferenceEngine`` over HTTP; 8 concurrent requests
   of 32 tokens; the flash forward and paged decode counters must move,
   and every stream must equal a plain-PyTorch (``decode_kernel="torch"``)
   run on the card except where that run's top-2 logit margin was below
   1e-4 (reported);
6. the training path: the same LM built with the layer DSL
   (``transformer.build``) from the same seeded weights.  At batch 1 the
   kernel path and the plain attention (``attention_impl="torch"``) agree
   on the first loss (1e-5 relative), every parameter gradient
   (1e-4 * max(1, max |g|)) and a 3-step Adam trajectory (1e-4 relative).
   Then ``trainer.SGD.train`` takes TRAIN_STEPS Adam steps (lr 1e-4) at
   batch 8 x 4096 on a fixed seeded set of sequences whose targets are the
   tokens shifted by one: every loss finite, the last below the first, and
   each attention kernel launched 8 times a step.  One more step is split
   by CUDA events into attention kernels, dense products, loss, optimizer
   and the rest, and one is traced by ``torch.profiler`` for the device's
   idle share.  The trained ``Parameters`` then serve one greedy request
   through ``PagedDecoder``;
7. one JSON line listing each kernel's numbers, then the card line again
   and, last, ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout.  The tokens/s, time-to-first-token and training step time it
prints are a smoke figure, not a benchmark.
"""

from __future__ import annotations

import json
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
TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 8, 6, 1e-4
SERVE_KERNELS = ("flash_fwd", "paged_decode")
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")


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


# ---------------------------------------------------------- flash backward
def _attn_grads(fa, q, k, v, lens, go, gl, kw, impl):
    """dQ, dK, dV of sum(O * go) (+ sum(LSE * gl)) through
    ``flash_attention`` on ``impl``."""
    qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
    o, lse = fa.flash_attention(*qkv, kv_lens=lens, return_lse=True,
                                impl=impl, **kw)
    obj = (o * go).sum()
    if gl is not None:
        obj = obj + (lse * gl).sum()
    return torch.autograd.grad(obj, qkv)


def flash_bwd_phase(dev, gen, flush):
    """Hold the backward kernels against autograd through the plain
    attention, then time forward, dK/dV and dQ at the training shape
    beside the plain version and the library call."""
    from paddle_tpu_torch.ops import flash_attention as fa

    D = DIM // HEADS
    # name, B, Lq, Lk, causal, kv_lens, q_offset, kv_offset, LSE cotangent
    cases = [
        ("training shape", TRAIN_BATCH, MAX_LEN, MAX_LEN, True, None, 0, 0,
         False),
        ("kv_lens", 4, 1024, 1024, True, [1024, 700, 333, 65], 0, 0, False),
        ("offset causal", 2, 512, 1536, True, None, 1000, 200, False),
        ("cross attention", 2, 300, 1100, False, None, 0, 0, False),
        ("return_lse", 2, 1024, 1024, True, None, 0, 0, True),
    ]
    errs = {"dq": [0.0, 0.0], "dkdv": [0.0, 0.0]}   # max abs, max relative
    for name, b, lq, lk, causal, lens, qo, ko, with_lse in cases:
        q = torch.randn(b, lq, HEADS, D, device=dev, generator=gen)
        k = torch.randn(b, lk, HEADS, D, device=dev, generator=gen)
        v = torch.randn(b, lk, HEADS, D, device=dev, generator=gen)
        go = torch.randn(b, lq, HEADS, D, device=dev, generator=gen)
        gl = (torch.randn(b, HEADS, lq, device=dev, generator=gen)
              if with_lse else None)
        lens_t = torch.tensor(lens or [lk] * b, dtype=torch.int32,
                              device=dev)
        kw = dict(causal=causal, scale=D ** -0.5, q_offset=qo,
                  kv_offset=ko)
        got = _attn_grads(fa, q, k, v, lens_t, go, gl, kw, "cuda")
        ref = _attn_grads(fa, q, k, v, lens_t, go, gl, kw, "torch")
        torch.cuda.synchronize()
        line = []
        for gname, a, r in zip(("dq", "dk", "dv"), got, ref):
            err = (a - r).abs().max().item()
            rel = err / max(1.0, r.abs().max().item())
            key = "dq" if gname == "dq" else "dkdv"
            errs[key] = [max(errs[key][0], err), max(errs[key][1], rel)]
            line.append(f"{gname} {err:.3e} ({rel:.2e} of max(1, |ref|))")
            if not (rel <= TOL and torch.isfinite(a).all()):
                raise AssertionError(
                    f"flash_bwd {name}: {gname} disagrees with autograd "
                    f"through the plain version: {rel} > {TOL}")
        print(f"flash_bwd {name} [B {b}, Lq {lq}, Lk {lk}, causal "
              f"{causal}, kv_lens {lens}, q_offset {qo}, kv_offset {ko}, "
              f"g_lse {with_lse}]: " + ", ".join(line), flush=True)
        del got, ref

    B, T = TRAIN_BATCH, MAX_LEN
    q, k, v, go = (torch.randn(B, T, HEADS, D, device=dev, generator=gen)
                   for _ in range(4))
    lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    kw = dict(causal=True, scale=D ** -0.5)
    o, lse = fa.flash_fwd_cuda(q, k, v, lens, **kw)
    delta = (go * o).sum(-1).transpose(1, 2).contiguous()
    t = {"fwd": time_ms(lambda: fa.flash_fwd_cuda(q, k, v, lens, **kw),
                        flush),
         "dkdv": time_ms(lambda: fa.flash_bwd_dkdv_cuda(
             q, k, v, go, lse, delta, lens, **kw), flush),
         "dq": time_ms(lambda: fa.flash_bwd_dq_cuda(
             q, k, v, go, lse, delta, lens, **kw), flush)}
    # the plain version: its forward, and autograd's backward through it
    # (one backward computes dQ, dK and dV)
    with torch.no_grad():
        t["plain_fwd"] = time_ms(
            lambda: fa._torch_attention(q, k, v, lens, **kw), flush,
            iters=5, warmup=1)
    qkv = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = fa._torch_attention(*qkv, lens, **kw)
    t["plain_bwd"] = time_ms(lambda: torch.autograd.grad(
        out, qkv, go, retain_graph=True), flush, iters=5, warmup=1)
    del out
    # the library yardstick on [B, H, T, D] views, never called by the port
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt = [x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v)]
    with torch.no_grad():
        t["lib_fwd"] = time_ms(lambda: sdpa(*qt, is_causal=True,
                                            scale=kw["scale"]), flush)
    so = sdpa(*qt, is_causal=True, scale=kw["scale"])
    t["lib_bwd"] = time_ms(lambda: torch.autograd.grad(
        so, qt, go.transpose(1, 2), retain_graph=True), flush)
    del so

    pairs = B * HEADS * T * (T + 1) // 2      # visible (q, k) pairs, causal
    row = 4.0 * B * T * HEADS * D             # one [B, T, H, D] float32
    vec = 4.0 * B * HEADS * T                 # one [B, H, T] float32
    bounds = {"fwd": bound(4.0 * D * pairs, 4 * row + vec + 4 * B),
              "dkdv": bound(8.0 * D * pairs, 6 * row + 2 * vec + 4 * B),
              "dq": bound(6.0 * D * pairs, 5 * row + 2 * vec + 4 * B)}
    for name in ("fwd", "dkdv", "dq"):
        plain, lib = (("plain_fwd", "lib_fwd") if name == "fwd"
                      else ("plain_bwd", "lib_bwd"))
        print(f"flash {name} at [{B}, {T}, {HEADS}, {D}] causal: ms "
              f"{t[name]:.4f}  bound_ms {bounds[name][0]:.4f} "
              f"({bounds[name][1]})  plain_ms {t[plain]:.4f}  library_ms "
              f"(scaled_dot_product_attention "
              f"{'forward' if name == 'fwd' else 'backward'}) "
              f"{t[lib]:.4f}", flush=True)

    def entry(name, plain, lib, err=None):
        d = dict(ms=t[name], plain_ms=t[plain], bound_ms=bounds[name][0],
                 bound_by=bounds[name][1], library_ms=t[lib])
        if err is not None:
            d.update(max_abs_err=err[0], max_rel_err=err[1])
        return d

    return {"shape": {"B": B, "Lq": T, "Lk": T, "H": HEADS, "D": D,
                      "causal": True},
            "fwd": entry("fwd", "plain_fwd", "lib_fwd"),
            "dkdv": entry("dkdv", "plain_bwd", "lib_bwd", errs["dkdv"]),
            "dq": entry("dq", "plain_bwd", "lib_bwd", errs["dq"])}


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
    if stats["kernels"] != launches or min(
            launches[k] for k in SERVE_KERNELS) < 1:
        raise AssertionError(f"a kernel was not launched on the serving "
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


# ----------------------------------------------------------- training path
def _train_model():
    """The LM's training graph through the port's DSL."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.ir import reset_name_counters
    from paddle_tpu_torch.models import transformer

    reset_name_counters()
    paddle.init(seed=SEED)
    cost, _ = transformer.build(vocab_size=VOCAB, max_len=MAX_LEN, dim=DIM,
                                num_heads=HEADS, num_layers=LAYERS,
                                ffn_mult=FFN_MULT)
    return paddle, paddle.Topology(cost)


def _trainer(paddle, topo, values):
    params = paddle.parameters.from_numpy(topo, values)
    return paddle.trainer.SGD(topo, params,
                              paddle.optimizer.Adam(learning_rate=TRAIN_LR))


def trainer_feed(tokens, targets):
    """The feed the DataFeeder builds for the training batch."""
    lens = np.full(len(tokens), tokens.shape[1], np.int32)
    return {"tokens": tokens, "tokens@len": lens, "targets": targets,
            "targets@len": lens}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def train_parity(paddle, topo, values, tokens, targets):
    """Batch 1, from the same weights: the kernel path against the plain
    attention (``attention_impl="torch"``) on the card - the first loss,
    every parameter gradient, and a 3-step Adam trajectory."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.core import config

    feed = {"tokens": tokens[:1], "targets": targets[:1]}
    runs = {}
    for impl in (None, "torch"):
        config.set_option("attention_impl", impl)
        try:
            ops.reset_launch_counts()
            tr = _trainer(paddle, topo, values)
            loss, grads = tr.forward_backward(feed)
            losses = []
            tr.train(lambda: iter([feed] * 3), event_handler=lambda e: (
                losses.append(e.cost)
                if isinstance(e, paddle.event.EndIteration) else None))
            runs[impl] = (float(loss), grads, losses)
            del tr
        finally:
            config.set_option("attention_impl", None)
        # 1 + 3 forward-backward passes of LAYERS attention layers each
        want = 0 if impl == "torch" else 4 * LAYERS
        if any(n != want for k, n in ops.launch_counts().items()
               if k in TRAIN_KERNELS):
            raise AssertionError(f"attention_impl={impl!r}: launches "
                                 f"{ops.launch_counts()}, expected {want} "
                                 f"of each attention kernel")
    (loss_k, grads_k, traj_k), (loss_t, grads_t, traj_t) = (runs[None],
                                                             runs["torch"])
    if not _rel(loss_k, loss_t) <= 1e-5:
        raise AssertionError(f"first loss: kernel path {loss_k} vs plain "
                             f"{loss_t}")
    worst = (0.0, "")
    for lname, ps in grads_t.items():
        for pname, ref in ps.items():
            rel = ((grads_k[lname][pname] - ref).abs().max().item()
                   / max(1.0, ref.abs().max().item()))
            worst = max(worst, (rel, f"{lname}.{pname}"))
    if not worst[0] <= TOL:
        raise AssertionError(f"gradient {worst[1]}: kernel path vs plain "
                             f"{worst[0]} > {TOL} of max(1, max |g|)")
    traj = max(_rel(a, b) for a, b in zip(traj_k, traj_t))
    if len(traj_k) != 3 or not traj <= TOL:
        raise AssertionError(f"Adam trajectory: kernel path {traj_k} vs "
                             f"plain {traj_t}")
    print(f"training parity at batch 1 x {MAX_LEN}: first loss {loss_k:.6f}"
          f" vs plain {loss_t:.6f} ({_rel(loss_k, loss_t):.2e} relative); "
          f"worst gradient {worst[1]} at {worst[0]:.2e} of max(1, max |g|)"
          f"; 3-step Adam losses {[round(x, 6) for x in traj_k]} vs "
          f"{[round(x, 6) for x in traj_t]} ({traj:.2e} relative)",
          flush=True)
    return {"loss_rel": _rel(loss_k, loss_t), "grad_rel": worst[0],
            "traj_rel": traj}


def _gemm_ms(n, din, dout, dev, gen):
    """CUDA-event time of one fc's three products at N rows: y = x W, and
    the backward's dx = dy W^T and dW = x^T dy (full float32)."""
    x = torch.randn(n, din, device=dev, generator=gen)
    w = torch.randn(din, dout, device=dev, generator=gen)
    dy = torch.randn(n, dout, device=dev, generator=gen)
    fns = (lambda: x @ w, lambda: dy @ w.T, lambda: x.T @ dy)
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        for fn in fns:
            fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 3


def step_breakdown(trainer, feed, attn_ms):
    """Where one full-width training step's device time goes, from CUDA
    events: the whole step, forward + backward, the optimizer update, the
    loss (``_SoftmaxNLL`` forward and backward on logits of the step's
    shape), the dense products (each fc's three products at the step's
    shapes, times their count) and the attention kernels (their times at
    the training shape, times LAYERS); the rest is elementwise work and
    gaps.  Then ``torch.profiler`` over one more step, for the device's
    busy share and the kernels by device time."""
    from paddle_tpu_torch.layers.cost import _SoftmaxNLL

    dev = trainer.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    loss, grads = trainer.forward_backward(feed)
    ev[1].record()
    trainer.optimizer.update(trainer._trainable, grads, trainer._opt_state,
                             trainer.parameters.meta)
    ev[2].record()
    torch.cuda.synchronize()
    del grads
    fb_ms, upd_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    n = TRAIN_BATCH * MAX_LEN
    logits = torch.randn(n, VOCAB, device=dev, generator=gen,
                         requires_grad=True)
    labels = torch.randint(0, VOCAB, (n,), device=dev, generator=gen)
    torch.cuda.synchronize()
    ev[0].record()
    torch.autograd.grad(_SoftmaxNLL.apply(logits, labels).mean(), logits)
    ev[1].record()
    torch.cuda.synchronize()
    loss_ms = ev[0].elapsed_time(ev[1])
    del logits
    hid = DIM * FFN_MULT
    dense = {(DIM, DIM): 4 * LAYERS, (DIM, hid): LAYERS,
             (hid, DIM): LAYERS, (DIM, VOCAB): 1}
    dense_ms = sum(count * _gemm_ms(n, a, b, dev, gen)
                   for (a, b), count in dense.items())
    attn = LAYERS * attn_ms
    step = fb_ms + upd_ms
    parts = {"attention kernels": attn, "dense products": dense_ms,
             "loss": loss_ms, "optimizer": upd_ms,
             "rest (elementwise, embedding, gaps)":
                 step - attn - dense_ms - loss_ms - upd_ms}
    print(f"step breakdown (CUDA events): step {step:.1f} ms = forward + "
          f"backward {fb_ms:.1f} + update {upd_ms:.1f}; " + "; ".join(
              f"{k} {v:.1f} ms ({v / step:.0%})" for k, v in parts.items()),
          flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ev[0].record()
        trainer._step(feed)
        ev[1].record()
        torch.cuda.synchronize()
    wall = ev[0].elapsed_time(ev[1])
    # the device's own activity (kernels, copies, fills), not the host ops
    # that launched it; busy = the union of their intervals
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end_us = 0.0, float("-inf")
    for start, stop in spans:
        busy_us += max(0.0, stop - max(start, end_us))
        end_us = max(end_us, stop)
    busy = busy_us / 1e3
    if busy:
        share = max(0.0, 1.0 - busy / wall)
        per_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                ms, n = per_name.get(e.name, (0.0, 0))
                per_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3,
                                    n + 1)
        top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:10]
        print(f"torch.profiler: device busy {busy:.1f} of {wall:.1f} ms, "
              f"idle share {share:.1%}; top kernels: " + "; ".join(
                  f"{name[:60]} x{n} {ms:.1f} ms"
                  for name, (ms, n) in top), flush=True)
    else:
        share = None
        print("torch.profiler saw no device time: idle share not measured",
              flush=True)
    return dict(parts, step_ms=step, forward_backward_ms=fb_ms,
                idle_share=share)


def train_path(attn_ms):
    """The training main path at full width: ``trainer.SGD.train`` at
    batch TRAIN_BATCH x MAX_LEN, then the hand-over to serving."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.models.transformer import (PagedDecoder,
                                                     params_from_jax)

    paddle, topo = _train_model()
    values = random_values(SEED)
    seqs = np.random.RandomState(SEED + 1).randint(
        0, VOCAB, size=(TRAIN_BATCH, MAX_LEN + 1)).astype(np.int32)
    tokens, targets = seqs[:, :-1], seqs[:, 1:]
    parity = train_parity(paddle, topo, values, tokens, targets)
    torch.cuda.empty_cache()

    trainer = _trainer(paddle, topo, values)

    def samples():
        for _ in range(TRAIN_STEPS):
            yield from zip(tokens, targets)

    losses, step_s = [], []

    def handler(e):
        if isinstance(e, paddle.event.BeginIteration):
            torch.cuda.synchronize()
            step_s.append(time.perf_counter())
        elif isinstance(e, paddle.event.EndIteration):
            losses.append(e.cost)          # reading it waits for the step
            step_s[-1] = time.perf_counter() - step_s[-1]

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    trainer.train(paddle.batch(samples, TRAIN_BATCH), num_passes=1,
                  event_handler=handler,
                  feeding={"tokens": 0, "targets": 1})
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if (len(losses) != TRAIN_STEPS
            or not all(np.isfinite(x) for x in losses)
            or not losses[-1] < losses[0]):
        raise AssertionError(f"training losses not finite and falling: "
                             f"{losses}")
    want = LAYERS * TRAIN_STEPS
    if any(launches[k] != want for k in TRAIN_KERNELS):
        raise AssertionError(f"the attention kernels did not run "
                             f"{LAYERS} times a step: {launches}")
    warm = sorted(step_s[1:])[len(step_s[1:]) // 2]
    print(f"training path: {TRAIN_STEPS} Adam steps (lr {TRAIN_LR}) at "
          f"batch {TRAIN_BATCH} x {MAX_LEN}, losses "
          f"{[round(x, 5) for x in losses]}; step time first "
          f"{step_s[0] * 1e3:.1f} ms, median after it {warm * 1e3:.1f} ms "
          f"= {TRAIN_BATCH * MAX_LEN / warm:.0f} tokens/s (smoke figure, "
          f"not a benchmark); peak memory {peak_gb:.2f} GB; launches "
          f"{launches}", flush=True)

    breakdown = step_breakdown(trainer, trainer_feed(tokens, targets),
                               attn_ms)

    # hand-over: the trained Parameters serve through PagedDecoder, and
    # its first token is the training graph's argmax at the prompt's end
    prompt = tokens[0][:MAX_LEN // 2]
    with torch.no_grad():
        outs, _ = topo.forward(trainer.parameters.values, {},
                               {"tokens": prompt[None],
                                "targets": prompt[None]},
                               outputs=["logits"])
    top2 = torch.topk(outs["logits"][0, -1], 2).values
    model = params_from_jax(trainer.parameters, num_heads=HEADS)
    dec = PagedDecoder(model, max_slots=1, block_size=BLOCK,
                       device=trainer.device)
    stream = [dec.prefill(0, prompt)]
    for pos in range(len(prompt), len(prompt) + MAX_TOKENS - 1):
        stream.append(int(dec.step(1, [stream[-1]], [pos])[0]))
    dec.release_sequence(0)
    want_first = int(torch.argmax(outs["logits"][0, -1]))
    if not all(0 <= x < VOCAB for x in stream) or (
            stream[0] != want_first and float(top2[0] - top2[1]) >= TOL):
        raise AssertionError(f"served stream {stream[:4]}... does not start "
                             f"with the training graph's {want_first}")
    print(f"hand-over: the trained parameters served {len(stream)} greedy "
          f"tokens through PagedDecoder, first {stream[0]} (training "
          f"graph's argmax {want_first})", flush=True)
    return {"launches": launches, "losses": losses, "step_ms": warm * 1e3,
            "first_step_ms": step_s[0] * 1e3, "peak_gb": peak_gb,
            "parity": parity, "breakdown": breakdown}


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
    logs = _build.build(["flash_fwd", "flash_bwd", "paged_decode"])
    print(f"built {len(logs)} kernel sources in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
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
    bwd = flash_bwd_phase(dev, gen, flush)
    del flush
    torch.cuda.empty_cache()

    launches, _, iters = main_path()
    share = LAYERS * paged_t["kernel_ms"] / iters["kernels"][0]
    print(f"paged_decode kernel launches (alone, timed above) cover about "
          f"{share:.1%} of a decode-only iteration", flush=True)
    torch.cuda.empty_cache()
    train = train_path(bwd["fwd"]["ms"] + bwd["dkdv"]["ms"]
                       + bwd["dq"]["ms"])
    tl = train["launches"]
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
                   "q_offset": flash_t["q_offset"]},
         "launches_train": tl["flash_fwd"],
         "train_shape": dict(bwd["fwd"], shape=bwd["shape"])},
        {"name": "flash_bwd_dkdv", "route": "cuda",
         "source": "paddle_tpu_torch/ops/csrc/flash_bwd.cu",
         "replaces": "paddle_tpu/ops/flash_attention.py:285",
         "launches": tl["flash_bwd_dkdv"], **bwd["dkdv"],
         "shape": bwd["shape"]},
        {"name": "flash_bwd_dq", "route": "cuda",
         "source": "paddle_tpu_torch/ops/csrc/flash_bwd.cu",
         "replaces": "paddle_tpu/ops/flash_attention.py:370",
         "launches": tl["flash_bwd_dq"], **bwd["dq"],
         "shape": bwd["shape"]},
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
    print(json.dumps({"training": {
        k: train[k] for k in ("losses", "first_step_ms", "step_ms",
                              "peak_gb", "parity", "breakdown")}}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
