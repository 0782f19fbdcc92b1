#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

Usage: ``python3 chip_smoke.py`` from the root of a checkout, on a machine
with an NVIDIA H100 and the CUDA toolkit.  Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build the seven CUDA kernel sources (``ops/csrc/*.cu``: flash forward,
   flash backward, paged decode, the LSTM and GRU steps, the batch-norm
   statistics, the conv + statistic products, the forward sweep's
   tensor-core variants; one ``nvcc`` each, in parallel) and print ptxas'
   register / shared-memory / spill lines;
3. hold each kernel against its plain PyTorch version at the main paths'
   full-width shapes (float32): the forward and the decode kernel within
   max |error| <= 1e-4; the backward kernels' dQ, dK and dV against
   autograd through the plain attention within 1e-4 * max(1, max |ref|)
   each (the training shape [8, 4096, 4, 128] causal, a kv_lens case, an
   offset-causal case, a cross-attention case, a return_lse case with a
   nonzero LSE cotangent); the LSTM step (B 128, H 512) and the GRU step
   (B 256, H 512), each with a mask of about 30% zeros and at two ragged
   shapes, on h' (and c') and on the autograd.Function's gradients of
   every input but the mask, within 1e-4 * max(1, max |ref|), masked rows
   copied bit for bit; the conv kernels (7a, 7b: the batch-norm
   statistic passes; 8, 9: the 1x1 and 3x3 convs with the statistics in
   their epilogue) at every distinct shape ResNet-50 gives them at batch
   128, at ragged shapes and (7a, 7b) at rank 2, on y, sum, sum of
   squares, sum dy and sum dy * xhat within 1e-4 * max(1, max |ref|);
   7b's relu boundary (folds exactly 0 are dropped as the forward drops
   them); the autograd Functions' gradients against autograd through the
   plain versions; kernel 1 on bf16 q/k/v (O bf16, LSE float32) at the
   forward sweep's shape [8, 4096, 8, 64] and the LM shape
   [8, 4096, 4, 128], causal, against the plain attention on the float32
   upcast with O rounded to bf16, and every variant of the sweep
   (``ops/flash_variants.py``: bf16 dots, exp2, split, pipelined, each at
   two tiles; the f32-dot instances at kernel 1's tile) at both shapes
   against its plain version at the same block_k, each launch moving the
   counter: each row of O within 2^-7 of its norm (every element within
   one bf16 ulp) and O within 2^-6 * max(1, max |ref|), LSE within
   1e-4 * max(1, max |ref|); at both shapes a planted fault (the first 64
   keys' P . V left out of the last 64 rows) must fail the O check;
4. time kernel, plain version and the library call (the forward and
   backward of ``F.scaled_dot_product_attention``, a yardstick the port
   never calls; for the recurrent steps, which no one PyTorch call
   computes, the cuBLAS product alone, ``torch.addmm``, as the product's
   floor; for the conv kernels ``torch.var_mean``,
   ``torch.batch_norm_backward_reduce``, ``torch.mm`` alone and
   ``F.conv2d`` alone; for kernel 1 at bf16 and the sweep's variants
   ``F.scaled_dot_product_attention`` at bf16; the sweep's own rows are
   timed by the sweep, phase 10), with CUDA events, L2
   flushed between launches, each beside its bound (float32 FMAs at 67
   TFLOP/s, bf16 tensor cores at 989 TFLOP/s, or bytes at 3.35 TB/s);
5. the serving path: the full-width transformer LM (vocab 32000, dim 512,
   4 x 128 heads, 8 layers, max_len 4096; random weights from a numpy
   seed) written as a checkpoint, loaded, and served through
   ``PagedDecoder`` + ``InferenceEngine`` over HTTP; 8 concurrent requests
   of 32 tokens; the flash forward and paged decode counters must move,
   and every stream must equal a plain-PyTorch (``decode_kernel="torch"``)
   run on the card except where that run's top-2 logit margin was below
   1e-4 (reported);
6. the LM training path: the same LM built with the layer DSL
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
7. the NMT training path: ``seq2seq.build`` at ``bench_nmt``'s widths
   (vocab 30000 both sides, emb/enc/dec 512, src = trg = 50) with weights
   from a numpy seed.  At batch 8 on a padded feed (one length-1 row) the
   GRU kernel route and ``use_fused_rnn=False`` agree on the first loss
   (1e-5 relative), every gradient (1e-4 * max(1, max |g|)) and a 3-step
   Adam trajectory (1e-4 relative).  Then NMT_STEPS Adam steps (lr 1e-3)
   at batch 256 x 50 + 50: losses finite and falling, the GRU kernel
   launched 100 times a step (2 directions x 50); a CUDA-event breakdown
   of one step (encoder, decoder group, vocab head + loss, Adam, rest) and
   the ``torch.profiler`` idle share;
8. the LSTM route: ``bench_lstm``'s graph with ``lstmemory(peephole=
   False)`` (embedding 128, 2 x (fc 4h, lstmemory) at h 512, last_seq,
   fc 2; B 128, T 100, Adam 2e-3): the same parity at batch 8, then
   LSTM_STEPS steps with finite losses and the LSTM kernel launched 200
   times a step;
9. the ResNet path: ``resnet.build(depth=50, image_size=224,
   num_classes=1000, space_to_depth=True)`` under ``fuse_conv_bn="all"``
   and ``fused_bn_impl="pallas"`` with seeded weights, TF32 off for cuDNN
   and cuBLAS.  At batch 8 (cuDNN deterministic), each fused conv and
   batch norm on the plain route's own inputs: the kernel route and the
   plain route (``fused_bn_impl`` and every ``conv_bn_impl`` "xla") agree
   on its output and moving statistics (1e-4 * max(1, max |ref|)) and
   gradients (1e-3 * max(1, max |g|)).  End to end they agree on the
   first loss (1e-4 relative), every gradient (1e-3 * max(1, max |g|)),
   the moving statistics after one step (1e-4 * max(1, max |ref|)) and a
   3-step Momentum trajectory (1e-3 relative), each or within twice
   float32's own spread for that number (the plain route on images
   nudged by 2^-22 and on the batch reversed).  Then 4 Momentum
   steps (0.1, 0.9) at batch 128 x 224^2: finite losses, kernels 8 / 9 /
   7a / 7b launched 30 / 16 / 4 / 4 times a step; the step and Momentum
   on CUDA events, the step's device time by part and the idle share
   from ``torch.profiler``; ``SGD.test`` on the trained state (the eval
   branch, no kernel launched);
10. the forward ablation sweep (``paddle_tpu_torch.tools.flash_variants``,
   ``run``) at the JAX tool's shape and ``--shape lm``: its ten rows with
   their times, rates and errors against row A; kernel 1 and the
   variants' wrapper must both launch; each row's time then stands beside
   its bound, plain and library time;
11. the bf16 precision policy: kernels 2 and 3 at bf16 at [8, 4096, 4,
   128] causal (after the float32 backward checks), dQ, dK and dV held per
   row within 2^-7 of the norm against ``_upcast_bwd`` (the Pallas
   kernels' arithmetic, float32 on the bf16 operands) on the forward
   kernel's own O and LSE, a planted fault (the last q tile left out of
   dK/dV) shown to fail that check, the distance to the bf16 plain route
   reported, each timed beside its bound, the plain route's backward and
   SDPA's at bf16; kernels 5 and 6 at each bf16 instance (x bf16, the mask
   float32 or bf16) against the plain step, timed (after the float32
   recurrent checks).  After the LSTM route: the LM under ``bf16`` and
   ``mixed`` (6 Adam steps at 8 x 4096 from the seeded weights, kernels
   1, 2 and 3 launching their bf16 instances 8 times a step, the losses
   within LM_BF16_BAND of the plain route's, the step breakdown, idle
   share and peak memory); NMT and the LSTM route under ``bf16``
   (kernel-route parity at batch 8 within RNN_BF16_TOLS, then their steps
   with kernels 6 and 5 launching 100 and 200 bf16 instances a step);
   ``mixed`` on the card (an inf batch skips the step bit for bit and
   halves the loss scale); ``tools/sass_diff.py`` (the float32 instances
   of ``flash_bwd.cu`` and ``rnn_step.cu`` against the build of their
   sources before the bf16 instances, kept in SASS_BASE);
12. one JSON line each for the LM training, NMT and LSTM, the bf16
   policy, sweep and ResNet runs, the card line again, one JSON line
   listing each kernel's numbers and, last, ``{"ok": true, "device":
   {...}}``.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout.  The tokens/s, time-to-first-token and training step times it
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

try:
    from paddle_tpu_torch.tools import flash_variants as sweep_tool
    from paddle_tpu_torch.tools.timing import (PEAK_BF16_FLOPS,
                                               PEAK_F32_FLOPS, bound,
                                               time_ms)
except ImportError as e:
    sys.exit(f"chip_smoke: run from the root of a checkout ({e})")

TOL = 1e-4
# the serving slice's model: bench.py bench_transformer defaults
VOCAB, DIM, HEADS, LAYERS, FFN_MULT, MAX_LEN = 32000, 512, 4, 8, 4, 4096
SLOTS, BLOCK = 8, 16
MAX_TOKENS = 32
SEED = 1234
TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 8, 6, 1e-4
SERVE_KERNELS = ("flash_fwd", "paged_decode")
# the recurrent slice: bench.py bench_nmt's and bench_lstm's widths
RNN_H = 512
NMT_VOCAB, NMT_DIM, NMT_LEN, NMT_BATCH, NMT_STEPS, NMT_LR = (30000, 512, 50,
                                                             256, 4, 1e-3)
LSTM_LEN, LSTM_BATCH, LSTM_STEPS, LSTM_LR = 100, 128, 3, 2e-3
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
# the conv slice: bench.py bench_resnet's model and optimizer, float32
RESNET_IMAGE, RESNET_CLASSES, RESNET_LR = 224, 1000, 0.1
RESNET_BATCH, RESNET_STEPS, RESNET_PARITY_BATCH = 128, 4, 8


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


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


# ------------------------------------------------ the forward ablation sweep
# O, each row (b, l, h) within 2^-7 of its norm: one bf16 ulp is at most
# 2^-7 of an element, so a row rounded one ulp apart in every element
# passes, while a kernel that leaves one 64-key tile's P . V out of a row of
# N keys moves it by about sqrt(64 / N), 1/8 at N 4096 (_planted_fault);
# and the whole within 2^-6 * max(1, max |ref|).  The LSE is float32
# throughout.
VAR_O_ROW_TOL, VAR_O_TOL, VAR_LSE_TOL = 2.0 ** -7, 2.0 ** -6, 1e-4
# flag sets and tiles that the sweep's rows (sweep_tool.ROWS) do not run,
# held and timed here; the sweep's own rows are held here and timed by the
# sweep.  The f32-dot instances have one tile, kernel 1's 64 x 64.
EXTRA_VARIANTS = (
    ("B bf16 bq64 bk64", dict(bf16_dots=True, block_q=64)),
    ("C bf16+exp2 bq64 bk64", dict(bf16_dots=True, use_exp2=True,
                                   block_q=64)),
    ("bf16+split bq128 bk64", dict(bf16_dots=True, split_loop=True)),
    ("bf16+split bq64 bk64", dict(bf16_dots=True, split_loop=True,
                                  block_q=64)),
    ("f32 bq64 bk64", dict()),
    ("f32+exp2 bq64 bk64", dict(use_exp2=True)),
    ("f32+split bq64 bk64", dict(split_loop=True)),
    ("f32+exp2+split bq64 bk64", dict(use_exp2=True, split_loop=True)),
)


def _o_row_err(o, ref) -> float:
    """Largest ||o_r - ref_r|| / ||ref_r|| over the rows (b, l, h) of O."""
    o, ref = o.float(), ref.float()
    return (torch.linalg.vector_norm(o - ref, dim=-1)
            / torch.linalg.vector_norm(ref, dim=-1).clamp_min(1e-30)
            ).max().item()


def _hold_bf16(what, o, lse, ro, rlse):
    """O and LSE against the plain version's: O's rows within
    VAR_O_ROW_TOL, O within VAR_O_TOL and the LSE within VAR_LSE_TOL of
    max(1, max |ref|).  Returns (max |err| O, O's row error, max |err|
    LSE)."""
    eo = (o.float() - ro.float()).abs().max().item()
    er = _o_row_err(o, ro)
    el = (lse - rlse).abs().max().item()
    so = max(1.0, ro.float().abs().max().item())
    sl = max(1.0, rlse.abs().max().item())
    ok = (er <= VAR_O_ROW_TOL and eo <= VAR_O_TOL * so
          and el <= VAR_LSE_TOL * sl
          and torch.isfinite(o.float()).all() and torch.isfinite(lse).all())
    if not ok:
        raise AssertionError(f"{what} disagrees with its plain version: O "
                             f"row error {er} (limit {VAR_O_ROW_TOL}), O "
                             f"{eo} (limit {VAR_O_TOL * so}), LSE {el} "
                             f"(limit {VAR_LSE_TOL * sl})")
    return eo, er, el


def _planted_fault(q, k, v, ro, rlse, scale, n=64):
    """The plain output ``ro`` (float32 [B, L, H, D]) with the first n
    keys' share of P . V left out of the last n query rows, each key
    weighted exp(s - lse) by the plain LSE ``rlse`` [B, H, L]: what a
    kernel returns that skips one KV tile's product on its last q tile."""
    qs, ks, vs = (x.float().transpose(1, 2)
                  for x in (q[:, -n:], k[:, :n], v[:, :n]))
    w = torch.exp(qs @ ks.transpose(-1, -2) * scale - rlse[:, :, -n:, None])
    bad = ro.clone()
    bad[:, -n:] -= (w @ vs).transpose(1, 2)
    return bad


def variants_phase(dev, gen, flush):
    """Kernel 1 on bf16 operands and every variant of the forward sweep
    (``ops/flash_variants.py``: the sweep's rows and EXTRA_VARIANTS) at the
    JAX tool's shape and the LM's training shape, causal: each held against
    its plain version with its launch counted, and the O check shown to
    reject a planted fault.  Times the plain versions, the library's bf16
    attention and EXTRA_VARIANTS; the sweep times its own rows
    (``sweep_path``, ``merge_sweep_times``)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flash_variants as fv

    sdpa = torch.nn.functional.scaled_dot_product_attention
    extra = {name for name, _ in EXTRA_VARIANTS}
    out = {"kernel1_bf16": {}, "variants": {}, "sdpa_bf16_ms": {},
           "planted_fault": {}}
    for shape in ("tool", "lm"):
        b, h, l, d = sweep_tool.SHAPES[shape]
        q, k, v = (torch.randn(b, l, h, d, device=dev, generator=gen,
                               dtype=torch.bfloat16) for _ in range(3))
        lens = torch.full((b,), l, dtype=torch.int32, device=dev)
        kw = dict(causal=True, scale=d ** -0.5)
        pairs = b * h * l * (l + 1) // 2
        # q, k, v bf16 read once, O bf16 and the LSE float32 written once
        nbytes = 4 * b * l * h * d * 2 + b * h * l * 4
        work = 4.0 * d * pairs

        # kernel 1 on bf16 against the plain version on the float32
        # upcast, O rounded to bf16: the kernel's own arithmetic
        o, lse = fa.flash_fwd_cuda(q, k, v, lens, **kw)
        ro, rlse = fa._torch_attention(q.float(), k.float(), v.float(),
                                       lens, return_lse=True, **kw)
        torch.cuda.synchronize()
        if o.dtype != torch.bfloat16 or lse.dtype != torch.float32:
            raise AssertionError(f"kernel 1 at bf16 gave {o.dtype}, "
                                 f"{lse.dtype}")
        ro16 = ro.to(torch.bfloat16)
        eo, er, el = _hold_bf16(f"flash_fwd bf16 {shape}", o, lse, ro16,
                                rlse)
        bad = _planted_fault(q, k, v, ro, rlse, kw["scale"])
        bad = bad.to(torch.bfloat16)
        fault = dict(row_err=_o_row_err(bad, ro16),
                     max_abs_err=(bad.float() - ro16.float()).abs().max()
                     .item(),
                     whole_limit=VAR_O_TOL * max(
                         1.0, ro16.float().abs().max().item()))
        print(f"planted fault at [{b}, {l}, {h}, {d}] (the first 64 keys' "
              f"P . V left out of the last 64 rows): O row error "
              f"{fault['row_err']:.3e} (limit {VAR_O_ROW_TOL:.3e}), max|err| "
              f"{fault['max_abs_err']:.3e} (whole-tensor limit "
              f"{fault['whole_limit']:.3e})", flush=True)
        if fault["row_err"] <= VAR_O_ROW_TOL:
            raise AssertionError(f"the O check passes a planted fault: "
                                 f"{fault}")
        out["planted_fault"][shape] = fault
        ref_a = o.float()
        del ro, rlse, ro16, bad
        with torch.no_grad():
            plain_ms = time_ms(lambda: fa._torch_attention(q, k, v, lens,
                                                           **kw),
                               flush, iters=3, warmup=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                      scale=kw["scale"]), flush)
        out["sdpa_bf16_ms"][shape] = lib_ms
        b_ms, b_by = bound(work, nbytes)
        shape_d = {"B": b, "L": l, "H": h, "D": d, "causal": True}
        out["kernel1_bf16"][shape] = dict(
            max_abs_err=max(eo, el), o_row_err=er, ms=None,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, shape=shape_d)
        print(f"flash_fwd bf16 at [{b}, {l}, {h}, {d}] causal: max|err| O "
              f"{eo:.3e} (row {er:.3e}) LSE {el:.3e}; bound_ms {b_ms:.4f} "
              f"({b_by}, float32 FMAs)  plain_ms {plain_ms:.4f}  "
              f"library_ms (scaled_dot_product_attention, bf16) "
              f"{lib_ms:.4f}", flush=True)

        for name, vkw in sweep_tool.ROWS[1:] + EXTRA_VARIANTS:
            flags = fv.variant_flags(vkw.get("bf16_dots", False),
                                     vkw.get("use_exp2", False),
                                     vkw.get("split_loop", False),
                                     vkw.get("pipelined", False))
            tile = fv.DEFAULT_TILE[flags[0]]
            args = dict(causal=True, block_q=tile[0], block_k=tile[1],
                        bf16_dots=False, use_exp2=False, split_loop=False,
                        pipelined=False)
            args.update(vkw)
            before = fv.run_fwd_cuda.launches
            o, lse = fv.run_fwd_cuda(q, k, v, **args)
            if fv.run_fwd_cuda.launches != before + 1:
                raise AssertionError(f"{name}: the launch counter did not "
                                     f"move")
            ro, rlse = fv._torch_run_fwd(q, k, v, **args)
            torch.cuda.synchronize()
            eo, er, el = _hold_bf16(f"{name} {shape}", o, lse, ro, rlse)
            err_a = (o.float() - ref_a).abs().max().item()
            del o, lse, ro, rlse
            ms = (time_ms(lambda: fv.run_fwd_cuda(q, k, v, **args), flush)
                  if name in extra else None)
            plain_ms = time_ms(lambda: fv._torch_run_fwd(q, k, v, **args),
                               flush, iters=3, warmup=1)
            b_ms, b_by = bound(work, nbytes,
                               PEAK_BF16_FLOPS if flags[0]
                               else PEAK_F32_FLOPS)
            out["variants"].setdefault(name, {})[shape] = dict(
                max_abs_err=max(eo, el), o_row_err=er, err_vs_A=err_a,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms,
                source=("paddle_tpu_torch/ops/csrc/flash_variants.cu"
                        if flags[0] else
                        "paddle_tpu_torch/ops/csrc/flash_fwd.cu"),
                shape=shape_d)
            print(f"  {name:28s} [{shape}] max|err| O {eo:.3e} (row "
                  f"{er:.3e}) LSE {el:.3e}, vs row A {err_a:.4f}; plain_ms "
                  f"{plain_ms:.4f}"
                  + ("" if ms is None else f"  ms {ms:.4f}"), flush=True)
        del q, k, v, ref_a
        torch.cuda.empty_cache()
    return out


def sweep_path():
    """This slice's path: the sweep's entry point,
    ``paddle_tpu_torch.tools.flash_variants``, at the JAX tool's shape and
    at the LM's (``--shape lm``), with every count set to 0 just before and
    read just after: kernel 1 (row A) and the variants' wrapper (rows B to
    G) must both have launched."""
    from paddle_tpu_torch import ops

    ops.reset_launch_counts()
    rows = {}
    for shape in ("tool", "lm"):
        print(f"the sweep (python -m paddle_tpu_torch.tools.flash_variants "
              f"--shape {shape}):", flush=True)
        rows[shape] = sweep_tool.run(shape, seed=SEED)
    launches = ops.launch_counts()
    if not (launches["flash_fwd"] and launches["flash_variants"]):
        raise AssertionError(f"the sweep launched {launches}")
    print(f"sweep launches: flash_fwd {launches['flash_fwd']}, "
          f"flash_variants {launches['flash_variants']}", flush=True)
    return launches, rows


def merge_sweep_times(var, rows):
    """The sweep's times into ``variants_phase``'s record (row A is kernel
    1 at bf16), printed beside each one's bound, plain and library time."""
    for shape, shape_rows in rows.items():
        ms = {r["name"]: r["ms"] for r in shape_rows}
        k1 = var["kernel1_bf16"][shape]
        k1["ms"] = ms[sweep_tool.ROWS[0][0]]
        print(f"[{shape}] {'kernel 1 at bf16 (row A)':28s} ms "
              f"{k1['ms']:.4f}  bound_ms {k1['bound_ms']:.4f}  plain_ms "
              f"{k1['plain_ms']:.4f}  library_ms {k1['library_ms']:.4f}",
              flush=True)
        for name, per in var["variants"].items():
            r = per[shape]
            if r["ms"] is None:
                r["ms"] = ms[name]
            print(f"[{shape}] {name:28s} ms {r['ms']:.4f}  bound_ms "
                  f"{r['bound_ms']:.4f} ({r['bound_by']})  plain_ms "
                  f"{r['plain_ms']:.4f}  library_ms {r['library_ms']:.4f}",
                  flush=True)


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


def _gemm_ms(n, din, dout, dev, gen, dtype=torch.float32):
    """CUDA-event time of one fc's three products at N rows: y = x W, and
    the backward's dx = dy W^T and dW = x^T dy (full float32, or bf16 on
    the tensor cores)."""
    x = torch.randn(n, din, device=dev, generator=gen).to(dtype)
    w = torch.randn(din, dout, device=dev, generator=gen).to(dtype)
    dy = torch.randn(n, dout, device=dev, generator=gen).to(dtype)
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


def step_breakdown(trainer, feed, attn_ms, dtype=torch.float32):
    """Where one full-width training step's device time goes, from CUDA
    events: the whole step, forward + backward, the optimizer update, the
    loss (``_SoftmaxNLL`` forward and backward on logits of the step's
    shape), the dense products (each fc's three products at the step's
    shapes, times their count) and the attention kernels (their times at
    the training shape, times LAYERS); the rest is elementwise work and
    gaps.  ``dtype`` is the compute dtype of the logits and the products
    (bf16 under the bf16 policies).  Then ``torch.profiler`` over one
    more step, for the device's busy share and the kernels by device
    time."""
    from paddle_tpu_torch.layers.cost import _SoftmaxNLL

    dev = trainer.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ls = trainer._opt_state.get("loss_scale")
    torch.cuda.synchronize()
    ev[0].record()
    loss, grads, found = trainer._grads(feed,
                                        None if ls is None else ls["scale"])
    ev[1].record()
    trainer.optimizer.update(
        trainer._trainable, grads, trainer._opt_state,
        trainer.parameters.meta,
        finite=None if ls is None else torch.isfinite(loss) & (found[0] == 0))
    ev[2].record()
    torch.cuda.synchronize()
    del grads
    fb_ms, upd_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    n = TRAIN_BATCH * MAX_LEN
    logits = torch.randn(n, VOCAB, device=dev, generator=gen).to(
        dtype).requires_grad_(True)
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
    dense_ms = sum(count * _gemm_ms(n, a, b, dev, gen, dtype)
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

    prof = profile_step(trainer, feed)
    if prof["idle_share"] is None:
        print("torch.profiler saw no device time: idle share not measured",
              flush=True)
    else:
        print(f"torch.profiler: device busy {prof['busy_ms']:.1f} of "
              f"{prof['step_ms']:.1f} ms, idle share "
              f"{prof['idle_share']:.1%}; top kernels: " + "; ".join(
                  f"{name} x{n} {ms:.1f} ms" for name, n, ms in prof["top"]),
              flush=True)
    return dict(parts, step_ms=step, forward_backward_ms=fb_ms,
                idle_share=prof["idle_share"])


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


# ------------------------------------------------------- recurrent kernels
def _dt(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _rnn_args(kind, b, h, dev, gen, dtypes=(torch.float32, torch.float32)):
    """One step's operands: x, h, (c), weights, bias, a [B, 1] mask with
    about 30% zeros; x and the mask in ``dtypes``, the rest float32."""
    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    m = (torch.rand(b, 1, device=dev, generator=gen) > 0.3).to(dtypes[1])
    if kind == "lstm":
        return (randn(b, 4 * h).to(dtypes[0]), randn(b, h, scale=0.5),
                randn(b, h), randn(h, 4 * h, scale=h ** -0.5),
                randn(4 * h, scale=0.1), m)
    return (randn(b, 3 * h).to(dtypes[0]), randn(b, h, scale=0.5),
            randn(h, 2 * h, scale=h ** -0.5), randn(h, h, scale=h ** -0.5),
            randn(3 * h, scale=0.1), m)


def _rnn_check(kind, b, h, dev, gen, dtypes=(torch.float32, torch.float32)):
    """The kernel against its plain version at [B, H] on x and the mask in
    ``dtypes`` (the rest float32): values (masked rows copied bit for bit)
    and, through the autograd.Function, the gradients of every input but
    the mask.  Returns (max abs error, max error relative to max(1, max
    |ref|))."""
    from paddle_tpu_torch.ops import fused_rnn as fr

    step = fr.lstm_step if kind == "lstm" else fr.gru_step
    args = _rnn_args(kind, b, h, dev, gen, dtypes)
    leaves = [t.requires_grad_(True) for t in args[:-1]]
    got = step(*leaves, args[-1], impl="cuda")
    ref = step(*leaves, args[-1], impl="torch")
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    cot = [torch.randn(r.shape, device=dev, generator=gen) for r in ref]
    g_got = torch.autograd.grad(got, leaves, cot)
    g_ref = torch.autograd.grad(ref, leaves, cot)
    torch.cuda.synchronize()
    dead = args[-1][:, 0] == 0
    state = (args[1], args[2]) if kind == "lstm" else (args[1],)
    if not all(torch.equal(o[dead], s[dead]) for o, s in zip(got, state)):
        raise AssertionError(f"{kind}_step B={b} H={h}: masked rows are "
                             f"not copied bit for bit")
    names = (("h'", "c'") if kind == "lstm" else ("h'",)) + tuple(
        f"d{n}" for n in (("x", "h", "c", "w", "b") if kind == "lstm"
                          else ("x", "h", "w_g", "w_c", "b")))
    worst_abs, worst_rel, line = 0.0, 0.0, []
    for n, a, r in zip(names, got + g_got, ref + g_ref):
        err = (a - r).abs().max().item()
        rel = err / max(1.0, r.abs().max().item())
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        line.append(f"{n} {rel:.1e}")
        if not (rel <= TOL and torch.isfinite(a).all()):
            raise AssertionError(f"{kind}_step B={b} H={h}: {n} disagrees "
                                 f"with the plain version: {rel} > {TOL}")
    tag = "" if dtypes[0] == torch.float32 else (
        f" x {_dt(dtypes[0])}, mask {_dt(dtypes[1])}")
    print(f"{kind}_step{tag} B={b} H={h} ({int(dead.sum())} masked rows): "
          f"error / max(1, max |ref|): " + ", ".join(line), flush=True)
    return worst_abs, worst_rel


def rnn_phase(dev, gen, flush):
    """Kernels 5 and 6 against their plain versions (values and the
    autograd.Function's gradients) at the routes' shapes and at ragged
    ones, then their device times (``time_ms(lead=True)``: a step is
    about as short as its launch) beside their bounds, the plain step's
    and the cuBLAS product's alone (``torch.addmm``, the product's floor -
    no one PyTorch call computes either step)."""
    from paddle_tpu_torch.ops import fused_rnn as fr

    out = {}
    for kind, b in (("lstm", LSTM_BATCH), ("gru", NMT_BATCH)):
        errs = [_rnn_check(kind, bb, hh, dev, gen)
                for bb, hh in ((b, RNN_H), (8, RNN_H), (37, 128))]
        x, h, *rest = _rnn_args(kind, b, RNN_H, dev, gen)
        m = rest[-1]
        live = int((m > 0).sum())
        H = RNN_H
        if kind == "lstm":
            c, w, bias = rest[:3]
            kernel = lambda: fr.lstm_step_cuda(x, h, c, w, bias, m)  # noqa
            plain = lambda: fr._lstm_step_ref(x, h, c, w, bias, m)   # noqa
            floor = lambda: torch.addmm(bias, h, w)                  # noqa
            flops = 2.0 * live * H * 4 * H
            nbytes = 4.0 * (b * 4 * H + 4 * b * H + 4 * H * H + 4 * H + b)
        else:
            wg, wc, bias = rest[:3]
            kernel = lambda: fr.gru_step_cuda(x, h, wg, wc, bias, m)  # noqa
            plain = lambda: fr._gru_step_ref(x, h, wg, wc, bias, m)   # noqa
            floor = lambda: (torch.addmm(bias[:2 * H], h, wg),        # noqa
                             torch.addmm(bias[2 * H:], h, wc))
            flops = 2.0 * live * H * 3 * H
            nbytes = 4.0 * (b * 3 * H + 2 * b * H + 3 * H * H + 3 * H + b)
        with torch.no_grad():
            t = {"ms": time_ms(kernel, flush, lead=True),
                 "plain_ms": time_ms(plain, flush, lead=True),
                 "addmm_ms": time_ms(floor, flush, lead=True)}
        b_ms, b_by = bound(flops, nbytes)
        print(f"{kind}_step at B {b}, H {H} ({live} live rows): ms "
              f"{t['ms']:.4f}  bound_ms {b_ms:.4f} ({b_by})  plain_ms "
              f"{t['plain_ms']:.4f}  library_ms none (no one PyTorch call "
              f"computes the step); the product alone (torch.addmm, its "
              f"floor) {t['addmm_ms']:.4f}", flush=True)
        out[kind] = dict(t, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                         max_abs_err=max(e[0] for e in errs),
                         max_rel_err=max(e[1] for e in errs),
                         shape={"B": b, "H": H, "live_rows": live})
    return out


# ------------------------------------------------------- recurrent routes
def seeded_values(topo, seed: int) -> dict:
    """A numpy parameter tree for ``topo`` from a seed: N(0, 1/fan_in)
    matrices, N(0, 0.01) vectors (biases included, so the parity checks
    see them)."""
    rng = np.random.default_rng(seed)
    vals = {}
    for spec in topo.specs:
        for p in topo.param_specs[spec.name]:
            if p.is_state:
                continue
            scale = p.shape[0] ** -0.5 if len(p.shape) == 2 else 0.1
            vals.setdefault(spec.name, {})[p.name] = (
                rng.standard_normal(p.shape, dtype=np.float32) * scale)
    return vals


def _fresh(paddle):
    from paddle_tpu_torch.core.ir import reset_name_counters
    reset_name_counters()
    paddle.init(seed=SEED)


def nmt_model():
    """``seq2seq.build`` at ``bench_nmt``'s widths, through the DSL."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import seq2seq

    _fresh(paddle)
    cost = seq2seq.build(NMT_VOCAB, NMT_VOCAB, emb_dim=NMT_DIM,
                         enc_dim=NMT_DIM, dec_dim=NMT_DIM,
                         max_src_len=NMT_LEN, max_trg_len=NMT_LEN)
    return paddle, paddle.Topology(cost)


def lstm_model():
    """``bench_lstm``'s graph with one change, ``lstmemory(peephole=
    False)``: embedding 128, 2 x (fc 4h, lstmemory) at h 512, last_seq,
    fc 2, classification cost."""
    import paddle_tpu_torch as paddle

    _fresh(paddle)
    layer = paddle.layer
    words = layer.data("data", paddle.data_type.integer_value_sequence(
        NMT_VOCAB, max_len=LSTM_LEN))
    net = layer.embedding(words, size=128, vocab_size=NMT_VOCAB)
    for _ in range(2):
        net = layer.lstmemory(layer.fc(net, size=4 * RNN_H, act=None,
                                       bias_attr=False), peephole=False)
    net = layer.fc(layer.last_seq(net), size=2)
    lab = layer.data("label", paddle.data_type.integer_value(2))
    return paddle, paddle.Topology(layer.classification_cost(net, lab))


def nmt_feed(b, src_lens=None, trg_lens=None, seed=SEED):
    """Seeded token ids as ``bench_nmt`` feeds them, with @len."""
    rng = np.random.RandomState(seed)
    full = np.full(b, NMT_LEN, np.int32)
    trg = np.asarray(trg_lens if trg_lens is not None else full, np.int32)
    return {"source_words": rng.randint(3, NMT_VOCAB, (b, NMT_LEN))
            .astype(np.int32),
            "source_words@len": np.asarray(
                src_lens if src_lens is not None else full, np.int32),
            "target_words": rng.randint(3, NMT_VOCAB, (b, NMT_LEN))
            .astype(np.int32), "target_words@len": trg,
            "target_next_words": rng.randint(3, NMT_VOCAB, (b, NMT_LEN))
            .astype(np.int32), "target_next_words@len": trg}


def lstm_feed(b, lens=None, seed=SEED):
    rng = np.random.RandomState(seed)
    return {"data": rng.randint(0, NMT_VOCAB, (b, LSTM_LEN)).astype(np.int32),
            "data@len": np.asarray(lens if lens is not None
                                   else np.full(b, LSTM_LEN), np.int32),
            "label": rng.randint(0, 2, b).astype(np.int32)}


def route_parity(name, paddle, topo, values, feed, kernel, per_pass, lr,
                 tols=(1e-5, TOL, TOL)):
    """Batch 8, from the same weights: the kernel route against the plain
    one (``use_fused_rnn=False``) on the card - the first loss (1e-5
    relative), every parameter gradient (1e-4 of max(1, max |g|)) and a
    3-step Adam trajectory (1e-4 relative), or the limits ``tols`` gives
    in that order.  The kernel's counter must move ``per_pass`` a forward
    on the kernel route and not at all on the plain one."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.core import config

    runs = {}
    for fused in (True, False):
        config.set_option("use_fused_rnn", fused)
        try:
            ops.reset_launch_counts()
            tr = paddle.trainer.SGD(topo, paddle.parameters.from_numpy(
                topo, values), paddle.optimizer.Adam(learning_rate=lr))
            loss, grads = tr.forward_backward(feed)
            losses = []
            tr.train(lambda: iter([feed] * 3), event_handler=lambda e: (
                losses.append(e.cost)
                if isinstance(e, paddle.event.EndIteration) else None))
            runs[fused] = (float(loss), grads, losses)
            del tr
        finally:
            config.set_option("use_fused_rnn", True)
        want = 4 * per_pass if fused else 0
        if ops.launch_counts()[kernel] != want:
            raise AssertionError(f"{name} use_fused_rnn={fused}: launches "
                                 f"{ops.launch_counts()}, expected {want} "
                                 f"of {kernel}")
    (loss_k, grads_k, traj_k), (loss_t, grads_t, traj_t) = runs[True], \
        runs[False]
    loss_tol, grad_tol, traj_tol = tols
    if not _rel(loss_k, loss_t) <= loss_tol:
        raise AssertionError(f"{name} first loss: kernel route {loss_k} vs "
                             f"plain {loss_t}")
    worst = (0.0, "")
    for lname, ps in grads_t.items():
        for pname, ref in ps.items():
            rel = ((grads_k[lname][pname] - ref).abs().max().item()
                   / max(1.0, ref.abs().max().item()))
            worst = max(worst, (rel, f"{lname}.{pname}"))
    if not worst[0] <= grad_tol:
        raise AssertionError(f"{name} gradient {worst[1]}: kernel route vs "
                             f"plain {worst[0]} > {grad_tol} of max(1, max "
                             f"|g|)")
    traj = max(_rel(a, b) for a, b in zip(traj_k, traj_t))
    if len(traj_k) != 3 or not traj <= traj_tol:
        raise AssertionError(f"{name} Adam trajectory: kernel route "
                             f"{traj_k} vs plain {traj_t}")
    print(f"{name} parity at batch {len(next(iter(feed.values())))}, kernel "
          f"route vs use_fused_rnn=False: first loss {loss_k:.6f} vs "
          f"{loss_t:.6f} ({_rel(loss_k, loss_t):.2e} relative); worst "
          f"gradient {worst[1]} at {worst[0]:.2e} of max(1, max |g|); "
          f"3-step Adam losses {[round(x, 6) for x in traj_k]} vs "
          f"{[round(x, 6) for x in traj_t]} ({traj:.2e} relative)",
          flush=True)
    return {"loss_rel": _rel(loss_k, loss_t), "grad_rel": worst[0],
            "traj_rel": traj}


def train_steps(name, paddle, trainer, feed, steps, kernel, per_step,
                falling=True):
    """``trainer.SGD.train`` over ``steps`` copies of one batch: every
    loss finite (and, with ``falling``, the last below the first), the
    kernel's counter moving ``per_step`` a step; returns losses, step
    times and peak memory."""
    from paddle_tpu_torch import ops

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
    trainer.train(lambda: iter([feed] * steps), event_handler=handler)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if (len(losses) != steps or not all(np.isfinite(x) for x in losses)
            or (falling and not losses[-1] < losses[0])):
        raise AssertionError(f"{name} losses not finite"
                             f"{' and falling' if falling else ''}: "
                             f"{losses}")
    if launches[kernel] != per_step * steps:
        raise AssertionError(f"{name}: {kernel} launched "
                             f"{launches[kernel]} times in {steps} steps, "
                             f"expected {per_step} a step")
    warm = sorted(step_s[1:])[len(step_s[1:]) // 2]
    return losses, step_s, warm, peak_gb, launches


def _events_ms(fns: dict, rounds=3) -> dict:
    """CUDA-event time of one call of each of ``fns``: one warm round (a
    host-bound part's first call is dominated by the allocator and the
    libraries), then ``rounds`` rounds calling each once in turn, so that
    every part samples the same host conditions; the median per part."""
    times = {name: [] for name in fns}
    for r in range(rounds + 1):
        for name, fn in fns.items():
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
            fn()
            ev[1].record()
            torch.cuda.synchronize()
            if r:
                times[name].append(ev[0].elapsed_time(ev[1]))
    return {name: sorted(t)[rounds // 2] for name, t in times.items()}


def profile_step(trainer, feed, match=None):
    """``torch.profiler`` over one training step: the step's CUDA-event
    time, the device's busy time (the union of the intervals of its own
    activity - kernels, copies, fills - not of the host ops that launched
    it), the idle share, the device time of the kernels whose name
    contains ``match``, and the top 10 kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ev[0].record()
        trainer._step(feed)
        ev[1].record()
        torch.cuda.synchronize()
    wall = ev[0].elapsed_time(ev[1])
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev_events)
    busy_us, end_us = 0.0, float("-inf")
    for start, stop in spans:
        busy_us += max(0.0, stop - max(start, end_us))
        end_us = max(end_us, stop)
    per_name = {}
    for e in dev_events:
        ms, n = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    matched = sum(ms for name, (ms, _) in per_name.items()
                  if match is not None and match in name)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:10]
    busy = busy_us / 1e3
    return {"step_ms": wall, "busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall) if busy else None,
            "matched_ms": matched,
            "top": [(name[:60], n, ms) for name, (ms, n) in top],
            "per_name": per_name}


def nmt_breakdown(topo, trainer, feed):
    """Where one NMT training step's time goes, from CUDA events on the
    step's own shapes, each part and the whole step the median of three
    interleaved rounds after a warm one: the encoder (embedding, both projections, the bigru, boot and
    enc_proj, forward + backward), the decoder group (forward + backward
    from the encoder's outputs), the vocab head with the loss, Adam, and
    the rest (target embedding, gaps); the GRU kernel's own sum and the
    idle share from ``torch.profiler``.  The encoder and the decoder loop
    are host-bound, so their parts are the host's pace as much as the
    device's."""
    from paddle_tpu_torch.core import config
    from paddle_tpu_torch.core.ir import collect_topology
    from paddle_tpu_torch.core.registry import ApplyContext, get_layer_def
    from paddle_tpu_torch.layers.cost import _SoftmaxNLL

    dev = trainer.device
    params = {l: {p: t.detach().requires_grad_(True) for p, t in ps.items()}
              for l, ps in trainer.parameters.values.items()}
    nodes = {n.name: n for n in collect_topology(topo.outputs)}
    enc_names = ["encoded_sequence", "encoded_proj", "decoder_boot"]
    enc_topo = type(topo)([nodes[n] for n in enc_names])
    enc_params = [t for l in enc_topo.param_specs for t in
                  params.get(l, {}).values()]

    def encoder():
        outs, _ = enc_topo.forward(params, {}, feed, train=True,
                                   outputs=enc_names)
        torch.autograd.grad(sum(o.sum() for o in outs.values()), enc_params)

    with torch.no_grad():
        enc_outs, _ = enc_topo.forward(params, {}, feed, outputs=enc_names)
    spec = topo.get_layer("decoder_group")
    ldef = get_layer_def("recurrent_group")
    lens = lambda k: torch.as_tensor(feed[k + "@len"], device=dev)  # noqa
    pos = torch.arange(NMT_LEN, device=dev)
    src_mask = (pos[None] < lens("source_words")[:, None]).float()
    trg_mask = (pos[None] < lens("target_words")[:, None]).float()
    trg_ids = torch.as_tensor(feed["target_words"], device=dev).long()
    inputs = [params["trg_embedding"]["w"].detach()[trg_ids]] + [
        enc_outs[n].detach().requires_grad_(True) for n in enc_names]
    group_params = list(params["decoder_group"].values())

    def decoder():
        ctx = ApplyContext(train=True, device=dev)
        y = ldef.apply_seq(spec.attrs, params["decoder_group"], inputs,
                           [trg_mask, src_mask, src_mask, None], ctx)
        torch.autograd.grad(y.sum(), group_params + inputs[1:])

    n = feed["target_words"].shape[0] * NMT_LEN
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(n, NMT_DIM, device=dev, generator=gen,
                    requires_grad=True)
    labels = torch.randint(0, NMT_VOCAB, (n,), device=dev, generator=gen)
    head_w = params["dec_out"]["w0"]
    head_b = params["dec_out"]["b"]

    dt = config.precision_policy().ctx_compute_dtype() or torch.float32

    def head():
        logits = x.to(dt) @ head_w.to(dt) + head_b.to(dt)
        loss = _SoftmaxNLL.apply(logits, labels).mean()
        torch.autograd.grad(loss, [x, head_w, head_b])

    _, grads = trainer.forward_backward(feed)
    parts = _events_ms({
        "encoder": encoder, "decoder group": decoder,
        "vocab head + loss": head,
        "Adam": lambda: trainer.optimizer.update(
            trainer._trainable, grads, trainer._opt_state,
            trainer.parameters.meta),
        "step": lambda: trainer._step(feed)})
    del x, grads
    step = parts.pop("step")
    prof = profile_step(trainer, feed, "gru_")
    parts["rest (target embedding, gaps)"] = step - sum(parts.values())
    print(f"NMT step breakdown (CUDA events; parts timed alone at the "
          f"step's shapes): step {step:.1f} ms; " + "; ".join(
              f"{k} {v:.1f} ms ({v / step:.0%})" for k, v in parts.items())
          + f"; the GRU kernel's own sum in the step {prof['matched_ms']:.2f}"
          f" ms", flush=True)
    if prof["idle_share"] is None:
        print("torch.profiler saw no device time: idle share not measured",
              flush=True)
    else:
        print(f"torch.profiler over one NMT step: device busy "
              f"{prof['busy_ms']:.1f} of {prof['step_ms']:.1f} ms, idle share "
              f"{prof['idle_share']:.1%} (against the unprofiled step's "
              f"{step:.1f} ms: {max(0.0, 1 - prof['busy_ms'] / step):.1%}); "
              f"top kernels: " + "; ".join(
                  f"{nm} x{k} {ms:.1f} ms" for nm, k, ms in prof["top"]),
              flush=True)
    return dict(parts, step_ms=step, gru_kernel_ms=prof["matched_ms"],
                busy_ms=prof["busy_ms"], profiled_step_ms=prof["step_ms"],
                idle_share=prof["idle_share"])


def nmt_path():
    """The slice's main path: the NMT model at ``bench_nmt``'s widths,
    kernel-route parity at batch 8, then ``trainer.SGD.train`` at batch
    NMT_BATCH x NMT_LEN + NMT_LEN."""
    paddle, topo = nmt_model()
    values = seeded_values(topo, SEED)
    n_params = sum(v.size for ps in values.values() for v in ps.values())
    print(f"NMT model: vocab {NMT_VOCAB}, emb/enc/dec {NMT_DIM}, src = trg "
          f"= {NMT_LEN}; {n_params / 1e6:.1f}M float32 parameters from a "
          f"numpy seed", flush=True)
    parity = route_parity(
        "NMT", paddle, topo, values,
        nmt_feed(8, [50, 37, 1, 12, 50, 25, 3, 44],
                 [50, 1, 20, 33, 7, 50, 16, 2]),
        "gru_step", 2 * NMT_LEN, NMT_LR)
    torch.cuda.empty_cache()
    trainer = paddle.trainer.SGD(topo, paddle.parameters.from_numpy(
        topo, values), paddle.optimizer.Adam(learning_rate=NMT_LR))
    feed = nmt_feed(NMT_BATCH)
    losses, step_s, warm, peak_gb, launches = train_steps(
        "NMT", paddle, trainer, feed, NMT_STEPS, "gru_step", 2 * NMT_LEN)
    toks = NMT_BATCH * 2 * NMT_LEN
    print(f"NMT training: {NMT_STEPS} Adam steps (lr {NMT_LR}) at batch "
          f"{NMT_BATCH} x {NMT_LEN} + {NMT_LEN}, losses "
          f"{[round(x, 5) for x in losses]}; step time first "
          f"{step_s[0] * 1e3:.1f} ms, median after it {warm * 1e3:.1f} ms = "
          f"{toks / warm:.0f} tokens/s (smoke figure, not a benchmark); peak "
          f"memory {peak_gb:.2f} GB; gru_step launches "
          f"{launches['gru_step']} ({2 * NMT_LEN} a step: 2 directions x "
          f"{NMT_LEN})", flush=True)
    breakdown = nmt_breakdown(topo, trainer, feed)
    return {"launches": launches, "losses": losses, "step_ms": warm * 1e3,
            "first_step_ms": step_s[0] * 1e3, "tokens_per_s": toks / warm,
            "peak_gb": peak_gb, "parity": parity, "breakdown": breakdown}


def lstm_path():
    """The LSTM route: ``bench_lstm``'s graph with ``peephole=False``,
    parity at batch 8, then LSTM_STEPS Adam steps at LSTM_BATCH x
    LSTM_LEN.  Its losses must be finite; they need not fall in three
    steps (random labels, Adam at 2e-3 overshoots on its second step, on
    the plain route alike), so the route's correctness is the parity
    check's."""
    paddle, topo = lstm_model()
    values = seeded_values(topo, SEED + 2)
    parity = route_parity("LSTM route", paddle, topo, values,
                          lstm_feed(8, [100, 1, 57, 100, 9, 33, 100, 80]),
                          "lstm_step", 2 * LSTM_LEN, LSTM_LR)
    trainer = paddle.trainer.SGD(topo, paddle.parameters.from_numpy(
        topo, values), paddle.optimizer.Adam(learning_rate=LSTM_LR))
    losses, step_s, warm, peak_gb, launches = train_steps(
        "LSTM route", paddle, trainer, lstm_feed(LSTM_BATCH), LSTM_STEPS,
        "lstm_step", 2 * LSTM_LEN, falling=False)
    print(f"LSTM route training: {LSTM_STEPS} Adam steps (lr {LSTM_LR}) at "
          f"batch {LSTM_BATCH} x {LSTM_LEN}, losses "
          f"{[round(x, 5) for x in losses]}; step time first "
          f"{step_s[0] * 1e3:.1f} ms, median after it {warm * 1e3:.1f} ms; "
          f"peak memory {peak_gb:.2f} GB; lstm_step launches "
          f"{launches['lstm_step']} ({2 * LSTM_LEN} a step: 2 layers x "
          f"{LSTM_LEN})", flush=True)
    return {"launches": launches, "losses": losses, "step_ms": warm * 1e3,
            "first_step_ms": step_s[0] * 1e3, "peak_gb": peak_gb,
            "parity": parity}


# ---------------------------------------------------- the bf16 policy slice
# dQ, dK and dV of the bf16 backward kernels against the plain version of
# the Pallas kernels' arithmetic (``_upcast_bwd``) on the same bf16
# operands and the forward kernel's own O and LSE: each row (b, l, h)
# within 2^-7 of its norm, one bf16 ulp of every element, as O is held in
# the sweep (_grad_row_err).  A planted fault (one 64-row q tile's share
# of dK and dV left out) must fail it.
BWD_ROW_TOL = 2.0 ** -7
# the bf16 routes against their plain routes on the card.  Recurrent
# kernels: the same float32 arithmetic as the plain step, but each
# product's sums in another order move a float32 h by ~1e-7, which can
# flip the rounding of a downstream bf16 activation (2^-8 of it): the
# first loss within 1e-4 relative, gradients within 1e-3 of max(1,
# max |g|), a 3-step trajectory within 1e-3 (readings on the H100: at
# most 5.8e-6, 1.5e-5 and 1.5e-4, the last the LSTM route's Adam at 2e-3
# amplifying its second step).  The LM's plain route rounds P to bf16
# before P . V (the JAX xla path), the kernels keep it float32: its 6-step
# losses within LM_BF16_BAND relative of the kernel route's (readings: at
# most 7.3e-6).
RNN_BF16_TOLS = (1e-4, 1e-3, 1e-3)
LM_BF16_BAND = 1e-4
BF16_POLICIES = ("bf16", "mixed")


def _grad_row_err(a, ref) -> float:
    """Largest ||a_r - ref_r|| / max(||ref_r||, 2^-7 m) over the rows
    (b, l, h), m the median row norm of ``ref``: a row whose gradient
    cancels to rounding noise (dQ's first query rows, where dP - delta is
    a difference of two equal sums) is held against that floor, not
    against its own noise."""
    a, ref = a.float(), ref.float()
    norms = torch.linalg.vector_norm(ref, dim=-1)
    floor = BWD_ROW_TOL * norms.median().item()
    return (torch.linalg.vector_norm(a - ref, dim=-1)
            / norms.clamp_min(max(floor, 1e-30))).max().item()


def flash_bwd_bf16_phase(dev, gen, flush):
    """Kernels 2 and 3 at bf16 at the LM's training shape, causal: dQ, dK
    and dV held per row against ``_upcast_bwd`` on the kernels' operands,
    the planted fault shown to fail that check, the distance to the bf16
    plain route's autograd reported; each kernel's time beside its bound
    (bf16 bytes, float32 FMAs), the bf16 plain route's backward and the
    library's bf16 backward; and kernel 1's bf16 time at this shape (the
    LM step breakdown's attention share)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    B, T, D = TRAIN_BATCH, MAX_LEN, DIM // HEADS
    bf = torch.bfloat16
    q, k, v, go = (torch.randn(B, T, HEADS, D, device=dev, generator=gen,
                               dtype=bf) for _ in range(4))
    lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    kw = dict(causal=True, scale=D ** -0.5)
    o, lse = fa.flash_fwd_cuda(q, k, v, lens, **kw)
    delta = (go.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_bwd_dq_cuda(q, k, v, go, lse, delta, lens, **kw)
    dk, dv = fa.flash_bwd_dkdv_cuda(q, k, v, go, lse, delta, lens, **kw)
    ref = fa._upcast_bwd(q, k, v, lens, o, lse, go, **kw)
    torch.cuda.synchronize()
    if any(t.dtype != bf for t in (dq, dk, dv)):
        raise AssertionError(f"bf16 backward gave {dq.dtype}, {dk.dtype}, "
                             f"{dv.dtype}")
    errs = {}
    for name, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        row = _grad_row_err(a, r)
        err = (a.float() - r.float()).abs().max().item()
        errs[name] = (err, row)
        if not (row <= BWD_ROW_TOL and torch.isfinite(a.float()).all()):
            raise AssertionError(f"flash_bwd bf16 {name}: row error {row} "
                                 f"> {BWD_ROW_TOL} against _upcast_bwd")
    # the planted fault: the last q tile's rows of dO zeroed leaves their
    # share out of every dK and dV row (and the last 64 keys, which only
    # that tile sees under causal masking, with none)
    go_bad = go.clone()
    go_bad[:, -64:] = 0
    _, bad_k, bad_v = fa._upcast_bwd(q, k, v, lens, o, lse, go_bad, **kw)
    fault = {n: _grad_row_err(b_, r) for n, b_, r in
             (("dk", bad_k, ref[1]), ("dv", bad_v, ref[2]))}
    if min(fault.values()) <= BWD_ROW_TOL:
        raise AssertionError(f"the bf16 backward check passes a planted "
                             f"fault: {fault}")
    del go_bad, bad_k, bad_v
    # the distance to the bf16 plain route (P rounded to bf16, autograd)
    plain = _attn_grads(fa, q, k, v, lens, go, None, kw, "torch")
    dist = {n: _grad_row_err(a, p) for n, a, p in
            zip(("dq", "dk", "dv"), (dq, dk, dv), plain)}
    del plain, ref
    print(f"flash_bwd bf16 at [{B}, {T}, {HEADS}, {D}] causal against "
          f"_upcast_bwd: " + ", ".join(
              f"{n} max|err| {e:.3e} row {r:.3e}" for n, (e, r) in
              errs.items())
          + f" (row limit {BWD_ROW_TOL:.3e}); planted fault (the last q "
          f"tile left out of dK/dV): row error dk {fault['dk']:.3e} dv "
          f"{fault['dv']:.3e}; distance to the bf16 plain route's autograd "
          f"(P rounded to bf16): " + ", ".join(
              f"{n} row {r:.3e}" for n, r in dist.items()), flush=True)

    t = {"fwd": time_ms(lambda: fa.flash_fwd_cuda(q, k, v, lens, **kw),
                        flush),
         "dkdv": time_ms(lambda: fa.flash_bwd_dkdv_cuda(
             q, k, v, go, lse, delta, lens, **kw), flush),
         "dq": time_ms(lambda: fa.flash_bwd_dq_cuda(
             q, k, v, go, lse, delta, lens, **kw), flush)}
    qkv = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = fa._torch_attention(*qkv, lens, **kw)
    t["plain_bwd"] = time_ms(lambda: torch.autograd.grad(
        out, qkv, go, retain_graph=True), flush, iters=5, warmup=1)
    del out
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt = [x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v)]
    so = sdpa(*qt, is_causal=True, scale=kw["scale"])
    t["lib_bwd"] = time_ms(lambda: torch.autograd.grad(
        so, qt, go.transpose(1, 2), retain_graph=True), flush)
    del so
    pairs = B * HEADS * T * (T + 1) // 2
    row = 2.0 * B * T * HEADS * D             # one [B, T, H, D] bf16
    vec = 4.0 * B * HEADS * T                 # one [B, H, T] float32
    bounds = {"dkdv": bound(8.0 * D * pairs, 6 * row + 2 * vec + 4 * B),
              "dq": bound(6.0 * D * pairs, 5 * row + 2 * vec + 4 * B)}
    out = {}
    for name in ("dkdv", "dq"):
        b_ms, b_by = bounds[name]
        print(f"flash {name} bf16 at [{B}, {T}, {HEADS}, {D}] causal: ms "
              f"{t[name]:.4f}  bound_ms {b_ms:.4f} ({b_by}, float32 FMAs)  "
              f"plain_ms (the bf16 plain route's backward, whole) "
              f"{t['plain_bwd']:.4f}  library_ms "
              f"(scaled_dot_product_attention backward, bf16) "
              f"{t['lib_bwd']:.4f}", flush=True)
        e = (max(errs["dk"], errs["dv"]) if name == "dkdv" else errs["dq"])
        out[name] = dict(ms=t[name], plain_ms=t["plain_bwd"], bound_ms=b_ms,
                         bound_by=b_by, library_ms=t["lib_bwd"],
                         max_abs_err=e[0], row_err=e[1])
    out["fwd_ms"] = t["fwd"]
    out["planted_fault"] = fault
    out["distance_to_plain"] = dist
    out["shape"] = {"B": B, "Lq": T, "Lk": T, "H": HEADS, "D": D,
                    "causal": True, "dtype": "bfloat16"}
    return out


def rnn_bf16_phase(dev, gen, flush):
    """Kernels 5 and 6 at every bf16 instance (``fused_rnn.KERNEL_DTYPES``:
    x bf16, the mask float32 or bf16) against the plain step on the same
    operands, values and gradients within 1e-4 of max(1, max |ref|) with
    masked rows copied bit for bit, at the routes' shapes and a ragged
    one; each timed as the float32 rows are, its bytes counting x (and the
    mask) at 2 bytes.  Every check moves the bf16 counters."""
    from paddle_tpu_torch.ops import fused_rnn as fr

    out = {}
    for kind, b in (("lstm", LSTM_BATCH), ("gru", NMT_BATCH)):
        wrapper = fr.lstm_step_cuda if kind == "lstm" else fr.gru_step_cuda
        for dts in fr.KERNEL_DTYPES:
            if dts[0] != torch.bfloat16:
                continue
            before = wrapper.launches_bf16
            errs = [_rnn_check(kind, bb, hh, dev, gen, dts)
                    for bb, hh in ((b, RNN_H), (37, 128))]
            if wrapper.launches_bf16 == before:
                raise AssertionError(f"{kind}_step {dts}: the bf16 counter "
                                     f"did not move")
            x, h, *rest = _rnn_args(kind, b, RNN_H, dev, gen, dts)
            m = rest[-1]
            live = int((m > 0).sum())
            H = RNN_H
            xb, mb = x.element_size(), m.element_size()
            if kind == "lstm":
                c, w, bias = rest[:3]
                kernel = lambda: fr.lstm_step_cuda(x, h, c, w, bias, m)  # noqa
                plain = lambda: fr._lstm_step_ref(x, h, c, w, bias, m)   # noqa
                floor = lambda: torch.addmm(bias, h, w)                  # noqa
                flops = 2.0 * live * H * 4 * H
                nbytes = (xb * b * 4 * H + 4.0 * (4 * b * H + 4 * H * H
                                                  + 4 * H) + mb * b)
            else:
                wg, wc, bias = rest[:3]
                kernel = lambda: fr.gru_step_cuda(x, h, wg, wc, bias, m)  # noqa
                plain = lambda: fr._gru_step_ref(x, h, wg, wc, bias, m)   # noqa
                floor = lambda: (torch.addmm(bias[:2 * H], h, wg),        # noqa
                                 torch.addmm(bias[2 * H:], h, wc))
                flops = 2.0 * live * H * 3 * H
                nbytes = (xb * b * 3 * H + 4.0 * (2 * b * H + 3 * H * H
                                                  + 3 * H) + mb * b)
            with torch.no_grad():
                t = {"ms": time_ms(kernel, flush, lead=True),
                     "plain_ms": time_ms(plain, flush, lead=True),
                     "addmm_ms": time_ms(floor, flush, lead=True)}
            b_ms, b_by = bound(flops, nbytes)
            key = f"x {_dt(dts[0])}, mask {_dt(dts[1])}"
            print(f"{kind}_step bf16 ({key}) at B {b}, H {H} ({live} live "
                  f"rows): ms {t['ms']:.4f}  bound_ms {b_ms:.4f} ({b_by})  "
                  f"plain_ms {t['plain_ms']:.4f}  library_ms none; the "
                  f"product alone (torch.addmm) {t['addmm_ms']:.4f}",
                  flush=True)
            out.setdefault(kind, {})[key] = dict(
                t, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                max_abs_err=max(e[0] for e in errs),
                max_rel_err=max(e[1] for e in errs),
                shape={"B": b, "H": H, "live_rows": live})
    return out


def _policy(name):
    """Make ``name`` the precision policy (every path sets its own)."""
    from paddle_tpu_torch.core import precision
    precision.apply_policy_name(name)


def _lm_policy_run(paddle, topo, values, feed, policy, impl):
    """TRAIN_STEPS Adam steps of ``trainer.SGD.train`` at batch
    TRAIN_BATCH x MAX_LEN under ``policy`` with the attention on ``impl``
    (None: the kernels; "torch": the plain route), counts set to 0 just
    before and read just after."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.core import config

    _policy(policy)
    config.set_option("attention_impl", impl)
    try:
        trainer = _trainer(paddle, topo, values)
        losses, step_s, warm, peak_gb, launches = train_steps(
            f"LM {policy} {'kernels' if impl is None else 'plain'}", paddle,
            trainer, feed, TRAIN_STEPS, "flash_fwd",
            LAYERS if impl is None else 0)
    finally:
        config.set_option("attention_impl", None)
    return trainer, losses, step_s, warm, peak_gb, launches


def lm_bf16_path(attn_bf16_ms, f32):
    """The LM under ``bf16`` and ``mixed`` at ``bench_transformer`` widths,
    8 x 4096, Adam 1e-4, from the seeded weights: TRAIN_STEPS steps on
    the kernels, whose bf16 instances (kernels 1, 2 and 3) must each
    launch LAYERS times a step, and on the plain route, whose losses must
    stay within LM_BF16_BAND of theirs; the step time, the step breakdown,
    the idle share and the peak memory beside the float32 run's."""
    paddle, topo = _train_model()
    values = random_values(SEED)
    seqs = np.random.RandomState(SEED + 1).randint(
        0, VOCAB, size=(TRAIN_BATCH, MAX_LEN + 1)).astype(np.int32)
    feed = trainer_feed(seqs[:, :-1], seqs[:, 1:])
    out = {}
    try:
        for policy in BF16_POLICIES:
            tr, losses, step_s, warm, peak_gb, launches = _lm_policy_run(
                paddle, topo, values, feed, policy, None)
            want = LAYERS * TRAIN_STEPS
            bf16 = {k: launches[k + "_bf16"] for k in TRAIN_KERNELS}
            if any(n != want for n in bf16.values()) or any(
                    launches[k] != want for k in TRAIN_KERNELS):
                raise AssertionError(f"LM {policy}: the bf16 attention "
                                     f"kernels did not run {LAYERS} times a "
                                     f"step: {launches}")
            if not losses[-1] < losses[0]:
                raise AssertionError(f"LM {policy} losses not falling: "
                                     f"{losses}")
            scale = None
            if policy == "mixed":
                ls = tr._opt_state["loss_scale"]
                scale = (float(ls["scale"]), int(ls["skipped"]))
                if scale[1]:
                    raise AssertionError(f"LM mixed skipped {scale[1]} of "
                                         f"{TRAIN_STEPS} clean steps")
            breakdown = step_breakdown(tr, feed, attn_bf16_ms, torch.bfloat16)
            del tr
            torch.cuda.empty_cache()
            ptr, plain, _, plain_warm, plain_peak, plain_launches = \
                _lm_policy_run(paddle, topo, values, feed, policy, "torch")
            del ptr
            torch.cuda.empty_cache()
            if any(plain_launches[k] for k in TRAIN_KERNELS):
                raise AssertionError(f"LM {policy} plain route launched "
                                     f"{plain_launches}")
            band = max(_rel(a, b) for a, b in zip(losses, plain))
            if not band <= LM_BF16_BAND:
                raise AssertionError(f"LM {policy}: kernel route {losses} "
                                     f"vs plain route {plain}: {band} > "
                                     f"{LM_BF16_BAND}")
            print(f"LM {policy}: {TRAIN_STEPS} Adam steps (lr {TRAIN_LR}) "
                  f"at batch {TRAIN_BATCH} x {MAX_LEN}, losses "
                  f"{[round(x, 5) for x in losses]}, plain route "
                  f"{[round(x, 5) for x in plain]} ({band:.2e} relative, "
                  f"band {LM_BF16_BAND}); step time first "
                  f"{step_s[0] * 1e3:.1f} ms, median after it "
                  f"{warm * 1e3:.1f} ms = {TRAIN_BATCH * MAX_LEN / warm:.0f}"
                  f" tokens/s (float32: {f32['step_ms']:.1f} ms; plain route"
                  f" {plain_warm * 1e3:.1f} ms); peak memory {peak_gb:.2f} "
                  f"GB (float32 {f32['peak_gb']:.2f}, plain route "
                  f"{plain_peak:.2f}); bf16 launches {bf16}"
                  + ("" if scale is None else
                     f"; loss scale {scale[0]:g}, skipped {scale[1]}"),
                  flush=True)
            out[policy] = {"losses": losses, "plain_losses": plain,
                           "band": band, "step_ms": warm * 1e3,
                           "first_step_ms": step_s[0] * 1e3,
                           "plain_step_ms": plain_warm * 1e3,
                           "peak_gb": peak_gb, "plain_peak_gb": plain_peak,
                           "launches": launches, "breakdown": breakdown,
                           "loss_scale": scale}
    finally:
        _policy("fp32")
    return out


def rnn_bf16_paths():
    """NMT and the LSTM route under ``bf16``: kernel-route parity against
    ``use_fused_rnn=False`` at batch 8 (RNN_BF16_TOLS), then the steps of
    the float32 paths with the bf16 instances' counters moving as the
    float32 ones did (kernel 6: 100 a step; kernel 5: 200), the step time,
    and for NMT the breakdown and the idle share."""
    out = {}
    paddle, topo = nmt_model()
    values = seeded_values(topo, SEED)
    try:
        _policy("bf16")
        parity = route_parity(
            "NMT bf16", paddle, topo, values,
            nmt_feed(8, [50, 37, 1, 12, 50, 25, 3, 44],
                     [50, 1, 20, 33, 7, 50, 16, 2]),
            "gru_step_bf16", 2 * NMT_LEN, NMT_LR, RNN_BF16_TOLS)
        torch.cuda.empty_cache()
        trainer = paddle.trainer.SGD(topo, paddle.parameters.from_numpy(
            topo, values), paddle.optimizer.Adam(learning_rate=NMT_LR))
        feed = nmt_feed(NMT_BATCH)
        losses, step_s, warm, peak_gb, launches = train_steps(
            "NMT bf16", paddle, trainer, feed, NMT_STEPS, "gru_step_bf16",
            2 * NMT_LEN)
        toks = NMT_BATCH * 2 * NMT_LEN
        print(f"NMT bf16 training: {NMT_STEPS} Adam steps, losses "
              f"{[round(x, 5) for x in losses]}; step time first "
              f"{step_s[0] * 1e3:.1f} ms, median after it {warm * 1e3:.1f} "
              f"ms = {toks / warm:.0f} tokens/s (smoke figure); peak memory "
              f"{peak_gb:.2f} GB; gru_step bf16 launches "
              f"{launches['gru_step_bf16']}", flush=True)
        breakdown = nmt_breakdown(topo, trainer, feed)
        out["nmt"] = {"losses": losses, "step_ms": warm * 1e3,
                      "first_step_ms": step_s[0] * 1e3,
                      "tokens_per_s": toks / warm, "peak_gb": peak_gb,
                      "parity": parity, "breakdown": breakdown,
                      "launches": launches}
        del trainer
        torch.cuda.empty_cache()

        paddle, topo = lstm_model()
        _policy("bf16")
        values = seeded_values(topo, SEED + 2)
        parity = route_parity(
            "LSTM route bf16", paddle, topo, values,
            lstm_feed(8, [100, 1, 57, 100, 9, 33, 100, 80]),
            "lstm_step_bf16", 2 * LSTM_LEN, LSTM_LR, RNN_BF16_TOLS)
        trainer = paddle.trainer.SGD(topo, paddle.parameters.from_numpy(
            topo, values), paddle.optimizer.Adam(learning_rate=LSTM_LR))
        feed = lstm_feed(LSTM_BATCH)
        losses, step_s, warm, peak_gb, launches = train_steps(
            "LSTM route bf16", paddle, trainer, feed, LSTM_STEPS,
            "lstm_step_bf16", 2 * LSTM_LEN, falling=False)
        prof = profile_step(trainer, feed, "lstm_step")
        print(f"LSTM route bf16 training: {LSTM_STEPS} Adam steps, losses "
              f"{[round(x, 5) for x in losses]}; step time first "
              f"{step_s[0] * 1e3:.1f} ms, median after it {warm * 1e3:.1f} "
              f"ms; peak memory {peak_gb:.2f} GB; lstm_step bf16 launches "
              f"{launches['lstm_step_bf16']}; idle share "
              + ("not measured" if prof["idle_share"] is None
                 else f"{prof['idle_share']:.1%}"), flush=True)
        out["lstm_route"] = {"losses": losses, "step_ms": warm * 1e3,
                             "first_step_ms": step_s[0] * 1e3,
                             "peak_gb": peak_gb, "parity": parity,
                             "idle_share": prof["idle_share"],
                             "launches": launches}
    finally:
        _policy("fp32")
    return out


def mixed_skip_phase(dev):
    """``mixed`` on the card: an MLP (1024 -> 4096 relu -> 1000) takes two
    clean Momentum steps, then a batch with one inf sample, which must
    leave the parameters, the Momentum slots and the step counter bit for
    bit, halve the loss scale and count one skipped step, with no host
    read inside the step."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.ir import reset_name_counters

    reset_name_counters()
    paddle.init(seed=SEED, precision="mixed")
    try:
        layer = paddle.layer
        x = layer.data("x", paddle.data_type.dense_vector(1024))
        y = layer.data("y", paddle.data_type.integer_value(1000))
        h = layer.fc(x, size=4096, act="relu")
        topo = paddle.Topology(layer.classification_cost(
            layer.fc(h, size=1000), y))
        tr = paddle.trainer.SGD(topo, paddle.parameters.create(topo),
                                paddle.optimizer.Momentum(
                                    learning_rate=0.01, momentum=0.9))
        rng = np.random.RandomState(SEED)
        xs = rng.randn(256, 1024).astype(np.float32)
        ys = rng.randint(0, 1000, 256).astype(np.int32)
        for _ in range(2):
            tr._step({"x": xs, "y": ys})
        before = [t.clone() for ps in tr._trainable.values()
                  for t in ps.values()]
        slots = [s.clone() for ps in tr._opt_state["slots"].values()
                 for ss in ps.values() for s in ss.values()]
        ls = {k: v.clone() for k, v in tr._opt_state["loss_scale"].items()}
        t = tr._opt_state["t"].clone()
        bad = xs.copy()
        bad[7, 3] = np.inf
        loss = tr._step({"x": bad, "y": ys})
        torch.cuda.synchronize()
        after = [t_ for ps in tr._trainable.values() for t_ in ps.values()]
        slots_after = [s for ps in tr._opt_state["slots"].values()
                       for ss in ps.values() for s in ss.values()]
        new = tr._opt_state["loss_scale"]
        ok = (not torch.isfinite(loss)
              and all(torch.equal(a, b) for a, b in zip(after, before))
              and all(torch.equal(a, b) for a, b in zip(slots_after, slots))
              and torch.equal(tr._opt_state["t"], t)
              and float(new["scale"]) == float(ls["scale"]) * 0.5
              and int(new["skipped"]) == 1 and int(new["good_steps"]) == 0)
        print(f"mixed on the card: two clean steps (loss scale "
              f"{float(ls['scale']):g}, good steps {int(ls['good_steps'])}), "
              f"then a batch with one inf sample: loss {float(loss)}, "
              f"parameters, Momentum slots and step counter "
              f"{'unchanged' if ok else 'CHANGED'}, loss scale "
              f"{float(new['scale']):g}, skipped {int(new['skipped'])}",
              flush=True)
        if not ok:
            raise AssertionError("mixed: the planted inf batch did not skip "
                                 "the step and halve the scale")
        return {"scale_before": float(ls["scale"]),
                "scale_after": float(new["scale"]),
                "skipped": int(new["skipped"])}
    finally:
        paddle.init(seed=SEED, precision="fp32")


# the float32 instances the bf16 templates must leave alone:
# (source, the kernel's name in the earlier build, in the new one)
SASS_KERNELS = (
    ("flash_bwd.cu", "flash_bwd_dkdv_kernelEPKf", "flash_bwd_dkdv_kernelIfE"),
    ("flash_bwd.cu", "flash_bwd_dq_kernelEPKf", "flash_bwd_dq_kernelIfE"),
    ("rnn_step.cu", "lstm_step_kernelEPKf", "lstm_step_kernelIffE"),
    ("rnn_step.cu", "gru_gates_kernelEPKf", "gru_gates_kernelIfE"),
    ("rnn_step.cu", "gru_cand_kernelEPKf", "gru_cand_kernelIffE"),
)
# their sources as of the last revision before the bf16 instances
# (SASS_BASE_REV), kept in SASS_BASE so that a checkout without history
# compares them too, each file pinned by its git blob id at that revision
SASS_BASE_REV = "704dbc822bcc64241779e3b269892a62eb6b8e70"
SASS_BASE = "paddle_tpu_torch/tools/sass_base"
SASS_BASE_BLOBS = {
    "flash_bwd.cu": "f9b8a77ef1567ea7eb23229367e4559e3e1faea8",
    "flash_common.cuh": "b1635bb2bcf22f838fcc6636dd32c01fd59f12a8",
    "rnn_step.cu": "3af9bce14b30ba10261c9297c9ed2bab2389d34d",
}


def sass_phase():
    """``tools/sass_diff.py`` over SASS_KERNELS: each float32 instance's
    machine code against SASS_BASE's build, line for line.  Fails when a
    file of SASS_BASE is missing or is not SASS_BASE_REV's."""
    import concurrent.futures
    import os

    from paddle_tpu_torch.tools import sass_diff

    csrc = "paddle_tpu_torch/ops/csrc"
    for name, blob in SASS_BASE_BLOBS.items():
        got = sass_diff.git_blob_id(os.path.join(SASS_BASE, name))
        if got != blob:
            raise AssertionError(
                f"{SASS_BASE}/{name} is blob {got}, not {blob} "
                f"({SASS_BASE_REV[:12]}'s)")
    srcs = sorted({src for src, _, _ in SASS_KERNELS})
    jobs = {}
    with concurrent.futures.ThreadPoolExecutor(2 * len(srcs)) as pool:
        for src in srcs:
            stem = src.removesuffix(".cu")
            jobs[("old", src)] = pool.submit(
                sass_diff.sass_of, os.path.join(SASS_BASE, src),
                f"old_{stem}")
            jobs[("new", src)] = pool.submit(
                sass_diff.sass_of, os.path.join(csrc, src), f"new_{stem}")
        listings = {key: sass_diff.kernels(f.result())
                    for key, f in jobs.items()}
    out = {}
    for src, old_name, new_name in SASS_KERNELS:
        old = sass_diff.pick(listings[("old", src)], old_name)
        new = sass_diff.pick(listings[("new", src)], new_name)
        diff = sass_diff.first_difference(old, new)
        out[new_name] = len(old) if diff is None else diff
        print(f"sass_diff {src} {new_name}: " + (
            f"identical to the earlier build, {len(old)} SASS lines"
            if diff is None else f"differs at line {diff[0]}: old "
            f"{diff[1]!r}, new {diff[2]!r}"), flush=True)
        if diff is not None:
            raise AssertionError(f"{src}: the float32 instance "
                                 f"{new_name} changed")
    return out


# ------------------------------------------------------------ conv kernels
CONV_KERNELS = ("matmul_stats", "conv3x3_stats", "bn_fwd_stats",
                "bn_bwd_stats")


def resnet_model():
    """ResNet-50 at full width (224 px, 1000 classes, s2d stem) through
    the DSL, with both fusions of the JAX package on: ``fuse_conv_bn=
    "all"`` and ``fused_bn_impl="pallas"``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import resnet

    _fresh(paddle)
    paddle.init(seed=SEED, fuse_conv_bn="all", fused_bn_impl="pallas")
    cost, _ = resnet.build(depth=50, image_size=RESNET_IMAGE,
                           num_classes=RESNET_CLASSES, space_to_depth=True)
    return paddle, paddle.Topology(cost)


def resnet_shapes(topo, batch):
    """The shapes each conv-slice kernel meets in one training step of
    ``topo`` at ``batch``, with their counts: kernel 8 (P, Ci, Co), kernel
    9 (N, H, W, Ci, Co), kernels 7a and 7b (N, H, W, C) of the relu batch
    norms (the linear ones take the plain statistics)."""
    from collections import Counter

    conv1, conv3, bn = Counter(), Counter(), Counter()
    for spec in topo.specs:
        if spec.kind == "conv_bn":
            h, w, ci = topo.shapes[spec.inputs[0]]
            co = spec.attrs["num_filters"]
            if spec.attrs.get("filter_size", 1) == 1:
                conv1[(batch * h * w, ci, co)] += 1
            else:
                conv3[(batch, h, w, ci, co)] += 1
        elif spec.kind == "batch_norm" and spec.attrs.get("act") == "relu":
            bn[(batch,) + tuple(topo.shapes[spec.inputs[0]])] += 1
    return conv1, conv3, bn


def _rel_err(got, ref) -> float:
    return ((got - ref).abs().max().item()
            / max(1.0, ref.abs().max().item()))


def _hold(what, pairs):
    """Each (name, kernel value, plain value) within TOL of max(1, max
    |plain|), finite; returns (max abs error, max relative error)."""
    worst_abs = worst_rel = 0.0
    for name, got, ref in pairs:
        rel = _rel_err(got, ref)
        if not (rel <= TOL and torch.isfinite(got).all()):
            raise AssertionError(f"{what}: {name} disagrees with the plain "
                                 f"version: {rel} > {TOL} of max(1, max "
                                 f"|ref|)")
        worst_abs = max(worst_abs, (got - ref).abs().max().item())
        worst_rel = max(worst_rel, rel)
    return worst_abs, worst_rel


def _grad_hold(what, fn, leaves, gen):
    """The kernel route's autograd Function against autograd through the
    plain version: ``fn(leaves, impl)`` returns outputs; cotangents on
    each; the gradients of every leaf within TOL of max(1, max |ref|)."""
    outs = {impl: fn(leaves, impl) for impl in ("cuda", "torch")}
    cots = [torch.randn(o.shape, device=o.device, generator=gen)
            for o in outs["torch"]]
    grads = {impl: torch.autograd.grad(o, leaves, cots)
             for impl, o in outs.items()}
    return _hold(what, [(f"d{i}", g, r) for i, (g, r) in enumerate(
        zip(grads["cuda"], grads["torch"]))])


def conv_phase(dev, gen, flush):
    """Kernels 7a, 7b, 8 and 9 against their plain versions at every
    distinct shape ResNet-50 gives them at batch RESNET_BATCH, at ragged
    shapes and (7a, 7b) at rank 2; 7b's relu boundary; the autograd
    Functions' gradients; then each shape's device time (``time_ms(lead=
    True)``) beside its bound, the plain version's and a library
    yardstick the port never calls (``torch.var_mean``;
    ``torch.batch_norm_backward_reduce``, which takes the same two sums
    without the relu mask; ``torch.mm`` and ``F.conv2d`` alone, the
    products' floors).  Returns per kernel its representative shape's
    numbers and the sums over one step's launches."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import conv_bn as cb
    from paddle_tpu_torch.ops import fused_bn as fb

    _, topo = resnet_model()
    conv1, conv3, bn = resnet_shapes(topo, RESNET_BATCH)
    counts = {"matmul_stats": sum(conv1.values()),
              "conv3x3_stats": sum(conv3.values()),
              "bn_fwd_stats": sum(bn.values()),
              "bn_bwd_stats": sum(bn.values())}
    print(f"ResNet-50 at batch {RESNET_BATCH}: launches a step by the "
          f"graph {counts}; distinct shapes: kernel 8 {len(conv1)}, "
          f"kernel 9 {len(conv3)}, kernels 7a/7b {len(bn)}", flush=True)
    if counts != {"matmul_stats": 30, "conv3x3_stats": 16,
                  "bn_fwd_stats": 4, "bn_bwd_stats": 4}:
        raise AssertionError(f"the graph's launch counts {counts}")

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    errs = {k: (0.0, 0.0) for k in CONV_KERNELS}

    def note(k, e):
        errs[k] = (max(errs[k][0], e[0]), max(errs[k][1], e[1]))

    def bn_args(shape):
        c = shape[-1]
        x = randn(*shape)
        x2 = x.view(-1, c)
        mean = x2.mean(0)
        inv = torch.rsqrt(x2.var(0, unbiased=False) + 1e-5)
        w = randn(c, scale=0.5) * inv
        b = randn(c, scale=0.2) - mean * w
        return x2, randn(*x2.shape), w, b, mean, inv

    # ---- values at every shape, ragged shapes and rank 2
    for shape in list(bn) + [(3, 37, 41, 64), (6272, 512), (1337, 40)]:
        x2, dout, w, b, mean, inv = bn_args(shape)
        note("bn_fwd_stats", _hold(f"bn_fwd_stats {shape}", zip(
            ("sum x", "sum x^2"), fb.bn_fwd_stats_cuda(x2),
            fb._fwd_stats_ref(x2))))
        for relu in (True, False):
            note("bn_bwd_stats", _hold(
                f"bn_bwd_stats {shape} relu={relu}",
                zip(("sum dy", "sum dy*xhat"),
                    fb.bn_bwd_stats_cuda(dout, x2, w, b, mean, inv, relu),
                    fb._bwd_stats_ref(dout, x2, w, b, mean, inv, relu))))
    # the relu boundary: b = -fl(x w) on one element of each channel, so
    # the fold is exactly 0 there and relu drops it; its dout is large,
    # so a kernel that kept it would miss by ~1000
    x2, dout, w, b, mean, inv = bn_args((4096, 96))
    rows = torch.randint(0, 4096, (96,), device=dev, generator=gen)
    cols = torch.arange(96, device=dev)
    b = -(x2[rows, cols] * w)
    dout[rows, cols] = 1000.0
    if not bool((fb._fold(x2, w, b)[rows, cols] == 0).all()):
        raise AssertionError("relu boundary case: the fold is not 0")
    e = _hold("bn_bwd_stats relu boundary", zip(
        ("sum dy", "sum dy*xhat"),
        fb.bn_bwd_stats_cuda(dout, x2, w, b, mean, inv, True),
        fb._bwd_stats_ref(dout, x2, w, b, mean, inv, True)))
    note("bn_bwd_stats", e)
    print(f"bn_bwd_stats relu boundary (96 folds exactly 0, dout 1000 "
          f"there): dropped as the forward drops them, error {e[1]:.1e} "
          f"of max(1, max |ref|)", flush=True)
    for p, ci, co in list(conv1) + [(1000, 37, 70), (4099, 64, 200)]:
        x2, w2 = randn(p, ci), randn(ci, co, scale=ci ** -0.5)
        note("matmul_stats", _hold(f"matmul_stats {(p, ci, co)}", zip(
            ("y", "s", "ss"), cb.matmul_stats_cuda(x2, w2),
            cb._matmul_stats_ref(x2, w2))))
    for n, h, w_, ci, co in list(conv3) + [(3, 7, 9, 5, 7),
                                           (2, 13, 11, 64, 72)]:
        x4 = randn(n, h, w_, ci)
        w4 = randn(3, 3, ci, co, scale=(9 * ci) ** -0.5)
        note("conv3x3_stats", _hold(
            f"conv3x3_stats {(n, h, w_, ci, co)}",
            zip(("y", "s", "ss"), cb.conv3x3_stats_cuda(x4, w4),
                cb._conv3x3_stats_ref(x4, w4))))
    # ---- gradients of the autograd Functions
    x = randn(16, 28, 28, 128).requires_grad_(True)
    sc = (randn(128, scale=0.2) + 1).requires_grad_(True)
    bi = randn(128, scale=0.2).requires_grad_(True)
    note("bn_bwd_stats", _grad_hold(
        "bn_act_train gradients", lambda lv, impl: fb.bn_act_train(
            *lv, 1e-5, "relu", impl), [x, sc, bi], gen))
    x2 = randn(4096, 256).requires_grad_(True)
    w2 = randn(256, 512, scale=1 / 16).requires_grad_(True)
    note("matmul_stats", _grad_hold(
        "matmul_stats gradients", lambda lv, impl: cb.matmul_stats(
            *lv, impl), [x2, w2], gen))
    x4 = randn(8, 14, 14, 256).requires_grad_(True)
    w4 = randn(3, 3, 256, 256, scale=1 / 48).requires_grad_(True)
    note("conv3x3_stats", _grad_hold(
        "conv3x3_stats gradients", lambda lv, impl: cb.conv3x3_stats(
            *lv, impl), [x4, w4], gen))
    del x, x2, w2, x4, w4
    torch.cuda.synchronize()
    print("conv kernels against their plain versions (values at every "
          "ResNet-50 shape, ragged shapes, rank 2; gradients): worst "
          "error / max(1, max |ref|) " + ", ".join(
              f"{k} {e[1]:.1e}" for k, e in errs.items()), flush=True)

    # ---- times at every main-path shape
    rows_out = {k: [] for k in CONV_KERNELS}
    with torch.no_grad():
        for shape, count in bn.items():
            x2, dout, w, b, mean, inv = bn_args(shape)
            p, c = x2.shape
            xn = x2.view(shape).permute(0, 3, 1, 2)
            dn = dout.view(shape).permute(0, 3, 1, 2)
            rows_out["bn_fwd_stats"].append(dict(
                shape=list(shape), count=count,
                ms=time_ms(lambda: fb.bn_fwd_stats_cuda(x2), flush,
                           lead=True),
                plain_ms=time_ms(lambda: fb._fwd_stats_ref(x2), flush,
                                 lead=True),
                library_ms=time_ms(lambda: torch.var_mean(
                    x2, dim=0, correction=0), flush, lead=True),
                bound=bound(3.0 * p * c, 4.0 * (p * c + 2 * c))))
            rows_out["bn_bwd_stats"].append(dict(
                shape=list(shape), count=count,
                ms=time_ms(lambda: fb.bn_bwd_stats_cuda(
                    dout, x2, w, b, mean, inv, True), flush, lead=True),
                plain_ms=time_ms(lambda: fb._bwd_stats_ref(
                    dout, x2, w, b, mean, inv, True), flush, lead=True),
                library_ms=time_ms(lambda: torch.batch_norm_backward_reduce(
                    dn, xn, mean, inv, None, True, False, False), flush,
                    lead=True),
                bound=bound(8.0 * p * c, 4.0 * (2 * p * c + 6 * c))))
            del x2, dout, xn, dn
        for (p, ci, co), count in conv1.items():
            x2, w2 = randn(p, ci), randn(ci, co, scale=ci ** -0.5)
            rows_out["matmul_stats"].append(dict(
                shape=[p, ci, co], count=count,
                ms=time_ms(lambda: cb.matmul_stats_cuda(x2, w2), flush,
                           lead=True),
                plain_ms=time_ms(lambda: cb._matmul_stats_ref(x2, w2),
                                 flush, lead=True),
                library_ms=time_ms(lambda: torch.mm(x2, w2), flush,
                                   lead=True),
                bound=bound(2.0 * p * ci * co + 3.0 * p * co,
                            4.0 * (p * ci + ci * co + p * co + 2 * co))))
            del x2, w2
        for (n, h, w_, ci, co), count in conv3.items():
            x4 = randn(n, h, w_, ci)
            w4 = randn(3, 3, ci, co, scale=(9 * ci) ** -0.5)
            xn, wn = x4.permute(0, 3, 1, 2), w4.permute(3, 2, 0, 1)
            p = n * h * w_
            rows_out["conv3x3_stats"].append(dict(
                shape=[n, h, w_, ci, co], count=count,
                ms=time_ms(lambda: cb.conv3x3_stats_cuda(x4, w4), flush,
                           lead=True),
                plain_ms=time_ms(lambda: cb._conv3x3_stats_ref(x4, w4),
                                 flush, lead=True),
                library_ms=time_ms(lambda: F.conv2d(xn, wn, padding=1),
                                   flush, lead=True),
                bound=bound(2.0 * p * 9 * ci * co + 3.0 * p * co,
                            4.0 * (p * ci + 9 * ci * co + p * co
                                   + 2 * co))))
            del x4, w4, xn, wn
    torch.cuda.empty_cache()
    library = {"bn_fwd_stats": "torch.var_mean",
               "bn_bwd_stats": "torch.batch_norm_backward_reduce (the two "
                               "sums, no relu mask)",
               "matmul_stats": "torch.mm alone (the product's floor)",
               "conv3x3_stats": "F.conv2d alone (the conv's floor)"}
    # the issue's representative shapes: res2 expand, res2 3x3, the stem
    rep = {"matmul_stats": [RESNET_BATCH * 56 * 56, 64, 256],
           "conv3x3_stats": [RESNET_BATCH, 56, 56, 64, 64],
           "bn_fwd_stats": [RESNET_BATCH, 112, 112, 64],
           "bn_bwd_stats": [RESNET_BATCH, 112, 112, 64]}
    out = {}
    for k, rows in rows_out.items():
        for r in rows:
            b_ms, b_by = r.pop("bound")
            r.update(bound_ms=b_ms, bound_by=b_by)
            print(f"{k} {r['shape']} x{r['count']} a step: ms {r['ms']:.4f}"
                  f"  bound_ms {b_ms:.4f} ({b_by})  plain_ms "
                  f"{r['plain_ms']:.4f}  library_ms {r['library_ms']:.4f} "
                  f"({library[k]})", flush=True)
        main = next(r for r in rows if r["shape"] == rep[k])
        step = {f: sum(r[f] * r["count"] for r in rows)
                for f in ("ms", "bound_ms", "plain_ms", "library_ms")}
        print(f"{k}: one step's {counts[k]} launches sum to ms "
              f"{step['ms']:.3f}, bound {step['bound_ms']:.3f}, plain "
              f"{step['plain_ms']:.3f}, library {step['library_ms']:.3f}",
              flush=True)
        out[k] = dict(ms=main["ms"], plain_ms=main["plain_ms"],
                      bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                      library_ms=main["library_ms"], library=library[k],
                      max_abs_err=errs[k][0], max_rel_err=errs[k][1],
                      shape=main["shape"], per_step=step, shapes=rows)
    return out


# -------------------------------------------------------------- ResNet path
def resnet_values(topo, seed: int) -> dict:
    """A numpy parameter tree for ResNet from a seed: He-normal conv
    kernels, N(0, 1/fan_in) fc weights, batch-norm scales 1 + N(0, 0.1^2),
    biases N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    vals = {}
    for spec in topo.specs:
        for p in topo.param_specs[spec.name]:
            if p.is_state:
                continue
            shape = tuple(p.shape)
            if len(shape) == 4:
                std = (2.0 / (shape[0] * shape[1] * shape[2])) ** 0.5
            elif len(shape) == 2:
                std = shape[0] ** -0.5
            else:
                std = 0.1
            v = rng.standard_normal(shape, dtype=np.float32) * std
            if p.name == "scale":
                v += 1.0
            vals.setdefault(spec.name, {})[p.name] = v
    return vals


def resnet_feed(b, seed=SEED):
    """Seeded images in [0, 1) and labels, as ``bench_resnet`` makes
    them."""
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(b, RESNET_IMAGE, RESNET_IMAGE, 3)
            .astype(np.float32),
            "label": rng.randint(0, RESNET_CLASSES, b).astype(np.int32)}


def _set_route(topo, kernel: bool) -> None:
    """The kernel route (the graph as built, ``fused_bn_impl="pallas"``)
    or the plain one, through the JAX package's own attributes:
    ``fused_bn_impl`` and every conv_bn's ``conv_bn_impl`` set to
    "xla"."""
    from paddle_tpu_torch.core import config

    config.set_option("fused_bn_impl", "pallas" if kernel else "xla")
    for spec in topo.specs:
        if spec.kind == "conv_bn":
            if kernel:
                spec.attrs.pop("conv_bn_impl", None)
            else:
                spec.attrs["conv_bn_impl"] = "xla"


def resnet_parity(paddle, topo, values, feed):
    """Batch RESNET_PARITY_BATCH, from the same weights, cuDNN
    deterministic: the kernel route against the plain one on the card -
    the first loss (1e-4 relative), every gradient (1e-3 of max(1, max
    |g|)), the moving statistics after one step (1e-4 of max(1, max
    |ref|)) and a 3-step Momentum trajectory (1e-3 relative).  The
    counters move 30 / 16 / 4 / 4 a forward-backward on the kernel route
    and not at all on the plain one.

    The plain route runs twice more on inputs that change nothing but
    float32 rounding: the images nudged by 2^-22 relative, and the batch
    in reverse order (every batch-norm sum and reduction taken in another
    order, as the kernels take them).  How far those move each number is
    float32's own spread for this net: the backward amplifies rounding
    through 50 batch norms at batch 8, so early layers' gradients move by
    ~3e-2 of max(1, max |g|).  Each number is held within the larger of
    its bound and twice that spread (for a gradient, the largest spread in
    its stage: stem, res2 to res5, head); the printout says which bound
    held where.  ``resnet_layer_parity`` holds every layer at the fixed
    bounds without the amplification."""
    from paddle_tpu_torch import ops

    per_pass = {"matmul_stats": 30, "conv3x3_stats": 16,
                "bn_fwd_stats": 4, "bn_bwd_stats": 4}
    nudged = dict(feed, image=feed["image"] * np.float32(1 + 2 ** -22))
    reversed_ = {k: np.ascontiguousarray(v[::-1]) for k, v in feed.items()}
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for name, kernel, fd in (("kernel", True, feed),
                                 ("plain", False, feed),
                                 ("nudged", False, nudged),
                                 ("reversed", False, reversed_)):
            _set_route(topo, kernel)
            ops.reset_launch_counts()
            tr = paddle.trainer.SGD(topo, paddle.parameters.from_numpy(
                topo, values), paddle.optimizer.Momentum(
                    learning_rate=RESNET_LR, momentum=0.9))
            loss, grads = tr.forward_backward(fd)
            state = tr.model_state
            tr.model_state = tr.topology.create_state()
            losses = []
            tr.train(lambda: iter([fd] * 3), event_handler=lambda e: (
                losses.append(e.cost)
                if isinstance(e, paddle.event.EndIteration) else None))
            runs[name] = (float(loss), grads, state, losses)
            del tr
            got = {k: ops.launch_counts()[k] for k in per_pass}
            want = {k: 4 * n if kernel else 0 for k, n in per_pass.items()}
            if got != want:
                raise AssertionError(f"ResNet parity, {name} route: "
                                     f"launches {got}, expected {want}")
    finally:
        _set_route(topo, True)
        torch.backends.cudnn.deterministic = False
    (loss_k, grads_k, state_k, traj_k), (loss_t, grads_t, state_t,
                                         traj_t) = (runs["kernel"],
                                                    runs["plain"])
    spread_runs = [runs["nudged"], runs["reversed"]]

    def stage(lname):
        return lname[:4] if lname.startswith("res") else (
            "stem" if lname.startswith("stem") else "head")

    checks = []     # (what, error, spread, fixed bound)
    checks.append(("first loss", _rel(loss_k, loss_t), max(
        _rel(r[0], loss_t) for r in spread_runs), 1e-4))
    grad_spread, grad_err = {}, {}
    for lname, ps in grads_t.items():
        grad_err[lname] = max(_rel_err(grads_k[lname][p], r)
                              for p, r in ps.items())
        sp = max(_rel_err(run[1][lname][p], r) for run in spread_runs
                 for p, r in ps.items())
        grad_spread[stage(lname)] = max(grad_spread.get(stage(lname), 0.0),
                                        sp)
    for lname, err in grad_err.items():
        checks.append((f"d {lname}", err, grad_spread[stage(lname)], 1e-3))
    for lname, ks in state_t.items():
        spread = max(_rel_err(run[2][lname][k], r) for run in spread_runs
                     for k, r in ks.items())
        err = max(_rel_err(state_k[lname][k], r) for k, r in ks.items())
        checks.append((f"moving statistics {lname}", err, spread, 1e-4))
    if len(traj_k) != 3:
        raise AssertionError(f"ResNet Momentum trajectory {traj_k}")
    checks.append(("3-step Momentum losses",
                   max(_rel(a, b) for a, b in zip(traj_k, traj_t)),
                   max(_rel(a, b) for run in spread_runs
                       for a, b in zip(run[3], traj_t)), 1e-3))
    held_fixed, held_spread = [], []
    for what, err, spread, fixed in checks:
        if err <= fixed:
            held_fixed.append(what)
        elif err <= 2 * spread:
            held_spread.append((what, err, spread))
        else:
            raise AssertionError(
                f"ResNet parity: {what}: kernel route vs plain {err:.3e}, "
                f"beyond its bound {fixed} and twice float32's spread "
                f"{spread:.3e} (the plain route on nudged or reversed "
                f"inputs)")
    worst = max(checks[1:-1], key=lambda c: c[1])
    print(f"ResNet-50 parity at batch {len(feed['label'])} x "
          f"{RESNET_IMAGE}^2, kernel route vs the plain route (fused_bn_impl"
          f" and conv_bn_impl 'xla'): first loss {loss_k:.6f} vs "
          f"{loss_t:.6f} ({_rel(loss_k, loss_t):.2e} relative); 3-step "
          f"Momentum losses {[round(x, 6) for x in traj_k]} vs "
          f"{[round(x, 6) for x in traj_t]}; worst {worst[0]} at "
          f"{worst[1]:.2e} (spread {worst[2]:.2e}); {len(held_fixed)} of "
          f"{len(checks)} numbers within their fixed bounds, "
          f"{len(held_spread)} within twice the spread; by stage, the "
          f"gradients' spread " + ", ".join(
              f"{k} {v:.1e}" for k, v in grad_spread.items())
          + "; held by the spread: " + ", ".join(
              f"{w} {e:.1e} (spread {sp:.1e})"
              for w, e, sp in held_spread[:12]), flush=True)
    return {"loss_rel": checks[0][1], "grad_rel": max(
                c[1] for c in checks if c[0].startswith("d ")),
            "state_rel": max(c[1] for c in checks
                             if c[0].startswith("moving")),
            "traj_rel": checks[-1][1],
            "held_fixed": len(held_fixed),
            "held_spread": [list(h) for h in held_spread],
            "grad_spread_by_stage": grad_spread}


def resnet_layer_parity(paddle, topo, values, feed, gen):
    """Each layer whose route differs (the 46 conv_bn layers and the 7
    batch norms) on the same inputs, the plain route's own activations at
    batch RESNET_PARITY_BATCH: the kernel route against the plain one on
    its output and moving statistics (1e-4 of max(1, max |ref|)) and,
    under one random cotangent, the gradients of its parameters and input
    (1e-3 of max(1, max |g|)), with no amplification through the rest of
    the net.

    The two routes' statistics differ by rounding, so a relu output whose
    fold lies within a rounding of 0 can be kept by one route and dropped
    by the other; its gradient then differs by its whole cotangent.  Such
    flips must be rare (at most 1e-5 of the outputs) and tiny (the kept
    value within 1e-4 of max(1, max |y|)), and the cotangent is zero at
    them."""
    from paddle_tpu_torch.core.registry import ApplyContext, get_layer_def

    params = paddle.parameters.from_numpy(topo, values).values
    state = topo.create_state()
    names = [s.name for s in topo.specs if s.kind != "data"]
    _set_route(topo, False)
    try:
        with torch.no_grad():
            acts, _ = topo.forward(params, state, feed, train=True,
                                   outputs=names)
        worst = {"output": (0.0, ""), "state": (0.0, ""),
                 "grad": (0.0, "")}
        n = flips = 0
        for spec in topo.specs:
            if spec.kind not in ("conv_bn", "batch_norm"):
                continue
            x = acts[spec.inputs[0]]
            run = {}
            for kernel in (True, False):
                _set_route(topo, kernel)
                ctx = ApplyContext(train=True, device=x.device)
                ctx.state_in, ctx._cur_layer = state, spec.name
                xi = x.detach().requires_grad_(True)
                lp = {k: v.detach().requires_grad_(True)
                      for k, v in params[spec.name].items()}
                y = get_layer_def(spec.kind).apply(spec.attrs, lp, [xi],
                                                   ctx)
                run[kernel] = (y, ctx.state_out[spec.name], lp, xi)
            yk, yp = run[True][0], run[False][0]
            flip = (yk > 0) != (yp > 0)
            n_flip = int(flip.sum())
            if n_flip:
                kept = torch.maximum(yk, yp)[flip].abs().max().item()
                if (n_flip > 1e-5 * flip.numel()
                        or kept > TOL * max(1.0, yp.abs().max().item())):
                    raise AssertionError(
                        f"ResNet layer parity: {spec.name}: relu decides "
                        f"{n_flip} outputs differently, the largest kept "
                        f"at {kept}")
            flips += n_flip
            cot = torch.randn(yp.shape, device=yp.device, generator=gen)
            cot[flip] = 0.0
            grads = {}
            for kernel, (y, _, lp, xi) in run.items():
                g = torch.autograd.grad(y, list(lp.values()) + [xi], cot)
                grads[kernel] = dict(zip(list(lp) + ["input"], g))
            checks = [("output", spec.name, yk.detach(), yp.detach(), TOL)]
            checks += [("state", f"{spec.name}.{k}", run[True][1][k], v,
                        TOL) for k, v in run[False][1].items()]
            checks += [("grad", f"{spec.name} d{k}", grads[True][k], v,
                        1e-3) for k, v in grads[False].items()]
            for kind, what, a, r, bound_ in checks:
                err = _rel_err(a, r)
                if not (err <= bound_ and torch.isfinite(a).all()):
                    raise AssertionError(f"ResNet layer parity: {what}: "
                                         f"kernel route vs plain {err} > "
                                         f"{bound_}")
                worst[kind] = max(worst[kind], (err, what))
            n += 1
            del run, grads
    finally:
        _set_route(topo, True)
    print(f"ResNet-50 layer by layer at batch {len(feed['label'])} ({n} "
          f"layers whose route differs, each on the plain route's inputs): "
          f"worst output {worst['output'][1]} {worst['output'][0]:.1e}, "
          f"moving statistics {worst['state'][1]} {worst['state'][0]:.1e} "
          f"(bound {TOL}); worst gradient {worst['grad'][1]} "
          f"{worst['grad'][0]:.1e} (bound 1e-3); relu decided {flips} "
          f"outputs differently (folds within a rounding of 0, cotangent "
          f"zero there)", flush=True)
    return dict({k: v[0] for k, v in worst.items()}, relu_flips=flips)


# device kernels of a ResNet step by part, from their names: the port's
# own kernels; cuDNN's and cuBLAS's products (the plain convs, the fused
# convs' backward, and fc's ~0.05 ms of products); pooling; the host-to-
# device copy of the feed; the rest is elementwise passes and reductions
# (batch-norm apply and backward, relu, residual adds, the loss's
# logsumexp and gather, Momentum)
_PARTS = (("the kernels (7a, 7b, 8, 9)", ("gemm_stats_kernel",
                                          "fwd_partial_kernel",
                                          "bwd_partial_kernel",
                                          "finish_kernel")),
          ("plain convs and their backward, fc (cuDNN, cuBLAS)",
           ("conv", "gemm", "xmma", "cudnn", "cutlass", "wgrad", "dgrad",
            "implicit", "winograd", "fft", "sm90", "sm80", "ampere")),
          ("pool", ("pool", "Pool")),
          ("feed copy (host to device)", ("Memcpy HtoD",)))
_REST = ("elementwise and reductions (BN apply and backward, relu, adds, "
         "loss, Momentum)")


def resnet_breakdown(trainer, feed):
    """Where one ResNet step's time goes: the step and the Momentum update
    alone on CUDA events (median of 3 interleaved rounds after a warm
    one); the step's device time by part from ``torch.profiler``, by
    kernel name (``_PARTS``), and the device's idle share."""
    _, grads = trainer.forward_backward(feed)
    t = _events_ms({
        "Momentum": lambda: trainer.optimizer.update(
            trainer._trainable, grads, trainer._opt_state,
            trainer.parameters.meta),
        "step": lambda: trainer._step(feed)})
    del grads
    prof = profile_step(trainer, feed)
    parts = {name: 0.0 for name, _ in _PARTS}
    parts[_REST] = 0.0
    for kname, (ms, _) in prof["per_name"].items():
        for name, keys in _PARTS:
            if any(k in kname for k in keys):
                parts[name] += ms
                break
        else:
            parts[_REST] += ms
    step = t["step"]
    print(f"ResNet-50 step breakdown at batch {len(feed['label'])}: step "
          f"{step:.1f} ms (CUDA events); Momentum alone {t['Momentum']:.1f}"
          f" ms; device time by part (torch.profiler, one step of "
          f"{prof['step_ms']:.1f} ms): " + "; ".join(
              f"{k} {v:.1f} ms ({v / prof['step_ms']:.0%})"
              for k, v in parts.items()) + f"; device idle "
          f"{prof['step_ms'] - prof['busy_ms']:.1f} ms", flush=True)
    if prof["idle_share"] is None:
        print("torch.profiler saw no device time: idle share not measured",
              flush=True)
    else:
        print(f"torch.profiler over one ResNet step: device busy "
              f"{prof['busy_ms']:.1f} of {prof['step_ms']:.1f} ms, idle "
              f"share {prof['idle_share']:.1%}; top kernels: " + "; ".join(
                  f"{nm} x{k} {ms:.1f} ms" for nm, k, ms in prof["top"]),
              flush=True)
    return dict(parts, step_ms=step, momentum_ms=t["Momentum"],
                busy_ms=prof["busy_ms"], profiled_step_ms=prof["step_ms"],
                idle_share=prof["idle_share"])


def resnet_path():
    """The conv slice's main path: ResNet-50 at full width, kernel-route
    parity at batch RESNET_PARITY_BATCH, then ``trainer.SGD.train`` with
    Momentum(RESNET_LR, 0.9) at RESNET_BATCH x RESNET_IMAGE^2, the launch
    counts a step, a breakdown, and ``SGD.test`` on the trained state."""
    from paddle_tpu_torch import ops

    paddle, topo = resnet_model()
    values = resnet_values(topo, SEED + 4)
    n_params = sum(v.size for ps in values.values() for v in ps.values())
    print(f"ResNet-50: {RESNET_IMAGE} px, {RESNET_CLASSES} classes, s2d "
          f"stem, fuse_conv_bn='all', fused_bn_impl='pallas'; "
          f"{n_params / 1e6:.1f}M float32 parameters from a numpy seed; "
          f"cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, "
          f"cuda.matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}",
          flush=True)
    parity_feed = resnet_feed(RESNET_PARITY_BATCH, SEED + 5)
    torch.backends.cudnn.deterministic = True
    try:
        layers = resnet_layer_parity(paddle, topo, values, parity_feed,
                                     torch.Generator(device="cuda")
                                     .manual_seed(SEED))
    finally:
        torch.backends.cudnn.deterministic = False
    parity = dict(resnet_parity(paddle, topo, values, parity_feed),
                  layers=layers)
    torch.cuda.empty_cache()
    trainer = paddle.trainer.SGD(topo, paddle.parameters.from_numpy(
        topo, values), paddle.optimizer.Momentum(learning_rate=RESNET_LR,
                                                 momentum=0.9))
    feed = resnet_feed(RESNET_BATCH)
    losses, step_s, warm, peak_gb, launches = train_steps(
        "ResNet-50", paddle, trainer, feed, RESNET_STEPS, "matmul_stats",
        30, falling=False)
    per_step = {k: launches[k] / RESNET_STEPS for k in CONV_KERNELS}
    if per_step != {"matmul_stats": 30, "conv3x3_stats": 16,
                    "bn_fwd_stats": 4, "bn_bwd_stats": 4}:
        raise AssertionError(f"ResNet-50 launches a step {per_step}")
    print(f"ResNet-50 training: {RESNET_STEPS} Momentum steps (lr "
          f"{RESNET_LR}, 0.9) at batch {RESNET_BATCH} x {RESNET_IMAGE}^2, "
          f"losses {[round(x, 5) for x in losses]}; step time first "
          f"{step_s[0] * 1e3:.1f} ms, median after it {warm * 1e3:.1f} ms = "
          f"{RESNET_BATCH / warm:.1f} images/s (smoke figure, not a "
          f"benchmark); peak memory {peak_gb:.2f} GB; launches a step "
          f"{per_step}", flush=True)
    breakdown = resnet_breakdown(trainer, feed)
    ops.reset_launch_counts()
    result = trainer.test(lambda: iter([resnet_feed(32, SEED + 6)]))
    eval_launches = {k: ops.launch_counts()[k] for k in CONV_KERNELS}
    if not np.isfinite(result.cost) or any(eval_launches.values()):
        raise AssertionError(f"ResNet-50 eval: cost {result.cost}, "
                             f"launches {eval_launches}")
    print(f"ResNet-50 eval (SGD.test, batch 32, the moving statistics): "
          f"cost {result.cost:.5f}, no kernel launched", flush=True)
    return {"launches": launches, "losses": losses, "step_ms": warm * 1e3,
            "first_step_ms": step_s[0] * 1e3,
            "images_per_s": RESNET_BATCH / warm, "peak_gb": peak_gb,
            "parity": parity, "breakdown": breakdown,
            "eval_cost": result.cost}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import _build
    # the plain versions are the reference: full float32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)

    t0 = time.perf_counter()
    logs = _build.build(["flash_fwd", "flash_bwd", "paged_decode",
                         "rnn_step", "bn_stats", "conv_bn", "flash_variants"])
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
    bwd16 = flash_bwd_bf16_phase(dev, gen, flush)
    rnn = rnn_phase(dev, gen, flush)
    rnn16 = rnn_bf16_phase(dev, gen, flush)
    conv = conv_phase(dev, gen, flush)
    var = variants_phase(dev, gen, flush)
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
    torch.cuda.empty_cache()
    nmt = nmt_path()
    torch.cuda.empty_cache()
    lstm = lstm_path()
    torch.cuda.empty_cache()
    # the bf16 policy slice: the LM on kernels 1, 2 and 3 at bf16 (their
    # times at the training shape from the bf16 backward phase)
    lm16 = lm_bf16_path(bwd16["fwd_ms"] + bwd16["dkdv"]["ms"]
                        + bwd16["dq"]["ms"], train)
    torch.cuda.empty_cache()
    rnn16_paths = rnn_bf16_paths()
    torch.cuda.empty_cache()
    mixed = mixed_skip_phase(dev)
    torch.cuda.empty_cache()
    sass = sass_phase()
    resnet = resnet_path()
    torch.cuda.empty_cache()
    sweep_launches, sweep_rows = sweep_path()
    merge_sweep_times(var, sweep_rows)
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
        {"name": "lstm_step", "route": "cuda",
         "source": "paddle_tpu_torch/ops/csrc/rnn_step.cu",
         "replaces": "paddle_tpu/ops/fused_rnn.py:44",
         "launches": lstm["launches"]["lstm_step"], **rnn["lstm"]},
        {"name": "gru_step", "route": "cuda",
         "source": "paddle_tpu_torch/ops/csrc/rnn_step.cu",
         "replaces": "paddle_tpu/ops/fused_rnn.py:144",
         "launches": nmt["launches"]["gru_step"], **rnn["gru"]},
        {"name": "bn_fwd_stats", "route": "cuda",
         "source": "paddle_tpu_torch/ops/csrc/bn_stats.cu",
         "replaces": "paddle_tpu/ops/fused_bn.py:58",
         "launches": resnet["launches"]["bn_fwd_stats"],
         **conv["bn_fwd_stats"]},
        {"name": "bn_bwd_stats", "route": "cuda",
         "source": "paddle_tpu_torch/ops/csrc/bn_stats.cu",
         "replaces": "paddle_tpu/ops/fused_bn.py:145",
         "launches": resnet["launches"]["bn_bwd_stats"],
         **conv["bn_bwd_stats"]},
        {"name": "matmul_stats", "route": "cuda",
         "source": "paddle_tpu_torch/ops/csrc/conv_bn.cu",
         "replaces": "paddle_tpu/ops/conv_bn.py:46",
         "launches": resnet["launches"]["matmul_stats"],
         **conv["matmul_stats"]},
        {"name": "conv3x3_stats", "route": "cuda",
         "source": "paddle_tpu_torch/ops/csrc/conv_bn.cu",
         "replaces": "paddle_tpu/ops/conv_bn.py:180",
         "launches": resnet["launches"]["conv3x3_stats"],
         **conv["conv3x3_stats"]},
        dict(var["kernel1_bf16"]["tool"], name="flash_fwd_bf16",
             route="cuda", source="paddle_tpu_torch/ops/csrc/flash_fwd.cu",
             replaces="paddle_tpu/ops/flash_attention.py:90",
             launches=lm16["bf16"]["launches"]["flash_fwd_bf16"],
             launches_mixed=lm16["mixed"]["launches"]["flash_fwd_bf16"],
             launches_sweep=sweep_launches["flash_fwd"],
             lm_shape=var["kernel1_bf16"]["lm"]),
        {"name": "flash_bwd_dkdv_bf16", "route": "cuda",
         "source": "paddle_tpu_torch/ops/csrc/flash_bwd.cu",
         "replaces": "paddle_tpu/ops/flash_attention.py:285",
         "launches": lm16["bf16"]["launches"]["flash_bwd_dkdv_bf16"],
         "launches_mixed": lm16["mixed"]["launches"]["flash_bwd_dkdv_bf16"],
         **{k: v for k, v in bwd16["dkdv"].items()},
         "shape": bwd16["shape"]},
        {"name": "flash_bwd_dq_bf16", "route": "cuda",
         "source": "paddle_tpu_torch/ops/csrc/flash_bwd.cu",
         "replaces": "paddle_tpu/ops/flash_attention.py:370",
         "launches": lm16["bf16"]["launches"]["flash_bwd_dq_bf16"],
         "launches_mixed": lm16["mixed"]["launches"]["flash_bwd_dq_bf16"],
         **{k: v for k, v in bwd16["dq"].items()},
         "shape": bwd16["shape"]},
        dict(rnn16["lstm"]["x bfloat16, mask float32"], name="lstm_step_bf16",
             route="cuda", source="paddle_tpu_torch/ops/csrc/rnn_step.cu",
             replaces="paddle_tpu/ops/fused_rnn.py:44",
             launches=rnn16_paths["lstm_route"]["launches"]["lstm_step_bf16"],
             instances=rnn16["lstm"]),
        dict(rnn16["gru"]["x bfloat16, mask float32"], name="gru_step_bf16",
             route="cuda", source="paddle_tpu_torch/ops/csrc/rnn_step.cu",
             replaces="paddle_tpu/ops/fused_rnn.py:144",
             launches=rnn16_paths["nmt"]["launches"]["gru_step_bf16"],
             instances=rnn16["gru"]),
        dict(var["variants"]["D bf16+exp2+split bq128 bk64"]["tool"],
             name="flash_variants", route="cuda",
             source="paddle_tpu_torch/ops/csrc/flash_variants.cu",
             replaces="tools/flash_variants.py:229",
             launches=sweep_launches["flash_variants"],
             headline="D bf16+exp2+split bq128 bk64",
             max_abs_err=max(r["max_abs_err"] for vs in
                             var["variants"].values() for r in vs.values()),
             o_row_err=max(r["o_row_err"] for vs in
                           var["variants"].values() for r in vs.values())),
    ]
    print(json.dumps({"training": {
        k: train[k] for k in ("losses", "first_step_ms", "step_ms",
                              "peak_gb", "parity", "breakdown")}}),
          flush=True)
    print(json.dumps({"nmt": {
        k: nmt[k] for k in ("losses", "first_step_ms", "step_ms",
                            "tokens_per_s", "peak_gb", "parity",
                            "breakdown")},
        "lstm_route": {k: lstm[k] for k in ("losses", "first_step_ms",
                                            "step_ms", "peak_gb",
                                            "parity")}}), flush=True)
    print(json.dumps({"bf16": {
        "lm": {p: {k: v for k, v in r.items() if k != "launches"}
               for p, r in lm16.items()},
        "nmt": {k: v for k, v in rnn16_paths["nmt"].items()
                if k != "launches"},
        "lstm_route": {k: v for k, v in rnn16_paths["lstm_route"].items()
                       if k != "launches"},
        "flash_bwd": {k: bwd16[k] for k in ("planted_fault",
                                            "distance_to_plain")},
        "mixed_skip": mixed, "sass": sass}}), flush=True)
    print(json.dumps({"sweep": {"rows": sweep_rows,
                                "variants": var["variants"],
                                "sdpa_bf16_ms": var["sdpa_bf16_ms"],
                                "planted_fault": var["planted_fault"]}}),
          flush=True)
    print(json.dumps({"resnet": {
        k: resnet[k] for k in ("losses", "first_step_ms", "step_ms",
                               "images_per_s", "peak_gb", "parity",
                               "breakdown", "eval_cost")}}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
