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
   max |error| <= 1e-4, the forward (3xTF32 on the tensor cores) also per
   row against ``_tf32x3_fwd``, its own arithmetic, at the serving shapes,
   the training shape, D 64 and D 100 (every row of O within 2^-7 of its
   norm, 99% within 2^-16, the LSE within 1e-5), one TF32 product
   (``terms=1``) shown to fail that check, its registers and local memory
   (a spill fails) (the decode kernel in the pool and the slab
   layout, a hole row among its 8, at kv_splits 1, 3, 8 and the default;
   one call traced by ``torch.profiler`` must hold exactly one CUDA
   kernel, the split fold inside it; its registers and local memory, a
   spill failing); the backward kernels' dQ, dK and dV against
   autograd through the plain attention within 1e-4 * max(1, max |ref|)
   each (the training shape [8, 4096, 4, 128] causal, a kv_lens case, an
   offset-causal case, a cross-attention case, a return_lse case with a
   nonzero LSE cotangent, D 64 and D 100), and at the training shape the
   float32 (3xTF32) pair per row against a float64 backward of its own
   inputs (``_f64_bwd``; every row within 2^-7 of its norm, 99% within
   2^-16; the reading against ``_tf32x3_bwd``, its arithmetic in float32,
   printed beside it), one TF32 product (``terms=1``, a planted fault)
   shown to fail that check, their registers and local memory at both
   head tiles (a spill fails); the LSTM step (B 128, H 512) and the GRU
   step (B 256, H 512), each with a mask of about 30% zeros and at three
   other shapes (B 8; B 37 at H 128; B 5 at H 37, the kernels' one-float
   copies), on h' (and c') and on the
   autograd.Function's gradients of every input but the mask, within 1e-4
   * max(1, max |ref|), masked rows copied bit for bit, both (3xTF32 on
   the tensor cores) also per row against ``_tf32x3_lstm_step`` and
   ``_tf32x3_gru_step`` with ``terms=1`` shown to fail at B 128 and B 256,
   their registers and local memory (a spill fails); the conv kernels (7a,
   7b: the batch-norm statistic passes; 8, 9: the 1x1 and 3x3 convs with the
   statistics in their epilogue) at every distinct shape ResNet-50 gives
   them at batch 128, at ragged shapes and (7a, 7b) at rank 2, on y, sum,
   sum of squares, sum dy and sum dy * xhat within 1e-4 * max(1, max |ref|),
   and 8 and 9 (3xTF32 on the tensor cores) per row against
   ``_tf32x3_matmul_stats`` and ``_tf32x3_conv3x3_stats`` (y's rows as the
   forward's, the sums within 1e-4) with ``terms=1`` shown to fail at res2,
   their registers and local memory;
   7b's relu boundary (folds exactly 0 are dropped as the forward drops
   them); the autograd Functions' gradients against autograd through the
   plain versions; kernel 1 on bf16 q/k/v (the tensor-core kernel; O
   bf16, LSE float32) at the forward sweep's shape [8, 4096, 8, 64] and
   the LM shape [8, 4096, 4, 128], causal, against the plain attention on
   the float32 upcast with O rounded to bf16 and against ``_mma_fwd``
   (its own arithmetic; 99% of O's rows within FWD_MMA_ROW_TOL), its
   registers and local memory (a spill fails), and every variant of the
   sweep (``ops/flash_variants.py``: bf16 dots, exp2, split, pipelined,
   each at two tiles; the f32-dot instances at kernel 1's float32 tile)
   at both shapes against its plain version at the same block_k, each
   launch moving the counter: each row of O within 2^-7 of its norm
   (every element within one bf16 ulp) and O within 2^-6 * max(1, max
   |ref|), LSE within 1e-4 * max(1, max |ref|); at both shapes two
   planted faults (the first 64 keys' P . V left out of the last 64 rows;
   one 16-deep k-step of the score product left out) must fail both of
   kernel 1's checks;
4. time kernel, plain version and the library call (the forward and
   backward of ``F.scaled_dot_product_attention``, a yardstick the port
   never calls; for the recurrent steps, which no one PyTorch call
   computes, the cuBLAS product alone, ``torch.addmm``, as the product's
   floor; for the conv kernels ``torch.var_mean``,
   ``torch.batch_norm_backward_reduce``, ``torch.mm`` alone and
   ``F.conv2d`` alone (TF32 off); for kernel 1 at bf16 and the sweep's
   variants
   ``F.scaled_dot_product_attention`` at bf16; the sweep's own rows are
   timed by the sweep, phase 10), with CUDA events, L2
   flushed between launches, each beside its bound (float32 FMAs at 67
   TFLOP/s, bf16 tensor cores at 989 TFLOP/s, three TF32 products at 495
   TFLOP/s for the float32 kernels 1, 2, 3, 5, 6, 8 and 9, beside their
   FMA floor, or bytes at 3.35 TB/s); those seven also beside the parent's
   CUDA-core kernels they replaced (built from MMA_SASS_BASE's
   ``flash_bwd.cu``, ``flash_fwd.cu`` and ``conv_bn.cu`` and SASS_BASE's
   ``rnn_step.cu``: PARENT_SIMT), and the kernels
   ``torch.profiler`` sees SDPA's float32 backward launch, with its error
   against the plain version;
5. the serving path: the full-width transformer LM (vocab 32000, dim 512,
   4 x 128 heads, 8 layers, max_len 4096; random weights from a numpy
   seed) written as a checkpoint, loaded, and served through
   ``PagedDecoder`` + ``InferenceEngine`` over HTTP; 8 concurrent requests
   of 32 tokens; the flash forward and paged decode counters must move,
   and every stream must equal a plain-PyTorch (``decode_kernel="torch"``)
   run on the card except where that run's top-2 logit margin was below
   1e-4 (reported); a decode-only and a chunk iteration at 8 residents
   on the kernel path and the plain path (host clock), and the
   decode-only iteration's device idle share (``torch.profiler``);
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
   times a step, and one step under ``torch.profiler`` (idle share, the
   kernel's own device time);
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
11. the bf16 precision policy: kernels 2 and 3 at bf16 (the tensor-core
   kernels) at [8, 4096, 4, 128] causal (after the float32 backward
   checks) and at BF16_BWD_CASES (the four ragged cases, D 64, D 100),
   kernel 1's O and LSE held as in phase 3 (``_hold_fwd_bf16``), dQ,
   dK and dV held per row on the forward kernel's own O and LSE against
   ``_upcast_bwd`` (the Pallas kernels' arithmetic, float32 on the bf16
   operands; every row within 2^-7 of its norm) and ``_mma_bwd`` (the
   kernels' own, P and dS rounded to bf16; 99% of the rows within 2^-9,
   every row within 2^-7), two planted faults (the last q tile's dO
   zeroed; one 16-deep k-step of the score product left out) shown to
   fail both checks, the distance to the bf16 plain route reported, each
   kernel's registers and local memory (a spill fails), each timed beside
   its bound, the plain route's backward and SDPA's at bf16; kernels 5
   and 6 at each bf16 instance (x bf16, the mask float32 or bf16) against
   the plain step and per row against their 3xTF32 arithmetic, timed (after
   the float32 recurrent checks).  After the LSTM route: the LM under
   ``bf16`` and ``mixed`` (6 Adam steps at 8 x 4096 from the seeded weights,
   kernels 1, 2 and 3 launching their bf16 instances 8 times a step, the
   losses within LM_BF16_BAND of the plain route's, the step breakdown, idle
   share and peak memory); NMT and the LSTM route under ``bf16``
   (kernel-route parity at batch 8 within RNN_BF16_TOLS, beside it
   kernels 6 and 5 held per layer on the route's own inputs - each
   layer's first, middle and last call per row against the kernel's
   arithmetic, ``rnn_layer_holds`` - then their steps with kernels 6 and
   5 launching 100 and 200 bf16 instances a step);
   ``mixed`` on the card (an inf batch skips the step bit for bit and
   halves the loss scale); ``tools/sass_diff.py`` (the float32 CUDA-core
   instances of ``bn_stats.cu`` against
   the build of their sources before the bf16 instances, kept in
   SASS_BASE; the sweep's four f32-dot instances
   against ``flash_fwd.cu`` before its tensor-core bf16 kernel, kept in
   FWD_SASS_BASE);
12. ResNet-50 under ``bf16`` (the bench's precision): after the float32
   conv kernels, the bf16 instances of kernels 7a, 7b, 8 and 9 against
   their plain versions at every shape the bf16 path gives them, batch
   256 (``conv_phase`` on bf16: 7a's and 7b's sums within CONV_STAT_TOL
   of max(1, max |ref|) and 7b's kept count equal, at bf16's relu
   boundary too; each row of 8's and 9's y within 2^-7 of its norm,
   their statistics within CONV_STAT_TOL; 8 and 9 also at shapes with
   Ci = 4 mod 8 (their 8-byte copies); planted faults - 8's last 8 input
   channels, 8's channels 16-31 (one 16-deep k-step), one of 9's taps, 16
   input channels of one of 9's taps, 7b's mask on the float32 fold -
   shown to fail; 8's and 9's tensor-core kernels' registers and local
   memory at each copy width, a spill failing), each timed beside its
   bound (bf16 bytes, the bf16 peak), plain version and bf16 library
   call; after the float32 ResNet path, the same
   model under ``bf16`` (``resnet_bf16_path``): every fused layer at batch
   8 on the plain route's inputs within RESNET_BF16_LAYER_TOLS, 4
   Momentum steps at batch 256 with the bf16 instances launched 30 / 16 /
   4 / 4 times a step and no float32 launch, the breakdown, idle share
   and peak memory,
   ``SGD.test`` launching none; then ``bench_resnet``'s configuration
   (``bf16``, no fusion, plain statistics: no kernel of this repo) for
   the same 4 steps, as a smoke figure;
13. the fp16 precision policy (K5): the float16 instances of kernels 1
   to 3 (``flash_bwd_bf16_phase`` on float16: the LM shape and
   BF16_BWD_CASES, kernel 1's planted faults there too), 5 and 6
   (``rnn_bf16_phase``) and 7a to 9 (``conv_phase`` at batch 256), each
   held against its plain versions at HALF_TOLS' float16 limits, with
   its planted faults, its registers (a spill fails) and its time beside
   its bound (the dense 16-bit peak), plain version and the library's
   float16 call; the LM, NMT, the LSTM route and the fused ResNet-50
   under ``fp16`` (``lm_bf16_path``, ``rnn_bf16_paths`` and
   ``resnet_bf16_path`` with the policy: kernel route against plain
   route, the f16 counters' launches a step as under ``bf16``, the step
   time and breakdown; no loss scaling, so a non-finite loss is printed
   and the LM's routes are held on the steps before it); the 12 bf16
   tensor-core instances' SASS against MMA_SASS_BASE;
14. the trainer's dispatch options (``dispatch_phases``; each graph
   released and the cache emptied before the next phase): the LSTM route
   (B 128, T 100) at float32 and under ``bf16`` with ``bench_lstm``'s
   ``steps_per_dispatch=10`` - ten eager steps against one 10-step CUDA
   graph from the same state, losses and every state tensor bit for bit,
   kernel 5 executing 2000 times a replay, and held per row inside the
   capture; NMT at ``bench_nmt``'s widths over ragged batches (lengths 1
   to 50) in four buckets under ``seq_buckets="auto"``,
   ``prefetch_depth=2`` and k = 4 - bit for bit against the eager steps
   on the same padded feeds, one capture a bucket, kernel 6 executing
   2 x T a step, the padding removed; the LM at 8 x 4096 under ``fp32``
   and ``bf16``, a 2-step graph against 2 eager steps bit for bit; each
   with the eager step's ms, the chunk's ms a step
   (``timed_multi_dispatch``) and the idle share of one eager step and
   of one replay; ``remat=True`` on the LM (gradients bit for bit, the
   peak memory of each, kernel 1 16 launches a step against 8); the
   arrival counters grown on the default and the capture stream between
   two replays from one state (bit-equal); a NaN batch under
   ``check_nan_inf`` raising with the names of the loss and every
   gradient;
15. the v2 slice (``v2_slice``): the fused LM head (``ops/chunked_ce.py``)
   against the unfused head and a float64 head at [8 x 4096, 512] x
   32000 under fp32 and bf16 (each row's nll, the loss and every
   gradient; bf16-rounded logits planted once), with both heads' peak
   memory; kernels 1, 2 and 3 at bf16 at [1, 65536, 4, 128], every row
   against float64 evaluations of their functions, timed beside their
   bounds and the library's bf16 attention; ``bench.py``'s
   ``transformer_64k`` (fused head, ``bf16``) trained 4 steps, kernels
   1-3 8 launches a step, and one step profiled; the v2 golden configs
   forward and backward on the card against the CPU; each new optimizer
   in a captured 2-step chunk against its eager steps bit for bit; dropout
   and NCE drawing anew at each replay;
16. one JSON line each for the LM training, NMT and LSTM, the bf16
   policy, fp16 policy, dispatch, v2, sweep, ResNet and ResNet-under-bf16
   runs, the card line again,
   one JSON line listing each kernel's numbers and, last, ``{"ok": true,
   "device": {...}}``.

``--only=<name>[,<name>...]`` runs the setup and then only the named
phases (``dispatch`` or ``v2``, or a part of either: DISPATCH_PHASES,
V2_PHASES) and prints their JSON: a development run; the full run takes
no arguments.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout.  The tokens/s, time-to-first-token and training step times it
prints are a smoke figure, not a benchmark.
"""

from __future__ import annotations

import contextlib
import ctypes
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
    # the serving slice's model (bench.py bench_transformer's defaults),
    # its prompts and its iteration timing
    from paddle_tpu_torch.tools.decode_iters import (BLOCK, DIM, FFN_MULT,
                                                     HEADS, LAYERS, MAX_LEN,
                                                     MAX_TOKENS, SEED, SLOTS,
                                                     VOCAB, iteration_ms,
                                                     prompts, random_values)
    from paddle_tpu_torch.tools.timing import (PEAK_BF16_FLOPS,
                                               PEAK_F32_FLOPS,
                                               PEAK_TF32_FLOPS, bound,
                                               time_ms)
except ImportError as e:
    sys.exit(f"chip_smoke: run from the root of a checkout ({e})")

TOL = 1e-4
TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 8, 6, 1e-4
SERVE_KERNELS = ("flash_fwd", "paged_decode")
# the recurrent slice: bench.py bench_nmt's and bench_lstm's widths
RNN_H = 512
NMT_VOCAB, NMT_DIM, NMT_LEN, NMT_BATCH, NMT_STEPS, NMT_LR = (30000, 512, 50,
                                                             256, 4, 1e-3)
LSTM_LEN, LSTM_BATCH, LSTM_STEPS, LSTM_LR = 100, 128, 3, 2e-3
LSTM_KERNEL = "lstm_tf32_kernel"     # kernel 5's name in a profiler trace
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
# the conv slice: bench.py bench_resnet's model and optimizer, float32
RESNET_IMAGE, RESNET_CLASSES, RESNET_LR = 224, 1000, 0.1
RESNET_BATCH, RESNET_STEPS, RESNET_PARITY_BATCH = 128, 4, 8
RESNET_BF16_BATCH = 256      # bench_resnet's batch, under bf16


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- kernels
# kernel 1 at float32 (the 3xTF32 kernel) against its own arithmetic in
# plain torch, ``_tf32x3_fwd``: each row of O as the backward's rows are
# held (_tf32_holds: every row within TF32_ROW_TOL of its norm, 99% within
# TF32_ROW_Q99_TOL), the LSE within FWD_TF32_LSE_TOL of max(1, max |ref|)
# on the rows that see a key (the others carry the sentinel, below -1e29
# on both sides); one TF32 product (``terms=1``, a planted fault) must fail
# the row check
FWD_TF32_LSE_TOL = 1e-5


def _hold_fwd_tf32(fa, what, q, k, v, lens, o, lse, kw, fault=False):
    """Kernel 1's float32 O and LSE against ``_tf32x3_fwd``; with
    ``fault`` the planted fault (``terms=1``) too, which must fail.
    Returns {row_err, row_err_q99, lse_err[, terms_1_row_err,
    terms_1_row_err_q99]}."""
    ro, rlse = fa._tf32x3_fwd(q, k, v, lens, **kw)
    worst, q99, rows_ok = _tf32_holds(o, ro)
    live = rlse > -1e29
    el = ((lse - rlse)[live].abs().max().item()
          / max(1.0, rlse[live].abs().max().item())) if live.any() else 0.0
    ok = (rows_ok and el <= FWD_TF32_LSE_TOL
          and bool((lse[~live] < -1e29).all()) and torch.isfinite(o).all()
          and torch.isfinite(lse[live]).all())
    if not ok:
        raise AssertionError(
            f"{what}: kernel 1 at float32 disagrees with _tf32x3_fwd: O rows "
            f"largest {worst} (limit {TF32_ROW_TOL}), {BWD_MMA_ROW_Q:.0%} "
            f"{q99} (limit {TF32_ROW_Q99_TOL}), LSE {el} (limit "
            f"{FWD_TF32_LSE_TOL})")
    out = dict(row_err=worst, row_err_q99=q99, lse_err=el)
    if fault:
        bad, _ = fa._tf32x3_fwd(q, k, v, lens, terms=1, **kw)
        bworst, bq99, bok = _tf32_holds(bad, ro)
        if bok:
            raise AssertionError(f"{what}: the float32 forward check passes "
                                 f"the planted fault (one TF32 product): "
                                 f"{bworst}, {bq99}")
        out.update(terms_1_row_err=bworst, terms_1_row_err_q99=bq99)
        del bad
    print(f"{what} [B {q.shape[0]}, Lq {q.shape[1]}, Lk {k.shape[1]}, H "
          f"{q.shape[2]}, D {q.shape[3]}, causal {kw['causal']}, q_offset "
          f"{kw.get('q_offset', 0)}, kv_offset {kw.get('kv_offset', 0)}]: "
          f"kernel 1 at float32 (3xTF32) against _tf32x3_fwd: O rows "
          f"(largest, {BWD_MMA_ROW_Q:.0%}) {worst:.3e} {q99:.3e} (limits "
          f"{TF32_ROW_TOL:.3e}, {TF32_ROW_Q99_TOL:.3e}), LSE {el:.3e} (limit "
          f"{FWD_TF32_LSE_TOL:.0e})" + (
              f"; planted fault (one TF32 product, terms=1; must fail): O "
              f"rows {bworst:.3e} {bq99:.3e}" if fault else ""), flush=True)
    return out


def _fwd_f32_work(b, lq, h, d, pairs, kneed):
    """(flops, bytes) of kernel 1 at float32: two products over the
    visible (q, k) pairs (``pairs`` of one batch row and head); q and O,
    the keys the rows need of K and V, the LSE and kv_lens."""
    return (4.0 * d * h * b * pairs,
            4.0 * (2 * b * lq * h * d + 2 * b * kneed * h * d + b * h * lq
                   + b))


def _fwd_bounds(flops, nbytes) -> dict:
    """Kernel 1's float32 bound (three TF32 products for each float32 one
    at TF32's dense peak) and its FMA floor (67 TFLOP/s)."""
    b_ms, b_by = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
    return dict(bound_ms=b_ms, bound_by=b_by,
                fma_bound_ms=bound(flops, nbytes)[0])


def _parent_fwd(lib, q, k, v, lens, kw):
    """One launch of the parent's CUDA-core float32 forward (O, LSE)."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.core.config import LOG2E

    b, lq, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    err = lib.flash_fwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, lq, k.shape[1], h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(kw.get("q_offset", 0)), int(kw.get("kv_offset", 0)),
        int(bool(kw["causal"])), float(kw["scale"] * LOG2E),
        torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "the parent's flash_fwd_f32")
    return o, lse


def flash_phase(dev, gen, flush, parents=None):
    """Kernel 1 at float32 (the 3xTF32 kernel) at the serving shapes (B 1,
    the LM's heads, chunks of 8 to 2048 rows over a 4096-key cache) and at
    D 64 and D 100 (BF16_BWD_CASES' last two): against the plain version
    within TOL, and per row against ``_tf32x3_fwd`` (``_hold_fwd_tf32``;
    the planted fault at the 2048-row chunk and the D 64 case); its
    registers and local memory (a spill fails); each serving case timed
    beside the plain version and its bounds, the 2048-row chunk also beside
    SDPA at float32 and, from ``parents``, the parent's CUDA-core
    forward."""
    from paddle_tpu_torch.ops import flash_attention as fa

    res = fa.fwd_f32_resources()
    print("flash_fwd float32 (3xTF32) kernel's resources "
          "(cudaFuncGetAttributes): " + ", ".join(
              f"{n} {r} registers, {l_} bytes local"
              for n, (r, l_) in res.items()), flush=True)
    if any(l_ for _, l_ in res.values()):
        raise AssertionError(f"the float32 forward spills: {res}")
    parent = parent_lib(parents, "flash_fwd") if parents else None
    B, LK, D = 1, MAX_LEN, DIM // HEADS
    k = torch.randn(B, LK, HEADS, D, device=dev, generator=gen)
    v = torch.randn(B, LK, HEADS, D, device=dev, generator=gen)
    cases = [(lq, off, None) for lq in (8, 256, 2048) for off in (0, 1000)]
    cases.append((256, 1000, 1100))
    max_err, timed, tf32 = 0.0, None, {}
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
        rep = (lq, off, kv_len) == (2048, 0, None)
        tf32[f"Lq {lq} q_offset {off} kv_len {kv_len or LK}"] = (
            _hold_fwd_tf32(fa, "flash_fwd serving", q, k, v, lens, o, lse,
                           kw, fault=rep))
        ms = time_ms(lambda: fa.flash_fwd_cuda(q, k, v, lens, **kw), flush)
        plain_ms = time_ms(lambda: fa._torch_attention(q, k, v, lens, **kw),
                           flush)
        kl = kv_len or LK
        pairs = sum(min(max(off + r + 1, 0), kl) for r in range(lq))
        kneed = min(kl, off + lq)
        bnd = _fwd_bounds(*_fwd_f32_work(B, lq, HEADS, D, pairs, kneed))
        print(f"  ms {ms:.4f}  plain_ms {plain_ms:.4f}  bound_ms "
              f"{bnd['bound_ms']:.4f} ({bnd['bound_by']}, 3xTF32 at the "
              f"TF32 peak)  fma_bound_ms {bnd['fma_bound_ms']:.4f}",
              flush=True)
        if rep:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib_ms = time_ms(lambda: torch.nn.functional
                             .scaled_dot_product_attention(
                                 qt, kt, vt, is_causal=True,
                                 scale=D ** -0.5), flush)
            extra = {}
            if parent is not None:
                po, plse = _parent_fwd(parent, q, k, v, lens, kw)
                torch.cuda.synchronize()
                extra = dict(
                    parent_simt_ms=time_ms(lambda: _parent_fwd(
                        parent, q, k, v, lens, kw), flush),
                    parent_simt_err=max((po - ro).abs().max().item(),
                                        (plse - rlse).abs().max().item()))
            print(f"  library_ms (scaled_dot_product_attention at float32, "
                  f"causal, same shapes) {lib_ms:.4f}" + (
                      f"  parent_simt_ms {extra['parent_simt_ms']:.4f} (the "
                      f"parent's CUDA-core forward, max|err| "
                      f"{extra['parent_simt_err']:.3e})" if extra else ""),
                  flush=True)
            regs, local = res[f"fwd_d{D}"]
            timed = dict(lq=lq, q_offset=off, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, registers=regs,
                         local_bytes=local, **bnd, **extra)
        del o, lse, ro, rlse
    # the other head tile (D 64) and a head narrower than its tile (D 100)
    for name, b, lq, lk, h, d, causal, lens_, qo, ko, _ in BF16_BWD_CASES[-2:]:
        q, k_, v_ = (torch.randn(b, n, h, d, device=dev, generator=gen)
                     for n in (lq, lk, lk))
        lens = torch.tensor(lens_ or [lk] * b, dtype=torch.int32, device=dev)
        kw = dict(causal=causal, scale=d ** -0.5, q_offset=qo, kv_offset=ko)
        o, lse = fa.flash_fwd_cuda(q, k_, v_, lens, **kw)
        ro, rlse = fa._torch_attention(q, k_, v_, lens, return_lse=True,
                                       **kw)
        torch.cuda.synchronize()
        err = max((o - ro).abs().max().item(),
                  (lse - rlse).abs().max().item())
        if not err <= TOL:
            raise AssertionError(f"flash_fwd {name} disagrees with its "
                                 f"plain version: {err} > {TOL}")
        max_err = max(max_err, err)
        tf32[name] = _hold_fwd_tf32(fa, f"flash_fwd {name}", q, k_, v_, lens,
                                    o, lse, kw, fault=name == "D 64")
        tf32[name]["plain_max_abs_err"] = err
    timed["tf32"] = tf32
    timed["resources"] = res
    return max_err, timed


def paged_phase(dev, gen, flush):
    """Kernel 4 against its plain version at the serving shape (8 slots,
    positions 0 to 4095, row 0 a hole row on scratch block 0), in the pool
    layout and the slab layout (BS = max_len, identity table), at
    kv_splits 1, 3 (an uneven cut), 8 and the default; a ``torch.profiler``
    trace of one call, which must hold exactly one CUDA kernel (the split
    fold is inside it); the kernel's registers and local memory (a spill
    fails); then the call's time on the device (``ms``) and as the host
    paces back-to-back calls (``host_ms``), beside its bound and the plain
    version's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
        ref = plain(k_, v_, t_)
        for g in sorted({1, 3, 8, pa._default_kv_splits(t_.shape[1])}):
            out = pa.paged_decode_cuda(q, k_, v_, t_, pos, scale=scale,
                                       kv_splits=g)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            print(f"paged_decode {name} kv_splits={g} (cut to "
                  f"{max(1, min(g, t_.shape[1]))}): max|err| {err:.3e}",
                  flush=True)
            if not (err <= TOL and torch.isfinite(out).all()):
                raise AssertionError(f"paged_decode disagrees with its "
                                     f"plain version: {err} > {TOL}")
            max_err = max(max_err, err)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pa.paged_decode_cuda(q, pk, pv, table, pos, scale=scale,
                             kv_splits=splits)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    print(f"paged_decode kv_splits={splits}: one call's device activity "
          f"(torch.profiler): {kernels}", flush=True)
    if len(kernels) != 1 or "paged_decode" not in kernels[0]:
        raise AssertionError(f"one paged_decode_cuda call ran {kernels}, "
                             f"not the one kernel")
    regs, local = pa.paged_decode_resources()
    print(f"paged_decode kernel's resources (cudaFuncGetAttributes): "
          f"{regs} registers, {local} bytes local", flush=True)
    if local:
        raise AssertionError(f"paged_decode spills: {local} bytes local")

    def call():
        return pa.paged_decode_cuda(q, pk, pv, table, pos, scale=scale,
                                    kv_splits=splits)

    # on the device alone, and as the host paces back-to-back calls
    ms = time_ms(call, flush, lead=True)
    host_ms = time_ms(call, flush)
    plain_ms = time_ms(lambda: plain(pk, pv, table), flush)
    keys = sum(p + 1 for p in pos_list)
    flops = 4.0 * HEADS * D * keys
    nbytes = 4.0 * (2 * SLOTS * HEADS * D + 2 * keys * HEADS * D + SLOTS
                    + sum(-(-(p + 1) // BLOCK) for p in pos_list))
    b_ms, b_by = bound(flops, nbytes)
    print(f"paged_decode S={SLOTS} pos={pos_list} kv_splits={splits}: ms "
          f"{ms:.4f} (one launch, the fold inside; host_ms {host_ms:.4f} "
          f"as the host paces a call)  plain_ms {plain_ms:.4f}  bound_ms "
          f"{b_ms:.4f} ({b_by})", flush=True)
    return max_err, dict(ms=ms, host_ms=host_ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, kv_splits=splits,
                         pos=pos_list, registers=regs, local_bytes=local)


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


# the float32 (3xTF32) kernels against their own arithmetic in plain torch
# (``_tf32x3_fwd``, ``_tf32x3_conv3x3_stats``, ``_tf32x3_matmul_stats``,
# ``_tf32x3_gru_step``) and kernels 2 and 3 against a float64 backward of
# the same inputs (``_f64_bwd``), per row (``_row_errs``): every row within
# TF32_ROW_TOL of its norm (float32's own cancellation in dQ's early rows
# sets the largest, as at 16 bits) and 99% of the rows within
# TF32_ROW_Q99_TOL.  The limit sits between what the CPU test
# tests/test_torch_flash_tf32.py::test_one_tf32_product_fails_the_row_limit
# reads at [2, 256, 2, 128]: 3xTF32 against a float64 backward, 99% of the
# rows within 2^-19, and one TF32 product (terms=1) past 2^-12.
TF32_ROW_TOL, TF32_ROW_Q99_TOL = 2.0 ** -7, 2.0 ** -16
# the CUDA-core float32 kernels the 3xTF32 ones replaced, timed beside them:
# MMA_SASS_BASE's flash_bwd.cu (the backward pair, replaced in PR 12),
# flash_fwd.cu (kernel 1's float32 instance) and conv_bn.cu (kernels 9's
# and 8's), whose float32 instances are the SIMT kernels as they last ran
# and were pinned to the same machine code (sass_phase) until they went,
# and SASS_BASE's rnn_step.cu (kernels 6 and 5, each pinned the same way
# until its tensor-core kernel), each built as ops/_build builds a source:
# {name: (the folder of its source, its entries)}
PARENT_SIMT = {"flash_bwd": ("bd128be", ("flash_bwd_dkdv_f32",
                                         "flash_bwd_dq_f32")),
               "flash_fwd": ("bd128be", ("flash_fwd_f32",)),
               "conv_bn": ("bd128be", ("conv3x3_stats_f32",
                                       "matmul_stats_f32")),
               "rnn_step": ("", ("gru_step_f32", "lstm_step_f32"))}
# the parent entries whose arguments are not the port's: the GRU's, which
# took z and r h scratch and no split, and the LSTM's, which took no
# scratch, counters or split
PARENT_SIGNATURES = {"gru_step_f32": [ctypes.c_void_p] * 9
                     + [ctypes.c_int] * 2 + [ctypes.c_void_p],
                     "lstm_step_f32": [ctypes.c_void_p] * 8
                     + [ctypes.c_int] * 2 + [ctypes.c_void_p]}


def start_parent_builds() -> dict:
    """Start ``nvcc`` on each PARENT_SIMT source: {name: (the process, its
    .so)}."""
    import os

    from paddle_tpu_torch.ops import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    builds = {}
    for name, (folder, _) in PARENT_SIMT.items():
        so = os.path.join(_build.BUILD_DIR, f"parent_simt_{name}.so")
        builds[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
             os.path.join(SASS_BASE, folder, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    return builds


def parent_lib(builds, name):
    """The loaded library of ``start_parent_builds``' build of ``name``, its
    float32 entries typed as the port's (or as PARENT_SIGNATURES says)."""
    from paddle_tpu_torch.ops import conv_bn as cb
    from paddle_tpu_torch.ops import flash_attention as fa

    proc, so = builds[name]
    if proc.returncode is None:
        proc.log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the parent's {name}:\n"
                           f"{proc.log}")
    sigs = {**fa._SIGNATURES, **fa._BWD_SIGNATURES, **cb._SIGNATURES,
            **PARENT_SIGNATURES}
    lib = ctypes.CDLL(so)
    for entry_name in PARENT_SIMT[name][1]:
        entry = getattr(lib, entry_name)
        entry.argtypes = list(sigs[entry_name])
        entry.restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def _simt_call(lib, fa, which, q, k, v, go, lse, delta, lens, kw):
    """One launch of the parent's SIMT ``which`` ("dkdv" or "dq")."""
    from paddle_tpu_torch.ops import _build

    outs = [torch.empty_like(x) for x in ((k, v) if which == "dkdv"
                                          else (q,))]
    err = getattr(lib, f"flash_bwd_{which}_f32")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), go.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), lens.data_ptr(),
        *(x.data_ptr() for x in outs),
        *fa._bwd_args(q, k, v, go, kw["causal"], kw["scale"], 0, 0))
    _build.check(lib, err, f"the parent's flash_bwd_{which}_f32")
    return outs


def _tf32_holds(a, ref) -> tuple:
    """(largest row error, its BWD_MMA_ROW_Q quantile, whether they are
    within TF32_ROW_TOL and TF32_ROW_Q99_TOL)."""
    return _rows_hold("mma", _row_errs(a, ref, TF32_ROW_TOL), TF32_ROW_TOL,
                      TF32_ROW_Q99_TOL, BWD_MMA_ROW_Q)


def _f64_bwd(fa, q, k, v, lens, lse, delta, go, kw):
    """dQ, dK and dV, float64, of the backward kernels' own inputs (q, k, v,
    dO and the forward's LSE and delta = rowsum(dO * O), each taken as it
    is, in float64): P = exp(S scale - LSE) and dS = P (dO V^T - delta)
    under ``_visible``'s masks, one batch row at a time.  A row that cancels
    (dQ's first query rows, where dO V^T and delta are the same sum) holds
    no float32 noise here, only what the inputs carry."""
    out = [torch.empty(t.shape, dtype=torch.float64, device=t.device)
           for t in (q, k, v)]
    scale = kw["scale"]
    for i in range(q.shape[0]):
        qd, kd, vd, gd = (t[i:i + 1].double() for t in (q, k, v, go))
        mask = fa._visible(q.shape[1], k.shape[1], lens[i:i + 1],
                           kw["causal"], kw.get("q_offset", 0),
                           kw.get("kv_offset", 0), q.device)
        p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qd, kd) * scale
                      - lse[i:i + 1].double()[..., None])
        p = p.masked_fill(~mask, 0.0)
        ds = p * (torch.einsum("bqhd,bkhd->bhqk", gd, vd)
                  - delta[i:i + 1].double()[..., None])
        out[0][i:i + 1] = torch.einsum("bhqk,bkhd->bqhd", ds, kd) * scale
        out[1][i:i + 1] = torch.einsum("bhqk,bqhd->bkhd", ds, qd) * scale
        out[2][i:i + 1] = torch.einsum("bhqk,bqhd->bkhd", p, gd)
        del p, ds
    return out


def _sdpa_kernels(sdpa, qt, go_t, scale) -> list:
    """The CUDA kernels one float32 backward of ``sdpa`` launches, from
    ``torch.profiler``: [(name, calls, device ms)]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    so = sdpa(*qt, is_causal=True, scale=scale)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(so, qt, go_t)
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, ms = per.get(e.name, (0, 0.0))
            per[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    return sorted(((name, n, ms) for name, (n, ms) in per.items()),
                  key=lambda x: -x[2])


def flash_bwd_phase(dev, gen, flush, parents=None):
    """Hold the backward kernels against autograd through the plain
    attention; at the training shape hold the float32 (3xTF32) forward
    per row against ``_tf32x3_fwd`` and the backward kernels against
    ``_tf32x3_bwd``, and show that one TF32 product (``terms=1``) fails
    those checks; read their registers (a spill fails); then time forward,
    dK/dV and dQ at the training shape beside the plain version, the
    library call (whose backward kernels ``torch.profiler`` names, and
    whose error against the plain version is printed), both bounds and,
    from ``parents``, the parent's CUDA-core kernels."""
    from paddle_tpu_torch.ops import flash_attention as fa

    D = DIM // HEADS
    # name, B, Lq, Lk, H, D, causal, kv_lens, q_offset, kv_offset, LSE
    # cotangent: the LM's heads, then the float32 kernels' other head tile
    # (D 64) and a head narrower than its tile (D 100), as BF16_BWD_CASES
    cases = [
        ("training shape", TRAIN_BATCH, MAX_LEN, MAX_LEN, HEADS, D, True,
         None, 0, 0, False),
        ("kv_lens", 4, 1024, 1024, HEADS, D, True, [1024, 700, 333, 65], 0,
         0, False),
        ("offset causal", 2, 512, 1536, HEADS, D, True, None, 1000, 200,
         False),
        ("cross attention", 2, 300, 1100, HEADS, D, False, None, 0, 0,
         False),
        ("return_lse", 2, 1024, 1024, HEADS, D, True, None, 0, 0, True),
        *BF16_BWD_CASES[-2:],
    ]
    errs = {"dq": [0.0, 0.0], "dkdv": [0.0, 0.0]}   # max abs, max relative
    for name, b, lq, lk, h, d, causal, lens, qo, ko, with_lse in cases:
        q = torch.randn(b, lq, h, d, device=dev, generator=gen)
        k = torch.randn(b, lk, h, d, device=dev, generator=gen)
        v = torch.randn(b, lk, h, d, device=dev, generator=gen)
        go = torch.randn(b, lq, h, d, device=dev, generator=gen)
        gl = (torch.randn(b, h, lq, device=dev, generator=gen)
              if with_lse else None)
        lens_t = torch.tensor(lens or [lk] * b, dtype=torch.int32,
                              device=dev)
        kw = dict(causal=causal, scale=d ** -0.5, q_offset=qo,
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
        print(f"flash_bwd {name} [B {b}, Lq {lq}, Lk {lk}, H {h}, D {d}, "
              f"causal {causal}, kv_lens {lens}, q_offset {qo}, kv_offset "
              f"{ko}, g_lse {with_lse}]: " + ", ".join(line), flush=True)
        del got, ref

    B, T = TRAIN_BATCH, MAX_LEN
    q, k, v, go = (torch.randn(B, T, HEADS, D, device=dev, generator=gen)
                   for _ in range(4))
    lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    kw = dict(causal=True, scale=D ** -0.5)
    o, lse = fa.flash_fwd_cuda(q, k, v, lens, **kw)
    fwd_tf32 = _hold_fwd_tf32(fa, "flash_fwd training shape", q, k, v, lens,
                              o, lse, kw, fault=True)
    delta = (go * o).sum(-1).transpose(1, 2).contiguous()

    # the 3xTF32 kernels per row against a float64 backward of their own
    # inputs, and one TF32 product (terms=1, the planted fault) against the
    # same; their reading against _tf32x3_bwd, the kernels' arithmetic in
    # float32 (whose own cancellation noise in dQ's first query rows it
    # carries), beside it
    got = (fa.flash_bwd_dq_cuda(q, k, v, go, lse, delta, lens, **kw),
           *fa.flash_bwd_dkdv_cuda(q, k, v, go, lse, delta, lens, **kw))
    plain = _attn_grads(fa, q, k, v, lens, go, None, kw, "torch")
    ref = _f64_bwd(fa, q, k, v, lens, lse, delta, go, kw)
    model = fa._tf32x3_bwd(q, k, v, lens, o, lse, go, **kw)
    bad = fa._tf32x3_bwd(q, k, v, lens, o, lse, go, terms=1, **kw)
    torch.cuda.synchronize()
    names = ("dq", "dk", "dv")
    tf32 = {"kernels": {}, "terms_1": {}}
    for gname, a, r, mo, x, p in zip(names, got, ref, model, bad, plain):
        worst, q99, ok = _tf32_holds(a, r)
        bworst, bq99, bok = _tf32_holds(x, r)
        mworst, mq99, _ = _tf32_holds(a, mo)
        tf32["kernels"][gname] = dict(
            row_err=worst, row_err_q99=q99, model_row_err=mworst,
            model_row_err_q99=mq99,
            plain_rel=(a - p).abs().max().item()
            / max(1.0, p.abs().max().item()))
        tf32["terms_1"][gname] = dict(
            row_err=bworst, row_err_q99=bq99,
            plain_rel=(x - p).abs().max().item()
            / max(1.0, p.abs().max().item()))
        if not (ok and torch.isfinite(a).all()):
            raise AssertionError(
                f"flash_bwd float32: {gname} row errors against the float64 "
                f"backward (largest {worst}, {BWD_MMA_ROW_Q:.0%} {q99}) past "
                f"{TF32_ROW_TOL}, {TF32_ROW_Q99_TOL}")
        if bok:
            raise AssertionError(
                f"the float32 backward check passes the planted fault (one "
                f"TF32 product): {gname} {bworst}, {bq99}")
    del ref, model
    print(f"flash_bwd float32 (3xTF32) at [{B}, {T}, {HEADS}, {D}] causal: "
          f"row errors (largest, {BWD_MMA_ROW_Q:.0%}) against the float64 "
          f"backward of the same inputs "
          + ", ".join(f"{g} {e['row_err']:.3e} {e['row_err_q99']:.3e}"
                      for g, e in tf32["kernels"].items())
          + f" (limits {TF32_ROW_TOL:.3e}, {TF32_ROW_Q99_TOL:.3e}), against "
          "_tf32x3_bwd " + ", ".join(
              f"{g} {e['model_row_err']:.3e} {e['model_row_err_q99']:.3e}"
              for g, e in tf32["kernels"].items())
          + "; planted fault (one TF32 product, terms=1; must fail): "
          + ", ".join(f"{g} {e['row_err']:.3e} {e['row_err_q99']:.3e}"
                      for g, e in tf32["terms_1"].items())
          + "; max|err| against autograd through the plain version, of "
          "max(1, |ref|) (gate 1e-4): kernels " + ", ".join(
              f"{g} {e['plain_rel']:.2e}" for g, e in tf32["kernels"].items())
          + ", planted fault " + ", ".join(
              f"{g} {e['plain_rel']:.2e}" for g, e in tf32["terms_1"].items()),
          flush=True)
    del bad
    res = fa.bwd_f32_resources()
    print("flash_bwd float32 (3xTF32) kernels' resources "
          "(cudaFuncGetAttributes): " + ", ".join(
              f"{n} {r} registers, {l} bytes local"
              for n, (r, l) in res.items()), flush=True)
    if any(l for _, l in res.values()):
        raise AssertionError(f"a float32 backward kernel spills: {res}")

    t = {"fwd": time_ms(lambda: fa.flash_fwd_cuda(q, k, v, lens, **kw),
                        flush),
         "dkdv": time_ms(lambda: fa.flash_bwd_dkdv_cuda(
             q, k, v, go, lse, delta, lens, **kw), flush),
         "dq": time_ms(lambda: fa.flash_bwd_dq_cuda(
             q, k, v, go, lse, delta, lens, **kw), flush)}
    simt = {}
    if parents is not None:
        plib = parent_lib(parents, "flash_fwd")
        simt["fwd_ms"] = time_ms(lambda: _parent_fwd(plib, q, k, v, lens, kw),
                                 flush)
        lib = parent_lib(parents, "flash_bwd")
        sgot = (*_simt_call(lib, fa, "dq", q, k, v, go, lse, delta, lens, kw),
                *_simt_call(lib, fa, "dkdv", q, k, v, go, lse, delta, lens,
                            kw))
        torch.cuda.synchronize()
        for gname, a, p in zip(names, sgot, plain):
            rel = (a - p).abs().max().item() / max(1.0, p.abs().max().item())
            simt[f"{gname}_plain_rel"] = rel
            if not rel <= TOL:
                raise AssertionError(f"the parent's SIMT {gname} disagrees "
                                     f"with the plain version: {rel}")
        del sgot
        for which in ("dkdv", "dq"):
            simt[f"{which}_ms"] = time_ms(lambda which=which: _simt_call(
                lib, fa, which, q, k, v, go, lse, delta, lens, kw), flush)
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
    lib_grads = [x.transpose(1, 2) for x in torch.autograd.grad(
        so, qt, go.transpose(1, 2))]
    del so
    sdpa_kernels = _sdpa_kernels(sdpa, qt, go.transpose(1, 2), kw["scale"])
    sdpa_rel = {g: (a - p).abs().max().item()
                / max(1.0, p.abs().max().item())
                for g, a, p in zip(names, lib_grads, plain)}
    del lib_grads, plain
    print("scaled_dot_product_attention's float32 backward at "
          f"[{B}, {T}, {HEADS}, {D}] causal (torch.profiler): " + "; ".join(
              f"{name} x{n} {ms:.4f} ms" for name, n, ms in sdpa_kernels)
          + "; max|err| against autograd through the plain version, of "
          "max(1, |ref|): " + ", ".join(f"{g} {e:.2e}"
                                       for g, e in sdpa_rel.items()),
          flush=True)

    pairs = B * HEADS * T * (T + 1) // 2      # visible (q, k) pairs, causal
    row = 4.0 * B * T * HEADS * D             # one [B, T, H, D] float32
    vec = 4.0 * B * HEADS * T                 # one [B, H, T] float32
    work = {"fwd": (4.0 * D * pairs, 4 * row + vec + 4 * B),
            "dkdv": (8.0 * D * pairs, 6 * row + 2 * vec + 4 * B),
            "dq": (6.0 * D * pairs, 5 * row + 2 * vec + 4 * B)}
    # three TF32 products for each float32 one at TF32's dense peak
    bounds = {name: bound(3 * work[name][0], work[name][1], PEAK_TF32_FLOPS)
              for name in ("fwd", "dkdv", "dq")}
    res["fwd_d128"], res["fwd_d64"] = (fa.fwd_f32_resources()[f"fwd_d{dt}"]
                                       for dt in (128, 64))
    for name in ("fwd", "dkdv", "dq"):
        plain_n, lib = (("plain_fwd", "lib_fwd") if name == "fwd"
                        else ("plain_bwd", "lib_bwd"))
        regs, local = res[f"{name}_d{D}"]
        extra = (f"  fma_bound_ms {bound(*work[name])[0]:.4f}"
                 + (f"  parent_simt_ms {simt[name + '_ms']:.4f}"
                    if simt else "")
                 + f"; {regs} registers, {local} bytes local")
        print(f"flash {name} at [{B}, {T}, {HEADS}, {D}] causal: ms "
              f"{t[name]:.4f}  bound_ms {bounds[name][0]:.4f} "
              f"({bounds[name][1]}, 3xTF32 at the TF32 peak)  "
              f"plain_ms {t[plain_n]:.4f}  library_ms "
              f"(scaled_dot_product_attention "
              f"{'forward' if name == 'fwd' else 'backward'}) "
              f"{t[lib]:.4f}" + extra, flush=True)

    def entry(name, plain_n, lib, err=None):
        regs, local = res[f"{name}_d{D}"]
        d = dict(ms=t[name], plain_ms=t[plain_n], bound_ms=bounds[name][0],
                 bound_by=bounds[name][1], library_ms=t[lib],
                 fma_bound_ms=bound(*work[name])[0], registers=regs,
                 local_bytes=local)
        if simt:
            d["parent_simt_ms"] = simt[name + "_ms"]
        if err is not None:
            gs = ("dq",) if name == "dq" else ("dk", "dv")
            d.update(max_abs_err=err[0], max_rel_err=err[1],
                     row_err=max(tf32["kernels"][g]["row_err"] for g in gs),
                     row_err_q99=max(tf32["kernels"][g]["row_err_q99"]
                                     for g in gs))
        return d

    return {"shape": {"B": B, "Lq": T, "Lk": T, "H": HEADS, "D": D,
                      "causal": True},
            "fwd": dict(entry("fwd", "plain_fwd", "lib_fwd"),
                        tf32=fwd_tf32),
            "dkdv": entry("dkdv", "plain_bwd", "lib_bwd", errs["dkdv"]),
            "dq": entry("dq", "plain_bwd", "lib_bwd", errs["dq"]),
            "tf32": tf32, "resources": res, "parent_simt": simt,
            "sdpa": {"kernels": [[n, c, ms] for n, c, ms in sdpa_kernels],
                     "plain_rel": sdpa_rel}}


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


def _o_row_errs(o, ref):
    """||o_r - ref_r|| / ||ref_r|| for every row (b, l, h) of O (0 on a
    row that is 0 on both sides)."""
    o, ref = o.float(), ref.float()
    return (torch.linalg.vector_norm(o - ref, dim=-1)
            / torch.linalg.vector_norm(ref, dim=-1).clamp_min(1e-30)
            ).flatten()


def _o_row_err(o, ref) -> float:
    """Largest ||o_r - ref_r|| / ||ref_r|| over the rows (b, l, h) of O."""
    return _o_row_errs(o, ref).max().item()


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


# Kernel 1 at bf16 (the tensor-core forward) is held two ways, each row
# (b, l, h) of O by its norm: against the upcast plain version (the Pallas
# kernel's arithmetic, P float32) with _hold_bf16's limits, and against
# ``_mma_fwd`` (its own arithmetic, P rounded to bf16) with every row
# within VAR_O_ROW_TOL and FWD_MMA_ROW_Q of the rows within
# FWD_MMA_ROW_TOL.  Both sides round O once to bf16, so a float32 value
# near a rounding midpoint can land one ulp apart (2^-8 of the element)
# however close the sums: the largest row reads up to 3.3e-3 against
# ``_mma_fwd``, near the upcast version's 4.8e-3, and only a percentile
# tells the two arithmetics apart (first readings on the H100: 99th
# percentile at most 9.8e-4 against ``_mma_fwd``).  The LSE is float32
# on both sides, held on the rows that see a key (the others carry the
# sentinel, below -1e29 on both).  Two planted faults must fail both
# checks: the first 64 keys' P . V left out of the last 64 rows
# (_planted_fault) and one 16-deep k-step of the score product left out
# (``_mma_fwd(drop_score_kstep=1)``).
FWD_MMA_ROW_TOL, FWD_MMA_ROW_Q = 2.0 ** -9, 0.99
# The float16 instances (the same templates on f16 operands) are held by
# the same checks, by operand dtype: kernel 1's O rows against the upcast
# version and _mma_fwd (o_row), O elementwise (o), its 99% rows against
# _mma_fwd (fwd_mma); kernels 2 and 3's rows against _upcast_bwd and
# _mma_bwd (bwd_row, which also sets the floor of a row whose gradient
# cancels, ``_row_errs``) and their 99% against _mma_bwd (bwd_mma); the
# rows of kernels 8's and 9's y (conv_row).  f16 keeps 11 significant
# bits where bf16 keeps 8, and P, dS, O and y each round once to the
# operands' dtype, so each limit is bf16's over 8, but bwd_row: the
# largest row of dQ is one whose gradient cancels (dP - delta, float32
# sums of terms that agree to f16's rounding of O), where float32 noise,
# not the dtype, sets the error.  Readings at float16 on the H100 at the
# LM shape and every BF16_BWD_CASES case: kernel 1 rows at most 5.4e-4
# (upcast) and 4.8e-4 (_mma_fwd), 99% 2.0e-4 to 2.2e-4 against _mma_fwd
# (4.1e-4 to 4.5e-4 against the upcast version, which the limit refuses);
# kernels 2 and 3 rows at most 4.1e-3 (dQ at the LM shape; the others
# 7.4e-4), 99% 1.6e-4 to 2.3e-4 against _mma_bwd (4.3e-4 to 5.0e-4
# against _upcast_bwd); y rows 4.4e-4 and 3.5e-4.
HALF_TOLS = {
    torch.bfloat16: dict(o_row=VAR_O_ROW_TOL, o=VAR_O_TOL,
                         fwd_mma=FWD_MMA_ROW_TOL, bwd_row=2.0 ** -7,
                         bwd_mma=2.0 ** -9, conv_row=2.0 ** -7),
    torch.float16: dict(o_row=2.0 ** -10, o=2.0 ** -9, fwd_mma=2.0 ** -12,
                        bwd_row=2.0 ** -7, bwd_mma=2.0 ** -12,
                        conv_row=2.0 ** -10)}


def _short(dtype) -> str:
    """"bf16" or "f16": the counters' and C entries' suffix of a 16-bit
    dtype."""
    return {torch.bfloat16: "bf16", torch.float16: "f16"}[dtype]


def _rows_hold(ref_name, rows, row_tol, mma_tol, mma_q) -> tuple:
    """(largest of the row errors ``rows``, their ``mma_q`` quantile,
    whether the check against the ``ref_name`` plain version holds: every
    row within ``row_tol`` and, against the kernels' own arithmetic
    ("mma"), the quantile within ``mma_tol``)."""
    worst = rows.max().item()
    q = torch.quantile(rows, mma_q).item()
    return worst, q, worst <= row_tol and (ref_name != "mma"
                                           or q <= mma_tol)


def _fwd_rows_hold(ref_name, rows, dtype=torch.bfloat16) -> tuple:
    """``_rows_hold`` at kernel 1's limits for ``dtype`` operands."""
    t = HALF_TOLS[dtype]
    return _rows_hold(ref_name, rows, t["o_row"], t["fwd_mma"],
                      FWD_MMA_ROW_Q)


def _hold_fwd_bf16(fa, what, q, k, v, lens, o, lse, kw):
    """Kernel 1's bf16 (or float16: q's dtype) O and LSE held against the
    upcast plain version and ``_mma_fwd``: O's rows (``_fwd_rows_hold``),
    O within VAR_O_TOL (HALF_TOLS' "o") and the live rows' LSE within
    VAR_LSE_TOL of max(1, max |ref|), the other rows' LSE below -1e29.
    Returns ({reference: errors}, {reference: (O, LSE)})."""
    dt, t = q.dtype, HALF_TOLS[q.dtype]
    ro, rlse = fa._torch_attention(q.float(), k.float(), v.float(), lens,
                                   return_lse=True, **kw)
    refs = {"upcast": (ro.to(dt), rlse),
            "mma": fa._mma_fwd(q, k, v, lens, **kw)}
    del ro
    if o.dtype != dt or lse.dtype != torch.float32:
        raise AssertionError(f"{what}: kernel 1 at {_short(dt)} gave "
                             f"{o.dtype}, {lse.dtype}")
    errs = {}
    for ref_name, (r_o, r_l) in refs.items():
        worst, q99, rows_ok = _fwd_rows_hold(ref_name,
                                             _o_row_errs(o, r_o), dt)
        live = r_l > -1e29
        el = (lse - r_l)[live].abs().max().item() if live.any() else 0.0
        eo = (o.float() - r_o.float()).abs().max().item()
        so = max(1.0, r_o.float().abs().max().item())
        sl = max(1.0, r_l[live].abs().max().item()) if live.any() else 1.0
        ok = (rows_ok and eo <= t["o"] * so and el <= VAR_LSE_TOL * sl
              and bool((lse[~live] < -1e29).all())
              and torch.isfinite(o.float()).all()
              and torch.isfinite(lse[live]).all())
        if not ok:
            raise AssertionError(
                f"{what}: kernel 1 at {_short(dt)} disagrees with the "
                f"{ref_name} plain version: O rows largest {worst} (limit "
                f"{t['o_row']}), {FWD_MMA_ROW_Q:.0%} {q99} (limit "
                f"{t['fwd_mma']} against _mma_fwd), O {eo} (limit "
                f"{t['o'] * so}), LSE {el} (limit {VAR_LSE_TOL * sl})")
        errs[ref_name] = dict(row_err=worst, row_err_q99=q99,
                              max_abs_err=eo, lse_err=el)
    print(f"{what} [B {q.shape[0]}, Lq {q.shape[1]}, Lk {k.shape[1]}, H "
          f"{q.shape[2]}, D {q.shape[3]}, causal {kw['causal']}, q_offset "
          f"{kw.get('q_offset', 0)}, kv_offset {kw.get('kv_offset', 0)}]: "
          f"kernel 1 at {_short(dt)}, O rows (largest, "
          f"{FWD_MMA_ROW_Q:.0%}) / max|err| O / LSE against the upcast "
          "version " + " ".join(f"{errs['upcast'][k_]:.3e}" for k_ in (
              "row_err", "row_err_q99", "max_abs_err", "lse_err"))
          + ", against _mma_fwd " + " ".join(
              f"{errs['mma'][k_]:.3e}" for k_ in (
                  "row_err", "row_err_q99", "max_abs_err", "lse_err"))
          + f" (limits: rows {t['o_row']:.3e}, 99% against _mma_fwd "
          f"{t['fwd_mma']:.3e})", flush=True)
    return errs, refs


def _planted_fwd_faults(fa, q, k, v, lens, kw, refs):
    """Each planted fault's O row errors against both references; raises
    unless each fails both checks."""
    rlse = refs["upcast"][1]
    faults = {
        "the first 64 keys' P . V left out of the last 64 rows":
            _planted_fault(q, k, v, refs["upcast"][0].float(), rlse,
                           kw["scale"]).to(q.dtype),
        "one score k-step left out":
            fa._mma_fwd(q, k, v, lens, drop_score_kstep=1, **kw)[0]}
    out = {}
    for fname, bad in faults.items():
        for ref_name, (r_o, _) in refs.items():
            worst, q99, ok = _fwd_rows_hold(ref_name,
                                            _o_row_errs(bad, r_o), q.dtype)
            out.setdefault(fname, {})[ref_name] = (worst, q99)
            if ok:
                raise AssertionError(f"kernel 1's {_short(q.dtype)} check "
                                     f"against "
                                     f"{ref_name} passes a planted fault "
                                     f"({fname}): {worst}, {q99}")
    return out


def variants_phase(dev, gen, flush):
    """Kernel 1 on bf16 operands (the tensor-core forward) and every
    variant of the forward sweep (``ops/flash_variants.py``: the sweep's
    rows and EXTRA_VARIANTS) at the JAX tool's shape and the LM's training
    shape, causal: each held against its plain version with its launch
    counted; kernel 1 also against ``_mma_fwd`` (``_hold_fwd_bf16``), its
    registers and local memory read (a spill fails), two planted faults
    shown to fail both of its checks.  Times kernel 1, the plain versions,
    the library's bf16 attention and EXTRA_VARIANTS; the sweep times its
    own rows (``sweep_path``, ``merge_sweep_times``)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flash_variants as fv

    sdpa = torch.nn.functional.scaled_dot_product_attention
    extra = {name for name, _ in EXTRA_VARIANTS}
    out = {"kernel1_bf16": {}, "variants": {}, "sdpa_bf16_ms": {},
           "planted_fault": {}}
    res = fa.fwd_mma_resources()
    print("flash_fwd bf16 kernel's resources (cudaFuncGetAttributes): "
          + ", ".join(f"{n} {r} registers, {l_} bytes local"
                      for n, (r, l_) in res.items()), flush=True)
    if any(l_ for _, l_ in res.values()):
        raise AssertionError(f"the bf16 forward kernel spills: {res}")
    out["resources"] = res
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

        # kernel 1 on bf16 (the tensor-core forward) against the upcast
        # plain version and its own arithmetic, ``_mma_fwd``
        before = fa.flash_fwd_cuda.launches_bf16
        o, lse = fa.flash_fwd_cuda(q, k, v, lens, **kw)
        torch.cuda.synchronize()
        if fa.flash_fwd_cuda.launches_bf16 != before + 1:
            raise AssertionError("kernel 1 at bf16: the counter did not "
                                 "move")
        errs, refs = _hold_fwd_bf16(fa, f"flash_fwd bf16 {shape}", q, k, v,
                                    lens, o, lse, kw)
        fault = _planted_fwd_faults(fa, q, k, v, lens, kw, refs)
        print(f"kernel 1 bf16 planted faults at [{b}, {l}, {h}, {d}] (O "
              f"row errors, largest and {FWD_MMA_ROW_Q:.0%}; each must fail "
              "both checks): " + "; ".join(
                  f"{f}: " + ", ".join(f"against {r} {w:.3e} {p:.3e}"
                                       for r, (w, p) in by_ref.items())
                  for f, by_ref in fault.items()), flush=True)
        out["planted_fault"][shape] = fault
        ref_a = o.float()
        del refs, o, lse
        k1_ms = time_ms(lambda: fa.flash_fwd_cuda(q, k, v, lens, **kw),
                        flush)
        with torch.no_grad():
            plain_ms = time_ms(lambda: fa._torch_attention(q, k, v, lens,
                                                           **kw),
                               flush, iters=3, warmup=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                      scale=kw["scale"]), flush)
        out["sdpa_bf16_ms"][shape] = lib_ms
        # bf16 operands: the bound at the card's bf16 peak
        b_ms, b_by = bound(work, nbytes, PEAK_BF16_FLOPS)
        regs, local = res[f"fwd_d{d}"]
        shape_d = {"B": b, "L": l, "H": h, "D": d, "causal": True}
        out["kernel1_bf16"][shape] = dict(
            max_abs_err=max(errs["upcast"]["max_abs_err"],
                            errs["upcast"]["lse_err"]),
            o_row_err=errs["upcast"]["row_err"],
            o_row_err_q99=errs["upcast"]["row_err_q99"],
            mma_row_err=errs["mma"]["row_err"],
            mma_row_err_q99=errs["mma"]["row_err_q99"], ms=k1_ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, registers=regs, local_bytes=local,
            shape=shape_d)
        print(f"flash_fwd bf16 at [{b}, {l}, {h}, {d}] causal (tensor "
              f"cores): ms {k1_ms:.4f}  bound_ms {b_ms:.4f} ({b_by}, bf16 "
              f"peak)  plain_ms {plain_ms:.4f}  library_ms "
              f"(scaled_dot_product_attention, bf16) {lib_ms:.4f}; {regs} "
              f"registers, {local} bytes local", flush=True)

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
            b_ms, b_by = bound(work, nbytes, PEAK_BF16_FLOPS)
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
    1 at bf16, timed there too), printed beside each one's bound, plain and
    library time."""
    for shape, shape_rows in rows.items():
        ms = {r["name"]: r["ms"] for r in shape_rows}
        k1 = var["kernel1_bf16"][shape]
        k1["row_a_ms"] = ms[sweep_tool.ROWS[0][0]]
        print(f"[{shape}] {'kernel 1 at bf16 (row A)':28s} ms "
              f"{k1['row_a_ms']:.4f} (variants_phase: {k1['ms']:.4f})  "
              f"bound_ms {k1['bound_ms']:.4f}  plain_ms "
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
    for name, it in iters.items():
        print(f"mixed iteration, {SLOTS} residents, {name} path: decode "
              f"only {it['decode_ms']:.3f} ms (device busy "
              f"{it['decode_busy_ms']:.3f} ms of it, idle share "
              f"{it['decode_idle_share']:.1%}, torch.profiler over 5); with "
              f"a {max(map(len, reqs))}-token prefill chunk "
              f"{it['chunk_ms']:.3f} ms", flush=True)
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
    loss, grads, found, _ = trainer._grads(
        feed, None if ls is None else ls["scale"])
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


def _hold_rnn_tf32(fr, kind, what, args, got, fault=False) -> dict:
    """Kernel 5's h' and c' or kernel 6's h' (3xTF32) against their
    arithmetic in plain torch, ``_tf32x3_lstm_step`` or
    ``_tf32x3_gru_step``, on the same operands: each row as
    ``_tf32_holds`` holds the flash kernels' rows; with ``fault`` the
    planted fault (``terms=1``, one TF32 product), which must fail on some
    output.  Returns {row_err, row_err_q99[, terms_1_...]}, the worst
    over the outputs."""
    num, ref_fn = ((5, fr._tf32x3_lstm_step) if kind == "lstm"
                   else (6, fr._tf32x3_gru_step))
    names = ("h'", "c'") if kind == "lstm" else ("h'",)

    def outs(t):
        return t if isinstance(t, tuple) else (t,)

    with torch.no_grad():
        ref = outs(ref_fn(*args))
        holds = [_tf32_holds(a, r) for a, r in zip(got, ref)]
        worst = max(h_[0] for h_ in holds)
        q99 = max(h_[1] for h_ in holds)
        if not all(h_[2] for h_ in holds):
            raise AssertionError(f"{what}: kernel {num} disagrees with "
                                 f"{ref_fn.__name__}: rows largest {worst}, "
                                 f"{BWD_MMA_ROW_Q:.0%} {q99} (limits "
                                 f"{TF32_ROW_TOL}, {TF32_ROW_Q99_TOL})")
        out = dict(row_err=worst, row_err_q99=q99)
        if fault:
            bad = [_tf32_holds(a, r) for a, r in
                   zip(outs(ref_fn(*args, terms=1)), ref)]
            bworst = max(b_[0] for b_ in bad)
            bq99 = max(b_[1] for b_ in bad)
            if all(b_[2] for b_ in bad):
                raise AssertionError(f"{what}: the kernel {num} check passes "
                                     f"the planted fault (one TF32 product):"
                                     f" {bworst}, {bq99}")
            out.update(terms_1_row_err=bworst, terms_1_row_err_q99=bq99)
    print(f"{what}: kernel {num} (3xTF32) against {ref_fn.__name__}: "
          + ", ".join(f"{n} rows (largest, {BWD_MMA_ROW_Q:.0%}) {h_[0]:.3e} "
                      f"{h_[1]:.3e}" for n, h_ in zip(names, holds))
          + f" (limits {TF32_ROW_TOL:.3e}, {TF32_ROW_Q99_TOL:.3e})" + (
              f"; planted fault (one TF32 product, terms=1; must fail): "
              f"{bworst:.3e} {bq99:.3e}" if fault else ""), flush=True)
    return out


def _rnn_check(kind, b, h, dev, gen, dtypes=(torch.float32, torch.float32),
               fault=False):
    """The kernel against its plain version at [B, H] on x and the mask in
    ``dtypes`` (the rest float32): values (masked rows copied bit for bit)
    and, through the autograd.Function, the gradients of every input but
    the mask; and per row against the kernel's own arithmetic,
    ``_tf32x3_lstm_step`` or ``_tf32x3_gru_step`` (``_hold_rnn_tf32``, with
    ``fault`` its planted fault).  Returns (max abs error, max error
    relative to max(1, max |ref|), the row errors)."""
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
    rows = _hold_rnn_tf32(
        fr, kind, f"{kind}_step{tag} B={b} H={h}",
        [t.detach() for t in args], tuple(t.detach() for t in got), fault)
    return worst_abs, worst_rel, rows


def _gru_parent(lib, fr, x, h, wg, wc, bias, m):
    """One call of the parent's CUDA-core GRU step (its two kernels through
    z and r h scratch): h'."""
    from paddle_tpu_torch.ops import _build

    bsz, hd = h.shape
    out, z, rh = (torch.empty_like(h) for _ in range(3))
    err = lib.gru_step_f32(
        x.data_ptr(), h.data_ptr(), wg.data_ptr(), wc.data_ptr(),
        bias.data_ptr(), m.data_ptr(), z.data_ptr(), rh.data_ptr(),
        out.data_ptr(), bsz, hd, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "the parent's gru_step_f32")
    return out


def _lstm_parent(lib, x, h, c, w, bias, m):
    """One call of the parent's CUDA-core LSTM step: (h', c')."""
    from paddle_tpu_torch.ops import _build

    bsz, hd = h.shape
    h_out, c_out = torch.empty_like(h), torch.empty_like(c)
    err = lib.lstm_step_f32(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), w.data_ptr(),
        bias.data_ptr(), m.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
        bsz, hd, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "the parent's lstm_step_f32")
    return h_out, c_out


def rnn_phase(dev, gen, flush, parents=None):
    """Kernels 5 and 6 against their plain versions (values and the
    autograd.Function's gradients) at the routes' shapes and at ragged
    ones, and (3xTF32) per row against ``_tf32x3_lstm_step`` and
    ``_tf32x3_gru_step`` with their planted faults, and their registers
    and local memory (a spill fails); then their device times
    (``time_ms(lead=True)``: a step is about as short as its launch)
    beside their bounds (three TF32 products a float32 one, beside the FMA
    floor), the plain step's, the cuBLAS product's alone (``torch.addmm``,
    the product's floor - no one PyTorch call computes either step) and,
    from ``parents``, the parent's CUDA-core step."""
    from paddle_tpu_torch.ops import fused_rnn as fr

    out = {}
    plib = None if parents is None else parent_lib(parents, "rnn_step")
    for kind, b in (("lstm", LSTM_BATCH), ("gru", NMT_BATCH)):
        errs = [_rnn_check(kind, bb, hh, dev, gen, fault=bb == b)
                for bb, hh in ((b, RNN_H), (8, RNN_H), (37, 128), (5, 37))]
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
        res = (fr.lstm_tf32_resources() if kind == "lstm"
               else fr.gru_tf32_resources())
        print(f"{kind}_step float32 (3xTF32) kernel's resources "
              f"(cudaFuncGetAttributes, by "
              f"{'copy width' if kind == 'lstm' else 'phase and copy width'}"
              f"): " + ", ".join(f"{n} {r} registers, {l_} bytes local"
                                 for n, (r, l_) in res.items()), flush=True)
        if any(l_ for _, l_ in res.values()):
            raise AssertionError(f"the {kind} kernel spills: {res}")
        extra = dict(registers=max(r for r, _ in res.values()),
                     local_bytes=max(l_ for _, l_ in res.values()),
                     resources=res, tf32=[e[2] for e in errs],
                     fma_bound_ms=bound(flops, nbytes)[0])
        if kind == "lstm":
            parent = lambda: _lstm_parent(plib, x, h, c, w, bias, m)  # noqa
            ref_names = ("h'", "c'")
        else:
            parent = lambda: (                                        # noqa
                _gru_parent(plib, fr, x, h, wg, wc, bias, m),)
            ref_names = ("h'",)
        if plib is not None:
            with torch.no_grad():
                got_p, ref_p = parent(), plain()
            ref_p = ref_p if isinstance(ref_p, tuple) else (ref_p,)
            _hold(f"the parent's {kind}_step_f32",
                  list(zip(ref_names, got_p, ref_p)))
        with torch.no_grad():
            t = {"ms": time_ms(kernel, flush, lead=True),
                 "plain_ms": time_ms(plain, flush, lead=True),
                 "addmm_ms": time_ms(floor, flush, lead=True)}
            if plib is not None:
                t["parent_simt_ms"] = time_ms(parent, flush, lead=True)
        # the product as three TF32 products at TF32's dense peak
        b_ms, b_by = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
        print(f"{kind}_step at B {b}, H {H} ({live} live rows): ms "
              f"{t['ms']:.4f}  bound_ms {b_ms:.4f} ({b_by}, 3xTF32 at the "
              f"TF32 peak)  fma_bound_ms {extra['fma_bound_ms']:.4f}"
              + f"  plain_ms {t['plain_ms']:.4f}  library_ms none (no one "
              f"PyTorch call computes the step); the product alone "
              f"(torch.addmm, its floor) {t['addmm_ms']:.4f}"
              + (f"  parent_simt_ms {t['parent_simt_ms']:.4f} (the parent's "
                 f"CUDA-core step)" if "parent_simt_ms" in t else ""),
              flush=True)
        out[kind] = dict(t, **extra, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None,
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
                falling=True, finite=True):
    """``trainer.SGD.train`` over ``steps`` copies of one batch: every
    loss finite (and, with ``falling``, the last below the first), the
    kernel's counter moving ``per_step`` a step; returns losses, step
    times and peak memory.  With ``finite=False`` (``fp16``, which has no
    loss scaling) a non-finite loss is printed, not raised, and
    ``falling`` holds over the losses before the first of them."""
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
    ok = _finite_prefix(losses)
    if not finite and ok < steps:
        print(f"{name}: a non-finite loss at step {ok} of {steps}: "
              f"{losses}", flush=True)
    elif ok < steps:
        ok = 0
    if (len(losses) != steps or ok < 2
            or (falling and not losses[ok - 1] < losses[0])):
        raise AssertionError(f"{name} losses not finite"
                             f"{' and falling' if falling else ''}: "
                             f"{losses}")
    if launches[kernel] != per_step * steps:
        raise AssertionError(f"{name}: {kernel} launched "
                             f"{launches[kernel]} times in {steps} steps, "
                             f"expected {per_step} a step")
    warm = sorted(step_s[1:])[len(step_s[1:]) // 2]
    return losses, step_s, warm, peak_gb, launches


def _finite_prefix(losses) -> int:
    """How many losses lead ``losses`` before the first non-finite one."""
    return next((i for i, x in enumerate(losses) if not np.isfinite(x)),
                len(losses))


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
    """``profile_call`` over one training step (``trainer._step``)."""
    return profile_call(lambda: trainer._step(feed), match)


def profile_call(fn, match=None):
    """``torch.profiler`` over one call of ``fn`` (a training step, a
    graph's replay): the call's CUDA-event time, the device's busy time
    (the union of the intervals of its own activity - kernels, copies,
    fills - not of the host ops that launched it), the idle share, the device time of the kernels whose name
    contains ``match``, and the top 10 kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ev[0].record()
        fn()
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
    check's.  Then one step under ``torch.profiler``: the idle share and
    the LSTM kernel's own device time in the step."""
    paddle, topo = lstm_model()
    values = seeded_values(topo, SEED + 2)
    parity = route_parity("LSTM route", paddle, topo, values,
                          lstm_feed(8, [100, 1, 57, 100, 9, 33, 100, 80]),
                          "lstm_step", 2 * LSTM_LEN, LSTM_LR)
    trainer = paddle.trainer.SGD(topo, paddle.parameters.from_numpy(
        topo, values), paddle.optimizer.Adam(learning_rate=LSTM_LR))
    feed = lstm_feed(LSTM_BATCH)
    losses, step_s, warm, peak_gb, launches = train_steps(
        "LSTM route", paddle, trainer, feed, LSTM_STEPS, "lstm_step",
        2 * LSTM_LEN, falling=False)
    prof = profile_step(trainer, feed, LSTM_KERNEL)
    print(f"LSTM route training: {LSTM_STEPS} Adam steps (lr {LSTM_LR}) at "
          f"batch {LSTM_BATCH} x {LSTM_LEN}, losses "
          f"{[round(x, 5) for x in losses]}; step time first "
          f"{step_s[0] * 1e3:.1f} ms, median after it {warm * 1e3:.1f} ms; "
          f"peak memory {peak_gb:.2f} GB; lstm_step launches "
          f"{launches['lstm_step']} ({2 * LSTM_LEN} a step: 2 layers x "
          f"{LSTM_LEN}); " + _route_profile(prof), flush=True)
    return {"launches": launches, "losses": losses, "step_ms": warm * 1e3,
            "first_step_ms": step_s[0] * 1e3, "peak_gb": peak_gb,
            "parity": parity, "idle_share": prof["idle_share"],
            "kernel_ms": prof["matched_ms"], "busy_ms": prof["busy_ms"],
            "profiled_step_ms": prof["step_ms"]}


def _route_profile(prof) -> str:
    """One profiled LSTM-route step: its device busy time, idle share and
    the LSTM kernel's own share of the busy time."""
    if prof["idle_share"] is None:
        return "torch.profiler saw no device activity: idle share not measured"
    return (f"one step under torch.profiler: device busy "
            f"{prof['busy_ms']:.1f} of {prof['step_ms']:.1f} ms, idle share "
            f"{prof['idle_share']:.1%}, the LSTM kernel's own "
            f"{prof['matched_ms']:.2f} ms "
            f"({prof['matched_ms'] / prof['busy_ms']:.1%} of the busy time)")


# ---------------------------------------------------- the bf16 policy slice
# dQ, dK and dV of the bf16 backward kernels held per row (b, l, h), on the
# same bf16 operands and the forward kernel's own O and LSE, against two
# plain versions (_row_errs, each row's error over its norm):
# - ``_upcast_bwd``, the Pallas kernels' arithmetic (float32 products on
#   the upcast operands): every row within BWD_ROW_TOL = 2^-7, one bf16
#   ulp of every element, as O is held in the sweep.  The tensor-core
#   kernels round P and dS to bf16 before three of their products (at
#   most 2^-8 of each term), and both sides round each output once
#   (readings at the LM shape on the H100: median 2.5e-3, 99th percentile
#   3.6e-3, max 5.1e-3);
# - ``_mma_bwd``, the kernels' own arithmetic (P and dS rounded to bf16):
#   the 99th percentile of the row errors within BWD_MMA_ROW_TOL = 2^-9,
#   every row within 2^-7.  The two compute dS in float32 ~1e-7 apart
#   (the order of the sums, the MUFU's exp2 against exp), which flips the
#   bf16 rounding of a term now and then; one flipped dominant term moves
#   a row by up to ~2^-8, so the tighter limit is on the percentile
#   (readings: median 0, most rows bit for bit, 99th percentile 9.3e-4 to
#   9.9e-4, max 5.4e-3).  ``_mma_bwd`` against ``_upcast_bwd`` reads
#   3.5e-3 at the 99th percentile: this check tells the two arithmetics
#   apart, which a limit on the largest row cannot.
# Two planted faults must fail both checks: one 64-row q tile's dO zeroed
# (its share of every dK and dV row left out) and one 16-deep k-step of
# the score product left out (``_mma_bwd(drop_score_kstep=1)``).
BWD_ROW_TOL = 2.0 ** -7
BWD_MMA_ROW_TOL, BWD_MMA_ROW_Q = 2.0 ** -9, 0.99
# the bf16 routes against their plain routes on the card.  Recurrent
# kernels: the same float32 arithmetic as the plain step, but each
# product's sums in another order move a float32 h by ~1e-7, which can
# flip the rounding of a downstream bf16 activation (2^-8 of it): the
# first loss within 1e-4 relative, gradients within 1e-3 of max(1,
# max |g|), a 3-step trajectory within 1e-3 (readings on the H100: at
# most 5.8e-6, 1.5e-5 and 1.5e-4, the last the LSTM route's Adam at 2e-3
# amplifying its second step).  The LM's plain route rounds P to bf16
# before P . V (the JAX xla path), as the tensor-core forward does but
# against the row's final max where the kernel rounds each tile's p
# against the running one, and the backward kernels round P and dS where
# autograd through the plain route rounds dP's operands instead: its
# 6-step losses within LM_BF16_BAND relative of the kernel route's
# (readings: at most 7.3e-6 with the float32-arithmetic backward, 6.0e-6
# with the tensor-core one and the float32-arithmetic forward).
RNN_BF16_TOLS = (1e-4, 1e-3, 1e-3)
LM_BF16_BAND = 1e-4
# under fp16 the two routes' 6-step losses part faster: 4.4e-7 relative at
# the first step, 2.2e-4 at the sixth (reading on the H100), where bf16's
# stay within 7.3e-6
LM_FP16_BAND = 1e-3
BF16_POLICIES = ("bf16", "mixed")
# the bf16 backward's cases beyond the LM shape: flash_bwd_phase's four
# ragged ones at the LM's heads, the sweep's head width, and a head width
# whose rows are 8-byte aligned only (the kernels' narrower copies):
# name, B, Lq, Lk, H, D, causal, kv_lens, q_offset, kv_offset, LSE
# cotangent
BF16_BWD_CASES = (
    ("kv_lens", 4, 1024, 1024, HEADS, DIM // HEADS, True,
     [1024, 700, 333, 65], 0, 0, False),
    ("offset causal", 2, 512, 1536, HEADS, DIM // HEADS, True, None, 1000,
     200, False),
    ("cross attention", 2, 300, 1100, HEADS, DIM // HEADS, False, None, 0,
     0, False),
    ("return_lse", 2, 1024, 1024, HEADS, DIM // HEADS, True, None, 0, 0,
     True),
    ("D 64", 2, 1000, 1000, 8, 64, True, [1000, 613], 0, 0, False),
    ("D 100", 2, 300, 300, 2, 100, False, [300, 129], 0, 0, True),
)


def _row_errs(a, ref, row_tol=BWD_ROW_TOL):
    """||a_r - ref_r|| / max(||ref_r||, 2^-7 m) for every row (b, l, h),
    m the median row norm of ``ref`` (``row_tol`` m for ``row_tol``): a
    row whose gradient cancels to rounding noise (dQ's first query rows,
    where dP - delta is a difference of two equal sums) is held against
    that floor, not against its own noise."""
    a, ref = a.float(), ref.float()
    norms = torch.linalg.vector_norm(ref, dim=-1)
    floor = row_tol * norms.median().item()
    return (torch.linalg.vector_norm(a - ref, dim=-1)
            / norms.clamp_min(max(floor, 1e-30))).flatten()


def _grad_row_err(a, ref) -> float:
    """The largest of ``_row_errs``."""
    return _row_errs(a, ref).max().item()


def _bwd_holds(ref_name, a, ref, dtype=torch.bfloat16) -> tuple:
    """(largest row error, its BWD_MMA_ROW_Q quantile, whether the check
    against ``_{ref_name}_bwd`` holds at ``dtype``'s limits)."""
    t = HALF_TOLS[dtype]
    return _rows_hold(ref_name, _row_errs(a, ref, t["bwd_row"]),
                      t["bwd_row"], t["bwd_mma"], BWD_MMA_ROW_Q)


def _bf16_bwd_refs(fa, q, k, v, lens, o, lse, go, gl, kw):
    """The two plain versions' (dQ, dK, dV)."""
    args = (q, k, v, lens, o, lse, go, gl)
    return {"upcast": fa._upcast_bwd(*args, **kw),
            "mma": fa._mma_bwd(*args, **kw)}


def _bf16_bwd_case(fa, name, q, k, v, lens, go, gl, kw):
    """Kernel 1 then kernels 2 and 3 on bf16 (or float16: q's dtype)
    operands, as the kernel route's backward runs them: kernel 1's O and
    LSE held two ways (``_hold_fwd_bf16``), dQ, dK and dV per row against
    ``_upcast_bwd`` and ``_mma_bwd``.  Returns the operands the timing and
    the planted faults reuse, the references and the errors (the
    forward's under "fwd")."""
    dt = q.dtype
    tag, t = _short(dt), HALF_TOLS[dt]
    o, lse = fa.flash_fwd_cuda(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    fwd_errs, _ = _hold_fwd_bf16(fa, f"flash_fwd {tag} {name}", q, k, v,
                                 lens, o, lse, kw)
    delta = (go.float() * o.float()).sum(-1).transpose(1, 2)
    if gl is not None:
        delta = delta - gl
    delta = delta.contiguous()
    got = (fa.flash_bwd_dq_cuda(q, k, v, go, lse, delta, lens, **kw),
           *fa.flash_bwd_dkdv_cuda(q, k, v, go, lse, delta, lens, **kw))
    refs = _bf16_bwd_refs(fa, q, k, v, lens, o, lse, go, gl, kw)
    torch.cuda.synchronize()
    if any(x.dtype != dt for x in got):
        raise AssertionError(f"flash_bwd {tag} {name} gave "
                             f"{[x.dtype for x in got]}")
    errs = {}
    for ref_name, ref in refs.items():
        for gname, a, r in zip(("dq", "dk", "dv"), got, ref):
            worst, q99, ok = _bwd_holds(ref_name, a, r, dt)
            errs.setdefault(ref_name, {})[gname] = (worst, q99)
            if not (ok and torch.isfinite(a.float()).all()):
                raise AssertionError(
                    f"flash_bwd {tag} {name}: {gname} row errors (largest "
                    f"{worst}, {BWD_MMA_ROW_Q:.0%} {q99}) fail the check "
                    f"against _{ref_name}_bwd")
    errs["max_abs"] = {g: (a.float() - r.float()).abs().max().item()
                       for g, a, r in zip(("dq", "dk", "dv"), got,
                                          refs["upcast"])}
    errs["fwd"] = fwd_errs
    print(f"flash_bwd {tag} {name} [B {q.shape[0]}, Lq {q.shape[1]}, Lk "
          f"{k.shape[1]}, H {q.shape[2]}, D {q.shape[3]}, causal "
          f"{kw['causal']}, q_offset {kw.get('q_offset', 0)}, kv_offset "
          f"{kw.get('kv_offset', 0)}, g_lse {gl is not None}]: row errors "
          f"(largest, {BWD_MMA_ROW_Q:.0%}) against _upcast_bwd " + ", ".join(
              f"{g} {w:.3e} {p:.3e}" for g, (w, p) in errs["upcast"].items())
          + f" (limit {t['bwd_row']:.3e} on the largest), against "
          "_mma_bwd " + ", ".join(f"{g} {w:.3e} {p:.3e}"
                                  for g, (w, p) in errs["mma"].items())
          + f" (limits {t['bwd_row']:.3e}, {t['bwd_mma']:.3e}); max|err| "
          "against _upcast_bwd " + ", ".join(
              f"{g} {e:.3e}" for g, e in errs["max_abs"].items()),
          flush=True)
    return o, lse, delta, got, refs, errs


def _planted_bwd_faults(fa, q, k, v, lens, o, lse, go, kw, refs):
    """Each planted fault's row errors against both references; raises
    unless every one of dQ, dK and dV fails both limits."""
    go_bad = go.clone()
    go_bad[:, -64:] = 0
    faults = {
        "the last q tile's dO zeroed":
            fa._mma_bwd(q, k, v, lens, o, lse, go_bad, **kw),
        "one score k-step left out":
            fa._mma_bwd(q, k, v, lens, o, lse, go, drop_score_kstep=1,
                        **kw)}
    out = {}
    for fname, bad in faults.items():
        for ref_name, ref in refs.items():
            held = {g: _bwd_holds(ref_name, b_, r, q.dtype) for g, b_, r in
                    zip(("dq", "dk", "dv"), bad, ref)}
            out.setdefault(fname, {})[ref_name] = {
                g: (w, p) for g, (w, p, _) in held.items()}
            if any(ok for _, _, ok in held.values()):
                raise AssertionError(f"the {_short(q.dtype)} backward check "
                                     f"against "
                                     f"_{ref_name}_bwd passes a planted "
                                     f"fault ({fname}): {held}")
    return out


def flash_bwd_bf16_phase(dev, gen, flush, dtype=torch.bfloat16):
    """Kernels 2 and 3 at bf16 (or float16: ``dtype``; the tensor-core
    kernels): at the LM's training shape, causal, and at BF16_BWD_CASES,
    kernel 1's O and LSE held against the upcast plain version and
    ``_mma_fwd`` (``_hold_fwd_bf16``), dQ, dK and dV per row against
    ``_upcast_bwd`` and ``_mma_bwd``; the two planted faults of the
    backward, and at float16 kernel 1's two (``_planted_fwd_faults``; at
    bf16 ``variants_phase`` holds them), shown to fail both checks; the
    distance to the plain route's autograd at that dtype reported; each
    kernel's registers and local memory (spills fail the run); each
    kernel's time beside its bound (16-bit bytes, the tensor cores' dense
    peak, the same 989 TFLOP/s at bf16 and float16), the plain route's
    backward and the library's backward at that dtype; and kernel 1's
    time at the LM shape (the LM step breakdown's attention share), at
    float16 beside its bound, the upcast plain forward and the library's
    forward."""
    from paddle_tpu_torch.ops import flash_attention as fa

    B, T, D = TRAIN_BATCH, MAX_LEN, DIM // HEADS
    bf, tag = dtype, _short(dtype)
    q, k, v, go = (torch.randn(B, T, HEADS, D, device=dev, generator=gen,
                               dtype=bf) for _ in range(4))
    lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    kw = dict(causal=True, scale=D ** -0.5)
    o, lse, delta, (dq, dk, dv), refs, errs = _bf16_bwd_case(
        fa, "LM shape", q, k, v, lens, go, None, kw)
    fault = _planted_bwd_faults(fa, q, k, v, lens, o, lse, go, kw, refs)
    del refs
    print(f"flash_bwd {tag} planted faults (row errors, largest and "
          f"{BWD_MMA_ROW_Q:.0%}; each must fail both checks): " + "; ".join(
              f"{f}: " + ", ".join(f"against _{r}_bwd " + " ".join(
                  f"{g} {w:.3e} {p:.3e}" for g, (w, p) in es.items())
                  for r, es in by_ref.items())
              for f, by_ref in fault.items()), flush=True)
    fwd_fault = None
    if dtype != torch.bfloat16:
        _, frefs = _hold_fwd_bf16(fa, f"flash_fwd {tag} LM shape", q, k, v,
                                  lens, o, lse, kw)
        fwd_fault = _planted_fwd_faults(fa, q, k, v, lens, kw, frefs)
        del frefs
        print(f"kernel 1 {tag} planted faults at [{B}, {T}, {HEADS}, {D}] (O "
              f"row errors, largest and {FWD_MMA_ROW_Q:.0%}; each must fail "
              "both checks): " + "; ".join(
                  f"{f}: " + ", ".join(f"against {r} {w:.3e} {p:.3e}"
                                       for r, (w, p) in by_ref.items())
                  for f, by_ref in fwd_fault.items()), flush=True)
    # the distance to the plain route (P rounded to the dtype, autograd)
    plain = _attn_grads(fa, q, k, v, lens, go, None, kw, "torch")
    dist = {n: _grad_row_err(a, p) for n, a, p in
            zip(("dq", "dk", "dv"), (dq, dk, dv), plain)}
    del plain
    print(f"flash_bwd {tag} distance to the {tag} plain route's autograd "
          "(row error): " + ", ".join(f"{n} {r:.3e}" for n, r in dist.items()),
          flush=True)
    cases = {"LM shape": errs}
    for (name, b, lq, lk, h, d, causal, kvl, qo, ko,
         with_lse) in BF16_BWD_CASES:
        xq, xg = (torch.randn(b, lq, h, d, device=dev, generator=gen,
                              dtype=bf) for _ in range(2))
        xk, xv = (torch.randn(b, lk, h, d, device=dev, generator=gen,
                              dtype=bf) for _ in range(2))
        gl = (torch.randn(b, h, lq, device=dev, generator=gen)
              if with_lse else None)
        xl = torch.tensor(kvl or [lk] * b, dtype=torch.int32, device=dev)
        ckw = dict(causal=causal, scale=d ** -0.5, q_offset=qo,
                   kv_offset=ko)
        cases[name] = _bf16_bwd_case(fa, name, xq, xk, xv, xl, xg, gl,
                                     ckw)[-1]
    res = fa.bwd_mma_resources(dtype)
    print(f"flash_bwd {tag} kernels' resources (cudaFuncGetAttributes): "
          + ", ".join(f"{n} {r} registers, {l} bytes local"
                      for n, (r, l) in res.items()), flush=True)
    if any(l for _, l in res.values()):
        raise AssertionError(f"a {tag} backward kernel spills: {res}")
    fres = fa.fwd_mma_resources(dtype)
    if any(l for _, l in fres.values()):
        raise AssertionError(f"the {tag} forward kernel spills: {fres}")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt = [x.detach().transpose(1, 2) for x in (q, k, v)]
    t = {"fwd": time_ms(lambda: fa.flash_fwd_cuda(q, k, v, lens, **kw),
                        flush),
         "dkdv": time_ms(lambda: fa.flash_bwd_dkdv_cuda(
             q, k, v, go, lse, delta, lens, **kw), flush),
         "dq": time_ms(lambda: fa.flash_bwd_dq_cuda(
             q, k, v, go, lse, delta, lens, **kw), flush)}
    with torch.no_grad():
        t["plain_fwd"] = time_ms(lambda: fa._torch_attention(
            q, k, v, lens, **kw), flush, iters=3, warmup=1)
        t["lib_fwd"] = time_ms(lambda: sdpa(*qt, is_causal=True,
                                            scale=kw["scale"]), flush)
    qkv = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = fa._torch_attention(*qkv, lens, **kw)
    t["plain_bwd"] = time_ms(lambda: torch.autograd.grad(
        out, qkv, go, retain_graph=True), flush, iters=5, warmup=1)
    del out
    qt = [x.requires_grad_(True) for x in qt]
    so = sdpa(*qt, is_causal=True, scale=kw["scale"])
    t["lib_bwd"] = time_ms(lambda: torch.autograd.grad(
        so, qt, go.transpose(1, 2), retain_graph=True), flush)
    del so
    pairs = B * HEADS * T * (T + 1) // 2
    row = 2.0 * B * T * HEADS * D             # one [B, T, H, D], 16-bit
    vec = 4.0 * B * HEADS * T                 # one [B, H, T] float32
    work = {"fwd": (4.0 * D * pairs, 4 * row + vec + 4 * B),
            "dkdv": (8.0 * D * pairs, 6 * row + 2 * vec + 4 * B),
            "dq": (6.0 * D * pairs, 5 * row + 2 * vec + 4 * B)}
    out = {}
    for name in ("fwd", "dkdv", "dq"):
        b_ms, b_by = bound(*work[name], PEAK_BF16_FLOPS)
        regs, local = (fres if name == "fwd" else res)[f"{name}_d{D}"]
        plain, lib = (("plain_fwd", "lib_fwd") if name == "fwd"
                      else ("plain_bwd", "lib_bwd"))
        print(f"flash {name} {tag} at [{B}, {T}, {HEADS}, {D}] causal: ms "
              f"{t[name]:.4f}  bound_ms {b_ms:.4f} ({b_by}, the tensor "
              f"cores' dense peak)  plain_ms (the {tag} plain route's "
              f"{'forward' if name == 'fwd' else 'backward, whole'}) "
              f"{t[plain]:.4f}  library_ms (scaled_dot_product_attention"
              f"{'' if name == 'fwd' else ' backward'}, {tag}) "
              f"{t[lib]:.4f}; {regs} registers, {local} bytes local",
              flush=True)
        gs = {"fwd": (), "dkdv": ("dk", "dv"), "dq": ("dq",)}[name]
        out[name] = dict(ms=t[name], plain_ms=t[plain], bound_ms=b_ms,
                         bound_by=b_by, library_ms=t[lib],
                         registers=regs, local_bytes=local)
        if gs:
            out[name].update(
                max_abs_err=max(errs["max_abs"][g] for g in gs),
                row_err=max(errs["upcast"][g][0] for g in gs),
                mma_row_err=max(errs["mma"][g][0] for g in gs),
                mma_row_err_q99=max(errs["mma"][g][1] for g in gs))
        else:
            fe = errs["fwd"]
            out[name].update(
                max_abs_err=max(fe["upcast"]["max_abs_err"],
                                fe["upcast"]["lse_err"]),
                row_err=fe["upcast"]["row_err"],
                mma_row_err=fe["mma"]["row_err"],
                mma_row_err_q99=fe["mma"]["row_err_q99"])
    out["fwd_ms"] = t["fwd"]
    out["planted_fault"] = fault
    if fwd_fault is not None:
        out["fwd"]["planted_fault"] = fwd_fault
    out["distance_to_plain"] = dist
    out["cases"] = cases
    out["resources"] = dict(res, **fres)
    out["shape"] = {"B": B, "Lq": T, "Lk": T, "H": HEADS, "D": D,
                    "causal": True, "dtype": _dt(dtype)}
    return out


def rnn_bf16_phase(dev, gen, flush, dtype=torch.bfloat16):
    """Kernels 5 and 6 at every bf16 (or float16: ``dtype``) instance
    (``fused_rnn.KERNEL_DTYPES``: x in that dtype, the mask float32 or in
    x's) against the plain step on the same operands, values and
    gradients within 1e-4 of max(1, max |ref|) with masked rows copied
    bit for bit, and per row against their 3xTF32 arithmetic
    (``_rnn_check``), at the routes' shapes and a ragged one, and a
    planted fault (``_rnn_planted_fault``) shown to fail; each timed as
    the float32 rows are, its bytes counting x (and the mask) at 2 bytes.
    Every check moves the instances' counter."""
    from paddle_tpu_torch.ops import fused_rnn as fr

    tag = _short(dtype)
    out = {}
    for kind, b in (("lstm", LSTM_BATCH), ("gru", NMT_BATCH)):
        wrapper = fr.lstm_step_cuda if kind == "lstm" else fr.gru_step_cuda
        for dts in fr.KERNEL_DTYPES:
            if dts[0] != dtype:
                continue
            before = getattr(wrapper, "launches_" + tag)
            errs = [_rnn_check(kind, bb, hh, dev, gen, dts)
                    for bb, hh in ((b, RNN_H), (37, 128))]
            if getattr(wrapper, "launches_" + tag) == before:
                raise AssertionError(f"{kind}_step {dts}: the {tag} counter "
                                     f"did not move")
            fault = _rnn_planted_fault(kind, b, dev, gen, dts)
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
            # the float32 product as three TF32 products, beside the FMA
            # floor
            b_ms, b_by = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
            t["fma_bound_ms"] = bound(flops, nbytes)[0]
            key = f"x {_dt(dts[0])}, mask {_dt(dts[1])}"
            print(f"{kind}_step {tag} ({key}) at B {b}, H {H} ({live} live "
                  f"rows): ms {t['ms']:.4f}  bound_ms {b_ms:.4f} ({b_by}, "
                  f"3xTF32)  fma_bound_ms {t['fma_bound_ms']:.4f}  plain_ms "
                  f"{t['plain_ms']:.4f}  library_ms none; the "
                  f"product alone (torch.addmm) {t['addmm_ms']:.4f}",
                  flush=True)
            out.setdefault(kind, {})[key] = dict(
                t, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                max_abs_err=max(e[0] for e in errs),
                max_rel_err=max(e[1] for e in errs), planted_fault=fault,
                shape={"B": b, "H": H, "live_rows": live})
    return out


def _rnn_planted_fault(kind, b, dev, gen, dtypes) -> float:
    """The planted fault of the 16-bit step checks: the kernel's h' held
    against the plain step on x with its last gate's columns (H of them)
    zeroed, what a kernel returns that skips one gate's x; must miss by
    more than TOL of max(1, max |ref|)."""
    from paddle_tpu_torch.ops import fused_rnn as fr

    step = fr.lstm_step if kind == "lstm" else fr.gru_step
    args = _rnn_args(kind, b, RNN_H, dev, gen, dtypes)
    got = step(*args, impl="cuda")
    cut = args[0].clone()
    cut[:, -RNN_H:] = 0
    bad = step(cut, *args[1:], impl="torch")
    got, bad = (t[0] if isinstance(t, tuple) else t for t in (got, bad))
    err = _rel_err(got, bad)
    print(f"{kind}_step x {_dt(dtypes[0])}, mask {_dt(dtypes[1])} planted "
          f"fault (the last gate's x left out): h' misses by {err:.3e} of "
          f"max(1, max |ref|) (limit {TOL}): fails, as it must", flush=True)
    if not err > TOL:
        raise AssertionError(f"{kind}_step {dtypes}: the check passes a "
                             f"planted fault ({err})")
    return err


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
            LAYERS if impl is None else 0, finite=policy != "fp16")
    finally:
        config.set_option("attention_impl", None)
    return trainer, losses, step_s, warm, peak_gb, launches


def _policy_sfx(policy) -> str:
    """The launch counters' suffix of a 16-bit policy's kernel instances:
    "f16" under ``fp16``, "bf16" under ``bf16`` and ``mixed``."""
    return "f16" if policy == "fp16" else "bf16"


def lm_bf16_path(attn_bf16_ms, f32, policies=BF16_POLICIES):
    """The LM under ``bf16`` and ``mixed`` (or ``policies``: ``fp16``) at
    ``bench_transformer`` widths, 8 x 4096, Adam 1e-4, from the seeded
    weights: TRAIN_STEPS steps on the kernels, whose bf16 (float16)
    instances (kernels 1, 2 and 3) must each launch LAYERS times a step,
    and on the plain route, whose losses must stay within LM_BF16_BAND of
    theirs (under ``fp16`` a non-finite loss is reported and the two
    routes are held on the steps before it); the step time, the step
    breakdown, the idle share and the peak memory beside the float32
    run's."""
    paddle, topo = _train_model()
    values = random_values(SEED)
    seqs = np.random.RandomState(SEED + 1).randint(
        0, VOCAB, size=(TRAIN_BATCH, MAX_LEN + 1)).astype(np.int32)
    feed = trainer_feed(seqs[:, :-1], seqs[:, 1:])
    out = {}
    try:
        for policy in policies:
            sfx = _policy_sfx(policy)
            tr, losses, step_s, warm, peak_gb, launches = _lm_policy_run(
                paddle, topo, values, feed, policy, None)
            want = LAYERS * TRAIN_STEPS
            bf16 = {k: launches[f"{k}_{sfx}"] for k in TRAIN_KERNELS}
            if any(n != want for n in bf16.values()) or any(
                    launches[k] != want for k in TRAIN_KERNELS):
                raise AssertionError(f"LM {policy}: the {sfx} attention "
                                     f"kernels did not run {LAYERS} times a "
                                     f"step: {launches}")
            scale = None
            if policy == "mixed":
                ls = tr._opt_state["loss_scale"]
                scale = (float(ls["scale"]), int(ls["skipped"]))
                if scale[1]:
                    raise AssertionError(f"LM mixed skipped {scale[1]} of "
                                         f"{TRAIN_STEPS} clean steps")
            breakdown = step_breakdown(
                tr, feed, attn_bf16_ms,
                torch.float16 if sfx == "f16" else torch.bfloat16)
            del tr
            torch.cuda.empty_cache()
            ptr, plain, _, plain_warm, plain_peak, plain_launches = \
                _lm_policy_run(paddle, topo, values, feed, policy, "torch")
            del ptr
            torch.cuda.empty_cache()
            if any(plain_launches[k] for k in TRAIN_KERNELS):
                raise AssertionError(f"LM {policy} plain route launched "
                                     f"{plain_launches}")
            held = min(_finite_prefix(losses), _finite_prefix(plain))
            band = max(_rel(a, b) for a, b in zip(losses[:held],
                                                  plain[:held]))
            if held < len(losses) or held < len(plain):
                print(f"LM {policy}: a non-finite loss (kernel route "
                      f"{losses}, plain route {plain}); the routes are held "
                      f"on the {held} steps before it", flush=True)
            limit = LM_FP16_BAND if policy == "fp16" else LM_BF16_BAND
            if not band <= limit:
                raise AssertionError(f"LM {policy}: kernel route {losses} "
                                     f"vs plain route {plain}: {band} > "
                                     f"{limit}")
            print(f"LM {policy}: {TRAIN_STEPS} Adam steps (lr {TRAIN_LR}) "
                  f"at batch {TRAIN_BATCH} x {MAX_LEN}, losses "
                  f"{[round(x, 5) for x in losses]}, plain route "
                  f"{[round(x, 5) for x in plain]} ({band:.2e} relative, "
                  f"band {limit}); step time first "
                  f"{step_s[0] * 1e3:.1f} ms, median after it "
                  f"{warm * 1e3:.1f} ms = {TRAIN_BATCH * MAX_LEN / warm:.0f}"
                  f" tokens/s (float32: {f32['step_ms']:.1f} ms; plain route"
                  f" {plain_warm * 1e3:.1f} ms); peak memory {peak_gb:.2f} "
                  f"GB (float32 {f32['peak_gb']:.2f}, plain route "
                  f"{plain_peak:.2f}); {sfx} launches {bf16}"
                  + ("" if scale is None else
                     f"; loss scale {scale[0]:g}, skipped {scale[1]}"),
                  flush=True)
            out[policy] = {"losses": losses, "plain_losses": plain,
                           "band": band, "step_ms": warm * 1e3,
                           "first_step_ms": step_s[0] * 1e3,
                           "plain_step_ms": plain_warm * 1e3,
                           "peak_gb": peak_gb, "plain_peak_gb": plain_peak,
                           "launches": launches, "breakdown": breakdown,
                           "loss_scale": scale, "finite_steps": held}
    finally:
        _policy("fp32")
    return out


def rnn_bf16_paths(policy="bf16"):
    """NMT and the LSTM route under ``bf16`` (or ``policy``: ``fp16``):
    kernel-route parity against ``use_fused_rnn=False`` at batch 8
    (RNN_BF16_TOLS), then the steps of the float32 paths with the bf16
    (float16) instances' counters moving as the float32 ones did (kernel
    6: 100 a step; kernel 5: 200), the step time, and for NMT the
    breakdown and the idle share."""
    sfx = _policy_sfx(policy)
    out = {}
    paddle, topo = nmt_model()
    values = seeded_values(topo, SEED)
    try:
        _policy(policy)
        parity = route_parity(
            f"NMT {policy}", paddle, topo, values,
            nmt_feed(8, [50, 37, 1, 12, 50, 25, 3, 44],
                     [50, 1, 20, 33, 7, 50, 16, 2]),
            f"gru_step_{sfx}", 2 * NMT_LEN, NMT_LR, RNN_BF16_TOLS)
        layer_holds = rnn_layer_holds(
            f"NMT {policy}", paddle, topo, values,
            nmt_feed(8, [50, 37, 1, 12, 50, 25, 3, 44],
                     [50, 1, 20, 33, 7, 50, 16, 2]), "gru", NMT_LEN, 2,
            NMT_LR)
        torch.cuda.empty_cache()
        trainer = paddle.trainer.SGD(topo, paddle.parameters.from_numpy(
            topo, values), paddle.optimizer.Adam(learning_rate=NMT_LR))
        feed = nmt_feed(NMT_BATCH)
        losses, step_s, warm, peak_gb, launches = train_steps(
            f"NMT {policy}", paddle, trainer, feed, NMT_STEPS,
            f"gru_step_{sfx}", 2 * NMT_LEN)
        toks = NMT_BATCH * 2 * NMT_LEN
        print(f"NMT {policy} training: {NMT_STEPS} Adam steps, losses "
              f"{[round(x, 5) for x in losses]}; step time first "
              f"{step_s[0] * 1e3:.1f} ms, median after it {warm * 1e3:.1f} "
              f"ms = {toks / warm:.0f} tokens/s (smoke figure); peak memory "
              f"{peak_gb:.2f} GB; gru_step {sfx} launches "
              f"{launches['gru_step_' + sfx]}", flush=True)
        breakdown = nmt_breakdown(topo, trainer, feed)
        out["nmt"] = {"losses": losses, "step_ms": warm * 1e3,
                      "first_step_ms": step_s[0] * 1e3,
                      "tokens_per_s": toks / warm, "peak_gb": peak_gb,
                      "parity": parity, "breakdown": breakdown,
                      "layer_holds": layer_holds, "launches": launches}
        del trainer
        torch.cuda.empty_cache()

        paddle, topo = lstm_model()
        _policy(policy)
        values = seeded_values(topo, SEED + 2)
        parity = route_parity(
            f"LSTM route {policy}", paddle, topo, values,
            lstm_feed(8, [100, 1, 57, 100, 9, 33, 100, 80]),
            f"lstm_step_{sfx}", 2 * LSTM_LEN, LSTM_LR, RNN_BF16_TOLS)
        layer_holds = rnn_layer_holds(
            f"LSTM route {policy}", paddle, topo, values,
            lstm_feed(8, [100, 1, 57, 100, 9, 33, 100, 80]), "lstm",
            LSTM_LEN, 2, LSTM_LR)
        trainer = paddle.trainer.SGD(topo, paddle.parameters.from_numpy(
            topo, values), paddle.optimizer.Adam(learning_rate=LSTM_LR))
        feed = lstm_feed(LSTM_BATCH)
        losses, step_s, warm, peak_gb, launches = train_steps(
            f"LSTM route {policy}", paddle, trainer, feed, LSTM_STEPS,
            f"lstm_step_{sfx}", 2 * LSTM_LEN, falling=False)
        prof = profile_step(trainer, feed, LSTM_KERNEL)
        print(f"LSTM route {policy} training: {LSTM_STEPS} Adam steps, "
              f"losses "
              f"{[round(x, 5) for x in losses]}; step time first "
              f"{step_s[0] * 1e3:.1f} ms, median after it {warm * 1e3:.1f} "
              f"ms; peak memory {peak_gb:.2f} GB; lstm_step {sfx} launches "
              f"{launches['lstm_step_' + sfx]}; " + _route_profile(prof),
              flush=True)
        out["lstm_route"] = {"losses": losses, "step_ms": warm * 1e3,
                             "first_step_ms": step_s[0] * 1e3,
                             "peak_gb": peak_gb, "parity": parity,
                             "idle_share": prof["idle_share"],
                             "kernel_ms": prof["matched_ms"],
                             "layer_holds": layer_holds,
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
# (source, the kernel's name in the earlier build, in the new one).  The
# float32 flash backward pair and kernels 9's, 8's, 6's and 5's float32
# instances (gemm_stats_kernel<Conv3x3A<float>>, gemm_stats_kernel<
# DenseA<float>, vec>, gru_gates_kernel<float>, gru_cand_kernel<float,
# float> and lstm_step_kernel<float, float>) were pinned here until the
# 3xTF32 kernels replaced them.
SASS_KERNELS = (
    ("bn_stats.cu", "fwd_partial_kernelEPKf", "fwd_partial_kernelIfE"),
    ("bn_stats.cu", "bwd_partial_kernelILb1E", "bwd_partial_kernelIfLb1E"),
    ("bn_stats.cu", "bwd_partial_kernelILb0E", "bwd_partial_kernelIfLb0E"),
)
# their sources as of the last revision before the bf16 instances
# (SASS_BASE_REV; bn_stats.cu and stat_reduce.cuh are the same blobs there
# as at the revision before their own bf16 instances), kept in SASS_BASE
# so that a checkout without history compares them too, each file pinned
# by its git blob id at that revision; rnn_step.cu, whose kernels are no
# longer pinned, is the parent's CUDA-core LSTM and GRU steps (PARENT_SIMT)
SASS_BASE_REV = "704dbc822bcc64241779e3b269892a62eb6b8e70"
SASS_BASE = "paddle_tpu_torch/tools/sass_base"
SASS_BASE_BLOBS = {
    "bn_stats.cu": "2688c2245abea33ec34e0b2db2c5f561604ef115",
    "rnn_step.cu": "3af9bce14b30ba10261c9297c9ed2bab2389d34d",
    "stat_reduce.cuh": "cbe135e3f7369ea805b038fccfe2ea71076bcf06",
}
# the forward sweep's f32-dot bf16 instances, which kernel 1's tensor-core
# kernels must leave alone: their sources as of the revision before the
# bf16 one (FWD_SASS_BASE_REV, whose flash_common.cuh is newer than
# SASS_BASE's), in a folder of their own, pinned the same way.  Kernel 1's
# float32 instance of the same template (flash_fwd_kernel<float, true,
# false>) was pinned here until the 3xTF32 kernel replaced it.
FWD_SASS_KERNELS = tuple(
    ("flash_fwd.cu", name, name) for name in (
        "flash_fwd_kernelI13__nv_bfloat16Lb1ELb0E",
        "flash_fwd_kernelI13__nv_bfloat16Lb1ELb1E",
        "flash_fwd_kernelI13__nv_bfloat16Lb0ELb0E",
        "flash_fwd_kernelI13__nv_bfloat16Lb0ELb1E"))
FWD_SASS_BASE_REV = "f7641f94db667444e7390f307109dec8b0211e5f"
FWD_SASS_BASE = "paddle_tpu_torch/tools/sass_base/f7641f9"
FWD_SASS_BASE_BLOBS = {
    "dtype.cuh": "b21690e89c4c42806e10384d69920c3403b96654",
    "flash_common.cuh": "62fb58e19cbb02e94f149679fbe2d7e69a12f3ae",
    "flash_fwd.cu": "9245ac04de53eda9b598f39550dfbeb08d0c4f32",
}
# the bf16 tensor-core instances of kernels 1, 2, 3, 8 and 9, which the
# float16 instances (the same templates on another element type) must
# leave alone: (source, the kernel in the build before the element type
# became a template parameter, the kernel's bf16 instance now), against
# their sources and headers of MMA_SASS_BASE_REV, pinned the same way
_BF16_MANGLED = "I13__nv_bfloat16"
MMA_SASS_KERNELS = (
    *(("flash_fwd.cu", f"flash_fwd_mma_kernelILi{dt}EE",
       f"flash_fwd_mma_kernel{_BF16_MANGLED}Li{dt}EE") for dt in (64, 128)),
    *(("flash_bwd.cu", f"flash_bwd_{k}_mma_kernelILi{dt}EE",
       f"flash_bwd_{k}_mma_kernel{_BF16_MANGLED}Li{dt}EE")
      for k in ("dkdv", "dq") for dt in (64, 128)),
    *(("conv_bn.cu", f"conv_mma_stats_kernelILi{taps}ELi{w}EE",
       f"conv_mma_stats_kernel{_BF16_MANGLED}Li{taps}ELi{w}EE")
      for taps in (1, 9) for w in (8, 4, 1)))
MMA_SASS_BASE_REV = "bd128be7a4db68f1fb1582c86a7287b83bec2dd2"
MMA_SASS_BASE = "paddle_tpu_torch/tools/sass_base/bd128be"
MMA_SASS_BASE_BLOBS = {
    "conv_bn.cu": "ba12bbe64fc462798c5856519a49a6d7bc4244dc",
    "dtype.cuh": "b21690e89c4c42806e10384d69920c3403b96654",
    "flash_bwd.cu": "104dc4f00499fa62d3f9d8301d6517f6591d2cda",
    "flash_common.cuh": "62fb58e19cbb02e94f149679fbe2d7e69a12f3ae",
    "flash_fwd.cu": "3950aa26250787a931d568cf39d2c08403abd9cb",
    "flash_mma.cuh": "bf96eac44bb5d40f7715db33dd99a6e623f02241",
    "mma_bf16.cuh": "45dab0fdb421741b5c75af10d9a7feb13b01c8e5",
    "stat_reduce.cuh": "9e66188fe6f7fd297e44343e554810745607ab13",
}
# (folder, its revision, its pinned blobs, the kernels built from it)
SASS_BASES = ((SASS_BASE, SASS_BASE_REV, SASS_BASE_BLOBS, SASS_KERNELS),
              (FWD_SASS_BASE, FWD_SASS_BASE_REV, FWD_SASS_BASE_BLOBS,
               FWD_SASS_KERNELS),
              (MMA_SASS_BASE, MMA_SASS_BASE_REV, MMA_SASS_BASE_BLOBS,
               MMA_SASS_KERNELS))


def sass_phase():
    """``tools/sass_diff.py`` over SASS_BASES: each pinned instance's
    machine code against its base folder's build, line for line.  Fails
    when a file of a base folder is missing or is not its revision's."""
    import concurrent.futures
    import os

    from paddle_tpu_torch.tools import sass_diff

    csrc = "paddle_tpu_torch/ops/csrc"
    for base, rev, blobs, _ in SASS_BASES:
        for name, blob in blobs.items():
            got = sass_diff.git_blob_id(os.path.join(base, name))
            if got != blob:
                raise AssertionError(f"{base}/{name} is blob {got}, not "
                                     f"{blob} ({rev[:12]}'s)")
    jobs = {}
    srcs = sorted({src for _, _, _, ks in SASS_BASES for src, _, _ in ks})
    olds = sorted({(base, src) for base, _, _, ks in SASS_BASES
                   for src, _, _ in ks})
    with concurrent.futures.ThreadPoolExecutor(len(srcs) + len(olds)) as pool:
        for base, src in olds:
            jobs[(base, src)] = pool.submit(
                sass_diff.sass_of, os.path.join(base, src),
                f"old_{os.path.basename(base)}_{src.removesuffix('.cu')}")
        for src in srcs:
            jobs[("new", src)] = pool.submit(
                sass_diff.sass_of, os.path.join(csrc, src),
                f"new_{src.removesuffix('.cu')}")
        listings = {key: sass_diff.kernels(f.result())
                    for key, f in jobs.items()}
    out = {}
    for base, _, _, kernels in SASS_BASES:
        for src, old_name, new_name in kernels:
            old = sass_diff.pick(listings[(base, src)], old_name)
            new = sass_diff.pick(listings[("new", src)], new_name)
            diff = sass_diff.first_difference(old, new)
            out[new_name] = len(old) if diff is None else diff
            print(f"sass_diff {src} {new_name} (base {base}): " + (
                f"identical to the earlier build, {len(old)} SASS lines"
                if diff is None else f"differs at line {diff[0]}: old "
                f"{diff[1]!r}, new {diff[2]!r}"), flush=True)
            if diff is not None:
                raise AssertionError(f"{src}: the pinned instance "
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
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max().item()
            / max(1.0, ref.abs().max().item()))


def _hold(what, pairs, tol=TOL):
    """Each (name, kernel value, plain value) within ``tol`` of max(1, max
    |plain|), finite; returns (max abs error, max relative error)."""
    worst_abs = worst_rel = 0.0
    for name, got, ref in pairs:
        rel = _rel_err(got, ref)
        if not (rel <= tol and torch.isfinite(got).all()):
            raise AssertionError(f"{what}: {name} disagrees with the plain "
                                 f"version: {rel} > {tol} of max(1, max "
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


# the 16-bit instances' limits: the statistics within the float32
# kernels' largest reading on the H100 (sums of the same values in another
# order); y's rows each within one rounding to its dtype of the plain
# version's (HALF_TOLS' "conv_row": 2^-7 at bf16, 2^-10 at float16)
CONV_STAT_TOL = 3.8e-6


def _hold_conv_bf16(what, got, ref):
    """Kernel 8's or 9's (y, s, ss) at bf16 (or float16: the plain y's
    dtype) against the plain version's: each row (output pixel) of y
    within HALF_TOLS' "conv_row" of its norm, s and ss
    within CONV_STAT_TOL.  Returns (y's row error, max abs error of y and
    the statistics, the statistics' max relative error)."""
    co = ref[0].shape[-1]
    row_tol = HALF_TOLS[ref[0].dtype]["conv_row"]
    row = _o_row_err(got[0].reshape(-1, co), ref[0].reshape(-1, co))
    if not (row <= row_tol and got[0].dtype == ref[0].dtype
            and torch.isfinite(got[0].float()).all()):
        raise AssertionError(f"{what}: y's rows disagree with the plain "
                             f"version: {row} > {row_tol} "
                             f"({got[0].dtype})")
    e_abs, e_rel = _hold(what, zip(("s", "ss"), got[1:], ref[1:]),
                         CONV_STAT_TOL)
    y_abs = (got[0].float() - ref[0].float()).abs().max().item()
    return row, max(y_abs, e_abs), e_rel


def _bf16_boundary(x2, w, gen, rows_per_channel=16):
    """b [C] and rows that put ``rows_per_channel`` elements of each
    channel of bf16 (or float16) x2 [P, C] where the fold in x2's dtype
    (w and b rounded to it, the product rounded, then the sum) is exactly
    0 while the float32 fold x * w + b is not: those elements take the
    value of one whose product x * dt(w) is not a number of x2's dtype dt,
    and b = -dt(that product).  (At float16 the fold rounds once, so there
    it is the product's rounding residual, whose sign the float32 fold
    does not always share.)  Returns (x2 changed in place, b, rows
    [k, C])."""
    p, c = x2.shape
    dt = x2.dtype
    wb = w.to(dt).float()
    prod = x2.float() * wb
    inexact = prod != prod.to(dt).float()
    src = inexact.float().argmax(dim=0)                 # one such row each
    cols = torch.arange(c, device=x2.device)
    rows = torch.randint(0, p, (rows_per_channel, c), device=x2.device,
                         generator=gen)
    x2[rows, cols] = x2[src, cols]
    b = -(x2[src, cols].float() * wb).to(dt).float()
    return x2, b, rows


def _hold_conv_tf32(cb, what, x, w, got, fault=False):
    """Kernel 8's or 9's float32 (y, s, ss) (x rank 2: kernel 8; rank 4:
    kernel 9) against its arithmetic in plain torch,
    ``_tf32x3_matmul_stats`` or ``_tf32x3_conv3x3_stats``: each row (output
    pixel) of y as ``_tf32_holds`` holds the flash kernels' rows, s and ss
    within TOL of max(1, max |ref|); with ``fault`` the planted fault
    (``terms=1``, one TF32 product), which must fail the row check.
    Returns {row_err, row_err_q99, stat_err[, terms_1_...]}."""
    co = w.shape[-1]
    k, model = ((8, cb._tf32x3_matmul_stats) if x.dim() == 2
                else (9, cb._tf32x3_conv3x3_stats))
    ref = model(x, w)
    worst, q99, ok = _tf32_holds(got[0].reshape(-1, co), ref[0].reshape(-1, co))
    stat = max(_rel_err(g, r) for g, r in zip(got[1:], ref[1:]))
    if not (ok and stat <= TOL):
        raise AssertionError(f"{what}: kernel {k} at float32 disagrees with "
                             f"{model.__name__}: y rows largest {worst}, "
                             f"{BWD_MMA_ROW_Q:.0%} {q99} (limits "
                             f"{TF32_ROW_TOL}, {TF32_ROW_Q99_TOL}), "
                             f"statistics {stat} (limit {TOL})")
    out = dict(row_err=worst, row_err_q99=q99, stat_err=stat)
    if fault:
        bad = model(x, w, terms=1)[0]
        bworst, bq99, bok = _tf32_holds(bad.reshape(-1, co),
                                        ref[0].reshape(-1, co))
        if bok:
            raise AssertionError(f"{what}: the float32 kernel {k} check "
                                 f"passes the planted fault (one TF32 "
                                 f"product): {bworst}, {bq99}")
        out.update(terms_1_row_err=bworst, terms_1_row_err_q99=bq99)
        del bad
    print(f"{what}: kernel {k} at float32 (3xTF32) against "
          f"{model.__name__}: y rows (largest, {BWD_MMA_ROW_Q:.0%}) "
          f"{worst:.3e} {q99:.3e} (limits {TF32_ROW_TOL:.3e}, "
          f"{TF32_ROW_Q99_TOL:.3e}), statistics {stat:.3e}" + (
              f"; planted fault (one TF32 product, terms=1; must fail): y "
              f"rows {bworst:.3e} {bq99:.3e}" if fault else ""), flush=True)
    del ref
    return out


def _parent_conv(lib, x, w):
    """One call of the parent's CUDA-core float32 kernel 8 (x rank 2) or 9
    (x rank 4): (y, s, ss)."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import conv_bn as cb

    *lead, ci = x.shape
    co = w.shape[-1]
    p = int(np.prod(lead))
    y, s, ss, part = cb._outputs(p, co, (*lead, co), x.device, x.dtype)
    vec = cb._vec(ci, co, x, w, y)
    tail = (vec, y.data_ptr(), part.data_ptr(), s.data_ptr(), ss.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if x.dim() == 2:
        err = lib.matmul_stats_f32(x.data_ptr(), w.data_ptr(), p, ci, co,
                                   *tail)
    else:
        err = lib.conv3x3_stats_f32(x.data_ptr(), w.data_ptr(), *lead, ci,
                                    co, *tail)
    _build.check(lib, err, "the parent's float32 kernel")
    return y, s, ss


def _tf32_bounds(prod, flops, nbytes, parent, x, w, hold, flush) -> dict:
    """A float32 kernel 8's or 9's bounds: the product as three TF32
    products at TF32's dense peak (the statistics' adds, under 1% of the
    work, run beside it on the CUDA cores), beside the float32 FMA floor;
    and, from ``parent``, the parent's CUDA-core instance timed on the same
    inputs (held against the plain version first where ``hold``)."""
    from paddle_tpu_torch.ops import conv_bn as cb

    b_ms, b_by = bound(3 * prod, nbytes, PEAK_TF32_FLOPS)
    out = dict(bound_ms=b_ms, bound_by=b_by,
               fma_bound_ms=bound(flops, nbytes)[0])
    if parent is not None:
        if hold:
            ref = (cb._matmul_stats_ref if x.dim() == 2
                   else cb._conv3x3_stats_ref)(x, w)
            _hold(f"the parent's float32 kernel {8 if x.dim() == 2 else 9}",
                  zip(("y", "s", "ss"), _parent_conv(parent, x, w), ref))
            del ref
        out["parent_simt_ms"] = time_ms(lambda: _parent_conv(parent, x, w),
                                        flush, lead=True)
    return out


def conv_phase(dev, gen, flush, dtype=torch.float32, parents=None):
    """Kernels 7a, 7b, 8 and 9 on ``dtype`` operands (float32, or the bf16
    or float16 instances, "bf16" below for either) against their plain
    versions, at every distinct shape ResNet-50 gives them on its main
    path at that precision (batch RESNET_BATCH at float32,
    RESNET_BF16_BATCH under bf16 and fp16), at ragged shapes and (7a, 7b)
    at rank 2: sums within TOL (float32) or CONV_STAT_TOL (bf16) of max(1,
    max |ref|), and 7b's kept count (its sum dy on a dout of ones) equal
    to the plain mask's; 8's and 9's y within TOL at float32, each row
    within HALF_TOLS' "conv_row" of its norm at bf16.  7b's relu boundary: folds exactly 0 dropped as the forward
    drops them.  At float32 the autograd Functions' gradients; at bf16
    planted faults that must fail the checks: 8's last 8 input channels
    left out, and its channels 16-31 (one 16-deep k-step of its
    tensor-core product), one of 9's nine taps, 7b's mask taken on the
    float32 fold on activations placed where it and the bf16 fold
    disagree, and 16 input channels of one of 9's taps (one 16-deep
    k-step of its tensor-core product); 8's and 9's bf16 kernels'
    registers and local memory by copy width (a spill fails).  At float32
    kernels 8 and 9 (3xTF32) also per row against ``_tf32x3_matmul_stats``
    and ``_tf32x3_conv3x3_stats`` (``_hold_conv_tf32``, one TF32 product
    shown to fail at res2), their registers and local memory, and each
    shape timed beside its bound at three TF32 products a float32 one, the
    FMA floor and, from ``parents``, the parent's CUDA-core instance.  Then
    each
    shape's device time (``time_ms(lead=True)``) beside its bound (the
    operands' bytes, the operations at the card's peak for their type; at
    bf16 also ``fma_bound_ms``, the floor at the 67 TFLOP/s of the float32
    FMAs, for 7a and 7b, which sum on the CUDA cores), the plain
    version's, and a library yardstick the port never calls on the same
    inputs (``torch.var_mean``; ``torch.batch_norm_backward_reduce``,
    which takes the same two sums without the relu mask; ``torch.mm`` and
    ``F.conv2d`` alone, the products' floors, on tensor cores at bf16).
    Returns per kernel its representative shape's numbers and the sums
    over one step's launches."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import conv_bn as cb
    from paddle_tpu_torch.ops import fused_bn as fb

    bf16 = dtype != torch.float32          # either 16-bit instance
    tag = _short(dtype) if bf16 else ""
    sfx = f"_{tag}" if bf16 else ""
    row_tol = HALF_TOLS[dtype]["conv_row"] if bf16 else None
    batch = RESNET_BF16_BATCH if bf16 else RESNET_BATCH
    es = torch.empty(0, dtype=dtype).element_size()
    # the dense 16-bit tensor-core peak: the same at bf16 and float16
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
    tol = CONV_STAT_TOL if bf16 else TOL
    _, topo = resnet_model()
    conv1, conv3, bn = resnet_shapes(topo, batch)
    counts = {"matmul_stats": sum(conv1.values()),
              "conv3x3_stats": sum(conv3.values()),
              "bn_fwd_stats": sum(bn.values()),
              "bn_bwd_stats": sum(bn.values())}
    print(f"ResNet-50 at batch {batch}: launches a step by the "
          f"graph {counts}; distinct shapes: kernel 8 {len(conv1)}, "
          f"kernel 9 {len(conv3)}, kernels 7a/7b {len(bn)}", flush=True)
    if counts != {"matmul_stats": 30, "conv3x3_stats": 16,
                  "bn_fwd_stats": 4, "bn_bwd_stats": 4}:
        raise AssertionError(f"the graph's launch counts {counts}")
    # the representative shapes: res2 expand, res2 3x3, the stem
    rep = {"matmul_stats": [batch * 56 * 56, 64, 256],
           "conv3x3_stats": [batch, 56, 56, 64, 64],
           "bn_fwd_stats": [batch, 112, 112, 64],
           "bn_bwd_stats": [batch, 112, 112, 64]}

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    errs = {k: (0.0, 0.0) for k in CONV_KERNELS}   # (max abs, max rel)
    rows_err = {"matmul_stats": 0.0, "conv3x3_stats": 0.0}
    faults = {}
    # kernels 8 and 9 at float32 against their arithmetic, by shape
    conv_tf32 = {"matmul_stats": {}, "conv3x3_stats": {}}

    def note(k, e):
        errs[k] = (max(errs[k][0], e[0]), max(errs[k][1], e[1]))

    def hold_conv(k, what, got, ref):
        if not bf16:
            note(k, _hold(what, zip(("y", "s", "ss"), got, ref)))
            return
        r, *e = _hold_conv_bf16(what, got, ref)
        rows_err[k] = max(rows_err[k], r)
        note(k, e)

    def bn_args(shape):
        c = shape[-1]
        x2 = randn(*shape).view(-1, c).to(dtype)
        xf = x2.float()
        mean = xf.mean(0)
        inv = torch.rsqrt(xf.var(0, unbiased=False) + 1e-5)
        w = randn(c, scale=0.5) * inv
        b = randn(c, scale=0.2) - mean * w
        return x2, randn(*x2.shape).to(dtype), w, b, mean, inv

    # ---- values at every shape, ragged shapes and rank 2
    for shape in list(bn) + [(3, 37, 41, 64), (6272, 512), (1337, 40)]:
        x2, dout, w, b, mean, inv = bn_args(shape)
        note("bn_fwd_stats", _hold(f"bn_fwd_stats{sfx} {shape}", zip(
            ("sum x", "sum x^2"), fb.bn_fwd_stats_cuda(x2),
            fb._fwd_stats_ref(x2)), tol))
        for relu in (True, False):
            note("bn_bwd_stats", _hold(
                f"bn_bwd_stats{sfx} {shape} relu={relu}",
                zip(("sum dy", "sum dy*xhat"),
                    fb.bn_bwd_stats_cuda(dout, x2, w, b, mean, inv, relu),
                    fb._bwd_stats_ref(dout, x2, w, b, mean, inv, relu)),
                tol))
        kept = fb.bn_bwd_stats_cuda(torch.ones_like(dout), x2, w, b, mean,
                                    inv, True)[0]
        want = (fb._fold(x2, w, b) > 0).sum(0).float()
        if not torch.equal(kept, want):
            raise AssertionError(f"bn_bwd_stats{sfx} {shape}: the kernel "
                                 f"kept {kept.sum().item()} elements, the "
                                 f"plain mask {want.sum().item()}")
        del x2, dout
    if not bf16:
        # the relu boundary: b = -fl(x w) on one element of each channel,
        # so the fold is exactly 0 there and relu drops it; its dout is
        # large, so a kernel that kept it would miss by ~1000
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
              f"there): dropped as the forward drops them, error "
              f"{e[1]:.1e} of max(1, max |ref|)", flush=True)
    else:
        # at the stem's shape: 16 elements of each channel where the bf16
        # fold is exactly 0 and the float32 fold is not, dout 1000 there;
        # the kernel drops them as the forward does, a mask on the float32
        # fold keeps those whose float32 fold is > 0
        x2, dout, w, _, mean, inv = bn_args(tuple(rep["bn_bwd_stats"]))
        x2, b, rows = _bf16_boundary(x2, w, gen)
        cols = torch.arange(x2.shape[1], device=dev)
        dout[rows, cols] = 1000.0
        got = fb.bn_bwd_stats_cuda(dout, x2, w, b, mean, inv, True)
        ref = fb._bwd_stats_ref(dout, x2, w, b, mean, inv, True)
        e = _hold(f"bn_bwd_stats {tag} relu boundary", zip(
            ("sum dy", "sum dy*xhat"), got, ref), tol)
        note("bn_bwd_stats", e)
        fold32 = x2.float() * w + b
        planted = fb._fold(x2, w, b)[rows, cols]
        if not (bool((planted == 0).all()) if dtype == torch.bfloat16 else
                bool(((planted > 0) != (fold32[rows, cols] > 0)).any())):
            raise AssertionError(f"{tag} relu boundary: the planted folds "
                                 f"do not part the {tag} fold from the "
                                 "float32 one")
        f32_kept = int((fold32[rows, cols] > 0).sum())
        bad = fb._bwd_stats_ref(dout, x2.float(), w, b, mean, inv, True)
        fault = max(_rel_err(g, r) for g, r in zip(bad, ref))
        kept = fb.bn_bwd_stats_cuda(torch.ones_like(dout), x2, w, b, mean,
                                    inv, True)[0].sum().item()
        kept32 = int((fold32 > 0).sum())
        if not (fault > tol and f32_kept and kept != kept32):
            raise AssertionError(f"bn_bwd_stats {tag} planted fault (the "
                                 f"mask on the float32 fold) passed: "
                                 f"{fault}")
        faults["bn_bwd_stats"] = fault
        print(f"bn_bwd_stats {tag} relu boundary at {rep['bn_bwd_stats']} "
              f"({rows.numel()} elements with the {tag} fold "
              + ("exactly 0" if dtype == torch.bfloat16 else
                 "at the product's rounding residual") + ", "
              f"dout 1000): error {e[1]:.1e}; the mask on the float32 fold "
              f"keeps {f32_kept} of them ({kept32} kept in all against the "
              f"kernel's {kept:.0f}) and misses by {fault:.3e} of max(1, "
              f"max |ref|) (limit {tol}): fails, as it must", flush=True)
        del fold32, bad
    del x2, dout
    # the ragged shapes: every copy width of the bf16 instance (one
    # element, 16-byte copies with Co past a 64-wide tile, 8-byte copies)
    for p, ci, co in list(conv1) + [(1000, 37, 70), (4099, 64, 200),
                                    (2000, 36, 100)]:
        x2 = randn(p, ci).to(dtype)
        w2 = randn(ci, co, scale=ci ** -0.5).to(dtype)
        ref = cb._matmul_stats_ref(x2, w2)
        got = cb.matmul_stats_cuda(x2, w2)
        hold_conv("matmul_stats", f"matmul_stats{sfx} {(p, ci, co)}", got,
                  ref)
        if not bf16:
            conv_tf32["matmul_stats"][(p, ci, co)] = _hold_conv_tf32(
                cb, f"matmul_stats {(p, ci, co)}", x2, w2, got,
                fault=[p, ci, co] == rep["matmul_stats"])
        del got
        if bf16 and [p, ci, co] == rep["matmul_stats"]:
            faults["matmul_stats"] = {}
            # the last 8 input channels left out; one 16-deep k-step of
            # the tensor cores' product (channels 16-31, the first slice's
            # second k-step, in the middle of K)
            for fname, sl in (("last 8 channels", slice(ci - 8, ci)),
                              ("channels 16-31", slice(16, 32))):
                cut = x2.clone()
                cut[:, sl] = 0
                got = cb.matmul_stats_cuda(cut, w2)
                err = _o_row_err(got[0], ref[0])
                faults["matmul_stats"][fname] = err
                if err <= row_tol:
                    raise AssertionError(f"matmul_stats {tag} planted fault "
                                         f"({fname}) passed the row check")
                del cut, got
        del x2, w2, ref
    # the ragged shapes: every staging of the bf16 instance (one element,
    # 16-byte copies with Co past the 64-wide tile, 8-byte copies: Ci = 4
    # mod 8)
    for n, h, w_, ci, co in list(conv3) + [(3, 7, 9, 5, 7),
                                           (2, 13, 11, 64, 72),
                                           (2, 9, 10, 36, 40)]:
        x4 = randn(n, h, w_, ci).to(dtype)
        w4 = randn(3, 3, ci, co, scale=(9 * ci) ** -0.5).to(dtype)
        ref = cb._conv3x3_stats_ref(x4, w4)
        got = cb.conv3x3_stats_cuda(x4, w4)
        hold_conv("conv3x3_stats", f"conv3x3_stats{sfx} "
                  f"{(n, h, w_, ci, co)}", got, ref)
        if not bf16:
            conv_tf32["conv3x3_stats"][(n, h, w_, ci, co)] = _hold_conv_tf32(
                cb, f"conv3x3_stats {(n, h, w_, ci, co)}", x4, w4, got,
                fault=[n, h, w_, ci, co] == rep["conv3x3_stats"])
        del got
        if bf16 and [n, h, w_, ci, co] == rep["conv3x3_stats"]:
            faults["conv3x3_stats"] = {}
            # one of the nine taps left out; one 16-deep k-step of the
            # tensor cores' product (16 input channels of one tap)
            for fname, sl in (("tap (2, 2)", (2, 2)),
                              ("tap (1, 1), channels 16-31",
                               (1, 1, slice(16, 32)))):
                cut = w4.clone()
                cut[sl] = 0
                got = cb.conv3x3_stats_cuda(x4, cut)
                err = _o_row_err(got[0].reshape(-1, co),
                                 ref[0].reshape(-1, co))
                faults["conv3x3_stats"][fname] = err
                if err <= row_tol:
                    raise AssertionError(f"conv3x3_stats {tag} planted fault "
                                         f"({fname}) passed the row check")
                del cut, got
        del x4, w4, ref
    if not bf16:
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
    print(f"conv kernels{' at ' + tag if bf16 else ''} against their plain "
          f"versions (values at every ResNet-50 shape at batch {batch}, "
          f"ragged shapes, rank 2{'' if bf16 else '; gradients'}): worst "
          f"error / max(1, max |ref|) " + ", ".join(
              f"{k} {e[1]:.1e}" for k, e in errs.items())
          + ((f" (statistics' limit {tol}); y's worst row error "
              + ", ".join(f"{k} {e:.1e}" for k, e in rows_err.items())
              + f" (limit {row_tol:.2e}); planted faults (row error, "
              f"or the statistics' for 7b): " + ", ".join(
                  f"{k} {e:.3f}" if not isinstance(e, dict) else ", ".join(
                      f"{k} {f} {v:.3f}" for f, v in e.items())
                  for k, e in faults.items())
              + ", each failing the check") if bf16 else ""), flush=True)
    mma_res = None
    if not bf16:
        tf32_res = cb.conv_tf32_resources()
        print("matmul_stats and conv3x3_stats float32 (3xTF32) kernels' "
              "resources (cudaFuncGetAttributes, by copy width): "
              + ", ".join(f"{n} {r} registers, {l_} bytes local"
                          for n, (r, l_) in tf32_res.items()), flush=True)
        if any(l_ for _, l_ in tf32_res.values()):
            raise AssertionError(f"a float32 kernel 8 or 9 spills: "
                                 f"{tf32_res}")
        parent = parent_lib(parents, "conv_bn") if parents else None
    if bf16:
        mma_res = cb.conv_mma_resources(dtype)
        print(f"matmul_stats and conv3x3_stats {tag} tensor-core kernels' "
              "resources (cudaFuncGetAttributes, by copy width): "
              + ", ".join(f"{n} {r} registers, {l_} bytes local"
                          for n, (r, l_) in mma_res.items()), flush=True)
        if any(l_ for _, l_ in mma_res.values()):
            raise AssertionError(f"a {tag} kernel 8 or 9 spills: {mma_res}")

    # ---- times at every main-path shape
    def bounds(flops, nbytes, fma=bf16):
        b_ms, b_by = bound(flops, nbytes, peak)
        extra = ({"fma_bound_ms": bound(flops, nbytes, PEAK_F32_FLOPS)[0]}
                 if fma else {})
        return dict(extra, bound_ms=b_ms, bound_by=b_by)

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
                **bounds(3.0 * p * c, es * p * c + 4.0 * 2 * c)))
            rows_out["bn_bwd_stats"].append(dict(
                shape=list(shape), count=count,
                ms=time_ms(lambda: fb.bn_bwd_stats_cuda(
                    dout, x2, w, b, mean, inv, True), flush, lead=True),
                plain_ms=time_ms(lambda: fb._bwd_stats_ref(
                    dout, x2, w, b, mean, inv, True), flush, lead=True),
                library_ms=time_ms(lambda: torch.batch_norm_backward_reduce(
                    dn, xn, mean, inv, None, True, False, False), flush,
                    lead=True),
                **bounds(8.0 * p * c, es * 2 * p * c + 4.0 * 6 * c)))
            del x2, dout, xn, dn
        for (p, ci, co), count in conv1.items():
            x2 = randn(p, ci).to(dtype)
            w2 = randn(ci, co, scale=ci ** -0.5).to(dtype)
            prod = 2.0 * p * ci * co
            flops = prod + 3.0 * p * co
            nbytes = es * (p * ci + ci * co + p * co) + 4.0 * 2 * co
            if bf16:
                bnd = bounds(flops, nbytes, fma=False)
            else:
                bnd = _tf32_bounds(prod, flops, nbytes, parent, x2, w2,
                                   [p, ci, co] == rep["matmul_stats"],
                                   flush)
            rows_out["matmul_stats"].append(dict(
                shape=[p, ci, co], count=count,
                ms=time_ms(lambda: cb.matmul_stats_cuda(x2, w2), flush,
                           lead=True),
                plain_ms=time_ms(lambda: cb._matmul_stats_ref(x2, w2),
                                 flush, lead=True),
                library_ms=time_ms(lambda: torch.mm(x2, w2), flush,
                                   lead=True),
                **bnd))
            del x2, w2
        for (n, h, w_, ci, co), count in conv3.items():
            x4 = randn(n, h, w_, ci).to(dtype)
            w4 = randn(3, 3, ci, co, scale=(9 * ci) ** -0.5).to(dtype)
            xn, wn = x4.permute(0, 3, 1, 2), w4.permute(3, 2, 0, 1)
            p = n * h * w_
            prod = 2.0 * p * 9 * ci * co
            flops = prod + 3.0 * p * co
            nbytes = es * (p * ci + 9 * ci * co + p * co) + 4.0 * 2 * co
            if bf16:
                bnd = bounds(flops, nbytes, fma=False)
            else:
                bnd = _tf32_bounds(prod, flops, nbytes, parent, x4, w4,
                                   [n, h, w_, ci, co] == rep["conv3x3_stats"],
                                   flush)
            rows_out["conv3x3_stats"].append(dict(
                shape=[n, h, w_, ci, co], count=count,
                ms=time_ms(lambda: cb.conv3x3_stats_cuda(x4, w4), flush,
                           lead=True),
                plain_ms=time_ms(lambda: cb._conv3x3_stats_ref(x4, w4),
                                 flush, lead=True),
                library_ms=time_ms(lambda: F.conv2d(xn, wn, padding=1),
                                   flush, lead=True),
                **bnd))
            del x4, w4, xn, wn
    torch.cuda.empty_cache()
    on = f" on {tag}" if bf16 else ""
    library = {"bn_fwd_stats": f"torch.var_mean{on}",
               "bn_bwd_stats": f"torch.batch_norm_backward_reduce{on} (the "
                               f"two sums, no relu mask)",
               "matmul_stats": (f"{tag} torch.mm alone (tensor cores)"
                                if bf16 else
                                "torch.mm alone (the product's floor)"),
               "conv3x3_stats": (f"{tag} F.conv2d alone (tensor cores)"
                                 if bf16 else
                                 "F.conv2d alone (the conv's floor)")}
    if not bf16:
        library["conv3x3_stats"] = ("F.conv2d alone at float32, TF32 off "
                                    "(the conv's floor)")
    out = {}
    for k, rows in rows_out.items():
        sums = ("ms", "bound_ms", "plain_ms", "library_ms") + tuple(
            f for f in ("fma_bound_ms", "parent_simt_ms") if f in rows[0])
        tf32_k = not bf16 and k in conv_tf32
        for r in rows:
            print(f"{k}{sfx} {r['shape']} x{r['count']} a step: ms "
                  f"{r['ms']:.4f}  bound_ms {r['bound_ms']:.4f} "
                  f"({r['bound_by']}"
                  + (", 3xTF32 at the TF32 peak" if tf32_k else "") + ")"
                  + (f"  fma_bound_ms {r['fma_bound_ms']:.4f}"
                     if "fma_bound_ms" in r else "")
                  + f"  plain_ms {r['plain_ms']:.4f}  library_ms "
                  f"{r['library_ms']:.4f} ({library[k]})"
                  + (f"  parent_simt_ms {r['parent_simt_ms']:.4f} (the "
                     f"parent's CUDA-core instance)"
                     if "parent_simt_ms" in r else ""), flush=True)
        main = next(r for r in rows if r["shape"] == rep[k])
        step = {f: sum(r[f] * r["count"] for r in rows) for f in sums}
        print(f"{k}{sfx}: one batch-{batch} step's {counts[k]} launches sum "
              f"to ms {step['ms']:.3f}, bound {step['bound_ms']:.3f}, plain "
              f"{step['plain_ms']:.3f}, library {step['library_ms']:.3f}"
              + (f", FMA floor {step['fma_bound_ms']:.3f}"
                 if "fma_bound_ms" in step else "")
              + (f", the parent's {step['parent_simt_ms']:.3f}"
                 if "parent_simt_ms" in step else ""), flush=True)
        out[k] = dict({f: main[f] for f in sums}, bound_by=main["bound_by"],
                      library=library[k], max_abs_err=errs[k][0],
                      max_rel_err=errs[k][1], shape=main["shape"],
                      per_step=step, shapes=rows)
        if bf16 and k in rows_err:
            out[k]["y_row_err"] = rows_err[k]
        if k in faults:
            out[k]["planted_fault"] = faults[k]
    if not bf16:
        for k, name in (("matmul_stats", "matmul"),
                        ("conv3x3_stats", "conv3x3")):
            regs, local = tf32_res[f"{name}_w4"]
            out[k].update(registers=regs, local_bytes=local, resources={
                n: r for n, r in tf32_res.items() if n.startswith(name)},
                          tf32={str(list(sh)): e
                                for sh, e in conv_tf32[k].items()})
    if mma_res is not None:
        for k, name in (("matmul_stats", "matmul"),
                        ("conv3x3_stats", "conv3x3")):
            regs, local = mma_res[f"{name}_w8"]
            out[k].update(registers=regs, local_bytes=local, resources={
                n: r for n, r in mma_res.items() if n.startswith(name)})
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


def resnet_layer_parity(paddle, topo, values, feed, gen, tols=None):
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
    them.  ``tols`` (output, moving statistics, gradients, flip share)
    replaces those limits under a reduced policy (RESNET_BF16_LAYER_TOLS),
    whose compute dtype each layer is applied under."""
    from paddle_tpu_torch.core import config
    from paddle_tpu_torch.core.registry import ApplyContext, get_layer_def

    out_tol, state_tol, grad_tol, flip_share = tols or (TOL, TOL, 1e-3,
                                                        1e-5)
    compute_dtype = config.precision_policy().ctx_compute_dtype()
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
                ctx = ApplyContext(train=True, device=x.device,
                                   compute_dtype=compute_dtype)
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
                if (n_flip > flip_share * flip.numel()
                        or kept > out_tol * max(
                            1.0, yp.abs().max().item())):
                    raise AssertionError(
                        f"ResNet layer parity: {spec.name}: relu decides "
                        f"{n_flip} outputs differently, the largest kept "
                        f"at {kept}")
            flips += n_flip
            cot = torch.randn(yp.shape, device=yp.device,
                              generator=gen).to(yp.dtype)
            cot[flip] = 0.0
            grads = {}
            for kernel, (y, _, lp, xi) in run.items():
                g = torch.autograd.grad(y, list(lp.values()) + [xi], cot)
                grads[kernel] = dict(zip(list(lp) + ["input"], g))
            checks = [("output", spec.name, yk.detach(), yp.detach(),
                       out_tol)]
            checks += [("state", f"{spec.name}.{k}", run[True][1][k], v,
                        state_tol) for k, v in run[False][1].items()]
            checks += [("grad", f"{spec.name} d{k}", grads[True][k], v,
                        grad_tol) for k, v in grads[False].items()]
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
          f"layers whose route differs, each on the plain route's inputs"
          f"{', compute dtype ' + str(compute_dtype) if compute_dtype else ''}"
          f"): worst output {worst['output'][1]} {worst['output'][0]:.1e} "
          f"(bound {out_tol:.2e}), moving statistics {worst['state'][1]} "
          f"{worst['state'][0]:.1e} (bound {state_tol}); worst gradient "
          f"{worst['grad'][1]} {worst['grad'][0]:.1e} (bound "
          f"{grad_tol:.2e}); relu decided {flips} "
          f"outputs differently (folds within a rounding of 0, cotangent "
          f"zero there)", flush=True)
    return dict({k: v[0] for k, v in worst.items()}, relu_flips=flips)


# device kernels of a ResNet step by part, from their names: the port's
# own kernels; cuDNN's and cuBLAS's products (the plain convs, the fused
# convs' backward, and fc's ~0.05 ms of products); pooling; the host-to-
# device copy of the feed; the rest is elementwise passes and reductions
# (batch-norm apply and backward, relu, residual adds, the loss's
# logsumexp and gather, Momentum)
# a kernel's part: the first whose keys its name holds.  The port's keys
# name every kernel that conv_bn.cu, bn_stats.cu and stat_reduce.cuh
# launch (the 16-bit and float32 conv kernels, whose names hold "conv",
# and the W planes' pre-pass before cuDNN's keys take them; stat_reduce's
# chunk_kernel and finish_kernel by their namespace)
_PARTS = (("the kernels (7a, 7b, 8, 9)", ("conv_mma_stats_kernel",
                                          "conv_tf32_stats_kernel",
                                          "split_w_planes_kernel",
                                          "fwd_partial_kernel",
                                          "bwd_partial_kernel",
                                          "stat_reduce::")),
          ("plain convs and their backward, fc (cuDNN, cuBLAS)",
           ("conv", "gemm", "xmma", "cudnn", "cutlass", "wgrad", "dgrad",
            "implicit", "winograd", "fft", "sm90", "sm80", "ampere")),
          ("pool", ("pool", "Pool")),
          ("feed copy (host to device)", ("Memcpy HtoD",)))
_REST = ("elementwise and reductions (BN apply and backward, relu, adds, "
         "loss, Momentum)")


def part_of(kname: str) -> str:
    """The part of a ResNet step a device activity of that name is in."""
    return next((name for name, keys in _PARTS
                 if any(k in kname for k in keys)), _REST)


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
        parts[part_of(kname)] += ms
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


# -------------------------------------------------- ResNet path at bf16
# resnet_layer_parity's limits under bf16 (output, moving statistics,
# gradients, relu flip share): the bf16 output and the gradients within a
# few bf16 roundings of max(1, max |ref|) (read on the H100: 6.3e-3 and
# 9.3e-3), the float32 moving statistics as at float32 (read 1.1e-6), a
# relu flip where the two routes' folds round apart (read: 1 output)
RESNET_BF16_LAYER_TOLS = (2.0 ** -6, TOL, 2.0 ** -5, 1e-4)


def _bf16_train(name, paddle, topo, values, kernels: bool, sfx="bf16"):
    """RESNET_STEPS Momentum steps of ``trainer.SGD.train`` under the
    current policy at RESNET_BF16_BATCH x RESNET_IMAGE^2, counts set to 0
    just before and read just after: with ``kernels`` the bf16 (``sfx``
    "f16": float16) instances of 8 / 9 / 7a / 7b launch 30 / 16 / 4 / 4
    times a step and no other instance, else none of the four; then the
    step breakdown and the idle share.  Returns the trainer and its
    numbers."""
    trainer = paddle.trainer.SGD(topo, paddle.parameters.from_numpy(
        topo, values), paddle.optimizer.Momentum(learning_rate=RESNET_LR,
                                                 momentum=0.9))
    feed = resnet_feed(RESNET_BF16_BATCH)
    losses, step_s, warm, peak_gb, launches = train_steps(
        name, paddle, trainer, feed, RESNET_STEPS, f"matmul_stats_{sfx}",
        30 if kernels else 0, falling=False)
    per_step = {k: launches[f"{k}_{sfx}"] / RESNET_STEPS
                for k in CONV_KERNELS}
    f32 = {k: launches[k] - launches[f"{k}_{sfx}"] for k in CONV_KERNELS}
    want = ({"matmul_stats": 30, "conv3x3_stats": 16, "bn_fwd_stats": 4,
             "bn_bwd_stats": 4} if kernels else dict.fromkeys(CONV_KERNELS, 0))
    if per_step != want or any(f32.values()):
        raise AssertionError(f"{name}: {sfx} launches a step {per_step}, "
                             f"other launches {f32}")
    print(f"{name}: {RESNET_STEPS} Momentum steps (lr {RESNET_LR}, 0.9) at "
          f"batch {RESNET_BF16_BATCH} x {RESNET_IMAGE}^2, losses "
          f"{[round(x, 5) for x in losses]}; step time first "
          f"{step_s[0] * 1e3:.1f} ms, median after it {warm * 1e3:.1f} ms = "
          f"{RESNET_BF16_BATCH / warm:.1f} images/s (smoke figure, not a "
          f"benchmark); peak memory {peak_gb:.2f} GB; {sfx} launches a step "
          f"{per_step}, other launches {f32}", flush=True)
    breakdown = resnet_breakdown(trainer, feed)
    return trainer, {"losses": losses, "step_ms": warm * 1e3,
                     "first_step_ms": step_s[0] * 1e3,
                     "images_per_s": RESNET_BF16_BATCH / warm,
                     "peak_gb": peak_gb, "launches": launches,
                     "breakdown": breakdown}


def resnet_bf16_path(policy="bf16"):
    """ResNet-50 at full width under ``precision="bf16"`` (the bench's; or
    ``policy``: ``fp16``, on the float16 instances, without the bench's
    configuration, which runs no kernel of this repo):
    first the model ``resnet_model()`` builds, both fusions on, whose
    kernel route must agree with its plain route layer by layer at batch
    RESNET_PARITY_BATCH within RESNET_BF16_LAYER_TOLS
    (``resnet_layer_parity``; end to end the bf16 rounding amplified
    through 53 batch norms at that batch moves the plain route's own
    early gradients by their whole scale, so that comparison could not
    tell a wrong kernel from a right one), then trains RESNET_STEPS steps at RESNET_BF16_BATCH on the kernels'
    bf16 instances (``_bf16_train``), and ``SGD.test`` on the trained
    state must launch none of them.  Then ``bench_resnet``'s own
    configuration: ``bf16``, ``fuse_conv_bn`` off, ``fused_bn_impl`` left
    at its default (no kernel of this repo on the path), the same steps,
    a smoke figure of what the bench will measure."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.core import config
    from paddle_tpu_torch.models import resnet

    paddle, topo = resnet_model()
    values = resnet_values(topo, SEED + 4)
    sfx = _policy_sfx(policy)
    _policy(policy)
    out = {}
    try:
        parity_feed = resnet_feed(RESNET_PARITY_BATCH, SEED + 5)
        torch.backends.cudnn.deterministic = True
        try:
            layers = resnet_layer_parity(
                paddle, topo, values, parity_feed,
                torch.Generator(device="cuda").manual_seed(SEED),
                tols=RESNET_BF16_LAYER_TOLS)
        finally:
            torch.backends.cudnn.deterministic = False
        out["layer_parity"] = layers
        torch.cuda.empty_cache()
        trainer, out["fused"] = _bf16_train(
            f"ResNet-50 {policy} (fuse_conv_bn='all', "
            "fused_bn_impl='pallas')", paddle, topo, values, kernels=True,
            sfx=sfx)
        ops.reset_launch_counts()
        result = trainer.test(lambda: iter([resnet_feed(32, SEED + 6)]))
        eval_launches = {k: v for k, v in ops.launch_counts().items()
                         if k.removesuffix("_" + sfx) in CONV_KERNELS}
        # under fp16 the cost may be inf or nan, and is printed: four steps
        # at lr 0.1 leave moving statistics that put the eval's activations
        # past float16's 65504 (the bf16 eval's cost reads ~1e11)
        if (not (np.isfinite(result.cost) or policy == "fp16")
                or any(eval_launches.values())):
            raise AssertionError(f"ResNet-50 {policy} eval: cost "
                                 f"{result.cost}, launches {eval_launches}")
        print(f"ResNet-50 {policy} eval (SGD.test, batch 32, the moving "
              f"statistics): cost {result.cost:.5f}, no kernel launched"
              + ("" if np.isfinite(result.cost) else
                 " (not finite: the eval's activations pass float16's "
                 "range)"), flush=True)
        out["fused"]["eval_cost"] = result.cost
        del trainer
        torch.cuda.empty_cache()
        if policy != "bf16":
            return out

        _fresh(paddle)
        paddle.init(seed=SEED, fuse_conv_bn=False, fused_bn_impl=None)
        cost, _ = resnet.build(depth=50, image_size=RESNET_IMAGE,
                               num_classes=RESNET_CLASSES,
                               space_to_depth=True)
        bench_topo = paddle.Topology(cost)
        if any(spec.kind == "conv_bn" for spec in bench_topo.specs):
            raise AssertionError("the bench configuration fused a conv")
        trainer, out["bench"] = _bf16_train(
            "ResNet-50 bf16, bench_resnet's configuration (no fusion, "
            "plain statistics)", paddle, bench_topo,
            resnet_values(bench_topo, SEED + 4), kernels=False)
        del trainer
        torch.cuda.empty_cache()
    finally:
        _policy("fp32")
        config.set_option("fuse_conv_bn", False)
        config.set_option("fused_bn_impl", None)
    fused, bench = out["fused"]["step_ms"], out["bench"]["step_ms"]
    print(f"ResNet-50 at bf16, batch {RESNET_BF16_BATCH}: the fused path "
          f"{fused:.1f} ms a step, the bench's configuration {bench:.1f} ms "
          f"({'fused' if fused < bench else 'unfused'} faster by "
          f"{abs(fused - bench):.1f} ms; smoke figures)", flush=True)
    return out


# ------------------------------------------- the trainer's dispatch options
# k of ``train(steps_per_dispatch=k)`` on each path: ``bench_lstm``'s 10
# for the LSTM route, 4 for NMT, 2 for the LM
DISPATCH_K = {"lstm": 10, "nmt": 4, "lm": 2}
# NMT's buckets under seq_buckets="auto" (powers of two >= 8 capped at
# max_len 50) and the batches drawn in each: one chunk of k a bucket
NMT_BUCKETS = (8, 16, 32, NMT_LEN)


def _trainers_equal(a, b) -> tuple:
    """(bit-equal, largest difference) of two trainers' state: every
    parameter, optimizer slot and step counter, loss-scale and running
    state tensor."""
    ta, tb = a._state_tensors(), b._state_tensors()
    worst = max((x.double() - y.double()).abs().max().item()
                for x, y in zip(ta, tb))
    return (len(ta) == len(tb)
            and all(torch.equal(x, y) for x, y in zip(ta, tb))), worst


def _losses(paddle, trainer, reader, **kw) -> list:
    """``trainer.train`` over ``reader``; the per-batch costs."""
    out = []
    trainer.train(reader, event_handler=lambda e: out.append(e.cost) if
                  isinstance(e, paddle.event.EndIteration) else None, **kw)
    return out


def _eager_ms(trainer, feeds) -> float:
    """The median host time of one eager step over ``feeds`` after the
    first, on copies of the trainer's state."""
    times = []
    with trainer.on_copies():
        for feed in feeds:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer._step(feed)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    rest = sorted(times[1:])
    return rest[len(rest) // 2] * 1e3


def _idle(prof) -> str:
    if prof["idle_share"] is None:
        return "idle share not measured (no device activity traced)"
    return (f"device busy {prof['busy_ms']:.1f} of {prof['step_ms']:.1f} ms, "
            f"idle share {prof['idle_share']:.1%}")


class _RnnCalls:
    """Records the operands and the results of chosen kernel 5 or 6 calls
    (``_LstmStep`` / ``_GruStep``, counted in call order; with
    ``capturing_only`` only the calls a CUDA graph captures, whose copies
    a replay then fills), for the per-layer hold (``hold``)."""

    def __init__(self, kind, picks, capturing_only=False):
        from paddle_tpu_torch.ops import fused_rnn as fr
        self.fr, self.kind, self.picks = fr, kind, set(picks)
        self.cls = fr._LstmStep if kind == "lstm" else fr._GruStep
        self.capturing_only = capturing_only
        self.calls, self.seen = [], 0

    def __enter__(self):
        orig = self.orig = self.cls.forward

        def forward(ctx, *args):
            out = orig(ctx, *args)
            if (not self.capturing_only
                    or torch.cuda.is_current_stream_capturing()):
                if self.seen in self.picks:
                    outs = out if isinstance(out, tuple) else (out,)
                    self.calls.append((self.seen,
                                       [a.detach().clone() for a in args],
                                       tuple(o.detach().clone()
                                             for o in outs)))
                self.seen += 1
            return out

        self.cls.forward = staticmethod(forward)
        return self

    def __exit__(self, *exc):
        self.cls.forward = staticmethod(self.orig)

    def hold(self, what, per_step, t_len) -> dict:
        """Each recorded call's results per row against the kernel's own
        arithmetic on its operands (``_hold_rnn_tf32``); a step makes
        ``per_step`` calls, a layer ``t_len`` of them."""
        torch.cuda.synchronize()
        if len(self.calls) != len(self.picks):
            raise AssertionError(f"{what}: recorded calls "
                                 f"{[c[0] for c in self.calls]}, expected "
                                 f"{sorted(self.picks)}")
        worst = {"row_err": 0.0, "row_err_q99": 0.0}
        for i, args, got in self.calls:
            r = _hold_rnn_tf32(self.fr, self.kind,
                               f"{what} call {i} (step {i // per_step}, "
                               f"layer {i % per_step // t_len}, call "
                               f"{i % t_len} of the layer)", args, got)
            worst = {k: max(worst[k], r[k]) for k in worst}
        return worst


def rnn_layer_holds(name, paddle, topo, values, feed, kind, t_len,
                    n_layers, lr):
    """Kernel 5 or 6 per layer on the route's own inputs (ROADMAP W1):
    one forward of the route at the parity batch, each layer's first,
    middle and last step held per row against the kernel's arithmetic on
    the operands the route gave it.  A kernel fault fails here; a bf16
    rounding that moves the first loss does not."""
    picks = [l * t_len + t for l in range(n_layers)
             for t in (0, t_len // 2, t_len - 1)]
    tr = paddle.trainer.SGD(topo, paddle.parameters.from_numpy(
        topo, values), paddle.optimizer.Adam(learning_rate=lr))
    with _RnnCalls(kind, picks) as rec:
        tr.forward_backward(feed)
    return rec.hold(f"{name} per layer (kernel {5 if kind == 'lstm' else 6})",
                    n_layers * t_len, t_len)


def _chunk_entry(trainer):
    entries = list(trainer._chunks.entries.values())
    return entries[-1]


def dispatch_check(name, paddle, make_trainer, feeds, k, kernels, per_step,
                   hold=None):
    """One path's chunk against its eager steps: trainer A takes the k
    feeds as eager steps, trainer B (the same start) as one
    ``steps_per_dispatch=k`` chunk, one CUDA graph; their losses and every
    state tensor must be equal bit for bit.  A second chunk on B replays
    the graph: each of ``kernels`` must execute ``per_step`` times a step
    in it and nothing be captured again.  Then the eager step's ms (median, on
    copies of A's state), the chunk's ms a step
    (``timed_multi_dispatch``, 3 timed replays) and the idle share of one
    eager step and of one replay (``torch.profiler``).  ``hold``, a
    ``_RnnCalls`` recording inside the capture, is held after the first
    replay."""
    from paddle_tpu_torch import ops

    a, b = make_trainer(), make_trainer()
    eager = _losses(paddle, a, lambda: iter(feeds))
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    if hold is not None:
        with hold:
            chunk = _losses(paddle, b, lambda: iter(feeds),
                            steps_per_dispatch=k)
        holds = hold.hold(f"{name} inside the captured chunk", per_step,
                          LSTM_LEN)
    else:
        chunk = _losses(paddle, b, lambda: iter(feeds), steps_per_dispatch=k)
        holds = None
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    same, worst = _trainers_equal(a, b)
    if chunk != eager or not same:
        raise AssertionError(f"{name}: the {k}-step graph is not its eager "
                             f"steps bit for bit: losses {chunk} vs {eager}, "
                             f"largest state difference {worst}")
    ops.reset_launch_counts()
    _losses(paddle, b, lambda: iter(feeds), steps_per_dispatch=k)
    torch.cuda.synchronize()
    counts = {n: c for n, c in ops.launch_counts().items() if c}
    replay = counts.get(kernels[0], 0)
    if (any(counts.get(n) != per_step * k for n in kernels)
            or b.step_capture_count != 1):
        raise AssertionError(f"{name}: one replay ran {counts} (expected "
                             f"{per_step * k} of each of {kernels}); "
                             f"captures {b.step_capture_count}")
    entry = _chunk_entry(b)
    stacked = b._stack_group(feeds)
    prof_replay = profile_call(lambda: entry(stacked))
    prof_eager = profile_step(a, feeds[0])
    b.release_chunks()
    del b
    torch.cuda.empty_cache()
    eager_ms = _eager_ms(a, feeds[:4])
    dt, n = a.timed_multi_dispatch(feeds[0], k, iters=3, warmup=1)
    chunk_ms = dt / n * 1e3
    print(f"{name} steps_per_dispatch={k} (one CUDA graph): losses "
          f"{[round(x, 5) for x in chunk]} equal to {k} eager steps bit for "
          f"bit, every parameter, slot and state tensor too; executions in "
          f"one replay {counts} ({per_step} a step each); eager "
          f"step {eager_ms:.1f} ms, chunk {chunk_ms:.1f} ms a step "
          f"(timed_multi_dispatch); one eager step: {_idle(prof_eager)}; one "
          f"replay ({k} steps): {_idle(prof_replay)}; peak memory with the "
          f"graph {peak_gb:.2f} GB; {card_line()}", flush=True)
    del a
    torch.cuda.empty_cache()
    return {"k": k, "losses": chunk, "bit_equal": True,
            "replay_launches": replay, "replay_counts": counts,
            "eager_ms": eager_ms,
            "chunk_ms": chunk_ms, "eager_idle_share": prof_eager["idle_share"],
            "replay_idle_share": prof_replay["idle_share"],
            "replay_ms": prof_replay["step_ms"],
            "replay_busy_ms": prof_replay["busy_ms"], "peak_gb": peak_gb,
            "kernel_holds": holds}


def lstm_dispatch(policy="fp32"):
    """The LSTM route at B 128, T 100 under ``policy`` with
    ``bench_lstm``'s k = 10: ten eager steps against one 10-step graph,
    kernel 5 executing 2000 times a replay, and kernel 5 held per layer
    inside the capture (the first step's first call, its second layer's
    middle call, the tenth step's last call)."""
    k, per_step = DISPATCH_K["lstm"], 2 * LSTM_LEN
    sfx = _policy_sfx(policy)
    paddle, topo = lstm_model()
    _policy(policy)
    try:
        values = seeded_values(topo, SEED + 2)
        feeds = [lstm_feed(LSTM_BATCH, seed=SEED + 10 + i) for i in range(k)]
        hold = _RnnCalls("lstm", (0, per_step // 2 + LSTM_LEN // 2,
                                  per_step * k - 1), capturing_only=True)
        return dispatch_check(
            f"LSTM route {policy}", paddle,
            lambda: paddle.trainer.SGD(topo, paddle.parameters.from_numpy(
                topo, values), paddle.optimizer.Adam(learning_rate=LSTM_LR)),
            feeds, k, ["lstm_step" + ("" if policy == "fp32" else "_" + sfx)],
            per_step, hold)
    finally:
        _policy("fp32")


def counter_growth_check(policy="fp32"):
    """A planted check of the arrival counters: capture the LSTM route's
    chunk, replay it from a saved state, then grow the counters of the
    default stream and of the capture stream with eager kernel 5 calls at
    B 2048 (512 tiles, past the 256 a stream starts with), put the state
    back and replay again: the losses and the state must be equal bit for
    bit, since the graph holds the counters it captured."""
    from paddle_tpu_torch.ops import fused_rnn as fr
    from paddle_tpu_torch.ops.paged_attention import arrival_counters

    k = DISPATCH_K["lstm"]
    paddle, topo = lstm_model()
    values = seeded_values(topo, SEED + 2)
    tr = paddle.trainer.SGD(topo, paddle.parameters.from_numpy(
        topo, values), paddle.optimizer.Adam(learning_rate=LSTM_LR))
    feeds = [lstm_feed(LSTM_BATCH, seed=SEED + 30 + i) for i in range(k)]
    stacked = tr._stack_group(feeds)
    entry = tr._chunk(stacked, k)
    start = [t.clone() for t in tr._state_tensors()]
    first = entry(stacked)
    after = [t.clone() for t in tr._state_tensors()]
    dev = tr.device
    stream = tr._chunks._stream
    held = entry.arrivals
    default = torch.cuda.current_stream(dev).cuda_stream
    before = {s: arrival_counters(dev, s)
              for s in (default, stream.cuda_stream)}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    big = _rnn_args("lstm", 2048, RNN_H, dev, gen)
    fr.lstm_step_cuda(*big)
    with torch.cuda.stream(stream):
        fr.lstm_step_cuda(*big)
    torch.cuda.synchronize()
    grown = {s: arrival_counters(dev, s) for s in before}
    if any(g is None or g.numel() < 512 or (b is not None and g is b)
           for s, g in grown.items() for b in (before[s],)):
        raise AssertionError("counter growth check: the large calls did "
                             "not grow both streams' counters")
    for t, s in zip(tr._state_tensors(), start):
        t.copy_(s)
    again = entry(stacked)
    torch.cuda.synchronize()
    same = (torch.equal(first, again) and all(
        torch.equal(t, s) for t, s in zip(tr._state_tensors(), after)))
    print(f"arrival counters: the LSTM chunk captured {held.numel()} "
          f"counters on its own stream; eager kernel 5 calls at B 2048 grew "
          f"the default stream's to {grown[default].numel()} and the "
          f"capture stream's to {grown[stream.cuda_stream].numel()}; the "
          f"replay from the same state after them is "
          f"{'bit-equal' if same else 'DIFFERENT'}", flush=True)
    tr.release_chunks()
    del tr, entry
    torch.cuda.empty_cache()
    if not same:
        raise AssertionError("counter growth check: the replay changed "
                             "after the counters grew")
    return {"held_counters": held.numel(), "bit_equal": same}


def nan_check_phase():
    """``check_nan_inf`` on the card: an MLP (1024 -> 4096 relu -> 1000)
    with ``steps_per_dispatch=2`` (which it stands down to one step) takes
    a clean batch, then a batch with one NaN sample; that step must raise
    FloatingPointError naming the loss and every gradient."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.ir import reset_name_counters

    reset_name_counters()
    paddle.init(seed=SEED)
    layer = paddle.layer
    x = layer.data("x", paddle.data_type.dense_vector(1024))
    y = layer.data("y", paddle.data_type.integer_value(1000))
    h = layer.fc(x, size=4096, act="relu", name="hidden")
    topo = paddle.Topology(layer.classification_cost(
        layer.fc(h, size=1000, name="out"), y, name="cost"))
    tr = paddle.trainer.SGD(topo, paddle.parameters.create(topo),
                            paddle.optimizer.Momentum(learning_rate=0.01,
                                                      momentum=0.9),
                            check_nan_inf=True)
    rng = np.random.RandomState(SEED)
    xs = rng.randn(256, 1024).astype(np.float32)
    ys = rng.randint(0, 1000, 256).astype(np.int32)
    bad = xs.copy()
    bad[5, 9] = np.nan
    want = {"loss", "hidden.w0@GRAD", "hidden.b@GRAD", "out.w0@GRAD",
            "out.b@GRAD"}
    try:
        tr.train(lambda: iter([{"x": xs, "y": ys}, {"x": bad, "y": ys}]),
                 event_handler=lambda e: None, steps_per_dispatch=2)
    except FloatingPointError as e:
        named = set(str(e).rsplit(" in: ", 1)[1].split(", "))
        msg = str(e)
    else:
        raise AssertionError("check_nan_inf: the NaN batch did not raise")
    if "batch 1" not in msg or named != want:
        raise AssertionError(f"check_nan_inf raised {msg!r}, expected the "
                             f"names {sorted(want)} at batch 1")
    print(f"check_nan_inf on the card (steps_per_dispatch=2, stood down to "
          f"one step): {msg}; captures {tr.step_capture_count}", flush=True)
    return {"message": msg, "captures": tr.step_capture_count}


def _nmt_bucket_samples():
    """Ragged NMT samples (source and target lengths 1 to 50, token ids
    from a numpy seed), DISPATCH_K["nmt"] batches of NMT_BATCH for each
    bucket of NMT_BUCKETS: each batch's longest sequence lands in its
    bucket, as length-sorted batching draws them."""
    rng = np.random.RandomState(SEED + 5)
    out = []
    for top in NMT_BUCKETS:
        for _ in range(DISPATCH_K["nmt"] * NMT_BATCH):
            ls, lt = rng.randint(1, top + 1, 2)
            if len(out) % NMT_BATCH == 0:
                ls = top                     # the batch reaches its bucket
            ids = [rng.randint(3, NMT_VOCAB, n).tolist() for n in
                   (ls, lt, lt)]
            out.append(tuple(ids))
    return out


def nmt_dispatch():
    """NMT at ``bench_nmt``'s widths with ``seq_buckets="auto"``,
    ``prefetch_depth=2`` and k = 4 over ragged batches in four buckets:
    the chunked run against the eager one on the same padded feeds, bit
    for bit; one capture a bucket hit; kernel 6 executing 2 x T a step at
    each bucket's T in the replays; the padding the buckets remove; the
    eager and chunked ms a step and the idle share of a replay at T 50."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.data_feeder import DataFeeder

    k = DISPATCH_K["nmt"]
    paddle, topo = nmt_model()
    values = seeded_values(topo, SEED)
    samples = _nmt_bucket_samples()
    feeding = {"source_words": 0, "target_words": 1, "target_next_words": 2}
    reader = paddle.batch(lambda: iter(samples), NMT_BATCH)

    def make():
        return paddle.trainer.SGD(topo, paddle.parameters.from_numpy(
            topo, values), paddle.optimizer.Adam(learning_rate=NMT_LR))

    a, b = make(), make()
    kw = dict(feeding=feeding, seq_buckets="auto")
    t0 = time.perf_counter()
    eager = _losses(paddle, a, reader, **kw)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    chunk = _losses(paddle, b, reader, prefetch_depth=2,
                    steps_per_dispatch=k, **kw)
    same, worst = _trainers_equal(a, b)
    if chunk != eager or not same:
        raise AssertionError(f"NMT buckets: the chunks are not the eager "
                             f"steps bit for bit: losses {chunk} vs {eager}; "
                             f"largest state difference {worst}")
    feeder = DataFeeder(topo, feeding)
    convert = a._make_feed_converter(feeder, "auto")
    batches = list(reader())
    pads = [convert(bt)["source_words"].shape[1] for bt in batches]
    hit = sorted(set(pads))
    if b.step_capture_count != len(hit) or hit != list(NMT_BUCKETS):
        raise AssertionError(f"NMT buckets: {b.step_capture_count} captures "
                             f"for the buckets {hit}")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _losses(paddle, b, reader, prefetch_depth=2, steps_per_dispatch=k, **kw)
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    replays = ops.launch_counts()["gru_step"]
    if replays != 2 * sum(pads) or b.step_capture_count != len(hit):
        raise AssertionError(f"NMT buckets: gru_step ran {replays} times in "
                             f"the replays, expected {2 * sum(pads)}")
    cells = sum(pads)
    removed = 1.0 - cells / (len(pads) * NMT_LEN)
    full = [convert(bt) for bt in batches[-k:]]
    stacked = b._stack_group(full)
    entry = b._chunks.get("train_chunk", k, stacked, b._step,
                          b._state_tensors)
    prof_replay = profile_call(lambda: entry(stacked))
    prof_eager = profile_step(a, full[0])
    b.release_chunks()
    del b
    torch.cuda.empty_cache()
    eager_ms = _eager_ms(a, full)
    dt, n = a.timed_multi_dispatch(full[0], k, iters=3, warmup=1)
    chunk_ms = dt / n * 1e3
    print(f"NMT seq_buckets=auto, prefetch_depth=2, steps_per_dispatch={k} "
          f"over {len(pads)} ragged batches of {NMT_BATCH} (lengths 1 to "
          f"{NMT_LEN}): buckets hit {hit}, captures {len(hit)}; losses equal "
          f"to the eager steps on the same padded feeds bit for bit, every "
          f"state tensor too; gru_step executions in the replays {replays} "
          f"(2 x T a step); padding removed {removed:.1%} of the T cells; "
          f"the pass eager {eager_s * 1e3:.0f} ms, chunked (replays) "
          f"{chunk_s * 1e3:.0f} ms; at T {NMT_LEN}: eager step "
          f"{eager_ms:.1f} ms, chunk {chunk_ms:.1f} ms a step "
          f"(timed_multi_dispatch); one eager step: {_idle(prof_eager)}; one "
          f"replay ({k} steps): {_idle(prof_replay)}; {card_line()}",
          flush=True)
    del a
    torch.cuda.empty_cache()
    return {"k": k, "buckets": hit, "captures": len(hit), "bit_equal": True,
            "replay_launches": replays, "padding_removed": removed,
            "pass_eager_ms": eager_s * 1e3, "pass_chunked_ms": chunk_s * 1e3,
            "eager_ms": eager_ms, "chunk_ms": chunk_ms,
            "eager_idle_share": prof_eager["idle_share"],
            "replay_idle_share": prof_replay["idle_share"],
            "replay_ms": prof_replay["step_ms"],
            "replay_busy_ms": prof_replay["busy_ms"]}


def lm_dispatch(policy="fp32"):
    """The LM at 8 x 4096 under ``policy``: two eager steps against one
    2-step graph, bit for bit, kernels 1, 2 and 3 executing 8 times a step
    in a replay."""
    k = DISPATCH_K["lm"]
    paddle, topo = _train_model()
    _policy(policy)
    try:
        values = random_values(SEED)
        rng = np.random.RandomState(SEED + 3)
        feeds = []
        for _ in range(k):
            seqs = rng.randint(0, VOCAB, size=(TRAIN_BATCH, MAX_LEN + 1)
                               ).astype(np.int32)
            feeds.append(trainer_feed(seqs[:, :-1], seqs[:, 1:]))
        sfx = "" if policy == "fp32" else "_" + _policy_sfx(policy)
        return dispatch_check(f"LM {policy}", paddle,
                              lambda: _trainer(paddle, topo, values), feeds,
                              k, [n + sfx for n in TRAIN_KERNELS], LAYERS)
    finally:
        _policy("fp32")


def remat_check():
    """``remat=True`` on the LM at 8 x 4096 (fp32): the gradients against
    remat off, bit for bit, the peak memory of each, and kernel 1's
    launches (the backward recomputes the attention forward: 16 a step
    against 8)."""
    from paddle_tpu_torch import ops

    paddle, topo = _train_model()
    values = random_values(SEED)
    seqs = np.random.RandomState(SEED + 4).randint(
        0, VOCAB, size=(TRAIN_BATCH, MAX_LEN + 1)).astype(np.int32)
    feed = trainer_feed(seqs[:, :-1], seqs[:, 1:])
    tr = _trainer(paddle, topo, values)
    runs = {}
    for remat in (False, True):
        tr.remat = remat
        tr.forward_backward(feed)         # warm: builds, allocator
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss, grads = tr.forward_backward(feed)
        torch.cuda.synchronize()
        runs[remat] = (float(loss), grads,
                       (torch.cuda.max_memory_allocated() - base) / 1e9,
                       ops.launch_counts()["flash_fwd"])
        del grads
    (l0, g0, m0, n0), (l1, g1, m1, n1) = runs[False], runs[True]
    worst = max((g1[l][p] - g).abs().max().item()
                for l, ps in g0.items() for p, g in ps.items())
    same = l0 == l1 and all(torch.equal(g1[l][p], g)
                            for l, ps in g0.items() for p, g in ps.items())
    print(f"LM remat=True at {TRAIN_BATCH} x {MAX_LEN}: loss and every "
          f"gradient {'equal bit for bit' if same else 'DIFFERENT'} to remat "
          f"off (largest difference {worst:.3e}); peak memory above the "
          f"model {m0:.2f} GB off, {m1:.2f} GB on; flash_fwd launches a step "
          f"{n0} off, {n1} on; {card_line()}", flush=True)
    del tr, runs, g0, g1
    torch.cuda.empty_cache()
    if not same or n0 != LAYERS or n1 != 2 * LAYERS:
        raise AssertionError("remat: gradients differ or kernel 1 did not "
                             "launch 8 and 16 times")
    return {"bit_equal": same, "peak_gb_off": m0, "peak_gb_on": m1,
            "flash_fwd_off": n0, "flash_fwd_on": n1}


DISPATCH_PHASES = {
    "lstm_route": lambda: lstm_dispatch("fp32"),
    "lstm_route_bf16": lambda: lstm_dispatch("bf16"),
    "counter_growth": counter_growth_check,
    "nan_check": nan_check_phase,
    "nmt": nmt_dispatch,
    "lm": lambda: lm_dispatch("fp32"),
    "lm_bf16": lambda: lm_dispatch("bf16"),
    "remat": remat_check,
}


def dispatch_phases() -> dict:
    """The trainer's dispatch options at full width (see the module
    docstring, phase 14); each phase releases its graphs and empties the
    cache before the next."""
    out = {}
    for name, phase in DISPATCH_PHASES.items():
        out[name] = phase()
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- the v2 slice
# phase 15: the fused LM head at 65,536 tokens (bench.py's
# transformer_64k), the heads side by side, the v2 goldens on the card,
# the new optimizers in a captured chunk and dropout across replays
LM64K_LEN, LM64K_STEPS = 65536, 4
HEAD_ROWS, HEAD_CHUNK = TRAIN_BATCH * MAX_LEN, 8192
# the two heads at [8 x 4096, 512] x 32000: under fp32 both keep their
# float32 logits, so they differ by the products' summation order alone
# (the mean loss within 1e-6 relative, each gradient within 1e-4 of its
# max |ref|); under bf16 the unfused head rounds each logit to bf16 (2^-9
# of it, 2^-8 at worst) before the softmax and the fused one does not,
# and both round dx and dw to bf16 once.  Those roundings are zero-mean,
# so over 32,768 rows the mean loss moves by about 3e-7 relative (a
# logit's rounding, some 5e-4 here, over sqrt(32768) and ln 32000): the
# mean loss within 2e-6 relative, each gradient within 2^-5 of its max
# |ref|.  The fused head is also held against a float64 head on the same
# (rounded) operands: each row's nll within HEAD_ROW_TOL absolute (float32
# logits and a float32 logsumexp over 32000 stay at a few 1e-6; bf16
# logits move a row's nll by some 4e-3, which ``fused_head_check`` plants
# once and shows to fail), the mean loss within 1e-5 relative, db within
# 1e-4 of its max |ref|, dx and dw (bf16 under bf16) within 2^-7 of their
# max |ref|, 1e-4 under fp32.
HEAD_TOLS = {"fp32": (1e-6, 1e-4), "bf16": (2e-6, 2.0 ** -5)}
HEAD_F64_TOLS = {"fp32": 1e-4, "bf16": 2.0 ** -7}
HEAD_ROW_TOL = 1e-5
GOLDEN_BATCH = 4
V2_OPTIMIZERS = ("Adagrad", "DecayedAdagrad", "AdaDelta", "RMSProp",
                 "RMSProp momentum", "Adamax", "Ftrl")
SMALL_LM = dict(vocab_size=1000, max_len=512, dim=128, num_heads=1,
                num_layers=2)


def _peak_above(fn) -> tuple:
    """(fn's result, its peak device memory above what was allocated
    before it, GB)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 1e9


def _head_f64(x, w, b, labels, chunk=HEAD_CHUNK):
    """A float64 head over row chunks: (mean nll, the nll of each row, dx,
    dw, db) of softmax(x w + b) at ``labels``."""
    n = x.shape[0]
    wd, bd = w.double(), b.double()
    nll = torch.empty(n, dtype=torch.float64, device=x.device)
    dx = torch.empty(x.shape, dtype=torch.float64, device=x.device)
    dw = torch.zeros(w.shape, dtype=torch.float64, device=x.device)
    db = torch.zeros(b.shape, dtype=torch.float64, device=x.device)
    for r in range(0, n, chunk):
        xc = x[r:r + chunk].double()
        z = xc @ wd + bd
        lse = torch.logsumexp(z, -1)
        lab = labels[r:r + chunk]
        rows = torch.arange(z.shape[0], device=z.device)
        nll[r:r + chunk] = lse - z[rows, lab]
        p = torch.exp(z - lse[:, None])
        p[rows, lab] -= 1.0
        p /= n
        dx[r:r + chunk] = p @ wd.t()
        dw += xc.t() @ p
        db += p.sum(0)
        del z, p
    return float(nll.mean()), nll, dx, dw, db


def _rel_max(a, ref) -> float:
    """max |a - ref| / max |ref|."""
    return ((a.double() - ref.double()).abs().max()
            / ref.double().abs().max().clamp_min(1e-300)).item()


def _planted_bf16_logits(x, w, b, labels, ref_nll) -> float:
    """The largest |nll - ref| of the fused head's forward with its float32
    product replaced by a bf16 GEMM whose bf16 result is upcast (the
    function the module docstring rules out): the fault HEAD_ROW_TOL must
    catch."""
    from paddle_tpu_torch.ops import chunked_ce

    real = chunked_ce.mm_f32
    chunked_ce.mm_f32 = lambda a, b_: (a @ b_).float()
    try:
        with torch.no_grad():
            nll = chunked_ce.lm_head_nll(x, w, b, labels, HEAD_CHUNK)
    finally:
        chunked_ce.mm_f32 = real
    return (nll.double() - ref_nll).abs().max().item()


def fused_head_check(dev, gen):
    """The chunked-CE head (``ops/chunked_ce.py``) against the unfused
    head (fc + ``_SoftmaxNLL``) from the same weights at the LM's training
    shape [8 x 4096, 512] x 32000, under fp32 and bf16 (x and w cast, b
    not, as the layers cast them): the mean loss, dx, dw and db within
    HEAD_TOLS; the fused head also against a float64 head, each row's nll
    within HEAD_ROW_TOL (under bf16 the same forward on bf16-rounded
    logits is planted and must fail it) and the rest within
    HEAD_F64_TOLS; and each head's peak memory above its inputs (the
    unfused head keeps its [N, 32000] logits for the backward, the fused
    one its [N] LSE)."""
    from paddle_tpu_torch.layers.cost import _SoftmaxNLL
    from paddle_tpu_torch.ops.chunked_ce import lm_head_nll

    x0 = torch.randn(HEAD_ROWS, DIM, device=dev, generator=gen)
    w0 = torch.randn(DIM, VOCAB, device=dev, generator=gen) * 0.02
    b0 = torch.randn(VOCAB, device=dev, generator=gen) * 0.02
    labels = torch.randint(0, VOCAB, (HEAD_ROWS,), device=dev, generator=gen)
    out = {}
    for policy, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        def run(fused):
            # fresh leaves each run (x0.to(float32) would be x0 itself)
            x = x0.to(dt, copy=True).requires_grad_(True)
            w = w0.clone().requires_grad_(True)
            b = b0.clone().requires_grad_(True)
            wc = w.to(dt)
            if fused:
                nll = lm_head_nll(x, wc, b, labels, HEAD_CHUNK)
            else:
                logits = x @ wc + b.to(dt)
                nll = _SoftmaxNLL.apply(logits, labels)
                del logits
            loss = nll.mean()
            loss.backward()
            return (float(loss.detach()), x.grad, w.grad, b.grad,
                    nll.detach())

        t0 = time.perf_counter()
        fused, peak_f = _peak_above(lambda: run(True))
        fused_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain, peak_p = _peak_above(lambda: run(False))
        plain_s = time.perf_counter() - t0
        xd, wd = x0.to(dt), w0.to(dt)
        ref = _head_f64(xd, wd, b0, labels)
        lt, gt = HEAD_TOLS[policy]
        loss_rel = _rel(fused[0], plain[0])
        grads = {g: _rel_max(a, r) for g, a, r in zip(
            ("dx", "dw", "db"), fused[1:4], plain[1:4])}
        f64_loss = _rel(fused[0], ref[0])
        f64_row = (fused[4].double() - ref[1]).abs().max().item()
        f64 = {g: _rel_max(a, r) for g, a, r in zip(
            ("dx", "dw", "db"), fused[1:4], ref[2:])}
        f64_tol = HEAD_F64_TOLS[policy]
        planted = (_planted_bf16_logits(xd, wd, b0, labels, ref[1])
                   if dt == torch.bfloat16 else None)
        ok = (loss_rel <= lt and all(e <= gt for e in grads.values())
              and f64_row <= HEAD_ROW_TOL
              and f64_loss <= 1e-5 and f64["db"] <= 1e-4
              and f64["dx"] <= f64_tol and f64["dw"] <= f64_tol
              and fused[2].dtype == torch.float32
              and all(torch.isfinite(g).all() for g in fused[1:]))
        print(f"fused LM head {policy} at [{HEAD_ROWS}, {DIM}] x {VOCAB} "
              f"(chunk {HEAD_CHUNK}): loss {fused[0]:.6f} vs unfused "
              f"{plain[0]:.6f} ({loss_rel:.2e} relative, limit {lt:.2e}); "
              "gradients against the unfused head (of max |ref|) "
              + ", ".join(f"{g} {e:.2e}" for g, e in grads.items())
              + f" (limit {gt:.2e}); against a float64 head: row nll "
              f"{f64_row:.2e} absolute (limit {HEAD_ROW_TOL:.0e}"
              + ("" if planted is None else
                 f"; planted bf16 logits {planted:.2e}")
              + f"), loss {f64_loss:.2e}, " + ", ".join(
                  f"{g} {e:.2e}" for g, e in f64.items())
              + f"; peak memory above the inputs: fused {peak_f:.3f} GB, "
              f"unfused {peak_p:.3f} GB; forward + backward "
              f"{fused_s * 1e3:.1f} ms vs {plain_s * 1e3:.1f} ms (host "
              "clock, first call)",
              flush=True)
        if not ok:
            raise AssertionError(f"the fused LM head under {policy} "
                                 f"disagrees with the unfused head or with "
                                 f"the float64 head")
        if planted is not None and not planted > HEAD_ROW_TOL:
            raise AssertionError(f"bf16-rounded logits move no row's nll "
                                 f"past {HEAD_ROW_TOL} ({planted}): the "
                                 f"row check cannot see them")
        out[policy] = {"loss": fused[0], "unfused_loss": plain[0],
                       "loss_rel": loss_rel, "grad_rel": grads,
                       "f64_row_abs": f64_row, "planted_bf16_logits": planted,
                       "f64_loss_rel": f64_loss, "f64_grad_rel": f64,
                       "fused_peak_gb": peak_f, "unfused_peak_gb": peak_p,
                       "fused_ms": fused_s * 1e3, "unfused_ms": plain_s * 1e3}
        del fused, plain, ref
        torch.cuda.empty_cache()
    return out


def _f64_head(qd, kd, vd, gd, lse_in, delta_in, scale, chunk=2048):
    """One causal head in float64 over query chunks: O and the LSE of the
    attention (kernel 1's function), and dQ, dK and dV from the inputs
    kernels 2 and 3 are given (their function): the cotangent ``gd`` of
    O, the forward's LSE ``lse_in`` and delta ``delta_in`` = rowsum(dO *
    O), both as the kernel route computes them."""
    n = qd.shape[0]
    lse = torch.empty(n, dtype=torch.float64, device=qd.device)
    o, dq = torch.empty_like(qd), torch.empty_like(qd)
    dk, dv = torch.zeros_like(kd), torch.zeros_like(vd)
    for r in range(0, n, chunk):
        e = min(r + chunk, n)
        s = (qd[r:e] @ kd[:e].t()) * scale
        rows = torch.arange(r, e, device=qd.device)[:, None]
        s.masked_fill_(torch.arange(e, device=qd.device)[None, :] > rows,
                       -torch.inf)
        lse[r:e] = torch.logsumexp(s, -1)
        p = torch.exp(s - lse[r:e, None])
        o[r:e] = p @ vd[:e]
        torch.exp(s.sub_(lse_in[r:e, None]), out=p)
        del s
        dv[:e] += p.t() @ gd[r:e]
        ds = (gd[r:e] @ vd[:e].t()).sub_(delta_in[r:e, None]).mul_(p)
        dq[r:e] = scale * (ds @ kd[:e])
        dk[:e] += scale * (ds.t() @ qd[r:e])
        del p, ds
    return o, lse, dq, dk, dv


def flash_64k_check(dev, gen, flush):
    """Kernels 1, 2 and 3 (bf16 on the tensor cores) at [1, 65536, 4,
    128] causal, the 64k LM's shape: past 32,768 rows, where the JAX
    package windows its calls.  The plain attention cannot run here (its
    scores are 17 GB a head), so the kernels are held against float64
    evaluations of their own functions on the same bf16 operands,
    computed over query chunks (``_f64_head``), at every row, by the bf16
    limits the phases use at 4096: kernel 1's O rows within
    VAR_O_ROW_TOL, O within VAR_O_TOL and the LSE within VAR_LSE_TOL of
    max(1, max |ref|) (``_hold_bf16``); kernels 2 and 3 given the LSE and
    delta the route hands them (as ``_upcast_bwd`` is given them at
    4096), dQ, dK and dV each row within HALF_TOLS' bf16 ``bwd_row`` of
    its norm, or of the floor ``_row_errs`` sets from the median row; the
    largest errors on the rows past 32,768 reported apart; each kernel
    timed at this shape beside its bound and the library's bf16 call
    (``scaled_dot_product_attention`` forward, and its whole backward
    beside each backward kernel, on one of its O(T) backends)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from paddle_tpu_torch.ops import flash_attention as fa

    b, n, h, d = 1, LM64K_LEN, HEADS, DIM // HEADS
    q, k, v, go = (torch.randn(b, n, h, d, device=dev, generator=gen)
                   .bfloat16() for _ in range(4))
    lens = torch.full((b,), n, dtype=torch.int32, device=dev)
    kw = dict(causal=True, scale=d ** -0.5)
    o, lse = fa.flash_fwd_cuda(q, k, v, lens, **kw)
    delta = (go.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_bwd_dq_cuda(q, k, v, go, lse, delta, lens, **kw)
    dk, dv = fa.flash_bwd_dkdv_cuda(q, k, v, go, lse, delta, lens, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = [torch.empty(b, n, h, d, dtype=torch.float64, device=dev)
           for _ in range(4)]
    rlse = torch.empty(b, h, n, dtype=torch.float64, device=dev)
    for head in range(h):
        res = _f64_head(*(t[0, :, head].double() for t in (q, k, v, go)),
                        lse[0, head].double(), delta[0, head].double(),
                        kw["scale"])
        rlse[0, head] = res[1]
        for dst, src in zip(ref, (res[0],) + res[2:]):
            dst[0, :, head] = src
        del res
    ro, rdq, rdk, rdv = ref
    ref_s = time.perf_counter() - t0
    eo, er, el = _hold_bf16(f"flash_fwd bf16 at T {n}", o, lse, ro, rlse)
    errs = {"o_row": er, "o": eo, "lse": el,
            "o_row_past_32k": _o_row_err(o[:, 32768:], ro[:, 32768:])}
    tol = HALF_TOLS[torch.bfloat16]["bwd_row"]
    for g, a, r in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        rows = _row_errs(a, r, tol).reshape(b, n, h)
        errs[g] = rows.max().item()
        errs[g + "_past_32k"] = rows[:, 32768:].max().item()
        if not (errs[g] <= tol and torch.isfinite(a.float()).all()):
            worst = int(rows.amax(dim=(0, 2)).argmax())
            raise AssertionError(
                f"flash_bwd bf16 at T {n}: {g} row error {errs[g]} (at row "
                f"{worst}) > {tol} against a float64 backward")
    del ref, ro, rdq, rdk, rdv, rlse
    # causal pairs (each query with the keys at or before it), all heads
    pairs = n * (n + 1) / 2 * h
    times = {}
    for name, fn, flops, nbytes in (
            ("fwd", lambda: fa.flash_fwd_cuda(q, k, v, lens, **kw),
             4 * pairs * d, 4 * q.numel() * 2 + lse.numel() * 4),
            ("dq", lambda: fa.flash_bwd_dq_cuda(q, k, v, go, lse, delta,
                                                lens, **kw),
             6 * pairs * d, 5 * q.numel() * 2 + 2 * lse.numel() * 4),
            ("dkdv", lambda: fa.flash_bwd_dkdv_cuda(q, k, v, go, lse, delta,
                                                    lens, **kw),
             8 * pairs * d, 6 * q.numel() * 2 + 2 * lse.numel() * 4)):
        ms = time_ms(fn, flush, iters=5, warmup=1)
        bms, by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        times[name] = {"ms": ms, "bound_ms": bms, "bound_by": by}
    # the library yardstick on [B, H, T, D] views, never called by the port
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt = [t.transpose(1, 2) for t in (q, k, v)]
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION,
                      SDPBackend.CUDNN_ATTENTION]):
        with torch.no_grad():
            lib_fwd = time_ms(lambda: sdpa(*qt, is_causal=True,
                                           scale=kw["scale"]),
                              flush, iters=5, warmup=1)
        qt = [t.requires_grad_(True) for t in qt]
        so = sdpa(*qt, is_causal=True, scale=kw["scale"])
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            so, qt, go.transpose(1, 2), retain_graph=True), flush,
            iters=5, warmup=1)
        del so, qt
    for name in times:
        times[name]["library_ms"] = lib_fwd if name == "fwd" else lib_bwd
    print(f"flash kernels 1-3 bf16 at [1, {n}, {h}, {d}] causal against "
          f"float64 evaluations of their functions (every row; "
          f"{ref_s:.1f} s): O "
          f"row {er:.3e} (past row 32768 {errs['o_row_past_32k']:.3e}; "
          f"limit {VAR_O_ROW_TOL:.3e}), O {eo:.3e}, LSE {el:.3e}; row errors"
          f" dQ {errs['dq']:.3e} ({errs['dq_past_32k']:.3e}), dK "
          f"{errs['dk']:.3e} ({errs['dk_past_32k']:.3e}), dV "
          f"{errs['dv']:.3e} ({errs['dv_past_32k']:.3e}) (limit {tol:.3e});"
          f" times " + ", ".join(
              f"{k_} {t['ms']:.3f} ms (bound {t['bound_ms']:.3f})"
              for k_, t in times.items())
          + f"; scaled_dot_product_attention bf16 forward {lib_fwd:.3f} ms,"
          f" backward {lib_bwd:.3f} ms; {card_line()}", flush=True)
    del q, k, v, go, o, lse, delta, dq, dk, dv
    torch.cuda.empty_cache()
    return {"errs": errs, "times": times}


def lm64k_path():
    """bench.py's transformer_64k on the card: ``transformer.build(vocab
    32000, max_len 65536, dim 512, 4 heads, 8 layers, fused_head=True)``
    at batch 1 under ``bf16``, Adam 1e-4, seeded weights, tokens and
    targets from ``np.random.RandomState(0)`` as bench.py draws them;
    LM64K_STEPS steps of ``trainer.SGD.train``, the counts set to 0 just
    before and read just after: every loss finite, the first near ln
    32000, kernels 1, 2 and 3 at bf16 LAYERS launches each a step.
    Smoke figures: step times, tokens/s, peak memory; then
    ``torch.profiler`` over one more step: the device's busy and idle
    share and the device time of kernels 1, 2 and 3 in it."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import transformer

    _fresh(paddle)
    _policy("bf16")
    try:
        cost, _ = transformer.build(vocab_size=VOCAB, max_len=LM64K_LEN,
                                    dim=DIM, num_heads=HEADS,
                                    num_layers=LAYERS, ffn_mult=FFN_MULT,
                                    fused_head=True)
        topo = paddle.Topology(cost)
        values = random_values(SEED)
        values["pos_emb"]["w"] = np.random.default_rng(
            SEED + 5).standard_normal((LM64K_LEN, DIM), dtype=np.float32) \
            * 0.02
        rng = np.random.RandomState(0)
        feed = {"tokens": rng.randint(2, VOCAB, (1, LM64K_LEN)).astype(
                    np.int32),
                "targets": rng.randint(2, VOCAB, (1, LM64K_LEN)).astype(
                    np.int32)}
        trainer = paddle.trainer.SGD(
            topo, paddle.parameters.from_numpy(topo, values),
            paddle.optimizer.Adam(learning_rate=1e-4))
        losses, step_s, warm, peak_gb, launches = train_steps(
            "LM 64k bf16", paddle, trainer, feed, LM64K_STEPS,
            "flash_fwd_bf16", LAYERS, falling=False)
        prof = profile_step(trainer, feed, "flash_")
    finally:
        _policy("fp32")
    names = [n + "_bf16" for n in TRAIN_KERNELS]
    if any(launches[n] != LAYERS * LM64K_STEPS for n in names):
        raise AssertionError(f"LM 64k: the bf16 attention kernels did not "
                             f"run {LAYERS} times a step: {launches}")
    if not abs(losses[0] - np.log(VOCAB)) < 0.5:
        raise AssertionError(f"LM 64k: first loss {losses[0]} is not near "
                             f"ln {VOCAB} = {np.log(VOCAB):.4f}")
    attn = {k: sum(ms for name, (ms, _) in prof["per_name"].items()
                   if f"flash_{k}_mma" in name)
            for k in ("fwd", "bwd_dkdv", "bwd_dq")}
    busy = ("not measured (torch.profiler saw no device time)"
            if prof["idle_share"] is None else
            f"device busy {prof['busy_ms']:.1f} of {prof['step_ms']:.1f} "
            f"ms (idle share {prof['idle_share']:.1%}), kernels 1-3 "
            f"{prof['matched_ms']:.1f} ms = "
            f"{prof['matched_ms'] / prof['step_ms']:.1%} of the step ("
            + ", ".join(f"{k} {ms:.1f}" for k, ms in attn.items()) + ")")
    print(f"LM 64k path: transformer_64k (fused head, bf16, batch 1 x "
          f"{LM64K_LEN}) {LM64K_STEPS} Adam steps, losses "
          f"{[round(x, 5) for x in losses]} (ln {VOCAB} = "
          f"{np.log(VOCAB):.5f}); first step {step_s[0] * 1e3:.1f} ms, "
          f"median after it {warm * 1e3:.1f} ms = {LM64K_LEN / warm:.0f} "
          f"tokens/s (smoke figure, not a benchmark); peak memory "
          f"{peak_gb:.2f} GB; launches "
          f"{ {n: launches[n] for n in names} }; one profiled step: {busy};"
          f" {card_line()}", flush=True)
    del trainer
    torch.cuda.empty_cache()
    return {"losses": losses, "first_step_ms": step_s[0] * 1e3,
            "step_ms": warm * 1e3, "tokens_per_s": LM64K_LEN / warm,
            "peak_gb": peak_gb, "launches": {n: launches[n] for n in names},
            "profiled_step_ms": prof["step_ms"], "busy_ms": prof["busy_ms"],
            "idle_share": prof["idle_share"],
            "attention_ms": prof["matched_ms"], "attention_parts_ms": attn}


class _Draws:
    """The integers NCE draws on the card (``torch.randint``), recorded
    and replayed for the same config on the CPU, whose generator draws
    other numbers."""

    def __init__(self):
        self.vals = []

    @contextlib.contextmanager
    def _patched(self, fn):
        real = torch.randint
        torch.randint = fn
        try:
            yield
        finally:
            torch.randint = real

    def recording(self):
        real = torch.randint

        def rec(*a, **kw):
            out = real(*a, **kw)
            self.vals.append(out)
            return out
        return self._patched(rec)

    def replaying(self):
        it = iter(self.vals)
        return self._patched(lambda *a, device=None, **kw:
                             next(it).to(device))


def _layer_configs():
    """``tests/torch_layer_configs.py``, the golden configs of the v2
    layers that the CPU tests hold against the JAX package; each is
    written for the package (and LM builder) it is given and imports
    neither."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_layer_configs.py")
    spec = importlib.util.spec_from_file_location("torch_layer_configs",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _golden_run(paddle, configs, name, values, device, gen):
    """One golden config's forward (train mode) and the gradients of the
    sum of its scalar outputs on ``device``, of every parameter and float
    feed."""
    from paddle_tpu_torch.models import transformer

    _fresh(paddle)
    outs = configs.CONFIGS[name](paddle, transformer)
    topo = paddle.Topology(outs if isinstance(outs, list) else [outs])
    if values is None:
        values = seeded_values(topo, SEED + 7)
    feed = configs.feed(topo, batch=GOLDEN_BATCH, seed=SEED, padded=True,
                        name=name)
    params = paddle.parameters.from_numpy(topo, values, device=device).values
    wrt = {}
    for l, ps in params.items():
        for p, t in ps.items():
            wrt[f"{l}.{p}"] = t.requires_grad_(True)
    tfeed = {}
    for k, a in feed.items():
        t = torch.as_tensor(a, device=device)
        if t.dtype == torch.float32 and not k.endswith("@len"):
            wrt[f"feed {k}"] = t.requires_grad_(True)
        tfeed[k] = t
    vals, _ = topo.forward(params, {}, tfeed, train=True, generator=gen,
                           device=device)
    scalars = [v for v in vals.values() if v.ndim == 0]
    total = sum(scalars[1:], scalars[0])
    grads = (torch.autograd.grad(total, list(wrt.values()),
                                 allow_unused=True)
             if total.requires_grad else [None] * len(wrt))
    return values, vals, dict(zip(wrt, grads))


def goldens_on_card():
    """Each golden config of ``tests/torch_layer_configs.py`` (the v2
    layers, costs and sequence layers, the fused-head LM) forward and
    backward on the card against the same config on the CPU from the same
    seeded weights and padded feed: every output and the gradient of every
    parameter and float feed within TOL of max(1, max |cpu|) (float32
    both; NCE on the card's negatives)."""
    import paddle_tpu_torch as paddle

    configs = _layer_configs()
    out = {}
    for name in configs.CONFIGS:
        if name in configs.PROTO_ONLY:
            continue
        draws = _Draws()
        with draws.recording():
            values, cvals, cgrads = _golden_run(
                paddle, configs, name, None, "cuda",
                torch.Generator(device="cuda").manual_seed(SEED))
        with draws.replaying():
            _, rvals, rgrads = _golden_run(
                paddle, configs, name, values, "cpu",
                torch.Generator().manual_seed(SEED))
        worst = (0.0, "")
        pairs = [(f"out {k}", cvals[k], rvals[k]) for k in rvals]
        pairs += [(f"d {k}", cgrads[k], g) for k, g in rgrads.items()
                  if g is not None]
        for what, a, r in pairs:
            if a is None:
                raise AssertionError(f"golden {name}: {what} missing on the "
                                     f"card")
            a, r = a.detach().cpu().double(), r.detach().double()
            e = ((a - r).abs().max().item() / max(1.0, r.abs().max().item())
                 if r.numel() else 0.0)
            worst = max(worst, (e, what))
        if not worst[0] <= TOL:
            raise AssertionError(f"golden {name} on the card vs the CPU: "
                                 f"{worst[1]} off by {worst[0]} of max(1, "
                                 f"max |ref|) > {TOL}")
        out[name] = {"worst": worst[0], "at": worst[1],
                     "checked": len(pairs)}
    print(f"v2 goldens on the card vs the CPU ({len(out)} configs, forward "
          f"and every gradient, padded feeds): worst "
          f"{max(v['worst'] for v in out.values()):.2e} of max(1, max |ref|)"
          f" (limit {TOL}); " + ", ".join(
              f"{k} {v['worst']:.1e}" for k, v in out.items()), flush=True)
    return out


def _small_lm(paddle):
    from paddle_tpu_torch.models import transformer
    _fresh(paddle)
    cost, _ = transformer.build(**SMALL_LM)
    return paddle.Topology(cost)


def _v2_optimizer(opt, name):
    """A new rule with the base options on: l2 decay, the global clip, a
    learning-rate schedule and a model average."""
    base = dict(learning_rate=1e-3,
                regularization=opt.L2Regularization(1e-4),
                gradient_clipping_threshold=1.0,
                learning_rate_schedule="poly", learning_rate_decay_a=0.1,
                learning_rate_decay_b=0.5,
                model_average=opt.ModelAverage(0.5))
    if name == "RMSProp momentum":
        return opt.RMSProp(momentum=0.9, **base)
    return getattr(opt, name)(**base)


def optimizer_dispatch():
    """Each new optimizer (V2_OPTIMIZERS, with l2, the clip, a schedule
    and a model average) trains a small LM (vocab 1000, T 512, one head
    of 128, 2 layers; batch 4) at ``steps_per_dispatch=2``: one CUDA graph
    of two steps against two eager steps from the same state, losses and
    every state tensor (the slots, the step counter, the average) bit for
    bit, kernels 1, 2 and 3 executing 2 a step (``dispatch_check``)."""
    import paddle_tpu_torch as paddle

    topo = _small_lm(paddle)
    values = seeded_values(topo, SEED + 4)
    rng = np.random.RandomState(SEED + 9)
    feeds = []
    for _ in range(2):
        seqs = rng.randint(0, SMALL_LM["vocab_size"],
                           size=(4, SMALL_LM["max_len"] + 1)).astype(np.int32)
        feeds.append(trainer_feed(seqs[:, :-1], seqs[:, 1:]))
    out = {}
    for name in V2_OPTIMIZERS:
        out[name] = dispatch_check(
            f"small LM {name}", paddle,
            lambda: paddle.trainer.SGD(
                topo, paddle.parameters.from_numpy(topo, values),
                _v2_optimizer(paddle.optimizer, name)),
            feeds, 2, list(TRAIN_KERNELS), SMALL_LM["num_layers"])
    return out


def dropout_replays():
    """A captured chunk draws new random numbers at each replay: an MLP
    with two dropouts and an NCE cost (1000 classes, 64 shared negatives)
    at learning rate 0, so only the draws move the loss, trained at
    ``steps_per_dispatch=2`` over one batch twice: the four losses of two
    replays all differ, one capture.  Then the same step captured with a
    generator the graph does not know raises inside the capture rather
    than run."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import prepared

    _fresh(paddle)
    layer = paddle.layer
    x = layer.data("x", paddle.data_type.dense_vector(256))
    y = layer.data("y", paddle.data_type.integer_value(1000))
    h = layer.dropout(layer.fc(x, size=512, act="relu", name="h1"),
                      rate=0.5, name="drop1")
    h = layer.fc(h, size=256, act="tanh", name="h2",
                 layer_attr=paddle.attr.ExtraAttr(drop_rate=0.3))
    topo = paddle.Topology(layer.nce_cost(h, y, num_classes=1000,
                                          num_neg_samples=64, name="nce"))
    trainer = paddle.trainer.SGD(
        topo, paddle.parameters.from_numpy(topo, seeded_values(topo, SEED)),
        paddle.optimizer.Momentum(learning_rate=0.0))
    rng = np.random.RandomState(SEED)
    feed = {"x": rng.randn(64, 256).astype(np.float32),
            "y": rng.randint(0, 1000, 64).astype(np.int32)}
    losses = _losses(paddle, trainer, lambda: iter([feed] * 4),
                     steps_per_dispatch=2)
    if (len(set(losses)) != 4 or trainer.step_capture_count != 1
            or not all(np.isfinite(losses))):
        raise AssertionError(f"dropout in a captured chunk: losses "
                             f"{losses} over two replays of one batch at "
                             f"lr 0 (all must differ), captures "
                             f"{trainer.step_capture_count}")
    stacked = trainer._stack_group([feed, feed])
    try:
        prepared.chunk_entry(trainer._step, 2, stacked,
                             trainer._state_tensors(), trainer.device)
        refused = None
    except RuntimeError as e:
        refused = str(e).splitlines()[0]
    torch.cuda.synchronize()
    if refused is None or "capture" not in refused:
        raise AssertionError("a capture whose generator is not registered "
                             "ran instead of raising")
    print(f"dropout + NCE in a captured 2-step chunk at lr 0: losses of two "
          f"replays of one batch {[round(v, 6) for v in losses]} (all "
          f"differ: new masks and negatives each replay), 1 capture; "
          f"without the generator registered the capture raises: "
          f"{refused[:120]}", flush=True)
    trainer.release_chunks()
    return {"losses": losses, "unregistered": refused}


V2_PHASES = {
    "fused_head": lambda dev, gen, flush: fused_head_check(dev, gen),
    "flash_64k": flash_64k_check,
    "lm_64k": lambda dev, gen, flush: lm64k_path(),
    "goldens": lambda dev, gen, flush: goldens_on_card(),
    "optimizers": lambda dev, gen, flush: optimizer_dispatch(),
    "dropout": lambda dev, gen, flush: dropout_replays(),
}


def v2_slice(dev, gen, flush):
    """Phase 15: the fused head, the 64k kernels and LM, the goldens on
    the card, the new optimizers' chunks and the replays' draws; each
    releases its memory before the next."""
    out = {}
    for name, phase in V2_PHASES.items():
        out[name] = phase(dev, gen, flush)
        torch.cuda.empty_cache()
    return out


def selected(argv) -> list:
    """The phases ``--only=<name>[,<name>...]`` names (None without it):
    ``dispatch`` or ``v2`` for phase 14 or 15 whole, or any part of
    either (DISPATCH_PHASES, V2_PHASES), for a development run; the full
    run takes no arguments."""
    only = [a.split("=", 1)[1] for a in argv if a.startswith("--only=")]
    if not only:
        return None
    groups = {"dispatch": list(DISPATCH_PHASES), "v2": list(V2_PHASES)}
    names = [n for a in only for g in a.split(",")
             for n in groups.get(g, [g])]
    unknown = [n for n in names
               if n not in DISPATCH_PHASES and n not in V2_PHASES]
    if unknown:
        raise SystemExit(f"chip_smoke: no phase {unknown}; --only= takes "
                         f"{sorted(groups) + sorted(DISPATCH_PHASES)}"
                         f" + {sorted(V2_PHASES)}")
    return names


def main(argv=()) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    only = selected(argv)
    from paddle_tpu_torch.ops import _build
    # the plain versions are the reference: full float32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)

    t0 = time.perf_counter()
    # beside the port's own builds; a development run compares no parents
    parents = start_parent_builds() if only is None else None
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
    if only is not None:
        out = {}
        for name in only:
            phase = V2_PHASES.get(name)
            out[name] = (DISPATCH_PHASES[name]() if phase is None
                         else phase(dev, gen, flush))
            torch.cuda.empty_cache()
        print(json.dumps({"only": out}), flush=True)
        return 0
    flash_err, flash_t = flash_phase(dev, gen, flush, parents)
    paged_err, paged_t = paged_phase(dev, gen, flush)
    bwd = flash_bwd_phase(dev, gen, flush, parents)
    bwd16 = flash_bwd_bf16_phase(dev, gen, flush)
    bwd_f16 = flash_bwd_bf16_phase(dev, gen, flush, torch.float16)
    rnn = rnn_phase(dev, gen, flush, parents)
    rnn16 = rnn_bf16_phase(dev, gen, flush)
    rnn_f16 = rnn_bf16_phase(dev, gen, flush, torch.float16)
    conv = conv_phase(dev, gen, flush, parents=parents)
    conv16 = conv_phase(dev, gen, flush, torch.bfloat16)
    conv_f16 = conv_phase(dev, gen, flush, torch.float16)
    var = variants_phase(dev, gen, flush)
    del flush
    torch.cuda.empty_cache()

    launches, _, iters = main_path()
    share = LAYERS * paged_t["ms"] / iters["kernels"]["decode_ms"]
    print(f"paged_decode calls (one launch each, timed above) cover about "
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
    # the fp16 policy slice: the LM on kernels 1, 2 and 3 at float16
    lm_f16 = lm_bf16_path(bwd_f16["fwd_ms"] + bwd_f16["dkdv"]["ms"]
                          + bwd_f16["dq"]["ms"], train, ("fp16",))["fp16"]
    torch.cuda.empty_cache()
    rnn16_paths = rnn_bf16_paths()
    torch.cuda.empty_cache()
    rnn_f16_paths = rnn_bf16_paths("fp16")
    torch.cuda.empty_cache()
    mixed = mixed_skip_phase(dev)
    torch.cuda.empty_cache()
    dispatch = dispatch_phases()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    v2 = v2_slice(dev, gen, flush)
    del flush
    torch.cuda.empty_cache()
    sass = sass_phase()
    resnet = resnet_path()
    torch.cuda.empty_cache()
    resnet16 = resnet_bf16_path()
    torch.cuda.empty_cache()
    resnet_f16 = resnet_bf16_path("fp16")
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
         "launches_replay": dispatch["lm"]["replay_launches"],
         "launches_remat": dispatch["remat"]["flash_fwd_on"],
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
         "ms": paged_t["ms"], "host_ms": paged_t["host_ms"],
         "plain_ms": paged_t["plain_ms"],
         "bound_ms": paged_t["bound_ms"], "bound_by": paged_t["bound_by"],
         "library_ms": None, "registers": paged_t["registers"],
         "local_bytes": paged_t["local_bytes"],
         "shape": {"S": SLOTS, "H": HEADS, "D": DIM // HEADS, "BS": BLOCK,
                   "MB": MAX_LEN // BLOCK, "NB": 1 + SLOTS * MAX_LEN // BLOCK,
                   "pos": paged_t["pos"], "kv_splits": paged_t["kv_splits"]}},
        {"name": "lstm_step", "route": "cuda",
         "source": "paddle_tpu_torch/ops/csrc/rnn_step.cu",
         "replaces": "paddle_tpu/ops/fused_rnn.py:44",
         "launches": lstm["launches"]["lstm_step"],
         "launches_replay": dispatch["lstm_route"]["replay_launches"],
         **rnn["lstm"]},
        {"name": "gru_step", "route": "cuda",
         "source": "paddle_tpu_torch/ops/csrc/rnn_step.cu",
         "replaces": "paddle_tpu/ops/fused_rnn.py:144",
         "launches": nmt["launches"]["gru_step"],
         "launches_replay": dispatch["nmt"]["replay_launches"],
         **rnn["gru"]},
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
             launches_replay=dispatch["lm_bf16"]["replay_launches"],
             launches_mixed=lm16["mixed"]["launches"]["flash_fwd_bf16"],
             launches_sweep=sweep_launches["flash_fwd"],
             launches_64k=v2["lm_64k"]["launches"]["flash_fwd_bf16"],
             at_64k=dict(v2["flash_64k"]["times"]["fwd"],
                         o_row_err=v2["flash_64k"]["errs"]["o_row"],
                         lse_err=v2["flash_64k"]["errs"]["lse"]),
             lm_shape=var["kernel1_bf16"]["lm"]),
        {"name": "flash_bwd_dkdv_bf16", "route": "cuda",
         "source": "paddle_tpu_torch/ops/csrc/flash_bwd.cu",
         "replaces": "paddle_tpu/ops/flash_attention.py:285",
         "launches": lm16["bf16"]["launches"]["flash_bwd_dkdv_bf16"],
         "launches_mixed": lm16["mixed"]["launches"]["flash_bwd_dkdv_bf16"],
         "launches_64k": v2["lm_64k"]["launches"]["flash_bwd_dkdv_bf16"],
         "at_64k": dict(v2["flash_64k"]["times"]["dkdv"],
                        dk_row_err=v2["flash_64k"]["errs"]["dk"],
                        dv_row_err=v2["flash_64k"]["errs"]["dv"]),
         **{k: v for k, v in bwd16["dkdv"].items()},
         "shape": bwd16["shape"]},
        {"name": "flash_bwd_dq_bf16", "route": "cuda",
         "source": "paddle_tpu_torch/ops/csrc/flash_bwd.cu",
         "replaces": "paddle_tpu/ops/flash_attention.py:370",
         "launches": lm16["bf16"]["launches"]["flash_bwd_dq_bf16"],
         "launches_mixed": lm16["mixed"]["launches"]["flash_bwd_dq_bf16"],
         "launches_64k": v2["lm_64k"]["launches"]["flash_bwd_dq_bf16"],
         "at_64k": dict(v2["flash_64k"]["times"]["dq"],
                        dq_row_err=v2["flash_64k"]["errs"]["dq"]),
         **{k: v for k, v in bwd16["dq"].items()},
         "shape": bwd16["shape"]},
        dict(rnn16["lstm"]["x bfloat16, mask float32"], name="lstm_step_bf16",
             route="cuda", source="paddle_tpu_torch/ops/csrc/rnn_step.cu",
             replaces="paddle_tpu/ops/fused_rnn.py:44",
             launches=rnn16_paths["lstm_route"]["launches"]["lstm_step_bf16"],
             launches_replay=dispatch["lstm_route_bf16"]["replay_launches"],
             instances=rnn16["lstm"]),
        dict(rnn16["gru"]["x bfloat16, mask float32"], name="gru_step_bf16",
             route="cuda", source="paddle_tpu_torch/ops/csrc/rnn_step.cu",
             replaces="paddle_tpu/ops/fused_rnn.py:144",
             launches=rnn16_paths["nmt"]["launches"]["gru_step_bf16"],
             instances=rnn16["gru"]),
        *(dict(conv16[k], name=f"{k}_bf16", route="cuda",
               source=f"paddle_tpu_torch/ops/csrc/{src}", replaces=site,
               launches=resnet16["fused"]["launches"][f"{k}_bf16"])
          for k, src, site in (
              ("bn_fwd_stats", "bn_stats.cu", "paddle_tpu/ops/fused_bn.py:58"),
              ("bn_bwd_stats", "bn_stats.cu",
               "paddle_tpu/ops/fused_bn.py:145"),
              ("matmul_stats", "conv_bn.cu", "paddle_tpu/ops/conv_bn.py:46"),
              ("conv3x3_stats", "conv_bn.cu",
               "paddle_tpu/ops/conv_bn.py:180"))),
        *(dict(bwd_f16[k], name=f"{name}_f16", route="cuda",
               source=f"paddle_tpu_torch/ops/csrc/{src}", replaces=site,
               launches=lm_f16["launches"][f"{name}_f16"],
               shape=bwd_f16["shape"])
          for k, name, src, site in (
              ("fwd", "flash_fwd", "flash_fwd.cu",
               "paddle_tpu/ops/flash_attention.py:90"),
              ("dkdv", "flash_bwd_dkdv", "flash_bwd.cu",
               "paddle_tpu/ops/flash_attention.py:285"),
              ("dq", "flash_bwd_dq", "flash_bwd.cu",
               "paddle_tpu/ops/flash_attention.py:370"))),
        *(dict(rnn_f16[kind]["x float16, mask float32"], name=f"{name}_f16",
               route="cuda", source="paddle_tpu_torch/ops/csrc/rnn_step.cu",
               replaces=site, launches=rnn_f16_paths[path]["launches"][
                   f"{name}_f16"], instances=rnn_f16[kind])
          for kind, name, path, site in (
              ("lstm", "lstm_step", "lstm_route",
               "paddle_tpu/ops/fused_rnn.py:44"),
              ("gru", "gru_step", "nmt",
               "paddle_tpu/ops/fused_rnn.py:144"))),
        *(dict(conv_f16[k], name=f"{k}_f16", route="cuda",
               source=f"paddle_tpu_torch/ops/csrc/{src}", replaces=site,
               launches=resnet_f16["fused"]["launches"][f"{k}_f16"])
          for k, src, site in (
              ("bn_fwd_stats", "bn_stats.cu", "paddle_tpu/ops/fused_bn.py:58"),
              ("bn_bwd_stats", "bn_stats.cu",
               "paddle_tpu/ops/fused_bn.py:145"),
              ("matmul_stats", "conv_bn.cu", "paddle_tpu/ops/conv_bn.py:46"),
              ("conv3x3_stats", "conv_bn.cu",
               "paddle_tpu/ops/conv_bn.py:180"))),
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
    print(json.dumps({"serving": {"iterations": iters}}), flush=True)
    print(json.dumps({"fp32_bwd": {
        k: bwd[k] for k in ("tf32", "resources", "parent_simt", "sdpa")}}),
          flush=True)
    print(json.dumps({"training": {
        k: train[k] for k in ("losses", "first_step_ms", "step_ms",
                              "peak_gb", "parity", "breakdown")}}),
          flush=True)
    print(json.dumps({"nmt": {
        k: nmt[k] for k in ("losses", "first_step_ms", "step_ms",
                            "tokens_per_s", "peak_gb", "parity",
                            "breakdown")},
        "lstm_route": {k: lstm[k] for k in ("losses", "first_step_ms",
                                            "step_ms", "peak_gb", "parity",
                                            "idle_share", "kernel_ms",
                                            "busy_ms", "profiled_step_ms")}}),
          flush=True)
    print(json.dumps({"bf16": {
        "lm": {p: {k: v for k, v in r.items() if k != "launches"}
               for p, r in lm16.items()},
        "nmt": {k: v for k, v in rnn16_paths["nmt"].items()
                if k != "launches"},
        "lstm_route": {k: v for k, v in rnn16_paths["lstm_route"].items()
                       if k != "launches"},
        "flash_bwd": {k: bwd16[k] for k in ("planted_fault",
                                            "distance_to_plain", "cases",
                                            "resources")},
        "mixed_skip": mixed, "sass": sass}}), flush=True)
    print(json.dumps({"fp16": {
        "lm": {k: v for k, v in lm_f16.items() if k != "launches"},
        "nmt": {k: v for k, v in rnn_f16_paths["nmt"].items()
                if k != "launches"},
        "lstm_route": {k: v for k, v in rnn_f16_paths["lstm_route"].items()
                       if k != "launches"},
        "resnet": {"layer_parity": resnet_f16["layer_parity"],
                   **{k: v for k, v in resnet_f16["fused"].items()
                      if k != "launches"}},
        "flash": {k: bwd_f16[k] for k in ("planted_fault",
                                          "distance_to_plain", "cases",
                                          "resources")}}}), flush=True)
    print(json.dumps({"dispatch": dispatch}), flush=True)
    print(json.dumps({"v2": v2}), flush=True)
    print(json.dumps({"sweep": {"rows": sweep_rows,
                                "variants": var["variants"],
                                "sdpa_bf16_ms": var["sdpa_bf16_ms"],
                                "planted_fault": var["planted_fault"]}}),
          flush=True)
    print(json.dumps({"resnet": {
        k: resnet[k] for k in ("losses", "first_step_ms", "step_ms",
                               "images_per_s", "peak_gb", "parity",
                               "breakdown", "eval_cost")}}), flush=True)
    print(json.dumps({"resnet_bf16": {
        "layer_parity": resnet16["layer_parity"],
        **{path: {k: v for k, v in resnet16[path].items() if k != "launches"}
           for path in ("fused", "bench")}}}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
