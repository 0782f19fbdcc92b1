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
16. the sparse slice (``sparse_slice``): the wide-and-deep CTR model
   (``models/ctr.py``) at (10 M, 10 M, 1 M) x 16 with every table
   ``sparse_update``, batch 4096 of Zipf ids, Adam 1e-3, 8 steps, AUC
   declared (``ctr_path``): 2 SGD steps against the dense twin's (touched
   rows within 1e-6, every other row bit for bit its start); the touched
   rows and moments of an eager Adam run against a float64 replay of lazy
   Adam (1e-6 x max(1, max |ref|)), the other rows and slots bit for bit
   their start; a second eager run bit for bit the first; 2 replays of a
   4-step graph bit for bit the eager run, the AUC equal; the eager
   step's peak memory above the parameters and slots under a quarter of a
   640 MB table; the step times, the idle share, and the dense twin's
   step time, peak and AUC beside them; then the README quickstart on
   the card against the CPU (costs within 1e-4, ``infer`` within 1e-5);
17. the checkpoint slice (``ckpt_slice``): the LM at full width under
   ``bf16`` (Adam TRAIN_LR, TRAIN_BATCH x MAX_LEN) takes 6 seeded batches
   with an async step snapshot every 2 (run A); a trainer of other
   weights resumes A's step 4 and takes steps 5 and 6 (run B): losses,
   parameters, moments, ``t`` and the global step bit for bit A's, kernels
   1 to 3 launched 8 times a resumed step; the same at
   ``steps_per_dispatch=2`` into a chunk captured and replayed before the
   restore; the dropout + NCE MLP in a 2-step chunk resumed between
   replays, its generator too; A's pass snapshot served over HTTP (8
   requests, streams equal to a ``PagedDecoder`` of A's live parameters)
   and, under ``fp32``, ``greedy_generate`` (kernel 1 LAYERS x 16 times)
   and ``incremental_generate`` for 8 prompts x 16 tokens with equal
   streams, ``beam_generate`` (K 4) to its end; the hand-off's host time,
   the steps that save and those during the write beside the same steps
   of a run without checkpoints (run C, whose losses must be A's), the
   background write's seconds and bytes, and the restore's time apart
   from the pinned buffers' warm-up, beside the card line (smoke
   figures);
18. the serving slice (``serve_slice``): the same LM at full width, served
   on ``device="cuda"``: (a) ``PagedDecoder(sampling=True)`` answers 8
   greedy requests (no knobs, or temperature 0) with streams equal bit for
   bit to ``reference_streams`` of the ``sampling=False`` decoder; (b) 8
   seeded requests (temperature 0.8, top_k 50, top_p 0.95) give one stream
   alone and beside 8 greedy requests, another seed another stream, and
   ``top_k=1`` rows the greedy stream; (c) ``InferenceEngine(SlotDecoder)``
   under ``continuous`` and ``static`` gives the reference's streams
   (a divergence only at a near tie, reported), with TTFT p50 / p99 and
   tokens/s; (d) 64 requests of tenant ``a`` and 16 of ``b`` at once
   through ``ServingClient`` with retries off against ``max_queue_depth``
   16, weights a 3 b 1 and a per-tenant quota of 0.5: every answered
   stream its reference's, the client's 429s by reason the engine's
   sheds, every slot free and the pool at its baseline after, each
   tenant's answered share and TTFT; (e) a 4000-token request with a 50 ms
   deadline answers 504 and gives its slot and blocks back; (f) 32 calls
   with retries on all answer within their deadlines; (g) the sampling
   pick's time at vocab 32000 x 8 rows beside the argmax, and kernels 1
   and 4's launches over the phase;
19. the whole-forward serving slice (``serve_fwd_slice``): the same LM's
   ``logits`` served from a DSL config and a snapshot as ``serve --model
   cfg.py --params DIR`` serves them (max_batch 8, row buckets 1, 2, 4,
   8, T buckets 128, 512, 2048): (1) 32 requests of 5 to 2000 tokens at
   once, each answer's logits against the plain path
   (``attention_impl="torch"``) alone at its own length, every row
   (position) within kernel 1's 3xTF32 row limits (TF32_ROW_TOL, 99%
   within TF32_ROW_Q99_TOL), ``GET /kernels`` counting kernel 1 at 8 a
   micro-batch, the buckets on the grid; kernel 1 at a micro-batch's
   shape (ragged kv_lens) against its plain version, timed beside it,
   SDPA with the same mask and its bound; one micro-batch under
   ``torch.profiler``; 8 requests over HTTP to the ``serve`` subprocess,
   bit for bit the in-process answers; (2) a second, perturbed snapshot
   in the watched dir: a request in flight at the swap answers on the old
   weights bit for bit, the next on the new, a ``"prev"`` pin on the old;
   a 0.25 canary over 64 requests splits 16 to 48; promote and a signed
   ``POST /reload?rollback=1`` (unsigned: 403); (3) a ``PagedDecoder``
   engine swapping while 4 streams are resident: they finish on the old
   weights' reference streams, the 4 after on the new; (4) ``serve
   --fleet 2`` with 32 calls through ``ServingClient``, a replica
   SIGKILLed mid-run, every call answered, the router showing it out of
   rotation and the survivor deregistering on drain;
20. NMT generation (``gen_slice``): ``seq2seq.build(is_generating=True)``
   at ``bench_nmt``'s widths (vocab 30000, 512 wide, beam 3, src = trg =
   50) with the NMT path's weights after its Adam steps, 64 seeded
   sources of 1 to 50 tokens (192 beam rows): the kernel route against
   ``use_fused_rnn=False`` on the same batch - kernel 6 called 100 times
   and 0, the encoder's outputs per row within kernel 6's 3xTF32 row
   limits and six of its calls per row against ``_tf32x3_gru_step``, the
   ids equal wherever no step's picks part, where they part the gap
   between the two candidates within GEN_GAP_TOL of max(1, |score|), the
   other scores within GEN_SCORE_TOL; ids [64, 3, 50] in the vocabulary,
   scores best first, eos held once emitted (also in a run whose
   ``candidate_adjust`` makes eos likelier from step 20, so beams end);
   the batch's time, generated tokens/s, peak memory (and above the
   batch's start), one batch under ``torch.profiler`` (kernel 6's device
   time and share) and kernel 6 alone at the batch's shape beside its
   bound; ``python -m paddle_tpu_torch train --job=gen`` in a
   subprocess on a snapshot of the same weights, its ids equal to the
   in-process ones; then item 9's other layers at small sizes on the card
   against the same code on the CPU within ITEM9_TOL (a nested group with
   an inner group, ``mdlstmemory`` with mixed directions, ``sub_seq`` and
   ``sub_nested_seq``, batch norm in a group with its state, a step under
   ``rnn_group_remat``, and ``text_lstm`` at its default widths on
   synthetic imdb, the first batch's gradients and 3 Adam losses);
21. the rest of the conv slice (``vision_slice``): VGG-19 with batch
   norm (``models/vgg.py``, 224 px, flowers' 102 classes,
   ``fused_bn_impl="pallas"``, Momentum(0.01, 0.9)) - its 16 relu batch
   norms layer by layer and end to end on the kernel route against the
   plain route at batch 8 (``resnet_layer_parity``, ``resnet_parity``,
   cuDNN deterministic, the spread from the images nudged up and down by
   2^-22, since the dropouts keep each row's mask), 16 launches of 7a and
   of 7b a forward-backward there and none on the plain route; 4 steps at
   batch 64 of synthetic flowers through ``paddle.batch`` and the
   DataFeeder under ``fp32`` and under ``bf16`` (16 launches of the
   policy's instances a step, none of another; step ms, images/s, peak
   memory; one step under ``torch.profiler``: 7a and 7b's device time and
   share, the idle share); 7a and 7b alone at [64, 224, 224, 64] at both
   dtypes against their plain versions, timed beside their bounds, plain
   versions, ``torch.var_mean`` and ``torch.batch_norm_backward_reduce``;
   AlexNet (227 px) and GoogLeNet (224 px) at 1000 classes: one forward
   and backward on the card against the CPU at batch 2 with the card's
   dropout masks (the loss within VISION_LOSS_TOL, every gradient within
   the larger of VISION_GRAD_TOL and twice float32's spread), 4 Momentum
   steps at batch 128; the new layers small, card against CPU
   (``_vision_layer_configs``: conv_transpose at stride 2, an antialiased
   shrinking bilinear_interp, spp at H 13, maxout, pad, crop,
   featmap_expand, conv3d, deconv3d, a 3-D batch norm, both pool3d;
   ITEM9_TOL);
22. the book models (``book_slice``): semantic role labelling at the
   book's width (``label_semantic_roles``: word 32, hidden 128, depth 4,
   T 40, conll05's vocabularies, batch 128) - kernel 5 at [128, 128]
   against its plain step and inside the LSTM layer, forward and
   reversed, with the batch's masks, timed beside its bound; the kernel
   route against ``use_fused_rnn=False`` (the first loss, every
   gradient, ``crf_decoding``'s paths; 320 launches a forward); 6 Adam
   steps under ``fp32`` and ``bf16`` (the loss falling, Chunk's F1, ms a
   step, tokens/s, peak memory, a profiled step's idle share and kernel 5's
   share); OCR-CTC (32 x 128, hidden 128, batch 64: kernel 6 at [64, 128]
   held and timed, 128 calls a step, 4 steps, CTCError); SSD (300 px,
   21 classes, batch 32, ``fused_bn_impl="pallas"``: 7a and 7b held and
   timed at its four batch-norm shapes, 4 launches each a step, 4 steps,
   ``detection_output`` under ``set_sync_debug_mode("error")``,
   DetectionMAP); the recommender and word2vec (softmax and hsigmoid)
   card against CPU over two Adam steps (BOOK_CPU_TOL);
23. the rest of v2 (``v2rest_slice``): upstream's RNN benchmark config
   (``benchmark/paddle/rnn/rnn.py``: vocabulary 30000, embedding 128, two
   ``simple_lstm`` of 512, T 100, batch 128) in its
   ``trainer_config_helpers`` style with a ``@provider`` module through
   ``python -m paddle_tpu_torch train --config=`` in a subprocess,
   ``--job=time`` (ms a batch, tokens/s) and ``--job=train`` (the costs
   finite), then in this process a profiled step's idle share and the
   peak memory (no kernel: the peephole LSTM takes the plain step); each
   ``networks`` helper's model card against CPU at batch 4 (ITEM9_TOL);
   ``networks.multi_head_attention`` at 512 wide, 4 heads, 128 x 100
   padded, the kernel route against the plain one (the first loss, every
   gradient, 3 Adam steps) with kernels 1, 2 and 3 one launch each a step;
24. Fluid (``fluid_slice``): the book's ``vgg16_bn_drop`` (cifar-10 at 32
   px, batch 128, Adam 1e-3, float32) through the eager executor on the
   card, 6 steps (ms a step, images/s, peak memory, the idle share; the
   losses finite; no kernel of the port launched), and the programs of
   ``tests/torch_fluid_programs.py`` card against CPU from the same
   starting values (FLUID_CPU_TOL), chapter 3's inference model saved and
   loaded on the card;
25. Fluid's control flow (``fluid_cf_slice``): a translation model with a
   DynamicRNN decoder (``tests/torch_fluid_programs.py``
   ``nmt_dynamic_rnn``) at bench_nmt's widths (FLUID_NMT), eager against
   run_n's captured CUDA graphs of FLUID_RUN_N steps (ms a step, tokens/s,
   the idle share and peak memory of each, the stand-downs), run_n's
   losses and scope equal to FLUID_RUN_N run() calls bit for bit under
   deterministic algorithms; ``vgg16_bn_drop`` the same way, dropout on;
   ``CF_PROGRAMS`` card against CPU (FLUID_CPU_TOL), the While program's
   counted stand-down, and check_nan_inf aborting without touching the
   scope; no kernel of the port launched;
26. one JSON line each for the LM training, NMT and LSTM, the bf16
   policy, fp16 policy, dispatch, v2, sparse, checkpoint, serving slice,
   whole-forward serving slice, generation, sweep, ResNet,
   ResNet-under-bf16, vision, book, v2rest, fluid and fluid_cf runs, the
   card line again,
   one JSON line listing each kernel's numbers and, last, ``{"ok": true,
   "device": {...}}``.

``--only=<name>[,<name>...]`` runs the setup and then only the named
phases (``dispatch``, ``v2``, ``sparse``, ``ckpt``, ``serve``,
``serve_fwd``, ``gen``, ``vision``, ``book``, ``v2rest``, ``fluid`` or
``fluid_cf``, or a part of one:
DISPATCH_PHASES, V2_PHASES, CTR_PHASES) and prints their JSON: a
development run; the full run takes no arguments.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout.  The tokens/s, time-to-first-token and training step times it
prints are a smoke figure, not a benchmark.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import shutil
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


def _post_status(url, doc, headers=None, timeout=900):
    """(status, body) of one POST /infer, an error status included."""
    import urllib.error
    req = urllib.request.Request(
        url + "/infer", data=json.dumps(doc).encode(),
        headers=dict({"Content-Type": "application/json"}, **(headers or {})),
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _served(engine, docs):
    """Each doc POSTed to ``engine``'s /infer at once: (status, body)s and
    the wall seconds."""
    url = f"http://127.0.0.1:{engine.serve(0).server_address[1]}"
    out = [None] * len(docs)

    def call(i):
        out[i] = _post_status(url, docs[i])

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(docs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("an HTTP request did not finish")
    return out, wall


def _streams_of(what, results):
    bad = [(i, r) for i, r in enumerate(results) if r[0] != 200]
    if bad:
        raise AssertionError(f"{what}: requests failed: {bad[:3]}")
    return [body["outputs"]["tokens"] for _, body in results]


def reference_streams(dec, reqs, n=MAX_TOKENS):
    """Each prompt decoded alone through ``dec`` (the plain-PyTorch path
    on the card), ``n`` tokens; per token, the top-2 logit margin of the
    step that chose it."""
    out = []
    for p in reqs:
        toks = [dec.prefill(0, p)]
        margins = [dec.last_logits[1]]
        pos = len(p)
        for _ in range(n - 1):
            toks.append(int(dec.step(1, [toks[-1]], [pos])[0]))
            margins.append(dec.last_logits[0][0])
            pos += 1
        dec.release_sequence(0)
        top2 = [torch.topk(m, 2).values for m in margins]
        out.append((toks, [float(t[0] - t[1]) for t in top2]))
    return out


def _tie_or_equal(what, got, ref) -> int:
    """0 when ``got`` equals the reference stream, 1 when it parts from it
    at a near tie (the reference's top-2 margin below TOL, reported);
    raises otherwise."""
    toks, margins = ref
    if got == toks:
        return 0
    j = next(j for j, (a, b) in enumerate(zip(got, toks)) if a != b)
    if margins[j] >= TOL:
        raise AssertionError(f"{what}: parts from the reference at token "
                             f"{j} where its top-2 margin is "
                             f"{margins[j]:.3e} >= {TOL}")
    print(f"{what}: parts at token {j}, a near tie (top-2 margin "
          f"{margins[j]:.3e} < {TOL}) - reported, not failed", flush=True)
    return 1


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
        with urllib.request.urlopen(url + "/kernels", timeout=60) as r:
            served = json.loads(r.read())["launches"]
    finally:
        engine.close()
    if any(t.is_alive() for t in threads):
        raise AssertionError("an HTTP request did not finish")
    for i, (code, body) in enumerate(results):
        toks = body["outputs"]["tokens"]
        if code != 200 or len(toks) != MAX_TOKENS \
                or not all(0 <= t < VOCAB for t in toks):
            raise AssertionError(f"request {i}: {code} {body}")
    if served != launches or min(launches[k] for k in SERVE_KERNELS) < 1:
        raise AssertionError(f"a kernel was not launched on the serving "
                             f"path: {launches} (/kernels {served})")
    gen = sum(len(b["outputs"]["tokens"]) for _, b in results)
    print(f"main path: {len(reqs)} HTTP requests, prompts "
          f"{[len(p) for p in reqs]}, {gen} tokens in {wall:.2f}s = "
          f"{gen / wall:.1f} tokens/s; iterations {stats['iterations']}, "
          f"prefix hits {stats['prefix_hits']}, ttft_us p50 "
          f"{stats['decode']['ttft_us_p50']:.0f} p99 "
          f"{stats['decode']['ttft_us_p99']:.0f} "
          f"(smoke figure, not a benchmark); launches {launches}",
          flush=True)

    t0 = time.perf_counter()
    ref_dec = PagedDecoder(model, max_slots=SLOTS, block_size=BLOCK,
                           decode_kernel="torch", device="cuda")
    ref = reference_streams(ref_dec, reqs)
    print(f"plain-PyTorch reference run: {time.perf_counter() - t0:.1f}s",
          flush=True)
    near_ties = sum(_tie_or_equal(f"request {i}", body["outputs"]["tokens"],
                                  r)
                    for i, ((_, body), r) in enumerate(zip(results, ref)))
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
    g = trainer._grads(feed, None if ls is None else ls["scale"])
    ev[1].record()
    trainer.optimizer.update(
        trainer._trainable, g.grads, trainer._opt_state,
        trainer.parameters.meta,
        finite=None if ls is None else (torch.isfinite(g.loss)
                                        & (g.found[0] == 0)))
    ev[2].record()
    torch.cuda.synchronize()
    del g
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


def _rnn_work(kind, b, H, dev, gen) -> dict:
    """Kernel 5's or 6's one call at [b, H] on ``_rnn_args``' operands:
    the kernel, its plain step and the cuBLAS product alone (the step's
    floor) as calls, the live rows, and the operations (over the live
    rows) and bytes (each operand read once, each output written once)
    of the step."""
    from paddle_tpu_torch.ops import fused_rnn as fr

    args = _rnn_args(kind, b, H, dev, gen)
    x, h, *rest = args
    m = rest[-1]
    live = int((m > 0).sum())
    if kind == "lstm":
        c, w, bias = rest[:3]
        return dict(
            args=args, live=live,
            kernel=lambda: fr.lstm_step_cuda(x, h, c, w, bias, m),
            plain=lambda: fr._lstm_step_ref(x, h, c, w, bias, m),
            floor=lambda: torch.addmm(bias, h, w),
            flops=2.0 * live * H * 4 * H,
            bytes=4.0 * (b * 4 * H + 4 * b * H + 4 * H * H + 4 * H + b))
    wg, wc, bias = rest[:3]
    return dict(
        args=args, live=live,
        kernel=lambda: fr.gru_step_cuda(x, h, wg, wc, bias, m),
        plain=lambda: fr._gru_step_ref(x, h, wg, wc, bias, m),
        floor=lambda: (torch.addmm(bias[:2 * H], h, wg),
                       torch.addmm(bias[2 * H:], h, wc)),
        flops=2.0 * live * H * 3 * H,
        bytes=4.0 * (b * 3 * H + 2 * b * H + 3 * H * H + 3 * H + b))


def rnn_step_times(kind, b, H, dev, gen, flush) -> dict:
    """Kernel 5 or 6 alone at [b, H], timed as ``rnn_phase`` times it
    (``time_ms(lead=True)``) beside its bound (three TF32 products at the
    TF32 peak, or the bytes), the FMA floor, its plain step and the
    product alone."""
    work = _rnn_work(kind, b, H, dev, gen)
    with torch.no_grad():
        t = {"ms": time_ms(work["kernel"], flush, lead=True),
             "plain_ms": time_ms(work["plain"], flush, lead=True),
             "addmm_ms": time_ms(work["floor"], flush, lead=True)}
    b_ms, b_by = bound(3 * work["flops"], work["bytes"], PEAK_TF32_FLOPS)
    out = dict(t, bound_ms=b_ms, bound_by=b_by, library_ms=None,
               fma_bound_ms=bound(work["flops"], work["bytes"])[0],
               shape={"B": b, "H": H, "live_rows": work["live"]})
    print(f"{kind}_step at B {b}, H {H} ({work['live']} live rows): ms "
          f"{t['ms']:.4f}  bound_ms {b_ms:.4f} ({b_by}, 3xTF32 at the TF32 "
          f"peak; {t['ms'] / b_ms:.1f}x)  fma_bound_ms "
          f"{out['fma_bound_ms']:.4f}  plain_ms {t['plain_ms']:.4f}  "
          f"library_ms none; the product alone (torch.addmm) "
          f"{t['addmm_ms']:.4f}", flush=True)
    return out


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
        work = _rnn_work(kind, b, RNN_H, dev, gen)
        x, h, *rest = work["args"]
        m = rest[-1]
        live, flops, nbytes = work["live"], work["flops"], work["bytes"]
        kernel, plain, floor = work["kernel"], work["plain"], work["floor"]
        H = RNN_H
        if kind == "lstm":
            c, w, bias = rest[:3]
        else:
            wg, wc, bias = rest[:3]
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
                falling=True, finite=True, reader=None, feeding=None,
                metrics=None):
    """``trainer.SGD.train`` over ``steps`` copies of one batch (or the
    ``steps`` batches of ``reader``, through ``feeding``): every loss
    finite (and, with ``falling``, the last below the first), the
    kernel's counter moving ``per_step`` a step; returns losses, step
    times and peak memory.  With ``finite=False`` (``fp16``, which has no
    loss scaling) a non-finite loss is printed, not raised, and
    ``falling`` holds over the losses before the first of them.  A
    ``metrics`` dict takes the evaluators' metrics at the pass's end."""
    from paddle_tpu_torch import ops

    losses, step_s = [], []

    def handler(e):
        if isinstance(e, paddle.event.BeginIteration):
            torch.cuda.synchronize()
            step_s.append(time.perf_counter())
        elif isinstance(e, paddle.event.EndIteration):
            losses.append(e.cost)          # reading it waits for the step
            step_s[-1] = time.perf_counter() - step_s[-1]
        elif isinstance(e, paddle.event.EndPass) and metrics is not None:
            metrics.update(e.metrics)

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    trainer.train(reader or (lambda: iter([feed] * steps)),
                  event_handler=handler, feeding=feeding)
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
    # the weights phase 20 generates with
    trained = _numpy_tree(trainer.parameters.values)
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
            "peak_gb": peak_gb, "parity": parity, "breakdown": breakdown,
            "trained": trained}


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
            args = bn_args(shape)
            for k, row in bn_times(shape, *args, flush, bounds).items():
                rows_out[k].append(dict(row, shape=list(shape), count=count))
            del args
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


RESNET_PER_PASS = {"matmul_stats": 30, "conv3x3_stats": 16,
                   "bn_fwd_stats": 4, "bn_bwd_stats": 4}


def _resnet_stage(lname):
    return lname[:4] if lname.startswith("res") else (
        "stem" if lname.startswith("stem") else "head")


def resnet_parity(paddle, topo, values, feed, name="ResNet-50",
                  per_pass=RESNET_PER_PASS, lr=RESNET_LR,
                  stage=_resnet_stage, spreads=("nudged", "reversed")):
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
    bounds without the amplification.

    The same holds serve another conv net (``name``, its launches a
    forward-backward ``per_pass``, its Momentum ``lr``, its layers'
    ``stage``); one with dropout takes ``spreads`` that keep each row in
    place (``nudged_down``: the images by 1 - 2^-22), since the trainers'
    generators give each route the same masks by row."""
    from paddle_tpu_torch import ops

    fd_of = {"nudged": dict(feed, image=feed["image"]
                            * np.float32(1 + 2 ** -22)),
             "nudged_down": dict(feed, image=feed["image"]
                                 * np.float32(1 - 2 ** -22)),
             "reversed": {k: np.ascontiguousarray(v[::-1])
                          for k, v in feed.items()}}
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for route, kernel, fd in (("kernel", True, feed),
                                  ("plain", False, feed),
                                  *((sp, False, fd_of[sp])
                                    for sp in spreads)):
            _set_route(topo, kernel)
            ops.reset_launch_counts()
            tr = paddle.trainer.SGD(topo, paddle.parameters.from_numpy(
                topo, values), paddle.optimizer.Momentum(
                    learning_rate=lr, momentum=0.9))
            loss, grads = tr.forward_backward(fd)
            state = tr.model_state
            tr.model_state = tr.topology.create_state()
            losses = []
            tr.train(lambda: iter([fd] * 3), event_handler=lambda e: (
                losses.append(e.cost)
                if isinstance(e, paddle.event.EndIteration) else None))
            runs[route] = (float(loss), grads, state, losses)
            del tr
            got = {k: ops.launch_counts()[k] for k in per_pass}
            want = {k: 4 * n if kernel else 0 for k, n in per_pass.items()}
            if got != want:
                raise AssertionError(f"{name} parity, {route} route: "
                                     f"launches {got}, expected {want}")
    finally:
        _set_route(topo, True)
        torch.backends.cudnn.deterministic = False
    (loss_k, grads_k, state_k, traj_k), (loss_t, grads_t, state_t,
                                         traj_t) = (runs["kernel"],
                                                    runs["plain"])
    spread_runs = [runs[sp] for sp in spreads]
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
        raise AssertionError(f"{name} Momentum trajectory {traj_k}")
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
                f"{name} parity: {what}: kernel route vs plain {err:.3e}, "
                f"beyond its bound {fixed} and twice float32's spread "
                f"{spread:.3e} (the plain route on inputs changed in their "
                f"rounding: {', '.join(spreads)})")
    worst = max(checks[1:-1], key=lambda c: c[1])
    print(f"{name} parity at batch {len(feed['label'])} x "
          f"{feed['image'].shape[1]}^2, kernel route vs the plain route "
          f"(fused_bn_impl and conv_bn_impl 'xla'): first loss {loss_k:.6f} vs "
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


def resnet_layer_parity(paddle, topo, values, feed, gen, tols=None,
                        name="ResNet-50"):
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
                                   outputs=names, generator=gen)
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
                        f"{name} layer parity: {spec.name}: relu decides "
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
                    raise AssertionError(f"{name} layer parity: {what}: "
                                         f"kernel route vs plain {err} > "
                                         f"{bound_}")
                worst[kind] = max(worst[kind], (err, what))
            n += 1
            del run, grads
    finally:
        _set_route(topo, True)
    print(f"{name} layer by layer at batch {len(feed['label'])} ({n} "
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
    """The numbers a layer draws on the card (``torch.randint`` for NCE,
    ``torch.rand`` for dropout: ``fn``), recorded and replayed for the
    same config on the CPU, whose generator draws other numbers."""

    def __init__(self, fn="randint"):
        self.fn = fn
        self.vals = []

    @contextlib.contextmanager
    def _patched(self, fn):
        real = getattr(torch, self.fn)
        setattr(torch, self.fn, fn)
        try:
            yield
        finally:
            setattr(torch, self.fn, real)

    def recording(self):
        real = getattr(torch, self.fn)

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
    return _tests_module("torch_layer_configs")


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
    vals, _ = topo.forward(params, topo.create_state(device=device), tfeed,
                           train=True, generator=gen, device=device)
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


# ------------------------------------------------------ the sparse slice
# phase 16: the wide-and-deep CTR model (models/ctr.py) at 21 M embedding
# rows on the SelectedRows path beside its dense twin, and the README
# quickstart on the card
CTR_VOCABS = (10_000_000, 10_000_000, 1_000_000)
CTR_EMB, CTR_DEEP = 16, (64, 32)
CTR_BATCH, CTR_STEPS, CTR_K, CTR_LR = 4096, 8, 4, 1e-3
# the ids: numpy's Zipf(1.2) folded into each vocabulary, so a batch
# repeats its hot ids as click logs do
CTR_ZIPF = 1.2
CTR_SGD_LR = 0.1
# one 10 M x 16 float32 table, 640 MB: the sparse step's peak above its
# parameters and slots stays under a quarter of it (the JAX package's
# bound, tests/test_sparse_embedding.py)
CTR_TABLE_BYTES = CTR_VOCABS[0] * CTR_EMB * 4
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def ctr_batches(n, seed=SEED) -> list:
    """``n`` seeded batches of ``CTR_BATCH``: Zipf ids a field and clicks
    drawn with the sigmoid of a fixed score of the ids (a hash of each
    id to [-0.5, 0.5) a field, summed, times 4), which a model can learn
    for the ids it sees again."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        feed = {f"f{i}": ((rng.zipf(CTR_ZIPF, CTR_BATCH) - 1) % v).astype(
            np.int32) for i, v in enumerate(CTR_VOCABS)}
        score = sum(feed[f"f{i}"].astype(np.int64) * 2654435761 % 1000
                    / 1000.0 - 0.5 for i in range(len(CTR_VOCABS)))
        feed["click"] = (rng.rand(CTR_BATCH)
                         < 1.0 / (1.0 + np.exp(-4.0 * score))).astype(
                             np.int32)
        out.append(feed)
    return out


def ctr_model(paddle, sparse):
    """``ctr.build`` at full width with ``auc(input=ctr_prob,
    label=click)`` declared on it."""
    from paddle_tpu_torch.models import ctr
    _fresh(paddle)
    cost, prob = ctr.build(field_vocab_sizes=CTR_VOCABS, emb_dim=CTR_EMB,
                           deep_layers=CTR_DEEP, sparse_update=sparse)
    paddle.evaluator.auc(input=prob, label=cost.parents[1], name="auc")
    return paddle.Topology(cost)


CTR_TABLES = tuple((f"{kind}{i}", i) for kind in ("wide", "emb")
                   for i in range(len(CTR_VOCABS)))


def _ctr_trainer(paddle, topo, start, opt):
    """A trainer of ``topo`` on a copy of the ``start`` weights."""
    sparse = bool(topo.sparse_embeddings())
    params = paddle.parameters.Parameters(
        {l: {p: t.clone() for p, t in ps.items()}
         for l, ps in start.values.items()},
        {l: {p: dict(m, sparse_update=sparse and p == "w")
             for p, m in ps.items()} for l, ps in start.meta.items()})
    return paddle.trainer.SGD(topo, params, opt)


def _touched(feeds, field) -> torch.Tensor:
    return torch.as_tensor(np.unique(np.concatenate(
        [f[f"f{field}"] for f in feeds])), device="cuda").long()


def _only_touched_moved(name, tensors, start_w, ids):
    """Raise unless every row that moved in ``tensors`` (a table, or its
    slots, which start at zero) is among ``ids``."""
    mask = torch.zeros(start_w.shape[0], dtype=torch.bool, device="cuda")
    mask[ids] = True
    w, *slots = tensors
    moved = (w != start_w).any(1)
    for s in slots:
        moved |= (s != 0).any(1)
    stray = int((moved & ~mask).sum())
    if stray:
        raise AssertionError(f"{name}: {stray} rows outside the batch's ids "
                             f"moved")


def ctr_sgd_check(paddle, topo_s, topo_d, start, feeds):
    """Two SGD steps of the sparse model and of its dense twin from the
    same weights: each table's touched rows within 1e-6 of the dense
    update's, the rows no batch touched bit for bit their start, the
    dense layers within 1e-6."""
    ts = _ctr_trainer(paddle, topo_s, start,
                      paddle.optimizer.SGD(learning_rate=CTR_SGD_LR))
    td = _ctr_trainer(paddle, topo_d, start,
                      paddle.optimizer.SGD(learning_rate=CTR_SGD_LR))
    for feed in feeds[:2]:
        ts._step(feed)
        td._step(feed)
    torch.cuda.synchronize()
    worst, rows = 0.0, 0
    for name, field in CTR_TABLES:
        ids = _touched(feeds[:2], field)
        ws, wd = ts._trainable[name]["w"], td._trainable[name]["w"]
        worst = max(worst, (ws[ids] - wd[ids]).abs().max().item())
        _only_touched_moved(f"sparse SGD {name}", [ws],
                            start.values[name]["w"], ids)
        rows += ids.numel()
    dense = max((ts._trainable[l][p] - td._trainable[l][p]).abs().max()
                .item() for l, ps in ts._trainable.items() for p in ps
                if (l, p) not in ts._sparse_keys)
    if not (worst <= 1e-6 and dense <= 1e-6):
        raise AssertionError(f"CTR sparse SGD against dense SGD: touched rows "
                             f"off by {worst}, dense layers by {dense} "
                             f"(limit 1e-6)")
    print(f"CTR at {sum(CTR_VOCABS):,} rows: 2 SGD steps (lr {CTR_SGD_LR}) "
          f"sparse against dense: {rows} touched rows within {worst:.2e} "
          f"(limit 1e-6), the dense layers within {dense:.2e}, every other "
          f"row bit for bit its start", flush=True)
    del ts, td
    torch.cuda.empty_cache()
    return {"touched_rows": rows, "row_err": worst, "dense_err": dense}


def _ctr_run(paddle, trainer, feeds, k=None) -> dict:
    """``trainer.train`` over ``feeds`` (one pass): the losses, the pass's
    AUC, and for eager steps each step's host time and its peak memory
    above what was allocated when it began (the parameters and slots
    among it); the median of the steps after the first."""
    out = {"losses": [], "ms": [], "peak": []}
    marks = {}

    def handler(e):
        if isinstance(e, paddle.event.BeginIteration) and k is None:
            torch.cuda.synchronize()
            marks[e.batch_id] = (time.perf_counter(),
                                 torch.cuda.memory_allocated())
            torch.cuda.reset_peak_memory_stats()
        elif isinstance(e, paddle.event.EndIteration):
            out["losses"].append(e.cost)
            if k is None:
                torch.cuda.synchronize()
                t0, base = marks[e.batch_id]
                out["ms"].append((time.perf_counter() - t0) * 1e3)
                out["peak"].append(torch.cuda.max_memory_allocated() - base)
        elif isinstance(e, paddle.event.EndPass):
            out["auc"] = e.metrics["auc"]

    trainer.train(lambda: iter(feeds), event_handler=handler,
                  steps_per_dispatch=k)
    if k is None:
        later = sorted(out["ms"][1:])
        out["step_ms"] = later[len(later) // 2]
        out["peak_above_gb"] = max(out["peak"][1:]) / 1e9
    return out


def _lazy_adam_f64(start, record, name):
    """Lazy Adam in float64 on the host over the rows of table ``name``
    that ``record`` (each step's SelectedRows gradients) touched: (ids,
    parameter rows, first and second moments)."""
    ids_all = np.unique(np.concatenate([r[name][0] for r in record]))
    w = start.values[name]["w"][torch.as_tensor(ids_all, device="cuda")]
    p = w.double().cpu().numpy()
    m, v = np.zeros_like(p), np.zeros_like(p)
    for t, r in enumerate(record, 1):
        ids, rows = r[name]
        pos = np.searchsorted(ids_all, ids)
        g = np.zeros_like(p)
        np.add.at(g, pos, rows)
        hit = np.unique(pos)
        m[hit] = ADAM_B1 * m[hit] + (1 - ADAM_B1) * g[hit]
        v[hit] = ADAM_B2 * v[hit] + (1 - ADAM_B2) * g[hit] ** 2
        mhat = m[hit] / (1 - ADAM_B1 ** t)
        vhat = v[hit] / (1 - ADAM_B2 ** t)
        p[hit] -= CTR_LR * mhat / (np.sqrt(vhat) + ADAM_EPS)
    return ids_all, p, m, v


def ctr_path():
    """Phase 16: ``ctr.build(field_vocab_sizes=(10 M, 10 M, 1 M),
    emb_dim=16, deep_layers=(64, 32), sparse_update=True)``, 21 M
    embedding rows, trained by ``SGD.train`` with Adam 1e-3 at batch 4096
    on CTR_STEPS seeded batches, AUC at the end of the pass:

    - sparse SGD against dense SGD (``ctr_sgd_check``);
    - an eager run whose SelectedRows gradients are recorded: its touched
      rows and their moments against a float64 replay of lazy Adam on
      them (1e-6 x max(1, max |ref|)), every other row and its slots bit
      for bit its start;
    - a second eager run, bit for bit the first (the fixed segment
      order), its step time and peak memory above the parameters and
      slots (under a quarter of a 640 MB table);
    - the same batches as 2 replays of a ``steps_per_dispatch=4`` chunk:
      the 8 losses, every parameter and slot and the AUC bit for bit the
      eager run's, one capture;
    - the dense twin (``sparse_update=False``) over the same batches:
      its step time, peak above its parameters and slots and AUC, smoke
      figures beside the sparse ones."""
    import paddle_tpu_torch as paddle

    feeds = ctr_batches(CTR_STEPS)
    repeats = [1 - len(np.unique(f[f"f{i}"])) / CTR_BATCH
               for f in feeds for i in range(len(CTR_VOCABS))]
    if min(repeats) < 0.25:
        raise AssertionError(f"CTR batches: repeated lookups {min(repeats)} "
                             f"of a field's batch, under a quarter")
    topo_s = ctr_model(paddle, True)
    if len(topo_s.sparse_embeddings()) != len(CTR_TABLES):
        raise AssertionError("CTR: not every table is sparse_update")
    start = topo_s.create_parameters(device="cuda")
    topo_d = ctr_model(paddle, False)
    n_params = sum(t.numel() for ps in start.values.values()
                   for t in ps.values())
    sgd = ctr_sgd_check(paddle, topo_s, topo_d, start, feeds)
    adam = lambda: paddle.optimizer.Adam(learning_rate=CTR_LR)  # noqa: E731

    # the recorded eager run and the float64 replay of its updates
    ta = _ctr_trainer(paddle, topo_s, start, adam())
    record = []
    update = ta.optimizer.update

    def recorded(params, grads, state, meta=None, sparse_grads=None,
                 finite=None):
        record.append({l: (ids.reshape(-1).cpu().numpy(),
                           rows.double().cpu().numpy())
                       for (l, _), (ids, rows) in sparse_grads.items()})
        return update(params, grads, state, meta, sparse_grads=sparse_grads,
                      finite=finite)

    ta.optimizer.update = recorded
    run_a = _ctr_run(paddle, ta, feeds)
    del ta.optimizer.update
    replay = {"row_err": 0.0, "slot_err": 0.0, "rows": 0}
    slots_a = ta._opt_state["slots"]
    for name, _ in CTR_TABLES:
        ids, p, m, v = _lazy_adam_f64(start, record, name)
        idx = torch.as_tensor(ids, device="cuda")
        w = ta._trainable[name]["w"]
        sl = slots_a[name]["w"]
        got = [w[idx], sl["momentum"][idx], sl["second_momentum"][idx]]
        errs = [np.abs(g.double().cpu().numpy() - r).max()
                / max(1.0, np.abs(r).max()) for g, r in zip(got, (p, m, v))]
        replay["row_err"] = max(replay["row_err"], errs[0])
        replay["slot_err"] = max(replay["slot_err"], *errs[1:])
        replay["rows"] += len(ids)
        _only_touched_moved(f"sparse Adam {name}",
                            [w, sl["momentum"], sl["second_momentum"]],
                            start.values[name]["w"], idx)
    if not max(replay["row_err"], replay["slot_err"]) <= 1e-6:
        raise AssertionError(f"CTR sparse Adam against its float64 replay: "
                             f"{replay} (limit 1e-6 x max(1, max |ref|))")

    # the second eager run: bit for bit the first; its time and memory
    tb = _ctr_trainer(paddle, topo_s, start, adam())
    run_b = _ctr_run(paddle, tb, feeds)
    same_ab, worst_ab = _trainers_equal(ta, tb)
    if run_a["losses"] != run_b["losses"] or not same_ab:
        raise AssertionError(f"CTR: two eager runs differ (losses "
                             f"{run_a['losses']} vs {run_b['losses']}, "
                             f"largest state difference {worst_ab})")
    del ta
    torch.cuda.empty_cache()
    if not run_b["peak_above_gb"] * 1e9 < CTR_TABLE_BYTES / 4:
        raise AssertionError(f"CTR sparse step peak {run_b['peak_above_gb']}"
                             f" GB above its parameters and slots, not under"
                             f" a quarter of a {CTR_TABLE_BYTES / 1e9} GB "
                             f"table")

    # the chunk: 2 replays of 4 steps from the same start
    tc = _ctr_trainer(paddle, topo_s, start, adam())
    run_c = _ctr_run(paddle, tc, feeds, k=CTR_K)
    same_bc, worst_bc = _trainers_equal(tb, tc)
    if (run_c["losses"] != run_b["losses"] or not same_bc
            or run_c["auc"] != run_b["auc"] or tc.step_capture_count != 1):
        raise AssertionError(f"CTR: the {CTR_K}-step chunk is not the eager "
                             f"run bit for bit: losses {run_c['losses']} vs "
                             f"{run_b['losses']}, AUC {run_c['auc']} vs "
                             f"{run_b['auc']}, largest state difference "
                             f"{worst_bc}, captures "
                             f"{tc.step_capture_count}")
    tc.release_chunks()
    del tc
    torch.cuda.empty_cache()
    dt, n = tb.timed_multi_dispatch(feeds[0], CTR_K, iters=3, warmup=1)
    chunk_ms = dt / n * 1e3
    test_auc = tb.test(lambda: iter(feeds)).metrics["auc"]
    prof = profile_step(tb, feeds[0])
    if not (run_b["auc"] > 0.5 and all(np.isfinite(run_b["losses"]))):
        raise AssertionError(f"CTR: AUC {run_b['auc']} over the pass, losses "
                             f"{run_b['losses']}")
    del tb
    torch.cuda.empty_cache()

    # the dense twin
    td = _ctr_trainer(paddle, topo_d, start, adam())
    run_d = _ctr_run(paddle, td, feeds)
    del td, start
    torch.cuda.empty_cache()
    print(f"CTR model {CTR_VOCABS} x {CTR_EMB} (+ width-1 wide tables), deep "
          f"{CTR_DEEP}, {n_params:,} parameters, batch {CTR_BATCH}, Adam "
          f"{CTR_LR}, {CTR_STEPS} steps: repeated lookups a field's batch "
          f"{min(repeats):.1%} to {max(repeats):.1%}; sparse losses "
          f"{[round(x, 5) for x in run_b['losses']]}, AUC over the pass "
          f"{run_b['auc']:.4f} (after it {test_auc:.4f}); lazy Adam against "
          f"float64 on {replay['rows']} touched rows: rows "
          f"{replay['row_err']:.2e}, moments {replay['slot_err']:.2e} of "
          f"max(1, max |ref|) (limit 1e-6), every other row and slot bit for "
          f"bit its start; two eager runs bit-equal; {CTR_STEPS // CTR_K} "
          f"replays of a {CTR_K}-step graph bit for bit the eager run, AUC "
          f"equal; sparse step {run_b['step_ms']:.2f} ms eager, "
          f"{chunk_ms:.2f} ms a step in the graph, peak above parameters and "
          f"slots {run_b['peak_above_gb'] * 1e3:.1f} MB (limit "
          f"{CTR_TABLE_BYTES / 4e6:.0f}), one eager step: {_idle(prof)}; "
          f"dense twin: step {run_d['step_ms']:.2f} ms, peak above "
          f"parameters and slots {run_d['peak_above_gb']:.3f} GB, AUC "
          f"{run_d['auc']:.4f}, first loss {run_d['losses'][0]:.6f} "
          f"(sparse {run_b['losses'][0]:.6f}); {card_line()}", flush=True)
    return {"params": n_params, "batch": CTR_BATCH, "steps": CTR_STEPS,
            "repeat_share": [min(repeats), max(repeats)], "sgd": sgd,
            "adam_replay": replay, "losses": run_b["losses"],
            "auc": run_b["auc"], "auc_after_pass": test_auc,
            "step_ms": run_b["step_ms"], "step_ms_all": run_b["ms"],
            "chunk_ms": chunk_ms, "chunk_bit_equal": True,
            "peak_above_gb": run_b["peak_above_gb"],
            "idle_share": prof["idle_share"], "busy_ms": prof["busy_ms"],
            "profiled_step_ms": prof["step_ms"],
            "dense": {"step_ms": run_d["step_ms"],
                      "peak_above_gb": run_d["peak_above_gb"],
                      "auc": run_d["auc"], "losses": run_d["losses"]}}


def quickstart_on_card():
    """The README quickstart as written, with ``paddle_tpu_torch``: 3
    passes of synthetic MNIST with Momentum(0.1, 0.9), then
    ``paddle.infer`` on ``mnist.test()``, on the CPU and on the card from
    the same seeded weights: the 384 batch costs within 1e-4, the
    probabilities within 1e-5."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import layer
    from paddle_tpu_torch.core.ir import reset_name_counters

    test = [(x,) for x, _ in paddle.dataset.mnist.test(synthetic=True)()]
    runs = {}
    for dev in ("cpu", "cuda"):
        reset_name_counters()
        paddle.init(seed=0, device=dev)
        img = layer.data("image", paddle.data_type.dense_vector(784))
        lbl = layer.data("label", paddle.data_type.integer_value(10))
        pred = layer.fc(layer.fc(img, size=128, act="relu"), size=10,
                        act="softmax")
        cost = layer.classification_cost(pred, lbl)

        topo = paddle.Topology(cost)
        params = paddle.parameters.create(topo)
        trainer = paddle.trainer.SGD(
            topo, params, paddle.optimizer.Momentum(learning_rate=0.1,
                                                    momentum=0.9))
        reader = paddle.batch(paddle.dataset.mnist.train(synthetic=True), 64)
        costs = []
        t0 = time.perf_counter()
        trainer.train(reader, num_passes=3, event_handler=lambda e: (
            costs.append(e.cost) if isinstance(e, paddle.event.EndIteration)
            else None))
        seconds = time.perf_counter() - t0
        prob = paddle.infer(output_layer=pred, parameters=params, input=test)
        runs[dev] = (np.asarray(costs), prob, seconds)
    cost_err = float(np.abs(runs["cuda"][0] - runs["cpu"][0]).max())
    prob_err = float(np.abs(runs["cuda"][1] - runs["cpu"][1]).max())
    if not (len(runs["cuda"][0]) == 384 and cost_err <= 1e-4
            and prob_err <= 1e-5):
        raise AssertionError(f"the quickstart on the card against the CPU: "
                             f"{len(runs['cuda'][0])} costs within "
                             f"{cost_err} (limit 1e-4), infer within "
                             f"{prob_err} (limit 1e-5)")
    labels = np.asarray([y for _, y in
                         paddle.dataset.mnist.test(synthetic=True)()])
    acc = float((runs["cuda"][1].argmax(1) == labels).mean())
    print(f"README quickstart on the card: 3 passes, 384 batches, cost "
          f"{runs['cuda'][0][0]:.4f} to {runs['cuda'][0][-1]:.4f} in "
          f"{runs['cuda'][2]:.1f} s ({runs['cpu'][2]:.1f} s on the CPU), "
          f"within {cost_err:.2e} of the CPU run (limit 1e-4); infer on "
          f"mnist.test() within {prob_err:.2e} (limit 1e-5), accuracy "
          f"{acc:.3f}", flush=True)
    return {"cost_err": cost_err, "infer_err": prob_err,
            "first_cost": float(runs["cuda"][0][0]),
            "last_cost": float(runs["cuda"][0][-1]),
            "card_s": runs["cuda"][2], "cpu_s": runs["cpu"][2],
            "test_accuracy": acc}


CTR_PHASES = {
    "ctr": ctr_path,
    "quickstart": quickstart_on_card,
}


def sparse_slice():
    """Phase 16: the CTR model and the quickstart; each releases its
    memory before the next."""
    out = {}
    for name, phase in CTR_PHASES.items():
        out[name] = phase()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------- the checkpoint slice
# phase 17: the checkpoint write side at the LM's full width (bf16, Adam
# TRAIN_LR, batch TRAIN_BATCH x MAX_LEN): run A takes CKPT_STEPS seeded
# batches with a step snapshot every CKPT_EVERY (async); run B, from other
# weights, resumes A's snapshot at CKPT_RESUME_AT and must end bit for bit
# as A; the same at k = 2 into a chunk captured before the restore; the
# dropout + NCE MLP resumed between two replays; A's pass snapshot served
# and generated from
CKPT_STEPS, CKPT_EVERY, CKPT_RESUME_AT = 6, 2, 4
GEN_ROWS, GEN_PROMPT, GEN_NEW, GEN_BEAM = 8, 32, 16, 4


def _ckpt_feeds(n, seed) -> list:
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        seqs = rng.randint(0, VOCAB, size=(TRAIN_BATCH, MAX_LEN + 1)).astype(
            np.int32)
        out.append(trainer_feed(seqs[:, :-1], seqs[:, 1:]))
    return out


def _link_snapshot(src_dir, dst, step) -> None:
    """Snapshot ``step`` of ``src_dir`` hard-linked into ``dst``: A's
    directory with every snapshot newer than it dropped."""
    from paddle_tpu_torch.io import checkpoint
    src = checkpoint.step_dir(src_dir, step)
    out = checkpoint.step_dir(dst, step)
    os.makedirs(out)
    for name in os.listdir(src):
        os.link(os.path.join(src, name), os.path.join(out, name))


def _ckpt_train(paddle, trainer, feeds, cfg, k=1, keep=None) -> dict:
    """``trainer.train`` over ``feeds`` (one pass) with ``cfg``: the
    losses, the host time of each BeginIteration after the compute stream
    drained (from the call), each step snapshot's hand-off, and the
    restore's seconds (``_auto_resume``: verify, load, copy in; the
    stream drained).  ``keep`` = (step, dir): at the last batch's
    BeginIteration the writer is drained and that step snapshot linked
    into dir."""
    losses, begins, handoffs, restores = [], [], [], []
    own, own_resume = trainer._save_step_snapshot, trainer._auto_resume

    def timed(*args):
        handoffs.append(own(*args))
        return handoffs[-1]

    def timed_resume(*args):
        t = time.perf_counter()
        out = own_resume(*args)
        torch.cuda.current_stream().synchronize()
        restores.append(time.perf_counter() - t)
        return out

    def handler(e):
        if isinstance(e, paddle.event.BeginIteration):
            torch.cuda.current_stream().synchronize()
            begins.append(time.perf_counter() - t0)
            if keep is not None and e.batch_id == len(feeds) - 1:
                trainer._flush_ckpt_writer()
                _link_snapshot(cfg.dirname, keep[1], keep[0])
        elif isinstance(e, paddle.event.EndIteration):
            losses.append(float(e.cost))

    trainer._save_step_snapshot = timed
    trainer._auto_resume = timed_resume
    t0 = time.perf_counter()
    try:
        trainer.train(lambda: iter(feeds), event_handler=handler,
                      checkpoint_config=cfg,
                      steps_per_dispatch=k if k > 1 else None)
    finally:
        del trainer._save_step_snapshot, trainer._auto_resume
    return {"losses": losses, "begins": begins, "handoffs": handoffs,
            "restores": restores}


def _since(base) -> dict:
    """The kernel launches since ``base`` (an ``ops.launch_counts()``):
    the phase's counters are set to 0 once, at its start."""
    from paddle_tpu_torch import ops
    return {n: c - base.get(n, 0) for n, c in ops.launch_counts().items()}


def _bf16_counts(base) -> dict:
    c = _since(base)
    return {n: c[n + "_bf16"] for n in TRAIN_KERNELS}


def _check_resumed(name, a, b, run_a, run_b, k, counts, dir_b):
    from paddle_tpu_torch.io import checkpoint
    same, worst = _trainers_equal(a, b)
    want = run_a["losses"][CKPT_RESUME_AT:]
    if (run_b["losses"] != want or not same
            or not a._global_step == b._global_step == CKPT_STEPS
            or b.step_capture_count != (1 if k > 1 else 0)):
        raise AssertionError(
            f"{name}: the resumed run is not the uninterrupted one bit for "
            f"bit: losses {run_b['losses']} vs {want}, largest state "
            f"difference {worst}, global steps {a._global_step} "
            f"{b._global_step}, captures {b.step_capture_count}")
    per = LAYERS * (CKPT_STEPS - CKPT_RESUME_AT)
    if any(n != per for n in counts.values()):
        raise AssertionError(f"{name}: the resumed steps launched {counts}"
                             f" (expected {per} bf16 launches of each)")
    if checkpoint.list_passes(dir_b) != [0]:
        raise AssertionError(f"{name}: no pass snapshot after the resume")


def ckpt_lm(k, gen=None) -> dict:
    """Runs A and B of the LM at ``k`` steps a dispatch; at k = 1 also
    the time figures and (``gen``) A's pass snapshot served and
    generated from."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.io import checkpoint

    paddle, topo = _train_model()
    _policy("bf16")
    root = tempfile.mkdtemp(prefix="ptt_ckpt_")
    dir_a, dir_b = root + "/a", root + "/b"
    try:
        feeds = _ckpt_feeds(CKPT_STEPS, SEED + 11)
        base = ops.launch_counts()
        a = _trainer(paddle, topo, random_values(SEED))
        run_a = _ckpt_train(paddle, a, feeds, checkpoint.CheckpointConfig(
            dir_a, save_period_steps=CKPT_EVERY), k,
            keep=(CKPT_RESUME_AT, dir_b))
        torch.cuda.synchronize()
        counts_a = _bf16_counts(base)
        want_a = LAYERS * CKPT_STEPS
        if (any(n < want_a for n in counts_a.values()) or k == 1 and any(
                n != want_a for n in counts_a.values())):
            raise AssertionError(f"LM k={k} run A launched {counts_a}")
        session = dict(a._ckpt_writer.session)
        man = checkpoint.verify_snapshot(checkpoint.step_dir(
            dir_b, CKPT_RESUME_AT))
        snap_bytes = sum(f["bytes"] for f in man["files"].values())
        b = _trainer(paddle, topo, random_values(SEED + 7))
        if k > 1:
            # a chunk captured and replayed before the restore: the
            # restore must feed the graph's own tensors
            _losses(paddle, b, lambda: iter(_ckpt_feeds(k, SEED + 12)),
                    steps_per_dispatch=k)
        base = ops.launch_counts()
        run_b = _ckpt_train(paddle, b, feeds,
                            checkpoint.CheckpointConfig(dir_b), k)
        torch.cuda.synchronize()
        counts_b = _bf16_counts(base)
        _check_resumed(f"LM k={k}", a, b, run_a, run_b, k, counts_b, dir_b)
        out = {"losses": run_a["losses"], "bit_equal": True,
               "restore_s": run_b["restores"][0],
               "start_s": run_b["begins"][0], "launches_a": counts_a,
               "launches_b": counts_b,
               "snapshot_bytes": snap_bytes,
               "writes": session["writes"], "stalls": session["stalls"],
               "write_s": session["write_s"] / max(1, session["writes"])}
        del b
        shutil.rmtree(dir_b)
        if k == 1:
            # steps[i]: batch i's step and what follows it, to batch
            # i + 1's start; in A batches 1 and 3 end with a step snapshot,
            # 2 and 4 run while its write goes on; run C, the same weights
            # and batches without checkpoint_config, is their control
            c = _trainer(paddle, topo, random_values(SEED))
            run_c = _ckpt_train(paddle, c, feeds, None)
            del c
            if run_c["losses"] != run_a["losses"]:
                raise AssertionError(
                    f"LM k=1: the run without checkpoints differs from A: "
                    f"{run_c['losses']} vs {run_a['losses']}")
            steps, plain = np.diff(run_a["begins"]), np.diff(run_c["begins"])
            out["handoff_ms"] = [h * 1e3 for h in run_a["handoffs"]]
            out["saving_step_ms"] = [float(steps[i]) * 1e3 for i in (1, 3)]
            out["writing_step_ms"] = [float(steps[i]) * 1e3 for i in (2, 4)]
            out["plain_step_ms"] = [float(plain[i]) * 1e3
                                    for i in range(1, 5)]
            if gen is not None:
                out.update(gen(paddle, topo, a, dir_a))
        print(f"checkpoint LM k={k}: run A {CKPT_STEPS} bf16 Adam steps at "
              f"{TRAIN_BATCH} x {MAX_LEN}, losses "
              f"{[round(x, 5) for x in run_a['losses']]}, step snapshots "
              f"every {CKPT_EVERY} ({session['writes']} written, "
              f"{snap_bytes / 1e9:.3f} GB each, {out['write_s']:.2f} s each "
              f"in the background, {session['stalls']} stalls); run B from "
              f"other weights resumed at step {CKPT_RESUME_AT}: the restore "
              f"{out['restore_s']:.2f} s, its first step began "
              f"{out['start_s']:.2f} s into train (the pinned buffers made "
              f"and the reader replayed too); it ended bit for bit as A "
              f"(losses, parameters, moments, t, global step)"
              + (", into a chunk captured before the restore" if k > 1
                 else "") + f"; {card_line()}", flush=True)
        if k == 1:
            print(f"checkpoint hot path (k=1): hand-off "
                  f"{[round(x, 3) for x in out['handoff_ms']]} ms host; "
                  f"steps 1 and 3, which save, "
                  f"{[round(x, 1) for x in out['saving_step_ms']]} ms, "
                  f"steps 2 and 4, during the write, "
                  f"{[round(x, 1) for x in out['writing_step_ms']]} ms; "
                  f"steps 1 to 4 of the same run without checkpoints "
                  f"{[round(x, 1) for x in out['plain_step_ms']]} ms (smoke "
                  f"figures, not a benchmark); {card_line()}", flush=True)
        del a
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)
        _policy("fp32")
        torch.cuda.empty_cache()


def _engine_streams(decoder, reqs) -> list:
    """Each request's tokens from ``InferenceEngine`` over HTTP, all sent
    at once."""
    from paddle_tpu_torch.serving import InferenceEngine

    engine = InferenceEngine(decoder, default_max_tokens=MAX_TOKENS)
    try:
        results, _ = _served(engine, [{"input": [r.tolist()],
                                       "max_tokens": MAX_TOKENS}
                                      for r in reqs])
    finally:
        engine.close()
    return _streams_of("the snapshot's server", results)


def _equal_streams(what, got, want, margin_at) -> None:
    """Raises unless the streams are equal, with the top-2 logit margin
    (``margin_at(j)``) at the first token j that differs."""
    if got == want:
        return
    j = next(j for j, (x, y) in enumerate(zip(got, want)) if x != y)
    raise AssertionError(f"{what}: streams part at token {j} "
                         f"({got[:j + 2]} vs {want[:j + 2]}) where the "
                         f"top-2 margin is {margin_at(j):.3e}")


def serve_and_generate(paddle, topo, trainer, dirname) -> dict:
    """A's pass snapshot served through ``InferenceEngine`` (8 requests)
    against a ``PagedDecoder`` of A's live parameters; then under ``fp32``
    the three generate paths from the snapshot."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.io import checkpoint
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.models.transformer import (PagedDecoder,
                                                     params_from_jax)

    snap = checkpoint.load(dirname)
    if snap["kind"] != "pass" or snap["manifest"]["global_step"] \
            != CKPT_STEPS:
        raise AssertionError(f"A's newest snapshot: {snap['kind']} "
                             f"{snap['manifest']}")
    reqs = prompts()
    base = ops.launch_counts()
    served = _engine_streams(PagedDecoder(
        params_from_jax(checkpoint.params_of(snap), num_heads=HEADS),
        max_slots=SLOTS, block_size=BLOCK, device="cuda"), reqs)
    serve_counts = {n: _since(base)[n] for n in ("flash_fwd", "paged_decode")}
    if min(serve_counts.values()) < 1:
        raise AssertionError(f"serving the snapshot launched {serve_counts}")
    live = reference_streams(PagedDecoder(
        params_from_jax(trainer.parameters, num_heads=HEADS),
        max_slots=SLOTS, block_size=BLOCK, device="cuda"), reqs)
    for i, (got, (toks, margins)) in enumerate(zip(served, live)):
        _equal_streams(f"served request {i}", got, toks,
                       margins.__getitem__)
    print(f"A's pass snapshot served 8 requests of {MAX_TOKENS} tokens over "
          f"HTTP: {len(reqs)} of {len(reqs)} streams equal to a "
          f"PagedDecoder of A's live parameters; launches {serve_counts}",
          flush=True)

    _policy("fp32")
    params = paddle.parameters.from_numpy(topo, checkpoint.params_of(snap))
    rows = np.random.RandomState(SEED + 13).randint(
        0, VOCAB, size=(GEN_ROWS, GEN_PROMPT)).astype(np.int32)
    base = ops.launch_counts()
    t0 = time.perf_counter()
    greedy = transformer.greedy_generate(topo, params, rows,
                                         max_new=GEN_NEW)
    t_greedy = time.perf_counter() - t0
    fwd = _since(base)["flash_fwd"]
    if fwd != LAYERS * GEN_NEW:
        raise AssertionError(f"greedy_generate launched kernel 1 {fwd} "
                             f"times (expected {LAYERS * GEN_NEW})")
    t0 = time.perf_counter()
    incr = transformer.incremental_generate(topo, params, rows,
                                            max_new=GEN_NEW)
    t_incr = time.perf_counter() - t0
    def margin_at(i, j):
        """The top-2 logit margin where row i chose its token j."""
        with torch.no_grad():
            toks = torch.as_tensor(greedy[i:i + 1, :GEN_PROMPT + j],
                                   device="cuda")
            outs, _ = topo.forward(params.values, {}, {
                "tokens": toks, "targets": toks}, outputs=["logits"])
        top2 = torch.topk(outs["logits"][0, -1], 2).values
        return float(top2[0] - top2[1])

    for i in range(GEN_ROWS):
        _equal_streams(f"generate row {i}", greedy[i, GEN_PROMPT:].tolist(),
                       incr[i, GEN_PROMPT:].tolist(),
                       lambda j, i=i: margin_at(i, j))
    t0 = time.perf_counter()
    ids, scores = transformer.beam_generate(topo, params, rows,
                                            max_new=GEN_NEW,
                                            beam_size=GEN_BEAM)
    t_beam = time.perf_counter() - t0
    one, _ = transformer.beam_generate(topo, params, rows, max_new=GEN_NEW,
                                       beam_size=1)
    if (ids.shape != (GEN_ROWS, GEN_BEAM, GEN_NEW)
            or not np.isfinite(scores).all()
            or not (np.diff(scores, axis=1) <= 0).all()
            or not ((ids >= 0) & (ids < VOCAB)).all()):
        raise AssertionError(f"beam_generate: ids {ids.shape}, scores "
                             f"{scores}")
    beam1_equal = int((one[:, 0] == incr[:, GEN_PROMPT:]).all(axis=1).sum())
    print(f"generate from the snapshot (fp32, {GEN_ROWS} prompts of "
          f"{GEN_PROMPT} + {GEN_NEW}): greedy_generate {t_greedy:.2f} s "
          f"({fwd} kernel 1 launches), incremental_generate {t_incr:.2f} s, "
          f"{GEN_ROWS} of {GEN_ROWS} streams equal; "
          f"beam_generate K {GEN_BEAM} {t_beam:.2f} s, best scores "
          f"{[round(float(x), 3) for x in scores[:, 0]]}; one beam equals "
          f"the greedy stream in {beam1_equal} of {GEN_ROWS} rows",
          flush=True)
    return {"served_equal": len(reqs), "serve_launches": serve_counts,
            "generate_equal": GEN_ROWS, "greedy_s": t_greedy,
            "incremental_s": t_incr, "beam_s": t_beam,
            "greedy_launches": fwd, "beam1_equal": beam1_equal}


def ckpt_dropout() -> dict:
    """The dropout + NCE MLP (``dropout_replays``' graph, Momentum 0.01)
    at ``steps_per_dispatch=2`` over 4 seeded batches, a step snapshot
    every 2: a trainer of other weights and another generator seed whose
    chunk was captured and replayed first restores step 2 and replays
    the rest: bit for bit the uninterrupted run, generator included."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.io import checkpoint

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
    rng = np.random.RandomState(SEED + 14)
    feeds = [{"x": rng.randn(64, 256).astype(np.float32),
              "y": rng.randint(0, 1000, 64).astype(np.int32)}
             for _ in range(6)]

    def make(seed):
        paddle.init(seed=seed)
        return paddle.trainer.SGD(
            topo, paddle.parameters.from_numpy(topo,
                                               seeded_values(topo, seed)),
            paddle.optimizer.Momentum(learning_rate=0.01, momentum=0.9))

    root = tempfile.mkdtemp(prefix="ptt_ckpt_mlp_")
    try:
        a = make(SEED)
        run_a = _ckpt_train(paddle, a, feeds[:4], checkpoint.CheckpointConfig(
            root + "/a", save_period_steps=2), 2, keep=(2, root + "/b"))
        b = make(SEED + 7)
        before = _losses(paddle, b, lambda: iter(feeds[4:]),
                         steps_per_dispatch=2)
        run_b = _ckpt_train(paddle, b, feeds[:4], checkpoint.CheckpointConfig(
            root + "/b"), 2)
        same, worst = _trainers_equal(a, b)
        rng_same = torch.equal(a._generator.get_state(),
                               b._generator.get_state())
        if (run_b["losses"] != run_a["losses"][2:] or not same
                or not rng_same or b.step_capture_count != 1):
            raise AssertionError(
                f"dropout MLP resumed between replays: losses "
                f"{run_b['losses']} vs {run_a['losses'][2:]}, state "
                f"{worst}, generator equal {rng_same}, captures "
                f"{b.step_capture_count}")
        print(f"dropout + NCE MLP in a 2-step chunk resumed between replays "
              f"(a replay of {before} before the restore): losses "
              f"{[round(v, 6) for v in run_b['losses']]} and every state "
              f"tensor and the generator bit for bit the uninterrupted run, "
              f"one capture", flush=True)
        return {"losses": run_a["losses"], "bit_equal": True,
                "captures": b.step_capture_count}
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def ckpt_slice() -> dict:
    """Phase 17: the LM resumed at k = 1 (with the time figures, the
    snapshot served and generated from) and k = 2, the dropout MLP; the
    launch counts of kernels 1 to 4 over the phase."""
    from paddle_tpu_torch import ops
    ops.reset_launch_counts()
    out = {"lm_k1": ckpt_lm(1, serve_and_generate), "lm_k2": ckpt_lm(2),
           "dropout": ckpt_dropout()}
    total = ops.launch_counts()
    out["launches"] = {n: total[n] for n in (
        "flash_fwd", "flash_fwd_bf16", "flash_bwd_dkdv_bf16",
        "flash_bwd_dq_bf16", "paged_decode")}
    out["launches"]["flash_fwd_f32"] = (out["launches"]["flash_fwd"]
                                        - out["launches"]["flash_fwd_bf16"])
    if min(out["launches"].values()) < 1:
        raise AssertionError(f"a kernel of the checkpoint slice was not "
                             f"launched: {out['launches']}")
    print(f"checkpoint slice launches: {out['launches']}", flush=True)
    return out


CKPT_PHASES = {"ckpt": ckpt_slice}


# ------------------------------------------------------ the serving slice
SERVE_SEEDED = dict(temperature=0.8, top_k=50, top_p=0.95)
FLOOD_TOKENS, FLOOD_PROMPTS = 64, 8
FLOOD_TENANTS = {"a": 64, "b": 16}


def _flood_prompts():
    """FLOOD_PROMPTS prompts of 5 to 15 tokens (shorter than a block, so
    no prefix is shared and each prefill is one chunk)."""
    rng = np.random.RandomState(SEED + 18)
    return [rng.randint(0, VOCAB, size=int(rng.randint(5, 16)))
            .astype(np.int32) for _ in range(FLOOD_PROMPTS)]


def _tenant_ttft(engine) -> dict:
    """Wraps the engine's first-token hook to record each request's time
    to first token by tenant (the engine keeps one pool for all)."""
    rec = {}
    first = engine._first_token

    def hook(active, r, slot, tok, t_first, *rest):
        rec.setdefault(r.tenant, []).append((t_first - r.t_submit) * 1e6)
        return first(active, r, slot, tok, t_first, *rest)

    engine._first_token = hook
    return rec


def _pct(vals, q):
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(q * len(vals)))] if vals else None


def serve_slice() -> dict:
    """Phase 18: the decode server's overload, tenancy and sampling layer
    at the LM's full width - greedy rows of a sampling decoder, seeded
    requests alone and beside greedy ones, the slab engine under both
    policies, a tenant flood through ``ServingClient`` with retries off,
    a mid-generation deadline, a second flood with retries on, and the
    pick's cost."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.models.transformer import (PagedDecoder,
                                                     SlotDecoder,
                                                     params_from_jax,
                                                     pick_tokens)
    from paddle_tpu_torch.serving import (InferenceEngine, Overloaded,
                                          ServingClient)

    card = card_line()
    model = params_from_jax(random_values(SEED), num_heads=HEADS)
    reqs = prompts()
    out = {}
    ops.reset_launch_counts()
    plain = PagedDecoder(model, max_slots=SLOTS, block_size=BLOCK,
                         device="cuda")
    ref = reference_streams(plain, reqs)
    sampler = PagedDecoder(model, max_slots=SLOTS, block_size=BLOCK,
                           sampling=True, device="cuda")

    # (a) greedy rows of the sampling decoder: no knobs, or temperature 0
    docs = [dict({"input": [p.tolist()], "max_tokens": MAX_TOKENS},
                 **({} if i % 2 else {"temperature": 0.0, "seed": i}))
            for i, p in enumerate(reqs)]
    engine = InferenceEngine(sampler)
    try:
        greedy = _streams_of("greedy rows", _served(engine, docs)[0])
    finally:
        engine.close()
    for i, (got, (toks, margins)) in enumerate(zip(greedy, ref)):
        _equal_streams(f"greedy request {i} of the sampling decoder", got,
                       toks, margins.__getitem__)
    print(f"(a) PagedDecoder(sampling=True), 8 greedy requests (4 with no "
          f"knobs, 4 at temperature 0): 8 of 8 streams equal to the "
          f"sampling=False decoder's reference; {card}", flush=True)

    # (b) seeded requests alone, then beside 8 greedy ones
    seeded = [dict({"input": [p.tolist()], "max_tokens": MAX_TOKENS,
                    "seed": 100 + i}, **SERVE_SEEDED)
              for i, p in enumerate(reqs)]
    extra = [dict(seeded[0], seed=200), dict(seeded[1], top_k=1, seed=300),
             dict(seeded[2], top_k=1, temperature=1.5, seed=301)]
    engine = InferenceEngine(sampler)
    try:
        res, wall_alone = _served(engine, seeded + extra)
        alone = _streams_of("seeded alone", res)
        res, wall_mixed = _served(engine, seeded + [
            {"input": [p.tolist()], "max_tokens": MAX_TOKENS}
            for p in reqs])
        mixed = _streams_of("seeded beside greedy", res)
    finally:
        engine.close()
    if mixed[:8] != alone[:8]:
        i = next(i for i in range(8) if mixed[i] != alone[i])
        raise AssertionError(f"seeded request {i}: its stream beside greedy "
                             f"requests differs from its stream alone")
    for i, (got, (toks, _)) in enumerate(zip(mixed[8:], ref)):
        if got != toks:
            raise AssertionError(f"greedy request {i} beside seeded ones "
                                 f"differs from the reference")
    if alone[8] == alone[0]:
        raise AssertionError("seeds 100 and 200 gave one stream")
    if alone[9] != ref[1][0] or alone[10] != ref[2][0]:
        raise AssertionError("top_k=1 rows differ from greedy")
    distinct = len({tuple(t) for t in alone[:8]})
    print(f"(b) 8 seeded requests (temperature 0.8, top_k 50, top_p 0.95, "
          f"{MAX_TOKENS} tokens): alone {wall_alone:.2f} s, beside 8 greedy "
          f"{wall_mixed:.2f} s, streams equal; seed 200 differs from seed "
          f"100; top_k=1 rows equal greedy; {distinct} distinct streams of "
          f"8; {card}", flush=True)
    out["seeded"] = {"alone_s": wall_alone, "beside_greedy_s": wall_mixed,
                     "distinct": distinct}

    # (c) the slab engine under both policies
    slab_dec = SlotDecoder(model, max_slots=SLOTS, device="cuda")
    docs = [{"input": [p.tolist()], "max_tokens": MAX_TOKENS} for p in reqs]
    out["slab"] = {}
    for policy in ("continuous", "static"):
        slab_dec.reset()
        engine = InferenceEngine(slab_dec, decode_policy=policy)
        try:
            res, wall = _served(engine, docs)
            st = engine.stats()
        finally:
            engine.close()
        streams = _streams_of(f"slab {policy}", res)
        ties = sum(_tie_or_equal(f"slab {policy} request {i}", got, r)
                   for i, (got, r) in enumerate(zip(streams, ref)))
        d = st["decode"]
        rec = {"ttft_us_p50": d["ttft_us_p50"], "ttft_us_p99": d["ttft_us_p99"],
               "tokens_per_s": len(reqs) * MAX_TOKENS / wall,
               "iterations": d["iterations"], "near_ties": ties}
        out["slab"][policy] = rec
        print(f"(c) slab SlotDecoder engine, {policy}: {len(reqs) - ties} of "
              f"{len(reqs)} streams equal to the paged engine's and the "
              f"reference ({ties} near ties); TTFT p50 "
              f"{rec['ttft_us_p50'] / 1e3:.1f} ms p99 "
              f"{rec['ttft_us_p99'] / 1e3:.1f} ms, "
              f"{rec['tokens_per_s']:.1f} tokens/s over {wall:.2f} s, "
              f"{d['iterations']} iterations (smoke figures); {card}",
              flush=True)
    del slab_dec
    torch.cuda.empty_cache()

    # (d) a tenant flood through the client, retries off
    fprompts = _flood_prompts()
    fref = [t for t, _ in reference_streams(plain, fprompts, FLOOD_TOKENS)]
    engine = InferenceEngine(plain, max_queue_depth=16,
                             tenant_weights={"a": 3, "b": 1},
                             max_queue_depth_per_tenant=0.5)
    ttft = _tenant_ttft(engine)
    base_pool = plain.pool_stats()
    url = f"http://127.0.0.1:{engine.serve(0).server_address[1]}"
    client = ServingClient(url, max_attempts=1)
    calls = [(t, i) for t, n in FLOOD_TENANTS.items() for i in range(n)]
    answers, sheds = {}, {}
    lock = threading.Lock()

    def flood_call(k):
        tenant, i = calls[k]
        try:
            toks = client.infer([fprompts[i % FLOOD_PROMPTS].tolist()],
                                max_tokens=FLOOD_TOKENS,
                                tenant=tenant)["tokens"].tolist()
            with lock:
                answers[k] = toks
        except Overloaded as e:
            with lock:
                sheds[e.reason] = sheds.get(e.reason, 0) + 1

    try:
        threads = [threading.Thread(target=flood_call, args=(k,))
                   for k in range(len(calls))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        flood_s = time.perf_counter() - t0
        st = engine.stats()
        if len(answers) + sum(sheds.values()) != len(calls):
            raise AssertionError(f"flood: {len(answers)} answered, {sheds} "
                                 f"shed of {len(calls)}")
        for k, toks in answers.items():
            if toks != fref[calls[k][1] % FLOOD_PROMPTS]:
                raise AssertionError(f"flood request {calls[k]}: its stream "
                                     f"differs from its reference")
        engine_sheds = {r: c for r, c in st["shed"].items() if c}
        if engine_sheds != sheds:
            raise AssertionError(f"flood: the client's 429s {sheds} are not "
                                 f"the engine's sheds {engine_sheds}")
        pool = plain.pool_stats()
        if (st["decode"]["slots_occupied"]
                or pool["used"] != base_pool["used"]
                or pool["free"] != base_pool["free"]
                or plain.blocks.leaked()):
            raise AssertionError(f"flood leaked: slots "
                                 f"{st['decode']['slots_occupied']}, pool "
                                 f"{pool} against {base_pool}")
        share = {t: sum(1 for k in answers if calls[k][0] == t)
                 for t in FLOOD_TENANTS}
        out["flood"] = {
            "answered": share, "sheds": sheds, "seconds": flood_s,
            "ttft_us": {t: {"p50": _pct(v, 0.5), "p99": _pct(v, 0.99)}
                        for t, v in ttft.items()},
            "ttft_us_p50": st["decode"]["ttft_us_p50"],
            "ttft_us_p99": st["decode"]["ttft_us_p99"]}
        print(f"(d) flood of {len(calls)} requests ({FLOOD_TENANTS}, "
              f"{FLOOD_TOKENS} tokens, max_queue_depth 16, weights a 3 b 1, "
              f"quota 0.5) in {flood_s:.2f} s: answered {share}, shed "
              f"{sheds} (the client's 429s equal the engine's sheds), every "
              f"answered stream equal to its reference, slots free and the "
              f"pool at its baseline (used {pool['used']}, free "
              f"{pool['free']}); TTFT ms by tenant " + ", ".join(
                  f"{t} p50 {_pct(v, 0.5) / 1e3:.1f} p99 "
                  f"{_pct(v, 0.99) / 1e3:.1f}" for t, v in
                  sorted(ttft.items())) + f"; {card}", flush=True)

        # (e) a mid-generation deadline
        code, body = _post_status(url, {"input": [reqs[0].tolist()],
                                        "max_tokens": 4000,
                                        "deadline_ms": 50})
        if code != 504:
            raise AssertionError(f"the 50 ms deadline answered {code} {body}")
        t0 = time.perf_counter()
        while engine.stats()["decode"]["slots_occupied"] and \
                time.perf_counter() - t0 < 30:
            time.sleep(0.01)
        pool = plain.pool_stats()
        if (engine.stats()["decode"]["slots_occupied"]
                or pool["used"] != base_pool["used"]
                or plain.blocks.leaked()):
            raise AssertionError(f"the reaped request kept its slot or "
                                 f"blocks: {pool}")
        out["deadline"] = {"status": code,
                           "generated": body.get("generated")}
        print(f"(e) 4000-token request with a 50 ms deadline: {code} after "
              f"{body.get('generated')} tokens; its slot and blocks came "
              f"back; {card}", flush=True)

        # (f) a second flood with retries on
        retrying = ServingClient(url, max_attempts=12, backoff_base_s=0.05,
                                 backoff_cap_s=1.0, deadline_s=120.0)
        took = [None] * 32

        def retry_call(k):
            t0 = time.perf_counter()
            toks = retrying.infer([fprompts[k % FLOOD_PROMPTS].tolist()],
                                  max_tokens=FLOOD_TOKENS,
                                  tenant="ab"[k % 4 == 3])["tokens"].tolist()
            if toks != fref[k % FLOOD_PROMPTS]:
                raise AssertionError(f"retried request {k} differs")
            took[k] = time.perf_counter() - t0

        threads = [threading.Thread(target=retry_call, args=(k,))
                   for k in range(len(took))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        if any(t is None or t >= 120.0 for t in took):
            raise AssertionError(f"a retried call failed or overran its "
                                 f"deadline: {took}")
        cs = retrying.stats()
        out["retries"] = {"calls": len(took), "retries": cs["retries"],
                          "status_counts": cs["status_counts"],
                          "max_s": max(took)}
        print(f"(f) {len(took)} calls with retries on: every call answered "
              f"within its 120 s deadline (slowest {max(took):.2f} s), "
              f"{cs['retries']} retries, statuses {cs['status_counts']}; "
              f"{card}", flush=True)
    finally:
        engine.close()

    # (g) the pick's cost, and the phase's launches
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    lg = torch.randn(SLOTS, VOCAB, device=dev, generator=gen)
    knobs = (torch.full((SLOTS,), 0.8, device=dev),
             torch.full((SLOTS,), 50, dtype=torch.int32, device=dev),
             torch.full((SLOTS,), 0.95, device=dev),
             torch.arange(SLOTS, dtype=torch.int32, device=dev),
             torch.full((SLOTS,), 100, dtype=torch.int32, device=dev))
    pick_ms = time_ms(lambda: pick_tokens(lg, *knobs), flush)
    argmax_ms = time_ms(lambda: torch.argmax(lg, dim=-1), flush)
    del flush
    prof = profile_call(lambda: pick_tokens(lg, *knobs))
    out["pick_profile"] = {k: prof[k] for k in ("step_ms", "busy_ms",
                                                "idle_share", "top")}
    print(f"(g) one pick under torch.profiler: {prof['step_ms']:.4f} ms, "
          f"the device busy {prof['busy_ms']:.4f} ms of it; its kernels "
          f"by device time: " + "; ".join(
              f"{name} x{n} {ms:.4f} ms" for name, n, ms in prof["top"][:6])
          + f"; {card}", flush=True)
    launches = {n: ops.launch_counts()[n] for n in SERVE_KERNELS}
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the serving slice was not "
                             f"launched: {launches}")
    out["pick_ms"], out["argmax_ms"] = pick_ms, argmax_ms
    out["launches"] = launches
    print(f"(g) the sampling pick at vocab {VOCAB} x {SLOTS} rows: "
          f"{pick_ms:.4f} ms a call on CUDA events (sort, softmax, cumsum, "
          f"the noise hash, argmax), the greedy argmax {argmax_ms:.4f} ms; "
          f"the phase launched kernel 1 {launches['flash_fwd']} and kernel "
          f"4 {launches['paged_decode']} times; {card}", flush=True)
    del plain, sampler
    torch.cuda.empty_cache()
    return out


SERVE_PHASES = {"serve": serve_slice}


# phase 19: the whole-forward engine serving the LM's logits
FWD_ROW_BUCKETS, FWD_SEQ_BUCKETS = (1, 2, 4, 8), (128, 512, 2048)
FWD_REQUESTS, FWD_HTTP_REQUESTS, FWD_CANARY_REQUESTS = 32, 8, 64
FWD_CANARY_FRACTION = 0.25
FWD_FLEET_CALLS = 32
# the served config, as a user writes it
FWD_CONFIG = f"""from paddle_tpu_torch.models import transformer

_, logits = transformer.build(vocab_size={VOCAB}, max_len={MAX_LEN},
                              dim={DIM}, num_heads={HEADS},
                              num_layers={LAYERS}, ffn_mult={FFN_MULT})
prediction = logits
"""
FWD_SERVE_FLAGS = ("--max_batch", "8", "--buckets", "1,2,4,8",
                   "--seq_buckets", "128,512,2048", "--device", "cuda")


def _fwd_lengths(rng, n, lo, hi):
    """``n`` lengths in [lo, hi], log-uniform, ascending (short requests
    arrive first, so the micro-batches fill every T bucket)."""
    lens = np.exp(rng.uniform(np.log(lo), np.log(hi + 1), n)).astype(int)
    return sorted(int(min(max(x, lo), hi)) for x in lens)


def _perturbed(values, seed):
    """Other weights of the same names and shapes: each leaf times
    (1 + 0.2 N(0, 1)), so greedy streams change too."""
    rng = np.random.default_rng(seed)
    return {lname: {name: (a * (1.0 + 0.2 * rng.standard_normal(
        a.shape, dtype=np.float32))).astype(np.float32)
        for name, a in ps.items()} for lname, ps in values.items()}


def _get_json(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _post_raw(url, path, body=b"", headers=None, timeout=120):
    """(status, decoded body) of one POST, an error status included."""
    import urllib.error
    req = urllib.request.Request(url + path, data=body,
                                 headers=headers or {}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _kernel1_at_served_shape(lens_list) -> dict:
    """Kernel 1 (float32, 3xTF32) at a micro-batch's shape [8, 2048, 4,
    128], causal, ragged kv_lens (the batch's request lengths): against
    its plain version within TOL and per row (``_hold_fwd_tf32``), timed
    beside the plain version, SDPA with the same mask and the bound of the
    pairs these lengths make visible."""
    from paddle_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 19)
    b, lq, d = len(lens_list), FWD_SEQ_BUCKETS[-1], DIM // HEADS
    q, k, v = (torch.randn(b, lq, HEADS, d, device=dev, generator=gen)
               for _ in range(3))
    lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    kw = dict(causal=True, scale=d ** -0.5, q_offset=0, kv_offset=0)
    o, lse = fa.flash_fwd_cuda(q, k, v, lens, **kw)
    ro, rlse = fa._torch_attention(q, k, v, lens, return_lse=True, **kw)
    torch.cuda.synchronize()
    err = max((o - ro).abs().max().item(), (lse - rlse).abs().max().item())
    if not err <= TOL:
        raise AssertionError(f"kernel 1 at the served shape disagrees with "
                             f"its plain version: {err} > {TOL}")
    held = _hold_fwd_tf32(fa, "flash_fwd served micro-batch", q, k, v, lens,
                          o, lse, kw)
    del o, lse, ro, rlse
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    ms = time_ms(lambda: fa.flash_fwd_cuda(q, k, v, lens, **kw), flush)
    plain_ms = time_ms(lambda: fa._torch_attention(q, k, v, lens, **kw),
                       flush)
    pos = torch.arange(lq, device=dev)
    mask = ((pos[None, :] <= pos[:, None])[None]
            & (pos[None, None, :] < lens[:, None, None]))[:, None]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, scale=d ** -0.5), flush)
    del flush, mask
    # every row's visible keys: min(r + 1, its request's length)
    pairs = sum(sum(min(r + 1, n) for r in range(lq)) for n in lens_list)
    flops = 4.0 * d * HEADS * pairs
    nbytes = 4.0 * (2 * b * lq * HEADS * d + 2 * sum(lens_list) * HEADS * d
                    + b * HEADS * lq + b)
    bnd = _fwd_bounds(flops, nbytes)
    out = dict(shape=[b, lq, HEADS, d], kv_lens=list(lens_list),
               max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               **bnd, **held)
    print(f"kernel 1 at the served micro-batch [{b}, {lq}, {HEADS}, {d}] "
          f"causal, kv_lens {lens_list}: max|err| {err:.3e}, ms {ms:.4f}, "
          f"plain_ms {plain_ms:.4f}, library_ms (SDPA, the same mask) "
          f"{lib_ms:.4f}, bound_ms {bnd['bound_ms']:.4f} ({bnd['bound_by']})"
          f"; {card_line()}", flush=True)
    return out


def _fwd_scoring(engine, out_layer, name) -> dict:
    """(1) FWD_REQUESTS requests of 5 to 2000 tokens submitted at once:
    each answer's logits against the plain path (``attention_impl=
    "torch"``) for that request alone at its own length; kernel 1's
    launches through ``GET /kernels``; the buckets on the grid."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.core import config
    from paddle_tpu_torch.data_feeder import DataFeeder
    from paddle_tpu_torch.inference import Inference

    rng = np.random.RandomState(SEED + 21)
    lens = _fwd_lengths(rng, FWD_REQUESTS, 5, 2000)
    reqs = [rng.randint(0, VOCAB, size=n).astype(np.int32) for n in lens]
    url = f"http://127.0.0.1:{engine.serve(0).server_address[1]}"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    futs = [engine.submit([(r.tolist(),)]) for r in reqs]
    outs = [f.result(900) for f in futs]
    wall = time.perf_counter() - t0
    launches = _get_json(url + "/kernels")["launches"]["flash_fwd"]
    st = engine.stats()
    if launches != LAYERS * st["batches"]:
        raise AssertionError(f"kernel 1 launched {launches} times over "
                             f"{st['batches']} micro-batches, not "
                             f"{LAYERS} a batch")
    off_grid = [b for b in st["buckets_used"]
                if b[0] not in FWD_ROW_BUCKETS or b[1] not in FWD_SEQ_BUCKETS]
    if off_grid or len({b[1] for b in st["buckets_used"]}) < 2:
        raise AssertionError(f"buckets off the grid or one T bucket only: "
                             f"{st['buckets_used']}")
    # the plain path, one request at a time at its own length
    prev = config.get_option("attention_impl")
    config.set_option("attention_impl", "torch")
    try:
        inf = Inference(out_layer, engine._inf.parameters, device="cuda")
        feeder = DataFeeder(inf.topology)
        rows = []
        for r, got in zip(reqs, outs):
            n = len(r)
            if got.shape[1] not in FWD_SEQ_BUCKETS or not np.isfinite(
                    got).all():
                raise AssertionError(f"a {n}-token answer has shape "
                                     f"{got.shape} or is not finite")
            ref = inf.run_feed(feeder.feed([(r.tolist(),)], seq_pad=n))[name]
            rows.append(_o_row_errs(torch.as_tensor(got[0, :n],
                                                    device="cuda"),
                                    ref[0]))
        del inf
    finally:
        config.set_option("attention_impl", prev)
    rows = torch.cat(rows)
    worst = rows.max().item()
    q99 = torch.quantile(rows, 0.99).item()
    if not (worst <= TF32_ROW_TOL and q99 <= TF32_ROW_Q99_TOL):
        raise AssertionError(
            f"served logits against the plain path: rows largest {worst}, "
            f"99% {q99} (limits {TF32_ROW_TOL}, {TF32_ROW_Q99_TOL})")
    pad_share = st["pad_cells"] / (st["pad_cells"] + st["real_cells"])
    res = {"requests": FWD_REQUESTS, "lengths": lens, "seconds": wall,
           "requests_per_s": FWD_REQUESTS / wall,
           "request_us_p50": st["request_us_p50"],
           "request_us_p99": st["request_us_p99"],
           "batches": st["batches"], "buckets_used": st["buckets_used"],
           "padded_rows": st["padded_rows"], "pad_cells": st["pad_cells"],
           "real_cells": st["real_cells"], "pad_cell_share": pad_share,
           "launches": launches, "row_err": worst, "row_err_q99": q99}
    print(f"(1) {FWD_REQUESTS} requests of {lens[0]} to {lens[-1]} tokens "
          f"at once: {st['batches']} micro-batches on {st['buckets_used']}, "
          f"padded_rows {st['padded_rows']}, pad_cells {st['pad_cells']} "
          f"(a {pad_share:.1%} share of the cells); every answer's logits "
          f"against the plain path alone at its own length: rows largest "
          f"{worst:.3e}, 99% {q99:.3e} (kernel 1's 3xTF32 row limits "
          f"{TF32_ROW_TOL:.3e}, {TF32_ROW_Q99_TOL:.3e}); GET /kernels: "
          f"kernel 1 {launches} launches = {LAYERS} x {st['batches']}; "
          f"{res['requests_per_s']:.2f} requests/s over {wall:.2f} s, "
          f"latency p50 {st['request_us_p50'] / 1e3:.1f} ms p99 "
          f"{st['request_us_p99'] / 1e3:.1f} ms (smoke figures); "
          f"{card_line()}", flush=True)
    return res, reqs


def _fwd_batch_profile(engine, reqs, name) -> dict:
    """One 8-row micro-batch at T 2048 (the longest requests) under
    ``torch.profiler``: kernel 1's device time in it, beside the forward's
    time and idle share; then the delivery's copy of its logits to the
    host (pageable memory, as the delivery thread copies), host clock."""
    from paddle_tpu_torch.data_feeder import DataFeeder

    last = reqs[-8:]
    feed = DataFeeder(engine._inf.topology).feed(
        [(r.tolist(),) for r in last], seq_pad=FWD_SEQ_BUCKETS[-1])
    engine._inf.run_feed(feed)
    torch.cuda.synchronize()
    prof = profile_call(lambda: engine._inf.run_feed(feed)[name],
                        match="flash_fwd")
    n = sum(c for nm, (_, c) in prof["per_name"].items() if "flash_fwd" in nm)
    logits = engine._inf.run_feed(feed)[name]
    torch.cuda.synchronize()
    copies = []
    for _ in range(3):
        t0 = time.perf_counter()
        logits.cpu()
        copies.append((time.perf_counter() - t0) * 1e3)
    copy_ms = sorted(copies)[1]
    gb = logits.numel() * logits.element_size() / 1e9
    del logits
    out = {"lengths": [len(r) for r in last], "forward_ms": prof["step_ms"],
           "busy_ms": prof["busy_ms"], "idle_share": prof["idle_share"],
           "kernel1_ms": prof["matched_ms"], "kernel1_launches": n,
           "copy_ms": copy_ms, "copy_gb": gb}
    print(f"one micro-batch [8, {FWD_SEQ_BUCKETS[-1]}] under torch.profiler: "
          f"{prof['step_ms']:.2f} ms, device busy {prof['busy_ms']:.2f} ms; "
          f"kernel 1 {n} launches, {prof['matched_ms']:.3f} ms of device time; "
          f"its {gb:.2f} GB of logits copied to the host in {copy_ms:.1f} ms "
          f"(median of 3, host clock; smoke figures); {card_line()}",
          flush=True)
    return out


def _fwd_http(engine, cfg_path, snap, name) -> dict:
    """(1, HTTP) FWD_HTTP_REQUESTS requests of at most 32 tokens, one after
    another, to ``python -m paddle_tpu_torch serve --model`` in a
    subprocess: each answer bit for bit the in-process engine's."""
    from paddle_tpu_torch.serving import fleet

    rng = np.random.RandomState(SEED + 22)
    reqs = [rng.randint(0, VOCAB, size=int(rng.randint(3, 33))).tolist()
            for _ in range(FWD_HTTP_REQUESTS)]
    want = [engine.infer([(r,)], 900) for r in reqs]
    t0 = time.perf_counter()
    rep = fleet.spawn_replica(cfg_path, extra=["--params", snap,
                                               *FWD_SERVE_FLAGS],
                              log_dir=os.path.join(os.path.dirname(cfg_path),
                                                   "serve_logs"))
    boot_s = time.perf_counter() - t0
    try:
        for i, (r, w) in enumerate(zip(reqs, want)):
            code, body = _post_status(rep.url, {"input": [[r]]})
            got = np.asarray(body.get("outputs", {}).get(name), np.float32)
            if code != 200 or got.shape != w.shape or not np.array_equal(
                    got, w):
                raise AssertionError(
                    f"HTTP request {i} to the serve subprocess: {code}, "
                    f"shape {got.shape}, differs from the in-process answer"
                    f" {w.shape}")
    finally:
        code = rep.stop(60)
    print(f"(1) {FWD_HTTP_REQUESTS} requests of at most 32 tokens to `serve "
          f"--model cfg.py --params DIR` (a subprocess, up in {boot_s:.1f} "
          f"s): every answer bit for bit the in-process engine's; drained "
          f"with exit code {code}; {card_line()}", flush=True)
    return {"requests": FWD_HTTP_REQUESTS, "boot_s": boot_s, "exit": code}


def _fwd_versions(out_layer, params, version, snap_vals, tmp, name) -> dict:
    """(2) A second snapshot of perturbed weights written into the watched
    dir: the watcher swaps; a request in flight at the swap answers on the
    old weights, bit for bit; later ones on the new; a "prev" pin on the
    old; a canary at 0.25 over 64 requests; promote, rollback and POST
    /reload with and without the HMAC key."""
    import hashlib
    import hmac

    from paddle_tpu_torch.data_feeder import DataFeeder
    from paddle_tpu_torch.io import checkpoint
    from paddle_tpu_torch.serving import InferenceEngine, WeightWatcher

    kw = dict(max_batch=8, batch_buckets=FWD_ROW_BUCKETS,
              seq_buckets=FWD_SEQ_BUCKETS)
    watch = os.path.join(tmp, "watch")
    os.makedirs(watch)
    new_vals = _perturbed(snap_vals, SEED + 23)
    req = [(np.random.RandomState(SEED + 24).randint(
        0, VOCAB, size=100).tolist(),)]
    out = {}
    engine = InferenceEngine(out_layer, params, model_version=version, **kw)
    watcher = WeightWatcher(engine, watch, period_s=0.2)
    try:
        old = engine.infer(req, 900)
        sem = threading.Semaphore(0)
        orig = engine._inf.run_feed
        engine._inf.run_feed = lambda feed, params=None: (
            sem.acquire(), orig(feed, params))[1]
        held = engine.submit(req)
        t0 = time.perf_counter()
        while engine.queue_depth() and time.perf_counter() - t0 < 60:
            time.sleep(0.001)
        checkpoint.save_params(watch, new_vals, pass_id=1)
        while (engine.stats()["model_version"] == version
               and time.perf_counter() - t0 < 120):
            time.sleep(0.01)
        new_id = engine.stats()["model_version"]
        if new_id == version:
            raise AssertionError("the watcher did not swap in 120 s")
        post = engine.submit(req)
        for _ in range(8):
            sem.release()
        engine._inf.run_feed = orig
        got_held, got_post = held.result(900), post.result(900)
        feed = DataFeeder(engine._inf.topology).feed(
            req, seq_pad=FWD_SEQ_BUCKETS[0])
        with engine._version_lock:
            new_values = engine._versions[new_id].values
        want_new = orig(feed, new_values)[name].cpu().numpy()
        pinned = engine.infer(req, 900, version="prev")
        if not (np.array_equal(got_held, old)
                and held._ptt_model_version == version):
            raise AssertionError("the request in flight at the swap did not "
                                 "answer on the old weights bit for bit")
        if not (np.array_equal(got_post, want_new)
                and post._ptt_model_version == new_id
                and not np.array_equal(got_post, old)):
            raise AssertionError("the request after the swap did not answer "
                                 "on the new weights")
        if not np.array_equal(pinned, old):
            raise AssertionError("the \"prev\" pin did not answer on the old "
                                 "weights")
        pause_ms = engine.swap_pauses_us()[-1] / 1e3
        out["swap"] = {"old": version, "new": new_id, "pause_ms": pause_ms,
                       "watcher": watcher.stats()}
        print(f"(2) the watcher swapped {version} -> {new_id} (pause "
              f"{pause_ms:.4f} ms, the pointer flip): the request in flight "
              f"answered on {version} bit for bit, the next on {new_id} (its "
              f"weights' forward bit for bit), a \"prev\" pin on {version}; "
              f"{card_line()}", flush=True)
    finally:
        engine.close()

    key = b"chip-smoke-reload-key"
    engine = InferenceEngine(out_layer, params, model_version=version,
                             canary_fraction=FWD_CANARY_FRACTION,
                             reload_key=key, **kw)
    try:
        res = engine.install_version(new_id, new_vals)
        if res["result"] != "canary":
            raise AssertionError(f"install with a canary fraction: {res}")
        rng = np.random.RandomState(SEED + 25)
        futs = [engine.submit([(rng.randint(0, VOCAB, size=int(
            rng.randint(5, 21))).tolist(),)])
                for _ in range(FWD_CANARY_REQUESTS)]
        for f in futs:
            f.result(900)
        split = {}
        for f in futs:
            split[f._ptt_model_version] = split.get(
                f._ptt_model_version, 0) + 1
        want_canary = int(FWD_CANARY_REQUESTS * FWD_CANARY_FRACTION)
        if split.get(new_id) != want_canary or split.get(
                version) != FWD_CANARY_REQUESTS - want_canary:
            raise AssertionError(f"canary split {split}, not "
                                 f"{want_canary} of {FWD_CANARY_REQUESTS}")
        if engine.promote()["result"] != "swapped" or \
                engine.stats()["model_version"] != new_id:
            raise AssertionError("promote did not make the canary active")
        url = f"http://127.0.0.1:{engine.serve(0).server_address[1]}"
        denied, _ = _post_raw(url, "/reload?rollback=1")
        sig = hmac.new(key, b"rollback=1\n", hashlib.sha256).hexdigest()
        code, body = _post_raw(url, "/reload?rollback=1",
                               headers={"X-Ptpu-Reload-Key": sig})
        if denied != 403 or code != 200 or body.get("model_version") != \
                version or engine.stats()["model_version"] != version:
            raise AssertionError(f"POST /reload?rollback=1: unsigned "
                                 f"{denied}, signed {code} {body}")
        out["canary"] = {"split": split, "unsigned_reload": denied,
                         "signed_reload": code,
                         "reloads": engine.stats()["reloads"]}
        print(f"(2) canary_fraction {FWD_CANARY_FRACTION} over "
              f"{FWD_CANARY_REQUESTS} requests: {split}; promote made "
              f"{new_id} active; POST /reload?rollback=1 answered {denied} "
              f"unsigned and {code} signed, back on {version}; "
              f"{card_line()}", flush=True)
    finally:
        engine.close()
    return out, new_vals


def _fwd_decode_swap(snap_vals, new_vals) -> dict:
    """(3) The LM in a PagedDecoder engine: 4 resident streams when new
    weights are installed finish on the old ones (the old reference's
    streams), 4 submitted after it on the new ones."""
    from paddle_tpu_torch.models.transformer import (PagedDecoder,
                                                     params_from_jax)
    from paddle_tpu_torch.serving import InferenceEngine

    reqs = prompts()[:4]
    refs = {}
    for tag, vals in (("old", snap_vals), ("new", new_vals)):
        dec = PagedDecoder(params_from_jax(vals, num_heads=HEADS),
                           max_slots=SLOTS, block_size=BLOCK, device="cuda")
        refs[tag] = reference_streams(dec, reqs)
        del dec
        torch.cuda.empty_cache()
    dec = PagedDecoder(params_from_jax(snap_vals, num_heads=HEADS),
                       max_slots=SLOTS, block_size=BLOCK, device="cuda")
    engine = InferenceEngine(dec, model_version="old")
    try:
        pre = [engine.submit([p], max_tokens=MAX_TOKENS) for p in reqs]
        t0 = time.perf_counter()
        while (engine.stats()["decode"]["slots_occupied"] < len(reqs)
               and time.perf_counter() - t0 < 60):
            time.sleep(0.0005)
        res = engine.install_version("new", new_vals)
        post = [engine.submit([p], max_tokens=MAX_TOKENS) for p in reqs]
        got_pre = [f.result(900).tolist() for f in pre]
        got_post = [f.result(900).tolist() for f in post]
        ties = 0
        for i, (f, got) in enumerate(zip(pre, got_pre)):
            if f._ptt_model_version != "old":
                raise AssertionError(f"resident {i} answered on "
                                     f"{f._ptt_model_version}")
            ties += _tie_or_equal(f"resident {i} (old weights)", got,
                                  refs["old"][i])
        for i, (f, got) in enumerate(zip(post, got_post)):
            if f._ptt_model_version != "new":
                raise AssertionError(f"request {i} after the swap answered "
                                     f"on {f._ptt_model_version}")
            ties += _tie_or_equal(f"request {i} after the swap (new "
                                  f"weights)", got, refs["new"][i])
        if all(a == b for a, b in zip(got_pre, got_post)):
            raise AssertionError("the swap changed no stream")
        pause_ms = engine.swap_pauses_us()[-1] / 1e3
    finally:
        engine.close()
    del dec
    torch.cuda.empty_cache()
    print(f"(3) PagedDecoder engine, install while {len(reqs)} streams are "
          f"resident ({res['result']}): they finish on the old weights "
          f"(equal to the old reference), the {len(reqs)} after it on the "
          f"new ({ties} near ties); the drain-then-swap pause "
          f"{pause_ms:.2f} ms; {card_line()}", flush=True)
    return {"install": res["result"], "near_ties": ties,
            "pause_ms": pause_ms}


def _fleet_ready(log_dir, n, timeout=600):
    """The ready records of ``n`` replicas' logs under ``log_dir``."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        recs = []
        for f in sorted(os.listdir(log_dir)) if os.path.isdir(log_dir) else ():
            if not f.startswith("replica-"):
                continue
            with open(os.path.join(log_dir, f), errors="replace") as fh:
                for line in fh:
                    if line.startswith('{"ptpu_serve"'):
                        recs.append(dict(json.loads(line)["ptpu_serve"],
                                         log=os.path.join(log_dir, f)))
        if len(recs) >= n:
            return recs
        time.sleep(0.2)
    raise AssertionError(f"{n} replicas not ready in {timeout} s under "
                         f"{log_dir}")


def _fwd_fleet(cfg_path, snap, tmp, name) -> dict:
    """(4) ``serve --fleet 2``: a router and two replica processes on the
    card; FWD_FLEET_CALLS calls through ``ServingClient`` to the router,
    one replica SIGKILLed mid-run, every call answered, the dead replica
    out of rotation, the survivor deregistering on drain."""
    import signal

    from paddle_tpu_torch.serving import ServingClient

    log_dir = os.path.join(tmp, "fleet_logs")
    log = open(os.path.join(tmp, "fleet.log"), "w")
    argv = [sys.executable, "-m", "paddle_tpu_torch", "serve", "--fleet",
            "2", "--model", cfg_path, "--params", snap, "--port", "0",
            "--fleet_log_dir", log_dir, "--router_poll_interval_s", "0.1",
            "--router_staleness_s", "2.0", "--max_batch", "8", "--buckets",
            "1,2,4,8", "--seq_buckets", "8,128,512,2048", "--device", "cuda"]
    proc = subprocess.Popen(argv, stdout=log, stderr=subprocess.STDOUT,
                            stdin=subprocess.DEVNULL)
    replicas = []
    try:
        t0 = time.perf_counter()
        router_url = None
        while router_url is None and time.perf_counter() - t0 < 120:
            if proc.poll() is not None:
                raise AssertionError("serve --fleet exited early")
            with open(os.path.join(tmp, "fleet.log"),
                      errors="replace") as fh:
                for line in fh:
                    if line.startswith('{"ptpu_serve"'):
                        router_url = json.loads(line)["ptpu_serve"]["url"]
            time.sleep(0.1)
        replicas = _fleet_ready(log_dir, 2)
        while (_get_json(router_url + "/stats")["replicas_up"] < 2
               and time.perf_counter() - t0 < 600):
            time.sleep(0.2)
        boot_s = time.perf_counter() - t0
        client = ServingClient(router_url, max_attempts=8,
                               backoff_base_s=0.05, backoff_cap_s=1.0,
                               deadline_s=120.0)
        rng = np.random.RandomState(SEED + 26)
        calls = [rng.randint(0, VOCAB, size=int(rng.randint(3, 9))).tolist()
                 for _ in range(FWD_FLEET_CALLS)]
        done, lock, errors = [], threading.Lock(), []
        killed = replicas[0]
        kill_at = FWD_FLEET_CALLS // 4

        def worker(k):
            for i in range(k, FWD_FLEET_CALLS, 8):
                try:
                    out = client.infer([[calls[i]]])
                    got = np.asarray(out[name])
                    if got.shape != (1, 8, VOCAB) or not np.isfinite(
                            got).all():
                        raise AssertionError(f"call {i}: shape {got.shape}")
                except Exception as e:        # noqa: BLE001 - reported
                    with lock:
                        errors.append((i, repr(e)))
                    continue
                with lock:
                    done.append(i)
                    if len(done) == kill_at:
                        os.kill(killed["pid"], signal.SIGKILL)

        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(8)]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        calls_s = time.perf_counter() - t1
        if errors or len(done) != FWD_FLEET_CALLS:
            raise AssertionError(f"fleet calls: {len(done)} answered, "
                                 f"errors {errors[:3]}")
        t2 = time.perf_counter()
        while time.perf_counter() - t2 < 30:
            rs = _get_json(router_url + "/stats")
            dead = rs["replicas"].get(killed["url"], {})
            if not dead.get("up", True):
                break
            time.sleep(0.1)
        if dead.get("up", True) or rs["replicas_up"] != 1:
            raise AssertionError(f"the killed replica is still in rotation: "
                                 f"{rs['replicas']}")
        proc.send_signal(signal.SIGINT)
        code = proc.wait(180)
        survivor = replicas[1]
        with open(survivor["log"], errors="replace") as fh:
            slog = fh.read()
        if "deregistered from router" not in slog:
            raise AssertionError(f"the survivor did not deregister on "
                                 f"drain: {slog[-2000:]}")
        cs = client.stats()
        res = {"boot_s": boot_s, "calls": FWD_FLEET_CALLS,
               "calls_s": calls_s, "killed_after": kill_at,
               "client_retries": cs["retries"],
               "router_failovers": rs["failovers"],
               "router_forwarded": rs["forwarded"],
               "killed_state": dead.get("state"), "fleet_exit": code}
        print(f"(4) serve --fleet 2 up in {boot_s:.1f} s (a router and two "
              f"replicas on the card): {FWD_FLEET_CALLS} calls through "
              f"ServingClient all answered in {calls_s:.2f} s, one replica "
              f"SIGKILLed after {kill_at} (router failovers "
              f"{rs['failovers']}, client retries {cs['retries']}); the "
              f"router shows it {dead.get('state')} and out of rotation; on "
              f"drain the survivor deregistered, the fleet exited {code}; "
              f"{card_line()}", flush=True)
        return res
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        for rec in replicas:
            try:
                os.kill(rec["pid"], signal.SIGKILL)
            except OSError:
                pass
        log.close()


def serve_fwd_slice() -> dict:
    """Phase 19: the whole-forward engine serving the LM's logits at full
    width as ``serve --model cfg.py --params DIR`` serves it (max_batch 8,
    row buckets 1, 2, 4, 8, T buckets 128, 512, 2048): micro-batched
    scoring against the plain path and over HTTP, model versions with the
    watcher, the canary and /reload, decode drain-then-swap, and the
    fleet with a replica killed."""
    from paddle_tpu_torch import cli
    from paddle_tpu_torch.io import checkpoint
    from paddle_tpu_torch.serving import InferenceEngine

    tmp = tempfile.mkdtemp(prefix="serve_fwd_")
    try:
        snap = os.path.join(tmp, "snap")
        snap_vals = random_values(SEED)
        checkpoint.save_params(snap, snap_vals)
        cfg_path = os.path.join(tmp, "cfg.py")
        with open(cfg_path, "w") as f:
            f.write(FWD_CONFIG)
        args = cli.build_parser().parse_args(
            ["serve", "--model", cfg_path, "--params", snap,
             *FWD_SERVE_FLAGS])
        out_layer, params, version, _, _ = cli._serve_weights(args)
        engine = InferenceEngine(out_layer, params, model_version=version,
                                 max_batch=8, batch_buckets=FWD_ROW_BUCKETS,
                                 seq_buckets=FWD_SEQ_BUCKETS)
        name = engine.output_names[0]
        try:
            out = {}
            out["scoring"], reqs = _fwd_scoring(engine, out_layer, name)
            out["micro_batch"] = _fwd_batch_profile(engine, reqs, name)
            out["kernel1"] = _kernel1_at_served_shape(
                out["micro_batch"]["lengths"])
            out["http"] = _fwd_http(engine, cfg_path, snap, name)
        finally:
            engine.close()
        torch.cuda.empty_cache()
        out["versions"], new_vals = _fwd_versions(out_layer, params, version,
                                                  snap_vals, tmp, name)
        del params
        torch.cuda.empty_cache()
        out["decode_swap"] = _fwd_decode_swap(snap_vals, new_vals)
        out["fleet"] = _fwd_fleet(cfg_path, snap, tmp, name)
        out["launches"] = out["scoring"]["launches"]
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


SERVE_FWD_PHASES = {"serve_fwd": serve_fwd_slice}


# ---------------------------------------- phase 20: NMT beam generation
GEN_BATCH, GEN_BEAM = 64, 3
GEN_SEED = SEED + 22
# Between the routes only the encoder differs: kernel 6 leaves each of its
# output rows within 2^-16 of the row's norm for 99% of rows (its 3xTF32
# row limit), about 1e-6 in the measurements so far.  A beam's score is a
# float32 sum of up to 50 log-probs of magnitude up to about 10 that move
# with those outputs; GEN_SCORE_TOL of max(1, |score|) bounds the move of
# one score, and two candidates can trade places only where their gap is
# below the sum of their two moves: GEN_GAP_TOL, twice it.
GEN_SCORE_TOL = 1e-4
GEN_GAP_TOL = 2 * GEN_SCORE_TOL
GEN_TIMED = 3
# the eos run: from this step on eos's log-prob gains this much, so beams
# end and the finished-beam path runs at full width
GEN_EOS_FROM, GEN_EOS_BONUS = 20, 8.0
# item 9's other layers on the card against the CPU (same port code)
ITEM9_TOL = 1e-5
TEXT_LSTM_BATCH, TEXT_LSTM_STEPS = 32, 3



def gen_feed(seed, batch, length, vocab) -> dict:
    """The generated batch's sources: ``batch`` rows of ids in [3,
    vocab), lengths drawn in [1, length] (``GEN_CONFIG`` carries this
    function's source, so the CLI's reader yields the same batch)."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, length + 1, batch)
    ids = rng.randint(3, vocab, (batch, length))
    return {"source_words": ids.astype(np.int32),
            "source_words@len": lens.astype(np.int32)}


GEN_ARGS = (GEN_SEED, GEN_BATCH, NMT_LEN, NMT_VOCAB)

# the --job=gen config: the generator at bench_nmt's widths and a reader
# of the same batch
GEN_CONFIG = """import numpy as np
from paddle_tpu_torch.models import seq2seq

generator = seq2seq.build({vocab}, {vocab}, emb_dim={dim}, enc_dim={dim},
                          dec_dim={dim}, max_src_len={len},
                          max_trg_len={len}, is_generating=True,
                          beam_size={beam})


{feed}

def gen_reader():
    yield gen_feed{args}
"""


def _numpy_tree(values) -> dict:
    return {l: {p: t.detach().cpu().numpy() for p, t in ps.items()}
            for l, ps in values.items()}


def nmt_trained_values() -> dict:
    """``nmt_path``'s weights after its NMT_STEPS Adam steps, for a run
    of the generation phase alone."""
    paddle, topo = nmt_model()
    trainer = paddle.trainer.SGD(
        topo, paddle.parameters.from_numpy(topo, seeded_values(topo, SEED)),
        paddle.optimizer.Adam(learning_rate=NMT_LR))
    trainer.train(lambda: iter([nmt_feed(NMT_BATCH)] * NMT_STEPS))
    return _numpy_tree(trainer.parameters.values)


def gen_model(paddle):
    """``seq2seq.build(is_generating=True)`` at ``bench_nmt``'s widths."""
    from paddle_tpu_torch.models import seq2seq

    _fresh(paddle)
    return paddle.Topology(seq2seq.build(
        NMT_VOCAB, NMT_VOCAB, emb_dim=NMT_DIM, enc_dim=NMT_DIM,
        dec_dim=NMT_DIM, max_src_len=NMT_LEN, max_trg_len=NMT_LEN,
        is_generating=True, beam_size=GEN_BEAM))


class _Candidates:
    """A ``drop_node`` hook that drops nothing and keeps each step's 2k
    best candidates of every sample, ranked as the engine ranks them (a
    stable descending sort)."""

    def __init__(self, k):
        self.k, self.steps = k, []

    def __call__(self, cand, tokens, t):
        vals, idx = torch.sort(cand.reshape(cand.shape[0], -1), dim=1,
                               descending=True, stable=True)
        self.steps.append((vals[:, :2 * self.k].clone(),
                           idx[:, :2 * self.k].clone()))
        return torch.zeros_like(cand, dtype=torch.bool)


def _eos_bonus(logp, tokens, t):
    """``candidate_adjust``: eos (1) GEN_EOS_BONUS likelier from step
    GEN_EOS_FROM on."""
    if t < GEN_EOS_FROM:
        return logp
    return torch.cat([logp[..., :1], logp[..., 1:2] + GEN_EOS_BONUS,
                      logp[..., 2:]], dim=-1)


def _gen_run(topo, params, feed, fused, hook=None, adjust=None):
    """One generated batch on the kernel route or the plain one, with
    ``hook`` as its ``drop_node`` and ``adjust`` as its
    ``candidate_adjust``: (ids, scores, the encoder's outputs, kernel 6's
    calls)."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.core import config

    spec = topo.get_layer("decoder_group")
    spec.attrs["drop_node"] = hook
    spec.attrs["candidate_adjust"] = adjust
    config.set_option("use_fused_rnn", fused)
    try:
        ops.reset_launch_counts()
        outs, state = topo.forward(params, {}, feed, outputs=[
            "decoder_group", "encoded_sequence"])
        torch.cuda.synchronize()
        return (outs["decoder_group"], state["decoder_group"]["scores"],
                outs["encoded_sequence"], ops.launch_counts()["gru_step"])
    finally:
        config.set_option("use_fused_rnn", True)
        spec.attrs["drop_node"] = spec.attrs["candidate_adjust"] = None


def _first_divergences(rec_k, rec_p, k) -> dict:
    """{sample: (step, gap, scale)} for each sample whose picks differ
    between the routes: the first step where they do (every earlier pick,
    hence every history, equal), and there the largest distance, in the
    plain route's scores, between the candidate each route took at a rank
    (a candidate outside the plain route's 2k best counts as the 2k-th's
    score, a lower bound of its gap); ``scale`` is max(1, |best score|)
    at that step."""
    out = {}
    for t, ((_, ki), (pv, pi)) in enumerate(zip(rec_k.steps, rec_p.steps)):
        diff = (ki[:, :k] != pi[:, :k]).any(1).nonzero().flatten().tolist()
        for b in diff:
            if b in out:
                continue
            gaps = []
            for j in range(k):
                f = ki[b, j].item()
                if f == pi[b, j].item():
                    continue
                at = (pi[b] == f).nonzero().flatten()
                other = pv[b, at[0] if len(at) else -1].item()
                gaps.append(abs(pv[b, j].item() - other))
            out[b] = (t, max(gaps), max(1.0, abs(pv[b, 0].item())))
    return out


def _gen_structure(ids, scores):
    """[GEN_BATCH, GEN_BEAM, NMT_LEN] ids in the vocabulary, scores best
    first, eos (1) to the end once emitted."""
    ids, scores = ids.cpu(), scores.cpu()
    if tuple(ids.shape) != (GEN_BATCH, GEN_BEAM, NMT_LEN):
        raise AssertionError(f"generated ids of shape {tuple(ids.shape)}")
    if not ((ids >= 0) & (ids < NMT_VOCAB)).all():
        raise AssertionError("a generated id outside the vocabulary")
    if not (scores[:, 1:] <= scores[:, :-1]).all():
        raise AssertionError(f"beam scores increase across beams: "
                             f"{scores[:4].tolist()}")
    eos = ids == 1
    after = eos.int().cummax(dim=2).values.bool()
    if not (ids[after] == 1).all():
        raise AssertionError("a beam left eos after emitting it")
    return int(eos.any(2).sum())


def _gen_routes(topo, params, feed):
    """The kernel route against the plain one on the same batch (the
    holds of the phase's docstring); returns the kernel route's ids and
    the figures."""
    fr_calls = _RnnCalls("gru", [0, 1, NMT_LEN, NMT_LEN + 1,
                                 2 * NMT_LEN - 2, 2 * NMT_LEN - 1])
    rec_k, rec_p = _Candidates(GEN_BEAM), _Candidates(GEN_BEAM)
    with fr_calls:
        ids_k, sc_k, enc_k, n_k = _gen_run(topo, params, feed, True, rec_k)
    ids_p, sc_p, enc_p, n_p = _gen_run(topo, params, feed, False, rec_p)
    if (n_k, n_p) != (2 * NMT_LEN, 0):
        raise AssertionError(f"generation: kernel 6 called {n_k} times on "
                             f"the kernel route (expected {2 * NMT_LEN}) "
                             f"and {n_p} on the plain one (expected 0)")
    rows = fr_calls.hold("generation encoder", 2 * NMT_LEN, 2 * NMT_LEN)
    worst, q99, ok = _tf32_holds(enc_k, enc_p)
    if not ok:
        raise AssertionError(f"generation encoder outputs, kernel route vs "
                             f"plain: rows largest {worst}, q99 {q99}")
    div = _first_divergences(rec_k, rec_p, GEN_BEAM)
    for b, (t, gap, scale) in sorted(div.items()):
        print(f"generation sample {b}: the routes' beams part at step {t}, "
              f"where the candidates' gap in the plain route's scores is "
              f"{gap:.3e} (limit {GEN_GAP_TOL:.0e} x {scale:.2f})",
              flush=True)
        if not gap <= GEN_GAP_TOL * scale:
            raise AssertionError(f"generation sample {b}: routes part at "
                                 f"step {t} over a gap of {gap}")
    same = [b for b in range(GEN_BATCH) if b not in div]
    if not torch.equal(ids_k[same], ids_p[same]):
        raise AssertionError("generation: ids differ where no pick did")
    sk, sp = sc_k[same], sc_p[same]
    score_err = ((sk - sp).abs() / sp.abs().clamp_min(1.0)).max().item()
    if not score_err <= GEN_SCORE_TOL:
        raise AssertionError(f"generation scores, kernel route vs plain: "
                             f"{score_err} > {GEN_SCORE_TOL} of max(1, "
                             f"|score|)")
    n_eos = _gen_structure(ids_k, sc_k)
    ids_e, sc_e, _, _ = _gen_run(topo, params, feed, True,
                                 adjust=_eos_bonus)
    n_eos_forced = _gen_structure(ids_e, sc_e)
    if not n_eos_forced:
        raise AssertionError("the eos run ended no beam")
    print(f"generation at batch {GEN_BATCH} x beam {GEN_BEAM} x "
          f"{NMT_LEN} steps, kernel route vs use_fused_rnn=False: kernel 6 "
          f"called {n_k} and {n_p} times; encoder outputs' rows largest "
          f"{worst:.3e}, 99% {q99:.3e} (limits {TF32_ROW_TOL:.3e}, "
          f"{TF32_ROW_Q99_TOL:.3e}); {GEN_BATCH - len(div)} of {GEN_BATCH} "
          f"samples' beams equal, scores within {score_err:.3e} of max(1, "
          f"|score|) (limit {GEN_SCORE_TOL:.0e}); {n_eos} of "
          f"{GEN_BATCH * GEN_BEAM} beams ended on eos, {n_eos_forced} with "
          f"eos {GEN_EOS_BONUS} likelier from step {GEN_EOS_FROM} (each "
          f"held at eos to the end)", flush=True)
    return ids_k, fr_calls, {
        "encoder_row_err": worst, "encoder_row_err_q99": q99,
        "kernel_rows": rows, "score_err": score_err,
        "samples_parted": {str(b): {"step": t, "gap": g, "limit":
                                    GEN_GAP_TOL * s}
                           for b, (t, g, s) in div.items()},
        "beams_on_eos": n_eos, "beams_on_eos_forced": n_eos_forced}


def _gen_times(topo, params, feed, fr_calls, flush) -> dict:
    """The kernel route's batch time (CUDA events, the median of
    GEN_TIMED after the parity runs), tokens/s, peak memory, one batch
    under ``torch.profiler`` (kernel 6's device time and share), and
    kernel 6 alone at the batch's middle call (a ragged mask) beside its
    bound, its plain step and the product's floor."""
    from paddle_tpu_torch.ops import fused_rnn as fr

    def run():
        topo.forward(params, {}, feed, outputs=["decoder_group"])

    ms = []
    for i in range(GEN_TIMED):
        if i == GEN_TIMED - 1:
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        run()
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    above_gb = peak_gb - start / 1e9
    batch_ms = sorted(ms)[len(ms) // 2]
    prof = profile_call(run, match="gru_tf32_kernel")
    tokens = GEN_BATCH * GEN_BEAM * NMT_LEN
    x, h, wg, wc, bias, m = next(a for i, a, _ in fr_calls.calls
                                 if i == NMT_LEN)
    H, b = h.shape[1], h.shape[0]
    live = int((m > 0).sum())
    with torch.no_grad():
        k = {"ms": time_ms(lambda: fr.gru_step_cuda(x, h, wg, wc, bias, m),
                           flush, lead=True),
             "plain_ms": time_ms(lambda: fr._gru_step_ref(
                 x, h, wg, wc, bias, m), flush, lead=True),
             "addmm_ms": time_ms(lambda: (
                 torch.addmm(bias[:2 * H], h, wg),
                 torch.addmm(bias[2 * H:], h, wc)), flush, lead=True)}
    flops = 2.0 * live * H * 3 * H
    nbytes = 4.0 * (b * 3 * H + 2 * b * H + 3 * H * H + 3 * H + b)
    k["bound_ms"], k["bound_by"] = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
    k["shape"] = {"B": b, "H": H, "live_rows": live}
    out = {"batch_ms": batch_ms, "batch_ms_all": ms,
           "tokens_per_s": tokens / (batch_ms / 1e3), "peak_gb": peak_gb,
           "peak_above_start_gb": above_gb,
           "kernel6_profiled_ms": prof["matched_ms"],
           "profiled_batch_ms": prof["step_ms"], "busy_ms": prof["busy_ms"],
           "idle_share": prof["idle_share"],
           "kernel6_share": prof["matched_ms"] / prof["step_ms"],
           "kernel6_at_gen_shape": k}
    print(f"generation (smoke figures, not a benchmark; {card_line()}): a "
          f"batch of {GEN_BATCH} sources x beam {GEN_BEAM} x {NMT_LEN} "
          f"steps {batch_ms:.1f} ms (runs {[round(v, 1) for v in ms]}) = "
          f"{out['tokens_per_s']:.0f} generated tokens/s; peak memory "
          f"{peak_gb:.2f} GB, {above_gb:.2f} GB above the batch's start "
          f"(below it the weights and what earlier phases hold); one "
          f"profiled batch {prof['step_ms']:.1f} ms, "
          f"device busy {prof['busy_ms']:.1f}, kernel 6 "
          f"{prof['matched_ms']:.3f} ms in {2 * NMT_LEN} calls "
          f"({out['kernel6_share']:.2%} of the batch); kernel 6 alone at "
          f"B {b}, H {H} ({live} live rows): ms {k['ms']:.4f}  bound_ms "
          f"{k['bound_ms']:.4f} ({k['bound_by']}, 3xTF32 at the TF32 "
          f"peak)  plain_ms {k['plain_ms']:.4f}  library_ms none; the "
          f"products alone (torch.addmm) {k['addmm_ms']:.4f}", flush=True)
    return out


def _gen_cli(values, ids_k) -> dict:
    """``python -m paddle_tpu_torch train --job=gen`` in a subprocess on
    the card, from a snapshot the port's writer saved and a config whose
    ``gen_reader`` yields this batch: its ids must equal the in-process
    kernel route's."""
    from paddle_tpu_torch.io import checkpoint

    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="gen_")
    try:
        t0 = time.perf_counter()
        checkpoint.save_params(os.path.join(tmp, "ck"), values)
        save_s = time.perf_counter() - t0
        cfg = os.path.join(tmp, "gen_cfg.py")
        import inspect
        with open(cfg, "w") as f:
            f.write(GEN_CONFIG.format(
                vocab=NMT_VOCAB, dim=NMT_DIM, len=NMT_LEN, beam=GEN_BEAM,
                feed=inspect.getsource(gen_feed), args=GEN_ARGS))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch", "train", "--job=gen",
             "--config", cfg, "--save_dir", os.path.join(tmp, "ck"),
             "--device", "cuda"],
            cwd=root, env={**os.environ, "PYTHONPATH": root},
            capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lines = [json.loads(l) for l in proc.stdout.splitlines()
             if l.startswith('{"ids"')]
    if proc.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"train --job=gen: rc {proc.returncode}, "
                             f"{len(lines)} ids lines; stderr "
                             f"{proc.stderr[-2000:]}")
    got = np.asarray(lines[0]["ids"])
    if not np.array_equal(got, ids_k.cpu().numpy()):
        raise AssertionError(f"train --job=gen's ids differ from the "
                             f"in-process ones in "
                             f"{int((got != ids_k.cpu().numpy()).sum())} "
                             f"places")
    print(f"train --job=gen on the card from the port's snapshot "
          f"(written in {save_s:.2f} s): one ids line, equal to the "
          f"in-process ids; the subprocess took {cli_s:.1f} s", flush=True)
    return {"ids_equal": True, "save_s": save_s, "subprocess_s": cli_s}


def _item9_configs(paddle):
    """Item 9's other layers at small sizes: (name, outputs, feed,
    options), each feed from a numpy seed."""
    layer, dt = paddle.layer, paddle.data_type
    rng = np.random.RandomState(SEED + 9)
    out = []
    # a nested group with an inner group of GRU steps
    doc = layer.data("doc", dt.dense_vector_sub_sequence(12, sub_max=3,
                                                         max_len=6))

    def outer(sent):
        def inner(word):
            mem = layer.memory(name="w_s", size=8)
            gates = layer.fc([word, mem], 24, bias_attr=False, name="w_g")
            return layer.gru_step_layer(gates, mem, name="w_s")

        acc = layer.memory(name="acc", size=8)
        h = layer.fc(layer.last_seq(layer.recurrent_group(
            inner, sent, name="words")), 8, act="tanh", name="sent_fc")
        return layer.addto([h, acc], act="linear", name="acc")

    sub = rng.randint(1, 7, (8, 3))
    outer_len = rng.randint(1, 4, 8)
    sub[np.arange(3)[None, :] >= outer_len[:, None]] = 0
    out.append(("nested group", [layer.recurrent_group(
        outer, layer.SubsequenceInput(doc), name="docs")],
        {"doc": rng.standard_normal((8, 3, 6, 12)).astype(np.float32),
         "doc@len": outer_len.astype(np.int32),
         "doc@sublen": sub.astype(np.int32)}, {}))
    # mdlstmemory on a 3 x 4 grid, the second dim reversed
    grid = layer.data("grid", dt.dense_vector_sequence(40, max_len=12))
    out.append(("mdlstmemory", [layer.mdlstmemory(
        grid, directions=(True, False), grid_dims=(3, 4), name="md")],
        {"grid": rng.standard_normal((8, 12, 40)).astype(np.float32) * 0.5,
         "grid@len": rng.randint(1, 13, 8).astype(np.int32)}, {}))
    # sub_seq and sub_nested_seq over one padded sequence
    s = layer.data("s", dt.dense_vector_sequence(6, max_len=10))
    sc = layer.data("sc", dt.dense_vector_sequence(1, max_len=10))
    off = layer.data("off", dt.dense_vector(1))
    size = layer.data("size", dt.dense_vector(1))
    lens = rng.randint(1, 11, 8).astype(np.int32)
    out.append(("sub_seq, sub_nested_seq", [
        layer.fc(layer.sub_seq(s, off, size, name="sub"), 4, name="sub_fc"),
        layer.fc(layer.sub_nested_seq(s, sc, k=4, name="sel"), 4,
                 name="sel_fc")],
        {"s": rng.standard_normal((8, 10, 6)).astype(np.float32),
         "s@len": lens, "sc": rng.standard_normal((8, 10, 1)).astype(
             np.float32), "sc@len": lens,
         "off": rng.randint(-2, 6, (8, 1)).astype(np.float32),
         "size": rng.randint(1, 8, (8, 1)).astype(np.float32)}, {}))
    # batch norm inside a group (full-length sequences)
    bx = layer.data("bx", dt.dense_vector_sequence(6, max_len=5))

    def bn_step(ipt):
        return layer.batch_norm(layer.fc(ipt, 8, name="bn_fc"), act="relu",
                                name="bn_in_grp")

    out.append(("batch_norm in a group", [layer.recurrent_group(
        bn_step, bx, name="bgrp")],
        {"bx": rng.standard_normal((16, 5, 6)).astype(np.float32)}, {}))
    # a GRU step under rnn_group_remat
    rx = layer.data("rx", dt.dense_vector_sequence(10, max_len=8))

    def r_step(ipt):
        mem = layer.memory(name="r_s", size=16)
        gates = layer.fc([ipt, mem], 48, bias_attr=False, name="r_g")
        return layer.gru_step_layer(gates, mem, name="r_s")

    out.append(("a step under rnn_group_remat", [layer.recurrent_group(
        r_step, rx, name="rgrp")],
        {"rx": rng.standard_normal((8, 8, 10)).astype(np.float32),
         "rx@len": rng.randint(1, 9, 8).astype(np.int32)},
        {"rnn_group_remat": True}))
    return out


def _rel_max_err(a, ref) -> float:
    return ((a.detach().float().cpu() - ref.detach().float()).abs().max()
            .item() / max(1.0, ref.detach().abs().max().item()))


def _item9_run(paddle, idx, device, configs=None):
    """Config ``idx`` of ``configs`` (``_item9_configs``) on ``device``:
    its outputs, the gradients of sum(output * a seeded cotangent) with
    respect to every parameter and float feed, and its new running
    state."""
    from paddle_tpu_torch.core import config

    _fresh(paddle)
    name, outs, feed, opts = (configs or _item9_configs)(paddle)[idx]
    topo = paddle.Topology(outs)
    values = seeded_values(topo, SEED + 10)
    params = paddle.parameters.from_numpy(topo, values, device=device).values
    wrt = {f"{l}.{p}": t.requires_grad_(True)
           for l, ps in params.items() for p, t in ps.items()}
    tfeed = {}
    for k, a in feed.items():
        t = torch.as_tensor(a, device=device)
        if t.dtype == torch.float32 and "@" not in k:
            wrt[f"feed {k}"] = t.requires_grad_(True)
        tfeed[k] = t
    for opt, v in opts.items():
        config.set_option(opt, v)
    try:
        vals, state = topo.forward(params, topo.create_state(device=device),
                                   tfeed, train=True, device=device)
    finally:
        for opt in opts:
            config.set_option(opt, False)
    rng = np.random.RandomState(SEED + 11)
    total = sum((v * torch.as_tensor(rng.standard_normal(tuple(v.shape))
                                     .astype(np.float32), device=device))
                .sum() for v in vals.values())
    grads = torch.autograd.grad(total, list(wrt.values()), allow_unused=True)
    return name, vals, dict(zip(wrt, grads)), state


def _item9_card() -> dict:
    """Each of item 9's other layers forward and backward on the card
    against the same port code on the CPU, every output, gradient and
    state entry within ITEM9_TOL of max(1, max |cpu|)."""
    out = _configs_card(_item9_configs)
    out["text_lstm"] = _text_lstm_card()
    return out


def _configs_card(configs) -> dict:
    """Each of ``configs``' small layer configs (``_item9_configs``'
    form) forward and backward on the card against the same port code on
    the CPU (``_item9_run``), every output, gradient and state entry
    within ITEM9_TOL of max(1, max |cpu|)."""
    import paddle_tpu_torch as paddle

    out = {}
    _fresh(paddle)
    for idx in range(len(configs(paddle))):
        name, vc, gc, sc = _item9_run(paddle, idx, "cuda", configs)
        _, vr, gr, sr = _item9_run(paddle, idx, "cpu", configs)
        errs = {f"out {n}": _rel_max_err(vc[n], vr[n]) for n in vr}
        errs.update({k: (0.0 if gr[k] is None else
                         _rel_max_err(gc[k], gr[k])) for k in gr})
        errs.update({f"state {l}.{k}": _rel_max_err(sc[l][k], sr[l][k])
                     for l, ks in sr.items() for k in ks})
        worst = max(errs.items(), key=lambda kv: kv[1])
        if not worst[1] <= ITEM9_TOL:
            raise AssertionError(f"{name} on the card vs the CPU: "
                                 f"{worst[0]} {worst[1]} > {ITEM9_TOL}")
        print(f"{name} on the card vs the CPU: {len(errs)} outputs, "
              f"gradients and state entries, worst {worst[0]} at "
              f"{worst[1]:.2e} of max(1, max |cpu|) (limit {ITEM9_TOL:.0e})",
              flush=True)
        out[name] = {"worst": worst[1], "of": worst[0], "checked": len(errs)}
    return out


class _MaxTies:
    """The positions the sequence max pool (``torch.amax`` over time)
    picks on the card, recorded, and followed on the CPU.  Two of a
    pool's values within a float32 rounding of each other (about 20 of
    its 16,384 maxima a text_lstm batch lie within 1e-6) can be picked
    the other way by the other device's rounding, which sends the
    gradient down another time step: the same function, another routing
    (read on the H100 in a whole run: 2.1e-5 on the embedding's gradient,
    1.6e-4 on the third Adam loss; alone 3e-10).  The CPU takes the
    card's pick only where it is one of its own maxima to within
    ITEM9_TOL of max(1, |max|); the count of such picks is reported."""

    def __init__(self):
        self.picks = []
        self.followed = 0

    @contextlib.contextmanager
    def _patched(self, fn):
        real = torch.amax
        torch.amax = fn
        try:
            yield
        finally:
            torch.amax = real

    def recording(self):
        real = torch.amax

        def rec(x, dim, keepdim=False):
            self.picks.append(x.detach().argmax(dim, keepdim=True).cpu())
            return real(x, dim, keepdim=keepdim)
        return self._patched(rec)

    def following(self):
        real = torch.amax
        it = iter(self.picks)

        def follow(x, dim, keepdim=False):
            idx = next(it).to(x.device)
            own = real(x, dim, keepdim=True)
            got = x.gather(dim, idx)
            gap = (own - got).detach()
            if not (gap <= ITEM9_TOL * own.detach().abs().clamp_min(1.0)
                    ).all():
                raise AssertionError(f"the card's max-pool pick lies "
                                     f"{gap.max().item()} below the CPU's "
                                     f"max")
            self.followed += int((gap > 0).sum())
            return got if keepdim else got.squeeze(dim)
        return self._patched(follow)


def _text_lstm_card() -> dict:
    """``models/text_lstm.py`` at its default widths (vocab 10000, emb
    128, two peephole LSTMs of 512, the plain step) on
    ``imdb.train(synthetic=True)`` batches of TEXT_LSTM_BATCH: the first
    batch's loss and gradients, then TEXT_LSTM_STEPS Adam steps, on the
    card against the CPU, the CPU's max pool following the card's picks
    at near ties (``_MaxTies``)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import text_lstm

    runs = {}
    ties = _MaxTies()
    for device in ("cuda", "cpu"):
        _fresh(paddle)
        cost, _ = text_lstm.build()
        topo = paddle.Topology(cost)
        values = seeded_values(topo, SEED + 12)
        reader = paddle.batch(paddle.dataset.imdb.train(synthetic=True),
                              TEXT_LSTM_BATCH)
        feeder = paddle.data_feeder.DataFeeder(topo, {"words": 0,
                                                      "label": 1})
        feeds = [feeder.feed(b) for _, b in zip(range(TEXT_LSTM_STEPS),
                                                 reader())]
        tr = paddle.trainer.SGD(
            topo, paddle.parameters.from_numpy(topo, values, device=device),
            paddle.optimizer.Adam(learning_rate=1e-3, epsilon=1e-6),
            device=device)
        losses = []
        with (ties.recording() if device == "cuda" else ties.following()):
            loss, grads = tr.forward_backward(feeds[0])
            tr.train(lambda: iter(feeds), event_handler=lambda e: (
                losses.append(e.cost)
                if isinstance(e, paddle.event.EndIteration) else None))
        runs[device] = (float(loss), grads, losses)
    (loss_c, g_c, l_c), (loss_r, g_r, l_r) = runs["cuda"], runs["cpu"]
    errs = {"first loss": _rel(loss_c, loss_r)}
    errs.update({f"grad {l}.{p}": _rel_max_err(g_c[l][p], g)
                 for l, ps in g_r.items() for p, g in ps.items()})
    errs.update({f"loss {i}": _rel(a, b) for i, (a, b) in
                 enumerate(zip(l_c, l_r))})
    worst = max(errs.items(), key=lambda kv: kv[1])
    if len(l_c) != TEXT_LSTM_STEPS or not worst[1] <= ITEM9_TOL:
        raise AssertionError(f"text_lstm on the card vs the CPU: {worst} "
                             f"(losses {l_c} vs {l_r})")
    print(f"text_lstm (default widths, imdb synthetic, batch "
          f"{TEXT_LSTM_BATCH}) on the card vs the CPU: first loss "
          f"{loss_c:.6f} vs {loss_r:.6f}, {TEXT_LSTM_STEPS} Adam losses "
          f"{[round(x, 6) for x in l_c]} vs {[round(x, 6) for x in l_r]}; "
          f"worst {worst[0]} at {worst[1]:.2e} (limit {ITEM9_TOL:.0e}, of "
          f"max(1, max |cpu|) for gradients, relative for losses); the "
          f"CPU's max pool followed the card's pick at {ties.followed} "
          f"near ties in {len(ties.picks)} pools", flush=True)
    return {"worst": worst[1], "of": worst[0], "losses": l_c,
            "ties_followed": ties.followed}


def gen_slice(trained=None) -> dict:
    """Phase 20: NMT generation at ``bench_nmt``'s full width through
    kernel 6, the ``train --job=gen`` entry point, and item 9's other
    layers on the card (the holds of the module docstring)."""
    import paddle_tpu_torch as paddle

    if trained is None:
        trained = nmt_trained_values()
    topo = gen_model(paddle)
    dev = torch.device("cuda")
    params = {l: {p: torch.from_numpy(v).to(dev) for p, v in ps.items()}
              for l, ps in trained.items()}
    feed = gen_feed(*GEN_ARGS)
    with torch.no_grad():
        ids_k, fr_calls, parity = _gen_routes(topo, params, feed)
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        times = _gen_times(topo, params, feed, fr_calls, flush)
        del flush
    cli = _gen_cli(trained, ids_k)
    del params
    torch.cuda.empty_cache()
    item9 = _item9_card()
    return {"launches": 2 * NMT_LEN, "parity": parity, "times": times,
            "cli": cli, "item9": item9,
            "shape": {"batch": GEN_BATCH, "beam": GEN_BEAM,
                      "src_len": NMT_LEN, "max_length": NMT_LEN,
                      "vocab": NMT_VOCAB, "dim": NMT_DIM}}


GEN_PHASES = {"gen": gen_slice}


# ------------------------------------------------------ the vision slice
# VGG-19 with batch norm, the upstream image benchmark's model
# (BASELINE.md:22: batch 64), on synthetic flowers (102 classes) at 224 px
VGG_DEPTH, VGG_IMAGE, VGG_CLASSES = 19, 224, 102
VGG_BATCH, VGG_STEPS, VGG_LR, VGG_PARITY_BATCH = 64, 4, 0.01, 8
VGG_PARITY_LRS = (0.01, 3e-3, 1e-3)   # the parity trajectory's, largest first
VGG_BNS = 16          # relu batch norms: kernels 7a and 7b, one each a BN
VGG_PER_PASS = {"matmul_stats": 0, "conv3x3_stats": 0,
                "bn_fwd_stats": VGG_BNS, "bn_bwd_stats": VGG_BNS}
# the upstream K40m benchmark's other two image models (BASELINE.md:10-15)
VISION_MODELS = {"AlexNet": ("alexnet", 227), "GoogLeNet": ("googlenet", 224)}
VISION_BATCH, VISION_CLASSES, VISION_STEPS, VISION_LR = 128, 1000, 4, 0.01
VISION_CPU_BATCH = 2
# the card against the CPU on one model's first step: the loss (relative)
# and every gradient (of max(1, max |cpu|)); float32 both, TF32 off.
# AlexNet's 5x5 grouped conv2's weight gradient, cuDNN's algorithm of its
# own choosing, read 1.7e-4, 2.1e-4 and 3.1e-4 off the CPU's in three runs
# on the H100, every other gradient within 1.4e-6 (which algorithm is not
# measured; cuDNN does pick FFT ones, whose float32 error is larger: VGG's
# profile holds complex GEMMs).  GoogLeNet's gradients move up to 8.9e-4
# between the CPU's own runs on images nudged by 2^-22 (its spread)
VISION_LOSS_TOL, VISION_GRAD_TOL = 1e-5, 1e-3
# the kernels of bn_stats.cu and stat_reduce.cuh in a profiler trace
BN_KERNEL_KEYS = ("fwd_partial_kernel", "bwd_partial_kernel",
                  "stat_reduce::")


def _vgg_stage(lname) -> str:
    return lname[:5] if lname.startswith("conv") else "head"


def vgg_model():
    """VGG-19 with batch norm at full width (224 px, flowers' 102
    classes) through the DSL, ``fused_bn_impl="pallas"``: its 16 relu
    batch norms on kernels 7a and 7b."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import vgg

    _fresh(paddle)
    paddle.init(seed=SEED, fused_bn_impl="pallas")
    _policy("fp32")
    cost, _ = vgg.build(depth=VGG_DEPTH, image_size=VGG_IMAGE,
                        num_classes=VGG_CLASSES, with_bn=True)
    return paddle, paddle.Topology(cost)


def _image_feed(samples) -> dict:
    """A feed of (HWC image, label) samples, as the DataFeeder makes it."""
    return {"image": np.stack([s[0] for s in samples]).astype(np.float32),
            "label": np.asarray([s[1] for s in samples], np.int32)}


def _bn_share(prof) -> float:
    return sum(ms for kname, (ms, _) in prof["per_name"].items()
               if any(k in kname for k in BN_KERNEL_KEYS))


def _vgg_train(paddle, topo, values, samples, policy) -> dict:
    """VGG_STEPS Momentum steps of ``trainer.SGD.train`` under ``policy``
    on the flowers samples, batched by the port's reader and fed through
    the DataFeeder; the counts set to 0 just before and read just after:
    kernels 7a and 7b (the ``policy``'s instance) VGG_BNS launches each a
    step and no other instance; then one step under ``torch.profiler``."""
    _policy(policy)
    sfx = "" if policy == "fp32" else "_bf16"
    trainer = paddle.trainer.SGD(topo, paddle.parameters.from_numpy(
        topo, values), paddle.optimizer.Momentum(learning_rate=VGG_LR,
                                                 momentum=0.9))
    name = f"VGG-{VGG_DEPTH} {policy}"
    losses, step_s, warm, peak_gb, launches = train_steps(
        name, paddle, trainer, None, VGG_STEPS, f"bn_fwd_stats{sfx}",
        VGG_BNS, falling=False,
        reader=paddle.batch(lambda: iter(samples), VGG_BATCH),
        feeding={"image": 0, "label": 1})
    per_step = {k: launches[f"{k}{sfx}"] / VGG_STEPS
                for k in ("bn_fwd_stats", "bn_bwd_stats")}
    # every launch at each instance: float32, bf16, float16
    by_dtype = {k: {"f32": launches[k] - launches[f"{k}_bf16"]
                    - launches[f"{k}_f16"], "bf16": launches[f"{k}_bf16"],
                    "f16": launches[f"{k}_f16"]} for k in CONV_KERNELS}
    others = {f"{k} {d}": n for k, ds in by_dtype.items()
              for d, n in ds.items()
              if n and not (k.startswith("bn_")
                            and d == ("f32" if policy == "fp32" else "bf16"))}
    if (per_step != {"bn_fwd_stats": VGG_BNS, "bn_bwd_stats": VGG_BNS}
            or others):
        raise AssertionError(f"{name}: launches a step {per_step}, the "
                             f"other instances {others}")
    prof = profile_step(trainer, _image_feed(samples[:VGG_BATCH]))
    bn_ms = _bn_share(prof)
    print(f"{name} training: {VGG_STEPS} Momentum steps (lr {VGG_LR}, "
          f"0.9) at batch {VGG_BATCH} x {VGG_IMAGE}^2 of synthetic flowers "
          f"through paddle.batch and the DataFeeder, losses "
          f"{[round(x, 5) for x in losses]}; step time first "
          f"{step_s[0] * 1e3:.1f} ms, median after it {warm * 1e3:.1f} ms = "
          f"{VGG_BATCH / warm:.1f} images/s (smoke figure, not a "
          f"benchmark); peak memory {peak_gb:.2f} GB; kernels 7a / 7b "
          f"launches a step {per_step}; one step under torch.profiler: "
          f"{prof['step_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} ms"
          + (f", idle share {prof['idle_share']:.1%}"
             if prof["idle_share"] is not None else
             ", idle share not measured (no device time)")
          + f"; kernels 7a + 7b {bn_ms:.3f} ms of device time "
          f"({bn_ms / prof['step_ms']:.2%} of the step); top kernels: "
          + "; ".join(f"{nm} x{k} {ms:.1f} ms" for nm, k, ms in prof["top"]),
          flush=True)
    del trainer
    torch.cuda.empty_cache()
    return {"losses": losses, "first_step_ms": step_s[0] * 1e3,
            "step_ms": warm * 1e3, "images_per_s": VGG_BATCH / warm,
            "peak_gb": peak_gb, "launches": launches[f"bn_fwd_stats{sfx}"],
            "launches_bwd": launches[f"bn_bwd_stats{sfx}"],
            "launches_per_step": per_step,
            "profiled_step_ms": prof["step_ms"], "busy_ms": prof["busy_ms"],
            "idle_share": prof["idle_share"], "bn_kernels_ms": bn_ms,
            "bn_kernels_share": bn_ms / prof["step_ms"]}


def bn_times(shape, x2, dout, w, b, mean, inv, flush, bounds) -> dict:
    """Kernels 7a and 7b on x2 and dout ([P, C] views of ``shape``'s NHWC
    activations) timed on the device alone (``time_ms(lead=True)``)
    beside their plain versions and the library's nearest calls
    (``torch.var_mean``; ``torch.batch_norm_backward_reduce``, which
    leaves out 7b's relu mask), and ``bounds(flops, bytes)`` of each: the
    bytes each must move and its operations."""
    from paddle_tpu_torch.ops import fused_bn as fb

    p, c = x2.shape
    es = x2.element_size()
    xn = x2.view(shape).permute(0, 3, 1, 2)
    dn = dout.view(shape).permute(0, 3, 1, 2)
    return {
        "bn_fwd_stats": dict(
            ms=time_ms(lambda: fb.bn_fwd_stats_cuda(x2), flush, lead=True),
            plain_ms=time_ms(lambda: fb._fwd_stats_ref(x2), flush,
                             lead=True),
            library_ms=time_ms(lambda: torch.var_mean(
                x2, dim=0, correction=0), flush, lead=True),
            **bounds(3.0 * p * c, es * p * c + 4.0 * 2 * c)),
        "bn_bwd_stats": dict(
            ms=time_ms(lambda: fb.bn_bwd_stats_cuda(
                dout, x2, w, b, mean, inv, True), flush, lead=True),
            plain_ms=time_ms(lambda: fb._bwd_stats_ref(
                dout, x2, w, b, mean, inv, True), flush, lead=True),
            library_ms=time_ms(lambda: torch.batch_norm_backward_reduce(
                dn, xn, mean, inv, None, True, False, False), flush,
                lead=True),
            **bounds(8.0 * p * c, es * 2 * p * c + 4.0 * 6 * c))}


def bn_kernels_at(shape, dtype, flush, gen, label=None) -> dict:
    """Kernels 7a and 7b alone at ``shape`` (by default VGG's largest,
    conv1's output; ``label`` names another) on ``dtype`` activations:
    each held against its plain version
    (TOL at float32, CONV_STAT_TOL at bf16, of max(1, max |ref|)), then
    timed (``time_ms(lead=True)``) beside its bound (the bytes each must
    move, the operations at the card's peak for the type), its plain
    version and the library's nearest call (``torch.var_mean``;
    ``torch.batch_norm_backward_reduce``, which leaves out 7b's relu
    mask)."""
    from paddle_tpu_torch.ops import fused_bn as fb

    label = label or f"VGG-{VGG_DEPTH}'s conv1"
    bf16 = dtype != torch.float32
    c = shape[-1]
    dev = torch.device("cuda")
    x2 = torch.randn(*shape, device=dev, generator=gen).view(-1, c).to(dtype)
    xf = x2.float()
    mean = xf.mean(0)
    inv = torch.rsqrt(xf.var(0, unbiased=False) + 1e-5)
    del xf
    w = torch.randn(c, device=dev, generator=gen) * 0.5 * inv
    b = torch.randn(c, device=dev, generator=gen) * 0.2 - mean * w
    dout = torch.randn(*x2.shape, device=dev, generator=gen).to(dtype)
    tol = CONV_STAT_TOL if bf16 else TOL
    tag = f"at {list(shape)}{' ' + _short(dtype) if bf16 else ''}"
    err_f = _hold(f"bn_fwd_stats {tag}", zip(
        ("sum x", "sum x^2"), fb.bn_fwd_stats_cuda(x2),
        fb._fwd_stats_ref(x2)), tol)
    err_b = _hold(f"bn_bwd_stats {tag}", zip(
        ("sum dy", "sum dy*xhat"),
        fb.bn_bwd_stats_cuda(dout, x2, w, b, mean, inv, True),
        fb._bwd_stats_ref(dout, x2, w, b, mean, inv, True)), tol)
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
    with torch.no_grad():
        out = bn_times(shape, x2, dout, w, b, mean, inv, flush,
                       lambda fl, nb: dict(zip(("bound_ms", "bound_by"),
                                               bound(fl, nb, peak))))
    library = {"bn_fwd_stats": "torch.var_mean",
               "bn_bwd_stats": "torch.batch_norm_backward_reduce, no relu "
                               "mask"}
    for (k, r), err in zip(out.items(), (err_f, err_b)):
        r.update(shape=list(shape), max_abs_err=err[0], max_rel_err=err[1])
        print(f"{k} {tag} ({label} at batch {shape[0]}): ms "
              f"{r['ms']:.4f}  bound_ms {r['bound_ms']:.4f} ({r['bound_by']}"
              f"; {r['ms'] / r['bound_ms']:.2f}x)  plain_ms "
              f"{r['plain_ms']:.4f}  library_ms {r['library_ms']:.4f} "
              f"({library[k]}); max rel err {err[1]:.2e}", flush=True)
    del x2, dout
    torch.cuda.empty_cache()
    return out


def _vgg_parity_lr(paddle, topo, values, feed, name) -> dict:
    """The Momentum rate of the parity trajectory, decided on the plain
    route alone before the routes are compared: the largest of
    VGG_PARITY_LRS at which its 3 losses do not rise, else the smallest
    (said so).  The timed training keeps VGG_LR."""
    tried = {}
    torch.backends.cudnn.deterministic = True
    try:
        _set_route(topo, False)
        for lr in VGG_PARITY_LRS:
            tr = paddle.trainer.SGD(topo, paddle.parameters.from_numpy(
                topo, values), paddle.optimizer.Momentum(
                    learning_rate=lr, momentum=0.9))
            losses = []
            tr.train(lambda: iter([feed] * 3), event_handler=lambda e: (
                losses.append(e.cost)
                if isinstance(e, paddle.event.EndIteration) else None))
            del tr
            tried[lr] = losses
            if all(b <= a for a, b in zip(losses, losses[1:])):
                break
    finally:
        _set_route(topo, True)
        torch.backends.cudnn.deterministic = False
        torch.cuda.empty_cache()
    ok = [lr for lr, ls in tried.items()
          if all(b <= a for a, b in zip(ls, ls[1:]))]
    lr = ok[0] if ok else VGG_PARITY_LRS[-1]
    print(f"{name} parity trajectory: Momentum rate {lr:g} (the plain "
          f"route's 3 losses at each rate tried: "
          f"{ {k: [round(x, 5) for x in v] for k, v in tried.items()} }"
          + ("" if ok else "; none is non-rising, so the smallest") + ")",
          flush=True)
    return {"lr": lr, "plain_losses": tried, "non_rising": bool(ok)}


def vgg_path(flush, gen) -> dict:
    """VGG-19 with batch norm at full width: kernel-route parity at batch
    VGG_PARITY_BATCH (layer by layer and end to end, ``resnet_layer_parity``
    and ``resnet_parity`` with the plain route's images nudged up and down
    by 2^-22 for float32's spread: the dropouts keep each row's mask), then
    VGG_STEPS Momentum steps at batch VGG_BATCH under ``fp32`` and under
    ``bf16`` (``_vgg_train``), then kernels 7a and 7b alone at VGG's
    largest shape at both dtypes (``bn_kernels_at``)."""
    paddle, topo = vgg_model()
    values = resnet_values(topo, SEED + 30)
    n_params = sum(v.size for ps in values.values() for v in ps.values())
    name = f"VGG-{VGG_DEPTH}"
    print(f"{name} with batch norm: {VGG_IMAGE} px, {VGG_CLASSES} classes, "
          f"{sum(s.kind == 'batch_norm' for s in topo.specs)} relu batch "
          f"norms, fused_bn_impl='pallas'; {n_params / 1e6:.1f}M float32 "
          f"parameters from a numpy seed", flush=True)
    samples = list(paddle.dataset.flowers.train(
        synthetic=True, n=VGG_BATCH * VGG_STEPS, image_size=VGG_IMAGE)())
    # the parity batch is the same in every run: images uniform in [-1, 1]
    # and labels uniform over the classes, from a numpy seed
    prng = np.random.RandomState(SEED + 32)
    parity_feed = {
        "image": prng.uniform(-1, 1, (VGG_PARITY_BATCH, VGG_IMAGE,
                                      VGG_IMAGE, 3)).astype(np.float32),
        "label": prng.randint(0, VGG_CLASSES,
                              VGG_PARITY_BATCH).astype(np.int32)}
    parity_lr = _vgg_parity_lr(paddle, topo, values, parity_feed, name)
    torch.backends.cudnn.deterministic = True
    try:
        layers = resnet_layer_parity(paddle, topo, values, parity_feed,
                                     torch.Generator(device="cuda")
                                     .manual_seed(SEED), name=name)
    finally:
        torch.backends.cudnn.deterministic = False
    parity = dict(resnet_parity(paddle, topo, values, parity_feed,
                                name=name, per_pass=VGG_PER_PASS,
                                lr=parity_lr["lr"], stage=_vgg_stage,
                                spreads=("nudged", "nudged_down")),
                  layers=layers, lr=parity_lr)
    torch.cuda.empty_cache()
    runs = {policy: _vgg_train(paddle, topo, values, samples, policy)
            for policy in ("fp32", "bf16")}
    _policy("fp32")
    alone = {_short(dt) if dt != torch.float32 else "f32": bn_kernels_at(
        (VGG_BATCH, VGG_IMAGE, VGG_IMAGE, 64), dt, flush, gen)
        for dt in (torch.float32, torch.bfloat16)}
    return {"parity": parity, **runs, "alone": alone,
            "params_m": n_params / 1e6}


def vision_model_path(label) -> dict:
    """AlexNet or GoogLeNet at the upstream benchmark's widths (1000
    classes, 227 or 224 px): one forward and backward on the card against
    the same port code on the CPU at batch VISION_CPU_BATCH from the same
    seeded weights (the card's dropout masks replayed on the CPU; the loss
    within VISION_LOSS_TOL relative, every gradient within the larger of
    VISION_GRAD_TOL and twice float32's spread of max(1, max |cpu|)), then VISION_STEPS Momentum steps on the card at
    batch VISION_BATCH: finite losses, ms a step, images/s, peak memory.
    Neither model reaches a kernel of this repo (no batch norm)."""
    import importlib

    import paddle_tpu_torch as paddle

    module, size = VISION_MODELS[label]
    _fresh(paddle)
    _policy("fp32")
    cost, _ = importlib.import_module(
        f"paddle_tpu_torch.models.{module}").build(
            image_size=size, num_classes=VISION_CLASSES)
    topo = paddle.Topology(cost)
    values = resnet_values(topo, SEED + 31)
    rng = np.random.RandomState(SEED + 32)

    def feed(b):
        return {"image": rng.rand(b, size, size, 3).astype(np.float32),
                "label": rng.randint(0, VISION_CLASSES, b).astype(np.int32)}

    small = feed(VISION_CPU_BATCH)
    draws = _Draws("rand")
    runs = {}
    for run, device, scale in (("card", "cuda", 1.0), ("cpu", "cpu", 1.0),
                               ("up", "cpu", 1 + 2 ** -22),
                               ("down", "cpu", 1 - 2 ** -22)):
        tr = paddle.trainer.SGD(
            topo, paddle.parameters.from_numpy(topo, values, device=device),
            paddle.optimizer.Momentum(learning_rate=VISION_LR, momentum=0.9),
            device=device)
        fd = dict(small, image=small["image"] * np.float32(scale))
        with (draws.recording() if device == "cuda" else draws.replaying()):
            loss, grads = tr.forward_backward(fd)
        runs[run] = (float(loss), grads)
        del tr
    (loss_c, g_c), (loss_r, g_r) = runs["card"], runs["cpu"]
    errs = {f"d {l}.{p}": _rel_max_err(g_c[l][p], g)
            for l, ps in g_r.items() for p, g in ps.items()}
    # float32's own spread for this net: the CPU on images nudged by
    # 2^-22; a max pool whose window holds two values within a rounding
    # of each other, or a relu at a value within a rounding of 0, routes
    # the gradient elsewhere, and the difference flows back to every
    # layer below
    spread = max(_rel_max_err(runs[r][1][l][p], g) for r in ("up", "down")
                 for l, ps in g_r.items() for p, g in ps.items())
    bound_ = max(VISION_GRAD_TOL, 2 * spread)
    worst = max(errs.items(), key=lambda kv: kv[1])
    loss_err = _rel(loss_c, loss_r)
    if not (loss_err <= VISION_LOSS_TOL and worst[1] <= bound_):
        raise AssertionError(
            f"{label} on the card vs the CPU: loss {loss_c} vs {loss_r} "
            f"({loss_err:.2e}), worst gradient {worst}, beyond the larger "
            f"of {VISION_GRAD_TOL} and twice float32's spread {spread:.2e}; "
            f"the five worst " + ", ".join(
                f"{k} {v:.1e}" for k, v in sorted(
                    errs.items(), key=lambda kv: -kv[1])[:5]))
    print(f"{label} ({size} px, {VISION_CLASSES} classes) on the card vs "
          f"the CPU at batch {VISION_CPU_BATCH}, TF32 off, the same dropout "
          f"masks: loss {loss_c:.6f} vs {loss_r:.6f} ({loss_err:.2e} "
          f"relative, limit {VISION_LOSS_TOL:.0e}); worst of {len(errs)} "
          f"gradients {worst[0]} at {worst[1]:.2e} of max(1, max |cpu|) "
          f"(limit the larger of {VISION_GRAD_TOL:.0e} and twice float32's "
          f"spread, the CPU on images nudged by 2^-22: {spread:.2e}); "
          f"{sum(v > 1e-4 for v in errs.values())} beyond 1e-4, the "
          f"worst five " + ", ".join(f"{k} {v:.1e}" for k, v in sorted(
              errs.items(), key=lambda kv: -kv[1])[:5]), flush=True)
    del runs, g_c, g_r
    trainer = paddle.trainer.SGD(topo, paddle.parameters.from_numpy(
        topo, values), paddle.optimizer.Momentum(learning_rate=VISION_LR,
                                                 momentum=0.9))
    losses, step_s, warm, peak_gb, _ = train_steps(
        label, paddle, trainer, feed(VISION_BATCH), VISION_STEPS,
        "bn_fwd_stats", 0, falling=False)
    print(f"{label} training: {VISION_STEPS} Momentum steps (lr "
          f"{VISION_LR}, 0.9) at batch {VISION_BATCH} x {size}^2, float32, "
          f"losses {[round(x, 5) for x in losses]}; step time first "
          f"{step_s[0] * 1e3:.1f} ms, median after it {warm * 1e3:.1f} ms = "
          f"{VISION_BATCH / warm:.1f} images/s (smoke figure, not a "
          f"benchmark); peak memory {peak_gb:.2f} GB", flush=True)
    del trainer
    torch.cuda.empty_cache()
    return {"card_vs_cpu": {"loss_rel": loss_err, "grad_worst": worst[1],
                            "at": worst[0], "spread": spread},
            "losses": losses, "first_step_ms": step_s[0] * 1e3,
            "step_ms": warm * 1e3, "images_per_s": VISION_BATCH / warm,
            "peak_gb": peak_gb}


def _vision_layer_configs(paddle):
    """The conv slice's layers without a kernel at small sizes:
    (name, outputs, feed, options) as ``_item9_configs``, each feed from
    a numpy seed."""
    layer, dt = paddle.layer, paddle.data_type
    rng = np.random.RandomState(SEED + 33)

    def image(name, c, h, w, b=4):
        x = layer.data(name, dt.dense_vector(c * h * w), height=h, width=w)
        return x, {name: rng.standard_normal((b, h, w, c)).astype(
            np.float32)}

    def volume(name, shape, b=4):
        x = layer.LayerOutput("data", [], {
            "shape": list(shape), "seq_type": 0, "is_index": False,
            "dim": int(np.prod(shape))}, name=name)
        return x, {name: rng.standard_normal((b,) + shape).astype(
            np.float32)}

    out = []
    x, fd = image("ct_in", 16, 9, 11)
    out.append(("conv_transpose stride 2", [layer.img_conv_transpose(
        x, filter_size=3, num_filters=24, stride=2, padding=1,
        name="deconv")], fd, {}))
    x, fd = image("bi_in", 8, 16, 15)
    c = layer.img_conv(x, filter_size=3, num_filters=12, padding=1,
                       name="bi_conv")
    out.append(("bilinear_interp shrinking (antialiased)", [
        layer.bilinear_interp(c, 6, 7, name="shrink")], fd, {}))
    x, fd = image("spp_in", 6, 13, 10)
    c = layer.img_conv(x, filter_size=3, num_filters=8, padding=1,
                       name="spp_conv")
    out.append(("spp max and avg at H 13, W 10", [
        layer.spp(c, pyramid_height=3, pool_type="max", name="spp_max"),
        layer.spp(c, pyramid_height=3, pool_type="avg", name="spp_avg")],
        fd, {}))
    x, fd = image("misc_in", 6, 10, 9)
    c = layer.img_conv(x, filter_size=3, num_filters=12, padding=1,
                       name="misc_conv")
    mo = layer.maxout(c, groups=3, name="maxout")
    pd = layer.pad(mo, pad_c=(1, 2), pad_h=(2, 1), pad_w=(0, 3), name="pad")
    cr = layer.crop(pd, 8, 9, offset=(2, 1), name="crop")
    v = layer.fc(layer.global_pool(cr, name="gp"), size=5, name="v")
    fm = layer.LayerOutput("featmap_expand", [v], {"h": 3, "w": 4},
                           name="featmap", size=5 * 3 * 4)
    out.append(("maxout, pad, crop, featmap_expand", [cr, fm], fd, {}))
    x, fd = volume("vol", (7, 6, 8, 4))
    c3 = layer.img_conv3d(x, filter_size=3, num_filters=8, stride=2,
                          padding=1, act="relu", name="conv3d")
    d3 = layer.img_conv3d_transpose(c3, filter_size=2, num_filters=6,
                                    stride=2, name="deconv3d")
    bn = layer.batch_norm(d3, act="relu", name="bn3d")
    out.append(("conv3d, deconv3d, 3-D batch_norm, pool3d max and avg", [
        d3, bn,
        layer.img_pool3d(bn, pool_size=2, pool_type="max", name="pool3d_max"),
        layer.img_pool3d(bn, pool_size=2, pool_type="avg",
                         name="pool3d_avg")], fd, {}))
    return out


def vision_slice() -> dict:
    """Phase 21: the rest of the conv slice on the card - VGG-19 with
    batch norm through kernels 7a and 7b (``vgg_path``), AlexNet and
    GoogLeNet at the upstream benchmark's widths (``vision_model_path``),
    the new image layers small, card against CPU (``_configs_card``)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 34)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    vgg_out = vgg_path(flush, gen)
    del flush
    torch.cuda.empty_cache()
    models = {label: vision_model_path(label) for label in VISION_MODELS}
    layers = _configs_card(_vision_layer_configs)
    return {"vgg": vgg_out, "models": models, "layers": layers}


VISION_PHASES = {"vision": vision_slice}


# -------------------------------------------------------- the book slice
# semantic role labelling at the book's width (book ch. 07): word 32,
# hidden 128 (its fc 512 wide, the book's hidden_dim), depth 4
# bidirectional levels (the book's 8 LSTMs), conll05's vocabularies, T 40
SRL_WIDTH = dict(word_dim=32, hidden=128, depth=4, max_len=40)
SRL_BATCH, SRL_STEPS, SRL_LR = 128, 6, 1e-3
SRL_PER_PASS = 2 * SRL_WIDTH["depth"] * SRL_WIDTH["max_len"]     # 320
SRL_CHUNK_TYPES = 33     # conll05's 67 labels: 33 IOB types and O
OCR_WIDTH = dict(image_h=32, image_w=128, num_classes=10, hidden=128)
OCR_BATCH, OCR_STEPS, OCR_LR, OCR_MAX_LABEL = 64, 4, 1e-3, 8
# the columns after the 2x2 pool: one kernel 6 call a column each way
OCR_PER_PASS = 2 * (OCR_WIDTH["image_w"] // 2)                  # 128
SSD_WIDTH = dict(image_size=300, num_classes=21, max_gt=8)
SSD_BATCH, SSD_STEPS, SSD_LR, SSD_BNS = 32, 4, 1e-3, 4
# the four relu batch norms' activations at batch 32: kernels 7a and 7b
SSD_BN_SHAPES = ((SSD_BATCH, 300, 300, 16), (SSD_BATCH, 150, 150, 32),
                 (SSD_BATCH, 75, 75, 64), (SSD_BATCH, 38, 38, 64))
# the recommender and word2vec at the book's widths, card against CPU
REC_WIDTH = dict(emb_dim=32, tower=200)
W2V_WIDTH = dict(emb_dim=32, hidden=256, window=5)
BOOK_CPU_BATCH, BOOK_CPU_TOL = 256, 1e-5


def srl_feed(samples) -> dict:
    """A padded SRL feed from conll05 samples (words, predicate, 5
    contexts, mark, labels), the predicate repeated over the sentence as
    the JAX package's test feeds it; every sequence padded to SRL_WIDTH's
    ``max_len``, so a forward runs T = ``max_len`` steps."""
    max_len = SRL_WIDTH["max_len"]
    b = len(samples)
    lens = np.array([min(len(s[0]), max_len) for s in samples], np.int32)
    feed = {}
    for name, pick in (("word", lambda s: s[0]),
                       ("verb", lambda s: [s[1]] * len(s[0])),
                       ("mark", lambda s: s[7]), ("target", lambda s: s[8])):
        arr = np.zeros((b, max_len), np.int32)
        for i, s in enumerate(samples):
            arr[i, :lens[i]] = pick(s)[:lens[i]]
        feed[name], feed[name + "@len"] = arr, lens
    return feed


def srl_model():
    """``label_semantic_roles.build`` at SRL_WIDTH with conll05's
    vocabularies and the Chunk evaluator (IOB, SRL_CHUNK_TYPES types) over
    the decoded path.  Returns (paddle, topology over the cost and the
    decoded path)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import label_semantic_roles

    _fresh(paddle)
    cost, decoded = label_semantic_roles.build(**SRL_WIDTH)
    paddle.evaluator.chunk(input=decoded, label=cost.parents[1],
                           chunk_scheme="IOB", num_chunk_types=SRL_CHUNK_TYPES,
                           name="srl_chunk")
    return paddle, paddle.Topology([cost, decoded])


def _lstm_layer_hold(dev, gen, lens) -> dict:
    """Kernel 5 inside the LSTM layer at SRL's shape ([128, 40] steps of
    H 128, masks from the batch's real lengths ``lens``), forward and
    reversed: the kernel route against the plain step on the same
    operands, the outputs and the gradients of x and the weights (TOL of
    max(1, max |ref|)), 40 launches a direction on the kernel route."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.core import config
    from paddle_tpu_torch.core.registry import ApplyContext, get_layer_def

    b, t, hd = len(lens), SRL_WIDTH["max_len"], SRL_WIDTH["hidden"]
    ldef = get_layer_def("lstmemory")
    x = torch.randn(b, t, 4 * hd, device=dev, generator=gen)
    w = torch.randn(hd, 4 * hd, device=dev, generator=gen) * hd ** -0.5
    bias = torch.randn(4 * hd, device=dev, generator=gen) * 0.1
    mask = (torch.arange(t, device=dev)[None, :]
            < torch.as_tensor(lens, device=dev)[:, None]).float()
    cot = torch.randn(b, t, hd, device=dev, generator=gen)
    out = {}
    for reverse in (False, True):
        runs = {}
        for fused in (True, False):
            leaves = [v.clone().requires_grad_(True) for v in (x, w, bias)]
            config.set_option("use_fused_rnn", fused)
            ops.reset_launch_counts()
            try:
                y = ldef.apply_seq({"peephole": False, "reverse": reverse},
                                   {"w": leaves[1], "b": leaves[2]},
                                   [leaves[0]], [mask],
                                   ApplyContext(train=True, device=dev))
            finally:
                config.set_option("use_fused_rnn", True)
            n = ops.launch_counts()["lstm_step"]
            if n != (t if fused else 0):
                raise AssertionError(f"lstmemory reverse={reverse} "
                                     f"use_fused_rnn={fused}: {n} kernel 5 "
                                     f"launches, expected {t if fused else 0}")
            runs[fused] = (y,) + torch.autograd.grad(y, leaves, cot)
        what = f"lstmemory at [{b}, {t}] x H {hd}{' reversed' if reverse else ''}"
        err = _hold(what, zip(("y", "dx", "dw", "db"), runs[True],
                              runs[False]))
        print(f"{what}, masks of the batch's lengths {min(lens)} to "
              f"{max(lens)}: kernel 5 route ({t} launches) against the plain "
              f"step, y and the gradients of x, w and b within {err[1]:.2e} "
              f"of max(1, max |ref|) (limit {TOL})", flush=True)
        out["reverse" if reverse else "forward"] = {"max_abs_err": err[0],
                                                    "max_rel_err": err[1]}
    return out


def _srl_parity(paddle, topo, values, feed) -> dict:
    """At batch SRL_BATCH from the same weights on the card: the kernel
    route against the plain one (``use_fused_rnn=False``): the first loss
    (1e-5 relative), every parameter gradient (TOL of max(1, max |g|))
    and ``crf_decoding``'s paths (equal, or where a row differs, the two
    paths' CRF scores equal within 1e-5: a tie); kernel 5 SRL_PER_PASS
    launches a forward on the kernel route, none on the plain one."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.core import config
    from paddle_tpu_torch.layers import crf_ctc

    runs = {}
    for fused in (True, False):
        config.set_option("use_fused_rnn", fused)
        try:
            ops.reset_launch_counts()
            tr = paddle.trainer.SGD(topo, paddle.parameters.from_numpy(
                topo, values), paddle.optimizer.Adam(learning_rate=SRL_LR))
            loss, grads = tr.forward_backward(feed)
            with torch.no_grad():
                outs, _ = topo.forward(tr.parameters.values, {}, feed,
                                       outputs=["emission", "decoded"])
            n = ops.launch_counts()["lstm_step"]
            runs[fused] = (float(loss), grads, outs)
            del tr
        finally:
            config.set_option("use_fused_rnn", True)
        if n != (2 * SRL_PER_PASS if fused else 0):
            raise AssertionError(f"SRL use_fused_rnn={fused}: {n} kernel 5 "
                                 f"launches in a forward_backward and a "
                                 f"forward, expected "
                                 f"{2 * SRL_PER_PASS if fused else 0}")
    (loss_k, grads_k, outs_k), (loss_t, grads_t, outs_t) = runs[True], \
        runs[False]
    if not _rel(loss_k, loss_t) <= 1e-5:
        raise AssertionError(f"SRL first loss: kernel route {loss_k} vs "
                             f"plain {loss_t}")
    worst = max((_rel_max_err(grads_k[l][p], ref.cpu()), f"{l}.{p}")
                for l, ps in grads_t.items() for p, ref in ps.items())
    if not worst[0] <= TOL:
        raise AssertionError(f"SRL gradient {worst[1]}: kernel route vs "
                             f"plain {worst[0]} > {TOL}")
    path_k, path_t = outs_k["decoded"], outs_t["decoded"]
    rows = (path_k != path_t).any(1).nonzero().flatten().tolist()
    w = values["crf"]["w"]
    w = torch.as_tensor(w, device=path_t.device)
    mask = (torch.arange(path_t.shape[1], device=path_t.device)[None, :]
            < torch.as_tensor(feed["word@len"],
                              device=path_t.device)[:, None]).float()
    em = outs_t["emission"].float()
    gap = 0.0
    if rows:
        # each path's negative log-likelihood under the plain route's
        # emissions: equal scores (a tie) is the only difference allowed
        nk = crf_ctc.crf_nll(em[rows], path_k[rows].long(), mask[rows],
                             w[0], w[1], w[2:])
        nt = crf_ctc.crf_nll(em[rows], path_t[rows].long(), mask[rows],
                             w[0], w[1], w[2:])
        gap = ((nk - nt).abs() / nt.abs().clamp(min=1.0)).max().item()
        if not gap <= 1e-5:
            raise AssertionError(f"SRL decoded paths differ in rows {rows} "
                                 f"by {gap} of their CRF scores")
    print(f"SRL parity at batch {SRL_BATCH}, kernel route vs "
          f"use_fused_rnn=False: first loss {loss_k:.6f} vs {loss_t:.6f} "
          f"({_rel(loss_k, loss_t):.2e} relative); worst gradient "
          f"{worst[1]} at {worst[0]:.2e} of max(1, max |g|); decoded paths "
          f"{'equal' if not rows else f'differ in {len(rows)} rows, ties within {gap:.1e}'}"
          f"; kernel 5 {SRL_PER_PASS} launches a forward", flush=True)
    return {"loss_rel": _rel(loss_k, loss_t), "grad_rel": worst[0],
            "grad_at": worst[1], "path_rows_differing": len(rows),
            "path_tie_gap": gap}


def _srl_train(paddle, topo, values, feed, policy) -> dict:
    """SRL_STEPS Adam steps under ``policy`` on one batch of synthetic
    conll05 (its labels are learnt over many passes; on one batch the
    loss falls step by step): kernel 5 (the policy's instance)
    SRL_PER_PASS launches a step, the loss falling, Chunk's precision,
    recall and F1 at the pass's end; then one step under
    ``torch.profiler``."""
    _policy(policy)
    sfx = "" if policy == "fp32" else "_bf16"
    trainer = paddle.trainer.SGD(topo, paddle.parameters.from_numpy(
        topo, values), paddle.optimizer.Adam(learning_rate=SRL_LR))
    metrics = {}
    name = f"SRL {policy}"
    losses, step_s, warm, peak_gb, launches = train_steps(
        name, paddle, trainer, feed, SRL_STEPS, f"lstm_step{sfx}",
        SRL_PER_PASS, metrics=metrics)
    if launches["lstm_step"] != launches[f"lstm_step{sfx}"]:
        raise AssertionError(f"{name}: kernel 5 launches of another "
                             f"instance: {launches}")
    prof = profile_step(trainer, feed, LSTM_KERNEL)
    toks = float(feed["word@len"].sum())
    chunk = {k.split(".")[-1]: v for k, v in metrics.items()
             if k.startswith("srl_chunk")}
    print(f"{name} training: {SRL_STEPS} Adam steps (lr {SRL_LR}) at batch "
          f"{SRL_BATCH} x T {SRL_WIDTH['max_len']} of synthetic conll05 "
          f"(one batch), "
          f"losses {[round(x, 4) for x in losses]}; step time first "
          f"{step_s[0] * 1e3:.1f} ms, median after it {warm * 1e3:.1f} ms = "
          f"{toks / warm:.0f} real tokens/s ({toks:.0f} a batch; "
          f"{SRL_BATCH * SRL_WIDTH['max_len'] / warm:.0f} padded; smoke "
          f"figure, not a benchmark); peak memory {peak_gb:.2f} GB; kernel 5 "
          f"launches a step {launches[f'lstm_step{sfx}'] // SRL_STEPS}; "
          f"chunk (IOB, {SRL_CHUNK_TYPES} types) at the pass's end "
          f"{chunk}; " + _route_profile(prof) + "; top kernels: "
          + "; ".join(f"{nm} x{k} {ms:.2f} ms" for nm, k, ms in prof["top"]),
          flush=True)
    del trainer
    return {"losses": losses, "first_step_ms": step_s[0] * 1e3,
            "step_ms": warm * 1e3, "tokens_per_s": toks / warm,
            "padded_tokens_per_s": SRL_BATCH * SRL_WIDTH["max_len"] / warm,
            "peak_gb": peak_gb, "launches": launches[f"lstm_step{sfx}"],
            "chunk": chunk, "idle_share": prof["idle_share"],
            "kernel_ms": prof["matched_ms"], "busy_ms": prof["busy_ms"],
            "profiled_step_ms": prof["step_ms"],
            "kernel_share": prof["matched_ms"] / prof["step_ms"],
            "top": prof["top"]}


def srl_path(flush, gen) -> dict:
    """SRL at the book's width: kernel 5 at [128, 128] against its plain
    step (``_rnn_check``) and inside the layer forward and reversed with
    the batch's masks (``_lstm_layer_hold``), timed beside its bound
    (``rnn_step_times``); the kernel route against the plain one
    (``_srl_parity``); SRL_STEPS Adam steps under ``fp32`` and ``bf16``
    (``_srl_train``)."""
    paddle, topo = srl_model()
    values = seeded_values(topo, SEED + 40)
    n_params = sum(v.size for ps in values.values() for v in ps.values())
    feed = srl_feed(list(paddle.dataset.conll05.test(n=SRL_BATCH)()))
    print(f"SRL (label_semantic_roles) at {SRL_WIDTH}, conll05's "
          f"vocabularies ({paddle.dataset.conll05.WORD_VOCAB} words, "
          f"{paddle.dataset.conll05.LABEL_COUNT} labels): "
          f"{sum(s.kind == 'lstmemory' for s in topo.specs)} LSTMs, "
          f"{n_params / 1e6:.2f}M float32 parameters from a numpy seed",
          flush=True)
    _policy("fp32")
    b, hd = SRL_BATCH, SRL_WIDTH["hidden"]
    errs = _rnn_check("lstm", b, hd, torch.device("cuda"), gen)
    layer_hold = _lstm_layer_hold(torch.device("cuda"), gen,
                                  feed["word@len"])
    times = rnn_step_times("lstm", b, hd, torch.device("cuda"), gen, flush)
    times.update(max_abs_err=errs[0], max_rel_err=errs[1], tf32=errs[2],
                 layer=layer_hold)
    parity = _srl_parity(paddle, topo, values, feed)
    torch.cuda.empty_cache()
    runs = {policy: _srl_train(paddle, topo, values, feed, policy)
            for policy in ("fp32", "bf16")}
    _policy("fp32")
    return {"kernel5": times, "parity": parity, **runs,
            "params_m": n_params / 1e6}


def ocr_feed(rng, b) -> dict:
    """Images whose column stripes encode a digit sequence (2 to
    OCR_MAX_LABEL digits, a stripe of image_w / OCR_MAX_LABEL columns
    each, brightness by digit), the digits as the label sequence."""
    h, w = OCR_WIDTH["image_h"], OCR_WIDTH["image_w"]
    stripe = w // OCR_MAX_LABEL
    imgs = rng.rand(b, h, w, 1).astype(np.float32) * 0.1
    lab = np.zeros((b, OCR_MAX_LABEL), np.int32)
    lens = rng.randint(2, OCR_MAX_LABEL + 1, b).astype(np.int32)
    for i in range(b):
        digits = rng.randint(0, OCR_WIDTH["num_classes"], lens[i])
        lab[i, :lens[i]] = digits
        for j, d in enumerate(digits):
            imgs[i, :, j * stripe:(j + 1) * stripe, 0] += (d + 1) / 11.0
    return {"image": imgs, "label": lab, "label@len": lens}


def ocr_path(flush, gen) -> dict:
    """OCR with CTC at image 32 x 128, hidden 128: kernel 6 at [64, 128]
    against its plain step and timed; OCR_STEPS Adam steps at batch
    OCR_BATCH with OCR_PER_PASS kernel 6 calls a step; CTCError at the
    pass's end."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import ocr_ctc

    dev = torch.device("cuda")
    _policy("fp32")
    errs = _rnn_check("gru", OCR_BATCH, OCR_WIDTH["hidden"], dev, gen)
    times = rnn_step_times("gru", OCR_BATCH, OCR_WIDTH["hidden"], dev, gen,
                           flush)
    times.update(max_abs_err=errs[0], max_rel_err=errs[1], tf32=errs[2])
    _fresh(paddle)
    cost, frames = ocr_ctc.build(**OCR_WIDTH)
    paddle.evaluator.ctc_error(input=frames, label=cost.parents[1],
                               blank=OCR_WIDTH["num_classes"],
                               name="ocr_ctc_error")
    topo = paddle.Topology(cost)
    values = seeded_values(topo, SEED + 41)
    rng = np.random.RandomState(SEED + 42)
    feeds = [ocr_feed(rng, OCR_BATCH) for _ in range(OCR_STEPS)]
    trainer = paddle.trainer.SGD(topo, paddle.parameters.from_numpy(
        topo, values), paddle.optimizer.Adam(learning_rate=OCR_LR))
    metrics = {}
    losses, step_s, warm, peak_gb, launches = train_steps(
        "OCR-CTC", paddle, trainer, None, OCR_STEPS, "gru_step",
        OCR_PER_PASS, falling=False, reader=lambda: iter(feeds),
        metrics=metrics)
    print(f"OCR-CTC training: {OCR_STEPS} Adam steps (lr {OCR_LR}) at batch "
          f"{OCR_BATCH} x {OCR_WIDTH['image_h']} x {OCR_WIDTH['image_w']}, "
          f"{OCR_PER_PASS // 2} columns of time, losses "
          f"{[round(x, 4) for x in losses]}; step time first "
          f"{step_s[0] * 1e3:.1f} ms, median after it {warm * 1e3:.1f} ms = "
          f"{OCR_BATCH / warm:.0f} images/s (smoke figure); peak memory "
          f"{peak_gb:.2f} GB; kernel 6 calls a step "
          f"{launches['gru_step'] // OCR_STEPS}; CTCError at the pass's end "
          f"{metrics}", flush=True)
    del trainer
    return {"kernel6": times, "losses": losses, "step_ms": warm * 1e3,
            "first_step_ms": step_s[0] * 1e3, "images_per_s":
            OCR_BATCH / warm, "peak_gb": peak_gb,
            "launches": launches["gru_step"], "ctc_error": metrics}


def ssd_feed(rng, b) -> dict:
    """Synthetic detection images: 1 to max_gt boxes an image, each
    painted in its class's colour on a dark noisy background, the other
    ground-truth slots -1."""
    size, classes, g = (SSD_WIDTH["image_size"], SSD_WIDTH["num_classes"],
                        SSD_WIDTH["max_gt"])
    palette = np.random.RandomState(SEED).rand(classes, 3).astype(np.float32)
    img = rng.rand(b, size, size, 3).astype(np.float32) * 0.2
    gt = np.zeros((b, g, 4), np.float32)
    gl = np.full((b, g), -1.0, np.float32)
    for i in range(b):
        for j in range(rng.randint(1, g + 1)):
            bw, bh = rng.uniform(0.1, 0.5, 2)
            x1, y1 = rng.uniform(0, 1 - bw), rng.uniform(0, 1 - bh)
            c = rng.randint(1, classes)
            gt[i, j] = [x1, y1, x1 + bw, y1 + bh]
            gl[i, j] = c
            img[i, int(y1 * size):int((y1 + bh) * size),
                int(x1 * size):int((x1 + bw) * size)] = palette[c]
    return {"image": img, "gt_box": gt.reshape(b, -1), "gt_label": gl}


def _nms_without_sync(paddle, topo, params, feed) -> dict:
    """``detection_output`` on the card over a forward's loc, conf and
    priors: its NMS (``ops/boxes.nms``, every round) under
    ``torch.cuda.set_sync_debug_mode("error")``, where a host sync
    raises, the rest of the layer under ``"warn"`` (the syncs it makes
    are counted); the layer's time by CUDA events."""
    import warnings

    from paddle_tpu_torch.core.registry import ApplyContext, get_layer_def
    from paddle_tpu_torch.ops import boxes

    with torch.no_grad():
        outs, _ = topo.forward(params, topo.create_state(), feed,
                               outputs=["ssd_loc", "ssd_conf", "ssd_priors"])
    spec = topo.get_layer("detections")
    inputs = [outs["ssd_loc"], outs["ssd_conf"], outs["ssd_priors"]]
    ctx = ApplyContext(train=False, device=torch.device("cuda"))
    real_nms = boxes.nms

    def nms_no_sync(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real_nms(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("warn")

    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    boxes.nms = nms_no_sync
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught, \
                torch.no_grad():
            warnings.simplefilter("always")
            ev[0].record()
            det = get_layer_def("detection_output").apply(spec.attrs, {},
                                                          inputs, ctx)
            ev[1].record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        boxes.nms = real_nms
    torch.cuda.synchronize()
    ms = ev[0].elapsed_time(ev[1])
    syncs = [str(w.message)[:80] for w in caught
             if "synchroniz" in str(w.message)]
    kept = int((det[..., 0] >= 0).sum())
    print(f"SSD detection_output on the card: NMS under "
          f"set_sync_debug_mode('error') (no host sync), the rest of the "
          f"layer {len(syncs)} syncs{(': ' + syncs[0]) if syncs else ''}; "
          f"{ms:.2f} ms for {det.shape[0]} images x "
          f"{SSD_WIDTH['num_classes'] - 1} classes x {inputs[2].shape[1]} "
          f"priors, {kept} rows kept", flush=True)
    return {"ms": ms, "rows_kept": kept, "syncs_outside_nms": len(syncs)}


def ssd_path(flush, gen) -> dict:
    """SSD at 300 px, 21 classes, under ``fused_bn_impl="pallas"``:
    kernels 7a and 7b alone at its four batch norms' shapes against their
    plain versions and timed (``bn_kernels_at``); SSD_STEPS Adam steps at
    batch SSD_BATCH, 7a and 7b SSD_BNS launches each a step;
    ``detection_output`` without a host sync (``_nms_without_sync``);
    DetectionMAP at the pass's end."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import ssd

    _policy("fp32")
    alone = {"x".join(map(str, shape[1:])): bn_kernels_at(
        shape, torch.float32, flush, gen, label="SSD's batch norm")
        for shape in SSD_BN_SHAPES}
    _fresh(paddle)
    paddle.init(seed=SEED, fused_bn_impl="pallas")
    cost, det = ssd.build(**SSD_WIDTH)
    paddle.evaluator.detection_map(input=det, label=cost.parents[4],
                                   gt_box=cost.parents[3], name="ssd_map")
    topo = paddle.Topology([cost, det])
    n_priors = topo.shapes["ssd_priors"][0]
    values = resnet_values(topo, SEED + 43)
    rng = np.random.RandomState(SEED + 44)
    feeds = [ssd_feed(rng, SSD_BATCH) for _ in range(SSD_STEPS)]
    trainer = paddle.trainer.SGD(topo, paddle.parameters.from_numpy(
        topo, values), paddle.optimizer.Adam(learning_rate=SSD_LR))
    metrics = {}
    losses, step_s, warm, peak_gb, launches = train_steps(
        "SSD", paddle, trainer, None, SSD_STEPS, "bn_fwd_stats", SSD_BNS,
        falling=False, reader=lambda: iter(feeds), metrics=metrics)
    if launches["bn_bwd_stats"] != SSD_BNS * SSD_STEPS:
        raise AssertionError(f"SSD: 7b launched {launches['bn_bwd_stats']} "
                             f"times in {SSD_STEPS} steps")
    prof = profile_step(trainer, feeds[0])
    bn_ms = _bn_share(prof)
    nms = _nms_without_sync(paddle, topo, trainer.parameters.values,
                            feeds[0])
    print(f"SSD training: {SSD_STEPS} Adam steps (lr {SSD_LR}) at batch "
          f"{SSD_BATCH} x {SSD_WIDTH['image_size']}^2, {n_priors} priors, "
          f"{SSD_WIDTH['num_classes']} classes, losses "
          f"{[round(x, 4) for x in losses]}; step time first "
          f"{step_s[0] * 1e3:.1f} ms, median after it {warm * 1e3:.1f} ms = "
          f"{SSD_BATCH / warm:.1f} images/s (smoke figure); peak memory "
          f"{peak_gb:.2f} GB; 7a / 7b launches a step "
          f"{launches['bn_fwd_stats'] // SSD_STEPS} / "
          f"{launches['bn_bwd_stats'] // SSD_STEPS}; one step under "
          f"torch.profiler {prof['step_ms']:.1f} ms, device busy "
          f"{prof['busy_ms']:.1f} ms"
          + (f", idle share {prof['idle_share']:.1%}"
             if prof["idle_share"] is not None else ", idle not measured")
          + f"; 7a + 7b {bn_ms:.3f} ms ({bn_ms / prof['step_ms']:.2%}); "
          f"DetectionMAP at the pass's end {metrics}", flush=True)
    del trainer
    return {"alone": alone, "losses": losses, "step_ms": warm * 1e3,
            "first_step_ms": step_s[0] * 1e3,
            "images_per_s": SSD_BATCH / warm, "peak_gb": peak_gb,
            "launches": launches["bn_fwd_stats"],
            "launches_bwd": launches["bn_bwd_stats"], "priors": n_priors,
            "idle_share": prof["idle_share"], "bn_kernels_ms": bn_ms,
            "profiled_step_ms": prof["step_ms"], "nms": nms,
            "detection_map": metrics}


def _book_feeds(name, b, seed) -> list:
    """Two batches of ``b`` from the model's synthetic dataset: movielens
    for the recommender, imikolov's 5-grams for word2vec."""
    import paddle_tpu_torch as paddle

    out = []
    if name == "recommender":
        keys = ("user_id", "gender", "age", "job", "movie_id", "categories",
                "title")
        samples = list(paddle.dataset.movielens.train(n=2 * b)())
        for part in (samples[:b], samples[b:]):
            fd = {k: np.asarray([s[i] for s in part], np.int32)
                  for i, k in enumerate(keys)}
            fd["score"] = np.stack([s[7] for s in part]).astype(np.float32)
            out.append(fd)
        return out
    grams = np.asarray(list(paddle.dataset.imikolov.train(
        samples=2 * b)()), np.int32)
    for part in (grams[:b], grams[b:]):
        fd = {f"w{i}": part[:, i] for i in range(W2V_WIDTH["window"] - 1)}
        fd["next_word"] = part[:, -1]
        out.append(fd)
    return out


def book_card_vs_cpu() -> dict:
    """The recommender (movielens' vocabularies, emb 32, towers 200) and
    word2vec (imikolov's 2074 words, emb 32, hidden 256, window 5; softmax
    and hsigmoid) at batch BOOK_CPU_BATCH: the losses and every gradient
    of two Adam steps on the card against the CPU from the same seeded
    weights, within BOOK_CPU_TOL of max(1, max |cpu|)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import recommender, word2vec

    builds = {
        "recommender": lambda: recommender.build(**REC_WIDTH)[0],
        "word2vec": lambda: word2vec.build(
            vocab_size=paddle.dataset.imikolov.VOCAB_SIZE, **W2V_WIDTH)[0],
        "word2vec hsigmoid": lambda: word2vec.build(
            vocab_size=paddle.dataset.imikolov.VOCAB_SIZE,
            use_hsigmoid=True, **W2V_WIDTH)[0]}
    out = {}
    for name, build in builds.items():
        _fresh(paddle)
        topo = paddle.Topology(build())
        values = seeded_values(topo, SEED + 45)
        feeds = _book_feeds(name.split()[0], BOOK_CPU_BATCH, SEED + 46)
        runs = {}
        for device in ("cuda", "cpu"):
            tr = paddle.trainer.SGD(
                topo, paddle.parameters.from_numpy(topo, values,
                                                   device=device),
                paddle.optimizer.Adam(learning_rate=1e-3), device=device)
            steps = []
            for fd in feeds:
                loss, grads = tr.forward_backward(fd)
                steps.append((float(loss), grads))
                tr.train(lambda: iter([fd]), event_handler=lambda e: None)
            runs[device] = steps
            del tr
        errs = {}
        for i, ((lc, gc), (lr_, gr)) in enumerate(zip(runs["cuda"],
                                                      runs["cpu"])):
            errs[f"step {i + 1} loss"] = _rel(lc, lr_)
            errs.update({f"step {i + 1} d {l}.{p}": _rel_max_err(gc[l][p], g)
                         for l, ps in gr.items() for p, g in ps.items()})
        worst = max(errs.items(), key=lambda kv: kv[1])
        if not worst[1] <= BOOK_CPU_TOL:
            raise AssertionError(f"{name} on the card vs the CPU: {worst[0]} "
                                 f"{worst[1]} > {BOOK_CPU_TOL}")
        print(f"{name} on the card vs the CPU at batch {BOOK_CPU_BATCH}, "
              f"two Adam steps: losses {[round(s[0], 6) for s in runs['cuda']]}"
              f" vs {[round(s[0], 6) for s in runs['cpu']]}; worst of "
              f"{len(errs)} {worst[0]} at {worst[1]:.2e} of max(1, max |cpu|)"
              f" (limit {BOOK_CPU_TOL:.0e})", flush=True)
        out[name] = {"worst": worst[1], "at": worst[0], "checked": len(errs)}
    return out


def book_slice() -> dict:
    """Phase 22: item 11a on the card - SRL at the book's width through
    kernel 5 (``srl_path``), OCR-CTC through kernel 6 (``ocr_path``), SSD
    through kernels 7a and 7b (``ssd_path``), the recommender and
    word2vec card against CPU (``book_card_vs_cpu``)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 47)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    out = {"srl": srl_path(flush, gen)}
    torch.cuda.empty_cache()
    out["ocr"] = ocr_path(flush, gen)
    torch.cuda.empty_cache()
    out["ssd"] = ssd_path(flush, gen)
    del flush
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = book_card_vs_cpu()
    return out


BOOK_PHASES = {"book": book_slice}


# --------------------------------------------------------- v2rest (23)
# upstream's benchmark/paddle/rnn/rnn.py (BASELINE.md "LSTM text-clf
# h=512, bs128"): vocabulary 30000, embedding 128, two simple_lstm of
# 512, fixed length 100, batch 128
LEGACY_VOCAB, LEGACY_LEN, LEGACY_H, LEGACY_BATCH = 30000, 100, 512, 128
LEGACY_BATCHES, LEGACY_ITERS = 4, 10
LEGACY_PROVIDER = f"""import numpy as np
from paddle_tpu_torch.py_data_provider2 import (provider, integer_value,
                                                integer_value_sequence)


@provider(input_types={{"data": integer_value_sequence(
              {LEGACY_VOCAB}, max_len={LEGACY_LEN}),
                       "label": integer_value(2)}},
          should_shuffle=False)
def process(settings, file_name):
    rng = np.random.RandomState({SEED + 50})
    for _ in range({LEGACY_BATCHES * LEGACY_BATCH}):
        yield {{"data": rng.randint(0, {LEGACY_VOCAB}, {LEGACY_LEN})
                .astype("int32"), "label": int(rng.randint(0, 2))}}
"""
LEGACY_CONFIG = f"""from paddle_tpu_torch.trainer_config_helpers import *

settings(batch_size={LEGACY_BATCH}, learning_rate=2e-3,
         learning_method=AdamOptimizer(),
         regularization=L2Regularization(8e-4),
         gradient_clipping_threshold=25)

define_py_data_sources2(["synthetic"], None, module="rnn_provider",
                        obj="process")

net = data_layer("data", size={LEGACY_VOCAB})
net = embedding_layer(input=net, size=128)
for _ in range(2):
    net = simple_lstm(input=net, size={LEGACY_H})
net = last_seq(input=net)
net = fc_layer(input=net, size=2, act=SoftmaxActivation())
lab = data_layer("label", 2)
loss = classification_cost(input=net, label=lab)
outputs(loss)
"""
# networks.multi_head_attention at the LM's attention width
NET_B, NET_T, NET_W, NET_HEADS, NET_STEPS = 128, 100, 512, 4, 3
NET_CPU_BATCH = 4


def _tests_module(name):
    """``tests/<name>.py``, a helper of the CPU tests that imports neither
    JAX nor the JAX package."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cli_json(args, root, what) -> tuple:
    """Run ``python -m paddle_tpu_torch <args>`` from the checkout: (its
    stdout's lines, the last line's JSON or None)."""
    proc = subprocess.run([sys.executable, "-m", "paddle_tpu_torch", *args],
                          cwd=root, env={**os.environ, "PYTHONPATH": root},
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"{what}: rc {proc.returncode}\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    try:
        return lines, json.loads(lines[-1])
    except (IndexError, ValueError):
        return lines, None


def legacy_rnn_path() -> dict:
    """Upstream's RNN benchmark config, written in its
    ``trainer_config_helpers`` style with a ``@provider`` module, through
    ``python -m paddle_tpu_torch train --config=`` on the card:
    ``--job=time`` (ms a batch, samples and tokens a second) and
    ``--job=train`` over LEGACY_BATCHES batches of the provider (the
    costs finite); then the config loaded in this process through the
    CLI's own loader for two steps' peak memory and a profiled step's idle
    share.  ``simple_lstm`` has the peephole on, so the step is the plain
    one: no kernel launches on this path."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import cli, ops
    from paddle_tpu_torch.data_feeder import DataFeeder

    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="legacy_rnn_")
    try:
        with open(os.path.join(tmp, "rnn_provider.py"), "w") as f:
            f.write(LEGACY_PROVIDER)
        cfg_path = os.path.join(tmp, "rnn.py")
        with open(cfg_path, "w") as f:
            f.write(LEGACY_CONFIG)
        base = ["train", f"--config={cfg_path}", "--device=cuda"]
        _, timed = _cli_json(base + ["--job=time",
                                     f"--batch_size={LEGACY_BATCH}",
                                     f"--iters={LEGACY_ITERS}"], root,
                             "legacy RNN --job=time")
        lines, _ = _cli_json(base + ["--job=train", "--num_passes=1",
                                     "--log_period=1"], root,
                             "legacy RNN --job=train")
        costs = [float(ln.rsplit("Cost", 1)[1]) for ln in lines
                 if ln.startswith("Pass 0, Batch")]
        if len(costs) != LEGACY_BATCHES or not all(map(np.isfinite, costs)):
            raise AssertionError(f"legacy RNN --job=train costs {costs}")
        _fresh(paddle)
        cfg = cli._load_config(cfg_path)
        topo = paddle.Topology(cfg["cost"])
        trainer = paddle.trainer.SGD(topo, paddle.parameters.create(topo),
                                     paddle.optimizer.Momentum(
                                         learning_rate=0.01, momentum=0.9))
        batch = next(iter(cfg["train_reader"]()))
        feed = DataFeeder(topo, cfg["feeding"]).feed(batch)
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            float(trainer._step(feed))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launched = {k: n for k, n in ops.launch_counts().items() if n}
        if launched:
            raise AssertionError(f"legacy RNN: the plain path launched "
                                 f"{launched}")
        prof = profile_step(trainer, feed)
        del trainer
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ms = timed["ms_per_batch"]
    tokens_s = timed["samples_per_sec"] * LEGACY_LEN
    print(f"legacy RNN config (upstream rnn.py: vocabulary {LEGACY_VOCAB}, "
          f"embedding 128, 2 x simple_lstm {LEGACY_H}, T {LEGACY_LEN}) "
          f"through `python -m paddle_tpu_torch train`: --job=time at batch "
          f"{LEGACY_BATCH} {ms} ms a batch, {tokens_s:.0f} tokens/s; "
          f"--job=train costs {[round(c, 5) for c in costs]}; peak memory "
          f"{peak_gb:.2f} GB; no kernel launched (simple_lstm's peephole "
          f"takes the plain step, not kernel 5); {_idle(prof)}", flush=True)
    return {"ms_per_batch": ms, "samples_per_s": timed["samples_per_sec"],
            "tokens_per_s": tokens_s, "costs": costs, "peak_gb": peak_gb,
            "idle_share": prof["idle_share"], "busy_ms": prof["busy_ms"],
            "profiled_step_ms": prof["step_ms"], "launches": 0,
            "optimizer": "Momentum(0.01, 0.9), the CLI's default: the "
                         "config does not assign settings()' optimizer"}


def _net_model(paddle):
    """networks.multi_head_attention (4 heads of 128 over 512) on a padded
    sequence batch, averaged, fc 2 softmax, classification cost."""
    _fresh(paddle)
    layer, dt = paddle.layer, paddle.data_type
    q = layer.data("q", dt.dense_vector_sequence(NET_W, max_len=NET_T))
    att = paddle.networks.multi_head_attention(q, q, q, head_num=NET_HEADS,
                                               name="mha")
    pred = layer.fc(layer.pooling(att, pooling_type="avg"), size=2,
                    act="softmax")
    lab = layer.data("label", dt.integer_value(2))
    return paddle.Topology(layer.classification_cost(pred, lab))


def _net_cpu_run(paddle, configs, name, values, device):
    """A helper's model at batch NET_CPU_BATCH (padded): its cost and the
    gradient of every parameter and float feed, on ``device``."""
    _fresh(paddle)
    topo = paddle.Topology(configs.CONFIGS[name](paddle))
    if values is None:
        values = seeded_values(topo, SEED + 51)
    feed = configs.feed(topo, padded=True, batch=NET_CPU_BATCH, seed=SEED)
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
    outs, _ = topo.forward(params, topo.create_state(device=device), tfeed,
                           train=True, device=device)
    cost = outs[topo.output_names[0]]
    grads = torch.autograd.grad(cost, list(wrt.values()), allow_unused=True)
    return values, float(cost.detach()), dict(zip(wrt, grads))


def networks_path() -> dict:
    """The ``networks`` helpers of item 11b: each helper's model
    (``tests/torch_networks_configs.py``) on the card against the CPU at
    batch NET_CPU_BATCH from the same weights (the cost and every
    gradient within ITEM9_TOL of max(1, max |cpu|)); then
    ``networks.multi_head_attention`` at the LM's width (NET_W wide,
    NET_HEADS heads) over NET_B x NET_T padded rows, the kernel route
    against ``attention_impl="torch"`` on the card: the first loss, every
    gradient and NET_STEPS Adam steps, kernels 1, 2 and 3 counted a step
    (one attention layer: one launch each)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.core import config

    configs = _tests_module("torch_networks_configs")
    helpers = {}
    for name in sorted(configs.CONFIGS):
        values, lc, gc = _net_cpu_run(paddle, configs, name, None, "cuda")
        _, lr_, gr = _net_cpu_run(paddle, configs, name, values, "cpu")
        errs = {"cost": _rel(lc, lr_)}
        errs.update({k: (0.0 if g is None else _rel_max_err(gc[k], g))
                     for k, g in gr.items()})
        worst = max(errs.items(), key=lambda kv: kv[1])
        if not worst[1] <= ITEM9_TOL:
            raise AssertionError(f"networks.{name} on the card vs the CPU: "
                                 f"{worst[0]} {worst[1]} > {ITEM9_TOL}")
        helpers[name] = {"worst": worst[1], "at": worst[0],
                         "checked": len(errs)}
    print(f"networks helpers on the card vs the CPU at batch "
          f"{NET_CPU_BATCH}: " + ", ".join(
              f"{n} {h['worst']:.1e}" for n, h in helpers.items())
          + f" (limit {ITEM9_TOL:.0e} of max(1, max |cpu|))", flush=True)

    topo = _net_model(paddle)
    values = seeded_values(topo, SEED + 52)
    rng = np.random.default_rng(SEED + 53)
    lens = rng.integers(1, NET_T + 1, NET_B).astype(np.int32)
    lens[::4] = NET_T
    feed = {"q": rng.standard_normal((NET_B, NET_T, NET_W),
                                     dtype=np.float32),
            "q@len": lens,
            "label": rng.integers(0, 2, NET_B).astype(np.int32)}
    runs = {}
    for impl in (None, "torch"):
        config.set_option("attention_impl", impl)
        try:
            tr = paddle.trainer.SGD(topo, paddle.parameters.from_numpy(
                topo, values), paddle.optimizer.Adam(learning_rate=1e-3))
            loss, grads = tr.forward_backward(feed)
            kernel, per = (("flash_fwd", 1) if impl is None
                           else ("flash_fwd", 0))
            losses, step_s, warm, peak_gb, launches = train_steps(
                f"networks.multi_head_attention ({impl or 'kernels'})",
                paddle, tr, feed, NET_STEPS, kernel, per, falling=False)
            runs[impl] = dict(loss=float(loss), grads=grads, losses=losses,
                              step_ms=warm * 1e3, peak_gb=peak_gb,
                              launches={k: launches[k]
                                        for k in TRAIN_KERNELS})
            del tr
        finally:
            config.set_option("attention_impl", None)
    k, t = runs[None], runs["torch"]
    if any(n != NET_STEPS for n in k["launches"].values()):
        raise AssertionError(f"networks.multi_head_attention: launches "
                             f"{k['launches']} in {NET_STEPS} steps, "
                             f"expected one of each a step")
    if any(t["launches"].values()):
        raise AssertionError(f"plain route launched {t['launches']}")
    loss_rel = _rel(k["loss"], t["loss"])
    worst = max(((g - t["grads"][l][p]).abs().max().item()
                 / max(1.0, t["grads"][l][p].abs().max().item()),
                 f"{l}.{p}")
                for l, ps in k["grads"].items() for p, g in ps.items())
    traj = max(_rel(a, b) for a, b in zip(k["losses"], t["losses"]))
    if not (loss_rel <= 1e-5 and worst[0] <= TOL and traj <= TOL):
        raise AssertionError(
            f"networks.multi_head_attention kernel vs plain: loss "
            f"{loss_rel}, gradient {worst}, trajectory {k['losses']} vs "
            f"{t['losses']}")
    print(f"networks.multi_head_attention ({NET_HEADS} x "
          f"{NET_W // NET_HEADS} over {NET_W}) at {NET_B} x {NET_T}, padded: "
          f"kernels 1, 2, 3 one launch each a step ({k['launches']} in "
          f"{NET_STEPS} steps); kernel route vs plain: first loss "
          f"{loss_rel:.1e} relative, worst gradient {worst[1]} at "
          f"{worst[0]:.1e}, {NET_STEPS}-step Adam losses within {traj:.1e}; "
          f"step {k['step_ms']:.1f} ms on the kernels, {t['step_ms']:.1f} ms "
          f"plain; peak {k['peak_gb']:.2f} GB", flush=True)
    return {"helpers": helpers,
            "mha": {"launches": k["launches"], "per_step": 1,
                    "loss_rel": loss_rel, "grad_rel": worst[0],
                    "grad_at": worst[1], "traj_rel": traj,
                    "step_ms": k["step_ms"], "plain_step_ms": t["step_ms"],
                    "peak_gb": k["peak_gb"],
                    "shape": {"B": NET_B, "T": NET_T, "W": NET_W,
                              "heads": NET_HEADS}}}


def v2rest_slice() -> dict:
    """Phase 23: item 11b on the card - the legacy RNN config through the
    CLI (``legacy_rnn_path``) and the ``networks`` helpers
    (``networks_path``)."""
    out = {"legacy_rnn": legacy_rnn_path()}
    torch.cuda.empty_cache()
    out["networks"] = networks_path()
    return out


V2REST_PHASES = {"v2rest": v2rest_slice}


# ---------------------------------------------------------- fluid (24)
# the Fluid book's chapter 3 (test_image_classification_train.py):
# vgg16_bn_drop on cifar-10
FLUID_VGG_BATCH, FLUID_VGG_STEPS = 128, 6
FLUID_CPU_TOL = 1e-4


def _host_negatives(ctx, n, c):
    """nce's negatives drawn on the host from the op's (seed, step,
    rng_id, call): the same on the card and on the CPU."""
    seed = np.random.SeedSequence(list(ctx._base) + [ctx._calls])
    ctx._calls += 1
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, c, n), device=ctx.device)


def vgg16_bn_drop(fluid, img):
    """The book's vgg16_bn_drop: five ``nets.img_conv_group`` blocks (64,
    128, 256, 512, 512; batch norm, dropout 0.3 / 0.4), dropout 0.5, fc
    512, batch norm, dropout 0.5, fc 512."""
    def block(ipt, nf, groups, drops):
        return fluid.nets.img_conv_group(
            input=ipt, pool_size=2, pool_stride=2,
            conv_num_filter=[nf] * groups, conv_filter_size=3,
            conv_act="relu", conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=drops, pool_type="max")

    t = block(img, 64, 2, [0.3, 0])
    t = block(t, 128, 2, [0.4, 0])
    t = block(t, 256, 3, [0.4, 0.4, 0])
    t = block(t, 512, 3, [0.4, 0.4, 0])
    t = block(t, 512, 3, [0.4, 0.4, 0])
    t = fluid.layers.dropout(x=t, dropout_prob=0.5)
    t = fluid.layers.fc(input=t, size=512, act=None)
    t = fluid.layers.batch_norm(input=t, act="relu")
    t = fluid.layers.dropout(x=t, dropout_prob=0.5)
    return fluid.layers.fc(input=t, size=512, act=None)


def fluid_vgg_path() -> dict:
    """vgg16_bn_drop at the book's width: 32 px cifar-10 (synthetic),
    batch FLUID_VGG_BATCH, Adam 1e-3, float32, FLUID_VGG_STEPS steps of
    one batch through the eager executor on the card (the losses finite;
    a few steps of dropout and Adam need not fall, and the ops' values are
    held by ``fluid_book_card_vs_cpu``), ms a step, images/s, peak
    memory, a profiled step's idle share; no kernel of the port is
    launched (Fluid reaches no TPU-kernel counterpart)."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import ops

    fluid.framework.reset_default_programs()
    img = fluid.layers.data(name="pixel", shape=[3, 32, 32])
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    predict = fluid.layers.fc(input=vgg16_bn_drop(fluid, img), size=10,
                              act="softmax")
    avg_cost = fluid.layers.mean(fluid.layers.cross_entropy(
        input=predict, label=label))
    acc = fluid.layers.accuracy(input=predict, label=label)
    fluid.optimizer.Adam(learning_rate=0.001).minimize(avg_cost)
    samples = list(paddle.dataset.cifar.train10(n=FLUID_VGG_BATCH)())
    feed = {"pixel": np.stack([s[0] for s in samples]).reshape(
        -1, 3, 32, 32).astype(np.float32),
            "label": np.asarray([[s[1]] for s in samples], np.int64)}
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(fluid.default_startup_program(), scope=scope)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for _ in range(FLUID_VGG_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lv, _ = exe.run(feed=feed, fetch_list=[avg_cost, acc], scope=scope)
        step_s.append(time.perf_counter() - t0)
        losses.append(float(lv))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launched = {k: n for k, n in ops.launch_counts().items() if n}
    if launched:
        raise AssertionError(f"fluid launched the port's kernels "
                             f"{launched}")
    if not all(map(np.isfinite, losses)):
        raise AssertionError(f"vgg16_bn_drop losses {losses}")
    prof = profile_call(lambda: exe.run(feed=feed, fetch_list=[avg_cost],
                                        scope=scope))
    warm = sorted(step_s[1:])[len(step_s[1:]) // 2]
    n_ops = len(fluid.default_main_program().global_block().ops)
    print(f"fluid vgg16_bn_drop (book ch. 3, 32 px, batch "
          f"{FLUID_VGG_BATCH}, Adam 1e-3, float32, {n_ops} ops a step "
          f"through the eager executor): losses "
          f"{[round(x, 4) for x in losses]}; step first "
          f"{step_s[0] * 1e3:.1f} ms, median after it {warm * 1e3:.1f} ms "
          f"({FLUID_VGG_BATCH / warm:.0f} images/s); peak memory "
          f"{peak_gb:.2f} GB; no kernel of the port launched; "
          f"{_idle(prof)}", flush=True)
    return {"losses": losses, "first_step_ms": step_s[0] * 1e3,
            "step_ms": warm * 1e3, "images_per_s": FLUID_VGG_BATCH / warm,
            "peak_gb": peak_gb, "ops": n_ops, "launches": 0,
            "idle_share": prof["idle_share"], "busy_ms": prof["busy_ms"],
            "profiled_step_ms": prof["step_ms"],
            "top": prof["top"][:5]}


def fluid_book_card_vs_cpu() -> dict:
    """The programs of ``tests/torch_fluid_programs.py`` (fit_a_line,
    recognize_digits, Adam with decay and clipping, the five book
    chapters) at their test widths: the same starting values (the CPU
    startup run's) on the card and on the CPU, the losses of every step
    within FLUID_CPU_TOL relative (machine translation's beams: the ids
    equal, the scores within FLUID_CPU_TOL); nce's negatives drawn on the
    host (``_host_negatives``).  Then chapter 3's inference model saved
    and loaded on the card, its output equal to the program's."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import ops as fops

    progs = _tests_module("torch_fluid_programs")
    draw, fops.nce_negatives = fops.nce_negatives, _host_negatives
    out = {}
    try:
        for name in progs.PROGRAMS:
            runs = {}
            for key, place in (("cpu", fluid.CPUPlace()),
                               ("cuda", fluid.CUDAPlace(0))):
                main, startup, fetch, feeds = progs.build(fluid, name)
                exe, scope = fluid.Executor(place), fluid.Scope()
                if not runs:
                    exe.run(startup, scope=scope)
                    init = {k: v.cpu().numpy() for k, v in
                            scope.vars.items()}
                else:
                    exe._step = 1
                    for k, v in init.items():
                        scope.set(k, v)
                n = progs.STEPS if name in progs.TRAINED else 1
                runs[key] = [
                    exe.run(main, feed=feeds(i), fetch_list=fetch,
                            scope=scope) for i in range(n)]
            cpu, card = runs["cpu"], runs["cuda"]
            if name in progs.TRAINED:
                err = max(_rel(float(a[0]), float(b[0]))
                          for a, b in zip(card, cpu))
                ok = err <= FLUID_CPU_TOL
            else:
                err = _rel_max_err(torch.as_tensor(card[0][1]),
                                   torch.as_tensor(cpu[0][1]))
                ok = (np.array_equal(card[0][0], cpu[0][0])
                      and err <= FLUID_CPU_TOL)
            if not ok:
                raise AssertionError(f"fluid {name} on the card vs the "
                                     f"CPU: {card} vs {cpu}")
            out[name] = {"losses": [float(s[0]) for s in card]
                         if name in progs.TRAINED else None,
                         "worst_rel": err}
        main, startup, fetch, feeds = progs.build(fluid,
                                                  "image_classification")
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        exe.run(startup, scope=scope)
        for i in range(2):
            exe.run(main, feed=feeds(i), fetch_list=fetch, scope=scope)
        logits = fetch[1]
        want, = exe.run(fluid.io._prune_for_inference(
            main, ["pixel"], [logits]), feed={"pixel": feeds(0)["pixel"]},
            fetch_list=[logits], scope=scope)
        tmp = tempfile.mkdtemp(prefix="fluid_infer_")
        try:
            fluid.io.save_inference_model(tmp, ["pixel"], [logits], exe,
                                          main_program=main, scope=scope)
            loaded = fluid.Scope()
            prog, feed_names, fetch_names = fluid.io.load_inference_model(
                tmp, exe, scope=loaded)
            got, = exe.run(prog, feed={"pixel": feeds(0)["pixel"]},
                           fetch_list=fetch_names, scope=loaded)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if not np.array_equal(got, want):
            raise AssertionError("fluid inference model on the card: the "
                                 "loaded model's output differs")
        out["inference_model"] = {"shape": list(got.shape), "equal": True}
    finally:
        fops.nce_negatives = draw
    print("fluid programs on the card vs the CPU from the same starting "
          "values: " + ", ".join(f"{n} {v['worst_rel']:.1e}"
                                 for n, v in out.items()
                                 if n != "inference_model")
          + f" (limit {FLUID_CPU_TOL:.0e}); chapter 3's inference model "
          f"saved and loaded on the card, output equal", flush=True)
    return out


def fluid_slice() -> dict:
    """Phase 24: item 12a on the card - vgg16_bn_drop at the book's width
    (``fluid_vgg_path``) and the book programs card against CPU
    (``fluid_book_card_vs_cpu``)."""
    out = {"vgg16_bn_drop": fluid_vgg_path()}
    torch.cuda.empty_cache()
    out["programs"] = fluid_book_card_vs_cpu()
    return out


FLUID_PHASES = {"fluid": fluid_slice}


# ---------------------------------------------------------------- fluid_cf
# item 12b on the card: a translation model trained through Fluid's
# control flow (a DynamicRNN decoder) at bench_nmt's widths (bench.py:
# vocabulary 30000 both sides, embedding and hidden 512, src = trg = 50,
# batch 256, float32, Adam 1e-3; full target lengths, as bench_nmt feeds
# them), eager and as run_n's captured CUDA graphs of FLUID_RUN_N steps;
# vgg16_bn_drop through prepare(...).run_n; the control-flow and catalog
# programs card against CPU.  No kernel of the port lies on this path.
FLUID_NMT = dict(vocab=30000, emb=512, hidden=512, src_len=50, trg_len=50,
                 batch=256)
FLUID_EAGER_STEPS, FLUID_RUN_N = 3, 4


@contextlib.contextmanager
def _deterministic():
    """cuDNN's and torch's deterministic algorithms for a bit-for-bit
    comparison of two runs, restored after it."""
    cudnn, algos = (torch.backends.cudnn.deterministic,
                    torch.are_deterministic_algorithms_enabled())
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = cudnn
        torch.use_deterministic_algorithms(algos, warn_only=warn)


def _scope_copy(fluid, scope):
    out = fluid.Scope()
    for k, v in scope.vars.items():
        out.set(k, v.clone())
    return out


def _bit_equal(a, b) -> list:
    """the names whose values differ between two scopes (bit for bit)"""
    return [n for n in a.vars
            if not torch.equal(torch.as_tensor(a.get(n)).cpu(),
                               torch.as_tensor(b.get(n)).cpu())]


def _fluid_timed(fn, steps) -> list:
    """host seconds of ``fn()`` ``steps`` times, each ending in a sync"""
    out = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def fluid_eager_vs_run_n(fluid, program, loss, feeds, start, fetch,
                         n, chunks, label) -> dict:
    """One program on the card from the scope ``start``: eager run()
    steps (ms a step: the median after the first), then run_n(n) chunks
    (one captured CUDA graph each; ms a step: the median chunk after the
    capturing one, over n); a profiled eager step and a profiled chunk
    (idle share), peak memory of each; and, under deterministic
    algorithms, run_n(n)'s losses and scope against n run() calls from
    ``start`` bit for bit."""
    from paddle_tpu_torch import ops

    out = {}
    ops.reset_launch_counts()
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), _scope_copy(fluid,
                                                                 start)
    torch.cuda.reset_peak_memory_stats()
    i = iter(range(1 << 30))
    eager = _fluid_timed(lambda: exe.run(program, feed=feeds(next(i)),
                                         fetch_list=fetch, scope=scope),
                         FLUID_EAGER_STEPS + 1)
    out["eager_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    prof_eager = profile_call(lambda: exe.run(
        program, feed=feeds(0), fetch_list=fetch, scope=scope))
    cp = exe.prepare(program, fetch_list=fetch, scope=scope)
    torch.cuda.reset_peak_memory_stats()
    k = iter(range(1 << 30))
    chunk_s = _fluid_timed(lambda: cp.run_n(
        lambda j: feeds(next(k)), n), chunks + 1)
    out["run_n_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    prof_chunk = profile_call(lambda: cp.run_n(lambda j: feeds(j), n))
    standdowns = dict(exe.run_n_standdowns)
    launched = {name: c for name, c in ops.launch_counts().items() if c}
    if launched:
        raise AssertionError(f"{label}: fluid launched the port's kernels "
                             f"{launched}")
    del exe, scope, cp
    torch.cuda.empty_cache()
    with _deterministic():
        ea, sa = fluid.Executor(fluid.CUDAPlace(0)), _scope_copy(fluid,
                                                                 start)
        eb, sb = fluid.Executor(fluid.CUDAPlace(0)), _scope_copy(fluid,
                                                                 start)
        want = [ea.run(program, feed=feeds(j), fetch_list=[loss],
                       scope=sa)[0] for j in range(n)]
        got, = eb.run_n(program, feed=feeds, n=n, fetch_list=[loss],
                        scope=sb)
        differ = _bit_equal(sa, sb)
    equal = np.array_equal(got, np.stack(want)) and not differ
    if not equal or not np.isfinite(got).all():
        raise AssertionError(
            f"{label}: run_n({n}) against {n} run() calls: losses {got} vs "
            f"{np.stack(want)}, {len(differ)} scope values differ "
            f"{differ[:5]}")
    del ea, sa, eb, sb
    torch.cuda.empty_cache()
    e_ms = sorted(eager[1:])[len(eager[1:]) // 2] * 1e3
    c_ms = sorted(chunk_s[1:])[len(chunk_s[1:]) // 2] * 1e3 / n
    out.update({"eager_first_step_ms": eager[0] * 1e3, "eager_step_ms": e_ms,
                "run_n": n, "run_n_first_chunk_ms": chunk_s[0] * 1e3,
                "run_n_step_ms": c_ms, "speedup": e_ms / c_ms,
                "eager_idle_share": prof_eager["idle_share"],
                "eager_busy_ms": prof_eager["busy_ms"],
                "eager_profiled_ms": prof_eager["step_ms"],
                "run_n_idle_share": prof_chunk["idle_share"],
                "run_n_busy_ms": prof_chunk["busy_ms"],
                "run_n_profiled_ms": prof_chunk["step_ms"],
                "standdowns": standdowns, "launches": 0,
                "equal_bits": equal, "losses": [float(x) for x in got],
                "eager_top": prof_eager["top"][:4]})
    return out


def fluid_cf_nmt(card) -> dict:
    """The DynamicRNN translation model (``tests/torch_fluid_programs.py``
    ``nmt_dynamic_rnn``) at bench_nmt's widths: target + source tokens a
    second (as bench_nmt counts them), eager and under run_n."""
    import paddle_tpu_torch.fluid as fluid

    progs = _tests_module("torch_fluid_programs")
    w = FLUID_NMT
    fluid.framework.reset_default_programs()
    loss, feeds = progs.nmt_dynamic_rnn(fluid, w["vocab"], w["emb"],
                                        w["hidden"], w["src_len"],
                                        w["trg_len"], w["batch"],
                                        min_len=w["trg_len"])
    program = fluid.default_main_program()
    exe, start = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(fluid.default_startup_program(), scope=start)
    cache = {}

    def feed(i):     # the batches made once, on the host
        if i % 8 not in cache:
            cache[i % 8] = feeds(i % 8)
        return cache[i % 8]

    out = fluid_eager_vs_run_n(fluid, program, loss, feed, start, [loss],
                               FLUID_RUN_N, 3, "translation model")
    toks = w["batch"] * (w["src_len"] + w["trg_len"])
    out.update(widths=w, ops=len(program.global_block().ops),
               eager_tokens_per_s=toks / out["eager_step_ms"] * 1e3,
               run_n_tokens_per_s=toks / out["run_n_step_ms"] * 1e3)
    print(f"fluid_cf translation model (DynamicRNN decoder; vocab "
          f"{w['vocab']}, emb {w['emb']}, hidden {w['hidden']}, src = trg "
          f"= {w['src_len']}, batch {w['batch']}, Adam 1e-3, float32; "
          f"{out['ops']} ops) on {card}: eager {out['eager_step_ms']:.1f} "
          f"ms a step ({out['eager_tokens_per_s']:.0f} tokens/s, first "
          f"{out['eager_first_step_ms']:.0f} ms, peak "
          f"{out['eager_peak_gb']:.2f} GB, {_idle(_prof_view(out, 'eager'))}"
          f"); run_n({FLUID_RUN_N}) {out['run_n_step_ms']:.1f} ms a step "
          f"({out['run_n_tokens_per_s']:.0f} tokens/s, x"
          f"{out['speedup']:.2f}; capture chunk "
          f"{out['run_n_first_chunk_ms']:.0f} ms, peak "
          f"{out['run_n_peak_gb']:.2f} GB, "
          f"{_idle(_prof_view(out, 'run_n'))}); stand-downs "
          f"{out['standdowns']}; run_n's losses and scope equal "
          f"{FLUID_RUN_N} run() calls bit for bit (deterministic "
          f"algorithms): {out['equal_bits']}; losses {out['losses']}",
          flush=True)
    return out


def _prof_view(out, key) -> dict:
    return {"idle_share": out[f"{key}_idle_share"],
            "busy_ms": out[f"{key}_busy_ms"],
            "step_ms": out[f"{key}_profiled_ms"]}


def fluid_cf_vgg(card) -> dict:
    """vgg16_bn_drop (PR 25's configuration: batch FLUID_VGG_BATCH, 32
    px, Adam 1e-3, dropout on) through prepare(...).run_n, beside the
    eager executor in the same call."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.fluid as fluid

    fluid.framework.reset_default_programs()
    img = fluid.layers.data(name="pixel", shape=[3, 32, 32])
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    predict = fluid.layers.fc(input=vgg16_bn_drop(fluid, img), size=10,
                              act="softmax")
    loss = fluid.layers.mean(fluid.layers.cross_entropy(input=predict,
                                                        label=label))
    fluid.optimizer.Adam(learning_rate=0.001).minimize(loss)
    samples = list(paddle.dataset.cifar.train10(n=FLUID_VGG_BATCH)())
    feed = {"pixel": np.stack([s[0] for s in samples]).reshape(
        -1, 3, 32, 32).astype(np.float32),
            "label": np.asarray([[s[1]] for s in samples], np.int64)}
    program = fluid.default_main_program()
    exe, start = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(fluid.default_startup_program(), scope=start)
    out = fluid_eager_vs_run_n(fluid, program, loss, lambda i: feed, start,
                               [loss], FLUID_RUN_N, 3, "vgg16_bn_drop")
    print(f"fluid_cf vgg16_bn_drop (batch {FLUID_VGG_BATCH}, 32 px, Adam "
          f"1e-3, dropout on) on {card}: eager {out['eager_step_ms']:.1f} "
          f"ms a step ({_idle(_prof_view(out, 'eager'))}, peak "
          f"{out['eager_peak_gb']:.2f} GB); prepare(...).run_n("
          f"{FLUID_RUN_N}) {out['run_n_step_ms']:.1f} ms a step (x"
          f"{out['speedup']:.2f}; {_idle(_prof_view(out, 'run_n'))}, peak "
          f"{out['run_n_peak_gb']:.2f} GB); stand-downs "
          f"{out['standdowns']}; equal to {FLUID_RUN_N} run() calls bit "
          f"for bit, dropout's masks included: {out['equal_bits']}",
          flush=True)
    return out


def fluid_cf_card_vs_cpu(card) -> dict:
    """``CF_PROGRAMS`` at the tests' widths (the two-phase unbounded While
    trained 3 SGD steps, IfElse, Switch, the SSD loss with
    detection_output, CTC with edit distance): the same starting values
    (the CPU startup run's) on the card and on the CPU, every float fetch
    within FLUID_CPU_TOL relative to max(1, |cpu|), every integer fetch
    equal; then check_nan_inf on the card aborts before it commits: every
    persistable the same tensor with the same values; and run_n of the
    While program stands down, counted."""
    import paddle_tpu_torch.fluid as fluid

    progs = _tests_module("torch_fluid_programs")
    out = {}
    for name, fn in progs.CF_PROGRAMS.items():
        runs = {}
        for key, place in (("cpu", fluid.CPUPlace()),
                           ("cuda", fluid.CUDAPlace(0))):
            fluid.framework.reset_default_programs()
            fetch, feeds = fn(fluid)
            exe, scope = fluid.Executor(place), fluid.Scope()
            if not runs:
                exe.run(fluid.default_startup_program(), scope=scope)
                init = {k: v.cpu().numpy() for k, v in scope.vars.items()}
            else:
                exe._step = 1
                for k, v in init.items():
                    scope.set(k, v)
            runs[key] = [exe.run(feed=f, fetch_list=fetch, scope=scope)
                         for f in feeds]
        worst = 0.0
        for a, b in zip(runs["cuda"], runs["cpu"]):
            for x, y in zip(a, b):
                if np.issubdtype(y.dtype, np.floating):
                    worst = max(worst, float(np.max(np.abs(x - y),
                                                    initial=0.0))
                                / max(1.0, float(np.max(np.abs(y),
                                                        initial=0.0))))
                elif not np.array_equal(x, y):
                    raise AssertionError(f"fluid_cf {name}: integer "
                                         f"fetches differ {x} vs {y}")
        if worst > FLUID_CPU_TOL:
            raise AssertionError(f"fluid_cf {name} on the card vs the CPU: "
                                 f"{worst:.2e} > {FLUID_CPU_TOL}")
        out[name] = worst
    # the While program under run_n: a counted stand-down, the same values
    fluid.framework.reset_default_programs()
    fetch, feeds = progs.while_train(fluid)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(fluid.default_startup_program(), scope=scope)
    chunk, = exe.run_n(feed=lambda i: feeds[i], n=3, fetch_list=fetch,
                       scope=scope)
    standdowns = dict(exe.run_n_standdowns)
    if standdowns["capture_vars"] != 3 or not np.isfinite(chunk).all():
        raise AssertionError(f"fluid_cf: the While program's run_n "
                             f"stand-downs {standdowns}, losses {chunk}")
    # check_nan_inf on the card
    fluid.framework.reset_default_programs()
    L = fluid.layers
    x = L.data(name="x", shape=[4])
    cost = L.mean(L.square_error_cost(L.fc(input=x, size=1),
                                      L.data(name="y", shape=[1])))
    fluid.optimizer.Adam(learning_rate=0.01).minimize(cost)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(fluid.default_startup_program(), scope=scope)
    xv = np.random.RandomState(0).rand(8, 4).astype(np.float32)
    good = {"x": xv, "y": xv.sum(1, keepdims=True)}
    exe.run(feed=good, fetch_list=[cost], scope=scope)
    before = dict(scope.vars)
    snap = {k: v.clone() for k, v in scope.vars.items()}
    try:
        exe.run(feed=dict(good, x=np.full_like(xv, np.nan)),
                fetch_list=[cost], scope=scope, check_nan_inf=True)
        raise AssertionError("check_nan_inf on the card did not raise")
    except FloatingPointError:
        pass
    touched = [k for k, v in scope.vars.items()
               if v is not before[k] or not torch.equal(v, snap[k])]
    retry, = exe.run(feed=good, fetch_list=[cost], scope=scope,
                     check_nan_inf=True)
    if touched or not np.isfinite(retry).all():
        raise AssertionError(f"check_nan_inf on the card touched {touched}")
    out["check_nan_inf"] = {"raised": True, "untouched": True}
    out["while_run_n_standdowns"] = standdowns
    print(f"fluid_cf programs on the card vs the CPU from the same starting "
          f"values on {card}: " + ", ".join(
              f"{n} {v:.1e}" for n, v in out.items()
              if isinstance(v, float))
          + f" (limit {FLUID_CPU_TOL:.0e}); the While program's run_n(3) "
          f"stands down {standdowns}; check_nan_inf raised "
          f"FloatingPointError and left every persistable as it was",
          flush=True)
    return out


def fluid_cf_slice() -> dict:
    """Phase 25: item 12b on the card (``fluid_cf_nmt``, ``fluid_cf_vgg``,
    ``fluid_cf_card_vs_cpu``); it launches no kernel of the port."""
    from paddle_tpu_torch import ops

    card = card_line()
    ops.reset_launch_counts()
    out = {"card": card, "nmt": fluid_cf_nmt(card)}
    torch.cuda.empty_cache()
    out["vgg16_bn_drop"] = fluid_cf_vgg(card)
    torch.cuda.empty_cache()
    out["programs"] = fluid_cf_card_vs_cpu(card)
    torch.cuda.empty_cache()
    out["launches"] = {k: c for k, c in ops.launch_counts().items() if c}
    if out["launches"]:
        raise AssertionError(f"fluid_cf launched {out['launches']}")
    return out


FLUID_CF_PHASES = {"fluid_cf": fluid_cf_slice}



# ------------------------------------------------- phase 26: telemetry
TELEMETRY_FLOP_BAND = 0.25   # the registry's FLOPs a step against analytic
TELEMETRY_REQUESTS = 16
TELEMETRY_PROFILE_STEPS = 2


def _get_json(url, timeout=120):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _get_text(url, timeout=120):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode()


@contextlib.contextmanager
def _counting_syncs():
    """Count the calls of ``torch.cuda.synchronize`` and
    ``torch.cuda.Event.synchronize`` made inside the block."""
    calls = {"torch.cuda.synchronize": 0, "Event.synchronize": 0}
    sync, ev_sync = torch.cuda.synchronize, torch.cuda.Event.synchronize

    def counted_sync(*a, **k):
        calls["torch.cuda.synchronize"] += 1
        return sync(*a, **k)

    def counted_ev(self, *a, **k):
        calls["Event.synchronize"] += 1
        return ev_sync(self, *a, **k)

    torch.cuda.synchronize = counted_sync
    torch.cuda.Event.synchronize = counted_ev
    try:
        yield calls
    finally:
        torch.cuda.synchronize = sync
        torch.cuda.Event.synchronize = ev_sync


def _lm_flops_analytic(batch, seq) -> dict:
    """6 x the non-embedding matmul parameters x tokens, plus 3.5 x the
    causal attention forward (its two products over the visible pairs)."""
    hid = DIM * FFN_MULT
    params = LAYERS * (4 * DIM * DIM + 2 * DIM * hid) + DIM * VOCAB
    attn_fwd = LAYERS * 4.0 * DIM * batch * seq * (seq + 1) / 2
    return {"matmul_params": params, "attention_fwd": attn_fwd,
            "flops": 6.0 * params * batch * seq + 3.5 * attn_fwd}


def _telemetry_train(paddle, topo, values, feed, on, metrics_url=None):
    """TRAIN_STEPS Adam steps of the LM under ``bf16`` with telemetry on or
    off, deterministic algorithms, counts set to 0 just before and read
    just after, the sync calls counted inside the step loop.  The loop
    reads no loss (each is read after it); with ``metrics_url`` it scrapes
    ``/metrics`` and ``/executables`` after the third step."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.observability import executables as ex

    obs.reset()
    ex.EXECUTABLES.reset()
    (obs.enable if on else obs.disable)()
    tr = _trainer(paddle, topo, values)
    events, host_s, mid = [], [], {}

    def handler(e):
        if isinstance(e, paddle.event.BeginIteration):
            host_s.append(time.perf_counter())
        elif isinstance(e, paddle.event.EndIteration):
            host_s[-1] = time.perf_counter() - host_s[-1]
            events.append(e)
            if metrics_url and e.batch_id == 2:
                mid["metrics"] = _get_text(metrics_url + "/metrics")
                mid["executables"] = _get_json(metrics_url + "/executables")

    ops.reset_launch_counts()
    with _deterministic():
        t0 = time.perf_counter()
        with _counting_syncs() as syncs:
            tr.train(lambda: iter([feed] * TRAIN_STEPS),
                     event_handler=handler)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    losses = [e.cost for e in events]
    del tr
    torch.cuda.empty_cache()
    return {"losses": losses, "launches": launches, "syncs": syncs,
            "host_step_ms": sorted(host_s)[len(host_s) // 2] * 1e3,
            "wall_ms_per_step": wall / TRAIN_STEPS * 1e3, "mid": mid}


def telemetry_train() -> dict:
    """The LM as ``train_path`` builds it, under ``bf16`` at TRAIN_BATCH x
    MAX_LEN, TRAIN_STEPS steps with telemetry on and ``serve_metrics`` on
    port 0 (scraped during and after the run), then the same steps with
    it off: the batches counter, the trainer row's dispatches and device
    time, kernels 1 to 3 LAYERS times a step in both runs, the losses bit
    for bit, no sync call in the telemetry-on loop, the row's FLOPs (the
    flop counter's plus the kernels' own counts) within
    TELEMETRY_FLOP_BAND of the analytic count; ``trainer_mfu`` and both
    step times.  Then ``utils.profiler.profiler()`` around
    TELEMETRY_PROFILE_STEPS steps: its Chrome trace holds the
    ``trainer/step`` ranges and the flash kernels."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.observability import executables as ex
    from paddle_tpu_torch.observability import metrics as m
    from paddle_tpu_torch.observability import sinks
    from paddle_tpu_torch.utils import profiler as prof

    paddle, topo = _train_model()
    values = random_values(SEED)
    seqs = np.random.RandomState(SEED + 1).randint(
        0, VOCAB, size=(TRAIN_BATCH, MAX_LEN + 1)).astype(np.int32)
    feed = trainer_feed(seqs[:, :-1], seqs[:, 1:])
    _policy("bf16")
    server = sinks.serve_metrics(
        0, extra_handlers={"/executables": ex.http_handler})
    url = f"http://127.0.0.1:{server.server_port}"
    try:
        on = _telemetry_train(paddle, topo, values, feed, True, url)
        final = _get_text(url + "/metrics")
        snap = _get_json(url + "/executables")
        off = _telemetry_train(paddle, topo, values, feed, False)
        obs.enable()
        with tempfile.TemporaryDirectory(prefix="ptt_prof_") as tmp:
            tr = _trainer(paddle, topo, values)
            with prof.profiler(tmp):
                tr.train(lambda: iter([feed] * TELEMETRY_PROFILE_STEPS),
                         event_handler=lambda e: None)
                torch.cuda.synchronize()
            del tr
            path = os.path.join(tmp, "trace.json")
            trace_bytes = os.path.getsize(path)
            with open(path) as f:
                doc = json.load(f)
    finally:
        obs.disable()
        _policy("fp32")
        server.shutdown()
        server.server_close()
        torch.cuda.empty_cache()
    evs = doc.get("traceEvents", ())
    kernels = [e.get("name", "") for e in evs if e.get("cat") == "kernel"]
    prof_counts = {
        "trainer/step": sum(e.get("name") == "trainer/step"
                            and e.get("cat") == "user_annotation"
                            for e in evs),
        "flash_fwd kernels": sum("flash_fwd" in n for n in kernels),
        "flash_bwd kernels": sum("flash_bwd" in n for n in kernels)}
    batches = m.snapshot_value(_prom_snapshot(final),
                               "trainer_batches_total")
    rows = [r for r in snap["executables"] if r["stack"] == "trainer"]
    row = rows[0] if len(rows) == 1 else None
    cost = (row or {}).get("cost") or {}
    pairs = TRAIN_BATCH * MAX_LEN * (MAX_LEN + 1) / 2
    kernel_want = LAYERS * (4.0 + 8.0 + 6.0) * DIM * pairs
    analytic = _lm_flops_analytic(TRAIN_BATCH, MAX_LEN)
    want = LAYERS * TRAIN_STEPS
    bad = []
    if batches != TRAIN_STEPS:
        bad.append(f"trainer_batches_total {batches}")
    if row is None or row["dispatches"] != TRAIN_STEPS \
            or not row["device_us"] > 0:
        bad.append(f"trainer rows {rows}")
    for name, run in (("on", on), ("off", off)):
        got = {k: run["launches"][k] for k in TRAIN_KERNELS}
        got16 = {k: run["launches"][f"{k}_bf16"] for k in TRAIN_KERNELS}
        if any(v != want for v in got.values()) or got16 != got:
            bad.append(f"telemetry {name}: launches {got} {got16}, "
                       f"expected {want} each")
    if on["losses"] != off["losses"]:
        bad.append(f"losses on {on['losses']} != off {off['losses']}")
    if any(on["syncs"].values()):
        bad.append(f"sync calls in the telemetry-on loop {on['syncs']}")
    flops = cost.get("flops")
    if not flops or flops != cost.get("aten_flops", 0) \
            + cost.get("kernel_flops", 0):
        bad.append(f"the row's cost {cost}")
    elif cost["kernel_flops"] != kernel_want:
        bad.append(f"kernel flops {cost['kernel_flops']} != "
                   f"{kernel_want}")
    elif not abs(flops / analytic["flops"] - 1) <= TELEMETRY_FLOP_BAND:
        bad.append(f"flops {flops:.4g} against analytic "
                   f"{analytic['flops']:.4g}")
    if "trainer_batches_total 3" not in on["mid"].get("metrics", ""):
        bad.append("the mid-run /metrics scrape")
    if not prof_counts["trainer/step"] == TELEMETRY_PROFILE_STEPS \
            or not prof_counts["flash_fwd kernels"] \
            or not prof_counts["flash_bwd kernels"]:
        bad.append(f"the profiler trace: {prof_counts}")
    mfu = m.snapshot_value(_prom_snapshot(final), "trainer_mfu")
    print(f"telemetry, LM bf16 {TRAIN_BATCH} x {MAX_LEN}, {TRAIN_STEPS} "
          f"steps: trainer_batches_total {batches}; trainer row "
          f"{(row or {}).get('exe')} dispatches "
          f"{(row or {}).get('dispatches')} device "
          f"{(row or {}).get('device_us', 0) / 1e3:.1f} ms (first step "
          f"included: it is the build, counted under the flop counter); "
          f"cost {flops or 0:.4g} FLOP a step = aten "
          f"{cost.get('aten_flops', 0):.4g} + kernels "
          f"{cost.get('kernel_flops', 0):.4g} (analytic "
          f"{analytic['flops']:.4g}: 6 x {analytic['matmul_params']} "
          f"non-embedding matmul parameters x {TRAIN_BATCH * MAX_LEN} "
          f"tokens + 3.5 x {analytic['attention_fwd']:.4g}; ratio "
          f"{(flops or 0) / analytic['flops']:.3f}); trainer_mfu "
          f"{mfu if 'trainer_mfu ' in final else 'absent (no peak)'} "
          f"against {snap['peak_flops']} FLOP/s; median host step "
          f"telemetry on {on['host_step_ms']:.1f} ms, off "
          f"{off['host_step_ms']:.1f} ms; wall a step (end synced) on "
          f"{on['wall_ms_per_step']:.1f} ms, off "
          f"{off['wall_ms_per_step']:.1f} ms; losses equal bit for bit: "
          f"{on['losses'] == off['losses']}; sync calls in the "
          f"telemetry-on loop {on['syncs']}; profiler trace "
          f"{trace_bytes / 1e6:.1f} MB {prof_counts}", flush=True)
    if bad:
        raise AssertionError("telemetry, training: " + "; ".join(bad))
    return {"batches": batches, "row": row, "analytic": analytic,
            "flops_ratio": flops / analytic["flops"], "trainer_mfu": mfu,
            "peak_flops": snap["peak_flops"], "losses": on["losses"],
            "host_step_ms": {"on": on["host_step_ms"],
                             "off": off["host_step_ms"]},
            "wall_ms_per_step": {"on": on["wall_ms_per_step"],
                                 "off": off["wall_ms_per_step"]},
            "syncs": on["syncs"], "profile": prof_counts,
            "launches": {k: on["launches"][k] for k in TRAIN_KERNELS}}


def _prom_snapshot(text) -> dict:
    """A snapshot dict of the unlabelled samples of Prometheus text (what
    ``snapshot_value`` reads)."""
    out = []
    for line in text.splitlines():
        if line.startswith("#") or "{" in line or " " not in line:
            continue
        name, v = line.rsplit(" ", 1)
        out.append({"name": name, "labels": {}, "value": float(v)})
    return {"counters": out}


def _trace_tree_ok(spans) -> bool:
    """Every span's parent lies in the trace, but the client's root."""
    ids = {s["span_id"] for s in spans}
    roots = [s for s in spans if not s.get("parent_id")]
    return (len(roots) == 1 and roots[0]["name"] == "client/infer"
            and all(s["parent_id"] in ids for s in spans
                    if s.get("parent_id")))


def telemetry_serve() -> dict:
    """An in-process ``Router`` over one replica, an ``InferenceEngine``
    on a ``PagedDecoder`` at the serving widths (SLOTS slots), both with
    ``trace_sample=1.0`` and a ``telemetry_dir``; a
    ``ServingClient(trace_sample=1.0)`` sends TELEMETRY_REQUESTS greedy
    requests one after another, then one with a 1 ms deadline.  Each
    request's ``/trace/<id>`` at the router holds client, router and
    replica spans under one id with every parent in it; the shed
    request's row is in ``flight-<pid>.jsonl`` with reason ``deadline``;
    ``serving_decode_tokens_total`` equals ``/stats``
    ``decode.tokens``; ``/executables`` lists the decoder with device
    time; kernels 1 and 4 launch; the streams equal those of the same
    requests untraced (the decoder reset between)."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.models.transformer import PagedDecoder
    from paddle_tpu_torch.observability import executables as ex
    from paddle_tpu_torch.observability import tracectx
    from paddle_tpu_torch.serving import (DeadlineExceeded, InferenceEngine,
                                          Router, ServingClient)

    model = _serving_model()
    rng = np.random.RandomState(SEED + 33)
    reqs = [rng.randint(0, VOCAB, size=int(n)).astype(np.int32)
            for n in rng.randint(4, min(400, MAX_LEN - MAX_TOKENS),
                                 size=TELEMETRY_REQUESTS)]
    decoder = PagedDecoder(model, max_slots=SLOTS, block_size=BLOCK,
                           device="cuda")
    plain = InferenceEngine(decoder, default_max_tokens=MAX_TOKENS)
    try:
        untraced = [plain.infer([p], 600).tolist() for p in reqs]
    finally:
        plain.close()
    decoder.reset()
    obs.reset()
    ex.EXECUTABLES.reset()
    tracectx.STORE.clear()
    obs.enable()
    tmp = tempfile.mkdtemp(prefix="ptt_tele_")
    engine = InferenceEngine(decoder, default_max_tokens=MAX_TOKENS,
                             trace_sample=1.0, telemetry_dir=tmp)
    router = None
    try:
        url = f"http://127.0.0.1:{engine.serve(0).server_address[1]}"
        router = Router([url], trace_sample=1.0, telemetry_dir=tmp)
        rurl = f"http://127.0.0.1:{router.serve(0).server_address[1]}"
        client = ServingClient(rurl, trace_sample=1.0, timeout_s=600)
        ops.reset_launch_counts()
        traced, ids = [], []
        for p in reqs:
            before = set(tracectx.STORE.recent_ids(4096))
            traced.append(client.infer([p], max_tokens=MAX_TOKENS,
                                       deadline_s=600)["tokens"].tolist())
            new = [t for t in set(tracectx.STORE.recent_ids(4096)) - before
                   if any(s["name"] == "client/infer"
                          for s in tracectx.STORE.get(t))]
            ids.extend(new)
        launches = ops.launch_counts()
        shed_before = set(tracectx.STORE.recent_ids(4096))
        try:
            client.infer([reqs[-1]], max_tokens=MAX_TOKENS, deadline_s=0.001)
            shed = "answered"
        except DeadlineExceeded as e:
            shed = f"DeadlineExceeded: {e}"
        shed_ids = set(tracectx.STORE.recent_ids(4096)) - shed_before
        # the router finishes the shed's trace on its handler thread: wait
        # for its flight row before the servers close
        flight = os.path.join(tmp, f"flight-{os.getpid()}.jsonl")
        for _ in range(150):
            tracectx.FLIGHT_WRITER.drain()
            if os.path.exists(flight) and any(
                    json.loads(ln)["trace_id"] in shed_ids
                    for ln in open(flight).read().splitlines()):
                break
            time.sleep(0.1)
        stitched = {}
        for tid in ids:
            doc = _get_json(f"{rurl}/trace/{tid}")
            stitched[tid] = ({s["role"] for s in doc["spans"]},
                             {s["trace_id"] for s in doc["spans"]},
                             _trace_tree_ok(doc["spans"]))
        metrics = _get_text(url + "/metrics")
        stats = _get_json(url + "/stats")
        exes = _get_json(url + "/executables")
    finally:
        if router is not None:
            router.close()
        engine.close()
        obs.disable()
    tracectx.FLIGHT_WRITER.drain()
    rows = ([json.loads(ln) for ln in open(flight).read().splitlines()]
            if os.path.exists(flight) else [])
    shutil.rmtree(tmp, ignore_errors=True)
    tokens_metric = _prom_snapshot(metrics)
    from paddle_tpu_torch.observability import metrics as m
    tokens = m.snapshot_value(tokens_metric, "serving_decode_tokens_total")
    dec_rows = [r for r in exes["executables"] if r["stack"] == "serving"]
    shed_rows = [r for r in rows if r["trace_id"] in shed_ids]
    bad = []
    if len(ids) != TELEMETRY_REQUESTS:
        bad.append(f"{len(ids)} client traces")
    for tid, (roles, tids, tree) in stitched.items():
        if roles != {"client", "router", "replica"} or tids != {tid} \
                or not tree:
            bad.append(f"trace {tid}: roles {roles}, ids {tids}, "
                       f"parents {tree}")
            break
    if not any(r["reason"] == "deadline" for r in shed_rows):
        bad.append(f"the shed request's flight rows {shed_rows} ({shed})")
    if tokens != stats["decode"]["tokens"]:
        bad.append(f"serving_decode_tokens_total {tokens} != /stats "
                   f"{stats['decode']['tokens']}")
    if not dec_rows or not all(r["device_us"] > 0 for r in dec_rows):
        bad.append(f"/executables serving rows {dec_rows}")
    if min(launches[k] for k in SERVE_KERNELS) < 1:
        bad.append(f"launches {launches}")
    if traced != untraced:
        bad.append("traced streams differ from the untraced ones")
    print(f"telemetry, serving: {TELEMETRY_REQUESTS} greedy requests "
          f"client -> router -> replica ({SLOTS}-slot PagedDecoder), "
          f"{len(ids)} traces stitched at the router with client, router "
          f"and replica spans under one id each; the 1 ms deadline: "
          f"{shed}, flight rows {[(r['reason'], r['role']) for r in shed_rows]}"
          f"; serving_decode_tokens_total {tokens} = /stats "
          f"{stats['decode']['tokens']}; /executables serving rows "
          f"{[(r['kind'], r['dispatches'], round(r['device_us'] / 1e3, 1)) for r in dec_rows]}"
          f" (kind, dispatches, device ms); launches "
          f"{ {k: launches[k] for k in SERVE_KERNELS} }; streams equal to "
          f"the untraced run: {traced == untraced}", flush=True)
    if bad:
        raise AssertionError("telemetry, serving: " + "; ".join(bad))
    return {"traces": len(ids), "shed": shed,
            "flight_reasons": [r["reason"] for r in shed_rows],
            "decode_tokens": tokens,
            "executables": [{k: r[k] for k in ("exe", "kind", "dispatches",
                                                "device_us")}
                            for r in dec_rows],
            "launches": {k: launches[k] for k in SERVE_KERNELS},
            "streams_equal": traced == untraced}


def _serving_model():
    """The serving slice's model (``main_path``'s) from the seeded
    weights, through a checkpoint."""
    from paddle_tpu_torch.io import checkpoint
    from paddle_tpu_torch.models.transformer import params_from_jax

    with tempfile.TemporaryDirectory(prefix="ptt_smoke_") as tmp:
        checkpoint.save_params(tmp, random_values(SEED))
        snap = checkpoint.load(tmp)
        return params_from_jax(checkpoint.params_of(snap), num_heads=HEADS)


def telemetry_slice() -> dict:
    """Phase 26: item 13a, the telemetry spine traced on the card through
    the LM's bf16 training (``telemetry_train``) and paged serving
    (``telemetry_serve``); a ``{"telemetry": ...}`` JSON line."""
    t0 = time.perf_counter()
    out = {"train": telemetry_train()}
    torch.cuda.empty_cache()
    out["serve"] = telemetry_serve()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"telemetry phase: {out['seconds']:.1f}s", flush=True)
    return out


TELEMETRY_PHASES = {"telemetry": telemetry_slice}


def selected(argv) -> list:
    """The phases ``--only=<name>[,<name>...]`` names (None without it):
    ``dispatch``, ``v2`` or ``sparse`` for phase 14, 15 or 16 whole, or
    any part of one (DISPATCH_PHASES, V2_PHASES, CTR_PHASES), ``ckpt``
    (phase 17), ``serve`` (phase 18), ``serve_fwd`` (phase 19), ``gen``
    (phase 20), ``vision`` (phase 21), ``book`` (phase 22), ``v2rest``
    (phase 23), ``fluid`` (phase 24), ``fluid_cf`` (phase 25) or
    ``telemetry`` (phase 26), for a development run; the full run takes no
    arguments."""
    only = [a.split("=", 1)[1] for a in argv if a.startswith("--only=")]
    if not only:
        return None
    groups = {"dispatch": list(DISPATCH_PHASES), "v2": list(V2_PHASES),
              "sparse": list(CTR_PHASES)}
    names = [n for a in only for g in a.split(",")
             for n in groups.get(g, [g])]
    unknown = [n for n in names if n not in DISPATCH_PHASES
               and n not in V2_PHASES and n not in CTR_PHASES
               and n not in CKPT_PHASES and n not in SERVE_PHASES
               and n not in SERVE_FWD_PHASES and n not in GEN_PHASES
               and n not in VISION_PHASES and n not in BOOK_PHASES
               and n not in V2REST_PHASES and n not in FLUID_PHASES
               and n not in FLUID_CF_PHASES and n not in TELEMETRY_PHASES]
    if unknown:
        raise SystemExit(f"chip_smoke: no phase {unknown}; --only= takes "
                         f"{sorted(groups) + sorted(DISPATCH_PHASES)}"
                         f" + {sorted(V2_PHASES)} + {sorted(CTR_PHASES)}"
                         f" + {sorted(CKPT_PHASES)} + {sorted(SERVE_PHASES)}"
                         f" + {sorted(SERVE_FWD_PHASES)}"
                         f" + {sorted(GEN_PHASES)}"
                         f" + {sorted(VISION_PHASES)}"
                         f" + {sorted(BOOK_PHASES)}"
                         f" + {sorted(V2REST_PHASES)}"
                         f" + {sorted(FLUID_PHASES)}"
                         f" + {sorted(FLUID_CF_PHASES)}"
                         f" + {sorted(TELEMETRY_PHASES)}")
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
            if phase is not None:
                out[name] = phase(dev, gen, flush)
            else:
                out[name] = {**DISPATCH_PHASES, **CTR_PHASES,
                             **CKPT_PHASES, **SERVE_PHASES,
                             **SERVE_FWD_PHASES, **GEN_PHASES,
                             **VISION_PHASES, **BOOK_PHASES,
                             **V2REST_PHASES, **FLUID_PHASES,
                             **FLUID_CF_PHASES, **TELEMETRY_PHASES}[name]()
            torch.cuda.empty_cache()
        print(card, flush=True)
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
    sparse = sparse_slice()
    ckpt = ckpt_slice()
    cl = ckpt["launches"]
    serve = serve_slice()
    serve_fwd = serve_fwd_slice()
    torch.cuda.empty_cache()
    gen = gen_slice(nmt.pop("trained"))
    torch.cuda.empty_cache()
    sass = sass_phase()
    resnet = resnet_path()
    torch.cuda.empty_cache()
    resnet16 = resnet_bf16_path()
    torch.cuda.empty_cache()
    resnet_f16 = resnet_bf16_path("fp16")
    torch.cuda.empty_cache()
    vision = vision_slice()
    torch.cuda.empty_cache()
    book = book_slice()
    torch.cuda.empty_cache()
    v2rest = v2rest_slice()
    nl = v2rest["networks"]["mha"]["launches"]
    torch.cuda.empty_cache()
    fluid = fluid_slice()
    torch.cuda.empty_cache()
    fluid_cf = fluid_cf_slice()
    torch.cuda.empty_cache()
    telemetry = telemetry_slice()
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
         "launches_ckpt": cl["flash_fwd_f32"],
         "launches_serve": serve["launches"]["flash_fwd"],
         "launches_serve_fwd": serve_fwd["launches"],
         "serve_fwd_shape": serve_fwd["kernel1"],
         "launches_replay": dispatch["lm"]["replay_launches"],
         "launches_remat": dispatch["remat"]["flash_fwd_on"],
         "launches_networks": nl["flash_fwd"],
         "train_shape": dict(bwd["fwd"], shape=bwd["shape"])},
        {"name": "flash_bwd_dkdv", "route": "cuda",
         "source": "paddle_tpu_torch/ops/csrc/flash_bwd.cu",
         "replaces": "paddle_tpu/ops/flash_attention.py:285",
         "launches": tl["flash_bwd_dkdv"], **bwd["dkdv"],
         "launches_networks": nl["flash_bwd_dkdv"],
         "shape": bwd["shape"]},
        {"name": "flash_bwd_dq", "route": "cuda",
         "source": "paddle_tpu_torch/ops/csrc/flash_bwd.cu",
         "replaces": "paddle_tpu/ops/flash_attention.py:370",
         "launches": tl["flash_bwd_dq"], **bwd["dq"],
         "launches_networks": nl["flash_bwd_dq"],
         "shape": bwd["shape"]},
        {"name": "paged_decode", "route": "cuda",
         "source": "paddle_tpu_torch/ops/csrc/paged_decode.cu",
         "replaces": "paddle_tpu/ops/paged_attention.py:59",
         "launches": launches["paged_decode"], "max_abs_err": paged_err,
         "launches_ckpt": cl["paged_decode"],
         "launches_serve": serve["launches"]["paged_decode"],
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
         "launches_srl": book["srl"]["fp32"]["launches"],
         "srl_shape": book["srl"]["kernel5"],
         **rnn["lstm"]},
        {"name": "gru_step", "route": "cuda",
         "source": "paddle_tpu_torch/ops/csrc/rnn_step.cu",
         "replaces": "paddle_tpu/ops/fused_rnn.py:144",
         "launches": nmt["launches"]["gru_step"],
         "launches_replay": dispatch["nmt"]["replay_launches"],
         "launches_gen": gen["launches"],
         "gen_shape": gen["times"]["kernel6_at_gen_shape"],
         "launches_ocr": book["ocr"]["launches"],
         "ocr_shape": book["ocr"]["kernel6"],
         **rnn["gru"]},
        {"name": "bn_fwd_stats", "route": "cuda",
         "source": "paddle_tpu_torch/ops/csrc/bn_stats.cu",
         "replaces": "paddle_tpu/ops/fused_bn.py:58",
         "launches": resnet["launches"]["bn_fwd_stats"],
         "launches_vgg": vision["vgg"]["fp32"]["launches"],
         "vgg_shape": vision["vgg"]["alone"]["f32"]["bn_fwd_stats"],
         "launches_ssd": book["ssd"]["launches"],
         "ssd_shapes": {k: v["bn_fwd_stats"]
                        for k, v in book["ssd"]["alone"].items()},
         **conv["bn_fwd_stats"]},
        {"name": "bn_bwd_stats", "route": "cuda",
         "source": "paddle_tpu_torch/ops/csrc/bn_stats.cu",
         "replaces": "paddle_tpu/ops/fused_bn.py:145",
         "launches": resnet["launches"]["bn_bwd_stats"],
         "launches_vgg": vision["vgg"]["fp32"]["launches_bwd"],
         "vgg_shape": vision["vgg"]["alone"]["f32"]["bn_bwd_stats"],
         "launches_ssd": book["ssd"]["launches_bwd"],
         "ssd_shapes": {k: v["bn_bwd_stats"]
                        for k, v in book["ssd"]["alone"].items()},
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
             launches_ckpt=cl["flash_fwd_bf16"],
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
         "launches_ckpt": cl["flash_bwd_dkdv_bf16"],
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
         "launches_ckpt": cl["flash_bwd_dq_bf16"],
         "at_64k": dict(v2["flash_64k"]["times"]["dq"],
                        dq_row_err=v2["flash_64k"]["errs"]["dq"]),
         **{k: v for k, v in bwd16["dq"].items()},
         "shape": bwd16["shape"]},
        dict(rnn16["lstm"]["x bfloat16, mask float32"], name="lstm_step_bf16",
             route="cuda", source="paddle_tpu_torch/ops/csrc/rnn_step.cu",
             replaces="paddle_tpu/ops/fused_rnn.py:44",
             launches=rnn16_paths["lstm_route"]["launches"]["lstm_step_bf16"],
             launches_replay=dispatch["lstm_route_bf16"]["replay_launches"],
             launches_srl=book["srl"]["bf16"]["launches"],
             instances=rnn16["lstm"]),
        dict(rnn16["gru"]["x bfloat16, mask float32"], name="gru_step_bf16",
             route="cuda", source="paddle_tpu_torch/ops/csrc/rnn_step.cu",
             replaces="paddle_tpu/ops/fused_rnn.py:144",
             launches=rnn16_paths["nmt"]["launches"]["gru_step_bf16"],
             instances=rnn16["gru"]),
        *(dict(conv16[k], name=f"{k}_bf16", route="cuda",
               source=f"paddle_tpu_torch/ops/csrc/{src}", replaces=site,
               launches=resnet16["fused"]["launches"][f"{k}_bf16"],
               **({"launches_vgg": vision["vgg"]["bf16"][
                   "launches" if k == "bn_fwd_stats" else "launches_bwd"],
                   "vgg_shape": vision["vgg"]["alone"]["bf16"][k]}
                  if k.startswith("bn_") else {}))
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
    print(json.dumps({"sparse": sparse}), flush=True)
    print(json.dumps({"ckpt": ckpt}), flush=True)
    print(json.dumps({"serve": serve}), flush=True)
    print(json.dumps({"serve_fwd": serve_fwd}), flush=True)
    print(json.dumps({"gen": {k: gen[k] for k in (
        "shape", "parity", "times", "cli", "item9")}}), flush=True)
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
    print(json.dumps({"vision": vision}), flush=True)
    print(json.dumps({"book": book}), flush=True)
    print(json.dumps({"v2rest": v2rest}), flush=True)
    print(json.dumps({"fluid": fluid}), flush=True)
    print(json.dumps({"fluid_cf": fluid_cf}), flush=True)
    print(json.dumps({"telemetry": telemetry}), flush=True)
    for k in kernels:       # fluid_cf reaches none of the kernels
        k["launches_fluid_cf"] = fluid_cf["launches"].get(k["name"], 0)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
