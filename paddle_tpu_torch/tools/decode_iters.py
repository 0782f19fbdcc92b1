"""Serving iterations of the full-width transformer LM on the card.

    python -m paddle_tpu_torch.tools.decode_iters

The LM at ``bench_transformer``'s widths (vocab 32000, dim 512, 4 x 128
heads, 8 layers, max_len 4096) with random weights from a numpy seed,
served by ``PagedDecoder`` (8 slots, blocks of 16) on the kernel path
and on the plain path (``decode_kernel="torch"``).  Per path, one mixed
iteration at full residency (8 rows decoding just past their prompts):
the host-clock median of a decode-only iteration and of one with the
longest prompt's prefill chunk fused in, and the decode-only iteration's
device busy time and idle share from ``torch.profiler``.  Prints the
card's name and power limit and one JSON line.

It uses only surfaces every revision of the port has had
(``params_from_jax``, ``PagedDecoder.mixed_step``), so the same file
measures an older checkout in the same call, run as a file with that
checkout first on the path:

    cd OLD && PYTHONPATH=. python3 NEW/paddle_tpu_torch/tools/decode_iters.py

``chip_smoke.py`` takes its model, prompts and iteration timing from
here.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

# bench.py bench_transformer's defaults
VOCAB, DIM, HEADS, LAYERS, FFN_MULT, MAX_LEN = 32000, 512, 4, 8, 4, 4096
SLOTS, BLOCK = 8, 16
MAX_TOKENS = 32
SEED = 1234


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
    """Eight prompts of 5 to 1500 tokens, two sharing a 64-token prefix."""
    rng = np.random.RandomState(SEED)
    shared = rng.randint(0, VOCAB, size=64)
    out = [rng.randint(0, VOCAB, size=n) for n in (5, 17, 200, 513, 1000,
                                                   1500)]
    out.insert(2, np.concatenate([shared, rng.randint(0, VOCAB, size=7)]))
    out.insert(3, np.concatenate([shared, rng.randint(0, VOCAB, size=30)]))
    return [p.astype(np.int32) for p in out]


def _busy_ms(prof) -> float:
    """The union of the device's own activity intervals in a trace."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end_us = 0.0, float("-inf")
    for start, stop in spans:
        busy_us += max(0.0, stop - max(start, end_us))
        end_us = max(end_us, stop)
    return busy_us / 1e3


def iteration_ms(dec, reqs, traced: int = 5) -> dict:
    """One mixed iteration at full residency (every slot decoding just past
    its prompt): the host-clock median of 10 alone (``decode_ms``) and
    with the longest prompt's prefill chunk fused in (``chunk_ms``), after
    3 warm-up calls each, and a ``torch.profiler`` trace of ``traced``
    decode-only iterations: the device's busy time a call
    (``decode_busy_ms``) and its idle share (``decode_idle_share``, 1 -
    busy / wall).  Leaves the decoder reset."""
    from torch.profiler import ProfilerActivity, profile

    slots = len(reqs)
    dec.reset()
    pos = np.array([len(p) + MAX_TOKENS // 2 for p in reqs], np.int32)
    for s, p in enumerate(reqs):
        dec.alloc_sequence(s, p)
        dec.ensure_blocks(s, int(pos[s]))
    toks = np.ones(slots, np.int32)
    live = np.ones(slots, bool)

    def median_ms(chunk):
        times = []
        for i in range(13):
            t0 = time.perf_counter()
            dec.mixed_step(slots, toks, pos, live=live, chunk=chunk)
            torch.cuda.synchronize()
            if i >= 3:
                times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[len(times) // 2]

    decode = median_ms(None)
    longest = int(np.argmax([len(p) for p in reqs]))
    chunk = median_ms((longest, reqs[longest], 0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(traced):
            dec.mixed_step(slots, toks, pos, live=live, chunk=None)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = _busy_ms(prof)
    dec.reset()
    return {"decode_ms": decode, "chunk_ms": chunk,
            "decode_busy_ms": busy / traced,
            "decode_idle_share": max(0.0, 1.0 - busy / wall)}


def main() -> int:
    from paddle_tpu_torch.models.transformer import (PagedDecoder,
                                                     params_from_jax)

    if not torch.cuda.is_available():
        raise SystemExit("decode_iters: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    model = params_from_jax(random_values(SEED), num_heads=HEADS)
    reqs = prompts()
    out = {}
    for name, kernel in (("kernels", None), ("plain", "torch")):
        kw = {} if kernel is None else {"decode_kernel": kernel}
        dec = PagedDecoder(model, max_slots=SLOTS, block_size=BLOCK,
                           device="cuda", **kw)
        out[name] = iteration_ms(dec, reqs)
        del dec
        torch.cuda.empty_cache()
    print(json.dumps({"decode_iters": out, "card": card,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
