"""Device timing and the card's peak rates, shared by the measurement
entry points (``tools/flash_variants.py``) and ``chip_smoke.py``."""

from __future__ import annotations

import torch

PEAK_F32_FLOPS = 67e12        # H100 SXM, float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12      # H100 SXM, dense bf16 on the tensor cores
PEAK_TF32_FLOPS = 495e12      # H100 SXM, dense TF32 on the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3


def bound(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS):
    """(least ms, "operations" or "bytes"): the larger of flops over
    ``peak`` and bytes over the memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, flush, iters=20, warmup=3, lead=False) -> float:
    """Median device time of one call on CUDA events, ``flush`` (a buffer
    larger than L2) zeroed before each.  With ``lead`` the device first
    spins for ~10 ms (``torch.cuda._sleep``), so the host has enqueued
    every call before the device reaches them and a call shorter than its
    own launch overhead is timed on the device alone, not at the host's
    pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if lead:
        torch.cuda._sleep(20_000_000)
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
