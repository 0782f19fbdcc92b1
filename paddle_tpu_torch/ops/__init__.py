"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Every wrapper counts the launches of its kernel (``count_launch``), and
``launch_counts()`` reads them.  The counts are of kernel executions: a
call made while a CUDA graph captures runs nothing, so it adds nothing to
the counts and goes to the capture's record instead
(``recording_launches``); each replay of that graph then adds the record
(``add_launches``).

A wrapper also reports the work of each launch (``add_work``: its
floating-point operations, by the formula of its bound in ``PERF.md``)
while a count is open (``recording_work``): the executable registry
counts a program's cost over one step with it, beside
``torch.utils.flop_counter``, which cannot see a ``ctypes`` launch.
"""

from __future__ import annotations

import contextlib

import torch

# the records of the captures in progress, innermost last:
# {(wrapper, counter name): launches}
_records: list = []
# the work counts open (``recording_work``), innermost last: {kernel: flops}
_work: list = []


def _wrappers() -> dict:
    # imported here: ops.paged_attention imports layers.attention, which
    # imports ops.flash_attention - a package-level import would cycle
    from paddle_tpu_torch.ops.flash_attention import (flash_bwd_dkdv_cuda,
                                                      flash_bwd_dq_cuda,
                                                      flash_fwd_cuda)
    from paddle_tpu_torch.ops.fused_rnn import gru_step_cuda, lstm_step_cuda
    from paddle_tpu_torch.ops.paged_attention import paged_decode_cuda
    from paddle_tpu_torch.ops.conv_bn import (conv3x3_stats_cuda,
                                              matmul_stats_cuda)
    from paddle_tpu_torch.ops.fused_bn import (bn_bwd_stats_cuda,
                                               bn_fwd_stats_cuda)
    from paddle_tpu_torch.ops.flash_variants import run_fwd_cuda
    return {"flash_fwd": flash_fwd_cuda,
            "flash_bwd_dkdv": flash_bwd_dkdv_cuda,
            "flash_bwd_dq": flash_bwd_dq_cuda,
            "paged_decode": paged_decode_cuda,
            "lstm_step": lstm_step_cuda,
            "gru_step": gru_step_cuda,
            "bn_fwd_stats": bn_fwd_stats_cuda,
            "bn_bwd_stats": bn_bwd_stats_cuda,
            "matmul_stats": matmul_stats_cuda,
            "conv3x3_stats": conv3x3_stats_cuda,
            "flash_variants": run_fwd_cuda}


# the per-instance counts a wrapper may keep beside ``launches``
_DTYPE_COUNTS = ("bf16", "f16")


def _counters(wrapper, dtype) -> tuple:
    names = ("launches",)
    for sfx, dt in (("bf16", torch.bfloat16), ("f16", torch.float16)):
        if dtype == dt and hasattr(wrapper, "launches_" + sfx):
            names += ("launches_" + sfx,)
    return names


def capturing() -> bool:
    """Whether the current stream is capturing a CUDA graph (never where
    PyTorch has no CUDA)."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def count_launch(wrapper, dtype=None) -> None:
    """One launch more of ``wrapper``'s kernel: on ``launches``, and on
    ``launches_bf16`` or ``launches_f16`` for an instance of that dtype.
    Under a CUDA graph capture the launch is recorded, not counted (the
    innermost ``recording_launches`` record takes it; with none open it
    is dropped, since a graph nobody replays through ``add_launches``
    never runs it)."""
    names = _counters(wrapper, dtype)
    if capturing():
        if _records:
            rec = _records[-1]
            for name in names:
                rec[wrapper, name] = rec.get((wrapper, name), 0) + 1
        return
    for name in names:
        setattr(wrapper, name, getattr(wrapper, name) + 1)


@contextlib.contextmanager
def recording_launches():
    """Open a record of the launches a CUDA graph's capture makes; yields
    the record, ``{(wrapper, counter name): launches}``, for
    ``add_launches`` at each replay."""
    rec: dict = {}
    _records.append(rec)
    try:
        yield rec
    finally:
        _records.remove(rec)


def add_launches(record: dict) -> None:
    """Count one replay of a captured graph: every kernel it holds ran as
    many times as its capture recorded."""
    for (wrapper, name), n in record.items():
        setattr(wrapper, name, getattr(wrapper, name) + n)


def launch_counts() -> dict:
    """Launches of each kernel so far in this process (the plain versions
    are not counted; a graph's launches count at each replay, not at its
    capture): ``name`` counts every launch of the wrapper, at any
    dtype; ``name_bf16`` and ``name_f16`` those of its bf16 and float16
    instances alone, for the wrappers that have them."""
    counts = {}
    for name, fn in _wrappers().items():
        counts[name] = fn.launches
        for sfx in _DTYPE_COUNTS:
            if hasattr(fn, "launches_" + sfx):
                counts[f"{name}_{sfx}"] = getattr(fn, "launches_" + sfx)
    return counts


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
        for sfx in _DTYPE_COUNTS:
            if hasattr(fn, "launches_" + sfx):
                setattr(fn, "launches_" + sfx, 0)


def work_recording() -> bool:
    """Whether a work count is open (a wrapper computes its work only
    then)."""
    return bool(_work)


@contextlib.contextmanager
def recording_work():
    """Open a count of the hand kernels' work; yields ``{kernel name:
    floating-point operations}`` of the launches made inside it."""
    rec: dict = {}
    _work.append(rec)
    try:
        yield rec
    finally:
        _work.remove(rec)


def add_work(name: str, flops: float) -> None:
    """One launch's work of kernel ``name``, into every open count."""
    for rec in _work:
        rec[name] = rec.get(name, 0.0) + float(flops)


def visible_pairs(lq: int, lk: int, causal: bool, q_offset: int = 0,
                  kv_offset: int = 0, kv_lens=None) -> float:
    """The (query, key) pairs attention visits for one head, summed over
    the batch: each query row sees the keys below its batch row's
    length, and under ``causal`` only those at or before its position
    (``q_offset + r >= kv_offset + c``).  ``kv_lens`` (one length a
    batch row, a host sequence) defaults to full rows of one batch row."""
    lens = [lk] if kv_lens is None else [min(int(n), lk) for n in kv_lens]
    total = 0
    for n in lens:
        if not causal:
            total += lq * n
            continue
        for r in range(lq):
            total += min(max(q_offset + r - kv_offset + 1, 0), n)
    return float(total)
