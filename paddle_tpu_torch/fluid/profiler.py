"""fluid.profiler parity (reference: python/paddle/v2/fluid/profiler.py
:33 cuda_profiler, :76 profiler; counterpart of
``paddle_tpu/fluid/profiler.py``): thin wrappers over the framework
profiler — named host timers + the ``torch.profiler`` trace bridge."""

from __future__ import annotations

import contextlib
from typing import Optional

from paddle_tpu_torch.utils.profiler import (GLOBAL_STATS, print_stats,
                                             profiler as _device_profiler,
                                             reset_profiler, timer)

__all__ = ["profiler", "device_profiler", "reset_profiler", "print_stats",
           "timer"]


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: str = "total",
             log_dir: Optional[str] = None):
    """`with fluid.profiler.profiler(): exe.run(...)` — captures a device
    trace and prints the host timer table at exit (the reference prints
    its event table from ParseEvents), sorted by ``sorted_key``
    (total | avg | max | count).  ``state`` is accepted for reference
    parity only: the capture takes CPU and CUDA activity together."""
    from paddle_tpu_torch.utils.profiler import _SORT_KEYS

    if sorted_key not in _SORT_KEYS:
        # fail fast — a typo must not surface only AFTER the profiled
        # workload has run
        raise ValueError(f"sorted_key must be one of "
                         f"{sorted(_SORT_KEYS)}, got {sorted_key!r}")
    with _device_profiler(log_dir):
        yield
    print_stats(sorted_key=sorted_key)


def device_profiler(log_dir: Optional[str] = None):
    """Trace-only context (reference cuda_profiler analogue)."""
    return _device_profiler(log_dir)
