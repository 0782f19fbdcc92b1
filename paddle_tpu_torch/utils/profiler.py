"""Profiling: named host timers and the ``torch.profiler`` bridge
(counterpart of ``paddle_tpu/utils/profiler.py``).

Three reference mechanisms collapse here:
  * Stat/REGISTER_TIMER RAII timers aggregated in a global StatSet and
    printed as a table (reference: paddle/utils/Stat.h:63,114,230-260)
  * fluid's RecordEvent profiler (reference: paddle/fluid/platform/
    profiler.h:25-141, python v2/fluid/profiler.py:33,76): here
    ``profiler(log_dir)``, a ``torch.profiler`` capture with CUDA
    activity on the card, written as one Chrome trace in which the hand
    kernels' launches and the trainer's ``trainer/step`` host ranges
    both appear
  * per-layer hooks (FLAGS_show_layer_stat): ``layer_cost_report``
    counts each layer's forward FLOPs with the flop counter and reads
    each layer's time from one profiled step, the layers named by
    ``record_function`` ranges (``topology.layer_scope``).
"""

from __future__ import annotations

import contextlib
import functools
import os
import tempfile
import threading
import time
import warnings
from typing import Optional

import torch


class _Stat:
    __slots__ = ("name", "count", "total", "max")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def add(self, dt: float) -> None:
        self.count += 1
        self.total += dt
        if dt > self.max:
            self.max = dt


class StatSet:
    """Aggregated named timers (reference StatSet)."""

    def __init__(self):
        self._stats = {}
        self._lock = threading.Lock()

    def add(self, name: str, dt: float) -> None:
        with self._lock:
            stat = self._stats.get(name)
            if stat is None:
                stat = self._stats[name] = _Stat(name)
            stat.add(dt)

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()

    def report(self, sorted_key: str = "total") -> str:
        """Stat table (the Stat.h printAllStatus UX), descending by
        ``sorted_key``: total | avg (alias ave) | max | count (alias
        calls)."""
        try:
            keyfn = _SORT_KEYS[sorted_key]
        except KeyError:
            raise ValueError(
                f"sorted_key must be one of {sorted(_SORT_KEYS)}, "
                f"got {sorted_key!r}")
        with self._lock:
            stats = sorted(self._stats.values(), key=keyfn, reverse=True)
        lines = [f"{'timer':<32} {'count':>8} {'total_ms':>12} "
                 f"{'avg_ms':>10} {'max_ms':>10}"]
        for s in stats:
            lines.append(
                f"{s.name:<32} {s.count:>8} {s.total * 1e3:>12.3f} "
                f"{s.total / s.count * 1e3:>10.3f} {s.max * 1e3:>10.3f}")
        return "\n".join(lines)

    def items(self):
        with self._lock:
            return {s.name: (s.count, s.total, s.max)
                    for s in self._stats.values()}


# report() sort orders (reference Stat.h sorts its table the same ways)
_SORT_KEYS = {
    "total": lambda s: s.total,
    "avg": lambda s: s.total / s.count if s.count else 0.0,
    "ave": lambda s: s.total / s.count if s.count else 0.0,
    "max": lambda s: s.max,
    "count": lambda s: s.count,
    "calls": lambda s: s.count,
}

GLOBAL_STATS = StatSet()

DEFAULT_LOG_DIR = os.path.join(tempfile.gettempdir(),
                               "paddle_tpu_profile")

# True while ``profiler`` captures: the trainer then names its steps
# with ``record_function`` ranges (one flag test a step otherwise)
PROFILING = False


@contextlib.contextmanager
def timer(name: str, stats: Optional[StatSet] = None):
    """REGISTER_TIMER_INFO equivalent: `with timer("ForwardTimer"): ...`"""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        (stats or GLOBAL_STATS).add(name, time.perf_counter() - t0)


def timed(name: str, stats: Optional[StatSet] = None):
    """Decorator form."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with timer(name, stats):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def reset_profiler() -> None:
    """fluid.profiler.reset_profiler parity."""
    GLOBAL_STATS.reset()


def print_stats(sorted_key: str = "total") -> None:
    """Host timer table; when step-level telemetry is enabled, the
    observability metrics table is appended."""
    print(GLOBAL_STATS.report(sorted_key=sorted_key))
    from paddle_tpu_torch import observability as _obs

    if _obs.enabled():
        table = _obs.render_table()
        if table:
            print(table)


def range_scope(name: str):
    """A ``record_function`` range named ``name`` while ``profiler``
    captures, else a null context."""
    if PROFILING:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


_START_TRACE_WARNED = False


@contextlib.contextmanager
def profiler(log_dir: Optional[str] = None, with_host_trace: bool = True):
    """Device profiler context (fluid.profiler.profiler parity): a
    ``torch.profiler`` capture of the CPU and, where a card is present,
    CUDA activity, exported on exit as ``<log_dir>/trace.json`` (Chrome
    trace-event JSON: Perfetto, ``chrome://tracing``).  Inside it the
    trainer's steps are ``trainer/step`` ranges and the hand kernels
    appear by name.  A capture that cannot start warns once and the
    region runs unprofiled (host timers still collected).  Yields the
    ``torch.profiler.profile`` (None when it did not start)."""
    global PROFILING, _START_TRACE_WARNED
    log_dir = log_dir or DEFAULT_LOG_DIR
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    try:
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    except Exception as e:  # noqa: BLE001 — degrade to host timers
        prof = None
        if not _START_TRACE_WARNED:
            _START_TRACE_WARNED = True
            warnings.warn(
                f"torch.profiler failed to start ({e!r}); device trace "
                f"disabled — host timers still collected",
                RuntimeWarning, stacklevel=3)
    PROFILING = prof is not None and with_host_trace
    t0 = time.perf_counter()
    try:
        yield prof
    finally:
        PROFILING = False
        GLOBAL_STATS.add("profiler_region", time.perf_counter() - t0)
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(log_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class TrainerTimers:
    """Per-pass timer report hooked on trainer events (the reference's
    --show_layer_stat / per-pass Stat dump UX)."""

    def __init__(self):
        self.stats = StatSet()
        self._t_batch = None

    def __call__(self, event) -> None:
        from paddle_tpu_torch import event as v2_event

        if isinstance(event, v2_event.BeginIteration):
            self._t_batch = time.perf_counter()
        elif isinstance(event, v2_event.EndIteration):
            if self._t_batch is not None:
                self.stats.add("batch", time.perf_counter() - self._t_batch)
        elif isinstance(event, v2_event.EndPass):
            print(self.stats.report())
            self.stats.reset()


def _device_time_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, attr, None)
        if v:
            return float(v)
    return 0.0


def layer_cost_report(trainer, feed: dict, top: int = 25):
    """Per-layer cost of one training step of ``trainer`` (a
    ``trainer.SGD``) on ``feed`` (the TPU package's per-layer HLO table
    becomes, on the port, a count and a profile of the step itself):

      * ``flops``: the layer's forward FLOPs, the flop counter's aten
        products plus its hand kernels' reported work, counted inside the
        layer's scope;
      * ``time_us``: the layer's time in one profiled step, from a
        ``record_function`` range named ``kind:name`` (device time on the
        card, CPU time off it).

    The step runs on copies of the trainer's state, which stays as it
    was.  Returns [(``kind:name``, {"flops": f, "time_us": t}), ...],
    most FLOPs first (the backward's ops, outside any layer, are
    ``"backward"``)."""
    from torch.utils.flop_counter import FlopCounterMode

    from paddle_tpu_torch import ops, topology

    rows: dict = {}
    counter = FlopCounterMode(display=False)

    class _Count:
        def __init__(self, spec):
            self.key = f"{spec.kind}:{spec.name}"

        def __enter__(self):
            self.f0 = counter.get_total_flops()
            self.w0 = sum(work.values())

        def __exit__(self, *exc):
            e = rows.setdefault(self.key, {"flops": 0.0, "time_us": 0.0})
            e["flops"] += (counter.get_total_flops() - self.f0
                           + sum(work.values()) - self.w0)

    with trainer.on_copies():
        with ops.recording_work() as work, counter, \
                topology.layer_scope(_Count):
            trainer._step(feed)
        total = counter.get_total_flops() + sum(work.values())
        inside = sum(e["flops"] for e in rows.values())
        rows["backward"] = {"flops": float(total - inside), "time_us": 0.0}
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof, \
                topology.layer_scope(
                    lambda spec: torch.profiler.record_function(
                        f"{spec.kind}:{spec.name}")):
            trainer._step(feed)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    on_card = torch.cuda.is_available()
    for evt in prof.key_averages():
        if evt.key in rows:
            rows[evt.key]["time_us"] = (_device_time_us(evt) if on_card
                                        else float(evt.cpu_time_total))
    return sorted(rows.items(), key=lambda kv: -kv[1]["flops"])[:top]


def print_layer_stats(trainer, feed: dict, top: int = 25) -> None:
    rows = layer_cost_report(trainer, feed, top)
    width = max((len(k) for k, _ in rows), default=10)
    print(f"{'layer':<{width}}  {'gflops':>10}  {'time_ms':>9}")
    for name, e in rows:
        print(f"{name:<{width}}  {e['flops'] / 1e9:>10.4f}  "
              f"{e['time_us'] / 1e3:>9.3f}")
