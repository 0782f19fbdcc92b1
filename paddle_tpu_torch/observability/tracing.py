"""Span tracing into a bounded ring buffer, exportable as Chrome
trace-event JSON.

The host-side twin of fluid's RecordEvent profiler (reference:
paddle/fluid/platform/profiler.h:25-141): named spans with wall-clock
start/duration, a per-step correlation id, and a fixed-capacity ring so
a long training run never grows memory.  The Chrome export
(``Tracer.to_chrome`` / ``sinks.write_chrome_trace``) opens in
Perfetto / ``chrome://tracing`` so host spans line up beside a
``torch.profiler``
device trace that ``utils/profiler.profiler`` captures.

Hot paths (fluid executor) record with explicit ``perf_counter_ns``
timestamps via ``Tracer.add`` — no context-manager allocation per step;
``Tracer.span`` is the convenience form for user code.  Everything is a
no-op while telemetry is disabled (see metrics.enable/disable).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from typing import Optional

from paddle_tpu_torch.observability import metrics as _metrics


class Tracer:
    """Bounded span ring buffer; oldest spans are overwritten.

    The ring is a ``deque(maxlen=capacity)``: its C-level append is
    atomic under the GIL, so the hot-path ``add`` takes NO lock — a
    fraction of a µs per span, which is what lets the executor record
    three spans per step inside the bench gate's overhead budget.

    Internal span layout (the contract ``metrics.record(spans=...)``
    bulk-appends against): ``(name, cat, start_ns, dur_ns, step, tid,
    args)`` with args a dict or None."""

    def __init__(self, capacity: int = 8192):
        self.capacity = int(capacity)
        self._buf = deque(maxlen=self.capacity)

    def add(self, name: str, start_ns: int, dur_ns: int, cat: str = "host",
            step: Optional[int] = None, args: Optional[dict] = None) -> None:
        """Record one completed span.  start_ns/dur_ns are
        time.perf_counter_ns values (the caller timed the region)."""
        if not _metrics._enabled:
            return
        self._buf.append((name, cat, int(start_ns), int(dur_ns), step,
                          threading.get_ident(), args))

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "host",
             step: Optional[int] = None, **args):
        """``with tracer.span("trainer/feed", step=3): ...``"""
        if not _metrics._enabled:
            yield
            return
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.add(name, t0, time.perf_counter_ns() - t0, cat=cat,
                     step=step, args=args or None)

    def events(self):
        """Recorded spans, oldest first, as dicts.  Export-time path: a
        concurrent add during the snapshot raises from the C iterator,
        so retry a few times (exports run on quiescent tracers)."""
        raw = []
        for _ in range(8):
            try:
                raw = list(self._buf)
                break
            except RuntimeError:    # deque mutated during iteration
                continue
        return [{"name": n, "cat": c, "start_ns": s, "dur_ns": d,
                 "step": st, "tid": t, "args": a}
                for (n, c, s, d, st, t, a) in raw]

    def clear(self) -> None:
        self._buf.clear()

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON document (Perfetto/chrome://tracing).
        ``ts``/``dur`` are µs; the per-step correlation id rides in
        ``args.step`` so one step's feed/plan/dispatch spans group
        together next to a ``torch.profiler`` device capture."""
        pid = os.getpid()
        evs = [{"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                "args": {"name": "paddle_tpu host"}}]
        for e in self.events():
            args = dict(e["args"] or {})
            if e["step"] is not None:
                args["step"] = e["step"]
            evs.append({"name": e["name"], "cat": e["cat"], "ph": "X",
                        "pid": pid, "tid": e["tid"],
                        "ts": e["start_ns"] / 1e3,
                        "dur": e["dur_ns"] / 1e3, "args": args})
        return {"traceEvents": evs, "displayTimeUnit": "ms"}


TRACER = Tracer()


def span(name: str, cat: str = "host", step: Optional[int] = None, **args):
    """Module-level convenience over the default tracer."""
    return TRACER.span(name, cat=cat, step=step, **args)
