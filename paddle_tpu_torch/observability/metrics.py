"""Thread-safe metrics registry: counters, gauges, fixed-bucket histograms
(counterpart of ``paddle_tpu/observability/metrics.py``, the same code).

The counterpart of the reference's Stat.h global StatSet (paddle/utils/
Stat.h:230-260) generalized to the three Prometheus metric kinds.  Design
constraints, in order:

  * disabled (the default) must cost nothing on the executor hot path —
    every mutator checks one module-level flag and returns, cheaper than
    a dict lookup;
  * enabled must stay within ~1-3 µs per executor step (a handful of
    lock-guarded integer updates);
  * instrumented modules pre-bind metric handles at import time so the
    per-step path never does a registry lookup.

Histogram buckets are µs-scale by default (1 µs .. 1 s) because every
latency this framework cares about is host dispatch measured in
microseconds.  Enable via ``PADDLE_TPU_TELEMETRY=1`` in the environment
or ``paddle_tpu_torch.observability.enable()``.
"""

from __future__ import annotations

import bisect
import os
import threading
from typing import Dict, Optional, Tuple

_enabled = os.environ.get("PADDLE_TPU_TELEMETRY", "") not in ("", "0")


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


# µs-scale: 1 µs .. 1 s, then +Inf overflow
DEFAULT_BUCKETS_US = (1, 2, 5, 10, 25, 50, 100, 250, 500,
                      1000, 2500, 5000, 10000, 25000, 50000,
                      100000, 250000, 1000000)

# ONE mutation lock shared by every metric: the fused hot-path
# ``record`` then pays a single acquire per executor step instead of
# one per metric (measured: each extra cache-cold lock touch costs
# ~1-2 µs in situ).  Contention is a non-issue — critical sections are
# a few integer updates.
_MUTATE_LOCK = threading.Lock()


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter; ``inc`` is a no-op while telemetry is disabled."""

    __slots__ = ("name", "help", "labels", "_value", "_lock")

    def __init__(self, name: str, help: str = "", labels=None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0
        self._lock = _MUTATE_LOCK

    def inc(self, n: int = 1) -> None:
        if not _enabled:
            return
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0


class Gauge:
    """Point-in-time value (queue depth, rate); set/add no-op when disabled."""

    __slots__ = ("name", "help", "labels", "_value", "_lock")

    def __init__(self, name: str, help: str = "", labels=None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0
        self._lock = _MUTATE_LOCK

    def set(self, v) -> None:
        if not _enabled:
            return
        with self._lock:
            self._value = v

    def add(self, n=1) -> None:
        if not _enabled:
            return
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0


class Histogram:
    """Fixed-bucket histogram with Prometheus ``le`` semantics: a value v
    lands in the first bucket whose upper bound satisfies v <= le; values
    past the last bound land in the implicit +Inf bucket."""

    __slots__ = ("name", "help", "labels", "buckets", "_counts", "_sum",
                 "_count", "_lock")

    def __init__(self, name: str, help: str = "",
                 buckets=DEFAULT_BUCKETS_US, labels=None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0
        self._lock = _MUTATE_LOCK

    def observe(self, v) -> None:
        if not _enabled:
            return
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    @property
    def bucket_counts(self):
        return list(self._counts)

    def quantile(self, q: float) -> float:
        """Approximate quantile: the upper bound of the first bucket whose
        cumulative count reaches q*count (inf for the overflow bucket)."""
        with self._lock:
            total = self._count
            counts = list(self._counts)
        if total == 0:
            return 0.0
        target = q * total
        running = 0
        for i, c in enumerate(counts):
            running += c
            if running >= target:
                return (float(self.buckets[i]) if i < len(self.buckets)
                        else float("inf"))
        return float("inf")

    def _reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._sum = 0.0
            self._count = 0


class MetricsRegistry:
    """Name+labels → metric instance store.  Registration is idempotent —
    the same (name, labels) returns the SAME object, so module-level
    handles and ad-hoc lookups share state.  ``reset()`` zeroes values in
    place (handles bound at import time stay valid)."""

    def __init__(self, max_series: Optional[int] = None):
        self._metrics: Dict[tuple, object] = {}
        self._lock = threading.Lock()
        # per-NAME labeled-series cardinality cap: unbounded label
        # values (request ids, user strings reaching a label by
        # accident) must not grow the scrape payload and the
        # per-exposition work without limit.  At the cap, NEW label
        # combinations collapse into one ``_overflow`` series per
        # name — increments are never dropped, they just lose label
        # resolution past the cap (the Prometheus client convention;
        # series present before the cap keep their identity).
        if max_series is None:
            max_series = int(os.environ.get(
                "PADDLE_TPU_MAX_SERIES_PER_METRIC", "512"))
        self.max_series = max_series
        self._series_count: Dict[str, int] = {}

    def _get_or_make(self, cls, name, help, labels, **kw):
        key = (name, _label_key(labels))
        with self._lock:
            metric = self._metrics.get(key)
            if metric is None:
                if (labels and self.max_series
                        and self._series_count.get(name, 0)
                        >= self.max_series):
                    labels = {k: "_overflow" for k in labels}
                    key = (name, _label_key(labels))
                    metric = self._metrics.get(key)
                    if metric is not None:
                        if type(metric) is not cls:
                            raise TypeError(
                                f"metric {name!r} already registered "
                                f"as {type(metric).__name__}, not "
                                f"{cls.__name__}")
                        return metric
                metric = self._metrics[key] = cls(
                    name, help=help, labels=labels, **kw)
                if labels:
                    self._series_count[name] = (
                        self._series_count.get(name, 0) + 1)
            elif type(metric) is not cls:
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(metric).__name__}, not {cls.__name__}")
            return metric

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get_or_make(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get_or_make(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_BUCKETS_US, **labels) -> Histogram:
        return self._get_or_make(Histogram, name, help, labels,
                                 buckets=buckets)

    def get(self, name: str, **labels):
        return self._metrics.get((name, _label_key(labels)))

    def remove(self, name: str, **labels) -> bool:
        """Drop one labeled series from the registry (True when it
        existed).  For metrics whose label values are UNBOUNDED over a
        process lifetime — the serving engine retires
        ``serving_model_version{version=...}`` series as weight
        versions retire, so continuous deployment cannot grow scrape
        cardinality without bound.  A module-level handle to a removed
        metric keeps working but is no longer exported; re-registering
        the same (name, labels) mints a fresh zeroed series."""
        key = (name, _label_key(labels))
        with self._lock:
            existed = self._metrics.pop(key, None) is not None
            if existed and labels:
                n = self._series_count.get(name, 0) - 1
                if n > 0:
                    self._series_count[name] = n
                else:
                    self._series_count.pop(name, None)
            return existed

    def value(self, name: str, **labels):
        """Counter/gauge value (0 when absent)."""
        metric = self.get(name, **labels)
        return metric.value if metric is not None else 0

    def by_label(self, name: str, label: str) -> Dict[str, object]:
        """{label value: counter/gauge value} across one metric family."""
        out = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for metric in metrics:
            if metric.name == name and label in metric.labels:
                out[metric.labels[label]] = metric.value
        return out

    def reset(self) -> None:
        with self._lock:
            metrics = list(self._metrics.values())
        for metric in metrics:
            metric._reset()

    def snapshot(self) -> dict:
        """JSON-safe point-in-time dump (the JSONL-sink payload).  Reads
        under the shared mutation lock so a scrape concurrent with a
        training thread's ``record`` never sees a torn histogram
        (count/sum/buckets from different instants)."""
        counters, gauges, hists = [], [], []
        with self._lock:
            metrics = list(self._metrics.values())
        with _MUTATE_LOCK:
            for metric in metrics:
                if isinstance(metric, Counter):
                    counters.append({"name": metric.name,
                                     "labels": dict(metric.labels),
                                     "value": metric._value})
                elif isinstance(metric, Gauge):
                    gauges.append({"name": metric.name,
                                   "labels": dict(metric.labels),
                                   "value": metric._value})
                else:
                    buckets = [[le, c] for le, c in
                               zip(metric.buckets, metric._counts)]
                    buckets.append(["+Inf", metric._counts[-1]])
                    hists.append({"name": metric.name,
                                  "labels": dict(metric.labels),
                                  "count": metric._count,
                                  "sum": metric._sum,
                                  "buckets": buckets})
        return {"counters": counters, "gauges": gauges,
                "histograms": hists}

    def to_prometheus(self) -> str:
        return prometheus_from_snapshot(self.snapshot(), registry=self)

    def render_table(self) -> str:
        return render_snapshot_table(self.snapshot())


REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "", **labels) -> Counter:
    return REGISTRY.counter(name, help, **labels)


def gauge(name: str, help: str = "", **labels) -> Gauge:
    return REGISTRY.gauge(name, help, **labels)


def histogram(name: str, help: str = "", buckets=DEFAULT_BUCKETS_US,
              **labels) -> Histogram:
    return REGISTRY.histogram(name, help, buckets=buckets, **labels)


def record(counters=(), observations=(), spans=(), tracer=None):
    """Fused hot-path update: one call, one enabled check, then inline
    lock-guarded updates.  The fluid executor records its whole step —
    4 counters, 3 histograms, 3 spans — through this single entry point
    because ten separate cache-cold method calls cost ~2.5 µs EACH in
    situ (measured; the same calls back-to-back are ~0.7 µs), blowing
    the bench gate's 10% budget.

    counters: iterable of (Counter, n); observations: (Histogram, value);
    spans: pre-built tuples in tracing.Tracer's internal layout
    (name, cat, start_ns, dur_ns, step, tid, args) — the layout contract
    is documented on Tracer.  tracer: the Tracer to bulk-append to
    (resolved lazily from tracing.TRACER when omitted)."""
    if not _enabled:
        return
    with _MUTATE_LOCK:      # every metric shares this lock — one acquire
        for c, n in counters:
            c._value += n
        for h, v in observations:
            h._counts[bisect.bisect_left(h.buckets, v)] += 1
            h._sum += v
            h._count += 1
    if spans:
        if tracer is None:
            from paddle_tpu_torch.observability import tracing
            tracer = tracing.TRACER
        tracer._buf.extend(spans)


# ------------------------------------------------------- snapshot renderers

def _fmt_labels(labels: dict, extra: Optional[dict] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def _fmt_num(v) -> str:
    if isinstance(v, float) and not v.is_integer():
        return repr(v)
    return str(int(v))


def snapshot_value(snap: dict, name: str, **labels):
    """Counter/gauge value out of a snapshot dict (0 when absent)."""
    want = dict((str(k), str(v)) for k, v in labels.items())
    for sect in ("counters", "gauges"):
        for m in snap.get(sect, ()):
            if m["name"] == name and {str(k): str(v) for k, v in
                                      m.get("labels", {}).items()} == want:
                return m["value"]
    return 0


def prometheus_from_snapshot(snap: dict, registry=None) -> str:
    """Prometheus text exposition format of a snapshot dict.  HELP lines
    come from the live registry when one is supplied (snapshots don't
    carry help strings)."""
    def help_for(name, labels):
        if registry is None:
            return ""
        m = registry.get(name, **labels)
        return getattr(m, "help", "") or ""

    lines = []
    seen_header = set()

    def header(name, kind, labels):
        if name in seen_header:
            return
        seen_header.add(name)
        h = help_for(name, labels)
        if h:
            lines.append(f"# HELP {name} {h}")
        lines.append(f"# TYPE {name} {kind}")

    for m in snap.get("counters", ()):
        header(m["name"], "counter", m.get("labels", {}))
        lines.append(f"{m['name']}{_fmt_labels(m.get('labels', {}))} "
                     f"{_fmt_num(m['value'])}")
    for m in snap.get("gauges", ()):
        header(m["name"], "gauge", m.get("labels", {}))
        lines.append(f"{m['name']}{_fmt_labels(m.get('labels', {}))} "
                     f"{_fmt_num(m['value'])}")
    for m in snap.get("histograms", ()):
        header(m["name"], "histogram", m.get("labels", {}))
        labels = m.get("labels", {})
        running = 0
        for le, c in m["buckets"]:
            running += c
            lines.append(
                f"{m['name']}_bucket"
                f"{_fmt_labels(labels, {'le': le})} {running}")
        lines.append(f"{m['name']}_sum{_fmt_labels(labels)} "
                     f"{_fmt_num(m['sum'])}")
        lines.append(f"{m['name']}_count{_fmt_labels(labels)} "
                     f"{_fmt_num(m['count'])}")
    return "\n".join(lines) + ("\n" if lines else "")


def render_snapshot_table(snap: dict) -> str:
    """Human table of a snapshot (the upgraded print_stats companion)."""
    lines = []
    scalars = []
    for m in snap.get("counters", ()):
        scalars.append((m["name"] + _fmt_labels(m.get("labels", {})),
                        m["value"]))
    for m in snap.get("gauges", ()):
        scalars.append((m["name"] + _fmt_labels(m.get("labels", {})) +
                        " (gauge)", m["value"]))
    if scalars:
        width = max([len(n) for n, _ in scalars] + [len("metric")])
        lines.append(f"{'metric':<{width}} {'value':>12}")
        for n, v in sorted(scalars):
            lines.append(f"{n:<{width}} {_fmt_num(v):>12}")
    hists = snap.get("histograms", ())
    if hists:
        if lines:
            lines.append("")
        width = max([len(m["name"] + _fmt_labels(m.get("labels", {})))
                     for m in hists] + [len("histogram")])
        lines.append(f"{'histogram':<{width}} {'count':>8} {'sum_us':>12} "
                     f"{'avg_us':>9} {'p50_us':>9} {'p99_us':>9}")
        for m in hists:
            name = m["name"] + _fmt_labels(m.get("labels", {}))
            count = m["count"]
            avg = m["sum"] / count if count else 0.0
            p50 = _snap_quantile(m, 0.5)
            p99 = _snap_quantile(m, 0.99)
            lines.append(f"{name:<{width}} {count:>8} {m['sum']:>12.1f} "
                         f"{avg:>9.1f} {p50:>9.1f} {p99:>9.1f}")
    return "\n".join(lines)


def _snap_quantile(hist: dict, q: float) -> float:
    total = hist["count"]
    if not total:
        return 0.0
    target = q * total
    running = 0
    for le, c in hist["buckets"]:
        running += c
        if running >= target:
            return float("inf") if le == "+Inf" else float(le)
    return float("inf")
