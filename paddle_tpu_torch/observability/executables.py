"""The executable observatory (counterpart of
``paddle_tpu/observability/executables.py``): one process-wide registry
that every prepared program of the port reports into, with the JAX
registry's entry schema and JSON keys (``exe``, ``stack``, ``kind``,
``fingerprint``, ``feed_sig``, ``provenance``, ``compile_us``,
``dispatches``, ``device_us``, ``cost``, ``memory``).

What counts as an executable here: one row per (stack, kind, feed
signature) of

  * a trainer step (``trainer`` / ``v2_train_step``, the eager k = 1
    step) or a prepared k-step chunk (``trainer`` / ``train_chunk``,
    ``core/prepared.py``: on the card one CUDA graph);
  * a Fluid run plan (``fluid`` / ``run_plan``) or ``run_n`` chunk
    (``fluid`` / ``run_n``);
  * a decoder iteration of the serving engine (``serving`` /
    ``decode_step``, ``paged_step``) or its whole forward
    (``serving`` / ``forward``).

The fingerprint is a hash of the program's identity (its topology or
program JSON, the precision policy, k and the feed signature).  The
provenance is ``fresh``: the port has no disk cache of built programs
yet (``ROADMAP.md`` §1, item 13b).  ``compile_us`` is the build time:
the first step of a new signature, or a chunk's capture.

Cost is counted once, at registration (``count_cost``): the aten
products ``torch.utils.flop_counter.FlopCounterMode`` sees over one
step, plus each hand-written kernel's own count of its work, which its
wrapper reports at each launch inside the count (``ops.recording_work``;
the formula of its bound in ``PERF.md``).  The flop counter cannot see
a ``ctypes`` launch, so without the kernels' counts attention would
count as nothing on the card.  Where no count exists the cost is None
and the MFU gauges are absent, as in the JAX registry.

Device time comes from CUDA event pairs around each dispatch while
telemetry is on (``begin`` / ``end``).  The hot path adds no device
sync: a pair is read once ``query()`` says its end has run, at the next
dispatch of the entry or at an exposition (``snapshot``).  On the CPU a
dispatch's device time is its host wall time.  A row's first dispatch
is its build (``record_build``): counted in ``dispatches``, its time is
``compile_us`` (the flop counter's host work in it would read as idle
device time), and the MFU divides the FLOPs of the timed dispatches
alone by their device time.

The peaks: ``PADDLE_TPU_PEAK_FLOPS`` / ``PADDLE_TPU_PEAK_BYTES_PER_SEC``
when set, else a table matched by prefix on
``torch.cuda.get_device_name()`` (the H100's dense bf16 and HBM3 rates
of ``tools/timing.py``) times the visible card count; off the card
there is no peak and no MFU gauge.

Surfaces: ``python -m paddle_tpu_torch executables [--json|--top N]``,
the ``/executables`` handler for ``sinks.serve_metrics(extra_handlers=)``
(``http_handler``), and the gauges of ``refresh_gauges``
(``executable_mfu``, ``process_mfu``, ``trainer_mfu(_useful)``,
``serving_mfu(_useful)``).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from paddle_tpu_torch.observability import metrics as _metrics

# Registration is always on (builds are rare); per-dispatch accounting
# is gated on the telemetry flag by the call sites.
_LOCK = threading.Lock()

# Per-card peak dense FLOP/s and memory bytes/s by device name (prefix
# match on ``torch.cuda.get_device_name()``, lower case): the H100's
# rates of ``tools/timing.py``.
PEAK_FLOPS_BY_KIND = (
    ("nvidia h100", 989e12),
)
PEAK_BYTES_BY_KIND = (
    ("nvidia h100", 3.35e12),
)

PROVENANCES = ("fresh", "warm", "baked")


def _peak_from_table(table) -> Optional[float]:
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        kind = torch.cuda.get_device_name(0).lower()
        n = max(1, torch.cuda.device_count())
    except Exception:  # noqa: BLE001 — no card, no peak
        return None
    for prefix, per_card in table:
        if kind.startswith(prefix):
            return per_card * n
    return None


def _env_peak(name: str) -> Optional[float]:
    env = os.environ.get(name, "")
    if env:
        try:
            v = float(env)
            return v if v > 0 else None
        except ValueError:
            pass
    return None


def peak_flops() -> Optional[float]:
    """Process peak FLOP/s: ``PADDLE_TPU_PEAK_FLOPS`` wins, else the
    device-name table times the card count, else None (the MFU gauges
    stay absent: a wrong denominator is worse than no number)."""
    return (_env_peak("PADDLE_TPU_PEAK_FLOPS")
            or _peak_from_table(PEAK_FLOPS_BY_KIND))


def peak_membw() -> Optional[float]:
    """Process peak memory bytes/s (``PADDLE_TPU_PEAK_BYTES_PER_SEC`` or
    the device-name table times the card count)."""
    return (_env_peak("PADDLE_TPU_PEAK_BYTES_PER_SEC")
            or _peak_from_table(PEAK_BYTES_BY_KIND))


def fingerprint(*parts) -> str:
    """A stable hex digest of a program's identity: each part's
    ``repr`` (a topology's or program's JSON, the policy signature, k,
    a feed signature)."""
    h = hashlib.sha256()
    for p in parts:
        h.update(repr(p).encode())
        h.update(b"\0")
    return h.hexdigest()


_COUNTER_READY = False


def warm_counter() -> None:
    """Pay the flop counter's one-time set-up (its first use in a
    process takes seconds of lazy imports) outside any timed region."""
    global _COUNTER_READY
    if _COUNTER_READY:
        return
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    a = torch.zeros(2, 2)
    with FlopCounterMode(display=False):
        torch.mm(a, a)
    _COUNTER_READY = True


@contextlib.contextmanager
def count_cost():
    """Count one step's work: yields a dict whose ``"flops"`` is set on
    exit to the flop counter's aten products plus the hand kernels'
    reported work, or left out where neither counted anything.
    ``"kernel_flops"`` and ``"aten_flops"`` keep the two parts."""
    from torch.utils.flop_counter import FlopCounterMode

    from paddle_tpu_torch import ops

    warm_counter()
    out: dict = {}
    counter = FlopCounterMode(display=False)
    with ops.recording_work() as work, counter:
        yield out
    aten = float(counter.get_total_flops())
    kernels = float(sum(work.values()))
    out["aten_flops"] = aten
    out["kernel_flops"] = kernels
    out["kernels"] = dict(work)
    if aten + kernels > 0:
        out["flops"] = aten + kernels


def cost_of(counted: Optional[dict], times: int = 1) -> Optional[dict]:
    """The registry's ``cost`` dict from a ``count_cost`` result (its
    flops times ``times``: a k-step chunk counts one step k times)."""
    if not counted or not counted.get("flops"):
        return None
    return {"flops": counted["flops"] * times,
            "aten_flops": counted["aten_flops"] * times,
            "kernel_flops": counted["kernel_flops"] * times}


def observe(rows: dict, key, device, run: Callable, register: Callable):
    """``run()`` as one dispatch of the registry row ``rows[key]``: the
    first call makes the row (``register()``) and is its build, its cost
    counted and its time the row's ``compile_us``; later calls are timed
    by a CUDA event pair on ``device`` (the host clock off the card).
    Returns (``run()``'s result, the row)."""
    ent = rows.get(key)
    if ent is None:
        ent = rows[key] = register()
        t0 = time.perf_counter_ns()
        with count_cost() as counted:
            out = run()
        ent.cost = cost_of(counted)
        ent.record_build((time.perf_counter_ns() - t0) / 1e3)
        return out, ent
    mark = ent.begin(device)
    out = run()
    ent.end(mark)
    return out, ent


class ExecutableEntry:
    """One prepared executable's ledger line.  Identity fields are
    immutable after registration; dispatch counters mutate under the
    metrics spine's shared lock."""

    __slots__ = ("seq", "short", "stack", "kind", "fingerprint",
                 "feed_sig", "provenance", "compile_us", "cost",
                 "memory", "dispatches", "device_us", "created_ts",
                 "_pending", "_untimed")

    def __init__(self, seq: int, short: str, stack: str, kind: str,
                 fingerprint: Optional[str], feed_sig: Optional[str],
                 provenance: str, compile_us: float,
                 cost: Optional[dict], memory: Optional[dict]):
        self.seq = seq
        self.short = short
        self.stack = stack
        self.kind = kind
        self.fingerprint = fingerprint
        self.feed_sig = feed_sig
        self.provenance = provenance
        self.compile_us = float(compile_us)
        self.cost = cost
        self.memory = memory
        self.dispatches = 0
        self.device_us = 0.0
        self.created_ts = time.time()
        # CUDA event pairs of dispatches whose end has not been read yet
        self._pending: deque = deque()
        # dispatches without a device time (the builds)
        self._untimed = 0

    def record_dispatch(self, device_us: float) -> None:
        """Account one dispatch of ``device_us`` µs (a host-timed
        dispatch: the CPU's path)."""
        with _metrics._MUTATE_LOCK:
            self.dispatches += 1
            self.device_us += device_us

    def record_build(self, build_us: float) -> None:
        """Account the build: one dispatch whose time is ``compile_us``,
        not device time."""
        with _metrics._MUTATE_LOCK:
            self.dispatches += 1
            self._untimed += 1
            self.compile_us = float(build_us)

    def begin(self, device):
        """Mark a dispatch's start: a recorded CUDA event on the card,
        else the host clock.  Pass the result to ``end``."""
        if getattr(device, "type", device) == "cuda":
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter_ns()

    def end(self, start) -> None:
        """Close the dispatch ``begin`` opened: counts it, and on the card
        queues its event pair, read later without a sync."""
        if isinstance(start, int):
            self.record_dispatch((time.perf_counter_ns() - start) / 1e3)
            return
        import torch

        stop = torch.cuda.Event(enable_timing=True)
        stop.record()
        with _metrics._MUTATE_LOCK:
            self.dispatches += 1
            self._pending.append((start, stop))
        self.poll()

    def poll(self) -> None:
        """Add the device time of every queued pair whose end has run
        (``Event.query``: no sync); the rest stay queued."""
        while True:
            with _metrics._MUTATE_LOCK:
                if not self._pending or not self._pending[0][1].query():
                    return
                start, stop = self._pending.popleft()
                self.device_us += start.elapsed_time(stop) * 1e3

    def flops_total(self) -> Optional[float]:
        if not self.cost or "flops" not in self.cost:
            return None
        return self.cost["flops"] * self.dispatches

    def bytes_total(self) -> Optional[float]:
        if not self.cost or "bytes_accessed" not in self.cost:
            return None
        return self.cost["bytes_accessed"] * self.dispatches

    def _timed_dispatches(self) -> int:
        # dispatches whose device time is in device_us
        return self.dispatches - len(self._pending) - self._untimed

    def mfu(self, peak: Optional[float]) -> Optional[float]:
        """Achieved FLOP/s over peak FLOP/s (PaLM's MFU), over the
        dispatches whose device time has been read."""
        if not self.cost or "flops" not in self.cost:
            return None
        ft = self.cost["flops"] * self._timed_dispatches()
        if not ft or not peak or self.device_us <= 0:
            return None
        return ft / (self.device_us * 1e-6) / peak

    def membw_util(self, peak_bw: Optional[float]) -> Optional[float]:
        if not self.cost or "bytes_accessed" not in self.cost:
            return None
        bt = self.cost["bytes_accessed"] * self._timed_dispatches()
        if not bt or not peak_bw or self.device_us <= 0:
            return None
        return bt / (self.device_us * 1e-6) / peak_bw

    def to_dict(self) -> dict:
        with _metrics._MUTATE_LOCK:
            dispatches, device_us = self.dispatches, self.device_us
        return {"exe": self.short, "stack": self.stack, "kind": self.kind,
                "fingerprint": self.fingerprint, "feed_sig": self.feed_sig,
                "provenance": self.provenance,
                "compile_us": round(self.compile_us, 1),
                "dispatches": dispatches,
                "device_us": round(device_us, 1),
                "cost": self.cost, "memory": self.memory}


def _rollup(entries: List[ExecutableEntry], peak: Optional[float],
            peak_bw: Optional[float]) -> dict:
    """Aggregate MFU / bandwidth over a set of entries: total estimated
    FLOPs (bytes) over total dispatch seconds, counting only entries
    that have an estimate."""
    flops = bytes_acc = flops_secs = bytes_secs = 0.0
    dispatches = 0
    secs = 0.0
    for e in entries:
        dispatches += e.dispatches
        secs += e.device_us * 1e-6
        timed = e._timed_dispatches()
        if e.cost and e.cost.get("flops") and timed:
            flops += e.cost["flops"] * timed
            flops_secs += e.device_us * 1e-6
        if e.cost and e.cost.get("bytes_accessed") and timed:
            bytes_acc += e.cost["bytes_accessed"] * timed
            bytes_secs += e.device_us * 1e-6
    out = {"executables": len(entries), "dispatches": dispatches,
           "device_s": round(secs, 6), "flops": flops,
           "bytes_accessed": bytes_acc, "mfu": None, "membw_util": None}
    if peak and flops and flops_secs > 0:
        out["mfu"] = flops / flops_secs / peak
    if peak_bw and bytes_acc and bytes_secs > 0:
        out["membw_util"] = bytes_acc / bytes_secs / peak_bw
    return out


def _useful_fraction(hist_name: str) -> Optional[float]:
    """1 - mean(padding waste %)/100 from a waste histogram in the live
    registry: the share of dispatched FLOPs that touched real rows."""
    h = _metrics.REGISTRY.get(hist_name)
    if h is None or not getattr(h, "count", 0):
        return None
    mean = h.sum / h.count
    return max(0.0, min(1.0, 1.0 - mean / 100.0))


class ExecutableRegistry:
    """Process-wide ledger of every prepared executable.  ``register``
    is idempotent on (stack, kind, fingerprint, feed_sig)."""

    def __init__(self):
        self._entries: List[ExecutableEntry] = []
        self._by_identity: Dict[tuple, ExecutableEntry] = {}
        self._shorts: Dict[str, int] = {}

    def register(self, *, stack: str, kind: str,
                 fingerprint: Optional[str] = None,
                 feed_sig=None, provenance: str = "fresh",
                 compile_us: float = 0.0, cost: Optional[dict] = None,
                 memory: Optional[dict] = None) -> ExecutableEntry:
        """Report one prepared executable; ``cost`` is ``{"flops": ...}``
        (``cost_of``) or None."""
        fp = str(fingerprint) if fingerprint is not None else None
        sig = None if feed_sig is None else str(feed_sig)
        if sig is not None and len(sig) > 160:
            sig = sig[:157] + "..."
        identity = (stack, kind, fp, sig)
        with _LOCK:
            ent = self._by_identity.get(identity) if fp else None
            if ent is not None:
                ent.provenance = provenance
                if compile_us:
                    ent.compile_us = float(compile_us)
                if cost is not None:
                    ent.cost = cost
                if memory is not None:
                    ent.memory = memory
                return ent
            seq = len(self._entries)
            base = f"{stack}:{fp[:8]}" if fp else f"{stack}:{kind}#{seq}"
            n = self._shorts.get(base, 0)
            self._shorts[base] = n + 1
            short = base if n == 0 else f"{base}-{n}"
            ent = ExecutableEntry(seq, short, stack, kind, fp, sig,
                                  provenance, compile_us, cost, memory)
            self._entries.append(ent)
            if fp:
                self._by_identity[identity] = ent
            return ent

    def entries(self) -> List[ExecutableEntry]:
        with _LOCK:
            return list(self._entries)

    def reset(self) -> None:
        with _LOCK:
            self._entries.clear()
            self._by_identity.clear()
            self._shorts.clear()

    def snapshot(self, top: Optional[int] = None) -> dict:
        """JSON-safe dump: peaks, per-stack and process rollups, and the
        per-executable rows (most device time first; ``top`` truncates
        the rows, never the rollups)."""
        peak = peak_flops()
        peak_bw = peak_membw()
        ents = self.entries()
        for e in ents:
            e.poll()
        rows = []
        for e in sorted(ents, key=lambda e: (-e.device_us, e.seq)):
            d = e.to_dict()
            m = e.mfu(peak)
            bw = e.membw_util(peak_bw)
            d["mfu"] = None if m is None else round(m, 4)
            d["membw_util"] = None if bw is None else round(bw, 4)
            rows.append(d)
        stacks: Dict[str, dict] = {}
        for s in sorted({e.stack for e in ents}):
            stacks[s] = _rollup([e for e in ents if e.stack == s],
                                peak, peak_bw)
        snap = {"peak_flops": peak, "peak_bytes_per_sec": peak_bw,
                "process": _rollup(ents, peak, peak_bw),
                "stacks": stacks,
                "executables": rows if top is None else rows[:int(top)]}
        for name, hist in (("trainer", "trainer_padding_waste_pct"),
                           ("serving", "serving_padding_waste_pct")):
            uf = _useful_fraction(hist)
            if uf is not None and name in stacks:
                stacks[name]["useful_fraction"] = round(uf, 4)
                if stacks[name]["mfu"] is not None:
                    stacks[name]["mfu_useful"] = round(
                        stacks[name]["mfu"] * uf, 4)
        return snap

    def render_table(self, top: Optional[int] = None) -> str:
        return render_snapshot_table(self.snapshot(top=top))


def render_snapshot_table(snap: dict) -> str:
    """Human table from a ``snapshot()`` dict (the JAX registry's
    layout, so either package's ``executables`` verb prints the
    other's snapshot alike)."""
    lines = []
    peak = snap["peak_flops"]
    lines.append("peak_flops: " +
                 (f"{peak:.3g}" if peak else "unknown "
                  "(set PADDLE_TPU_PEAK_FLOPS for MFU)"))
    proc = snap["process"]
    lines.append(f"executables: {proc['executables']}  dispatches: "
                 f"{proc['dispatches']}  device_s: {proc['device_s']}"
                 + (f"  process_mfu: {proc['mfu']:.4f}"
                    if proc["mfu"] is not None else ""))
    for s, r in snap["stacks"].items():
        extra = ""
        if r["mfu"] is not None:
            extra += f"  mfu: {r['mfu']:.4f}"
        if r.get("mfu_useful") is not None:
            extra += f"  useful: {r['mfu_useful']:.4f}"
        lines.append(f"  [{s}] executables: {r['executables']}  "
                     f"dispatches: {r['dispatches']}{extra}")
    if snap["executables"]:
        lines.append("")
        hdr = (f"{'exe':<28} {'kind':<16} {'prov':<5} {'disp':>6} "
               f"{'device_ms':>10} {'compile_ms':>10} {'gflops':>8} "
               f"{'mfu':>6}")
        lines.append(hdr)
        for d in snap["executables"]:
            gf = (d["cost"]["flops"] / 1e9
                  if d["cost"] and "flops" in d["cost"] else None)
            gf_s = f"{gf:>8.3f}" if gf is not None else f"{'-':>8}"
            mfu = d["mfu"]
            mfu_s = f"{mfu:>6.4f}" if mfu is not None else f"{'-':>6}"
            lines.append(
                f"{d['exe']:<28.28} {d['kind']:<16.16} "
                f"{d['provenance']:<5} {d['dispatches']:>6} "
                f"{d['device_us'] / 1e3:>10.2f} "
                f"{d['compile_us'] / 1e3:>10.1f} {gf_s} {mfu_s}")
    return "\n".join(lines)


EXECUTABLES = ExecutableRegistry()


def register(**kw) -> ExecutableEntry:
    """Module-level convenience over the process registry."""
    return EXECUTABLES.register(**kw)


def refresh_gauges() -> None:
    """Materialize the derived utilization gauges into the global
    metrics registry (sinks calls this before every exposition).  A
    gauge is emitted only where its ratio is computable."""
    snap = EXECUTABLES.snapshot()
    for d in snap["executables"]:
        if d["mfu"] is not None:
            _metrics.gauge("executable_mfu",
                           "model-FLOPs-utilization of one executable",
                           exe=d["exe"]).set(d["mfu"])
        if d["membw_util"] is not None:
            _metrics.gauge(
                "executable_membw_util",
                "memory-bandwidth utilization of one executable",
                exe=d["exe"]).set(d["membw_util"])
    proc = snap["process"]
    if proc["mfu"] is not None:
        _metrics.gauge("process_mfu",
                       "process-wide MFU over all registered executables"
                       ).set(proc["mfu"])
    if proc["membw_util"] is not None:
        _metrics.gauge("process_membw_util",
                       "process-wide memory-bandwidth utilization"
                       ).set(proc["membw_util"])
    for stack in ("trainer", "serving"):
        r = snap["stacks"].get(stack)
        if not r:
            continue
        if r["mfu"] is not None:
            _metrics.gauge(f"{stack}_mfu",
                           f"MFU rollup of the {stack} stack"
                           ).set(r["mfu"])
        if r.get("mfu_useful") is not None:
            _metrics.gauge(f"{stack}_mfu_useful",
                           f"{stack} MFU discounted by padding waste"
                           ).set(r["mfu_useful"])


def http_handler(method: str, body: bytes, headers=None, query: str = ""):
    """``/executables`` for ``sinks.serve_metrics(extra_handlers=)``: the
    JSON snapshot; ``?top=N`` truncates the rows, ``?table=1`` renders
    the human table instead."""
    top = None
    table = False
    for part in (query or "").split("&"):
        k, _, v = part.partition("=")
        if k == "top":
            try:
                top = int(v)
            except ValueError:
                pass
        elif k == "table":
            table = v not in ("", "0")
    if table:
        return 200, "text/plain", (
            EXECUTABLES.render_table(top=top) + "\n").encode()
    return 200, "application/json", json.dumps(
        EXECUTABLES.snapshot(top=top)).encode()
