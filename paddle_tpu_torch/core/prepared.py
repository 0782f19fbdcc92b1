"""Prepared train chunks: k training steps as one dispatch (counterpart of
``paddle_tpu/core/prepared.py``'s ``PreparedFamily``, without its disk
cache and its fingerprints).

A ``PreparedFamily`` holds one entry per ``(kind, k, feed signature)``,
the signature being the feed's names, shapes and dtypes in dict order.
An entry runs k sequential training steps over feeds stacked on a
leading ``[k]`` axis and returns the k losses, a float32 ``[k]`` tensor;
a step that returns ``(loss, stats)``, ``stats`` a dict of tuples of
tensors (the evaluators' statistics), makes the entry return ``(losses,
stats)`` with each statistic stacked ``[k, ...]``, so the statistics of a
captured chunk come out of its graph and nothing reads them back a step:

- on the card (``CapturedChunk``) it is one ``torch.cuda.CUDAGraph`` of
  the k steps.  Before the capture, one step runs on the family's side
  stream and the state and the generator are put back as they were (the
  replays draw on from where the generator stood): that builds the kernels
  (``nvcc`` must not run under capture), initialises the libraries and
  sizes the arrival counters of kernels 4 to 6 for that stream.  The
  capture then records the steps over static device buffers of the
  stacked feeds; every tensor a step updates (parameters, optimizer
  slots and step counter, running state, loss-scale state) is updated in
  place, so the graph's replays carry the training forward.  A replay
  copies the chunk's feeds in, replays once and returns a copy of the
  losses, so that no later replay overwrites a loss an event still
  holds.  The step's generator (dropout's masks, NCE's negatives) is
  registered with the graph, so each replay advances it and draws new
  numbers; a generator the graph does not know raises inside the
  capture.  A capture that fails raises with the op that broke it;
  nothing runs the steps eagerly instead;
- on the CPU (``EagerChunk``) the k steps run eagerly, one after the
  other: the caller asked for the CPU.

``ops.launch_counts()`` counts a graph's kernel launches at each replay
(``ops.recording_launches`` and ``ops.add_launches``).

A family made with a ``stack`` registers each entry in the executable
registry (``observability/executables.py``): its fingerprint (the
caller's identity parts, the kind, k and the feed signature), its build
time (the capture with its warm-up step; on the CPU none) and, while
telemetry is on at the build, its cost, counted over the warm-up step (on
the CPU over the first step) and multiplied by k.  While telemetry is on
each call of an entry is a dispatch of its row, timed by a CUDA event
pair (``ExecutableEntry.begin`` / ``end``; no sync).  Dropping an entry
(``release``, ``PreparedFamily.clear`` or the family itself) frees its
graph; the family's graphs share one memory pool, which goes with the
last of them.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.observability import executables as _executables
from paddle_tpu_torch.observability import metrics as _metrics


def feed_signature(feed: dict) -> tuple:
    """The names, shapes and dtypes of ``feed``'s arrays in dict order
    (numpy arrays and tensors of one dtype sign alike)."""
    def dtype(v):
        return str(v.dtype).removeprefix("torch.")

    return tuple((name, tuple(v.shape), dtype(v)) for name, v in feed.items())


def _step_feed(feeds: dict, i: int) -> dict:
    return {name: v[i] for name, v in feeds.items()}


def _stacked(results: list):
    """The k steps' results stacked: the losses, (losses, statistics)
    for steps that return ``(loss, {name: (tensor, ...)})``, or a list
    of stacked values for steps that return a list (Fluid's fetches)."""
    if isinstance(results[0], list):
        return [torch.stack([r[j] for r in results])
                for j in range(len(results[0]))]
    if not isinstance(results[0], tuple):
        return torch.stack(results)
    stats = {name: tuple(torch.stack([r[1][name][j] for r in results])
                         for j in range(len(parts)))
             for name, parts in results[0][1].items()}
    return torch.stack([r[0] for r in results]), stats


def _copied(out):
    if isinstance(out, list):
        return [t.clone() for t in out]
    if isinstance(out, tuple):
        losses, stats = out
        return losses.clone(), {name: tuple(t.clone() for t in parts)
                                for name, parts in stats.items()}
    return out.clone()


def _dispatch(entry, run: Callable):
    """``run()`` as one dispatch of ``entry``'s registry row while
    telemetry is on."""
    exe = entry.exe if _metrics._enabled else None
    if exe is None:
        return run()
    t = exe.begin(entry.device)
    out = run()
    exe.end(t)
    return out


class EagerChunk:
    """k steps run eagerly, one after the other (the CPU's entry).  With
    ``count`` the first call's first step is counted for the registry
    (``cost``, set on ``exe`` when there is one)."""

    exe = None
    device = "cpu"

    def __init__(self, step: Callable, k: int, count: bool = False):
        self.step, self.k = step, k
        self._count = count
        self.cost = None

    def __call__(self, feeds: dict):
        if not self._count:
            return _dispatch(self, lambda: self._run(feeds))
        # the first call is the build: its first step counted
        self._count = False
        t0 = time.perf_counter_ns()
        with _executables.count_cost() as counted:
            first = self.step(_step_feed(feeds, 0))
        self.cost = _executables.cost_of(counted, self.k)
        out = self._run(feeds, [first])
        if self.exe is not None:
            if self.cost is not None:
                self.exe.cost = self.cost
            self.exe.record_build((time.perf_counter_ns() - t0) / 1e3)
        return out

    def _run(self, feeds: dict, results=None):
        results = list(results or [])
        for i in range(len(results), self.k):
            results.append(self.step(_step_feed(feeds, i)))
        return _stacked(results)

    def release(self) -> None:
        self.step = None


class CapturedChunk:
    """One CUDA graph of k sequential steps over static feed buffers.

    ``step(feed) -> loss`` is the trainer's step; ``state`` lists every
    tensor the step updates, which the warm-up step puts back;
    ``feeds`` (stacked ``[k, ...]`` arrays) fill the static buffers
    before the warm-up, so that it runs on real data.  With ``count`` the
    warm-up step is counted for the registry (``cost``: k times it)."""

    exe = None

    def __init__(self, step: Callable, k: int, feeds: dict,
                 state: List[torch.Tensor], stream: torch.cuda.Stream,
                 pool=None, generator: Optional[torch.Generator] = None,
                 count: bool = False):
        dev = stream.device
        self.k = k
        self.device = dev
        self.cost = None
        self.static = {name: torch.empty(tuple(v.shape), device=dev,
                                         dtype=torch.as_tensor(v).dtype)
                       for name, v in feeds.items()}
        self._load(feeds)
        cur = torch.cuda.current_stream(dev)
        saved = [t.clone() for t in state]
        rng = None if generator is None else generator.get_state()
        stream.wait_stream(cur)
        counting = (_executables.count_cost() if count
                    else contextlib.nullcontext({}))
        with torch.cuda.stream(stream):
            with counting as counted:
                step(_step_feed(self.static, 0))
            for t, was in zip(state, saved):
                t.copy_(was)
        cur.wait_stream(stream)
        self.cost = _executables.cost_of(counted, k)
        if rng is not None:
            generator.set_state(rng)
        del saved
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        with ops.recording_launches() as rec:
            try:
                # thread_local: a prefetch producer may copy to the card
                # on its own stream meanwhile
                with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                      capture_error_mode="thread_local"):
                    self.out = _stacked(
                        [step(_step_feed(self.static, i))
                         for i in range(k)])
            except Exception as e:
                raise RuntimeError(
                    f"the CUDA graph capture of {k} training steps failed "
                    f"(the steps do not run eagerly instead): {e}") from e
        self.launches = dict(rec)
        # the arrival counters the graph captured: held while it lives
        from paddle_tpu_torch.ops.paged_attention import arrival_counters
        self.arrivals = arrival_counters(dev, stream.cuda_stream)

    def _load(self, feeds: dict) -> None:
        for name, buf in self.static.items():
            buf.copy_(torch.as_tensor(feeds[name]))

    def __call__(self, feeds: dict):
        self._load(feeds)
        _dispatch(self, self.graph.replay)
        ops.add_launches(self.launches)
        return _copied(self.out)

    def release(self) -> None:
        self.graph.reset()
        self.graph = self.out = self.static = self.arrivals = None


def chunk_entry(step: Callable, k: int, feeds: dict,
                state: List[torch.Tensor], device: torch.device,
                stream=None, pool=None, generator=None, count=False):
    """The entry of k steps on ``device``: a ``CapturedChunk`` on the card
    (on ``stream``, a new side stream when None; ``generator`` registered
    with its graph), an ``EagerChunk`` on the CPU; ``count`` counts its
    cost."""
    if device.type != "cuda":
        return EagerChunk(step, k, count)
    return CapturedChunk(step, k, feeds, state,
                         stream or torch.cuda.Stream(device), pool,
                         generator, count)


class PreparedFamily:
    """The prepared entries of one trainer, keyed by ``(kind, k, feed
    signature)``.  On the card its graphs capture on one side stream of
    their own and share one memory pool.  ``prepared`` counts the entries
    made (the trainer's ``step_capture_count``).  With a ``stack`` each
    entry is a row of the executable registry (``exe``)."""

    def __init__(self, device: torch.device, stack: Optional[str] = None):
        self.device = device
        self.stack = stack
        self.entries: Dict[tuple, object] = {}
        self.prepared = 0
        self._stream = self._pool = None

    def get(self, kind, k: int, feeds: dict, step: Callable,
            state: Callable[[], List[torch.Tensor]], generator=None,
            exe_kind: str = "train_chunk", identity: tuple = ()):
        """The entry for ``feeds`` (stacked ``[k, ...]``), prepared on
        first use; ``state()`` lists the tensors the step updates and
        ``generator`` is the step's random stream.  ``exe_kind`` and
        ``identity`` (the program's identity parts) name its registry
        row."""
        sig = feed_signature(feeds)
        key = (kind, k, sig)
        entry = self.entries.get(key)
        if entry is None:
            if self.device.type == "cuda" and self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
                self._pool = torch.cuda.graph_pool_handle()
            count = self.stack is not None and _metrics._enabled
            t0 = time.perf_counter_ns()
            entry = chunk_entry(step, k, feeds, state(), self.device,
                                self._stream, self._pool, generator, count)
            if self.stack is not None:
                entry.exe = _executables.register(
                    stack=self.stack, kind=exe_kind,
                    fingerprint=_executables.fingerprint(*identity, exe_kind,
                                                         k, sig),
                    feed_sig=sig,
                    compile_us=(time.perf_counter_ns() - t0) / 1e3,
                    cost=entry.cost)
            self.entries[key] = entry
            self.prepared += 1
        return entry

    def clear(self) -> None:
        """Drop every entry (a change of precision policy: their graphs
        hold the old policy's kernels)."""
        for entry in self.entries.values():
            entry.release()
        self.entries.clear()
