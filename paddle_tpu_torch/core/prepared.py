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
(``ops.recording_launches`` and ``ops.add_launches``).  Dropping an entry
(``release``, ``PreparedFamily.clear`` or the family itself) frees its
graph; the family's graphs share one memory pool, which goes with the
last of them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from paddle_tpu_torch import ops


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


class EagerChunk:
    """k steps run eagerly, one after the other (the CPU's entry)."""

    def __init__(self, step: Callable, k: int):
        self.step, self.k = step, k

    def __call__(self, feeds: dict):
        return _stacked([self.step(_step_feed(feeds, i))
                         for i in range(self.k)])

    def release(self) -> None:
        self.step = None


class CapturedChunk:
    """One CUDA graph of k sequential steps over static feed buffers.

    ``step(feed) -> loss`` is the trainer's step; ``state`` lists every
    tensor the step updates, which the warm-up step puts back;
    ``feeds`` (stacked ``[k, ...]`` arrays) fill the static buffers
    before the warm-up, so that it runs on real data."""

    def __init__(self, step: Callable, k: int, feeds: dict,
                 state: List[torch.Tensor], stream: torch.cuda.Stream,
                 pool=None, generator: Optional[torch.Generator] = None):
        dev = stream.device
        self.k = k
        self.static = {name: torch.empty(tuple(v.shape), device=dev,
                                         dtype=torch.as_tensor(v).dtype)
                       for name, v in feeds.items()}
        self._load(feeds)
        cur = torch.cuda.current_stream(dev)
        saved = [t.clone() for t in state]
        rng = None if generator is None else generator.get_state()
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            step(_step_feed(self.static, 0))
            for t, was in zip(state, saved):
                t.copy_(was)
        cur.wait_stream(stream)
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
        self.graph.replay()
        ops.add_launches(self.launches)
        return _copied(self.out)

    def release(self) -> None:
        self.graph.reset()
        self.graph = self.out = self.static = self.arrivals = None


def chunk_entry(step: Callable, k: int, feeds: dict,
                state: List[torch.Tensor], device: torch.device,
                stream=None, pool=None, generator=None):
    """The entry of k steps on ``device``: a ``CapturedChunk`` on the card
    (on ``stream``, a new side stream when None; ``generator`` registered
    with its graph), an ``EagerChunk`` on the CPU."""
    if device.type != "cuda":
        return EagerChunk(step, k)
    return CapturedChunk(step, k, feeds, state,
                         stream or torch.cuda.Stream(device), pool,
                         generator)


class PreparedFamily:
    """The prepared entries of one trainer, keyed by ``(kind, k, feed
    signature)``.  On the card its graphs capture on one side stream of
    their own and share one memory pool.  ``prepared`` counts the entries
    made (the trainer's ``step_capture_count``)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.entries: Dict[tuple, object] = {}
        self.prepared = 0
        self._stream = self._pool = None

    def get(self, kind: str, k: int, feeds: dict, step: Callable,
            state: Callable[[], List[torch.Tensor]], generator=None):
        """The entry for ``feeds`` (stacked ``[k, ...]``), prepared on
        first use; ``state()`` lists the tensors the step updates and
        ``generator`` is the step's random stream."""
        key = (kind, k, feed_signature(feeds))
        entry = self.entries.get(key)
        if entry is None:
            if self.device.type == "cuda" and self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
                self._pool = torch.cuda.graph_pool_handle()
            entry = chunk_entry(step, k, feeds, state(), self.device,
                                self._stream, self._pool, generator)
            self.entries[key] = entry
            self.prepared += 1
        return entry

    def clear(self) -> None:
        """Drop every entry (a change of precision policy: their graphs
        hold the old policy's kernels)."""
        for entry in self.entries.values():
            entry.release()
        self.entries.clear()
