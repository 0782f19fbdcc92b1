"""Background prefetch to the card (counterpart of
``paddle_tpu/reader/prefetch.py``; the reference's DataProvider
DoubleBuffer).

A producer thread runs the reader and the feed conversion (the trainer's
``seq_buckets`` padding included) and copies each feed to the device
while the current step runs.  On the card the copy goes from pinned host
memory on a stream of the producer's own; the consumer's stream waits on
the copy's event before it uses the batch, and each tensor is marked as
used on that stream (``record_stream``), so the caching allocator does
not hand its memory out again while the consumer still reads it.  On the
CPU the producer only converts.

A producer exception is re-raised in the consumer at its next ``next()``:
the pass fails instead of ending early.  A consumer that stops early
(an error in the step, a ``break``, the generator closed or collected)
ends the producer: the thread stops at its next batch and is joined.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from paddle_tpu_torch.core import config as cfg
from paddle_tpu_torch.observability import metrics as _metrics

# the JAX package's prefetch telemetry (no-ops while telemetry is off)
_G_DEPTH = _metrics.gauge(
    "dataloader_queue_depth",
    "items buffered by the background producer (native shuffle pool "
    "samples or reader.prefetch batches; last poll)")
_M_BATCHES = _metrics.counter(
    "prefetch_batches_total",
    "feed dicts staged on device by reader.prefetch_to_device")

_END = object()
# how long a blocked put waits before it looks at the stop flag again
_POLL_S = 0.05


class _ProducerError:
    """Carries a producer-thread exception across the queue."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


def _to_device(feed: dict, dev: torch.device, stream):
    """``feed``'s arrays as tensors on ``dev``, and on the card the event
    that marks the end of their copies on ``stream``."""
    if stream is None:
        return {k: torch.as_tensor(v) for k, v in feed.items()}, None
    out = {}
    with torch.cuda.stream(stream):
        for k, v in feed.items():
            t = (torch.from_numpy(np.ascontiguousarray(v))
                 if isinstance(v, np.ndarray) else torch.as_tensor(v))
            if t.device.type == "cpu":
                t = t.pin_memory()
            out[k] = t.to(dev, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def prefetch_to_device(batch_iter_fn, depth: int = 2, device=None):
    """Wrap a callable returning an iterator of feed dicts; returns a
    callable whose iterator yields the same feeds, in order, as tensors
    already on ``device`` (default: the ``device`` option, else the
    card), with up to ``depth`` of them converted ahead."""
    if depth < 1:
        raise ValueError(f"prefetch depth must be >= 1, got {depth}")
    dev = cfg.default_device(device)

    def prefetched():
        q: queue.Queue = queue.Queue(maxsize=depth)
        stop = threading.Event()
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=_POLL_S)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for feed in batch_iter_fn():
                    if stop.is_set() or not put(_to_device(feed, dev,
                                                           stream)):
                        return
                    _G_DEPTH.set(q.qsize())
            except BaseException as e:  # re-raised in the consumer
                put(_ProducerError(e))
            else:
                put(_END)

        thread = threading.Thread(target=produce, name="prefetch",
                                  daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                _G_DEPTH.set(q.qsize())
                if item is _END:
                    break
                if isinstance(item, _ProducerError):
                    raise item.exc
                _M_BATCHES.inc()
                feed, event = item
                if event is not None:
                    cur = torch.cuda.current_stream(dev)
                    cur.wait_event(event)
                    for t in feed.values():
                        t.record_stream(cur)
                yield feed
        finally:
            # on exhaustion, on an error and on close or collection:
            # release a producer blocked in put, then wait for it
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            thread.join()

    return prefetched
