"""Reader decorators (reference: python/paddle/v2/reader/decorator.py;
a copy of ``paddle_tpu/reader/decorator.py``).

Same API: map_readers:29, shuffle:51, chain:86, compose:118, buffered:165,
firstn:208, xmap_readers:236, plus ``batched`` and ``cache``.
``buffered`` and ``xmap_readers`` overlap host I/O with background
threads; the device feed's overlap lives in ``reader.prefetch``.
``shuffle(seed=)`` seeds its own ``random.Random``, so a seeded shuffle
gives the JAX package's order.
"""

from __future__ import annotations

import itertools
import queue
import random as _random
import threading
from typing import Callable, Iterable


def map_readers(func: Callable, *readers):
    """reader of func(*one_sample_from_each)."""

    def reader():
        for items in zip(*[r() for r in readers]):
            yield func(*items)

    return reader


def shuffle(reader, buf_size: int, seed=None):
    """pool-shuffle within a sliding buffer (reference semantics)."""

    def shuffled():
        rnd = _random.Random(seed)
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) >= buf_size:
                rnd.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            rnd.shuffle(buf)
            yield from buf

    return shuffled


def chain(*readers):
    def reader():
        for r in readers:
            yield from r()

    return reader


def compose(*readers, check_alignment: bool = True):
    """zip samples from several readers into flat tuples."""

    def _flatten(item):
        if isinstance(item, tuple):
            return item
        return (item,)

    def reader():
        iters = [r() for r in readers]
        for items in zip(*iters):
            yield sum((_flatten(i) for i in items), ())

    return reader


def buffered(reader, size: int):
    """background-thread producer with a bounded queue (reference:
    decorator.py:165; the PyDataProvider2 double-buffer pattern)."""

    _end = object()

    def buffered_reader():
        q: queue.Queue = queue.Queue(maxsize=size)

        def produce():
            try:
                for item in reader():
                    q.put(item)
            finally:
                q.put(_end)

        th = threading.Thread(target=produce, daemon=True)
        th.start()
        while True:
            item = q.get()
            if item is _end:
                break
            yield item

    return buffered_reader


def firstn(reader, n: int):
    def reader_n():
        return itertools.islice(reader(), n)

    return reader_n


def xmap_readers(mapper: Callable, reader, process_num: int, buffer_size: int,
                 order: bool = False):
    """parallel map over samples with worker threads (reference:
    decorator.py:236: processes there, threads here: the heavy work is
    on the device, and host decoding rarely needs processes)."""

    _end = object()

    def xreader():
        in_q: queue.Queue = queue.Queue(buffer_size)
        out_q: queue.Queue = queue.Queue(buffer_size)

        def feed():
            for i, item in enumerate(reader()):
                in_q.put((i, item))
            for _ in range(process_num):
                in_q.put(_end)

        def work():
            while True:
                got = in_q.get()
                if got is _end:
                    out_q.put(_end)
                    break
                i, item = got
                out_q.put((i, mapper(item)))

        threading.Thread(target=feed, daemon=True).start()
        workers = [threading.Thread(target=work, daemon=True)
                   for _ in range(process_num)]
        for w in workers:
            w.start()

        done = 0
        if order:
            import heapq
            heap, next_i = [], 0
            while done < process_num:
                got = out_q.get()
                if got is _end:
                    done += 1
                    continue
                heapq.heappush(heap, got)
                while heap and heap[0][0] == next_i:
                    yield heapq.heappop(heap)[1]
                    next_i += 1
            while heap:
                yield heapq.heappop(heap)[1]
        else:
            while done < process_num:
                got = out_q.get()
                if got is _end:
                    done += 1
                    continue
                yield got[1]

    return xreader


def cache(reader):
    """materialise once, replay from memory."""
    data = []
    filled = [False]

    def cached():
        if not filled[0]:
            for item in reader():
                data.append(item)
                yield item
            filled[0] = True
        else:
            yield from data

    return cached


def batched(reader, batch_size: int, drop_last: bool = True,
            calc_batch_size=None, can_over_batch_size: bool = True):
    """group samples into lists of batch_size (paddle.batch parity).

    calc_batch_size(sample) -> int prices each sample (variable-cost
    batching, e.g. token budgets): a batch closes once the summed cost
    reaches batch_size. can_over_batch_size=False closes the batch
    BEFORE the sample that would overflow it (reference:
    PyDataProvider2.cpp:280-294 and the DataPool fill loop at :565) —
    with one escape hatch: a single sample whose own cost exceeds
    batch_size is still emitted as a one-sample over-budget batch
    (there is no smaller batch to put it in; the reference's fill loop
    admits the same case), so the no-overflow contract holds only for
    batches of two or more samples."""

    def batch_reader():
        buf, cost = [], 0
        for item in reader():
            c = calc_batch_size(item) if calc_batch_size else 1
            if (calc_batch_size and buf and not can_over_batch_size
                    and cost + c > batch_size):
                yield buf
                buf, cost = [], 0
            buf.append(item)
            cost += c
            if cost >= batch_size:
                yield buf
                buf, cost = [], 0
        if buf and not drop_last:
            yield buf

    return batch_reader
