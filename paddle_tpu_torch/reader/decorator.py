"""Reader decorators: ``batched`` (``paddle.batch``), the part of
``paddle_tpu/reader/decorator.py`` the trainer needs; the rest of the
decorators come with a later slice."""

from __future__ import annotations


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
