"""Reader creators (counterpart of ``paddle_tpu/reader/creator.py``;
reference: python/paddle/v2/reader/creator.py)."""

from __future__ import annotations

import numpy as np


def np_array(x):
    """iterate rows of a numpy array."""

    def reader():
        arr = np.asarray(x)
        for row in arr:
            yield row

    return reader


def text_file(path: str):
    def reader():
        with open(path) as f:
            for line in f:
                yield line.rstrip("\n")

    return reader


def recordio(paths):
    """Read the records of recordio shard files written by
    ``io/recordio.py`` (length-prefixed framed records)."""
    from paddle_tpu_torch.io.recordio import RecordReader

    if isinstance(paths, str):
        paths = [paths]

    def reader():
        for p in paths:
            with RecordReader(p) as rr:
                yield from rr

    return reader
