"""Reader creators (counterpart of ``paddle_tpu/reader/creator.py``;
reference: python/paddle/v2/reader/creator.py).

Not ported yet, and refused: ``recordio``, which reads the record files
of ``io/recordio.py`` (``ROADMAP.md`` section 1, item 6).
"""

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
    raise NotImplementedError(
        "reader.creator.recordio is not ported to paddle_tpu_torch yet "
        "(ROADMAP.md section 1, item 6)")
