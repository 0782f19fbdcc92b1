"""DataFeeder: minibatch (list of sample tuples) → feed dict of arrays.

Reference ``python/paddle/v2/fluid/data_feeder.py``.  LoD sequence slots are
replaced by padded [batch, max_len] arrays when samples are variable-length
lists.  A copy of ``paddle_tpu/fluid/data_feeder.py``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from paddle_tpu_torch.fluid.framework import Variable


class DataFeeder:
    def __init__(self, feed_list: Sequence[Variable], place=None):
        self.feed_list = list(feed_list)
        self.place = place

    def feed(self, minibatch: List[Sequence]) -> Dict[str, np.ndarray]:
        out = {}
        for i, var in enumerate(self.feed_list):
            col = [sample[i] for sample in minibatch]
            out[var.name] = self._to_array(col, var)
        return out

    @staticmethod
    def _to_array(col, var: Variable) -> np.ndarray:
        first = np.asarray(col[0])
        if first.ndim == 0 and len(var.shape) >= 2 and var.shape[-1] == 1:
            # scalar labels → [batch, 1] (fluid convention)
            return np.asarray(col, dtype=var.dtype).reshape(-1, 1)
        lens = {np.asarray(c).shape for c in col}
        if len(lens) > 1:
            # variable-length sequences → pad to the batch max
            arrs = [np.asarray(c, dtype=var.dtype) for c in col]
            max_len = max(a.shape[0] for a in arrs)
            shape = (len(arrs), max_len) + arrs[0].shape[1:]
            out = np.zeros(shape, dtype=var.dtype)
            for j, a in enumerate(arrs):
                out[j, :a.shape[0]] = a
            return out
        return np.asarray(col, dtype=var.dtype)
