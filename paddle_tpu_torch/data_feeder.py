"""DataFeeder: python sample tuples -> padded numpy feed dict (counterpart
of ``paddle_tpu/data_feeder.py``).

Sequences are padded to the data layer's max_len (or the batch max,
rounded up to a power of two; or ``seq_pad``, the trainer's 2-D
bucketing) and a ``<name>@len`` array is added;
``Topology.forward`` moves the arrays to the device.  Sparse (ids + values)
inputs are not ported yet and raise.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _bucket_len(n: int, max_len: int = 0) -> int:
    if max_len:
        return max_len
    b = 8
    while b < n:
        b *= 2
    return b


class DataFeeder:
    """feeder = DataFeeder(feeding={'image': img_layer, 'label': lbl_layer})
    or DataFeeder(topology, feeding={'image': 0, 'label': 1}).

    Call with a batch (list of sample tuples) → feed dict of numpy arrays.
    """

    def __init__(self, topology=None, feeding: Dict[str, int] = None):
        self.topology = topology
        if feeding is None and topology is not None:
            feeding = {n: i for i, n in enumerate(topology.input_names)}
        self.feeding = feeding

    def _layer_attrs(self, name: str) -> dict:
        if self.topology is None:
            return {}
        return self.topology.get_layer(name).attrs

    def __call__(self, batch: Sequence[tuple]) -> Dict[str, np.ndarray]:
        return self.feed(batch)

    def feed(self, batch: Sequence[tuple],
             seq_pad: int = None) -> Dict[str, np.ndarray]:
        """One batch as a feed dict.  ``seq_pad`` overrides the T-axis
        padding of plain sequence inputs (capped at the layer's declared
        max_len): the trainer's 2-D (rows x seqlen) bucketing pads each
        batch to the smallest bucket covering its longest sequence.  A
        ``seq_pad`` below the batch's longest (max_len-capped) sequence
        raises, since it would truncate data the layer could have seen;
        truncation at the declared max_len stays the layer's contract."""
        out: Dict[str, np.ndarray] = {}
        for name, idx in self.feeding.items():
            column = [sample[idx] for sample in batch]
            attrs = self._layer_attrs(name)
            seq = attrs.get("seq_type", 0) != 0
            is_index = attrs.get("is_index", False)
            shape = tuple(attrs.get("shape", ()))
            if seq:
                # attrs["shape"] is always the per-sample shape; Topology
                # prepends T only into its own shape table
                max_len = attrs.get("max_len", 0)
                if seq_pad and attrs.get("seq_type", 0) == 1:
                    eff = (min(int(seq_pad), max_len) if max_len
                           else int(seq_pad))
                    longest = max((len(s) for s in column), default=0)
                    floor = (min(longest, max_len) if max_len
                             else longest)
                    if eff < floor:
                        raise ValueError(
                            f"seq_pad={int(seq_pad)} would truncate "
                            f"input {name!r}: the batch's longest "
                            f"sequence is {longest} (declared max_len="
                            f"{max_len or 'unset'}); pick a bucket "
                            f">= the batch max")
                    max_len = eff
                arr, lens = self._pad_sequences(
                    column, is_index, max_len, shape)
                out[name] = arr
                out[name + "@len"] = lens
            elif attrs.get("sparse_kind"):
                raise NotImplementedError(
                    f"input {name!r}: sparse inputs are not ported to "
                    f"paddle_tpu_torch yet (ROADMAP.md section 1, item 4)")
            elif is_index:
                out[name] = np.asarray(column, dtype=np.int32)
            else:
                arr = np.asarray(column, dtype=np.float32)
                if shape and arr.shape[1:] != shape:
                    arr = arr.reshape((len(column),) + shape)
                out[name] = arr
        return out

    def _pad_sequences(self, column: List, is_index: bool, max_len: int,
                       sample_shape: tuple):
        lens = np.asarray([len(s) for s in column], dtype=np.int32)
        t = _bucket_len(int(lens.max()) if len(lens) else 1, max_len)
        lens = np.minimum(lens, t)
        if is_index:
            arr = np.zeros((len(column), t), dtype=np.int32)
            for i, s in enumerate(column):
                s = list(s)[:t]
                arr[i, :len(s)] = s
        else:
            arr = np.zeros((len(column), t) + tuple(sample_shape),
                           dtype=np.float32)
            for i, s in enumerate(column):
                s = np.asarray(s, dtype=np.float32)[:t]
                arr[i, :len(s)] = s.reshape((len(s),) + tuple(sample_shape))
        return arr, lens
