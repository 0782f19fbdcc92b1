"""Inference: the forward of a topology, without gradients (counterpart of
``paddle_tpu/inference.py``: ``Inference``, ``infer`` and ``bucket_rows``).

Reference: python/paddle/v2/inference.py (Inference:24, infer:125).  Each
batch is one plain ``torch.no_grad`` forward in eval mode on the device
given at construction (default: the ``device`` option, else the card);
the results come back as numpy.  ``iter_infer`` pads a short final batch
to ``batch_size`` (or to the smallest of ``bucket_batch`` that fits) by
repeating its last sample and slices the padding out of every result, so
the batch shapes stay the JAX package's.

Not ported yet, and refused: ``compile_cache_dir`` (the JAX package's disk
cache of compiled executables; ``ROADMAP.md`` section 1, item 13b).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core import config as cfg
from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch.topology import Topology


def bucket_rows(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n, or n itself when none is large enough."""
    for b in buckets:
        if b >= n:
            return b
    return n


class Inference:
    def __init__(self, output_layer, parameters,
                 compile_cache_dir: Optional[str] = None, device=None):
        if compile_cache_dir:
            raise NotImplementedError(
                "compile_cache_dir is not ported to paddle_tpu_torch yet "
                "(ROADMAP.md section 1, item 13b)")
        outputs = (output_layer if isinstance(output_layer, (list, tuple))
                   else [output_layer])
        self.device = cfg.default_device(device)
        self.topology = Topology(outputs, collect_evaluators=False)
        self.parameters = parameters
        self.output_names = self.topology.output_names
        self._state = self.topology.create_state(device=self.device)
        # a scalar output (a cost) folds the batch away: its padding could
        # not be sliced back out, so such a topology runs unpadded
        self._pad_ok = all(self.topology.shapes[n] != ()
                           for n in self.output_names)

    @torch.no_grad()
    def run_feed(self, feed: Dict[str, np.ndarray],
                 params: Optional[dict] = None) -> dict:
        """One forward on a built feed dict: ``{name: tensor}``.
        ``params`` overrides the weights for this call (same names and
        shapes)."""
        values = self.parameters.values if params is None else params
        outs, _ = self.topology.forward(values, self._state, feed,
                                        train=False, device=self.device)
        return outs

    def iter_infer_field(self, field, **kwargs):
        for result in self.iter_infer(**kwargs):
            yield [result[name] for name in self.output_names]

    def iter_infer(self, input, feeding=None, batch_size: int = 0,
                   bucket_batch: Optional[Sequence[int]] = None):
        feeder = DataFeeder(self.topology, feeding)
        batch_size = batch_size or len(input)
        for i in range(0, len(input), batch_size):
            batch = list(input[i:i + batch_size])
            real = len(batch)
            target = (bucket_rows(real, sorted(bucket_batch))
                      if bucket_batch else batch_size)
            if self._pad_ok and target > real:
                # the last sample repeated, so the padding holds valid data
                batch.extend(batch[-1:] * (target - real))
            out = self.run_feed(feeder.feed(batch))
            yield {n: v.detach().cpu().numpy()[:real]
                   if len(batch) > real else v.detach().cpu().numpy()
                   for n, v in out.items()}

    def infer(self, input, feeding=None, field="value", batch_size: int = 0,
              bucket_batch: Optional[Sequence[int]] = None):
        results = [[out[n] for n in self.output_names]
                   for out in self.iter_infer(input=input, feeding=feeding,
                                              batch_size=batch_size,
                                              bucket_batch=bucket_batch)]
        merged = [np.concatenate([r[i] for r in results])
                  for i in range(len(self.output_names))]
        return merged[0] if len(merged) == 1 else merged


def infer(output_layer, parameters, input, feeding=None, field="value",
          batch_size: int = 0, device=None):
    """paddle.infer parity (reference: v2/inference.py:125)."""
    return Inference(output_layer, parameters, device=device).infer(
        input, feeding=feeding, field=field, batch_size=batch_size)
