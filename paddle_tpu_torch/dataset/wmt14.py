"""WMT14 fr-en translation (counterpart of ``paddle_tpu/dataset/wmt14.py``;
reference: v2/dataset/wmt14.py).  Samples: (src ids, trg ids with <s>,
trg ids with <e>), the seq2seq book format.  The synthetic stream's target
is the reversed source over a shared vocabulary, sample for sample the JAX
package's; a non-synthetic call raises through ``must_download``."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.dataset import common

DICT_SIZE = 30000
START = 0     # <s>
END = 1       # <e>
UNK = 2


def _synthetic(n, dict_size, seed, max_len=16):
    def reader():
        rng = common.synthetic_rng("wmt14", seed)
        for _ in range(n):
            length = int(rng.randint(3, max_len))
            src = rng.randint(3, dict_size, size=length).astype(np.int64)
            trg = src[::-1] % dict_size
            yield (src.tolist(),
                   [START] + trg.tolist(),
                   trg.tolist() + [END])

    return reader


def train(dict_size: int = DICT_SIZE, synthetic: bool = True,
          n: int = 4096):
    if synthetic:
        return _synthetic(n, dict_size, seed=0)
    common.must_download("wmt14", "wmt14 tarball")


def test(dict_size: int = DICT_SIZE, synthetic: bool = True, n: int = 512):
    if synthetic:
        return _synthetic(n, dict_size, seed=1)
    common.must_download("wmt14", "wmt14 tarball")
