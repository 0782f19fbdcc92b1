"""WMT16 en-de translation (counterpart of ``paddle_tpu/dataset/wmt16.py``;
reference: v2/dataset/wmt16.py, a BPE vocabulary).  Samples as wmt14's:
(src ids, trg-in with <s>, trg-out with <e>).  The synthetic stream's
target is the source under a fixed permutation and offset, sample for
sample the JAX package's; a non-synthetic call raises through
``must_download``."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.dataset import common

DICT_SIZE = 10000
START = 0
END = 1
UNK = 2


def get_dict(lang: str = "en", dict_size: int = DICT_SIZE,
             synthetic: bool = True):
    return {f"{lang}{i}": i for i in range(dict_size)}


def _synthetic(n, dict_size, seed, max_len=16):
    def reader():
        rng = common.synthetic_rng("wmt16", seed)
        for _ in range(n):
            length = int(rng.randint(3, max_len))
            src = rng.randint(3, dict_size, size=length).astype(np.int64)
            trg = ((src + 7) % (dict_size - 3)) + 3
            yield (src.tolist(),
                   [START] + trg.tolist(),
                   trg.tolist() + [END])

    return reader


def train(src_dict_size: int = DICT_SIZE, trg_dict_size: int = DICT_SIZE,
          synthetic: bool = True, n: int = 4096):
    if synthetic:
        return _synthetic(n, min(src_dict_size, trg_dict_size), seed=0)
    common.must_download("wmt16", "wmt16 tarball")


def test(src_dict_size: int = DICT_SIZE, trg_dict_size: int = DICT_SIZE,
         synthetic: bool = True, n: int = 512):
    if synthetic:
        return _synthetic(n, min(src_dict_size, trg_dict_size), seed=1)
    common.must_download("wmt16", "wmt16 tarball")


validation = test
