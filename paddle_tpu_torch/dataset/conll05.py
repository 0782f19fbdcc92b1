"""CoNLL-2005 semantic role labelling (counterpart of
``paddle_tpu/dataset/conll05.py``; reference: v2/dataset/conll05.py):
samples (word ids, predicate id, 5 context id lists, mark ids, label ids),
the label_semantic_roles book format; the synthetic stream only, sample
for sample the JAX package's, with its vocabularies (44068 words, 3162
predicates, 67 labels)."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.dataset import common

WORD_VOCAB = 44068
PRED_VOCAB = 3162
LABEL_COUNT = 67


def get_dict(synthetic: bool = True):
    word_dict = {f"w{i}": i for i in range(WORD_VOCAB)}
    verb_dict = {f"v{i}": i for i in range(PRED_VOCAB)}
    label_dict = {f"l{i}": i for i in range(LABEL_COUNT)}
    return word_dict, verb_dict, label_dict


def _synthetic(n, seed):
    def reader():
        rng = common.synthetic_rng("conll05", seed)
        for _ in range(n):
            length = int(rng.randint(5, 40))
            words = rng.randint(0, WORD_VOCAB, size=length).tolist()
            pred = int(rng.randint(0, PRED_VOCAB))
            ctx = [rng.randint(0, WORD_VOCAB, size=length).tolist()
                   for _ in range(5)]
            mark = rng.randint(0, 2, size=length).tolist()
            labels = ((np.asarray(words) + pred) % LABEL_COUNT).tolist()
            yield tuple([words, pred] + ctx + [mark, labels])

    return reader


def test(synthetic: bool = True, n: int = 512):
    if synthetic:
        return _synthetic(n, seed=1)
    common.must_download("conll05", "conll05st tarball")
