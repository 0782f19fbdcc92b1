"""The PTB n-gram dataset (counterpart of ``paddle_tpu/dataset/imikolov.py``;
reference: v2/dataset/imikolov.py): n-gram tuples of word ids for the
word2vec book chapter; the synthetic stream only, sample for sample the
JAX package's, over its 2074 words."""

from __future__ import annotations


from paddle_tpu_torch.dataset import common

VOCAB_SIZE = 2074


def build_dict(synthetic: bool = True):
    return {f"w{i}": i for i in range(VOCAB_SIZE)}


def _synthetic(n, gram, seed):
    def reader():
        rng = common.synthetic_rng("imikolov", seed)
        # markov-ish chain so context predicts next word
        trans = rng.randint(0, VOCAB_SIZE, size=(VOCAB_SIZE,))
        for _ in range(n):
            w = int(rng.randint(0, VOCAB_SIZE))
            seq = [w]
            for _ in range(gram - 1):
                w = int((trans[w] + rng.randint(0, 3)) % VOCAB_SIZE)
                seq.append(w)
            yield tuple(seq)

    return reader


def train(word_idx=None, n=5, synthetic: bool = True, samples: int = 4096):
    if synthetic:
        return _synthetic(samples, n, seed=0)
    common.must_download("imikolov", "ptb.train.txt")


def test(word_idx=None, n=5, synthetic: bool = True, samples: int = 512):
    if synthetic:
        return _synthetic(samples, n, seed=1)
    common.must_download("imikolov", "ptb.valid.txt")
