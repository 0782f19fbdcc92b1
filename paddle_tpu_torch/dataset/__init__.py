"""Dataset loaders (counterpart of ``paddle_tpu/dataset/``; reference:
python/paddle/v2/dataset/): ``common``, ``mnist``, ``cifar``, and the
synthetic streams of ``flowers``, ``imdb``, ``wmt14``, ``wmt16``,
``conll05``, ``imikolov`` and ``movielens``.

A loader serves the raw files when the cache directory
(``~/.cache/paddle_tpu`` or ``$PADDLE_TPU_DATA``) holds them, else, with
``synthetic=True``, a seeded synthetic stream of the right shapes, sample
for sample the JAX package's; with neither it raises: nothing is
downloaded.  The other datasets (mq2007, sentiment, uci_housing,
voc2012) come with ``ROADMAP.md`` section 1, item 11b.
"""

from paddle_tpu_torch.dataset import common
from paddle_tpu_torch.dataset import mnist
from paddle_tpu_torch.dataset import cifar
from paddle_tpu_torch.dataset import flowers
from paddle_tpu_torch.dataset import imdb
from paddle_tpu_torch.dataset import wmt14
from paddle_tpu_torch.dataset import wmt16
from paddle_tpu_torch.dataset import conll05
from paddle_tpu_torch.dataset import imikolov
from paddle_tpu_torch.dataset import movielens
