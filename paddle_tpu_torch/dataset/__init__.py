"""Dataset loaders (counterpart of ``paddle_tpu/dataset/``; reference:
python/paddle/v2/dataset/), the part the quickstart needs: ``common`` and
``mnist``.

A loader serves the raw files when the cache directory
(``~/.cache/paddle_tpu`` or ``$PADDLE_TPU_DATA``) holds them, else, with
``synthetic=True``, a seeded synthetic stream of the right shapes, sample
for sample the JAX package's; with neither it raises: nothing is
downloaded.  The other datasets come with ``ROADMAP.md`` section 1,
items 9 to 11.
"""

from paddle_tpu_torch.dataset import common
from paddle_tpu_torch.dataset import mnist
