"""Device resolution and the constants the attention kernels share.

Counterpart of ``paddle_tpu/core/config.py`` (backend detection) and of the
constants at the top of ``paddle_tpu/ops/flash_attention.py``.
"""

from __future__ import annotations

import torch

# the masked-score sentinel and the exp -> exp2 fold of the online softmax;
# the CUDA sources repeat both (ops/csrc/*.cu) and must stay equal
NEG_INF = -1e30
LOG2E = 1.4426950408889634


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    names another.  ``None`` means ``"cuda"``; a CUDA device with no card
    present raises rather than quietly running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU explicitly")
    return dev
