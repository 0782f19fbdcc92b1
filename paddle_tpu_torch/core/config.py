"""Global options, device resolution and the constants the attention kernels
share.

Counterpart of ``paddle_tpu/core/config.py`` (the options dict and its
setters; backend detection) and of the constants at the top of
``paddle_tpu/ops/flash_attention.py``.
"""

from __future__ import annotations

import torch

# the masked-score sentinel and the exp -> exp2 fold of the online softmax;
# the CUDA sources repeat both (ops/csrc/flash_common.cuh,
# paged_decode.cu) and must stay equal
NEG_INF = -1e30
LOG2E = 1.4426950408889634

_options: dict = {
    "seed": 0,                # global rng seed (reference: FLAGS_seed)
    "log_period": 100,        # reference: FLAGS_log_period
    # where entry points run when the caller names no device: None means
    # the card (see resolve_device)
    "device": None,
    # flash_attention's impl for the attention layers: None routes by
    # device; "torch" forces the plain version on the card (the reference
    # the kernels are held against)
    "attention_impl": None,
}


def set_seed(seed: int) -> None:
    _options["seed"] = int(seed)


def set_option(key: str, value) -> None:
    _options[key] = value


def get_option(key: str, default=None):
    return _options.get(key, default)


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


def default_device(device=None) -> torch.device:
    """``device`` if given, else the ``device`` option, resolved."""
    return resolve_device(device if device is not None
                          else _options.get("device"))
