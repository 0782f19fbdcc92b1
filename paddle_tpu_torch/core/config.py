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
    # the recurrent layers' switch to their CUDA step kernels
    # (ops/fused_rnn.py): True routes a standard cell on the card to the
    # kernel, False runs the plain step (the reference's escape hatch)
    "use_fused_rnn": True,
    # accepted so configs written for the JAX package run: there it is
    # lax.scan's unroll factor; the port's recurrences are eager loops
    # over T, which it does not change
    "scan_unroll": 1,
    # the conv slice's two opt-in fusions, with the JAX package's values:
    # fuse_conv_bn False / True (1x1 stride-1 conv+BN pairs become
    # conv_bn layers, kernel 8) / "all" (the 3x3 stride-1 ones too,
    # kernel 9), read by models/resnet.py when it builds the graph;
    # fused_bn_impl None (the default: plain statistics) / "xla" /
    # "interpret" (the plain statistics) / "pallas" (the relu BatchNorms
    # on the card take the CUDA statistic kernels 7a and 7b)
    "fuse_conv_bn": False,
    "fused_bn_impl": None,
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
