"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` is the reference; this package mirrors its
module layout (``layer``, ``topology``, ``parameters``, ``optimizer``,
``trainer``, ``ops/``, ``layers/``, ``models/``, ``serving/``, ``io/``) so
each module's counterpart is found by path.  Every Pallas TPU kernel on a
ported path becomes a CUDA C++ kernel for Hopper (``ops/csrc/*.cu``),
built with ``nvcc`` at first use.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; with no card present they raise instead of falling back.
"""

from paddle_tpu_torch import activation
from paddle_tpu_torch import attr
from paddle_tpu_torch import data_feeder
from paddle_tpu_torch import data_type
from paddle_tpu_torch import event
from paddle_tpu_torch import initializer
from paddle_tpu_torch import layer
from paddle_tpu_torch import optimizer
from paddle_tpu_torch import parameters
from paddle_tpu_torch import reader
from paddle_tpu_torch import topology
from paddle_tpu_torch import trainer
from paddle_tpu_torch.core import config as _config
from paddle_tpu_torch.reader.decorator import batched as batch
from paddle_tpu_torch.topology import Topology

__version__ = "0.1.0"

PRECISIONS = ("fp32",)


def init(seed: int = 0, precision: str = "fp32", device=None, **options):
    """Framework initialisation (reference: paddle.init): records the rng
    seed and options, as ``paddle_tpu.init`` does.

    ``device`` becomes the default of every entry point (``Topology``
    forward, ``parameters.create``, ``trainer.SGD``); left unset it is the
    card, and with no card ``init`` raises.  Like every option it persists
    until set again.  Only the ``fp32`` precision policy is ported: the
    bf16 policies and their loss scaling are ROADMAP.md section 1, item 1.
    """
    if precision not in PRECISIONS:
        raise NotImplementedError(
            f"precision policy {precision!r} is not ported to "
            f"paddle_tpu_torch yet (ROADMAP.md section 1, item 1); only "
            f"{PRECISIONS} is")
    if options.get("compute_dtype", "float32") != "float32":
        raise NotImplementedError(
            f"compute_dtype={options['compute_dtype']!r}: only float32 is "
            f"ported to paddle_tpu_torch")
    if device is not None:
        _config.set_option("device", device)
    _config.default_device()          # no card and no device: raise
    _config.set_seed(seed)
    _config.set_option("precision", precision)
    for k, v in options.items():
        _config.set_option(k, v)
