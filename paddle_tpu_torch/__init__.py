"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` is the reference; this package mirrors its
module layout (``layer``, ``topology``, ``parameters``, ``optimizer``,
``trainer``, ``evaluator``, ``inference``, ``dataset/``, ``ops/``,
``layers/``, ``models/``, ``serving/``, ``io/``, ``fluid/``,
``trainer_config_helpers/``) so
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
from paddle_tpu_torch import dataset
from paddle_tpu_torch import evaluator
from paddle_tpu_torch import event
from paddle_tpu_torch import image
from paddle_tpu_torch import inference
from paddle_tpu_torch import initializer
from paddle_tpu_torch import layer
from paddle_tpu_torch import networks
from paddle_tpu_torch import observability
from paddle_tpu_torch import optimizer
from paddle_tpu_torch import parameters
from paddle_tpu_torch import plot
from paddle_tpu_torch import pooling
from paddle_tpu_torch import reader
from paddle_tpu_torch import topology
from paddle_tpu_torch import trainer
from paddle_tpu_torch.core import config as _config
from paddle_tpu_torch.inference import infer
from paddle_tpu_torch.reader.decorator import batched as batch
from paddle_tpu_torch.topology import Topology

__version__ = "0.1.0"

PRECISIONS = ("fp32", "bf16", "fp16", "mixed")


def init(seed: int = 0, device=None, **options):
    """Framework initialisation (reference: paddle.init): records the rng
    seed and options, as ``paddle_tpu.init`` does.

    ``device`` becomes the default of every entry point (``Topology``
    forward, ``parameters.create``, ``trainer.SGD``); left unset it is the
    card, and with no card ``init`` raises.  Like every option it persists
    until set again.

    ``precision`` names the precision policy (``core/precision.py``), one
    of ``PRECISIONS``: ``fp32`` (the default), ``bf16`` and ``fp16``
    (reduced-precision compute on float32 master parameters) and
    ``mixed`` (bf16 compute with dynamic loss scaling, tuned by
    ``loss_scale_init``, ``loss_scale_growth_interval``,
    ``loss_scale_growth_factor``, ``loss_scale_backoff_factor``,
    ``loss_scale_max`` and ``loss_scale_min``).  ``compute_dtype`` is its
    deprecated alias (``"bfloat16"`` means ``bf16``; warned once).  The
    two apply in the order given, so the later spelling wins, and the
    policy persists until named again.

    ``use_fused_rnn`` (default True) sends the standard LSTM and GRU cells
    on the card to their CUDA step kernels (``ops/fused_rnn.py``); False
    keeps them on the plain step.  ``scan_unroll`` is accepted so configs
    written for the JAX package run, and has no effect: each recurrence
    here is an eager loop over T, one step an iteration.

    The conv slice's two opt-in fusions take the JAX package's values:
    ``fuse_conv_bn`` (False; True: ``models/resnet.py`` builds the 1x1
    stride-1 conv + BN pairs as ``conv_bn`` layers, kernel 8; ``"all"``:
    the 3x3 stride-1 ones too, kernel 9) and ``fused_bn_impl`` (None or
    ``"xla"`` / ``"interpret"``: batch norm takes the plain statistics;
    ``"pallas"``: a relu batch norm on the card takes the CUDA statistic
    kernels 7a and 7b).
    """
    from paddle_tpu_torch.core import precision as _precision

    if device is not None:
        _config.set_option("device", device)
    _config.default_device()          # no card and no device: raise
    _config.set_seed(seed)
    evaluator.reset_registry()
    for k, v in options.items():
        if k == "precision":
            _precision.apply_policy_name(v)
        elif k == "compute_dtype":
            _precision.apply_legacy_compute_dtype(v)
        else:
            _config.set_option(k, v)


def default_main_program():
    """Fluid's default main program, re-exported at the top level as the
    reference's v2 package does."""
    from paddle_tpu_torch.fluid import framework

    return framework.default_main_program()


def default_startup_program():
    from paddle_tpu_torch.fluid import framework

    return framework.default_startup_program()
