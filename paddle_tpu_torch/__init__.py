"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` is the reference; this package mirrors its
module layout (``ops/``, ``layers/``, ``models/``, ``serving/``, ``io/``)
so each module's counterpart is found by path.  Every Pallas TPU kernel on
a ported path becomes a CUDA C++ kernel for Hopper (``ops/csrc/*.cu``),
built with ``nvcc`` at first use.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; with no card present they raise instead of falling back.
"""

__version__ = "0.1.0"
