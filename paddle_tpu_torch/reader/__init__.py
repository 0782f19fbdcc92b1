"""Reader decorators and prefetch (the part of ``paddle_tpu/reader`` the
trainer needs)."""

from paddle_tpu_torch.reader.decorator import batched
from paddle_tpu_torch.reader.prefetch import prefetch_to_device

__all__ = ["batched", "prefetch_to_device"]
