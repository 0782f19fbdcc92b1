"""Reader decorators (the part of ``paddle_tpu/reader`` the trainer
needs)."""

from paddle_tpu_torch.reader.decorator import batched

__all__ = ["batched"]
