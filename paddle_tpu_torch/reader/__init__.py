"""Reader creators, decorators and prefetch (the part of
``paddle_tpu/reader`` the trainer and the quickstart need)."""

from paddle_tpu_torch.reader.creator import np_array, recordio, text_file
from paddle_tpu_torch.reader.decorator import batched
from paddle_tpu_torch.reader.prefetch import prefetch_to_device

__all__ = ["batched", "np_array", "prefetch_to_device", "recordio",
           "text_file"]
