"""Reader creators, decorators and prefetch: a reader is a zero-argument
callable returning an iterator (reference: python/paddle/v2/reader/)."""

from paddle_tpu_torch.reader.creator import np_array, recordio, text_file
from paddle_tpu_torch.reader.decorator import (
    batched, buffered, cache, chain, compose, firstn, map_readers, shuffle,
    xmap_readers)
from paddle_tpu_torch.reader.prefetch import prefetch_to_device

__all__ = ["batched", "buffered", "cache", "chain", "compose", "firstn",
           "map_readers", "np_array", "prefetch_to_device", "recordio",
           "shuffle", "text_file", "xmap_readers"]
