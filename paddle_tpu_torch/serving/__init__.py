"""Serving: the paged decode engine and its HTTP front end."""

from paddle_tpu_torch.serving.blocks import (BlockAllocator,
                                             KVPoolExhausted, chain_hash)
from paddle_tpu_torch.serving.engine import (DeadlineExceeded,
                                             EngineClosed,
                                             InferenceEngine, Overloaded,
                                             ServingError)

__all__ = ["BlockAllocator", "DeadlineExceeded", "EngineClosed",
           "InferenceEngine", "KVPoolExhausted", "Overloaded",
           "ServingError", "chain_hash"]
