"""Serving: the decode engine (slab and paged decoders, lanes, tenants,
admission, breakers, the watchdog), its HTTP front end and the client."""

from paddle_tpu_torch.serving.blocks import (BlockAllocator,
                                             KVPoolExhausted, chain_hash)
from paddle_tpu_torch.serving.client import (ServingClient,
                                             ServingHTTPError,
                                             local_transport)
from paddle_tpu_torch.serving.engine import (BreakerOpen, DeadlineExceeded,
                                             EngineClosed, EngineUnhealthy,
                                             InferenceEngine, Overloaded,
                                             ServingError)

__all__ = ["InferenceEngine", "ServingError", "Overloaded", "BreakerOpen",
           "DeadlineExceeded", "EngineClosed", "EngineUnhealthy",
           "BlockAllocator", "KVPoolExhausted", "chain_hash",
           "ServingClient", "ServingHTTPError", "local_transport"]
