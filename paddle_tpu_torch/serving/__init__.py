"""Serving: the engine (whole-forward micro-batches, or decode over the
slab and paged decoders; lanes, tenants, admission, breakers, the
watchdog; model versions and canaries), its HTTP front end, weight
reloads from the checkpoint stream, the fleet router and the client."""

from paddle_tpu_torch.serving import fleet
from paddle_tpu_torch.serving.blocks import (BlockAllocator,
                                             KVPoolExhausted, chain_hash)
from paddle_tpu_torch.serving.client import (ServingClient,
                                             ServingHTTPError,
                                             local_transport)
from paddle_tpu_torch.serving.engine import (BreakerOpen, DeadlineExceeded,
                                             EngineClosed, EngineUnhealthy,
                                             InferenceEngine, Overloaded,
                                             ServingError, default_buckets)
from paddle_tpu_torch.inference import bucket_rows
from paddle_tpu_torch.serving.reload import WeightWatcher
from paddle_tpu_torch.serving.router import Router

__all__ = ["InferenceEngine", "bucket_rows", "default_buckets",
           "ServingError", "Overloaded", "BreakerOpen",
           "DeadlineExceeded", "EngineClosed", "EngineUnhealthy",
           "BlockAllocator", "KVPoolExhausted", "chain_hash",
           "ServingClient", "ServingHTTPError", "local_transport",
           "Router", "fleet", "WeightWatcher"]
