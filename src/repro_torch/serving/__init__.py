"""Continuous-batching serving over the O(1)-state PRF decode."""
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.prefix_cache import (NoFreePages, PageAllocator,
                                              PrefixCache,
                                              PrefixCacheConfig)
from repro_torch.serving.request import (Request, RequestResult,
                                         shared_prefix_requests,
                                         synthetic_requests)

__all__ = ["NoFreePages", "PageAllocator", "PrefixCache",
           "PrefixCacheConfig", "Request", "RequestResult", "ServingEngine",
           "shared_prefix_requests", "synthetic_requests"]
