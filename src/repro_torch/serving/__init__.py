"""Continuous-batching serving over the O(1)-state PRF decode."""
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import (Request, RequestResult,
                                         synthetic_requests)

__all__ = ["Request", "RequestResult", "ServingEngine",
           "synthetic_requests"]
