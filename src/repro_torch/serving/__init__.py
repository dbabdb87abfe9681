from .engine import (DegradeController, GenerationConfig, QueueFullError,
                     Request, RequestBatcher, ServeEngine, SLOConfig)
from .kvcache import (PageAllocator, PagedKVCache, PagedKVConfig,
                      PagePoolOOM)

__all__ = ["ServeEngine", "GenerationConfig", "RequestBatcher", "Request",
           "QueueFullError", "SLOConfig", "DegradeController",
           "PagedKVConfig", "PagedKVCache",
           "PageAllocator", "PagePoolOOM"]
