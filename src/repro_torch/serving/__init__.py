from .engine import GenerationConfig, Request, RequestBatcher, ServeEngine
from .kvcache import (PageAllocator, PagedKVCache, PagedKVConfig,
                      PagePoolOOM)

__all__ = ["ServeEngine", "GenerationConfig", "RequestBatcher", "Request",
           "PagedKVConfig", "PagedKVCache",
           "PageAllocator", "PagePoolOOM"]
