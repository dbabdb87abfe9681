from .engine import (DegradeController, GenerationConfig, QueueFullError,
                     Request, RequestBatcher, ServeEngine, SLOConfig,
                     make_key, split_key)
from .failover import DurableBatcher, ServeSupervisor, SimulatedCrash
from .kvcache import (PageAllocator, PagedKVCache, PagedKVConfig,
                      PagePoolOOM)

__all__ = ["ServeEngine", "GenerationConfig", "RequestBatcher", "Request",
           "QueueFullError", "SLOConfig", "DegradeController",
           "PagedKVConfig", "PagedKVCache",
           "PageAllocator", "PagePoolOOM", "DurableBatcher",
           "ServeSupervisor", "SimulatedCrash", "make_key", "split_key"]
