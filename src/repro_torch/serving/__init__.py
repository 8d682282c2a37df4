from .engine import EngineStats, PagedServingEngine, Request, ServingEngine
from .lifecycle import (TERMINAL_STATUSES, EngineStallError, RequestStatus)
from .paged_cache import BlockAllocator, PagedKVCache, PoolExhausted

__all__ = ["BlockAllocator", "EngineStats", "PagedKVCache",
           "PagedServingEngine", "PoolExhausted", "Request", "ServingEngine",
           "TERMINAL_STATUSES", "EngineStallError", "RequestStatus"]
