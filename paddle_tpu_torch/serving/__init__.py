"""Serving tier: paged KV cache, FIFO continuous batching, the engine."""

from .engine import ServingEngine  # noqa: F401
from .kv_cache import (DEFAULT_PAGE_SIZE, PageAllocator,  # noqa: F401
                       PagedKVCache, pages_needed)
from .scheduler import ContinuousBatchingScheduler, Request  # noqa: F401
