"""Serving tier: paged KV cache with a prefix index, the FIFO and
preemptive continuous-batching schedulers, speculative decoding, and the
engine."""

from .engine import ServingEngine  # noqa: F401
from .kv_cache import (DEFAULT_PAGE_SIZE, PageAllocator,  # noqa: F401
                       PagedKVCache, PrefixCache, pages_needed)
from .scheduler import (ContinuousBatchingScheduler,  # noqa: F401
                        PreemptiveScheduler, Request)
from .speculative import SpeculativeDecoder, build_draft_lm  # noqa: F401
