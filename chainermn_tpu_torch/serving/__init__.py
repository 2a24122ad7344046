"""Serving: continuous-batching inference over a paged KV cache.

* :mod:`.page_allocator` -- refcounted host-side block allocator with the
  prefix trie for copy-on-write sharing;
* :mod:`.kv_cache` -- the ``[L, P, S, H, D]`` device pools and in-place
  page writers;
* :mod:`.scheduler` -- open-loop admission, per-tenant fairness,
  preemption by eviction;
* :mod:`.engine` -- prefill (flash kernel) and paged decode wired
  together, with prefix sharing.
"""

from .engine import (ServingEngine, decode_program, prefill_program,
                     prefix_prefill_program)
from .errors import (EvictionStalledError, PagePoolExhaustedError,
                     QueueSaturatedError, ServingError)
from .kv_cache import (PagedKVCache, copy_page, write_prompt_kv,
                       write_prompt_kv_at, write_token_kv)
from .page_allocator import BlockAllocator
from .scheduler import Request, RequestScheduler

__all__ = [
    "ServingEngine", "prefill_program", "prefix_prefill_program",
    "decode_program", "PagedKVCache", "write_prompt_kv",
    "write_prompt_kv_at", "write_token_kv", "copy_page", "BlockAllocator",
    "Request", "RequestScheduler", "ServingError", "PagePoolExhaustedError",
    "QueueSaturatedError", "EvictionStalledError",
]
