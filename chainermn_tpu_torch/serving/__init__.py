"""Serving: continuous-batching inference over a paged KV cache.

* :mod:`.page_allocator` -- refcounted host-side block allocator with the
  prefix trie for copy-on-write sharing;
* :mod:`.kv_cache` -- the ``[L, P, S, H, D]`` device pools and in-place
  page writers;
* :mod:`.scheduler` -- open-loop admission, per-tenant fairness,
  preemption by eviction;
* :mod:`.engine` -- prefill (flash kernel) and paged decode wired
  together, with prefix sharing, speculative decoding, chunked prefill,
  disaggregated prefill and tensor-parallel decode;
* :mod:`.router` / :mod:`.fleet` -- the elastic serving fleet: engines as
  replicas in a ``fleet`` membership group behind a per-tenant fair
  router, a lost replica's sequences replayed on survivors with no drop,
  cold joiners synced over a multicast tree, and the queue-depth scale
  policy (``CHAINERMN_TPU_FLEET=off``: one engine).
"""

from .engine import (ServingEngine, decode_program, ngram_propose,
                     prefill_program, prefix_prefill_program,
                     serve_disagg_mode, serve_spec_k, spec_verify_program)
from .errors import (EvictionStalledError, PagePoolExhaustedError,
                     QueueSaturatedError, ServingError)
from .fleet import (FleetWorker, LocalReplica, QueueDepthScalePolicy,
                    RemoteReplica, ReplicaFleet, fleet_mode)
from .kv_cache import (PagedKVCache, copy_page, insert_pages,
                       write_prompt_kv, write_prompt_kv_at, write_span_kv,
                       write_token_kv)
from .page_allocator import BlockAllocator
from .router import FleetRouter, NoLiveReplicaError
from .scheduler import Request, RequestScheduler

__all__ = [
    "ServingEngine", "prefill_program", "prefix_prefill_program",
    "decode_program", "spec_verify_program", "ngram_propose",
    "serve_disagg_mode", "serve_spec_k", "write_span_kv", "PagedKVCache",
    "write_prompt_kv", "write_prompt_kv_at", "write_token_kv", "copy_page",
    "insert_pages", "BlockAllocator",
    "Request", "RequestScheduler", "ServingError", "PagePoolExhaustedError",
    "QueueSaturatedError", "EvictionStalledError",
    "ReplicaFleet", "FleetRouter", "LocalReplica", "RemoteReplica",
    "FleetWorker", "QueueDepthScalePolicy", "fleet_mode",
    "NoLiveReplicaError",
]
