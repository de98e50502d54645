"""Host-side prefix KV cache for the decode engine: the counterpart of
mlcomp_tpu/cache, with the same exports.

- ``prefix_index``: radix token-trie with longest-prefix lookup, LRU
  eviction under a host-byte budget, and ref-count pinning (a copy: pure
  host, no torch).
- ``kv_store``: host block storage for the port's bf16/f32 and int8
  cache layouts, the capture that copies a finished prefill's rows out of
  the admission cache, and the write of a hit's rows back into it.
- ``prefix_key``: the pure, process-stable prompt-prefix key (a copy).
"""

from mlcomp_tpu_torch.cache.kv_store import KVBlock, PrefixKVCache  # noqa: F401
from mlcomp_tpu_torch.cache.prefix_index import Lease, PrefixIndex  # noqa: F401
from mlcomp_tpu_torch.cache.prefix_key import (  # noqa: F401
    normalize_ids,
    prefix_hash,
    rendezvous_rank,
)
