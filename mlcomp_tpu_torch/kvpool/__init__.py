"""Device-resident paged KV cache for the serving engine: the counterpart
of mlcomp_tpu/kvpool.

The dense engine pays worst-case KV per slot; the paged layout stores the
cache as ``(num_pages, page_tokens, ...)`` tiles with per-slot page
tables, so sequence length is paid per page, left-pad and unused budget
cost nothing (the shared NULL page), and the live slot count scales with
traffic under a free-page budget.

- ``allocator``, ``pool``: host bookkeeping, copies of the JAX package's
  numpy-only modules (free list and ref counts, slot-row policy, lazy
  decode-page growth, the prefix-page registry);
- ``layout``: the paged form of each cache leaf and the gather/scatter
  between pages and the dense view (the page-gather kernel, B8);
- ``attn``: :class:`PagedKV`, one dispatch's pages and table, which the
  engine hands to the model in place of a dense cache.

``mlcomp_tpu_torch/engine.py`` wires it in behind ``kv_layout="paged"``.
"""

from mlcomp_tpu_torch.kvpool.allocator import (  # noqa: F401
    GRAVE_PAGE,
    NULL_PAGE,
    RESERVED_PAGES,
    NoFreePages,
    PageAllocator,
)
from mlcomp_tpu_torch.kvpool.attn import PagedKV, PagedLayer  # noqa: F401
from mlcomp_tpu_torch.kvpool.layout import PagedLayout  # noqa: F401
from mlcomp_tpu_torch.kvpool.pool import PageLease, PagePool  # noqa: F401
