"""The prompt-prefix affinity key, shared by cache and router: the port's
copy of mlcomp_tpu/cache/prefix_key.py.

``PrefixIndex`` (the host prefix KV cache) and the fleet router
(``mlcomp_tpu/fleet/router.py``) both key on "the first N token ids of
the prompt".  If each computed that key its own way — the trie with its
private ``int(t) for t in ids`` walk, the router with an ad-hoc hash —
the two would drift the first time either tweaked its coercion, and
affinity routing would silently stop landing requests on the replica
whose cache holds their prefix.  This module is the single definition
of that key: pure, import-light (no JAX, no numpy), deterministic
across processes and restarts (no ``PYTHONHASHSEED`` dependence).

- :func:`normalize_ids` is the canonical token coercion — exactly the
  walk ``PrefixIndex.lookup``/``insert`` perform on their inputs (and
  now delegate here).
- :func:`prefix_key_bytes` serializes a bounded prefix of those ids
  into the canonical byte string both sides hash.
- :func:`prefix_hash` digests that byte string (blake2b) into a stable
  hex key — the router's affinity key.
- :func:`rendezvous_rank` turns the key into a highest-random-weight
  (HRW) ranking over replica names: every router instance — including
  one restarted mid-traffic — maps the same prefix to the same replica
  preference order, and adding/removing one replica only moves the
  keys that hashed to it.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, List, Sequence, Tuple

# how many leading prompt tokens feed the affinity key by default: long
# enough to separate real system prompts/templates, short enough that
# one shared preamble plus a user suffix still maps to one replica
DEFAULT_AFFINITY_TOKENS = 32


def normalize_ids(ids: Iterable) -> Tuple[int, ...]:
    """The canonical token-id coercion (``int()`` each element) the
    prefix trie applies before any walk — routers and caches must agree
    on these exact values for affinity to mean anything."""
    return tuple(int(t) for t in ids)


def prefix_key_bytes(ids: Iterable, max_tokens: int = DEFAULT_AFFINITY_TOKENS
                     ) -> bytes:
    """The canonical byte serialization of ``ids[:max_tokens]``: each
    normalized id as 8 little-endian signed bytes.  Fixed-width (not a
    repr/join) so no two distinct id sequences can collide by
    concatenation."""
    toks = normalize_ids(ids)
    if max_tokens is not None and max_tokens >= 0:
        toks = toks[:max_tokens]
    return b"".join(t.to_bytes(8, "little", signed=True) for t in toks)


def prefix_hash(ids: Iterable, max_tokens: int = DEFAULT_AFFINITY_TOKENS
                ) -> str:
    """Stable hex digest of the prompt's affinity prefix — identical
    across processes, machines, and router restarts."""
    return hashlib.blake2b(
        prefix_key_bytes(ids, max_tokens), digest_size=16
    ).hexdigest()


def _weight(key: str, member: str) -> int:
    h = hashlib.blake2b(
        key.encode() + b"\x00" + member.encode(), digest_size=8
    )
    return int.from_bytes(h.digest(), "little")


def rendezvous_rank(key: str, members: Sequence[str]) -> List[str]:
    """Members sorted by descending HRW weight for ``key`` (ties broken
    by name for total determinism).  ``rank[0]`` is the affinity
    target; the tail is the stable failover order."""
    return sorted(
        members, key=lambda m: (-_weight(key, m), m)
    )
