"""Paged attention's view of one dispatch: the counterpart of
mlcomp_tpu/kvpool/attn.py.

The engine passes a :class:`PagedKV` to ``TransformerLM.forward`` in place
of a ``DecodeCache`` (an explicit argument where the JAX package installs a
trace-time context).  The attention modules then create or read no dense
cache:

- the new rows' K/V (and the int8 scales) are written straight into their
  physical pages, in place: page ``table[row, pos // T]``, offset
  ``pos % T``.  The flat page-row indices are resolved ONCE per forward
  (:meth:`PagedKV.cursors`), for every layer, and each page tensor takes
  one ``index_copy_``: the dense path's write, with other indices.  A
  retired row's all-GRAVE table parks its frozen cursor's writes on the
  graveyard page; NULL is never inside a write span;
- the int8 family reads its pages through the table in the paged decode
  kernels (B6 for one query, B7 for a chunk; :meth:`PagedLayer.kernel_table`);
- the bf16 family reads each layer's dense view through the page gather
  (B8; :meth:`PagedLayer.gather_dense`) and runs the dense attention over it.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from mlcomp_tpu_torch.kvpool.layout import PagedLayout


class PagedLayer:
    """One layer's slice of a :class:`PagedKV`: ``pages`` is the layer's
    cache dataclass (``KVCache`` or ``QuantKVCache``) holding the PAGE
    tensors, so the write path is the dense cursor path's."""

    def __init__(self, kv: "PagedKV", layer: int, pages):
        self.kv, self.layer, self.pages = kv, layer, pages

    def gather_dense(self, field: str) -> torch.Tensor:
        """This layer's leaf ``field`` as its dense view (B8)."""
        idx = self.kv.index[(self.layer, field)]
        layout = self.kv.layout
        return layout.gather_leaf(layout.kv_specs[idx], self.kv.pages[idx], self.kv.table)

    def kernel_table(self, field: str = "kq") -> torch.Tensor:
        """The table columns covering leaf ``field``'s buffer, for B6/B7."""
        layout = self.kv.layout
        spec = layout.kv_specs[self.kv.index[(self.layer, field)]]
        return self.kv.table[:, : layout.n_cols(spec)]


class PagedKV:
    """One dispatch's paged KV: the page tensors (written in place), the
    (slots, max_pages) int32 table and the static layout."""

    def __init__(self, layout: PagedLayout, pages: Sequence[torch.Tensor],
                 table: torch.Tensor):
        from mlcomp_tpu_torch.models.transformer import KVCache, QuantKVCache

        self.layout = layout
        self.pages: List[torch.Tensor] = list(pages)
        self.table = table
        self.index = {(s.layer, s.field): i for i, s in enumerate(layout.kv_specs)}
        per_layer: dict = {}
        for spec, pg in zip(layout.kv_specs, self.pages):
            per_layer.setdefault(spec.layer, {})[spec.field] = pg
        self.layers = [
            PagedLayer(self, li, (QuantKVCache if "kq" in f else KVCache)(**f))
            for li, f in sorted(per_layer.items())
        ]

    def cursors(self, cursor: torch.Tensor, s: int):
        """The per-row cursors of one forward resolved to page rows, for
        every layer (a ``RowCursors``): row b's S new K/V go to slots
        ``cursor_b + j`` (the start clamped to ``[0, L - S]``, as the dense
        path clamps) at physical page ``table[b, slot // T]``, offset
        ``slot % T``.  ``flat`` indexes the pages flattened to (rows,
        features): (P*T, Hkv*dh) for the bf16 family, (P*Hkv*T, dhp) for
        the int8 one, whose (P*Hkv*T,) scale rows share them."""
        from mlcomp_tpu_torch.models.transformer import RowCursors

        spec = self.layout.kv_specs[0]
        t = self.layout.page_tokens
        cur = cursor.long()
        dev = cur.device
        j = torch.arange(s, device=dev)[None]
        slot = torch.clamp(cur, 0, spec.seq_len - s)[:, None] + j            # (B, S)
        page = self.table.long().gather(1, slot // t)                        # (B, S)
        row = page * t + slot % t
        if spec.field == "kq":
            h_kv = spec.shape[1]
            heads = torch.arange(h_kv, device=dev)
            # (page * Hkv + h) * T + slot % T
            row = (page[..., None] * h_kv + heads) * t + (slot % t)[..., None]   # (B, S, Hkv)
        return RowCursors(q_slots=cur[:, None] + j, stop0=(cur + 1).to(torch.int32),
                          flat=row.reshape(-1))
