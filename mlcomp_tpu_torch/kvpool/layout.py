"""Paged layout over the engine's KV cache: the counterpart of
mlcomp_tpu/kvpool/layout.py, in torch.

A page is a dense-layout TILE of one cache leaf: drop the batch (slot)
axis, put the physical-page axis first, shrink the sequence axis to
``page_tokens`` in place.  The port's two cache families
(``models/transformer.py``) page as

- bf16/f32 ``KVCache``: ``k``/``v`` (B, L, Hkv, dh) -> (P, T, Hkv, dh);
- int8 ``QuantKVCache``: ``kq``/``vq`` (B, Hkv, L, dhp) -> (P, Hkv, T, dhp)
  and the scales ``ks``/``vs`` (B, Hkv, 1, L) -> (P, Hkv, 1, T),

the JAX package's page shapes, byte for byte, so a page written by one
package reads the same in the other.  Every leaf carries the flax path the
JAX cache pytree gives it (``DecoderLayer_0/attn/cached_key_q``), which is
what a handoff between the packages keys on.

Gathers through a table run the page-gather kernel (``ops/cuda/page_gather``,
B8) on a card; writes (``scatter``, ``insert_rows``) are one
``index_copy_`` per page tensor, in place.  Everything here is pure data
movement, exact for every dtype.  The int8 family's decode attention reads
pages through the table directly (``kvpool/attn.PagedKV``); the gather
serves the bf16 family, the tests and the reference.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch

from mlcomp_tpu_torch.ops.cuda.page_gather import page_gather

# leaf name -> axis holding the cache slot (sequence) dimension, a copy of
# mlcomp_tpu/cache/kv_store.py's SLOT_AXES
SLOT_AXES = {
    "cached_key": 1,
    "cached_value": 1,
    "cached_key_q": 2,
    "cached_value_q": 2,
    "cached_key_scale": 3,
    "cached_value_scale": 3,
}

# the port's cache dataclass fields and the JAX cache leaf each one is
FIELD_LEAVES = {
    "k": "cached_key", "v": "cached_value",
    "kq": "cached_key_q", "ks": "cached_key_scale",
    "vq": "cached_value_q", "vs": "cached_value_scale",
}


class LeafSpec(NamedTuple):
    keystr: str           # the flax path of the leaf
    layer: int            # index into DecodeCache.layers
    field: str            # attribute of the layer's cache dataclass
    slot_axis: int
    shape: tuple          # dense leaf shape at slots = 1
    dtype: torch.dtype
    seq_len: int          # the leaf's own buffer length (the int8 family
    # lane-rounds past l_buf; the rounded tail is never written, so its
    # pages stay NULL, but gather and scatter cover it to keep shapes)


class PagedLayout:
    """Static description of one cache family's paged form, built from a
    dense ``DecodeCache`` of one row (its shapes and dtypes only)."""

    def __init__(self, cache, l_buf: int, page_tokens: int,
                 num_pages: Optional[int] = None):
        self.l_buf = int(l_buf)
        self.page_tokens = int(page_tokens)
        # num_pages may stay unset while the caller derives the pool budget
        # from the layout (max_pages depends on the cache shapes alone)
        self.num_pages = None if num_pages is None else int(num_pages)
        if self.page_tokens < 1:
            raise ValueError(f"page_tokens must be >= 1: {page_tokens}")
        self.kv_specs: List[LeafSpec] = []
        for li, layer in enumerate(cache.layers):
            for field, leaf in vars(layer).items():
                name = FIELD_LEAVES[field]
                ax = SLOT_AXES[name]
                if leaf.shape[ax] < self.l_buf:
                    raise ValueError(f"leaf {field} of layer {li} has {leaf.shape[ax]} cache "
                                     f"slots, below l_buf={self.l_buf}")
                self.kv_specs.append(LeafSpec(
                    f"DecoderLayer_{li}/attn/{name}", li, field, ax,
                    (1,) + tuple(leaf.shape[1:]), leaf.dtype, int(leaf.shape[ax])))
        self.kv_index = {s.keystr: i for i, s in enumerate(self.kv_specs)}
        # table width: enough pages for the LONGEST leaf buffer; a leaf reads
        # only its own first ceil(seq_len / T) columns
        self.max_pages = max(-(-s.seq_len // self.page_tokens) for s in self.kv_specs)

    # ---------------------------------------------------------- allocation

    def _require_pages(self) -> int:
        if self.num_pages is None:
            raise ValueError("PagedLayout.num_pages is unset: set it before materializing "
                             "or pricing pages")
        return self.num_pages

    def _page_rest(self, spec: LeafSpec) -> tuple:
        return tuple(self.page_tokens if i == spec.slot_axis else d
                     for i, d in enumerate(spec.shape) if i != 0)

    def page_shape(self, spec: LeafSpec) -> tuple:
        return (self._require_pages(),) + self._page_rest(spec)

    def fresh_pages(self, device) -> List[torch.Tensor]:
        """Zeroed page tensors, one per leaf (kv_specs order).  Zeros, never
        uninitialized memory: NULL must read as zeros, and a masked slot in
        a live block loads whatever its page holds."""
        return [torch.zeros(self.page_shape(s), dtype=s.dtype, device=device)
                for s in self.kv_specs]

    def page_bytes(self) -> int:
        """Bytes of ONE page across every leaf: the allocation quantum."""
        total = 0
        for s in self.kv_specs:
            n = 1
            for d in self._page_rest(s):
                n *= d
            total += n * torch.empty((), dtype=s.dtype).element_size()
        return total

    def n_cols(self, spec: LeafSpec) -> int:
        """Table columns covering this leaf's buffer."""
        return -(-spec.seq_len // self.page_tokens)

    # ------------------------------------------------------------ movement

    def _from_view(self, spec: LeafSpec, leaf: torch.Tensor) -> torch.Tensor:
        """Dense leaf (S, ...) -> (S, MP, *page_rest) page tiles, zero-padded
        from the leaf's seq_len up to MP * T."""
        ax, t = spec.slot_axis, self.page_tokens
        pad = self.max_pages * t - spec.seq_len
        if pad:
            widths = [0, 0] * (leaf.dim() - 1 - ax) + [0, pad]
            leaf = torch.nn.functional.pad(leaf, widths)
        shape = leaf.shape[:ax] + (self.max_pages, t) + leaf.shape[ax + 1:]
        return torch.movedim(leaf.reshape(shape), ax, 1)

    def _rows_to_view(self, spec: LeafSpec, rows: torch.Tensor,
                      width: Optional[int] = None) -> torch.Tensor:
        """(S, n_cols, *page_rest) gathered tiles -> the dense leaf layout,
        sliced to ``width`` slots (default the leaf's own buffer length)."""
        ax, t = spec.slot_axis, self.page_tokens
        n_cols = rows.shape[1]
        rows = torch.movedim(rows, 1, ax)
        rows = rows.reshape(rows.shape[:ax] + (n_cols * t,) + rows.shape[ax + 2:])
        return rows.narrow(ax, 0, spec.seq_len if width is None else width)

    def gather_leaf(self, spec: LeafSpec, pages: torch.Tensor,
                    table: torch.Tensor) -> torch.Tensor:
        """ONE leaf's dense view through ``table`` (S, max_pages) int32:
        the page gather (B8), then a reshape.  Contiguous, so an attention
        over it runs the same reduction as over the dense buffer."""
        rows = page_gather(pages, table[:, : self.n_cols(spec)])
        return self._rows_to_view(spec, rows).contiguous()

    def gather(self, pages: Sequence[torch.Tensor], table: torch.Tensor):
        """Rebuild the dense per-layer caches (``DecodeCache``) from pages."""
        from mlcomp_tpu_torch.models.transformer import DecodeCache, KVCache, QuantKVCache

        views: dict = {}
        for spec, pg in zip(self.kv_specs, pages):
            views.setdefault(spec.layer, {})[spec.field] = self.gather_leaf(spec, pg, table)
        return DecodeCache([
            (QuantKVCache if "kq" in v else KVCache)(**v) for _, v in sorted(views.items())
        ])

    def _leaves(self, cache) -> List[torch.Tensor]:
        return [getattr(cache.layers[s.layer], s.field) for s in self.kv_specs]

    def scatter(self, pages: Sequence[torch.Tensor], table: torch.Tensor,
                cache) -> List[torch.Tensor]:
        """Write the dense view back through ``table``, in place: every
        mapped page receives the bytes the view holds for it, NULL gets
        back the zeros it served, GRAVE absorbs retired rows' writes (with
        duplicates, one of them lands: GRAVE is never read)."""
        flat_tbl = table.reshape(-1).long()
        for spec, pg, leaf in zip(self.kv_specs, pages, self._leaves(cache)):
            rows = self._from_view(spec, leaf)
            pg.index_copy_(0, flat_tbl, rows.reshape((-1,) + rows.shape[2:]))
        return list(pages)

    def insert_rows(self, pages: Sequence[torch.Tensor], write_sel: torch.Tensor,
                    cache) -> List[torch.Tensor]:
        """Write ONE prefilled ``(1, ...)`` dense admission cache into the
        pages, in place.  ``write_sel`` (max_pages,) int32 is the write
        ROUTING: the private page id where the row's bytes must land,
        ``GRAVE_PAGE`` everywhere else (shared prefix pages keep their
        bytes, NULL stays zero, lazy decode pages do not exist yet)."""
        sel = write_sel.long()
        for spec, pg, leaf in zip(self.kv_specs, pages, self._leaves(cache)):
            pg.index_copy_(0, sel, self._from_view(spec, leaf)[0])
        return list(pages)

    def gather_row_span(self, pages: Sequence[torch.Tensor], page_ids: torch.Tensor,
                        width: int) -> List[torch.Tensor]:
        """Slot rows [0, width) of every leaf as ONE (1, ...) row set,
        gathered from ``page_ids`` (a span's table entries)."""
        return [self._rows_to_view(spec, page_gather(pg, page_ids[None]), width=width)
                for spec, pg in zip(self.kv_specs, pages)]
