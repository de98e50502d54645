"""Decoder-only Transformer LM, the PyTorch counterpart of
mlcomp_tpu/models/transformer.py (``transformer_lm``).

Pre-norm RMSNorm blocks, RoPE, GQA, SiLU-gated MLP, an f32 logits head.
Weights load from the JAX package's parameter tree
(``io.weights.from_flax_params``): projections hold the folded 2-D
kernel, and kernel-consumable int8 leaves load as
:class:`~mlcomp_tpu_torch.ops.quant.Int8Linear`.

Decoding runs against an explicit :class:`DecodeCache` that the caller
allocates (``init_cache``) and passes to every forward; the model writes
each step's K/V into it IN PLACE.  Two cache layouts: the dense
(B, L, Hkv, dh) cache in the model dtype, and with ``kv_quant`` the int8
cache (B, Hkv, L, dhp) with (B, Hkv, 1, L) bf16 scales, dh zero-padded to
128 and L from ``pick_buffer_len`` (the JAX package's shapes), read by the
CUDA flash-decode kernels.

The continuous engine's paged layout passes a ``kvpool.attn.PagedKV`` in
place of the ``DecodeCache``: the new K/V go straight into their pages
(the same ``index_copy_`` writes through other indices), the int8 family
attends through the page table (the paged kernels, B6/B7) and the bf16
family over each layer's gathered dense view (B8).  Paged attention runs
only with per-row cursors.

Two write contracts, as in the JAX package:

- a global index (``cache.index``, a host integer the caller may set):
  every row writes its S new K/V at ``[index, index + S)`` and the index
  advances by S.  ``generate`` prefills at index 0 and steps from there;
  the engine's admission starts its cache past the all-pad chunks.
- per-row cursors (``cache_cursor``, (B,) int32, the continuous engine's
  contract): row b writes at ``[cur_b, cur_b + S)`` (the start clamped so
  the span fits, as a dynamic-update-slice clamps) and query j attends
  slots ``<= cur_b + j``; ``cache.index`` is neither read nor advanced.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from mlcomp_tpu_torch.kvpool.attn import PagedKV, PagedLayer
from mlcomp_tpu_torch.models import MODELS
from mlcomp_tpu_torch.ops.attention import dot_product_attention
from mlcomp_tpu_torch.ops.cuda.decode_attention import (
    decode_attention,
    decode_attention_chunk,
    paged_decode_attention,
    paged_decode_attention_chunk,
    pick_buffer_len,
    quantize_kv,
)
from mlcomp_tpu_torch.ops.quant import Int8Linear, as_tensor, is_quantized_leaf

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def apply_rope(x: torch.Tensor, positions: torch.Tensor, base: float = 10000.0) -> torch.Tensor:
    """Rotary embeddings; x (B, S, H, D), positions (B, S)."""
    half = x.shape[-1] // 2
    freq = base ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freq
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """RMSNorm with f32 accumulation, output in ``dtype``."""
    x32 = x.float()
    x32 = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-6)
    return (x32 * scale).to(dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype, device):
        super().__init__()
        self.register_buffer("scale", torch.ones(dim, dtype=torch.float32, device=device))
        self.dtype = dtype

    def forward(self, x):
        return rmsnorm(x, self.scale, self.dtype)


class Dense(nn.Module):
    """``y = x @ kernel`` contracting the trailing ``n_contract`` axes of x
    (flax ``Dense``/``DenseGeneral`` semantics: inputs and kernel cast to
    ``dtype``).  The kernel is held folded, (m, n); it is set by
    ``TransformerLM.load_state``."""

    def __init__(self, feats: Tuple[int, ...], n_contract: int, dtype: torch.dtype):
        super().__init__()
        self.feats, self.n_contract, self.dtype = tuple(feats), n_contract, dtype
        self.register_buffer("kernel", None)

    def forward(self, x, norm: Optional[nn.Module] = None):
        if norm is not None:
            x = norm(x)
        lead = x.shape[: x.dim() - self.n_contract]
        y = x.reshape(-1, self.kernel.shape[0]).to(self.dtype) @ self.kernel.to(self.dtype)
        return y.reshape(*lead, *self.feats)


class Embed(nn.Module):
    """Token embedding: a float table, or int8 rows times the per-column
    scale (the gather commutes with the dequantize)."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("weight", None)
        self.register_buffer("q8", None)
        self.register_buffer("scale", None)

    def forward(self, ids):
        if self.q8 is not None:
            return (self.q8[ids].float() * self.scale).to(self.dtype)
        return self.weight[ids].to(self.dtype)


@dataclass
class KVCache:
    """Dense decode cache of one layer: (B, L, Hkv, dh) in the model dtype."""
    k: torch.Tensor
    v: torch.Tensor


@dataclass
class QuantKVCache:
    """int8 decode cache of one layer: (B, Hkv, L, dhp) int8 values and
    (B, Hkv, 1, L) bf16 per-(slot, head) scales."""
    kq: torch.Tensor
    ks: torch.Tensor
    vq: torch.Tensor
    vs: torch.Tensor


@dataclass
class DecodeCache:
    """Every layer's cache and the global write index (a host integer: a
    global-index decode advances it identically for every row)."""
    layers: List[Union[KVCache, QuantKVCache]]
    index: int = 0


@dataclass
class RowCursors:
    """Per-row cursors resolved once per forward, for every layer: row b
    writes its S new K/V at slots ``cursor_b + j`` (the start clamped to
    ``[0, L - S]`` like ``dynamic_update_slice``; the engine keeps a
    scratch slot so a retired row's frozen cursor never needs it), and
    query j sits at slot ``q_slots[b, j] = cursor_b + j``.  ``flat`` are
    those slots as row indices of the cache flattened to (rows, features):
    (B*L, Hkv*dh) for the dense layout, (B*Hkv*L, dhp) for the int8 one,
    where the (B*Hkv*L,) scale rows share them; one ``index_copy_`` per
    cache tensor writes them."""
    q_slots: torch.Tensor    # (B, S) int64
    stop0: torch.Tensor      # (B,) int32: query 0's exclusive stop
    flat: torch.Tensor       # (B*S,) dense, or (B*S*Hkv,) int8 layout

    @classmethod
    def of(cls, cursor: torch.Tensor, s: int, layer_cache) -> "RowCursors":
        cur = cursor.long()
        dev = cur.device
        j = torch.arange(s, device=dev)[None]
        rows = torch.arange(cur.shape[0], device=dev)[:, None]
        if isinstance(layer_cache, KVCache):
            l_buf = layer_cache.k.shape[1]
            flat = rows * l_buf + torch.clamp(cur, 0, l_buf - s)[:, None] + j
        else:
            h_kv, l_buf = layer_cache.kq.shape[1], layer_cache.kq.shape[2]
            slot = torch.clamp(cur, 0, l_buf - s)[:, None] + j                 # (B, S)
            head = rows[:, :, None] * h_kv + torch.arange(h_kv, device=dev)   # (B, 1, Hkv)
            flat = head * l_buf + slot[:, :, None]                            # (B, S, Hkv)
        return cls(q_slots=cur[:, None] + j, stop0=(cur + 1).to(torch.int32),
                   flat=flat.reshape(-1))


def _causal_mask(q_slots: torch.Tensor, l_buf: int, kv_mask, kv_start) -> torch.Tensor:
    """(B or 1, 1, S, L) mask: slot <= the query's own slot (``q_slots``
    (B or 1, S)), within the row's valid slots (``kv_mask`` (B, L), or the
    window start ``kv_start`` (B,))."""
    slots = torch.arange(l_buf, device=q_slots.device)
    mask = (slots[None, None] <= q_slots[..., None])[:, None]
    if kv_mask is not None:
        mask = mask & kv_mask[:, None, None, :].bool()
    elif kv_start is not None:
        mask = mask & (slots[None] >= kv_start[:, None])[:, None, None]
    return mask


def _project(x, norm, linears, fold: bool):
    """The norm-then-projections step of a block.  With ``fold`` (int8
    kernel mode) each int8 projection takes the norm into its kernel
    prologue where the shape allows (``ops.quant.folds_norm``); otherwise
    the norm runs once and feeds every projection."""
    if fold:
        return [lin(x, norm=norm) for lin in linears]
    h = norm(x)
    return [lin(h) for lin in linears]


class SelfAttention(nn.Module):
    def __init__(self, hidden, heads, kv_heads, dtype, kv_quant, decode_fused, device):
        super().__init__()
        self.heads, self.kv_heads = heads, kv_heads
        self.d_head = hidden // heads
        self.dtype, self.kv_quant, self.decode_fused = dtype, kv_quant, decode_fused
        self.norm = RMSNorm(hidden, dtype, device)
        dh = self.d_head
        if decode_fused:
            self.qkv = Dense((heads + 2 * kv_heads, dh), 1, dtype)
        else:
            self.q = Dense((heads, dh), 1, dtype)
            self.k = Dense((kv_heads, dh), 1, dtype)
            self.v = Dense((kv_heads, dh), 1, dtype)
        self.out = Dense((hidden,), 2, dtype)

    def forward(self, x, positions, cache=None, index: int = 0, kv_mask=None,
                kv_start=None, fold: bool = False, cursor=None):
        if self.decode_fused:
            (qkv,) = _project(x, self.norm, [self.qkv], fold)
            q = qkv[..., : self.heads, :]
            k = qkv[..., self.heads: self.heads + self.kv_heads, :]
            v = qkv[..., self.heads + self.kv_heads:, :]
        else:
            q, k, v = _project(x, self.norm, [self.q, self.k, self.v], fold)
        q = apply_rope(q, positions)
        k = apply_rope(k, positions)
        if cache is None:
            attn = dot_product_attention(q, k, v, causal=True)
        elif self.kv_quant:
            attn = self._decode_attention_quant(q, k, v, cache, index, kv_start, cursor)
        else:
            attn = self._decode_attention(q, k, v, cache, index, kv_mask, kv_start, cursor)
        return x + self.out(attn)

    def init_cache(self, b: int, max_len: int, device):
        dh = self.d_head
        if not self.kv_quant:
            shape = (b, max_len, self.kv_heads, dh)
            return KVCache(torch.zeros(shape, dtype=self.dtype, device=device),
                           torch.zeros(shape, dtype=self.dtype, device=device))
        dhp = -(-dh // 128) * 128
        lpad = pick_buffer_len(max_len, self.kv_heads, dhp)
        vals = (b, self.kv_heads, lpad, dhp)
        scales = (b, self.kv_heads, 1, lpad)
        return QuantKVCache(
            torch.zeros(vals, dtype=torch.int8, device=device),
            torch.zeros(scales, dtype=torch.bfloat16, device=device),
            torch.zeros(vals, dtype=torch.int8, device=device),
            torch.zeros(scales, dtype=torch.bfloat16, device=device),
        )

    def _decode_attention(self, q, k, v, c, i: int, kv_mask, kv_start, cursor):
        """Dense-cache decode: write K/V (in place) at slot ``i`` or at each
        row's cursor, attend under a slot <= own-slot mask.  A global-index
        prefill at ``i == 0`` attends the fresh K/V directly (causal, left
        pads as a ``kv_start`` window), which keeps the flash path.  Paged
        (``c`` a ``PagedLayer``): the cursor writes land in the pages and
        the mask covers each layer's gathered dense view."""
        s = q.shape[1]
        if cursor is not None:
            store = c.pages if isinstance(c, PagedLayer) else c
            feats = store.k.shape[2] * store.k.shape[3]
            store.k.view(-1, feats).index_copy_(0, cursor.flat, k.reshape(-1, feats))
            store.v.view(-1, feats).index_copy_(0, cursor.flat, v.reshape(-1, feats))
            if isinstance(c, PagedLayer):
                k_all, v_all = c.gather_dense("k"), c.gather_dense("v")
            else:
                k_all, v_all = c.k, c.v
            mask = _causal_mask(cursor.q_slots, k_all.shape[1], kv_mask, kv_start)
            return dot_product_attention(q, k_all, v_all, mask=mask)
        l_buf = c.k.shape[1]
        c.k[:, i: i + s] = k
        c.v[:, i: i + s] = v
        if s > 1 and i == 0:
            return dot_product_attention(q, k, v, causal=True, kv_start=kv_start)
        q_slots = (i + torch.arange(s, device=q.device))[None]
        mask = _causal_mask(q_slots, l_buf, kv_mask, kv_start)
        return dot_product_attention(q, c.k, c.v, mask=mask)

    def _decode_attention_quant(self, q, k, v, c, i: int, kv_start, cursor):
        """int8-cache decode: quantize the new K/V per (slot, head) and
        write values and bf16 scales (in place) at slot ``i`` or at each
        row's cursor.  One new token per row runs the flash-decode kernel
        over the row's window ``[kv_start, own slot + 1)``; a chunk (S > 1)
        runs the chunk kernel, query j stopping at ``own slot + j + 1``.
        A global-index prefill at ``i == 0`` attends the fresh K/V through
        the flash-attention kernel instead.  Paged (``c`` a ``PagedLayer``):
        the same writes land in the pages and the paged kernels read them
        through the table."""
        paged = isinstance(c, PagedLayer)
        store = c.pages if paged else c
        s, dh = k.shape[1], k.shape[3]
        dhp = store.kq.shape[-1]
        pad = (0, dhp - dh)
        kq, ks_ = quantize_kv(F.pad(k, pad) if dhp != dh else k)
        vq, vs_ = quantize_kv(F.pad(v, pad) if dhp != dh else v)
        ks_, vs_ = ks_.to(store.ks.dtype), vs_.to(store.vs.dtype)
        if cursor is not None:
            # kq (B, S, Hkv, dhp) and ks_ (B, S, Hkv) flatten in the order of
            # cursor.flat
            store.kq.view(-1, dhp).index_copy_(0, cursor.flat, kq.reshape(-1, dhp))
            store.vq.view(-1, dhp).index_copy_(0, cursor.flat, vq.reshape(-1, dhp))
            store.ks.view(-1).index_copy_(0, cursor.flat, ks_.reshape(-1))
            store.vs.view(-1).index_copy_(0, cursor.flat, vs_.reshape(-1))
            stop0 = cursor.stop0
        else:
            c.kq[:, :, i: i + s] = kq.transpose(1, 2)
            c.vq[:, :, i: i + s] = vq.transpose(1, 2)
            c.ks[:, :, 0, i: i + s] = ks_.transpose(1, 2)
            c.vs[:, :, 0, i: i + s] = vs_.transpose(1, 2)
            if s > 1 and i == 0:
                return dot_product_attention(q, k, v, causal=True, kv_start=kv_start)
            stop0 = i + 1
        qp = F.pad(q, pad) if dhp != dh else q
        if paged:
            pages = (store.kq, store.ks, store.vq, store.vs)
            if s == 1:
                out = paged_decode_attention(qp[:, 0].contiguous(), *pages, c.kernel_table(),
                                             kv_start=kv_start, kv_stop=stop0,
                                             scale=1.0 / math.sqrt(dh))
                return out[..., :dh][:, None]
            out = paged_decode_attention_chunk(qp.contiguous(), *pages, c.kernel_table(),
                                               kv_start=kv_start, kv_stop0=stop0,
                                               scale=1.0 / math.sqrt(dh))
            return out[..., :dh]
        if s == 1:
            out = decode_attention(qp[:, 0].contiguous(), c.kq, c.ks, c.vq, c.vs,
                                   kv_start=kv_start, kv_stop=stop0,
                                   scale=1.0 / math.sqrt(dh))
            return out[..., :dh][:, None]
        out = decode_attention_chunk(qp.contiguous(), c.kq, c.ks, c.vq, c.vs,
                                     kv_start=kv_start, kv_stop0=stop0,
                                     scale=1.0 / math.sqrt(dh))
        return out[..., :dh]


class DecoderLayer(nn.Module):
    def __init__(self, hidden, heads, kv_heads, mlp_dim, dtype, kv_quant, decode_fused, device):
        super().__init__()
        self.attn = SelfAttention(hidden, heads, kv_heads, dtype, kv_quant, decode_fused, device)
        self.norm = RMSNorm(hidden, dtype, device)
        self.mlp_dim, self.decode_fused = mlp_dim, decode_fused
        if decode_fused:
            self.gate_up = Dense((2 * mlp_dim,), 1, dtype)
        else:
            self.gate = Dense((mlp_dim,), 1, dtype)
            self.up = Dense((mlp_dim,), 1, dtype)
        self.down = Dense((hidden,), 1, dtype)

    def forward(self, x, positions, cache=None, index=0, kv_mask=None, kv_start=None,
                fold=False, cursor=None):
        x = self.attn(x, positions, cache, index, kv_mask, kv_start, fold, cursor)
        if self.decode_fused:
            (gu,) = _project(x, self.norm, [self.gate_up], fold)
            gate, up = gu[..., : self.mlp_dim], gu[..., self.mlp_dim:]
        else:
            gate, up = _project(x, self.norm, [self.gate, self.up], fold)
        return x + self.down(F.silu(gate) * up)


def _cat_kernels(leaves, axis: int):
    if all(is_quantized_leaf(l) for l in leaves):
        return {k: torch.cat([as_tensor(l[k]) for l in leaves], axis) for k in ("q8", "q8_scale")}
    if any(is_quantized_leaf(l) for l in leaves):
        raise ValueError("cannot fuse a mix of quantized and raw kernels")
    return torch.cat([as_tensor(l) for l in leaves], axis)


def fuse_decode_params(params):
    """The ``decode_fused`` layout: every ``q``/``k``/``v`` trio fuses to
    ``qkv`` (head-axis concat, [q | k | v]) and every ``gate``/``up`` pair
    to ``gate_up``.  Raw or quantized trees; anything else passes through."""
    def fusable(node, names):
        return all(isinstance(node.get(n), dict) and set(node[n]) == {"kernel"} for n in names)

    def visit(node):
        if not isinstance(node, dict) or is_quantized_leaf(node):
            return node
        node = {k: visit(v) for k, v in node.items()}
        if fusable(node, ("q", "k", "v")):
            node["qkv"] = {"kernel": _cat_kernels([node.pop(n)["kernel"] for n in ("q", "k", "v")], 1)}
        if fusable(node, ("gate", "up")):
            node["gate_up"] = {"kernel": _cat_kernels([node.pop(n)["kernel"] for n in ("gate", "up")], 1)}
        return node

    return visit(dict(params))



@MODELS.register("transformer_lm")
class TransformerLM(nn.Module):
    """``transformer_lm`` with the JAX package's config keys.  ``forward``
    returns f32 logits; pass a :class:`DecodeCache` to decode."""

    def __init__(self, vocab_size: int = 32000, hidden: int = 512, layers: int = 8,
                 heads: int = 8, kv_heads: Optional[int] = None,
                 mlp_dim: Optional[int] = None, dtype: str = "bfloat16",
                 kv_quant: bool = False, decode_fused: bool = False,
                 head_dtype: str = "float32", device=None):
        super().__init__()
        if dtype not in _DTYPES or head_dtype not in _DTYPES:
            raise ValueError(f"dtype/head_dtype must be one of {sorted(_DTYPES)}")
        self.vocab_size, self.hidden, self.heads = vocab_size, hidden, heads
        self.kv_heads = kv_heads or heads
        self.mlp_dim = mlp_dim or hidden * 4
        self.dtype = _DTYPES[dtype]
        self.kv_quant, self.decode_fused = kv_quant, decode_fused
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        # set by generation.prep_decode_variables in int8-kernel mode: every
        # RMSNorm here feeds projections, so each may fold into the kernel
        self.fold_norms = False
        self.emb = Embed(self.dtype)
        self.layers = nn.ModuleList([
            DecoderLayer(hidden, heads, self.kv_heads, self.mlp_dim, self.dtype,
                         kv_quant, decode_fused, self.device)
            for _ in range(layers)
        ])
        self.norm = RMSNorm(hidden, self.dtype, self.device)
        self.lm_head = Dense((vocab_size,), 1, _DTYPES[head_dtype])

    def init_cache(self, batch_size: int, max_len: int) -> DecodeCache:
        """A zeroed decode cache for ``(batch_size, max_len)`` slots."""
        return DecodeCache([
            layer.attn.init_cache(batch_size, max_len, self.device) for layer in self.layers
        ])

    def linears(self):
        """``(owner, attribute name, flax path)`` of every projection."""
        out = []
        for i, layer in enumerate(self.layers):
            pre = f"DecoderLayer_{i}"
            names = ("qkv",) if self.decode_fused else ("q", "k", "v")
            for n in names + ("out",):
                out.append((layer.attn, n, (pre, "attn", n, "kernel")))
            names = ("gate_up",) if self.decode_fused else ("gate", "up")
            for n in names + ("down",):
                out.append((layer, n, (pre, n, "kernel")))
        out.append((self, "lm_head", ("lm_head", "kernel")))
        return out

    def norms(self):
        out = [(self.norm, ("RMSNorm_0", "scale"))]
        for i, layer in enumerate(self.layers):
            pre = f"DecoderLayer_{i}"
            out.append((layer.attn.norm, (pre, "attn", "RMSNorm_0", "scale")))
            out.append((layer.norm, (pre, "RMSNorm_0", "scale")))
        return out

    def load_state(self, state: dict) -> None:
        """Load a flat state from ``io.weights.from_flax_params``: keys are
        flax paths joined by ``/``; a projection whose state holds ``q8``
        becomes an :class:`Int8Linear`, any other a :class:`Dense`."""
        dev = self.device
        for owner, name, path in self.linears():
            key = "/".join(path[:-1])
            cur = getattr(owner, name)
            if f"{key}/q8" in state:
                setattr(owner, name, Int8Linear(
                    state[f"{key}/q8"].to(dev).contiguous(),
                    state[f"{key}/scale"].to(dev).float().contiguous(),
                    cur.feats, cur.n_contract,
                    cur.dtype if isinstance(cur, Dense) else cur.out_dtype,
                ))
            else:
                dense = cur if isinstance(cur, Dense) else Dense(
                    cur.feats, cur.n_contract, cur.out_dtype)
                dense.kernel = state[f"{key}/kernel"].to(dev)
                setattr(owner, name, dense)
        for norm, path in self.norms():
            norm.scale = state["/".join(path)].to(dev).float()
        if "emb/q8" in state:
            self.emb.q8 = state["emb/q8"].to(dev)
            self.emb.scale = state["emb/scale"].to(dev).float()
            self.emb.weight = None
        else:
            self.emb.weight = state["emb/embedding"].to(dev)
            self.emb.q8 = self.emb.scale = None

    def forward(self, ids: torch.Tensor, positions: Optional[torch.Tensor] = None,
                cache: "Optional[DecodeCache | PagedKV]" = None,
                kv_mask: Optional[torch.Tensor] = None,
                last_only: bool = False, cache_cursor: Optional[torch.Tensor] = None,
                kv_start: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits (B, S, V) f32, or (B, 1, V) with ``last_only``.  With a
        ``cache``, ``positions`` are required (the caller owns the decode
        cursor), and the valid slots are ``kv_mask`` (B, max_len; False =
        left padding) or the window start ``kv_start`` (B,).  Without
        ``cache_cursor`` the new K/V go to ``cache.index`` and the index
        advances by S; with it (B,) each row writes at its own cursor.  A
        ``PagedKV`` cache needs ``cache_cursor``."""
        b, s = ids.shape
        if positions is None:
            if cache is not None:
                raise ValueError("decoding needs explicit positions")
            positions = torch.arange(s, device=ids.device)[None].expand(b, s)
        if kv_start is None and kv_mask is not None:
            # left padding makes the invalid slots a prefix: a window start is exact
            kv_start = torch.argmax(kv_mask.int(), dim=1).int()
        h = self.emb(ids.long())
        index, cursor = 0, None
        if isinstance(cache, PagedKV):
            if cache_cursor is None:
                raise NotImplementedError(
                    "paged attention runs only under per-row cursors (the engine's "
                    "decode dispatch); admission prefills use a dense (1, L) cache")
            cursor = cache.cursors(cache_cursor, s)
        elif cache is not None:
            index = cache.index
            if cache_cursor is not None:
                cursor = RowCursors.of(cache_cursor, s, cache.layers[0])
        for li, layer in enumerate(self.layers):
            h = layer(h, positions, None if cache is None else cache.layers[li], index,
                      kv_mask, kv_start, self.fold_norms, cursor)
        if cache is not None and cache_cursor is None:
            cache.index += s
        if last_only:
            h = h[:, -1:]
        (logits,) = _project(h, self.norm, [self.lm_head], self.fold_norms)
        return logits.float()
