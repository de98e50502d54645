"""Decoder-only Transformer LM, the PyTorch counterpart of
mlcomp_tpu/models/transformer.py (``transformer_lm``).

Pre-norm RMSNorm blocks, RoPE, GQA, SiLU-gated MLP, an f32 logits head.
Weights load from the JAX package's parameter tree
(``io.weights.from_flax_params``): projections hold the folded 2-D
kernel, and kernel-consumable int8 leaves load as
:class:`~mlcomp_tpu_torch.ops.quant.Int8Linear`.

Decoding runs against an explicit :class:`DecodeCache` that the caller
allocates (``init_cache``) and passes to every forward; the model writes
each step's K/V into it IN PLACE at ``cache.index`` and advances the
index.  Two cache layouts: the dense (B, L, Hkv, dh) cache in the model
dtype, and with ``kv_quant`` the int8 cache (B, Hkv, L, dhp) with
(B, Hkv, 1, L) bf16 scales, dh zero-padded to 128 and L from
``pick_buffer_len`` (the JAX package's shapes), read by the CUDA
flash-decode kernel.  Only the global-index decode of ``generate`` is
ported: one prefill at index 0, then single-token steps.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from mlcomp_tpu_torch.models import MODELS
from mlcomp_tpu_torch.ops.attention import dot_product_attention
from mlcomp_tpu_torch.ops.cuda.decode_attention import (
    decode_attention,
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
    """Every layer's cache and the global write index (a host integer: the
    window decode advances it identically for every row)."""
    layers: List[Union[KVCache, QuantKVCache]]
    index: int = 0


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
                kv_start=None, fold: bool = False):
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
            attn = self._decode_attention_quant(q, k, v, cache, index, kv_start)
        else:
            attn = self._decode_attention(q, k, v, cache, index, kv_mask, kv_start)
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

    def _decode_attention(self, q, k, v, c: KVCache, i: int, kv_mask, kv_start):
        """Dense-cache decode: write K/V at slot ``i`` (in place), attend
        under a slot <= own-slot mask.  The prefill at ``i == 0`` attends
        the fresh K/V directly (causal, left pads as a ``kv_start``
        window), which keeps the flash path."""
        s = q.shape[1]
        c.k[:, i: i + s] = k
        c.v[:, i: i + s] = v
        if s > 1 and i == 0:
            return dot_product_attention(q, k, v, causal=True, kv_start=kv_start)
        slots = torch.arange(c.k.shape[1], device=q.device)
        q_slots = i + torch.arange(s, device=q.device)
        mask = (slots[None, :] <= q_slots[:, None])[None, None]
        if kv_mask is not None:
            mask = mask & kv_mask[:, None, None, :].bool()
        return dot_product_attention(q, c.k, c.v, mask=mask)

    def _decode_attention_quant(self, q, k, v, c: QuantKVCache, i: int, kv_start):
        """int8-cache decode: quantize the new K/V per (slot, head), write
        values and bf16 scales at slot ``i`` (in place), then a
        single-token step runs the flash-decode kernel over each row's
        window ``[kv_start, i + 1)``; the prefill (``i == 0``) attends the
        fresh bf16 K/V through the flash-attention kernel."""
        b, s, hkv, dh = k.shape
        dhp = c.kq.shape[-1]
        if s > 1 and i > 0:
            raise NotImplementedError(
                "chunked decode against the int8 cache (cache index > 0 "
                "with several new tokens) is not ported yet"
            )
        pad = (0, dhp - dh)
        kq, ks_ = quantize_kv(F.pad(k, pad) if dhp != dh else k)
        vq, vs_ = quantize_kv(F.pad(v, pad) if dhp != dh else v)
        c.kq[:, :, i: i + s] = kq.transpose(1, 2)
        c.vq[:, :, i: i + s] = vq.transpose(1, 2)
        c.ks[:, :, 0, i: i + s] = ks_.transpose(1, 2).to(c.ks.dtype)
        c.vs[:, :, 0, i: i + s] = vs_.transpose(1, 2).to(c.vs.dtype)
        if s == 1:
            qp = F.pad(q, pad) if dhp != dh else q
            out = decode_attention(qp[:, 0].contiguous(), c.kq, c.ks, c.vq, c.vs,
                                   kv_start=kv_start, kv_stop=i + 1,
                                   scale=1.0 / math.sqrt(dh))
            return out[..., :dh][:, None]
        return dot_product_attention(q, k, v, causal=True, kv_start=kv_start)


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
                fold=False):
        x = self.attn(x, positions, cache, index, kv_mask, kv_start, fold)
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
                cache: Optional[DecodeCache] = None, kv_mask: Optional[torch.Tensor] = None,
                last_only: bool = False) -> torch.Tensor:
        """Logits (B, S, V) f32, or (B, 1, V) with ``last_only``.  With a
        ``cache``, ``positions`` are required (the caller owns the decode
        cursor), ``kv_mask`` (B, max_len) marks valid slots (False = left
        padding), and the cache index advances by S."""
        b, s = ids.shape
        if positions is None:
            if cache is not None:
                raise ValueError("decoding needs explicit positions")
            positions = torch.arange(s, device=ids.device)[None].expand(b, s)
        # left padding makes the invalid slots a prefix: a window start is exact
        kv_start = None if kv_mask is None else torch.argmax(kv_mask.int(), dim=1).int()
        h = self.emb(ids.long())
        index = cache.index if cache is not None else 0
        for li, layer in enumerate(self.layers):
            h = layer(h, positions, None if cache is None else cache.layers[li], index,
                      kv_mask, kv_start, self.fold_norms)
        if cache is not None:
            cache.index += s
        if last_only:
            h = h[:, -1:]
        (logits,) = _project(h, self.norm, [self.lm_head], self.fold_norms)
        return logits.float()
