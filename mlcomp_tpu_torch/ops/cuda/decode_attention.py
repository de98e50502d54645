"""Flash decode over an int8 KV cache (csrc/decode_attention.cu): one query
per row (:func:`decode_attention`) or S chunk queries per row
(:func:`decode_attention_chunk`), each also through a page table
(:func:`paged_decode_attention`, :func:`paged_decode_attention_chunk`),
and the cache helpers that fix its layout.

The counterpart of mlcomp_tpu/ops/pallas/decode_attention.py: the cache is
(B, Hkv, L, dh) int8 values with (B, Hkv, 1, L) bf16 per-(slot, head)
scales, L from :func:`pick_buffer_len` and dh zero-padded to 128, exactly
the JAX package's shapes; its pages are (P, Hkv, T, dh) and (P, Hkv, 1, T)
tiles of it (``kvpool/layout.py``).  Two kernel bodies serve the four,
picked by :func:`chunk_plan`: a single query (S = 1) runs on the CUDA
cores with each window cut into shares placed over a thread-block cluster,
a chunk (S > 1) on the tensor cores; each reads the dense cache or the
pages, and the plan depends on the shapes alone, so a paged call equals
the dense call on the same bytes bit for bit.  A CUDA tensor launches a kernel; a CPU tensor
takes the plain version beside it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from mlcomp_tpu_torch.ops.cuda import build

NEG_INF = -1e30
LANES = 128
# block budget of the TPU kernel; kept so pick_buffer_len gives the JAX
# package's buffer lengths (the cache shapes are part of the contract)
KV_BLOCK_BUDGET = 2 * 1024 * 1024 + 128 * 1024
# the TPU kernel's query tile: a chunk wider than this runs there as
# ceil(S / 32) sweeps.  The CUDA kernel puts its query tiles on the grid and
# covers any S in one launch, with the same per-query result.
CHUNK_MAX_SQ = 32

# query rows per CTA of the two bodies (csrc/decode_attention.cu): the
# CUDA-core one takes up to 8 (G rounded up to 1, 2, 4 or 8), the
# tensor-core one wgmma's 64
SIMT_ROWS = 8
TC_ROWS = 64
# the single-query body cuts each window's 32-slot blocks into shares,
# merged in share order.  The cut comes from the cache length alone, never
# from the batch: it decides which blocks each warp walks and the order of
# the merges, so a row's bits would otherwise change with how many rows
# share the call.  A thread-block cluster of CTAs places the shares (each
# CTA computes its shares one after another), so that one lone request
# still spreads over the card (H100: 132 SMs) while a many-row call needs
# no cluster.  The launcher takes up to 8; the plan stops at 4, since
# clusters of 8 ran slower than 4 at every main-path shape on an H100
# (PERF.md)
SPLIT_SLOTS = 32
MAX_CLUSTER = 4
NUM_SMS = 132

launches = 0
chunk_launches = 0
paged_launches = 0
paged_chunk_launches = 0
# launches of the tensor-core body and of the single-query (split) body,
# by any of the four wrappers
chunk_tc_launches = 0
split_launches = 0


def chunk_plan(s_q: int, h: int, h_kv: int, b: int, dh: int, l_buf: int) -> dict:
    """The body and grid a launch of ``s_q`` queries per row against an
    ``l_buf``-slot cache takes, for every wrapper; it reads the shapes
    only, never the layout or the windows, so dense and paged calls run
    the same grid.  Rows r = j * G + g (G = h / h_kv) of one (batch row, KV
    head) share a CTA.

    - One query per row (B3, B6, and a one-query chunk, which so equals the
      single-query decode bit for bit) takes the CUDA-core body
      (``"split"``): G rows a CTA (rounded up to 1, 2, 4 or 8; tiles of 8
      above), each window cut into ``shares`` contiguous shares of its
      32-slot blocks, the largest power of two up to :data:`MAX_CLUSTER`
      and no larger than the cache's count of blocks, and merged in share
      order.  ``shares`` reads ``l_buf`` alone, never ``b``: a row's cut,
      and so its bits, do not depend on how many rows the call holds.
      The shares are placed over a cluster of ``cluster`` CTAs, the
      smallest power of two up to ``shares`` whose grid reaches
      :data:`NUM_SMS` CTAs; each CTA computes ``shares / cluster`` of them
      one after another.
    - A chunk (S > 1: B4, B7) takes the tensor-core body (``"wgmma"``,
      64-row tiles, shares and cluster 1).

    Returns {"body", "rows_per_cta", "tiles", "shares", "cluster",
    "ctas"}."""
    if h % h_kv or dh not in (128, 256) or s_q < 1 or l_buf < 1:
        raise ValueError(f"no kernel for s_q {s_q}, h {h}, h_kv {h_kv}, dh {dh}, "
                         f"l_buf {l_buf}")
    g = h // h_kv
    if s_q > 1:
        tiles = -(-s_q * g // TC_ROWS)
        return {"body": "wgmma", "rows_per_cta": TC_ROWS, "tiles": tiles, "shares": 1,
                "cluster": 1, "ctas": tiles * h_kv * b}
    per = min(SIMT_ROWS, 1 << (g - 1).bit_length())
    tiles = -(-g // per)
    blocks = -(-l_buf // SPLIT_SLOTS)
    shares = 1
    while shares < MAX_CLUSTER and 2 * shares <= blocks:
        shares *= 2
    base = tiles * h_kv * b
    cluster = 1
    while cluster < shares and base * cluster < NUM_SMS:
        cluster *= 2
    return {"body": "split", "rows_per_cta": per, "tiles": tiles, "shares": shares,
            "cluster": cluster, "ctas": base * cluster}


def resources() -> dict:
    """Registers, shared memory, spills and CTAs per SM of the single-query
    body (dh 128 at G = 1 and G = 4, dh 256 at G = 2) and of the
    tensor-core body at dh 128 and 256, on the card (``build.resources``):
    {name: {field: int}}."""
    return build.resources("decode_attention", "decode_attention_resources",
                           ("split_dh128", "split_dh128_g4", "split_dh256_g2", "wgmma_dh128",
                            "wgmma_dh256"))


def auto_block_kv(l_buf: int, h_kv: int, dh: int) -> int:
    """Largest lane-multiple divisor of ``l_buf`` whose K+V blocks fit
    :data:`KV_BLOCK_BUDGET` (fallback: one lane)."""
    return max(
        (bl for bl in range(LANES, l_buf + 1, LANES)
         if l_buf % bl == 0 and 2 * h_kv * bl * dh <= KV_BLOCK_BUDGET),
        default=LANES,
    )


def pick_buffer_len(s: int, h_kv: int, dh: int) -> int:
    """Cache-buffer length for ``s`` live slots: the smallest lane multiple
    >= s whose :func:`auto_block_kv` block is fat (>= 384, or the whole
    buffer for short caches)."""
    base = -(-s // LANES) * LANES
    for cand in range(base, base + 4 * LANES + 1, LANES):
        if auto_block_kv(cand, h_kv, dh) >= min(384, cand):
            return cand
    return -(-base // 512) * 512


def quantize_kv(x: torch.Tensor, eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax int8: x (..., dh) -> (int8 values, f32 scales (...)).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(-1), min=eps) / 127.0
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def decode_attention_plain(q, k8, ks, v8, vs, kv_start, kv_stop, scale):
    """Plain version of the single-query kernel, with its arithmetic:
    logits (q . k) * scale * ks in f32, masked to -1e30, p zero for masked
    slots, the V scale folded into p and rounded to q.dtype, l == 0 gives
    0.  q (B, H, dh); the window is ``[kv_start, kv_stop)``.  On the card a
    one-query chunk runs it (:func:`decode_attention_chunk_plain`)."""
    b, h, dh = q.shape
    h_kv, l_buf = k8.shape[1], k8.shape[2]
    rep = h // h_kv
    qg = q.float().reshape(b, h_kv, rep, dh)
    s = torch.einsum("bgrd,bgld->bgrl", qg, k8.float()) * scale
    s = s * ks.float()                                  # (B, Hkv, 1, L)
    slots = torch.arange(l_buf, device=q.device)
    live = (slots[None] >= kv_start[:, None]) & (slots[None] < kv_stop[:, None])
    live = live[:, None, None, :]                       # (B, 1, 1, L)
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(live & (m > NEG_INF / 2), torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    # a masked slot's p * vs is selected to 0, never multiplied: its scale
    # may be anything a page held
    pv = torch.where(live, p * vs.float(), torch.zeros_like(p))
    pv = pv.to(q.dtype).float()
    acc = torch.einsum("bgrl,bgld->bgrd", pv, v8.float())
    out = acc / torch.where(l == 0, torch.ones_like(l), l)
    return out.to(q.dtype).reshape(b, h, dh)


def decode_attention_chunk_plain(q, k8, ks, v8, vs, kv_start, kv_stop0, scale):
    """Plain version of the chunk kernel: q (B, S, H, dh), query j's window
    ``[kv_start, kv_stop0 + j)``.  Each query goes through
    :func:`decode_attention_plain` on its own, so that a row's bits do not
    depend on how many queries the call holds (ROADMAP §C1, §C7): a batched
    product's reduction order follows its shape on the CPU's BLAS, and a
    verify row must give the bits of the same token decoded alone."""
    return torch.stack([decode_attention_plain(q[:, j].contiguous(), k8, ks, v8, vs, kv_start,
                                               kv_stop0 + j, scale)
                        for j in range(q.shape[1])], 1)


def pages_to_dense(kq_pages, ks_pages, vq_pages, vs_pages, table):
    """The dense (B, Hkv, MP * T, dh) cache and (B, Hkv, 1, MP * T) scales
    that a (B, MP) table maps out of (P, Hkv, T, dh) and (P, Hkv, 1, T)
    pages: a pure gather."""
    idx = table.long()
    b, mp = idx.shape

    def vals(pg):
        _, h_kv, t, dh = pg.shape
        return pg[idx].permute(0, 2, 1, 3, 4).reshape(b, h_kv, mp * t, dh)

    def scales(pg):
        _, h_kv, _, t = pg.shape
        return pg[idx].permute(0, 2, 3, 1, 4).reshape(b, h_kv, 1, mp * t)

    return vals(kq_pages), scales(ks_pages), vals(vq_pages), scales(vs_pages)


def paged_decode_attention_plain(q, kq_pages, ks_pages, vq_pages, vs_pages, table,
                                 kv_start, kv_stop, scale):
    """Plain version of the paged single-query kernel: gather, then
    :func:`decode_attention_plain`."""
    dense = pages_to_dense(kq_pages, ks_pages, vq_pages, vs_pages, table)
    return decode_attention_plain(q, *dense, kv_start, kv_stop, scale)


def paged_decode_attention_chunk_plain(q, kq_pages, ks_pages, vq_pages, vs_pages, table,
                                       kv_start, kv_stop0, scale):
    """Plain version of the paged chunk kernel: gather, then
    :func:`decode_attention_chunk_plain`."""
    dense = pages_to_dense(kq_pages, ks_pages, vq_pages, vs_pages, table)
    return decode_attention_chunk_plain(q, *dense, kv_start, kv_stop0, scale)


def _rows(x: Union[None, int, torch.Tensor], b: int, default: int, device) -> torch.Tensor:
    if x is None:
        return torch.full((b,), default, dtype=torch.int32, device=device)
    if isinstance(x, int):
        return torch.full((b,), x, dtype=torch.int32, device=device)
    return x.to(device=device, dtype=torch.int32).expand(b).contiguous()


def _check_cache(q, k8, ks, v8, vs, h: int, dh: int) -> None:
    """The layout checks both wrappers share."""
    b = q.shape[0]
    _, h_kv, l_buf, _ = k8.shape
    if ks.shape != (b, h_kv, 1, l_buf) or vs.shape != (b, h_kv, 1, l_buf):
        raise ValueError(
            f"scales must be (B, Hkv, 1, L) = {(b, h_kv, 1, l_buf)}; got "
            f"ks {tuple(ks.shape)}, vs {tuple(vs.shape)}"
        )
    if h % h_kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    if l_buf % LANES or dh % LANES:
        raise NotImplementedError(
            f"cache length {l_buf} and head dim {dh} must be multiples of {LANES}"
        )


def _check_pages(q, kq, ks, vq, vs, table, h: int) -> None:
    """The page layout checks both paged wrappers share."""
    _, h_kv, t, dh = kq.shape
    if vq.shape != kq.shape:
        raise ValueError(f"K/V page shapes differ: {tuple(kq.shape)} vs {tuple(vq.shape)}")
    want = (kq.shape[0], h_kv, 1, t)
    if ks.shape != want or vs.shape != want:
        raise ValueError(f"scale pages must be {want}; got ks {tuple(ks.shape)}, "
                         f"vs {tuple(vs.shape)}")
    if table.dim() != 2 or table.shape[0] != q.shape[0]:
        raise ValueError(f"table must be (B, MP) with B = {q.shape[0]}; got {tuple(table.shape)}")
    if h % h_kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    if q.shape[-1] != dh or dh % LANES:
        raise NotImplementedError(f"q head dim {q.shape[-1]} must equal the page head dim "
                                  f"{dh}, a multiple of {LANES}")


def _check_launch(what: str, q, k8, ks, v8, vs, dh: int) -> None:
    """The CUDA kernel's operand contract (the plain version takes more)."""
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {q.device}")
    if q.dtype != torch.bfloat16 or ks.dtype != torch.bfloat16 or vs.dtype != torch.bfloat16:
        raise TypeError(f"need bf16 q and scales; got {q.dtype}, {ks.dtype}, {vs.dtype}")
    if k8.dtype != torch.int8 or v8.dtype != torch.int8:
        raise TypeError("k8/v8 must be int8")
    if dh > 256:
        raise NotImplementedError(f"kernel takes dh <= 256; got {dh}")
    for t in (q, k8, ks, v8, vs):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{what} operands must be contiguous and on one device")


def plan_for(q: torch.Tensor, k8: torch.Tensor, table: Optional[torch.Tensor] = None) -> dict:
    """The :func:`chunk_plan` a wrapper call launches for q (B, S, H, dh)
    against a dense cache ``k8`` (B, Hkv, L, dh), or against (P, Hkv, T,
    dh) pages through ``table`` (B, MP), whose cache length is MP * T."""
    b, s_q, h, dh = q.shape
    l_buf = k8.shape[2] if table is None else table.shape[1] * k8.shape[2]
    return chunk_plan(s_q, h, k8.shape[1], b, dh, l_buf)


def _attend(what: str, q, k8, ks, v8, vs, kv_start, kv_stop0, scale, table=None):
    """The checks and the launch of :func:`chunk_plan`'s body on a CUDA
    ``q`` (B, S, H, dh), or the plain version on a CPU one; every wrapper
    goes through here.  With ``table`` the cache operands are pages and the
    cache length is MP * T."""
    global chunk_tc_launches, split_launches
    b, s_q, h, dh = q.shape
    if table is None:
        _check_cache(q, k8, ks, v8, vs, h, dh)
        h_kv, l_buf = k8.shape[1], k8.shape[2]
    else:
        _check_pages(q, k8, ks, v8, vs, table, h)
        h_kv, l_buf = k8.shape[1], table.shape[1] * k8.shape[2]
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    start = _rows(kv_start, b, 0, q.device)
    stop0 = _rows(kv_stop0, b, l_buf - s_q + 1, q.device)
    if q.device.type == "cpu":
        if table is not None:
            return paged_decode_attention_chunk_plain(q, k8, ks, v8, vs, table, start, stop0,
                                                      scale)
        return decode_attention_chunk_plain(q, k8, ks, v8, vs, start, stop0, scale)
    _check_launch(what, q, k8, ks, v8, vs, dh)
    plan = plan_for(q, k8, table)
    tc = plan["body"] == "wgmma"
    # the launchers' first arguments: 0 for the tensor-core body, else the
    # single-query body's cluster; then its shares
    route = 0 if tc else plan["cluster"]
    out = torch.empty_like(q)
    p, i = ctypes.c_void_p, ctypes.c_int
    if table is None:
        launch = build.function("decode_attention", "decode_attention_chunk_launch",
                                [i, i] + [p] * 8 + [i] * 6 + [ctypes.c_float, p])
        err = launch(
            route, plan["shares"],
            *(t.data_ptr() for t in (q, k8, ks, v8, vs, start, stop0, out)),
            b, s_q, h, h_kv, l_buf, dh, scale, build.stream_ptr(q.device),
        )
    else:
        if table.device != q.device or table.dtype != torch.int32:
            raise TypeError(f"{what}: the table must be int32 on {q.device}")
        table = table.contiguous()
        launch = build.function("decode_attention", "paged_decode_attention_chunk_launch",
                                [i, i] + [p] * 9 + [i] * 7 + [ctypes.c_float, p])
        err = launch(
            route, plan["shares"],
            *(t.data_ptr() for t in (q, k8, ks, v8, vs, start, stop0, table, out)),
            b, s_q, h, h_kv, table.shape[1], k8.shape[2], dh, scale,
            build.stream_ptr(q.device),
        )
    build.check(err, what)
    if tc:
        chunk_tc_launches += 1
    else:
        split_launches += 1
    return out


def decode_attention(q: torch.Tensor, k8: torch.Tensor, ks: torch.Tensor,
                     v8: torch.Tensor, vs: torch.Tensor,
                     kv_start=None, kv_stop=None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention against an int8 KV cache: the one-query case
    of :func:`decode_attention_chunk`, counted apart in ``launches``.

    q (B, H, dh); k8/v8 (B, Hkv, L, dh) int8; ks/vs (B, Hkv, 1, L);
    kv_start/kv_stop: (B,) int32 tensors or ints, the valid-slot window
    (default: the whole buffer).  L and dh must be multiples of 128.
    Returns (B, H, dh) in q.dtype."""
    global launches
    out = _attend("decode_attention", q[:, None], k8, ks, v8, vs, kv_start, kv_stop, scale)
    if q.device.type == "cuda":
        launches += 1
    return out[:, 0]


def decode_attention_chunk(q: torch.Tensor, k8: torch.Tensor, ks: torch.Tensor,
                           v8: torch.Tensor, vs: torch.Tensor,
                           kv_start=None, kv_stop0=None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """S queries per row against an int8 KV cache in one launch.

    q (B, S, H, dh) whose K/V are already in the cache: query j sits at
    slot ``kv_stop0 - 1 + j`` and attends ``[kv_start, kv_stop0 + j)``
    (default ``kv_stop0``: ``L - S + 1``, the chunk at the buffer end).  The
    cache as for :func:`decode_attention`, which is the S == 1 case.
    Returns (B, S, H, dh) in q.dtype."""
    global chunk_launches
    out = _attend("decode_attention_chunk", q, k8, ks, v8, vs, kv_start, kv_stop0, scale)
    if q.device.type == "cuda":
        chunk_launches += 1
    return out


def paged_decode_attention(q: torch.Tensor, kq_pages: torch.Tensor, ks_pages: torch.Tensor,
                           vq_pages: torch.Tensor, vs_pages: torch.Tensor,
                           table: torch.Tensor, kv_start=None, kv_stop=None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """:func:`decode_attention` reading the cache through a page table:
    q (B, H, dh); kq/vq pages (P, Hkv, T, dh) int8; ks/vs pages
    (P, Hkv, 1, T) bf16; ``table`` (B, MP) int32 maps row b's logical page
    j (slots [j * T, (j + 1) * T)) to a physical page.  Any T: the cache
    length is MP * T.  Windows and output as the dense call, bit for bit
    on the same bytes.  Counted in ``paged_launches``."""
    global paged_launches
    out = _attend("paged_decode_attention", q[:, None], kq_pages, ks_pages, vq_pages,
                  vs_pages, kv_start, kv_stop, scale, table=table)
    if q.device.type == "cuda":
        paged_launches += 1
    return out[:, 0]


def paged_decode_attention_chunk(q: torch.Tensor, kq_pages: torch.Tensor,
                                 ks_pages: torch.Tensor, vq_pages: torch.Tensor,
                                 vs_pages: torch.Tensor, table: torch.Tensor,
                                 kv_start=None, kv_stop0=None,
                                 scale: Optional[float] = None) -> torch.Tensor:
    """:func:`decode_attention_chunk` through a page table: q (B, S, H, dh),
    query j attending ``[kv_start, kv_stop0 + j)``; pages and table as
    :func:`paged_decode_attention`.  Counted in ``paged_chunk_launches``."""
    global paged_chunk_launches
    out = _attend("paged_decode_attention_chunk", q, kq_pages, ks_pages, vq_pages, vs_pages,
                  kv_start, kv_stop0, scale, table=table)
    if q.device.type == "cuda":
        paged_chunk_launches += 1
    return out


def check_tp_heads(h: int, h_kv: int, tp: int) -> None:
    """tp must divide both head counts so that a GQA group (its query heads
    beside their shared KV head) stays on one rank (the JAX package's
    ``sharded_decode_attention`` check, word for word).  Under a mesh each
    rank's model holds the cache of its own ``kv_heads / tp`` heads and
    calls :func:`decode_attention` (and the chunk and paged kernels) on
    them: attention is independent per (row, KV head), so no cross-rank
    math happens."""
    if tp > 1 and (h % tp or h_kv % tp):
        raise ValueError(f"int8 KV decode under tp={tp}: tp must divide both heads ({h}) and "
                         f"kv heads ({h_kv}) so GQA groups stay device-local")

