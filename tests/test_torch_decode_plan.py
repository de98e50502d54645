"""The int8-KV decode's routing and its tensor-core body's arithmetic.

``decode_attention.chunk_plan`` picks the body and grid of every launch of
the four decode wrappers; here it is held at the main path's shapes and at
the card check's extra cases (the single-query body's cluster split in
test_torch_decode_split.py).  The tensor-core body itself runs only on
the card (chip_smoke.py holds it against decode_attention_chunk_plain,
bit-equal on a rerun and paged against dense); here its blocked schedule
(64-row tiles, 64-slot blocks from the window's first block, zero-filled
slots outside the tile's live range, the unmasked fast path, base-2 exp,
p * vs rounded to bf16) is replayed in PyTorch on the CPU and held against
the plain version by the card's own rule.
"""

import math

import numpy as np
import pytest
import torch

from mlcomp_tpu_torch.ops.cuda import build
from mlcomp_tpu_torch.ops.cuda import decode_attention as da

NEG_INF = -1e30
COUNTERS = ("launches", "chunk_launches", "paged_launches", "paged_chunk_launches",
            "chunk_tc_launches")


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16])
def test_one_query_keeps_the_cuda_core_body_at_every_group(g):
    p = da.chunk_plan(1, 16, 16 // g, 8, 128, 768)
    assert p["body"] == "split" and da.SIMT_ROWS == 8
    assert p["rows_per_cta"] == min(g, da.SIMT_ROWS)
    assert p["tiles"] == -(-g // 8)
    assert p["ctas"] == p["tiles"] * (16 // g) * 8 * p["cluster"]


@pytest.mark.parametrize("s_q,h,h_kv,b,dh,tiles,ctas", [
    (256, 16, 16, 1, 128, 4, 64),      # the admission chunk (1, 256)
    (32, 16, 16, 8, 128, 1, 128),      # the verify width 8 x 32: half a tile
    (37, 16, 4, 2, 128, 3, 24),        # GQA at a ragged S: 148 rows a KV head
    (48, 8, 4, 2, 256, 2, 16),         # head dim 256
    (40, 16, 16, 4, 128, 1, 64),       # windows from mid-block
    (2, 16, 16, 1, 128, 1, 16),        # the smallest chunk
])
def test_chunks_take_the_tensor_core_body(s_q, h, h_kv, b, dh, tiles, ctas):
    p = da.chunk_plan(s_q, h, h_kv, b, dh, 768)
    assert p == {"body": "wgmma", "rows_per_cta": da.TC_ROWS, "tiles": tiles, "shares": 1,
                 "cluster": 1, "ctas": ctas}
    assert da.TC_ROWS == 64


def test_chunk_plan_refuses_what_no_body_takes():
    for args in ((4, 16, 3, 1, 128, 768), (4, 16, 16, 1, 64, 768), (4, 16, 16, 1, 384, 768),
                 (0, 16, 16, 1, 128, 768), (1, 16, 16, 1, 128, 0)):
        with pytest.raises(ValueError, match="no kernel"):
            da.chunk_plan(*args)


def _cache(rng, b, h_kv, length, dh):
    k8 = torch.from_numpy(rng.integers(-127, 128, size=(b, h_kv, length, dh)).astype(np.int8))
    sc = torch.from_numpy((rng.random((b, h_kv, 1, length)) * 0.02 + 0.001).astype(np.float32))
    return k8, sc.bfloat16()


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    rng = np.random.default_rng(0)
    k8, ks = _cache(rng, 1, 2, 128, 128)
    v8, vs = _cache(rng, 1, 2, 128, 128)
    q = torch.from_numpy(rng.normal(size=(1, 5, 4, 128)).astype(np.float32)).bfloat16()
    table = torch.tensor([[2]], dtype=torch.int32)
    pages = tuple(torch.cat([torch.zeros_like(x[:1]), torch.zeros_like(x[:1]), x])
                  for x in (k8, ks, v8, vs))
    before = {c: getattr(da, c) for c in COUNTERS}
    out = da.decode_attention_chunk(q, k8, ks, v8, vs, 0, 40)
    assert torch.equal(out, da.decode_attention_chunk_plain(
        q, k8, ks, v8, vs, torch.zeros(1, dtype=torch.int32),
        torch.full((1,), 40, dtype=torch.int32), 1 / math.sqrt(128)))
    da.decode_attention(q[:, 0], k8, ks, v8, vs, 0, 40)
    assert torch.equal(da.paged_decode_attention_chunk(q, *pages, table, 0, 40), out)
    da.paged_decode_attention(q[:, 0], *pages, table, 0, 40)
    assert {c: getattr(da, c) for c in COUNTERS} == before


def test_the_chunk_body_is_a_wgmma_kernel():
    src = (build.CSRC_DIR / "decode_attention.cu").read_text()
    assert "attend_tc_kernel" in src and "wgmma_ss_n64" in src and "wgmma_rs_n128" in src
    assert "attend_split_kernel" in src     # the single-query body beside it


def tc_replay(q, k8, ks, v8, vs, start, stop0, scale):
    """The tensor-core body's schedule in PyTorch: per (batch row, KV head,
    64-row tile), 64-slot blocks from the window's first block to the
    tile's last stop; slots outside [kv_start, tile stop) zero-filled;
    blocks inside every row's window unmasked; logits (q . k) * scale * ks,
    masked ones selected to -1e30; p = 2^(s log2 e - m log2 e) selected to
    0 on masked slots; p * vs rounded to bf16 before P V; l of the unscaled
    p; an empty window gives 0."""
    b, s_q, h, dh = q.shape
    h_kv, length = k8.shape[1], k8.shape[2]
    g = h // h_kv
    rows, bkv, log2e = s_q * g, 64, 1.4426950408889634
    out = torch.zeros(b, s_q, h, dh)
    for bi in range(b):
        lo, st0 = max(int(start[bi]), 0), int(stop0[bi])
        for hk in range(h_kv):
            for r0 in range(0, rows, 64):
                r = torch.arange(r0, min(r0 + 64, rows))
                j, gi = r // g, r % g
                qt = q[bi, j, hk * g + gi].float()                      # (R, dh)
                hi_r = torch.clamp(st0 + j, max=length)
                hi_cta = min(st0 + (int(r[-1]) // g), length)
                hi_min = min(st0 + r0 // g, length)
                begin = lo // bkv * bkv
                nblk = -(-(hi_cta - begin) // bkv) if hi_cta > lo else 0
                m = torch.full((len(r),), NEG_INF)
                l = torch.zeros(len(r))
                o = torch.zeros(len(r), dh)
                for n in range(nblk):
                    j0 = begin + n * bkv
                    slot = torch.arange(j0, j0 + bkv)
                    inside = (slot >= lo) & (slot < hi_cta)
                    sl = slot.clamp(max=length - 1)
                    k = torch.where(inside[:, None], k8[bi, hk, sl].float(), 0.)
                    v = torch.where(inside[:, None], v8[bi, hk, sl].float(), 0.)
                    ksc = torch.where(inside, ks[bi, hk, 0, sl].float(), 0.)
                    vsc = torch.where(inside, vs[bi, hk, 0, sl].float(), 0.)
                    s = (qt @ k.T) * scale * ksc
                    masked = j0 < lo or j0 + bkv > hi_min
                    live = (slot[None] >= lo) & (slot[None] < hi_r[:, None])
                    if masked:
                        s = torch.where(live, s, torch.full_like(s, NEG_INF))
                    mx = torch.maximum(m, s.amax(1))
                    alpha = torch.exp2((m - mx) * log2e)
                    p = torch.exp2(s * log2e - mx[:, None] * log2e)
                    pv = p * vsc
                    if masked:
                        p = torch.where(live, p, torch.zeros_like(p))
                        pv = torch.where(live, pv, torch.zeros_like(pv))
                    l = alpha * l + p.sum(1)
                    o = o * alpha[:, None] + pv.bfloat16().float() @ v
                    m = mx
                res = o / torch.where(l == 0, torch.ones_like(l), l)[:, None]
                out[bi, j, hk * g + gi] = res
    return out.bfloat16()


@pytest.mark.parametrize("b,s_q,h,h_kv,dh,length,start,stop0", [
    (1, 256, 2, 2, 128, 512, [100], [129]),                    # the admission chunk, cut
    (2, 37, 8, 2, 128, 256, [37, 20], [100, 160]),             # GQA 4, ragged S
    (2, 48, 4, 2, 256, 256, [3, 130], [60, 180]),              # head dim 256
    (4, 40, 2, 2, 128, 256, [37, 100, 250, 70], [60, 120, 200, 80]),  # mid-block, row 2 empty
])
def test_tensor_core_schedule_holds_the_plain_version(b, s_q, h, h_kv, dh, length, start,
                                                       stop0):
    """The card's rule, element by element: |body - plain| <= 2^-7 (|ref| +
    ref_abs), ref_abs the plain version on |v8|; an empty window gives 0."""
    rng = np.random.default_rng(b * 100 + s_q)
    k8, ks = _cache(rng, b, h_kv, length, dh)
    v8, vs = _cache(rng, b, h_kv, length, dh)
    q = torch.from_numpy(rng.normal(size=(b, s_q, h, dh)).astype(np.float32)).bfloat16()
    start = torch.tensor(start, dtype=torch.int32)
    stop0 = torch.tensor(stop0, dtype=torch.int32)
    scale = 1 / math.sqrt(dh)
    got = tc_replay(q, k8, ks, v8, vs, start, stop0, scale).float()
    ref = da.decode_attention_chunk_plain(q, k8, ks, v8, vs, start, stop0, scale).float()
    ref_abs = da.decode_attention_chunk_plain(q, k8, ks, v8.abs(), vs, start, stop0,
                                              scale).float()
    assert bool(((got - ref).abs() <= 2 ** -7 * (ref.abs() + ref_abs)).all())
    empty = (stop0 + s_q - 1 <= start)
    assert bool((got[empty] == 0).all()) and bool((ref[empty] == 0).all())
