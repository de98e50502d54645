"""The int8-KV single-query decode's split of each window into shares,
placed over a thread-block cluster.

One query per row (B3, B6, and a one-query chunk) runs on
``attend_split_kernel`` (csrc/decode_attention.cu), which exists only on
the card: chip_smoke.py holds it there against the plain version, paged
against dense and a one-query chunk against B3 bit for bit, a rerun
against the first run, and one row inside calls of 1, 8 and 32 rows.
Here, on the CPU: ``chunk_plan``'s shares (read from the cache length
alone) and cluster, the same plan for a dense and a paged call of one
shape, and a PyTorch replay of the body's arithmetic (each share, a
contiguous run of the window's 32-slot blocks, every 4th block of it to
each of 4 warps, one online softmax per warp with p * vs rounded to bf16
against the warp's running max, the warps' partials merged in order,
then the shares' in share order by rank 0; which CTA computes a share
does not enter)
held against the JAX package's Pallas kernels in interpret mode and
against the port's plain version.
"""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlcomp_tpu.ops.pallas import decode_attention as jda
from mlcomp_tpu_torch.ops.cuda import build
from mlcomp_tpu_torch.ops.cuda import decode_attention as da

torch.set_num_threads(1)

NEG_INF = -1e30
WARPS, SLOTS = 4, 32


@pytest.mark.parametrize("b", [1, 2, 4, 8, 9, 16, 32, 64])
@pytest.mark.parametrize("g", [1, 2, 4, 8, 16])
def test_the_cluster_fills_the_card_and_no_more(b, g):
    """The shares NS are a power of two up to 4 (the launcher takes 8),
    read from the cache length alone: the most that do not exceed the
    cache's 32-slot blocks, the same at every batch row count, so that a
    row's cut (and so its bits) never depends on how many rows share the
    call.  The cluster C places them: a power of two dividing NS, the
    smallest whose grid reaches the card's 132 SMs, 1 where the grid
    already does."""
    h_kv = 16 // g
    for dh in (128, 256):
        for l_buf in (64, 128, 256, 768, 4096):
            p = da.chunk_plan(1, 16, h_kv, b, dh, l_buf)
            ns, c = p["shares"], p["cluster"]
            base = p["tiles"] * h_kv * b
            blocks = -(-l_buf // da.SPLIT_SLOTS)
            assert p["body"] == "split" and ns in (1, 2, 4) and da.MAX_CLUSTER == 4
            assert ns <= blocks and (ns == da.MAX_CLUSTER or 2 * ns > blocks)
            for b2 in (1, 8, 32, 64):
                assert da.chunk_plan(1, 16, h_kv, b2, dh, l_buf)["shares"] == ns
            assert c in (1, 2, 4) and ns % c == 0
            assert p["ctas"] == base * c
            if base >= da.NUM_SMS:
                assert c == 1
            elif c < ns:
                assert base * c >= da.NUM_SMS
            if c > 1:
                assert base * c // 2 < da.NUM_SMS


@pytest.mark.parametrize("b,h,h_kv,dh,l_buf,per,cluster,ctas", [
    (8, 16, 16, 128, 768, 1, 2, 256),     # the decode step at 8 rows
    (1, 16, 16, 128, 768, 1, 4, 64),      # one lone request
    (32, 16, 16, 128, 768, 1, 1, 512),    # the paged engine's 32 live slots
    (8, 16, 4, 128, 768, 4, 4, 128),      # GQA, 16 q heads on 4 KV heads
    (2, 8, 4, 256, 512, 2, 4, 32),        # head dim 256
    (1, 16, 16, 128, 128, 1, 4, 64),      # a short cache: 4 blocks, 4 shares
    (2, 16, 1, 128, 768, 8, 4, 16),       # G = 16: two 8-row tiles
])
def test_the_main_path_shapes(b, h, h_kv, dh, l_buf, per, cluster, ctas):
    """Every main-path shape cuts a window into 4 shares; the cluster that
    places them falls from 4 at one row to 1 at 32."""
    p = da.chunk_plan(1, h, h_kv, b, dh, l_buf)
    assert p == {"body": "split", "rows_per_cta": per, "tiles": -(-(h // h_kv) // per),
                 "shares": 4, "cluster": cluster, "ctas": ctas}


@pytest.mark.parametrize("t", [32, 64, 128, 256])
@pytest.mark.parametrize("b,h,h_kv", [(1, 16, 16), (8, 16, 16), (8, 16, 4), (32, 16, 16)])
def test_dense_and_paged_calls_take_one_plan(t, b, h, h_kv):
    """The plan reads the shapes alone: a paged call (MP * T = L) and a
    one-query chunk launch what the dense single-query call launches."""
    l_buf, dh = 768, 128
    q = torch.zeros(b, 1, h, dh, dtype=torch.bfloat16)
    dense = torch.zeros(b, h_kv, l_buf, dh, dtype=torch.int8)
    pages = torch.zeros(b * l_buf // t + 2, h_kv, t, dh, dtype=torch.int8)
    table = torch.zeros(b, l_buf // t, dtype=torch.int32)
    want = da.chunk_plan(1, h, h_kv, b, dh, l_buf)
    assert da.plan_for(q, dense) == want == da.plan_for(q, pages, table)
    assert want["body"] == "split"


def shares(start, stop, l_buf, n_shares):
    """Each share's [c0, c1) of 32-slot blocks, as the kernel derives them."""
    lo, hi = max(start, 0), min(stop, l_buf)
    kb0 = lo // SLOTS
    nblk = -(-hi // SLOTS) - kb0 if hi > lo else 0
    return [(kb0 + c * nblk // n_shares, kb0 + (c + 1) * nblk // n_shares)
            for c in range(n_shares)]


def split_replay(q, k8, ks, v8, vs, start, stop, scale, n_shares):
    """The single-query body's arithmetic in PyTorch: per (batch row, KV
    head), share c of the window's blocks, every 4th block of it to warp
    w; each warp's online softmax (logits (q . k) * scale * ks, -1e30 off
    the window, p zero while its row has seen no live slot, p * vs
    selected to 0 off the window and rounded to bf16, l of the unscaled p);
    then the warps' partials merged in order into each share's, and the
    shares' in share order; l == 0 gives 0.  The cluster that places the
    shares does not enter."""
    b, h, dh = q.shape
    h_kv, l_buf = k8.shape[1], k8.shape[2]
    g = h // h_kv
    out = torch.zeros(b, h, dh)
    for bi in range(b):
        lo, hi = max(int(start[bi]), 0), min(int(stop[bi]), l_buf)
        for hk in range(h_kv):
            qt = q[bi, hk * g:(hk + 1) * g].float()
            ranks = []
            for c0, c1 in shares(int(start[bi]), int(stop[bi]), l_buf, n_shares):
                parts = []
                for w in range(WARPS):
                    m = torch.full((g,), NEG_INF)
                    l = torch.zeros(g)
                    acc = torch.zeros(g, dh)
                    for k in range(c0 + w, c1, WARPS):
                        slot = torch.arange(k * SLOTS, (k + 1) * SLOTS)
                        live = (slot >= lo) & (slot < hi)
                        sl = slot.clamp(max=l_buf - 1)
                        kk = torch.where(live[:, None], k8[bi, hk, sl].float(), 0.)
                        vv = torch.where(live[:, None], v8[bi, hk, sl].float(), 0.)
                        ksc = torch.where(live, ks[bi, hk, 0, sl].float(), 0.)
                        vsc = torch.where(live, vs[bi, hk, 0, sl].float(), 0.)
                        s = torch.where(live, (qt @ kk.T) * scale * ksc,
                                        torch.tensor(NEG_INF))
                        m_new = torch.maximum(m, s.amax(1))
                        p = torch.where(m_new[:, None] > NEG_INF / 2,
                                        torch.exp(s - m_new[:, None]), torch.zeros_like(s))
                        alpha = torch.exp(m - m_new)
                        l = alpha * l + p.sum(1)
                        pv = torch.where(live, (p * vsc).bfloat16().float(), torch.zeros_like(p))
                        acc = acc * alpha[:, None] + pv @ vv
                        m = m_new
                    parts.append((m, l, acc))
                ranks.append(merge(parts))
            _, ls, o = merge(ranks)
            out[bi, hk * g:(hk + 1) * g] = o / torch.where(ls == 0, torch.ones_like(ls), ls)[:, None]
    return out.bfloat16()


def merge(parts):
    """(m, l, acc) of partial softmaxes merged in order: m = max m_i,
    l = sum e^(m_i - m) l_i, acc = sum e^(m_i - m) acc_i."""
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    ls = torch.zeros_like(mx)
    o = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        f = torch.exp(m - mx)
        ls = ls + f * l
        o = o + f[:, None] * acc
    return mx, ls, o


def _quant_cache(rng, b, h_kv, l_buf, dh):
    """(B, Hkv, L, dh) int8 and (B, Hkv, 1, L) bf16-valued f32 scales via
    the JAX package's quantize_kv."""
    x = rng.normal(size=(b, l_buf, h_kv, dh)).astype(np.float32)
    q8, s = jda.quantize_kv(jnp.asarray(x))
    return (np.array(q8.transpose(0, 2, 1, 3)),
            np.array(s.transpose(0, 2, 1)[:, :, None].astype(jnp.bfloat16).astype(jnp.float32)))


def _pages(rng, k8, ks, v8, vs, t, stop):
    """A shuffled page pool holding each row's window (NULL page 0 past
    it; page 1 holds non-finite scales no entry maps) and its table."""
    b, h_kv, l_buf, dh = k8.shape
    mp = l_buf // t
    n_pages = 2 + b * mp
    table = (rng.permutation(n_pages - 2)[: b * mp] + 2).astype(np.int32).reshape(b, mp)
    kq_p = np.zeros((n_pages, h_kv, t, dh), np.int8)
    vq_p = np.zeros_like(kq_p)
    ks_p = np.zeros((n_pages, h_kv, 1, t), np.float32)
    vs_p = np.zeros_like(ks_p)
    ks_p[1], vs_p[1] = np.nan, np.inf
    for r in range(b):
        for j in range(mp):
            if j * t >= stop[r]:
                table[r, j] = 0
                continue
            p, sl = table[r, j], slice(j * t, (j + 1) * t)
            kq_p[p], vq_p[p] = k8[r, :, sl], v8[r, :, sl]
            ks_p[p], vs_p[p] = ks[r, :, :, sl], vs[r, :, :, sl]
    return (kq_p, ks_p, vq_p, vs_p), table


# (h, h_kv): G 1 and 4; windows: the whole buffer, one that starts and
# stops inside a block (so inside a share), an EMPTY one, one of two slots
# and one from mid-block to the end; 1-8 shares (at 8 the short windows
# leave shares empty)
@pytest.mark.parametrize("n_shares", [1, 2, 4, 8])
@pytest.mark.parametrize("h,h_kv", [(4, 4), (8, 2)])
def test_split_replay_holds_the_pallas_kernels_and_the_plain_version(n_shares, h, h_kv):
    rng = np.random.default_rng(n_shares * 10 + h)
    b, l_buf, dh, t = 5, 256, 128, 64
    k8, ks = _quant_cache(rng, b, h_kv, l_buf, dh)
    v8, vs = _quant_cache(rng, b, h_kv, l_buf, dh)
    q = np.array(jnp.asarray(rng.normal(size=(b, h, dh)).astype(np.float32), jnp.bfloat16)
                   .astype(jnp.float32))
    start = np.array([0, 37, 100, 130, 70], np.int32)
    stop = np.array([256, 211, 100, 132, 256], np.int32)
    scale = 1 / math.sqrt(dh)
    tq = torch.from_numpy(q).bfloat16()
    tk8, tks = torch.from_numpy(k8), torch.from_numpy(ks).bfloat16()
    tv8, tvs = torch.from_numpy(v8), torch.from_numpy(vs).bfloat16()
    tstart, tstop = torch.from_numpy(start), torch.from_numpy(stop)
    got = split_replay(tq, tk8, tks, tv8, tvs, tstart, tstop, scale, n_shares).float()
    plain = da.decode_attention_plain(tq, tk8, tks, tv8, tvs, tstart, tstop, scale).float()
    ref_abs = da.decode_attention_plain(tq, tk8, tks, tv8.abs(), tvs, tstart, tstop,
                                        scale).float()
    jref = np.asarray(jda.decode_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k8), jnp.asarray(ks, jnp.bfloat16),
        jnp.asarray(v8), jnp.asarray(vs, jnp.bfloat16), kv_start=jnp.asarray(start),
        kv_stop=jnp.asarray(stop), scale=scale).astype(jnp.float32))
    pages, table = _pages(rng, k8, ks, v8, vs, t, stop)
    jpaged = np.asarray(jda.paged_decode_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(pages[0]), jnp.asarray(pages[1], jnp.bfloat16),
        jnp.asarray(pages[2]), jnp.asarray(pages[3], jnp.bfloat16), jnp.asarray(table),
        kv_start=jnp.asarray(start), kv_stop=jnp.asarray(stop), scale=scale)
        .astype(jnp.float32))
    # the card's rule, element by element: |split - ref| <= 2^-7 (|ref| +
    # ref_abs), ref_abs the plain version on |v8|.  Both sides round the
    # output to bf16 and p * vs to bf16 against another running max (2^-8
    # of each term); the merge's e^(m_c - m) and f32 sums in other orders
    # add ~2^-20.  A lost share or a wrong merge weight moves an output by
    # whole terms.
    for ref in (plain, torch.from_numpy(jref), torch.from_numpy(jpaged)):
        assert bool(((got - ref).abs() <= 2 ** -7 * (ref.abs() + ref_abs)).all())
    # the empty window gives 0 on every side
    assert bool((got[2] == 0).all()) and bool((plain[2] == 0).all())
    assert np.all(jref[2] == 0) and np.all(jpaged[2] == 0)
    # the port's paged plain version reads the same bytes as its dense one
    tp = (torch.from_numpy(pages[0]), torch.from_numpy(pages[1]).bfloat16(),
          torch.from_numpy(pages[2]), torch.from_numpy(pages[3]).bfloat16())
    assert torch.equal(da.paged_decode_attention(tq, *tp, torch.from_numpy(table), tstart, tstop,
                                                 scale), plain.bfloat16())


@pytest.mark.parametrize("start,stop,n_shares", [
    (0, 256, 8), (37, 211, 4), (100, 100, 2), (130, 132, 8), (70, 256, 8), (5, 700, 2),
    (412, 576, 8), (0, 768, 1),
])
def test_shares_cover_the_live_blocks_once(start, stop, n_shares):
    """The shares are contiguous, disjoint, in order, at most one block
    apart in size, and together the blocks that meet the window: no live
    slot is lost or counted twice, and an empty window gives every share
    nothing."""
    l_buf = 768 if stop > 256 else 256
    got = shares(start, stop, l_buf, n_shares)
    lo, hi = max(start, 0), min(stop, l_buf)
    want = set(range(lo // SLOTS, -(-hi // SLOTS))) if hi > lo else set()
    seen = [k for c0, c1 in got for k in range(c0, c1)]
    assert sorted(seen) == seen and set(seen) == want and len(seen) == len(want)
    sizes = [c1 - c0 for c0, c1 in got]
    assert max(sizes) - min(sizes) <= 1


# the main path's single-query shapes (h, h_kv, dh, l_buf): the decode
# step, GQA 16 on 4, head dim 256
MAIN_SPLIT_SHAPES = [(16, 16, 128, 768), (16, 4, 128, 768), (8, 4, 256, 512)]


@pytest.mark.parametrize("h,h_kv,dh,l_buf", MAIN_SPLIT_SHAPES)
def test_a_rows_bits_do_not_depend_on_the_batch(h, h_kv, dh, l_buf):
    """One row's inputs replayed under the plan each batch row count b
    launches (b = 1 ... 64) give the same bits: the plan's shares, which
    decide the row's cut and merge order, read the shapes of one row
    alone, while the cluster that places them follows b.  (The card holds
    the kernel to the same inside calls of 1, 8 and 32 rows.)"""
    rng = np.random.default_rng(h + h_kv + dh)
    k8, ks = _quant_cache(rng, 1, h_kv, l_buf, dh)
    v8, vs = _quant_cache(rng, 1, h_kv, l_buf, dh)
    q = torch.from_numpy(rng.normal(size=(1, h, dh)).astype(np.float32)).bfloat16()
    args = (q, torch.from_numpy(k8), torch.from_numpy(ks).bfloat16(), torch.from_numpy(v8),
            torch.from_numpy(vs).bfloat16(), torch.tensor([37], dtype=torch.int32),
            torch.tensor([l_buf - 91], dtype=torch.int32), 1 / math.sqrt(dh))
    outs, clusters = {}, set()
    for b in (1, 2, 4, 8, 9, 16, 32, 64):
        p = da.chunk_plan(1, h, h_kv, b, dh, l_buf)
        clusters.add(p["cluster"])
        if p["shares"] not in outs:
            outs[p["shares"]] = split_replay(*args, p["shares"])
        assert torch.equal(outs[p["shares"]], next(iter(outs.values()))), (b, p)
    assert len(outs) == 1 and len(clusters) > 1


def test_the_single_query_body_is_a_cluster_split_with_copies_in_flight():
    """attend_split_kernel is launched over a cluster, keeps cp.async
    copies in flight and merges through distributed shared memory (each
    rank stores its partial into rank 0's, behind one cluster barrier); the
    old single-query body is gone, so no S = 1 launch can reach it."""
    src = (build.CSRC_DIR / "decode_attention.cu").read_text()
    assert re.search(r"\battend_kernel\b", src) is None
    assert "attend_split_kernel" in src and "cudaLaunchAttributeClusterDimension" in src
    assert "cp_async_16" in src and "cp_async_wait" in src
    assert "st_cluster_f4" in src and "cluster_sync()" in src
    # the launcher's route: 0 takes the tensor-core body, a cluster the split
    launch = src[src.index("int launch(int cluster"):]
    launch = launch[: launch.index("\n}\n")]
    assert "if (cluster == 0)" in launch and "launch_split_rows" in launch
    assert "S != 1" in launch
    for s_q in (1,):
        for g in (1, 2, 3, 4, 8, 16):
            assert da.chunk_plan(s_q, 16 * g, 16, 4, 128, 768)["body"] == "split"
