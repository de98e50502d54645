"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each port wrapper takes its kernel's plain PyTorch version;
the JAX kernels run in interpret mode, as the JAX package's own tests run
them.  Inputs are drawn with numpy from a seed and handed to both.  The
CUDA kernels themselves are held against these plain versions on the card
by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlcomp_tpu.ops.pallas import decode_attention as jda
from mlcomp_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from mlcomp_tpu.ops.pallas.quant_matmul import quant_matmul as j_qmm
from mlcomp_tpu.ops.quant import quantize_params as j_quantize_params
from mlcomp_tpu_torch.io.weights import init_params
from mlcomp_tpu_torch.ops.cuda import decode_attention as da
from mlcomp_tpu_torch.ops.cuda.flash_attention import flash_attention, flash_attention_fwd
from mlcomp_tpu_torch.ops.cuda.quant_matmul import quant_matmul
from mlcomp_tpu_torch.ops.quant import quantize_params

torch.set_num_threads(1)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _bf16_np(a):
    """numpy f32 values already rounded to bf16, so both sides start equal."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("rows,d,n,norm", [
    (8, 256, 384, False), (3, 128, 256, False), (72, 256, 128, False),
    (8, 256, 384, True), (3, 128, 256, True),
    # the tiled path's row counts: one padded 128-row tile (65), a ragged
    # second tile (130), two whole tiles (256); the planner splits D = 256
    # into two slices at each
    (65, 256, 384, False), (130, 256, 384, False), (256, 256, 384, False),
    # the norm prologue over the widest folded row (d = 2048) at one row
    # (the admission chunk's last_only head), a ragged 33 and the most
    # rows it takes; "f32" feeds it an f32 model's un-normed x
    (1, 2048, 256, True), (33, 2048, 128, True), (64, 2048, 128, True),
    (8, 2048, 256, "f32"),
])
def test_quant_matmul_matches_pallas(rows, d, n, norm):
    rng = np.random.default_rng(rows * 7 + d + n)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    x_f32 = norm == "f32"
    if not x_f32:
        x = _bf16_np(x)
    q8 = rng.integers(-127, 128, size=(d, n)).astype(np.int8)
    sc = (rng.random(n) * 0.02).astype(np.float32)
    g = (rng.random(d) + 0.5).astype(np.float32) if norm else None
    ref = j_qmm(jnp.asarray(x, jnp.float32 if x_f32 else jnp.bfloat16), jnp.asarray(q8),
                jnp.asarray(sc), norm_scale=None if g is None else jnp.asarray(g),
                norm_dtype=(jnp.float32 if x_f32 else jnp.bfloat16) if norm else None)
    out = quant_matmul(_t(x, torch.float32 if x_f32 else torch.bfloat16), _t(q8), _t(sc),
                       norm_scale=None if g is None else _t(g))
    assert out.dtype == torch.bfloat16 and out.shape == (rows, n)
    ref = np.asarray(ref.astype(jnp.float32))
    # both outputs are bf16 of the same exact products summed in f32 in
    # another order: they differ by at most one bf16 step (2^-8 relative)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -7, atol=1e-6)


def test_quant_matmul_checks_its_operands():
    x = torch.zeros(2, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contraction"):
        quant_matmul(x, torch.zeros(256, 128, dtype=torch.int8), torch.ones(128))
    with pytest.raises(NotImplementedError, match="multiples of 128"):
        quant_matmul(torch.zeros(2, 96, dtype=torch.bfloat16),
                     torch.zeros(96, 128, dtype=torch.int8), torch.ones(128))
    with pytest.raises(NotImplementedError, match="at most 64 rows"):
        quant_matmul(torch.zeros(65, 128), torch.zeros(128, 128, dtype=torch.int8),
                     torch.ones(128), norm_scale=torch.ones(128))
    # a tensor on neither the CPU nor a card is refused, never run plainly
    with pytest.raises(ValueError, match="cuda or cpu"):
        quant_matmul(x.to("meta"), torch.zeros(128, 128, dtype=torch.int8, device="meta"),
                     torch.ones(128, device="meta"))


def _quant_cache(rng, b, h_kv, l_buf, dh):
    """(B, Hkv, L, dh) int8 and (B, Hkv, 1, L) bf16 scales via quantize_kv."""
    k = rng.normal(size=(b, l_buf, h_kv, dh)).astype(np.float32)
    q8, s = jda.quantize_kv(jnp.asarray(k))
    return (np.asarray(q8.transpose(0, 2, 1, 3)),
            np.asarray(s.transpose(0, 2, 1)[:, :, None].astype(jnp.bfloat16).astype(jnp.float32)))


@pytest.mark.parametrize("h,h_kv", [(8, 2), (4, 4)])
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_pallas(h, h_kv, q_dtype):
    rng = np.random.default_rng(h * 10 + h_kv)
    b, l_buf, dh = 4, 256, 128
    k8, ks = _quant_cache(rng, b, h_kv, l_buf, dh)
    v8, vs = _quant_cache(rng, b, h_kv, l_buf, dh)
    q = _bf16_np(rng.normal(size=(b, h, dh)).astype(np.float32))
    # ragged windows: whole buffer, one slot, an EMPTY window, a mid window
    start = np.array([0, 17, 40, 100], np.int32)
    stop = np.array([256, 18, 40, 230], np.int32)
    jdt = jnp.dtype(q_dtype)
    ref = jda.decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(k8), jnp.asarray(ks, jnp.bfloat16),
        jnp.asarray(v8), jnp.asarray(vs, jnp.bfloat16),
        kv_start=jnp.asarray(start), kv_stop=jnp.asarray(stop), scale=0.1,
    )
    tdt = getattr(torch, q_dtype)
    out = da.decode_attention(_t(q, tdt), _t(k8), _t(ks, torch.bfloat16), _t(v8),
                              _t(vs, torch.bfloat16), _t(start), _t(stop), scale=0.1)
    assert out.dtype == tdt and out.shape == (b, h, dh)
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.all(out[2].float().numpy() == 0) and np.all(ref[2] == 0)
    # f32: one pass vs blocked online softmax, f32 rounding only; bf16:
    # p rounds to bf16 before P V on both sides and the output rounds to
    # bf16 (2^-8 relative)
    tol = 1e-5 if q_dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=tol, atol=tol)


# (S, H, Hkv, windows): the windows of rows 0-2 are the whole buffer, a
# short one from slot 17 and an empty one; "mid" starts every window inside
# a 64-slot block of the card's tensor-core body and keeps row 2's empty
CHUNK_CASES = [
    pytest.param(1, 4, 2, "base", id="1"),
    pytest.param(5, 4, 2, "base", id="5"),
    pytest.param(da.CHUNK_MAX_SQ + 8, 4, 2, "base", id="40"),
    # the card check's GQA case: G = 4 at a ragged S
    pytest.param(37, 8, 2, "mid", id="gqa4-37-midblock"),
]


def _chunk_windows(windows, s_q, l_buf):
    if windows == "mid":
        return (np.array([37, 70, 200], np.int32),
                np.array([l_buf - s_q + 1, 150, 200 - s_q + 1], np.int32))
    return (np.array([0, 17, 100], np.int32),
            np.array([l_buf - s_q + 1, 30, 100 - s_q + 1], np.int32))


@pytest.mark.parametrize("s_q,h,h_kv,windows", CHUNK_CASES)
def test_decode_attention_chunk_matches_pallas(s_q, h, h_kv, windows):
    """B4 against JAX ``decode_attention_chunk`` in interpret mode: GQA (rep
    2, or 4 in the card check's case), per-row windows, query j stopping at
    ``kv_stop0 + j``.  S = 37 and 40 take the TPU's query-tiled route (two
    sweeps of CHUNK_MAX_SQ); the port covers them in one call.  Row 2's
    windows are all empty and give 0."""
    rng = np.random.default_rng(100 + s_q)
    b, l_buf, dh = 3, 256, 128
    k8, ks = _quant_cache(rng, b, h_kv, l_buf, dh)
    v8, vs = _quant_cache(rng, b, h_kv, l_buf, dh)
    q = _bf16_np(rng.normal(size=(b, s_q, h, dh)).astype(np.float32))
    start, stop0 = _chunk_windows(windows, s_q, l_buf)
    ref = jda.decode_attention_chunk(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k8), jnp.asarray(ks, jnp.bfloat16),
        jnp.asarray(v8), jnp.asarray(vs, jnp.bfloat16),
        kv_start=jnp.asarray(start), kv_stop0=jnp.asarray(stop0), scale=0.1,
    )
    args = (_t(k8), _t(ks, torch.bfloat16), _t(v8), _t(vs, torch.bfloat16))
    out = da.decode_attention_chunk(_t(q, torch.bfloat16), *args, _t(start), _t(stop0),
                                    scale=0.1)
    assert out.dtype == torch.bfloat16 and out.shape == (b, s_q, h, dh)
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.all(out[2].float().numpy() == 0) and np.all(ref[2] == 0)
    # B3's tolerance, for B3's reason: p rounds to bf16 before P V on both
    # sides (against another running max: one pass here, 256-slot blocks
    # there) and the output rounds to bf16, each 2^-8 relative
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -7, atol=2 ** -7)
    if s_q == 1:
        # the single-query decode is the one-query chunk, bit for bit
        single = da.decode_attention(_t(q[:, 0], torch.bfloat16), *args, _t(start),
                                     _t(stop0), scale=0.1)
        assert torch.equal(single, out[:, 0])


def test_decode_attention_checks_scale_layout():
    q = torch.zeros(2, 4, 128)
    k8 = torch.zeros(2, 4, 128, 128, dtype=torch.int8)
    with pytest.raises(ValueError, match="scales must be"):
        da.decode_attention(q, k8, torch.zeros(2, 4, 128), k8, torch.zeros(2, 4, 128))


def test_quantize_kv_and_buffer_len_match_jax():
    x = np.random.default_rng(3).normal(size=(3, 5, 2, 128)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0  # an all-zero row takes the eps floor
    jq, js = jda.quantize_kv(jnp.asarray(x))
    tq, ts = da.quantize_kv(_t(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for s in (1, 100, 640, 2100, 2177, 4000):
        for h_kv, dh in ((16, 128), (2, 128), (8, 256)):
            assert da.pick_buffer_len(s, h_kv, dh) == jda.pick_buffer_len(s, h_kv, dh)
            l_buf = da.pick_buffer_len(s, h_kv, dh)
            assert da.auto_block_kv(l_buf, h_kv, dh) == jda.auto_block_kv(l_buf, h_kv, dh)


@pytest.mark.parametrize("s,h,h_kv,d", [(128, 4, 2, 64), (256, 2, 2, 128)])
def test_flash_attention_matches_pallas(s, h, h_kv, d):
    rng = np.random.default_rng(s + h + d)
    b = 3
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, h_kv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, h_kv, d)).astype(np.float32)
    # left padding: rows of queries before kv_start see no key and output 0
    start = np.array([0, 5, s // 2], np.int32)
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                  kv_start=jnp.asarray(start))
    out, lse = flash_attention_fwd(_t(q), _t(k), _t(v), causal=True, kv_start=_t(start))
    ref = np.asarray(ref)
    assert out.shape == (b, s, h, d)
    assert np.all(out[2, : s // 2].numpy() == 0) and np.all(ref[2, : s // 2] == 0)
    assert torch.isfinite(lse).all()
    # f32 fixtures: one softmax pass against the TPU's blocked online
    # softmax differs by f32 rounding only
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_flash_attention_plain_lse_and_window():
    rng = np.random.default_rng(5)
    q, k, v = (_t(rng.normal(size=(2, 40, 2, 16)).astype(np.float32)) for _ in range(3))
    stop = torch.tensor([40, 25], dtype=torch.int32)
    out, lse = flash_attention_fwd(q, k, v, causal=False, kv_stop=stop)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / 4.0
    s[1, :, :, 25:] = float("-inf")
    ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-5, atol=1e-5)
    assert torch.equal(flash_attention(q, k, v, kv_stop=stop), out)
    with pytest.raises(NotImplementedError, match="Sq == Sk"):
        flash_attention(q, k[:, :30], v[:, :30], causal=True)


def test_quantize_params_codes_bit_equal_jax():
    cfg = dict(vocab_size=256, hidden=128, layers=2, heads=4, kv_heads=2, mlp_dim=512)
    tree = init_params(cfg, seed=4)
    jt = j_quantize_params({k: _to_jnp(v) for k, v in tree.items()})
    pt = quantize_params(tree)

    def walk(a, b, path=()):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for key in a:
                walk(a[key], b[key], path + (key,))
        else:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=str(path))

    walk(jt, pt)
    assert pt["DecoderLayer_0"]["attn"]["q"]["kernel"]["q8"].dtype == torch.int8
    assert tuple(pt["DecoderLayer_0"]["attn"]["out"]["kernel"]["q8_scale"].shape) == (1, 1, 128)


def _to_jnp(tree):
    if isinstance(tree, dict):
        return {k: _to_jnp(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _paged(rng, b, h_kv, l_buf, dh, t, last_slot):
    """A shuffled page pool holding each row's window and NULL (page 0)
    past it: (kq, ks, vq, vs) pages, the (B, MP) table, and the same bytes
    laid out densely.  Page 1 (the graveyard) holds non-finite scales that
    no table entry maps."""
    mp = l_buf // t
    k8, ks = _quant_cache(rng, b, h_kv, l_buf, dh)
    v8, vs = _quant_cache(rng, b, h_kv, l_buf, dh)
    n_pages = 2 + b * mp + 3
    table = (rng.permutation(n_pages - 2)[: b * mp] + 2).astype(np.int32).reshape(b, mp)
    kq_p = np.zeros((n_pages, h_kv, t, dh), np.int8)
    vq_p = np.zeros_like(kq_p)
    ks_p = np.zeros((n_pages, h_kv, 1, t), np.float32)
    vs_p = np.zeros_like(ks_p)
    ks_p[1], vs_p[1] = np.nan, np.inf
    for r in range(b):
        for j in range(mp):
            if j * t > last_slot[r]:
                table[r, j] = 0
                continue
            p, sl = table[r, j], slice(j * t, (j + 1) * t)
            kq_p[p], vq_p[p] = k8[r, :, sl], v8[r, :, sl]
            ks_p[p], vs_p[p] = ks[r, :, :, sl], vs[r, :, :, sl]
    pages = (kq_p, ks_p, vq_p, vs_p)
    dense = da.pages_to_dense(*(_t(x) for x in pages), _t(table))
    return pages, table, [x.numpy() for x in dense]


@pytest.mark.parametrize("t", [64, 128])
@pytest.mark.parametrize("s_q,h,h_kv,windows", CHUNK_CASES)
def test_paged_decode_attention_matches_pallas(t, s_q, h, h_kv, windows):
    """B6 (S = 1) and B7 against the JAX paged kernels in interpret mode:
    L = 256, GQA (rep 2, or 4 in the card check's case), shuffled physical
    pages, NULL pages past each row's window, per-row windows (row 2's are
    empty).  The port's paged plain version equals its dense plain version
    on the same bytes exactly."""
    rng = np.random.default_rng(200 + t + s_q)
    b, l_buf, dh = 3, 256, 128
    start, stop0 = _chunk_windows(windows, s_q, l_buf)
    pages, table, dense = _paged(rng, b, h_kv, l_buf, dh, t, stop0 + s_q - 2)
    q = _bf16_np(rng.normal(size=(b, s_q, h, dh)).astype(np.float32))
    jp = (jnp.asarray(pages[0]), jnp.asarray(pages[1], jnp.bfloat16),
          jnp.asarray(pages[2]), jnp.asarray(pages[3], jnp.bfloat16))
    tp = (_t(pages[0]), _t(pages[1], torch.bfloat16), _t(pages[2]), _t(pages[3], torch.bfloat16))
    td = (_t(dense[0]), _t(dense[1], torch.bfloat16), _t(dense[2]), _t(dense[3], torch.bfloat16))
    if s_q == 1:
        ref = jda.paged_decode_attention(
            jnp.asarray(q[:, 0], jnp.bfloat16), *jp, jnp.asarray(table),
            kv_start=jnp.asarray(start), kv_stop=jnp.asarray(stop0), scale=0.1)[:, None]
        out = da.paged_decode_attention(_t(q[:, 0], torch.bfloat16), *tp, _t(table),
                                        _t(start), _t(stop0), scale=0.1)[:, None]
        plain = da.decode_attention(_t(q[:, 0], torch.bfloat16), *td, _t(start), _t(stop0),
                                    scale=0.1)[:, None]
    else:
        ref = jda.paged_decode_attention_chunk(
            jnp.asarray(q, jnp.bfloat16), *jp, jnp.asarray(table),
            kv_start=jnp.asarray(start), kv_stop0=jnp.asarray(stop0), scale=0.1)
        out = da.paged_decode_attention_chunk(_t(q, torch.bfloat16), *tp, _t(table),
                                              _t(start), _t(stop0), scale=0.1)
        plain = da.decode_attention_chunk(_t(q, torch.bfloat16), *td, _t(start), _t(stop0),
                                          scale=0.1)
    assert out.dtype == torch.bfloat16 and out.shape == (b, s_q, h, dh)
    # paging is addressing only: the same bytes give the same bits
    assert torch.equal(out, plain)
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.all(out[2].float().numpy() == 0) and np.all(ref[2] == 0)
    assert torch.isfinite(out.float()).all()
    # B3's tolerance, for B3's reason: p rounds to bf16 before P V on both
    # sides against another running max, and the output rounds to bf16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -7, atol=2 ** -7)


def test_paged_decode_attention_checks_its_pages():
    q = torch.zeros(2, 4, 128, dtype=torch.bfloat16)
    kq = torch.zeros(5, 2, 8, 128, dtype=torch.int8)
    sc = torch.zeros(5, 2, 1, 8, dtype=torch.bfloat16)
    table = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="scale pages must be"):
        da.paged_decode_attention(q, kq, sc[:, :, :, :4], kq, sc, table)
    with pytest.raises(ValueError, match=r"table must be \(B, MP\)"):
        da.paged_decode_attention(q, kq, sc, kq, sc, table[:1])
    with pytest.raises(ValueError, match="cuda or cpu"):
        da.paged_decode_attention(q.to("meta"), kq.to("meta"), sc.to("meta"), kq.to("meta"),
                                  sc.to("meta"), table.to("meta"))
