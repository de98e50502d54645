"""The port's flash-attention backward against the JAX package's.

The same numpy inputs go through ``jax.grad`` of the JAX
``flash_attention`` (Pallas, interpret mode on the CPU, blocks of 128 so
that S = 256 runs the triangular and compacted grids over 2 x 2 blocks)
and through the port: ``flash_attention_bwd_plain`` at the forward's
(out, lse), and autograd through ``ops.attention.dot_product_attention``
(the ``FlashAttention`` Function, whose CPU branch runs the plain
versions).  Tolerances: in f32 both sides compute the same sums in other
orders (blocked online softmax against one pass), ~1e-6 relative, so
5e-5 absolute on O(1) gradients; the bf16 case rounds p and ds to bf16 on
both sides, where a value near a rounding boundary can land one bf16 step
(2^-8 relative) apart, so 2e-2 absolute on O(1) gradients.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlcomp_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from mlcomp_tpu.ops.pallas.flash_attention import flash_attention_lse as jax_flash_lse
from mlcomp_tpu_torch.ops.attention import dot_product_attention
from mlcomp_tpu_torch.ops.cuda import flash_attention as fa

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
F32_ATOL = 5e-5
BF16_ATOL = 2e-2


def _inputs(seed, b, s, h, h_kv, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d), dtype=np.float32)
    k = rng.standard_normal((b, s, h_kv, d), dtype=np.float32)
    v = rng.standard_normal((b, s, h_kv, d), dtype=np.float32)
    w = rng.standard_normal((b, s, h, d), dtype=np.float32)
    return q, k, v, w


def _jax_grads(q, k, v, w, causal, lo, hi, dtype):
    def loss(q, k, v):
        out = jax_flash(q, k, v, causal=causal, kv_start=lo, kv_stop=hi,
                        block_q=128, block_kv=128, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * w)

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    lo = None if lo is None else jnp.asarray(lo, jnp.int32)
    hi = None if hi is None else jnp.asarray(hi, jnp.int32)
    return [np.asarray(g, np.float32) for g in jax.grad(loss, argnums=(0, 1, 2))(*args)]


def _port_autograd(q, k, v, w, causal, lo, hi, dtype):
    ts = [torch.tensor(x, dtype=dtype, requires_grad=True) for x in (q, k, v)]
    lo = None if lo is None else torch.tensor(lo, dtype=torch.int32)
    hi = None if hi is None else torch.tensor(hi, dtype=torch.int32)
    out = dot_product_attention(*ts, causal=causal, kv_start=lo, kv_stop=hi)
    (out.float() * torch.tensor(w)).sum().backward()
    return [t.grad.float().numpy() for t in ts]


def _port_plain(q, k, v, w, causal, lo, hi, dtype):
    tq, tk, tv = (torch.tensor(x, dtype=dtype) for x in (q, k, v))
    b, s = q.shape[:2]
    lo_t = fa._window(None if lo is None else torch.tensor(lo), b, 0, tq.device)
    hi_t = fa._window(None if hi is None else torch.tensor(hi), b, s, tq.device)
    scale = q.shape[-1] ** -0.5
    out, lse = fa.flash_attention_plain(tq, tk, tv, causal, scale, lo_t, hi_t)
    grads = fa.flash_attention_bwd_plain(tq, tk, tv, out, lse, torch.tensor(w).to(dtype),
                                         causal, scale, lo_t, hi_t)
    return [g.float().numpy() for g in grads]


# (name, b, s, h, h_kv, d, causal, kv_start, kv_stop): the JAX grid each
# reaches at blocks of 128 is in the name
CASES = [
    ("causal_tri_2x2_blocks", 1, 256, 2, 2, 64, True, None, None),
    ("causal_gqa_tri", 1, 256, 4, 1, 32, True, None, None),
    ("windows_bsched_2_kv_blocks", 2, 256, 1, 1, 32, False, [10, 100], [250, 200]),
    ("windows_gqa_bsched", 1, 256, 2, 1, 32, False, [130], [256]),
    ("windows_one_kv_block_rect", 2, 128, 1, 1, 64, False, [5, 0], [100, 64]),
    ("noncausal_rect", 1, 128, 2, 1, 64, False, None, None),
    ("ragged_s200_causal", 1, 200, 1, 1, 32, True, None, None),
    ("ragged_s200_windows", 2, 200, 1, 1, 32, False, [3, 50], [190, 120]),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_backward_matches_jax_grad_f32(case):
    _, b, s, h, h_kv, d, causal, lo, hi = case
    q, k, v, w = _inputs(7, b, s, h, h_kv, d)
    want = _jax_grads(q, k, v, w, causal, lo, hi, jnp.float32)
    for got in (_port_autograd(q, k, v, w, causal, lo, hi, torch.float32),
                _port_plain(q, k, v, w, causal, lo, hi, torch.float32)):
        for name, g, r in zip("qkv", got, want):
            assert g.shape == r.shape
            np.testing.assert_allclose(g, r, atol=F32_ATOL, rtol=0, err_msg=f"d{name}")


def test_empty_window_row_gets_finite_zero_gradients():
    # batch row 1's window is empty: its output is 0 and every gradient of
    # its queries, keys and values is exactly 0 (not NaN)
    q, k, v, w = _inputs(3, 2, 256, 2, 2, 32)
    lo, hi = [0, 60], [256, 60]
    want = _jax_grads(q, k, v, w, False, lo, hi, jnp.float32)
    got = _port_autograd(q, k, v, w, False, lo, hi, torch.float32)
    for name, g, r in zip("qkv", got, want):
        assert np.isfinite(g).all(), f"d{name}"
        assert (g[1] == 0).all(), f"d{name} of the empty row"
        np.testing.assert_allclose(g, r, atol=F32_ATOL, rtol=0, err_msg=f"d{name}")


def test_backward_matches_jax_grad_bf16():
    q, k, v, w = _inputs(11, 1, 256, 2, 2, 64)
    want = _jax_grads(q, k, v, w, True, None, None, jnp.bfloat16)
    got = _port_autograd(q, k, v, w, True, None, None, torch.bfloat16)
    for name, g, r in zip("qkv", got, want):
        np.testing.assert_allclose(g, r, atol=BF16_ATOL, rtol=0, err_msg=f"d{name}")


def test_lse_cotangent_folds_into_delta():
    # ring attention's building block: gradients through both the output
    # and the logsumexp, against JAX's flash_attention_lse
    q, k, v, w = _inputs(5, 1, 256, 2, 2, 32)
    w_lse = np.random.default_rng(6).standard_normal((1, 256, 2), dtype=np.float32)

    def loss(q, k, v):
        out, lse = jax_flash_lse(q, k, v, causal=True, block_q=128, block_kv=128,
                                 interpret=True)
        return jnp.sum(out * w) + jnp.sum(lse * w_lse)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out, lse = fa.flash_attention_lse(*ts, causal=True)
    ((out * torch.tensor(w)).sum() + (lse * torch.tensor(w_lse)).sum()).backward()
    for name, t, r in zip("qkv", ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=F32_ATOL, rtol=0,
                                   err_msg=f"d{name}")


def test_bwd_grid_names_the_tpu_schedule():
    # chip_smoke.py labels the backward's rows and launches by the TPU grid
    # the JAX package runs for each call
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.bwd_grid(True, False, 4096) == "tri"
    assert smoke.bwd_grid(False, True, 128) == "rect"       # one KV block
    assert smoke.bwd_grid(False, True, 1024) == "bsched"
    assert smoke.bwd_grid(False, False, 1024) == "rect"
    assert smoke.bwd_grid(True, True, 1024) == "rect"       # causal + windows
    assert smoke.bwd_grid(True, False, 200) == "rect"       # ragged S goes through windows


def test_cuda_tensor_without_a_card_raises_instead_of_running_plain():
    # the wrapper takes the plain version only for CPU tensors; any other
    # device launches the kernels or raises
    q = torch.zeros(1, 64, 1, 128, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, q, q, q, torch.zeros(1, 1, 64, device="meta"), q, True, 0.1)
