"""The flash backward's dh-256 instance (bf16): the route the wrapper takes
to it, the design its sources hold, and the plain backward at head dim 256
against the Pallas kernel.

- With the card's launch points stubbed (``build.function`` records each
  C call), a bf16 call at head dim 256 passes its operands as they are with
  ``DH = 256`` and returns the kernels' own outputs; a head of 192 pads to
  256 and is sliced back; both count on ``fwd_dh256_launches`` /
  ``bwd_dh256_launches``.
- ``resources()`` lists the dh-256 kernels under their names.
- The sources hold the dh-256 design: dq and dk/dv kernels of their own
  (two warpgroups sharing a tile's logits by role, p crossing through
  shared memory), no 128-column-half CTAs recomputing the logits,
  the register-A product against a K-major tile, and a DH == 256 branch in
  every launcher that sends it there.
- The plain backward at dh 256 against ``jax.grad`` of the Pallas kernel in
  interpret mode (f32, 1e-5 of the largest entry), beside the cases of
  ``test_torch_attention_dispatch.py``: causal GQA at a ragged S, and
  causal windows with an empty row.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlcomp_tpu.ops.pallas.flash_attention as jflash
from mlcomp_tpu_torch.ops.cuda import build
from mlcomp_tpu_torch.ops.cuda import flash_attention as fa

torch.set_num_threads(2)
CSRC = Path(fa.__file__).resolve().parents[2] / "csrc"
COUNTERS = ("launches", "bwd_dq_launches", "bwd_dkv_launches", "fwd_dh64_launches",
            "bwd_dh64_launches", "fwd_dh256_launches", "bwd_dh256_launches",
            "f32_fwd_launches", "f32_bwd_launches")


def _stub_card(monkeypatch):
    """The CUDA branch with its C launchers recorded: {launcher: [args]}."""
    calls = {}

    def function(stem, name, argtypes):
        def launch(*args):
            assert len(args) == len(argtypes), (name, len(args))
            calls.setdefault(name, []).append(args)
            return 0

        return launch

    monkeypatch.setattr(fa, "runs_kernels", lambda t: True)
    monkeypatch.setattr(build, "function", function)
    monkeypatch.setattr(build, "stream_ptr", lambda device: 0)
    for c in COUNTERS:
        monkeypatch.setattr(fa, c, 0)
    return calls


@pytest.mark.parametrize("d", [256, 192])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "windows"])
def test_a_bf16_head_of_256_runs_the_dh256_kernels(monkeypatch, d, causal):
    calls = _stub_card(monkeypatch)
    g = torch.Generator().manual_seed(4)
    b, s, h, h_kv = 2, 128, 4, 2
    q, k, v, do = (torch.randn(b, s, hh, d, generator=g).to(torch.bfloat16)
                   for hh in (h, h_kv, h_kv, h))
    lo = hi = None
    if not causal:
        lo = torch.tensor([0, 7], dtype=torch.int32)
        hi = torch.tensor([128, 7], dtype=torch.int32)
    out, lse = fa.flash_attention_fwd(q, k, v, causal, d ** -0.5, lo, hi)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, causal, d ** -0.5, lo, hi)
    (fwd,) = calls["flash_fwd_launch"]
    (delta,) = calls["flash_bwd_delta_launch"]
    (dq,) = calls["flash_bwd_dq_launch"]
    (dkv,) = calls["flash_bwd_dkv_launch"]
    # B, H, Hkv, Sq, Sk, DH, causal after the pointers
    assert fwd[7:14] == (b, h, h_kv, s, s, 256, int(causal))
    assert delta[7] == 256
    assert dq[9:16] == (b, h, h_kv, s, s, 256, int(causal))
    assert dkv[10:17] == (b, h, h_kv, s, s, 256, int(causal))
    assert [x.shape for x in grads] == [q.shape, k.shape, v.shape]
    if d == 256:
        # the operands as they are, and the kernels' own outputs returned
        assert dq[:4] == tuple(t.data_ptr() for t in (q, k, v, do))
        assert grads[0].data_ptr() == dq[8]
        assert (grads[1].data_ptr(), grads[2].data_ptr()) == dkv[8:10]
        assert all(x.is_contiguous() for x in grads)
    else:
        # zero-padded to 256 and sliced back
        assert dq[0] != q.data_ptr() and not any(x.is_contiguous() for x in grads)
    assert (fa.fwd_dh256_launches, fa.bwd_dh256_launches) == (1, 1)
    assert (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches) == (1, 1, 1)
    assert (fa.fwd_dh64_launches, fa.bwd_dh64_launches) == (0, 0)
    assert (fa.f32_fwd_launches, fa.f32_bwd_launches) == (0, 0)


def test_resources_list_the_dh256_kernels(monkeypatch):
    _stub_card(monkeypatch)
    res = fa.resources()
    assert {"fwd_256", "bwd_delta_256", "bwd_dq_256", "bwd_dkv_256"} <= set(res)
    assert set(res["bwd_dq_256"]) == set(build.RESOURCE_FIELDS)


def _body(src: str, head: str) -> str:
    body = src[src.index(head):]
    return body[:body.index("\n}\n")]


def test_sources_hold_the_dh256_design():
    wgmma = (CSRC / "wgmma.cuh").read_text()
    bwd = (CSRC / "flash_attention_bwd.cu").read_text()
    # the logits from a register-A row block against a K-major tile
    rs_k = _body(wgmma, "__device__ __forceinline__ void wgmma_rs_n64_kmajor(")
    assert "m64n64k16.f32.bf16.bf16" in rs_k and "p, 1, 1, 0;" in rs_k
    # kernels of their own, two warpgroups each, one CTA a key tile: no
    # 128-column halves recomputing s and dp
    assert "NHALF" not in bwd and "half * 128" not in bwd
    for kernel, struct in (("flash_bwd_dq256_kernel", "Dq256"),
                           ("flash_bwd_dkv256_kernel", "Dkv256")):
        assert f"__launch_bounds__({struct}::THREADS, 1)\n{kernel}(" in bwd
        assert re.search(rf"struct {struct} {{[^}}]*THREADS = 256;", bwd), struct
    # p crosses as f32 through shared memory in both; dS comes back as bf16
    # fragments in dq, where both warpgroups take it (dk/dv: warpgroup 1
    # alone takes it, for dK)
    decls = {}
    for struct in ("Dq256", "Dkv256"):
        decl = bwd[bwd.index(f"struct {struct} {{"):]
        decls[struct] = decl[:decl.index("};")]
    assert "P_BYTES" in decls["Dq256"] and "DS_BYTES" in decls["Dq256"]
    assert "P_BYTES" in decls["Dkv256"] and "DS_BYTES" not in decls["Dkv256"]
    assert "Dq256::SMEM == 189440" in bwd and "Dkv256::SMEM == 216064" in bwd
    # every launcher sends DH == 256 to the kernels of its own
    dq = _body(bwd, "int flash_bwd_dq_launch(")
    dkv = _body(bwd, "int flash_bwd_dkv_launch(")
    assert "if (DH == 256)\n    return dq256_launch(" in dq
    assert "if (DH == 256)\n    return dkv256_launch(" in dkv
    assert "dq_launch<256>" not in bwd and "dkv_launch<256>" not in bwd
    res = _body(bwd, "int bwd_resources(int* res) {")
    assert "flash_bwd_dq256_kernel" in res and "flash_bwd_dkv256_kernel" in res


def _jax_grads(q, k, v, w, causal, lo, hi):
    def loss(q, k, v):
        out = jflash.flash_attention(q, k, v, causal=causal, kv_start=lo, kv_stop=hi,
                                     block_q=128, block_kv=128, interpret=True)
        return jnp.sum(out * w), out

    lo = None if lo is None else jnp.asarray(lo, jnp.int32)
    hi = None if hi is None else jnp.asarray(hi, jnp.int32)
    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("b,s,h,h_kv,causal,windows", [
    (1, 192, 4, 2, True, None),                       # causal GQA, ragged S (the B10 grid)
    (2, 256, 2, 1, True, ([5, 64], [200, 64])),       # causal windows, row 1 empty
], ids=["causal_gqa_ragged", "causal_windows_empty_row"])
def test_plain_flash_at_dh256_matches_pallas(b, s, h, h_kv, causal, windows):
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((b, s, hh, 256), dtype=np.float32) for hh in (h, h_kv, h_kv))
    w = rng.standard_normal((b, s, h, 256), dtype=np.float32)
    lo, hi = windows if windows else (None, None)
    out_ref, grads_ref = _jax_grads(q, k, v, w, causal, lo, hi)
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    lo_t = fa._window(None if lo is None else torch.tensor(lo), b, 0, "cpu")
    hi_t = fa._window(None if hi is None else torch.tensor(hi), b, s, "cpu")
    out, lse = fa.flash_attention_plain(tq, tk, tv, causal, 256 ** -0.5, lo_t, hi_t)
    np.testing.assert_allclose(out.numpy(), out_ref, rtol=0, atol=1e-5 * np.abs(out_ref).max())
    grads = fa.flash_attention_bwd_plain(tq, tk, tv, out, lse, torch.tensor(w), causal,
                                         256 ** -0.5, lo_t, hi_t)
    for name, g, r in zip("qkv", grads, grads_ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max(),
                                   err_msg=f"d{name}")
    if windows:
        assert (out[1] == 0).all() and (lse[1] == -1e30).all()
        assert all((g[1] == 0).all() for g in grads)
