"""The flash kernels' dh-64 instance (bf16): the route the wrapper takes
to it, and the plain versions at head dim 64 against the Pallas kernel.

- ``kernel_dh`` is per dtype: bf16 and f32 each have instances at 64, 128
  and 256.
- With the card's launch points stubbed (``build.function`` records each
  C call), a bf16 call at head dim 64 passes q, k, v (and out, dO) as
  they are with ``DH = 64``, returns the very tensors the kernels wrote
  (nothing sliced) and counts on ``fwd_dh64_launches`` /
  ``bwd_dh64_launches``; an f32 call at head dim 64 runs the f32 kernels'
  dh-64 instance the same way and counts on ``f32_fwd_launches`` /
  ``f32_bwd_launches``.
- ``resources()`` lists the dh-64 kernels and ``dh64_registers()`` their
  producer's and consumers' registers; the sources hold the m64n64
  register-A product, a DH == 64 branch in every dispatcher, and dh-64
  kernels that split into a producer warp issuing TMA loads into mbarrier
  rings and consumer warpgroups (setmaxnreg), with no atomics and no
  CTA-wide barrier in a loop; the four C launchers keep their interface,
  and the wrapper refuses a dh-64 operand whose base TMA cannot take.
- The plain versions at dh 64 against ``jax.grad`` of the Pallas kernel in
  interpret mode (f32, 1e-5 of the largest entry): the BERT window with an
  empty row, causal GQA and a ragged S.
"""

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
COUNTERS = ("launches", "bwd_dq_launches", "fwd_dh64_launches", "bwd_dh64_launches",
            "fwd_dh256_launches", "bwd_dh256_launches", "f32_fwd_launches", "f32_bwd_launches")


def test_kernel_dh_is_per_dtype():
    bf16 = {16: 64, 32: 64, 64: 64, 65: 128, 96: 128, 128: 128, 129: 256, 256: 256}
    f32 = {16: 64, 32: 64, 64: 64, 65: 128, 128: 128, 129: 256, 256: 256}
    assert {d: fa.kernel_dh(d, torch.bfloat16) for d in bf16} == bf16
    assert {d: fa.kernel_dh(d, torch.float32) for d in f32} == f32
    for dt in (torch.bfloat16, torch.float32):
        with pytest.raises(NotImplementedError, match="head dim 320 > 256"):
            fa.kernel_dh(320, dt)


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


def _operands(dtype, b=2, s=128, h=4, h_kv=2, d=64):
    g = torch.Generator().manual_seed(3)
    return [torch.randn(b, s, hh, d, generator=g).to(dtype) for hh in (h, h_kv, h_kv, h)]


@pytest.mark.parametrize("dtype,kd", [(torch.bfloat16, 64), (torch.float32, 64)])
def test_a_head_of_64_runs_its_dtypes_instance(monkeypatch, dtype, kd):
    calls = _stub_card(monkeypatch)
    q, k, v, do = _operands(dtype)
    lo = torch.tensor([0, 3], dtype=torch.int32)
    hi = torch.tensor([128, 0], dtype=torch.int32)
    out, lse = fa.flash_attention_fwd(q, k, v, False, 0.125, lo, hi)
    prefix = "flash" if dtype == torch.bfloat16 else "flash_f32"
    (fwd,) = calls[f"{prefix}_fwd_launch"]
    # q, k, v, lo, hi, out, lse, then B, H, Hkv, Sq, Sk, DH, causal
    assert fwd[7:14] == (2, 4, 2, 128, 128, kd, 0)
    assert out.shape == q.shape and lse.shape == (2, 4, 128)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, False, 0.125, lo, hi)
    (delta,) = calls[f"{prefix}_bwd_delta_launch"]
    (dq,) = calls[f"{prefix}_bwd_dq_launch"]
    (dkv,) = calls[f"{prefix}_bwd_dkv_launch"]
    assert delta[7] == kd and dq[14] == kd and dkv[15] == kd
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    # the operands as they are, and the kernels' own outputs returned
    assert fwd[:3] == tuple(t.data_ptr() for t in (q, k, v))
    assert out.is_contiguous() and out.data_ptr() == fwd[5]
    assert dq[:4] == tuple(t.data_ptr() for t in (q, k, v, do))
    assert delta[:2] == (do.data_ptr(), out.data_ptr())
    assert grads[0].data_ptr() == dq[8] and (grads[1].data_ptr(), grads[2].data_ptr()) \
        == dkv[8:10]
    assert all(g.is_contiguous() for g in grads)
    if dtype == torch.bfloat16:
        assert (fa.fwd_dh64_launches, fa.bwd_dh64_launches) == (1, 1)
        assert (fa.f32_fwd_launches, fa.f32_bwd_launches) == (0, 0)
    else:
        assert (fa.f32_fwd_launches, fa.f32_bwd_launches) == (1, 1)
        assert (fa.fwd_dh64_launches, fa.bwd_dh64_launches) == (0, 0)
    assert (fa.launches, fa.bwd_dq_launches) == (1, 1)
    assert (fa.fwd_dh256_launches, fa.bwd_dh256_launches) == (0, 0)


def test_a_bf16_head_below_64_pads_to_the_dh64_instance(monkeypatch):
    calls = _stub_card(monkeypatch)
    q, k, v, _ = _operands(torch.bfloat16, d=32)
    out, _ = fa.flash_attention_fwd(q, k, v, True, 32 ** -0.5)
    (fwd,) = calls["flash_fwd_launch"]
    assert fwd[12] == 64 and fwd[0] != q.data_ptr()
    assert out.shape == q.shape and fa.fwd_dh64_launches == 1


def test_resources_list_the_dh64_kernels(monkeypatch):
    calls = _stub_card(monkeypatch)
    res = fa.resources()
    assert {"fwd_64", "bwd_delta_64", "bwd_dq_64", "bwd_dkv_64"} <= set(res)
    assert {"fwd", "fwd_256", "bwd_dq", "bwd_dq_256", "f32_fwd", "f32_bwd_dkv_256"} <= set(res)
    assert set(res["fwd_64"]) == set(build.RESOURCE_FIELDS)
    # the warp-specialised dh-64 kernels: registers after setmaxnreg, by role
    regs = fa.dh64_registers()
    assert set(regs) == {"fwd_64", "bwd_dq_64", "bwd_dkv_64"}
    assert all(set(r) == {"producer", "consumer"} for r in regs.values())
    assert {"flash_fwd64_regs", "flash_bwd64_regs"} <= set(calls)
    fwd = (CSRC / "flash_attention.cu").read_text()
    bwd = (CSRC / "flash_attention_bwd.cu").read_text()
    assert "int flash_fwd64_regs(int* r)" in fwd and "int flash_bwd64_regs(int* r)" in bwd


def _kernel_body(src: str, name: str) -> str:
    """The text of the kernel ``name`` from its definition to its end."""
    body = src[src.index(f"\n{name}("):]
    return body[:body.index("\n}\n")]


# the dh-64 kernels: (source, kernel, its wgmma products); each splits
# into a producer warpgroup and consumer warpgroups
DH64_KERNELS = [("flash_attention.cu", "flash_fwd64_kernel", ("qk_tile64(", "pv_tile64(")),
                ("flash_attention_bwd.cu", "flash_bwd_dq64_kernel",
                 ("dq64_scores(", "dq64_ds_k(")),
                ("flash_attention_bwd.cu", "flash_bwd_dkv64_kernel", ("dkv_item<64>(",))]


def test_sources_hold_the_dh64_instance():
    wgmma = (CSRC / "wgmma.cuh").read_text()
    assert "void wgmma_rs_n64(float (&d)[32]" in wgmma
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in wgmma
    tma = (CSRC / "tma.cuh").read_text()
    for ptx in ("mbarrier.try_wait.parity", "mbarrier.arrive.expect_tx", "cp.async.bulk.tensor",
                "setmaxnreg.dec", "setmaxnreg.inc", "cuTensorMapEncodeTiled",
                "CU_TENSOR_MAP_SWIZZLE_128B"):
        assert ptx in tma, ptx
    fwd = (CSRC / "flash_attention.cu").read_text()
    bwd = (CSRC / "flash_attention_bwd.cu").read_text()
    launchers = {"flash_fwd_launch": fwd, "flash_bwd_delta_launch": bwd,
                 "flash_bwd_dq_launch": bwd, "flash_bwd_dkv_launch": bwd}
    for name, src in launchers.items():
        body = src[src.index(f"int {name}("):]
        body = body[:body.index("\n}\n")]
        assert "if (DH == 64)" in body, name
    for src_name, kernel, products in DH64_KERNELS:
        src = (CSRC / src_name).read_text()
        assert '#include "tma.cuh"' in src
        body = _kernel_body(src, kernel)
        # a producer warp issuing TMA loads into mbarrier rings, consumers
        # that take the producer's registers
        for call in ("mbar_init(", "mbar_wait(", "mbar_arrive_expect_tx(", "tma_load_4d(",
                     "setmaxnreg_dec<", "setmaxnreg_inc<", *products):
            assert call in body, (kernel, call)
        assert "atomic" not in body, kernel
        # one CTA-wide barrier, after the barriers' initialisation and
        # before the roles split: none in the loops that follow
        assert body.count("__syncthreads()") == 1, kernel
        init = body.index("fence_barrier_init();")
        assert init < body.index("__syncthreads()") < body.index("if (wg == 0) {"), kernel
        assert "cp_async_wait" not in body, kernel
    assert "kernel_resources((const void*)flash_fwd64_kernel, Fwd64::SMEM_BYTES" in fwd
    assert "bwd_resources<64>" in bwd and "flash_bwd_dq64_kernel, Dq64::SMEM" in bwd
    assert "flash_bwd_dkv64_kernel, Dkv64::SMEM" in bwd


# the C launchers' interface, which bwd_parts_device_ms and a parent tree's
# timing in chip_smoke.py call directly, so they stay as they are
LAUNCHER_SIGNATURES = {
    "flash_attention.cu": [
        "int flash_fwd_launch(const void* q, const void* k, const void* v, const void* kv_lo, "
        "const void* kv_hi, void* out, void* lse, int B, int H, int Hkv, int Sq, int Sk, "
        "int DH, int causal, float scale, void* stream)"],
    "flash_attention_bwd.cu": [
        "int flash_bwd_delta_launch(const void* dout, const void* out, const void* g_lse, "
        "void* delta, int B, int H, int Sq, int DH, void* stream)",
        "int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const void* dout, "
        "const void* lse, const void* delta, const void* kv_lo, const void* kv_hi, void* dq, "
        "int B, int H, int Hkv, int Sq, int Sk, int DH, int causal, float scale, void* stream)",
        "int flash_bwd_dkv_launch(const void* q, const void* k, const void* v, "
        "const void* dout, const void* lse, const void* delta, const void* kv_lo, "
        "const void* kv_hi, void* dk, void* dv, int B, int H, int Hkv, int Sq, int Sk, int DH, "
        "int causal, float scale, void* stream)"],
}


@pytest.mark.parametrize("source", sorted(LAUNCHER_SIGNATURES))
def test_the_launchers_signatures_are_unchanged(source):
    src = (CSRC / source).read_text()
    extern_c = " ".join(src[src.index('extern "C" {'):].split())
    for sig in LAUNCHER_SIGNATURES[source]:
        assert sig + " {" in extern_c, sig


def test_dh64_operands_must_be_tma_aligned(monkeypatch):
    calls = _stub_card(monkeypatch)
    q, k, v, do = _operands(torch.bfloat16)
    # a view one element into a buffer: contiguous, but 2 bytes off
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16)
    q_off = flat[1:].view(q.shape)
    q_off.copy_(q)
    assert q_off.is_contiguous() and q_off.data_ptr() % fa.TMA_ALIGN
    with pytest.raises(ValueError, match="16-byte-aligned"):
        fa.flash_attention_fwd(q_off, k, v, True, 0.125)
    out, lse = fa.flash_attention_fwd(q, k, v, True, 0.125)
    with pytest.raises(ValueError, match="load q by TMA"):
        fa.flash_attention_bwd(q_off, k, v, out, lse, do, True, 0.125)
    assert len(calls["flash_fwd_launch"]) == 1 and "flash_bwd_dq_launch" not in calls
    # f32 at dh 64 and bf16 at 128 do not load by TMA: any base goes
    fa.check_tma_aligned(torch.float32, 64, q=q_off)
    fa.check_tma_aligned(torch.bfloat16, 128, q=q_off)


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
    (2, 128, 2, 2, False, ([0, 0], [100, 0])),    # BERT's key padding, an empty row
    (1, 256, 4, 2, True, None),                   # causal GQA (the B10 grid)
    (2, 196, 2, 2, False, None),                  # ViT's ragged S
], ids=["bert_window_empty_row", "causal_gqa", "ragged_s"])
def test_plain_flash_at_dh64_matches_pallas(b, s, h, h_kv, causal, windows):
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((b, s, hh, 64), dtype=np.float32) for hh in (h, h_kv, h_kv))
    w = rng.standard_normal((b, s, h, 64), dtype=np.float32)
    lo, hi = windows if windows else (None, None)
    out_ref, grads_ref = _jax_grads(q, k, v, w, causal, lo, hi)
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    lo_t = fa._window(None if lo is None else torch.tensor(lo), b, 0, "cpu")
    hi_t = fa._window(None if hi is None else torch.tensor(hi), b, s, "cpu")
    out, lse = fa.flash_attention_plain(tq, tk, tv, causal, 0.125, lo_t, hi_t)
    np.testing.assert_allclose(out.numpy(), out_ref, rtol=0, atol=1e-5 * np.abs(out_ref).max())
    grads = fa.flash_attention_bwd_plain(tq, tk, tv, out, lse, torch.tensor(w), causal, 0.125,
                                         lo_t, hi_t)
    for name, g, r in zip("qkv", grads, grads_ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max(),
                                   err_msg=f"d{name}")
    if windows:
        assert (out[1] == 0).all() and (lse[1] == -1e30).all()
        assert all((g[1] == 0).all() for g in grads)
