"""The f32 flash kernels (csrc/flash_attention_f32.cu): the route the
wrapper takes to them, a numerics model of their products, their sources
and their resource names.

- With the card's launch points stubbed (``build.function`` records each
  C call), an f32 head of 64 launches ``DH = 64`` on the operands as they
  are and returns the kernels' own outputs; 32 pads to 64, 128 and 256 pass
  unchanged, 192 pads to 256; every call counts on ``f32_fwd_launches`` /
  ``f32_bwd_launches``; ``kernel_refusal`` refuses what it refused before.
- A torch model of the kernels' arithmetic: every product but dp in
  3xTF32 (operands split into big = rna(x) and small = rna(x - big), 10
  explicit mantissa bits each; small_a big_b + big_a small_b + big_a big_b),
  dp (dO v^T) in f32, the forward's online softmax over 32-key tiles, then
  delta, dq and dk/dv.  Held against the Pallas kernel in interpret mode
  (and ``jax.grad`` of it) at head dims 64, 128 and 256 with the card's
  rule, 2^-16 (|ref| + ref_abs); the same model with one TF32 pass per
  product exceeds that rule, so the comparison bites (the port's plain f32
  versions meet the rule on the same inputs first: its floor).
- The source holds the tensor-core instructions and no atomics, and every
  launcher takes DH 64; ``resources()`` names the dh-64 kernels.
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
SRC = Path(fa.__file__).resolve().parents[2] / "csrc" / "flash_attention_f32.cu"
COUNTERS = ("launches", "bwd_dq_launches", "bwd_dkv_launches", "fwd_dh64_launches",
            "bwd_dh64_launches", "fwd_dh256_launches", "bwd_dh256_launches",
            "f32_fwd_launches", "f32_bwd_launches")
RULE = 2.0 ** -16
NEG_INF = -1e30


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


# ---- (a) the route


@pytest.mark.parametrize("d,kd", [(64, 64), (32, 64), (128, 128), (256, 256), (192, 256)])
def test_an_f32_head_runs_its_instance(monkeypatch, d, kd):
    calls = _stub_card(monkeypatch)
    g = torch.Generator().manual_seed(5)
    b, s, h, h_kv = 2, 96, 4, 2
    q, k, v, do = (torch.randn(b, s, hh, d, generator=g) for hh in (h, h_kv, h_kv, h))
    lo = torch.tensor([0, 9], dtype=torch.int32)
    hi = torch.tensor([96, 9], dtype=torch.int32)
    out, lse = fa.flash_attention_fwd(q, k, v, False, d ** -0.5, lo, hi)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, False, d ** -0.5, lo, hi)
    (fwd,) = calls["flash_f32_fwd_launch"]
    (delta,) = calls["flash_f32_bwd_delta_launch"]
    (dq,) = calls["flash_f32_bwd_dq_launch"]
    (dkv,) = calls["flash_f32_bwd_dkv_launch"]
    # B, H, Hkv, Sq, Sk, DH, causal after the pointers
    assert fwd[7:14] == (b, h, h_kv, s, s, kd, 0)
    assert delta[4:8] == (b, h, s, kd)
    assert dq[9:16] == dkv[10:17] == (b, h, h_kv, s, s, kd, 0)
    assert out.shape == q.shape and lse.shape == (b, h, s)
    assert [x.shape for x in grads] == [q.shape, k.shape, v.shape]
    if d == kd:
        # the operands as they are, the kernels' own outputs returned
        assert fwd[:3] == tuple(t.data_ptr() for t in (q, k, v))
        assert out.is_contiguous() and out.data_ptr() == fwd[5]
        assert delta[:2] == (do.data_ptr(), out.data_ptr())
        assert dq[:4] == dkv[:4] == tuple(t.data_ptr() for t in (q, k, v, do))
        assert grads[0].data_ptr() == dq[8]
        assert (grads[1].data_ptr(), grads[2].data_ptr()) == dkv[8:10]
        assert all(x.is_contiguous() for x in grads)
    else:
        # zero-padded up to the instance and sliced back
        assert fwd[0] != q.data_ptr() and not out.is_contiguous()
        assert not any(x.is_contiguous() for x in grads)
    assert (fa.f32_fwd_launches, fa.f32_bwd_launches) == (1, 1)
    assert (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches) == (1, 1, 1)
    assert (fa.fwd_dh64_launches, fa.bwd_dh64_launches) == (0, 0)
    assert (fa.fwd_dh256_launches, fa.bwd_dh256_launches) == (0, 0)


def test_kernel_refusal_is_unchanged():
    f32 = torch.float32
    assert fa.kernel_refusal(128, 96, 64, True, f32) == "causal flash needs Sq == Sk; got 128/96"
    assert fa.kernel_refusal(128, 128, 64, False, torch.float16) == \
        "the kernels take bf16 or f32, not torch.float16"
    assert fa.kernel_refusal(128, 128, 320, False, f32) == "head dim 320 > 256"
    assert all(fa.kernel_refusal(128, 128, d, True, f32) is None for d in (16, 64, 192, 256))
    assert all(fa.kernel_refusal(64, 128, d, False, f32) is None for d in (32, 128))


# ---- (b) a numerics model of the kernels' products


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: f32 rounded to 10 explicit mantissa bits, ties
    away from zero (adding half a unit to the magnitude's bits, then
    truncating)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b (f32) the way the kernels' tensor cores form it: 3 passes is
    3xTF32 (small_a big_b + big_a small_b, then big_a big_b), 1 pass is
    big_a big_b alone; the TF32 products summed exactly and rounded to f32."""
    ab, bb = _tf32(a), _tf32(b)
    big = ab.double() @ bb.double()
    if passes == 1:
        return big.float()
    a_small, b_small = _tf32(a - ab), _tf32(b - bb)
    small = a_small.double() @ bb.double() + ab.double() @ b_small.double()
    return (small + big).float()


def _live(b, s, causal, lo, hi):
    cols = torch.arange(s)
    live = (cols[None] >= lo[:, None]) & (cols[None] < hi[:, None])     # (B, Sk)
    live = live[:, None, None, :].expand(b, 1, s, s)
    if causal:
        live = live & (cols[:, None] >= cols[None, :])
    return live                                                         # (B, 1, Sq, Sk)


def _model_fwd(q, k, v, causal, scale, lo, hi, passes, bk=32):
    """The forward kernel's arithmetic on (B, H, S, D) f32 tensors (k, v
    repeated over the GQA group): s = q k^T tile by tile of ``bk`` keys,
    logits masked to -1e30, p selected to 0 on them, the online max, l and
    O, then out = O / l (l == 0 gives 1) and lse."""
    b, h, s, d = q.shape
    live = _live(b, s, causal, lo, hi)
    m = torch.full((b, h, s, 1), NEG_INF)
    l = torch.zeros(b, h, s, 1)
    o = torch.zeros(b, h, s, d)
    for k0 in range(0, s, bk):
        sl = slice(k0, min(k0 + bk, s))
        lv = live[..., sl]
        x = torch.where(lv, _mm(q, k[:, :, sl].transpose(-1, -2), passes) * scale,
                        torch.tensor(NEG_INF))
        mx = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp(m - mx)
        p = torch.where(lv, torch.exp(x - mx), torch.zeros(()))
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _mm(p, v[:, :, sl], passes)
        m = mx
    ls = torch.where(l == 0, torch.ones(()), l)
    lse = torch.where(m > NEG_INF / 2, m, torch.tensor(NEG_INF)) + torch.log(ls)
    return o / ls, lse[..., 0]


def _model_bwd(q, k, v, out, lse, do, causal, scale, lo, hi, passes):
    """delta, dq and dk/dv on (B, H, S, D) tensors: dp = dO v^T in f32 (the
    CUDA cores), every other product through ``_mm``; returns (dq, dk, dv)
    with dk, dv per query head (the caller sums the GQA group)."""
    b, h, s, d = q.shape
    live = _live(b, s, causal, lo, hi)
    delta = (do * out).sum(-1, keepdim=True)
    x = _mm(q, k.transpose(-1, -2), passes)
    p = torch.where(live, torch.exp(x * scale - lse[..., None]), torch.zeros(()))
    dp = do @ v.transpose(-1, -2) if passes == 3 else _mm(do, v.transpose(-1, -2), 1)
    ds = p * (dp - delta) * scale
    return (_mm(ds, k, passes), _mm(ds.transpose(-1, -2), q, passes),
            _mm(p.transpose(-1, -2), do, passes))


def _model(q, k, v, w, causal, lo, hi, passes):
    """out, lse and (dq, dk, dv) of the model on (B, S, H, D) numpy inputs,
    the backward at the model's own forward with dO = w."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    tq, tk, tv, tw = (torch.tensor(x).transpose(1, 2) for x in (q, k, v, w))
    tk, tv = tk.repeat_interleave(rep, 1), tv.repeat_interleave(rep, 1)
    scale = d ** -0.5
    out, lse = _model_fwd(tq, tk, tv, causal, scale, lo, hi, passes)
    dq, dk, dv = _model_bwd(tq, tk, tv, out, lse, tw, causal, scale, lo, hi, passes)
    dk, dv = (x.reshape(b, h // rep, rep, s, d).sum(2) for x in (dk, dv))
    return (out.transpose(1, 2).numpy(), lse.numpy(),
            [x.transpose(1, 2).numpy() for x in (dq, dk, dv)])


def _abs_refs(q, k, v, w, causal, lo, hi):
    """ref_abs of the rule in f64: attention on |v| for the output; for the
    gradients the sums of their absolute terms, p (|dp| + |delta|) scale
    |k| (dq), the same over queries with |q| (dk) and p |dO| (dv)."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    tq, tk, tv, tw = (torch.tensor(x).double().transpose(1, 2) for x in (q, k, v, w))
    tk, tv = tk.repeat_interleave(rep, 1), tv.repeat_interleave(rep, 1)
    live = _live(b, s, causal, lo, hi)
    x = torch.where(live, tq @ tk.transpose(-1, -2) * d ** -0.5, torch.tensor(NEG_INF).double())
    m = x.amax(-1, keepdim=True)
    p = torch.where(live, torch.exp(x - m), torch.zeros(()).double())
    l = p.sum(-1, keepdim=True)
    p = p / torch.where(l == 0, torch.ones(()).double(), l)
    out = p @ tv
    delta = (tw * out).sum(-1, keepdim=True)
    wgt = p * ((tw @ tv.transpose(-1, -2)).abs() + delta.abs()) * d ** -0.5
    dk = (wgt.transpose(-1, -2) @ tq.abs()).reshape(b, h // rep, rep, s, d).sum(2)
    dv = (p.transpose(-1, -2) @ tw.abs()).reshape(b, h // rep, rep, s, d).sum(2)
    return ((p @ tv.abs()).transpose(1, 2).numpy(),
            [x.transpose(1, 2).numpy() for x in (wgt @ tk.abs(), dk, dv)])


def _jax_ref(q, k, v, w, causal, lo, hi):
    def loss(q, k, v):
        out = jflash.flash_attention(q, k, v, causal=causal, kv_start=lo, kv_stop=hi,
                                     block_q=128, block_kv=128, interpret=True)
        return jnp.sum(out * w), out

    lo = None if lo is None else jnp.asarray(lo, jnp.int32)
    hi = None if hi is None else jnp.asarray(hi, jnp.int32)
    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _worst(got, ref, ref_abs) -> float:
    """The largest |got - ref| over its limit 2^-16 (|ref| + ref_abs)."""
    limit = RULE * (np.abs(ref).astype(np.float64) + ref_abs)
    diff = np.abs(got.astype(np.float64) - ref)
    return float(np.max(np.where(limit > 0, diff / np.maximum(limit, 1e-300),
                                 np.where(diff > 0, np.inf, 0.0))))


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("b,s,h,h_kv,causal,windows", [
    (1, 160, 4, 2, True, None),                       # causal GQA, ragged S (the B10 grid)
    (2, 192, 2, 1, False, ([5, 64], [150, 64])),      # windows, row 1 empty (the B11 grid)
], ids=["causal_gqa_ragged", "windows_empty_row"])
def test_the_3xtf32_model_holds_the_rule_and_one_pass_does_not(b, s, h, h_kv, causal, windows, d):
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((b, s, hh, d), dtype=np.float32) for hh in (h, h_kv, h_kv))
    w = rng.standard_normal((b, s, h, d), dtype=np.float32)
    lo, hi = windows if windows else (None, None)
    out_ref, grads_ref = _jax_ref(q, k, v, w, causal, lo, hi)
    lo_t = fa._window(None if lo is None else torch.tensor(lo), b, 0, "cpu")
    hi_t = fa._window(None if hi is None else torch.tensor(hi), b, s, "cpu")
    out_abs, grads_abs = _abs_refs(q, k, v, w, causal, lo_t, hi_t)
    # the rule's floor: the port's plain f32 versions meet it first.  A
    # causal row with one live key has dq = 0 exactly (dp = delta); where
    # its dp is ~1e-3 of its scale, two f32 orders of the same sum already
    # differ beyond 2^-16 (|ref| + ref_abs), and these inputs hold no such row
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    p_out, p_lse = fa.flash_attention_plain(tq, tk, tv, causal, d ** -0.5, lo_t, hi_t)
    p_grads = fa.flash_attention_bwd_plain(tq, tk, tv, p_out, p_lse, torch.tensor(w), causal,
                                           d ** -0.5, lo_t, hi_t)
    floor = max([_worst(p_out.numpy(), out_ref, out_abs)]
                + [_worst(g.numpy(), r, a) for g, r, a in zip(p_grads, grads_ref, grads_abs)])
    assert floor <= 0.5, floor
    worst = {}
    for passes in (3, 1):
        out, lse, grads = _model(q, k, v, w, causal, lo_t, hi_t, passes)
        worst[passes] = max([_worst(out, out_ref, out_abs)]
                            + [_worst(g, r, a) for g, r, a in zip(grads, grads_ref, grads_abs)])
        if windows:
            # the empty row: 0 with lse -1e30, zero gradients
            assert (out[1] == 0).all() and (lse[1] == NEG_INF).all()
            assert all((g[1] == 0).all() for g in grads)
    assert worst[3] <= 0.5, worst
    assert worst[1] > 1.0, worst


# ---- (c) the sources, (d) the names


def _body(src: str, head: str) -> str:
    body = src[src.index(head):]
    return body[:body.index("\n}\n")]


def test_sources_hold_the_tensor_core_design():
    src = SRC.read_text()
    assert 'mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32' in src
    assert 'cvt.rna.tf32.f32' in src
    assert "atomicAdd" not in src and not re.search(r"\b(atom|red)\.(global|shared|add)", src)
    # the three passes, small terms first
    mma3 = _body(src, "__device__ __forceinline__ void mma3(")
    assert mma3.index("a.small, b.big") < mma3.index("a.big, b.small") \
        < mma3.index("a.big, b.big")
    # copies in flight: a cp.async ring, no synchronous row loads
    assert "cp_async_16(" in src and "load_rows" not in src
    for name in ("flash_f32_fwd_launch", "flash_f32_bwd_delta_launch",
                 "flash_f32_bwd_dq_launch", "flash_f32_bwd_dkv_launch"):
        body = _body(src, f"int {name}(")
        for dh in (64, 128, 256):
            assert f"if (DH == {dh})" in body, (name, dh)
    res = _body(src, "int flash_f32_resources(int* res) {")
    assert "resources<64>(res + 48)" in res


def test_resources_name_the_dh64_kernels(monkeypatch):
    _stub_card(monkeypatch)
    res = fa.resources()
    names = ("fwd", "bwd_delta", "bwd_dq", "bwd_dkv")
    for suffix in ("", "_256", "_64"):
        assert {f"f32_{n}{suffix}" for n in names} <= set(res)
    assert set(res["f32_bwd_dkv_64"]) == set(build.RESOURCE_FIELDS)
