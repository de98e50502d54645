"""Flash attention over (B, S, H, D) tensors, forward
(csrc/flash_attention.cu) and backward (csrc/flash_attention_bwd.cu).

The counterpart of mlcomp_tpu/ops/pallas/flash_attention.py: causal
and/or per-row key windows ``[kv_start, kv_stop)``, GQA, and a row with
no live key outputs 0 and gets zero gradients.  :func:`flash_attention`
and :func:`flash_attention_lse` are differentiable through
:class:`FlashAttention` (``_flash``'s custom VJP, :1165-1180): the
forward saves q, k, v, out and lse, the backward runs the delta, dq and
dk/dv kernels.  A CUDA tensor launches the kernels; a CPU tensor takes
:func:`flash_attention_plain` and :func:`flash_attention_bwd_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from mlcomp_tpu_torch.ops.cuda import build

NEG_INF = -1e30
_KERNEL_DH = 128   # the kernel's head dim; smaller heads zero-pad up to it

launches = 0
# the backward's three kernels
bwd_delta_launches = 0
bwd_dq_launches = 0
bwd_dkv_launches = 0


def flash_attention_plain(q, k, v, causal, scale, kv_start, kv_stop
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version with the kernel's semantics: f32 logits, masked to
    -1e30, p zero on masked logits (an empty row outputs 0), p rounded to
    v.dtype before the P V product.  Returns (out (B, Sq, H, D), lse
    (B, H, Sq))."""
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    rep = h // h_kv
    qg = q.float().reshape(b, s_q, h_kv, rep, d)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * scale
    cols = torch.arange(s_k, device=q.device)
    live = (cols[None] >= kv_start[:, None]) & (cols[None] < kv_stop[:, None])
    live = live[:, None, None, None, :]
    if causal:
        rows = torch.arange(s_q, device=q.device)
        live = live & (rows[:, None] >= cols[None, :])
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    acc = torch.einsum("bgrqk,bkgd->bqgrd", p.to(v.dtype).float(), v.float())
    out = acc / l_safe.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(l_safe))[..., 0].reshape(b, h, s_q)
    return out.reshape(b, s_q, h, d).to(q.dtype), lse


def _window(x, b: int, default: int, device) -> torch.Tensor:
    if x is None:
        return torch.full((b,), default, dtype=torch.int32, device=device)
    return x.to(device=device, dtype=torch.int32).contiguous()


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, scale: Optional[float] = None,
                        kv_start: Optional[torch.Tensor] = None,
                        kv_stop: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, Sq, H, D); k/v (B, Sk, Hkv, D); kv_start/kv_stop (B,) int32.
    Returns (out (B, Sq, H, D) in q.dtype, lse (B, H, Sq) f32)."""
    global launches
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    if h % h_kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    if causal and s_q != s_k:
        raise NotImplementedError(f"causal flash needs Sq == Sk; got {s_q}/{s_k}")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    lo = _window(kv_start, b, 0, q.device)
    hi = _window(kv_stop, b, s_k, q.device)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale, lo, hi)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"the kernel takes bf16 q/k/v; got {q.dtype}, {k.dtype}, {v.dtype}")
    if d > _KERNEL_DH:
        raise NotImplementedError(f"head dim {d} > {_KERNEL_DH}")
    if d < _KERNEL_DH:
        # zero columns add nothing to q.k and give output columns that
        # are sliced off below
        pad = (0, _KERNEL_DH - d)
        q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
    q, k, v = (t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    launch = build.function("flash_attention", "flash_fwd_launch",
                            [p] * 7 + [i] * 6 + [ctypes.c_float, p])
    err = launch(
        *(t.data_ptr() for t in (q, k, v, lo, hi, out, lse)),
        b, h, h_kv, s_q, s_k, int(bool(causal)), scale, build.stream_ptr(q.device),
    )
    build.check(err, "flash_attention")
    launches += 1
    return out[..., :d], lse


def flash_work(b: int, s_q: int, s_k: int, h: int, h_kv: int, d: int, causal: bool,
               kv_start=None, kv_stop=None) -> dict:
    """The work behind the flash kernels' bounds for one call on these
    inputs: ``live_pairs``, the (batch, query, key) pairs of the causal-and-
    window mask; ``live_rows``, the (batch, query) rows with a live key;
    ``live_keys``, the (batch, key) positions inside ``[kv_start, kv_stop)``;
    the forward's operations (4 x pairs x H x dh: q.k and p.v) and bytes
    (q of live rows, k/v of live keys read once; out and lse written) and
    the backward's (10 x pairs x H x dh: q.k and dO.v recomputed, dq, dk
    and dv; q/out/dO of live rows and k/v of live keys read, lse read, dq,
    dk and dv written).  Windows given add 4 bytes per batch row each."""
    lo = _window(kv_start, b, 0, "cpu").long().clamp(0, s_k)
    hi = _window(kv_stop, b, s_k, "cpu").long().clamp(0, s_k)
    width = (hi - lo).clamp_min(0)
    if causal:
        rows = torch.arange(s_q)
        per_row = (torch.minimum(hi[:, None], rows[None] + 1) - lo[:, None]).clamp_min(0)
    else:
        per_row = width[:, None].expand(b, s_q)
    pairs = int(per_row.sum())
    live_rows = int((per_row > 0).sum())
    live_keys = int(width.sum())
    win_bytes = 4 * b * ((kv_start is not None) + (kv_stop is not None))
    return dict(
        live_pairs=pairs, live_rows=live_rows, live_keys=live_keys,
        fwd_ops=4 * pairs * h * d, bwd_ops=10 * pairs * h * d,
        fwd_bytes=(live_rows * h + 2 * live_keys * h_kv) * d * 2 + b * s_q * h * d * 2
        + b * h * s_q * 4 + win_bytes,
        bwd_bytes=(3 * live_rows * h + 2 * live_keys * h_kv) * d * 2
        + (b * s_q * h + 2 * b * s_k * h_kv) * d * 2 + b * h * s_q * 4 + win_bytes,
    )


def resources() -> dict:
    """Each flash kernel's resources on the card (``build.resources``):
    {"fwd" | "bwd_delta" | "bwd_dq" | "bwd_dkv": {field: int}}."""
    return {**build.resources("flash_attention", "flash_fwd_resources", ("fwd",)),
            **build.resources("flash_attention_bwd", "flash_bwd_resources",
                              ("bwd_delta", "bwd_dq", "bwd_dkv"))}


def flash_attention_bwd_plain(q, k, v, out, lse, do, causal, scale, kv_start, kv_stop,
                              g_lse=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward with the kernels' semantics and
    roundings (``_dq_update``/``_dkv_update``): delta = sum_d dO * O in f32
    (minus ``g_lse``, the lse cotangent (B, H, Sq), when given); p =
    exp(s - lse) selected to 0 on masked logits; ds = p (dp - delta) *
    scale; ds rounds to k's dtype before dq += ds k and to q's before
    dk += ds^T q, p to dO's before dv += p^T dO.  dk and dv sum over the
    GQA group.  Returns (dq, dk, dv) in the input dtypes."""
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    rep = h // h_kv
    do = do.to(q.dtype)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)          # (B, H, Sq)
    if g_lse is not None:
        delta = delta - g_lse.float()
    qg = q.float().reshape(b, s_q, h_kv, rep, d)
    dog = do.float().reshape(b, s_q, h_kv, rep, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kf) * scale
    cols = torch.arange(s_k, device=q.device)
    live = (cols[None] >= kv_start[:, None]) & (cols[None] < kv_stop[:, None])
    live = live[:, None, None, None, :]
    if causal:
        rows = torch.arange(s_q, device=q.device)
        live = live & (rows[:, None] >= cols[None, :])
    p = torch.where(live, torch.exp(s - lse.reshape(b, h_kv, rep, s_q)[..., None]),
                    torch.zeros_like(s))
    dp = torch.einsum("bqgrd,bkgd->bgrqk", dog, vf)
    ds = p * (dp - delta.reshape(b, h_kv, rep, s_q)[..., None]) * scale
    dq = torch.einsum("bgrqk,bkgd->bqgrd", ds.to(k.dtype).float(), kf)
    dk = torch.einsum("bgrqk,bqgrd->bkgd", ds.to(q.dtype).float(), qg)
    dv = torch.einsum("bgrqk,bqgrd->bkgd", p.to(do.dtype).float(), dog)
    return dq.reshape(b, s_q, h, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q, k, v, out, lse, do, causal: bool, scale: float,
                        kv_start=None, kv_stop=None, g_lse=None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of attention at the forward's (out, lse) for
    the output cotangent ``do`` and the optional lse cotangent ``g_lse``
    (B, H, Sq).  CUDA tensors launch the delta, dq and dk/dv kernels; CPU
    tensors take :func:`flash_attention_bwd_plain`."""
    global bwd_delta_launches, bwd_dq_launches, bwd_dkv_launches
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    lo = _window(kv_start, b, 0, q.device)
    hi = _window(kv_stop, b, s_k, q.device)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do, causal, scale, lo, hi, g_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")
    if not (q.dtype == k.dtype == v.dtype == out.dtype == torch.bfloat16):
        raise TypeError(f"the kernels take bf16 q/k/v/out; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}, {out.dtype}")
    if d > _KERNEL_DH:
        raise NotImplementedError(f"head dim {d} > {_KERNEL_DH}")
    do = do.to(q.dtype)
    if d < _KERNEL_DH:
        # zero columns add nothing to q.k, dO.v or dO.O; the gradient
        # columns they produce are sliced off below
        pad = (0, _KERNEL_DH - d)
        q, k, v, out, do = (torch.nn.functional.pad(t, pad) for t in (q, k, v, out, do))
    q, k, v, out, do = (t.contiguous() for t in (q, k, v, out, do))
    lse = lse.float().contiguous()
    g = None if g_lse is None else g_lse.float().contiguous()
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = build.stream_ptr(q.device)
    delta = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    launch = build.function("flash_attention_bwd", "flash_bwd_delta_launch",
                            [p] * 4 + [i] * 3 + [p])
    err = launch(do.data_ptr(), out.data_ptr(), None if g is None else g.data_ptr(),
                 delta.data_ptr(), b, h, s_q, stream)
    build.check(err, "flash_attention_bwd delta")
    bwd_delta_launches += 1
    dq = torch.empty_like(q)
    launch = build.function("flash_attention_bwd", "flash_bwd_dq_launch",
                            [p] * 9 + [i] * 6 + [ctypes.c_float, p])
    err = launch(*(t.data_ptr() for t in (q, k, v, do, lse, delta, lo, hi, dq)),
                 b, h, h_kv, s_q, s_k, int(bool(causal)), scale, stream)
    build.check(err, "flash_attention_bwd dq")
    bwd_dq_launches += 1
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    launch = build.function("flash_attention_bwd", "flash_bwd_dkv_launch",
                            [p] * 10 + [i] * 6 + [ctypes.c_float, p])
    err = launch(*(t.data_ptr() for t in (q, k, v, do, lse, delta, lo, hi, dk, dv)),
                 b, h, h_kv, s_q, s_k, int(bool(causal)), scale, stream)
    build.check(err, "flash_attention_bwd dk/dv")
    bwd_dkv_launches += 1
    return dq[..., :d], dk[..., :d], dv[..., :d]


class FlashAttention(torch.autograd.Function):
    """``_flash``'s custom VJP: the forward runs :func:`flash_attention_fwd`
    and saves q, k, v, out, lse and the windows; the backward runs
    :func:`flash_attention_bwd`, folding an lse cotangent into delta.
    Returns (out (B, Sq, H, D), lse (B, H, Sq))."""

    @staticmethod
    def forward(ctx, q, k, v, kv_start, kv_stop, causal: bool, scale: float):
        out, lse = flash_attention_fwd(q, k, v, causal, scale, kv_start, kv_stop)
        ctx.save_for_backward(q, k, v, out, lse, kv_start, kv_stop)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse, kv_start, kv_stop = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.causal, ctx.scale,
                                         kv_start, kv_stop, g_lse=dlse)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = False, scale: Optional[float] = None,
                    kv_start=None, kv_stop=None) -> torch.Tensor:
    """Flash attention over (B, S, H, D) tensors; returns (B, Sq, H, D).
    Differentiable in q, k and v."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    return FlashAttention.apply(q, k, v, kv_start, kv_stop, bool(causal), float(scale))[0]


def flash_attention_lse(q, k, v, causal: bool = False, scale: Optional[float] = None,
                        kv_start=None, kv_stop=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like :func:`flash_attention`, also returning the per-row logsumexp
    (B, Sq, H), the JAX package's layout: the ring-attention building
    block.  Differentiable in q, k and v through both outputs."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    out, lse = FlashAttention.apply(q, k, v, kv_start, kv_stop, bool(causal), float(scale))
    return out, lse.transpose(1, 2)
