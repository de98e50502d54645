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

The kernels take bf16 (csrc/flash_attention.cu, flash_attention_bwd.cu:
wgmma) and f32 (csrc/flash_attention_f32.cu: 3xTF32 products on mma.sync)
at head dims 64, 128 and 256; other heads zero-pad up to the next
instance of their dtype (:func:`kernel_dh`).  A head of 64 runs unpadded:
the JAX wrapper's padding to 128 lanes is a TPU constraint.  The
wrapper raises ``NotImplementedError`` only where no kernel exists: causal
with Sq != Sk (as the JAX wrapper does) and, on a CUDA tensor, a dtype
other than bf16 and f32 (fp16: the JAX kernel computes in it, the port has
no fp16 instance yet) and head dims above 256.
``ops.attention.dot_product_attention`` then falls back loudly to its
reference path, as the JAX dispatcher does.  The tiles take a
ragged S, so S < 128, which the JAX kernel refuses for its lane width,
stays on the kernels here.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from mlcomp_tpu_torch.ops.cuda import build

NEG_INF = -1e30
# the kernels' head dims of each dtype; smaller heads zero-pad up
KERNEL_DHS = {torch.bfloat16: (64, 128, 256), torch.float32: (64, 128, 256)}
MAX_DH = max(max(dhs) for dhs in KERNEL_DHS.values())   # the largest of every dtype
# the source (library) of the forward and backward kernels of each dtype
_LIBS = {torch.bfloat16: ("flash_attention", "flash_attention_bwd", "flash"),
         torch.float32: ("flash_attention_f32", "flash_attention_f32", "flash_f32")}

# the bf16 dh-64 kernels read their operands by TMA, whose tensor maps take
# 16-byte-aligned bases only (every stride is a multiple of a 128-byte row)
TMA_ALIGN = 16

launches = 0
# the backward's three kernels
bwd_delta_launches = 0
bwd_dq_launches = 0
bwd_dkv_launches = 0
# backward calls on the causal (triangular, the TPU's B10) grid, counted
# again on their own: the ring's diagonal blocks against its full ones (B9)
bwd_causal_launches = 0
# the instances beside bf16 at dh 128, counted again on their own: the
# forward and the backward (one a backward) at bf16 dh 64 and 256, and on
# f32
fwd_dh64_launches = bwd_dh64_launches = 0
fwd_dh256_launches = bwd_dh256_launches = 0
f32_fwd_launches = f32_bwd_launches = 0


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


def kernel_dh(d: int, dtype: torch.dtype) -> int:
    """The kernel instance a head dim of ``dtype`` runs on: the smallest of
    its KERNEL_DHS that holds it (the rest zero-pads)."""
    for kd in KERNEL_DHS[dtype]:
        if d <= kd:
            return kd
    raise NotImplementedError(f"head dim {d} > {MAX_DH}")


def kernel_refusal(s_q: int, s_k: int, d: int, causal: bool,
                   dtype: torch.dtype = torch.bfloat16) -> Optional[str]:
    """Why no kernel takes these shapes and this dtype, or None: causal with
    Sq != Sk (the JAX wrapper's refusal, in its words), a dtype with no
    instance (fp16) and head dims above the largest instance."""
    if causal and s_q != s_k:
        return f"causal flash needs Sq == Sk; got {s_q}/{s_k}"
    if dtype not in KERNEL_DHS:
        return f"the kernels take bf16 or f32, not {dtype}"
    if d > MAX_DH:
        return f"head dim {d} > {MAX_DH}"
    return None


def runs_kernels(t: torch.Tensor) -> bool:
    """True where a tensor launches the kernels (CUDA); a CPU tensor takes
    the plain versions, any other device raises."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {t.device}")
    return t.device.type == "cuda"


def _kernel_inputs(d: int, *ts: torch.Tensor):
    """The kernels' operands: one dtype they take, the head dim zero-padded
    to its instance (zero columns add nothing to q.k, dO.v or dO.O, and the
    columns they produce are sliced off), contiguous: a head of its
    instance's width passes as it is."""
    if ts[0].dtype not in _LIBS or any(t.dtype != ts[0].dtype for t in ts):
        raise TypeError("the kernels take bf16 or f32 tensors of one dtype; got "
                        + ", ".join(str(t.dtype) for t in ts))
    kd = kernel_dh(d, ts[0].dtype)
    if d < kd:
        ts = tuple(torch.nn.functional.pad(t, (0, kd - d)) for t in ts)
    return kd, tuple(t.contiguous() for t in ts)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, scale: Optional[float] = None,
                        kv_start: Optional[torch.Tensor] = None,
                        kv_stop: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, Sq, H, D); k/v (B, Sk, Hkv, D); kv_start/kv_stop (B,) int32.
    Returns (out (B, Sq, H, D) in q.dtype, lse (B, H, Sq) f32).  Raises
    ``NotImplementedError`` where :func:`kernel_refusal` refuses on a CUDA
    tensor, and on causal with Sq != Sk on any device."""
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    if h % h_kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    lo = _window(kv_start, b, 0, q.device)
    hi = _window(kv_stop, b, s_k, q.device)
    if not runs_kernels(q):
        # the plain version's diagonal is position-aligned like the kernels':
        # an offset causal mask is the reference path's
        if causal and s_q != s_k:
            raise NotImplementedError(f"causal flash needs Sq == Sk; got {s_q}/{s_k}")
        return flash_attention_plain(q, k, v, causal, scale, lo, hi)
    why = kernel_refusal(s_q, s_k, d, causal, q.dtype)
    if why:
        raise NotImplementedError(why)
    return _launch_fwd(q, k, v, lo, hi, causal, scale)


def check_tma_aligned(dtype, kd: int, **ts: torch.Tensor) -> None:
    """Raise ``ValueError`` where a bf16 dh-64 kernel would get an operand
    whose base is not TMA_ALIGN-byte aligned (a view into another tensor's
    storage); other instances take any base."""
    if dtype != torch.bfloat16 or kd != 64:
        return
    bad = [n for n, t in ts.items() if t.data_ptr() % TMA_ALIGN]
    if bad:
        raise ValueError(f"the dh-64 flash kernels load {', '.join(bad)} by TMA, which needs "
                         f"{TMA_ALIGN}-byte-aligned bases; pass a copy (.clone())")


def _launch_fwd(q, k, v, lo, hi, causal: bool, scale: float):
    global launches
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    kd, (q, k, v) = _kernel_inputs(d, q, k, v)
    check_tma_aligned(q.dtype, kd, q=q, k=k, v=v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    stem, _, prefix = _LIBS[q.dtype]
    launch = build.function(stem, f"{prefix}_fwd_launch", [p] * 7 + [i] * 7 + [ctypes.c_float, p])
    err = launch(
        *(t.data_ptr() for t in (q, k, v, lo, hi, out, lse)),
        b, h, h_kv, s_q, s_k, kd, int(bool(causal)), scale, build.stream_ptr(q.device),
    )
    build.check(err, stem)
    launches += 1
    _count_instance("fwd", q.dtype, kd)
    return out[..., :d], lse


def _count_instance(kind: str, dtype, kd: int) -> None:
    """Count a ``kind`` ("fwd" or "bwd") call again on its instance's own
    counter (bf16 dh 128 has only the shared counters)."""
    global fwd_dh64_launches, bwd_dh64_launches, fwd_dh256_launches, bwd_dh256_launches
    global f32_fwd_launches, f32_bwd_launches
    fwd = kind == "fwd"
    if dtype == torch.float32:
        if fwd:
            f32_fwd_launches += 1
        else:
            f32_bwd_launches += 1
    elif kd == 64:
        if fwd:
            fwd_dh64_launches += 1
        else:
            bwd_dh64_launches += 1
    elif kd == 256:
        if fwd:
            fwd_dh256_launches += 1
        else:
            bwd_dh256_launches += 1


def flash_work(b: int, s_q: int, s_k: int, h: int, h_kv: int, d: int, causal: bool,
               kv_start=None, kv_stop=None, itemsize: int = 2) -> dict:
    """The work behind the flash kernels' bounds for one call on these
    inputs: ``live_pairs``, the (batch, query, key) pairs of the causal-and-
    window mask; ``live_rows``, the (batch, query) rows with a live key;
    ``live_keys``, the (batch, key) positions inside ``[kv_start, kv_stop)``;
    the forward's operations (4 x pairs x H x dh: q.k and p.v) and bytes
    (q of live rows, k/v of live keys read once; out and lse written) and
    the backward's (10 x pairs x H x dh: q.k and dO.v recomputed, dq, dk
    and dv; q/out/dO of live rows and k/v of live keys read, lse read, dq,
    dk and dv written), at ``itemsize`` bytes an element (2 for bf16, 4 for
    f32).  Windows given add 4 bytes per batch row each."""
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
        fwd_bytes=(live_rows * h + 2 * live_keys * h_kv) * d * itemsize
        + b * s_q * h * d * itemsize + b * h * s_q * 4 + win_bytes,
        bwd_bytes=(3 * live_rows * h + 2 * live_keys * h_kv) * d * itemsize
        + (b * s_q * h + 2 * b * s_k * h_kv) * d * itemsize + b * h * s_q * 4 + win_bytes,
    )


def resources() -> dict:
    """Each flash kernel's resources on the card (``build.resources``):
    {"fwd" | "bwd_delta" | "bwd_dq" | "bwd_dkv" (bf16, dh 128), the same
    names ending "_256" and "_64" (bf16, dh 256 and 64) and "f32_<name>" /
    "f32_<name>_256" / "f32_<name>_64" (f32, dh 128, 256 and 64): {field:
    int}}.  The bf16 dh-64 kernels rebalance their registers between
    producer and consumers: ``dh64_registers``."""
    names = ("fwd", "bwd_delta", "bwd_dq", "bwd_dkv")
    return {**build.resources("flash_attention", "flash_fwd_resources",
                              ("fwd", "fwd_256", "fwd_64")),
            **build.resources("flash_attention_bwd", "flash_bwd_resources",
                              names[1:] + tuple(n + "_256" for n in names[1:])
                              + tuple(n + "_64" for n in names[1:])),
            **build.resources("flash_attention_f32", "flash_f32_resources",
                              tuple(f"f32_{n}" for n in names)
                              + tuple(f"f32_{n}_256" for n in names)
                              + tuple(f"f32_{n}_64" for n in names))}


def dh64_registers() -> dict:
    """The bf16 dh-64 kernels' registers a thread after ``setmaxnreg``
    (``resources()`` gives those at launch): {"fwd_64" | "bwd_dq_64" |
    "bwd_dkv_64": {"producer": n, "consumer": n}}."""
    names = {"flash_attention": ("flash_fwd64_regs", ("fwd_64",)),
             "flash_attention_bwd": ("flash_bwd64_regs", ("bwd_dq_64", "bwd_dkv_64"))}
    out = {}
    for stem, (fn, kernels) in names.items():
        buf = (ctypes.c_int * (2 * len(kernels)))()
        query = build.function(stem, fn, [ctypes.c_void_p])
        build.check(query(ctypes.addressof(buf)), f"{stem} registers")
        for i, k in enumerate(kernels):
            out[k] = {"producer": buf[2 * i], "consumer": buf[2 * i + 1]}
    return out


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
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    lo = _window(kv_start, b, 0, q.device)
    hi = _window(kv_stop, b, s_k, q.device)
    if not runs_kernels(q):
        return flash_attention_bwd_plain(q, k, v, out, lse, do, causal, scale, lo, hi, g_lse)
    why = kernel_refusal(s_q, s_k, d, causal, q.dtype)
    if why:
        raise NotImplementedError(why)
    return _launch_bwd(q, k, v, out, lse, do.to(q.dtype), causal, scale, lo, hi, g_lse)


def _launch_bwd(q, k, v, out, lse, do, causal: bool, scale: float, lo, hi, g_lse):
    global bwd_delta_launches, bwd_dq_launches, bwd_dkv_launches, bwd_causal_launches
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    kd, (q, k, v, out, do) = _kernel_inputs(d, q, k, v, out, do)
    check_tma_aligned(q.dtype, kd, q=q, k=k, v=v, do=do)
    lse = lse.float().contiguous()
    g = None if g_lse is None else g_lse.float().contiguous()
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = build.stream_ptr(q.device)
    _, stem, prefix = _LIBS[q.dtype]
    delta = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    launch = build.function(stem, f"{prefix}_bwd_delta_launch", [p] * 4 + [i] * 4 + [p])
    err = launch(do.data_ptr(), out.data_ptr(), None if g is None else g.data_ptr(),
                 delta.data_ptr(), b, h, s_q, kd, stream)
    build.check(err, f"{stem} delta")
    bwd_delta_launches += 1
    dq = torch.empty_like(q)
    launch = build.function(stem, f"{prefix}_bwd_dq_launch",
                            [p] * 9 + [i] * 7 + [ctypes.c_float, p])
    err = launch(*(t.data_ptr() for t in (q, k, v, do, lse, delta, lo, hi, dq)),
                 b, h, h_kv, s_q, s_k, kd, int(bool(causal)), scale, stream)
    build.check(err, f"{stem} dq")
    bwd_dq_launches += 1
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    launch = build.function(stem, f"{prefix}_bwd_dkv_launch",
                            [p] * 10 + [i] * 7 + [ctypes.c_float, p])
    err = launch(*(t.data_ptr() for t in (q, k, v, do, lse, delta, lo, hi, dk, dv)),
                 b, h, h_kv, s_q, s_k, kd, int(bool(causal)), scale, stream)
    build.check(err, f"{stem} dk/dv")
    bwd_dkv_launches += 1
    if causal:
        bwd_causal_launches += 1
    _count_instance("bwd", q.dtype, kd)
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
