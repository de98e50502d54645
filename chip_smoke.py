#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mlcomp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero
without printing a result:

1. device: a CUDA card must be present; prints ``nvidia-smi``'s name and
   power limit.
2. build: compiles every kernel in mlcomp_tpu_torch/csrc with nvcc.
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes of the 1.2B transformer_lm (hidden 2048, 16
   heads, mlp 8192, vocab 32768), with its time, the plain version's, one
   PyTorch library call's (a yardstick only; the port never calls it) and
   the card's bound for the same work.
4. window serve: the 1.2B all-int8 transformer_lm (int8 weights through
   the int8 matmul, int8 KV cache, fused qkv/gate_up, 16 layers, random
   weights from a seed) behind the HTTP server on 127.0.0.1 through the
   window batcher; concurrent greedy and sampled requests; launch counts
   of every kernel over that run; prefill and decode times.
5. window parity: one prefill and 8 teacher-forced decode steps of the
   same model with the kernels and with their plain versions.
6. engine serve (the main path): the same model behind HTTP through the
   default continuous batcher (8 slots, prompt bucket 512, 128 new tokens,
   prefill chunk 256, adaptive K, pipeline depth 2, fused admission):
   concurrent greedy and sampled requests of 100-500 prompt tokens, one
   SSE stream, a repeated greedy prompt; every kernel must launch; TTFT,
   decode ms per step at 8 live slots, tok/s and the K rungs used.
7. engine parity: a (1, 256) admission chunk at cache index 256 and 8
   per-row-cursor decode steps, kernels against plain versions.
8. summary: a ``kernels`` JSON line, then, last, the device line.
"""

from __future__ import annotations

import json
import math
import queue
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

import torch

CFG = {
    "name": "transformer_lm", "vocab_size": 32768, "hidden": 2048, "layers": 16,
    "heads": 16, "mlp_dim": 8192, "dtype": "bfloat16",
    "decode_fused": True, "kv_quant": True,
}
SEED = 0
BATCH, PROMPT, NEW, CHUNK = 8, 512, 128, 256

# data-sheet peaks (dense): memory bytes/s, bf16 tensor FLOP/s
PEAKS = {
    "H100 SXM": (3.35e12, 989e12),
    "H100 PCIe": (2.0e12, 756e12),
    "H100 NVL": (3.9e12, 835e12),
    "H200": (4.8e12, 989e12),
}


def log(*a):
    print(*a, flush=True)


def peaks_for(name: str):
    n = name.upper()
    if "H200" in n:
        return "H200", PEAKS["H200"]
    if "PCIE" in n:
        return "H100 PCIe", PEAKS["H100 PCIe"]
    if "NVL" in n:
        return "H100 NVL", PEAKS["H100 NVL"]
    if "H100" in n:
        return "H100 SXM", PEAKS["H100 SXM"]
    raise SystemExit(f"no data-sheet peaks for {name!r}; add them to PEAKS")


def time_ms(fns, iters=20, warmup=3):
    """Mean device time of one call, cycling through ``fns`` (copies of the
    operands, so that the weights come from device memory, not L2)."""
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fns[i % len(fns)]()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def copies_for(nbytes: int) -> int:
    return max(2, math.ceil(160e6 / max(nbytes, 1)))


class Kernel:
    def __init__(self, name, source, replaces, module, counter="launches"):
        self.name, self.source, self.replaces = name, source, replaces
        self.module, self.counter = module, counter
        self.rows = []          # per-shape measurements

    @property
    def launches(self) -> int:
        return getattr(self.module, self.counter)

    def reset(self) -> None:
        setattr(self.module, self.counter, 0)

    def add(self, **kw):
        self.rows.append(kw)
        log("  " + json.dumps(kw))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    card, (bw, flops) = peaks_for(kind)
    log(f"device: {kind}; bounds from the {card} data sheet: {bw / 1e12} TB/s, "
        f"{flops / 1e12} TFLOP/s bf16")

    # ---- 2. build
    from mlcomp_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s")

    from mlcomp_tpu_torch.ops.cuda import decode_attention as da
    from mlcomp_tpu_torch.ops.cuda import flash_attention as fa
    from mlcomp_tpu_torch.ops.cuda import page_gather as pgm
    from mlcomp_tpu_torch.ops.cuda import quant_matmul as qm

    kernels = {
        "B1": Kernel("quant_matmul", "mlcomp_tpu_torch/csrc/quant_matmul.cu",
                     "mlcomp_tpu/ops/pallas/quant_matmul.py:41", qm),
        "B2": Kernel("quant_matmul_norm", "mlcomp_tpu_torch/csrc/quant_matmul.cu",
                     "mlcomp_tpu/ops/pallas/quant_matmul.py:61", qm, "norm_launches"),
        "B3": Kernel("decode_attention", "mlcomp_tpu_torch/csrc/decode_attention.cu",
                     "mlcomp_tpu/ops/pallas/decode_attention.py:173", da),
        "B4": Kernel("decode_attention_chunk", "mlcomp_tpu_torch/csrc/decode_attention.cu",
                     "mlcomp_tpu/ops/pallas/decode_attention.py:323", da, "chunk_launches"),
        "B5": Kernel("flash_attention_fwd", "mlcomp_tpu_torch/csrc/flash_attention.cu",
                     "mlcomp_tpu/ops/pallas/flash_attention.py:507", fa),
        "B6": Kernel("paged_decode_attention", "mlcomp_tpu_torch/csrc/decode_attention.cu",
                     "mlcomp_tpu/ops/pallas/decode_attention.py:957", da, "paged_launches"),
        "B7": Kernel("paged_decode_attention_chunk", "mlcomp_tpu_torch/csrc/decode_attention.cu",
                     "mlcomp_tpu/ops/pallas/decode_attention.py:1169", da,
                     "paged_chunk_launches"),
        "B8": Kernel("page_gather", "mlcomp_tpu_torch/csrc/page_gather.cu",
                     "mlcomp_tpu/kvpool/layout.py:384", pgm),
    }
    # the kernels the dense paths run (B1-B5) and those of the paged paths
    dense_keys = ("B1", "B2", "B3", "B4", "B5")
    g = torch.Generator(device=dev).manual_seed(SEED)

    def bound_of(nbytes, ops):
        """The card's least time for work that moves ``nbytes`` (each input
        read once, each output written once) and does ``ops`` bf16 tensor
        operations: the larger of the two times."""
        t_bytes, t_ops = nbytes / bw, ops / flops
        return dict(bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops) * 1e3,
                    bound_by="bytes" if t_bytes >= t_ops else "operations")

    def total(weighted):
        """Times, bytes and operations summed over one decode step's (or
        prefill's, or admission chunk's) calls: ``weighted`` pairs each
        measured shape with its calls; the bound is that of the summed work."""
        agg = {f: sum(r[f] * c for r, c in weighted) for f in ("ms", "plain_ms", "library_ms")}
        agg.update(bound_of(sum(r["bytes"] * c for r, c in weighted),
                            sum(r["ops"] * c for r, c in weighted)))
        agg["calls"] = sum(c for _, c in weighted)
        return agg

    # ---- 3. kernels against their plain versions
    log("phase kernels")
    # tolerance, element by element: |kernel - plain| <= 2^-7 (|ref| + ref_abs).
    # ref_abs is the plain version on the absolute values of the summed
    # operand (|x| and |q8|, |v|): the sum of the absolute terms behind each
    # output.  Both sides round the output to bf16 (at most one step apart,
    # 2^-7 |ref|).  Inside, each rounds an intermediate to bf16 where the two
    # can land on neighbouring values: the normed x (B2), p or p * vs against
    # another running max (B3, B5); that moves each term by at most 2^-8 of
    # it (2^-7 for a normed x element on a tie), so the sum by at most 2^-7
    # ref_abs.  f32 sums in another order add ~2^-20 of it.  A wrong tile, a
    # wrong scale or a missed mask moves an output by a whole term.
    rel_tol = 2.0 ** -7

    def held(name, out, ref, ref_abs):
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        limit = rel_tol * (ref.float().abs() + ref_abs.float())
        err = diff.max().item()
        ratio = (diff / limit.clamp_min(1e-30)).max().item()
        if not math.isfinite(err) or not bool((diff <= limit).all()):
            raise AssertionError(f"{name}: |kernel - plain| over 2^-7 (|ref| + ref_abs): "
                                 f"max error {err}, max error / limit {ratio}")
        return err, ratio

    hidden, mlp, vocab = CFG["hidden"], CFG["mlp_dim"], CFG["vocab_size"]
    layers = CFG["layers"]
    qkv_n = 3 * hidden
    d_shapes = [(hidden, qkv_n), (hidden, 2 * mlp), (mlp, hidden), (hidden, hidden),
                (hidden, vocab)]
    # calls per shape in a decode step (decode_fused): B2 runs qkv, gate_up
    # and the lm_head; B1 runs out and down; a prefill runs all four
    # projections through B1.  The serve phase checks these against the
    # launch counts it measures.
    b1_step = {(hidden, hidden): layers, (mlp, hidden): layers}
    b2_step = {(hidden, qkv_n): layers, (hidden, 2 * mlp): layers, (hidden, vocab): 1}
    b1_prefill = {(hidden, qkv_n): layers, (hidden, 2 * mlp): layers, (mlp, hidden): layers,
                  (hidden, hidden): layers}

    def by_shape(key, shapes, n_rows):
        rows = {(r["d"], r["n"]): r for r in kernels[key].rows if r["rows"] == n_rows}
        return [(rows[s], c) for s, c in shapes.items()]

    def qmm_case(rows, d, n, norm):
        q8 = torch.randint(-127, 128, (d, n), generator=g, device=dev, dtype=torch.int8)
        sc = torch.rand(n, generator=g, device=dev) / (127 * math.sqrt(d))
        x = torch.randn(rows, d, generator=g, device=dev).bfloat16()
        gn = torch.rand(d, generator=g, device=dev) + 0.5 if norm else None
        out = qm.quant_matmul(x, q8, sc, norm_scale=gn)
        err, ratio = held(f"quant_matmul{'_norm' if norm else ''} {rows}x{d}x{n}", out,
                          qm.quant_matmul_plain(x, q8, sc, norm_scale=gn),
                          qm.quant_matmul_plain(x.abs(), q8.abs(), sc, norm_scale=gn))
        ncopy = copies_for(d * n)
        ws = [q8] + [q8.clone() for _ in range(ncopy - 1)]
        kms = time_ms([lambda w=w: qm.quant_matmul(x, w, sc, norm_scale=gn) for w in ws])
        pms = time_ms([lambda w=w: qm.quant_matmul_plain(x, w, sc, norm_scale=gn) for w in ws[:2]],
                      iters=5, warmup=1)
        wb = [(w.float() * sc).bfloat16() for w in ws[:2]]
        # yardstick: the bf16 product alone (for B2 on the normed x)
        xl = x
        if norm:
            x32 = x.float()
            xl = (x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-6) * gn).bfloat16()
        lms = time_ms([lambda w=w: torch.matmul(xl, w) for w in wb])
        del ws, wb
        nbytes = rows * d * x.element_size() + d * n + n * 4 + rows * n * 2 + (d * 4 if norm else 0)
        ops = 2 * rows * d * n
        return dict(rows=rows, d=d, n=n, max_abs_err=err, err_over_limit=ratio, ms=kms,
                    plain_ms=pms, library_ms=lms, **bound_of(nbytes, ops))

    for d, n in d_shapes:
        kernels["B1"].add(**qmm_case(BATCH, d, n, False))
        kernels["B2"].add(**qmm_case(BATCH, d, n, True))
    for d, n in b1_prefill:
        kernels["B1"].add(**qmm_case(BATCH * PROMPT, d, n, False))
    # an engine admission chunk: its four projections at CHUNK rows (B1) and
    # its last_only lm_head at one row (B2, which splits D otherwise)
    for d, n in b1_prefill:
        kernels["B1"].add(**qmm_case(CHUNK, d, n, False))
    kernels["B2"].add(**qmm_case(1, hidden, vocab, True))
    torch.cuda.empty_cache()

    # B3: the decode step's cache: prompt bucket 512 + 128 new tokens
    heads = CFG["heads"]
    dh = hidden // heads
    l_buf = da.pick_buffer_len(PROMPT + NEW, heads, dh)
    starts = torch.randint(0, PROMPT - 100, (BATCH,), generator=g, device=dev, dtype=torch.int32)
    stops = torch.full((BATCH,), PROMPT + NEW // 2, dtype=torch.int32, device=dev)
    caches = []
    for _ in range(copies_for(2 * BATCH * heads * l_buf * dh)):
        k8, ks = da.quantize_kv(torch.randn(BATCH, l_buf, heads, dh, generator=g, device=dev))
        v8, vs = da.quantize_kv(torch.randn(BATCH, l_buf, heads, dh, generator=g, device=dev))
        caches.append((k8.transpose(1, 2).contiguous(),
                       ks.transpose(1, 2)[:, :, None].bfloat16().contiguous(),
                       v8.transpose(1, 2).contiguous(),
                       vs.transpose(1, 2)[:, :, None].bfloat16().contiguous()))
    q = torch.randn(BATCH, heads, dh, generator=g, device=dev).bfloat16()
    scale = 1.0 / math.sqrt(dh)
    out = da.decode_attention(q, *caches[0], starts, stops, scale)
    k8, ks, v8, vs = caches[0]
    err, ratio = held("decode_attention", out,
                      da.decode_attention_plain(q, k8, ks, v8, vs, starts, stops, scale),
                      da.decode_attention_plain(q, k8, ks, v8.abs(), vs, starts, stops, scale))
    del k8, ks, v8, vs
    kms = time_ms([lambda c=c: da.decode_attention(q, *c, starts, stops, scale) for c in caches])
    pms = time_ms([lambda c=c: da.decode_attention_plain(q, *c, starts, stops, scale)
                   for c in caches[:2]], iters=5, warmup=1)
    slots = torch.arange(l_buf, device=dev)
    mask = ((slots[None] >= starts[:, None]) & (slots[None] < stops[:, None]))[:, None, None, :]
    dq = [((c[0].float() * c[1].float().transpose(2, 3)).bfloat16(),
           (c[2].float() * c[3].float().transpose(2, 3)).bfloat16()) for c in caches[:2]]
    q4 = q[:, :, None]
    lms = time_ms([lambda kv=kv: torch.nn.functional.scaled_dot_product_attention(
        q4, kv[0], kv[1], attn_mask=mask, scale=scale) for kv in dq])
    live = int((stops - starts).sum().item())
    # q in, out back; K and V int8 with their bf16 scales over the live
    # window only; the window bounds
    nbytes = q.numel() * 2 * 2 + live * heads * (2 * dh + 2 * 2) + BATCH * 8
    ops = 4 * live * heads * dh
    kernels["B3"].add(b=BATCH, h=heads, h_kv=heads, l_buf=l_buf, dh=dh, live_slots=live,
                      max_abs_err=err, err_over_limit=ratio, ms=kms, plain_ms=pms,
                      library_ms=lms, **bound_of(nbytes, ops))
    # the one-query chunk is the single-query decode: the same kernel body
    one = da.decode_attention_chunk(q[:, None], *caches[0], starts, stops, scale)[:, 0]
    torch.cuda.synchronize()
    if not torch.equal(one, out):
        raise AssertionError("decode_attention_chunk at S = 1 differs from decode_attention")
    del caches, dq
    torch.cuda.empty_cache()

    # B4: an admission chunk (1, 256) at cache index 256 of a 512-token
    # prompt with left padding (window [pad, 512)), and a verify-width
    # chunk S = 32 of 8 rows at per-row cursors
    def chunk_case(b, s_q, starts, stop0):
        cache_bytes = 2 * b * heads * l_buf * dh
        cs = []
        for _ in range(copies_for(cache_bytes)):
            k8, ks = da.quantize_kv(torch.randn(b, l_buf, heads, dh, generator=g, device=dev))
            v8, vs = da.quantize_kv(torch.randn(b, l_buf, heads, dh, generator=g, device=dev))
            cs.append((k8.transpose(1, 2).contiguous(),
                       ks.transpose(1, 2)[:, :, None].bfloat16().contiguous(),
                       v8.transpose(1, 2).contiguous(),
                       vs.transpose(1, 2)[:, :, None].bfloat16().contiguous()))
        qc = torch.randn(b, s_q, heads, dh, generator=g, device=dev).bfloat16()
        k8, ks, v8, vs = cs[0]
        outc = da.decode_attention_chunk(qc, k8, ks, v8, vs, starts, stop0, scale)
        err, ratio = held(f"decode_attention_chunk {b}x{s_q}", outc,
                          da.decode_attention_chunk_plain(qc, k8, ks, v8, vs, starts, stop0, scale),
                          da.decode_attention_chunk_plain(qc, k8, ks, v8.abs(), vs, starts,
                                                          stop0, scale))
        del k8, ks, v8, vs
        kms = time_ms([lambda c=c: da.decode_attention_chunk(qc, *c, starts, stop0, scale)
                       for c in cs])
        pms = time_ms([lambda c=c: da.decode_attention_chunk_plain(qc, *c, starts, stop0, scale)
                       for c in cs[:2]], iters=5, warmup=1)
        slots = torch.arange(l_buf, device=dev)
        qstop = stop0[:, None] + torch.arange(s_q, device=dev)[None]            # (B, S)
        cmask = ((slots[None, None] >= starts[:, None, None])
                 & (slots[None, None] < qstop[..., None]))[:, None]          # (B, 1, S, L)
        dq = [((c[0].float() * c[1].float().transpose(2, 3)).bfloat16(),
               (c[2].float() * c[3].float().transpose(2, 3)).bfloat16()) for c in cs[:2]]
        qt = qc.transpose(1, 2)
        lms = time_ms([lambda kv=kv: torch.nn.functional.scaled_dot_product_attention(
            qt, kv[0], kv[1], attn_mask=cmask, scale=scale) for kv in dq])
        # keys each query attends, summed; the K/V window a row reads once
        pairs = int((qstop - starts[:, None]).clamp_min(0).sum().item())
        window = int((stop0 + s_q - 1 - starts).clamp_min(0).sum().item())
        nbytes = (2 * qc.numel() * 2 + window * heads * (2 * dh + 2 * 2) + b * 8)
        ops = 4 * pairs * heads * dh
        kernels["B4"].add(b=b, s=s_q, h=heads, h_kv=heads, l_buf=l_buf, dh=dh,
                          live_pairs=pairs, window_slots=window, max_abs_err=err,
                          err_over_limit=ratio, ms=kms, plain_ms=pms, library_ms=lms,
                          **bound_of(nbytes, ops))
        del cs, dq
        torch.cuda.empty_cache()

    adm_pad = 100
    chunk_case(1, CHUNK, torch.tensor([adm_pad], dtype=torch.int32, device=dev),
               torch.tensor([CHUNK + 1], dtype=torch.int32, device=dev))
    chunk_case(BATCH, 32, torch.randint(0, 100, (BATCH,), generator=g, device=dev,
                                        dtype=torch.int32),
               torch.randint(PROMPT, PROMPT + NEW - 32, (BATCH,), generator=g, device=dev,
                             dtype=torch.int32))

    # B5: the prefill, causal, left padding as kv_start
    pads = torch.randint(0, PROMPT - 100, (BATCH,), generator=g, device=dev, dtype=torch.int32)
    qkv = [[torch.randn(BATCH, PROMPT, heads, dh, generator=g, device=dev).bfloat16()
            for _ in range(3)] for _ in range(3)]
    fq, fk, fv = qkv[0]
    out, lse = fa.flash_attention_fwd(fq, fk, fv, True, scale, pads)
    hi = torch.full_like(pads, PROMPT)
    ref, ref_lse = fa.flash_attention_plain(fq, fk, fv, True, scale, pads, hi)
    err, ratio = held("flash_attention", out, ref,
                      fa.flash_attention_plain(fq, fk, fv.abs(), True, scale, pads, hi)[0])
    live_rows = ref_lse > -1e29
    lse_err = (lse - ref_lse).abs()[live_rows].max().item()
    if lse_err > 1e-3:
        raise AssertionError(f"flash_attention lse: max error {lse_err} > 1e-3")
    if not bool((out.float().transpose(1, 2)[~live_rows] == 0).all()):
        raise AssertionError("flash_attention: a row with no live key must output 0")
    kms = time_ms([lambda t=t: fa.flash_attention_fwd(t[0], t[1], t[2], True, scale, pads)
                   for t in qkv])
    pms = time_ms([lambda t=t: fa.flash_attention_plain(t[0], t[1], t[2], True, scale, pads, hi)
                   for t in qkv[:2]], iters=5, warmup=1)
    pos = torch.arange(PROMPT, device=dev)
    fmask = ((pos[:, None] >= pos[None, :])[None] & (pos[None, None, :] >= pads[:, None, None]))[:, None]
    tq = [[x.transpose(1, 2).contiguous() for x in t] for t in qkv[:2]]
    lms = time_ms([lambda t=t: torch.nn.functional.scaled_dot_product_attention(
        t[0], t[1], t[2], attn_mask=fmask, scale=scale) for t in tq])
    n_live = (PROMPT - pads).long()
    live_rows_n = int(n_live.sum().item())
    pairs = int((n_live * (n_live + 1) // 2).sum().item())
    # q, k and v of the live rows only (a row before kv_start is never
    # read); the whole output (dead rows are written as 0) and lse; pads
    nbytes = (3 * live_rows_n * heads * dh * 2 + BATCH * PROMPT * heads * dh * 2
              + BATCH * heads * PROMPT * 4 + BATCH * 4)
    ops = 4 * pairs * heads * dh
    kernels["B5"].add(b=BATCH, s=PROMPT, h=heads, dh=dh, live_rows=live_rows_n,
                      live_pairs=pairs, max_abs_err=err, err_over_limit=ratio,
                      lse_err=lse_err, ms=kms, plain_ms=pms, library_ms=lms,
                      **bound_of(nbytes, ops))
    del qkv, tq
    torch.cuda.empty_cache()

    # B6 and B7: B3's and B4's kernel body through a page table.  The page
    # size is the paged engine's (128 slots, 6 pages per 768-slot row);
    # each row's window lives in shuffled physical pages, the table maps
    # NULL (page 0, zeros) past it, and the graveyard page (1) holds
    # non-finite scales that no table entry maps.  Paged must equal the
    # dense kernel on the same bytes laid out densely, bit for bit.
    page_t = 128

    def paginate(cache, last):
        """pages (kq, ks, vq, vs) and a (B, MP) table holding the rows of a
        dense cache up to slot ``last[b]``; the dense cache of those bytes"""
        k8, ks, v8, vs = cache
        b, h_kv, l_b, d = k8.shape
        mp = l_b // page_t
        n_pages = 2 + b * mp
        table = (torch.randperm(n_pages - 2, generator=g, device=dev)[: b * mp] + 2).view(b, mp)
        live = torch.arange(mp, device=dev)[None] * page_t <= last[:, None]
        table = torch.where(live, table, torch.zeros_like(table)).int().contiguous()
        pages = []
        for x in (k8, ks, v8, vs):
            if x.dtype == torch.int8:
                tiles = x.view(b, h_kv, mp, page_t, d).permute(0, 2, 1, 3, 4)
            else:
                tiles = x.view(b, h_kv, 1, mp, page_t).permute(0, 3, 1, 2, 4)
            pg = torch.zeros((n_pages,) + tuple(tiles.shape[2:]), dtype=x.dtype, device=dev)
            pg[table[live].long()] = tiles[live]
            if x.dtype != torch.int8:
                pg[1] = float("nan")
            pages.append(pg)
        dense = tuple(t.contiguous() for t in da.pages_to_dense(*pages, table))
        return tuple(pages), table, dense

    def paged_case(key, twin, qp, cache, starts, stop0):
        """B6 (q (B, H, dh)) or B7 (q (B, S, H, dh)) against B3 / B4 on the
        same bytes (bit for bit) and against its plain version (2^-7 rule)."""
        single = qp.dim() == 3
        b, s_q = qp.shape[0], 1 if single else qp.shape[1]
        pages, table, dense = paginate(cache, stop0 + s_q - 2)
        if single:
            kern, plain, twin_fn = (da.paged_decode_attention, da.paged_decode_attention_plain,
                                    da.decode_attention)
        else:
            kern, plain, twin_fn = (da.paged_decode_attention_chunk,
                                    da.paged_decode_attention_chunk_plain,
                                    da.decode_attention_chunk)
        out = kern(qp, *pages, table, starts, stop0, scale)
        if not torch.equal(out, twin_fn(qp, *dense, starts, stop0, scale)):
            raise AssertionError(f"{kernels[key].name} differs from {twin} on the same bytes")
        if not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"{kernels[key].name}: non-finite output")
        kq, ks, vq, vs = pages
        err, ratio = held(f"{kernels[key].name} {b}x{s_q}", out,
                          plain(qp, kq, ks, vq, vs, table, starts, stop0, scale),
                          plain(qp, kq, ks, vq.abs(), vs, table, starts, stop0, scale))
        copies = [pages] + [tuple(t.clone() for t in pages)
                            for _ in range(copies_for(sum(t.nbytes for t in pages)) - 1)]
        kms = time_ms([lambda c=c: kern(qp, *c, table, starts, stop0, scale) for c in copies])
        pms = time_ms([lambda c=c: plain(qp, *c, table, starts, stop0, scale)
                       for c in copies[:2]], iters=5, warmup=1)
        # yardstick: SDPA on a bf16 copy gathered through the table
        l_b = dense[0].shape[2]
        slots = torch.arange(l_b, device=dev)
        qstop = stop0[:, None] + torch.arange(s_q, device=dev)[None]
        cmask = ((slots[None, None] >= starts[:, None, None])
                 & (slots[None, None] < qstop[..., None]))[:, None]
        dq = ((dense[0].float() * dense[1].float().transpose(2, 3)).bfloat16(),
              (dense[2].float() * dense[3].float().transpose(2, 3)).bfloat16())
        qt = (qp[:, None] if single else qp).transpose(1, 2)
        lms = time_ms([lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, dq[0], dq[1], attn_mask=cmask, scale=scale)])
        pairs = int((qstop - starts[:, None]).clamp_min(0).sum().item())
        window = int((stop0 + s_q - 1 - starts).clamp_min(0).sum().item())
        # q in, out back, the live K/V window and its scales once, the table
        # and the window bounds
        nbytes = (2 * qp.numel() * 2 + window * heads * (2 * dh + 2 * 2) + table.numel() * 4
                  + b * 8)
        kernels[key].add(b=b, s=s_q, h=heads, h_kv=heads, page_tokens=page_t,
                         pages_per_row=table.shape[1], live_pairs=pairs, window_slots=window,
                         max_abs_err=err, err_over_limit=ratio, ms=kms, plain_ms=pms,
                         library_ms=lms, **bound_of(nbytes, 4 * pairs * heads * dh))
        del copies, dq
        torch.cuda.empty_cache()

    def quant_cache(b):
        k8, ks = da.quantize_kv(torch.randn(b, l_buf, heads, dh, generator=g, device=dev))
        v8, vs = da.quantize_kv(torch.randn(b, l_buf, heads, dh, generator=g, device=dev))
        return (k8.transpose(1, 2).contiguous(),
                ks.transpose(1, 2)[:, :, None].bfloat16().contiguous(),
                v8.transpose(1, 2).contiguous(),
                vs.transpose(1, 2)[:, :, None].bfloat16().contiguous())

    # B6 at the decode step's windows (B3's), B7 at the verify width and
    # at the admission chunk (B4's two cases)
    paged_case("B6", "decode_attention", q, quant_cache(BATCH), starts, stops)
    paged_case("B7", "decode_attention_chunk",
               torch.randn(BATCH, 32, heads, dh, generator=g, device=dev).bfloat16(),
               quant_cache(BATCH), torch.randint(0, 100, (BATCH,), generator=g, device=dev,
                                                 dtype=torch.int32),
               torch.randint(PROMPT, PROMPT + NEW - 32, (BATCH,), generator=g, device=dev,
                             dtype=torch.int32))
    paged_case("B7", "decode_attention_chunk",
               torch.randn(1, CHUNK, heads, dh, generator=g, device=dev).bfloat16(),
               quant_cache(1), torch.tensor([adm_pad], dtype=torch.int32, device=dev),
               torch.tensor([CHUNK + 1], dtype=torch.int32, device=dev))

    # B8: one layer's K (or V) gather of the bf16-KV paged engine's decode
    # step: 8 rows x 6 pages of (128, 16, 128) bf16 from a 50-page pool
    n_pool = 2 + BATCH * (l_buf // page_t)
    pool_bytes = n_pool * page_t * heads * dh * 2
    pools = [torch.randn(n_pool, page_t, heads, dh, generator=g, device=dev).bfloat16()
             for _ in range(copies_for(pool_bytes))]
    gtable = (torch.randperm(n_pool - 2, generator=g, device=dev)[: BATCH * (l_buf // page_t)]
              + 2).view(BATCH, -1).int()
    gout = pgm.page_gather(pools[0], gtable)
    torch.cuda.synchronize()
    if not torch.equal(gout, pools[0][gtable.long()]):
        raise AssertionError("page_gather differs from pages[table]")
    kms = time_ms([lambda p=p: pgm.page_gather(p, gtable) for p in pools])
    pms = time_ms([lambda p=p: pgm.page_gather_plain(p, gtable) for p in pools[:2]],
                  iters=5, warmup=1)
    flat_idx = gtable.view(-1).long()
    lms = time_ms([lambda p=p: torch.index_select(p, 0, flat_idx) for p in pools])
    moved = gout.nbytes
    kernels["B8"].add(s=BATCH, mp=gtable.shape[1], page_bytes=pools[0][0].nbytes,
                      max_abs_err=0.0, err_over_limit=0.0, ms=kms, plain_ms=pms,
                      library_ms=lms, **bound_of(2 * moved + gtable.numel() * 4, 0))
    del pools, gout
    torch.cuda.empty_cache()

    # ---- 4. window serve
    log("phase window serve")
    from mlcomp_tpu_torch.io.weights import init_params
    from mlcomp_tpu_torch.models.generation import generate
    from mlcomp_tpu_torch.serve import load_service, make_http_server

    t0 = time.perf_counter()
    params = init_params(CFG, SEED, device=dev)
    service = load_service(
        CFG, params=params, device="cuda", quantize="kernel", batch_sizes=(1, BATCH),
        prompt_buckets=(PROMPT,), max_new_buckets=(NEW,), batch_window_ms=200.0,
        batcher="window",
    )
    torch.cuda.empty_cache()
    model = service.model
    log(f"load_service: {time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    httpd = make_http_server(service, "127.0.0.1", 0, model_name="transformer_lm-1.2b")
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(body):
        req = urllib.request.Request(url + "/generate", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=180) as r:
            if r.status != 200:
                raise AssertionError(f"/generate answered {r.status}")
            return json.loads(r.read())

    vocab = CFG["vocab_size"]
    cpu_rng = torch.Generator().manual_seed(SEED)

    def prompt_of(n):
        return torch.randint(1, vocab, (n,), generator=cpu_rng).tolist()

    lengths = torch.linspace(100, 500, BATCH).long().tolist()
    bodies = [{"prompt": prompt_of(n), "max_new_tokens": NEW, "logprobs": True} for n in lengths]
    bodies += [{"prompt": prompt_of(300), "max_new_tokens": NEW, "logprobs": True,
                "temperature": 0.8, "top_p": 0.95} for _ in range(2)]
    # warm the allocator and the kernel libraries outside the counted run
    post({"prompt": prompt_of(16), "max_new_tokens": 2})
    for k in kernels.values():
        k.reset()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(bodies)) as ex:
        results = list(ex.map(post, bodies))
    wall = time.perf_counter() - t0
    alone = prompt_of(200)
    first = post({"prompt": alone, "max_new_tokens": NEW})
    second = post({"prompt": alone, "max_new_tokens": NEW})
    counts = {key: k.launches for key, k in kernels.items()}
    with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
        health = json.loads(r.read())
    httpd.shutdown()
    httpd.server_close()
    server.join(timeout=10)
    for body, res in zip(bodies, results):
        ids = res["ids"]
        if len(ids) != NEW:
            raise AssertionError(f"expected {NEW} ids, got {len(ids)}")
        if not all(0 <= t < vocab for t in ids):
            raise AssertionError("generated id outside the vocabulary")
        if len(res["logprobs"]) != NEW or max(res["logprobs"]) > 0:
            raise AssertionError("logprobs must be <= 0, one per token")
    if first["ids"] != second["ids"]:
        raise AssertionError("the same greedy prompt gave different tokens")
    if not health.get("ok"):
        raise AssertionError(f"/healthz: {health}")
    log(f"serve: {len(bodies)} concurrent requests in {wall:.2f} s "
        f"(batches {health['batches']}, rows {health['batched_rows']}); "
        f"repeat prompt identical; healthz ok")
    log("launches over the window serve run: " + json.dumps(
        {kernels[key].name: n for key, n in counts.items()}))
    for key in kernels:
        # the window path prefills at cache index 0 only (no chunk kernel)
        # and reads a dense cache (no paged kernel)
        if (counts[key] <= 0) != (key not in dense_keys or key == "B4"):
            raise AssertionError(f"{kernels[key].name}: {counts[key]} launches on the window path")
    window_counts = counts

    # launches and time per prefill / decode step, straight through generate
    prompts = torch.randint(1, vocab, (BATCH, PROMPT), generator=g, device=dev)
    pmask = torch.ones(BATCH, PROMPT, dtype=torch.bool, device=dev)
    for r, n in enumerate(lengths):
        pmask[r, : PROMPT - n] = False

    def run(n_new):
        for k in kernels.values():
            k.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        generate(model, prompts, n_new, prompt_mask=pmask)
        torch.cuda.synchronize()
        return time.perf_counter() - t, {key: k.launches for key, k in kernels.items()}

    run(2)
    pre_s, pre_n = run(1)
    full_s, full_n = run(NEW)
    step_ms = (full_s - pre_s) * 1e3 / (NEW - 1)
    per_step = {key: (full_n[key] - pre_n[key]) / (NEW - 1) for key in kernels}
    log(f"prefill {BATCH}x{PROMPT}: {pre_s * 1e3:.2f} ms; decode {step_ms:.3f} ms/step "
        f"({BATCH * 1e3 / step_ms:.1f} tok/s at B={BATCH}); end to end "
        f"{BATCH * NEW / full_s:.1f} tok/s for {BATCH}x{NEW} tokens")
    log("launches per prefill: " + json.dumps(pre_n) + "; per decode step: " + json.dumps(per_step))
    # the summary below weighs each kernel shape's time by its calls in one
    # step or prefill: those call counts must be the ones just measured
    expected = {("B1", "step"): sum(b1_step.values()), ("B2", "step"): sum(b2_step.values()),
                ("B1", "prefill"): sum(b1_prefill.values())}
    measured = {("B1", "step"): per_step["B1"], ("B2", "step"): per_step["B2"],
                ("B1", "prefill"): pre_n["B1"]}
    if measured != expected:
        raise AssertionError(f"launches per step/prefill {measured} differ from the shape "
                             f"decomposition {expected}")

    # ---- 5. window parity: kernels vs their plain versions on the 1.2B model
    log("phase window parity")
    import mlcomp_tpu_torch.models.transformer as tr
    import mlcomp_tpu_torch.ops.attention as at
    import mlcomp_tpu_torch.ops.quant as oq

    @contextmanager
    def plain_kernels():
        """Route the model's kernel call sites to the plain versions (on the
        card's tensors), for the comparison only."""
        saved = (oq.quant_matmul, tr.decode_attention, tr.decode_attention_chunk,
                 at.flash_attention)

        def qmm(x, q8, sc, norm_scale=None, norm_eps=1e-6):
            return qm.quant_matmul_plain(x, q8, sc, norm_scale, norm_eps)

        def dec(q, k8, ks, v8, vs, kv_start=None, kv_stop=None, scale=None):
            b, l_b = q.shape[0], k8.shape[2]
            return da.decode_attention_plain(
                q, k8, ks, v8, vs, da._rows(kv_start, b, 0, q.device),
                da._rows(kv_stop, b, l_b, q.device), scale)

        def chunk(q, k8, ks, v8, vs, kv_start=None, kv_stop0=None, scale=None):
            b, s_q, l_b = q.shape[0], q.shape[1], k8.shape[2]
            return da.decode_attention_chunk_plain(
                q, k8, ks, v8, vs, da._rows(kv_start, b, 0, q.device),
                da._rows(kv_stop0, b, l_b - s_q + 1, q.device), scale)

        def fl(q, k, v, causal=False, scale=None, kv_start=None, kv_stop=None):
            b, s_k = q.shape[0], k.shape[1]
            return fa.flash_attention_plain(
                q, k, v, causal, scale if scale is not None else q.shape[-1] ** -0.5,
                fa._window(kv_start, b, 0, q.device), fa._window(kv_stop, b, s_k, q.device))[0]

        (oq.quant_matmul, tr.decode_attention, tr.decode_attention_chunk,
         at.flash_attention) = qmm, dec, chunk, fl
        try:
            yield
        finally:
            (oq.quant_matmul, tr.decode_attention, tr.decode_attention_chunk,
             at.flash_attention) = saved

    def compare(what, run_fn):
        """Logits with the kernels against logits with the plain versions.
        Tolerance: every bf16 activation may differ by one rounding between
        the two (f32 sums in other orders), and 16 layers carry that along;
        5% of the logit range is far below what a wrong kernel produces."""
        lk = run_fn()
        with plain_kernels():
            lp = run_fn()
        if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
            raise AssertionError(f"{what}: non-finite logits")
        dlog = (lk - lp).abs().max().item()
        mag = lp.abs().max().item()
        agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
        log(f"parity, {what}: max |logit(kernels) - logit(plain)| {dlog:.4f} "
            f"(max |logit| {mag:.3f}); greedy-token agreement {agree:.3f}")
        if dlog > 0.05 * mag:
            raise AssertionError(f"parity, {what}: logits differ by {dlog} > 0.05 x {mag}")
        return dlog, agree

    forced = torch.randint(1, vocab, (BATCH, 8), generator=g, device=dev)

    @torch.inference_mode()
    def teacher_forced():
        cache = model.init_cache(BATCH, PROMPT + 8)
        positions = torch.clamp(torch.cumsum(pmask.int(), 1) - 1, min=0)
        kv_mask = torch.cat([pmask, torch.ones(BATCH, 8, dtype=torch.bool, device=dev)], 1)
        outs = [model(prompts, positions=positions, cache=cache, kv_mask=kv_mask,
                      last_only=True)[:, -1]]
        pos = pmask.sum(1)
        for j in range(8):
            outs.append(model(forced[:, j: j + 1], positions=(pos + j)[:, None], cache=cache,
                              kv_mask=kv_mask, last_only=True)[:, -1])
        return torch.stack(outs, 1)

    dlog, agree = compare("window prefill + 8 decode steps", teacher_forced)
    service.close()
    del service
    torch.cuda.empty_cache()

    # ---- 6. engine serve: the default continuous batcher, the main path
    log("phase engine serve")
    t0 = time.perf_counter()
    service = load_service(
        CFG, params=params, device="cuda", quantize="kernel", batch_sizes=(1, BATCH),
        prompt_buckets=(PROMPT,), max_new_buckets=(NEW,), prefill_chunk=CHUNK,
    )
    torch.cuda.empty_cache()
    model = service.model
    eng = service.engine
    if service.batcher != "continuous" or not eng.adaptive_k or eng.pipeline_depth != 2 \
            or not eng.fused_admission:
        raise AssertionError(f"the default service is not the continuous engine: "
                             f"{service.stats()}")
    log(f"load_service (continuous): {time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated; engine cache L = "
        f"{da.pick_buffer_len(eng.l_buf, heads, dh)} for {eng.l_buf} slots")

    def sse(body):
        """POST a streaming request; (events, seconds from sending it to the
        first token event, and to the last token event)."""
        req = urllib.request.Request(url + "/generate",
                                     data=json.dumps({**body, "stream": True}).encode(),
                                     headers={"Content-Type": "application/json"})
        t = time.perf_counter()
        events, stamps = [], []
        with urllib.request.urlopen(req, timeout=180) as r:
            for line in r:
                if line.startswith(b"data: "):
                    events.append(json.loads(line[len(b"data: "):]))
                    stamps.append(time.perf_counter() - t)
        if len(stamps) < 2:
            raise AssertionError(f"SSE stream without tokens: {events}")
        return events, stamps[0], stamps[-2]

    def streamed(events, n_new):
        """The final result of an SSE stream, after checking that its token
        events come in step order and spell its ids."""
        *tokens, done = events
        if not done.get("done") or [e["token"] for e in tokens] != done["ids"] or \
                len(done["ids"]) != n_new:
            raise AssertionError(f"SSE stream out of order or incomplete: {done}")
        if [e["step"] for e in tokens] != sorted(e["step"] for e in tokens):
            raise AssertionError("SSE steps out of order")
        return done

    def pct(xs, q):
        return torch.quantile(torch.tensor(xs, dtype=torch.float64), q).item()

    # prompts of 100-500 tokens in the 512 bucket with chunks of 256: below
    # 256 the only chunk runs at cache index 256 (B4 only); above it the
    # first chunk runs at index 0 (B5) and the second at 256 (B4).  Every
    # request streams, so that the client stamps its own time to first
    # token under this load.  The paged engine phase replays them.
    lengths = torch.linspace(100, 500, 10).long().tolist() + [300]
    bodies = [{"prompt": prompt_of(n), "max_new_tokens": NEW, "logprobs": True}
              for n in lengths]
    for b in bodies[1::4]:
        b.update(temperature=0.8, top_p=0.95)
    alone, lone_prompt, warm = prompt_of(200), prompt_of(400), prompt_of(16)
    steady_prompts = [prompt_of(100) for _ in range(BATCH)]

    class Tap:
        def __init__(self, i, sink):
            self.i, self.sink = i, sink

        def put(self, item):
            self.sink.put((self.i, time.perf_counter(), item))

    def engine_serve(service, label):
        """The engine's HTTP run: the concurrent SSE requests, a repeated
        greedy prompt, a lone SSE request; launch counts over that run;
        then decode ms per step with all 8 slots live.  Returns what it
        measured."""
        nonlocal url
        eng = service.engine
        httpd = make_http_server(service, "127.0.0.1", 0, model_name="transformer_lm-1.2b")
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        post({"prompt": warm, "max_new_tokens": 2})   # warm the allocator
        for k in kernels.values():
            k.reset()
        st0 = eng.stats()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(bodies)) as ex:
            streams = list(ex.map(sse, bodies))
        wall = time.perf_counter() - t0
        st_mid = eng.stats()
        first = post({"prompt": alone, "max_new_tokens": NEW})
        second = post({"prompt": alone, "max_new_tokens": NEW})
        lone_events, ttft_lone, _ = sse({"prompt": lone_prompt, "max_new_tokens": 16})
        counts = {key: k.launches for key, k in kernels.items()}
        st1 = eng.stats()
        ids = []
        for events, _, _ in streams:
            res = streamed(events, NEW)
            ids.append(res["ids"])
            if not all(0 <= t < vocab for t in res["ids"]):
                raise AssertionError(f"expected {NEW} ids in the vocabulary, got {res['ids']}")
            if len(res["logprobs"]) != NEW or max(res["logprobs"]) > 0:
                raise AssertionError("logprobs must be <= 0, one per token")
        streamed(lone_events, 16)
        ttft = [f * 1e3 for _, f, _ in streams]
        per_tok = [(t_last - f) * 1e3 / (NEW - 1) for _, f, t_last in streams]
        ttft_ms = {"p50": pct(ttft, 0.5), "p95": pct(ttft, 0.95), "max": max(ttft)}
        per_token_ms = {"p50": pct(per_tok, 0.5), "p95": pct(per_tok, 0.95)}
        if first["ids"] != second["ids"]:
            raise AssertionError(f"{label}: the same greedy prompt gave different tokens")
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if not (health.get("ok") and health.get("ready")):
            raise AssertionError(f"/healthz: {health}")
        log(f"launches over the {label} serve run: " + json.dumps(
            {kernels[key].name: n for key, n in counts.items()}))
        emitted = st_mid["emitted_tokens"] - st0["emitted_tokens"]
        k_used = {k: n - st0["dispatches_by_k"].get(k, 0)
                  for k, n in st_mid["dispatches_by_k"].items()}
        # decode steps issued over the counted run: each runs every layer once
        steps_issued = sum(k * (n - st0["dispatches_by_k"].get(k, 0))
                           for k, n in st1["dispatches_by_k"].items())
        log(f"{label} serve: {len(bodies)} concurrent SSE requests (100-500 prompt tokens, "
            f"3 sampled) in {wall:.2f} s, {emitted} tokens ({emitted / wall:.1f} tok/s); "
            f"client TTFT over these {len(bodies)}: p50 {ttft_ms['p50']:.1f} ms, p95 "
            f"{ttft_ms['p95']:.1f} ms (sorted: {[round(x, 1) for x in sorted(ttft)]}); lone "
            f"SSE TTFT {ttft_lone * 1e3:.1f} ms; per-token p50 {per_token_ms['p50']:.3f} ms; "
            f"K rungs used (dispatches per K): {json.dumps(k_used)}; repeat prompt "
            f"identical; healthz ok and ready")

        # an elastic engine shrinks back to its floor at an idle boundary: let
        # it, so that the steady run below decodes 8 rows
        t_idle = time.perf_counter()
        while len(eng._host) != eng.slots and time.perf_counter() - t_idle < 10:
            time.sleep(0.05)
        # decode ms per step with all 8 slots live: 8 requests of 100 prompt
        # tokens, each streaming into a tap that stamps the host time the
        # engine hands it a token (at a dispatch readback).  The window runs
        # from the readback that gives the last of them its first token to
        # the readback that gives one of them its last; the consumer blocks
        # in queue.get, so it takes no interpreter time from the engine loop
        sink: "queue.Queue" = queue.Queue()
        futs8 = [service.submit(p, NEW, stream=Tap(i, sink))
                 for i, p in enumerate(steady_prompts)]
        seen: dict = {}
        ended = 0
        while ended < BATCH:
            i, t, item = sink.get(timeout=180)
            if item is None:
                ended += 1
            else:
                seen.setdefault(i, []).append((t, item["step"]))
        for f in futs8:
            f.result(timeout=180)
        t_a, s_a = max(ev[0] for ev in seen.values())       # the last first token
        t_b, s_b = min(ev[-1] for ev in seen.values())      # the first last token
        if len(seen) != BATCH or s_b <= s_a:
            raise AssertionError(f"no window with all {BATCH} slots decoding: {s_a}, {s_b}")
        steady_ms = (t_b - t_a) * 1e3 / (s_b - s_a)
        log(f"{label} decode at {BATCH} live slots: {steady_ms:.3f} ms/step "
            f"({BATCH * 1e3 / steady_ms:.1f} tok/s; {s_b - s_a} steps in "
            f"{(t_b - t_a) * 1e3:.1f} ms, K {eng.stats()['k_ladder']} ladder)")
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=10)
        return dict(wall=wall, emitted=emitted, ttft_ms=ttft_ms, per_token_ms=per_token_ms,
                    ttft_lone=ttft_lone, steady_ms=steady_ms, k_used=k_used, counts=counts,
                    st0=st0, st1=st1, ids=ids, first=first["ids"], steps_issued=steps_issued)

    dense_run = engine_serve(service, "engine")
    counts = dense_run["counts"]
    for key in kernels:
        if (counts[key] <= 0) != (key not in dense_keys):
            raise AssertionError(f"{kernels[key].name}: {counts[key]} launches on the dense "
                                 "engine path")
    wall, emitted, ttft_ms = dense_run["wall"], dense_run["emitted"], dense_run["ttft_ms"]
    per_token_ms, ttft_lone = dense_run["per_token_ms"], dense_run["ttft_lone"]
    steady_ms, k_used = dense_run["steady_ms"], dense_run["k_used"]
    st0, st1 = dense_run["st0"], dense_run["st1"]

    # ---- 7. engine parity: an admission chunk at index 256, 8 per-row-cursor steps
    log("phase engine parity")
    chunk_ids = torch.randint(1, vocab, (1, PROMPT), generator=g, device=dev)
    chunk_pos = torch.clamp(torch.arange(PROMPT, device=dev) - adm_pad, min=0)[None]
    chunk_start = torch.tensor([adm_pad], dtype=torch.int32, device=dev)

    @torch.inference_mode()
    def admission_chunk():
        cache = model.init_cache(1, eng.l_buf)
        model(chunk_ids[:, :CHUNK], positions=chunk_pos[:, :CHUNK], cache=cache,
              last_only=True, kv_start=chunk_start)
        return model(chunk_ids[:, CHUNK:], positions=chunk_pos[:, CHUNK:], cache=cache,
                     kv_start=chunk_start)

    starts8 = PROMPT - pmask.sum(1).int()
    cur0 = (PROMPT - torch.arange(BATCH, device=dev)).int()   # row r rewrites its last r slots
    pos0 = pmask.sum(1) - torch.arange(BATCH, device=dev)

    @torch.inference_mode()
    def cursor_steps():
        cache = model.init_cache(BATCH, eng.l_buf)
        positions = torch.clamp(torch.cumsum(pmask.int(), 1) - 1, min=0)
        model(prompts, positions=positions, cache=cache, kv_start=starts8, last_only=True)
        outs = []
        for j in range(8):
            outs.append(model(forced[:, j: j + 1], positions=(pos0 + j)[:, None], cache=cache,
                              kv_start=starts8, cache_cursor=cur0 + j, last_only=True)[:, -1])
        return torch.stack(outs, 1)

    chunk_dlog, chunk_agree = compare("admission chunk (1, 256) at cache index 256",
                                      admission_chunk)
    cur_dlog, cur_agree = compare("8 per-row-cursor decode steps", cursor_steps)

    # one admission chunk as the engine runs it (last_only), kernels on: its
    # launches per kernel, and its wall on the card (host clock around
    # synchronized runs of the chunk at index 256)
    @torch.inference_mode()
    def chunk_ms(reps=5):
        cache = model.init_cache(1, eng.l_buf)
        model(chunk_ids[:, :CHUNK], positions=chunk_pos[:, :CHUNK], cache=cache,
              last_only=True, kv_start=chunk_start)
        walls, launched = [], None
        for _ in range(reps):
            cache.index = CHUNK
            for k in kernels.values():
                k.reset()
            torch.cuda.synchronize()
            t = time.perf_counter()
            model(chunk_ids[:, CHUNK:], positions=chunk_pos[:, CHUNK:], cache=cache,
                  last_only=True, kv_start=chunk_start)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
            launched = launched or {key: k.launches for key, k in kernels.items()}
        return min(walls), launched

    adm_chunk_ms, per_chunk = chunk_ms()
    # the summary weighs the B1, B2 and B4 shapes by these calls
    expected = {"B1": sum(b1_prefill.values()), "B2": 1, "B3": 0, "B4": layers, "B5": 0,
                "B6": 0, "B7": 0, "B8": 0}
    if per_chunk != expected:
        raise AssertionError(f"launches per admission chunk {per_chunk}, expected {expected}")
    share = {"B1": total(by_shape("B1", b1_prefill, CHUNK))["ms"],
             "B2": total(by_shape("B2", {(hidden, vocab): 1}, 1))["ms"],
             "B4": kernels["B4"].rows[0]["ms"] * per_chunk["B4"]}
    b4_chunk_ms = share["B4"]
    log(f"admission chunk (1, 256) at index 256: {adm_chunk_ms:.3f} ms wall (best of 5); "
        f"of it, in ms: " + ", ".join(f"{key} {v:.3f} ({100 * v / adm_chunk_ms:.1f}%)"
                                      for key, v in share.items()))
    service.close()

    del service, model, eng
    torch.cuda.empty_cache()

    # ---- 8. paged engine serve: --kv-layout paged, the same model and traffic
    log("phase paged engine serve")
    from mlcomp_tpu_torch.engine import DecodeEngine

    t0 = time.perf_counter()
    engine_kw = dict(prompt_buckets=(PROMPT,), max_new_cap=NEW, prefill_chunk=CHUNK,
                     steps_per_dispatch="adaptive")
    serve_kw = dict(params=params, device="cuda", quantize="kernel", batch_sizes=(1, BATCH),
                    prompt_buckets=(PROMPT,), max_new_buckets=(NEW,), prefill_chunk=CHUNK)
    # the CLI's default buckets give 128-slot pages; this single bucket would
    # give 256, so the page size is passed as the CLI user passes it
    pservice = load_service(CFG, kv_layout="paged", kv_page_tokens=page_t, **serve_kw)
    peng = pservice.engine
    pool0 = peng.stats()["kv_pool"]
    if (peng.kv_layout != "paged" or peng.max_slots != 4 * BATCH
            or pool0["page_tokens"] != page_t
            or pool0["max_pages_per_slot"] != da.pick_buffer_len(peng.l_buf, heads, dh) // page_t):
        raise AssertionError(f"not the paged engine asked for: {peng.stats()}")
    log(f"load_service (paged): {time.perf_counter() - t0:.2f} s; {pool0['pages_total']} pages "
        f"of {pool0['page_bytes']} bytes (+2 reserved), {pool0['max_pages_per_slot']} per row; "
        f"max_slots {peng.max_slots}")
    paged_run = engine_serve(pservice, "paged engine")
    pcounts = paged_run["counts"]
    for key in kernels:
        if (pcounts[key] > 0) != (key not in ("B3", "B7", "B8")):
            raise AssertionError(f"{kernels[key].name}: {pcounts[key]} launches on the paged "
                                 "engine path (B6 must replace B3 in every decode step)")
    if pcounts["B6"] != layers * paged_run["steps_issued"]:
        raise AssertionError(f"B6 launched {pcounts['B6']} times for "
                             f"{paged_run['steps_issued']} decode steps of {layers} layers")
    pst = peng.stats()
    ppool = pst["kv_pool"]
    elastic = {"slots_scaled": pst["slots_scaled"], "peak_live_slots": pst["peak_live_slots"],
               "live_slots_after": pst["live_slots"], "max_slots": pst["max_slots"]}
    log(f"paged engine: peak pages used {ppool['peak_pages_used']} of {ppool['pages_total']}; "
        f"pages allocated lazily {pst['kv_pages_lazy_allocated']}; decode page failures "
        f"{pst['kv_decode_page_failures']}; elastic slots {json.dumps(elastic)}")
    pservice.close()

    # greedy tokens against the dense engine's on the same requests, in a run
    # that keeps the slot count (and so every kernel's row count) at 8
    eq = DecodeEngine(pservice.model, slots=BATCH, kv_layout="paged", kv_page_tokens=page_t,
                      max_slots=BATCH, **engine_kw)
    try:
        futs = [eq.submit(b["prompt"], NEW, temperature=b.get("temperature", 0.0),
                          top_p=b.get("top_p")) for b in bodies]
        futs.append(eq.submit(alone, NEW))
        eq_ids = [f.result(timeout=300)["ids"] for f in futs]
        if eq.stats()["peak_live_slots"] != BATCH:
            raise AssertionError("the equality run changed its slot count")
    finally:
        eq.close()
    greedy = [i for i, b in enumerate(bodies) if "temperature" not in b]
    want = [dense_run["ids"][i] for i in greedy] + [dense_run["first"]]
    got = [eq_ids[i] for i in greedy] + [eq_ids[-1]]
    if got != want:
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        raise AssertionError(f"paged greedy tokens differ from the dense engine's in "
                             f"requests {bad}")
    sampled_equal = sum(eq_ids[i] == dense_run["ids"][i] for i in range(len(bodies))
                        if i not in greedy)
    elastic_equal = sum(paged_run["ids"][i] == dense_run["ids"][i] for i in greedy)
    log(f"paged == dense: {len(got)} greedy requests equal at 8 slots (sampled, keyed by "
        f"request ids that differ between the runs: {sampled_equal} of "
        f"{len(bodies) - len(greedy)} equal); in the elastic run {elastic_equal} of "
        f"{len(greedy)} greedy requests equal the dense engine's")
    del pservice, peng, eq
    torch.cuda.empty_cache()

    # ---- 9. bf16-KV paged engine: each layer's K and V gathered through B8
    log("phase bf16-KV paged engine")
    cfg16 = {**CFG, "kv_quant": False}
    svc16 = load_service(cfg16, kv_layout="paged", kv_page_tokens=page_t, max_slots=BATCH,
                         **serve_kw)
    dense16 = DecodeEngine(svc16.model, slots=BATCH, **engine_kw)
    few = [bodies[i]["prompt"] for i in greedy[:4]]
    n16 = 32
    try:
        svc16.generate(warm, 2)
        for k in kernels.values():
            k.reset()
        s16_0 = svc16.engine.stats()
        t0 = time.perf_counter()
        ids16 = [f.result(timeout=300)["ids"] for f in [svc16.submit(p, n16) for p in few]]
        wall16 = time.perf_counter() - t0
        counts16 = {key: k.launches for key, k in kernels.items()}
        s16_1 = svc16.engine.stats()
        dense_ids16 = [f.result(timeout=300)["ids"]
                       for f in [dense16.submit(p, n16) for p in few]]
    finally:
        dense16.close()
        svc16.close()
    steps16 = sum(k * (n - s16_0["dispatches_by_k"].get(k, 0))
                  for k, n in s16_1["dispatches_by_k"].items())
    if counts16["B8"] != 2 * layers * steps16 or counts16["B8"] <= 0:
        raise AssertionError(f"B8 launched {counts16['B8']} times for {steps16} decode steps")
    if counts16["B3"] or counts16["B6"]:
        raise AssertionError(f"an int8-KV kernel ran on the bf16-KV path: {counts16}")
    if ids16 != dense_ids16:
        raise AssertionError("bf16-KV paged tokens differ from the dense bf16-KV engine's")
    log(f"bf16-KV paged engine: {len(few)} greedy requests of {n16} tokens in {wall16:.2f} s, "
        f"equal to the dense bf16-KV engine's; launches {json.dumps(counts16)}")
    del svc16, dense16
    torch.cuda.empty_cache()

    # ---- 10. summary
    # each kernel's work in one decode step at B=8 (B1, B2, B3), in one
    # 8x512 prefill (B5) or in one admission chunk at index 256 (B4); B1's
    # prefill share rides along under "prefill"
    scopes = {
        "B1": ("decode step: out and down of every layer", by_shape("B1", b1_step, BATCH)),
        "B2": ("decode step: qkv and gate_up of every layer, lm_head",
               by_shape("B2", b2_step, BATCH)),
        "B3": ("decode step: every layer", [(kernels["B3"].rows[0], per_step["B3"])]),
        "B4": ("admission chunk (1, 256) at cache index 256: every layer",
               [(kernels["B4"].rows[0], per_chunk["B4"])]),
        "B5": ("prefill 8x512: every layer", [(kernels["B5"].rows[0], pre_n["B5"])]),
        "B6": ("paged decode step: every layer", [(kernels["B6"].rows[0], layers)]),
        "B7": ("8 rows x 32 queries through the table, one call (the paged verify shape; "
               "served with speculation, not yet)", [(kernels["B7"].rows[0], 1)]),
        "B8": ("bf16-KV paged decode step: K and V of every layer",
               [(kernels["B8"].rows[0], 2 * layers)]),
    }
    # each kernel's launches over its own path's run
    path_counts = {**{key: counts[key] for key in dense_keys},
                   "B6": pcounts["B6"], "B7": pcounts["B7"], "B8": counts16["B8"]}
    paths = {**{key: "dense engine serve" for key in dense_keys},
             "B6": "paged engine serve", "B7": "paged engine serve",
             "B8": "bf16-KV paged engine"}
    entries = []
    for key, (label, weighted) in scopes.items():
        k = kernels[key]
        entry = {
            "name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "launches": path_counts[key], "path": paths[key],
            "launches_window_path": window_counts[key],
            "max_abs_err": max(r["max_abs_err"] for r in k.rows),
            "err_over_limit": max(r["err_over_limit"] for r in k.rows),
            "scope": label, **total(weighted),
        }
        if key == "B1":
            entry["prefill"] = {"scope": "prefill 8x512: all four projections of every layer",
                                **total(by_shape("B1", b1_prefill, BATCH * PROMPT))}
            entry["admission_chunk"] = {
                "scope": "admission chunk (1, 256): all four projections of every layer",
                **total(by_shape("B1", b1_prefill, CHUNK))}
        if key == "B2":
            entry["admission_chunk"] = {"scope": "admission chunk (1, 256): last_only lm_head",
                                        **total(by_shape("B2", {(hidden, vocab): 1}, 1))}
        if key == "B4":
            entry["verify_width"] = {"scope": "8 rows x 32 queries, one call",
                                     **total([(kernels["B4"].rows[1], 1)])}
        if key == "B7":
            entry["admission_shape"] = {"scope": "(1, 256) chunk at cache index 256, one call",
                                        **total([(kernels["B7"].rows[1], 1)])}
        entries.append(entry)
    log(json.dumps({"serve": {
        "prefill_ms": pre_s * 1e3, "decode_ms_per_step": step_ms,
        "decode_tok_s": BATCH * 1e3 / step_ms, "e2e_tok_s": BATCH * NEW / full_s,
        "launches_per_decode_step": per_step, "launches_per_prefill": pre_n,
        "parity_max_abs_logit_err": dlog, "greedy_agreement": agree, "card": smi}}))
    log(json.dumps({"engine": {
        "requests": len(bodies), "wall_s": wall, "emitted_tokens": emitted,
        "tok_s": emitted / wall, "ttft_ms_loaded": ttft_ms, "per_token_ms_loaded": per_token_ms,
        "lone_sse_ttft_ms": ttft_lone * 1e3, "decode_ms_per_step_8_slots": steady_ms,
        "decode_tok_s_8_slots": BATCH * 1e3 / steady_ms, "k_rungs_used": k_used,
        "fused_chunks": st1["fused_chunks"] - st0["fused_chunks"],
        "prefill_chunks": st1["prefill_chunks"] - st0["prefill_chunks"],
        "pipeline": st1["pipeline"], "launches": counts,
        "b4_launches_per_admission_chunk": per_chunk["B4"],
        "admission_chunk_ms": adm_chunk_ms, "b4_ms_per_admission_chunk": b4_chunk_ms,
        "admission_chunk_kernel_ms": share, "launches_per_admission_chunk": per_chunk,
        "parity_chunk_max_abs_logit_err": chunk_dlog, "parity_chunk_agreement": chunk_agree,
        "parity_cursor_max_abs_logit_err": cur_dlog, "parity_cursor_agreement": cur_agree,
        "card": smi}}))
    prun = paged_run
    log(json.dumps({"paged_engine": {
        "requests": len(bodies), "wall_s": prun["wall"], "emitted_tokens": prun["emitted"],
        "tok_s": prun["emitted"] / prun["wall"], "ttft_ms_loaded": prun["ttft_ms"],
        "per_token_ms_loaded": prun["per_token_ms"], "lone_sse_ttft_ms": prun["ttft_lone"] * 1e3,
        "decode_ms_per_step_8_slots": prun["steady_ms"],
        "decode_tok_s_8_slots": BATCH * 1e3 / prun["steady_ms"], "k_rungs_used": prun["k_used"],
        "launches": pcounts, "peak_pages_used": ppool["peak_pages_used"],
        "pages_total": ppool["pages_total"], "page_bytes": ppool["page_bytes"],
        "kv_pages_lazy_allocated": pst["kv_pages_lazy_allocated"],
        "kv_decode_page_failures": pst["kv_decode_page_failures"], "elastic": elastic,
        "greedy_equal_dense_at_8_slots": len(got), "elastic_greedy_equal_dense": elastic_equal,
        "dense_engine_same_call": {"decode_ms_per_step_8_slots": steady_ms,
                                   "tok_s": emitted / wall, "ttft_ms_loaded": ttft_ms,
                                   "lone_sse_ttft_ms": ttft_lone * 1e3},
        "bf16_kv": {"requests": len(few), "new_tokens": n16, "wall_s": wall16,
                    "launches": counts16, "equal_dense": True},
        "card": smi}}))
    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
