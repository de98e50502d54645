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
   the card's bound for the same work.  Every time is a median over five
   windows of CUDA events, with its fastest and slowest window beside it.
   The int8 matmul (B1, and B2 with its RMSNorm prologue) must give the
   same bits on a second run at every shape and prints its grid: the
   decode path (64 rows or fewer, one launch of the tensor-core kernel)
   its ``gemv_plan`` cluster and CTAs, at the decode step's shapes at 8
   rows, the admission chunk's 1-row lm_head, 32 and 64 rows at every
   decode shape, ragged 3, 13 and 57 rows and an f32 x for the norm; the
   tiled path (more than 64 rows) its CTAs and D splits, also at ragged
   row counts.  Their device times from torch.profiler, and one profiled
   decode step of the engine's model (which fails if it holds a
   qmm_reduce_kernel), are taken after the train phase (11), where the
   profiler cannot touch the serving phases' host timings.  The
   single-query decode (B3, and B6 through a page table: the split body,
   each window over a thread-block cluster) is held at the decode step
   (8 rows), one lone request (a 460-slot window), GQA 16 on 4, head dim
   256, the paged engine's 32 live slots and windows inside cluster
   shares with one row empty: each prints its ``chunk_plan`` (cluster,
   CTAs), must give the same bits on a rerun, B6 must equal B3 and a
   one-query chunk B3 bit for bit.  The chunk decode (B4, and B7 through a page
   table) is held at the admission chunk (1, 256), the 8 x 32 verify
   width, a GQA chunk at a ragged S, head dim 256, and windows that start
   mid-block with one row's window empty: each prints the route its
   ``chunk_plan`` picks, must give the same bits on a rerun, and B7 must
   equal B4 bit for bit.  The page gather (B8) must equal pages[table] on
   a bf16 K leaf, an int8 code leaf and a bf16 scale leaf.  The device
   times (torch.profiler) of B3, B4, B6, B7 and B8 and of their library
   calls come after the train phase too.
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
   SSE stream, a repeated greedy prompt; every kernel must launch, every
   chunk launch must take the tensor-core body and every single-query
   launch the split body; TTFT,
   decode ms per step at 8 live slots, tok/s and the K rungs used.  Lone
   TTFT and decode ms per step are medians over three requests or runs,
   each with its spread and the host's load average.
7. engine parity: a (1, 256) admission chunk at cache index 256 and 8
   per-row-cursor decode steps, kernels against plain versions.
8. paged engine serve (``kv_layout="paged"``) and 9. the bf16-KV paged
   engine.
10. train: configs/multihost_lm.yml's 1.2B transformer_lm (hidden 2048, 16
   layers, vocab 32000, bf16, adafactor with warmup_cosine) through
   ``mlcomp_tpu_torch.cli dag``, in-process, cut to one card (2 sequences
   of 4096 tokens per step, 6 steps); the flash forward and the backward
   kernels must launch 16 times per step; ms per step, tok/s, MFU and
   peak memory.
11. train parity: one step's loss and gradient norm with the kernels and
   with their plain versions; one profiled step (device time by kernel);
   then the kernels' torch.profiler device times (B1-B4, B6-B8) and one
   profiled decode step of the dense engine's model and the same step
   through pages: each must run its attention as 16 launches of the split
   body (no launch of the old ``attend_kernel``), and the paged step's
   logits must equal the dense step's bit for bit.
12. summary: ``serve``, ``engine``, ``paged_engine``, ``train`` and
   ``kernels`` JSON lines, then, last, the device line.

The kernel phase (3) also holds the flash-attention backward (B9-B11), and
the forward (B5) whose (out, lse) it takes, at the training shape, a GQA
shape, BERT finetune's shape, a windowed shape and a ragged GQA shape; at
each, a second forward and backward on the same inputs must give the same
bits.  Before it, three lines give each flash kernel's, the int8
matmul's (tiled path, split pass, decode kernel) and the two decode
bodies' registers, shared memory, spills and CTAs per SM.
"""

from __future__ import annotations

import gc
import json
import math
import os
import queue
import re
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

import torch

CFG = {
    "name": "transformer_lm", "vocab_size": 32768, "hidden": 2048, "layers": 16,
    "heads": 16, "mlp_dim": 8192, "dtype": "bfloat16",
    "decode_fused": True, "kv_quant": True,
}
SEED = 0
BATCH, PROMPT, NEW, CHUNK = 8, 512, 128, 256
# the engine phases' repeats: lone SSE requests for TTFT, and runs of 8
# live slots for decode ms per step (each reported as a median)
LONE_REPEATS, STEADY_WINDOWS = 3, 3
# the train phase: one card's share of configs/multihost_lm.yml's batch
# (16 sequences over dp 8), and the steps after the first that it times
TRAIN_BATCH, TRAIN_STEPS = 2, 5

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


class Ms(float):
    """A time in ms: the median over windows, with the fastest and the
    slowest window as ``spread``."""
    spread = (0.0, 0.0)


def time_ms(fns, iters=20, warmup=3, windows=5) -> Ms:
    """Device time of one call, cycling through ``fns`` (copies of the
    operands, so that the weights come from device memory, not L2): CUDA
    events around each of ``windows`` windows of ``iters`` calls; the
    median window, with its spread."""
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(windows + 1)]
    marks[0].record()
    for w in range(windows):
        for i in range(iters):
            fns[(w * iters + i) % len(fns)]()
        marks[w + 1].record()
    torch.cuda.synchronize()
    per = sorted(a.elapsed_time(b) / iters for a, b in zip(marks, marks[1:]))
    out = Ms(per[len(per) // 2])
    out.spread = (per[0], per[-1])
    return out


def copies_for(nbytes: int) -> int:
    return max(2, math.ceil(160e6 / max(nbytes, 1)))


# the flash kernels' case labels: rows are picked by these, not by position
PREFILL_CASE = "prefill 8x512, causal, left padding"
CASE_A = "(a) LM training 2x4096, causal"
CASE_B = "(b) BERT finetune 32x128, 12 heads of 64, key padding"
CASE_C = "(c) GQA 2x4096, 16 q heads on 4 kv heads, causal"
CASE_D = "(d) 4x2048 key-padding windows, non-causal"
CASE_E = "(e) ragged 3x1000, 16 q heads on 8 kv heads, causal, left padding"
TRAIN_B5_CASE = "training shape " + CASE_A

# the TPU grid of each backward row: B9 _flash_bwd's rectangular grid,
# B10 _flash_bwd_tri, B11 _flash_bwd_bsched
GRID_KEYS = {"rect": "B9", "tri": "B10", "bsched": "B11"}


def bwd_grid(causal: bool, windowed: bool, s_k: int) -> str:
    """The TPU grid ``_flash_bwd`` (mlcomp_tpu/ops/pallas/flash_attention.py)
    runs for such a call at its default settings: ``"tri"`` for causal
    attention without windows, ``"bsched"`` for non-causal windowed
    attention over more than one KV block, else the rectangular grid
    ``"rect"``.  A ragged S counts as windowed: the JAX wrapper pads it
    through the window machinery.  The port runs one CUDA implementation
    for all three; this only labels its rows and launches."""
    s_kp = -(-s_k // 128) * 128
    bounded = windowed or s_kp != s_k
    if causal and not bounded:
        return "tri"
    if bounded and not causal:
        block_kv = next(bk for bk in (512, 256, 128) if s_kp % bk == 0)
        if s_kp // block_kv > 1:
            return "bsched"
    return "rect"


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
        for k, v in list(kw.items()):
            if isinstance(v, Ms):
                kw[f"{k}_spread"] = list(v.spread)
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
        # the flash backward: one CUDA implementation (delta, dq, dk/dv) for
        # the three TPU grids.  Each row reads the dq kernel's counter (one
        # launch per backward, as delta's and dk/dv's); the train phase gives
        # its path's launches to the grid that bwd_grid names for its calls
        "B9": Kernel("flash_attention_bwd", "mlcomp_tpu_torch/csrc/flash_attention_bwd.cu",
                     "mlcomp_tpu/ops/pallas/flash_attention.py:639", fa, "bwd_dq_launches"),
        "B10": Kernel("flash_attention_bwd", "mlcomp_tpu_torch/csrc/flash_attention_bwd.cu",
                      "mlcomp_tpu/ops/pallas/flash_attention.py:738", fa, "bwd_dq_launches"),
        "B11": Kernel("flash_attention_bwd", "mlcomp_tpu_torch/csrc/flash_attention_bwd.cu",
                      "mlcomp_tpu/ops/pallas/flash_attention.py:787", fa, "bwd_dq_launches"),
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

    # each flash kernel's, and the int8 matmul's tiled path's, registers,
    # shared memory, spills and CTAs per SM
    flash_resources = fa.resources()
    log("flash kernel resources: " + json.dumps(flash_resources))
    qmm_resources = qm.resources()
    log("quant_matmul resources: " + json.dumps(qmm_resources))
    da_resources = da.resources()
    log("decode_attention resources: " + json.dumps(da_resources))

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

    def row_of(key, case):
        """The row of kernel ``key`` measured for the case labelled ``case``."""
        return next(r for r in kernels[key].rows if r.get("case") == case)

    def by_shape(key, shapes, n_rows):
        """The timed bf16-x rows of kernel ``key`` at ``n_rows`` rows, each
        with its calls in ``shapes``."""
        rows = {(r["d"], r["n"]): r for r in kernels[key].rows
                if r["rows"] == n_rows and "ms" in r and r.get("x") != "f32"}
        return [(rows[s], c) for s, c in shapes.items()]

    def device_ms(fns, iters=20):
        """Device time of one call from torch.profiler: the kernels' own
        time, without the host's launch overhead that CUDA events see when
        the card outruns the host."""
        for i in range(2):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fns[i % len(fns)]()
            torch.cuda.synchronize()
        return sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
                   for e in prof.key_averages()) / iters / 1e3

    def qmm_operands(rows, d, n, copies, x_f32=False, gen=g):
        """x (bf16, or f32 for the norm prologue of an f32 model), ``copies``
        int8 weights (cycled past the L2) and a scale."""
        q8 = torch.randint(-127, 128, (d, n), generator=gen, device=dev, dtype=torch.int8)
        sc = torch.rand(n, generator=gen, device=dev) / (127 * math.sqrt(d))
        x = torch.randn(rows, d, generator=gen, device=dev)
        x = x if x_f32 else x.bfloat16()
        return x, [q8] + [q8.clone() for _ in range(copies - 1)], sc

    def qmm_case(rows, d, n, norm, timed=True, x_f32=False, gen=g):
        x, ws, sc = qmm_operands(rows, d, n, copies_for(d * n) if timed else 1, x_f32, gen)
        q8 = ws[0]
        gn = torch.rand(d, generator=gen, device=dev) + 0.5 if norm else None
        name = f"quant_matmul{'_norm' if norm else ''} {rows}x{d}x{n}{' f32 x' if x_f32 else ''}"
        out = qm.quant_matmul(x, q8, sc, norm_scale=gn)
        err, ratio = held(name, out, qm.quant_matmul_plain(x, q8, sc, norm_scale=gn),
                          qm.quant_matmul_plain(x.abs(), q8.abs(), sc, norm_scale=gn))
        row = dict(rows=rows, d=d, n=n, max_abs_err=err, err_over_limit=ratio)
        if x_f32:
            row["x"] = "f32"
        # the same bits from a second run, and the grid: the tiled path's
        # plan above 64 rows, the decode kernel's gemv_plan at or below
        if not torch.equal(qm.quant_matmul(x, q8, sc, norm_scale=gn), out):
            raise AssertionError(f"{name}: two runs on the same inputs differ")
        row["bit_equal_rerun"] = True
        if rows > qm.GEMV_ROWS:
            pl = qm.plan(rows, d, n)
            row.update(ctas=pl["ctas"], splits=pl["splits"])
        else:
            pl = qm.gemv_plan(rows, d, n)
            row.update(ctas=pl["ctas"], cluster=pl["cluster"], rows_padded=pl["rows_padded"])
            log(f"  {name}: gemv_plan cluster {pl['cluster']}, {pl['ctas']} CTAs, rows padded "
                f"to {pl['rows_padded']}; err/limit {ratio:.4f}, bit-equal rerun")
        if not timed:
            return row
        kms = time_ms([lambda w=w: qm.quant_matmul(x, w, sc, norm_scale=gn) for w in ws])
        pms = time_ms([lambda w=w: qm.quant_matmul_plain(x, w, sc, norm_scale=gn) for w in ws[:2]],
                      iters=1, warmup=1)
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
        row.update(ms=kms, plain_ms=pms, library_ms=lms, **bound_of(nbytes, ops))
        return row

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
    # the tiled path at ragged row counts (a padded last tile; 65 and 200
    # rows split D, 300 rows at qkv fill the card with tiles alone)
    for rows in (65, 200, 300):
        for d, n in ((mlp, hidden), (hidden, qkv_n)):
            kernels["B1"].add(**qmm_case(rows, d, n, False, timed=False))
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
    b3_plan = da.chunk_plan(1, heads, heads, BATCH, dh, l_buf)
    log(f"  B3 {BATCH}x1: chunk_plan {json.dumps(b3_plan)}")
    out = da.decode_attention(q, *caches[0], starts, stops, scale)
    if not torch.equal(da.decode_attention(q, *caches[0], starts, stops, scale), out):
        raise AssertionError("decode_attention: two runs on the same inputs differ")
    k8, ks, v8, vs = caches[0]
    err, ratio = held("decode_attention", out,
                      da.decode_attention_plain(q, k8, ks, v8, vs, starts, stops, scale),
                      da.decode_attention_plain(q, k8, ks, v8.abs(), vs, starts, stops, scale))
    del k8, ks, v8, vs
    kms = time_ms([lambda c=c: da.decode_attention(q, *c, starts, stops, scale) for c in caches])
    pms = time_ms([lambda c=c: da.decode_attention_plain(q, *c, starts, stops, scale)
                   for c in caches[:2]], iters=1, warmup=1)
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
    kernels["B3"].add(case=f"{BATCH}x1", route=b3_plan["body"], shares=b3_plan["shares"],
                      cluster=b3_plan["cluster"],
                      ctas=b3_plan["ctas"], b=BATCH, h=heads, h_kv=heads, l_buf=l_buf, dh=dh,
                      live_slots=live, max_abs_err=err, err_over_limit=ratio,
                      bit_equal_rerun=True, ms=kms, plain_ms=pms, library_ms=lms,
                      **bound_of(nbytes, ops))
    chunk_inputs_b3 = ("B3", kernels["B3"].rows[-1], q, caches[0], starts, stops, scale)
    # the one-query chunk is the single-query decode: the same kernel body
    one = da.decode_attention_chunk(q[:, None], *caches[0], starts, stops, scale)[:, 0]
    torch.cuda.synchronize()
    if not torch.equal(one, out):
        raise AssertionError("decode_attention_chunk at S = 1 differs from decode_attention")
    del caches, dq
    torch.cuda.empty_cache()

    def quant_cache(b, h_kv=heads, d=dh, length=None, gen=g):
        """A (B, Hkv, L, d) int8 K/V cache of random rows, with its scales."""
        length = length or l_buf
        k8, ks = da.quantize_kv(torch.randn(b, length, h_kv, d, generator=gen, device=dev))
        v8, vs = da.quantize_kv(torch.randn(b, length, h_kv, d, generator=gen, device=dev))
        return (k8.transpose(1, 2).contiguous(),
                ks.transpose(1, 2)[:, :, None].bfloat16().contiguous(),
                v8.transpose(1, 2).contiguous(),
                vs.transpose(1, 2)[:, :, None].bfloat16().contiguous())

    def sdpa_operands(cache, h, starts, stop0, s_q):
        """The library yardstick's operands: bf16 K and V dequantized from
        the int8 cache (each KV head repeated for its G query heads) and
        the chunk's boolean mask (B, 1, S, L)."""
        rep = h // cache[0].shape[1]
        kv = [(x.float() * sc_.float().transpose(2, 3)).bfloat16().repeat_interleave(rep, 1)
              for x, sc_ in ((cache[0], cache[1]), (cache[2], cache[3]))]
        slots = torch.arange(cache[0].shape[2], device=dev)
        qstop = stop0[:, None] + torch.arange(s_q, device=dev)[None]             # (B, S)
        mask = ((slots[None, None] >= starts[:, None, None])
                & (slots[None, None] < qstop[..., None]))[:, None]           # (B, 1, S, L)
        return kv[0], kv[1], mask

    def chunk_work(b, s_q, h, h_kv, d, starts, stop0, extra_bytes=0):
        """(live pairs, window slots, bound) of a chunk call: q in and out
        back, each (row, KV head)'s K/V window and its scales read once,
        the window bounds; 4 operations per live (query head, slot) pair
        and head dim."""
        qstop = stop0[:, None] + torch.arange(s_q, device=dev)[None]
        pairs = int((qstop - starts[:, None]).clamp_min(0).sum().item())
        window = int((stop0 + s_q - 1 - starts).clamp_min(0).sum().item())
        nbytes = 2 * b * s_q * h * d * 2 + window * h_kv * (2 * d + 2 * 2) + b * 8 + extra_bytes
        return pairs, window, bound_of(nbytes, 4 * pairs * h * d)

    # every B3, B4, B6 and B7 case's operands (one copy), for their device
    # times from torch.profiler after the serving phases
    chunk_inputs = [chunk_inputs_b3]

    # B4: an admission chunk (1, 256) at cache index 256 of a 512-token
    # prompt with left padding (window [pad, 512)), and a verify-width
    # chunk S = 32 of 8 rows at per-row cursors (the first two rows, which
    # the summary reads); then a GQA chunk at a ragged S, head dim 256, and
    # windows that start mid-block with one row's window empty.  Each case
    # prints its chunk_plan route and must give the same bits on a rerun
    def chunk_case(b, s_q, starts, stop0, h=heads, h_kv=heads, d=dh, length=None, case=None):
        length = length or l_buf
        case = case or f"{b}x{s_q}"
        sc_ = 1.0 / math.sqrt(d)
        plan = da.chunk_plan(s_q, h, h_kv, b, d, length)
        log(f"  B4 {case}: chunk_plan {json.dumps(plan)}")
        cs = [quant_cache(b, h_kv, d, length)
              for _ in range(copies_for(2 * b * h_kv * length * d))]
        qc = torch.randn(b, s_q, h, d, generator=g, device=dev).bfloat16()
        k8, ks, v8, vs = cs[0]
        outc = da.decode_attention_chunk(qc, k8, ks, v8, vs, starts, stop0, sc_)
        err, ratio = held(f"decode_attention_chunk {case}", outc,
                          da.decode_attention_chunk_plain(qc, k8, ks, v8, vs, starts, stop0, sc_),
                          da.decode_attention_chunk_plain(qc, k8, ks, v8.abs(), vs, starts,
                                                          stop0, sc_))
        if not torch.equal(da.decode_attention_chunk(qc, k8, ks, v8, vs, starts, stop0, sc_), outc):
            raise AssertionError(f"decode_attention_chunk {case}: two runs on the same inputs "
                                 "differ")
        del k8, ks, v8, vs
        kms = time_ms([lambda c=c: da.decode_attention_chunk(qc, *c, starts, stop0, sc_)
                       for c in cs])
        pms = time_ms([lambda c=c: da.decode_attention_chunk_plain(qc, *c, starts, stop0, sc_)
                       for c in cs[:2]], iters=1, warmup=1)
        dq = [sdpa_operands(c, h, starts, stop0, s_q) for c in cs[:2]]
        qt = qc.transpose(1, 2)
        lms = time_ms([lambda kv=kv: torch.nn.functional.scaled_dot_product_attention(
            qt, kv[0], kv[1], attn_mask=kv[2], scale=sc_) for kv in dq])
        pairs, window, bound = chunk_work(b, s_q, h, h_kv, d, starts, stop0)
        kernels["B4"].add(case=case, route=plan["body"], ctas=plan["ctas"], b=b, s=s_q, h=h,
                          h_kv=h_kv, l_buf=length, dh=d, live_pairs=pairs, window_slots=window,
                          max_abs_err=err, err_over_limit=ratio, bit_equal_rerun=True, ms=kms,
                          plain_ms=pms, library_ms=lms, **bound)
        chunk_inputs.append(("B4", kernels["B4"].rows[-1], qc, cs[0], starts, stop0, sc_))
        del cs, dq
        torch.cuda.empty_cache()

    adm_pad = 100
    i32 = dict(dtype=torch.int32, device=dev)
    chunk_case(1, CHUNK, torch.tensor([adm_pad], **i32), torch.tensor([CHUNK + 1], **i32))
    chunk_case(BATCH, 32, torch.randint(0, 100, (BATCH,), generator=g, **i32),
               torch.randint(PROMPT, PROMPT + NEW - 32, (BATCH,), generator=g, **i32))
    # the extra cases (B7 repeats them through the page table)
    extra_chunks = [
        dict(case="GQA 2x37, 16 q heads on 4 kv heads", b=2, s_q=37, h=heads, h_kv=4,
             starts=torch.tensor([37, 200], **i32), stop0=torch.tensor([300, 500], **i32)),
        dict(case="dh 256 2x48, 8 q heads on 4 kv heads", b=2, s_q=48, h=8, h_kv=4, d=256,
             length=512, starts=torch.tensor([3, 130], **i32),
             stop0=torch.tensor([200, 400], **i32)),
        dict(case="windows from mid-block 4x40, row 3 empty", b=4, s_q=40,
             starts=torch.tensor([37, 100, 250, 300], **i32),
             stop0=torch.tensor([120, 300, 400, 200], **i32)),
    ]
    for kw in extra_chunks:
        chunk_case(**kw)

    def fwd_held(label, q, k, v, causal, sc, lo, hi, out, lse):
        """B5's (out, lse) against its plain version on the same inputs:
        out within 2^-7 (|ref| + ref_abs), ref_abs the plain version on |v|;
        lse within 1e-3 on rows with a live key; a row without one outputs
        0.  Returns (max error, max error / limit, lse error)."""
        ref, ref_lse = fa.flash_attention_plain(q, k, v, causal, sc, lo, hi)
        err, ratio = held(f"flash_attention {label}", out, ref,
                          fa.flash_attention_plain(q, k, v.abs(), causal, sc, lo, hi)[0])
        live_rows = ref_lse > -1e29
        lse_err = (lse - ref_lse).abs()[live_rows].max().item()
        if lse_err > 1e-3:
            raise AssertionError(f"flash_attention {label} lse: max error {lse_err} > 1e-3")
        if not bool((out.float().transpose(1, 2)[~live_rows] == 0).all()):
            raise AssertionError(f"flash_attention {label}: a row with no live key must "
                                 "output 0")
        return err, ratio, lse_err

    # B5: the prefill, causal, left padding as kv_start
    pads = torch.randint(0, PROMPT - 100, (BATCH,), generator=g, device=dev, dtype=torch.int32)
    qkv = [[torch.randn(BATCH, PROMPT, heads, dh, generator=g, device=dev).bfloat16()
            for _ in range(3)] for _ in range(3)]
    fq, fk, fv = qkv[0]
    out, lse = fa.flash_attention_fwd(fq, fk, fv, True, scale, pads)
    hi = torch.full_like(pads, PROMPT)
    err, ratio, lse_err = fwd_held("prefill", fq, fk, fv, True, scale, pads, hi, out, lse)
    kms = time_ms([lambda t=t: fa.flash_attention_fwd(t[0], t[1], t[2], True, scale, pads)
                   for t in qkv])
    pms = time_ms([lambda t=t: fa.flash_attention_plain(t[0], t[1], t[2], True, scale, pads, hi)
                   for t in qkv[:2]], iters=1, warmup=1)
    pos = torch.arange(PROMPT, device=dev)
    fmask = ((pos[:, None] >= pos[None, :])[None] & (pos[None, None, :] >= pads[:, None, None]))[:, None]
    tq = [[x.transpose(1, 2).contiguous() for x in t] for t in qkv[:2]]
    lms = time_ms([lambda t=t: torch.nn.functional.scaled_dot_product_attention(
        t[0], t[1], t[2], attn_mask=fmask, scale=scale) for t in tq])
    # q, k and v of the live rows only (a row before kv_start is never
    # read); the whole output (dead rows are written as 0) and lse; pads
    work = fa.flash_work(BATCH, PROMPT, PROMPT, heads, heads, dh, True, pads)
    kernels["B5"].add(case=PREFILL_CASE, b=BATCH, s=PROMPT, h=heads, dh=dh,
                      live_rows=work["live_rows"], live_pairs=work["live_pairs"],
                      max_abs_err=err, err_over_limit=ratio, lse_err=lse_err, ms=kms,
                      plain_ms=pms, library_ms=lms,
                      **bound_of(work["fwd_bytes"], work["fwd_ops"]))
    del qkv, tq
    torch.cuda.empty_cache()

    # B6 and B7: B3's and B4's kernel body through a page table.  The page
    # size is the paged engine's (128 slots, 6 pages per 768-slot row);
    # each row's window lives in shuffled physical pages, the table maps
    # NULL (page 0, zeros) past it, and the graveyard page (1) holds
    # non-finite scales that no table entry maps.  Paged must equal the
    # dense kernel on the same bytes laid out densely, bit for bit.
    page_t = 128

    def paginate(cache, last, gen=g):
        """pages (kq, ks, vq, vs) and a (B, MP) table holding the rows of a
        dense cache up to slot ``last[b]``; the dense cache of those bytes"""
        k8, ks, v8, vs = cache
        b, h_kv, l_b, d = k8.shape
        mp = l_b // page_t
        n_pages = 2 + b * mp
        table = (torch.randperm(n_pages - 2, generator=gen, device=dev)[: b * mp] + 2).view(b, mp)
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

    def paged_case(key, twin, qp, cache, starts, stop0, case=None):
        """B6 (q (B, H, dh)) or B7 (q (B, S, H, dh)) against B3 / B4 on the
        same bytes (bit for bit), against its plain version (2^-7 rule) and
        against itself on a rerun (bit for bit)."""
        single = qp.dim() == 3
        b, s_q = qp.shape[0], 1 if single else qp.shape[1]
        h, d, h_kv = qp.shape[-2], qp.shape[-1], cache[0].shape[1]
        case = case or f"{b}x{s_q}"
        sc_ = 1.0 / math.sqrt(d)
        plan = da.chunk_plan(s_q, h, h_kv, b, d, cache[0].shape[2])
        log(f"  {key} {case}: chunk_plan {json.dumps(plan)}")
        pages, table, dense = paginate(cache, stop0 + s_q - 2)
        if single:
            kern, plain, twin_fn = (da.paged_decode_attention, da.paged_decode_attention_plain,
                                    da.decode_attention)
        else:
            kern, plain, twin_fn = (da.paged_decode_attention_chunk,
                                    da.paged_decode_attention_chunk_plain,
                                    da.decode_attention_chunk)
        out = kern(qp, *pages, table, starts, stop0, sc_)
        if not torch.equal(out, twin_fn(qp, *dense, starts, stop0, sc_)):
            raise AssertionError(f"{kernels[key].name} {case} differs from {twin} on the same "
                                 "bytes")
        if not torch.equal(out, kern(qp, *pages, table, starts, stop0, sc_)):
            raise AssertionError(f"{kernels[key].name} {case}: two runs on the same inputs differ")
        if not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"{kernels[key].name}: non-finite output")
        kq, ks, vq, vs = pages
        err, ratio = held(f"{kernels[key].name} {case}", out,
                          plain(qp, kq, ks, vq, vs, table, starts, stop0, sc_),
                          plain(qp, kq, ks, vq.abs(), vs, table, starts, stop0, sc_))
        copies = [pages] + [tuple(t.clone() for t in pages)
                            for _ in range(copies_for(sum(t.nbytes for t in pages)) - 1)]
        kms = time_ms([lambda c=c: kern(qp, *c, table, starts, stop0, sc_) for c in copies])
        pms = time_ms([lambda c=c: plain(qp, *c, table, starts, stop0, sc_)
                       for c in copies[:2]], iters=1, warmup=1)
        # yardstick: SDPA on a bf16 copy gathered through the table
        dk, dv, cmask = sdpa_operands(dense, h, starts, stop0, s_q)
        qt = (qp[:, None] if single else qp).transpose(1, 2)
        lms = time_ms([lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, dk, dv, attn_mask=cmask, scale=sc_)])
        # ... and the table
        pairs, window, bound = chunk_work(b, s_q, h, h_kv, d, starts, stop0,
                                          extra_bytes=table.numel() * 4)
        kernels[key].add(case=case, route=plan["body"], cluster=plan["cluster"],
                         ctas=plan["ctas"], b=b, s=s_q, h=h,
                         h_kv=h_kv, dh=d, page_tokens=page_t, pages_per_row=table.shape[1],
                         live_pairs=pairs, window_slots=window, max_abs_err=err,
                         err_over_limit=ratio, bit_equal_rerun=True, ms=kms, plain_ms=pms,
                         library_ms=lms, **bound)
        chunk_inputs.append((key, kernels[key].rows[-1], qp, (pages, table), starts, stop0, sc_))
        del copies, dk, dv
        torch.cuda.empty_cache()

    # B6 at the decode step's windows (B3's), B7 at the verify width and
    # at the admission chunk (B4's first two cases), then at B4's extra
    # cases
    paged_case("B6", "decode_attention", q, quant_cache(BATCH), starts, stops)

    # B3 and B6 at the single-query body's other shapes, on a generator of
    # their own (every earlier case keeps its inputs): one lone request, GQA,
    # head dim 256, the paged engine's 32 live slots, and windows that start
    # and stop inside a cluster share with one row empty.  Each case prints
    # its plan (cluster, CTAs); B3 and B6 are held against their plain
    # versions (2^-7 rule), B6 must equal B3 on the same bytes, a one-query
    # chunk must equal B3 and a rerun the first run, bit for bit, and an
    # empty row gives 0.  Their device times come after the train phase
    gs = torch.Generator(device=dev).manual_seed(SEED + 2)

    def single_case(case, b, starts_, stops_, h=heads, h_kv=heads, d=dh, length=None):
        length = length or l_buf
        sc_ = 1.0 / math.sqrt(d)
        plan = da.chunk_plan(1, h, h_kv, b, d, length)
        log(f"  B3/B6 {case}: chunk_plan {json.dumps(plan)}")
        cache = quant_cache(b, h_kv, d, length, gen=gs)
        qq = torch.randn(b, h, d, generator=gs, device=dev).bfloat16()
        pages, table, dense = paginate(cache, stops_ - 1, gen=gs)
        k8_, ks_, v8_, vs_ = dense
        kq_, kps, vq_, vps = pages
        runs = {
            "B3": (lambda: da.decode_attention(qq, *dense, starts_, stops_, sc_),
                   da.decode_attention_plain(qq, *dense, starts_, stops_, sc_),
                   da.decode_attention_plain(qq, k8_, ks_, v8_.abs(), vs_, starts_, stops_, sc_),
                   dense, 0),
            "B6": (lambda: da.paged_decode_attention(qq, *pages, table, starts_, stops_, sc_),
                   da.paged_decode_attention_plain(qq, *pages, table, starts_, stops_, sc_),
                   da.paged_decode_attention_plain(qq, kq_, kps, vq_.abs(), vps, table, starts_,
                                                   stops_, sc_),
                   (pages, table), table.numel() * 4),
        }
        outs = {}
        for key, (run_k, ref, ref_abs, operands, extra) in runs.items():
            out_k = run_k()
            err_k, ratio_k = held(f"{kernels[key].name} {case}", out_k, ref, ref_abs)
            if not torch.equal(run_k(), out_k):
                raise AssertionError(f"{kernels[key].name} {case}: two runs on the same inputs "
                                     "differ")
            empty = (stops_ <= starts_).nonzero().flatten().tolist()
            if any(bool(out_k[r].float().abs().max() != 0) for r in empty):
                raise AssertionError(f"{kernels[key].name} {case}: an empty window must give 0")
            outs[key] = out_k
            pairs, window, bound = chunk_work(b, 1, h, h_kv, d, starts_, stops_,
                                              extra_bytes=extra)
            kernels[key].add(case=case, route=plan["body"], shares=plan["shares"],
                             cluster=plan["cluster"], ctas=plan["ctas"], b=b, h=h, h_kv=h_kv,
                             dh=d, l_buf=length,
                             live_pairs=pairs, max_abs_err=err_k, err_over_limit=ratio_k,
                             bit_equal_rerun=True, **bound)
            chunk_inputs.append((key, kernels[key].rows[-1], qq, operands, starts_, stops_,
                                 sc_))
        if not torch.equal(outs["B6"], outs["B3"]):
            raise AssertionError(f"paged_decode_attention {case} differs from decode_attention "
                                 "on the same bytes")
        one_q = da.decode_attention_chunk(qq[:, None], *dense, starts_, stops_, sc_)[:, 0]
        torch.cuda.synchronize()
        if not torch.equal(one_q, outs["B3"]):
            raise AssertionError(f"decode_attention_chunk {case} at S = 1 differs from "
                                 "decode_attention")
        log(f"  B3/B6 {case}: B6 == B3, one-query chunk == B3, reruns bit-equal")
        torch.cuda.empty_cache()

    i32s = dict(dtype=torch.int32, device=dev)
    single_case("1x1 lone request, window 460", 1, torch.tensor([40], **i32s),
                torch.tensor([500], **i32s))
    single_case(f"GQA {BATCH}x1, 16 q heads on 4 kv heads", BATCH,
                torch.randint(0, PROMPT - 100, (BATCH,), generator=gs, **i32s),
                torch.full((BATCH,), PROMPT + NEW // 2, **i32s), h_kv=heads // 4)
    single_case("dh 256 2x1, 8 q heads on 4 kv heads", 2, torch.tensor([3, 130], **i32s),
                torch.tensor([200, 400], **i32s), h=8, h_kv=4, d=256, length=512)
    single_case("32x1, the paged engine's 32 live slots", 4 * BATCH,
                torch.randint(0, PROMPT - 100, (4 * BATCH,), generator=gs, **i32s),
                torch.randint(PROMPT - 60, PROMPT + NEW, (4 * BATCH,), generator=gs, **i32s))
    single_case("4x1, windows inside cluster shares, row 3 empty", 4,
                torch.tensor([37, 100, 250, 300], **i32s), torch.tensor([120, 301, 411, 200], **i32s))
    paged_case("B7", "decode_attention_chunk",
               torch.randn(BATCH, 32, heads, dh, generator=g, device=dev).bfloat16(),
               quant_cache(BATCH), torch.randint(0, 100, (BATCH,), generator=g, **i32),
               torch.randint(PROMPT, PROMPT + NEW - 32, (BATCH,), generator=g, **i32))
    paged_case("B7", "decode_attention_chunk",
               torch.randn(1, CHUNK, heads, dh, generator=g, device=dev).bfloat16(),
               quant_cache(1), torch.tensor([adm_pad], **i32), torch.tensor([CHUNK + 1], **i32))
    for kw in extra_chunks:
        h, d = kw.get("h", heads), kw.get("d", dh)
        paged_case("B7", "decode_attention_chunk",
                   torch.randn(kw["b"], kw["s_q"], h, d, generator=g, device=dev).bfloat16(),
                   quant_cache(kw["b"], kw.get("h_kv", heads), d, kw.get("length")),
                   kw["starts"], kw["stop0"], case=kw["case"])

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
                  iters=1, warmup=1)
    flat_idx = gtable.view(-1).long()
    lms = time_ms([lambda p=p: torch.index_select(p, 0, flat_idx) for p in pools])
    moved = gout.nbytes
    kernels["B8"].add(case=f"bf16 K leaf {BATCH}x{gtable.shape[1]}", s=BATCH,
                      mp=gtable.shape[1], page_bytes=pools[0][0].nbytes,
                      max_abs_err=0.0, err_over_limit=0.0, ms=kms, plain_ms=pms,
                      library_ms=lms, **bound_of(2 * moved + gtable.numel() * 4, 0))
    # its operands (one copy), for its device time after the serving phases
    gather_inputs = [(kernels["B8"].rows[-1], pools[0], gtable)]
    del pools, gout
    # the int8-KV family's leaves through the same table: a code leaf
    # (Hkv, T, dh) int8 and a scale leaf (Hkv, 1, T) bf16, exact as well
    for leaf, shape, dtype in (("int8 code leaf", (heads, page_t, dh), torch.int8),
                               ("bf16 scale leaf", (heads, 1, page_t), torch.bfloat16)):
        pool = (torch.randn((n_pool,) + shape, generator=gs, device=dev) * 40).to(dtype)
        got = pgm.page_gather(pool, gtable)
        torch.cuda.synchronize()
        if not torch.equal(got, pool[gtable.long()]):
            raise AssertionError(f"page_gather differs from pages[table] on the {leaf}")
        kernels["B8"].add(case=f"{leaf} {BATCH}x{gtable.shape[1]}", s=BATCH,
                          mp=gtable.shape[1], page_bytes=pool[0].nbytes, max_abs_err=0.0,
                          err_over_limit=0.0, **bound_of(2 * got.nbytes + gtable.numel() * 4, 0))
        gather_inputs.append((kernels["B8"].rows[-1], pool, gtable))
        del got
    torch.cuda.empty_cache()

    # B9, B10, B11: the flash-attention backward (delta, dq, dk/dv) against
    # its plain version, on the kernel forward's (out, lse).  The three TPU
    # grids are one CUDA implementation; each case is the shape that the
    # JAX package would send to its grid: (a) LM training, causal (B10's
    # triangular grid); (c) the same with GQA (B10); (b) BERT finetune's
    # batch (configs/bert_finetune.yml: 32 x 128, models/bert.py's 12 heads
    # of 64) with per-row key-padding windows and one empty row, one KV
    # block (B9's rectangular grid); (d) key-padding windows over 2048 keys
    # (B11's compacted grid).  Tolerance, element by element:
    # |kernel - plain| <= 2^-7 (|ref| + ref_abs), ref_abs the sum of the
    # absolute terms behind each gradient: sum_k p (|dp| + |delta|) scale |k|
    # for dq, the same over queries with |q| for dk, sum_q p |dO| for dv.
    # Both sides round ds (or p) to bf16 before the product, where the two
    # can land one bf16 step apart (2^-8 of the term), and round the output
    # (2^-8 of it); f32 sums in other orders add ~2^-20.  A missed mask, a
    # wrong tile or a lost GQA head moves a gradient by whole terms.
    def bwd_abs(q, k, v, out, lse, do, causal, sc, lo, hi):
        b, s_q, h, d = q.shape
        s_k, h_kv = k.shape[1], k.shape[2]
        rep = h // h_kv
        qg = q.float().reshape(b, s_q, h_kv, rep, d)
        dog = do.float().reshape(b, s_q, h_kv, rep, d)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).reshape(b, h_kv, rep, s_q)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * sc
        cols = torch.arange(s_k, device=dev)
        live = ((cols[None] >= lo[:, None]) & (cols[None] < hi[:, None]))[:, None, None, None]
        if causal:
            live = live & (torch.arange(s_q, device=dev)[:, None] >= cols[None])
        p = torch.where(live, torch.exp(s - lse.reshape(b, h_kv, rep, s_q)[..., None]),
                        torch.zeros_like(s))
        del s
        dp = torch.einsum("bqgrd,bkgd->bgrqk", dog, v.float())
        w = p * (dp.abs() + delta.abs()[..., None]) * sc
        del dp
        dq = torch.einsum("bgrqk,bkgd->bqgrd", w, k.float().abs()).reshape(b, s_q, h, d)
        dk = torch.einsum("bgrqk,bqgrd->bkgd", w, qg.abs())
        dv = torch.einsum("bgrqk,bqgrd->bkgd", p, dog.abs())
        return dq, dk, dv

    def bwd_case(key, label, b, s, h, h_kv, d, causal, lo=None, hi=None, fwd_row=False):
        sc = 1.0 / math.sqrt(d)
        nbytes_in = (2 * b * s * h + 2 * b * s * h_kv) * d * 2
        sets = []
        for _ in range(copies_for(nbytes_in)):
            t = [torch.randn(b, s, hh, d, generator=g, device=dev).bfloat16()
                 for hh in (h, h_kv, h_kv, h)]
            out_, lse_ = fa.flash_attention_fwd(t[0], t[1], t[2], causal, sc, lo, hi)
            sets.append((*t, out_, lse_))
        bq, bk, bv, bdo, bout, blse = sets[0]
        lo_t = fa._window(lo, b, 0, dev)
        hi_t = fa._window(hi, b, s, dev)
        # the forward whose (out, lse) the backward takes, at this shape
        f_err, f_ratio, f_lse_err = fwd_held(label, bq, bk, bv, causal, sc, lo_t, hi_t,
                                             bout, blse)
        torch.cuda.empty_cache()
        got = fa.flash_attention_bwd(bq, bk, bv, bout, blse, bdo, causal, sc, lo, hi)
        # deterministic: a second run on the same inputs gives the same bits
        again = fa.flash_attention_bwd(bq, bk, bv, bout, blse, bdo, causal, sc, lo, hi)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"flash_attention_bwd {label}: two runs on the same inputs "
                                 "differ")
        out2, lse2 = fa.flash_attention_fwd(bq, bk, bv, causal, sc, lo, hi)
        if not (torch.equal(out2, bout) and torch.equal(lse2, blse)):
            raise AssertionError(f"flash_attention {label}: two runs on the same inputs differ")
        del again, out2, lse2
        ref = fa.flash_attention_bwd_plain(bq, bk, bv, bout, blse, bdo, causal, sc, lo_t, hi_t)
        absr = bwd_abs(bq, bk, bv, bout, blse, bdo, causal, sc, lo_t, hi_t)
        errs, ratios = [], []
        for n, a, r, ra in zip(("dq", "dk", "dv"), got, ref, absr):
            if not bool(torch.isfinite(a.float()).all()):
                raise AssertionError(f"flash_attention_bwd {label}: non-finite {n}")
            e, rt = held(f"flash_attention_bwd {label} {n}", a, r, ra)
            errs.append(e)
            ratios.append(rt)
        if lo is not None or hi is not None:
            empty = (hi_t <= lo_t).nonzero().flatten().tolist()
            for row in empty:
                if any(bool(x[row].float().abs().max() != 0) for x in got):
                    raise AssertionError(f"flash_attention_bwd {label}: the empty row {row} "
                                         "has non-zero gradients")
        del got, ref, absr
        torch.cuda.empty_cache()
        win = lo is not None or hi is not None
        kms = time_ms([lambda t=t: fa.flash_attention_bwd(t[0], t[1], t[2], t[4], t[5], t[3],
                                                          causal, sc, lo, hi)
                       for t in sets], iters=10, warmup=2)
        pms = time_ms([lambda t=t: fa.flash_attention_bwd_plain(t[0], t[1], t[2], t[4], t[5],
                                                                t[3], causal, sc, lo_t, hi_t)
                       for t in sets[:1]], iters=1, warmup=1)
        # yardstick: SDPA's backward, on bf16 copies in its (B, H, S, D)
        # layout with the KV heads repeated for GQA
        rep = h // h_kv
        mask = None
        if win:
            cols = torch.arange(s, device=dev)
            mask = ((cols[None] >= lo_t[:, None]) & (cols[None] < hi_t[:, None]))[:, None, None]
            if causal:
                mask = mask & (cols[:, None] >= cols[None, :])
        lib = []
        for t in sets[:2]:
            lq = t[0].transpose(1, 2).contiguous().requires_grad_()
            lk = t[1].repeat_interleave(rep, 2).transpose(1, 2).contiguous().requires_grad_()
            lv = t[2].repeat_interleave(rep, 2).transpose(1, 2).contiguous().requires_grad_()
            lib.append((lq, lk, lv, t[3].transpose(1, 2).contiguous()))
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def lib_f(x):
            with torch.no_grad():
                sdpa(x[0], x[1], x[2], attn_mask=mask, is_causal=causal and mask is None,
                     scale=sc)

        # SDPA's backward alone: each copy's forward runs once, outside the
        # timing, and keeps its graph; each timed call is one
        # torch.autograd.grad through it (retain_graph, nothing accumulates)
        graphs = [(sdpa(x[0], x[1], x[2], attn_mask=mask, is_causal=causal and mask is None,
                        scale=sc), x) for x in lib]

        def lib_b(gx):
            o, x = gx
            torch.autograd.grad(o, x[:3], x[3], retain_graph=True)

        lms = time_ms([lambda gx=gx: lib_b(gx) for gx in graphs], iters=10, warmup=2)
        del graphs, lib
        # q, out and dO of the live rows, k and v of the live keys, lse and
        # the windows read once; dq, dk, dv written
        work = fa.flash_work(b, s, s, h, h_kv, d, causal, lo, hi)
        pairs = work["live_pairs"]
        row_grid = bwd_grid(causal, win, s)
        if GRID_KEYS[row_grid] != key:
            raise AssertionError(f"{label}: the JAX package runs its {row_grid} grid, not {key}")
        row = dict(case=label, b=b, s=s, h=h, h_kv=h_kv, dh=d, causal=causal, windowed=win,
                   grid=row_grid, live_pairs=pairs, bit_equal_reruns=True,
                   fwd_max_abs_err=f_err,
                   fwd_err_over_limit=f_ratio, max_abs_err=max(errs),
                   err_over_limit=max(ratios), ms=kms, plain_ms=pms, library_ms=lms,
                   **bound_of(work["bwd_bytes"], work["bwd_ops"]))
        kernels[key].add(**row)
        if fwd_row:
            # B5 at the training shape: the forward of this case
            fk = time_ms([lambda t=t: fa.flash_attention_fwd(t[0], t[1], t[2], causal, sc)
                          for t in sets], iters=10, warmup=2)
            fp = time_ms([lambda t=t: fa.flash_attention_plain(t[0], t[1], t[2], causal, sc,
                                                               lo_t, hi_t)
                          for t in sets[:1]], iters=1, warmup=1)
            fl = time_ms([lambda x=x: lib_f(x) for x in
                          [(t[0].transpose(1, 2), t[1].transpose(1, 2), t[2].transpose(1, 2))
                           for t in sets[:2]]], iters=10, warmup=2)
            kernels["B5"].add(case="training shape " + label, b=b, s=s, h=h, dh=d,
                              live_pairs=pairs, max_abs_err=f_err, err_over_limit=f_ratio,
                              lse_err=f_lse_err, ms=fk,
                              plain_ms=fp, library_ms=fl,
                              **bound_of(work["fwd_bytes"], work["fwd_ops"]))
        del sets
        torch.cuda.empty_cache()

    bwd_case("B10", CASE_A, 2, 4096, heads, heads, dh, True, fwd_row=True)
    bwd_case("B10", CASE_C, 2, 4096, heads, heads // 4, dh, True)
    bert_stop = torch.randint(16, 129, (32,), generator=g, device=dev, dtype=torch.int32)
    bert_stop[5] = 0                                        # an all-pad row
    bwd_case("B9", CASE_B, 32, 128, 12, 12, 64, False, torch.zeros(32, dtype=torch.int32, device=dev), bert_stop)
    w_lo = torch.randint(0, 512, (4,), generator=g, device=dev, dtype=torch.int32)
    w_hi = w_lo + torch.randint(256, 1536, (4,), generator=g, device=dev, dtype=torch.int32)
    bwd_case("B11", CASE_D, 4, 2048, heads, heads, dh, False, w_lo, w_hi)
    # a ragged GQA shape that no tile size divides, with left padding and
    # one row padded to its end (no live key): the JAX package pads S to
    # 1024 through the window machinery, so its rectangular grid (B9)
    e_lo = torch.randint(0, 301, (3,), generator=g, device=dev, dtype=torch.int32)
    e_lo[2] = 1000
    bwd_case("B9", CASE_E, 3, 1000, heads, heads // 2, dh, True, e_lo)

    # B1/B2's decode path at the paged engine's 32 slots and at its most
    # rows (64), both kernels at every decode shape; ragged row counts
    # inside a row tile (3, 13, 57); the norm prologue on an f32 model's x.
    # Last in the phase, with a generator of their own, so that every other
    # case runs on the inputs and in the order it ran before they were added
    gq = torch.Generator(device=dev).manual_seed(SEED + 1)
    for rows in (32, qm.GEMV_ROWS):
        for d, n in d_shapes:
            kernels["B1"].add(**qmm_case(rows, d, n, False, timed=rows == 32, gen=gq))
            kernels["B2"].add(**qmm_case(rows, d, n, True, timed=rows == 32, gen=gq))
    for rows, (d, n) in ((3, (hidden, qkv_n)), (13, (mlp, hidden)), (57, (hidden, 2 * mlp))):
        kernels["B1"].add(**qmm_case(rows, d, n, False, timed=False, gen=gq))
        kernels["B2"].add(**qmm_case(rows, hidden, n, True, timed=False, gen=gq))
    kernels["B2"].add(**qmm_case(BATCH, hidden, qkv_n, True, timed=False, x_f32=True, gen=gq))
    torch.cuda.empty_cache()

    # A row's bits must not depend on how many rows the call holds (the
    # Pallas grids give each row its own cell).  B3 and B6 on one row's
    # inputs inside calls of 1, 8 and 32 rows, the row at another index in
    # each, and B1 on 512 rows alone and inside a 4096-row call (a lone
    # window-batcher prefill against the same prompt in a batch of 8), at
    # every projection: bit for bit.  Own generator, after every other case
    gb = torch.Generator(device=dev).manual_seed(SEED + 3)
    big = quant_cache(4 * BATCH, gen=gb)
    qb = torch.randn(4 * BATCH, heads, dh, generator=gb, device=dev).bfloat16()
    sb = torch.randint(0, PROMPT - 100, (4 * BATCH,), generator=gb, **i32s)
    eb = torch.randint(PROMPT - 60, PROMPT + NEW, (4 * BATCH,), generator=gb, **i32s)
    row_bits = {}
    for b, at_ in ((1, 0), (BATCH, 3), (4 * BATCH, 17)):
        sel = torch.tensor(list(range(1, at_ + 1)) + [0] + list(range(at_ + 1, b)),
                           device=dev)
        sub = tuple(t[sel].contiguous() for t in big)
        pages, table, dense = paginate(sub, eb[sel] - 1, gen=gb)
        plan = da.chunk_plan(1, heads, heads, b, dh, l_buf)
        row_bits[b] = (
            da.decode_attention(qb[sel], *dense, sb[sel], eb[sel], scale)[at_],
            da.paged_decode_attention(qb[sel], *pages, table, sb[sel], eb[sel], scale)[at_],
            (plan["shares"], plan["cluster"]))
    torch.cuda.synchronize()
    ref3, ref6, _ = row_bits[1]
    for b, (o3, o6, grid) in row_bits.items():
        if not (torch.equal(o3, ref3) and torch.equal(o6, ref6) and torch.equal(o6, o3)):
            raise AssertionError(f"B3/B6: one row's output inside a {b}-row call (shares, "
                                 f"cluster {grid}) differs from the same row alone")
    log("  B3/B6 one row inside calls of 1, 8 and 32 rows ((shares, cluster) "
        f"{[v[2] for v in row_bits.values()]}): bit-equal, B6 == B3")
    del big, row_bits, sub, pages, table, dense
    for d, n in b1_prefill:
        q8, sc = qmm_operands(1, d, n, 1, gen=gb)[1:]
        xb = torch.randn(BATCH * PROMPT, d, generator=gb, device=dev).bfloat16()
        full = qm.quant_matmul(xb, q8[0], sc)
        alone512 = qm.quant_matmul(xb[3 * PROMPT: 4 * PROMPT].contiguous(), q8[0], sc)
        torch.cuda.synchronize()
        if not torch.equal(alone512, full[3 * PROMPT: 4 * PROMPT]):
            raise AssertionError(f"B1 {d}x{n}: 512 rows alone differ from the same rows inside "
                                 f"a {BATCH * PROMPT}-row call")
        log(f"  B1 {d}x{n}: {PROMPT} rows alone == inside {BATCH * PROMPT} rows (D split "
            f"{qm.plan(PROMPT, d, n)['splits']} at both)")
    del q8, sc, xb, full, alone512
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
    # a greedy request that rode a batch (padded to 8 rows) must give the
    # same tokens sent alone (one row): its prefill at 512 rows instead of
    # 4096, its decode at 1 row instead of 8
    rode = next(i for i, r in enumerate(results) if r["batched_with"] > 1
                and "temperature" not in bodies[i])
    solo = post(bodies[rode])
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
    if solo["batched_with"] != 1 or solo["ids"] != results[rode]["ids"]:
        raise AssertionError(f"window batcher: request {rode} alone gave other tokens than "
                             f"inside a batch of {results[rode]['batched_with']}")
    if not health.get("ok"):
        raise AssertionError(f"/healthz: {health}")
    log(f"serve: {len(bodies)} concurrent requests in {wall:.2f} s "
        f"(batches {health['batches']}, rows {health['batched_rows']}); "
        f"repeat prompt identical; request {rode} alone == inside a batch of "
        f"{results[rode]['batched_with']}; healthz ok")
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
        da.chunk_tc_launches = da.split_launches = 0
        st0 = eng.stats()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(bodies)) as ex:
            streams = list(ex.map(sse, bodies))
        wall = time.perf_counter() - t0
        st_mid = eng.stats()
        first = post({"prompt": alone, "max_new_tokens": NEW})
        second = post({"prompt": alone, "max_new_tokens": NEW})
        # lone TTFT: LONE_REPEATS requests one after another, the median
        # with its spread and the host's load beside it
        lone = [sse({"prompt": lone_prompt, "max_new_tokens": 16}) for _ in range(LONE_REPEATS)]
        lone_ms = sorted(t * 1e3 for _, t, _ in lone)
        ttft_lone = {"median": lone_ms[len(lone_ms) // 2], "spread": [lone_ms[0], lone_ms[-1]],
                     "n": len(lone_ms), "loadavg": list(os.getloadavg())}
        counts = {key: k.launches for key, k in kernels.items()}
        chunk_tc, split = da.chunk_tc_launches, da.split_launches
        st1 = eng.stats()
        ids = []
        for events, _, _ in streams:
            res = streamed(events, NEW)
            ids.append(res["ids"])
            if not all(0 <= t < vocab for t in res["ids"]):
                raise AssertionError(f"expected {NEW} ids in the vocabulary, got {res['ids']}")
            if len(res["logprobs"]) != NEW or max(res["logprobs"]) > 0:
                raise AssertionError("logprobs must be <= 0, one per token")
        for events, _, _ in lone:
            streamed(events, 16)
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
            f"SSE TTFT {json.dumps(ttft_lone)} ms; per-token p50 {per_token_ms['p50']:.3f} ms; "
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
        # in queue.get, so it takes no interpreter time from the engine loop.
        # STEADY_WINDOWS such runs; the median with its spread and the
        # host's load beside it
        def steady_window():
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
            return (t_b - t_a) * 1e3 / (s_b - s_a), s_b - s_a

        wins = sorted(steady_window() for _ in range(STEADY_WINDOWS))
        steady_ms = wins[len(wins) // 2][0]
        steady = {"median": steady_ms, "spread": [wins[0][0], wins[-1][0]],
                  "steps": [n for _, n in wins], "loadavg": list(os.getloadavg())}
        log(f"{label} decode at {BATCH} live slots: {steady_ms:.3f} ms/step median of "
            f"{STEADY_WINDOWS} windows ({BATCH * 1e3 / steady_ms:.1f} tok/s; "
            f"{json.dumps(steady)}, K {eng.stats()['k_ladder']} ladder)")
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=10)
        return dict(wall=wall, emitted=emitted, ttft_ms=ttft_ms, per_token_ms=per_token_ms,
                    ttft_lone=ttft_lone, steady_ms=steady_ms, steady=steady, k_used=k_used,
                    counts=counts, chunk_tc=chunk_tc, split=split,
                    st0=st0, st1=st1, ids=ids, first=first["ids"], steps_issued=steps_issued)

    def chunks_on_tensor_cores(run, label):
        """Every chunk launch of an engine run (B4 and B7: its admission
        chunks, S > 1) took the tensor-core body, and every single-query
        launch (B3 or B6) the split body."""
        c = run["counts"]
        if c["B4"] <= 0 or run["chunk_tc"] != c["B4"] + c["B7"]:
            raise AssertionError(f"{label}: {run['chunk_tc']} tensor-core body launches for "
                                 f"{c['B4']} B4 and {c['B7']} B7 launches")
        log(f"{label}: all {run['chunk_tc']} chunk launches on the tensor-core body")
        # ... and every single-query launch (B3 or B6) the split body
        if run["split"] <= 0 or run["split"] != c["B3"] + c["B6"]:
            raise AssertionError(f"{label}: {run['split']} split-body launches for {c['B3']} B3 "
                                 f"and {c['B6']} B6 launches")
        log(f"{label}: all {run['split']} single-query launches on the split body")

    dense_run = engine_serve(service, "engine")
    counts = dense_run["counts"]
    chunks_on_tensor_cores(dense_run, "engine")
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
            da.chunk_tc_launches = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            model(chunk_ids[:, CHUNK:], positions=chunk_pos[:, CHUNK:], cache=cache,
                  last_only=True, kv_start=chunk_start)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
            launched = launched or {key: k.launches for key, k in kernels.items()}
            if da.chunk_tc_launches != launched["B4"]:
                raise AssertionError(f"admission chunk: {da.chunk_tc_launches} tensor-core body "
                                     f"launches for {launched['B4']} B4 launches")
        return sorted(walls), launched

    chunk_walls, per_chunk = chunk_ms()
    adm_chunk_ms = chunk_walls[0]
    # the summary weighs the B1, B2 and B4 shapes by these calls
    expected = {"B1": sum(b1_prefill.values()), "B2": 1, "B3": 0, "B4": layers, "B5": 0,
                "B6": 0, "B7": 0, "B8": 0, "B9": 0, "B10": 0, "B11": 0}
    if per_chunk != expected:
        raise AssertionError(f"launches per admission chunk {per_chunk}, expected {expected}")
    share = {"B1": total(by_shape("B1", b1_prefill, CHUNK))["ms"],
             "B2": total(by_shape("B2", {(hidden, vocab): 1}, 1))["ms"],
             "B4": kernels["B4"].rows[0]["ms"] * per_chunk["B4"]}
    b4_chunk_ms = share["B4"]
    log(f"admission chunk (1, 256) at index 256: {adm_chunk_ms:.3f} ms wall (best of 5; "
        f"all five {[round(w, 3) for w in chunk_walls]}); "
        f"of it, in ms: " + ", ".join(f"{key} {v:.3f} ({100 * v / adm_chunk_ms:.1f}%)"
                                      for key, v in share.items()))
    service.close()

    # the model and the decode step's inputs, kept for one decode step's
    # torch.profiler trace after the train phase (a trace taken now would
    # slow the later host-bound phases)
    step_model, step_l_buf = model, eng.l_buf
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
    chunks_on_tensor_cores(paged_run, "paged engine")
    for key in kernels:
        if (pcounts[key] > 0) != (key not in ("B3", "B7", "B9", "B10", "B11")):
            raise AssertionError(f"{kernels[key].name}: {pcounts[key]} launches on the paged "
                                 "engine path (B6 must replace B3 in every decode step, and "
                                 "the repeated lone prompt must hit the prefix-page registry)")
    if pcounts["B6"] != layers * paged_run["steps_issued"]:
        raise AssertionError(f"B6 launched {pcounts['B6']} times for "
                             f"{paged_run['steps_issued']} decode steps of {layers} layers")
    pst = peng.stats()
    ppool = pst["kv_pool"]
    # B8 serves the int8 engine's registry hits: each gathers every layer's
    # four leaves (int8 K and V codes, bf16 K and V scales) once
    n_leaves = 4 * layers
    if pst["kv_registry_hit_tokens"] <= 0 or pcounts["B8"] % n_leaves:
        raise AssertionError(f"paged engine: {pcounts['B8']} B8 launches for "
                             f"{pst['kv_registry_hit_tokens']} registry hit tokens")
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
    # the elastic run (slots growing to 16 and more, so every kernel at
    # other row counts) must give every greedy request the dense tokens: a
    # row's bits do not depend on how many rows the call holds
    elastic_bad = [i for i in greedy if paged_run["ids"][i] != dense_run["ids"][i]]
    if elastic_bad:
        raise AssertionError(f"elastic paged run: greedy requests {elastic_bad} differ from the "
                             f"dense engine's (peak live slots {elastic['peak_live_slots']})")
    elastic_equal = len(greedy)
    log(f"paged == dense: {len(got)} greedy requests equal at 8 slots (sampled, keyed by "
        f"request ids that differ between the runs: {sampled_equal} of "
        f"{len(bodies) - len(greedy)} equal); in the elastic run (peak live slots "
        f"{elastic['peak_live_slots']}) all {len(greedy)} greedy requests equal the dense "
        f"engine's; {pcounts['B8']} B8 launches for {pst['kv_registry_hit_tokens']} registry "
        "hit tokens")
    pmodel = pservice.model
    del pservice, peng, eq
    torch.cuda.empty_cache()

    # ---- 8b. disaggregated handoff: the same model, int8 KV, 128-slot pages
    log("phase disaggregated handoff")
    from mlcomp_tpu_torch.kvpool.transfer import HandoffError

    hand_prompts = [bodies[i]["prompt"] for i in greedy] + [alone]
    pre = DecodeEngine(pmodel, prefill_only=True, kv_page_tokens=page_t, **engine_kw)
    dec = DecodeEngine(pmodel, slots=BATCH, kv_layout="paged", kv_page_tokens=page_t,
                       max_slots=BATCH, **engine_kw)
    try:
        pre.submit(warm, 2).result(timeout=300)
        dec.submit(warm, 2).result(timeout=300)
        # the prefill replica: one export at a time, each timed alone
        for k in kernels.values():
            k.reset()
        blobs, export_ms = [], []
        for p in hand_prompts:
            t = time.perf_counter()
            blobs.append(pre.submit(p, NEW).result(timeout=300)["handoff"])
            export_ms.append((time.perf_counter() - t) * 1e3)
        pre_counts = {key: k.launches for key, k in kernels.items()}
        pre_st = pre.stats()
        # a blob cut short is rejected typed, no page touched
        free0 = dec._pool.alloc.free_pages
        try:
            dec.import_pages(blobs[0][: len(blobs[0]) // 2])
            raise AssertionError("a truncated handoff was accepted")
        except HandoffError:
            pass
        if dec._pool.alloc.free_pages != free0 or dec.stats()["handoff_rejects"] != 1:
            raise AssertionError("the rejected handoff touched the pool")
        # the decode replica: one import timed alone to its first token,
        # then every blob at once
        for k in kernels.values():
            k.reset()
        tap: "queue.Queue" = queue.Queue()
        t = time.perf_counter()
        f_one = dec.import_pages(blobs[-1], stream=tap)
        tap.get(timeout=300)
        import_first_ms = (time.perf_counter() - t) * 1e3
        f_one.result(timeout=300)
        t = time.perf_counter()
        futs = [dec.import_pages(b) for b in blobs]
        hand_ids = [f.result(timeout=300)["ids"] for f in futs]
        import_wall = time.perf_counter() - t
        dec_counts = {key: k.launches for key, k in kernels.items()}
        dec_st = dec.stats()
        if hand_ids != want:
            bad = [i for i, (a, b) in enumerate(zip(hand_ids, want)) if a != b]
            raise AssertionError(f"imported requests {bad} differ from the dense engine's")
        # a repeated prompt (the longest greedy one, imported once more so
        # that its pages are the registry's newest) hits the registry: its
        # prefix pages gathered by B8, its tokens the cold ones
        hit_i = max(range(len(greedy)), key=lambda i: len(hand_prompts[i]))
        dec.import_pages(blobs[hit_i]).result(timeout=300)
        for k in kernels.values():
            k.reset()
        hit0 = dec.stats()["kv_registry_hit_tokens"]
        hit_ids = dec.submit(hand_prompts[hit_i], NEW).result(timeout=300)["ids"]
        hit_tokens = dec.stats()["kv_registry_hit_tokens"] - hit0
        hit_counts = {key: k.launches for key, k in kernels.items()}
    finally:
        pre.close()
        dec.close()
    if hit_ids != want[hit_i] or hit_tokens <= 0 or hit_counts["B8"] != n_leaves:
        raise AssertionError(f"registry hit: {hit_tokens} tokens, {hit_counts['B8']} B8 "
                             f"launches, tokens equal cold: {hit_ids == want[hit_i]}")
    for key in ("B1", "B2", "B4", "B5"):
        if pre_counts[key] <= 0:
            raise AssertionError(f"the prefill replica launched no {kernels[key].name}")
    if any(pre_counts[key] for key in ("B3", "B6", "B7", "B8")) or pre_st["dispatches"]:
        raise AssertionError(f"the prefill replica ran decode work: {pre_counts}")
    if dec_counts["B6"] <= 0 or dec_counts["B4"] or dec_counts["B5"] or dec_counts["B3"]:
        raise AssertionError(f"the decode replica's imports ran a prefill: {dec_counts}")
    sizes = sorted(len(b) for b in blobs)
    disagg = {
        "requests": len(blobs), "handoff_bytes": {"min": sizes[0], "max": sizes[-1],
                                                  "total": sum(sizes)},
        "pages_exported": pre_st["kv_pages_exported"],
        "export_ms": {"median": sorted(export_ms)[len(export_ms) // 2],
                      "spread": [min(export_ms), max(export_ms)]},
        "import_to_first_token_ms": import_first_ms,
        "import_wall_s": import_wall, "imported": dec_st["handoffs_imported"],
        "pages_imported": dec_st["kv_pages_imported"],
        "launches_prefill_side": pre_counts, "launches_decode_side": dec_counts,
        "registry_hit": {"tokens": hit_tokens, "launches": hit_counts, "equal_cold": True},
        "greedy_equal_dense": len(want), "truncated_blob_rejected": True, "card": smi,
    }
    log(f"disaggregated handoff ({smi}): {len(blobs)} prompts exported by a prefill_only "
        f"engine, {sizes[0]}-{sizes[-1]} bytes a handoff; export median "
        f"{disagg['export_ms']['median']:.1f} ms; one import to its first token "
        f"{import_first_ms:.1f} ms; all imported in {import_wall:.2f} s, tokens equal the dense "
        f"engine's; a cut blob rejected with no page touched; registry hit {hit_tokens} tokens "
        f"with {hit_counts['B8']} B8 launches, tokens equal cold")
    log("launches, prefill side: " + json.dumps(pre_counts) + "; decode side: "
        + json.dumps(dec_counts))
    # the paged model's weights go too: the train phase's peak memory is
    # read after this
    del pre, dec, blobs, pmodel
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

    # ---- 10. train: configs/multihost_lm.yml's model through `cli dag`
    log("phase train")
    import tempfile

    import yaml

    from mlcomp_tpu_torch import cli as port_cli
    from mlcomp_tpu_torch.db.store import Store
    from mlcomp_tpu_torch.io.checkpoint import latest_step

    with open(Path(__file__).resolve().parent / "configs" / "multihost_lm.yml") as f:
        dag_cfg = yaml.safe_load(f)
    task = dag_cfg["executors"]["pretrain"]
    targs = task["args"]
    tmp_train = tempfile.mkdtemp(prefix="chip_smoke_train_")
    # the single-chip cuts of the shipped config; widths, data, optimizer,
    # schedule and loss stay as shipped
    cuts = {
        "resources": f"{task['resources']} -> {{'chips': 1}} (one card: no hosts, no gang)",
        "mesh": f"{targs.get('mesh')} -> none (one card's share of dp 8)",
        "batch_size": f"{targs['data']['train']['batch_size']} -> {TRAIN_BATCH} (16 over dp 8: "
                      f"one chip's share)",
        "n": f"{targs['data']['train']['n']} -> {TRAIN_BATCH * (TRAIN_STEPS + 1)} "
             f"({TRAIN_STEPS + 1} steps of one epoch)",
        "epochs": f"{targs['epochs']} -> 1",
        "storage": f"model storage -> {tmp_train}/storage",
    }
    task["resources"] = {"chips": 1}
    targs.pop("mesh", None)
    targs["data"]["train"]["batch_size"] = TRAIN_BATCH
    targs["data"]["train"]["n"] = TRAIN_BATCH * (TRAIN_STEPS + 1)
    targs["epochs"] = 1
    targs["storage_root"] = f"{tmp_train}/storage"
    # host spans of every data fetch and step (instrumentation, not a cut)
    targs["trace"] = {"path": f"{tmp_train}/trace.json"}
    train_yaml = f"{tmp_train}/multihost_lm_1chip.yml"
    with open(train_yaml, "w") as f:
        yaml.safe_dump(dag_cfg, f)
    mcfg = targs["model"]
    seq = targs["data"]["train"]["seq_len"]
    n_steps = TRAIN_STEPS + 1
    log("train cuts of configs/multihost_lm.yml: " + json.dumps(cuts))
    train_keys = ("B9", "B10", "B11")
    # every attention call of the LM's training forward is causal with no
    # windows at one S: its backward launches are those of this grid
    train_grid = GRID_KEYS[bwd_grid(True, False, seq)]
    bwd_counters = ("bwd_delta_launches", "bwd_dq_launches", "bwd_dkv_launches")
    for k in kernels.values():
        k.reset()
    for c in bwd_counters:
        setattr(fa, c, 0)
    # the serving phases' weights are not needed any more: the peak below
    # is the train run's on top of what the process still holds
    del params, serve_kw
    gc.collect()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = port_cli.main(["dag", train_yaml, "--db", f"{tmp_train}/db.sqlite",
                        "--workdir", tmp_train, "--device", "cuda"])
    train_wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    train_counts = {key: k.launches for key, k in kernels.items()}
    for key in train_keys:
        train_counts[key] = train_counts[key] if key == train_grid else 0
    bwd_counts = {c: getattr(fa, c) for c in bwd_counters}
    store = Store(f"{tmp_train}/db.sqlite")
    try:
        rows = store.task_rows(1)
        losses_ = store.metric_series(rows[0]["id"], "train/loss")
    finally:
        store.close()
    if rc != 0 or rows[0]["status"] != "success":
        raise AssertionError(f"train task: rc {rc}, {rows[0]['status']}: {rows[0]['error']}")
    ckpt_dir = f"{tmp_train}/storage/lm/multihost_lm/pretrain/checkpoints"
    if latest_step(ckpt_dir) != n_steps:
        raise AssertionError(f"no checkpoint at step {n_steps} under {ckpt_dir}")
    layers_t = mcfg["layers"]
    want = {"B5": layers_t * n_steps, **{k: 0 for k in train_keys},
            train_grid: layers_t * n_steps}
    if {k: train_counts[k] for k in want} != want or any(
            v != layers_t * n_steps for v in bwd_counts.values()):
        raise AssertionError(f"train launches {train_counts} {bwd_counts}: want {want} and "
                             f"{layers_t} backward launches of each kernel per step")
    if any(train_counts[k] for k in kernels if k not in want):
        raise AssertionError(f"a serving kernel ran on the train path: {train_counts}")
    if not losses_ or not all(math.isfinite(v) for _, v in losses_):
        # the epoch's loss is the mean of every step's: finite only if each is
        raise AssertionError(f"non-finite train loss: {losses_}")
    with open(f"{tmp_train}/trace.json") as f:
        events = json.load(f)["traceEvents"]
    steps_ev = sorted((e for e in events if e.get("name") == "step" and e.get("ph") == "X"),
                      key=lambda e: e["ts"])
    epoch_ev = [e for e in events if e.get("name") == "train_epoch" and e.get("ph") == "X"]
    if len(steps_ev) != n_steps or len(epoch_ev) != 1:
        raise AssertionError(f"trace: {len(steps_ev)} step spans, {len(epoch_ev)} epochs")
    # from the second step's start to the epoch's end, which follows the
    # host's read of the summed losses (every step done on the card)
    epoch_end = epoch_ev[0]["ts"] + epoch_ev[0]["dur"]
    train_step_ms = (epoch_end - steps_ev[1]["ts"]) / 1e3 / (n_steps - 1)
    first_train_step_ms = (steps_ev[1]["ts"] - steps_ev[0]["ts"]) / 1e3
    tokens = TRAIN_BATCH * seq
    hidden_t, mlp_t, vocab_t = mcfg["hidden"], mcfg.get("mlp_dim") or 4 * mcfg["hidden"], \
        mcfg["vocab_size"]
    heads_t = mcfg["heads"]
    dh_t = hidden_t // heads_t
    matmul_params = layers_t * (4 * hidden_t * hidden_t + 3 * hidden_t * mlp_t) + hidden_t * vocab_t
    causal_pairs = fa.flash_work(TRAIN_BATCH, seq, seq, heads_t, heads_t, dh_t, True)["live_pairs"]
    step_flops = 6 * matmul_params * tokens + 12 * causal_pairs * heads_t * dh_t * layers_t
    mfu = step_flops / (train_step_ms / 1e3) / flops
    b10a, b5t = row_of("B10", CASE_A), row_of("B5", TRAIN_B5_CASE)
    per_step_kernel_ms = {"B5 flash_attention_fwd": b5t["ms"] * layers_t,
                          "B10 flash_attention_bwd (delta + dq + dk/dv)": b10a["ms"] * layers_t}
    train_result = {
        "config": "configs/multihost_lm.yml", "cuts": cuts, "steps": n_steps,
        "tokens_per_step": tokens, "ms_per_step": train_step_ms, "first_train_step_ms": first_train_step_ms,
        "tok_s": tokens / (train_step_ms / 1e3), "mfu": mfu,
        "mfu_formula": f"(6 x {matmul_params} matmul params x {tokens} tokens + 12 x "
                       f"{causal_pairs} causal pairs x {heads_t} heads x {dh_t} dh x "
                       f"{layers_t} layers) / step time / {flops / 1e12} TFLOP/s bf16",
        "step_flops": step_flops, "max_memory_allocated_gb": peak_gb,
        "allocated_before_gb": held_gb,
        "losses": [v for _, v in losses_], "launches": train_counts, "bwd_launches": bwd_counts,
        "kernel_ms_per_step_from_kernel_phase": per_step_kernel_ms, "dag_wall_s": train_wall,
        "card": smi,
    }
    log(f"train: {n_steps} steps of {TRAIN_BATCH}x{seq} tokens through `cli dag`: "
        f"{train_step_ms:.1f} ms/step after the first ({first_train_step_ms:.1f} ms), "
        f"{tokens / (train_step_ms / 1e3):.0f} tok/s, MFU {mfu:.4f}; peak "
        f"{peak_gb:.2f} GB ({held_gb:.2f} GB held before the run); epoch loss {losses_}; launches {json.dumps(train_counts)} "
        f"{json.dumps(bwd_counts)}; checkpoint at step {n_steps}")
    torch.cuda.empty_cache()

    # ---- 11. train parity and where a step's device time goes: one step's
    # loss and global gradient norm from the same seed and batch, with the
    # kernels and with their plain versions (full depth and width; the
    # plain attention's S x S intermediates live one layer at a time).
    # Tolerances: the two differ by bf16 roundings inside attention (one
    # bf16 step of some p, ds and outputs), carried through 16 layers:
    # loss within 1e-3 relative, gradient norm within 2%.  A wrong kernel
    # moves the loss by far more than that.
    log("phase train parity")
    from mlcomp_tpu_torch.train.loop import Trainer

    pcfg = {k: v for k, v in targs.items() if k not in ("trace", "storage_root", "project",
                                                       "dag_name")}
    gc.collect()
    torch.cuda.empty_cache()
    trainer = Trainer(pcfg, device="cuda")
    x_par = torch.randint(1, mcfg["vocab_size"], (TRAIN_BATCH, seq), generator=g, device=dev)

    def loss_and_gnorm():
        for p_ in trainer.state.params.values():
            p_.grad = None
        out_ = trainer.model(x_par)
        loss_ = trainer.loss_fn(out_, {"x": x_par})
        loss_.backward()
        gn = torch.sqrt(sum((p_.grad.float() ** 2).sum() for p_ in trainer.state.params.values()))
        res = (loss_.item(), gn.item())
        for p_ in trainer.state.params.values():
            p_.grad = None
        return res

    l_k, g_k = loss_and_gnorm()
    saved_fa = (fa.flash_attention_fwd, fa.flash_attention_bwd)

    def plain_fwd(q, k, v, causal=False, scale=None, kv_start=None, kv_stop=None):
        b_, s_k = q.shape[0], k.shape[1]
        return fa.flash_attention_plain(q, k, v, causal, scale, fa._window(kv_start, b_, 0, dev),
                                        fa._window(kv_stop, b_, s_k, dev))

    def plain_bwd(q, k, v, out, lse, do, causal, scale, kv_start=None, kv_stop=None,
                  g_lse=None):
        b_, s_k = q.shape[0], k.shape[1]
        return fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal, scale,
                                            fa._window(kv_start, b_, 0, dev),
                                            fa._window(kv_stop, b_, s_k, dev), g_lse)

    fa.flash_attention_fwd, fa.flash_attention_bwd = plain_fwd, plain_bwd
    try:
        l_p, g_p = loss_and_gnorm()
    finally:
        fa.flash_attention_fwd, fa.flash_attention_bwd = saved_fa
    log(f"train parity: loss {l_k:.6f} (kernels) vs {l_p:.6f} (plain); gradient norm "
        f"{g_k:.6f} vs {g_p:.6f}")
    if not (math.isfinite(l_k) and math.isfinite(g_k)) or abs(l_k - l_p) > 1e-3 * abs(l_p) \
            or abs(g_k - g_p) > 0.02 * g_p:
        raise AssertionError(f"train parity: loss {l_k} vs {l_p}, grad norm {g_k} vs {g_p}")

    # one profiled train step (after a warm one): device time by kernel and
    # the card's busy share of the step's wall.  The flash kernels' share
    # of the step is what this profile is for, so a profile without device
    # time for them fails the run
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch_p = {"x": x_par}
    trainer._train_step(trainer.state, batch_p)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer._train_step(trainer.state, batch_p)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(evt, "device_time_total", None)
        us = getattr(evt, "cuda_time_total", 0.0) if us is None else us
        # a kernel's name without its namespace and argument list
        name = evt.key.replace("(anonymous namespace)::", "").split("(")[0][:96]
        by_name[name] = by_name.get(name, 0.0) + us
    busy_ms = sum(by_name.values()) / 1e3
    ours = {n: us / 1e3 for n, us in by_name.items() if "flash_" in n}
    want_flash = ("flash_fwd_kernel", "flash_bwd_delta_kernel", "flash_bwd_dq_kernel",
                  "flash_bwd_dkv_kernel")
    if busy_ms <= 0 or any(not any(w in n and t > 0 for n, t in ours.items())
                           for w in want_flash):
        raise AssertionError(f"profiled train step: no device time for the flash kernels "
                             f"(busy {busy_ms} ms; flash kernels {ours})")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    profile_result = {
        "wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / prof_wall_ms,
        "our_kernels_ms": ours, "our_kernels_share_of_busy": sum(ours.values()) / busy_ms,
        "top_ms": {n: us / 1e3 for n, us in top},
    }
    log("profiled train step: " + json.dumps(profile_result))
    del trainer
    torch.cuda.empty_cache()

    # B1 and B2 at every timed shape (the decode path's rows, the tiled
    # path's prefill and admission-chunk rows): device time of the kernel
    # and of bf16 torch.matmul (on the normed x for B2) from torch.profiler.
    # Measured last, so that the profiler's tracing stays out of the
    # serving phases' host timings
    for key in ("B1", "B2"):
        for r in kernels[key].rows:
            if "ms" not in r:
                continue
            x, ws, sc = qmm_operands(r["rows"], r["d"], r["n"], copies_for(r["d"] * r["n"]),
                                     gen=gq)
            gn = None
            xl = x
            if key == "B2":
                gn = torch.rand(r["d"], generator=gq, device=dev) + 0.5
                x32 = x.float()
                xl = (x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-6) * gn).bfloat16()
            wb = [(w.float() * sc).bfloat16() for w in ws[:2]]
            r.update(device_ms=device_ms([lambda w=w: qm.quant_matmul(x, w, sc, norm_scale=gn)
                                          for w in ws]),
                     library_device_ms=device_ms([lambda w=w: torch.matmul(xl, w) for w in wb]))
            if r["rows"] <= qm.GEMV_ROWS:
                log(f"  {key} {r['rows']}x{r['d']}x{r['n']}: device {r['device_ms']:.4f} ms "
                    f"(torch.matmul {r['library_device_ms']:.4f}), bound {r['bound_ms']:.4f}, "
                    f"cluster {r['cluster']}")
            del x, ws, wb, xl
    torch.cuda.empty_cache()

    # one decode step of the dense engine's model at 8 rows (per-row
    # cursors, as the engine steps), profiled: the int8 matmul's kernels
    # by name.  Every product is one launch of the decode kernel: the step
    # fails if it holds a qmm_reduce_kernel.  B2 is the kernel's norm-
    # prologue instantiation (template argument NORM = true).  Then the same
    # step through 128-slot pages holding the same state (PagedKV, as the
    # paged engine steps), profiled too: each step's attention is 16
    # launches of the split single-query body (B3, then B6), its device time
    # by kernel name; the old body's name must not appear, and the paged
    # step's logits must equal the dense step's bit for bit
    from mlcomp_tpu_torch.kvpool import PagedKV, PagedLayout

    def attention_by_name(prof_):
        split_ = {"launches": 0, "device_ms": 0.0}
        old_ = 0
        for evt in prof_.key_averages():
            if re.search(r"\battend_kernel\b", evt.key):
                old_ += evt.count
            if "attend_split_kernel" in evt.key:
                split_["launches"] += evt.count
                us = getattr(evt, "device_time_total", None)
                split_["device_ms"] += (getattr(evt, "cuda_time_total", 0.0) if us is None
                                        else us) / 1e3
        return split_, old_

    with torch.inference_mode():
        cache = step_model.init_cache(BATCH, step_l_buf)
        positions = torch.clamp(torch.cumsum(pmask.int(), 1) - 1, min=0)
        step_model(prompts, positions=positions, cache=cache, kv_start=starts8, last_only=True)

        def decode_step(j, c=cache):
            return step_model(forced[:, j: j + 1], positions=(pos0 + j)[:, None], cache=c,
                              kv_start=starts8, cache_cursor=cur0 + j, last_only=True)

        decode_step(0)
        layout = PagedLayout(cache, step_l_buf, page_t)
        layout.num_pages = 2 + BATCH * layout.max_pages
        step_pages = layout.fresh_pages(dev)
        step_table = (torch.randperm(BATCH * layout.max_pages, generator=gs, device=dev)
                      + 2).view(BATCH, -1).int()
        layout.scatter(step_pages, step_table, cache)
        paged_kv = PagedKV(layout, step_pages, step_table)
        torch.cuda.synchronize()
        qm.launches = qm.norm_launches = 0
        da.launches = da.paged_launches = da.split_launches = 0
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            dense_logits = decode_step(1)
            torch.cuda.synchronize()
        qmm_counts = (qm.launches, qm.norm_launches)
        dense_attn = (da.launches, da.paged_launches, da.split_launches)
        da.launches = da.paged_launches = da.split_launches = 0
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as pprof:
            paged_logits = decode_step(1, paged_kv)
            torch.cuda.synchronize()
        paged_attn = (da.launches, da.paged_launches, da.split_launches)
    step_qmm = {"B1": {"launches": 0, "device_ms": 0.0}, "B2": {"launches": 0, "device_ms": 0.0}}
    reduce_launches = 0
    for evt in prof.key_averages():
        if "qmm_reduce_kernel" in evt.key:
            reduce_launches += evt.count
        m = re.search(r"qmm_gemv_tc_kernel<[^,]+, (true|false), ", evt.key)
        if m:
            part = step_qmm["B2" if m.group(1) == "true" else "B1"]
            part["launches"] += evt.count
            us = getattr(evt, "device_time_total", None)
            part["device_ms"] += (getattr(evt, "cuda_time_total", 0.0) if us is None else us) / 1e3
    want = {"B1": sum(b1_step.values()), "B2": sum(b2_step.values())}
    if (reduce_launches or {k: v["launches"] for k, v in step_qmm.items()} != want
            or qmm_counts != (want["B1"], want["B2"])):
        raise AssertionError(f"profiled decode step: {reduce_launches} qmm_reduce_kernel "
                             f"launches, decode-kernel launches {step_qmm} (counters "
                             f"{qmm_counts}); want {want} and no reduce")
    log("profiled decode step (8 rows): " + json.dumps(step_qmm) + "; no qmm_reduce_kernel")
    step_attn = {}
    for key, prof_, counters, want_counters in (
            ("B3", prof, dense_attn, (layers, 0, layers)),
            ("B6", pprof, paged_attn, (0, layers, layers))):
        split_, old_ = attention_by_name(prof_)
        if old_ or split_["launches"] != layers or counters != want_counters:
            raise AssertionError(f"profiled {key} decode step: {split_} split-body launches, "
                                 f"{old_} of the old attend_kernel, counters (launches, "
                                 f"paged_launches, split_launches) {counters}; want "
                                 f"{layers} split launches and {want_counters}")
        step_attn[key] = split_
    if not torch.equal(paged_logits, dense_logits):
        raise AssertionError("profiled decode step: the paged step's logits differ from the "
                             "dense step's")
    log("profiled decode step (8 rows), attention by kernel name: " + json.dumps(step_attn)
        + "; no attend_kernel; paged logits == dense logits")
    del step_model, cache, prof, pprof, paged_kv, step_pages
    torch.cuda.empty_cache()
    # B3, B4, B6 and B7 per case: device time of the kernel and of SDPA on
    # the bf16 copy, operands cycled past the L2 as in the kernel phase
    wrappers = {"B3": da.decode_attention, "B4": da.decode_attention_chunk,
                "B6": da.paged_decode_attention, "B7": da.paged_decode_attention_chunk}
    for key, r, qc, operands, c_start, c_stop0, sc_ in chunk_inputs:
        fn = wrappers[key]
        if key in ("B3", "B4"):
            cs = [operands] + [tuple(x.clone() for x in operands)
                               for _ in range(copies_for(sum(x.nbytes for x in operands)) - 1)]
            fns = [lambda c=c: fn(qc, *c, c_start, c_stop0, sc_) for c in cs]
            dense_c = operands
        else:
            pages, table = operands
            cs = [pages] + [tuple(x.clone() for x in pages)
                            for _ in range(copies_for(sum(x.nbytes for x in pages)) - 1)]
            fns = [lambda c=c: fn(qc, *c, table, c_start, c_stop0, sc_) for c in cs]
            dense_c = da.pages_to_dense(*pages, table)
        qs = qc[:, None] if key in ("B3", "B6") else qc
        dk, dv, cmask = sdpa_operands(dense_c, qs.shape[2], c_start, c_stop0, qs.shape[1])
        qt = qs.transpose(1, 2)
        r.update(device_ms=device_ms(fns), library_device_ms=device_ms(
            [lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, dk, dv, attn_mask=cmask, scale=sc_)]))
        log(f"  {key} {r['case']}: device {r['device_ms']:.4f} ms (SDPA "
            f"{r['library_device_ms']:.4f}), bound {r['bound_ms']:.4f}")
        del cs, fns, dk, dv
    chunk_inputs.clear()
    # B8: device time of the gather and of index_select on the same leaf
    for r, pool, table in gather_inputs:
        pools = [pool] + [pool.clone() for _ in range(copies_for(pool.nbytes) - 1)]
        flat_idx = table.view(-1).long()
        r.update(device_ms=device_ms([lambda p=p: pgm.page_gather(p, table) for p in pools]),
                 library_device_ms=device_ms([lambda p=p: torch.index_select(p, 0, flat_idx)
                                              for p in pools]))
        log(f"  B8 {r['case']}: device {r['device_ms']:.4f} ms (index_select "
            f"{r['library_device_ms']:.4f}), bound {r['bound_ms']:.4f}")
        del pools
    gather_inputs.clear()
    torch.cuda.empty_cache()

    # ---- 12. summary
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
        "B5": ("prefill 8x512: every layer", [(row_of("B5", PREFILL_CASE), pre_n["B5"])]),
        "B6": ("paged decode step: every layer", [(kernels["B6"].rows[0], layers)]),
        "B7": ("8 rows x 32 queries through the table, one call (the paged verify shape; "
               "served with speculation, not yet)", [(kernels["B7"].rows[0], 1)]),
        "B8": ("bf16-KV paged decode step: K and V of every layer",
               [(kernels["B8"].rows[0], 2 * layers)]),
        "B9": ("BERT finetune backward 32x128, 12 heads of 64, key padding, one call (the JAX "
               "package's rectangular grid; not on the LM train path)",
               [(row_of("B9", CASE_B), 1)]),
        "B10": ("train step 2x4096: every layer's backward (delta, dq, dk/dv), causal",
                [(row_of("B10", CASE_A), layers)]),
        "B11": ("4x2048 key-padding windows backward, one call (the JAX package's compacted "
                "grid; not on the LM train path)", [(row_of("B11", CASE_D), 1)]),
    }
    # each kernel's launches over its own path's run
    path_counts = {**{key: counts[key] for key in dense_keys},
                   "B6": pcounts["B6"], "B7": pcounts["B7"], "B8": counts16["B8"],
                   **{key: train_counts[key] for key in train_keys}}
    paths = {**{key: "dense engine serve" for key in dense_keys},
             "B6": "paged engine serve", "B7": "paged engine serve",
             "B8": "bf16-KV paged engine", **{key: "train (cli dag)" for key in train_keys}}
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
        if all("device_ms" in r for r, _ in weighted):
            # device time (torch.profiler) over the same scope
            entry.update({f: sum(r[f] * c for r, c in weighted)
                          for f in ("device_ms", "library_device_ms")})
        if key == "B1":
            for part, n_rows, scope in (
                    ("prefill", BATCH * PROMPT, "prefill 8x512: all four projections of every layer"),
                    ("admission_chunk", CHUNK,
                     "admission chunk (1, 256): all four projections of every layer")):
                weighted = by_shape("B1", b1_prefill, n_rows)
                entry[part] = {"scope": scope, **total(weighted), **{
                    f: sum(r[f] * c for r, c in weighted)
                    for f in ("device_ms", "library_device_ms")}}
            # the tiled path per shape, one call each
            entry["tiled"] = [
                {f: r[f] for f in ("rows", "d", "n", "ctas", "splits", "ms", "ms_spread",
                                   "device_ms", "bound_ms", "bound_by", "library_ms",
                                   "library_device_ms")} | {"share_of_bound": r["bound_ms"] / r["ms"]}
                for r in kernels["B1"].rows if r["rows"] in (CHUNK, BATCH * PROMPT)]
        if key == "B2":
            weighted = by_shape("B2", {(hidden, vocab): 1}, 1)
            entry["admission_chunk"] = {
                "scope": "admission chunk (1, 256): last_only lm_head", **total(weighted),
                **{f: sum(r[f] * c for r, c in weighted)
                   for f in ("device_ms", "library_device_ms")}}
        if key in ("B1", "B2"):
            # the decode path: device time (torch.profiler) of one decode
            # step's calls at 8 rows, per shape and as the profiled step
            # read it; and every timed shape of 64 rows or fewer
            weighted = by_shape(key, b1_step if key == "B1" else b2_step, BATCH)
            entry["decode_step"] = {
                "scope": label, "device_ms": sum(r["device_ms"] * c for r, c in weighted),
                "library_device_ms": sum(r["library_device_ms"] * c for r, c in weighted),
                "bound_ms": total(weighted)["bound_ms"],
                "profiled_step": step_qmm[key]}
            entry["gemv"] = [
                {f: r[f] for f in ("rows", "d", "n", "cluster", "ctas", "ms", "ms_spread",
                                   "device_ms", "bound_ms", "bound_by", "library_ms",
                                   "library_device_ms", "err_over_limit")}
                for r in kernels[key].rows if r["rows"] <= qm.GEMV_ROWS and "ms" in r]
        if key == "B5":
            entry["launches_train_path"] = train_counts["B5"]
            entry["train_step"] = {"scope": "train step 2x4096: every layer's forward, causal",
                                   **total([(row_of("B5", TRAIN_B5_CASE), layers)])}
        if key == "B10":
            entry["gqa"] = {"scope": "2x4096, 16 q heads on 4 kv heads, causal, one call",
                            **total([(row_of("B10", CASE_C), 1)])}
        if key == "B9":
            entry["ragged"] = {"scope": "3x1000, 16 q heads on 8 kv heads, causal, left "
                                        "padding, one call", **total([(row_of("B9", CASE_E), 1)])}
        if key == "B4":
            entry["verify_width"] = {"scope": "8 rows x 32 queries, one call",
                                     **total([(kernels["B4"].rows[1], 1)])}
        if key == "B7":
            entry["admission_shape"] = {"scope": "(1, 256) chunk at cache index 256, one call",
                                        **total([(kernels["B7"].rows[1], 1)])}
        if key in ("B3", "B4", "B6", "B7", "B8"):
            # every case, one call each: its body, grid and device time
            entry["cases"] = [
                {f: r[f] for f in ("case", "route", "shares", "cluster", "ctas", "ms", "ms_spread",
                                   "device_ms", "bound_ms", "bound_by", "library_ms",
                                   "library_device_ms", "plain_ms", "err_over_limit") if f in r}
                for r in kernels[key].rows]
        entries.append(entry)
    log(json.dumps({"serve": {
        "prefill_ms": pre_s * 1e3, "decode_ms_per_step": step_ms,
        "decode_tok_s": BATCH * 1e3 / step_ms, "e2e_tok_s": BATCH * NEW / full_s,
        "launches_per_decode_step": per_step, "launches_per_prefill": pre_n,
        "parity_max_abs_logit_err": dlog, "greedy_agreement": agree, "card": smi}}))
    log(json.dumps({"engine": {
        "requests": len(bodies), "wall_s": wall, "emitted_tokens": emitted,
        "tok_s": emitted / wall, "ttft_ms_loaded": ttft_ms, "per_token_ms_loaded": per_token_ms,
        "lone_sse_ttft_ms": ttft_lone, "decode_ms_per_step_8_slots": steady_ms,
        "decode_ms_per_step_8_slots_windows": dense_run["steady"],
        "decode_tok_s_8_slots": BATCH * 1e3 / steady_ms, "k_rungs_used": k_used,
        "fused_chunks": st1["fused_chunks"] - st0["fused_chunks"],
        "prefill_chunks": st1["prefill_chunks"] - st0["prefill_chunks"],
        "pipeline": st1["pipeline"], "launches": counts,
        "b4_launches_per_admission_chunk": per_chunk["B4"],
        "chunk_tc_launches": dense_run["chunk_tc"],
        "admission_chunk_ms": adm_chunk_ms, "admission_chunk_ms_walls": chunk_walls,
        "b4_ms_per_admission_chunk": b4_chunk_ms,
        "admission_chunk_kernel_ms": share, "launches_per_admission_chunk": per_chunk,
        "parity_chunk_max_abs_logit_err": chunk_dlog, "parity_chunk_agreement": chunk_agree,
        "parity_cursor_max_abs_logit_err": cur_dlog, "parity_cursor_agreement": cur_agree,
        "card": smi}}))
    prun = paged_run
    log(json.dumps({"paged_engine": {
        "requests": len(bodies), "wall_s": prun["wall"], "emitted_tokens": prun["emitted"],
        "tok_s": prun["emitted"] / prun["wall"], "ttft_ms_loaded": prun["ttft_ms"],
        "per_token_ms_loaded": prun["per_token_ms"], "lone_sse_ttft_ms": prun["ttft_lone"],
        "decode_ms_per_step_8_slots": prun["steady_ms"],
        "decode_ms_per_step_8_slots_windows": prun["steady"],
        "decode_tok_s_8_slots": BATCH * 1e3 / prun["steady_ms"], "k_rungs_used": prun["k_used"],
        "launches": pcounts, "chunk_tc_launches": paged_run["chunk_tc"],
        "peak_pages_used": ppool["peak_pages_used"],
        "pages_total": ppool["pages_total"], "page_bytes": ppool["page_bytes"],
        "kv_pages_lazy_allocated": pst["kv_pages_lazy_allocated"],
        "kv_decode_page_failures": pst["kv_decode_page_failures"], "elastic": elastic,
        "greedy_equal_dense_at_8_slots": len(got), "elastic_greedy_equal_dense": elastic_equal,
        "dense_engine_same_call": {"decode_ms_per_step_8_slots": steady_ms,
                                   "tok_s": emitted / wall, "ttft_ms_loaded": ttft_ms,
                                   "lone_sse_ttft_ms": ttft_lone},
        "bf16_kv": {"requests": len(few), "new_tokens": n16, "wall_s": wall16,
                    "launches": counts16, "equal_dense": True},
        "card": smi}}))
    log(json.dumps({"disagg": disagg}))
    log(json.dumps({"train": {**train_result, "parity": {
        "loss_kernels": l_k, "loss_plain": l_p, "grad_norm_kernels": g_k,
        "grad_norm_plain": g_p, "tolerance": "loss 1e-3 relative, gradient norm 2%"},
        "profiled_step": profile_result}}))
    log(json.dumps({"kernels": entries, "flash_resources": flash_resources,
                    "profiled_decode_step": {"quant_matmul": step_qmm,
                                             "qmm_reduce_kernel_launches": reduce_launches,
                                             "attention": step_attn},
                    "quant_matmul_resources": qmm_resources,
                    "decode_attention_resources": da_resources}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
