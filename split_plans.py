#!/usr/bin/env python3
"""Device time of the two grids that decide a row's order of sums, before
and after they stopped reading the batch, on one NVIDIA GPU.

    python3 split_plans.py

- B3/B6, the single-query int8 flash-decode (``attend_split_kernel``):
  each window's 32-slot blocks are cut into shares, merged in share
  order, and the shares placed over a thread-block cluster.
  ``batch_plan`` is the grid the planner took before: as many shares as
  cluster CTAs, the smallest cluster whose grid reaches the card's 132
  SMs, so 4 at one row, 2 at 8 rows and 1 from 9 rows on at the main
  path's shape, and a row's bits changed with the batch.
  ``cluster_plan`` keeps the cut of one row (4 shares at L = 768) and
  one share a CTA at every batch; ``row_plan`` is
  ``decode_attention.chunk_plan`` now: the same cut, placed over
  ``batch_plan``'s cluster, each CTA computing its shares one after
  another.  Both give a row the same bits at every batch.  Timed at one
  lone request (a 460-slot window), the decode step at 8 rows and the
  paged engine's 32 live slots, dense (B3) and through 128-slot pages
  (B6).
- B1's tiled path (``qmm_wgmma_kernel``, more than 64 rows): D is split
  into slices summed by a second pass.  ``batch_plan`` split D only where
  the row tiles left SMs idle (so a 512-row prefill and the same rows
  inside 4096 summed in other orders); ``row_plan`` is
  ``quant_matmul.plan``'s split now, read from (D, N) alone.  Timed at
  the admission chunk (256 rows) and the 8 x 512 prefill (4096 rows),
  the 1.2B transformer_lm's four projections, summed over its 16 layers.

The CUDA source is the same for every plan (only the launch grid
differs), so all run in this one process on the same build, each plan
twice, in the order of the list and then reversed.  Each time is torch.profiler's device
time of one call, the mean over 20 calls cycling through copies of the
operands (past the 50 MB L2).  Prints the card's name and power limit,
one JSON line per case, and exits non-zero without a card or when a
plan's outputs break the kernels' 2^-7 rule against the plain version,
the two row-independent plans disagree, or ``row_plan``'s rows change
with the batch.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys

import torch

HIDDEN, HEADS, MLP, LAYERS = 2048, 16, 8192, 16
DH = HIDDEN // HEADS
PROMPT, NEW, PAGE = 512, 128, 128
# (D, N) of the fused qkv, fused gate_up, down and out projections
SHAPES = {"qkv": (HIDDEN, 3 * HIDDEN), "gate_up": (HIDDEN, 2 * MLP), "down": (MLP, HIDDEN),
          "out": (HIDDEN, HIDDEN)}
SMS = 132


def batch_cluster(b: int, tiles: int, h_kv: int, l_buf: int) -> int:
    """The single-query body's cluster as the planner picked it before:
    the smallest power of two up to 4 whose grid reaches the SMs, never
    more shares than the cache's 32-slot blocks."""
    base, blocks, c = tiles * h_kv * b, -(-l_buf // 32), 1
    while c < 4 and base * c < SMS and 2 * c <= blocks:
        c *= 2
    return c


def batch_splits(rows: int, d: int, n: int) -> int:
    """B1's tiled D split as the planner picked it before: the most slices
    of at least two 64-deep steps that keep the ROW COUNT's tiles within
    one CTA an SM."""
    tiles = -(-rows // 128) * (n // 128)
    steps = d // 64
    fits = [s for s in range(1, steps // 2 + 1) if steps % s == 0 and tiles * s <= SMS]
    return max(fits, default=1)


def device_ms(fns, iters=20) -> float:
    for i in range(3):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
    return sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
               for e in prof.key_averages()) / iters / 1e3


def copies_for(nbytes: int) -> int:
    return max(2, math.ceil(160e6 / max(nbytes, 1)))


def interleaved(run, plans):
    """Device ms of each plan, timed in the list's order and then reversed:
    {plan: [t, t]}."""
    out = {p: [] for p in plans}
    for p in list(plans) + list(reversed(plans)):
        out[p].append(run(p))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("split_plans: no CUDA device; this script runs on the GPU", file=sys.stderr)
        return 1
    from mlcomp_tpu_torch.ops.cuda import build
    from mlcomp_tpu_torch.ops.cuda import decode_attention as da
    from mlcomp_tpu_torch.ops.cuda import quant_matmul as qm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build.build_all()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stream = build.stream_ptr(dev)
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    dense_fn = build.function("decode_attention", "decode_attention_chunk_launch",
                              [i_, i_] + [p_] * 8 + [i_] * 6 + [ctypes.c_float, p_])
    paged_fn = build.function("decode_attention", "paged_decode_attention_chunk_launch",
                              [i_, i_] + [p_] * 9 + [i_] * 7 + [ctypes.c_float, p_])
    qmm_fn = build.function("quant_matmul", "qmm_launch",
                            [p_, p_, p_, p_, ctypes.c_float, p_, p_, i_, i_, i_, i_, i_, i_, p_])
    l_buf = da.pick_buffer_len(PROMPT + NEW, HEADS, DH)
    scale = 1.0 / math.sqrt(DH)
    i32 = dict(dtype=torch.int32, device=dev)
    failures = []

    def quant_cache(b):
        k8, ks = da.quantize_kv(torch.randn(b, l_buf, HEADS, DH, generator=g, device=dev))
        v8, vs = da.quantize_kv(torch.randn(b, l_buf, HEADS, DH, generator=g, device=dev))
        return (k8.transpose(1, 2).contiguous(),
                ks.transpose(1, 2)[:, :, None].bfloat16().contiguous(),
                v8.transpose(1, 2).contiguous(),
                vs.transpose(1, 2)[:, :, None].bfloat16().contiguous())

    def paged(cache):
        """The cache's bytes as (P, Hkv, T, dh) / (P, Hkv, 1, T) pages and a
        shuffled (B, MP) table."""
        k8, ks, v8, vs = cache
        b, mp = k8.shape[0], l_buf // PAGE
        table = (torch.randperm(b * mp, generator=g, device=dev) + 2).view(b, mp).int()
        pages = []
        for x in cache:
            if x.dtype == torch.int8:
                tiles = x.view(b, HEADS, mp, PAGE, DH).permute(0, 2, 1, 3, 4)
            else:
                tiles = x.view(b, HEADS, 1, mp, PAGE).permute(0, 3, 1, 2, 4)
            pg = torch.zeros((2 + b * mp,) + tuple(tiles.shape[2:]), dtype=x.dtype, device=dev)
            pg[table.view(-1).long()] = tiles.reshape((b * mp,) + tuple(tiles.shape[2:]))
            pages.append(pg)
        return pages, table

    # ---- B3 / B6
    cases = [("1x1 lone request, window 460", 1, torch.tensor([40], **i32),
              torch.tensor([500], **i32)),
             ("8x1 decode step", 8, torch.randint(0, PROMPT - 100, (8,), generator=g, **i32),
              torch.full((8,), PROMPT + NEW // 2, **i32)),
             ("32x1, 32 live slots", 32, torch.randint(0, PROMPT - 100, (32,), generator=g, **i32),
              torch.randint(PROMPT - 60, PROMPT + NEW, (32,), generator=g, **i32))]
    probe = {}
    for label, b, starts, stops in cases:
        nbytes = 2 * b * HEADS * l_buf * (DH + 2)
        caches = [quant_cache(b) for _ in range(copies_for(nbytes))]
        pages = [paged(c) for c in caches]
        q = torch.randn(b, HEADS, DH, generator=g, device=dev).bfloat16()
        old = batch_cluster(b, 1, HEADS, l_buf)
        plan = da.chunk_plan(1, HEADS, HEADS, b, DH, l_buf)
        # (cluster, shares) of each plan
        plans = {"batch_plan": (old, old), "cluster_plan": (plan["shares"], plan["shares"]),
                 "row_plan": (plan["cluster"], plan["shares"])}

        def b3(grid, cache, out):
            return lambda: build.check(dense_fn(
                *grid, *(t.data_ptr() for t in (q, *cache, starts, stops, out)),
                b, 1, HEADS, HEADS, l_buf, DH, scale, stream), "B3")

        def b6(grid, pg, out):
            pgs, table = pg
            return lambda: build.check(paged_fn(
                *grid, *(t.data_ptr() for t in (q, *pgs, starts, stops, table, out)),
                b, 1, HEADS, HEADS, table.shape[1], PAGE, DH, scale, stream), "B6")

        outs = {p: (torch.empty_like(q), torch.empty_like(q)) for p in plans}
        for p, cl in plans.items():
            b3(cl, caches[0], outs[p][0])()
            b6(cl, pages[0], outs[p][1])()
        torch.cuda.synchronize()
        ref = da.decode_attention_plain(q, *caches[0], starts, stops, scale).float()
        ref_abs = da.decode_attention_plain(q, caches[0][0], caches[0][1], caches[0][2].abs(),
                                            caches[0][3], starts, stops, scale).float()
        for p in plans:
            for o in outs[p]:
                if not bool(((o.float() - ref).abs() <= 2 ** -7 * (ref.abs() + ref_abs)).all()):
                    failures.append(f"{label} {p}: over the 2^-7 rule")
            if not torch.equal(outs[p][0], outs[p][1]):
                failures.append(f"{label} {p}: B6 != B3")
        if not torch.equal(outs["cluster_plan"][0], outs["row_plan"][0]):
            failures.append(f"{label}: the row-independent plans differ")
        # row 0 of every case holds the same inputs only in the lone case;
        # keep each case's row-plan output of its first row for the
        # same-row check below
        probe[label] = (q[0], caches[0], starts[0], stops[0], outs["row_plan"][0][0])
        res = {}
        for key, mk, ops in (("B3", b3, caches), ("B6", b6, pages)):
            out = torch.empty_like(q)
            res[key] = interleaved(
                lambda p: device_ms([mk(plans[p], o, out) for o in ops]), list(plans))
        live = int((stops - starts).clamp(min=0).sum())
        bound_ms = (2 * q.numel() * 2 + live * HEADS * (2 * DH + 4)) / 3.35e12 * 1e3
        print(json.dumps({"kernel": "B3/B6", "case": label, "b": b,
                          "cluster_shares": plans,
                          "device_ms": res, "bound_ms": bound_ms, "card": smi}), flush=True)
        del caches, pages

    # the row plan's rows do not depend on the batch: the lone case's row
    # inside calls of 8 and 32 rows (placed at row 0 of each)
    q1, c1, s1, e1, o1 = probe["1x1 lone request, window 460"]
    for b in (8, 32):
        cache = tuple(torch.cat([t[:1], t[:1].expand(b - 1, *t.shape[1:])]).contiguous()
                      for t in c1)
        q = q1[None].expand(b, *q1.shape).contiguous()
        out = torch.empty_like(q)
        st = torch.full((b,), int(s1), **i32)
        en = torch.full((b,), int(e1), **i32)
        pl = da.chunk_plan(1, HEADS, HEADS, b, DH, l_buf)
        build.check(dense_fn(pl["cluster"], pl["shares"],
                             *(t.data_ptr() for t in (q, *cache, st, en, out)), b, 1,
                             HEADS, HEADS, l_buf, DH, scale, stream), "B3")
        torch.cuda.synchronize()
        if not torch.equal(out[0], o1):
            failures.append(f"B3 row plan: the lone row differs inside {b} rows")

    # ---- B1's tiled path
    for rows, scope in ((256, "admission chunk (1, 256)"), (4096, "prefill 8x512")):
        per_shape = {}
        for name, (d, n) in SHAPES.items():
            q8 = torch.randint(-127, 128, (d, n), generator=g, device=dev, dtype=torch.int8)
            ws = [q8] + [q8.clone() for _ in range(copies_for(d * n) - 1)]
            sc = torch.rand(n, generator=g, device=dev) / (127 * math.sqrt(d))
            x = torch.randn(rows, d, generator=g, device=dev).bfloat16()
            plans = {"batch_plan": batch_splits(rows, d, n),
                     "row_plan": qm.plan(rows, d, n)["splits"]}
            out = torch.empty(rows, n, dtype=torch.bfloat16, device=dev)
            parts = {s: torch.empty(s, rows, n, device=dev) for s in set(plans.values()) if s > 1}

            def call(splits, w):
                part = parts.get(splits)
                return lambda: build.check(qmm_fn(
                    x.data_ptr(), w.data_ptr(), sc.data_ptr(), None, 1e-6,
                    part.data_ptr() if part is not None else None, out.data_ptr(),
                    rows, d, n, splits, d // splits, 0, stream), "B1")

            got = {}
            for p, s in plans.items():
                call(s, q8)()
                torch.cuda.synchronize()
                got[p] = out.clone()
            ref = qm.quant_matmul_plain(x, q8, sc).float()
            ref_abs = qm.quant_matmul_plain(x.abs(), q8.abs(), sc).float()
            for p, o in got.items():
                if not bool(((o.float() - ref).abs() <= 2 ** -7 * (ref.abs() + ref_abs)).all()):
                    failures.append(f"B1 {rows}x{d}x{n} {p}: over the 2^-7 rule")
            per_shape[name] = {"splits": plans, "device_ms": interleaved(
                lambda p: device_ms([call(plans[p], w) for w in ws]), list(plans))}
            del ws, parts
        total = {p: [sum(v["device_ms"][p][i] for v in per_shape.values()) * LAYERS
                     for i in range(2)] for p in ("batch_plan", "row_plan")}
        print(json.dumps({"kernel": "B1", "case": scope, "rows": rows,
                          "device_ms_16_layers": total, "per_call": per_shape, "card": smi}),
              flush=True)
        torch.cuda.empty_cache()
    if failures:
        print("split_plans: " + "; ".join(failures), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
