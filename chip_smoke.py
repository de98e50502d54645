#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mlcomp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases attention_dims[,zoo,...]

Phases, in order; any failed check raises and the script exits non-zero
without printing a result.  Before the device line a ``wall`` line gives
the script's own seconds from its start and each phase's (a failed run
prints them to stderr).  ``--phases`` runs only the named phases of
SELECTABLE (each a function of its own), after the build and the
resource lines, for a focused run; with no argument every phase runs:

1. device: a CUDA card must be present; prints ``nvidia-smi``'s name and
   power limit.
2. build: compiles every kernel in mlcomp_tpu_torch/csrc with nvcc.
2b. device profile (``device_profile_phase``, in a child process so that
   the profiler's session leaves this process's later host timings
   alone), early, before the long phases: the continuous daemon on the
   1.2B all-int8 LM (dense, then
   paged) decodes 8 requests while ``GET /profile?dispatches=8`` captures
   them with torch.profiler; the capture must name B1, B2 and B3 (B6 on
   paged) with as many events as their wrappers counted launches over the
   window, give 0 < device time <= wall, a host gap >= 0 and a roofline
   share in (0, 1.05], and ``/metrics`` and ``/trace`` must carry the A13
   families and the ``engine.device`` track.  A Trainer over
   configs/multihost_lm.yml's model with ``profile:`` must write a trace
   holding B5 and B10's kernels 16 times a profiled step; the native host
   library must build and be engaged, and MLCOMP_TPU_NATIVE_SHUFFLE's
   epoch must be the seed's permutation.
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
   row counts.  Their device times (CUDA events around calls queued
   behind a spin), and one profiled decode step of the engine's model
   (which fails if it holds a qmm_reduce_kernel), are taken after the
   train phase (11), where the profiler cannot touch the serving phases'
   host timings.  The
   single-query decode (B3, and B6 through a page table: the split body,
   each window over a thread-block cluster) is held at the decode step
   (8 rows), one lone request (a 460-slot window), GQA 16 on 4, head dim
   256, the paged engine's 32 live slots and windows inside cluster
   shares with one row empty: each prints its ``chunk_plan`` (cluster,
   CTAs), must give the same bits on a rerun, B6 must equal B3 and a
   one-query chunk B3 bit for bit.  The chunk decode (B4, and B7 through a page
   table) is held at the admission chunk (1, 256), the 8 x 32 verify
   width, a GQA chunk at a ragged S, head dim 256, and windows that start
   mid-block with one row's window empty, and last, on a generator of
   their own, the speculative verify's widths 8 x 8 (spec_k 7 at 8 slots)
   and 1 x 9 (spec_k 8 at B = 1): each prints the route its
   ``chunk_plan`` picks, must give the same bits on a rerun, and B7 must
   equal B4 bit for bit.  The page gather (B8) must equal pages[table] on
   a bf16 K leaf, an int8 code leaf and a bf16 scale leaf.  The device
   times (queued CUDA events) of B3, B4, B6, B7 and B8 and of their
   library calls come after the train phase too.  The flash forward and
   causal backward (B5, B10) at configs/longcontext_lm.yml's attention
   (1 x 32768, 16 heads of 64) are held leaf by leaf (out, dq, dk, dv)
   against f32 attention: each within LONG_LEAF_MULTIPLE x SDPA's
   relative error (ROADMAP §C8).
4. window serve: the all-int8 transformer_lm at the 1.2B's widths (int8
   weights through the int8 matmul, int8 KV cache, fused qkv/gate_up, its
   16 layers cut to CFG's 8, random weights from a seed) behind the HTTP server on 127.0.0.1 through the
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
8. paged engine serve (``kv_layout="paged"``), its disaggregated handoff,
   then "prefix cache and daemon surface": the same weights served with
   ``prefix_cache=True`` on the dense and the paged engine (prompts of
   340-500 tokens, three sharing a 320-token prefix); every repeat must
   hit and give its cold tokens, a shared prefix at another length must
   hit the host cache, launch counts must show each hit skipping its first
   chunk (B5) and running its second (B4), ``cache_degraded`` must stay 0;
   then a daemon started through ``start_warmup`` must answer ``ready:
   false`` until warmup ends, serve ``/metrics``, answer 429 with
   ``Retry-After`` under ``max_queue_depth=2`` and 11 clients while every
   accepted request completes, and return a client's ``traceparent`` in
   ``/trace``.  9. the bf16-KV paged engine.
9b. speculation: the same model's dense engine at 8 slots with
   ``spec_k=7`` (B4 must carry every verify and no single-query kernel may
   run), the paged engine with 128-slot pages at ``max_slots`` 8 (B7 in
   B4's place, no B6) and the B = 1 speculative batcher at ``spec_k=8``
   (B4 at 1 x 9) against the window batcher at B = 1.  Paged spec tokens
   must equal dense spec tokens on every request; the largest logit
   difference D between a verify and single-token steps on the same tokens
   from one state is measured, and at every divergence between spec and
   non-spec tokens the teacher-forced margin of the two tokens must be at
   most 2 D; on seeded prompts whose greedy continuation repeats a bigram
   at least one verify must emit more than one token.
10. train: configs/multihost_lm.yml's 1.2B transformer_lm (hidden 2048, 16
   layers, vocab 32000, bf16, adafactor with warmup_cosine) through
   ``mlcomp_tpu_torch.cli dag``, in-process, cut to one card (2 sequences
   of 4096 tokens per step, 6 steps); the flash forward and the backward
   kernels must launch 16 times per step; ms per step, tok/s, MFU and
   peak memory.
11. train parity: one step's loss and gradient norm with the kernels and
   with their plain versions; one profiled step (device time by kernel);
   then the kernels' device times (B1-B4, B6-B8; queued CUDA events) and one
   profiled decode step of the dense engine's model and the same step
   through pages: each must run its attention as 16 launches of the split
   body (no launch of the old ``attend_kernel``), and the paged step's
   logits must equal the dense step's bit for bit.
11b. train to serve: configs/generate_quant.yml through ``cli dag`` as
   published (only its model storage moved to a temporary directory): its
   sample stage must launch B1, B2, B3 and B5; then ``serve`` on the train
   task's checkpoint directory (resolved as ``--storage-task`` resolves
   it) must give the greedy tokens of the same weights served from .npz.
11c. daemons and report: the port's ``supervisor``, one isolated ``worker
   --chips 1`` and ``report`` as processes over one store; the same
   configs/generate_quant.yml ``submit``-ted, ``status`` polled until it
   ends in the statuses ``cli dag`` gave it in 11b; the report server's
   ``/api/dags``, task routes and ``/metrics`` must show it.  Then ``fleet
   --scheduler --replicas 2 --storage-task`` on its train task: two
   ``serve_replica`` tasks on the worker; a repeated greedy prompt must
   come back from one ``x-mlcomp-replica`` with the ids ``load_service``
   gives in-process, and ``stop`` must end both tasks and empty the
   registry.
11d. fleet: ``fleet --phase-split 1:1`` on the serving configuration (the
   seed's weights saved once as ``.npz``): the 9 greedy prompts of the
   disaggregated phase through the router (prefill replica, KV pages,
   paged decode replica) must give the dense engine's ids; the router's
   lone TTFT beside the engine's, the handoff bytes, the router's
   ``mlcomp_fleet_*`` families, and a report server over the registry
   listing both daemons in ``/fleet/metrics``.  Each of these phases ends
   every process it starts and deletes its files, on failure too.
11e. model zoo: the repo's five baseline DAGs through ``cli dag`` in this
   process at their published widths, one card's cuts on one printed
   ``reduced`` line (resources to one chip, no mesh): configs/mnist.yml
   (plus a valid with ``report: classification``), grid_search.yml (6
   train tasks and the noop), unet_segmentation.yml (its valid with
   ``report: segmentation``), resnet50_imagenet.yml (on-device random
   resized crop and flip, batch 256 on the card), bert_finetune.yml as
   published and with ``model.pad_mode: window``, and a Trainer config of
   vit_b16 (224 x 224, batch 64, 6 steps).  Every task must end in
   ``success`` with finite losses and the reports must be stored;
   BERT-window and ViT must launch B5 12 times a train step and an eval
   batch and the backward kernels 12 times a train step, every call on the
   bf16 dh-64 instance's counters, the other models no flash kernel.  On one batch of BERT-window (padded rows) and ViT,
   every kernel call of a train step is held against its plain version on
   its own inputs with the kernel phase's rule, and the logits against the
   plain model's within 2^-7 (|ref| + the head's absolute terms).  One
   ResNet-50 step is profiled (device time by kernel group, idle share;
   the pass fails without device time); B5 and B9 at the BERT and ViT
   shapes get their device times (queued CUDA events, failing unless the
   dh-64 instance launches every call) beside the padded route's (the
   dh-128 instance on operands zero-padded to 128) and SDPA's.
   Then (ROADMAP §C6) the same step with SDPA in the attention's place:
   the SDPA and plain steps against each other give the noise floor of
   bf16 attention in loss and gradient norm, printed beside the kernels'
   gap, which is held within C6_FLOOR_MULTIPLE x the floor.
11f. attention dims and dtypes (ROADMAP §C5): the flash forward and
   backward at head dims 256 and 64 (bf16; 64 also at BERT's window and
   ViT's ragged 64 x 196, beside the padded route) and on f32 at head dims
   64, 128 and 256, each against its plain version at the three TPU grids'
   shapes (an empty row where windows are), bit-equal on a rerun, with
   times, SDPA's and the bound (f32: the smaller of the bounds at 3xTF32's
   rate, the bf16 peak / 6, and at the CUDA cores' FFMA rate, the latter
   kept as ``bound_ffma_ms``; at dh 256 and 64 and on f32 also the
   backward's queued device ms split into its delta, dq and dk/dv kernels,
   ``bwd_parts_device_ms``), and the f32 and bf16 dh-64 kernels'
   resources (the dh-64 ones with their producer's and consumers'
   registers after setmaxnreg; no spill in either);
   one train step of the
   1.2B LM with 8 heads of 256 (the dh-256 kernels 16 times each; loss and
   gradient norm against the plain step); an f32 BERT-window step and an
   f32 LM step with heads of 256 (cut on a ``reduced`` line) against their
   plain steps, each step's ms beside the plain step's; the 1.2B LM's ``remat`` and ``fused_loss`` steps against
   its plain step (loss within 1e-5 relative, gradient norm within 1e-4),
   each with its peak memory.
11g. moe: ``moe_lm`` at the serving widths (hidden 2048, 8 layers (16 cut
   to 8), 8 experts of 8192 top-2 in every second layer)
   served with ``--quantize kernel --kv-quant`` through the continuous
   engine: greedy requests alone equal inside a batch of 8, B1 launched
   16 times per MoE layer per decode step (the int8 expert slices), the
   quantized scan's first token equal to entry dequant's on the 8 of 64
   prompts with the widest entry-dequant top-2 margin; then 4 train steps
   at 2 x 2048 with adafactor (the cross-entropy must fall, the aux loss
   stay within MOE_AUX_BOUND x its balanced floor), peak memory.
11h. sharded serving (A12b), in processes of its own
   (``sharded_serving_phase``): the serving model cut to 4 layers
   (SHARD_CFG: unfused, all-int8) served by (a) a world of one rank over
   NCCL, which must equal the one-card engine bit for bit (8 greedy
   requests' ids, logprobs and first-step logits), and (b) ``serve --mesh
   tp=2 --distributed`` gangs of two processes on the card over gloo,
   dense at depths 2 and 1 and paged, 8 requests over HTTP to each
   coordinator.  Fails unless the arms are bit-equal (depth 1 on its
   first SHARD_D1_NEW tokens), the first-step logits are within
   SHARD_LOGIT_RTOL of the one-card engine's, every greedy divergence
   from the one-card ids sits where the one-card top-2 margin is below
   the two engines' logit gap, B1-B5 (B6 in B3's place, paged) launch on
   both ranks after warmup, the follower answers ``ready: false`` and 503,
   the coordinator's /metrics carries the mesh gauges, each follower
   exits 0 on the coordinator's stop record, and every kernel call the
   SHARD_RECORDED arms' ranks recorded at their local shapes holds
   against its plain version (``shard_local_checks``: B1/B2 at each
   shard shape, B3-B6 on 8 local heads, each row-parallel sum against
   the plain partials' f32 sum, bit-equal on both ranks).  Prints decode
   ms a step at 8 live slots against one card, GB a rank, collectives by
   transport, each rank's kernel shapes and each row-parallel sum's gap
   to one rounding split into its bf16 partials' and its kernels' shares.
11i. parallel (A12's training half), last, in a process of its own
   (``parallel_process``).  NCCL refuses two ranks on one device, so it
   runs (a) a world of one rank over NCCL (a DeviceMesh of size 1: a
   4096-token step of configs/longcontext_lm.yml's LM through the sharded
   state must give the unsharded step's loss, gradient norm within 1e-6)
   and (b) a gang of two processes on the one card over gloo
   (``MLCOMP_TPU_DIST_BACKEND=gloo``; the ring's point-to-point exchanges
   staged through pinned host memory, printed as the ``transport``).  On
   the gang: ``ring_attention`` alone at one longcontext layer (1 x 32768
   split two ways, 16 heads of 64) against the unsharded flash kernels
   within 2^-7 of each tensor's largest value, launching B5, B9 and B10;
   configs/longcontext_lm.yml's LM at full width (seq 32768, batch 1,
   mesh {sp: 2}; its depth cut to PAR_LONG_LAYERS) one step each of ``ring`` (at PAR_RING_SEQ tokens),
   ``ring_flash`` (B5, B9 and B10 must launch) and ``ulysses`` (B5 and
   B10), loss and gradient norm against the unsharded step that runs the
   same attention at the same length (plain for ``ring``, the kernels for
   the others); configs/multihost_lm.yml's 1.2B
   LM (depth cut to PAR_MH_LAYERS) at {fsdp: 2} and {tp: 2}, PAR_MH_STEPS steps each, the first
   held the same way against the unsharded kernel step.  Each is held within
   C6_FLOOR_MULTIPLE x the noise floor of bf16 attention; tp within that
   multiple of the larger of the floor and tp's own noise on plain
   attention (a tp step on plain attention, its optimizer not run,
   against the unsharded plain step; printed beside sp's, the ``ring``
   step's gap, under ``sharding_noise``).  The floor is the
   largest gap among the unsharded steps on SDPA (three runs: its
   backward is not deterministic), on plain attention (the ring's einsum
   tiles on one rank) and on f32 attention, all on one Trainer whose
   optimizer does not run, measured in the same call, no flash kernel
   among them.  The unsharded kernel step is held within the same
   multiple of the floor from the f32-attention step, and its first and
   last layer's attention leaf by leaf (``long_flash_leaves``, ROADMAP
   §C8); the first layer's B5 and B10 (the dh-64 instance) are timed
   beside the padded route and SDPA, B10 also kernel by kernel
   (``long_flash_times``).
   ``transformer_lm_pp`` at pp 2 with two virtual stages a rank
   against its sequential step (2e-3); step ms and peak memory per rank.
   Then configs/multihost_lm.yml through the local runner as two gang
   slots on the card (cuts on ``reduced`` lines): both slots must succeed
   and the checkpoint load into an unsharded Trainer.
12. summary: ``device_profile`` (the captures' device time per decode step
   beside the kernel phase's B1 + B2 + B3 of one step, two sources),
   ``serve``, ``engine``, ``paged_engine``, ``disagg``, ``spec``,
   ``train_to_serve``, ``daemons``, ``fleet``, ``zoo``, ``prefix_cache``,
   ``daemon``, ``train``, ``attention_dims``, ``moe``, ``parallel``,
   ``sharded_serving`` and ``kernels`` JSON
   lines (the kernels line lists the flash kernels' dh-256, dh-64 and f32
   instances beside B1-B11), then, last, the device line.

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
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

import torch

# the script's own clock: its start, and the seconds of each phase of main
# (the wall line before the device line)
T_START = time.perf_counter()
PHASE_S: dict = {}
_OPEN_PHASE: list = []

# the phases a focused run (``--phases a,b``) may select: each a function of
# its own; with no argument every phase runs, these among them
SELECTABLE = ("device_profile", "zoo", "attention_dims", "moe", "sharded_serving", "parallel")

# the serving model (bench.py's 1.2B at its widths), its 16 layers cut to 8
# (for "sharded serving" too), so that the whole run leaves room under
# its limit
CFG = {
    "name": "transformer_lm", "vocab_size": 32768, "hidden": 2048, "layers": 8,
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
# the model zoo phase: configs/resnet50_imagenet.yml's global batch (256 over
# dp 8 on the TPU) on the one card, and ViT-B/16's Trainer config
ZOO_RESNET_BATCH = 256
ZOO_VIT = {"batch": 64, "steps": 6}
# BERT's two DAGs (as published and with pad_mode window) train this many
# epochs (2 as published; cut for the script's time, on the zoo's
# `reduced` line)
ZOO_BERT_EPOCHS = 1
# the spin (GPU clock cycles, ~50 ms on an H100) that queued_device_ms
# puts in front of the calls it times
SPIN_CYCLES = 100_000_000
# ROADMAP §C6: the zoo's kernel step is held within this multiple of the
# noise floor of bf16 attention (the SDPA step against the plain step)
C6_FLOOR_MULTIPLE = 4.0
ZOO_DAGS = ("mnist", "grid_search", "unet_segmentation", "resnet50_imagenet", "bert_finetune",
            "bert_finetune_window", "vit_b16")

# data-sheet peaks (dense): memory bytes/s, bf16 tensor FLOP/s
PEAKS = {
    "H100 SXM": (3.35e12, 989e12),
    "H100 PCIe": (2.0e12, 756e12),
    "H100 NVL": (3.9e12, 835e12),
    "H200": (4.8e12, 989e12),
}


def log(*a):
    print(*a, flush=True)


def phase(name):
    """Close the phase that runs (its seconds go into PHASE_S) and, unless
    ``name`` is None, open ``name``."""
    now = time.perf_counter()
    if _OPEN_PHASE:
        prev, t0 = _OPEN_PHASE.pop()
        PHASE_S[prev] = PHASE_S.get(prev, 0.0) + now - t0
    if name:
        _OPEN_PHASE.append((name, now))
        log(f"phase {name}")


def wall_line(smi) -> None:
    """The script's own wall time from its start and each phase's seconds,
    on one line (before the device line)."""
    phase(None)
    log(json.dumps({"wall": {"script_s": time.perf_counter() - T_START, "phase_s": PHASE_S,
                             "card": smi}}))


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


@contextmanager
def profiled(activities=None):
    """torch.profiler (the card's activity by default) over the enclosed
    work, with ``utils.profile.EDGE_S`` of idle time at each edge: the
    profiler keeps only the card's records inside the window's bounds on
    the host's clock, and a window whose launches began as it opened has
    lost its first kernels.  Time the work inside the body."""
    from mlcomp_tpu_torch.utils.profile import EDGE_S

    acts = activities or [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(EDGE_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(EDGE_S)


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


# the kernel phase's tolerance, element by element (main's "phase kernels"
# says why): |kernel - plain| <= HELD_REL_TOL (|ref| + ref_abs)
HELD_REL_TOL = 2.0 ** -7


def held_to_plain(name, out, ref, ref_abs):
    """``out`` (a kernel's) against ``ref`` (its plain version's on the same
    inputs) under HELD_REL_TOL; ``ref_abs`` is the plain version on the
    absolute values of the summed operand.  Returns (max error, max error
    / limit); raises past the limit."""
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    limit = HELD_REL_TOL * (ref.float().abs() + ref_abs.float())
    err = diff.max().item()
    ratio = (diff / limit.clamp_min(1e-30)).max().item()
    if not math.isfinite(err) or not bool((diff <= limit).all()):
        raise AssertionError(f"{name}: |kernel - plain| over 2^-7 (|ref| + ref_abs): "
                             f"max error {err}, max error / limit {ratio}")
    return err, ratio


# the route before the flash kernels' dh-64 instance, timed beside it: the
# dh-128 instance on operands zero-padded to 128, the outputs sliced back
def pad_to_128(t):
    return torch.nn.functional.pad(t, (0, 128 - t.shape[-1]))


def padded_route_fwd(q, k, v, causal, sc, lo=None, hi=None):
    from mlcomp_tpu_torch.ops.cuda import flash_attention as fa

    out = fa.flash_attention_fwd(pad_to_128(q), pad_to_128(k), pad_to_128(v), causal, sc, lo,
                                 hi)[0]
    return out[..., :q.shape[-1]]


def padded_route_bwd(q, k, v, out, lse, do, causal, sc, lo=None, hi=None):
    from mlcomp_tpu_torch.ops.cuda import flash_attention as fa

    grads = fa.flash_attention_bwd(*(pad_to_128(t) for t in (q, k, v, out)), lse,
                                   pad_to_128(do), causal, sc, lo, hi)
    return [g[..., :q.shape[-1]] for g in grads]


def dh64_calls() -> int:
    """Forward and backward calls on the dh-64 instance so far."""
    from mlcomp_tpu_torch.ops.cuda import flash_attention as fa

    return fa.fwd_dh64_launches + fa.bwd_dh64_launches


def dh128_calls() -> int:
    """Forward and backward calls on the bf16 dh-128 instance so far (where
    no dh-256 or f32 call runs)."""
    from mlcomp_tpu_torch.ops.cuda import flash_attention as fa

    return fa.launches + fa.bwd_dq_launches - dh64_calls()


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


REPO = str(Path(__file__).resolve().parent)
TERMINAL = ("success", "failed", "skipped", "stopped")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def kill_matching(token: str) -> None:
    """SIGKILL every process of this user whose command line holds
    ``token`` (a phase's temporary directory: task children and replicas
    that run in sessions of their own)."""
    import signal

    for entry in os.listdir("/proc"):
        if not entry.isdigit() or int(entry) == os.getpid():
            continue
        try:
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read()
            if token.encode() in cmd:
                os.kill(int(entry), signal.SIGKILL)
        except OSError:
            pass


def end_procs(procs, timeout=30.0) -> None:
    """SIGTERM each process (the daemons drain or clean up on it), then
    SIGKILL its process group past ``timeout``."""
    import signal

    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except OSError:
                p.kill()
            p.wait()


def http(url, body=None, timeout=600.0):
    """GET (or POST ``body`` as JSON): (status, decoded body, headers)."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw, code, headers = r.read(), r.status, dict(r.headers)
    except urllib.error.HTTPError as e:
        raw, code, headers = e.read(), e.code, dict(e.headers)
    ctype = headers.get("Content-Type", "")
    return code, json.loads(raw) if ctype.startswith("application/json") else raw.decode(), \
        headers


def spawn_cli(tmp, name, argv, env):
    """``python -m mlcomp_tpu_torch.cli <argv>`` in a session of its own,
    its output in ``tmp/<name>.log``."""
    with open(f"{tmp}/{name}.log", "wb") as log_f:
        return subprocess.Popen([sys.executable, "-m", "mlcomp_tpu_torch.cli", *argv],
                                cwd=tmp, env=env, stdout=log_f, stderr=subprocess.STDOUT,
                                start_new_session=True)


def log_tail(tmp, name, n=3000) -> str:
    try:
        return Path(f"{tmp}/{name}.log").read_text(errors="replace")[-n:]
    except OSError:
        return ""


def wait_router(url, want_live, proc, what, timeout=300.0):
    """Poll a fleet router's ``/healthz`` until ``want_live(status)``;
    raises if the fleet process exits first or the time runs out."""
    deadline = time.monotonic() + timeout
    st = {}
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"{what}: the fleet exited with {proc.returncode}")
        try:
            st = http(url + "/healthz", timeout=10)[1]
            if want_live(st):
                return st
        except (urllib.error.URLError, OSError, ValueError):
            pass
        time.sleep(0.25)
    raise AssertionError(f"{what}: not live in {timeout:.0f} s: {st}")


# the phase "daemons and report" runs generate_quant.yml's sample stage on
# one batch of short requests (the train stage as published)
DAEMONS_SAMPLE = {"n": 8, "max_new_tokens": 32}


def daemons_phase(gq_cfg, cli_statuses, tr_steps, device, smi):
    """Phase "daemons and report": the port's ``supervisor``, one isolated
    ``worker --chips 1`` and ``report`` as processes over one store;
    ``submit`` of ``gq_cfg`` (configs/generate_quant.yml with its model
    storage moved), ``status`` polled until the DAG ends in
    ``cli_statuses`` (what ``cli dag`` gave it in the same call); the
    report server's routes and ``/metrics`` must show it.  Then ``fleet
    --scheduler --replicas 2`` on the train task's checkpoint runs two
    ``serve_replica`` tasks on the worker: a repeated greedy prompt must
    come back from one replica with the ids ``load_service`` gives for the
    checkpoint in-process, and ``stop`` must end both replica tasks and
    empty the registry.  Every process it starts is ended on the way out."""
    import copy
    import shutil
    import tempfile
    from contextlib import redirect_stdout
    from io import StringIO

    import yaml

    from mlcomp_tpu_torch import cli as port_cli
    from mlcomp_tpu_torch.db.store import Store
    from mlcomp_tpu_torch.fleet.registry import read_registry
    from mlcomp_tpu_torch.io.checkpoint import latest_step
    from mlcomp_tpu_torch.serve import load_service, resolve_storage_ckpt

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_daemons_")
    storage = f"{tmp}/storage"
    cfg = copy.deepcopy(gq_cfg)
    for ex in cfg["executors"].values():
        ex["args"]["storage_root"] = storage
    # the sample stage cut (the train stage runs as published: the fleet
    # serves its checkpoint), each cut with its value before and after
    sample = next(ex for ex in cfg["executors"].values() if ex["type"] == "generate")["args"]
    reduced = {}
    for key, path, cut in (("sample prompts", ("data", "infer", "n"), DAEMONS_SAMPLE["n"]),
                           ("sample new tokens", ("max_new_tokens",),
                            DAEMONS_SAMPLE["max_new_tokens"])):
        node = sample
        for k_ in path[:-1]:
            node = node[k_]
        reduced[key] = f"{node[path[-1]]} -> {cut}"
        node[path[-1]] = cut
    log("reduced (daemons and report): " + json.dumps(reduced))
    dag_yaml = f"{tmp}/generate_quant.yml"
    with open(dag_yaml, "w") as f:
        yaml.safe_dump(cfg, f)
    db = f"{tmp}/db.sqlite"
    info = cfg["info"]
    train_name = next(n for n, ex in cfg["executors"].items() if ex["type"] == "train")
    storage_task = f"{info['project']}/{info['name']}/{train_name}"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p),
        # the worker resolves --storage-task here, and its replicas publish
        # this address
        "MLCOMP_TPU_STORAGE": storage, "MLCOMP_TPU_HOST_IP": "127.0.0.1"}

    def cli(*argv):
        buf = StringIO()
        with redirect_stdout(buf):
            rc = port_cli.main([str(a) for a in argv])
        if rc != 0:
            raise AssertionError(f"cli {argv[0]} exited {rc}: {buf.getvalue()}")
        return buf.getvalue()

    procs = {}
    try:
        report_port = free_port()
        procs["supervisor"] = spawn_cli(tmp, "supervisor", ["supervisor", "--db", db, "--poll",
                                                             "0.2"], env)
        # two tasks at once: the two replicas (chips 0) share the card
        procs["worker"] = spawn_cli(tmp, "worker", [
            "worker", "--db", db, "--chips", "1", "--max-tasks", "2", "--workdir",
            f"{tmp}/work", "--poll", "0.2", "--device", device], env)
        procs["report"] = spawn_cli(tmp, "report", ["report", "--db", db, "--port",
                                                     str(report_port)], env)
        t0 = time.perf_counter()
        dag_id = json.loads(cli("submit", dag_yaml, "--db", db))["dag_id"]
        deadline = time.monotonic() + 900
        while True:
            lines = cli("status", dag_id, "--db", db).splitlines()
            statuses = {ln.split()[1]: ln.split()[2] for ln in lines}
            if statuses and all(s in TERMINAL for s in statuses.values()):
                break
            for name, p in procs.items():
                if p.poll() is not None:
                    raise AssertionError(f"the {name} daemon exited {p.returncode}: "
                                         f"{log_tail(tmp, name)}")
            if time.monotonic() > deadline:
                raise AssertionError(f"the DAG did not end: {statuses}")
            time.sleep(0.5)
        dag_wall = time.perf_counter() - t0
        if statuses != cli_statuses:
            raise AssertionError(f"through the daemons {statuses}; cli dag gave {cli_statuses}; "
                                 f"{log_tail(tmp, 'worker')}")
        # the report server's view of it
        base = f"http://127.0.0.1:{report_port}"
        dags = {d["id"]: d for d in http(base + "/api/dags")[1]}
        counts = dags[dag_id]["counts"]
        tasks = {t["name"]: t for t in http(f"{base}/api/dags/{dag_id}/tasks")[1]}
        tid = tasks[train_name]["id"]
        loss = http(f"{base}/api/tasks/{tid}/metrics/train/loss")[1]
        logs = [ln["message"] for ln in http(f"{base}/api/tasks/{tid}/logs")[1]]
        prom = http(base + "/metrics")[1]
        n_ok = sum(s == "success" for s in cli_statuses.values())
        ckpt_dir = f"{storage}/{storage_task}/checkpoints"
        steps = latest_step(ckpt_dir)
        if (counts != {"success": n_ok} or {n: t["status"] for n, t in tasks.items()}
                != cli_statuses or len(loss) != 1 or not math.isfinite(loss[0][1])
                or not any(m.startswith("epoch 0:") for m in logs)
                or f'mlcomp_report_tasks{{status="success"}} {n_ok}' not in prom
                or steps != tr_steps):
            raise AssertionError(f"the report server's view: counts {counts}, loss {loss}, "
                                 f"checkpoint step {steps}, tasks {list(tasks)}")
        log(f"daemons: {info['name']} through supervisor + worker in {dag_wall:.1f} s, "
            f"statuses {json.dumps(statuses)} as cli dag gave them; report: counts "
            f"{json.dumps(counts)}, train/loss {loss} (one point an epoch: the mean over its "
            f"{steps} steps)")

        # the fleet through the scheduler: two serve_replica tasks
        reg = f"{tmp}/registry.json"
        rurl = f"http://127.0.0.1:{free_port()}"
        t0 = time.perf_counter()
        procs["fleet"] = spawn_cli(tmp, "fleet", [
            "fleet", "--scheduler", "--replicas", "2", "--db", db, "--model", dag_yaml,
            "--storage-task", storage_task, "--registry", reg, "--port", rurl.rsplit(":", 1)[1],
            "--health-poll", "0.5"], env)
        wait_router(rurl, lambda st: st.get("live") == 2, procs["fleet"],
                    "the scheduler fleet")
        fleet_ready_s = time.perf_counter() - t0
        os.environ["MLCOMP_TPU_STORAGE"] = storage
        try:
            ckpt = resolve_storage_ckpt(*storage_task.split("/"))
        finally:
            del os.environ["MLCOMP_TPU_STORAGE"]
        gen = torch.Generator().manual_seed(SEED + 14)
        vocab = cfg["model"]["vocab_size"]
        prompt = torch.randint(1, vocab, (60,), generator=gen).tolist()
        others = [torch.randint(1, vocab, (n,), generator=gen).tolist() for n in (20, 90, 120)]
        ref = load_service(cfg["model"], ckpt_path=ckpt, device=device)
        try:
            want = [f.result(timeout=300)["ids"]
                    for f in [ref.submit(p, 32) for p in [prompt] + others]]
        finally:
            ref.close()
        del ref
        replies = [http(rurl + "/generate", {"prompt": p, "max_new_tokens": 32})
                   for p in [prompt] * 3 + others]
        served = [h.get("x-mlcomp-replica") for _, _, h in replies]
        ids = [r.get("ids") for _, r, _ in replies]
        if any(c != 200 for c, _, _ in replies) or len(set(served[:3])) != 1:
            raise AssertionError(f"the repeated prompt went to {served[:3]}: {replies[0]}")
        if ids != [want[0]] * 3 + want[1:]:
            raise AssertionError("the scheduler replicas' tokens differ from load_service's "
                                 "in-process ones")
        # stop: the manager goes first (SIGKILL; the replicas are scheduler
        # tasks and outlive it), then `stop` ends each replica's DAG
        procs["fleet"].kill()
        procs["fleet"].wait()
        store = Store(db)
        try:
            replica_dags = [d["id"] for d in store.list_dags()
                            if d["name"].startswith("fleet-") and d["status"] == "in_progress"]
        finally:
            store.close()
        registered = sorted(read_registry(reg))
        if len(replica_dags) != 2 or len(registered) != 2:
            raise AssertionError(f"replica DAGs {replica_dags}, registry {registered}")
        t0 = time.perf_counter()
        stopped = [json.loads(cli("stop", d, "--db", db))["stopped_tasks"] for d in replica_dags]
        deadline = time.monotonic() + 60
        while True:
            rows = [cli("status", d, "--db", db).split()[2] for d in replica_dags]
            if rows == ["stopped", "stopped"] and not read_registry(reg):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"after stop: tasks {rows}, registry {read_registry(reg)}")
            time.sleep(0.25)
        stop_s = time.perf_counter() - t0
    finally:
        try:
            store = Store(db)
            try:
                for d in store.list_dags():
                    store.stop_dag(d["id"])
            finally:
                store.close()
            time.sleep(2.0)   # the worker's stop-watch ends its children
        except Exception:
            pass
        end_procs(list(procs.values()))
        kill_matching(tmp)
        shutil.rmtree(tmp, ignore_errors=True)
    result = {
        "config": "configs/generate_quant.yml", "moved": "model storage -> a temporary dir",
        "reduced": reduced,
        "dag_wall_s": dag_wall, "statuses": statuses, "equal_cli_dag": True,
        "report": {"counts": counts, "train_loss": loss, "train_steps": steps},
        "scheduler_fleet": {"replicas": 2, "ready_s": fleet_ready_s, "repeat_replica": served[0],
                            "served_by": served, "ids_equal_in_process": True,
                            "stopped_tasks": stopped, "stop_to_empty_registry_s": stop_s},
        "phase_s": time.perf_counter() - t_phase, "card": smi,
    }
    log(f"scheduler fleet: 2 serve_replica tasks ready in {fleet_ready_s:.1f} s; the repeated "
        f"prompt came back from {served[0]} 3 times with load_service's ids; stop ended both "
        f"and emptied the registry in {stop_s:.2f} s; phase {result['phase_s']:.1f} s ({smi})")
    return result


def fleet_phase(cfg, seed, prompts, want, lone_prompt, lone_new, engine_lone_ttft, serve_args,
                device, smi):
    """Phase "fleet": ``cli fleet --phase-split 1:1`` on ``cfg`` with the
    seed's weights saved once as ``.npz``: the router brokers each request
    as ``/prefill`` on the prefill replica and ``/import`` on the paged
    decode replica; ``prompts`` must come back with ``want`` (the dense
    engine's ids).  Prints the router-side lone TTFT beside the engine's
    (``engine_lone_ttft``), the handoff bytes, the router's
    ``mlcomp_fleet_*`` families, and a report server's ``/fleet/metrics``
    over the registry.  The replicas are killed and the weights deleted on
    the way out."""
    import shutil
    import tempfile

    import yaml

    from mlcomp_tpu_torch.fleet.registry import read_registry
    from mlcomp_tpu_torch.io.weights import init_params, load_npz, save_npz
    from mlcomp_tpu_torch.ops.quant import quantize_leaf
    from mlcomp_tpu_torch.report.server import start_in_thread

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    weights = f"{tmp}/weights.npz"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}
    proc = None
    report = None
    try:
        t0 = time.perf_counter()
        params = init_params(cfg, seed, device=torch.device(device))
        save_npz(weights, params)
        write_s = time.perf_counter() - t0
        # why a file's weights must reach the card before quantization: the
        # card rounds the scale's division by 127 otherwise than the host
        leaf = params["DecoderLayer_0"]["gate"]["kernel"]
        on_card, on_host = quantize_leaf(leaf), quantize_leaf(leaf.cpu())
        host_vs_card = {"leaf": "DecoderLayer_0/gate " + "x".join(map(str, leaf.shape)),
                        "codes_differing": int((on_card["q8"].cpu() != on_host["q8"]).sum()),
                        "scales_differing": int((on_card["q8_scale"].cpu()
                                                 != on_host["q8_scale"]).sum()),
                        "scales": on_host["q8_scale"].numel()}
        del params, leaf, on_card, on_host
        size = os.path.getsize(weights)
        t0 = time.perf_counter()
        tree = load_npz(weights)
        load_s = time.perf_counter() - t0
        del tree
        if device == "cuda":
            torch.cuda.empty_cache()
        with open(f"{tmp}/model.yml", "w") as f:
            yaml.safe_dump({"model": cfg}, f)
        reg = f"{tmp}/registry.json"
        rport = free_port()
        lo = free_port()
        t0 = time.perf_counter()
        proc = spawn_cli(tmp, "fleet", [
            "fleet", "--model", f"{tmp}/model.yml", "--ckpt", weights, "--phase-split", "1:1",
            "--port", str(rport), "--port-range", f"{lo}:{lo + 41}", "--registry", reg,
            "--health-poll", "0.5", "--log-dir", f"{tmp}/replicas",
            "--serve-arg", f"{serve_args} --device {device}"], env)
        rurl = f"http://127.0.0.1:{rport}"
        wait_router(rurl, lambda st: st.get("live_by_phase") == {
            "both": 0, "prefill": 1, "decode": 1}, proc, "the phase-split fleet")
        ready_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(prompts)) as ex:
            replies = list(ex.map(
                lambda p: http(rurl + "/generate", {"prompt": p, "max_new_tokens": len(want[0])}),
                prompts))
        wall = time.perf_counter() - t0
        bad = [i for i, (c, r, _) in enumerate(replies) if c != 200 or r.get("ids") != want[i]]
        if bad:
            raise AssertionError(f"two-hop requests {bad} differ from the dense engine's: "
                                 f"{replies[bad[0]][0]} {str(replies[bad[0]][1])[:300]}")
        if not all(h["x-mlcomp-replica"].startswith("decode") for _, _, h in replies):
            raise AssertionError("a request did not end on the decode replica")

        def sse(body):
            req = urllib.request.Request(rurl + "/generate",
                                         data=json.dumps({**body, "stream": True}).encode(),
                                         headers={"Content-Type": "application/json"})
            t = time.perf_counter()
            first, n = None, 0
            with urllib.request.urlopen(req, timeout=300) as r:
                for line in r:
                    if line.startswith(b"data: ") and b'"token"' in line:
                        n += 1
                        first = first if first is not None else time.perf_counter() - t
            if first is None or n != lone_new:
                raise AssertionError(f"the router's SSE stream gave {n} tokens")
            return first * 1e3

        lone = sorted(sse({"prompt": lone_prompt, "max_new_tokens": lone_new}) for _ in range(3))
        st = http(rurl + "/healthz")[1]
        c = st["counts"]
        n_req = len(prompts) + len(lone)
        if c["handoffs"] != n_req or c["handoff_failures"] or c["handoff_bytes"] <= 0:
            raise AssertionError(f"router counts {c}")
        prom = http(rurl + "/metrics")[1]
        families = sorted({ln.split("{")[0].split(" ")[0] for ln in prom.splitlines()
                           if ln.startswith("mlcomp_fleet_")})
        fleet_lines = [ln for ln in prom.splitlines() if ln.startswith("mlcomp_fleet_")
                       and not ln.split("{")[0].split(" ")[0].endswith("_bucket")]
        # a report server pointed at the registry sees both daemons
        urls = sorted(e["url"] for e in read_registry(reg).values())
        os.environ["MLCOMP_TPU_SERVE_REGISTRY"] = reg
        try:
            report, report_port = start_in_thread(f"{tmp}/report.sqlite")
            fm = http(f"http://127.0.0.1:{report_port}/fleet/metrics")[1]
        finally:
            del os.environ["MLCOMP_TPU_SERVE_REGISTRY"]
        up = sorted(ln for ln in fm.splitlines() if ln.startswith("mlcomp_fleet_daemon_up"))
        if len(urls) != 2 or up != sorted(f'mlcomp_fleet_daemon_up{{daemon="{u[7:]}"}} 1'
                                          for u in urls):
            raise AssertionError(f"/fleet/metrics over the registry {urls}: {up}")
    finally:
        if report is not None:
            report.shutdown()
            report.server_close()
        if proc is not None:
            end_procs([proc], timeout=60)
        kill_matching(tmp)
        shutil.rmtree(tmp, ignore_errors=True)
    result = {
        "config": "the serving configuration, --phase-split 1:1", "serve_args": serve_args,
        "weights_npz_bytes": size, "npz_write_s": write_s, "npz_load_s": load_s,
        "host_vs_card_quantization": host_vs_card,
        "ready_s": ready_s, "requests": len(prompts), "wall_s": wall,
        "greedy_equal_dense": len(prompts),
        "router_lone_sse_ttft_ms": {"median": lone[1], "spread": [lone[0], lone[-1]], "n": 3,
                                    "loadavg": list(os.getloadavg())},
        "engine_lone_sse_ttft_ms": engine_lone_ttft,
        "handoffs": c["handoffs"], "handoff_bytes": c["handoff_bytes"],
        "handoff_bytes_per_request": c["handoff_bytes"] / c["handoffs"],
        "router_fleet_families": families, "router_fleet_samples": fleet_lines,
        "report_fleet_daemon_up": up, "phase_s": time.perf_counter() - t_phase, "card": smi,
    }
    log(f"fleet --phase-split 1:1 ({smi}): weights {size} bytes written in {write_s:.1f} s, "
        f"read in {load_s:.1f} s; ready in {ready_s:.1f} s; {len(prompts)} greedy prompts "
        f"through prefill -> import in {wall:.2f} s with the dense engine's ids; router lone "
        f"TTFT {lone[1]:.1f} ms (engine alone {engine_lone_ttft['median']:.1f}); "
        f"{c['handoff_bytes']} handoff bytes over {c['handoffs']} handoffs; phase "
        f"{result['phase_s']:.1f} s")
    log("router families: " + " ".join(families))
    log("int8 quantization of one leaf, host against card: " + json.dumps(host_vs_card))
    return result


def flash_bwd_abs(q, k, v, out, lse, do, causal, sc, lo, hi):
    """The sum of the absolute terms behind each gradient of the flash
    backward: sum_k p (|dp| + |delta|) scale |k| for dq, the same over
    queries with |q| for dk, sum_q p |dO| for dv (the ref_abs of the
    backward's tolerance)."""
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    rep = h // h_kv
    dev = q.device
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


def zoo_step_ms(trace_path: str) -> dict:
    """ms per train step from a Trainer's ``trace`` spans: the time from
    each step's start to the next one's (the last step of an epoch to its
    epoch's end, which follows the host's read of the summed losses),
    every step but the run's first; the median with its spread."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    starts = sorted(e["ts"] for e in spans if e.get("name") == "step")
    epochs = sorted((e["ts"], e["ts"] + e["dur"]) for e in spans if e.get("name") == "train_epoch")
    gaps = []
    for lo, hi in epochs:
        inside = [t for t in starts if lo <= t <= hi] + [hi]
        gaps += [(b - a) / 1e3 for a, b in zip(inside, inside[1:])]
    gaps = sorted(gaps[1:])
    evals = sorted(e["dur"] / 1e3 for e in spans if e.get("name") == "eval_epoch")
    return {"median": gaps[len(gaps) // 2], "spread": [gaps[0], gaps[-1]], "n": len(gaps),
            "steps": len(starts), "eval_epoch_ms": evals}


def zoo_phase(device, smi, bw, flops):
    """Phase "model zoo": the repo's five baseline DAGs and ViT-B/16 through
    ``cli dag`` in this process, each at its published widths (cuts on the
    printed ``reduced`` line): every task must end in ``success`` with
    finite losses, the valid reports must be stored, BERT with ``pad_mode:
    window`` and ViT must launch the flash forward (B5) 12 times a train
    step and an eval batch and the backward kernels 12 times a train step,
    and the other models none; then one train step of BERT-window and of
    ViT on one batch, with the kernels and with their plain versions on
    the card: every kernel call within the kernel phase's 2^-7 (|ref| +
    ref_abs) of its plain version on its own inputs, the logits within
    2^-7 (|ref| + the head's absolute terms); then one profiled ResNet-50
    step, and the device times (queued CUDA events, the calls' CUDA-event
    times beside) of B5 and B9 at the BERT and ViT shapes beside SDPA's."""
    import shutil
    import tempfile

    import yaml

    from mlcomp_tpu_torch import cli as port_cli
    from mlcomp_tpu_torch.db.store import Store
    from mlcomp_tpu_torch.models import create_model
    from mlcomp_tpu_torch.ops.cuda import flash_attention as fa
    from mlcomp_tpu_torch.train.losses import create_loss

    t_phase = time.perf_counter()
    dev = torch.device(device)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_zoo_")
    configs = {}
    for name in ZOO_DAGS[:5]:
        with open(Path(REPO) / "configs" / f"{name}.yml") as f:
            configs[name] = yaml.safe_load(f)
    reduced = {}
    for name, cfg in configs.items():
        for tname, task in cfg["executors"].items():
            if "resources" in task and task["resources"] != {"chips": 1}:
                reduced[f"{name}.{tname}.resources"] = f"{task['resources']} -> {{'chips': 1}}"
                task["resources"] = {"chips": 1}
            args = task.get("args") or {}
            if "mesh" in args:
                reduced[f"{name}.{tname}.mesh"] = f"{args.pop('mesh')} -> none (one card)"
    # additions: mnist's valid with a classification report; U-Net's valid
    # with a segmentation report
    mnist_ex = configs["mnist"]["executors"]
    mnist_ex["valid_report"] = {**mnist_ex["valid"], "args": {
        **mnist_ex["valid"]["args"], "report": "classification"}}
    reduced["mnist.valid_report"] = "added: valid with report: classification"
    configs["unet_segmentation"]["executors"]["valid"]["args"]["report"] = "segmentation"
    reduced["unet_segmentation.valid.report"] = "added: segmentation"
    rtrain = configs["resnet50_imagenet"]["executors"]["train"]["args"]
    if ZOO_RESNET_BATCH != rtrain["data"]["train"]["batch_size"]:
        reduced["resnet50_imagenet.train.batch_size"] = (
            f"{rtrain['data']['train']['batch_size']} -> {ZOO_RESNET_BATCH} (one chip's share)")
        rtrain["data"]["train"]["batch_size"] = ZOO_RESNET_BATCH
    for tname, task in configs["bert_finetune"]["executors"].items():
        if task["args"].get("epochs", 1) > ZOO_BERT_EPOCHS:
            reduced[f"bert_finetune.{tname}.epochs"] = (
                f"{task['args']['epochs']} -> {ZOO_BERT_EPOCHS} (bert_finetune_window too; for "
                "the script's time)")
            task["args"]["epochs"] = ZOO_BERT_EPOCHS
    window = json.loads(json.dumps(configs["bert_finetune"]))
    window["info"]["name"] = "bert_finetune_window"
    for task in window["executors"].values():
        task["args"]["model"]["pad_mode"] = "window"
        if "dag_name" in task["args"]:
            task["args"]["dag_name"] = "bert_finetune_window"
    reduced["bert_finetune_window"] = "bert_finetune.yml with model.pad_mode: window"
    configs["bert_finetune_window"] = window
    vb, vsteps = ZOO_VIT["batch"], ZOO_VIT["steps"]
    configs["vit_b16"] = {"info": {"name": "vit_b16", "project": "vision"}, "executors": {"train": {
        "type": "train", "args": {
            "model": {"name": "vit_b16", "num_classes": 1000, "dtype": "bfloat16"},
            "optimizer": {"name": "adamw", "lr": 1e-3, "weight_decay": 0.05, "grad_clip": 1.0},
            "loss": "cross_entropy", "metrics": ["accuracy"], "epochs": 1,
            "data": {"train": {"name": "synthetic_images", "n": vb * vsteps, "batch_size": vb},
                     "valid": {"name": "synthetic_images", "n": vb, "seed": 1,
                               "batch_size": vb}},
            "project": "vision", "dag_name": "vit_b16"}}}}
    reduced["vit_b16"] = (f"a Trainer config of our own (no ViT YAML in configs/): vit_b16 at "
                          f"224x224, 1000 classes, batch {vb}, {vsteps} steps, adamw")
    log("reduced (model zoo): " + json.dumps(reduced))
    traced = {"unet_segmentation", "resnet50_imagenet", "bert_finetune", "bert_finetune_window",
              "vit_b16"}
    bwd_counters = ("bwd_delta_launches", "bwd_dq_launches", "bwd_dkv_launches")
    # the dh-64 instance's own counters: every flash call of the two models
    # (bf16, 12 heads of 64) must go through it
    dh64_counters = ("fwd_dh64_launches", "bwd_dh64_launches")
    # the two models that attend through the flash kernels, by their depth
    layers = {n: create_model(configs[n]["executors"]["train"]["args"]["model"], "cpu").layers
              for n in ("bert_finetune_window", "vit_b16")}
    dags = {}
    try:
        for name in ZOO_DAGS:
            cfg = configs[name]
            d = f"{tmp}/{name}"
            os.makedirs(d)
            for tname, task in cfg["executors"].items():
                if task.get("type") == "train":
                    task["args"]["storage_root"] = f"{d}/storage"
                    if name in traced:
                        task["args"]["trace"] = {"path": f"{d}/{tname}_trace.json"}
            with open(f"{d}/dag.yml", "w") as f:
                yaml.safe_dump(cfg, f)
            fa.launches = 0
            for c in bwd_counters + dh64_counters:
                setattr(fa, c, 0)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            rc = port_cli.main(["dag", f"{d}/dag.yml", "--db", f"{d}/db.sqlite", "--workdir", d,
                                "--device", device])
            wall = time.perf_counter() - t0
            counts = {"B5": fa.launches,
                      **{c: getattr(fa, c) for c in bwd_counters + dh64_counters}}
            store = Store(f"{d}/db.sqlite")
            try:
                rows = store.task_rows(1)
                statuses = {r["name"]: r["status"] for r in rows}
                losses = {r["name"]: [v for _, v in store.metric_series(r["id"], "train/loss")]
                          for r in rows if r["name"].startswith("train")}
                reports = {r["name"]: [(p["name"], p["kind"]) for p in store.reports(r["id"])]
                           for r in rows}
                errors = {r["name"]: r["error"] for r in rows if r["status"] != "success"}
            finally:
                store.close()
            if rc != 0 or any(s != "success" for s in statuses.values()):
                raise AssertionError(f"zoo {name}: rc {rc}, {statuses}, {errors}")
            if not all(v and all(math.isfinite(x) for x in v) for v in losses.values()):
                raise AssertionError(f"zoo {name}: train losses {losses}")
            res = {"wall_s": wall, "statuses": statuses, "train_loss": losses,
                   "launches": counts, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            steps = 0
            for tname in cfg["executors"]:
                tp = f"{d}/{tname}_trace.json"
                if os.path.exists(tp):
                    res[f"{tname}_ms_per_step"] = zoo_step_ms(tp)
                    steps += res[f"{tname}_ms_per_step"]["steps"]
            if name in layers:
                # forward batches: every train step, the train task's eval
                # each epoch and the valid task's pass
                evals = 0
                for task in cfg["executors"].values():
                    a = task["args"]
                    dv = a["data"].get("valid")
                    if dv is not None:
                        nb = -(-dv["n"] // dv.get("batch_size", a.get("batch_size", 64)))
                        evals += nb * (a.get("epochs", 1) if task.get("type") == "train" else 1)
                want = {"B5": layers[name] * (steps + evals),
                        **{c: layers[name] * steps for c in bwd_counters}}
                want.update(fwd_dh64_launches=want["B5"], bwd_dh64_launches=want["bwd_dq_launches"])
                if counts != want or steps == 0:
                    raise AssertionError(f"zoo {name}: flash launches {counts}, want {want} "
                                         f"({steps} train steps, {evals} eval batches)")
            elif any(counts.values()):
                raise AssertionError(f"zoo {name}: a flash kernel ran: {counts}")
            if name == "mnist" and not reports.get("valid_report"):
                raise AssertionError(f"zoo mnist: no classification report: {reports}")
            if name == "unet_segmentation" and not reports.get("valid"):
                raise AssertionError(f"zoo unet: no segmentation report: {reports}")
            res["reports"] = {k: v for k, v in reports.items() if v}
            dags[name] = res
            log(f"zoo {name}: {json.dumps(res)}")

        # BERT-window and ViT on one batch: one train step's forward and
        # backward with the kernels, then with their plain versions.  Every
        # kernel call of the kernels' step is recorded and held against the
        # plain version on its own inputs with the kernel phase's rule:
        # |kernel - plain| <= 2^-7 (|ref| + ref_abs), ref_abs the sum of the
        # absolute terms (the plain forward on |v|; flash_bwd_abs).  The
        # model's logits are held with the same rule, ref_abs the sum of the
        # absolute terms of the head's product (|x| |W| + |b|, the head's
        # input from the plain run).  The loss, the gradient norm and each
        # parameter gradient's error are printed, not held: one bf16 step of
        # an attention output in one layer moves everything after it, so
        # through 12 layers the loss moves by ~0.2% between two right
        # answers; the k bias's exact gradient is 0 (it shifts every logit
        # of a row alike) and the last layer's q and k gradients come from
        # one query (the CLS row) as sums that cancel, so both sides give
        # rounding noise there.
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

        def within(label, out, ref, ref_abs):
            diff = (out.float() - ref.float()).abs()
            limit = 2.0 ** -7 * (ref.float().abs() + ref_abs.float())
            ratio = float((diff / limit.clamp_min(1e-30)).max())
            if not math.isfinite(ratio) or ratio > 1.0:
                raise AssertionError(f"zoo parity {label}: |kernel - plain| at {ratio:.3f} of "
                                     "2^-7 (|ref| + ref_abs)")
            return ratio

        g = torch.Generator(device=dev).manual_seed(SEED)
        ids = torch.randint(1, 30522, (32, 128), generator=g, device=dev)
        stop = torch.randint(16, 129, (32,), generator=g, device=dev)
        start = torch.randint(0, 16, (32,), generator=g, device=dev)
        cols = torch.arange(128, device=dev)
        right, left = cols[None] < stop[:, None], cols[None] >= start[:, None]
        # rows 0-15 right-padded, rows 16-31 left-padded: one pad run each
        ids = torch.where(torch.cat([right[:16], left[16:]]), ids, torch.zeros_like(ids))
        batches = {
            "bert_finetune_window": ({**configs["bert_finetune_window"]["executors"]["train"]
                                      ["args"]["model"]}, ids,
                                     torch.randint(0, 2, (32,), generator=g, device=dev)),
            "vit_b16": (dict(configs["vit_b16"]["executors"]["train"]["args"]["model"]),
                        torch.rand((vb, 224, 224, 3), generator=g, device=dev),
                        torch.randint(0, 1000, (vb,), generator=g, device=dev)),
        }
        ce = create_loss("cross_entropy")
        import mlcomp_tpu_torch.models.bert as zoo_bert
        import mlcomp_tpu_torch.models.vit as zoo_vit
        from mlcomp_tpu_torch.models.zoo import dense as zoo_dense

        zoo_attention = zoo_bert.dot_product_attention
        sdpa_ = torch.nn.functional.scaled_dot_product_attention

        def sdpa_attention(q, k, v, mask=None, causal=False, scale=None, kv_start=None,
                           kv_stop=None):
            """The oracle: SDPA on (B, H, S, D) views, windows as a mask (no
            row of these batches is empty)."""
            m_ = None
            if kv_start is not None or kv_stop is not None:
                cols_ = torch.arange(k.shape[1], device=q.device)
                lo_ = fa._window(kv_start, q.shape[0], 0, q.device)
                hi_ = fa._window(kv_stop, q.shape[0], k.shape[1], q.device)
                m_ = ((cols_[None] >= lo_[:, None]) & (cols_[None] < hi_[:, None]))[:, None, None]
            return sdpa_(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=m_,
                         is_causal=causal and m_ is None, scale=scale).transpose(1, 2)

        head_in = {}

        def rec_dense(scope, x_, features, dtype, n_contract=1, use_bias=True):
            if scope.path[-1] in ("head", "cls_head", "mlm_head"):
                head_in.update(x=x_.detach(), path="/".join(scope.path))
            return zoo_dense(scope, x_, features, dtype, n_contract, use_bias)

        parity = {}
        for name, (mcfg, x, y) in batches.items():
            model = create_model(mcfg, device=dev)
            model.load_variables(*model.init_variables(SEED, dev, (1,) + tuple(x.shape[1:])),
                                 train=True)
            model.train()

            def run():
                for p_ in model.params.values():
                    p_.grad = None
                out_ = model(x)
                loss_ = ce(out_, {"x": x, "y": y})
                loss_.backward()
                res_ = {"loss": loss_.detach().float(), "logits": out_.detach().float()}
                res_.update({k_: p_.grad.float() for k_, p_ in model.params.items()})
                for p_ in model.params.values():
                    p_.grad = None
                return res_

            calls = []
            f0, b0 = fa.flash_attention_fwd, fa.flash_attention_bwd

            def rec_fwd(q, k, v, causal=False, scale=None, kv_start=None, kv_stop=None):
                res_ = f0(q, k, v, causal, scale, kv_start, kv_stop)
                calls.append(("fwd", (q, k, v, causal, scale, kv_start, kv_stop), res_))
                return res_

            def rec_bwd(q, k, v, out, lse, do, causal, scale, kv_start=None, kv_stop=None,
                        g_lse=None):
                res_ = b0(q, k, v, out, lse, do, causal, scale, kv_start, kv_stop, g_lse)
                calls.append(("bwd", (q, k, v, out, lse, do, causal, scale, kv_start, kv_stop),
                              res_))
                return res_

            fa.launches = 0
            for c in bwd_counters:
                setattr(fa, c, 0)
            fa.flash_attention_fwd, fa.flash_attention_bwd = rec_fwd, rec_bwd
            try:
                got = run()
            finally:
                fa.flash_attention_fwd, fa.flash_attention_bwd = f0, b0
            one = {"B5": fa.launches, **{c: getattr(fa, c) for c in bwd_counters}}
            if set(one.values()) != {layers[name]} or len(calls) != 2 * layers[name]:
                raise AssertionError(f"zoo parity {name}: launches {one}, {len(calls)} calls")
            call_ratio = {"fwd": 0.0, "bwd": 0.0}
            for i, (kind_, a, res_) in enumerate(calls):
                if kind_ == "fwd":
                    q, k, v, causal, sc, lo, hi = a
                    lo_t = fa._window(lo, q.shape[0], 0, dev)
                    hi_t = fa._window(hi, q.shape[0], k.shape[1], dev)
                    ref_ = fa.flash_attention_plain(q, k, v, causal, sc, lo_t, hi_t)[0]
                    abs_ = fa.flash_attention_plain(q, k, v.abs(), causal, sc, lo_t, hi_t)[0]
                    call_ratio["fwd"] = max(call_ratio["fwd"],
                                            within(f"{name} B5 call {i}", res_[0], ref_, abs_))
                else:
                    q, k, v, out, lse, do, causal, sc, lo, hi = a
                    lo_t = fa._window(lo, q.shape[0], 0, dev)
                    hi_t = fa._window(hi, q.shape[0], k.shape[1], dev)
                    refs = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal, sc,
                                                        lo_t, hi_t)
                    abss = flash_bwd_abs(q, k, v, out, lse, do, causal, sc, lo_t, hi_t)
                    for n_, o_, r_, ab_ in zip(("dq", "dk", "dv"), res_, refs, abss):
                        call_ratio["bwd"] = max(call_ratio["bwd"], within(
                            f"{name} B9 call {i} {n_}", o_, r_, ab_))
                    del refs, abss
            del calls
            fa.flash_attention_fwd, fa.flash_attention_bwd = plain_fwd, plain_bwd
            zoo_bert.dense = zoo_vit.dense = rec_dense
            try:
                ref = run()
            finally:
                fa.flash_attention_fwd, fa.flash_attention_bwd = f0, b0
                zoo_bert.dense = zoo_vit.dense = zoo_dense
            # the oracle (ROADMAP §C6): SDPA in the attention's place, the
            # same weights and batch.  The two steps without the kernels
            # against each other give the noise floor of bf16 attention
            zoo_bert.dot_product_attention = sdpa_attention
            try:
                oracle = run()
            finally:
                zoo_bert.dot_product_attention = zoo_attention
            w_head = model.params[head_in["path"] + "/kernel"].detach().float()
            b_head = model.params[head_in["path"] + "/bias"].detach().float()
            logit_abs = head_in["x"].float().abs() @ w_head.abs() + b_head.abs()
            logit_ratio = within(f"{name} logits", got["logits"], ref["logits"], logit_abs)
            loss_rel = float((got["loss"] - ref["loss"]).abs() / ref["loss"].abs())
            leaves = [k_ for k_ in ref if k_ not in ("loss", "logits")]
            gn_k = float(torch.sqrt(sum((got[k_] ** 2).sum() for k_ in leaves)))
            gn_p = float(torch.sqrt(sum((ref[k_] ** 2).sum() for k_ in leaves)))
            gn_o = float(torch.sqrt(sum((oracle[k_] ** 2).sum() for k_ in leaves)))
            floor = {"loss": float((oracle["loss"] - ref["loss"]).abs() / ref["loss"].abs()),
                     "grad_norm": abs(gn_o - gn_p) / gn_p}
            gap = {"loss": loss_rel, "grad_norm": abs(gn_k - gn_p) / gn_p}
            if any(gap[k_] > C6_FLOOR_MULTIPLE * floor[k_] for k_ in gap):
                raise AssertionError(
                    f"zoo parity {name}: the kernels' step is {gap} (relative) from the plain "
                    f"step, past {C6_FLOOR_MULTIPLE} x the bf16 noise floor {floor} (the SDPA "
                    "step against the plain step)")
            leaf_ratio = {k_: float(((got[k_] - ref[k_]).abs() / (2.0 ** -7 * (
                ref[k_].abs() + ref[k_].abs().max())).clamp_min(1e-30)).max()) for k_ in leaves}
            leaf_rel = {k_: float((got[k_] - ref[k_]).norm() / ref[k_].norm().clamp_min(1e-30))
                        for k_ in leaves}
            parity[name] = {
                "calls_err_over_limit": call_ratio, "logits_err_over_limit": logit_ratio,
                "logits_max_abs_err": float((got["logits"] - ref["logits"]).abs().max()),
                "loss_kernels": float(got["loss"]), "loss_plain": float(ref["loss"]),
                "loss_relative_err": loss_rel,
                "grad_norm_kernels": gn_k, "grad_norm_plain": gn_p, "leaves": len(leaves),
                "c6": {"loss_sdpa": float(oracle["loss"]), "grad_norm_sdpa": gn_o,
                       "noise_floor": floor, "kernels_gap": gap,
                       "floor_multiple": C6_FLOOR_MULTIPLE},
                "leaf_err_over_limit_largest": sorted(leaf_ratio.items(), key=lambda kv: -kv[1])[:5],
                "leaf_relative_err_largest": sorted(leaf_rel.items(), key=lambda kv: -kv[1])[:5],
                "leaf_relative_err_median": sorted(leaf_rel.values())[len(leaf_rel) // 2],
                "launches_one_step": one}
            log(f"zoo parity {name}: {json.dumps(parity[name])}")
            del model, got, ref, oracle
            torch.cuda.empty_cache()

        # where a ResNet-50 step's device time goes: one profiled train step
        # of the DAG's train configuration (its batch, augmentation, loss
        # and optimizer), after one unprofiled step; kernels grouped by name
        from mlcomp_tpu_torch.train.loop import Trainer

        gc.collect()
        torch.cuda.empty_cache()
        rargs = {k: v for k, v in configs["resnet50_imagenet"]["executors"]["train"][
            "args"].items() if k not in ("trace", "storage_root", "project", "dag_name")}
        rargs["data"] = {"train": {**rargs["data"]["train"], "n": 2 * ZOO_RESNET_BATCH}}
        rtr = Trainer(rargs, device=device)
        rbatches = list(rtr._loader("train"))
        rtr._train_step(rtr.state, rbatches[0])
        torch.cuda.synchronize()
        with profiled() as p_:
            t0 = time.perf_counter()
            rtr._train_step(rtr.state, rbatches[1])
            torch.cuda.synchronize()
            step_wall = (time.perf_counter() - t0) * 1e3
        per_kernel, launches_ = {}, 0
        for evt in p_.key_averages():
            us = getattr(evt, "device_time_total", None)
            us = getattr(evt, "cuda_time_total", 0.0) if us is None else us
            if us:
                per_kernel[evt.key] = per_kernel.get(evt.key, 0.0) + us / 1e3
                launches_ += evt.count
        groups = (("convolution", r"conv|cudnn|dgrad|wgrad|fprop|implicit"),
                  ("matmul", r"gemm|cutlass|sm90|xmma"),
                  ("pooling", r"pool"),
                  ("copy and pad", r"copy|pad|cat|index"),
                  ("elementwise and reductions", r"elementwise|vectorized|reduce|unrolled"))
        by_group = {}
        for key_, ms_ in per_kernel.items():
            g_ = next((n_ for n_, rx in groups if re.search(rx, key_, re.I)), "other")
            by_group[g_] = by_group.get(g_, 0.0) + ms_
        busy = sum(per_kernel.values())
        if busy <= 0:
            raise AssertionError("zoo resnet50 profiled step: no device time "
                                 f"(events {[e.key[:60] for e in p_.key_averages()][:8]})")
        resnet_profile = {
            "step_wall_ms_profiled": step_wall, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / step_wall), "kernel_launches": launches_,
            "device_ms_by_group": dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms": [(k_[:90], v_) for k_, v_ in
                               sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]]}
        log(f"zoo resnet50 profiled step: {json.dumps(resnet_profile)}")
        del rtr, rbatches
        gc.collect()
        torch.cuda.empty_cache()

        # B5 and B9 device times at the two models' attention shapes: the
        # dh-64 instance, and the route before it (the dh-128 instance on
        # operands zero-padded to 128, pads and slices included) in the
        # same process
        def timed(fn, counter=None, iters=10):
            """Device time of one call (``queued_device_ms``; a flash pass
            fails unless ``counter``'s kernels launch every call), and the
            call's time by CUDA events (median of five windows)."""
            out_ = {"device": device_ms_of(fn, counter, iters)}
            ev = time_ms([fn], iters=iters, warmup=2)
            out_["events_ms"], out_["events_ms_spread"] = float(ev), list(ev.spread)
            return out_

        def bound(nbytes, ops):
            t_b, t_o = nbytes / bw, ops / flops
            return {"bound_ms": max(t_b, t_o) * 1e3,
                    "bound_by": "bytes" if t_b >= t_o else "operations"}

        sdpa = torch.nn.functional.scaled_dot_product_attention
        shapes = {"bert_window 32x128x12x64": (32, 128, True),
                  "vit_b16 64x196x12x64": (64, 196, False)}
        flash_times = {}
        for label, (b, s, win) in shapes.items():
            q, k, v, do = (torch.randn(b, s, 12, 64, generator=g, device=dev).bfloat16()
                           for _ in range(4))
            lo = torch.zeros(b, dtype=torch.int32, device=dev) if win else None
            hi = torch.full((b,), s, dtype=torch.int32, device=dev) if win else None
            sc = 64 ** -0.5
            out, lse = fa.flash_attention_fwd(q, k, v, False, sc, lo, hi)
            padded = {
                "fwd": lambda: padded_route_fwd(q, k, v, False, sc, lo, hi),
                "bwd": lambda: padded_route_bwd(q, k, v, out, lse, do, False, sc, lo, hi)}
            pad_f = timed(padded["fwd"], dh128_calls)
            fwd = timed(lambda: fa.flash_attention_fwd(q, k, v, False, sc, lo, hi), dh64_calls)
            bwd = timed(lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, False, sc, lo, hi),
                        dh64_calls)
            pad_b = timed(padded["bwd"], dh128_calls)
            lq, lk, lv, ldo = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
            with torch.no_grad():
                lib_f = timed(lambda: sdpa(lq, lk, lv, scale=sc))
            lq, lk, lv = (t.requires_grad_() for t in (lq, lk, lv))
            graph = sdpa(lq, lk, lv, scale=sc)
            lib_b = timed(lambda: torch.autograd.grad(graph, (lq, lk, lv), ldo,
                                                         retain_graph=True))
            lo_t, hi_t = fa._window(lo, b, 0, dev), fa._window(hi, b, s, dev)
            plain_f = time_ms([lambda: fa.flash_attention_plain(q, k, v, False, sc, lo_t, hi_t)],
                              iters=3, warmup=1)
            plain_b = time_ms([lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, do, False,
                                                                    sc, lo_t, hi_t)],
                              iters=3, warmup=1)
            w64 = fa.flash_work(b, s, s, 12, 12, 64, False, lo, hi)
            w128 = fa.flash_work(b, s, s, 12, 12, 128, False, lo, hi)
            flash_times[label] = {
                key_: {"instance": "bf16 dh 64", "device_ms": m["device"],
                       "events_ms": m["events_ms"], "events_ms_spread": m["events_ms_spread"],
                       "padded_route_device_ms": pm["device"],
                       "padded_route_events_ms": pm["events_ms"],
                       "sdpa_device_ms": lib["device"], "sdpa_events_ms": lib["events_ms"],
                       "no_slower_than_sdpa": m["device"] <= lib["device"],
                       **bound(w64[f"{f_}_bytes"], w64[f"{f_}_ops"]),
                       "bound_ms_at_dh128": bound(w128[f"{f_}_bytes"], w128[f"{f_}_ops"])["bound_ms"]}
                for key_, f_, m, pm, lib in (("B5", "fwd", fwd, pad_f, lib_f),
                                             ("B9", "bwd", bwd, pad_b, lib_b))}
            flash_times[label]["B5"]["plain_ms"] = float(plain_f)
            flash_times[label]["B9"]["plain_ms"] = float(plain_b)
            log(f"zoo flash {label}: {json.dumps(flash_times[label])}")
            del q, k, v, do, out, lse, lq, lk, lv, ldo, graph, padded
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    rn = dags["resnet50_imagenet"]
    rstep = rn["train_ms_per_step"]
    n_valid = configs["resnet50_imagenet"]["executors"]["train"]["args"]["data"]["valid"]["n"]
    result = {
        "reduced": reduced, "card": smi,
        "resnet50": {"batch": ZOO_RESNET_BATCH, "ms_per_step": rstep,
                     "train_images_s": ZOO_RESNET_BATCH * 1e3 / rstep["median"],
                     "valid_images_s": n_valid * 1e3 / rstep["eval_epoch_ms"][-1],
                     "peak_gb": rn["peak_gb"]},
        "ms_per_step": {n: dags[n]["train_ms_per_step"] for n in
                        ("unet_segmentation", "bert_finetune", "bert_finetune_window", "vit_b16")},
        "dag_wall_s": {n: r["wall_s"] for n, r in dags.items()},
        "statuses": {n: r["statuses"] for n, r in dags.items()},
        "launches": {n: r["launches"] for n, r in dags.items()},
        "reports": {n: r["reports"] for n, r in dags.items() if r["reports"]},
        "resnet50_profiled_step": resnet_profile,
        "parity": parity, "flash": flash_times, "phase_s": time.perf_counter() - t_phase,
    }
    log(f"model zoo ({smi}): ResNet-50 {result['resnet50']['train_images_s']:.1f} images/s "
        f"training ({rstep['median']:.1f} ms/step, {rstep['spread']}), "
        f"{result['resnet50']['valid_images_s']:.1f} images/s valid, peak {rn['peak_gb']:.2f} GB; "
        f"phase {result['phase_s']:.1f} s")
    return result


# phase "moe": moe_lm at the serving configuration's widths (the 1.2B LM's
# attention, an 8-expert top-2 FFN in every second layer), served with
# `serve --quantize kernel --kv-quant` through the continuous engine, then
# trained a few steps at one card's share of a batch
# (its 16 layers cut to 8, as CFG's)
MOE_CFG = {"name": "moe_lm", "vocab_size": 32768, "hidden": 2048, "layers": 8, "heads": 16,
           "n_experts": 8, "d_ff": 8192, "k": 2, "moe_every": 2, "capacity_factor": 1.25,
           "dtype": "bfloat16", "kv_quant": True}
MOE_SERVE = {"requests": 8, "new": 32, "first_token_prompts": 8, "first_token_pool": 64,
             "first_token_len": 256}
MOE_TRAIN = {"batch": 2, "seq": 2048, "steps": 4,
             "optimizer": {"name": "adafactor", "lr": 1e-2}}
# the moe train steps' aux loss is held within this multiple of its balanced
# floor (the sum of the MoE layers' aux weights)
MOE_AUX_BOUND = 2.0
# phase "attention dims and dtypes": the LM step with heads of 256 is the
# train phase's 1.2B LM with 8 heads; the f32 LM step with heads of 256 is
# cut to ATTN_F32_LM's depth and batch (printed on its `reduced` line)
ATTN_LM_HEADS = 8
ATTN_F32_LM = {"layers": 2, "batch": 1, "seq": 2048}
# the kernel checks (label, dtype, B, S, H, Hkv, dh, causal, windows, timing
# iterations): bf16 at head dim 256 at the LM's shape (B10's grid), GQA,
# windows over 2048 keys (B11's), a BERT-sized batch with key padding (B9's
# rectangle) and a ragged S; bf16 at head dim 64 (the unpadded instance,
# timed beside the route before it: the dh-128 instance on operands padded
# to 128) at BERT's window, ViT-B/16's ragged 64 x 196, causal GQA (B10's
# grid) and windows (B11's); f32 at head dims 128 and 256 and BERT's 64
# (the f32 dh-64 instance).  Every windowed case holds an empty row
ATTN_CASES = [
    ("LM training 2x4096, 8 heads of 256, causal", "bf16", 2, 4096, 8, 8, 256, True, None, 10),
    ("GQA 2x4096, 8 q heads on 2 kv heads of 256, causal", "bf16", 2, 4096, 8, 2, 256, True,
     None, 10),
    ("4x2048 key-padding windows, 8 heads of 256, one empty row", "bf16", 4, 2048, 8, 8, 256,
     False, "windows", 10),
    ("32x128, 4 heads of 256, key padding, one empty row", "bf16", 32, 128, 4, 4, 256, False,
     "padding", 10),
    ("ragged 3x1000, 8 q heads on 4 kv heads of 192, causal", "bf16", 3, 1000, 8, 4, 192, True,
     None, 10),
    ("BERT 32x128, 12 heads of 64, key padding, one empty row", "bf16", 32, 128, 12, 12, 64,
     False, "padding", 10),
    ("ViT-B/16 64x196, 12 heads of 64 (ragged S)", "bf16", 64, 196, 12, 12, 64, False, None, 10),
    ("GQA 2x4096, 16 q heads on 4 kv heads of 64, causal", "bf16", 2, 4096, 16, 4, 64, True,
     None, 10),
    ("4x2048 key-padding windows, 16 heads of 64, one empty row", "bf16", 4, 2048, 16, 16, 64,
     False, "windows", 10),
    ("f32 LM 1x2048, 16 heads of 128, causal", "f32", 1, 2048, 16, 16, 128, True, None, 3),
    ("f32 2x1024 key-padding windows, 8 heads of 128, one empty row", "f32", 2, 1024, 8, 8,
     128, False, "windows", 3),
    ("f32 LM 1x2048, 8 heads of 256, causal", "f32", 1, 2048, 8, 8, 256, True, None, 3),
    ("f32 2x1024 key-padding windows, 4 heads of 256, one empty row", "f32", 2, 1024, 4, 4,
     256, False, "windows", 3),
    ("f32 BERT 32x128, 12 heads of 64, key padding, one empty row", "f32", 32, 128, 12, 12, 64,
     False, "padding", 3),
]
# f32 peaks outside the tensor cores (FFMA), dense, per card (data sheets);
# the f32 kernels' products also run as 3xTF32 on the tensor cores, three
# TF32 passes a product at half the bf16 rate each: the bf16 peak / 6
F32_PEAKS = {"H100 SXM": 67e12, "H100 PCIe": 51e12, "H100 NVL": 60e12, "H200": 67e12}
TF32X3_OF_BF16 = 6


def queued_device_ms(fn, iters=10) -> float:
    """Device time of one call by CUDA events around ``iters`` calls queued
    behind a spin kernel: the host enqueues every call while the card
    spins, so the card runs them back to back and the events see the
    calls' device time, the gaps between them included, and not the host's
    launch overhead.  The spin doubles until the host's enqueueing fits
    inside it."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES
    for _ in range(4):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        torch.cuda._sleep(cycles)
        marks[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        marks[2].record()
        torch.cuda.synchronize()
        if host_ms < 0.8 * marks[0].elapsed_time(marks[1]):
            return marks[1].elapsed_time(marks[2]) / iters
        cycles *= 2
    raise AssertionError(f"queued device time: the host's {host_ms:.2f} ms of enqueueing "
                         "outran every spin")


def device_ms_of(fn, counter=None, iters=10):
    """Device time of one call (``queued_device_ms``); ``counter`` reads
    the launch count of the kernel the call must run: the pass fails when
    it did not launch once a call."""
    before = counter() if counter else 0
    ms = queued_device_ms(fn, iters)
    if counter and counter() - before < iters + 2:
        raise AssertionError(f"device time: the kernel launched {counter() - before} times in "
                             f"{iters + 2} calls")
    return ms


# the instances whose backward the attention phase times kernel by kernel
BWD_PARTS_LABELS = {"dh256": "dh-256", "dh64": "dh-64", "f32": "f32"}


def bwd_parts_device_ms(q, k, v, out, lse, do, causal, sc, lo=None, hi=None, iters=10) -> dict:
    """Queued device ms of the backward's three kernels apart (delta, dq,
    dk/dv), bf16 or f32 by the operands' dtype, each launched alone through
    its C launcher on the operands the wrapper gives it
    (``_kernel_inputs``), so that a time reads one kernel; these launches
    count on no wrapper counter.  The launchers' C interface has stayed the
    same through the kernels' redesigns, so a parent tree's kernels time
    the same way."""
    import ctypes

    from mlcomp_tpu_torch.ops.cuda import build
    from mlcomp_tpu_torch.ops.cuda import flash_attention as fa

    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    lo_t, hi_t = fa._window(lo, b, 0, q.device), fa._window(hi, b, s_k, q.device)
    kd, (q, k, v, out, do) = fa._kernel_inputs(d, q, k, v, out, do)
    lse = lse.float().contiguous()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    stream = build.stream_ptr(q.device)
    _, stem, prefix = fa._LIBS[q.dtype]
    delta = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    l_delta = build.function(stem, f"{prefix}_bwd_delta_launch", [p] * 4 + [i] * 4 + [p])
    l_dq = build.function(stem, f"{prefix}_bwd_dq_launch", [p] * 9 + [i] * 7 + [f, p])
    l_dkv = build.function(stem, f"{prefix}_bwd_dkv_launch", [p] * 10 + [i] * 7 + [f, p])
    ints = (b, h, h_kv, s_q, s_k, kd, int(bool(causal)), sc, stream)

    def run_delta():
        build.check(l_delta(do.data_ptr(), out.data_ptr(), None, delta.data_ptr(), b, h, s_q, kd,
                            stream), "delta")

    def run_dq():
        build.check(l_dq(*(t.data_ptr() for t in (q, k, v, do, lse, delta, lo_t, hi_t, dq)),
                         *ints), "dq")

    def run_dkv():
        build.check(l_dkv(*(t.data_ptr() for t in (q, k, v, do, lse, delta, lo_t, hi_t, dk, dv)),
                          *ints), "dk/dv")

    run_delta()
    torch.cuda.synchronize()
    return {"delta": queued_device_ms(run_delta, iters), "dq": queued_device_ms(run_dq, iters),
            "dkv": queued_device_ms(run_dkv, iters)}


def attention_dims_phase(device, smi, bw, flops, f32_flops):
    """Phase "attention dims and dtypes" (ROADMAP §C5): the flash kernels'
    instances beside bf16 at 128, bf16 at head dims 256 and 64 and f32 at
    128 and 256, each held
    against its plain version at shapes that reach every TPU grid (B10's
    causal, B11's windows, B9's rectangle, with an empty row where windows
    are) with the kernel phase's rule (2^-7 (|ref| + ref_abs) for bf16;
    2^-16 for f32, whose 3xTF32 products keep ~2^-22 of each operand and
    whose dp runs on the CUDA cores, and by the SFU-free expf's ulps),
    bit-equal on a rerun, with times beside the plain version's, SDPA's
    (events and device) and the card's bound (f32: the smaller of the
    3xTF32 and FFMA bounds, the FFMA one also as ``bound_ffma_ms``; at head
    dim 64 also the padded route's: the dh-128 instance on operands
    zero-padded to 128, the path before the dh-64 instance).  The f32
    and bf16 dh-64 kernels' resources are printed first (the dh-64 ones
    with their registers after setmaxnreg), and a spill fails the phase.
    Then the paths: one train step of the 1.2B LM with 8 heads of 256 (the
    dh-256 kernels launch 16 times each; loss and gradient norm against the
    plain step with the train parity's rule), an f32 BERT-window step and
    an f32 LM step with heads of 256 (the f32 kernels; against their plain
    steps, each step's ms beside the plain step's), and the 1.2B LM's `remat: true` and `fused_loss: true` steps
    against its plain step (loss within 1e-5 relative, gradient norm within
    1e-4), each with its peak memory."""
    import yaml

    from mlcomp_tpu_torch.io.weights import from_flax_params, init_params
    from mlcomp_tpu_torch.models import create_model
    from mlcomp_tpu_torch.ops.cuda import flash_attention as fa
    from mlcomp_tpu_torch.train.losses import create_loss
    from mlcomp_tpu_torch.train.loop import Trainer

    t_phase = time.perf_counter()
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(SEED + 16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {"fwd_dh256": [], "bwd_dh256": [], "fwd_dh64": [], "bwd_dh64": [], "fwd_f32": [],
            "bwd_f32": []}

    def bound(nbytes, ops, peak):
        t_b, t_o = nbytes / bw, ops / peak
        return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_b, t_o) * 1e3,
                "bound_by": "bytes" if t_b >= t_o else "operations"}

    def f32_bound(nbytes, ops):
        # 3xTF32 on the tensor cores or FFMA, whichever is faster; the
        # FFMA bound stays beside it
        tc, ffma = bound(nbytes, ops, flops / TF32X3_OF_BF16), bound(nbytes, ops, f32_flops)
        return {**min(tc, ffma, key=lambda x: x["bound_ms"]), "bound_ffma_ms": ffma["bound_ms"]}

    all_res = fa.resources()
    f32_res = {k_: v_ for k_, v_ in all_res.items() if k_.startswith("f32_")}
    log(f"attention dims: f32 flash kernel resources ({smi}): " + json.dumps(f32_res))
    # the bf16 dh-64 kernels: registers at launch and after setmaxnreg
    # (producer and consumers)
    dh64_res = {k_: v_ for k_, v_ in all_res.items() if k_.endswith("_64")
                and not k_.startswith("f32_")}
    for k_, regs in fa.dh64_registers().items():
        dh64_res[k_] = {**dh64_res[k_], "producer_regs": regs["producer"],
                        "consumer_regs": regs["consumer"]}
    log(f"attention dims: bf16 dh-64 flash kernel resources ({smi}): " + json.dumps(dh64_res))
    spills = [k_ for k_, v_ in {**f32_res, **dh64_res}.items() if v_["local_bytes"]]
    if spills:
        raise AssertionError(f"f32 or dh-64 flash kernels spill registers: {spills}")

    def held(label, out, ref, ref_abs, tol):
        diff = (out.float() - ref.float()).abs()
        limit = tol * (ref.float().abs() + ref_abs.float())
        ratio = float((diff / limit.clamp_min(1e-30)).max())
        if not math.isfinite(ratio) or ratio > 1.0:
            raise AssertionError(f"{label}: |kernel - plain| at {ratio:.3f} of its limit")
        return float(diff.max()), ratio

    def case(label, dtype, b, s, h, h_kv, d, causal, lo=None, hi=None, iters=10):
        f32 = dtype == torch.float32
        key = "f32" if f32 else f"dh{fa.kernel_dh(d, dtype)}"
        tol = 2.0 ** -16 if f32 else 2.0 ** -7
        bound_of = f32_bound if f32 else (lambda n_, o_: bound(n_, o_, flops))
        sc = d ** -0.5
        q, k, v, do = (torch.randn(b, s, hh, d, generator=g, device=dev).to(dtype)
                       for hh in (h, h_kv, h_kv, h))
        lo_t, hi_t = fa._window(lo, b, 0, dev), fa._window(hi, b, s, dev)
        out, lse = fa.flash_attention_fwd(q, k, v, causal, sc, lo, hi)
        grads = fa.flash_attention_bwd(q, k, v, out, lse, do, causal, sc, lo, hi)
        out2, lse2 = fa.flash_attention_fwd(q, k, v, causal, sc, lo, hi)
        grads2 = fa.flash_attention_bwd(q, k, v, out, lse, do, causal, sc, lo, hi)
        if not (torch.equal(out, out2) and torch.equal(lse, lse2)
                and all(torch.equal(x, y) for x, y in zip(grads, grads2))):
            raise AssertionError(f"{label}: two runs on the same inputs differ")
        del out2, lse2, grads2
        ref, ref_lse = fa.flash_attention_plain(q, k, v, causal, sc, lo_t, hi_t)
        ref_abs = fa.flash_attention_plain(q, k, v.abs(), causal, sc, lo_t, hi_t)[0]
        f_err, f_ratio = held(f"{label} forward", out, ref, ref_abs, tol)
        live = ref_lse > -1e29
        lse_err = float((lse - ref_lse).abs()[live].max())
        if bool((lse[~live] != -1e30).any()) or bool((out.float().abs().sum(-1)
                                                      [live.transpose(1, 2) == 0] != 0).any()):
            raise AssertionError(f"{label}: an empty row's output is not 0 with lse -1e30")
        del ref, ref_abs
        refs = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal, sc, lo_t, hi_t)
        abss = flash_bwd_abs(q, k, v, out, lse, do, causal, sc, lo_t, hi_t)
        b_err = b_ratio = 0.0
        for n_, a_, r_, ab_ in zip(("dq", "dk", "dv"), grads, refs, abss):
            e_, rt_ = held(f"{label} backward {n_}", a_, r_, ab_, tol)
            b_err, b_ratio = max(b_err, e_), max(b_ratio, rt_)
        del refs, abss
        if lo is not None or hi is not None:
            for row in (hi_t <= lo_t).nonzero().flatten().tolist():
                if any(bool(x[row].float().abs().max() != 0) for x in (out, *grads)):
                    raise AssertionError(f"{label}: the empty row {row} is not all zeros")
        torch.cuda.empty_cache()
        kf = time_ms([lambda: fa.flash_attention_fwd(q, k, v, causal, sc, lo, hi)],
                     iters=iters, warmup=2)
        kb = time_ms([lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, causal, sc, lo, hi)],
                     iters=iters, warmup=2)
        pf = time_ms([lambda: fa.flash_attention_plain(q, k, v, causal, sc, lo_t, hi_t)],
                     iters=1, warmup=1, windows=3)
        pb = time_ms([lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal, sc,
                                                           lo_t, hi_t)],
                     iters=1, warmup=1, windows=3)
        fwd_count = "f32_fwd_launches" if f32 else f"fwd_{key}_launches"
        bwd_count = "f32_bwd_launches" if f32 else f"bwd_{key}_launches"
        padded = {}
        if key == "dh64":
            # the route before the dh-64 instance, in the same process
            padded["padded_route_fwd_device_ms"] = device_ms_of(
                lambda: padded_route_fwd(q, k, v, causal, sc, lo, hi), dh128_calls)
        dkf = device_ms_of(lambda: fa.flash_attention_fwd(q, k, v, causal, sc, lo, hi),
                           lambda: getattr(fa, fwd_count))
        dkb = device_ms_of(lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, causal, sc,
                                                          lo, hi),
                           lambda: getattr(fa, bwd_count))
        if key == "dh64":
            padded["padded_route_bwd_device_ms"] = device_ms_of(
                lambda: padded_route_bwd(q, k, v, out, lse, do, causal, sc, lo, hi),
                dh128_calls)
        if key in ("dh256", "dh64", "f32"):
            # the backward's time split between its kernels (delta, dq, dk/dv)
            padded["bwd_parts_device_ms"] = bwd_parts_device_ms(q, k, v, out, lse, do, causal,
                                                                sc, lo, hi)
        # the yardstick: SDPA on copies in its (B, H, S, D) layout, the kv
        # heads repeated for GQA, windows as a boolean mask
        rep = h // h_kv
        mask = None
        if lo is not None or hi is not None:
            cols = torch.arange(s, device=dev)
            mask = ((cols[None] >= lo_t[:, None]) & (cols[None] < hi_t[:, None]))[:, None, None]
            if causal:
                mask = mask & (cols[:, None] >= cols[None, :])
        lq = q.transpose(1, 2).contiguous()
        lk, lv = (t.repeat_interleave(rep, 2).transpose(1, 2).contiguous() for t in (k, v))
        ldo = do.transpose(1, 2).contiguous()

        def lib_f():
            with torch.no_grad():
                sdpa(lq, lk, lv, attn_mask=mask, is_causal=causal and mask is None, scale=sc)

        lf = time_ms([lib_f], iters=iters, warmup=2)
        dlf = device_ms_of(lib_f)
        lq, lk, lv = (t.requires_grad_() for t in (lq, lk, lv))
        graph = sdpa(lq, lk, lv, attn_mask=mask, is_causal=causal and mask is None, scale=sc)

        def lib_b():
            torch.autograd.grad(graph, (lq, lk, lv), ldo, retain_graph=True)

        lb = time_ms([lib_b], iters=iters, warmup=2)
        dlb = device_ms_of(lib_b)
        del graph, lq, lk, lv, ldo
        win = lo is not None or hi is not None
        work = fa.flash_work(b, s, s, h, h_kv, d, causal, lo, hi, itemsize=4 if f32 else 2)
        grid = bwd_grid(causal, win, s)
        common = dict(case=label, dtype="f32" if f32 else "bf16", b=b, s=s, h=h, h_kv=h_kv,
                      dh=d, kernel_dh=fa.kernel_dh(d, dtype), causal=causal, windowed=win,
                      live_pairs=work["live_pairs"], bit_equal_reruns=True)
        fwd_row = dict(common, max_abs_err=f_err, err_over_limit=f_ratio, lse_err=lse_err,
                       ms=kf, device_ms=dkf, plain_ms=pf, library_ms=lf, library_device_ms=dlf,
                       **{k_: v_ for k_, v_ in padded.items() if "fwd" in k_},
                       **bound_of(work["fwd_bytes"], work["fwd_ops"]))
        bwd_row = dict(common, grid=grid, replaces_row=GRID_KEYS[grid], max_abs_err=b_err,
                       err_over_limit=b_ratio, ms=kb, device_ms=dkb, plain_ms=pb,
                       library_ms=lb, library_device_ms=dlb,
                       **{k_: v_ for k_, v_ in padded.items() if "bwd" in k_},
                       **bound_of(work["bwd_bytes"], work["bwd_ops"]))
        for part, row in (("fwd", fwd_row), ("bwd", bwd_row)):
            for f_, v_ in list(row.items()):
                if isinstance(v_, Ms):
                    row[f"{f_}_spread"] = list(v_.spread)
            rows[f"{part}_{key}"].append(row)
            log(f"  {part} {json.dumps(row)}")
        if key in ("dh256", "dh64", "f32"):
            log(f"  {BWD_PARTS_LABELS[key]} backward ({smi}), queued device ms: "
                + json.dumps({"case": label, **bwd_row["bwd_parts_device_ms"], "whole": dkb,
                              "sdpa_backward": dlb, "bound_ms": bwd_row["bound_ms"],
                              **({"bound_ffma_ms": bwd_row["bound_ffma_ms"],
                                  "forward": dkf, "sdpa_forward": dlf,
                                  "forward_bound_ms": fwd_row["bound_ms"],
                                  "forward_bound_ffma_ms": fwd_row["bound_ffma_ms"]}
                                 if f32 else {})}))
        del q, k, v, do, out, lse, grads
        torch.cuda.empty_cache()

    i32 = dict(dtype=torch.int32, device=dev)
    for label, dt, b, s, h, h_kv, d, causal, win, iters in ATTN_CASES:
        lo = hi = None
        if win == "windows":
            # windows inside the keys, the last row's empty
            lo = torch.randint(0, s // 4, (b,), generator=g, **i32)
            hi = lo + torch.randint(s // 8, s * 3 // 4, (b,), generator=g, **i32)
            hi[-1] = lo[-1]
        elif win == "padding":
            # key padding from 0, row 5's (or the last's) empty
            lo = torch.zeros(b, **i32)
            hi = torch.randint(16, s + 1, (b,), generator=g, **i32)
            hi[min(5, b - 1)] = 0
        case(label, torch.float32 if dt == "f32" else torch.bfloat16, b, s, h, h_kv, d, causal,
             lo, hi, iters)

    # ---- the paths.  Every count is set to 0 just before a path and read
    # just after it
    counters = ("launches", "bwd_delta_launches", "bwd_dq_launches", "bwd_dkv_launches",
                "fwd_dh64_launches", "bwd_dh64_launches", "fwd_dh256_launches",
                "bwd_dh256_launches", "f32_fwd_launches", "f32_bwd_launches")

    def reset():
        for c_ in counters:
            setattr(fa, c_, 0)

    def counts():
        return {c_: getattr(fa, c_) for c_ in counters}

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

    @contextmanager
    def plain_attention():
        saved = (fa.flash_attention_fwd, fa.flash_attention_bwd)
        fa.flash_attention_fwd, fa.flash_attention_bwd = plain_fwd, plain_bwd
        try:
            yield
        finally:
            fa.flash_attention_fwd, fa.flash_attention_bwd = saved

    def step_ms(model, params, loss_fn, x, y=None):
        """ms of one forward and backward of ``model`` (CUDA events, the
        median of three windows of three steps); gradients cleared after"""
        batch = {"x": x} if y is None else {"x": x, "y": y}
        ms = time_ms([lambda: loss_fn(model(x), batch).backward()], iters=3, warmup=1,
                     windows=3)
        for p_ in params.values():
            p_.grad = None
        return ms

    def loss_and_gnorm(model, params, loss_fn, x, y=None):
        for p_ in params.values():
            p_.grad = None
        torch.cuda.reset_peak_memory_stats()
        batch = {"x": x} if y is None else {"x": x, "y": y}
        loss_ = loss_fn(model(x), batch)
        loss_.backward()
        gn = torch.sqrt(sum((p_.grad.float() ** 2).sum() for p_ in params.values()))
        res = (loss_.item(), gn.item(), torch.cuda.max_memory_allocated() / 1e9)
        for p_ in params.values():
            p_.grad = None
        return res

    with open(Path(REPO) / "configs" / "multihost_lm.yml") as f:
        lm_dag = yaml.safe_load(f)
    largs = lm_dag["executors"]["pretrain"]["args"]
    lm_model = dict(largs["model"])
    seq = largs["data"]["train"]["seq_len"]
    paths = {}

    # the 1.2B LM with 8 heads of 256: one Trainer step (configs/
    # multihost_lm.yml's optimizer and loss, one card's 2 x 4096), then
    # loss and gradient norm with the kernels and with their plain versions
    # (the train parity's rule: 1e-3 relative, 2%)
    gc.collect()
    torch.cuda.empty_cache()
    pcfg = {k_: v_ for k_, v_ in largs.items() if k_ not in ("mesh", "project", "dag_name")}
    pcfg["model"] = {**lm_model, "heads": ATTN_LM_HEADS}
    pcfg["data"] = {"train": {**largs["data"]["train"], "batch_size": TRAIN_BATCH,
                              "n": TRAIN_BATCH}}
    trainer = Trainer(pcfg, device=device)
    x_lm = torch.randint(1, lm_model["vocab_size"], (TRAIN_BATCH, seq), generator=g, device=dev)
    reset()
    stats = trainer._train_step(trainer.state, {"x": x_lm})
    step_loss = float(stats["loss"])
    step_counts = counts()
    l_k, g_k, peak_k = loss_and_gnorm(trainer.model, trainer.state.params, trainer.loss_fn, x_lm)
    with plain_attention():
        l_p, g_p, peak_p = loss_and_gnorm(trainer.model, trainer.state.params, trainer.loss_fn,
                                          x_lm)
    n_layers = lm_model["layers"]
    if (step_counts["fwd_dh256_launches"] != n_layers or step_counts["bwd_dh256_launches"]
            != n_layers or step_counts["f32_fwd_launches"] or not math.isfinite(step_loss)):
        raise AssertionError(f"LM with heads of 256: step loss {step_loss}, launches "
                             f"{step_counts}; want {n_layers} of each dh-256 kernel")
    if abs(l_k - l_p) > 1e-3 * abs(l_p) or abs(g_k - g_p) > 0.02 * g_p:
        raise AssertionError(f"LM with heads of 256: loss {l_k} vs plain {l_p}, gradient norm "
                             f"{g_k} vs {g_p}")
    paths["lm_heads_256"] = {
        "model": f"configs/multihost_lm.yml's LM with heads {lm_model['heads']} -> "
                 f"{ATTN_LM_HEADS} (head dim {lm_model['hidden'] // ATTN_LM_HEADS})",
        "batch": [TRAIN_BATCH, seq], "step_loss": step_loss, "launches_one_step": step_counts,
        "loss_kernels": l_k, "loss_plain": l_p, "grad_norm_kernels": g_k, "grad_norm_plain": g_p,
        "peak_gb_kernels": peak_k, "peak_gb_plain": peak_p,
        "tolerance": "loss 1e-3 relative, gradient norm 2%"}
    log(f"attention dims: LM with heads of 256: {json.dumps(paths['lm_heads_256'])}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # remat and the fused CE head on the 1.2B LM as published (heads of
    # 128): the same weights and batch, loss within 1e-5 relative and
    # gradient norm within 1e-4 of the plain step's (remat recomputes the
    # same products; the fused head sums the same f32 logits in chunks)
    tree = init_params({**lm_model, "name": "transformer_lm"}, SEED, device=dev)
    steps = {}
    for label, extra, loss_name in (("plain", {}, "lm_cross_entropy"),
                                    ("remat", {"remat": True}, "lm_cross_entropy"),
                                    ("fused_loss", {"fused_loss": True},
                                     "lm_cross_entropy_fused")):
        m = create_model({**lm_model, **extra}, device=device)
        m.load_state(from_flax_params(tree, fold=False), train=True)
        m.train()
        reset()
        l_, g_, peak_ = loss_and_gnorm(m, m.flax_params(), create_loss(loss_name), x_lm)
        steps[label] = {"loss": l_, "grad_norm": g_, "peak_gb": peak_, "launches": counts()}
        del m
        gc.collect()
        torch.cuda.empty_cache()
    for label in ("remat", "fused_loss"):
        s_, p_ = steps[label], steps["plain"]
        # remat runs each layer's forward again in the backward
        want_fwd = (2 if label == "remat" else 1) * n_layers
        if abs(s_["loss"] - p_["loss"]) > 1e-5 * abs(p_["loss"]) or \
                abs(s_["grad_norm"] - p_["grad_norm"]) > 1e-4 * p_["grad_norm"] or \
                s_["launches"]["launches"] != want_fwd or \
                s_["launches"]["bwd_dq_launches"] != n_layers:
            raise AssertionError(f"{label} step: {s_} against the plain step {p_}")
    paths["remat_and_fused_loss"] = {**steps, "tolerance": "loss 1e-5 relative, gradient norm "
                                                           "1e-4 relative"}
    log(f"attention dims: remat and fused_loss: {json.dumps(steps)}")
    del tree
    gc.collect()
    torch.cuda.empty_cache()

    # f32 paths: BERT-window (configs/bert_finetune.yml's model, pad_mode
    # window, dtype float32) and an LM with heads of 256 in f32, cut to
    # ATTN_F32_LM; each against its plain step (f32: loss within 1e-5
    # relative, gradient norm within 1e-4)
    with open(Path(REPO) / "configs" / "bert_finetune.yml") as f:
        bert_cfg = yaml.safe_load(f)["model"]
    bert_cfg = {**bert_cfg, "pad_mode": "window", "dtype": "float32"}
    ids = torch.randint(1, bert_cfg["vocab_size"], (32, 128), generator=g, device=dev)
    stop = torch.randint(16, 129, (32,), generator=g, device=dev)
    ids = torch.where(torch.arange(128, device=dev)[None] < stop[:, None], ids,
                      torch.zeros_like(ids))
    y = torch.randint(0, bert_cfg["num_classes"], (32,), generator=g, device=dev)
    bert = create_model(bert_cfg, device=device)
    bert.load_variables(*bert.init_variables(SEED, dev, (1, 128)), train=True)
    bert.train()
    ce = create_loss("cross_entropy")
    reset()
    l_k, g_k, peak_k = loss_and_gnorm(bert, bert.params, ce, ids, y)
    bert_counts = counts()
    with plain_attention():
        l_p, g_p, _ = loss_and_gnorm(bert, bert.params, ce, ids, y)
        ms_p = step_ms(bert, bert.params, ce, ids, y)
    ms_k = step_ms(bert, bert.params, ce, ids, y)
    n_bert = bert.layers
    if bert_counts["f32_fwd_launches"] != n_bert or bert_counts["f32_bwd_launches"] != n_bert \
            or abs(l_k - l_p) > 1e-5 * abs(l_p) or abs(g_k - g_p) > 1e-4 * g_p:
        raise AssertionError(f"f32 BERT-window step: loss {l_k} vs {l_p}, gradient norm {g_k} "
                             f"vs {g_p}, launches {bert_counts}")
    paths["f32_bert_window"] = {"batch": [32, 128], "loss_kernels": l_k, "loss_plain": l_p,
                                "grad_norm_kernels": g_k, "grad_norm_plain": g_p,
                                "peak_gb": peak_k, "launches_one_step": bert_counts,
                                "step_ms_kernels": ms_k, "step_ms_plain": ms_p}
    log(f"attention dims: f32 BERT-window: {json.dumps(paths['f32_bert_window'])}")
    del bert
    gc.collect()
    torch.cuda.empty_cache()

    f_cfg = {**lm_model, "name": "transformer_lm", "heads": ATTN_LM_HEADS,
             "layers": ATTN_F32_LM["layers"], "dtype": "float32"}
    reduced = {"f32 LM with heads of 256": (
        f"configs/multihost_lm.yml's LM in f32 with {ATTN_LM_HEADS} heads, layers "
        f"{lm_model['layers']} -> {ATTN_F32_LM['layers']}, batch {TRAIN_BATCH}x{seq} -> "
        f"{ATTN_F32_LM['batch']}x{ATTN_F32_LM['seq']} (the f32 kernels: 3xTF32 products on the "
        f"tensor cores, dp on the CUDA cores)")}
    log("reduced (attention dims and dtypes): " + json.dumps(reduced))
    m = create_model(f_cfg, device=device)
    m.load_state(from_flax_params(init_params(f_cfg, SEED, device=dev), fold=False), train=True)
    m.train()
    x_f = torch.randint(1, f_cfg["vocab_size"], (ATTN_F32_LM["batch"], ATTN_F32_LM["seq"]),
                        generator=g, device=dev)
    lm_ce = create_loss("lm_cross_entropy")
    reset()
    l_k, g_k, peak_k = loss_and_gnorm(m, m.flax_params(), lm_ce, x_f)
    f_counts = counts()
    with plain_attention():
        l_p, g_p, _ = loss_and_gnorm(m, m.flax_params(), lm_ce, x_f)
        ms_p = step_ms(m, m.flax_params(), lm_ce, x_f)
    ms_k = step_ms(m, m.flax_params(), lm_ce, x_f)
    if f_counts["f32_fwd_launches"] != f_cfg["layers"] or \
            f_counts["f32_bwd_launches"] != f_cfg["layers"] or \
            abs(l_k - l_p) > 1e-5 * abs(l_p) or abs(g_k - g_p) > 1e-4 * g_p:
        raise AssertionError(f"f32 LM with heads of 256: loss {l_k} vs {l_p}, gradient norm "
                             f"{g_k} vs {g_p}, launches {f_counts}")
    paths["f32_lm_heads_256"] = {"loss_kernels": l_k, "loss_plain": l_p, "grad_norm_kernels": g_k,
                                 "grad_norm_plain": g_p, "peak_gb": peak_k,
                                 "launches_one_step": f_counts, "step_ms_kernels": ms_k,
                                 "step_ms_plain": ms_p}
    log(f"attention dims: f32 LM with heads of 256: {json.dumps(paths['f32_lm_heads_256'])}")
    del m
    gc.collect()
    torch.cuda.empty_cache()
    result = {"rows": rows, "paths": paths, "reduced": reduced, "card": smi,
              "phase_s": time.perf_counter() - t_phase}
    log(f"attention dims and dtypes ({smi}): phase {result['phase_s']:.1f} s")
    return result


def moe_phase(device, smi, bw, flops):
    """Phase "moe": ``moe_lm`` at MOE_CFG's widths (random weights from the
    seed) served as ``serve --quantize kernel --kv-quant`` serves it, through
    the continuous engine: MOE_SERVE's greedy requests sent alone must give
    the tokens they get inside one batch of 8; the int8 experts' slices run
    through B1 (16 launches in each MoE layer per decode step, on top of
    the dense layers' projections and the head, counted over decode steps);
    the first new token of the quantized scan must equal entry-dequant
    decoding's (tests/test_quant.py's check) on the prompts whose
    entry-dequant top-2 margin is widest; then MOE_TRAIN's Trainer steps at
    the same widths: objective and aux loss finite, the cross-entropy lower
    after the last step than at the first, and the aux loss of every step
    within MOE_AUX_BOUND x its balanced floor."""
    from mlcomp_tpu_torch.io.weights import flatten, init_params
    from mlcomp_tpu_torch.models import create_model
    from mlcomp_tpu_torch.models.generation import generate, load_decode_weights
    from mlcomp_tpu_torch.ops.cuda import quant_matmul as qm
    from mlcomp_tpu_torch.serve import load_service
    from mlcomp_tpu_torch.train.loop import Trainer, sown_losses

    t_phase = time.perf_counter()
    dev = torch.device(device)
    cpu_rng = torch.Generator().manual_seed(SEED + 17)
    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    vocab, n_new = MOE_CFG["vocab_size"], MOE_SERVE["new"]
    params = init_params(MOE_CFG, SEED, device=dev)
    n_params = sum(t.numel() for t in flatten(params).values())
    t0 = time.perf_counter()
    service = load_service(MOE_CFG, params=params, device=device, quantize="kernel",
                           batch_sizes=(1, BATCH), prompt_buckets=(PROMPT,),
                           max_new_buckets=(n_new,), prefill_chunk=CHUNK)
    model, eng = service.model, service.engine
    if service.batcher != "continuous" or model.fold_norms:
        raise AssertionError(f"moe service: batcher {service.batcher}, fold_norms "
                             f"{model.fold_norms}")
    blk = model.layers[1].moe
    if not (isinstance(blk.w1, dict) and blk.w1["q8"].dtype == torch.int8
            and tuple(blk.w1["q8_scale"].shape) == (MOE_CFG["n_experts"], 1, MOE_CFG["d_ff"])):
        raise AssertionError("moe service: the stacked experts are not int8 with per-expert "
                             "per-channel scales")
    # the modules' buffers and the stacked int8 experts (plain attributes)
    int8_gb = (sum(t.numel() * t.element_size() for t in model.state_dict().values())
               + sum(t.numel() * t.element_size() for _, b in model.moe_blocks()
                     for w in (b.w1, b.w2) for t in w.values())) / 1e9
    load_s = time.perf_counter() - t0
    log(f"moe: {n_params / 1e9:.3f} B parameters; load_service (continuous, int8 kernel, "
        f"int8 KV) {load_s:.2f} s, {int8_gb:.2f} GB of weights on the card")

    prompts = [torch.randint(1, vocab, (n,), generator=cpu_rng).tolist()
               for n in torch.linspace(100, 500, MOE_SERVE["requests"]).long().tolist()]
    eng.submit(prompts[0][:16], 2, _count=False).result(timeout=600)   # warm
    qm.launches = qm.norm_launches = 0
    t0 = time.perf_counter()
    batched = [f.result(timeout=600)["ids"] for f in [eng.submit(p, n_new) for p in prompts]]
    batch_wall = time.perf_counter() - t0
    serve_counts = {"B1": qm.launches, "B2": qm.norm_launches}
    alone = [eng.submit(p, n_new).result(timeout=600)["ids"] for p in prompts]
    if alone != batched:
        raise AssertionError(f"moe: greedy requests alone differ from the batch of "
                             f"{len(prompts)}: {sum(a != b for a, b in zip(alone, batched))} "
                             "requests differ")
    if serve_counts["B1"] <= 0 or serve_counts["B2"]:
        raise AssertionError(f"moe serve launches {serve_counts}: want B1 and no norm prologue")

    # B1 per decode step and decode ms per step, at 8 rows: generate with
    # 1 and with 1 + n new tokens, the difference over n steps
    x8 = torch.randint(1, vocab, (BATCH, 200), generator=g, device=dev)
    times, b1 = {}, {}
    for n in (1, 1 + n_new):
        generate(model, x8, n)
        torch.cuda.synchronize()
        qm.launches = qm.norm_launches = 0
        t0 = time.perf_counter()
        generate(model, x8, n)
        torch.cuda.synchronize()
        times[n], b1[n] = time.perf_counter() - t0, (qm.launches, qm.norm_launches)
    per_step_b1 = (b1[1 + n_new][0] - b1[1][0]) / n_new
    n_moe = MOE_CFG["layers"] // MOE_CFG["moe_every"]
    n_dense = MOE_CFG["layers"] - n_moe
    want_b1 = n_dense * 7 + n_moe * (4 + 2 * MOE_CFG["n_experts"]) + 1
    if per_step_b1 != want_b1 or b1[1 + n_new][1] != b1[1][1]:
        raise AssertionError(f"moe decode step: {per_step_b1} B1 launches a step, B2 "
                             f"{b1[1 + n_new][1] - b1[1][1]}; want {want_b1} (16 in each of "
                             f"the {n_moe} MoE layers) and no B2")
    decode_ms = (times[1 + n_new] - times[1]) * 1e3 / n_new

    # the first new token: the quantized scan against entry dequant (the int8
    # tree dequantized once to bf16) on prompts of one length, no padding.
    # The two round differently (bf16 weights against int8 codes scaled in
    # f32), so random weights leave some top-2 margins below the logits'
    # difference: the check holds the prompts of a pool whose entry-dequant
    # margin is widest, chosen from the reference alone
    xf = torch.randint(1, vocab, (MOE_SERVE["first_token_pool"],
                                  MOE_SERVE["first_token_len"]), generator=g, device=dev)

    def last_logits(m_):
        with torch.inference_mode():
            return torch.cat([m_(xc, last_only=True)[:, -1].float()
                              for xc in xf.split(MOE_SERVE["first_token_prompts"])])

    lk = last_logits(model)
    del service, model, eng
    gc.collect()
    torch.cuda.empty_cache()
    deq = create_model({k_: v_ for k_, v_ in MOE_CFG.items()}, device=device)
    load_decode_weights(deq, params, quantize="int8")
    ld = last_logits(deq)
    del deq
    gc.collect()
    torch.cuda.empty_cache()
    top2 = ld.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    held_rows = margin.topk(MOE_SERVE["first_token_prompts"]).indices
    same = lk.argmax(-1) == ld.argmax(-1)
    diff = float((lk - ld).abs().max())
    if not bool(same[held_rows].all()):
        raise AssertionError(f"moe: the quantized scan's first token differs from entry "
                             f"dequant's on {int((~same[held_rows]).sum())} of the "
                             f"{len(held_rows)} widest-margin prompts (margins "
                             f"{margin[held_rows].tolist()}, largest logit difference {diff})")
    first_token = {"pool": int(xf.shape[0]), "held": len(held_rows),
                   "equal_held": int(same[held_rows].sum()), "equal_pool": int(same.sum()),
                   "max_abs_logit_diff": diff,
                   "smallest_held_top2_margin": float(margin[held_rows].min())}

    # training: MOE_TRAIN's steps through the Trainer's step on its
    # loader's first batch (the step adds every MoE layer's aux loss to the
    # objective, as the JAX step adds its sown collection).  The reported
    # loss is the objective; its CE part must fall, which on uniform random
    # tokens it does in a few steps only on a batch seen again.  The aux
    # loss need not fall there: it starts near its balanced floor (the aux
    # weight a layer), and the CE's pull on the router moves it either way,
    # as it does under the JAX trainer (tests/test_torch_moe.py holds the
    # two trainers' aux losses step by step).  Every step's aux loss is held
    # within MOE_AUX_BOUND x the floor: top-2 routing collapsed onto two
    # experts gives E / 2 x, onto one E x
    del params
    gc.collect()
    torch.cuda.empty_cache()
    trainer = Trainer({
        "model": {k_: v_ for k_, v_ in MOE_CFG.items() if k_ != "kv_quant"},
        "optimizer": MOE_TRAIN["optimizer"], "loss": "lm_cross_entropy", "metrics": [],
        "seed": SEED, "data": {"train": {"name": "synthetic_tokens", "n": MOE_TRAIN["batch"],
                                         "seq_len": MOE_TRAIN["seq"], "vocab_size": vocab,
                                         "batch_size": MOE_TRAIN["batch"]}}}, device=device)
    batches = list(trainer._loader("train")) * MOE_TRAIN["steps"]
    torch.cuda.reset_peak_memory_stats()
    losses, auxes, step_s = [], [], []
    for batch in batches:
        t0 = time.perf_counter()
        st = trainer._train_step(trainer.state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(st["loss"]))
        auxes.append(float(sum(a.detach() for a in sown_losses(trainer.model))))
    peak = torch.cuda.max_memory_allocated() / 1e9
    ces = [l_ - a_ for l_, a_ in zip(losses, auxes)]
    aux_floor = sum(b_.aux_weight for _, b_ in trainer.model.moe_blocks())
    if len(losses) != MOE_TRAIN["steps"] or not all(math.isfinite(v) for v in losses + auxes) \
            or not ces[-1] < ces[0] or not 0 < max(auxes) <= MOE_AUX_BOUND * aux_floor:
        raise AssertionError(f"moe train: objective {losses}, aux losses {auxes} (balanced "
                             f"floor {aux_floor}, bound {MOE_AUX_BOUND} x)")
    del trainer, batches
    gc.collect()
    torch.cuda.empty_cache()
    result = {
        "config": MOE_CFG, "parameters": n_params, "int8_weights_gb": int8_gb,
        "serve": {"requests": len(prompts), "new_tokens": n_new, "batch_wall_s": batch_wall,
                  "lone_equal_batched": len(prompts), "launches": serve_counts,
                  "load_s": load_s},
        "decode": {"rows": 8, "b1_launches_per_step": per_step_b1,
                   "b1_per_moe_layer": 2 * MOE_CFG["n_experts"], "ms_per_step": decode_ms},
        "first_token": first_token,
        "train": {"batch": [MOE_TRAIN["batch"], MOE_TRAIN["seq"]], "steps": MOE_TRAIN["steps"],
                  "optimizer": MOE_TRAIN["optimizer"], "objective": losses, "ce": ces,
                  "aux_losses": auxes, "aux_balanced_floor": aux_floor,
                  "aux_bound": MOE_AUX_BOUND * aux_floor, "step_s": step_s,
                  "peak_gb": peak},
        "card": smi, "phase_s": time.perf_counter() - t_phase}
    log(f"moe ({smi}): {json.dumps(result)}")
    return result


# the device profile phase: the decode dispatches a capture asks for (GET
# /profile?dispatches=N) while its requests decode, and the Trainer's
# profiled window (global steps [start_step, start_step + num_steps) of
# `steps` steps at TRAIN_BATCH x 4096 tokens)
PROFILE_DISPATCHES = 8
PROFILE_PROMPTS = 8
# new tokens a profiled request asks for: twice the serving phases', so that
# the first request still decodes when the last one is admitted
PROFILE_NEW = 2 * NEW
PROFILE_TRAIN = {"steps": 3, "start_step": 1, "num_steps": 2}
# the roofline share a capture may show: past the data sheet's bandwidth
# by no more than the clock's slack
PROFILE_ROOFLINE_MAX = 1.05


def capture_kernel(key: str, name: str) -> bool:
    """Whether a kernel name as a capture gives it (``devprof.short_op``)
    is ``key``'s: B1 the int8 matmul without the norm prologue (the decode
    kernel's NORM = false instances and the tiled kernel), B2 its NORM =
    true instances, B3/B6 the single-query decode body (B6 is the same body
    through the page table), B5 the flash forward, B10's three backward
    kernels."""
    gemv = name.startswith("qmm_gemv_tc_kernel<")
    return {"B1": (gemv and ", false," in name) or name == "qmm_wgmma_kernel",
            "B2": gemv and ", true," in name,
            "B3/B6": name.startswith("attend_split_kernel<"),
            "B5": name.startswith("flash_fwd_kernel"),
            "B10 delta": name.startswith("flash_bwd_delta_kernel"),
            "B10 dq": name.startswith("flash_bwd_dq_kernel"),
            "B10 dk/dv": name.startswith("flash_bwd_dkv_kernel")}[key]


def device_profile_phase(dev, smi, bw):
    """Phase 2b: the engine's on-demand device capture, the Trainer's
    profiled window and the native host library, on the card.

    The continuous daemon serves the 1.2B all-int8 LM over HTTP (dense,
    then ``kv_layout="paged"`` with 128-slot pages); 8 requests decode and,
    once all 8 hold a slot, ``GET /profile?dispatches=8`` captures the
    next dispatches.  The capture must name B1, B2 and B3 (B6 on paged)
    among its kernels, hold exactly as many events of each as its wrapper
    counted launches over the window (a record the profiler lost fails the
    phase), give 0 < device time <= wall, a host gap >= 0 and a roofline
    share in (0, PROFILE_ROOFLINE_MAX]; ``/metrics`` must carry the four
    A13 families and ``/trace`` the ``engine.device`` track.  Then a
    Trainer over configs/multihost_lm.yml's model (2 x 4096, 3 steps)
    with ``profile: {start_step: 1, num_steps: 2}`` must write a trace
    holding the flash forward (B5) and B10's backward kernels, 16 launches
    of each a step.  Last, the native library must have built and be
    engaged, and an epoch under MLCOMP_TPU_NATIVE_SHUFFLE must be a
    permutation, the same for the same seed."""
    import tempfile
    from collections import Counter

    import numpy as np
    import yaml

    from mlcomp_tpu_torch import native
    from mlcomp_tpu_torch.data.loader import DataLoader
    from mlcomp_tpu_torch.io.weights import init_params
    from mlcomp_tpu_torch.obs import devprof
    from mlcomp_tpu_torch.serve import load_service, make_http_server
    from mlcomp_tpu_torch.train.loop import Trainer

    log("phase device profile")
    t_phase = time.perf_counter()
    hbm = devprof.hbm_gbps(dev)
    if hbm is None or (not os.environ.get("MLCOMP_TPU_HBM_GBPS") and hbm * 1e9 != bw):
        raise AssertionError(f"the engine's roofline bandwidth {hbm} GB/s is not this card's "
                             f"data sheet's {bw / 1e9} GB/s")
    params = init_params(CFG, SEED, device=dev)
    rng = torch.Generator().manual_seed(SEED + 2)
    prompts = [torch.randint(1, CFG["vocab_size"], (n,), generator=rng).tolist()
               for n in torch.linspace(64, 200, PROFILE_PROMPTS).long().tolist()]
    captures = {}
    for layout in ("dense", "paged"):
        kw = {"kv_layout": "paged", "kv_page_tokens": 128} if layout == "paged" else {}
        service = load_service(CFG, params=params, device=str(dev), quantize="kernel",
                               batch_sizes=(1, BATCH), prompt_buckets=(PROMPT,),
                               max_new_buckets=(PROFILE_NEW,), prefill_chunk=CHUNK, **kw)
        eng = service.engine
        httpd = make_http_server(service, "127.0.0.1", 0, model_name="transformer_lm-1.2b")
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            http(url + "/generate", {"prompt": prompts[0][:16], "max_new_tokens": 2})
            with ThreadPoolExecutor(PROFILE_PROMPTS) as ex:
                futs = [ex.submit(http, url + "/generate",
                                  {"prompt": p, "max_new_tokens": PROFILE_NEW})
                        for p in prompts]
                # every request admitted and decoding: the window holds
                # decode dispatches only
                t_wait = time.perf_counter()
                while not (eng._adm is None and not eng._pending and not eng._queue.qsize()
                           and sum(s is not None for s in eng._host) == PROFILE_PROMPTS):
                    if time.perf_counter() - t_wait > 120:
                        raise AssertionError(f"{layout}: the {PROFILE_PROMPTS} requests never "
                                             f"decoded together: {eng.stats()}")
                    time.sleep(0.005)
                code, att, _ = http(f"{url}/profile?dispatches={PROFILE_DISPATCHES}",
                                    timeout=300)
                done = [f.result() for f in futs]
            if code != 200:
                raise AssertionError(f"{layout}: GET /profile answered {code}: {att}")
            for c, res, _ in done:
                if c != 200 or len(res["ids"]) != PROFILE_NEW:
                    raise AssertionError(f"{layout}: a profiled request failed: {c} {res}")
            _, metrics_text, _ = http(url + "/metrics")
            _, trace_doc, _ = http(url + "/trace")
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.join(timeout=10)
            service.close()
        attn_key, other = (("decode_attention", "paged_decode_attention") if layout == "dense"
                           else ("paged_decode_attention", "decode_attention"))
        launches = att["launches"]
        want = {"B1": launches["quant_matmul"], "B2": launches["quant_matmul_norm"],
                "B3/B6": launches[attn_key]}
        events = {key: sum(k["count"] for k in att["kernels"] if capture_kernel(key, k["name"]))
                  for key in want}
        if min(events.values()) <= 0 or events != want or launches[other]:
            raise AssertionError(f"{layout} capture: kernel events {events} against the "
                                 f"wrappers' launches over the window {launches} (a record "
                                 f"the profiler lost, or a kernel missing from the "
                                 f"attribution); kernels {att['kernels']}")
        util = att["roofline_utilization"]
        if not (0 < att["device_time_ms"] <= att["wall_ms"] and att["host_gap_ms"] >= 0
                and util is not None and 0 < util <= PROFILE_ROOFLINE_MAX):
            raise AssertionError(f"{layout} capture out of bounds: device "
                                 f"{att['device_time_ms']} ms, wall {att['wall_ms']} ms, host "
                                 f"gap {att['host_gap_ms']} ms, roofline share {util}")
        families = {line.split()[2] for line in metrics_text.splitlines()
                    if line.startswith("# TYPE ")}
        a13 = {"mlcomp_engine_device_time_ms", "mlcomp_engine_profile_captures_total",
               "mlcomp_engine_device_time_ms_per_dispatch", "mlcomp_engine_roofline_utilization"}
        tracks = {e.get("args", {}).get("name") for e in trace_doc["traceEvents"]
                  if e.get("ph") == "M"}
        if not a13 <= families or "engine.device" not in tracks:
            raise AssertionError(f"{layout}: /metrics lacks {sorted(a13 - families)} or /trace "
                                 f"lacks the engine.device track ({sorted(filter(None, tracks))})")
        # device forwards in the window: a decode_scan_kK dispatch runs K
        steps = sum(f["dispatches"] * int(re.match(r"decode_scan_k(\d+)", fam).group(1))
                    for fam, f in att["families"].items())
        captures[layout] = {
            **{k: att[k] for k in ("dispatches", "requested_dispatches", "wall_ms",
                                   "device_time_ms", "host_gap_ms", "device_time_ms_per_dispatch",
                                   "host_gap_ms_per_dispatch", "roofline_ms_per_dispatch",
                                   "roofline_utilization", "hbm_gbps", "families",
                                   "device_events", "launches")},
            "decode_steps": steps, "device_ms_per_step": att["device_time_ms"] / steps,
            "kernel_events": events, "top_kernels": att["kernels"][:8]}
        log(f"device profile, {layout} engine ({smi}): {json.dumps(captures[layout])}")
        del service, eng
        gc.collect()
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # the Trainer's profiled window on the training configuration
    with open(Path(REPO) / "configs" / "multihost_lm.yml") as f:
        targs = yaml.safe_load(f)["executors"]["pretrain"]["args"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    cfg = {k: v for k, v in targs.items() if k not in ("mesh", "project", "dag_name")}
    cfg["data"]["train"].update(batch_size=TRAIN_BATCH,
                                n=TRAIN_BATCH * PROFILE_TRAIN["steps"])
    cfg["profile"] = {"dir": tmp, "start_step": PROFILE_TRAIN["start_step"],
                      "num_steps": PROFILE_TRAIN["num_steps"]}
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=str(dev))
    layers = trainer.model.arch()["layers"]
    trainer.fit()
    train_s = time.perf_counter() - t0
    trace = devprof.load_trace(trainer.profiler.trace_path)
    by_name = Counter(devprof.short_op(e["name"]) for e in trace.events
                      if e.get("cat") == "kernel")
    seq = cfg["data"]["train"]["seq_len"]
    grid = GRID_KEYS[bwd_grid(True, False, seq)]
    train_events = {key: sum(c for n, c in by_name.items() if capture_kernel(key, n))
                    for key in ("B5", "B10 delta", "B10 dq", "B10 dk/dv")}
    want_n = layers * PROFILE_TRAIN["num_steps"]
    if grid != "B10" or set(train_events.values()) != {want_n}:
        raise AssertionError(f"profiled train window: {train_events} flash kernel events, want "
                             f"{want_n} of each ({layers} layers x {PROFILE_TRAIN['num_steps']} "
                             f"steps, the {grid} grid)")
    train_att = devprof.attribution(trace, top_kernels=8)
    train_profile = {"trace_bytes": os.path.getsize(trainer.profiler.trace_path),
                     "window_steps": PROFILE_TRAIN["num_steps"], "batch": [TRAIN_BATCH, seq],
                     "kernel_events": train_events,
                     "device_time_ms": train_att["device_time_ms"],
                     "top_kernels": train_att["kernels"], "fit_s": train_s}
    log(f"device profile, Trainer window ({smi}): {json.dumps(train_profile)}")
    shutil.rmtree(tmp, ignore_errors=True)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # the native host library: built here with g++, engaged, and the
    # native shuffle a permutation that a seed repeats
    lib = native.lib()
    engaged = native.dag_analyze(np.array([0, 0, 1]), np.array([0]),
                                 np.array([2, 0], dtype=np.int8), np.array([0, 0]))
    if lib is None or engaged is None or [r.tolist() for r in engaged] != [[1], []]:
        raise AssertionError(f"the native library did not build or is not engaged: {lib}, "
                             f"{engaged}")
    n_rows = 1 << 16
    data = {"x": np.arange(n_rows * 4, dtype=np.float32).reshape(n_rows, 4),
            "y": np.arange(n_rows, dtype=np.int64)}
    os.environ["MLCOMP_TPU_NATIVE_SHUFFLE"] = "1"
    try:
        orders = [torch.cat([b["y"].cpu() for b in DataLoader(
            data, batch_size=4096, shuffle=True, seed=SEED, device=str(dev))]).tolist()
            for _ in range(2)]
    finally:
        del os.environ["MLCOMP_TPU_NATIVE_SHUFFLE"]
    numpy_order = np.arange(n_rows)
    np.random.RandomState(SEED).shuffle(numpy_order)
    if (sorted(orders[0]) != list(range(n_rows)) or orders[0] != orders[1]
            or orders[0] != native.shuffled_indices(n_rows, SEED).tolist()
            or orders[0] == numpy_order.tolist()):
        raise AssertionError("MLCOMP_TPU_NATIVE_SHUFFLE: the epoch is not the native "
                             "permutation of its seed")
    result = {"captures": captures, "train": train_profile,
              "native": {"library": str(native.so_path()), "engaged": True,
                         "shuffle_rows": n_rows, "permutation": True, "same_for_seed": True},
              "card": smi, "phase_s": time.perf_counter() - t_phase}
    log(f"device profile: {time.perf_counter() - t_phase:.1f} s")
    return result


def device_profile_process(smi, bw) -> dict:
    """:func:`device_profile_phase` in a child process (the kernels already
    built, so it loads them): its output interleaves with this one's, and
    its result comes back as JSON.  Fails when the child fails."""
    import tempfile

    fd, out = tempfile.mkstemp(prefix="chip_smoke_devprof_", suffix=".json")
    os.close(fd)
    code = ("import json, sys, torch; sys.path.insert(0, sys.argv[1]); import chip_smoke as cs; "
            "from mlcomp_tpu_torch.ops.cuda import build; build.build_all(); "
            "r = cs.device_profile_phase(torch.device('cuda'), sys.argv[2], float(sys.argv[3])); "
            "json.dump(r, open(sys.argv[4], 'w'))")
    try:
        proc = subprocess.run([sys.executable, "-c", code, REPO, smi, repr(bw), out], cwd=REPO,
                              timeout=900)
        if proc.returncode:
            raise AssertionError(f"the device profile phase failed (exit {proc.returncode}; "
                                 "its output above)")
        with open(out) as f:
            return json.load(f)
    finally:
        os.unlink(out)


# ---- the phase "parallel": A12's training half on one card
#
# One card holds one device, and NCCL refuses two ranks on one device, so
# the phase runs (a) a world of one rank over NCCL (a DeviceMesh of size 1:
# the NCCL path and the sharded placement on the card) and (b) a gang of
# two processes on the one card over gloo, whose card tensors travel in
# gloo's collectives except point-to-point, which parallel/collectives.py
# stages through pinned host memory (its "gloo-host-staged" count).
PAR_LONG_SEQ = 32768          # configs/longcontext_lm.yml's seq_len
PAR_LONG_BATCH = 1            # one sequence: mesh {sp: 2} over the two ranks
PAR_MH_SEQ = 4096             # configs/multihost_lm.yml's seq_len
PAR_MH_BATCH = 2              # the global batch of its {fsdp: 2} / {tp: 2} steps
PAR_MH_STEPS = 1               # 2 before the script's time was cut
# the depth of the two models' steps (references, world of one, gang; the
# DAG's gang slots too), cut from 8 and 16 layers to leave the whole run
# room for the phase "sharded serving"
PAR_LONG_LAYERS = 2
PAR_MH_LAYERS = 2             # 4 before the script's time was cut
# the DAG's gang slots: 1 step (2 before the script's time was cut)
PAR_DAG = {"chips": 1, "hosts": 2, "mesh": {"dp": 2}, "batch_per_rank": 2, "steps": 1}
PAR_PP = {"name": "transformer_lm_pp", "vocab_size": 32000, "hidden": 1024, "layers": 4,
          "heads": 16, "dtype": "bfloat16", "n_microbatches": 2}
PAR_PP_SEQ, PAR_PP_BATCH = 2048, 4
PAR_WORLD1_SEQ = 4096         # the world-of-one NCCL step's sequence
PAR_RING_ALONE = (1, 32768, 16, 64)   # one longcontext layer's q/k/v
PAR_RING_TOL = 2.0 ** -7
PAR_SP_MODES = ("ring", "ring_flash", "ulysses")
# the ``ring`` mode (plain einsum tiles, ~36 s a step at 32768 tokens on
# the one-card gang) runs at this length, against the unsharded plain
# step at the same length
PAR_RING_SEQ = 8192
# ROADMAP §C8: at 32768 tokens each of the flash kernels' tensors (out,
# dq, dk, dv) stays within this multiple of SDPA's relative error from
# the f32 attention
LONG_LEAF_MULTIPLE = 1.5


def _par_configs():
    """configs/longcontext_lm.yml's and configs/multihost_lm.yml's train
    args, as the phase runs them."""
    import yaml

    with open(Path(REPO) / "configs" / "longcontext_lm.yml") as f:
        lc = yaml.safe_load(f)["executors"]["train"]["args"]
    with open(Path(REPO) / "configs" / "multihost_lm.yml") as f:
        mh_doc = yaml.safe_load(f)
    mh = mh_doc["executors"]["pretrain"]["args"]
    lc_cfg = {"model": {**lc["model"], "layers": PAR_LONG_LAYERS}, "optimizer": lc["optimizer"],
              "loss": lc["loss"],
              "metrics": [], "epochs": 1, "seed": SEED,
              "data": {"train": {**lc["data"]["train"], "n": PAR_LONG_BATCH,
                                 "seq_len": PAR_LONG_SEQ, "batch_size": PAR_LONG_BATCH}}}
    mh_cfg = {"model": {**mh["model"], "layers": PAR_MH_LAYERS}, "optimizer": mh["optimizer"],
              "loss": mh["loss"],
              "metrics": [], "epochs": 1, "seed": SEED,
              "data": {"train": {**mh["data"]["train"], "n": PAR_MH_BATCH,
                                 "seq_len": PAR_MH_SEQ, "batch_size": PAR_MH_BATCH}}}
    pp_cfg = {"model": dict(PAR_PP), "optimizer": lc["optimizer"], "loss": "lm_cross_entropy",
              "metrics": [], "epochs": 1, "seed": SEED,
              "data": {"train": {"name": "synthetic_tokens", "n": PAR_PP_BATCH,
                                 "seq_len": PAR_PP_SEQ, "vocab_size": PAR_PP["vocab_size"],
                                 "batch_size": PAR_PP_BATCH}}}
    return lc_cfg, mh_cfg, pp_cfg, mh_doc


def _ring_cfg(lc_cfg):
    """configs/longcontext_lm.yml's train args at PAR_RING_SEQ tokens."""
    return {**lc_cfg, "data": {"train": {**lc_cfg["data"]["train"], "seq_len": PAR_RING_SEQ}}}


def _par_batch(cfg, seed):
    import numpy as np

    d = cfg["data"]["train"]
    rng = np.random.default_rng(seed)
    return {"x": rng.integers(1, d["vocab_size"], (d["batch_size"], d["seq_len"])
                              ).astype(np.int64)}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _peak_gb(dev):
    return torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None


def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _fa_counts():
    from mlcomp_tpu_torch.ops.cuda import flash_attention as fa

    return {"B5": fa.launches, "B9": fa.bwd_dq_launches - fa.bwd_causal_launches,
            "B10": fa.bwd_causal_launches}


def _par_step(trainer, batch, dev, attention=None, update=True):
    """One train step of ``trainer`` on ``batch`` (a global host batch; a
    sharded trainer's rank keeps its rows): loss, gradient norm (of the
    gradients the optimizer receives), ms and the flash launches.
    ``attention`` takes the dispatch rule's place in the model's layers;
    without ``update`` the optimizer does not run, so the state stays as
    it was."""
    from mlcomp_tpu_torch.models import transformer as tr
    from mlcomp_tpu_torch.parallel.distributed import global_batch_from_host
    from mlcomp_tpu_torch.parallel.sharding import full_tensor

    state = trainer.state
    seen = {}
    apply = state.apply_gradients

    def capture(grads):
        seen["sq"] = sum((g.float() * g.float()).sum() for g in grads.values())
        if update:
            apply(grads)

    state.apply_gradients = capture
    saved = tr.dot_product_attention
    if attention is not None:
        tr.dot_product_attention = attention
    if trainer.mesh is not None:
        b = global_batch_from_host(batch, trainer.mesh, dev)
    else:
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    c0 = _fa_counts()
    _sync(dev)
    t0 = time.perf_counter()
    try:
        stats = trainer._train_step(state, b)
        loss = float(stats["loss"])
        _sync(dev)
    finally:
        del state.apply_gradients
        tr.dot_product_attention = saved
    ms = (time.perf_counter() - t0) * 1e3
    c1 = _fa_counts()
    return {"loss": loss, "grad_norm": math.sqrt(float(full_tensor(seen["sq"]))), "ms": ms,
            "launches": {k: c1[k] - c0[k] for k in c1}}


def _par_trainer(cfg, dev, weights):
    """A Trainer for ``cfg`` (its ``mesh`` if any) starting from
    ``weights``, the flat flax-path host weights of ``init_params``."""
    from mlcomp_tpu_torch.parallel.sharding import load_into
    from mlcomp_tpu_torch.train.loop import Trainer

    t = Trainer(cfg, device=dev)
    if weights is not None:
        with torch.no_grad():
            for k, p in t.state.params.items():
                load_into(p, weights[k])
    return t


def _par_weights(cfg):
    """The flat host weights every process of the phase starts from (the
    seed's CPU draw, which a sharded Trainer makes itself)."""
    from mlcomp_tpu_torch.io.weights import from_flax_params, init_params
    from mlcomp_tpu_torch.models import create_model

    arch = create_model(dict(cfg["model"]), device="cpu").arch()
    return from_flax_params(init_params(arch, SEED, device=torch.device("cpu")), fold=False)


def _free(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _par_gap(got, ref):
    return {"loss": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
            "grad_norm": abs(got["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]}


def _sdpa_attention(q, k, v, causal=False, scale=None, **_):
    """SDPA over (B, S, H, D) tensors (its flash backend on the card's bf16)."""
    import torch.nn.functional as F

    o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                       is_causal=causal, scale=scale)
    return o.transpose(1, 2)


def _plain_attention(q, k, v, causal=False, scale=None, **_):
    """Plain PyTorch attention: the ring's einsum tiles on one rank (O(S)
    memory)."""
    from mlcomp_tpu_torch.parallel.ring import ring_attention

    return ring_attention(q, k, v, None, causal=causal, scale=scale)


def _f32_attention(q, k, v, causal=False, scale=None, **_):
    """Attention in f32: SDPA's memory-efficient path on f32 copies of q,
    k and v (the math path in a CPU rehearsal), rounded back."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION if q.is_cuda else SDPBackend.MATH):
        return _sdpa_attention(q.float(), k.float(), v.float(), causal, scale).to(q.dtype)


# the unsharded steps that give the noise floor of bf16 attention: SDPA
# three times (its backward adds dq in no fixed order, so its gradients
# differ from run to run), plain attention and f32 attention
PAR_SOUND = {"sdpa": _sdpa_attention, "sdpa_2": _sdpa_attention, "sdpa_3": _sdpa_attention,
             "plain": _plain_attention, "f32": _f32_attention}


def _par_references(dev, lc_cfg, mh_cfg, pp_cfg):
    """The unsharded first steps on the gang's weights and batches, each
    model's on one Trainer whose optimizer does not run (so every step
    starts from the same state): the kernel step and, for the noise floor
    of bf16 attention (ROADMAP §C6, §C8), the PAR_SOUND steps, none of
    which runs a flash kernel.  The floor is the largest gap between two
    of those; the kernel step is held within C6_FLOOR_MULTIPLE x the floor
    of the f32-attention step.  The longcontext kernel step also hands its
    first and last layer's attention inputs and output cotangents to
    :func:`long_flash_leaves`."""
    from mlcomp_tpu_torch.models import transformer as tr

    out, failures = {}, []
    for name, cfg in (("longcontext", lc_cfg), ("multihost", mh_cfg), ("pipeline", pp_cfg)):
        batch = _par_batch(cfg, 1)
        row = {}
        _reset_peak(dev)
        t = _par_trainer(cfg, dev, _par_weights(cfg))
        captured = []
        spy = (_capturing(tr.dot_product_attention, cfg["model"]["layers"], captured)
               if name == "longcontext" else None)
        row["kernels"] = _par_step(t, batch, dev, spy, update=False)
        row["kernels"]["peak_gb"] = _peak_gb(dev)
        if name == "longcontext":
            # the ``ring`` mode's counterpart, at its length
            row["plain_ring_seq"] = _par_step(t, _par_batch(_ring_cfg(cfg), 1), dev,
                                              _plain_attention, update=False)
        if name != "pipeline":
            for kind, attention in PAR_SOUND.items():
                row[kind] = _par_step(t, batch, dev, attention, update=False)
            sound = list(PAR_SOUND)
            gaps = {f"{a}_{b}": _par_gap(row[a], row[b])
                    for i, a in enumerate(sound) for b in sound[i + 1:]}
            row["pair_gaps"] = gaps
            row["floor"] = {k: max(g[k] for g in gaps.values()) for k in ("loss", "grad_norm")}
            kg = _par_gap(row["kernels"], row["f32"])
            row["kernels_vs_f32"] = kg
            if dev.type == "cuda" and any(kg[k] > C6_FLOOR_MULTIPLE * row["floor"][k]
                                          for k in kg):
                failures.append(f"{name}: the unsharded kernel step {kg} from the f32-attention "
                                f"step, past {C6_FLOOR_MULTIPLE} x the floor {row['floor']}")
        del t
        _free(dev)
        if captured:
            row["leaves"] = long_flash_leaves(
                dev, {f"layer{i}": [*qkv, do] for i, qkv, do in captured})
            if dev.type == "cuda":
                row["flash_times"] = long_flash_times(*captured[0][1], captured[0][2])
            captured.clear()
        out[name] = row
        log(f"parallel reference {name}: " + json.dumps(
            {k: {kk: vv for kk, vv in v.items() if kk != "launches"} for k, v in row.items()
             if k not in ("pair_gaps", "leaves")}))
    return out, failures


# the aim of the dh-64 instance at 1 x 32768: B5 and B10 each at most this
# share of the route before it (the dh-128 instance on padded operands)
LONG_DH64_AIM = 0.6


def long_flash_times(q, k, v, do) -> dict:
    """B5 and B10 at one longcontext layer's causal attention (1 x 32768,
    16 heads of 64, bf16), queued device ms: the dh-64 instance, the route
    before it (the dh-128 instance on operands zero-padded to 128, pads and
    slices included) and SDPA, in turns in this process, B10's split into
    delta, dq and dk/dv (``bwd_parts_device_ms``), with the bound
    (``flash_work``) and each instance's share of the padded route's time
    against LONG_DH64_AIM (reported, not a check)."""
    from mlcomp_tpu_torch.ops.cuda import flash_attention as fa

    b, s, h, d = q.shape
    sc = d ** -0.5
    bw, flops = peaks_for(torch.cuda.get_device_name(0))[1]
    out, lse = fa.flash_attention_fwd(q, k, v, True, sc)
    lq, lk, lv, ldo = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    gq, gk, gv = (t.clone().requires_grad_() for t in (lq, lk, lv))
    graph = torch.nn.functional.scaled_dot_product_attention(gq, gk, gv, is_causal=True,
                                                             scale=sc)

    def sdpa_fwd():
        with torch.no_grad():
            torch.nn.functional.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                                             scale=sc)

    runs = {
        "fwd": (lambda: fa.flash_attention_fwd(q, k, v, True, sc), dh64_calls),
        "padded_fwd": (lambda: padded_route_fwd(q, k, v, True, sc), dh128_calls),
        "sdpa_fwd": (sdpa_fwd, None),
        "bwd": (lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, True, sc), dh64_calls),
        "padded_bwd": (lambda: padded_route_bwd(q, k, v, out, lse, do, True, sc), dh128_calls),
        "sdpa_bwd": (lambda: torch.autograd.grad(graph, (gq, gk, gv), ldo, retain_graph=True),
                     None),
    }
    res = {}
    # padded, dh 64, dh 64, padded (and SDPA beside each pass)
    for order in (("padded_fwd", "fwd", "sdpa_fwd", "padded_bwd", "bwd", "sdpa_bwd"),
                  ("fwd", "padded_fwd", "bwd", "padded_bwd")):
        for name in order:
            fn, counter = runs[name]
            res.setdefault(f"{name}_device_ms", []).append(device_ms_of(fn, counter, iters=5))
    # the backward's time split between its kernels (delta, dq, dk/dv)
    res["bwd_parts_device_ms"] = bwd_parts_device_ms(q, k, v, out, lse, do, True, sc, iters=5)
    w = fa.flash_work(b, s, s, h, k.shape[2], d, True)
    for part in ("fwd", "bwd"):
        t_b, t_o = w[f"{part}_bytes"] / bw, w[f"{part}_ops"] / flops
        res[f"{part}_bound_ms"] = max(t_b, t_o) * 1e3
        res[f"{part}_share_of_padded"] = (min(res[f"{part}_device_ms"])
                                          / min(res[f"padded_{part}_device_ms"]))
        res[f"{part}_meets_aim"] = res[f"{part}_share_of_padded"] <= LONG_DH64_AIM
    log(f"long flash times 1x{s}x{h}x{d} causal: {json.dumps(res)}")
    del graph, gq, gk, gv, lq, lk, lv, ldo, out, lse
    return res


def _capturing(attention, n_layers, captured):
    """``attention`` that also records, for the first and last layer of a
    step, (layer, (q, k, v), output cotangent) into ``captured``."""
    calls = [0]

    def spy(q, k, v, **kw):
        o = attention(q, k, v, **kw)
        i = calls[0]
        calls[0] += 1
        if i in (0, n_layers - 1) and torch.is_grad_enabled():
            qkv = [t.detach().clone() for t in (q, k, v)]
            o.register_hook(lambda g, i=i, qkv=qkv: captured.append((i, qkv, g.detach().clone())))
        return o

    return spy


def _leaf_gaps(got, ref):
    """Per tensor of ``got`` against the f32 reference ``ref``: the
    relative error of the whole tensor and the relative gap of its norm."""
    out = {}
    for name, g in got.items():
        r = ref[name].float()
        rn = float(r.norm())
        out[name] = {"rel": float((g.float() - r).norm()) / rn,
                     "norm_gap": (float(g.float().norm()) - rn) / rn}
    return out


def long_randn_inputs(dev, seq=PAR_LONG_SEQ):
    """q, k, v and an output cotangent at configs/longcontext_lm.yml's
    attention (1 x ``seq``, 16 heads of 64, bf16), standard normals."""
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    return [torch.randn((1, seq, 16, 64), generator=g, device=dev, dtype=torch.bfloat16)
            for _ in range(4)]


def long_flash_leaves(dev, inputs):
    """ROADMAP §C8, leaf by leaf: for each named (q, k, v, output
    cotangent) of ``inputs`` (causal attention), out, dq, dk and dv of the
    flash kernels (B5 forward, B10 backward), of SDPA and of the plain
    einsum tiles, each on the bf16 inputs, against the plain tiles in f32.
    Fails unless each of the kernels' tensors is within LONG_LEAF_MULTIPLE
    x SDPA's relative error.  Returns {name: {kind: {tensor: gaps}}}."""
    from mlcomp_tpu_torch.ops.cuda import flash_attention as fa

    runs = {"kernels": lambda q, k, v: fa.flash_attention(q, k, v, causal=True),
            "sdpa": lambda q, k, v: _sdpa_attention(q, k, v, causal=True),
            "plain": lambda q, k, v: _plain_attention(q, k, v, causal=True)}

    def grads(fn, q, k, v, do):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves)
        out.backward(do.to(out.dtype))
        return {"out": out.detach(), "dq": leaves[0].grad, "dk": leaves[1].grad,
                "dv": leaves[2].grad}

    res, failures = {}, []
    for name, (q, k, v, do) in inputs.items():
        launched = fa.bwd_causal_launches
        ref = grads(runs["plain"], q.float(), k.float(), v.float(), do.float())
        row = {kind: _leaf_gaps(grads(fn, q, k, v, do), ref) for kind, fn in runs.items()}
        if fa.bwd_causal_launches == launched and q.is_cuda:
            failures.append(f"{name}: B10 did not launch")
        for t, gap in row["kernels"].items():
            if gap["rel"] > LONG_LEAF_MULTIPLE * row["sdpa"][t]["rel"]:
                failures.append(f"{name} {t}: the kernels {gap['rel']:.4g} from f32, past "
                                f"{LONG_LEAF_MULTIPLE} x SDPA's {row['sdpa'][t]['rel']:.4g}")
        res[name] = row
        log(f"long flash leaves {name} ({tuple(q.shape)}): {json.dumps(row)}")
        del ref
        _free(dev)
    if failures:
        raise AssertionError("long flash leaves (ROADMAP §C8): " + "; ".join(failures))
    return res


def _par_rank(rank, world, port, dev_type, job, q):
    """One rank of the phase's two-process gang on the one card; ``job``
    holds the configs and sizes the parent chose."""
    try:
        q.put((rank, _par_rank_work(rank, world, port, torch.device(dev_type), job)))
    except BaseException as e:  # the parent reports it
        import traceback

        q.put((rank, {"error": f"{e!r}\n{traceback.format_exc()[-4000:]}"}))


def _par_rank_work(rank, world, port, dev, job):
    from mlcomp_tpu_torch.ops.cuda import build
    from mlcomp_tpu_torch.ops.cuda import flash_attention as fa
    from mlcomp_tpu_torch.parallel import collectives as col
    from mlcomp_tpu_torch.parallel.distributed import init_distributed
    from mlcomp_tpu_torch.parallel.mesh import MeshSpec, make_mesh, set_current_mesh
    from mlcomp_tpu_torch.parallel.ring import ring_attention_sharded

    torch.set_num_threads(2)
    if dev.type == "cuda":
        build.build_all()
    init_distributed(f"127.0.0.1:{port}", world, rank, device=dev)
    mh_cfg, pp_cfg = job["mh"], job["pp"]
    res = {"backend": torch.distributed.get_backend()}

    # ring_attention alone at one longcontext layer's shapes, against the
    # unsharded flash kernels on the whole sequence
    mesh = make_mesh(MeshSpec(sp=world), device_type=dev.type)
    b, s, h, d = job["ring_alone"]
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    qkv = [torch.randn((b, s, h, d), generator=g, device=dev, dtype=torch.bfloat16)
           for _ in range(4)]
    full = [t.clone().requires_grad_(True) for t in qkv[:3]]
    ref = fa.flash_attention(*full, causal=True)
    ref.backward(qkv[3])
    cut = slice(rank * s // world, (rank + 1) * s // world)
    loc = [t[:, cut].detach().clone().requires_grad_(True) for t in qkv[:3]]
    c0 = _fa_counts()
    col.reset_counts()
    out = ring_attention_sharded(*loc, mesh, causal=True, use_flash=True)
    out.backward(qkv[3][:, cut])
    _sync(dev)
    c1 = _fa_counts()
    errs = {}
    out = out.detach()
    for label, got_, want in zip(("out", "dq", "dk", "dv"), (out, *[t.grad for t in loc]),
                                 (ref[:, cut], *[t.grad[:, cut] for t in full])):
        errs[label] = float((got_.float() - want.float()).abs().max()
                            / want.float().abs().max().clamp_min(1e-30))
    res["ring_alone"] = {"err_over_max": errs, "launches": {k: c1[k] - c0[k] for k in c1},
                         "transport": dict(col.transport_counts)}
    del qkv, full, ref, loc, out
    _free(dev)

    def run(name, cfg, steps, plain_first=False):
        _reset_peak(dev)
        col.reset_counts()
        # a Trainer under a mesh draws the seed's host weights itself, the
        # references' (_par_weights)
        t0 = time.perf_counter()
        t = _par_trainer(cfg, dev, None)
        build_s = time.perf_counter() - t0
        # ``plain_first``: the first batch on plain attention, the
        # optimizer not run (this sharding's own noise)
        plain = (_par_step(t, _par_batch(cfg, 1), dev, _plain_attention, update=False)
                 if plain_first else None)
        rows = [_par_step(t, _par_batch(cfg, 1 + i), dev) for i in range(steps)]
        if plain is not None:
            rows[0]["plain_step"] = plain
        rows[0]["peak_gb"] = _peak_gb(dev)
        rows[0]["build_s"] = build_s
        rows[0]["wall_s"] = time.perf_counter() - t0
        rows[0]["transport"] = dict(col.transport_counts)
        rows[0]["later_steps_ms"] = [r["ms"] for r in rows[1:]]
        res[name] = rows[0]
        del t
        set_current_mesh(None)
        _free(dev)

    for mode, cfg in job["sp"].items():
        run(f"sp_{mode}", cfg, 1)
    run("fsdp", {**mh_cfg, "mesh": {"fsdp": world}}, job["mh_steps"])
    run("tp", {**mh_cfg, "mesh": {"tp": world}}, job["mh_steps"], plain_first=True)
    run("pp", {**pp_cfg, "mesh": {"pp": world}}, 1)
    torch.distributed.destroy_process_group()
    return res


def parallel_phase(dev, smi, world=2):
    """The phase "parallel" (see the comment above ``PAR_LONG_SEQ``);
    returns its JSON result.  Runs in a process of its own
    (``parallel_process``): it spawns the gang's ranks and the DAG's gang
    slots, each a process that reaches the card."""
    import multiprocessing as mp

    from mlcomp_tpu_torch.parallel import collectives as col
    from mlcomp_tpu_torch.parallel.distributed import init_distributed
    from mlcomp_tpu_torch.parallel.mesh import set_current_mesh

    t_phase = time.perf_counter()
    lc_cfg, mh_cfg, pp_cfg, mh_doc = _par_configs()
    reduced = [
        f"configs/longcontext_lm.yml: mesh {{dp: 2, sp: 4}} -> {{sp: {world}}} (one card, "
        f"{world} processes); batch 8 -> {PAR_LONG_BATCH}; layers 8 -> {PAR_LONG_LAYERS}",
        f"configs/longcontext_lm.yml, seq_parallel ring (the einsum tiles): seq_len "
        f"{PAR_LONG_SEQ} -> {PAR_RING_SEQ}",
        f"configs/multihost_lm.yml: mesh {{dp: 8}} -> {{fsdp: {world}}} and {{tp: {world}}}; "
        f"batch 16 -> {PAR_MH_BATCH}; {PAR_MH_STEPS} steps (2 -> {PAR_MH_STEPS} for the script's "
        f"time); layers 16 -> {PAR_MH_LAYERS} "
        f"(4 -> {PAR_MH_LAYERS} for the script's time)",
        f"configs/multihost_lm.yml as a DAG: resources {{chips: 4, hosts: 2}} -> "
        f"{{chips: {PAR_DAG['chips']}, hosts: {PAR_DAG['hosts']}}}, mesh {{dp: 8}} -> "
        f"{PAR_DAG['mesh']}, batch 16 -> {PAR_DAG['batch_per_rank'] * world} "
        f"({PAR_DAG['batch_per_rank']} a rank), {PAR_DAG['steps']} steps (2 -> "
        f"{PAR_DAG['steps']} for the script's time), remat on (two "
        f"replicas on one card), layers 16 -> {PAR_MH_LAYERS} (4 -> {PAR_MH_LAYERS} for the "
        f"script's time)",
        f"transformer_lm_pp: hidden {PAR_PP['hidden']}, {PAR_PP['layers']} layers on pp "
        f"{world} ({PAR_PP['layers'] // world} virtual stages a rank), seq {PAR_PP_SEQ}",
    ]
    for r in reduced:
        log(f"reduced: {r}")

    # unsharded references (no process group: the Trainer's mesh is None)
    refs, ref_failures = _par_references(dev, lc_cfg, mh_cfg, pp_cfg)
    refs_s = time.perf_counter() - t_phase

    # (a) a world of one rank over NCCL (gloo on the CPU): the placement
    # code and the sharded step against the unsharded one
    port = free_port()
    init_distributed(f"127.0.0.1:{port}", 1, 0, device=dev)
    backend1 = torch.distributed.get_backend()
    w1_cfg = {**lc_cfg, "mesh": {}, "data": {"train": {**lc_cfg["data"]["train"],
                                                       "seq_len": PAR_WORLD1_SEQ}}}
    weights = _par_weights(w1_cfg)
    col.reset_counts()
    t = _par_trainer(w1_cfg, dev, weights)
    one = _par_step(t, _par_batch(w1_cfg, 1), dev)
    sharded_state = type(next(iter(t.state.params.values()))).__name__
    del t
    set_current_mesh(None)
    torch.distributed.destroy_process_group()
    t = _par_trainer({**w1_cfg, "mesh": None}, dev, weights)
    alone = _par_step(t, _par_batch(w1_cfg, 1), dev)
    del t, weights
    _free(dev)
    if one["loss"] != alone["loss"] or _par_gap(one, alone)["grad_norm"] > 1e-6:
        raise AssertionError(f"parallel: the world-of-one {backend1} step {one} differs from "
                             f"the unsharded step {alone}")
    world1 = {"backend": backend1, "state": sharded_state, "step": one, "unsharded": alone}
    log(f"parallel world of one: {json.dumps(world1)}")

    # (b) the two-process gang on the one card
    os.environ["MLCOMP_TPU_DIST_BACKEND"] = "gloo"
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    t0 = time.perf_counter()
    sp = {mode: {**(_ring_cfg(lc_cfg) if mode == "ring" else lc_cfg), "mesh": {"sp": world}}
          for mode in PAR_SP_MODES}
    for mode, cfg in sp.items():
        cfg["model"] = {**cfg["model"], "seq_parallel": mode}
    job = {"sp": sp, "mh": mh_cfg, "pp": pp_cfg, "ring_alone": PAR_RING_ALONE,
           "mh_steps": PAR_MH_STEPS}
    procs = [ctx.Process(target=_par_rank, args=(r, world, port, dev.type, job, q))
             for r in range(world)]
    for p in procs:
        p.start()
    ranks = {}
    try:
        for _ in range(world):
            r, out = q.get(timeout=900)
            ranks[r] = out
    finally:
        end_procs_mp(procs)
    gang_s = time.perf_counter() - t0
    for r, out in ranks.items():
        if "error" in out:
            raise AssertionError(f"parallel gang rank {r} failed: {out['error']}")
    # each sharded step against the unsharded step that runs the same
    # attention (ring: the einsum tiles, plain; ring_flash and ulysses: the
    # flash kernels), within C6_FLOOR_MULTIPLE x the noise floor of bf16
    # attention (the unsharded SDPA, plain and f32-attention steps against
    # each other); tp within that multiple of the larger of the floor and
    # its own noise on plain attention.  Failures are gathered and raised
    # once the DAG has run, so that one call measures every part.
    failures, checks = list(ref_failures), {}
    on_card = dev.type == "cuda"
    counterpart = {"ring": "plain_ring_seq", "ring_flash": "kernels", "ulysses": "kernels"}
    want = {"ring": (), "ring_flash": ("B5", "B9", "B10"), "ulysses": ("B5", "B10")}

    def held(label, gap, floor, noise=None):
        # ``noise``: the sharding's own gap on plain attention (a sharded
        # plain step against the unsharded plain step), where given
        checks[label] = gap
        base = {k: max(floor[k], noise[k]) if noise else floor[k] for k in floor}
        # (held on the card: a CPU rehearsal's tiny model has no such floor)
        if on_card and any(gap[k] > C6_FLOOR_MULTIPLE * max(base[k], 1e-6) for k in gap):
            failures.append(f"{label}: {gap} from its unsharded step, past "
                            f"{C6_FLOOR_MULTIPLE} x {base} (the floor {floor}, the sharding's "
                            f"own noise on plain attention {noise})")

    gang_launches, sharding_noise = {}, {}
    for r, out in ranks.items():
        ra = out["ring_alone"]
        if any(v > PAR_RING_TOL for v in ra["err_over_max"].values()):
            failures.append(f"rank {r}: ring_flash alone against the unsharded flash kernels "
                            f"{ra['err_over_max']}, past {PAR_RING_TOL}")
        for k, v in ra["launches"].items():
            gang_launches.setdefault("ring_alone", {}).setdefault(k, 0)
            gang_launches["ring_alone"][k] += v
        # each sharding's own noise on plain attention (no kernel): sp's is
        # the ring's gap (at its length), tp's a tp step on plain attention
        # against the unsharded plain step; tp is held against its own
        tp_noise = _par_gap(out["tp"]["plain_step"], refs["multihost"]["plain"])
        sharding_noise[r] = {"sp": _par_gap(out["sp_ring"], refs["longcontext"]["plain_ring_seq"]),
                             "tp": tp_noise}
        for mode in PAR_SP_MODES:
            row = out[f"sp_{mode}"]
            held(f"sp_{mode} rank {r}", _par_gap(row, refs["longcontext"][counterpart[mode]]),
                 refs["longcontext"]["floor"])
            for k, v in row["launches"].items():
                gang_launches.setdefault(mode, {}).setdefault(k, 0)
                gang_launches[mode][k] += v
        held(f"fsdp rank {r}", _par_gap(out["fsdp"], refs["multihost"]["kernels"]),
             refs["multihost"]["floor"])
        held(f"tp rank {r}", _par_gap(out["tp"], refs["multihost"]["kernels"]),
             refs["multihost"]["floor"], tp_noise)
        gap = _par_gap(out["pp"], refs["pipeline"]["kernels"])
        checks[f"pp rank {r}"] = gap
        if any(v > 2e-3 for v in gap.values()):
            failures.append(f"pp rank {r}: {gap} from the sequential step, past 2e-3")
    if on_card:
        for mode, keys in [("ring_alone", ("B5", "B9", "B10")), *want.items()]:
            if not all(gang_launches[mode][k] for k in keys):
                failures.append(f"{mode}: the gang launched {gang_launches[mode]}, not all of "
                                f"{keys}")
    for name in ("longcontext", "multihost"):
        log(f"parallel: {name}'s unsharded kernel step against the f32-attention step "
            f"{refs[name]['kernels_vs_f32']}; the floor's pairs {refs[name]['pair_gaps']}")
    transports = {k for out in ranks.values() for k, v in out["ring_alone"]["transport"].items()
                  if v}
    transport = "gloo-host-staged" if "gloo-host-staged" in transports else sorted(transports)

    # the gang through the DAG layer: configs/multihost_lm.yml as two gang
    # slots on the one card
    t0 = time.perf_counter()
    dag = dag_gang_run(dev, mh_doc, world)
    dag_s = time.perf_counter() - t0
    result = {"card": smi, "world_of_one": world1, "gang_backend": ranks[0]["backend"],
              "transport": transport, "references": refs, "references_s": refs_s,
              "gang_s": gang_s, "dag_s": dag_s, "ranks": ranks, "gaps": checks,
              "gang_launches": gang_launches, "sharding_noise": sharding_noise, "dag": dag,
              "reduced": reduced,
              "floor_multiple": C6_FLOOR_MULTIPLE, "ring_tolerance": PAR_RING_TOL,
              "phase_s": time.perf_counter() - t_phase}
    log(json.dumps({"parallel_transport": transport, "backend": ranks[0]["backend"],
                    "gaps": checks, "sharding_noise": sharding_noise,
                    "gang_launches": gang_launches, "seconds": {"references": refs_s, "gang": gang_s, "dag": dag_s,
                                "phase": result["phase_s"]},
                    "rank0_runs_s": {k: [v.get("build_s"), v.get("wall_s")]
                                     for k, v in ranks[0].items() if isinstance(v, dict)
                                     and "wall_s" in v}}))
    if failures:
        raise AssertionError("parallel: " + "; ".join(failures))
    return result


def end_procs_mp(procs, timeout=30.0):
    for p in procs:
        p.join(timeout)
        if p.is_alive():
            p.kill()
            p.join(5)


def dag_gang_run(dev, mh_doc, world):
    """configs/multihost_lm.yml through the local runner (``cli dag``'s
    path) as ``world`` gang slots on this machine's card; both slots must
    succeed and the checkpoint load into an unsharded Trainer."""
    import tempfile

    import yaml

    from mlcomp_tpu_torch.db.store import Store, TaskStatus
    from mlcomp_tpu_torch.io.checkpoint import latest_step, restore_checkpoint
    from mlcomp_tpu_torch.scheduler.local import run_dag_local
    from mlcomp_tpu_torch.train.loop import Trainer

    tmp = tempfile.mkdtemp(prefix="chip_smoke_par_")
    try:
        doc = json.loads(json.dumps(mh_doc))
        ex = doc["executors"]["pretrain"]
        ex["resources"] = {"chips": PAR_DAG["chips"], "hosts": PAR_DAG["hosts"]}
        batch = PAR_DAG["batch_per_rank"] * world
        ex["args"].update(mesh=PAR_DAG["mesh"], storage_root=f"{tmp}/storage",
                          dag_name="chip-smoke-gang")
        ex["args"]["model"] = {**ex["args"]["model"], "remat": True, "layers": PAR_MH_LAYERS}
        ex["args"]["data"]["train"].update(n=batch * PAR_DAG["steps"], batch_size=batch)
        path = Path(tmp) / "multihost_lm.yml"
        path.write_text(yaml.safe_dump(doc))
        db = f"{tmp}/db.sqlite"
        t0 = time.perf_counter()
        statuses = run_dag_local(str(path), db_path=db, workdir=tmp, timeout_s=600,
                                 device=dev.type)
        wall = time.perf_counter() - t0
        store = Store(db)
        try:
            row = store.task_rows(1)[0]
            logs = [l["message"] for l in store.task_logs(row["id"])]
            loss = [v for _, v in store.metric_series(row["id"], "train/loss")]
        finally:
            store.close()
        if not all(s == TaskStatus.SUCCESS for s in statuses.values()):
            raise AssertionError(f"parallel DAG gang: {statuses}: {row['error']}\n"
                                 + "\n".join(logs[-20:]))
        slots = [l for l in logs if "process_count=" in l]
        if len(slots) != world:
            raise AssertionError(f"parallel DAG gang: slots joined {slots}")
        ckpt = Path(json.loads(row["result"])["ckpt_dir"])
        step = latest_step(ckpt)
        cfg = {k: v for k, v in ex["args"].items()
               if k not in ("mesh", "project", "dag_name", "storage_root")}
        t = Trainer(cfg, device=dev)
        restore_checkpoint(ckpt, t.state)
        if step != PAR_DAG["steps"] or t.state.step != step:
            raise AssertionError(f"parallel DAG gang: checkpoint step {step}, loaded {t.state.step}")
        del t
        _free(dev)
        return {"statuses": {k: str(v) for k, v in statuses.items()}, "wall_s": wall,
                "train_loss": loss, "slots": slots, "checkpoint_step": step,
                "loads_unsharded": True}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def parallel_process(smi) -> dict:
    """:func:`parallel_phase` in a child process (the kernels already
    built, so its ranks load them); its result comes back as JSON."""
    import tempfile

    fd, out = tempfile.mkstemp(prefix="chip_smoke_parallel_", suffix=".json")
    os.close(fd)
    code = ("import json, sys, torch; sys.path.insert(0, sys.argv[1]); import chip_smoke as cs; "
            "from mlcomp_tpu_torch.ops.cuda import build; build.build_all(); "
            "r = cs.parallel_phase(torch.device('cuda'), sys.argv[2]); "
            "json.dump(r, open(sys.argv[3], 'w'))")
    try:
        env = {**os.environ, "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
        proc = subprocess.run([sys.executable, "-c", code, REPO, smi, out], cwd=REPO,
                              timeout=1000, env=env)
        if proc.returncode:
            raise AssertionError(f"the parallel phase failed (exit {proc.returncode}; its "
                                 "output above)")
        with open(out) as f:
            return json.load(f)
    finally:
        os.unlink(out)


# ---- the phase "sharded serving" (A12b): the serving model at 4 layers
# (CFG's 8 before the script's time was cut: the gang's decode is held by
# its per-layer gloo sums through the host), unfused (decode_fused is
# refused under a mesh, as in the JAX package), all-int8
SHARD_CFG = {**CFG, "decode_fused": False, "layers": 4}
SHARD = {"slots": BATCH, "prompt": PROMPT, "chunk": CHUNK, "new": NEW, "requests": 8,
         "lengths": (300, 500)}
# the phase's cuts, on its `reduced` line, each with its value before and
# after: the serving model's depth, as CFG's (its widths are the 1.2B's,
# so every local kernel shape is the same)
SHARD_REDUCED = {"layers": f"16 -> {SHARD_CFG['layers']} (8 -> {SHARD_CFG['layers']} "
                           "for the script's time)"}
# the gang's first-step logits against the one-card engine's: the largest
# difference over the largest logit (the row-parallel products round their
# bf16 partials before the f32 sum, twice a layer)
SHARD_LOGIT_RTOL = 2.0 ** -4
# the gang's arms: (name, kv layout, pipeline depth, new tokens a request).
# dense_d2 is timed; paged_d2 records every step's logits (a sync a step);
# dense_d1 is held against the first SHARD_D1_NEW tokens of dense_d2's
# (greedy rows do not depend on the budget)
SHARD_D1_NEW = 32
SHARD_GANGS = (("dense_d2", "dense", 2, SHARD["new"]), ("dense_d1", "dense", 1, SHARD_D1_NEW),
               ("paged_d2", "paged", 2, SHARD["new"]))
# the arms whose ranks record their kernels' calls (shard_local_checks)
SHARD_RECORDED = ("dense_d1", "paged_d2")
SHARD_KEYS = {"B1": "quant_matmul", "B2": "quant_matmul_norm", "B3": "decode_attention",
              "B4": "decode_attention_chunk", "B5": "flash_attention_fwd",
              "B6": "paged_decode_attention", "B7": "paged_decode_attention_chunk",
              "B8": "page_gather"}


def shard_prompts():
    """The phase's 8 prompts: 300-500 tokens, so that each admission runs
    both 256-token chunks of the 512 bucket (B5 at index 0, B4 after)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 19)
    lo, hi = SHARD["lengths"]
    return [rng.integers(1, SHARD_CFG["vocab_size"], int(n)).tolist()
            for n in rng.integers(lo, hi + 1, SHARD["requests"])]


def shard_trace_id(i: int) -> str:
    return f"{i + 1:032x}"


def _shard_recorders():
    """Instrument this process's engine (on its class) and kernel call
    sites: each admission's first-step logits by trace id; with
    ``logits_on``, the logits every live row sampled from, by (rid,
    position) (a sync a step: never in a timed run); each dispatch's
    readback time, step and live rows; the kernels' local shapes; the
    launch counters at the end of a gang's warm control record; and, with
    CHIP_SMOKE_SHARD_RECORD=1, each kernel's first call at each local
    shape after warmup (operands and output) and each row-parallel sum's
    (``shard_local_checks`` holds them against the plain versions)."""
    import mlcomp_tpu_torch.engine as em
    import mlcomp_tpu_torch.models.transformer as tm
    import mlcomp_tpu_torch.ops.quant as oq
    import mlcomp_tpu_torch.serve as sv
    from mlcomp_tpu_torch.ops.cuda import launch_counts

    rec = {"first": {}, "logits": {}, "logits_on": False, "rid_trace": {}, "shapes": {},
           "warm": None, "resident_gb": None, "resolved": [],
           # with record on: the operands and output of each kernel call site's
           # first call at each shape after warmup (CPU copies)
           "record": os.environ.get("CHIP_SMOKE_SHARD_RECORD") == "1", "calls": {}}
    warmup = sv.GenerationService.warmup

    def _warmup(self):
        # the weights and the KV are resident now; the peak from here on is
        # serving's (the load's transient f32 tree is gone)
        torch.cuda.synchronize()
        rec["resident_gb"] = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        return warmup(self)

    sv.GenerationService.warmup = _warmup
    set_row, run_ctrl, sample = em.DecodeEngine._set_row, em.DecodeEngine._run_ctrl, \
        em.sample_token_rowwise_keyed

    def _set_row(self, slot, req, last_logits, rseed):
        if req.get("trace_id") and not req.get("warmup"):
            rec["first"][req["trace_id"]] = last_logits.float().cpu()
            rec["rid_trace"][int(req["rid"])] = req["trace_id"]
        return set_row(self, slot, req, last_logits, rseed)

    def _run_ctrl(self, kind, fut=None):
        run_ctrl(self, kind, fut)
        rec["warm"] = launch_counts()

    def _sample(seed, rseed, position, logits, *a, **k):
        if rec["logits_on"]:
            rows = logits.float().cpu()
            for b, (rid, pos) in enumerate(zip(rseed.tolist(), position.tolist())):
                # a row's first record at a position: a finished row keeps
                # running at its frozen position
                if rid and (rid, pos) not in rec["logits"]:
                    rec["logits"][(rid, pos)] = rows[b].clone()
        return sample(seed, rseed, position, logits, *a, **k)

    def cpu(v):
        return v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor) else v

    def shapes(key, fn, shape_of):
        def wrapped(*a, **k):
            shape = shape_of(*a, **k)
            rec["shapes"].setdefault(key, set()).add(shape)
            out = fn(*a, **k)
            if rec["record"] and rec["warm"] is not None and (key, shape) not in rec["calls"]:
                rec["calls"][(key, shape)] = {"args": [cpu(v) for v in a],
                                              "kwargs": {n: cpu(v) for n, v in k.items()},
                                              "out": cpu(out)}
            return out
        return wrapped

    rank_qmm = oq.rank_quant_matmul

    def _rank_qmm(x2, q8, scale, tp_group, row_parallel, norm_scale=None):
        # a row-parallel projection's summed output, with its operands
        out = rank_qmm(x2, q8, scale, tp_group, row_parallel, norm_scale=norm_scale)
        key = ("row sum", tuple(x2.shape), tuple(q8.shape))
        if (rec["record"] and rec["warm"] is not None and row_parallel
                and tp_group is not None and key not in rec["calls"]):
            rec["calls"][key] = {"x": cpu(x2), "q8": cpu(q8), "scale": cpu(scale),
                                 "norm_scale": cpu(norm_scale), "out": cpu(out)}
        return out

    process_oldest = em.DecodeEngine._process_oldest

    def _process_oldest(self):
        # the host time each dispatch's tokens were read, with the engine's
        # step count and the rows that were live in it
        live = sum(sl is not None for sl in self._host)
        process_oldest(self)
        rec["resolved"].append((time.perf_counter(), self.step_count, live))

    em.DecodeEngine._process_oldest = _process_oldest
    em.DecodeEngine._set_row, em.DecodeEngine._run_ctrl = _set_row, _run_ctrl
    em.sample_token_rowwise_keyed = _sample
    oq.rank_quant_matmul = _rank_qmm
    oq.quant_matmul = shapes("B1/B2", oq.quant_matmul, lambda x, q8, sc, norm_scale=None, **_: (
        "B2" if norm_scale is not None else "B1", tuple(x.shape), tuple(q8.shape)))
    for key, name in (("B3", "decode_attention"), ("B4", "decode_attention_chunk"),
                      ("B6", "paged_decode_attention"), ("B7", "paged_decode_attention_chunk")):
        setattr(tm, name, shapes(key, getattr(tm, name), lambda q, k8, *a, **k: (
            tuple(q.shape), tuple(k8.shape))))
    tm.dot_product_attention = shapes("B5 (flash, where it takes the call)",
                                      tm.dot_product_attention,
                                      lambda q, k, v, *a, **kw: (tuple(q.shape), tuple(k.shape)))
    return rec


def shard_logits_by_trace(rec) -> dict:
    """The recorded step logits as {trace id: {position: logits}}."""
    out: dict = {}
    for (rid, pos), row in rec["logits"].items():
        if rid in rec["rid_trace"]:
            out.setdefault(rec["rid_trace"][rid], {})[pos] = row
    return out


def shard_decode_ms(resolved, slots: int) -> dict:
    """Decode ms a step with every slot live, from an engine's resolved
    dispatches ``(host time, step count, live rows)``: from the first
    readback of a dispatch that ran all ``slots`` rows to the readback of
    the last such dispatch, over the steps between them."""
    full = [i for i, (_, _, live) in enumerate(resolved) if live == slots]
    if len(full) < 2:
        raise AssertionError(f"no two dispatches ran all {slots} slots: {resolved[-20:]}")
    a, b = full[0], full[-1]
    steps = resolved[b][1] - resolved[a][1]
    return {"ms": (resolved[b][0] - resolved[a][0]) * 1e3 / steps, "steps": steps,
            "dispatches": b - a}


def shard_reference(out_path: str) -> None:
    """Child process of the phase: the one-card engine and a world of one
    over NCCL on the same weights (``init_params(SHARD_CFG, 0)`` drawn on
    the card), each serving the phase's 8 prompts greedily at 8 slots.
    Saves the one-card ids, logprobs, first-step logits, step logits and
    decode ms/step, and the world of one's ids and first-step logits."""
    from mlcomp_tpu_torch.io.weights import init_params
    from mlcomp_tpu_torch.ops.cuda import build, launch_counts
    from mlcomp_tpu_torch.parallel import collectives as col
    from mlcomp_tpu_torch.parallel.distributed import init_distributed
    from mlcomp_tpu_torch.serve import load_service

    build.build_all()
    rec = _shard_recorders()
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    import torch.distributed as tdist

    backend = tdist.get_backend()
    dev = torch.device("cuda")
    prompts = shard_prompts()
    kw = dict(batch_sizes=(SHARD["slots"],), prompt_buckets=(SHARD["prompt"],),
              max_new_buckets=(SHARD["new"],), prefill_chunk=SHARD["chunk"], quantize="kernel",
              engine_pipeline_depth=2, metrics_history_interval=0)
    out = {"backend": backend}

    def run(svc, label):
        futs = [svc.submit(p, SHARD["new"], logprobs=True, trace_id=shard_trace_id(i))
                for i, p in enumerate(prompts)]
        res = [f.result(timeout=600) for f in futs]
        return [r["ids"] for r in res], [r["logprobs"] for r in res], [f.rid for f in futs]

    t0 = time.perf_counter()
    # the weights are drawn for each service (the same draw): the float tree
    # is gone once the service has loaded it
    svc = load_service(SHARD_CFG, params=init_params(SHARD_CFG, SEED, device=dev), device=dev,
                       **kw)
    try:
        svc.warmup()
        out["load_warm_s"] = time.perf_counter() - t0
        # pass 1: timed, nothing recorded but the first-step logits
        rec["resolved"].clear()
        ids, lps, _ = run(svc, "one card")
        out["decode_ms_per_step"] = shard_decode_ms(rec["resolved"], SHARD["slots"])
        # the timed pass is over: the phase may start the gangs' processes
        Path(out_path + ".timed").touch()
        out["first"] = {t: v for t, v in rec["first"].items()}
        rec["first"].clear()
        # pass 2: the same requests with every sampled row's logits recorded
        rec["logits_on"] = True
        ids2, _, _ = run(svc, "one card, logits")
        rec["logits_on"] = False
        if ids2 != ids:
            raise AssertionError("the one-card engine's greedy ids changed between two passes")
        rec["first"].clear()
        out["logits"] = shard_logits_by_trace(rec)
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["resident_gb"] = rec["resident_gb"]
    finally:
        svc.close()
    out.update(ids=ids, logprobs=lps)
    del svc
    gc.collect()
    torch.cuda.empty_cache()
    launches0 = launch_counts()
    svc = load_service(SHARD_CFG, params=init_params(SHARD_CFG, SEED, device=dev), device=dev,
                       mesh_cfg={"tp": 1}, **kw)
    try:
        if any(getattr(m, "tp_group", None) is not None for m in svc.model.modules()):
            raise AssertionError("a mesh of one rank set a tensor-parallel group")
        svc.warmup()
        w_ids, w_lps, _ = run(svc, "world of one")
        out["world1"] = {"ids": w_ids, "logprobs": w_lps, "first": dict(rec["first"]),
                         "mesh": svc.stats()["mesh"],
                         "launches": {k: launch_counts()[k] - launches0[k]
                                      for k in launches0},
                         "transport": dict(col.transport_counts)}
    finally:
        svc.close()
    torch.save(out, out_path)


def shard_rank(out_path: str, argv_json: str) -> None:
    """One rank of a ``serve --mesh tp=2 --distributed`` gang (its process
    is started with the gang's MLCOMP_TPU_* environment): the CLI serves
    until SIGTERM (the coordinator) or the coordinator's stop record (a
    follower), then the rank saves what it recorded and its counters."""
    from mlcomp_tpu_torch import cli
    from mlcomp_tpu_torch.ops.cuda import launch_counts
    from mlcomp_tpu_torch.parallel import collectives as col

    rec = _shard_recorders()
    # one arm's coordinator records the logits of every step (untimed)
    rec["logits_on"] = os.environ.get("CHIP_SMOKE_SHARD_LOGITS") == "1"
    t0 = time.perf_counter()
    rc = cli.main(json.loads(argv_json))
    torch.save({"rc": rc, "first": rec["first"], "warm": rec["warm"], "final": launch_counts(),
                "shapes": {k: sorted(v) for k, v in rec["shapes"].items()},
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "resident_gb": rec["resident_gb"], "resolved": rec["resolved"],
                "logits": shard_logits_by_trace(rec),
                "transport": dict(col.transport_counts), "wall_s": time.perf_counter() - t0},
               out_path)
    if rec["calls"]:
        torch.save(rec["calls"], out_path + ".calls")


def shard_local_checks(arms: dict) -> dict:
    """The kernels at the gang's local shapes against their plain versions
    on the card, on the operands the ranks recorded (``arms``: {arm: [rank
    0's calls, rank 1's]}, each rank's first call at each shape after
    warmup): B1 and B2 at every (x, q8) shape, B3/B4/B6 on the rank's 8 of
    16 heads and B5 on its heads of the prefill, each under the kernel
    phase's rule (``held_to_plain``).  Each row-parallel projection's
    summed output must be the same on both ranks and held against the plain
    versions' partials summed in f32 and rounded once; beside it, the share
    of its gap to one rounding of the whole product that the bf16 partials
    take (plain arithmetic alone) and the share the kernels' own sums at
    the shard shapes take.  Returns the rows by kernel."""
    from mlcomp_tpu_torch.ops.cuda import decode_attention as da
    from mlcomp_tpu_torch.ops.cuda import flash_attention as fa
    from mlcomp_tpu_torch.ops.cuda import quant_matmul as qm

    dev = torch.device("cuda")

    def on(v):
        return v.to(dev) if isinstance(v, torch.Tensor) else v

    def window(x, b, default):
        return da._rows(on(x), b, default, dev)

    out: dict = {}
    for arm, ranks in arms.items():
        for r, calls in enumerate(ranks):
            for (key, *shape), call in calls.items():
                if key == "row sum":
                    continue
                shape = shape[0]
                a = [on(v) for v in call["args"]]
                kw = {n: on(v) for n, v in call["kwargs"].items()}
                got = on(call["out"])
                label = f"{arm} rank {r} {key} {shape}"
                if key == "B1/B2":
                    x, q8, sc = a[:3]
                    gn = kw.get("norm_scale")
                    ref = qm.quant_matmul_plain(x, q8, sc, norm_scale=gn)
                    ref_abs = qm.quant_matmul_plain(x.abs(), q8.abs(), sc, norm_scale=gn)
                    rows, d, n = x.shape[0], q8.shape[0], q8.shape[1]
                    plan = qm.gemv_plan(rows, d, n) if rows <= qm.GEMV_ROWS else \
                        qm.plan(rows, d, n)
                    name = shape[0]
                    extra = {"rows": rows, "d": d, "n": n,
                             "plan": {f: plan[f] for f in ("ctas", "cluster", "splits")
                                      if f in plan}}
                elif key in ("B3", "B4", "B6", "B7"):
                    q = a[0]
                    b, s_q = q.shape[0], 1 if q.dim() == 3 else q.shape[1]
                    paged = key in ("B6", "B7")
                    cache = a[1:5]
                    l_buf = a[5].shape[1] * a[1].shape[2] if paged else a[1].shape[2]
                    stop_key = "kv_stop0" if key in ("B4", "B7") else "kv_stop"
                    start = window(kw.get("kv_start"), b, 0)
                    stop = window(kw.get(stop_key), b, l_buf - s_q + 1)
                    sc_ = kw.get("scale") or 1.0 / math.sqrt(q.shape[-1])
                    plain = {"B3": da.decode_attention_plain,
                             "B4": da.decode_attention_chunk_plain,
                             "B6": da.paged_decode_attention_plain,
                             "B7": da.paged_decode_attention_chunk_plain}[key]
                    lead = (*cache, a[5]) if paged else cache
                    abs_lead = (cache[0], cache[1], cache[2].abs(), cache[3]) + \
                        ((a[5],) if paged else ())
                    ref = plain(q, *lead, start, stop, sc_)
                    ref_abs = plain(q, *abs_lead, start, stop, sc_)
                    name = key
                    extra = {"q": list(q.shape), "cache": list(cache[0].shape),
                             "plan": da.plan_for(q if q.dim() == 4 else q[:, None], cache[0],
                                                 a[5] if paged else None)}
                else:
                    # B5: the prefill's causal flash call (a dense mask takes
                    # the reference path, not the kernel)
                    if not key.startswith("B5"):
                        raise AssertionError(f"{label}: no plain version for {key}")
                    if kw.get("mask") is not None:
                        continue
                    q, k, v = a[:3]
                    b, s_k = q.shape[0], k.shape[1]
                    sc_ = kw.get("scale") or 1.0 / math.sqrt(q.shape[-1])
                    lo = fa._window(kw.get("kv_start"), b, 0, dev)
                    hi = fa._window(kw.get("kv_stop"), b, s_k, dev)
                    causal = bool(kw.get("causal", False))
                    ref = fa.flash_attention_plain(q, k, v, causal, sc_, lo, hi)[0]
                    ref_abs = fa.flash_attention_plain(q, k, v.abs(), causal, sc_, lo, hi)[0]
                    name = "B5"
                    extra = {"q": list(q.shape), "k": list(k.shape)}
                err, ratio = held_to_plain(label, got, ref, ref_abs)
                out.setdefault(name, []).append({"arm": arm, "rank": r, **extra,
                                                 "max_abs_err": err, "err_over_limit": ratio})
        # the row-parallel sums, both ranks' operands together
        keys = sorted(k for k in ranks[0] if k[0] == "row sum")
        if sorted(k for k in ranks[1] if k[0] == "row sum") != keys or not keys:
            raise AssertionError(f"{arm}: the ranks recorded different row-parallel sums: "
                                 f"{keys}")
        for key in keys:
            c0, c1 = ranks[0][key], ranks[1][key]
            if not torch.equal(c0["out"], c1["out"]):
                raise AssertionError(f"{arm} {key}: the ranks' summed outputs differ")
            parts = [qm.quant_matmul_plain(on(c["x"]), on(c["q8"]), on(c["scale"]))
                     for c in (c0, c1)]
            parts_abs = [qm.quant_matmul_plain(on(c["x"]).abs(), on(c["q8"]).abs(),
                                               on(c["scale"])) for c in (c0, c1)]
            ref = (parts[0].float() + parts[1].float()).bfloat16()
            got = on(c0["out"])
            err, ratio = held_to_plain(f"{arm} {key}", got, ref,
                                       parts_abs[0].float() + parts_abs[1].float())
            whole = qm.quant_matmul_plain(torch.cat([on(c0["x"]), on(c1["x"])], 1),
                                          torch.cat([on(c0["q8"]), on(c1["q8"])], 0),
                                          on(c0["scale"])).float()
            top = whole.abs().max().item()
            out.setdefault("row_parallel_sum", []).append({
                "arm": arm, "x": list(c0["x"].shape), "q8_shard": list(c0["q8"].shape),
                "max_abs_err": err, "err_over_limit": ratio,
                # each over the largest |output| of the whole product
                "partials_vs_one_rounding": (ref.float() - whole).abs().max().item() / top,
                "kernels_vs_plain_partials": (got.float() - ref.float()).abs().max().item() / top,
                "gang_vs_one_rounding": (got.float() - whole).abs().max().item() / top})
    for need in ("B1", "B2", "B3", "B4", "B5", "B6", "row_parallel_sum"):
        if need not in out:
            raise AssertionError(f"sharded serving: no {need} call was recorded at a local shape")
    return out


def _shard_requests(url, prompts, new):
    """The phase's prompts to a coordinator at once over HTTP (greedy, with
    logprobs, each with its trace id): [(ids, logprobs)] in prompt order."""
    def one(i):
        body = json.dumps({"prompt": prompts[i], "max_new_tokens": new,
                           "logprobs": True}).encode()
        req = urllib.request.Request(url + "/generate", data=body, headers={
            "Content-Type": "application/json",
            "traceparent": f"00-{shard_trace_id(i)}-00f067aa0ba902b7-01"})
        with urllib.request.urlopen(req, timeout=600) as r:
            res = json.loads(r.read())
        return res["ids"], res["logprobs"]

    with ThreadPoolExecutor(len(prompts)) as ex:
        return list(ex.map(one, range(len(prompts))))


def sharded_serving_phase(smi) -> dict:
    """Phase "sharded serving": the serving model (SHARD_CFG, all-int8,
    int8 KV) served by a world of one over NCCL (in a child process, against
    the one-card engine bit for bit) and by ``serve --mesh tp=2
    --distributed`` gangs of two processes on the one card over gloo, dense
    at depths 2 and 1 and paged at depth 2, 8 requests over HTTP to each
    coordinator.  Fails unless: the world of one equals the one-card engine
    bit for bit; the gang's arms are bit-equal to each other; its
    first-step logits are within SHARD_LOGIT_RTOL of the one-card engine's
    and its greedy ids equal the one-card ids up to the first position
    whose one-card top-2 margin is below the logits' measured gap; B1-B5
    (B6/B7 paged) launched on both ranks after warmup; the follower answers
    /healthz ready:false and /generate 503; the coordinator's /metrics
    shows the mesh gauges; and each follower's loop ends (its daemon exits
    0) on the coordinator's stop record."""
    import tempfile

    import yaml

    from mlcomp_tpu_torch.io.weights import init_params, save_npz

    t_phase = time.perf_counter()
    log("reduced (sharded serving): " + json.dumps(SHARD_REDUCED))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p),
        "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    procs = []
    try:
        # the one-card reference and the world of one, in a child process,
        # while this one writes the weights the gangs' CLI reads
        ref_path = f"{tmp}/reference.pt"
        code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke as cs; "
                "cs.shard_reference(sys.argv[2])")
        ref_proc = subprocess.Popen([sys.executable, "-c", code, REPO, ref_path], cwd=REPO,
                                    env=env)
        t0 = time.perf_counter()
        params = init_params(SHARD_CFG, SEED, device=torch.device("cuda"))
        save_npz(f"{tmp}/weights.npz", params)
        del params
        torch.cuda.empty_cache()
        npz_s = time.perf_counter() - t0
        with open(f"{tmp}/model.yml", "w") as f:
            yaml.safe_dump({"model": SHARD_CFG}, f)
        # the gangs load (host-bound) only once the one-card engine's timed
        # pass is over; its other passes overlap them
        deadline = time.monotonic() + 600
        while not os.path.exists(ref_path + ".timed"):
            if ref_proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"the sharded serving reference failed before its timed "
                                     f"pass (exit {ref_proc.returncode}; its output above)")
            time.sleep(0.2)
        # the gangs: all three arms load at once, then serve
        prompts = shard_prompts()
        gangs = {}
        for name, layout, depth, _ in SHARD_GANGS:
            store, sync = free_port(), free_port()
            ports = [free_port(), free_port()]
            argv = ["serve", "--model", f"{tmp}/model.yml", "--ckpt", f"{tmp}/weights.npz",
                    "--quantize", "kernel", "--batch-sizes", str(SHARD["slots"]),
                    "--prompt-buckets", str(SHARD["prompt"]), "--max-new-buckets",
                    str(SHARD["new"]), "--prefill-chunk", str(SHARD["chunk"]),
                    "--engine-pipeline-depth", str(depth), "--kv-layout", layout,
                    "--mesh", "tp=2", "--distributed", "--sync-port", str(sync), "--warmup",
                    "--metrics-history-interval", "0"]
            if layout == "paged":
                argv += ["--kv-page-tokens", "128"]
            ranks = []
            for r in range(2):
                renv = {**env, "MLCOMP_TPU_COORDINATOR": f"127.0.0.1:{store}",
                        "MLCOMP_TPU_NUM_PROCESSES": "2", "MLCOMP_TPU_PROCESS_ID": str(r),
                        "MLCOMP_TPU_DIST_BACKEND": "gloo",
                        "CHIP_SMOKE_SHARD_LOGITS": "1" if name == "paged_d2" and r == 0
                        else "0",
                        # the untimed arms keep their kernels' calls at each
                        # local shape for shard_local_checks
                        "CHIP_SMOKE_SHARD_RECORD": "1" if name in SHARD_RECORDED else "0"}
                out = f"{tmp}/{name}_rank{r}.pt"
                code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke as cs; "
                        "cs.shard_rank(sys.argv[2], sys.argv[3])")
                with open(f"{tmp}/{name}_rank{r}.log", "wb") as lf:
                    proc = subprocess.Popen(
                        [sys.executable, "-c", code, REPO, out,
                         json.dumps(argv + ["--port", str(ports[r])])],
                        cwd=tmp, env=renv, stdout=lf, stderr=subprocess.STDOUT,
                        start_new_session=True)
                procs.append(proc)
                ranks.append((proc, f"http://127.0.0.1:{ports[r]}", out))
            gangs[name] = ranks
        if ref_proc.wait(timeout=600):
            raise AssertionError(f"the sharded serving reference failed (exit "
                                 f"{ref_proc.returncode}; its output above)")
        ref = torch.load(ref_path)
        w1 = ref["world1"]
        if w1["ids"] != ref["ids"] or w1["logprobs"] != ref["logprobs"]:
            raise AssertionError("the world of one's greedy ids differ from the one-card "
                                 "engine's")
        for t, v in ref["first"].items():
            if not torch.equal(w1["first"][t], v):
                raise AssertionError(f"the world of one's first-step logits differ ({t})")
        log(f"sharded serving: a world of one over {ref['backend']} == the one-card engine bit "
            f"for bit (8 greedy requests' ids, logprobs and first-step logits; mesh "
            f"{json.dumps(w1['mesh']['axes'])}, collectives {json.dumps(w1['transport'])})")
        t_ready = time.perf_counter()
        for name, ranks in gangs.items():
            for r, (proc, url, _) in enumerate(ranks):
                # the coordinator until it is ready (warmed up), a follower
                # until it answers (it is never ready)
                deadline = time.monotonic() + 600
                while True:
                    if proc.poll() is not None:
                        raise AssertionError(f"{name}: rank {r} exited with {proc.returncode}: "
                                             f"{log_tail(tmp, f'{name}_rank{r}')}")
                    try:
                        st = http(url + "/healthz", timeout=10)[1]
                        if isinstance(st, dict) and (r == 1 or st.get("ready")):
                            break
                    except (urllib.error.URLError, OSError, ValueError):
                        pass
                    if time.monotonic() > deadline:
                        raise AssertionError(f"{name}: rank {r} at {url} not ready")
                    time.sleep(0.25)
        ready_s = time.perf_counter() - t_ready
        def serve_arm(name, new):
            """The prompts through one gang's coordinator, then its follower's
            and its gauges' checks."""
            (_, u0, _), (_, u1, _) = gangs[name]
            t0 = time.perf_counter()
            got = _shard_requests(u0, prompts, new)
            wall = time.perf_counter() - t0
            st0 = http(u0 + "/healthz")[1]
            st1 = http(u1 + "/healthz")[1]
            code, body, _ = http(u1 + "/generate", {"prompt": prompts[0],
                                                    "max_new_tokens": 4})
            if st1.get("ready") is not False or st0.get("ready") is not True:
                raise AssertionError(f"{name}: ready {st0.get('ready')} / {st1.get('ready')}")
            if code != 503 or body.get("status") != "not_coordinator":
                raise AssertionError(f"{name}: the follower's /generate answered {code} {body}")
            metrics = http(u0 + "/metrics")[1]
            for want in ("mlcomp_engine_mesh_devices 2", "mlcomp_engine_is_coordinator 1"):
                if want not in metrics.splitlines():
                    raise AssertionError(f"{name}: /metrics lacks {want!r}")
            return {"results": got, "wall_s": wall, "mesh": st0.get("mesh")}

        # the timed arm alone, then the other two side by side
        results, served, calls = {}, {}, {}
        served["dense_d2"] = serve_arm("dense_d2", SHARD["new"])
        with ThreadPoolExecutor(2) as ex:
            arms = {name: ex.submit(serve_arm, name, new)
                    for name, _, _, new in SHARD_GANGS if name != "dense_d2"}
            served.update({name: f.result() for name, f in arms.items()})
        # shutdown: SIGTERM to each coordinator; its followers must exit alone
        import signal

        for name, ranks in gangs.items():
            (p0, _, _), (p1, _, _) = ranks
            p0.send_signal(signal.SIGTERM)
        for name, ranks in gangs.items():
            (p0, _, o0), (p1, _, o1) = ranks
            rc0, rc1 = p0.wait(timeout=120), p1.wait(timeout=120)
            if rc0 or rc1:
                raise AssertionError(f"{name}: exit codes {rc0}, {rc1}: "
                                     f"{log_tail(tmp, name + '_rank1')}")
            results[name] = [torch.load(o0), torch.load(o1)]
            if name in SHARD_RECORDED:
                calls[name] = [torch.load(o0 + ".calls"), torch.load(o1 + ".calls")]
        # equality within the gang
        base = served["dense_d2"]["results"]
        if served["paged_d2"]["results"] != base:
            raise AssertionError("paged_d2's ids/logprobs differ from dense_d2's")
        if served["dense_d1"]["results"] != [(i[:SHARD_D1_NEW], lp[:SHARD_D1_NEW])
                                             for i, lp in base]:
            raise AssertionError(f"dense_d1's ids/logprobs differ from the first {SHARD_D1_NEW} "
                                 "of dense_d2's")
        # agreement with the one-card engine: the first-step logits (paged_d2's
        # coordinator recorded every step's), and the greedy ids up to the
        # first position where the one-card top-2 margin is below the gap
        # between the two engines' logits there
        steps = results["paged_d2"][0]["logits"]
        gaps, rels, divergence = [], [], []
        for i, p in enumerate(prompts):
            t = shard_trace_id(i)
            a, b = steps[t][len(p)], ref["logits"][t][len(p)]
            if not torch.equal(a, results["paged_d2"][0]["first"][t]):
                raise AssertionError(f"request {i}: the first step's logits are not the inserted "
                                     "row's")
            gaps.append(float((a - b).abs().max()))
            rels.append(gaps[-1] / float(b.abs().max()))
            ids, want = base[i][0], ref["ids"][i]
            j = next((k for k in range(min(len(ids), len(want))) if ids[k] != want[k]), None)
            if j is None and len(ids) != len(want):
                j = min(len(ids), len(want))
            row = {"request": i, "diverged_at": j}
            if j is not None:
                o, g = ref["logits"][t].get(len(p) + j), steps[t].get(len(p) + j)
                if o is None or g is None:
                    raise AssertionError(f"request {i}: no logits recorded at step {j}")
                top = torch.topk(o, 2).values
                row.update(margin=float(top[0] - top[1]), gap=float((o - g).abs().max()))
                if not row["margin"] < row["gap"]:
                    raise AssertionError(f"request {i}: the gang's greedy ids leave the one-card "
                                         f"engine's at step {j}, where the one-card top-2 margin "
                                         f"is not below the logits' gap: {row}")
            divergence.append(row)
        gap = max(gaps)
        if max(rels) > SHARD_LOGIT_RTOL:
            raise AssertionError(f"first-step logits of the gang {max(rels)} (relative) from the "
                                 f"one-card engine's, above {SHARD_LOGIT_RTOL}")
        equal = sum(d["diverged_at"] is None for d in divergence)
        # the kernels at the ranks' local shapes against their plain versions
        local = shard_local_checks(calls)
        for k, rows in local.items():
            log(f"sharded serving: {k} at local shapes, held against plain: "
                f"{json.dumps(rows)}")
        # the kernels ran on both ranks after warmup
        launches = {}
        for name, layout, _, _ in SHARD_GANGS:
            # B7 (a chunk through pages) runs only in a speculative verify,
            # which a mesh refuses: the paged decode is B6, its admissions B4/B5
            need = ("B1", "B2", "B3", "B4", "B5") if layout == "dense" else \
                ("B1", "B2", "B4", "B5", "B6")
            for r, res in enumerate(results[name]):
                if res["warm"] is None:
                    raise AssertionError(f"{name} rank {r}: no warm control record ran")
                moved = {k: res["final"][SHARD_KEYS[k]] - res["warm"][SHARD_KEYS[k]]
                         for k in SHARD_KEYS}
                launches[f"{name} rank {r}"] = moved
                if any(moved[k] <= 0 for k in need):
                    raise AssertionError(f"{name} rank {r}: kernels without launches after "
                                         f"warmup: {moved}")
        # the coordinator's dispatches after warmup (its warmup requests
        # resolve before the phase's first request is admitted)
        res0 = results["dense_d2"][0]
        tp_decode = shard_decode_ms(res0["resolved"], SHARD["slots"])
        one_ms, tp_ms = ref["decode_ms_per_step"]["ms"], tp_decode["ms"]
        summary = {
            "card": smi, "config": {k: SHARD_CFG[k] for k in SHARD_CFG},
            "serve": {**SHARD, "quantize": "kernel", "kv_quant": True, "mesh": {"tp": 2},
                      "backend": "gloo (two ranks share the card; NCCL refuses that)"},
            "world_of_one": {"backend": ref["backend"], "equal_bit_for_bit": True,
                             "launches": w1["launches"]},
            "first_step_logits": {"max_abs_gap": gap, "max_rel": max(rels),
                                  "tolerance_rel": SHARD_LOGIT_RTOL},
            "greedy": {"equal_throughout": equal, "of": len(prompts),
                       "divergence": divergence},
            "decode_ms_per_step_8_slots": {"tp2": tp_decode, "one_card": ref["decode_ms_per_step"],
                                           "how": "host time between the readbacks of the "
                                                  "first and last dispatches with all 8 slots "
                                                  "live, over the steps between them"},
            "peak_gb": {f"{n} rank {r}": res["peak_gb"] for n, rs in results.items()
                        for r, res in enumerate(rs)},
            "resident_gb": {f"{n} rank {r}": res["resident_gb"] for n, rs in results.items()
                            for r, res in enumerate(rs)},
            "one_card_peak_gb": ref["peak_gb"], "one_card_resident_gb": ref["resident_gb"],
            "transport": {f"{n} rank {r}": res["transport"] for n, rs in results.items()
                          for r, res in enumerate(rs)},
            "launches_after_warmup": launches,
            "local_kernel_checks": local,
            "local_shapes": {k: [list(map(str, s)) for s in v]
                             for k, v in results["paged_d2"][1]["shapes"].items()},
            "walls_s": {"npz_write": npz_s, "gangs_ready": ready_s,
                        "reference_load_warm": ref["load_warm_s"],
                        **{f"{n}_requests": served[n]["wall_s"] for n in served}},
        }
        for name, rs in results.items():
            for r, res in enumerate(rs):
                log(f"sharded serving {name} rank {r}: local kernel shapes "
                    f"{json.dumps({k: [str(x) for x in v] for k, v in res['shapes'].items()})}")
        log(f"sharded serving ({smi}): tp 2 gang over gloo: decode {tp_ms:.3f} ms/step at "
            f"{SHARD['slots']} live slots ({tp_decode['steps']} steps) against {one_ms:.3f} on "
            f"one card ({ref['decode_ms_per_step']['steps']} steps); GB per rank resident "
            f"after load "
            f"{json.dumps(summary['resident_gb'])}, peak while serving "
            f"{json.dumps(summary['peak_gb'])} (one card {ref['resident_gb']:.2f} and "
            f"{ref['peak_gb']:.2f}); collectives "
            f"by transport {json.dumps(summary['transport'])}; greedy ids equal throughout on "
            f"{equal} of {len(prompts)} (divergences {json.dumps(divergence)}); first-step "
            f"logit gap {gap} ({max(rels)} relative); phase "
            f"{time.perf_counter() - t_phase:.1f} s")
        summary["phase_s"] = time.perf_counter() - t_phase
        summary["reduced"] = SHARD_REDUCED
        return summary
    finally:
        end_procs(procs, timeout=30)
        kill_matching(tmp)
        shutil.rmtree(tmp, ignore_errors=True)


def parse_phases(argv):
    """``--phases a,b`` (names of SELECTABLE) -> that tuple; no argument ->
    None, every phase."""
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port on one GPU (see the module's "
                                             "docstring); with no argument every phase runs.")
    ap.add_argument("--phases", default=None,
                    help="a focused run of these phases only, comma-separated, of: "
                         + ", ".join(SELECTABLE))
    args = ap.parse_args(argv)
    if args.phases is None:
        return None
    names = tuple(n.strip() for n in args.phases.split(",") if n.strip())
    bad = [n for n in names if n not in SELECTABLE]
    if bad or not names:
        ap.error(f"--phases takes some of {', '.join(SELECTABLE)}; got {args.phases!r}")
    return names


def focused_run(phases, dev, smi, card, bw, flops) -> None:
    """The phases of ``phases`` alone (after the build and the resource
    lines), in the full run's order, each failing as it does there; their
    JSON lines, then the wall line.  The kernel, serving and train phases
    and the summary's kernels line belong to the full run only."""
    from mlcomp_tpu_torch.ops.cuda import decode_attention as da
    from mlcomp_tpu_torch.ops.cuda import flash_attention as fa
    from mlcomp_tpu_torch.ops.cuda import quant_matmul as qm

    results = {}
    if "device_profile" in phases:
        phase("device profile")
        results["device_profile"] = device_profile_process(smi, bw)
    phase("resources")
    log("flash kernel resources: " + json.dumps(fa.resources()))
    log("quant_matmul resources: " + json.dumps(qm.resources()))
    log("decode_attention resources: " + json.dumps(da.resources()))
    for name, label, run in (
            ("zoo", "model zoo", lambda: zoo_phase("cuda", smi, bw, flops)),
            ("attention_dims", "attention dims and dtypes",
             lambda: attention_dims_phase("cuda", smi, bw, flops, F32_PEAKS[card])),
            ("moe", "moe", lambda: moe_phase("cuda", smi, bw, flops)),
            ("sharded_serving", "sharded serving", lambda: sharded_serving_phase(smi)),
            ("parallel", "parallel", lambda: parallel_process(smi))):
        if name in phases:
            gc.collect()
            torch.cuda.empty_cache()
            phase(label)
            results[name] = run()
    for name, r in results.items():
        if name == "attention_dims":
            r = {k: v for k, v in r.items() if k != "rows"}
        log(json.dumps({name: r}))
    wall_line(smi)


def main(argv=None) -> int:
    phases = parse_phases(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. device
    phase("device")
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
    phase("build")
    from mlcomp_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    if phases is not None:
        focused_run(phases, dev, smi, card, bw, flops)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # ---- 2b. device profile: early, before the long phases (late in a long
    # run the profiler has lost records on this card's machine), and in a
    # process of its own: a profiler session with the card's activity can
    # leave its process slower at every later launch, and the serving
    # phases below time the host
    phase("device profile")
    devprof_result = device_profile_process(smi, bw)
    phase("resources")

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
    phase("kernels")
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
    held = held_to_plain

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
        """Device time of one call, the calls cycled over ``fns``
        (``queued_device_ms``): without the host's launch overhead that
        plain CUDA events see when the card outruns the host."""
        calls = iter(range(10 ** 9))
        return queued_device_ms(lambda: fns[next(calls) % len(fns)](), iters)

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
    # times after the serving phases
    chunk_inputs = [chunk_inputs_b3]

    # B4: an admission chunk (1, 256) at cache index 256 of a 512-token
    # prompt with left padding (window [pad, 512)), and a verify-width
    # chunk S = 32 of 8 rows at per-row cursors (the first two rows, which
    # the summary reads); then a GQA chunk at a ragged S, head dim 256, and
    # windows that start mid-block with one row's window empty.  Each case
    # prints its chunk_plan route and must give the same bits on a rerun
    def chunk_case(b, s_q, starts, stop0, h=heads, h_kv=heads, d=dh, length=None, case=None,
                   gen=g):
        length = length or l_buf
        case = case or f"{b}x{s_q}"
        sc_ = 1.0 / math.sqrt(d)
        plan = da.chunk_plan(s_q, h, h_kv, b, d, length)
        log(f"  B4 {case}: chunk_plan {json.dumps(plan)}")
        cs = [quant_cache(b, h_kv, d, length, gen=gen)
              for _ in range(copies_for(2 * b * h_kv * length * d))]
        qc = torch.randn(b, s_q, h, d, generator=gen, device=dev).bfloat16()
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

    def paged_case(key, twin, qp, cache, starts, stop0, case=None, gen=g):
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
        pages, table, dense = paginate(cache, stop0 + s_q - 2, gen=gen)
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
    bwd_abs = flash_bwd_abs

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
    # ROADMAP §C8: B5 and B10 at configs/longcontext_lm.yml's attention
    # (1 x 32768), leaf by leaf against f32 attention beside SDPA
    long_flash_leaves(dev, {"randn": long_randn_inputs(dev)})

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

    # The speculative verify's widths: B4 (dense) and B7 (through pages) at 8
    # rows x 8 queries (spec_k 7 at 8 slots, the engine's) and 1 x 9 (spec_k
    # 8, the speculative batcher's), each against its plain version, bit-equal
    # on a rerun, B7 == B4 on the same bytes, its chunk_plan route printed;
    # their device times come after the train phase.  Own generator, last
    gsp = torch.Generator(device=dev).manual_seed(SEED + 4)
    for b_, s_ in ((BATCH, 8), (1, 9)):
        spec_case = f"spec verify {b_}x{s_}"
        st_ = torch.randint(0, 100, (b_,), generator=gsp, **i32)
        so_ = torch.randint(PROMPT, PROMPT + NEW - s_, (b_,), generator=gsp, **i32)
        chunk_case(b_, s_, st_, so_, case=spec_case, gen=gsp)
        paged_case("B7", "decode_attention_chunk",
                   torch.randn(b_, s_, heads, dh, generator=gsp, device=dev).bfloat16(),
                   quant_cache(b_, gen=gsp), st_, so_, case=spec_case, gen=gsp)

    # ---- 4. window serve
    phase("window serve")
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
    phase("window parity")
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
    phase("engine serve")
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
    phase("engine parity")
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
    phase("paged engine serve")
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
    phase("disaggregated handoff")
    from mlcomp_tpu_torch.kvpool.transfer import HandoffError

    hand_prompts = [bodies[i]["prompt"] for i in greedy] + [alone]
    # the dense engine's ids of these prompts (the fleet phase's two-hop
    # path is held to them too; `want` is a name later phases reuse)
    hand_want = list(want)
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

    # ---- 8c. prefix cache and daemon surface: the same weights, int8 KV
    phase("prefix cache and daemon surface")
    from mlcomp_tpu_torch.serve import start_warmup

    # prompts of 340-500 tokens; "a", "b" and "c" share a 320-token prefix,
    # longer than one 256-token chunk, "d" shares nothing.  A repeat at the
    # same placement hits the device registry first on the paged layout
    # (B8), the host cache on the dense one, and must give the cache-off
    # tokens when its first instance was a cold prefill.  A prompt of a new
    # length that shares the prefix misses the registry (another placement)
    # and hits the host cache on both layouts: its first chunk is skipped
    # and its second (B4) attends over rows that came from host RAM.  Those
    # rows were computed along another chunk path (a 256-token chunk at
    # index 0 attends its fresh K/V, a later one the int8 cache), so its
    # tokens are compared with the cache-off engine's, not required equal.
    shared = prompt_of(320)
    pc = {key: shared + prompt_of(n - 320) for key, n in (("a", 340), ("b", 400), ("c", 460))}
    pc["d"] = prompt_of(500)
    pc_order = ["a", "a", "b", "c", "b", "d", "d"]
    pc_new = 32
    cold_lone = [prompt_of(400) for _ in range(LONE_REPEATS)]

    def span_ms(svc, name, hit=False):
        """Sorted ms of the flight recorder's ``name`` spans (with a hit only)."""
        evs = [e for e in svc.trace()["traceEvents"] if e.get("name") == name
               and e.get("ph") == "X" and (not hit or (e["args"].get("hit_tokens") or 0) > 0)]
        return sorted(e["dur"] / 1e3 for e in evs)

    def med(xs):
        return {"median": xs[len(xs) // 2], "spread": [xs[0], xs[-1]], "n": len(xs)}

    def prefix_run(label, **layout):
        """The prefix-cache sequence over HTTP with launch counts; lone TTFT
        of cold prompts and of their repeats; the cache's bytes and the
        recorder's lookup + upload and capture times; then the same prompts
        through a cache-off engine."""
        nonlocal url
        svc = load_service(CFG, prefix_cache=True, **layout, **serve_kw)
        eng = svc.engine
        httpd = make_http_server(svc, "127.0.0.1", 0, model_name="transformer_lm-1.2b")
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            post({"prompt": warm, "max_new_tokens": 2})   # warm the allocator
            svc.prefix_cache.flush()
            for k in kernels.values():
                k.reset()
            st0 = eng.stats()
            res = []
            for key in pc_order:
                res.append(post({"prompt": pc[key], "max_new_tokens": pc_new}))
                svc.prefix_cache.flush()       # the capture lands before the next lookup
            counts = {key: k.launches for key, k in kernels.items()}
            st1 = eng.stats()
            # lone TTFT: cold prompts one at a time, then each again (a hit)
            lone = {"cold": [], "hit": []}
            for kind in ("cold", "hit"):
                for p in cold_lone:
                    events, t_first, _ = sse({"prompt": p, "max_new_tokens": 16})
                    lone[kind].append((t_first * 1e3, streamed(events, 16)))
                    svc.prefix_cache.flush()
            upload_ms, capture_ms = span_ms(svc, "prefix_cache.lookup", hit=True), span_ms(
                svc, "prefix_cache.capture")
            cstats, st2 = svc.cache_stats(), eng.stats()
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.join(timeout=10)
            svc.close()
        off_kw = {"kv_layout": "paged", "kv_page_tokens": page_t} if layout else {}
        off = DecodeEngine(svc.model, slots=BATCH, **off_kw, **engine_kw)
        try:
            off_ids = {key: off.submit(pc[key], pc_new).result(timeout=300)["ids"]
                       for key in pc}
        finally:
            off.close()
        hits = [r["cache_hit_tokens"] for r in res]
        ids = [r["ids"] for r in res]
        first = {key: pc_order.index(key) for key in pc}
        cold_first = [key for key in pc if hits[first[key]] == 0]
        repeats = [i for i, key in enumerate(pc_order) if i != first[key]]
        lone_hits = [r["cache_hit_tokens"] for _, r in lone["hit"]]
        if (sorted(cold_first) != ["a", "d"] or min(hits[i] for i in repeats) <= 0
                or min(lone_hits) <= 0 or any(r["cache_hit_tokens"] for _, r in lone["cold"])):
            raise AssertionError(f"{label}: cache_hit_tokens {hits}, lone {lone_hits}")
        # a repeat gives its first instance's tokens, and the cache-off
        # engine's when that was a cold prefill
        if (any(ids[i] != ids[first[pc_order[i]]] for i in repeats)
                or any(ids[first[key]] != off_ids[key] for key in cold_first)
                or [r["ids"] for _, r in lone["hit"]] != [r["ids"] for _, r in lone["cold"]]):
            raise AssertionError(f"{label}: a repeated prompt's tokens differ from cold")
        if st2["cache_degraded"] or cstats["insert_errors"]:
            raise AssertionError(f"{label}: cache_degraded {st2['cache_degraded']}, capture "
                                 f"errors {cstats['insert_errors']}")
        host_hits = st1["prefix_cache"]["used_hits"] - st0["prefix_cache"]["used_hits"]
        registry_hits = counts["B8"] // (4 * layers)
        # every request runs its last chunk at index 256 (B4); only the cold
        # ones run their first chunk (B5 at index 0): a hit skips it
        want = {"B4": layers * len(pc_order), "B5": layers * len(cold_first)}
        if layout:
            want.update(B3=0, B8=4 * layers * 3)
            tiers = (registry_hits, host_hits) == (3, 2)
        else:
            want.update(B6=0, B8=0)
            tiers = host_hits == 5
        bad = {key: counts[key] for key, n in want.items() if counts[key] != n}
        decode_key = "B6" if layout else "B3"
        if bad or not tiers or counts[decode_key] <= 0 or counts["B1"] <= 0 or counts["B2"] <= 0:
            raise AssertionError(f"{label}: launches {counts} (expected {want}); registry hits "
                                 f"{registry_hits}, host hits {host_hits}")
        shared_hits = [key for key in pc if key not in cold_first]
        out = {
            "requests": pc_order, "prompt_tokens": {k: len(v) for k, v in pc.items()},
            "cache_hit_tokens": hits, "registry_hits": registry_hits, "host_hits": host_hits,
            "repeats_equal_cold": len(repeats) + len(cold_lone),
            "shared_prefix_hits_equal_cache_off": sum(ids[first[k]] == off_ids[k]
                                                      for k in shared_hits),
            "shared_prefix_hits": len(shared_hits),
            "lone_ttft_ms": {kind: med(sorted(t for t, _ in lone[kind])) for kind in lone},
            "lone_hit_tokens": lone_hits, "loadavg": list(os.getloadavg()),
            "bytes_stored": cstats["bytes"], "inserted_tokens": cstats["inserted_tokens"],
            "hit_lookup_upload_ms": med(upload_ms), "capture_ms_off_loop": med(capture_ms),
            "launches": counts, "cache_degraded": st2["cache_degraded"],
        }
        log(f"{label} with the prefix cache ({smi}): hit tokens {hits}; lone TTFT "
            f"{json.dumps(out['lone_ttft_ms'])} ms; {cstats['bytes']} bytes stored; a host "
            f"hit's lookup + upload {json.dumps(out['hit_lookup_upload_ms'])} ms; capture off "
            f"the loop {json.dumps(out['capture_ms_off_loop'])} ms; launches "
            f"{json.dumps(counts)}; repeats equal cold; shared-prefix hits equal to the "
            f"cache-off engine's: {out['shared_prefix_hits_equal_cache_off']} of "
            f"{len(shared_hits)}")
        return out, [r["ids"] for _, r in lone["cold"]]

    pc_dense, lone_dense = prefix_run("dense engine")
    pc_paged, lone_paged = prefix_run("paged engine", kv_layout="paged", kv_page_tokens=page_t)
    if lone_dense != lone_paged:
        raise AssertionError("the paged engine's tokens differ from the dense engine's")
    torch.cuda.empty_cache()

    # the daemon: --warmup (ready false until it ends), /metrics, 429s under
    # --max-queue-depth 2 with 11 concurrent clients, a client's traceparent
    dsvc = load_service(CFG, prefix_cache=True, max_queue_depth=2, **serve_kw)
    httpd = make_http_server(dsvc, "127.0.0.1", 0, model_name="transformer_lm-1.2b")
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def health():
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            return json.loads(r.read())

    def post_status(body, headers=None):
        req = urllib.request.Request(url + "/generate", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json",
                                              **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.status, None, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, e.headers.get("Retry-After"), json.loads(e.read())

    try:
        warm_failed = []
        t0 = time.perf_counter()
        warm_thread = start_warmup(dsvc, warm_failed.append)
        answers = []
        while not warm_failed:
            answers.append(health()["ready"])
            if answers[-1] or time.perf_counter() - t0 > 600:
                break
            time.sleep(0.002)
        time_to_ready = time.perf_counter() - t0
        warm_thread.join(timeout=60)
        if warm_failed:
            raise warm_failed[0]
        if not answers[-1] or answers[0] or warm_thread.is_alive():
            raise AssertionError(f"--warmup: ready answers {answers[:3]}...{answers[-3:]}")
        events, t_first, _ = sse({"prompt": prompt_of(400), "max_new_tokens": 16})
        streamed(events, 16)
        first_ttft_ms = t_first * 1e3
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            ctype, text = r.headers["Content-Type"], r.read().decode()
        families = set()
        for line in text.splitlines():
            if line.startswith("# TYPE "):
                families.add(line.split()[2])
            elif line and not line.startswith("#"):
                name, value = line.rsplit(" ", 1)
                float(value)
                if not re.fullmatch(r"[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})?", name):
                    raise AssertionError(f"/metrics: bad sample line {line!r}")
        need = {"mlcomp_engine_ttft_ms", "mlcomp_prefix_cache_used_hits_total",
                "mlcomp_serving_requests_rejected_total", "mlcomp_cache_degraded_total"}
        if not ctype.startswith("text/plain; version=0.0.4") or not need <= families:
            raise AssertionError(f"/metrics: {ctype}, missing {need - families}")
        flood = [{"prompt": prompt_of(500), "max_new_tokens": 32} for _ in range(11)]
        with ThreadPoolExecutor(len(flood)) as ex:
            outs = list(ex.map(post_status, flood))
        ok = [o for o in outs if o[0] == 200]
        rejected = [o for o in outs if o[0] == 429]
        if (len(ok) + len(rejected) != len(outs) or not rejected or not ok
                or any(len(o[2]["ids"]) != 32 for o in ok)
                or any(o[2]["reason"] != "queue_full" or int(o[1]) < 1 for o in rejected)):
            raise AssertionError(f"--max-queue-depth 2: {[(o[0], o[1]) for o in outs]}")
        tid = "0af7651916cd43dd8448eb211c80319c"
        code, _, res = post_status({"prompt": prompt_of(300), "max_new_tokens": 8},
                                   {"traceparent": f"00-{tid}-b7ad6b7169203331-01"})
        with urllib.request.urlopen(f"{url}/trace?trace_id={tid}", timeout=60) as r:
            tevs = [e for e in json.loads(r.read())["traceEvents"] if e.get("ph") != "M"]
        tnames = sorted({e["name"] for e in tevs})
        if code != 200 or res["trace_id"] != tid or not {"request", "admit", "insert"} <= set(
                tnames):
            raise AssertionError(f"traceparent: {code}, {res.get('trace_id')}, {tnames}")
        dst = dsvc.stats()
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=10)
        dsvc.close()
    daemon = {
        "time_to_ready_s": time_to_ready, "ready_answers": len(answers),
        "ready_false_answers": answers.count(False),
        "first_request_ttft_ms": first_ttft_ms, "metrics_families": len(families),
        "max_queue_depth": 2, "clients": len(flood), "accepted": len(ok),
        "rejected_429": len(rejected), "retry_after_s": sorted(int(o[1]) for o in rejected),
        "rejected_counter": dst["rejected"], "traceparent_events": len(tevs),
        "traceparent_event_names": tnames, "card": smi,
    }
    log(f"daemon ({smi}): ready after {time_to_ready:.2f} s of --warmup ({answers.count(False)} "
        f"/healthz answers ready: false first); first request's TTFT {first_ttft_ms:.1f} ms; "
        f"/metrics {len(families)} families; --max-queue-depth 2 under {len(flood)} clients: "
        f"{len(ok)} served, {len(rejected)} x 429 (Retry-After {daemon['retry_after_s']}); "
        f"traceparent {tid}: {len(tevs)} events {tnames}")
    # the server's handler class holds its service: drop both (and with
    # them the last reference to the window phase's service, which the
    # name httpd kept alive into the train phase before this phase existed)
    del dsvc, httpd, server
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 9. bf16-KV paged engine: each layer's K and V gathered through B8
    phase("bf16-KV paged engine")
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

    # ---- 9b. speculation: the dense and the paged engine's speculative
    # dispatch (spec_k 7 at 8 slots: a verify puts 64 rows through B1/B2, the
    # decode kernel's upper edge; B4 on the dense cache, B7 through 128-slot
    # pages) and the B = 1 speculative batcher (spec_k 8: B4 at 1 x 9)
    phase("speculation")
    SPEC_K, SPEC_K_B1 = 7, 8
    spec_kw = dict(prompt_buckets=(PROMPT,), max_new_cap=NEW, prefill_chunk=CHUNK)
    spec_svc = load_service(CFG, batcher="speculative", spec_k=SPEC_K_B1,
                            **{**serve_kw, "batch_sizes": (1,)})
    smodel = spec_svc.model
    spec_prompts = [bodies[i]["prompt"] for i in greedy] + [alone]

    def spec_run(eng, prompts, label):
        """``prompts`` at once through ``eng`` (greedy, NEW tokens each):
        ids, wall, launch counts, tokens, verifies and the engine's
        acceptance over the run."""
        eng.submit(warm, 2).result(timeout=300)
        for k in kernels.values():
            k.reset()
        da.chunk_tc_launches = da.split_launches = 0
        st0 = eng.stats()
        t0 = time.perf_counter()
        ids = [f.result(timeout=600)["ids"] for f in [eng.submit(p, NEW) for p in prompts]]
        wall = time.perf_counter() - t0
        counts = {key: k.launches for key, k in kernels.items()}
        st1 = eng.stats()
        run = {"ids": ids, "wall_s": wall, "counts": counts,
               "chunk_tc": da.chunk_tc_launches, "split": da.split_launches,
               "emitted": st1["emitted_tokens"] - st0["emitted_tokens"],
               "issued": st1["pipeline"]["issued"] - st0["pipeline"]["issued"],
               "prefill_chunks": st1["prefill_chunks"] - st0["prefill_chunks"],
               "spec_rows": st1.get("spec_rows", 0) - st0.get("spec_rows", 0)}
        run["tok_s"] = run["emitted"] / wall
        if run["spec_rows"]:
            run["acceptance_tokens_per_row"] = run["emitted"] / run["spec_rows"]
        if any(len(i) != NEW or not all(0 <= t < vocab for t in i) for i in ids):
            raise AssertionError(f"{label}: expected {NEW} ids in the vocabulary per request")
        log(f"{label}: {len(prompts)} requests, {run['emitted']} tokens in {wall:.2f} s "
            f"({run['tok_s']:.1f} tok/s), {run['issued']} dispatches, acceptance "
            f"{run.get('acceptance_tokens_per_row')}; launches {json.dumps(counts)}")
        return run

    def spec_checks(run, label, chunk_key, single_keys):
        """A speculating engine's launches: every dispatch one verify, each
        layer's attention one ``chunk_key`` launch (B4 dense, B7 paged) on
        the tensor-core body; admissions B5 (a chunk at index 0) or B4; no
        single-query launch (B3, B6) at all."""
        c = run["counts"]
        verifies = layers * run["issued"]
        chunks_b4 = layers * run["prefill_chunks"] - c["B5"]
        want_b4 = chunks_b4 + (verifies if chunk_key == "B4" else 0)
        if (c[chunk_key] <= 0 or c["B4"] != want_b4
                or (chunk_key == "B7" and c["B7"] != verifies)):
            raise AssertionError(f"{label}: B4 {c['B4']} launches (want {want_b4}), B7 "
                                 f"{c['B7']} (want {verifies if chunk_key == 'B7' else 0}) for "
                                 f"{run['issued']} verifies and {run['prefill_chunks']} chunks")
        if any(c[k] for k in single_keys) or run["split"]:
            raise AssertionError(f"{label}: a single-query kernel ran during spec decode: "
                                 f"{ {k: c[k] for k in single_keys} }, {run['split']} split-body "
                                 "launches")
        if run["chunk_tc"] != c["B4"] + c["B7"] or c["B1"] <= 0 or c["B2"] <= 0:
            raise AssertionError(f"{label}: {run['chunk_tc']} tensor-core launches for "
                                 f"{c['B4']} B4 and {c['B7']} B7; B1 {c['B1']}, B2 {c['B2']}")

    plain_eng = DecodeEngine(smodel, slots=BATCH, **engine_kw)
    try:
        plain_run = spec_run(plain_eng, spec_prompts, "non-spec dense engine")
        # candidates for a multi-token verify: seeded prompts of a repeated
        # 4-gram; random-weight greedy streams fall into cycles, and a
        # continuation that repeats a bigram gives the draft a hit
        gcand = torch.Generator().manual_seed(SEED + 5)
        cands = [torch.randint(1, vocab, (4,), generator=gcand).tolist() * 24 for _ in range(16)]
        cand_ids = [f.result(timeout=600)["ids"]
                    for f in [plain_eng.submit(p, NEW) for p in cands]]
    finally:
        plain_eng.close()

    def repeats_bigram(ids):
        pairs = list(zip(ids, ids[1:]))
        return len(set(pairs)) < len(pairs)

    cycling = [p for p, ids in zip(cands, cand_ids) if repeats_bigram(ids)][:BATCH]
    if not cycling:
        raise AssertionError("no candidate prompt's greedy continuation repeats a bigram: no "
                             "prompt to hold a multi-token verify on")
    spec_dense = DecodeEngine(smodel, slots=BATCH, spec_k=SPEC_K, **spec_kw)
    try:
        if spec_dense.steps_per_dispatch != 1 or spec_dense.spec_k != SPEC_K:
            raise AssertionError(f"not the spec engine asked for: {spec_dense.stats()}")
        dense_spec = spec_run(spec_dense, spec_prompts, "dense spec engine")
        dense_cyc = spec_run(spec_dense, cycling, "dense spec engine, cycling prompts")
    finally:
        spec_dense.close()
    spec_checks(dense_spec, "dense spec engine", "B4", ("B3", "B6", "B7"))
    spec_paged = DecodeEngine(smodel, slots=BATCH, spec_k=SPEC_K, kv_layout="paged",
                              kv_page_tokens=page_t, max_slots=BATCH, **spec_kw)
    try:
        paged_spec = spec_run(spec_paged, spec_prompts, "paged spec engine")
        paged_cyc = spec_run(spec_paged, cycling, "paged spec engine, cycling prompts")
        if spec_paged.stats()["peak_live_slots"] != BATCH:
            raise AssertionError("the paged spec engine changed its slot count")
    finally:
        spec_paged.close()
    spec_checks(paged_spec, "paged spec engine", "B7", ("B3", "B6"))
    for a, b, what in ((paged_spec, dense_spec, "requests"), (paged_cyc, dense_cyc, "cycling")):
        if a["ids"] != b["ids"]:
            bad = [i for i, (x, y) in enumerate(zip(a["ids"], b["ids"])) if x != y]
            raise AssertionError(f"paged spec {what} {bad} differ from the dense spec engine's")
    if dense_cyc["emitted"] <= dense_cyc["spec_rows"]:
        raise AssertionError(f"no verify emitted more than one token on the cycling prompts: "
                             f"{dense_cyc['emitted']} tokens in {dense_cyc['spec_rows']} "
                             "row-verifies")
    log(f"paged spec == dense spec on {len(spec_prompts)} requests and {len(cycling)} cycling "
        f"prompts; cycling acceptance {dense_cyc['acceptance_tokens_per_row']:.3f} tokens a row "
        "a verify")

    # the cross-body noise D: from one prefilled state of the 8 greedy
    # prompts, one verify of K+1 tokens (B4, 64 rows through B1/B2) against
    # K+1 single-token steps on the same tokens (B3, 8 rows): the largest
    # logit difference
    def padded(prompts):
        row = torch.zeros((len(prompts), PROMPT), dtype=torch.long)
        mask = torch.zeros((len(prompts), PROMPT), dtype=torch.bool)
        for r, p in enumerate(prompts):
            row[r, PROMPT - len(p):] = torch.tensor(p)
            mask[r, PROMPT - len(p):] = True
        return row.to(dev), mask.to(dev)

    with torch.inference_mode():
        nb = len(greedy)
        row_, mask_ = padded(spec_prompts[:nb])
        pos_ = torch.clamp(torch.cumsum(mask_.int(), 1) - 1, min=0)
        cache = smodel.init_cache(nb, PROMPT + NEW + SPEC_K + 1)
        kv_start_ = (PROMPT - mask_.sum(1)).int()
        smodel(row_, positions=pos_, cache=cache, last_only=True, kv_start=kv_start_)
        snap = [{n: t.clone() for n, t in vars(layer).items()} for layer in cache.layers]
        seq = torch.tensor([ids[: SPEC_K + 1] for ids in plain_run["ids"][:nb]], device=dev)
        vpos = mask_.sum(1)[:, None] + torch.arange(SPEC_K + 1, device=dev)[None]
        lv = smodel(seq, positions=vpos, cache=cache, kv_start=kv_start_)
        for layer, saved in zip(cache.layers, snap):
            for n, t in saved.items():
                getattr(layer, n).copy_(t)
        cache.index = PROMPT
        ls = torch.stack([smodel(seq[:, j:j + 1], positions=vpos[:, j:j + 1], cache=cache,
                                 kv_start=kv_start_)[:, 0] for j in range(SPEC_K + 1)], 1)
        noise_d = (lv - ls).abs().max().item()
        del cache, snap, lv, ls
    log(f"cross-body noise D: {noise_d:.6g} (largest logit difference, verify against single "
        f"steps, {nb} rows x {SPEC_K + 1} positions)")

    # spec against non-spec: at each divergence the teacher-forced margin of
    # the two tokens, on the non-spec engine's own path (its chunked
    # admission, then single steps over the common prefix), must be <= 2 D
    def teacher_margin(prompt, prefix, a, b):
        with torch.inference_mode():
            row, mask = padded([prompt])
            pos = torch.clamp(torch.cumsum(mask.int(), 1) - 1, min=0)
            kv_start = (PROMPT - mask.sum(1)).int()
            cache = smodel.init_cache(1, PROMPT + NEW + 1)
            first = (PROMPT - len(prompt)) // CHUNK
            cache.index = first * CHUNK
            for lo in range(first * CHUNK, PROMPT, CHUNK):
                lg = smodel(row[:, lo:lo + CHUNK], positions=pos[:, lo:lo + CHUNK], cache=cache,
                            last_only=True, kv_start=kv_start)[:, -1]
            p = len(prompt)
            for t in prefix:
                lg = smodel(torch.tensor([[t]], device=dev), positions=torch.tensor([[p]],
                            device=dev), cache=cache, kv_start=kv_start)[:, -1]
                p += 1
            return (lg[0, b] - lg[0, a]).item()

    margins = []
    for p, s_ids, n_ids in zip(spec_prompts, dense_spec["ids"], plain_run["ids"]):
        if s_ids == n_ids:
            continue
        at = next(i for i, (x, y) in enumerate(zip(s_ids, n_ids)) if x != y)
        m = teacher_margin(p, n_ids[:at], s_ids[at], n_ids[at])
        margins.append({"position": at, "spec_token": s_ids[at], "plain_token": n_ids[at],
                        "margin": m})
    spec_equal = sum(a == b for a, b in zip(dense_spec["ids"], plain_run["ids"]))
    log(f"spec == non-spec on {spec_equal} of {len(spec_prompts)} requests; divergences "
        f"(teacher-forced margins, limit 2 D = {2 * noise_d:.6g}): {json.dumps(margins)}")
    if any(abs(m["margin"]) > 2 * noise_d for m in margins):
        raise AssertionError(f"a spec/non-spec divergence has a margin above 2 D = "
                             f"{2 * noise_d}: {margins}")

    # B = 1: the speculative batcher (spec_k 8) against the window batcher
    b1_prompts = cycling[:2] + spec_prompts[:2]
    spec_svc.generate(warm, 2)
    for k in kernels.values():
        k.reset()
    da.chunk_tc_launches = da.split_launches = 0
    b1_st0 = spec_svc.stats()
    t0 = time.perf_counter()
    b1_ids = [spec_svc.generate(p, NEW)["ids"] for p in b1_prompts]
    b1_wall = time.perf_counter() - t0
    b1_counts = {key: k.launches for key, k in kernels.items()}
    b1_st = {k: v - b1_st0[k] for k, v in spec_svc.stats().items()
             if k in ("spec_tokens", "spec_forwards")}
    spec_svc.close()
    if b1_counts["B4"] <= 0 or b1_counts["B3"] or b1_counts["B6"] or b1_counts["B7"]:
        raise AssertionError(f"speculative batcher launches {b1_counts}: B4 must carry every "
                             "verify, and no single-query kernel may run")
    win_svc = load_service(CFG, batcher="window", **{**serve_kw, "batch_sizes": (1,)})
    try:
        win_svc.generate(warm, 2)
        t0 = time.perf_counter()
        win_ids = [win_svc.generate(p, NEW)["ids"] for p in b1_prompts]
        win_wall = time.perf_counter() - t0
    finally:
        win_svc.close()

    # B = 1 against the window batcher, on the two batchers' own paths: a
    # B = 1 prefill of the padded prompt (the speculative batcher's cache
    # holds K slots more), then a verify of K+1 tokens (B4 at 1 x 9) against
    # K+1 single steps (B3).  D1 is the largest logit difference on the
    # window batcher's first K+1 tokens of each prompt; at each divergence
    # the window path's teacher-forced margin of the two tokens must be <= 2 D1
    def one_row_prefill(prompt, slack):
        row, mask = padded([prompt])
        total = PROMPT + NEW + slack
        cache = smodel.init_cache(1, total)
        kv_mask = torch.cat([mask, torch.ones((1, total - PROMPT), dtype=torch.bool,
                                              device=dev)], 1)
        pos = torch.clamp(torch.cumsum(mask.int(), 1) - 1, min=0)
        lg = smodel(row, positions=pos, cache=cache, kv_mask=kv_mask, last_only=True)[:, -1]
        return cache, kv_mask, lg

    def b1_margin(prompt, prefix, a, b):
        cache, kv_mask, lg = one_row_prefill(prompt, 0)
        for i, t in enumerate(prefix):
            lg = smodel(torch.tensor([[t]], device=dev),
                        positions=torch.tensor([[len(prompt) + i]], device=dev), cache=cache,
                        kv_mask=kv_mask, last_only=True)[:, -1]
        return (lg[0, b] - lg[0, a]).item()

    noise_d1, b1_margins = 0.0, []
    with torch.inference_mode():
        for p, w_ids in zip(b1_prompts, win_ids):
            seq = torch.tensor([w_ids[: SPEC_K_B1 + 1]], device=dev)
            vpos = len(p) + torch.arange(SPEC_K_B1 + 1, device=dev)[None]
            cache, kv_mask, _ = one_row_prefill(p, SPEC_K_B1)
            lv = smodel(seq, positions=vpos, cache=cache, kv_mask=kv_mask)
            cache, kv_mask, _ = one_row_prefill(p, 0)
            ls = torch.stack([smodel(seq[:, j:j + 1], positions=vpos[:, j:j + 1], cache=cache,
                                     kv_mask=kv_mask)[:, 0] for j in range(SPEC_K_B1 + 1)], 1)
            noise_d1 = max(noise_d1, (lv - ls).abs().max().item())
            del cache, lv, ls
        for p, s_ids, w_ids in zip(b1_prompts, b1_ids, win_ids):
            if s_ids == w_ids:
                continue
            at = next(i for i, (x, y) in enumerate(zip(s_ids, w_ids)) if x != y)
            b1_margins.append({"position": at, "spec_token": s_ids[at],
                               "window_token": w_ids[at],
                               "margin": b1_margin(p, w_ids[:at], s_ids[at], w_ids[at])})
    log(f"B = 1 cross-body noise D1: {noise_d1:.6g} (verify 1 x {SPEC_K_B1 + 1} against single "
        f"steps, {len(b1_prompts)} prompts); divergences from the window batcher "
        f"(teacher-forced margins, limit 2 D1 = {2 * noise_d1:.6g}): {json.dumps(b1_margins)}")
    if any(abs(m["margin"]) > 2 * noise_d1 for m in b1_margins):
        raise AssertionError(f"a speculative/window batcher divergence has a margin above "
                             f"2 D1 = {2 * noise_d1}: {b1_margins}")
    b1 = {"spec_k": SPEC_K_B1, "requests": len(b1_prompts), "tokens": b1_st["spec_tokens"],
          "forwards": b1_st["spec_forwards"],
          "tokens_per_forward": b1_st["spec_tokens"] / b1_st["spec_forwards"],
          "tok_s": len(b1_prompts) * NEW / b1_wall,
          "window_batcher_b1_tok_s": len(b1_prompts) * NEW / win_wall,
          "equal_window_batcher": sum(a == b for a, b in zip(b1_ids, win_ids)),
          "cross_body_noise_d1": noise_d1, "divergence_margins": b1_margins,
          "launches": b1_counts}
    log(f"speculative batcher B=1: {b1['tokens_per_forward']:.3f} tokens a forward, "
        f"{b1['tok_s']:.1f} tok/s against the window batcher's {b1['window_batcher_b1_tok_s']:.1f}"
        f"; ids equal on {b1['equal_window_batcher']} of {len(b1_prompts)}")
    spec_result = {
        "spec_k": SPEC_K, "slots": BATCH, "requests": len(spec_prompts),
        "non_spec": {k: plain_run[k] for k in ("wall_s", "tok_s", "emitted", "issued")},
        "dense": {k: dense_spec.get(k) for k in ("wall_s", "tok_s", "emitted", "issued",
                                                  "acceptance_tokens_per_row", "counts")},
        "paged": {k: paged_spec.get(k) for k in ("wall_s", "tok_s", "emitted", "issued",
                                                  "acceptance_tokens_per_row", "counts")},
        "cycling": {"prompts": len(cycling), "candidates": len(cands),
                    "dense_acceptance_tokens_per_row": dense_cyc["acceptance_tokens_per_row"],
                    "paged_acceptance_tokens_per_row": paged_cyc["acceptance_tokens_per_row"],
                    "dense_tok_s": dense_cyc["tok_s"]},
        "paged_equal_dense": len(spec_prompts) + len(cycling),
        "spec_equal_non_spec": spec_equal, "cross_body_noise_d": noise_d,
        "divergence_margins": margins, "batcher_b1": b1,
        "b4_launches": dense_spec["counts"]["B4"], "b7_launches": paged_spec["counts"]["B7"],
        "card": smi,
    }
    del spec_svc, win_svc, smodel, spec_dense, spec_paged, plain_eng
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 10. train: configs/multihost_lm.yml's model through `cli dag`
    phase("train")
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
    phase("train parity")
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
    from torch.profiler import ProfilerActivity

    batch_p = {"x": x_par}
    trainer._train_step(trainer.state, batch_p)
    torch.cuda.synchronize()
    with profiled([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    # and of bf16 torch.matmul (on the normed x for B2), queued CUDA events
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
        with profiled() as prof:
            dense_logits = decode_step(1)
        qmm_counts = (qm.launches, qm.norm_launches)
        dense_attn = (da.launches, da.paged_launches, da.split_launches)
        da.launches = da.paged_launches = da.split_launches = 0
        with profiled() as pprof:
            paged_logits = decode_step(1, paged_kv)
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

    # ---- 11b. train to serve: configs/generate_quant.yml through `cli dag`
    # as published (a train stage, then a generate stage on int8 weights
    # through the int8 matmul and an int8 KV cache), only its model storage
    # moved under a temporary directory; then `serve` on the train task's
    # checkpoint directory against the same weights served from .npz
    phase("train to serve")
    from mlcomp_tpu_torch.io.checkpoint import read_weights
    from mlcomp_tpu_torch.io.weights import save_npz
    from mlcomp_tpu_torch.serve import resolve_storage_ckpt

    with open(Path(__file__).resolve().parent / "configs" / "generate_quant.yml") as f:
        gq_cfg = yaml.safe_load(f)
    tmp_gq = tempfile.mkdtemp(prefix="chip_smoke_gq_")
    for ex in gq_cfg["executors"].values():
        ex["args"]["storage_root"] = f"{tmp_gq}/storage"
    gq_yaml = f"{tmp_gq}/generate_quant.yml"
    with open(gq_yaml, "w") as f:
        yaml.safe_dump(gq_cfg, f)
    for k in kernels.values():
        k.reset()
    t0 = time.perf_counter()
    rc = port_cli.main(["dag", gq_yaml, "--db", f"{tmp_gq}/db.sqlite", "--workdir", tmp_gq,
                        "--device", "cuda"])
    gq_wall = time.perf_counter() - t0
    gq_counts = {key: k.launches for key, k in kernels.items()}
    store = Store(f"{tmp_gq}/db.sqlite")
    try:
        gq_rows = {r["name"]: r for r in store.task_rows(1)}
    finally:
        store.close()
    if rc != 0 or any(r["status"] != "success" for r in gq_rows.values()):
        raise AssertionError("generate_quant.yml: " + json.dumps(
            {n: [r["status"], r["error"]] for n, r in gq_rows.items()}))
    gq_model = gq_cfg["model"]
    gq_train = gq_cfg["executors"]["train"]["args"]
    gq_sample = gq_cfg["executors"]["sample"]["args"]
    tr_steps = gq_train["data"]["train"]["n"] // gq_train["data"]["train"]["batch_size"]
    sm_batches = -(-gq_sample["data"]["infer"]["n"] // gq_sample["data"]["infer"]["batch_size"])
    gq_layers = gq_model["layers"]
    # B5: every train step's forward and every sample batch's prefill; B3:
    # every decode step of every sample batch (max_new_tokens - 1 a batch)
    want_gq = {"B5": gq_layers * (tr_steps + sm_batches),
               "B3": gq_layers * sm_batches * (gq_sample["max_new_tokens"] - 1)}
    if ({k: gq_counts[k] for k in want_gq} != want_gq or gq_counts["B1"] <= 0
            or gq_counts["B2"] <= 0):
        raise AssertionError(f"generate_quant.yml launches {gq_counts}: want {want_gq} and B1, "
                             "B2 on the sample stage")
    import numpy as np_

    gen_ids = np_.load(f"{tmp_gq}/sample_gen.npz")["ids"]
    if gen_ids.shape != (gq_sample["data"]["infer"]["n"], gq_sample["data"]["infer"]["seq_len"]
                         + gq_sample["max_new_tokens"]) or gen_ids.min() < 0 \
            or gen_ids.max() >= gq_model["vocab_size"]:
        raise AssertionError(f"sample stage ids {gen_ids.shape}, range [{gen_ids.min()}, "
                             f"{gen_ids.max()}]")
    os.environ["MLCOMP_TPU_STORAGE"] = f"{tmp_gq}/storage"
    try:
        gq_ckpt = resolve_storage_ckpt("lm", "generate_quant", "train")
    finally:
        del os.environ["MLCOMP_TPU_STORAGE"]
    save_npz(f"{tmp_gq}/weights.npz", read_weights(gq_ckpt)["params"])
    gq_prompts = [torch.randint(1, gq_model["vocab_size"], (n,), generator=cpu_rng).tolist()
                  for n in (20, 60, 100, 128)]
    t2s_ids = {}
    for src, path in (("checkpoint_dir", gq_ckpt), ("npz", f"{tmp_gq}/weights.npz")):
        svc = load_service(gq_model, ckpt_path=path, device="cuda", quantize="kernel",
                           batch_sizes=(1, 4), prompt_buckets=(128,), max_new_buckets=(32,))
        try:
            t2s_ids[src] = [f.result(timeout=300)["ids"]
                            for f in [svc.submit(p, 32) for p in gq_prompts]]
        finally:
            svc.close()
        del svc
    if t2s_ids["checkpoint_dir"] != t2s_ids["npz"]:
        raise AssertionError("serving the train task's checkpoint directory gives other tokens "
                             "than the same weights served from .npz")
    t2s_result = {
        "config": "configs/generate_quant.yml", "moved": "model storage -> a temporary dir",
        "dag_wall_s": gq_wall, "train_steps": tr_steps, "sample_batches": sm_batches,
        # over the DAG: B5 of both stages, the rest the sample stage's
        "launches": {k: gq_counts[k] for k in ("B1", "B2", "B3", "B4", "B5")},
        "sample_ids_shape": list(gen_ids.shape), "checkpoint": gq_ckpt,
        "served_requests": len(gq_prompts), "checkpoint_dir_equal_npz": True, "card": smi,
    }
    log(f"train to serve: generate_quant.yml in {gq_wall:.1f} s, launches "
        f"{json.dumps(t2s_result['launches'])}; serve --storage-task lm/generate_quant/"
        f"train == .npz on {len(gq_prompts)} greedy requests")
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 11c. daemons and report: the same DAG through the supervisor and
    # worker daemons, the report server, then two scheduler-launched replicas
    phase("daemons and report")
    daemons_result = daemons_phase(gq_cfg, {n: r["status"] for n, r in gq_rows.items()},
                                   tr_steps, "cuda", smi)

    # ---- 11d. fleet: `cli fleet --phase-split 1:1` on the serving
    # configuration, the router brokering prefill -> KV pages -> import
    phase("fleet")
    fleet_result = fleet_phase(
        CFG, SEED, hand_prompts, hand_want, lone_prompt, 16, ttft_lone,
        f"--quantize kernel --batch-sizes 1,{BATCH} --prompt-buckets {PROMPT} --max-new-buckets"
        f" {NEW} --prefill-chunk {CHUNK} --kv-page-tokens {page_t} --max-slots {BATCH}",
        "cuda", smi)

    # ---- 11e. model zoo: the five baseline DAGs and ViT-B/16 through `cli dag`
    phase("model zoo")
    gc.collect()
    torch.cuda.empty_cache()
    zoo_result = zoo_phase("cuda", smi, bw, flops)
    zoo_bwd = sum(zoo_result["launches"][n]["bwd_dq_launches"]
                  for n in ("bert_finetune_window", "vit_b16"))

    # ---- 11f. attention dims and dtypes: the flash kernels at head dim 256
    # and on f32 (ROADMAP §C5), their paths, remat and the fused CE head
    phase("attention dims and dtypes")
    gc.collect()
    torch.cuda.empty_cache()
    attn_result = attention_dims_phase("cuda", smi, bw, flops, F32_PEAKS[card])

    # ---- 11g. moe: moe_lm served through int8 expert slices (B1), trained
    phase("moe")
    gc.collect()
    torch.cuda.empty_cache()
    moe_result = moe_phase("cuda", smi, bw, flops)

    # ---- 12. summary
    phase("summary")
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
        "B7": (f"paged spec verify, 8 rows x {SPEC_K + 1} queries through the table: every "
               "layer", [(row_of("B7", f"spec verify {BATCH}x{SPEC_K + 1}"), layers)]),
        "B8": ("bf16-KV paged decode step: K and V of every layer",
               [(kernels["B8"].rows[0], 2 * layers)]),
        "B9": ("BERT finetune backward 32x128, 12 heads of 64, key padding, one call (the JAX "
               "package's rectangular grid: BERT with pad_mode window and ViT train steps)",
               [(row_of("B9", CASE_B), 1)]),
        "B10": ("train step 2x4096: every layer's backward (delta, dq, dk/dv), causal",
                [(row_of("B10", CASE_A), layers)]),
        "B11": ("4x2048 key-padding windows backward, one call (the JAX package's compacted "
                "grid; not on the LM train path)", [(row_of("B11", CASE_D), 1)]),
    }
    # each kernel's launches over its own path's run
    path_counts = {**{key: counts[key] for key in dense_keys},
                   "B6": pcounts["B6"], "B7": paged_spec["counts"]["B7"], "B8": counts16["B8"],
                   **{key: train_counts[key] for key in train_keys}}
    paths = {**{key: "dense engine serve" for key in dense_keys},
             "B6": "paged engine serve", "B7": f"paged spec engine (spec_k {SPEC_K})",
             "B8": "bf16-KV paged engine", **{key: "train (cli dag)" for key in train_keys},
             "B9": "model zoo: BERT (pad_mode window) and ViT-B/16 train steps (cli dag)"}
    path_counts["B9"] = zoo_bwd
    entries = []
    for key, (label, weighted) in scopes.items():
        k = kernels[key]
        entry = {
            "name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "launches": path_counts[key], "path": paths[key],
            "launches_window_path": window_counts[key],
            "launches_prefix_cache_path": {"dense": pc_dense["launches"][key],
                                           "paged": pc_paged["launches"][key]},
            "launches_spec_path": {"dense": dense_spec["counts"][key],
                                   "paged": paged_spec["counts"][key],
                                   "batcher_b1": b1_counts[key]},
            "max_abs_err": max(r["max_abs_err"] for r in k.rows),
            "err_over_limit": max(r["err_over_limit"] for r in k.rows),
            "scope": label, **total(weighted),
        }
        if all("device_ms" in r for r, _ in weighted):
            # device time (queued CUDA events) over the same scope
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
            # the decode path: device time (queued CUDA events) of one decode
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
            entry["launches_zoo_path"] = {n: zoo_result["launches"][n]["B5"]
                                          for n in ("bert_finetune_window", "vit_b16")}
            entry["zoo"] = {k_: v["B5"] for k_, v in zoo_result["flash"].items()}
            entry["train_step"] = {"scope": "train step 2x4096: every layer's forward, causal",
                                   **total([(row_of("B5", TRAIN_B5_CASE), layers)])}
        if key == "B10":
            entry["gqa"] = {"scope": "2x4096, 16 q heads on 4 kv heads, causal, one call",
                            **total([(row_of("B10", CASE_C), 1)])}
        if key == "B9":
            entry["zoo"] = {k_: v["B9"] for k_, v in zoo_result["flash"].items()}
            entry["ragged"] = {"scope": "3x1000, 16 q heads on 8 kv heads, causal, left "
                                        "padding, one call", **total([(row_of("B9", CASE_E), 1)])}
        if key == "B4":
            entry["verify_width"] = {"scope": "8 rows x 32 queries, one call",
                                     **total([(kernels["B4"].rows[1], 1)])}
        if key == "B7":
            entry["admission_shape"] = {"scope": "(1, 256) chunk at cache index 256, one call",
                                        **total([(kernels["B7"].rows[1], 1)])}
            entry["verify_width_32"] = {"scope": "8 rows x 32 queries, one call",
                                        **total([(kernels["B7"].rows[0], 1)])}
        if key in ("B4", "B7"):
            # the speculative verify's widths, one call each
            entry["spec_verify"] = [
                {"scope": f"{r['case']}, one call", **total([(r, 1)]),
                 "device_ms": r["device_ms"], "library_device_ms": r["library_device_ms"]}
                for r in kernels[key].rows if r["case"].startswith("spec verify")]
        if key in ("B3", "B4", "B6", "B7", "B8"):
            # every case, one call each: its body, grid and device time
            entry["cases"] = [
                {f: r[f] for f in ("case", "route", "shares", "cluster", "ctas", "ms", "ms_spread",
                                   "device_ms", "bound_ms", "bound_by", "library_ms",
                                   "library_device_ms", "plain_ms", "err_over_limit") if f in r}
                for r in kernels[key].rows]
        if key == "B1":
            entry["launches_moe_path"] = {
                "serve": moe_result["serve"]["launches"]["B1"],
                "per_decode_step": moe_result["decode"]["b1_launches_per_step"],
                "per_moe_layer_per_decode_step": moe_result["decode"]["b1_per_moe_layer"],
                "path": "moe: moe_lm served through the continuous engine (int8 expert slices)"}
        entries.append(entry)
    # the launches the device profile phase's captures counted (its windows'
    # wrapper counters, each equal to the capture's events of the kernel)
    pcap = devprof_result["captures"]
    cap_launches = {
        "B1": {lay: c["launches"]["quant_matmul"] for lay, c in pcap.items()},
        "B2": {lay: c["launches"]["quant_matmul_norm"] for lay, c in pcap.items()},
        "B3": {"dense": pcap["dense"]["launches"]["decode_attention"]},
        "B6": {"paged": pcap["paged"]["launches"]["paged_decode_attention"]},
        "B5": {"train window": devprof_result["train"]["kernel_events"]["B5"]},
        "B10": {"train window": devprof_result["train"]["kernel_events"]["B10 dq"]}}
    for entry, key in zip(entries, scopes):
        if key in cap_launches:
            entry["launches_device_profile"] = cap_launches[key]
    # a capture's device time per decode step beside the kernel phase's
    # B1 + B2 + B3 of one decode step at 8 rows: two sources (torch.profiler
    # over the served engine; CUDA events around calls queued behind a spin)
    by_key = dict(zip(scopes, entries))
    kernel_step = (by_key["B1"]["decode_step"]["device_ms"]
                   + by_key["B2"]["decode_step"]["device_ms"] + by_key["B3"]["device_ms"])
    log(json.dumps({"device_profile": {
        **devprof_result,
        "dense_device_ms_per_step": pcap["dense"]["device_ms_per_step"],
        "dense_device_time_ms_per_dispatch": pcap["dense"]["device_time_ms_per_dispatch"],
        "kernel_phase_b1_b2_b3_ms_per_step": kernel_step,
        "sources": "the capture: torch.profiler's device lanes over the served engine's "
                   "decode dispatches (every kernel of a step); the kernel phase: CUDA events "
                   "around B1, B2 and B3 calls queued behind a spin, at one decode step's "
                   "shapes (those three kernels only)"}}))
    # the flash kernels' instances at head dim 256 and on f32, each with the
    # launches of the path that runs it (counts set to 0 just before it)
    ap = attn_result["paths"]
    f32_paths = [ap["f32_bert_window"]["launches_one_step"],
                 ap["f32_lm_heads_256"]["launches_one_step"]]
    lm256 = ap["lm_heads_256"]["launches_one_step"]
    path_256 = "attention dims: the 1.2B LM with 8 heads of 256, one train step"
    path_f32 = "attention dims: the f32 BERT-window step and the f32 LM step with heads of 256"
    # the dh-64 instance: every flash call of the zoo's BERT-window and ViT
    # DAGs (counts set to 0 before each DAG, checked there)
    zoo_64 = ("bert_finetune_window", "vit_b16")
    path_64 = "model zoo: the bert_finetune_window and vit_b16 DAGs"
    for key, name, source, launches, path in (
            ("fwd_dh64", "flash_attention_fwd (bf16, head dim 64)",
             "mlcomp_tpu_torch/csrc/flash_attention.cu",
             sum(zoo_result["launches"][n]["fwd_dh64_launches"] for n in zoo_64), path_64),
            ("bwd_dh64", "flash_attention_bwd (bf16, head dim 64)",
             "mlcomp_tpu_torch/csrc/flash_attention_bwd.cu",
             sum(zoo_result["launches"][n]["bwd_dh64_launches"] for n in zoo_64), path_64),
            ("fwd_dh256", "flash_attention_fwd (bf16, head dim 256)",
             "mlcomp_tpu_torch/csrc/flash_attention.cu", lm256["fwd_dh256_launches"], path_256),
            ("bwd_dh256", "flash_attention_bwd (bf16, head dim 256)",
             "mlcomp_tpu_torch/csrc/flash_attention_bwd.cu", lm256["bwd_dh256_launches"],
             path_256),
            ("fwd_f32", "flash_attention_fwd (f32, head dims 64, 128 and 256)",
             "mlcomp_tpu_torch/csrc/flash_attention_f32.cu",
             sum(c["f32_fwd_launches"] for c in f32_paths), path_f32),
            ("bwd_f32", "flash_attention_bwd (f32, head dims 64, 128 and 256)",
             "mlcomp_tpu_torch/csrc/flash_attention_f32.cu",
             sum(c["f32_bwd_launches"] for c in f32_paths), path_f32)):
        rows_ = attn_result["rows"][key]
        head = rows_[0]
        replaces = kernels[GRID_KEYS[head["grid"]] if "grid" in head else "B5"].replaces
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "path": path,
            "max_abs_err": max(r["max_abs_err"] for r in rows_),
            "err_over_limit": max(r["err_over_limit"] for r in rows_),
            "scope": f"{head['case']}, one call",
            **{f: head[f] for f in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                    "bytes", "ops", "device_ms", "library_device_ms")},
            "cases": rows_})
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
    # ---- the phase "parallel" (A12's training half): last, in a process of
    # its own that starts the gang's processes (this one's card memory
    # released first)
    gc.collect()
    torch.cuda.empty_cache()
    # ---- the phase "sharded serving" (A12b): child processes of its own
    phase("sharded serving")
    log(f"sharded serving: this process holds {torch.cuda.memory_allocated() / 1e9:.2f} GB of "
        "the card")
    shard_result = sharded_serving_phase(smi)
    local = shard_result["local_kernel_checks"]
    for entry, key in zip(entries, scopes):
        rows = local.get(key, []) + (local["row_parallel_sum"] if key == "B1" else [])
        if rows:
            # the kernel at the sharded gang's local shapes, against its plain
            # version on the operands the ranks recorded
            entry["sharded_local_shapes"] = {
                "calls_held": len(rows),
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "err_over_limit": max(r["err_over_limit"] for r in rows)}
    phase("parallel")
    log(f"parallel: this process holds {torch.cuda.memory_allocated() / 1e9:.2f} GB of the card")
    par_result = parallel_process(smi)
    phase("summary")
    # the dh-64 instance at configs/longcontext_lm.yml's 1 x 32768 beside the
    # padded route (the parallel phase's unsharded reference step)
    for entry in entries:
        if entry["name"].endswith("(bf16, head dim 64)"):
            entry["longcontext"] = par_result["references"]["longcontext"].get("flash_times")

    log(json.dumps({"disagg": disagg}))
    log(json.dumps({"spec": spec_result}))
    log(json.dumps({"train_to_serve": t2s_result}))
    log(json.dumps({"daemons": daemons_result}))
    log(json.dumps({"fleet": fleet_result}))
    log(json.dumps({"zoo": zoo_result}))
    log(json.dumps({"attention_dims": {k: v for k, v in attn_result.items() if k != "rows"}}))
    log(json.dumps({"moe": moe_result}))
    log(json.dumps({"prefix_cache": {"dense": pc_dense, "paged": pc_paged, "card": smi}}))
    log(json.dumps({"daemon": daemon}))
    log(json.dumps({"train": {**train_result, "parity": {
        "loss_kernels": l_k, "loss_plain": l_p, "grad_norm_kernels": g_k,
        "grad_norm_plain": g_p, "tolerance": "loss 1e-3 relative, gradient norm 2%"},
        "profiled_step": profile_result}}))
    log(json.dumps({"parallel": par_result}))
    log(json.dumps({"sharded_serving": shard_result}))
    log(json.dumps({"kernels": entries, "flash_resources": flash_resources,
                    "profiled_decode_step": {"quant_matmul": step_qmm,
                                             "qmm_reduce_kernel_launches": reduce_launches,
                                             "attention": step_attn},
                    "quant_matmul_resources": qmm_resources,
                    "decode_attention_resources": da_resources}))
    wall_line(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        # a failed run prints no result: the phases' seconds go to stderr
        phase(None)
        print(json.dumps({"wall_before_failure": {"script_s": time.perf_counter() - T_START,
                                                  "phase_s": PHASE_S}}),
              file=sys.stderr, flush=True)
        raise
