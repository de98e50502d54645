"""The int8 matmul's decode path (64 rows or fewer, with and without the
RMSNorm prologue): the grid planner in mlcomp_tpu_torch/ops/cuda/
quant_matmul.py and the order of sums the tensor-core kernel
(csrc/quant_matmul.cu, qmm_gemv_tc_kernel) keeps.

The kernel runs only on the card (chip_smoke.py holds it against
quant_matmul_plain at these shapes, bit-equal on a rerun); here its plan
and its arithmetic are replayed on the CPU.
"""

import re

import numpy as np
import pytest
import torch

from mlcomp_tpu_torch.ops.cuda import build
from mlcomp_tpu_torch.ops.cuda import quant_matmul as qm

# the 1.2B transformer_lm's decode projections (hidden 2048, mlp 8192,
# vocab 32768): fused qkv and gate_up and the lm_head (norm prologue), out
# and down (no norm)
MAIN_SHAPES = {"qkv": (2048, 6144), "gate_up": (2048, 16384), "out": (2048, 2048),
               "down": (8192, 2048), "lm_head": (2048, 32768)}
ROWS = (1, 3, 8, 13, 32, 57, 64)


def _valid_clusters(d, n):
    steps = d // qm.GEMV_KS
    return [c for c in qm.GEMV_CLUSTERS
            if steps % c == 0 and (n // qm.GEMV_BN) * c <= 2 * qm.SMS]


def _check_gemv_plan(rows, d, n):
    p = qm.gemv_plan(rows, d, n)
    assert p["tiles"] == n // qm.GEMV_BN
    assert p["ctas"] == p["tiles"] * p["cluster"]
    # the slices cover D in whole 128-deep steps
    assert p["d_chunk"] * p["cluster"] == d
    assert p["d_chunk"] % qm.GEMV_KS == 0
    assert p["steps"] * qm.GEMV_KS == p["d_chunk"]
    # the cluster is a portable size (at most 8) that divides the step count
    assert p["cluster"] in qm.GEMV_CLUSTERS and max(qm.GEMV_CLUSTERS) <= 8
    assert (d // qm.GEMV_KS) % p["cluster"] == 0
    # the padded rows are a valid product width: whole 8-column mma tiles,
    # the narrowest of the kernel's row tiles that holds every row
    assert p["rows_padded"] in qm.GEMV_ROW_TILES and p["rows_padded"] % 8 == 0
    assert p["rows_padded"] >= rows
    assert all(t < rows for t in qm.GEMV_ROW_TILES if t < p["rows_padded"])
    if p["tiles"] >= qm.SMS:
        # the tiles alone fill the card: no split
        assert p["cluster"] == 1
    else:
        # one wave of two CTAs an SM, and the largest cluster that keeps it
        assert p["ctas"] <= 2 * qm.SMS
        assert p["cluster"] == max(_valid_clusters(d, n))
    return p


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("shape", sorted(MAIN_SHAPES))
def test_gemv_plan_at_main_path_shapes(shape, rows):
    d, n = MAIN_SHAPES[shape]
    p = _check_gemv_plan(rows, d, n)
    # every main-path shape keeps at least 128 CTAs in its one wave
    assert p["ctas"] >= 128


def test_gemv_plan_at_the_decode_step():
    """8 rows: qkv's 48 tiles split in four, gate_up's 128 in two, the
    2048-wide out and down in eight (a full cluster), the lm_head's 256
    tiles not at all; the grid does not depend on the row count."""
    got = {k: qm.gemv_plan(8, *v)["cluster"] for k, v in MAIN_SHAPES.items()}
    assert got == {"qkv": 4, "gate_up": 2, "out": 8, "down": 8, "lm_head": 1}
    for rows in ROWS:
        assert {k: qm.gemv_plan(rows, *v)["cluster"] for k, v in MAIN_SHAPES.items()} == got


def test_gemv_plan_refuses_nothing_the_wrapper_accepts():
    """Every (rows <= 64, D and N multiples of 128) gets a valid grid."""
    for rows in (1, 2, 7, 8, 9, 16, 17, 31, 33, 63, 64):
        for d in (128, 256, 384, 640, 2048, 8192):
            for n in (128, 384, 2048, 16384, 32768):
                _check_gemv_plan(rows, d, n)


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16()


def _warps_along_depth(rows_padded):
    """The kernel's Gemv<RT>::WK: warps that split each 128-deep step."""
    return {8: 8, 16: 8, 32: 4, 64: 2}[rows_padded]


def _replay(x, q8, sc, g=None, eps=1e-6):
    """The decode kernel's arithmetic in PyTorch, in its order.  With the
    norm: each row's f32 sum of squares over the full row, inv = 1 /
    sqrt(mean + eps), x normed as bf16((x * inv) * g).  Then, per cluster
    rank p (its D slice), per warp wk along the depth, the f32 sum of its
    share of every step (the tensor cores' order inside a share is the
    hardware's); the warps' partials added in order wk = 0, 1, ...; the
    ranks' slices added in rank order; the scale once; bf16."""
    rows, d = x.shape
    n = q8.shape[1]
    p = qm.gemv_plan(rows, d, n)
    if g is not None:
        x32 = x.float()
        inv = 1.0 / torch.sqrt((x32 * x32).sum(-1, keepdim=True) / d + eps)
        xb = ((x32 * inv) * g).bfloat16().float()
    else:
        xb = x.float()
    wk_n = _warps_along_depth(p["rows_padded"])
    kw = qm.GEMV_KS // wk_n
    total = None
    for rank in range(p["cluster"]):
        parts = []
        for wk in range(wk_n):
            acc = torch.zeros(rows, n)
            for t in range(p["steps"]):
                k0 = rank * p["d_chunk"] + t * qm.GEMV_KS + wk * kw
                acc = acc + xb[:, k0:k0 + kw] @ q8[k0:k0 + kw].float()
            parts.append(acc)
        cta = parts[0]
        for part in parts[1:]:
            cta = cta + part
        total = cta if total is None else total + cta
    return (total * sc).bfloat16()


@pytest.mark.parametrize("rows,d,n,norm", [
    (8, 2048, 2048, False),     # out: a cluster of 8, two steps a CTA
    (8, 1024, 512, True),       # the norm prologue, a cluster of 8
    (3, 2048, 256, True),       # ragged rows in one 8-row tile
    (13, 512, 384, False),      # two row tiles
    (32, 1024, 256, True),      # four row tiles: four warps along the depth
    (57, 640, 128, False),      # eight row tiles, five steps (no split)
    (64, 2048, 128, "f32"),     # the norm prologue on an f32 model's x
])
def test_replay_of_the_kernel_order_matches_the_plain_version(rows, d, n, norm):
    rng = np.random.default_rng(rows * 31 + d + n)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    x = torch.from_numpy(x) if norm == "f32" else _bf16(x)
    q8 = torch.from_numpy(rng.integers(-127, 128, size=(d, n)).astype(np.int8))
    sc = torch.from_numpy((rng.random(n) * 0.02).astype(np.float32))
    g = torch.from_numpy((rng.random(d) + 0.5).astype(np.float32)) if norm else None
    got = _replay(x, q8, sc, g).float()
    ref = qm.quant_matmul(x, q8, sc, norm_scale=g).float()   # the plain version
    # chip_smoke.py's criterion: both round the output to bf16 (2^-8 |ref|);
    # the normed x can land on neighbouring bf16 values (2^-8 of a term, so
    # 2^-8 ref_abs); f32 sums in another order add ~2^-20 ref_abs
    ref_abs = qm.quant_matmul(x.abs(), q8.abs(), sc, norm_scale=g).float()
    assert bool(((got - ref).abs() <= 2 ** -7 * (ref.abs() + ref_abs)).all())


def test_replay_is_what_a_rerun_gives():
    """The kernel's sums run in one fixed order (no atomics): the replay
    of the same inputs gives the same bits twice, and the plan is the same
    object for the same shape."""
    rng = np.random.default_rng(5)
    x = _bf16(rng.normal(size=(8, 2048)).astype(np.float32))
    q8 = torch.from_numpy(rng.integers(-127, 128, size=(2048, 2048)).astype(np.int8))
    sc = torch.from_numpy((rng.random(2048) * 0.02).astype(np.float32))
    assert torch.equal(_replay(x, q8, sc), _replay(x, q8, sc))
    assert qm.gemv_plan(8, 2048, 2048) is qm.gemv_plan(8, 2048, 2048)


def _source():
    return (build.CSRC_DIR / "quant_matmul.cu").read_text()


def _body(src, signature):
    """The text of the C function that starts at ``signature``."""
    start = src.index(signature)
    depth, i = 0, src.index("{", start)
    while True:
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        i += 1
        if depth == 0:
            return src[start:i]


def test_the_decode_path_is_the_tensor_core_kernel():
    src = _source()
    # the CUDA-core GEMV (one f32 FMA per weight byte per row) is gone
    assert "qmm_gemv_kernel<" not in src and "fmaf(xv, qf" not in src
    assert "qmm_gemv_smem_bytes" not in src
    # qmm_launch sends 64 rows or fewer to the tensor-core kernel, one
    # launch, and never to the split pass, which the tiled path alone keeps
    launch = _body(src, "int qmm_launch(")
    gemv, tiled = launch.split("if (rows <= MAX_GEMV_ROWS) {", 1)[1].split(
        "\n  }\n", 1)
    assert "launch_gemv_rows<" in gemv and "return" in gemv
    assert "qmm_reduce_kernel" not in gemv and "qmm_reduce_kernel<<<" in tiled
    kernel = _body(src, "qmm_gemv_tc_kernel(")
    assert "mma_16816(" in kernel and "bf16x2_of_int8(" in kernel
    # the cluster's slices meet in distributed shared memory: no partial
    # sums in device memory, no atomics
    params = kernel[:kernel.index(") {")]
    assert "ld_cluster_f4(" in kernel and "cluster_sync()" in kernel
    assert "atomic" not in kernel and "partial" not in params
    # the launcher runs it as clusters along D
    assert "cudaLaunchAttributeClusterDimension" in _body(src, "cudaError_t launch_gemv(")


def test_shared_memory_attributes_are_set_once():
    """cudaFuncSetAttribute is host work: qmm_launch asks for it through
    allow_smem_once (once per kernel and device), never on every call."""
    src = _source()
    launch = _body(src, "int qmm_launch(")
    assert "cudaFuncSetAttribute" not in launch
    assert "allow_smem_once(" in launch
    assert "allow_smem_once(" in _body(src, "cudaError_t launch_gemv(")
    once = _body(src, "cudaError_t allow_smem_once(")
    assert "cudaFuncSetAttribute" in once and "done.load" in once


def test_the_wrapper_allocates_no_partial_sums_at_decode():
    src = (build.PKG_DIR / "ops" / "cuda" / "quant_matmul.py").read_text()
    body = src[src.index("def quant_matmul("):]
    gemv = body.split("if r <= GEMV_ROWS:", 1)[1].split("else:", 1)[0]
    assert "gemv_plan(" in gemv and "torch.empty" not in gemv
    assert not re.search(r"_splits\(r, d, n\) if r <= GEMV_ROWS", body)
