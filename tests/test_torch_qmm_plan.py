"""The int8 matmul's tiled path (more than 64 rows): the grid planner in
mlcomp_tpu_torch/ops/cuda/quant_matmul.py, the split-and-reduce order it
implies, and the int8 -> bf16 conversion the kernel does in shared memory.

The wgmma kernel itself runs only on the card (chip_smoke.py holds it
against quant_matmul_plain at these shapes, bit-equal on a rerun); here
its arithmetic is replayed in numpy/PyTorch on the CPU.
"""

import numpy as np
import pytest
import torch

from mlcomp_tpu_torch.ops.cuda import build
from mlcomp_tpu_torch.ops.cuda import quant_matmul as qm

# the 1.2B transformer_lm's projections (hidden 2048, mlp 8192): fused
# qkv, fused gate_up, down, out
MAIN_SHAPES = {"qkv": (2048, 6144), "gate_up": (2048, 16384), "down": (8192, 2048),
               "out": (2048, 2048)}
# an admission chunk, the 8 x 512 prefill, and ragged counts
MAIN_ROWS = (256, 4096, 65, 130, 200, 300)


def _valid_splits(d):
    steps = d // qm.GEMM_BK
    return [s for s in range(1, steps + 1)
            if steps % s == 0 and steps // s >= qm.MIN_SLICE_STEPS]


def _check_plan(rows, d, n):
    p = qm.plan(rows, d, n)
    assert p["tiles"] == -(-rows // qm.GEMM_BM) * (n // qm.GEMM_BN)
    assert p["ctas"] == p["tiles"] * p["splits"]
    # every slice is a whole number of 64-deep steps and they cover D
    assert p["splits"] in _valid_splits(d)
    assert p["d_chunk"] * p["splits"] == d
    assert p["d_chunk"] % qm.GEMM_BK == 0
    assert p["steps"] * qm.GEMM_BK == p["d_chunk"]
    # the slicing reads (D, N) alone: one wave that covers the work of a
    # SPLIT_ROWS-row call (the admission chunk), every CTA on an SM of its
    # own, and the most slices that keep it so
    ref_tiles = -(-qm.SPLIT_ROWS // qm.GEMM_BM) * (n // qm.GEMM_BN)
    if ref_tiles >= qm.SMS:
        assert p["splits"] == 1
    else:
        assert ref_tiles * p["splits"] <= qm.SMS
        assert all(ref_tiles * s > qm.SMS for s in _valid_splits(d) if s > p["splits"])
    return p


@pytest.mark.parametrize("rows", MAIN_ROWS)
@pytest.mark.parametrize("shape", sorted(MAIN_SHAPES))
def test_plan_covers_the_card_at_main_path_shapes(shape, rows):
    d, n = MAIN_SHAPES[shape]
    p = _check_plan(rows, d, n)
    # every main-path shape keeps at least 96 of the 132 SMs busy from two
    # row tiles on (the admission chunk, the prefill); one row tile (65-128
    # rows) at least 48
    assert p["ctas"] >= (96 if rows > qm.GEMM_BM else 48)


@pytest.mark.parametrize("shape", sorted(MAIN_SHAPES))
def test_every_row_count_slices_d_alike(shape):
    """A row's f32 sums do not depend on how many rows the call holds: the
    same D slices (count, width) at M = 65, 256, 512, 1024 and 4096, so a
    lone 512-row prefill and the same rows inside an 8 x 512 one sum in
    one order (the card holds 512 rows inside 4096 bit for bit)."""
    d, n = MAIN_SHAPES[shape]
    plans = [qm.plan(m, d, n) for m in (65, 256, 512, 1024, 4096)]
    assert len({(p["splits"], p["d_chunk"], p["steps"]) for p in plans}) == 1
    for m in (66, 127, 129, 300, 2000, 8192):
        assert qm.plan(m, d, n)["d_chunk"] == plans[0]["d_chunk"]


def test_plan_at_the_admission_chunk_and_the_prefill():
    # 256 rows: qkv makes 96 tiles and gate_up 256 (no split); out and down
    # 32, split in four (128 CTAs)
    assert {k: qm.plan(256, *v)["splits"] for k, v in MAIN_SHAPES.items()} == {
        "qkv": 1, "gate_up": 1, "down": 4, "out": 4}
    # 8 x 512 rows: at least 512 tiles everywhere, and the chunk's slices
    for k, v in MAIN_SHAPES.items():
        p = qm.plan(4096, *v)
        assert p["tiles"] >= 512 and p["splits"] == qm.plan(256, *v)["splits"], k


def test_plan_refuses_nothing_the_wrapper_accepts():
    """Every (rows > 64, D and N multiples of 128) gets a valid grid."""
    for rows in (65, 66, 127, 128, 129, 200, 300, 1000, 4096, 8192):
        for d in (128, 256, 384, 640, 2048, 8192):
            for n in (128, 384, 2048, 16384):
                _check_plan(rows, d, n)


def _bf16(a):
    return torch.from_numpy(a).bfloat16()


@pytest.mark.parametrize("rows,d,n", [(65, 256, 384), (200, 512, 256), (130, 2048, 128),
                                      (256, 2048, 2048)])
def test_split_slices_summed_in_order_match_the_plain_version(rows, d, n):
    """The split path's arithmetic: each slice's f32 sum, the slices added
    in order (qmm_reduce_kernel), the scale once, one bf16 rounding."""
    rng = np.random.default_rng(rows + d + n)
    x = _bf16(rng.normal(size=(rows, d)).astype(np.float32))
    q8 = torch.from_numpy(rng.integers(-127, 128, size=(d, n)).astype(np.int8))
    sc = torch.from_numpy((rng.random(n) * 0.02).astype(np.float32))
    p = qm.plan(rows, d, n)
    assert p["splits"] > 1
    total = torch.zeros(rows, n)
    for s in range(p["splits"]):
        sl = slice(s * p["d_chunk"], (s + 1) * p["d_chunk"])
        total = total + x[:, sl].float() @ q8[sl].float()
    got = (total * sc).bfloat16().float()
    ref = qm.quant_matmul(x, q8, sc).float()        # the plain version on the CPU
    # chip_smoke.py's criterion: both round to bf16 (one step, 2^-8 |ref|
    # at most) after f32 sums in another order (~2^-20 of the sum of the
    # absolute terms, ref_abs)
    ref_abs = qm.quant_matmul(x.abs(), q8.abs(), sc).float()
    assert bool(((got - ref).abs() <= 2 ** -7 * (ref.abs() + ref_abs)).all())


def _bf16x2_of_int8(word, sel):
    """numpy replay of wgmma.cuh's bf16x2_of_int8 on uint32 words."""
    def byte(i):
        return (word >> (8 * i)) & 0xFF if i < 4 else np.uint32(0x43)
    s = np.zeros_like(word)
    for k in range(4):
        s |= byte((sel >> (4 * k)) & 0xF) << (8 * k)
    mag = s & 0xFF7FFF7F
    off = (s & 0x00800080) | 0xC300C300
    halves = []
    for h in (0, 16):
        a = ((mag >> h) & 0xFFFF).astype(np.uint32) << 16
        b = ((off >> h) & 0xFFFF).astype(np.uint32) << 16
        halves.append(a.view(np.float32) + b.view(np.float32))   # exact in f32
    return halves


def test_int8_to_bf16_conversion_is_exact_for_every_byte():
    v = np.arange(-128, 128, dtype=np.int32).astype(np.int8)
    words = v.view(np.uint8).reshape(-1, 4).copy().view(np.uint32).reshape(-1)
    lo01, hi01 = _bf16x2_of_int8(words, 0x4140)
    lo23, hi23 = _bf16x2_of_int8(words, 0x4342)
    got = np.stack([lo01, hi01, lo23, hi23], 1).reshape(-1)
    np.testing.assert_array_equal(got, v.astype(np.float32))
    # each sum is an integer in [-128, 127]: bf16 (8 significant bits) holds it
    assert np.all(np.abs(got) <= 128)


def test_the_tiled_path_is_the_wgmma_kernel():
    src = (build.CSRC_DIR / "quant_matmul.cu").read_text()
    assert "qmm_wgmma_kernel" in src and "wgmma_ss_n128" in src
    assert "qmm_gemm_kernel" not in src and "wmma::" not in src and "<mma.h>" not in src
