"""What a tp 2 serving rank computes, on a gloo gang of two processes
(``tests/torch_gang.py``), against the JAX package's kernels in interpret
mode on the whole operands.

A rank loads its serving shards (``parallel/sharding.serving_shards``, the
leaves quantized whole first) and ``set_serving_tp`` gives each int8
projection its role from ``TP_RULES``.  A column-parallel projection's
outputs, gathered over the ranks, are the whole product's columns; a
row-parallel one's partial products (each a bf16 kernel output) add over
tp in f32 and round once, as the JAX package's ``sharded_quant_matmul``
island computes them (held here by summing the JAX kernel's per-shard
outputs in f32).  Decode attention runs on the rank's own heads of its
cache and does no cross-rank math.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlcomp_tpu.ops.pallas import decode_attention as jda
from mlcomp_tpu.ops.pallas.quant_matmul import quant_matmul as j_qmm
from mlcomp_tpu.ops.quant import quantize_params as j_quantize_params
from mlcomp_tpu_torch.io.weights import flatten, init_params
from torch_gang import result, run_gang

torch.set_num_threads(1)

WORLD = 2
ROWS = 4
# the JAX quantized serving test's widths: every tp-sharded dim stays
# lane-tileable a rank (heads * dh 256 -> 128, mlp 512 -> 256, vocab 256 -> 128)
SHARD_CFG = {"name": "transformer_lm", "vocab_size": 256, "hidden": 256, "layers": 2,
             "heads": 4, "mlp_dim": 512, "dtype": "float32", "kv_quant": True}
# decode attention at the kernel's head width (128): 4 query heads on 4 KV
# heads, and on 2 (GQA groups of 2, one KV head a rank)
DECODE_CFGS = {name: {"name": "transformer_lm", "vocab_size": 256, "hidden": 512, "layers": 1,
                      "heads": 4, "kv_heads": kv, "mlp_dim": 512, "dtype": "float32",
                      "kv_quant": True} for name, kv in (("mha", 4), ("gqa", 2))}
# the refusals: gate/up 128 wide cut to 64-wide int8 shards; 3 heads over tp 2
TILE_CFG = {**SHARD_CFG, "hidden": 256, "heads": 2, "mlp_dim": 128}
HEADS_CFG = {**SHARD_CFG, "hidden": 384, "heads": 3}
PATHS = {"q": "DecoderLayer_0/attn/q/kernel", "v": "DecoderLayer_0/attn/v/kernel",
         "out": "DecoderLayer_0/attn/out/kernel", "gate": "DecoderLayer_0/gate/kernel",
         "down": "DecoderLayer_0/down/kernel", "lm_head": "lm_head/kernel"}


def _bf16_np(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _x():
    return _bf16_np(np.random.default_rng(3).normal(size=(ROWS, 512)).astype(np.float32))


def _decode_inputs(h_kv):
    rng = np.random.default_rng(5)
    b, h, l_buf, dh = 4, 4, 256, 128

    def cache():
        k = rng.normal(size=(b, l_buf, h_kv, dh)).astype(np.float32)
        q8, s = jda.quantize_kv(jnp.asarray(k))
        return (np.asarray(q8.transpose(0, 2, 1, 3)),
                np.asarray(s.transpose(0, 2, 1)[:, :, None].astype(jnp.bfloat16)
                           .astype(jnp.float32)))

    k8, ks = cache()
    v8, vs = cache()
    q = _bf16_np(rng.normal(size=(b, h, dh)).astype(np.float32))
    # ragged windows: the whole buffer, one slot, an EMPTY window, a mid window
    start = np.array([0, 17, 40, 100], np.int32)
    stop = np.array([256, 18, 40, 230], np.int32)
    return q, k8, ks, v8, vs, start, stop


@pytest.fixture(scope="module")
def gang():
    params = init_params(SHARD_CFG, 0)
    cases = [("linears", "serving_linears", dict(cfg=SHARD_CFG, params=params, x=_x())),
             ("errors", "serving_errors", dict(
                 tile_cfg=TILE_CFG, tile_params=init_params(TILE_CFG, 0),
                 heads_cfg=HEADS_CFG, heads_params=init_params(HEADS_CFG, 0)))]
    for name, cfg in DECODE_CFGS.items():
        q, k8, ks, v8, vs, start, stop = _decode_inputs(cfg["kv_heads"])
        cases.append((f"decode/{name}", "local_decode", dict(
            cfg=cfg, q=q, k8=k8, ks=ks, v8=v8, vs=vs, start=start, stop=stop)))
    for quantize in (True, False):
        cases.append((f"shards/{quantize}", "serving_shards", dict(
            cfg=SHARD_CFG, params=params, axes={"dp": 1, "tp": 2}, quantize=quantize)))
    return run_gang(WORLD, cases)


def _whole(path):
    """The JAX package's whole int8 leaf at ``path`` as the kernel's (m, n)
    operand and (n,) scale."""
    flat = flatten(j_quantize_params(_to_jnp(init_params(SHARD_CFG, 0))))
    q8 = np.asarray(flat[f"{path}/q8"])
    n = int(np.asarray(flat[f"{path}/q8_scale"]).size)
    return q8.reshape(-1, n), np.asarray(flat[f"{path}/q8_scale"]).reshape(n)


def _ranks(gang, case, name):
    got = sorted((result(gang, r, case) for r in range(WORLD)), key=lambda g: g["tp"])
    return [g[name] for g in got]


@pytest.mark.parametrize("name", ["q", "v", "gate", "lm_head"])
def test_column_parallel_int8_linear_equals_the_whole_kernel(gang, name):
    """A column-parallel projection (B1 on the rank's (m, n/tp) shard of
    the whole-quantized weight): the ranks' outputs, concatenated, are the
    JAX kernel's product on the whole weight, each column the same sums
    (within 1e-5 relative, as f32 values of the bf16 outputs)."""
    parts = _ranks(gang, "linears", name)
    assert not any(p["row_parallel"] for p in parts)
    q8, sc = _whole(PATHS[name])
    x = _x()[:, : q8.shape[0]]
    got = np.concatenate([p["y"] for p in parts], 1)
    ref = np.asarray(j_qmm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(q8),
                           jnp.asarray(sc)).astype(jnp.float32))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["q", "gate"])
def test_column_parallel_norm_fold_equals_the_whole_kernel(gang, name):
    """The same projections with their RMSNorm folded into the kernel's
    prologue (B2, as a decode step runs them): the gathered outputs are the
    JAX kernel's normed product on the whole weight within 1e-5 relative."""
    parts = _ranks(gang, "linears", f"{name}+norm")
    np.testing.assert_array_equal(parts[0]["norm_scale"], parts[1]["norm_scale"])
    q8, sc = _whole(PATHS[name])
    got = np.concatenate([p["y"] for p in parts], 1)
    ref = np.asarray(j_qmm(jnp.asarray(_x()[:, : q8.shape[0]], jnp.bfloat16), jnp.asarray(q8),
                           jnp.asarray(sc), norm_scale=jnp.asarray(parts[0]["norm_scale"]))
                     .astype(jnp.float32))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["out", "down"])
def test_row_parallel_int8_linear_sums_partials_in_f32(gang, name):
    """A row-parallel projection (B1 on the rank's (m/tp, n) shard, the
    per-column scale whole): every rank holds the same sum, which equals
    the JAX island's arithmetic, the JAX kernel on each contraction shard
    summed in f32 and rounded once to bf16 (within 1e-5 relative), and the
    whole-weight product within the two roundings: each partial's (half a
    bf16 step of the partial) and the sum's (half a step of the sum),
    bounded here by one step, 2^-8, of the partials' magnitudes plus the
    product's."""
    ranks = _ranks(gang, "linears", name)
    assert all(p["row_parallel"] for p in ranks)
    np.testing.assert_array_equal(ranks[0]["y"], ranks[1]["y"])
    got = ranks[0]["y"]
    q8, sc = _whole(PATHS[name])
    w = ranks[0]["m"]
    assert w * WORLD == q8.shape[0]
    x = _x()[:, : q8.shape[0]]
    parts = [j_qmm(jnp.asarray(x[:, i * w:(i + 1) * w], jnp.bfloat16),
                   jnp.asarray(q8[i * w:(i + 1) * w]), jnp.asarray(sc)).astype(jnp.float32)
             for i in range(WORLD)]
    island = np.asarray(sum(parts).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_allclose(got, island, rtol=1e-5, atol=1e-6)
    whole = np.asarray(j_qmm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(q8),
                             jnp.asarray(sc)).astype(jnp.float32))
    bound = 2.0 ** -8 * (sum(np.abs(np.asarray(p)) for p in parts) + np.abs(whole))
    assert np.all(np.abs(got - whole) <= bound), np.max(np.abs(got - whole) - bound)


@pytest.mark.parametrize("name", sorted(DECODE_CFGS))
def test_local_head_decode_equals_the_whole_kernel(gang, name):
    """Each rank's cache holds kv_heads / tp heads, and decode attention on
    the rank's query heads, gathered over the ranks, equals JAX
    ``decode_attention`` on the whole q and cache within 1e-5 (f32 sums in
    another order; both round p * vs to bf16 at the same points), an empty
    window giving zeros."""
    cfg = DECODE_CFGS[name]
    q, k8, ks, v8, vs, start, stop = _decode_inputs(cfg["kv_heads"])
    ranks = sorted((result(gang, r, f"decode/{name}") for r in range(WORLD)),
                   key=lambda g: g["tp"])
    assert [g["cache_heads"] for g in ranks] == [cfg["kv_heads"] // WORLD] * WORLD
    got = np.concatenate([g["out"] for g in ranks], 1)
    ref = np.asarray(jda.decode_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k8), jnp.asarray(ks, jnp.bfloat16),
        jnp.asarray(v8), jnp.asarray(vs, jnp.bfloat16), kv_start=jnp.asarray(start),
        kv_stop=jnp.asarray(stop), scale=0.1).astype(jnp.float32))
    assert np.all(got[2] == 0) and np.all(ref[2] == 0)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_serving_under_tp_raises_the_jax_errors(gang):
    for r in range(WORLD):
        got = result(gang, r, "errors")
        assert "must split into lane-tileable 64-wide shards" in got["qmm"]
        assert "int8 kernel under tp=2" in got["qmm"]
        assert "must divide both heads (3)" in got["decode"]
        assert "so GQA groups stay device-local" in got["decode"]


def _to_jnp(tree):
    return {k: _to_jnp(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def _split_dim(key, shape):
    from mlcomp_tpu_torch.parallel.sharding import spec_for

    spec = spec_for(key, shape, {"tp": 2})
    return spec.index("tp") if "tp" in spec else None


@pytest.mark.parametrize("quantize", [True, False])
def test_rank_shards_concatenate_to_the_jax_leaves(gang, quantize):
    """Each rank's serving shards, concatenated over the ranks, are the JAX
    package's whole leaves exactly: int8 codes and scales quantized whole
    (a row-parallel cut keeps the per-column scale whole, a column-parallel
    one cuts it), float leaves as they are; leaves outside the tp layout
    come whole to every rank."""
    params = init_params(SHARD_CFG, 0)
    want = flatten(j_quantize_params(_to_jnp(params)) if quantize else params)
    ranks = [result(gang, r, f"shards/{quantize}") for r in range(WORLD)]
    ranks.sort(key=lambda got: got["tp"])
    leaves = [got["leaves"] for got in ranks]
    assert set(leaves[0]) == set(want)
    cut = 0
    for key, ref in want.items():
        ref = np.asarray(ref)
        parts = [lv[key] for lv in leaves]
        q_key = key.rsplit("/", 1)[0] + "/q8" if key.endswith("/q8_scale") else key
        d = _split_dim(q_key.replace("/q8", ""), np.asarray(want[q_key]).shape) \
            if quantize else _split_dim(key, ref.shape)
        if d is None or parts[0].shape == ref.shape:
            for p in parts:
                np.testing.assert_array_equal(p, ref, err_msg=key)
            continue
        cut += 1
        np.testing.assert_array_equal(np.concatenate(parts, d), ref, err_msg=key)
    # q/k/v/out, gate/up/down in two layers, the embedding and the head
    assert cut >= 14
