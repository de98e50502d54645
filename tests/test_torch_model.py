"""The port's transformer_lm and generate against the JAX package's, on the
CPU at a tiny width (hidden 128, 2 layers, 4 heads, 2 KV heads, vocab
256), fed the same numpy weights (``io.weights.init_params``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlcomp_tpu.models import create_model as j_create
from mlcomp_tpu.models.generation import generate as j_generate
from mlcomp_tpu.models.generation import init_cache as j_init_cache
from mlcomp_tpu.models.generation import process_logits as j_process
from mlcomp_tpu.models.generation import process_logits_rowwise as j_process_rowwise
from mlcomp_tpu.models.transformer import fuse_decode_params as j_fuse
from mlcomp_tpu.ops.quant import quantize_params as j_quantize
from mlcomp_tpu_torch.io.weights import from_flax_params, init_params, load_npz, save_npz
from mlcomp_tpu_torch.models import create_model
from mlcomp_tpu_torch.models.generation import (
    generate,
    prep_decode_variables,
    process_logits,
    process_logits_rowwise,
    sample_token_rowwise,
)
from mlcomp_tpu_torch.models.transformer import fuse_decode_params
from mlcomp_tpu_torch.ops.quant import Int8Linear, quantize_params

torch.set_num_threads(1)

CFG = dict(vocab_size=256, hidden=128, layers=2, heads=4, kv_heads=2)
TREE = init_params(CFG, seed=0)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _port(extra, tree=TREE, **prep):
    cfg = {"name": "transformer_lm", **CFG, **extra}
    if cfg.get("decode_fused"):
        tree = fuse_decode_params(tree)
    return prep_decode_variables(create_model(cfg, device="cpu"), tree, **prep)


def _jax(extra, tree=TREE):
    m = j_create({"name": "transformer_lm", **CFG, **extra})
    t = _jnp(tree)
    return m, (j_fuse(t) if extra.get("decode_fused") else t)


@pytest.mark.parametrize("fused", [False, True])
def test_forward_logits_match_flax(fused):
    extra = {"dtype": "float32", "decode_fused": fused}
    jm, jt = _jax(extra)
    ids = np.random.default_rng(1).integers(0, 256, (2, 24))
    ref = np.asarray(jm.apply({"params": jt}, jnp.asarray(ids)))
    out = _port(extra)(torch.from_numpy(ids))
    assert out.dtype == torch.float32 and out.shape == (2, 24, 256)
    # f32 fixtures: the same math in another library, f32 rounding only
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("extra,quant", [
    ({}, False),
    ({"kv_quant": True}, False),
    ({"kv_quant": True, "decode_fused": True}, True),
])
def test_decode_step_logits_match_flax(extra, quant):
    """Prefill of a left-padded ragged batch, then one decode step, against
    model.apply with the flax cache: the dense and the int8 cache, and the
    all-int8 path (int8 weights through the kernel, norms folded)."""
    extra = {"dtype": "float32", **extra}
    jm, jt = _jax(extra)
    if quant:
        jt = j_quantize(jt)
    rng = np.random.default_rng(2)
    b, s = 2, 10
    prompt = rng.integers(1, 256, (b, s))
    pm = np.ones((b, s), bool)
    pm[0, :4] = False
    pos = np.maximum(np.cumsum(pm, 1) - 1, 0)
    kv_mask = np.concatenate([pm, np.ones((b, 4), bool)], 1)
    from mlcomp_tpu.models.generation import prep_decode_variables as j_prep

    jv, apply = j_prep(jm, {"params": jt}, quant, None)
    # one compiled program per shape: eager flax would compile every op
    run = jax.jit(lambda v, ids, p, m: apply(v, ids, decode=True, positions=p, kv_mask=m,
                                             mutable=["cache"]))
    cache = j_init_cache(jm, b, s + 4)
    jl, upd = run({**jv, "cache": cache}, jnp.asarray(prompt), jnp.asarray(pos),
                  jnp.asarray(kv_mask))
    tok = np.array(jnp.argmax(jl[:, -1], -1))
    jstep, _ = run({**jv, "cache": upd["cache"]}, jnp.asarray(tok[:, None]),
                   jnp.asarray(pos[:, -1:] + 1), jnp.asarray(kv_mask))

    tree = quantize_params(TREE) if quant else TREE
    pmodel = _port(extra, tree, quant_kernel=quant)
    cache_t = pmodel.init_cache(b, s + 4)
    km = torch.from_numpy(kv_mask)
    pl = pmodel(torch.from_numpy(prompt), positions=torch.from_numpy(pos), cache=cache_t,
                kv_mask=km)
    pstep = pmodel(torch.from_numpy(tok[:, None]), positions=torch.from_numpy(pos[:, -1:] + 1),
                   cache=cache_t, kv_mask=km)
    assert cache_t.index == s + 1
    # prefill logits at real positions (pad query rows are discarded by
    # contract: the kernel semantics give them 0, the XLA path an average)
    jl = np.asarray(jl)
    # f32 model; the int8 path rounds activations to bf16 at every kernel
    # on both sides, identically, so the bound stays at f32 rounding
    # noise amplified by a few bf16 near-ties
    tol = 2e-3 if quant else 1e-4
    np.testing.assert_allclose(pl.numpy()[1], jl[1], rtol=tol, atol=tol)
    np.testing.assert_allclose(pl.numpy()[0, 4:], jl[0, 4:], rtol=tol, atol=tol)
    np.testing.assert_allclose(pstep.numpy(), np.asarray(jstep), rtol=tol, atol=tol)


def test_int8_cache_layout_matches_jax():
    pm = create_model({"name": "transformer_lm", **CFG, "kv_quant": True}, device="cpu")
    c = pm.init_cache(2, 20).layers[0]
    jm = j_create({"name": "transformer_lm", **CFG, "kv_quant": True})
    jc = j_init_cache(jm, 2, 20)["DecoderLayer_0"]["attn"]
    assert tuple(c.kq.shape) == jc["cached_key_q"].shape and c.kq.dtype == torch.int8
    assert tuple(c.ks.shape) == jc["cached_key_scale"].shape and c.ks.dtype == torch.bfloat16
    assert tuple(c.vq.shape) == jc["cached_value_q"].shape
    assert tuple(c.vs.shape) == jc["cached_value_scale"].shape


def _jax_decode(extra):
    """The JAX model and one jitted decode apply (one compile per shape)."""
    jm, jt = _jax({"dtype": "float32", **extra})
    run = jax.jit(lambda c, ids, p, m, cur: jm.apply(
        {"params": jt, "cache": c}, ids, decode=True, positions=p, kv_mask=m,
        cache_cursor=cur, mutable=["cache"]))
    run_global = jax.jit(lambda c, ids, p, m: jm.apply(
        {"params": jt, "cache": c}, ids, decode=True, positions=p, kv_mask=m,
        mutable=["cache"]))
    return jm, run, run_global


def test_chunked_int8_decode_is_not_ported():
    """The path that raised NotImplementedError before the chunk kernel:
    a chunk of 4 at global cache index 8 on the int8 cache now runs the
    chunk kernel's plain version and matches the JAX apply (which takes the
    multi-query Pallas kernel in interpret mode at this width)."""
    jm, _, run_global = _jax_decode({"kv_quant": True})
    rng = np.random.default_rng(6)
    b = 2
    ids = rng.integers(1, 256, (b, 12))
    pm = np.ones((b, 12), bool)
    pm[0, :3] = False
    pos = np.maximum(np.cumsum(pm, 1) - 1, 0)
    kv_mask = np.concatenate([pm, np.ones((b, 4), bool)], 1)
    cache = j_init_cache(jm, b, 16)
    _, upd = run_global(cache, jnp.asarray(ids[:, :8]), jnp.asarray(pos[:, :8]),
                        jnp.asarray(kv_mask))
    ref, _ = run_global(upd["cache"], jnp.asarray(ids[:, 8:]), jnp.asarray(pos[:, 8:]),
                        jnp.asarray(kv_mask))
    m = _port({"kv_quant": True, "dtype": "float32"})
    cache_t = m.init_cache(b, 16)
    km = torch.from_numpy(kv_mask)
    m(torch.from_numpy(ids[:, :8]), positions=torch.from_numpy(pos[:, :8]), cache=cache_t,
      kv_mask=km)
    out = m(torch.from_numpy(ids[:, 8:]), positions=torch.from_numpy(pos[:, 8:]),
            cache=cache_t, kv_mask=km)
    assert cache_t.index == 12
    # f32 model, f32 rounding only: both sides quantize the same K/V to int8
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("s", [1, 4])
def test_row_cursor_decode_matches_flax(kv_quant, s):
    """Per-row cache cursors (the continuous engine's contract) against the
    JAX apply with ``cache_cursor``: two rows at different cursors write
    their s new tokens at their own slots and attend slots <= cursor + j;
    a second single-token step reads what the first wrote."""
    extra = {"kv_quant": kv_quant}
    jm, run, run_global = _jax_decode(extra)
    rng = np.random.default_rng(7 + s)
    b, l_max = 2, 24
    prompt = rng.integers(1, 256, (b, 10))
    pm = np.ones((b, 10), bool)
    pm[0, :2] = False
    pos = np.maximum(np.cumsum(pm, 1) - 1, 0)
    kv_mask = np.concatenate([pm, np.ones((b, l_max - 10), bool)], 1)
    cur = np.array([8, 10], np.int32)          # row 0 rewrites its last two slots
    new = rng.integers(1, 256, (b, s))
    new_pos = pos[np.arange(b), cur - 1][:, None] + 1 + np.arange(s)[None]
    nxt = rng.integers(1, 256, (b, 1))

    cache = j_init_cache(jm, b, l_max)
    _, upd = run_global(cache, jnp.asarray(prompt), jnp.asarray(pos), jnp.asarray(kv_mask))
    ref1, upd = run(upd["cache"], jnp.asarray(new), jnp.asarray(new_pos), jnp.asarray(kv_mask),
                    jnp.asarray(cur))
    ref2, _ = run(upd["cache"], jnp.asarray(nxt), jnp.asarray(new_pos[:, -1:] + 1),
                  jnp.asarray(kv_mask), jnp.asarray(cur + s))

    m = _port({"dtype": "float32", **extra})
    ct = m.init_cache(b, l_max)
    km = torch.from_numpy(kv_mask)
    m(torch.from_numpy(prompt), positions=torch.from_numpy(pos), cache=ct, kv_mask=km)
    out1 = m(torch.from_numpy(new), positions=torch.from_numpy(new_pos), cache=ct, kv_mask=km,
             cache_cursor=torch.from_numpy(cur))
    out2 = m(torch.from_numpy(nxt), positions=torch.from_numpy(new_pos[:, -1:] + 1), cache=ct,
             kv_mask=km, cache_cursor=torch.from_numpy(cur + s))
    assert ct.index == 10      # per-row cursors neither read nor advance it
    # f32 model: f32 rounding only (int8 codes equal on both sides)
    np.testing.assert_allclose(out1.numpy(), np.asarray(ref1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out2.numpy(), np.asarray(ref2), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("extra,quant", [
    ({"dtype": "float32"}, False),
    ({"dtype": "float32", "kv_quant": True, "decode_fused": True}, True),
])
def test_generate_greedy_tokens_equal_jax(extra, quant):
    """Left-padded ragged prompts; eos -> pad: the eos is the token row 0
    emits second, so row 0 stops there and pads after it."""
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, 256, (3, 8))
    pm = np.ones((3, 8), bool)
    pm[0, :3] = False
    pm[2, :6] = False
    tree = quantize_params(TREE) if quant else TREE
    model = _port(extra, tree, quant_kernel=quant)
    free = generate(model, torch.from_numpy(prompt), 6, prompt_mask=torch.from_numpy(pm)).numpy()
    eos = int(free[0, 9])
    out = generate(model, torch.from_numpy(prompt), 6, prompt_mask=torch.from_numpy(pm),
                   eos_id=eos, pad_id=0).numpy()
    jm, jt = _jax(extra)
    if quant:
        jt = j_quantize(jt)
    ref = np.asarray(j_generate(jm, {"params": jt}, jnp.asarray(prompt), 6,
                                prompt_mask=jnp.asarray(pm), eos_id=eos, pad_id=0,
                                quant_kernel=quant))
    assert out.shape == ref.shape == (3, 14)
    np.testing.assert_array_equal(out, ref)
    assert out[0, 9] == eos and np.all(out[0, 10:] == 0)
    np.testing.assert_array_equal(out[0, :10], free[0, :10])
    for r in (1, 2):  # rows that never emit eos are untouched by it
        if eos not in free[r, 8:]:
            np.testing.assert_array_equal(out[r], free[r])


def test_generate_logprobs_and_int8_storage_mode():
    m = _port({"dtype": "float32"}, quantize_params(TREE), quant_kernel=False)
    assert not any(isinstance(x, Int8Linear) for x in m.modules())
    prompt = torch.randint(1, 256, (2, 5), generator=torch.Generator().manual_seed(0))
    ids, lps = generate(m, prompt, 4, with_logprobs=True)
    assert ids.shape == (2, 9) and lps.shape == (2, 4)
    assert torch.all(lps <= 0) and torch.all(torch.isfinite(lps))
    # logprobs are the raw model's: recompute the first from a full forward
    full = m(ids[:, :5])[:, -1].log_softmax(-1)
    torch.testing.assert_close(lps[:, 0], full.gather(-1, ids[:, 5:6])[:, 0], rtol=1e-4, atol=1e-4)


def test_process_logits_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(4, 256)).astype(np.float32) * 3
    t = np.array([0.5, 1.0, 0.8, 2.0], np.float32)
    k = np.array([5, 256, 40, 1], np.int32)
    p = np.array([0.9, 0.5, 1.0, 0.3], np.float32)
    ref = np.asarray(j_process_rowwise(jnp.asarray(logits), jnp.asarray(t), jnp.asarray(k),
                                       jnp.asarray(p)))
    out = process_logits_rowwise(torch.from_numpy(logits), torch.from_numpy(t),
                                 torch.from_numpy(k), torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(np.isfinite(out), np.isfinite(ref))
    np.testing.assert_allclose(out[np.isfinite(out)], ref[np.isfinite(ref)], rtol=1e-6)
    ref_s = np.asarray(j_process(jnp.asarray(logits), 0.7, 10, 0.8))
    out_s = process_logits(torch.from_numpy(logits), 0.7, 10, 0.8).numpy()
    np.testing.assert_array_equal(np.isfinite(out_s), np.isfinite(ref_s))


def test_rowwise_sampling_stays_inside_topk_topp():
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.normal(size=(4, 256)).astype(np.float32) * 2)
    t = torch.tensor([0.0, 1.0, 0.7, 1.5])
    k = torch.tensor([256, 8, 256, 3])
    p = torch.tensor([1.0, 1.0, 0.6, 0.9])
    allowed = torch.isfinite(process_logits_rowwise(logits, t, k, p))
    gen = torch.Generator().manual_seed(0)
    seen = torch.zeros_like(allowed)
    for _ in range(200):
        tok = sample_token_rowwise(gen, logits, t, k, p)
        assert tok[0] == torch.argmax(logits[0])           # temperature 0: greedy
        assert allowed[torch.arange(4), tok].all()
        seen[torch.arange(4), tok] = True
    assert seen[1].sum() > 1 and seen[1].sum() <= 8      # it does sample, within top-8
    assert seen[3].sum() <= 3


def test_weights_round_trip_and_flatten(tmp_path):
    q = quantize_params(TREE)
    save_npz(str(tmp_path / "w.npz"), q)
    back = load_npz(str(tmp_path / "w.npz"))
    np.testing.assert_array_equal(back["lm_head"]["kernel"]["q8"], q["lm_head"]["kernel"]["q8"].numpy())
    state = from_flax_params(TREE)
    assert tuple(state["DecoderLayer_1/attn/q/kernel"].shape) == (128, 128)
    assert tuple(state["DecoderLayer_1/attn/out/kernel"].shape) == (128, 128)
    assert tuple(state["DecoderLayer_1/attn/k/kernel"].shape) == (128, 64)
    np.testing.assert_array_equal(
        state["DecoderLayer_0/attn/out/kernel"].numpy(),
        TREE["DecoderLayer_0"]["attn"]["out"]["kernel"].reshape(128, 128))


def test_fuse_decode_params_matches_jax():
    ref = j_fuse(_jnp(TREE))
    out = fuse_decode_params(TREE)
    np.testing.assert_array_equal(out["DecoderLayer_0"]["attn"]["qkv"]["kernel"].numpy(),
                                  np.asarray(ref["DecoderLayer_0"]["attn"]["qkv"]["kernel"]))
    np.testing.assert_array_equal(out["DecoderLayer_1"]["gate_up"]["kernel"].numpy(),
                                  np.asarray(ref["DecoderLayer_1"]["gate_up"]["kernel"]))
    qf = fuse_decode_params(quantize_params(TREE))
    rq = j_fuse(j_quantize(_jnp(TREE)))
    np.testing.assert_array_equal(qf["DecoderLayer_0"]["attn"]["qkv"]["kernel"]["q8"].numpy(),
                                  np.asarray(rq["DecoderLayer_0"]["attn"]["qkv"]["kernel"]["q8"]))


def test_entry_points_refuse_to_drift_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is the default here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model({"name": "transformer_lm", **CFG})
