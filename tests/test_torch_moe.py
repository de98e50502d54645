"""The port's ``moe_lm`` (models/moe.py) and B1's expert path
(``ops.quant.expert_matmul``) against the JAX package's, on one
numpy-drawn weight tree (``io.weights.init_params``) and f32 fixtures.

Tolerances: in f32 both packages compute the same sums in other orders
(XLA's einsums against torch's), ~1e-6 relative: forwards are held to
1e-5 of the output's scale, the train step's loss to 1e-5 relative and
each gradient leaf to 1e-4 of its largest entry.  Routing is discrete:
greedy ids are held exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlcomp_tpu.models import create_model as j_create
from mlcomp_tpu.models.generation import generate as j_generate
from mlcomp_tpu.models.moe import MoEBlock as JBlock
from mlcomp_tpu.ops.quant import dequantize_nonkernel_params as j_deq_nonkernel
from mlcomp_tpu.ops.quant import quantize_params as j_quantize
from mlcomp_tpu.train.losses import lm_cross_entropy as j_lm_ce
from mlcomp_tpu_torch.engine import DecodeEngine
from mlcomp_tpu_torch.io.weights import from_flax_params, init_params
from mlcomp_tpu_torch.models import create_model
from mlcomp_tpu_torch.models.generation import generate, prep_decode_variables
from mlcomp_tpu_torch.models.moe import MoEBlock
from mlcomp_tpu_torch.ops import quant
from mlcomp_tpu_torch.ops.cuda import quant_matmul as qm
from mlcomp_tpu_torch.train.losses import lm_cross_entropy
from mlcomp_tpu_torch.train.loop import sown_losses

torch.set_num_threads(2)

CFG = dict(vocab_size=128, hidden=128, layers=4, heads=2, kv_heads=1, n_experts=4,
           d_ff=256, k=2, moe_every=2, dtype="float32")
TREE = init_params({"name": "moe_lm", **CFG}, seed=0)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _port(tree=TREE, extra=None, **prep):
    model = create_model({"name": "moe_lm", **CFG, **(extra or {})}, device="cpu")
    return prep_decode_variables(model, tree, **prep)


def _block_params(seed, e, d, f):
    rng = np.random.default_rng(seed)
    return {"router": {"kernel": rng.standard_normal((d, e), dtype=np.float32) / np.sqrt(d)},
            "experts_w1": rng.standard_normal((e, d, f), dtype=np.float32) / np.sqrt(d),
            "experts_w2": rng.standard_normal((e, f, d), dtype=np.float32) / np.sqrt(f)}


def _port_block(params, e, d, f, k, cf):
    blk = MoEBlock(e, k, cf, torch.float32)
    blk.router.kernel = torch.from_numpy(params["router"]["kernel"])
    blk.w1 = torch.from_numpy(params["experts_w1"])
    blk.w2 = torch.from_numpy(params["experts_w2"])
    return blk


@pytest.mark.parametrize("e,k,cf,tokens", [
    (4, 2, 2.0, (2, 8)),      # generous capacity: almost nothing drops
    (2, 1, 0.1, (1, 32)),     # one slot an expert: most tokens drop
    (4, 2, 1.25, (2, 48)),    # the serving config's capacity; t > 64 at eval
])
def test_moe_block_routing_drops_and_aux_match_jax(e, k, cf, tokens):
    d, f = 16, 32
    params = _block_params(1, e, d, f)
    x = np.random.default_rng(2).standard_normal((*tokens, d), dtype=np.float32)
    jb = JBlock(n_experts=e, d_model=d, d_ff=f, k=k, capacity_factor=cf, dtype=jnp.float32)
    ref, sown = jb.apply({"params": _jnp(params)}, jnp.asarray(x), train=True,
                         mutable=["losses"])
    ref_eval = jb.apply({"params": _jnp(params)}, jnp.asarray(x), train=False)
    blk = _port_block(params, e, d, f, k, cf)
    out = blk(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    (aux_ref,) = jax.tree.leaves(sown["losses"])
    np.testing.assert_allclose(float(blk.aux), float(aux_ref), rtol=1e-5)
    # the same rows are dropped (all-zero outputs) on both sides
    np.testing.assert_array_equal(np.linalg.norm(out.detach().numpy(), axis=-1) < 1e-6,
                                  np.linalg.norm(np.asarray(ref), axis=-1) < 1e-6)
    out_eval = blk(torch.from_numpy(x), train=False)
    assert blk.aux is None
    np.testing.assert_allclose(out_eval.detach().numpy(), np.asarray(ref_eval), rtol=1e-5,
                               atol=1e-5)
    # inference is drop-free
    assert (np.linalg.norm(out_eval.detach().numpy(), axis=-1) > 1e-6).all()


def test_moe_lm_forward_matches_jax():
    ids = np.random.default_rng(3).integers(0, 128, (2, 24))
    jm = j_create({"name": "moe_lm", **CFG})
    ref = np.asarray(jm.apply({"params": _jnp(TREE)}, jnp.asarray(ids), train=False))
    out = _port()(torch.from_numpy(ids))
    assert out.shape == (2, 24, 128) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_moe_lm_train_step_matches_jax():
    """The objective (lm_cross_entropy plus every MoE layer's sown aux loss)
    and its gradients: the JAX Trainer's ``loss_of`` against the port
    Trainer's step (``sown_losses``) on the same weights and batch."""
    ids = np.random.default_rng(4).integers(0, 128, (4, 32))
    batch_j = {"x": jnp.asarray(ids)}
    jm = j_create({"name": "moe_lm", **CFG})

    def loss_of(params):
        out, state = jm.apply({"params": params}, batch_j["x"], train=True,
                              mutable=["losses"])
        loss = j_lm_ce(out, batch_j)
        for leaf in jax.tree.leaves(state["losses"]):
            loss = loss + jnp.sum(leaf)
        return loss

    loss_ref, grads_ref = jax.value_and_grad(loss_of)(_jnp(TREE))
    model = create_model({"name": "moe_lm", **CFG}, device="cpu")
    model.load_state(from_flax_params(TREE, fold=False), train=True)
    model.train()
    x = torch.from_numpy(ids)
    loss = lm_cross_entropy(model(x), {"x": x})
    aux = sown_losses(model)
    assert len(aux) == 2
    loss = loss + sum(a.sum() for a in aux)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref), rtol=1e-5)
    flat_ref = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(g)
                for path, g in jax.tree_util.tree_flatten_with_path(grads_ref)[0]}
    params = model.flax_params()
    assert set(params) == set(flat_ref)
    for name, p in params.items():
        ref = flat_ref[name]
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * max(np.abs(ref).max(), 1e-30), err_msg=name)


def test_moe_lm_trainer_runs_steps():
    from mlcomp_tpu_torch.train.loop import Trainer

    cfg = {"model": {"name": "moe_lm", **CFG}, "optimizer": {"name": "adafactor", "lr": 1e-2},
           "loss": "lm_cross_entropy", "metrics": [], "epochs": 1,
           "data": {"train": {"name": "synthetic_tokens", "n": 8, "seq_len": 16,
                              "vocab_size": 128, "batch_size": 4}}}
    tr = Trainer(cfg, device="cpu")
    assert "MoELayer_1/moe/experts_w2" in tr.state.params
    stats = tr.train_epoch()
    assert np.isfinite(stats["loss"])


def test_moe_lm_aux_loss_over_steps_on_one_batch_matches_the_jax_trainer():
    """The moe phase's recipe (adafactor at lr 1e-2, four steps on one
    batch seen again) at this width, from the JAX Trainer's init: the
    objective and the summed aux loss of every step against the JAX
    Trainer's (the aux loss at the step's own weights, from its sown
    ``losses``), 1e-4 relative.  On this batch the JAX Trainer's aux loss
    ends above where it started while the cross-entropy falls, as the aux
    loss of chip_smoke.py's moe phase does: the reference does not make it
    fall on a batch seen again."""
    from mlcomp_tpu.parallel.mesh import MeshSpec, make_mesh
    from mlcomp_tpu.train.loop import Trainer as JaxTrainer
    from mlcomp_tpu_torch.train.loop import Trainer

    cfg = {"model": {"name": "moe_lm", **CFG}, "optimizer": {"name": "adafactor", "lr": 1e-2},
           "loss": "lm_cross_entropy", "metrics": [], "seed": 0,
           "data": {"train": {"name": "synthetic_tokens", "n": 4, "seq_len": 32,
                              "vocab_size": 128, "batch_size": 4}}}
    jt = JaxTrainer(cfg, mesh=make_mesh(MeshSpec(), devices=jax.devices()[:1]))
    tt = Trainer(cfg, device="cpu")
    init = from_flax_params(jax.tree.map(np.array, jt.state.params), fold=False)
    with torch.no_grad():
        for k, p in tt.state.params.items():
            p.copy_(init[k])
    x = np.random.default_rng(7).integers(1, 128, (4, 32)).astype(np.int32)
    j_obj, j_aux, t_obj, t_aux = [], [], [], []
    for _ in range(4):
        _, sown = jt.state.apply_fn({"params": jt.state.params}, jnp.asarray(x), train=True,
                                    mutable=["losses"])
        j_aux.append(float(sum(jnp.sum(a) for a in jax.tree.leaves(sown["losses"]))))
        jt.state, jstats = jt._train_step(jt.state, {"x": jnp.asarray(x)})
        j_obj.append(float(jstats["loss"]))
        tstats = tt._train_step(tt.state, {"x": torch.from_numpy(x)})
        t_obj.append(float(tstats["loss"]))
        t_aux.append(float(sum(a.detach() for a in sown_losses(tt.model))))
    np.testing.assert_allclose(t_obj, j_obj, rtol=1e-4)
    np.testing.assert_allclose(t_aux, j_aux, rtol=1e-4)
    assert t_obj[-1] < t_obj[0] and j_aux[-1] > j_aux[0]


@pytest.mark.parametrize("kv_quant", [False, True])
def test_moe_lm_cached_greedy_generate_equals_jax(kv_quant):
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, 128, (3, 8))
    pm = np.ones((3, 8), bool)
    pm[0, :3] = False
    model = _port(extra={"kv_quant": kv_quant})
    out = generate(model, torch.from_numpy(prompt), 6, prompt_mask=torch.from_numpy(pm))
    jm = j_create({"name": "moe_lm", **CFG, "kv_quant": kv_quant})
    ref = j_generate(jm, {"params": _jnp(TREE)}, jnp.asarray(prompt), 6,
                     prompt_mask=jnp.asarray(pm))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_moe_lm_engine_serves_generates_tokens():
    """The continuous engine (per-row cursors, int8 KV) gives generate's
    greedy tokens on the same left-padded bucket."""
    model = _port(extra={"kv_quant": True})
    prompts = [np.random.RandomState(6).randint(1, 128, n).tolist() for n in (5, 11)]
    eng = DecodeEngine(model, slots=2, prompt_buckets=(16,), max_new_cap=8, prefill_chunk=16)
    try:
        got = [f.result(timeout=300)["ids"] for f in [eng.submit(p, 5) for p in prompts]]
    finally:
        eng.close()
    for p, ids in zip(prompts, got):
        row = np.zeros((1, 16), np.int64)
        mask = np.zeros((1, 16), bool)
        row[0, 16 - len(p):] = p
        mask[0, 16 - len(p):] = True
        ref = generate(model, torch.from_numpy(row), 5, prompt_mask=torch.from_numpy(mask))
        assert ids == ref[0, 16:].tolist()


def test_quantized_experts_stay_int8_under_the_jax_rule():
    q = quant.quantize_params(TREE, min_size=1024)
    w1 = q["MoELayer_0"]["moe"]["experts_w1"]
    assert quant.is_quantized_leaf(w1) and tuple(w1["q8_scale"].shape) == (4, 1, 256)
    ours = quant.dequantize_nonkernel_params(q)
    ref = j_deq_nonkernel(j_quantize(_jnp(TREE), min_size=1024))
    for layer in ("MoELayer_0", "MoELayer_1"):
        for name in ("experts_w1", "experts_w2"):
            assert quant.is_quantized_leaf(ours[layer]["moe"][name])
            assert quant.is_quantized_leaf(ref[layer]["moe"][name])
            np.testing.assert_array_equal(ours[layer]["moe"][name]["q8"].numpy(),
                                          np.asarray(ref[layer]["moe"][name]["q8"]))
        # the router (d, 4) is not kernel-consumable: dequantized on both sides
        assert not quant.is_quantized_leaf(ours[layer]["moe"]["router"]["kernel"])
        assert not quant.is_quantized_leaf(ref[layer]["moe"]["router"]["kernel"])


def test_expert_matmul_runs_b1_on_tileable_slices_and_dequantizes_others():
    rng = np.random.default_rng(7)
    w = rng.standard_normal((3, 128, 256), dtype=np.float32)
    leaf = quant.quantize_leaf(w)
    x = torch.from_numpy(rng.standard_normal((5, 128), dtype=np.float32))
    got = quant.expert_matmul(x, {"q8": leaf["q8"][1], "q8_scale": leaf["q8_scale"][1]},
                              torch.float32)
    ref = qm.quant_matmul_plain(x.bfloat16(), leaf["q8"][1], leaf["q8_scale"][1].reshape(-1))
    torch.testing.assert_close(got, ref.float())
    # a slice whose out dim is not a multiple of 128 dequantizes inline
    small = quant.quantize_leaf(rng.standard_normal((2, 128, 96), dtype=np.float32))
    sl = {"q8": small["q8"][0], "q8_scale": small["q8_scale"][0]}
    torch.testing.assert_close(quant.expert_matmul(x, sl, torch.float32),
                               x @ quant.dequantize_leaf(sl, torch.float32))


def test_moe_quantized_decode_matches_entry_dequant():
    """tests/test_quant.py's case on the port: int8 experts consumed slice by
    slice in the scan give the entry-dequant decode's first new token, and
    so do the JAX package's two paths."""
    cfg = dict(vocab_size=64, hidden=128, layers=2, heads=2, n_experts=2, d_ff=256,
               moe_every=1, dtype="float32")
    tree = init_params({"name": "moe_lm", **cfg}, seed=9)
    q = quant.quantize_params(tree, min_size=1024)
    prompt = torch.from_numpy(np.random.RandomState(9).randint(1, 64, (2, 4)))
    a = generate(prep_decode_variables(create_model({"name": "moe_lm", **cfg}, device="cpu"),
                                       q), prompt, 3)
    kernel_model = prep_decode_variables(create_model({"name": "moe_lm", **cfg}, device="cpu"),
                                         q, quant_kernel=True)
    assert kernel_model.fold_norms is False
    assert quant.is_quantized_leaf(kernel_model.layers[0].moe.w1)
    b = generate(kernel_model, prompt, 3)
    assert a.shape == b.shape == (2, 7)
    np.testing.assert_array_equal(a[:, 4].numpy(), b[:, 4].numpy())
    jm = j_create({"name": "moe_lm", **cfg})
    jq = {"params": j_quantize(_jnp(tree), min_size=1024)}
    jb = j_generate(jm, jq, jnp.asarray(prompt.numpy()), 3, quant_kernel=True)
    np.testing.assert_array_equal(b[:, 4].numpy(), np.asarray(jb)[:, 4])


def test_quantized_experts_are_decode_only():
    blk = MoEBlock(2, dtype=torch.float32)
    params = _block_params(3, 2, 128, 256)
    blk.router.kernel = torch.from_numpy(params["router"]["kernel"])
    blk.w1 = quant.quantize_leaf(params["experts_w1"])
    blk.w2 = quant.quantize_leaf(params["experts_w2"])
    x = torch.randn(2, 4, 128, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="decode-only"):
        blk(x, train=True)
    assert blk(x, train=False).shape == x.shape
    tree = {**TREE, "MoELayer_0": {**TREE["MoELayer_0"], "moe": {
        **TREE["MoELayer_0"]["moe"],
        "experts_w1": quant.quantize_leaf(TREE["MoELayer_0"]["moe"]["experts_w1"])}}}
    model = create_model({"name": "moe_lm", **CFG}, device="cpu")
    with pytest.raises(ValueError, match="decode-only"):
        model.load_state(from_flax_params(tree, fold=False), train=True)
