"""The training recipes the zoo does not use, against the JAX package:
``remat``, the fused CE head (``ops/fused_ce.py`` with
``lm_cross_entropy_fused``), the ``lamb``, ``lars`` and ``rmsprop``
optimizers, adafactor's ``momentum`` and ``accum_steps``
(``optax.MultiSteps``).

Tolerances: f32 on the CPU, the same formulas summed in other orders.
Optimizer trajectories are held at 1e-6 absolute over five updates;
losses at 1e-5 relative; gradients at 1e-4 of each leaf's largest entry
(a transformer's gradients pass through ~20 chained f32 products), and
remat against the same model without it at 1e-6 (the same products,
recomputed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mlcomp_tpu.models import create_model as j_create
from mlcomp_tpu.ops.fused_ce import fused_linear_cross_entropy as j_fused_ce
from mlcomp_tpu.train import losses as jlosses
from mlcomp_tpu.train import optim as joptim
from mlcomp_tpu_torch.io.weights import from_flax_params, init_params
from mlcomp_tpu_torch.models import create_model
from mlcomp_tpu_torch.ops.fused_ce import fused_linear_cross_entropy
from mlcomp_tpu_torch.train import losses, optim
from mlcomp_tpu_torch.train.loop import Trainer

torch.set_num_threads(2)

CFG = dict(vocab_size=128, hidden=64, layers=2, heads=2, mlp_dim=128, dtype="float32")
TREE = init_params(CFG, seed=1)
IDS = np.random.default_rng(2).integers(0, 128, (2, 24))


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_loss_grads(extra, loss_name):
    jm = j_create({"name": "transformer_lm", **CFG, **extra})
    batch = {"x": jnp.asarray(IDS)}
    fn = jlosses.LOSSES.get(loss_name)

    def loss_of(params):
        return fn(jm.apply({"params": params}, batch["x"], train=True), batch)

    loss, grads = jax.value_and_grad(loss_of)(jax.tree.map(jnp.asarray, TREE))
    return float(loss), _flat(grads)


def _port_loss_grads(extra, loss_name):
    m = create_model({"name": "transformer_lm", **CFG, **extra}, device="cpu")
    m.load_state(from_flax_params(TREE, fold=False), train=True)
    x = torch.from_numpy(IDS)
    loss = losses.create_loss(loss_name)(m(x), {"x": x})
    loss.backward()
    return float(loss.detach()), {k: p.grad.numpy() for k, p in m.flax_params().items()}


def _assert_grads(got, want):
    assert set(got) == set(want)
    for k, ref in want.items():
        np.testing.assert_allclose(got[k], ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=k)


def test_remat_gradients_equal_the_plain_step_and_jax_remat():
    loss_r, grads_r = _port_loss_grads({"remat": True}, "lm_cross_entropy")
    loss_p, grads_p = _port_loss_grads({}, "lm_cross_entropy")
    assert loss_r == loss_p
    for k in grads_p:
        np.testing.assert_allclose(grads_r[k], grads_p[k], rtol=0, atol=1e-6, err_msg=k)
    loss_j, grads_j = _jax_loss_grads({"remat": True}, "lm_cross_entropy")
    np.testing.assert_allclose(loss_r, loss_j, rtol=1e-5)
    _assert_grads(grads_r, grads_j)


def test_remat_is_off_at_decode_and_keeps_the_parameter_paths():
    from mlcomp_tpu_torch.models.generation import generate, prep_decode_variables

    plain = prep_decode_variables(create_model({"name": "transformer_lm", **CFG},
                                               device="cpu"), TREE)
    remat = prep_decode_variables(create_model({"name": "transformer_lm", **CFG, "remat": True},
                                               device="cpu"), TREE)
    assert set(remat.flax_params()) == set(plain.flax_params())
    prompt = torch.from_numpy(IDS[:, :8])
    assert torch.equal(generate(remat, prompt, 4), generate(plain, prompt, 4))


def test_fused_linear_cross_entropy_matches_the_jax_op():
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 32, 48), dtype=np.float32)
    w = rng.standard_normal((48, 96), dtype=np.float32) * 0.2
    labels = rng.integers(0, 96, (2, 32)).astype(np.int32)
    g = rng.standard_normal((2, 32), dtype=np.float32)

    def jloss(h, w):
        return jnp.sum(j_fused_ce(h, w, jnp.asarray(labels), 8) * g)

    ref = np.asarray(j_fused_ce(jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels), 8))
    dh_ref, dw_ref = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    out = fused_linear_cross_entropy(th, tw, torch.from_numpy(labels), 8)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5, atol=1e-5)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(dh_ref), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(dh_ref)).max())
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dw_ref), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(dw_ref)).max())
    with pytest.raises(ValueError, match="not divisible"):
        fused_linear_cross_entropy(th, tw, torch.from_numpy(labels), 7)


@pytest.mark.parametrize("chunk", [8, 10])
def test_fused_loss_model_and_loss_match_jax(chunk):
    """``fused_loss: true`` with ``lm_cross_entropy_fused``: per-token losses
    (B, S), the chunk the largest divisor of S that fits (10 -> 8 at S 24),
    against the JAX model's, and equal to the unfused loss."""
    extra = {"fused_loss": True, "fused_loss_chunk": chunk}
    loss_f, grads_f = _port_loss_grads(extra, "lm_cross_entropy_fused")
    loss_j, grads_j = _jax_loss_grads(extra, "lm_cross_entropy_fused")
    np.testing.assert_allclose(loss_f, loss_j, rtol=1e-5)
    _assert_grads(grads_f, grads_j)
    loss_p, _ = _port_loss_grads({}, "lm_cross_entropy")
    np.testing.assert_allclose(loss_f, loss_p, rtol=1e-5)


def test_fused_loss_trains_through_the_trainer():
    cfg = {"model": {"name": "transformer_lm", **CFG, "fused_loss": True, "remat": True},
           "optimizer": {"name": "adamw", "lr": 1e-3, "accum_steps": 2},
           "loss": "lm_cross_entropy_fused", "metrics": [], "epochs": 1,
           "data": {"train": {"name": "synthetic_tokens", "n": 8, "seq_len": 16,
                              "vocab_size": 128, "batch_size": 2}}}
    stats = Trainer(cfg, device="cpu").train_epoch()
    assert np.isfinite(stats["loss"])


NEW_OPTIMIZERS = [
    {"name": "lamb", "lr": 1e-2, "weight_decay": 0.01},
    {"name": "lars", "lr": 0.1},
    {"name": "rmsprop", "lr": 1e-2},
    {"name": "rmsprop", "lr": 1e-2, "momentum": 0.9, "decay": 0.8},
    {"name": "adafactor", "lr": 1e-2, "momentum": 0.9},
    {"name": "adam", "lr": 1e-2, "accum_steps": 2},
    {"name": "lamb", "lr": {"name": "cosine", "lr": 1e-2, "decay_steps": 4},
     "accum_steps": 3, "grad_clip": 1.0},
]


@pytest.mark.parametrize("cfg", NEW_OPTIMIZERS,
                         ids=[f"{c['name']}{i}" for i, c in enumerate(NEW_OPTIMIZERS)])
def test_new_optimizers_match_optax(cfg):
    rng = np.random.default_rng(4)
    shapes = {"w": (256, 128), "k": (4, 128, 256), "b": (64,)}
    params = {k: rng.standard_normal(s, dtype=np.float32) * 0.1 for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s, dtype=np.float32) for k, s in shapes.items()}
             for _ in range(6)]
    tx = joptim.create_optimizer(cfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    ttx = optim.create_optimizer(cfg)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = ttx.init(tp)
    for i, g in enumerate(grads[:5] if "accum_steps" not in cfg else grads):
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, ts = ttx.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        optim.apply_updates(tp, tupd)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6,
                                       err_msg=f"{k} after update {i + 1}")
