"""Statistics that the JAX step takes over the global batch, held under a
mesh: the port's Trainer against the JAX Trainer under the same mesh,
from the JAX Trainer's initial weights.

- BatchNorm (``models/zoo._BatchNormTrain``): the JAX step's
  ``nn.BatchNorm`` runs under ``jit`` on a batch sharded over dp, so its
  mean and variance are the global batch's, and so are the running
  statistics every rank writes.  The zoo's two-stage ResNet at ``{dp: 2}``
  under plain SGD (a gradient of the wrong scale shows in the weights):
  the losses, the weights and the ``batch_stats``.
- ``moe_lm``'s routing (``models/moe.MoEBlock``): no ``shard_map`` cuts
  the JAX block, so its capacity, the positions that decide which tokens
  are dropped and the Switch aux loss are taken over the global ``B*S``
  tokens.  At ``{dp: 2}`` and ``{sp: 2}`` (``ring_flash``, the sequence
  sharded) with a capacity factor low enough to drop tokens: the losses,
  each step's aux loss (the JAX one from the step's weights on the whole
  batch) and the weights.

Before either, the JAX Trainer under the mesh is held against itself
unsharded: its statistics do not depend on the sharding, so the port's
must not either.  The port side runs on one gloo gang of 2 processes
started once for the file (tests/torch_gang.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_gang
from mlcomp_tpu.models import MODELS as JAX_MODELS
from mlcomp_tpu.models import load_all as jax_load_all
from mlcomp_tpu.models.resnet import ResNet as JaxResNet
from mlcomp_tpu.parallel.mesh import MeshSpec, make_mesh
from mlcomp_tpu.train.loop import Trainer as JaxTrainer
from mlcomp_tpu_torch.train.loop import Trainer
from torch_gang import result, run_gang

torch.set_num_threads(1)
WORLD = 2
SGD = {"name": "sgd", "lr": 1.0}
# the ResNet's f32 convolutions sum in another order than XLA's, and three
# steps at lr 0.1 carried that past 1e-4 into a few weights (the port's
# unsharded Trainer as far as its sharded one): lr 0.01
RESNET_SGD = {"name": "sgd", "lr": 0.01}
# tests/test_torch_zoo.py's two-stage ResNet, registered as ``resnet`` on
# both sides (tests/torch_gang.py does the port's)
RESNET = {"name": "resnet", "stage_sizes": [1, 1], "width": 8, "num_classes": 10,
          "dtype": "float32"}
# one MoE layer of 4 experts behind one dense layer; at capacity factor 0.5
# each expert takes a quarter of the global tokens' top-2 assignments
MOE = {"name": "moe_lm", "vocab_size": 128, "hidden": 64, "layers": 2, "heads": 2,
       "kv_heads": 1, "n_experts": 4, "d_ff": 128, "k": 2, "moe_every": 2,
       "capacity_factor": 0.5, "dtype": "float32"}
STEPS = 3

# name -> (mesh, model, optimizer, data)
CASES = {
    "resnet_dp2": ({"dp": 2}, RESNET, RESNET_SGD,
                   {"name": "synthetic_images", "n": 4, "height": 32, "width": 32,
                    "channels": 3, "num_classes": 10, "batch_size": 4}),
    "moe_dp2": ({"dp": 2}, MOE, SGD,
                {"name": "synthetic_tokens", "n": 4, "seq_len": 64, "vocab_size": 128,
                 "batch_size": 4}),
    "moe_sp2": ({"sp": 2}, {**MOE, "seq_parallel": "ring_flash"}, SGD,
                {"name": "synthetic_tokens", "n": 2, "seq_len": 256, "vocab_size": 128,
                 "batch_size": 2}),
}


def _register_resnet():
    jax_load_all()
    try:
        JAX_MODELS.get("resnet")
    except KeyError:
        JAX_MODELS.register("resnet", obj=JaxResNet)


def _cfg(name, mesh=True):
    m, model, opt, data = CASES[name]
    is_lm = model["name"] == "moe_lm"
    return {"model": dict(model), "optimizer": opt,
            "loss": "lm_cross_entropy" if is_lm else "cross_entropy", "metrics": [],
            "epochs": 1, "seed": 0, "mesh": m if mesh else None, "data": {"train": data}}


def _batches(name):
    data = CASES[name][3]
    rng = np.random.default_rng(sorted(CASES).index(name) + 30)
    b = data["batch_size"]
    if data["name"] == "synthetic_tokens":
        return [{"x": rng.integers(1, 128, (b, data["seq_len"])).astype(np.int64)}
                for _ in range(STEPS)]
    return [{"x": rng.random((b, 32, 32, 3), dtype=np.float32),
             "y": rng.integers(0, 10, b).astype(np.int32)} for _ in range(STEPS)]


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


_JAX = {}


def _jax(name, n_devices=WORLD):
    """The JAX Trainer on ``n_devices`` (the case's mesh at 2, unsharded at
    1): initial flat weights, losses, each step's aux loss, final weights
    and model state."""
    key = (name, n_devices)
    if key not in _JAX:
        _register_resnet()
        cfg = _cfg(name, mesh=n_devices > 1)
        mesh = make_mesh(MeshSpec.from_config(cfg["mesh"]), devices=jax.devices()[:n_devices])
        jt = JaxTrainer(cfg, mesh=mesh)
        init = _flat(jt.state.params)
        losses, aux = [], []
        for b in _batches(name):
            jb = {k: jnp.asarray(v, jnp.int32 if v.dtype != np.float32 else jnp.float32)
                  for k, v in b.items()}
            if "y" not in b:
                _, sown = jt.state.apply_fn({"params": jt.state.params}, jb["x"], train=True,
                                            mutable=["losses"])
                aux.append(float(sum(jnp.sum(a) for a in jax.tree.leaves(sown["losses"]))))
            jt.state, stats = jt._train_step(jt.state, jb)
            losses.append(float(stats["loss"]))
        _JAX[key] = (init, losses, aux, _flat(jt.state.params), _flat(jt.state.model_state))
    return _JAX[key]


@pytest.fixture(scope="module")
def gang():
    cases = [(name, "trainer", dict(cfg=_cfg(name), init=_jax(name)[0], batches=_batches(name)))
             for name in CASES]
    return run_gang(WORLD, cases)


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_jax_trainers_statistics_do_not_depend_on_the_mesh(name):
    """The reference itself: the JAX Trainer under the mesh equals the JAX
    Trainer on one device (losses, aux, weights, batch statistics), so its
    BatchNorm statistics and MoE routing are the global batch's."""
    _, losses, aux, final, stats = _jax(name)
    _, losses1, aux1, final1, stats1 = _jax(name, n_devices=1)
    np.testing.assert_allclose(losses, losses1, rtol=1e-5)
    np.testing.assert_allclose(aux, aux1, rtol=1e-5)
    for k, v in {**final1, **stats1}.items():
        np.testing.assert_allclose({**final, **stats}[k], v, atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_global_batch_statistics_under_a_mesh_match_the_jax_trainer(gang, name):
    _, losses, aux, final, stats = _jax(name)
    got = [result(gang, r, name) for r in range(WORLD)]
    for r, g in enumerate(got):
        assert g["step"] == STEPS
        np.testing.assert_allclose(g["losses"], losses, rtol=1e-4, err_msg=f"{name} r{r}")
    g = got[0]
    assert set(g["params"]) == set(final)
    for k, v in final.items():
        np.testing.assert_allclose(g["params"][k], v, atol=1e-4, rtol=0, err_msg=f"{name} {k}")
    if name.startswith("resnet"):
        want = {k.split("/", 1)[1]: v for k, v in stats.items()}
        for r, g_r in enumerate(got):
            assert set(g_r["model_state"]) == {f"batch_stats/{k}" for k in want}
            for k, v in want.items():
                np.testing.assert_allclose(g_r["model_state"][f"batch_stats/{k}"], v,
                                           atol=1e-4, rtol=0, err_msg=f"{name} r{r} {k}")
    else:
        for r, g_r in enumerate(got):
            np.testing.assert_allclose(g_r["aux"], aux, rtol=1e-4, err_msg=f"{name} r{r}")
            # the capacity refused some of the global tokens' assignments
            # at every step, the same count on each rank
            assert all(d > 0 for d in g_r["dropped"]), g_r["dropped"]
            assert g_r["dropped"] == got[0]["dropped"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_global_batch_statistics_under_a_mesh_match_the_ports_unsharded_trainer(gang, name):
    """The port's sharded steps against its own unsharded Trainer on the
    whole batch, from the same weights: the file's 1e-5 on the losses and
    1e-4 on the weights (tests/test_torch_parallel_trainer.py)."""
    torch_gang._register_test_models()
    init = _jax(name)[0]
    t = Trainer(_cfg(name, mesh=False), device="cpu")
    with torch.no_grad():
        for k, p in t.state.params.items():
            p.copy_(torch.from_numpy(np.array(init[k])))
    losses = [float(t._train_step(t.state, {k: torch.from_numpy(v) for k, v in b.items()})
                    ["loss"]) for b in _batches(name)]
    got = result(gang, 0, name)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5, err_msg=name)
    for k, p in t.state.params.items():
        np.testing.assert_allclose(got["params"][k], p.detach().numpy(), atol=1e-4, rtol=0,
                                   err_msg=f"{name} {k}")
    for k, v in t.state.model_state.items():
        np.testing.assert_allclose(got["model_state"][k], v.numpy(), atol=1e-5, rtol=0,
                                   err_msg=f"{name} {k}")
