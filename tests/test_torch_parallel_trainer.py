"""The port's Trainer under a mesh, held against the JAX Trainer under the
same mesh and against the port's own unsharded Trainer, from the JAX
Trainer's initial weights (carried across with ``from_flax_params``):
two steps' losses and the final weights (under adamw or adafactor, and
under plain SGD, whose weights hold the reduced gradients' scale), the
state's shards, and
checkpoints (a sharded run's loads unsharded; an unsharded one resumes
under a mesh).

The port side runs on one gloo gang of 2 processes started once for the
file (tests/torch_gang.py); each rank feeds its rows of the global batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlcomp_tpu.parallel.mesh import MeshSpec, make_mesh
from mlcomp_tpu.train.loop import Trainer as JaxTrainer
from mlcomp_tpu_torch.io.checkpoint import restore_checkpoint, save_checkpoint
from mlcomp_tpu_torch.io.weights import from_flax_params
from mlcomp_tpu_torch.train.loop import Trainer
from torch_gang import result, run_gang

torch.set_num_threads(1)
WORLD = 2
ADAMW = {"name": "adamw", "lr": 1e-3, "weight_decay": 0.01, "grad_clip": 1.0}
ADAFACTOR = {"name": "adafactor", "grad_clip": 1.0,
             "lr": {"name": "warmup_cosine", "lr": 1e-2, "warmup_steps": 1, "decay_steps": 50}}
# plain SGD, unclipped: the weights after a step are the initial weights
# less the reduced gradient itself, so a gradient of the wrong scale (a
# missing or doubled mean over the data axes, a mean where sp or pp sum)
# shows in the weights, where adamw and adafactor normalise it away
SGD = {"name": "sgd", "lr": 1.0}
LM = {"name": "transformer_lm", "vocab_size": 256, "hidden": 64, "layers": 2, "heads": 4,
      "kv_heads": 2, "dtype": "float32"}

# name -> (mesh, model overrides, optimizer, seq_len)
CASES = {
    "dp2": ({"dp": 2}, {}, ADAMW, 128),
    "fsdp2": ({"fsdp": 2}, {}, ADAFACTOR, 128),
    "tp2": ({"tp": 2}, {}, ADAFACTOR, 128),
    "sp2_ring_flash": ({"sp": 2}, {"seq_parallel": "ring_flash"}, ADAMW, 256),
    "pp2": ({"pp": 2}, {"name": "transformer_lm_pp", "layers": 4, "mlp_dim": 128}, ADAMW, 128),
    "dp2_sgd": ({"dp": 2}, {}, SGD, 128),
    "fsdp2_sgd": ({"fsdp": 2}, {}, SGD, 128),
    "tp2_sgd": ({"tp": 2}, {}, SGD, 128),
    "sp2_ring_flash_sgd": ({"sp": 2}, {"seq_parallel": "ring_flash"}, SGD, 256),
    "pp2_sgd": ({"pp": 2}, {"name": "transformer_lm_pp", "layers": 4, "mlp_dim": 128}, SGD,
                128),
}
# the port's other sequence-parallel modes, held against its unsharded run
PORT_ONLY = {
    "sp2_ring": ({"sp": 2}, {"seq_parallel": "ring"}, ADAMW, 256),
    "sp2_ulysses": ({"sp": 2}, {"seq_parallel": "ulysses"}, ADAMW, 256),
    "dp2_fused_loss": ({"dp": 2}, {"fused_loss": True}, ADAMW, 128),
}


def _cfg(name):
    mesh, over, opt, seq = {**CASES, **PORT_ONLY}[name]
    model = {**LM, **over}
    loss = "lm_cross_entropy_fused" if over.get("fused_loss") else "lm_cross_entropy"
    return {"model": model, "optimizer": opt, "loss": loss, "metrics": [], "epochs": 1,
            "seed": 0, "mesh": mesh,
            "data": {"train": {"name": "synthetic_tokens", "n": 4, "seq_len": seq,
                               "vocab_size": 256, "batch_size": 2}}}


def _batches(name):
    seq = {**CASES, **PORT_ONLY}[name][3]
    rng = np.random.default_rng(sorted({**CASES, **PORT_ONLY}).index(name))
    return [{"x": rng.integers(1, 256, (2, seq)).astype(np.int64)} for _ in range(2)]


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


_JAX = {}


def _jax(name):
    """The JAX Trainer under the same mesh: initial flat weights (flax
    paths, the port's layout), losses, final weights."""
    if name not in _JAX:
        cfg = _cfg(name)
        mesh = make_mesh(MeshSpec.from_config(cfg["mesh"]), devices=jax.devices()[:WORLD])
        jt = JaxTrainer(cfg, mesh=mesh)
        init = {k: v.numpy() for k, v in
                from_flax_params(jax.tree.map(np.array, jt.state.params), fold=False).items()}
        losses = []
        for b in _batches(name):
            jt.state, stats = jt._train_step(jt.state, {"x": jnp.asarray(b["x"], jnp.int32)})
            losses.append(float(stats["loss"]))
        _JAX[name] = (init, losses, _flat(jt.state.params))
    return _JAX[name]


def _port_unsharded(name, init):
    cfg = dict(_cfg(name))
    cfg.pop("mesh")
    t = Trainer(cfg, device="cpu")
    with torch.no_grad():
        for k, p in t.state.params.items():
            p.copy_(torch.from_numpy(init[k]))
    losses = [float(t._train_step(t.state, {"x": torch.from_numpy(b["x"])})["loss"])
              for b in _batches(name)]
    return losses, {k: v.detach().numpy() for k, v in t.state.params.items()}


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    cases = []
    for name in CASES:
        init = _jax(name)[0]
        cases.append((name, "trainer", dict(cfg=_cfg(name), init=init, batches=_batches(name))))
    rng = np.random.default_rng(7)
    for name in PORT_ONLY:
        init = {k: v.detach().numpy() for k, v in
                Trainer({**_cfg(name), "mesh": None}, device="cpu").state.params.items()}
        cases.append((name, "trainer", dict(cfg=_cfg(name), init=init, batches=_batches(name))))
    # checkpoints: a sharded run's save, and an unsharded save resumed
    # under a mesh
    ck = tmp_path_factory.mktemp("ckpt")
    un = Trainer({**_cfg("fsdp2"), "mesh": None}, device="cpu")
    un._train_step(un.state, {"x": torch.from_numpy(_batches("fsdp2")[0]["x"])})
    save_checkpoint(ck / "unsharded", un.state, step=un.state.step)
    cases.append(("ckpt_sharded_save", "checkpoint", dict(
        cfg=_cfg("fsdp2"), init=_jax("fsdp2")[0], batches=_batches("fsdp2"),
        directory=str(ck / "sharded"))))
    for mesh in ({"fsdp": 2}, {"tp": 2}):
        cases.append((f"ckpt_resume_unsharded_{'_'.join(mesh)}", "restore", dict(
            cfg={**_cfg("fsdp2"), "mesh": mesh}, directory=str(ck / "unsharded"))))
    res = run_gang(WORLD, cases)
    res["_dir"] = ck
    res["_unsharded"] = un
    return res


@pytest.mark.parametrize("name", sorted(CASES))
def test_trainer_under_a_mesh_matches_the_jax_trainer(gang, name):
    _, losses, final = _jax(name)
    for r in range(WORLD):
        got = result(gang, r, name)
        assert got["step"] == 2
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-4, err_msg=f"{name} r{r}")
    got = result(gang, 0, name)
    assert set(got["params"]) == set(final)
    for k, v in final.items():
        np.testing.assert_allclose(got["params"][k], v, atol=1e-4, rtol=0, err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", sorted({**CASES, **PORT_ONLY}))
def test_trainer_under_a_mesh_matches_the_ports_unsharded_trainer(gang, name):
    got = result(gang, 0, name)
    init = _jax(name)[0] if name in CASES else None
    if init is None:
        init = {k: v.detach().numpy() for k, v in
                Trainer({**_cfg(name), "mesh": None}, device="cpu").state.params.items()}
    losses, final = _port_unsharded(name, init)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5, err_msg=name)
    # adam's normalised steps carry a gradient's last bits into the weights:
    # the JAX comparison's 1e-4 (tests/test_torch_train.py)
    for k, v in final.items():
        np.testing.assert_allclose(got["params"][k], v, atol=1e-4, rtol=0, err_msg=f"{name} {k}")


@pytest.mark.parametrize("name,axis", [("fsdp2", "fsdp"), ("tp2", "tp"), ("pp2", "pp")])
def test_each_rank_holds_only_its_shards(gang, name, axis):
    """Every leaf ``spec_for`` shards over the axis is held as a half on
    each rank; the rest whole."""
    from mlcomp_tpu_torch.parallel.sharding import spec_for

    got = result(gang, 0, name)
    halves = 0
    for k, full in got["params"].items():
        spec = spec_for(k, full.shape, _cfg(name)["mesh"])
        want = tuple(s // 2 if i < len(spec) and spec[i] == axis else s
                     for i, s in enumerate(full.shape))
        assert tuple(got["local"][k]) == want, (k, spec)
        halves += want != full.shape
    assert halves > 0


def test_a_sharded_runs_checkpoint_loads_unsharded_and_resumes_sharded(gang):
    got = result(gang, 0, "ckpt_sharded_save")
    assert got == {"step": 2, "same": True}
    assert result(gang, 1, "ckpt_sharded_save") == got
    cfg = {**_cfg("fsdp2"), "mesh": None}
    t = Trainer(cfg, device="cpu")
    restore_checkpoint(gang["_dir"] / "sharded", t.state)
    want = result(gang, 0, "fsdp2")["params"]
    assert t.state.step == 2
    for k, p in t.state.params.items():
        np.testing.assert_array_equal(p.detach().numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("mesh", ["fsdp", "tp"])
def test_an_unsharded_checkpoint_resumes_under_a_mesh(gang, mesh):
    un = gang["_unsharded"]
    for r in range(WORLD):
        got = result(gang, r, f"ckpt_resume_unsharded_{mesh}")
        assert got["step"] == un.state.step == 1
        for k, p in un.state.params.items():
            np.testing.assert_array_equal(got["params"][k], p.detach().numpy(), err_msg=k)
