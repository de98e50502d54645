"""The port's training stack against the JAX package's.

Losses, metrics, schedules, optimizers, the loader and the Trainer take
the same numpy inputs on both sides.  Tolerances: everything runs in f32
on the CPU; both sides compute the same formulas, in other orders where
a sum is involved, so values agree to ~1e-6 relative.  Losses, metrics
and learning rates are held at 1e-6 relative (1e-7 absolute), optimizer
updates at 1e-5 relative over four updates, and a 3-step training run at
1e-4 relative for the losses and 1e-4 absolute for the parameters (a
transformer's gradients pass through ~20 chained f32 products each step).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mlcomp_tpu.data.loader import DataLoader as JaxLoader
from mlcomp_tpu.parallel.mesh import MeshSpec, make_mesh
from mlcomp_tpu.train import losses as jlosses
from mlcomp_tpu.train import metrics as jmetrics
from mlcomp_tpu.train import optim as joptim
from mlcomp_tpu.train.loop import Trainer as JaxTrainer
from mlcomp_tpu_torch.data.loader import DataLoader
from mlcomp_tpu_torch.io.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from mlcomp_tpu_torch.io.weights import from_flax_params
from mlcomp_tpu_torch.train import losses, metrics, optim
from mlcomp_tpu_torch.train.loop import Trainer

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _batch_pair(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: _t(v) for k, v in batch.items()})


def _loss_inputs(name, rng):
    b = 6
    valid = np.array([1, 1, 1, 1, 0, 0], np.float32)
    if name in ("cross_entropy", "smoothed_cross_entropy"):
        logits = rng.standard_normal((b, 7), dtype=np.float32)
        y = rng.integers(0, 7, (b,)).astype(np.int32)
        y[1] = -1                                   # ignored label
        return logits, {"y": y, "valid": valid}
    if name == "cross_entropy_soft":
        logits = rng.standard_normal((b, 7), dtype=np.float32)
        y = rng.dirichlet(np.ones(7), b).astype(np.float32)
        return logits, {"y": y, "valid": valid}
    if name == "bce_with_logits":
        logits = rng.standard_normal((b, 3), dtype=np.float32)
        return logits, {"y": (rng.random((b, 3)) > 0.5).astype(np.float32), "valid": valid}
    if name in ("mse", "mae"):
        return (rng.standard_normal((b, 4), dtype=np.float32),
                {"y": rng.standard_normal((b, 4), dtype=np.float32), "valid": valid})
    if name in ("pixel_cross_entropy", "dice", "miou", "pixel_accuracy"):
        logits = rng.standard_normal((b, 5, 4, 3), dtype=np.float32)
        y = rng.integers(0, 3, (b, 5, 4)).astype(np.int32)
        y[0, 0, :2] = 255                           # void pixels
        return logits, {"y": y, "valid": valid}
    if name == "lm_cross_entropy":
        return (rng.standard_normal((b, 9, 11), dtype=np.float32),
                {"x": rng.integers(0, 11, (b, 9)).astype(np.int32), "valid": valid})
    if name in ("accuracy", "top5_accuracy"):
        logits = rng.standard_normal((b, 8), dtype=np.float32)
        y = rng.integers(0, 8, (b,)).astype(np.int32)
        y[2] = 9                                    # out of range: ignored
        return logits, {"y": y, "valid": valid}
    raise KeyError(name)


LOSS_NAMES = ["cross_entropy", "cross_entropy_soft", "smoothed_cross_entropy",
              "bce_with_logits", "mse", "pixel_cross_entropy", "lm_cross_entropy", "dice"]


@pytest.mark.parametrize("name", LOSS_NAMES)
def test_losses_match_jax(name):
    logits, batch = _loss_inputs(name, np.random.default_rng(0))
    fn_name = "cross_entropy" if name == "cross_entropy_soft" else name
    jb, tb = _batch_pair(batch)
    want = float(jlosses.LOSSES.get(fn_name)(jnp.asarray(logits), jb))
    got = float(losses.LOSSES.get(fn_name)(_t(logits), tb))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["accuracy", "top5_accuracy", "miou", "pixel_accuracy", "mae"])
def test_metrics_match_jax(name):
    logits, batch = _loss_inputs(name, np.random.default_rng(1))
    jb, tb = _batch_pair(batch)
    want = float(jmetrics.METRICS.get(name)(jnp.asarray(logits), jb))
    got = float(metrics.METRICS.get(name)(_t(logits), tb))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_fused_loss_is_refused_until_its_head_is_ported():
    # the head is ported (ops/fused_ce.py): the loss takes per-token losses
    # (B, S) as the JAX loss does, and refuses logits as it does
    fn = losses.create_loss("lm_cross_entropy_fused")
    per = np.random.default_rng(0).random((3, 9)).astype(np.float32)
    batch = {"x": np.zeros((3, 9), np.int32)}
    jb, tb = _batch_pair(batch)
    want = float(jlosses.LOSSES.get("lm_cross_entropy_fused")(jnp.asarray(per), jb))
    np.testing.assert_allclose(float(fn(_t(per), tb)), want, rtol=1e-6)
    with pytest.raises(ValueError, match="per-token losses"):
        fn(_t(np.zeros((3, 9, 5), np.float32)), tb)


SCHEDULES = [
    {"name": "constant", "lr": 0.3},
    {"name": "cosine", "lr": 0.3, "decay_steps": 7, "alpha": 0.1},
    {"name": "warmup_cosine", "lr": 3e-4, "warmup_steps": 3, "decay_steps": 10, "end_lr": 1e-5},
    {"name": "warmup_cosine", "lr": 3e-4, "warmup_steps": 3, "decay_steps": 10},
    {"name": "step", "lr": 0.5, "boundaries_and_scales": {2: 0.5, 5: 0.1}},
    {"name": "linear_warmup", "lr": 0.2, "warmup_steps": 4},
]


@pytest.mark.parametrize("cfg", SCHEDULES, ids=[f"{c['name']}{i}" for i, c in enumerate(SCHEDULES)])
def test_schedules_match_optax(cfg):
    want_fn = joptim._sched(cfg)
    got_fn = optim._sched(cfg)
    for count in range(14):
        np.testing.assert_allclose(got_fn(count), float(want_fn(jnp.int32(count))),
                                   rtol=1e-6, atol=1e-10, err_msg=f"step {count}")


OPTIMIZERS = [
    {"name": "sgd", "lr": 0.1, "momentum": 0.9},
    {"name": "sgd", "lr": 0.1, "momentum": 0.9, "nesterov": True, "grad_clip": 0.5},
    {"name": "adam", "lr": 1e-2, "grad_clip": 1.0},
    {"name": "adamw", "lr": {"name": "cosine", "lr": 1e-2, "decay_steps": 5},
     "weight_decay": 0.1},
    {"name": "adafactor", "grad_clip": 1.0,
     "lr": {"name": "warmup_cosine", "lr": 3e-2, "warmup_steps": 2, "decay_steps": 10}},
    {"name": "adafactor", "lr": 1e-2, "multiply_by_parameter_scale": False,
     "clipping_threshold": None},
]


@pytest.mark.parametrize("cfg", OPTIMIZERS, ids=[f"{c['name']}{i}" for i, c in enumerate(OPTIMIZERS)])
def test_optimizers_match_optax(cfg):
    # a 256x128 matrix and a (256, 2, 128) flax-shaped kernel (both factored
    # by Adafactor), a 64-vector (not factored); four updates, since a
    # warmup schedule makes the first update zero
    rng = np.random.default_rng(2)
    shapes = {"w": (256, 128), "k": (256, 2, 128), "b": (64,)}
    params = {k: rng.standard_normal(s, dtype=np.float32) * 0.1 for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s, dtype=np.float32) for k, s in shapes.items()}
             for _ in range(4)]
    tx = joptim.create_optimizer(cfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    ttx = optim.create_optimizer(cfg)
    tp = {k: _t(v.copy()) for k, v in params.items()}
    ts = ttx.init(tp)
    for i, g in enumerate(grads):
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, ts = ttx.update({k: _t(v) for k, v in g.items()}, ts, tp)
        optim.apply_updates(tp, tupd)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{k} after update {i + 1}")


@pytest.mark.parametrize("name", ["lamb", "lars", "rmsprop"])
def test_unported_optimizers_are_refused(name):
    # ported now: each builds with the JAX package's defaults and takes
    # optax's first step (tests/test_torch_train_recipes.py holds five)
    rng = np.random.default_rng(1)
    p = rng.standard_normal((32, 16), dtype=np.float32)
    g = rng.standard_normal((32, 16), dtype=np.float32)
    tx = joptim.create_optimizer({"name": name, "lr": 0.1})
    upd, _ = tx.update({"w": jnp.asarray(g)}, tx.init({"w": jnp.asarray(p)}),
                       {"w": jnp.asarray(p)})
    ttx = optim.create_optimizer({"name": name, "lr": 0.1})
    tp = {"w": _t(p.copy())}
    tupd, _ = ttx.update({"w": _t(g)}, ttx.init(tp), tp)
    np.testing.assert_allclose(tupd["w"].numpy(), np.asarray(upd["w"]), rtol=1e-5, atol=1e-7)


def test_loader_batches_equal_the_jax_loaders():
    rng = np.random.default_rng(3)
    data = {"x": rng.integers(0, 100, (23, 5)).astype(np.int32),
            "y": rng.integers(0, 3, (23,)).astype(np.int32)}
    for drop_last in (True, False):
        jl = JaxLoader(data, batch_size=4, shuffle=True, seed=5, drop_last=drop_last)
        tl = DataLoader(data, batch_size=4, shuffle=True, seed=5, drop_last=drop_last,
                        device="cpu")
        assert len(jl) == len(tl)
        for _ in range(2):       # two epochs: the permutation follows seed + epoch
            jb, tb = list(jl), list(tl)
            assert len(jb) == len(tb) == len(tl)
            for a, b in zip(jb, tb):
                assert sorted(a) == sorted(b)
                for k in a:
                    np.testing.assert_array_equal(np.asarray(a[k]), b[k].numpy())


def _lm_cfg(optimizer, grad_accum=1, epochs=1, n=6):
    return {
        "model": {"name": "transformer_lm", "vocab_size": 256, "hidden": 64, "layers": 2,
                  "heads": 4, "kv_heads": 2, "dtype": "float32"},
        "optimizer": optimizer, "loss": "lm_cross_entropy", "metrics": [],
        "epochs": epochs, "seed": 0, "grad_accum": grad_accum,
        "data": {"train": {"name": "synthetic_tokens", "n": n, "seq_len": 128,
                           "vocab_size": 256, "batch_size": 2}},
    }


ADAFACTOR = {"name": "adafactor", "grad_clip": 1.0,
             "lr": {"name": "warmup_cosine", "lr": 1e-2, "warmup_steps": 1, "decay_steps": 50}}
ADAMW = {"name": "adamw", "lr": 1e-3, "weight_decay": 0.01, "grad_clip": 1.0}


@pytest.mark.parametrize("optimizer,grad_accum", [(ADAFACTOR, 1), (ADAFACTOR, 2)],
                         ids=["adafactor", "adafactor_accum2"])
def test_trainer_matches_the_jax_trainer(optimizer, grad_accum):
    cfg = _lm_cfg(optimizer, grad_accum)
    jt = JaxTrainer(cfg, mesh=make_mesh(MeshSpec(), devices=jax.devices()[:1]))
    # the port's trainer starts from the JAX trainer's init
    tt = Trainer(cfg, device="cpu")
    init = from_flax_params(jax.tree.map(np.array, jt.state.params), fold=False)
    with torch.no_grad():
        for k, p in tt.state.params.items():
            p.copy_(init[k])
    rng = np.random.default_rng(4)
    for step in range(3):
        x = rng.integers(1, 256, (2, 128)).astype(np.int32)
        jt.state, jstats = jt._train_step(jt.state, {"x": jnp.asarray(x)})
        tstats = tt._train_step(tt.state, {"x": _t(x)})
        np.testing.assert_allclose(float(tstats["loss"]), float(jstats["loss"]), rtol=1e-4,
                                   err_msg=f"loss at step {step}")
    assert tt.state.step == int(jt.state.step) == 3
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(jt.state.params)}
    got = tt.model.flax_params()
    assert set(got) == set(flat)
    for k, v in flat.items():
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_allclose(got[k].detach().numpy(), v, atol=1e-4, rtol=0, err_msg=k)


def test_fit_resumes_after_a_checkpoint(tmp_path):
    cfg = _lm_cfg(ADAMW, epochs=1, n=4)
    first = Trainer(cfg, device="cpu")
    first.fit()
    assert first.state.step == first.steps_per_epoch == 2
    save_checkpoint(tmp_path, first.state, step=first.state.step)
    assert latest_step(tmp_path) == 2

    second = Trainer({**cfg, "epochs": 3}, device="cpu")
    restore_checkpoint(tmp_path, second.state)
    assert second.state.step == 2 and second.epochs_done == 1
    for k, p in second.state.params.items():
        assert torch.equal(p, first.state.params[k])
    seen = []
    last = second.fit(on_epoch=lambda epoch, stats: seen.append(epoch))
    assert seen == [1, 2]                           # only the remaining epochs
    assert second.state.step == 6 and np.isfinite(last["train/loss"])


def test_ema_tracks_and_eval_uses_it():
    cfg = {**_lm_cfg(ADAMW, n=4), "ema": 0.5,
           "data": {"train": {"name": "synthetic_tokens", "n": 4, "seq_len": 128,
                              "vocab_size": 256, "batch_size": 2},
                    "valid": {"name": "synthetic_tokens", "n": 2, "seq_len": 128,
                              "vocab_size": 256, "batch_size": 2, "seed": 1}}}
    t = Trainer(cfg, device="cpu")
    before = {k: p.detach().clone() for k, p in t.state.params.items()}
    t._train_step(t.state, {"x": _t(np.random.default_rng(9).integers(1, 256, (2, 128)))})
    for k, e in t.state.ema_params.items():
        torch.testing.assert_close(e, 0.5 * before[k] + 0.5 * t.state.params[k])
    live = {k: p.detach().clone() for k, p in t.state.params.items()}
    stats = t.eval_epoch("valid")
    assert np.isfinite(stats["loss"])
    for k, p in t.state.params.items():           # eval swaps the EMA in and back out
        assert torch.equal(p, live[k])


@pytest.mark.parametrize("key,value", [("mesh", {"dp": 8}), ("profile", {"dir": "x"}),
                                       ("mixup", 0.2), ("augment", {"flip": True})])
def test_unported_trainer_options_are_refused(key, value):
    """``mesh`` is ported: a process alone (no process group) is one
    device, so a mesh of 8 is refused as the JAX ``MeshSpec.resolve``
    refuses a mesh larger than its devices (ValueError; the gloo gangs of
    tests/test_torch_parallel_*.py run the meshes).  ``profile`` is: the
    Trainer builds the JAX Trainer's profiler window from it (the capture
    itself is held in tests/test_torch_devprof.py).  ``augment`` and
    ``mixup`` are, and on this LM config each is refused as the JAX
    Trainer refuses it: a typo'd augment op when the Trainer is built,
    mixup of token ids at the first step (ValueError)."""
    cfg = {**_lm_cfg(ADAMW), key: value}
    if key == "mesh":
        with pytest.raises(ValueError, match="needs 8 devices but 1 available"):
            Trainer(cfg, device="cpu")
    elif key == "profile":
        from mlcomp_tpu.utils.profile import create_profiler as j_create_profiler

        want = j_create_profiler(value)
        prof = Trainer(cfg, device="cpu").profiler
        assert (prof.dir, prof.start_step, prof.stop_step) == (
            want.dir, want.start_step, want.stop_step)
        assert not prof.active and not prof.done
    elif key == "augment":
        with pytest.raises(ValueError, match="unknown ops"):
            Trainer(cfg, device="cpu")
    else:
        t = Trainer(cfg, device="cpu")
        ids = _t(np.random.default_rng(9).integers(1, 256, (2, 128)))
        with pytest.raises(ValueError, match="mixup blends float inputs"):
            t._train_step(t.state, {"x": ids, "y": ids})
