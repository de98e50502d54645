"""The zoo's DAGs and its train -> valid path, port against JAX package.

- ``configs/mnist.yml`` and ``configs/grid_search.yml``, cut small (the
  same executors, edges, grid, models, losses and optimizers; a few rows),
  end in the same task statuses through both packages' ``run_dag_local``.
- On the same weights, the ``valid`` executor's stored classification
  report (``mnist_cnn``) and segmentation report (``unet``) equal the JAX
  executor's within 1e-5 (scores and rates; counts exactly).
- A ResNet checkpoint carries its BatchNorm statistics (``model_state``):
  they survive save -> restore and train -> valid, and
  ``average_checkpoints`` averages them as the JAX function does.

Batches are multiples of 8: the JAX Trainer shards them over the test
run's 8 host devices.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mlcomp_tpu_torch.executors import load_all
from mlcomp_tpu_torch.executors.base import ExecutionContext, create_executor
from mlcomp_tpu_torch.io.checkpoint import (
    average_checkpoints,
    read_weights,
    restore_checkpoint,
    restore_eval_state,
    save_checkpoint,
)
from mlcomp_tpu_torch.io.weights import flatten, init_variables
from mlcomp_tpu_torch.scheduler.local import run_dag_local
from mlcomp_tpu_torch.train.loop import Trainer

torch.set_num_threads(2)
load_all()

REPO = Path(__file__).resolve().parents[1]


def _cut(config, tmp_path, model=None):
    doc = yaml.safe_load((REPO / "configs" / config).read_text())
    for ex in doc["executors"].values():
        a = ex.get("args") or {}
        if model:
            a["model"] = {**a["model"], **model}
        for split in (a.get("data") or {}).values():
            split.update(n=16, batch_size=8)
        if "epochs" in a:
            a["epochs"] = 1
        if "dag_name" in a:
            a["storage_root"] = str(tmp_path / "storage")
    out = tmp_path / config
    out.write_text(yaml.safe_dump(doc))
    return out


@pytest.mark.parametrize("config,model", [
    ("mnist.yml", {"features": [4], "dense": 8}),
    ("grid_search.yml", None),
])
def test_the_baseline_dag_ends_as_the_jax_dag(config, model, tmp_path):
    from mlcomp_tpu.scheduler.local import run_dag_local as j_run

    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    got = run_dag_local(str(_cut(config, tmp_path / "p", model)),
                        db_path=str(tmp_path / "p.sqlite"), workdir=str(tmp_path / "p"),
                        device="cpu")
    want = j_run(str(_cut(config, tmp_path / "j", model)), db_path=str(tmp_path / "j.sqlite"),
                 workdir=str(tmp_path / "j"))
    assert {k: str(v) for k, v in got.items()} == {k: str(v) for k, v in want.items()}
    assert set(got) == set(yaml.safe_load((REPO / "configs" / config).read_text())[
        "executors"]) or len(got) == 7                    # grid_search: 6 train tasks + noop
    assert all(getattr(v, "value", v) == "success" for v in got.values())


# ------------------------------------------------------------------ reports

def _jax_ckpt(directory, params, model_state, step):
    """A JAX checkpoint (the JAX TrainState's tree) of these weights."""
    import optax

    from mlcomp_tpu.io.checkpoint import save_checkpoint as j_save
    from mlcomp_tpu.train.state import TrainState as JState

    state = JState.create(None, jax.tree.map(jnp.asarray, params), optax.sgd(0.1),
                          jax.tree.map(jnp.asarray, model_state))
    return j_save(directory, state.replace(step=jnp.asarray(step, jnp.int32)), step=step)


def _port_ckpt(directory, cfg, params, model_state, step):
    pt = Trainer(dict(cfg), device="cpu")
    with torch.no_grad():
        for k, v in flatten(params).items():
            pt.state.params[k].copy_(torch.from_numpy(np.array(v)))
        for k, v in flatten(model_state).items():
            pt.state.model_state[k].copy_(torch.from_numpy(np.array(v)))
    pt.state.step = step
    return save_checkpoint(directory, pt.state, step=step)


def _same_weight_checkpoints(cfg, tmp_path, sample_shape):
    """A JAX and a port checkpoint of one weight set (drawn by the port's
    ``init_variables``, the flax tree's paths and shapes)."""
    params, ms = init_variables(cfg["model"], seed=5, sample_shape=sample_shape)
    _jax_ckpt(tmp_path / "jck", params, ms, 1)
    _port_ckpt(tmp_path / "pck", cfg, params, ms, 1)


def _reports(cfg, tmp_path, report, sample_shape):
    from mlcomp_tpu.executors.base import ExecutionContext as JCtx
    from mlcomp_tpu.executors.infer import ValidExecutor as JValid

    _same_weight_checkpoints(cfg, tmp_path, sample_shape)
    got, want = {}, {}

    class Ctx(ExecutionContext):
        def report(self, name, payload):
            got[name] = payload

    class JC(JCtx):
        def report(self, name, payload):
            want[name] = payload

    stats = create_executor("valid", {**cfg, "ckpt_dir": str(tmp_path / "pck"),
                                      "report": report})(
        Ctx(dag_id=1, task_id=1, task_name="v", args={}, workdir=str(tmp_path), device="cpu"))
    j_stats = JValid(**{**cfg, "ckpt_dir": str(tmp_path / "jck"), "report": report})(
        JC(dag_id=1, task_id=1, task_name="v", args={}, workdir=str(tmp_path)))
    assert set(stats) == set(j_stats)
    for k in stats:
        assert stats[k] == pytest.approx(j_stats[k], rel=1e-5, abs=1e-6)
    assert set(got) == set(want) and got
    return got, want


def _close(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), path
        for k in b:
            _close(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, (list, tuple)) and b and not isinstance(b[0], (int, float, type(None))):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(b, (float, int, list, tuple, np.ndarray)) and not isinstance(b, bool) and \
            not (isinstance(b, (list, tuple)) and not b):
        np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                                   np.asarray(b, dtype=np.float64), rtol=1e-5, atol=1e-5,
                                   err_msg=path)
    else:
        assert a == b, path


def test_the_classification_report_equals_the_jax_report(tmp_path):
    data = {"name": "synth_mnist", "n": 24, "batch_size": 8, "seed": 1}
    cfg = {"model": {"name": "mnist_cnn", "features": [4], "dense": 8},
           "loss": "cross_entropy", "metrics": ["accuracy"], "data": {"valid": data}}
    got, want = _reports(cfg, tmp_path, "classification", (1, 28, 28, 1))
    _close(got, want)
    assert got["v_classification"]["n"] == 24


def test_the_segmentation_report_equals_the_jax_report(tmp_path):
    data = {"name": "synthetic_segmentation", "n": 8, "height": 16, "width": 16,
            "num_classes": 4, "batch_size": 8, "seed": 1}
    cfg = {"model": {"name": "unet", "features": [8, 16], "num_classes": 4, "dtype": "float32"},
           "loss": "pixel_cross_entropy", "metrics": ["miou", "pixel_accuracy"],
           "data": {"valid": data}}
    got, want = _reports(cfg, tmp_path, {"kind": "segmentation"}, (1, 16, 16, 3))
    _close(got, want)


# ------------------------------------------------- checkpoints with statistics

RESNET = {"model": {"name": "resnet18", "width": 8, "num_classes": 10, "dtype": "float32"},
          "optimizer": {"name": "sgd", "lr": 0.1, "momentum": 0.9}, "metrics": [],
          "data": {"train": {"name": "synthetic_images", "height": 32, "width": 32,
                             "num_classes": 10, "n": 8, "batch_size": 8},
                   "valid": {"name": "synthetic_images", "height": 32, "width": 32,
                             "num_classes": 10, "n": 8, "batch_size": 8, "seed": 1}}}


def test_batch_stats_survive_save_restore_and_train_to_valid(tmp_path):
    tr = Trainer(dict(RESNET), device="cpu")
    tr.fit()
    stats = {k: v.clone() for k, v in tr.state.model_state.items()}
    assert stats and any((v != 0).any() for k, v in stats.items() if k.endswith("/mean"))
    save_checkpoint(tmp_path / "ck", tr.state, step=tr.state.step)
    back = restore_checkpoint(tmp_path / "ck", Trainer(dict(RESNET), device="cpu").state)
    ev = restore_eval_state(tmp_path / "ck", Trainer(dict(RESNET), device="cpu").state)
    for state in (back, ev):
        for k, v in stats.items():
            assert torch.equal(state.model_state[k], v), k
            # the model reads the restored statistics (the same tensors)
            assert state.model_state[k] is state.model.batch_stats[k[len("batch_stats/"):]]
    w = read_weights(tmp_path / "ck")
    assert set(w["model_state"]) == {"batch_stats"}
    assert set(flatten(w["model_state"]["batch_stats"])) == {
        k[len("batch_stats/"):] for k in stats}
    # eval mode reads them: the restored model's valid loss equals the trainer's
    assert ev.model is not tr.model
    assert Trainer.eval_epoch.__name__ == "eval_epoch"
    a = tr.eval_epoch("valid")["loss"]
    t2 = Trainer(dict(RESNET), device="cpu")
    restore_eval_state(tmp_path / "ck", t2.state)
    assert t2.eval_epoch("valid")["loss"] == pytest.approx(a, rel=1e-6)


def test_average_checkpoints_averages_batch_stats_as_the_jax_function(tmp_path):
    from mlcomp_tpu.io.checkpoint import average_checkpoints as j_average
    from mlcomp_tpu.io.checkpoint import read_weights as j_read

    params0, ms0 = init_variables(RESNET["model"], seed=6, sample_shape=(1, 32, 32, 3))
    for i, (f, step) in enumerate(((1.0, 3), (3.0, 5))):
        params = jax.tree.map(lambda a: a * np.float32(f), params0)
        ms = jax.tree.map(lambda a: a + np.float32(f), ms0)
        _jax_ckpt(tmp_path / f"j{i}", params, ms, step)
        _port_ckpt(tmp_path / f"p{i}", RESNET, params, ms, step)
    average_checkpoints([str(tmp_path / "p0"), str(tmp_path / "p1")], tmp_path / "pavg",
                        weights=[1, 3])
    j_average([str(tmp_path / "j0"), str(tmp_path / "j1")], tmp_path / "javg", weights=[1, 3])
    got, want = read_weights(tmp_path / "pavg"), j_read(tmp_path / "javg")
    assert got["step"] == want["step"] == 5
    for part in ("params", "model_state"):
        g = {k: v.numpy() for k, v in flatten(got[part]).items()}
        w = flatten(jax.tree.map(np.asarray, dict(want[part])))
        assert set(g) == set(w) and g, part
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    t = Trainer(dict(RESNET), device="cpu")
    restore_eval_state(tmp_path / "pavg", t.state)
    for k, v in flatten(jax.tree.map(np.asarray, dict(want["model_state"]))).items():
        np.testing.assert_array_equal(t.state.model_state[k].numpy(), v)
