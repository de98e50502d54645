"""Train -> serve in the port, on the CPU: the weights-only checkpoint
readers (``io/checkpoint.py``: ``read_weights``, ``restore_eval_state``,
``average_checkpoints``), the ``valid``, ``infer`` and ``generate``
executors (``executors/infer.py``), ``configs/generate_lm.yml`` and
``configs/generate_quant.yml`` cut small through the port's ``cli dag``,
and ``serve``'s checkpoint sources (a checkpoint directory, ``--storage-task``,
the ``average`` command).

Held against the JAX package on one weight set (``io.weights.init_params``,
f32): the generate executor's greedy ids equal the JAX executor's on the
same weights, and ``average_checkpoints`` equals the JAX function's on the
same checkpoints; a served checkpoint directory gives the tokens of the
same params served from ``.npz``.
"""

import json
import os
import subprocess
import sys
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
    latest_step,
    read_weights,
    restore_eval_state,
    save_checkpoint,
)
from mlcomp_tpu_torch.io.weights import init_params, save_npz
from mlcomp_tpu_torch.serve import load_service, resolve_storage_ckpt
from mlcomp_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)
load_all()

REPO = Path(__file__).resolve().parents[1]
MODEL = {"name": "transformer_lm", "vocab_size": 64, "hidden": 64, "layers": 2, "heads": 2,
         "mlp_dim": 128, "dtype": "float32"}
TREE = init_params(MODEL, seed=0)
CFG = {"model": MODEL, "optimizer": {"name": "adamw", "lr": 3e-4}, "loss": "lm_cross_entropy",
       "metrics": [],
       # batches of 8: the JAX Trainer shards them over the test run's 8
       # host devices
       "data": {"infer": {"name": "synthetic_tokens", "n": 8, "seq_len": 8, "vocab_size": 64,
                          "batch_size": 8},
                "valid": {"name": "synthetic_tokens", "n": 8, "seq_len": 8, "vocab_size": 64,
                          "batch_size": 8, "seed": 1}}}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def _scaled(tree, f):
    return {k: (_scaled(v, f) if isinstance(v, dict) else (v * f).astype(np.float32))
            for k, v in tree.items()}


def _port_ckpt(directory, tree, step, ema_tree=None, cfg=CFG):
    """A port checkpoint of a Trainer whose weights are ``tree`` (and its
    EMA ``ema_tree``)."""
    tr = Trainer({**cfg, **({"ema": 0.9} if ema_tree is not None else {})}, device="cpu")
    with torch.no_grad():
        for k, v in _flat(tree):
            tr.state.params[k].copy_(torch.from_numpy(v))
        if ema_tree is not None:
            for k, v in _flat(ema_tree):
                tr.state.ema_params[k].copy_(torch.from_numpy(v))
    tr.state.step = step
    return save_checkpoint(directory, tr.state, step=step)


def _jax_ckpt(directory, tree, step):
    from mlcomp_tpu.io.checkpoint import save_checkpoint as j_save
    from mlcomp_tpu.train.loop import Trainer as JTrainer

    tr = JTrainer(dict(CFG))
    state = tr.state.replace(params=jax.tree.map(jnp.asarray, tree),
                             step=jnp.asarray(step, tr.state.step.dtype))
    return j_save(directory, state, step=step)


def _ctx(tmp_path, args, name="sample"):
    return ExecutionContext(dag_id=1, task_id=1, task_name=name, args=args,
                            workdir=str(tmp_path), device="cpu")


# ------------------------------------------------------------ checkpoints


def test_read_weights_prefers_ema_and_restore_eval_state_takes_them(tmp_path):
    ema = _scaled(TREE, 0.5)
    _port_ckpt(tmp_path / "ck", TREE, 7, ema_tree=ema)
    w = read_weights(tmp_path / "ck")
    assert w["step"] == 7 and w["model_state"] == {}
    np.testing.assert_array_equal(w["params"]["DecoderLayer_1"]["attn"]["q"]["kernel"].numpy(),
                                  ema["DecoderLayer_1"]["attn"]["q"]["kernel"])
    tr = Trainer({**CFG, "ema": 0.9}, device="cpu")
    restore_eval_state(tmp_path / "ck", tr.state)
    assert tr.state.step == 7 and tr.state.ema_params is None
    for k, v in _flat(ema):
        np.testing.assert_array_equal(tr.state.params[k].detach().numpy(), v)
    with pytest.raises(FileNotFoundError):
        read_weights(tmp_path / "none")


def test_average_checkpoints_equals_the_jax_function(tmp_path):
    """Three checkpoints (the last at an explicit step), weights 1, 2, 1:
    the port's average of its checkpoints equals the JAX function's average
    of the same trees, leaf for leaf, at the largest step."""
    from mlcomp_tpu.io.checkpoint import average_checkpoints as j_average
    from mlcomp_tpu.io.checkpoint import read_weights as j_read

    trees = [init_params(MODEL, seed=s) for s in (1, 2, 3)]
    steps = (4, 9, 6)
    for i, (t, st) in enumerate(zip(trees, steps)):
        _port_ckpt(tmp_path / f"p{i}", t, st)
        _jax_ckpt(tmp_path / f"j{i}", t, st)
    srcs = [str(tmp_path / "p0"), str(tmp_path / "p1"), f"{tmp_path / 'p2'}:6"]
    out = average_checkpoints(srcs, tmp_path / "pavg", weights=[1, 2, 1])
    j_average([str(tmp_path / "j0"), str(tmp_path / "j1"), f"{tmp_path / 'j2'}:6"],
              tmp_path / "javg", weights=[1, 2, 1])
    got, want = read_weights(tmp_path / "pavg"), j_read(tmp_path / "javg")
    assert out.endswith("/9") and got["step"] == want["step"] == 9
    want_flat = dict(_flat(jax.tree.map(np.asarray, want["params"])))
    got_flat = {k: v.numpy() for k, v in _flat(got["params"])}
    assert set(got_flat) == set(want_flat)
    for k in want_flat:
        assert got_flat[k].dtype == np.float32
        np.testing.assert_array_equal(got_flat[k], want_flat[k], err_msg=k)
    with pytest.raises(ValueError, match=">= 2"):
        average_checkpoints(srcs[:1], tmp_path / "x")
    with pytest.raises(ValueError, match="weights"):
        average_checkpoints(srcs, tmp_path / "x", weights=[1, 2])


def test_the_average_command(tmp_path):
    for i, t in enumerate((TREE, _scaled(TREE, 3.0))):
        _port_ckpt(tmp_path / f"c{i}", t, 2 + i)
    out = subprocess.run(
        [sys.executable, "-m", "mlcomp_tpu_torch.cli", "average", str(tmp_path / "c0"),
         str(tmp_path / "c1"), "--out", str(tmp_path / "avg")],
        capture_output=True, text=True, env={**os.environ, "PYTHONPATH": str(REPO)},
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["averaged"] == 2
    w = read_weights(tmp_path / "avg")
    assert w["step"] == 3
    np.testing.assert_allclose(w["params"]["lm_head"]["kernel"].numpy(),
                               TREE["lm_head"]["kernel"] * 2.0, rtol=1e-6)


# -------------------------------------------------------------- executors


def test_generate_executor_equals_the_jax_executor(tmp_path):
    """Greedy generation from a checkpoint of the same weights, through each
    package's ``generate`` executor: the same ids, prompts included."""
    from mlcomp_tpu.executors.base import ExecutionContext as JCtx
    from mlcomp_tpu.executors.infer import GenerateExecutor as JGenerate

    _port_ckpt(tmp_path / "pck", TREE, 5)
    _jax_ckpt(tmp_path / "jck", TREE, 5)
    args = {**CFG, "max_new_tokens": 6, "temperature": 0.0}
    res = create_executor("generate", {**args, "ckpt_dir": str(tmp_path / "pck"),
                                       "out": str(tmp_path / "p.npz")})(_ctx(tmp_path, {}))
    JGenerate(**{**args, "ckpt_dir": str(tmp_path / "jck"), "out": str(tmp_path / "j.npz")})(
        JCtx(dag_id=1, task_id=1, task_name="sample", args={}, workdir=str(tmp_path)))
    got = np.load(tmp_path / "p.npz")["ids"]
    want = np.load(tmp_path / "j.npz")["ids"]
    assert res["n"] == 8 and got.shape == (8, 14)
    np.testing.assert_array_equal(got, want)


def test_valid_and_infer_executors_restore_the_checkpoint(tmp_path):
    """``valid`` and ``infer`` on a checkpoint of the same weights, through
    each package's executor: the port's ``valid/loss`` equals the JAX
    executor's within 1e-5 relative (an empty ``report: {layout: []}`` is
    logged as rejected, as the JAX executor's ``publish_layout`` logs it,
    and the task goes on), and its ``preds`` equal the JAX executor's within
    1e-5.  The weights are not a fresh init's, so a restore that missed
    would show."""
    from types import SimpleNamespace

    from mlcomp_tpu.executors.base import ExecutionContext as JCtx
    from mlcomp_tpu.executors.infer import InferExecutor as JInfer
    from mlcomp_tpu.executors.infer import ValidExecutor as JValid
    from mlcomp_tpu.report.artifacts import publish_layout as j_publish_layout

    tree = init_params(MODEL, seed=4)
    _port_ckpt(tmp_path / "pck", tree, 3)
    _jax_ckpt(tmp_path / "jck", tree, 3)
    logs, metrics = [], {}

    class Ctx(ExecutionContext):
        def log(self, message, level="info"):
            logs.append((level, message))

        def metric(self, name, value, step=0):
            metrics[name] = value

    def jctx(name):
        return JCtx(dag_id=1, task_id=1, task_name=name, args={}, workdir=str(tmp_path))

    stats = create_executor("valid", {**CFG, "ckpt_dir": str(tmp_path / "pck"),
                                      "report": {"layout": []}})(
        Ctx(dag_id=1, task_id=1, task_name="v", args={}, workdir=str(tmp_path), device="cpu"))
    want = JValid(**{**CFG, "ckpt_dir": str(tmp_path / "jck")})(jctx("v"))
    assert set(stats) == set(want) == {"loss"} and metrics == {"valid/loss": stats["loss"]}
    assert stats["loss"] == pytest.approx(want["loss"], rel=1e-5)
    jlogs = []
    j_publish_layout(SimpleNamespace(report=None, log=lambda m, level="info": jlogs.append(
        (level, m))), {"layout": []})
    assert jlogs and jlogs[0][0] == "error" and jlogs[0] in logs
    assert any("restored checkpoint" in m for _, m in logs)

    res = create_executor("infer", {**CFG, "ckpt_dir": str(tmp_path / "pck"),
                                    "out": str(tmp_path / "p.npz")})(
        _ctx(tmp_path, {}, name="inf"))
    jres = JInfer(**{**CFG, "ckpt_dir": str(tmp_path / "jck"),
                     "out": str(tmp_path / "j.npz")})(jctx("inf"))
    got, want_preds = np.load(res["preds"]), np.load(jres["preds"])
    assert set(got.files) == set(want_preds.files) and res["n"] == jres["n"] == 8
    assert got["preds"].shape == want_preds["preds"].shape == (8, 8, 64)
    np.testing.assert_allclose(got["preds"], want_preds["preds"], rtol=1e-5, atol=1e-5)
    if "labels" in want_preds.files:
        np.testing.assert_array_equal(got["labels"], want_preds["labels"])


def _cut(config: str, tmp_path: Path) -> Path:
    """``configs/<config>`` cut to a CPU test's size: the same executors,
    edges, losses, optimizers and decode knobs (quantize, kv_quant,
    sampling), narrow widths, a few rows, the checkpoints under tmp."""
    doc = yaml.safe_load((REPO / "configs" / config).read_text())
    small = {"vocab_size": 128, "hidden": 128, "layers": 1, "heads": 2}
    for ex in doc["executors"].values():
        a = ex["args"]
        a["model"] = {**a["model"], **small}
        if "kv_heads" in a["model"]:
            a["model"]["kv_heads"] = 1
        for split in a["data"].values():
            split.update(n=4, seq_len=16, vocab_size=128, batch_size=2)
        a["storage_root"] = str(tmp_path / "storage")
        if "max_new_tokens" in a:
            a["max_new_tokens"] = 4
        ex.pop("resources", None)
    out = tmp_path / config
    out.write_text(yaml.safe_dump(doc))
    return out, doc


@pytest.mark.parametrize("config", ["generate_lm.yml", "generate_quant.yml"])
def test_generate_configs_run_through_cli_dag(tmp_path, config):
    """Train, then generate from the train task's checkpoint (found
    through the dependency edge), through the port's ``cli dag`` on the
    CPU; then serve the train task's checkpoints by ``--storage-task``."""
    path, doc = _cut(config, tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "mlcomp_tpu_torch.cli", "dag", str(path), "--db",
         str(tmp_path / "db.sqlite"), "--workdir", str(tmp_path), "--device", "cpu"],
        capture_output=True, text=True, env={**os.environ, "PYTHONPATH": str(REPO)},
        cwd=str(tmp_path), timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert json.loads(out.stdout) == {"train": "success", "sample": "success"}
    ids = np.load(tmp_path / "sample_gen.npz")["ids"]
    assert ids.shape == (4, 20) and ids.min() >= 0 and ids.max() < 128
    dag_name = config.split(".")[0]
    os.environ["MLCOMP_TPU_STORAGE"] = str(tmp_path / "storage")
    try:
        ckpt = resolve_storage_ckpt("lm", dag_name, "train")
    finally:
        del os.environ["MLCOMP_TPU_STORAGE"]
    # 2 steps an epoch (4 rows, batches of 2)
    assert latest_step(ckpt) == 2 * doc["executors"]["train"]["args"]["epochs"]
    with pytest.raises(FileNotFoundError):
        resolve_storage_ckpt("lm", dag_name, "nothing")


@pytest.mark.parametrize("quantize", [False, "kernel"])
def test_a_served_checkpoint_directory_equals_npz_serving(tmp_path, quantize):
    """``serve --ckpt DIR``: the checkpoint's weights (EMA preferred) give
    the greedy tokens of the same params served from ``.npz``."""
    ema = _scaled(TREE, 0.9)
    _port_ckpt(tmp_path / "ck", _scaled(TREE, 2.0), 4, ema_tree=ema)
    save_npz(str(tmp_path / "w.npz"), ema)
    model_cfg = {**MODEL, "kv_quant": True}
    kw = dict(batch_sizes=(1, 2), prompt_buckets=(16,), max_new_buckets=(6,),
              quantize=quantize, device="cpu", metrics_history_interval=0)
    prompts = [[5, 9, 11, 3], list(range(1, 14))]
    got = []
    for src in (tmp_path / "ck", tmp_path / "w.npz"):
        svc = load_service(model_cfg, ckpt_path=str(src), **kw)
        try:
            got.append([svc.generate(p, 6)["ids"] for p in prompts])
        finally:
            svc.close()
    assert got[0] == got[1] and all(len(i) == 6 for i in got[0])
