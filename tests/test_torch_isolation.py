"""The port stands alone: ``mlcomp_tpu_torch`` imports neither JAX, flax,
optax, orbax, ml_dtypes nor anything of ``mlcomp_tpu``; chip_smoke.py
refuses to run without a card."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "mlcomp_tpu_torch"

torch.set_num_threads(1)


def _modules():
    return sorted(
        "mlcomp_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py"
    )


def test_the_module_walk_covers_the_kvpool_copies():
    mods = _modules()
    for name in ("allocator", "pool", "layout", "attn", "transfer"):
        assert f"mlcomp_tpu_torch.kvpool.{name}" in mods


def test_the_module_walk_covers_the_training_slice():
    mods = set(_modules())
    for name in ("train.loop", "train.optim", "train.losses", "train.metrics", "train.state",
                 "data.loader", "data.datasets", "io.checkpoint", "io.storage", "io.sync",
                 "dag.parser", "dag.graph", "dag.schema", "db.store", "scheduler.worker",
                 "scheduler.child", "scheduler.local", "scheduler.supervisor",
                 "executors.base", "executors.basic", "executors.train", "utils.trace",
                 "utils.config", "utils.faults", "utils.preempt", "obs.metrics"):
        assert f"mlcomp_tpu_torch.{name}" in mods, name


def test_the_module_walk_covers_the_prefix_cache_and_obs_modules():
    mods = set(_modules())
    for name in ("cache.kv_store", "cache.prefix_index", "cache.prefix_key", "obs.history",
                 "obs.slo", "obs.metrics"):
        assert f"mlcomp_tpu_torch.{name}" in mods, name


def test_the_module_walk_covers_the_control_plane():
    mods = set(_modules())
    for name in ("scheduler.pool", "report.server", "report.artifacts", "fleet.registry",
                 "fleet.manager", "fleet.router", "fleet.autoscale", "executors.serve"):
        assert f"mlcomp_tpu_torch.{name}" in mods, name


def test_the_module_walk_covers_the_model_zoo():
    mods = set(_modules())
    for name in ("models.zoo", "models.mlp", "models.cnn", "models.resnet", "models.unet",
                 "models.bert", "models.vit", "data.augment", "executors.infer",
                 "io.weights", "io.checkpoint", "train.state", "train.loop"):
        assert f"mlcomp_tpu_torch.{name}" in mods, name


def test_no_port_source_spawns_the_jax_cli():
    """The copies of the pool and the fleet manager launch the port's CLI;
    the reference's launch lines name its own."""
    for path in list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        text = path.read_text()
        assert "mlcomp_tpu.cli" not in text, path.relative_to(REPO)
    assert "mlcomp_tpu_torch.cli worker" in (PORT / "scheduler" / "pool.py").read_text()
    assert '"mlcomp_tpu_torch.cli", "serve"' in (PORT / "fleet" / "manager.py").read_text()


def test_import_leaves_jax_out_of_the_process():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax',"
        " 'optax', 'orbax', 'ml_dtypes', 'mlcomp_tpu'))\n"
        "print(','.join(bad))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(REPO), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"the port pulled in: {out.stdout.strip()}"


@pytest.mark.parametrize("module", ["mlcomp_tpu_torch.engine", "mlcomp_tpu_torch.dispatch_control",
                                    "mlcomp_tpu_torch.kvpool", "mlcomp_tpu_torch.kvpool.transfer",
                                    "mlcomp_tpu_torch.train.loop",
                                    "mlcomp_tpu_torch.scheduler.local",
                                    "mlcomp_tpu_torch.executors.train"])
def test_engine_modules_alone_leave_jax_out(module):
    code = (
        f"import sys, {module}\n"
        "print(','.join(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib',"
        " 'flax', 'optax', 'orbax', 'ml_dtypes', 'mlcomp_tpu'))))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(REPO), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"{module} pulled in: {out.stdout.strip()}"


def test_no_jax_or_mlcomp_tpu_imports_in_the_source():
    for path in list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "flax", "mlcomp_tpu", "optax", "orbax",
                                    "ml_dtypes"), (
                    f"{path.relative_to(REPO)}:{node.lineno} imports {name}")


def test_kernel_sources_are_in_the_package():
    from mlcomp_tpu_torch.ops.cuda import build

    stems = {p.stem for p in build._sources()}
    assert {"quant_matmul", "decode_attention", "flash_attention", "flash_attention_bwd",
            "page_gather"} <= stems
    for src in build._sources():
        head = src.read_text().split("#include")[0]
        # each source says what it replaces, what bounds it, and its design
        assert "Replaces" in head and "bounds it" in head and "design" in head.lower()
    # the build key changes with the sources and lives under the package
    assert build.build_dir().parent == PORT / "_build"


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        return
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
