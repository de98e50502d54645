"""The serving front under a mesh: ``load_service(mesh_cfg=, dist=)`` on a
gloo gang of two processes (``tests/torch_gang.py``), held against the JAX
package's unsharded ``load_service`` on the same weights (the counterparts
of tests/test_serve.py's sharded cases), the service's validations with
the JAX words, and ``cli serve --mesh tp=2 --distributed`` as two
processes over HTTP.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mlcomp_tpu.serve import load_service as j_load_service
from mlcomp_tpu_torch.io.weights import init_params, save_npz
from mlcomp_tpu_torch.models import create_model
from mlcomp_tpu_torch.serve import GenerationService, load_service
from torch_gang import free_port, result, run_gang

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
WORLD = 2
PROMPT = [3, 14, 15, 9, 2]
# tests/test_serve.py's tiny f32 model, and its quantized case's widths: every
# tp-sharded dim stays lane-tileable a rank (heads * dh 256 -> 128, mlp 512 ->
# 256, vocab 256 -> 128)
CFG = {"name": "transformer_lm", "vocab_size": 64, "hidden": 32, "layers": 1, "heads": 2,
       "mlp_dim": 64, "dtype": "float32"}
QCFG = {"name": "transformer_lm", "vocab_size": 256, "hidden": 256, "layers": 2, "heads": 4,
        "mlp_dim": 512, "dtype": "float32", "kv_quant": True}
# tests/test_serve.py's moe_lm: 4 experts, every second layer routed
MOE_CFG = {"name": "moe_lm", "vocab_size": 64, "hidden": 32, "layers": 2, "heads": 2,
           "n_experts": 4, "moe_every": 2, "dtype": "float32"}
KW = dict(batch_sizes=(4,), prompt_buckets=(8,), max_new_buckets=(4,))
QKW = dict(KW, quantize="kernel")
SERVICES = {"tp2": (CFG, {"tp": 2}, KW), "dp2": (CFG, {"dp": 2}, KW),
            "kernel_tp2": (QCFG, {"tp": 2}, QKW), "moe_ep2": (MOE_CFG, {"dp": 1, "ep": 2}, KW)}


def _np_tree(tree):
    if hasattr(tree, "items"):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.array(tree)


_JAX = {}


def _jax(cfg, kw):
    """JAX ``load_service``'s unsharded greedy ids and its float weights."""
    key = json.dumps([cfg, {k: v for k, v in kw.items()}], sort_keys=True, default=list)
    if key not in _JAX:
        svc = j_load_service(dict(cfg), **kw)
        try:
            ids = svc.generate(PROMPT, max_new_tokens=4)["ids"]
            params = svc.variables["params"]
            if kw.get("quantize"):
                # the service holds its quantized tree: take the float init
                svc2 = j_load_service(dict(cfg), **KW)
                params = svc2.variables["params"]
                svc2.close()
            _JAX[key] = (ids, _np_tree(params))
        finally:
            svc.close()
    return _JAX[key]


@pytest.fixture(scope="module")
def gang():
    cases = []
    for name, (cfg, mesh_cfg, kw) in SERVICES.items():
        cases.append((name, "service", dict(cfg=cfg, params=_jax(cfg, kw)[1], mesh_cfg=mesh_cfg,
                                            kw=kw, prompt=PROMPT, sync_port=free_port())))
    return run_gang(WORLD, cases)


@pytest.mark.parametrize("name", sorted(SERVICES))
def test_sharded_service_gives_the_unsharded_jax_ids(gang, name):
    """``load_service(mesh_cfg={"tp": 2})``, ``{"dp": 2}``, the int8
    kernel service with int8 KV under tp 2, and ``moe_lm`` with its experts
    over ``{"dp": 1, "ep": 2}`` give the greedy ids of JAX ``load_service``
    unsharded on the same weights; the follower is never ready and its loop
    ends on the coordinator's stop record."""
    cfg, mesh_cfg, kw = SERVICES[name]
    coord, follower = result(gang, 0, name), result(gang, 1, name)
    assert coord["ids"] == _jax(cfg, kw)[0], (coord["ids"], _jax(cfg, kw)[0])
    assert coord["warm"] > 0 and coord["ready"] is True
    assert follower["ready"] is False and follower["loop_ended"]
    axes = {"dp": 1, "fsdp": 1, "pp": 1, "sp": 1, "ep": 1, "tp": 1, **mesh_cfg}
    assert coord["mesh_block"]["axes"] == axes and coord["mesh_block"]["devices"] == WORLD
    assert coord["mesh_block"]["coordinator"] and not follower["mesh_block"]["coordinator"]
    if name == "moe_ep2":
        # each rank holds its half of the 4 experts of the one MoE layer
        assert coord["experts"] == [(2, 0)] and follower["experts"] == [(2, 2)]


def test_mesh_gauges_on_both_ranks(gang):
    """/metrics carries the two mesh gauges: the mesh's devices on every
    rank, 1 as the coordinator only on rank 0."""
    coord, follower = result(gang, 0, "tp2"), result(gang, 1, "tp2")
    assert "mlcomp_engine_mesh_devices 2" in coord["metrics"]
    assert "mlcomp_engine_is_coordinator 1" in coord["metrics"]
    assert "mlcomp_engine_mesh_devices 2" in follower["metrics"]
    assert "mlcomp_engine_is_coordinator 0" in follower["metrics"]


def _model(cfg):
    return create_model(cfg, device="cpu")


def test_service_validations_carry_the_jax_words():
    """The JAX service's mesh checks: batch sizes that don't divide dp,
    a tp that doesn't divide the heads for the serving kernels (int8 weights
    or int8 KV), fsdp with the kernels; and the refusals under a mesh."""
    params = init_params(CFG, 0)
    mesh = {"dp": 2, "tp": 4}
    with pytest.raises(ValueError, match="don't divide"):
        GenerationService(_model(CFG), params, mesh=mesh, batch_sizes=(1, 2))
    with pytest.raises(ValueError, match="must divide heads"):
        GenerationService(_model(CFG), params, mesh=mesh, batch_sizes=(2,), quantize="kernel")
    with pytest.raises(ValueError, match="must divide heads"):
        GenerationService(_model({**CFG, "kv_quant": True}), params, mesh=mesh,
                          batch_sizes=(2,))
    with pytest.raises(ValueError, match="fsdp"):
        GenerationService(_model(CFG), params, mesh={"fsdp": 4, "tp": 2}, batch_sizes=(4,),
                          quantize="kernel")
    one = {"dp": 1, "tp": 1}
    with pytest.raises(ValueError, match="phase-split serving is single-process"):
        GenerationService(_model(CFG), params, mesh=one, phase="prefill")
    with pytest.raises(ValueError, match="speculative batcher is single-chip"):
        GenerationService(_model(CFG), params, mesh=one, batcher="speculative")
    with pytest.raises(ValueError, match="prefix KV cache is single-chip"):
        GenerationService(_model(CFG), params, mesh=one, prefix_cache=True)
    with pytest.raises(ValueError, match="needs the continuous batcher"):
        GenerationService(_model(CFG), params, mesh=one, dist=object(), batcher="window")
    with pytest.raises(ValueError, match="needs a mesh"):
        GenerationService(_model(CFG), params, dist=object())
    with pytest.raises(ValueError, match="serves through the continuous batcher"):
        GenerationService(_model(CFG), params, mesh={"dp": 2, "tp": 1}, batch_sizes=(2,),
                          batcher="window")
    with pytest.raises(ValueError, match="decode_fused serving is single-chip"):
        load_service({**CFG, "decode_fused": True}, params=params, device="cpu",
                      mesh_cfg={"tp": 2})


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read().decode()


def _wait_healthz(url, proc, timeout=120.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if proc.poll() is not None:
            raise AssertionError(f"the daemon exited with {proc.returncode}")
        try:
            return json.loads(_get(url + "/healthz"))
        except (urllib.error.URLError, ConnectionError):
            time.sleep(0.2)
    raise AssertionError(f"{url} did not come up")


def test_cli_serve_mesh_distributed_as_two_processes_over_http(tmp_path):
    """``cli serve --mesh tp=2 --distributed`` as two processes: the
    coordinator answers /generate with the unsharded service's ids, the
    follower answers /healthz ready:false and /generate 503
    not_coordinator, both carry the mesh gauges, and after the coordinator
    stops the follower's loop ends on the stop record and its daemon
    exits."""
    params = init_params(CFG, 0)
    save_npz(str(tmp_path / "w.npz"), params)
    (tmp_path / "m.yml").write_text(yaml.safe_dump({"model": CFG}))
    store, sync = free_port(), free_port()
    http = [free_port(), free_port()]
    procs = []
    logs = []
    for r in range(WORLD):
        env = {**os.environ, "MLCOMP_TPU_COORDINATOR": f"127.0.0.1:{store}",
               "MLCOMP_TPU_NUM_PROCESSES": str(WORLD), "MLCOMP_TPU_PROCESS_ID": str(r),
               "PYTHONPATH": os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH"))
                                             if p), "OMP_NUM_THREADS": "1"}
        env.pop("MLCOMP_TPU_DIST_BACKEND", None)
        log = open(tmp_path / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "mlcomp_tpu_torch.cli", "serve", "--model",
             str(tmp_path / "m.yml"), "--ckpt", str(tmp_path / "w.npz"), "--device", "cpu",
             "--mesh", "tp=2", "--distributed", "--sync-port", str(sync), "--port",
             str(http[r]), "--batch-sizes", "2", "--prompt-buckets", "8",
             "--max-new-buckets", "4", "--metrics-history-interval", "0"],
            env=env, stdout=log, stderr=subprocess.STDOUT, cwd=str(tmp_path)))
    urls = [f"http://127.0.0.1:{p}" for p in http]
    try:
        h0 = _wait_healthz(urls[0], procs[0])
        h1 = _wait_healthz(urls[1], procs[1])
        assert h0["ready"] is True and h1["ready"] is False and h1["ok"] is not False
        assert h0["mesh"]["coordinator"] and not h1["mesh"]["coordinator"]
        body = json.dumps({"prompt": PROMPT, "max_new_tokens": 4}).encode()
        req = urllib.request.Request(urls[0] + "/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            got = json.loads(r.read())["ids"]
        svc = load_service(CFG, ckpt_path=str(tmp_path / "w.npz"), device="cpu",
                           batch_sizes=(2,), prompt_buckets=(8,), max_new_buckets=(4,),
                           metrics_history_interval=0)
        try:
            want = svc.generate(PROMPT, 4)["ids"]
        finally:
            svc.close()
        assert got == want
        req = urllib.request.Request(urls[1] + "/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 503
        assert json.loads(e.value.read())["status"] == "not_coordinator"
        m0, m1 = _get(urls[0] + "/metrics"), _get(urls[1] + "/metrics")
        assert "mlcomp_engine_mesh_devices 2" in m0 and "mlcomp_engine_is_coordinator 1" in m0
        assert "mlcomp_engine_mesh_devices 2" in m1 and "mlcomp_engine_is_coordinator 0" in m1
        procs[0].send_signal(signal.SIGTERM)
        assert procs[0].wait(timeout=60) == 0
        # no signal to the follower: the stop record ends it
        assert procs[1].wait(timeout=60) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
        for log in logs:
            log.close()
