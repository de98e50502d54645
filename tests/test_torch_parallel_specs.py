"""The port's pure placement policies and its boundary channel, held
against the JAX package's: ``MeshSpec.resolve``/``from_config``,
``spec_for`` over the parameter trees of ``transformer_lm``, ``moe_lm``,
``bert`` and ``transformer_lm_pp`` on meshes over every axis,
``seq_shard_spec``, and ``BoundaryChannel`` records across the two
packages' ends (one wire format)."""

import threading

import jax
import numpy as np
import pytest

from mlcomp_tpu.parallel import distributed as jdist
from mlcomp_tpu.parallel.mesh import MeshSpec as JMeshSpec
from mlcomp_tpu.parallel.mesh import make_mesh as j_make_mesh
from mlcomp_tpu.parallel.mesh import seq_shard_spec as j_seq_shard_spec
from mlcomp_tpu.parallel.sharding import spec_for as j_spec_for
from mlcomp_tpu_torch.io.weights import flatten, init_params, init_variables
from mlcomp_tpu_torch.parallel import distributed as tdist
from mlcomp_tpu_torch.parallel.mesh import AXES, MeshSpec, seq_shard_spec
from mlcomp_tpu_torch.parallel.sharding import TP_RULES, spec_for, state_shardings
from torch_gang import free_port

MESHES = [
    {"fsdp": 8}, {"tp": 8}, {"dp": 2, "fsdp": 2, "tp": 2}, {"dp": 2, "tp": 4},
    {"ep": 2, "tp": 2, "fsdp": 2}, {"pp": 2, "fsdp": 2, "tp": 2}, {"sp": 4, "dp": 2},
    {"pp": 4, "ep": 2}, {"fsdp": 4, "sp": 2},
]

TREES = {
    "transformer_lm": {"name": "transformer_lm", "vocab_size": 96, "hidden": 64, "layers": 2,
                       "heads": 8, "kv_heads": 2},
    "moe_lm": {"name": "moe_lm", "vocab_size": 96, "hidden": 64, "layers": 2, "heads": 4,
               "n_experts": 4, "d_ff": 128, "moe_every": 2},
    "transformer_lm_pp": {"name": "transformer_lm_pp", "vocab_size": 96, "hidden": 64,
                          "layers": 4, "heads": 4, "mlp_dim": 256},
    "bert": {"name": "bert", "vocab_size": 128, "hidden": 64, "layers": 2, "heads": 4,
             "mlp_dim": 256, "max_len": 32, "num_classes": 3},
}


def _leaves(name):
    cfg = TREES[name]
    tree = (init_variables(cfg, 0, sample_shape=(1, 32))[0] if name == "bert"
            else init_params(cfg, 0))
    return {k: tuple(np.shape(v)) for k, v in flatten(tree).items()}


def _jmesh(axes):
    return j_make_mesh(JMeshSpec(**{"dp": 1, **axes}), devices=jax.devices()[:8])


def test_the_rules_are_the_jax_packages():
    from mlcomp_tpu.parallel.sharding import TP_RULES as J_RULES

    assert TP_RULES == J_RULES
    assert AXES == ("dp", "fsdp", "pp", "sp", "ep", "tp")


@pytest.mark.parametrize("tree", sorted(TREES))
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "-".join(f"{k}{v}" for k, v in m.items()))
def test_spec_for_equals_the_jax_package(tree, mesh):
    jm = _jmesh(mesh)
    leaves = _leaves(tree)
    assert leaves
    got = state_shardings(leaves, {"dp": 1, **mesh})
    for path, shape in leaves.items():
        want = tuple(j_spec_for(path, shape, jm))
        assert got[path] == want, (path, shape)
        assert spec_for(path, shape, {"dp": 1, **mesh}) == want


@pytest.mark.parametrize("spec,n", [
    ({}, 8), ({"tp": 2}, 8), ({"dp": 2, "sp": 4}, 8), ({"fsdp": -1, "tp": 4}, 8),
    ({"dp": 8}, 8), ({"dp": 2}, 2), ({"pp": 2, "ep": 2}, 4), ({"dp": 3}, 8),
    ({"dp": -1, "tp": 3}, 8), ({"dp": -1, "fsdp": -1}, 8), ({"tp": 4}, 2),
])
def test_mesh_spec_resolves_as_the_jax_package(spec, n):
    def run(cls):
        try:
            return cls.from_config(spec).resolve(n)
        except ValueError as e:
            return f"ValueError: {e}"

    assert run(MeshSpec) == run(JMeshSpec)


def test_mesh_spec_refuses_unknown_axes():
    for cls in (MeshSpec, JMeshSpec):
        with pytest.raises(ValueError, match="unknown mesh axes"):
            cls.from_config({"dp": 2, "xp": 2})


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "-".join(f"{k}{v}" for k, v in m.items()))
@pytest.mark.parametrize("batch,heads,kv_heads", [(8, 16, 16), (3, 16, 4), (4, 6, 2), (2, 8, 8)])
@pytest.mark.parametrize("split", [False, True])
def test_seq_shard_spec_equals_the_jax_package(mesh, batch, heads, kv_heads, split):
    want = tuple(j_seq_shard_spec(_jmesh(mesh), batch, heads, kv_heads,
                                  heads_split_sp=split))
    assert seq_shard_spec({"dp": 1, **mesh}, batch, heads, kv_heads,
                          heads_split_sp=split) == want


def test_init_distributed_is_a_noop_without_the_gang_env(monkeypatch):
    for k in ("MLCOMP_TPU_COORDINATOR", "MLCOMP_TPU_NUM_PROCESSES", "MLCOMP_TPU_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert tdist.init_distributed(device="cpu") is False
    assert tdist.process_count() == 1 and tdist.process_index() == 0
    assert tdist.is_coordinator()
    tdist.sync_hosts("noop")  # must not raise or hang


def test_hybrid_mesh_refuses_per_layer_axes_across_slices():
    with pytest.raises(ValueError, match="may not cross DCN"):
        tdist.make_hybrid_mesh(MeshSpec(dp=2, tp=4), dcn_spec={"tp": 2})
    with pytest.raises(ValueError, match="may not cross DCN"):
        jdist.make_hybrid_mesh(JMeshSpec(dp=2, tp=4), dcn_spec={"tp": 2})


def test_the_coordinator_preflight_refuses_a_taken_port():
    import socket

    s = socket.socket()
    s.bind(("", 0))
    s.listen(1)
    port = s.getsockname()[1]
    try:
        with pytest.raises(tdist.CoordinatorBindError, match="already taken"):
            tdist._preflight_coordinator_bind(f"127.0.0.1:{port}")
    finally:
        s.close()
    tdist._preflight_coordinator_bind(f"127.0.0.1:{port}")


def _channel(mod, pid, port, n=3):
    return mod.BoundaryChannel(num_processes=n, process_id=pid, address="127.0.0.1",
                               port=port, timeout_s=30.0)


@pytest.mark.parametrize("coordinator,follower", [("torch", "torch"), ("jax", "torch"),
                                                  ("torch", "jax")])
def test_boundary_channel_round_trips_across_the_packages(coordinator, follower):
    mods = {"torch": tdist, "jax": jdist}
    port = free_port()
    followers, errors = [None, None], []

    def join(i):
        try:
            followers[i] = _channel(mods[follower], i + 1, port)
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=join, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    coord = _channel(mods[coordinator], 0, port)
    for t in threads:
        t.join(10)
    assert not errors and all(followers)
    records = [{"boundary": 1, "admit": [3, 4]}, {"boundary": 2, "stop": False}, [1, "x"]]
    for r in records:
        coord.send(r)
    for f in followers:
        assert [f.recv() for _ in records] == records
    # the coordinator going away is the followers' stop record
    coord.close()
    for f in followers:
        with pytest.raises((tdist.ChannelClosed, jdist.ChannelClosed)):
            f.recv()
        f.close()


def test_a_closed_follower_unblocks_its_recv():
    port = free_port()
    box = {}
    t = threading.Thread(target=lambda: box.setdefault("f", _channel(tdist, 1, port, n=2)))
    t.start()
    coord = _channel(tdist, 0, port, n=2)
    t.join(10)
    f = box["f"]
    got = []

    def reader():
        try:
            f.recv()
        except tdist.ChannelClosed as e:
            got.append(e)

    r = threading.Thread(target=reader)
    r.start()
    f.close()
    r.join(10)
    assert got and not r.is_alive()
    # a dead follower is dropped, and the coordinator's sends go on
    coord.send({"after": True})
    coord.send({"after": True})
    coord.close()
    coord.close()  # idempotent


def test_a_single_process_channel_is_inert():
    ch = tdist.BoundaryChannel(num_processes=1, process_id=0)
    assert ch.is_coordinator
    ch.send({"x": 1})
    ch.close()


def test_a_follower_without_an_address_is_refused(monkeypatch):
    monkeypatch.delenv("MLCOMP_TPU_COORDINATOR", raising=False)
    with pytest.raises(ValueError, match="coordinator host"):
        tdist.BoundaryChannel(num_processes=2, process_id=1)


@pytest.mark.parametrize("flag", [["--mesh", "tp=2"], ["--distributed"],
                                  ["--mesh", "tp", "--sync-port", "9100"]],
                         ids=["mesh", "distributed", "sync-port"])
def test_serve_under_a_mesh_stays_refused_naming_the_next_slice(tmp_path, monkeypatch, flag):
    """The JAX command's sharded serving flags, as its CLI takes them:
    ``--mesh tp=2`` reaches ``load_service`` as ``mesh_cfg={"tp": 2}``;
    ``--distributed`` without ``--mesh``, and a ``--mesh`` value that is
    not AXIS=N (beside a ``--sync-port``), exit 2 before anything loads."""
    from mlcomp_tpu_torch import cli
    from mlcomp_tpu_torch import serve as port_serve

    seen = {}

    def fake_load(model_cfg, **kw):
        seen.update(kw)
        return object()

    monkeypatch.setattr(port_serve, "load_service", fake_load)
    monkeypatch.setattr(port_serve, "serve_http", lambda *a, **k: None)
    m = tmp_path / "m.yml"
    m.write_text("model: {name: transformer_lm, vocab_size: 64, hidden: 32, layers: 1, "
                 "heads: 4}\n")
    rc = cli.main(["serve", "--model", str(m), "--ckpt", str(tmp_path / "w.npz"), "--device",
                   "cpu", *flag])
    if flag == ["--mesh", "tp=2"]:
        assert rc == 0 and seen["mesh_cfg"] == {"tp": 2} and "dist" not in seen
    else:
        assert rc == 2 and not seen
