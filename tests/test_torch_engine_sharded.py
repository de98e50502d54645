"""The port's continuous engine as a serve gang (one gloo process a rank,
``tests/torch_gang.py``): the counterparts of tests/test_engine_sharded.py's
acceptance surface, held within the port and against the JAX package's
single-device ``generate`` on its tiny f32 model.

Each gang engine runs the mixed workload (a streaming row, a mid-stream
join, a queued request stopping at an EOS inside a K = 2 dispatch) under a
tp 2 and a dp 2 mesh over two ranks, and a dp 2 x tp 2 mesh over four.
Within the port the equalities are bit for bit: depth 2 equals depth 1 and
the paged layout equals the dense one, tokens and logprobs.  Against the
JAX package the greedy ids are equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlcomp_tpu.models import create_model as j_create
from mlcomp_tpu.models.generation import generate as j_generate
from mlcomp_tpu.train.state import init_model
from mlcomp_tpu_torch.engine import DecodeEngine
from mlcomp_tpu_torch.models import create_model
from mlcomp_tpu_torch.models.generation import prep_decode_variables
from torch_gang import free_port, result, run_gang

torch.set_num_threads(1)

CFG = {"name": "transformer_lm", "vocab_size": 64, "hidden": 64, "layers": 2, "heads": 2,
       "mlp_dim": 128, "dtype": "float32"}
# mesh name -> (world, axes); every mesh runs depth 1 and 2 dense and depth 2 paged
MESHES = {"tp2": (2, {"dp": 1, "tp": 2}), "dp2": (2, {"dp": 2, "tp": 1}),
          "dp2xtp2": (4, {"dp": 2, "tp": 2})}
ARMS = (("d1", 1, "dense"), ("d2", 2, "dense"), ("p2", 2, "paged"))


def _np_tree(tree):
    if hasattr(tree, "items"):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.array(tree)


@functools.lru_cache(maxsize=None)
def _jax_model():
    model = j_create(CFG)
    prompt = jnp.asarray(np.random.RandomState(0).randint(1, 64, (1, 8)))
    params, _ = init_model(model, {"x": prompt}, jax.random.PRNGKey(0))
    return model, params


def _params():
    return _np_tree(_jax_model()[1])


@functools.lru_cache(maxsize=None)
def _reference(ids, n_new, bucket=16):
    model, params = _jax_model()
    prompt = np.zeros((1, bucket), np.int32)
    mask = np.zeros((1, bucket), bool)
    prompt[0, bucket - len(ids):] = ids
    mask[0, bucket - len(ids):] = True
    out = j_generate(model, {"params": params}, jnp.asarray(prompt), n_new,
                     prompt_mask=jnp.asarray(mask))
    return tuple(np.asarray(out)[0, bucket:].tolist())


def _ids():
    rs = np.random.RandomState(11)
    return {"a": rs.randint(1, 64, 5).tolist(), "b": rs.randint(1, 64, 7).tolist(),
            "c": rs.randint(1, 64, 3).tolist()}


def _eos_c():
    return _reference(tuple(_ids()["c"]), 1)[0]


REPLAY = ([3, 14, 15, 9, 2], [7, 3, 44])


def _cases(world):
    params, ids, eos_c = _params(), _ids(), _eos_c()
    cases = []
    for name, (w, axes) in MESHES.items():
        if w != world:
            continue
        for arm, depth, layout in ARMS:
            cases.append((f"{name}/{arm}", "engine_workload", dict(
                cfg=CFG, params=params, axes=axes, depth=depth, kv_layout=layout, eos_c=eos_c,
                ids=ids, sync_port=free_port())))
    if world == 2:
        cases.append(("dp_slots", "dp_slots", dict(cfg=CFG, params=params,
                                                   axes=MESHES["dp2"][1])))
        cases.append(("replay", "follower_replay", dict(
            cfg=CFG, params=params, axes=MESHES["tp2"][1], prompt1=REPLAY[0], prompt2=REPLAY[1],
            sync_port=free_port())))
    return cases


@pytest.fixture(scope="module")
def gang2():
    return run_gang(2, _cases(2))


@pytest.fixture(scope="module")
def gang4():
    return run_gang(4, _cases(4))


def _gang(request, name):
    return request.getfixturevalue("gang4" if MESHES[name][0] == 4 else "gang2")


@pytest.mark.parametrize("name", sorted(MESHES))
def test_sharded_depth2_bit_identical_to_depth1_and_paged_to_dense(request, name):
    """Under each mesh the gang's depth-2 engine emits tokens and logprobs
    bit-identical to depth 1, the paged layout bit-identical to the dense
    one, and the greedy ids are JAX ``generate``'s, with a mid-stream join
    and an EOS mid-dispatch in the mix."""
    gang = _gang(request, name)
    got = {arm: result(gang, 0, f"{name}/{arm}") for arm, _, _ in ARMS}
    keys = ("a", "b", "c")
    d1, d2, p2 = ({k: got[arm][k] for k in keys} for arm in ("d1", "d2", "p2"))
    assert d1 == d2, (d1, d2)
    assert p2 == d2, (p2, d2)
    ids = _ids()
    assert tuple(d1["a"][0]) == _reference(tuple(ids["a"]), 9)
    assert tuple(d1["b"]) == _reference(tuple(ids["b"]), 7)
    assert d1["c"] == [_eos_c()]  # EOS stopped it at one
    assert got["d2"]["depth"] == 2 and got["d2"]["peak_inflight"] >= 2
    assert got["d1"]["depth"] == 1


@pytest.mark.parametrize("name", sorted(MESHES))
def test_each_rank_holds_its_kv_heads_and_the_replicated_tables(request, name):
    """Every rank's cache (dense) and pages (paged) hold kv_heads / tp heads
    from birth through admissions, retirements and lazy page growth; the
    page tables and the live slot count are equal on every rank, and every
    rank emitted the same tokens."""
    world, axes = MESHES[name]
    gang = _gang(request, name)
    want = [CFG["heads"] // axes["tp"]]
    for arm, _, layout in ARMS:
        states = [result(gang, r, f"{name}/{arm}") for r in range(world)]
        for r, st in enumerate(states):
            assert st["kv_heads_born"] == want and st["kv_heads"] == want, (arm, r, st)
            assert st["emitted_tokens"] == states[0]["emitted_tokens"]
            assert st["prefills"] == states[0]["prefills"] == 3
            assert st["mesh"]["devices"] == world and st["mesh"]["coordinator"] == (r == 0)
        for st in states[1:]:
            assert st["loop_ended"], arm  # the stop record ended the follower's loop
        if layout == "paged":
            for st in states[1:]:
                np.testing.assert_array_equal(st["table"], states[0]["table"])
                assert st["live_slots"] == states[0]["live_slots"]


def test_follower_replays_the_coordinator(gang2):
    """A coordinator/follower pair: the follower's submit raises
    NotCoordinator; it replays the coordinator's admissions, dispatches and
    its cancel retirement (equal emitted tokens and prefills, one cancel);
    the coordinator's stop record ends its loop."""
    coord, follower = result(gang2, 0, "replay"), result(gang2, 1, "replay")
    assert coord["is_coordinator"] and not follower["is_coordinator"]
    assert follower["not_coordinator"] == "not_coordinator"
    assert tuple(coord["r1"]) == _reference(tuple(REPLAY[0]), 6)
    assert coord["cancel_matched"] and coord["f2"] == "RequestCancelled"
    for key in ("emitted_tokens", "prefills", "cancelled", "dispatches"):
        assert follower[key] == coord[key], key
    assert coord["prefills"] == 2 and coord["cancelled"] == 1
    assert coord["mesh"]["coordinator"] is True and follower["mesh"]["coordinator"] is False
    assert follower["loop_ended"]


class FakeMesh:  # construction-time checks precede any use of the mesh
    pass


def _model():
    model = create_model(CFG, device="cpu")
    prep_decode_variables(model, _params())
    return model


def test_mesh_defaults_pipelined_and_remaining_rejections_name_followup():
    """A mesh's default depth is 2 and an explicit depth stands; speculative
    dispatch, the prefix cache and prefill-only engines under a mesh are
    refused naming the follow-up; a gang needs a mesh, and a mesh wider than
    one rank needs the gang's channel."""
    from mlcomp_tpu_torch.cache import PrefixKVCache

    model = _model()
    kw = dict(slots=2, prompt_buckets=(16,), max_new_cap=8)
    eng = DecodeEngine(model, mesh=FakeMesh(), **kw)
    try:
        assert eng.pipeline_depth == 2
        assert eng.stats()["mesh"]["coordinator"] is True
    finally:
        eng.close()
    eng = DecodeEngine(model, mesh=FakeMesh(), pipeline_depth=2, **kw)
    try:
        assert eng.pipeline_depth == 2
    finally:
        eng.close()
    with pytest.raises(ValueError, match="follow-up"):
        DecodeEngine(model, mesh=FakeMesh(), spec_k=2, **kw)
    with pytest.raises(ValueError, match="follow-up"):
        DecodeEngine(model, mesh=FakeMesh(), prefix_cache=PrefixKVCache(), **kw)
    with pytest.raises(ValueError, match="follow-up"):
        DecodeEngine(model, mesh=FakeMesh(), prefill_only=True, **kw)
    with pytest.raises(ValueError, match="needs a mesh"):
        DecodeEngine(model, dist=object(), **kw)
    with pytest.raises(ValueError, match="needs dist"):
        DecodeEngine(model, mesh={"dp": 1, "tp": 2}, **kw)
    with pytest.raises(ValueError, match="no serving layout"):
        DecodeEngine(model, mesh={"dp": 1, "sp": 2}, dist=object(), **kw)


def test_a_mesh_of_one_rank_is_the_one_card_engine():
    """A mesh of one rank runs the one-card code path: the same tokens and
    logprobs bit for bit, and no tensor-parallel group on any module."""
    def run(mesh):
        model = create_model(CFG, device="cpu")
        prep_decode_variables(model, _params(), mesh=mesh)
        assert all(getattr(m, "tp_group", None) is None for m in model.modules())
        eng = DecodeEngine(model, slots=2, prompt_buckets=(16,), max_new_cap=8, mesh=mesh)
        try:
            futs = [eng.submit(ids, 6, logprobs=True) for ids in _ids().values()]
            return [(f.result(timeout=120)["ids"], f.result()["logprobs"]) for f in futs]
        finally:
            eng.close()

    assert run({"dp": 1, "tp": 1}) == run(None)


def test_dp_refuses_slot_counts_it_does_not_split(gang2):
    """Every rank holds every slot's KV but decodes only its dp share of the
    rows, so a slot count (or elastic cap) that dp does not split is
    refused when the engine is built, on every rank."""
    for r in range(2):
        got = result(gang2, r, "dp_slots")
        assert "slots=3 and max_slots=3 must split over dp=2" in got["slots"]
        assert "max_slots=5 must split over dp=2" in got["max_slots"]
