"""The port's pipeline (``parallel/pipeline.py``) and ``transformer_lm_pp``
held against the JAX package's on the same f32 inputs: GPipe and the
interleaved schedule, forward and gradients, pre-interleaved stacks, the
refusals, and the pipelined LM's logits against the JAX model's.

The JAX side runs on the virtual CPU devices; the port side on one gloo
gang of 4 processes started once for the file (tests/torch_gang.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlcomp_tpu.models import create_model as j_create_model
from mlcomp_tpu.parallel.mesh import MeshSpec, make_mesh, replicated, set_current_mesh
from mlcomp_tpu.parallel.pipeline import (
    interleave_stage_params,
    pipeline_apply,
    stack_stage_params,
)
from torch_gang import result, run_gang

WORLD = 4
TOL = 1e-5


def _stage_fn(params, h):
    return jnp.tanh(h @ params["w"] + params["b"])


def _stacked(n_stages, dim, seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.normal(scale=0.5, size=(n_stages, dim, dim)).astype(np.float32),
            "b": rng.normal(scale=0.1, size=(n_stages, dim)).astype(np.float32)}


# name -> (pp, stages, n_micro, dim, batch, pre_interleaved)
CASES = {
    "gpipe_pp4_m4": (4, 4, 4, 16, 16, False),
    "gpipe_pp4_m8": (4, 4, 8, 16, 16, False),
    "gpipe_pp2_m2": (2, 2, 2, 8, 8, False),
    "interleaved_v2_m4": (4, 8, 4, 8, 16, False),
    "interleaved_v2_m8": (4, 8, 8, 8, 16, False),
    "interleaved_v2_m6_ragged_groups": (4, 8, 6, 8, 12, False),
    "interleaved_v2_pre_interleaved": (4, 8, 4, 8, 16, True),
}

ERRORS = {
    "non_multiple_virtual_stages": (4, 6, 4, 8, 8, "not a multiple"),
    "ragged_microbatches": (4, 4, 4, 8, 10, "not divisible"),
}

LM = {"name": "transformer_lm_pp", "vocab_size": 64, "hidden": 32, "heads": 4,
      "kv_heads": 2, "mlp_dim": 64, "dtype": "float32"}
# name -> (pp, layers, n_microbatches, batch)
LM_CASES = {"lm_gpipe_pp4": (4, 4, 0, 8), "lm_interleaved_pp4_v2": (4, 8, 4, 8),
            "lm_pp2_v2": (2, 4, 2, 4)}


def _inputs(name):
    pp, stages, n_micro, dim, batch, pre = CASES[name]
    seed = sorted(CASES).index(name) * 10
    stacked = _stacked(stages, dim, seed)
    rng = np.random.RandomState(seed + 1)
    x = rng.normal(size=(batch, dim)).astype(np.float32)
    ct = rng.normal(size=(batch, dim)).astype(np.float32)
    return stacked, x, ct


def _lm(name):
    pp, layers, n_micro, batch = LM_CASES[name]
    cfg = {**LM, "layers": layers, "n_microbatches": n_micro}
    model = j_create_model(cfg)
    ids = np.random.RandomState(layers + pp).randint(0, 64, (batch, 16)).astype(np.int32)
    set_current_mesh(make_mesh(MeshSpec(dp=1), devices=jax.devices()[:1]))
    try:
        variables = model.init(jax.random.PRNGKey(sorted(LM_CASES).index(name)), jnp.asarray(ids))
    finally:
        set_current_mesh(None)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(variables["params"])}
    return cfg, model, variables, flat, ids


@pytest.fixture(scope="module")
def gang():
    cases = []
    for name, (pp, stages, n_micro, dim, batch, pre) in CASES.items():
        stacked, x, ct = _inputs(name)
        if pre:
            stacked = {k: np.asarray(v) for k, v in
                       interleave_stage_params({k: jnp.asarray(v) for k, v in stacked.items()},
                                               pp).items()}
        cases.append((name, "pipeline", dict(stacked=stacked, x=x, n_micro=n_micro, pp=pp, ct=ct,
                                             pre_interleaved=pre)))
    for name, (pp, stages, n_micro, dim, batch, _) in ERRORS.items():
        rng = np.random.RandomState(5)
        cases.append((name, "pipeline_error", dict(
            stacked=_stacked(stages, dim, 5), x=rng.normal(size=(batch, dim)).astype(np.float32),
            n_micro=n_micro, pp=pp)))
    for name, (pp, *_rest) in LM_CASES.items():
        cfg, _, _, flat, ids = _lm(name)
        cases.append((name, "pipeline_lm", dict(model_cfg=cfg, flat=flat, ids=ids, pp=pp)))
    return run_gang(WORLD, cases)


def _jax(name):
    pp, stages, n_micro, dim, batch, pre = CASES[name]
    mesh = make_mesh(MeshSpec(pp=pp), devices=jax.devices()[:pp])
    stacked, x, ct = _inputs(name)
    stacked = {k: jnp.asarray(v) for k, v in stacked.items()}
    if pre:
        stacked = interleave_stage_params(stacked, pp)

    def f(sp):
        return pipeline_apply(_stage_fn, sp, jnp.asarray(x), n_micro, mesh,
                              pre_interleaved=pre)

    out, vjp = jax.vjp(jax.jit(f), stacked)
    (grads,) = vjp(jnp.asarray(ct))
    return np.asarray(out), {k: np.asarray(v) for k, v in grads.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_and_grads_equal_the_jax_package(gang, name):
    out, grads = _jax(name)
    pp = CASES[name][0]
    for r in range(WORLD):
        got = result(gang, r, name)
        # every rank returns the last stage's output
        np.testing.assert_allclose(got["out"], out, atol=TOL, rtol=0, err_msg=f"{name} r{r}")
        for k in grads:
            # summed over microbatches in another order: relative 1e-5
            np.testing.assert_allclose(got["grads"][k], grads[k], atol=TOL, rtol=TOL,
                                       err_msg=f"{name} d{k} r{r}")
        if r >= pp:
            break


def test_stack_stage_params_equals_the_jax_stack():
    from mlcomp_tpu_torch.parallel.pipeline import stack_stage_params as t_stack
    import torch

    rng = np.random.RandomState(0)
    plist = [{"w": rng.normal(size=(3, 3)).astype(np.float32)} for _ in range(4)]
    want = stack_stage_params([{k: jnp.asarray(v) for k, v in p.items()} for p in plist])
    got = t_stack([{k: torch.from_numpy(v) for k, v in p.items()} for p in plist])
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))


@pytest.mark.parametrize("n_stages,n_virtual", [(2, 2), (4, 2), (2, 3), (4, 1)])
def test_interleave_permutations_equal_the_jax_package(n_stages, n_virtual):
    import torch

    from mlcomp_tpu.parallel.pipeline import deinterleave_stage_params as j_de
    from mlcomp_tpu_torch.parallel.pipeline import (
        deinterleave_stage_params as t_de, interleave_stage_params as t_in)

    v = np.arange(n_stages * n_virtual * 2, dtype=np.float32).reshape(n_stages * n_virtual, 2)
    want = np.asarray(interleave_stage_params({"a": jnp.asarray(v)}, n_stages)["a"])
    got = t_in({"a": torch.from_numpy(v)}, n_stages)["a"].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        t_de({"a": torch.from_numpy(got)}, n_stages)["a"].numpy(),
        np.asarray(j_de({"a": jnp.asarray(want)}, n_stages)["a"]))


@pytest.mark.parametrize("n_micro,n_stages,n_virtual", [(4, 4, 1), (8, 4, 2), (6, 4, 2), (3, 2, 3)])
def test_the_tick_schedule_banks_every_microbatch_once_in_order(n_micro, n_stages, n_virtual):
    """The JAX schedule's arithmetic, replayed: each microbatch visits
    every virtual stage once, in network order, and the last rank banks it
    at the end of its last lap."""
    from mlcomp_tpu_torch.parallel.pipeline import schedule_ticks, tick_slot

    visits = {m: [] for m in range(n_micro)}
    for t in range(schedule_ticks(n_micro, n_stages, n_virtual)):
        for d in range(n_stages):
            m, k = tick_slot(t, d, n_stages, n_virtual)
            if 0 <= m < n_micro:
                visits[m].append(k * n_stages + d)
    for m, seq in visits.items():
        assert seq == list(range(n_stages * n_virtual)), (m, seq)


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_pipeline_refuses_where_the_jax_package_refuses(gang, name):
    pp, stages, n_micro, dim, batch, match = ERRORS[name]
    got = result(gang, 0, name)
    assert got["msg"] is not None and match in got["msg"], got
    mesh = make_mesh(MeshSpec(pp=pp), devices=jax.devices()[:pp])
    stacked = {k: jnp.asarray(v) for k, v in _stacked(stages, dim, 5).items()}
    with pytest.raises(ValueError, match=match):
        pipeline_apply(lambda p, h: jnp.tanh(h @ p["w"]), stacked,
                       jnp.zeros((batch, dim)), n_micro, mesh)


@pytest.mark.parametrize("name", sorted(LM_CASES))
def test_pipelined_lm_logits_equal_the_jax_model(gang, name):
    pp = LM_CASES[name][0]
    cfg, model, variables, flat, ids = _lm(name)
    mesh = make_mesh(MeshSpec(pp=pp), devices=jax.devices()[:pp])
    set_current_mesh(mesh)
    try:
        want = np.asarray(jax.jit(model.apply)(jax.device_put(variables, replicated(mesh)),
                                               jnp.asarray(ids)))
    finally:
        set_current_mesh(None)
    for r in range(pp):
        np.testing.assert_allclose(result(gang, r, name)["logits"], want, atol=2e-5, rtol=0,
                                   err_msg=f"{name} r{r}")
