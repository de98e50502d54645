"""Ring (einsum tiles and flash blocks) and Ulysses attention of the port,
held against the JAX package's on the same f32 inputs.

The JAX side runs ``ring_attention_sharded`` / ``ulysses_attention_sharded``
on the virtual CPU devices (the flash ring through the Pallas kernel in
interpret mode); the port side runs on one gloo gang of 4 processes,
started once for the whole file (tests/torch_gang.py), each rank holding
its shard of the sequence.  Forward outputs and the gradients of
sum(out * ct) are reassembled over the sp ranks and compared within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlcomp_tpu.parallel import ring as jring
from mlcomp_tpu.parallel.mesh import MeshSpec, make_mesh
from mlcomp_tpu.parallel.ring import ring_attention_sharded
from mlcomp_tpu.parallel.ulysses import ulysses_attention_sharded
from torch_gang import result, run_gang

WORLD = 4
TOL = 1e-5


def _rand(shape, seed):
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


# name -> (mode, sp, causal, (B, S, H, Hkv, D), use_flash, kv_chunk)
CASES = {
    "ring_sp2_full": ("ring", 2, False, (2, 64, 4, 2, 16), False, None),
    "ring_sp2_causal": ("ring", 2, True, (2, 64, 4, 2, 16), False, None),
    "ring_sp4_full": ("ring", 4, False, (1, 64, 4, 2, 16), False, None),
    "ring_sp4_causal": ("ring", 4, True, (1, 64, 4, 2, 16), False, None),
    "ring_sp2_chunked_ragged": ("ring", 2, True, (1, 128, 2, 1, 16), False, 24),
    "ring_flash_sp2_full": ("ring", 2, False, (1, 256, 4, 2, 64), True, None),
    "ring_flash_sp2_causal": ("ring", 2, True, (1, 256, 4, 2, 64), True, None),
    "ring_flash_sp4_causal": ("ring", 4, True, (1, 512, 2, 2, 64), True, None),
    "ulysses_sp2_full": ("ulysses", 2, False, (2, 64, 8, 4, 16), False, None),
    "ulysses_sp2_causal": ("ulysses", 2, True, (2, 64, 8, 4, 16), False, None),
    "ulysses_sp4_causal": ("ulysses", 4, True, (1, 64, 8, 4, 16), False, None),
}


def _inputs(name):
    _, _, _, (b, s, h, hkv, d), _, _ = CASES[name]
    seed = sorted(CASES).index(name) * 10
    return (_rand((b, s, h, d), seed), _rand((b, s, hkv, d), seed + 1),
            _rand((b, s, hkv, d), seed + 2), _rand((b, s, h, d), seed + 3))


REFUSALS = {
    # 3 heads over sp=2: Ulysses needs the heads to split over sp
    "ulysses_indivisible_heads": ("ulysses", 3, 3, 32, 2),
    # 64-row shards: the flash ring needs lane-tileable (128) shards
    "ring_flash_untileable": ("ring_flash", 4, 2, 64, 2),
}


@pytest.fixture(scope="module")
def gang():
    cases = []
    for name, (mode, sp, causal, _, use_flash, kv_chunk) in CASES.items():
        q, k, v, ct = _inputs(name)
        cases.append((name, "attention", dict(mode=mode, q=q, k=k, v=v, ct=ct, sp=sp,
                                              causal=causal, use_flash=use_flash,
                                              kv_chunk=kv_chunk)))
    for name, (mode, h, hkv, s_local, sp) in REFUSALS.items():
        cases.append((name, "refusal", dict(mode=mode, heads=h, kv_heads=hkv, s_local=s_local,
                                            sp=sp)))
    return run_gang(WORLD, cases)


def _jax(name, monkeypatch):
    mode, sp, causal, _, use_flash, kv_chunk = CASES[name]
    if kv_chunk is not None:
        monkeypatch.setattr(jring, "KV_CHUNK", kv_chunk)
    mesh = make_mesh(MeshSpec(sp=sp), devices=jax.devices()[:sp])
    q, k, v, ct = (jnp.asarray(a) for a in _inputs(name))

    def f(q, k, v):
        if mode == "ulysses":
            return ulysses_attention_sharded(q, k, v, mesh, causal=causal)
        return ring_attention_sharded(q, k, v, mesh, causal=causal, use_flash=use_flash)

    def fwd_bwd(q, k, v, ct):
        out, vjp = jax.vjp(f, q, k, v)
        return (out, *vjp(ct))

    return [np.asarray(a) for a in jax.jit(fwd_bwd)(q, k, v, ct)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_attention_and_grads_equal_the_jax_package(gang, name, monkeypatch):
    sp = CASES[name][1]
    # ranks 0 .. sp-1 are the first dp row: one whole sequence
    parts = [result(gang, r, name) for r in range(sp)]
    assert [p["sp_rank"] for p in parts] == list(range(sp))
    got = [np.concatenate([p[key] for p in parts], axis=1) for key in ("out", "dq", "dk", "dv")]
    want = _jax(name, monkeypatch)
    for label, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, label
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0, err_msg=f"{name} {label}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_data_row_of_the_mesh_computes_the_same(gang, name):
    """sp < 4 leaves dp rows: each computes the same sequence, bit for bit."""
    sp = CASES[name][1]
    for r in range(sp, WORLD):
        a, b = result(gang, r, name), result(gang, r % sp, name)
        for key in ("out", "dq", "dk", "dv"):
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_the_sharded_attentions_refuse_where_the_jax_package_refuses(gang, name):
    got = result(gang, 0, name)
    if name == "ulysses_indivisible_heads":
        assert got["type"] == "ValueError" and "ring attention" in got["msg"]
        mesh = make_mesh(MeshSpec(sp=2), devices=jax.devices()[:2])
        x = jnp.zeros((1, 64, 3, 16))
        with pytest.raises(ValueError, match="ring attention"):
            ulysses_attention_sharded(x, x, x, mesh, causal=True)
    else:
        assert got["type"] == "NotImplementedError" and "lane-tileable" in got["msg"]
        mesh = make_mesh(MeshSpec(sp=2), devices=jax.devices()[:2])
        x = jnp.zeros((1, 128, 4, 16))
        with pytest.raises(NotImplementedError, match="lane-tileable"):
            ring_attention_sharded(x, x, x, mesh, causal=True, use_flash=True)
