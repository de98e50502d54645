"""The port's paged KV pool (mlcomp_tpu_torch/kvpool) against the JAX
package's on the CPU.

- The port's allocator and pool are copies of the JAX package's numpy-only
  modules: one scripted sequence (alloc, extend, free, slot rows with pad
  pages and lazy tails, all-or-nothing failures, LIFO reuse, the prefix
  registry) runs through both and must leave equal tables, free counts and
  counters at every step.
- The port's ``PagedLayout`` must write and read the JAX ``PagedLayout``'s
  pages byte for byte (int8 and bf16 families), through the same tables
  and write routing: the page layout the handoff between the packages
  relies on.
- B8's plain version equals the Pallas page gather in interpret mode.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlcomp_tpu.kvpool import allocator as j_alloc
from mlcomp_tpu.kvpool import layout as j_layout
from mlcomp_tpu.kvpool import pool as j_pool
from mlcomp_tpu.models import create_model as j_create
from mlcomp_tpu.models.generation import init_cache as j_init_cache
from mlcomp_tpu_torch.kvpool import allocator as t_alloc
from mlcomp_tpu_torch.kvpool import pool as t_pool
from mlcomp_tpu_torch.kvpool.layout import PagedLayout
from mlcomp_tpu_torch.models import create_model
from mlcomp_tpu_torch.ops.cuda.page_gather import page_gather, page_gather_plain

torch.set_num_threads(1)

GRAVE, NULL, RESERVED = t_alloc.GRAVE_PAGE, t_alloc.NULL_PAGE, t_alloc.RESERVED_PAGES


def test_reserved_pages_match_jax():
    assert (NULL, GRAVE, RESERVED) == (j_alloc.NULL_PAGE, j_alloc.GRAVE_PAGE,
                                       j_alloc.RESERVED_PAGES)


def _plain(v):
    """numpy values as plain Python, for an exact comparison."""
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v.item() if isinstance(v, np.generic) else v


def _script(alloc_mod, pool_mod):
    """One sequence of pool operations; a snapshot after each (tables, free
    pages, counters and stats), exceptions by name and status."""
    layout = SimpleNamespace(page_tokens=4, max_pages=6, num_pages=2 + 12,
                             page_bytes=lambda: 96)
    pool = pool_mod.PagePool(layout, max_slots=3, registry_entries=2)
    snaps = []

    def snap(tag, value=None, check=True):
        if check:  # a built row holds its pages before it is committed
            pool.check_invariants()
        snaps.append((tag, _plain(value),
                      pool.tables.tolist(), list(pool.alloc._free), pool.stats()))

    def attempt(tag, fn):
        try:
            snap(tag, fn())
        except Exception as e:  # the typed failure is part of the contract
            snap(f"{tag}: {type(e).__name__} {getattr(e, 'status', '')}")

    # slot 0: 3 pad slots, span to 21; the lazy tail past alloc_end stays NULL
    row, mask, forks = pool.build_slot_row(3, 21, alloc_end=10)
    snap("row0", [row.tolist(), mask.tolist(), forks], check=False)
    pool.commit_slot_row(0, row)
    snap("commit0")
    attempt("extend0", lambda: pool.extend_slot_row(0, 3, 5))
    # slot 1: pad pages cost nothing (start 9 -> page 2)
    row1, _, _ = pool.build_slot_row(9, 24)
    pool.commit_slot_row(1, row1)
    snap("commit1", row1)
    # all or nothing: 5 pages asked, fewer free
    attempt("too_many", lambda: pool.build_slot_row(0, 20)[0])
    attempt("alloc_too_many", lambda: pool.alloc.alloc(99))
    # the registry pins slot 1's prompt pages; a lookup leases them
    snap("register", [pool.registry_register(16, 9, list(range(7)), row1)])
    lease = pool.registry_lookup(16, 9, list(range(7)) + [50])
    snap("lookup", [lease.matched, lease.boundary, list(lease.entries)])
    pool.free_slot(1)
    snap("free1")
    # a slot row sharing the leased prefix: shared mapping plus a fork
    def shared():
        row, mask, forks = pool.build_slot_row(9, 20, shared=lease)
        pool.release_row(row)   # an admission that failed before its commit
        return [row.tolist(), mask.tolist(), forks]

    attempt("shared", shared)
    lease.release()
    snap("released")
    pool.free_slot(0)
    snap("free0")
    # LIFO reuse: the pages freed last come back first
    def reuse():
        pages = pool.alloc.alloc(3)
        for pg in pages:
            pool.alloc.release(pg)
        return pages

    attempt("reuse", reuse)
    snap("reclaim", [pool.reclaim(pool.alloc.total_pages), pool.reclaimable_pages()])
    pool.reset()
    snap("reset")
    return snaps


def test_allocator_and_pool_copies_behave_as_jax():
    got = _script(t_alloc, t_pool)
    want = _script(j_alloc, j_pool)
    assert len(got) == len(want) == 15
    for g, w in zip(got, want):
        assert g == w, (g[0], w[0])


def test_lazy_extend_refuses_a_mapped_page_and_pages_needed():
    layout = SimpleNamespace(page_tokens=8, max_pages=4, num_pages=6, page_bytes=lambda: 1)
    for mod in (t_pool, j_pool):
        pool = mod.PagePool(layout, max_slots=1)
        assert pool.pages_needed(5, 17) == 3 and pool.pages_needed(8, 17) == 2
        row, _, _ = pool.build_slot_row(0, 17, alloc_end=9)
        pool.commit_slot_row(0, row)
        with pytest.raises(AssertionError, match="lazy extend over a mapped page"):
            pool.extend_slot_row(0, 1, 3)


# ---------------------------------------------------------------- layout

CFG = {"name": "transformer_lm", "vocab_size": 64, "hidden": 64, "layers": 2, "heads": 2,
       "kv_heads": 1, "mlp_dim": 128, "dtype": "bfloat16"}
L_BUF, SLOTS = 25, 3


def _families(kv_quant, t):
    """The JAX and port layouts of one cache family at page size ``t``."""
    jm = j_create({**CFG, "kv_quant": kv_quant})
    jlay = j_layout.PagedLayout(jax.eval_shape(lambda: j_init_cache(jm, 1, L_BUF)), L_BUF, t)
    tm = create_model({**CFG, "kv_quant": kv_quant}, device="cpu")
    tlay = PagedLayout(tm.init_cache(1, L_BUF), L_BUF, t)
    num_pages = RESERVED + SLOTS * tlay.max_pages + 3
    jlay.num_pages = tlay.num_pages = num_pages
    return jm, jlay, tm, tlay


def _random_leaf(rng, shape, dtype):
    if dtype == torch.int8:
        return rng.integers(-127, 128, size=shape).astype(np.int8)
    x = rng.normal(size=shape).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))  # bf16 values


def _to_torch(a, dtype):
    return torch.from_numpy(np.array(a)).to(dtype)


def _bytes(x):
    """Raw bytes of a jax array or torch tensor, for exact comparison."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().tobytes()
    a = np.asarray(x)
    return (a.view(np.int16) if a.dtype == jnp.bfloat16 else a).tobytes()


def _path(path) -> str:
    return "/".join(str(getattr(k, "key", k)) for k in path)


def _dense_caches(jm, tm, tlay, slots, seed):
    """The same random dense cache in both packages' forms, at ``slots`` rows."""
    rng = np.random.default_rng(seed)
    arrays = {spec.keystr: _random_leaf(rng, (slots,) + spec.shape[1:], spec.dtype)
              for spec in tlay.kv_specs}
    jcache = jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(arrays[_path(path)], leaf.dtype)
        if _path(path) in arrays else leaf, j_init_cache(jm, slots, L_BUF))
    tcache = tm.init_cache(slots, L_BUF)
    for spec in tlay.kv_specs:
        setattr(tcache.layers[spec.layer], spec.field, _to_torch(arrays[spec.keystr], spec.dtype))
    return jcache, tcache


def _tables(rng, max_pages, n_cols):
    """Shuffled private pages with a NULL pad prefix and NULL past the span
    (row 0), a fully mapped row (row 1) and a retired all-GRAVE row."""
    ids = rng.permutation(np.arange(RESERVED, RESERVED + SLOTS * max_pages)).astype(np.int32)
    table = ids[: SLOTS * max_pages].reshape(SLOTS, max_pages)
    table[0, :1] = NULL
    table[0, max(n_cols - 1, 1):] = NULL
    table[2] = GRAVE
    return table


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("t", [4, 8])
def test_layout_pages_byte_equal_jax(kv_quant, t):
    jm, jlay, tm, tlay = _families(kv_quant, t)
    assert [s.keystr for s in tlay.kv_specs] == sorted(s.keystr for s in jlay.kv_specs)
    assert tlay.max_pages == jlay.max_pages and tlay.page_bytes() == jlay.page_bytes()
    jspec = {s.keystr: (i, s) for i, s in enumerate(jlay.kv_specs)}
    for spec in tlay.kv_specs:
        assert tuple(tlay.page_shape(spec)) == tuple(jlay.page_shape(jspec[spec.keystr][1]))
    rng = np.random.default_rng(7 + t)
    table = _tables(rng, tlay.max_pages, tlay.n_cols(tlay.kv_specs[0]))
    jcache, tcache = _dense_caches(jm, tm, tlay, SLOTS, seed=t)

    def same_pages(jpages, tpages, skip=(GRAVE,)):
        # GRAVE takes several rows' writes at once: which lands is not a
        # contract (it is never read), so it is left out
        keep = [p for p in range(tlay.num_pages) if p not in skip]
        for spec, tp in zip(tlay.kv_specs, tpages):
            jp = jpages[jspec[spec.keystr][0]]
            assert _bytes(tp[keep]) == _bytes(np.asarray(jp)[keep]), spec.keystr

    # scatter through the table, in place here and functionally in JAX
    jpages = jlay.scatter(jlay.fresh_pages(), jnp.asarray(table), jcache)
    tpages = tlay.scatter(tlay.fresh_pages("cpu"), torch.from_numpy(table), tcache)
    same_pages(jpages, tpages)
    # gather back through the same table
    jview = jlay.gather(jpages, jnp.asarray(table), jlay.scalars_of(jcache), impl="lax")
    tview = tlay.gather(tpages, torch.from_numpy(table))
    jflat = {_path(path): leaf for path, leaf in jax.tree_util.tree_flatten_with_path(jview)[0]}
    for spec in tlay.kv_specs:
        tv = getattr(tview.layers[spec.layer], spec.field)
        assert tuple(tv.shape) == tuple(jflat[spec.keystr].shape)
        assert _bytes(tv) == _bytes(jflat[spec.keystr]), spec.keystr
    # insert one prefilled row: private pages get its bytes, the rest GRAVE
    jrow, trow = _dense_caches(jm, tm, tlay, 1, seed=100 + t)
    wsel = np.where(rng.random(tlay.max_pages) < 0.6, table[1], GRAVE).astype(np.int32)
    wsel[0] = NULL if t == 8 else wsel[0]
    jpages = jlay.insert_rows(jpages, jnp.asarray(wsel), jrow)
    tpages = tlay.insert_rows(tpages, torch.from_numpy(wsel), trow)
    same_pages(jpages, tpages)
    # a span of table entries back as one (1, ...) row set
    ids = table[1, :3]
    jspan = jlay.gather_row_span(jpages, jnp.asarray(ids), width=3 * t - 1)
    tspan = tlay.gather_row_span(tpages, torch.from_numpy(ids), width=3 * t - 1)
    for i, spec in enumerate(tlay.kv_specs):
        assert _bytes(tspan[i]) == _bytes(jspan[jspec[spec.keystr][0]]), spec.keystr


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_page_gather_plain_equals_pallas_interpret(dtype):
    rng = np.random.default_rng(3)
    shape = (9, 2, 8, 128)
    if dtype == "int8":
        pages = rng.integers(-128, 128, size=shape).astype(np.int8)
        tp = torch.from_numpy(pages)
    else:
        pages = np.asarray(jnp.asarray(rng.normal(size=shape), jnp.bfloat16))
        tp = torch.from_numpy(pages.astype(np.float32)).to(torch.bfloat16)
    table = rng.integers(0, 9, size=(3, 4)).astype(np.int32)
    want = j_layout._gather_leaf_pallas(jnp.asarray(pages), jnp.asarray(table), interpret=True)
    got = page_gather(tp, torch.from_numpy(table))
    assert got.shape == (3, 4) + shape[1:]
    assert _bytes(got) == _bytes(want)
    assert torch.equal(got, page_gather_plain(tp, torch.from_numpy(table)))
    with pytest.raises(ValueError, match=r"\(S, MP\)"):
        page_gather(tp, torch.from_numpy(table[0]))
