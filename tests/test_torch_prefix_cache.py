"""The port's host prefix cache (``mlcomp_tpu_torch/cache``) on the CPU,
held against the JAX package's on the same weights: the trie cases of
tests/test_prefix_cache.py run on both packages' ``PrefixIndex``; for one
request sequence (a cold prompt, its repeat, a shared prefix with a new
suffix, a shared prefix at another length) the port's greedy ids,
per-request ``cache_hit_tokens`` and cache stats (bytes stored included:
the leaves have the JAX package's shapes) equal the JAX engine's, for
f32 and int8 KV on the dense and the paged layout, and every hit's ids
equal a cache-off engine's; a capture taken while the next admission
reuses the admission cache keeps its own rows; the prefill-only export
feeds the cache as in JAX; and the service's ``/cache/stats``,
``cache_hit_tokens`` and warmup isolation.

The fixture is tests/test_prefix_cache.py's: vocab 64, hidden 64, 2
layers, prompt bucket 32, prefill chunk 8, f32 weights.
"""

import functools
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlcomp_tpu.cache import PrefixIndex as JPrefixIndex
from mlcomp_tpu.cache import PrefixKVCache as JPrefixKVCache
from mlcomp_tpu.cache.kv_store import KVBlock as JKVBlock
from mlcomp_tpu.engine import DecodeEngine as JEngine
from mlcomp_tpu.models import create_model as j_create
from mlcomp_tpu_torch.cache import PrefixIndex, PrefixKVCache
from mlcomp_tpu_torch.cache.kv_store import KVBlock
from mlcomp_tpu_torch.engine import DecodeEngine
from mlcomp_tpu_torch.io.weights import init_params
from mlcomp_tpu_torch.kvpool.transfer import decode_handoff
from mlcomp_tpu_torch.models import create_model
from mlcomp_tpu_torch.models.generation import prep_decode_variables
from mlcomp_tpu_torch.serve import load_service, make_http_server
from mlcomp_tpu_torch.utils import faults

torch.set_num_threads(1)

CFG = {"name": "transformer_lm", "vocab_size": 64, "hidden": 64, "layers": 2, "heads": 2,
       "mlp_dim": 128, "dtype": "float32"}
TREE = init_params(CFG, seed=0)
KW = dict(slots=2, prompt_buckets=(32,), max_new_cap=8, prefill_chunk=8)
PACKAGES = {"jax": (JPrefixIndex, JKVBlock), "torch": (PrefixIndex, KVBlock)}


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm_all()


# ----------------------------------------------------------- trie unit


def _block(cls, ids):
    """Self-checking block: the payload IS the ids, so slice/split
    bookkeeping errors surface as token mismatches."""
    return cls({"ids": np.asarray(list(ids), np.int64)[None]}, {"ids": 1}, len(ids))


def _lease_ids(lease):
    out = []
    for block, take in lease.segments:
        out.extend(block.arrays["ids"][0, :take].tolist())
    return out


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_trie_longest_prefix_match_and_split(pkg):
    Index, Block = PACKAGES[pkg]
    idx = Index(1 << 20)
    assert idx.lookup([1, 2, 3]) is None
    idx.insert([1, 2, 3, 4], _block(Block, [1, 2, 3, 4]))
    with idx.lookup([1, 2, 3, 9]) as lease:
        assert lease.tokens == 3 and _lease_ids(lease) == [1, 2, 3]
    # divergence mid-edge splits the node; both arms stay reachable
    idx.insert([1, 2, 7, 8], _block(Block, [1, 2, 7, 8]))
    idx.check_invariants()
    with idx.lookup([1, 2, 7, 8, 5]) as lease:
        assert lease.tokens == 4 and _lease_ids(lease) == [1, 2, 7, 8]
    with idx.lookup([1, 2, 3, 4]) as lease:
        assert lease.tokens == 4 and _lease_ids(lease) == [1, 2, 3, 4]
    # dedup: re-inserting an existing prefix stores nothing new
    assert idx.insert([1, 2, 3], _block(Block, [1, 2, 3])) == 0
    # offset insert: the block covers only the new suffix
    assert idx.insert([1, 2, 3, 4, 5, 6], _block(Block, [5, 6]), offset=4) == 2
    with idx.lookup([1, 2, 3, 4, 5, 6]) as lease:
        assert _lease_ids(lease) == [1, 2, 3, 4, 5, 6]


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_trie_lru_eviction_under_byte_budget(pkg):
    Index, Block = PACKAGES[pkg]
    idx = Index(7 * 8)        # int64 payload: 8 bytes a token, 7 tokens
    idx.insert([1, 2, 3], _block(Block, [1, 2, 3]))
    idx.insert([5, 6, 7], _block(Block, [5, 6, 7]))
    idx.lookup([1, 2, 3]).release()          # [5, 6, 7] is now LRU
    idx.insert([8, 9], _block(Block, [8, 9]))  # 8 tokens > 7: evict the LRU
    idx.check_invariants()
    st = idx.stats()
    assert st["evictions"] == 1 and st["bytes"] <= 7 * 8
    assert idx.lookup([5, 6, 7]) is None
    assert idx.lookup([1, 2, 3]).tokens == 3


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_trie_refcount_pins_against_eviction(pkg):
    Index, Block = PACKAGES[pkg]
    idx = Index(6 * 8)
    idx.insert([1, 2, 3], _block(Block, [1, 2, 3]))
    lease = idx.lookup([1, 2, 3])
    # everything unpinned goes before the lease's nodes; the pinned data
    # stays intact even while over budget
    idx.insert([7] * 6, _block(Block, [7] * 6))
    idx.check_invariants()
    assert _lease_ids(lease) == [1, 2, 3]
    with idx.lookup([1, 2, 3]) as again:
        assert again.tokens == 3
    lease.release()
    lease.release()  # idempotent
    idx.evict_to_budget()
    assert idx.stats()["pinned_nodes"] == 0
    assert idx.stats()["bytes"] <= 6 * 8


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_trie_concurrent_eviction_race(pkg):
    """Racing lookups/inserts/evictions under a tiny budget: pinned leases
    keep their bytes, invariants hold throughout, refcounts return to 0."""
    Index, Block = PACKAGES[pkg]
    idx = Index(40 * 8)
    errs = []

    def worker(seed):
        rs = np.random.RandomState(seed)
        try:
            for _ in range(200):
                ids = rs.randint(1, 5, rs.randint(1, 12)).tolist()
                if rs.rand() < 0.5:
                    idx.insert(ids, _block(Block, ids))
                else:
                    lease = idx.lookup(ids)
                    if lease is not None:
                        want = ids[: lease.tokens]
                        idx.evict_to_budget()  # pressure WHILE pinned
                        assert _lease_ids(lease) == want
                        lease.release()
                idx.check_invariants()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        raise errs[0]
    idx.check_invariants()
    assert idx.stats()["pinned_nodes"] == 0
    idx.evict_to_budget()
    assert idx.stats()["bytes"] <= 40 * 8


# ------------------------------------------------- engines, both packages


def _sequence():
    rs = np.random.RandomState(5)
    ids = rs.randint(1, 64, 28).tolist()
    ids2 = ids[:20] + rs.randint(1, 64, 8).tolist()   # shared prefix, new suffix
    ids3 = ids[:20] + rs.randint(1, 64, 4).tolist()   # shared prefix, another length
    return [ids, ids, ids2, ids3]


@functools.lru_cache(maxsize=None)
def _model(kv_quant=False):
    return prep_decode_variables(create_model({**CFG, "kv_quant": kv_quant}, device="cpu"),
                                 TREE)


def _run(eng, flush):
    """The sequence one request at a time, each capture landed before the
    next lookup; (ids, cache_hit_tokens) per request and the cache stats."""
    out = []
    for ids in _sequence():
        r = eng.submit(ids, 6).result(timeout=600)
        out.append((r["ids"], r.get("cache_hit_tokens")))
        flush()
    st = eng.stats()
    return out, st.get("prefix_cache"), st["cache_degraded"]


@functools.lru_cache(maxsize=None)
def _jax_run(kv_quant, layout):
    jm = j_create({**CFG, "kv_quant": kv_quant})
    cache = JPrefixKVCache(max_bytes=64 << 20)
    eng = JEngine(jm, {"params": jax.tree.map(jnp.asarray, TREE)}, kv_layout=layout,
                  prefix_cache=cache, **KW)
    try:
        return _run(eng, cache.flush)
    finally:
        eng.close()


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_hits_give_the_cold_tokens_and_the_jax_engines_numbers(kv_quant, layout):
    """The acceptance bar: each repeat hits (the registry first on the
    paged layout, the host cache across placements) and emits exactly the
    cache-off engine's tokens; the port's ids, hit tokens and cache stats
    equal the JAX engine's for the same sequence."""
    want, want_stats, _ = _jax_run(kv_quant, layout)
    cache = PrefixKVCache(max_bytes=64 << 20)
    eng = DecodeEngine(_model(kv_quant), kv_layout=layout, prefix_cache=cache, **KW)
    cold = DecodeEngine(_model(kv_quant), kv_layout=layout, **KW)
    try:
        got, got_stats, degraded = _run(eng, cache.flush)
        off, off_stats, _ = _run(cold, lambda: None)
    finally:
        eng.close()
        cold.close()
    assert got == want
    assert got_stats == want_stats
    assert degraded == 0
    hits = [h for _, h in got]
    # 28 real tokens, pad 4, chunk 8: the match caps at 27 -> chunk 3 ->
    # 3 * 8 - 4 = 20 tokens skipped
    assert hits[0] == 0 and hits[1] == 20 and all(h > 0 for h in hits[2:])
    assert [i for i, _ in got] == [i for i, _ in off] and off_stats is None
    assert got_stats["bytes"] > 0 and got_stats["used_hit_tokens"] > 0


@pytest.mark.parametrize("kv_quant", [False, True])
def test_a_capture_keeps_its_rows_while_the_next_admission_reuses_the_buffer(kv_quant):
    """The admission cache is one static buffer that the next admission
    zeroes and refills.  With the capture worker held back until a second
    prompt has been admitted and prefilled, the first prompt's stored rows
    must still equal those of an engine that served it alone."""
    first, second = _sequence()[0], list(range(40, 64))
    ref_cache = PrefixKVCache(max_bytes=64 << 20)
    ref = DecodeEngine(_model(kv_quant), prefix_cache=ref_cache, **KW)
    cache = PrefixKVCache(max_bytes=64 << 20)
    eng = DecodeEngine(_model(kv_quant), prefix_cache=cache, **KW)
    try:
        ref.submit(first, 2).result(timeout=600)
        ref_cache.flush()
        faults.arm("cache.capture", flavor="sleep", seconds=2.0, times=1)
        eng.submit(first, 2).result(timeout=600)
        eng.submit(second, 2).result(timeout=600)   # while the first capture sleeps
        assert cache.stats()["inserted_tokens"] == 0 or cache.stats()["capture_queue_depth"]
        cache.flush()
        assert cache.stats()["inserted_tokens"] == len(first) + len(second)
        with ref_cache.index.lookup(first) as a, cache.index.lookup(first) as b:
            assert a.tokens == b.tokens == len(first)
            (blk_a, _), = a.segments
            (blk_b, _), = b.segments
            assert sorted(blk_a.arrays) == sorted(blk_b.arrays)
            for key, arr in blk_a.arrays.items():
                np.testing.assert_array_equal(blk_b.arrays[key], arr)
    finally:
        ref.close()
        eng.close()


@functools.lru_cache(maxsize=None)
def _jax_export(kv_quant):
    jm = j_create({**CFG, "kv_quant": kv_quant})
    cache = JPrefixKVCache(max_bytes=64 << 20)
    eng = JEngine(jm, {"params": jax.tree.map(jnp.asarray, TREE)}, prefill_only=True,
                  prefix_cache=cache, **{**KW, "slots": 1})
    try:
        ids = _sequence()[0]
        res = []
        for _ in range(2):
            res.append(eng.submit(ids, 6).result(timeout=600)["cache_hit_tokens"])
            cache.flush()
        return res, eng.stats()["prefix_cache"]
    finally:
        eng.close()


@pytest.mark.parametrize("kv_quant", [False, True])
def test_the_prefill_only_export_feeds_the_cache(kv_quant):
    """A prefill replica's exports feed its host cache as in JAX: the
    repeat hits, its handoff carries the cold one's logits and real-token
    rows bit for bit (the pad slots before the prompt are zeros on a hit,
    never read), and hit tokens and cache stats equal the JAX prefill-only
    engine's."""
    want_hits, want_stats = _jax_export(kv_quant)
    cache = PrefixKVCache(max_bytes=64 << 20)
    eng = DecodeEngine(_model(kv_quant), prefill_only=True, prefix_cache=cache,
                       **{**KW, "slots": 1})
    try:
        ids = _sequence()[0]
        res = []
        for _ in range(2):
            res.append(eng.submit(ids, 6).result(timeout=600))
            cache.flush()
        stats = eng.stats()["prefix_cache"]
        specs = eng._export.kv_specs
    finally:
        eng.close()
    assert [r["cache_hit_tokens"] for r in res] == want_hits and want_hits[1] > 0
    assert stats == want_stats
    (m0, lg0, p0), (m1, lg1, p1) = (decode_handoff(r["handoff"]) for r in res)
    assert torch.equal(lg0, lg1) and len(p0) == len(p1) == len(specs)
    t, start_pad = m0["page_tokens"], m0["start_pad"]
    for spec, a, b in zip(specs, p0, p1):
        a, b = a.movedim(spec.slot_axis, 1), b.movedim(spec.slot_axis, 1)
        slot = torch.arange(a.shape[0])[:, None] * t + torch.arange(t)[None]
        real = slot >= start_pad
        assert real.sum() == len(ids) and torch.equal(a[real], b[real])


def test_the_engine_warns_when_no_bucket_can_hit():
    import warnings

    with pytest.warns(UserWarning, match="impossible"):
        eng = DecodeEngine(_model(), slots=2, prompt_buckets=(32,), max_new_cap=8,
                           prefix_cache=PrefixKVCache(max_bytes=1 << 20))
    eng.close()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # divisible buckets stay silent
        eng = DecodeEngine(_model(), prefix_cache=PrefixKVCache(max_bytes=1 << 20), **KW)
    eng.close()


def test_the_budget_evicts_and_serving_stays_exact():
    """A budget too small for the traffic evicts instead of growing, and
    every request keeps the cache-off tokens."""
    cache = PrefixKVCache(max_bytes=40_000)
    eng = DecodeEngine(_model(), prefix_cache=cache, **KW)
    cold = DecodeEngine(_model(), **KW)
    try:
        rs = np.random.RandomState(6)
        for _ in range(4):
            ids = rs.randint(1, 64, 28).tolist()
            got = eng.submit(ids, 4).result(timeout=600)
            assert got["ids"] == cold.submit(ids, 4).result(timeout=600)["ids"]
            cache.flush()
        st = eng.stats()["prefix_cache"]
    finally:
        eng.close()
        cold.close()
    assert st["evictions"] > 0 and st["bytes"] <= 40_000


# ------------------------------------------------------- service / HTTP


def test_service_cache_stats_hit_tokens_and_warmup_isolation():
    """GenerationService(prefix_cache=True): warmup stays out of the
    cache, results carry cache_hit_tokens, GET /cache/stats serves the
    counters; without the cache it answers 404 and the window batcher
    refuses the cache."""
    kw = dict(batch_sizes=(1, 2), prompt_buckets=(32,), max_new_buckets=(4, 8),
              prefill_chunk=8)
    svc = load_service(CFG, params=TREE, device="cpu", prefix_cache=True,
                       prefix_cache_bytes=64 << 20, **kw)
    httpd = make_http_server(svc, "127.0.0.1", 0, model_name="tiny")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        assert svc.warmup() > 0
        assert svc.cache_stats()["inserted_tokens"] == 0     # warmup excluded
        assert svc.stats()["requests"] == 0
        ids = _sequence()[0]

        def post():
            req = urllib.request.Request(
                url + "/generate", data=json.dumps({"prompt": ids, "max_new_tokens": 4}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                return json.loads(r.read())

        cold = post()
        svc.prefix_cache.flush()
        hot = post()
        assert cold["cache_hit_tokens"] == 0 and hot["cache_hit_tokens"] == 20
        assert hot["ids"] == cold["ids"]
        with urllib.request.urlopen(url + "/cache/stats", timeout=60) as r:
            stats = json.loads(r.read())
        assert stats["hits"] >= 1 and stats["bytes"] > 0 and stats["used_hits"] == 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
        svc.close()
    off = load_service(CFG, params=TREE, device="cpu", **kw)
    httpd = make_http_server(off, "127.0.0.1", 0, model_name="tiny")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        assert off.cache_stats() is None
        assert "cache_hit_tokens" not in off.generate(ids, 4)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{httpd.server_address[1]}/cache/stats",
                                   timeout=60)
        assert e.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
        off.close()
    with pytest.raises(ValueError, match="continuous"):
        load_service(CFG, params=TREE, device="cpu", batcher="window", prefix_cache=True, **kw)
