"""The port's continuous-batching DecodeEngine on the CPU, at the tiny f32
fixture of tests/test_engine.py (vocab 64, hidden 64, 2 layers, prompt
bucket 16, prefill chunk 8): against the JAX package's DecodeEngine fed
the same weights, against the port's own ``generate``, and against itself
under every schedule knob (pipeline depth, K, fused vs staged admission).

With a chunk of 8 in a bucket of 16, a 5-token prompt prefills its only
chunk at cache index 8 (the chunk kernel's path) and 9- or 13-token
prompts prefill a chunk at index 0 (flash attention) and one at 8.
"""

import queue
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlcomp_tpu.engine import DecodeEngine as JEngine
from mlcomp_tpu.models import create_model as j_create
from mlcomp_tpu_torch.engine import DeadlineExceeded, DecodeEngine, RequestCancelled
from mlcomp_tpu_torch.io.weights import init_params
from mlcomp_tpu_torch.models import create_model
from mlcomp_tpu_torch.models.generation import (
    _unit,
    generate,
    keyed_uniform,
    prep_decode_variables,
    sample_token_rowwise_keyed,
)

torch.set_num_threads(1)

CFG = {"name": "transformer_lm", "vocab_size": 64, "hidden": 64, "layers": 2, "heads": 2,
       "mlp_dim": 128, "dtype": "float32"}
TREE = init_params(CFG, seed=0)
ENGINE_KW = dict(prompt_buckets=(16,), max_new_cap=8, prefill_chunk=8)
PROMPTS = [np.random.RandomState(1).randint(1, 64, n).tolist() for n in (5, 9, 13)]
IDS_A = [3, 14, 15, 9, 2]
IDS_B = [7, 3, 44, 5, 6]


def _model(kv_quant=False):
    return prep_decode_variables(
        create_model({**CFG, "kv_quant": kv_quant}, device="cpu"), TREE)


def _run(eng, jobs, timeout=120):
    """Submit ``(prompt, n_new, knobs)`` jobs at once; the results in order."""
    try:
        futs = [eng.submit(p, n, **kw) for p, n, kw in jobs]
        return [f.result(timeout=timeout) for f in futs]
    finally:
        eng.close()


def _generate(model, ids, n_new):
    """Bare generate on the same left-padded bucket the engine uses."""
    row = np.zeros((1, 16), np.int64)
    mask = np.zeros((1, 16), bool)
    row[0, 16 - len(ids):] = ids
    mask[0, 16 - len(ids):] = True
    out = generate(model, torch.from_numpy(row), n_new, prompt_mask=torch.from_numpy(mask))
    return out[0, 16:].tolist()


@pytest.fixture(scope="module")
def jax_tokens():
    """Greedy tokens of the JAX DecodeEngine, once per module."""
    out = {}
    for kv_quant in (False, True):
        jm = j_create({**CFG, "kv_quant": kv_quant})
        eng = JEngine(jm, {"params": jax.tree.map(jnp.asarray, TREE)}, slots=4, **ENGINE_KW)
        try:
            futs = [eng.submit(p, 6) for p in PROMPTS]
            out[kv_quant] = [f.result(timeout=600)["ids"] for f in futs]
        finally:
            eng.close()
    return out


@pytest.mark.parametrize("kv_quant", [False, True])
def test_greedy_tokens_equal_the_jax_engine(jax_tokens, kv_quant):
    got = _run(DecodeEngine(_model(kv_quant), slots=4, **ENGINE_KW),
               [(p, 6, {}) for p in PROMPTS])
    assert [r["ids"] for r in got] == jax_tokens[kv_quant]


@pytest.mark.parametrize("kv_quant", [False, True])
def test_engine_equals_generate(kv_quant):
    """One chunk per prompt (prefill_chunk = bucket): the admission is
    generate's prefill, the steps are its steps."""
    m = _model(kv_quant)
    got = _run(DecodeEngine(m, slots=4, **{**ENGINE_KW, "prefill_chunk": 16}),
               [(p, 6, {}) for p in PROMPTS])
    assert [r["ids"] for r in got] == [_generate(m, p, 6) for p in PROMPTS]


# greedy and sampled rows, with logprobs and a repetition penalty: the
# workload every schedule comparison below runs
JOBS = [(PROMPTS[0], 8, {"logprobs": True}),
        (PROMPTS[1], 6, {"temperature": 0.9, "top_k": 20, "logprobs": True}),
        (PROMPTS[2], 7, {"temperature": 1.2, "top_p": 0.9, "repetition_penalty": 1.3}),
        (IDS_A, 5, {"logprobs": True}),
        (IDS_B, 8, {"temperature": 0.7, "logprobs": True})]


def _schedule(**kw):
    """The workload on 2 slots (so admissions join a running decode)."""
    eng = DecodeEngine(_model(True), slots=2, **{**ENGINE_KW, **kw})
    res = _run(eng, JOBS)
    return [(r["ids"], r.get("logprobs")) for r in res], eng.stats()


def test_schedules_give_the_same_tokens():
    """Pipeline depth 1 == 2, adaptive K == pinned K = 1 == 4, fused ==
    staged admission: each request's tokens (greedy and sampled) and
    logprobs do not depend on how steps were grouped or when neighbours
    joined."""
    base, st = _schedule()
    # a pinned K issues only K = 4 dispatches (counted at issue; close may
    # drop the last one unread)
    assert set(st["dispatches_by_k"]) == {4} and st["fused_chunks"] > 0
    for kw in ({"pipeline_depth": 1}, {"steps_per_dispatch": 1},
               {"steps_per_dispatch": "adaptive"}, {"fused_admission": False}):
        got, st2 = _schedule(**kw)
        assert got == base, kw
    assert st2["fused_chunks"] == 0 and st2["prefill_chunks"] > 0


def test_one_slot_churns_through_more_requests_than_slots():
    m = _model(True)
    solo = [_generate(m, p, 5) for p, _, _ in JOBS]
    got = _run(DecodeEngine(m, slots=1, **ENGINE_KW), [(p, 5, {}) for p, _, _ in JOBS])
    assert [r["ids"] for r in got] == solo


def test_eos_during_fused_admission_matches_staged():
    """A hits EOS while B's admission chunks ride A's dispatches: A's slot
    frees and its stream ends, B's insert lands, and everything equals the
    staged path and generate.  (The JAX package's own test of this case
    fails on its tree, so it is not the reference here.)"""
    m = _model(False)
    ref_a = _generate(m, IDS_A, 8)
    eos_a = ref_a[1]
    want_a = ref_a[: ref_a.index(eos_a) + 1]
    results = {}
    for fused in (True, False):
        eng = DecodeEngine(m, slots=2, steps_per_dispatch=1,
                           **{**ENGINE_KW, "prefill_chunk": 2}, fused_admission=fused)
        try:
            qa: "queue.Queue" = queue.Queue()
            fa = eng.submit(IDS_A, 8, eos_id=eos_a, stream=qa)
            qa.get(timeout=60)                 # A is decoding
            fb = eng.submit(IDS_B, 6)          # 3 chunks of 2 after the skipped pads
            ra, rb = fa.result(timeout=60), fb.result(timeout=60)
            streamed = []
            while (item := qa.get(timeout=60)) is not None:
                streamed.append(item["token"])
            assert qa.empty()
            stats = eng.stats()
        finally:
            eng.close()
        assert ra["ids"] == want_a
        assert fused or stats["fused_chunks"] == 0
        results[fused] = (ra["ids"], rb["ids"])
    assert results[True] == results[False]
    assert results[True][1] == _generate(m, IDS_B, 6)


class _Slow(torch.nn.Module):
    """The model with a sleep per forward: a decode long enough to retire."""

    def __init__(self, model, delay=0.02):
        super().__init__()
        self.inner, self.delay = model, delay
        self.vocab_size, self.device = model.vocab_size, model.device

    def init_cache(self, b, max_len):
        return self.inner.init_cache(b, max_len)

    def forward(self, *a, **kw):
        time.sleep(self.delay)
        return self.inner(*a, **kw)


def test_deadline_retires_a_row_and_frees_its_slot():
    # a chunk and 8 steps of 0.2 s cannot finish inside the 1.5 s deadline;
    # the first token lands after ~0.4 s (depth 1 reads each step back)
    eng = DecodeEngine(_Slow(_model(), delay=0.2), slots=1, steps_per_dispatch=1,
                       pipeline_depth=1, **ENGINE_KW)
    try:
        q: "queue.Queue" = queue.Queue()
        fut = eng.submit(IDS_A, 8, stream=q, deadline_s=1.5)
        assert q.get(timeout=60) is not None   # it decodes, then runs out of time
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=60)
        assert eng.stats()["deadline_exceeded"] == 1
        # the freed slot serves the next request (queued behind it until now)
        assert len(eng.submit(IDS_B, 2).result(timeout=60)["ids"]) == 2
        assert eng.stats()["active_slots"] == 0
    finally:
        eng.close()


def test_cancel_frees_the_slot():
    eng = DecodeEngine(_Slow(_model(), delay=0.2), slots=1, steps_per_dispatch=1, **ENGINE_KW)
    try:
        q: "queue.Queue" = queue.Queue()
        fut = eng.submit(IDS_A, 8, stream=q)
        assert q.get(timeout=60) is not None     # decoding
        assert eng.cancel(fut.rid)
        with pytest.raises(RequestCancelled):
            fut.result(timeout=60)
        assert eng.stats()["cancelled"] == 1 and not eng.cancel(fut.rid)
        assert len(eng.submit(IDS_B, 2).result(timeout=60)["ids"]) == 2
    finally:
        eng.close()


def test_close_fails_every_pending_request_exactly_once():
    eng = DecodeEngine(_Slow(_model(), delay=0.05), slots=1, **ENGINE_KW)
    streams = [queue.Queue() for _ in range(4)]
    futs = [eng.submit(IDS_A, 8, stream=q) for q in streams]
    streams[0].get(timeout=60)          # one row decoding, three queued
    eng.close()
    # the decoding row may finish inside the boundary close() waits for
    for fut in futs[1:]:
        with pytest.raises(RuntimeError, match="closed"):
            fut.result(timeout=10)
    for fut, q in zip(futs, streams):
        assert fut.done()
        tail = []
        while not q.empty():
            tail.append(q.get_nowait())
        assert tail.count(None) == 1 and tail[-1] is None
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(IDS_B, 2)


def test_engine_needs_its_model_device_and_validates():
    eng = DecodeEngine(_model(), slots=1, **ENGINE_KW)
    try:
        with pytest.raises(ValueError, match="exceeds the engine cap"):
            eng.submit(IDS_A, 9)
        with pytest.raises(ValueError, match="exceeds"):
            eng.submit([1] * 17, 2)
        with pytest.raises(ValueError, match="deadline_s"):
            eng.submit(IDS_A, 2, deadline_s=0)
    finally:
        eng.close()
    with pytest.raises(ValueError, match="adaptive"):
        DecodeEngine(_model(), steps_per_dispatch="fast", **ENGINE_KW)


def test_keyed_sampler_matches_softmax_and_is_a_pure_function():
    """20000 draws over an 8-token vocabulary, one per (request seed,
    position) key, against softmax(logits): chi-square with 7 degrees of
    freedom under 24.32, its 0.999 quantile (a correct sampler fails one
    run in a thousand).  The same key gives the same draw in any batch."""
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 0.2, 1.5])
    n = 20000
    rseed = torch.arange(n) % 97
    pos = torch.arange(n) // 97
    temp = torch.ones(n)
    tok = sample_token_rowwise_keyed(3, rseed, pos, logits.expand(n, 8), temp,
                                     torch.full((n,), 8), torch.ones(n))
    counts = torch.bincount(tok, minlength=8).double()
    expect = torch.softmax(logits.double(), -1) * n
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 24.32, (chi2, counts.tolist())
    # a pure function of (seed, request seed, position): any subset, order
    u = keyed_uniform(3, rseed, pos, 8)
    idx = torch.tensor([5, 17, 4000, 3])
    torch.testing.assert_close(keyed_uniform(3, rseed[idx], pos[idx], 8), u[idx], rtol=0, atol=0)
    assert not torch.equal(keyed_uniform(4, rseed[idx], pos[idx], 8), u[idx])
    assert 0.0 < float(u.min()) and float(u.max()) < 1.0
    # greedy rows ignore the key
    g = sample_token_rowwise_keyed(3, rseed[:4], pos[:4], logits.expand(4, 8), torch.zeros(4),
                                   torch.full((4,), 8), torch.ones(4))
    assert g.tolist() == [0, 0, 0, 0]


def test_keyed_draws_never_reach_one_and_top_k_1_is_greedy():
    """The extreme hashes give uniforms strictly inside (0, 1), so every
    race term is finite; over a 32768-token vocabulary and 64 keys, a
    sampled row with top_k = 1 always takes the greedy token."""
    u = _unit(torch.tensor([0, 1 << 8, (1 << 32) - 1], dtype=torch.int64))
    assert 0.0 < float(u.min()) and float(u.max()) < 1.0
    assert bool(torch.isfinite(torch.log(-torch.log(u))).all())
    n, v = 64, 32768
    logits = torch.from_numpy(np.random.default_rng(5).standard_normal((n, v))).float()
    rseed, pos = torch.arange(n) % 7, torch.arange(n)
    u = keyed_uniform(11, rseed, pos, v)
    assert 0.0 < float(u.min()) and float(u.max()) < 1.0
    tok = sample_token_rowwise_keyed(11, rseed, pos, logits, torch.full((n,), 1.3),
                                     torch.ones(n, dtype=torch.int64), torch.ones(n))
    assert tok.tolist() == logits.argmax(-1).tolist()


def test_streams_end_with_the_final_result():
    eng = DecodeEngine(_model(True), slots=2, **ENGINE_KW)
    try:
        q: "queue.Queue" = queue.Queue()
        fut = eng.submit(PROMPTS[0], 7, logprobs=True, stream=q)
        streamed = []
        while (item := q.get(timeout=60)) is not None:
            streamed.append(item)
        final = fut.result(timeout=60)
    finally:
        eng.close()
    assert [s["token"] for s in streamed] == final["ids"]
    assert [s["logprob"] for s in streamed] == final["logprobs"]
    steps = [s["step"] for s in streamed]
    assert steps == sorted(steps) and len(set(steps)) == len(steps)


def test_a_loop_that_dies_fails_submits_fast():
    class Dying(DecodeEngine):
        def _loop_body(self):
            raise RuntimeError("no device")

    eng = Dying(_model(), slots=1, **ENGINE_KW)
    eng._thread.join(timeout=10)
    try:
        assert not eng.healthy and "no device" in eng.stats()["watchdog"]["unhealthy_reason"]
        with pytest.raises(RuntimeError, match="down"):
            eng.submit(IDS_A, 2)
    finally:
        eng.close()


# ------------------------------------------------------------ paged layout

def _paged(model, slots=2, t=4, **kw):
    return DecodeEngine(model, slots=slots, kv_layout="paged", kv_page_tokens=t,
                        **{**ENGINE_KW, **kw})


def _quiesced(eng, timeout=10.0):
    """Wait until every page is free again (rows retire at boundaries)."""
    pool = eng._pool
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if pool.alloc.free_pages == pool.alloc.total_pages:
            break
        time.sleep(0.02)
    pool.check_invariants()
    return pool.alloc.free_pages == pool.alloc.total_pages


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("t", [4, 8])
def test_paged_greedy_tokens_equal_the_jax_dense_engine(jax_tokens, kv_quant, depth, t):
    """The paged engine against the JAX package's DENSE engine (JAX holds
    paged == dense within itself).  T = 4 puts 32 pages in one of the int8
    kernel's 128-slot blocks; the bf16 family's 25-slot buffer ends inside
    a page."""
    eng = _paged(_model(kv_quant), slots=4, t=t, max_slots=4, pipeline_depth=depth)
    got = _run(eng, [(p, 6, {}) for p in PROMPTS])
    assert [r["ids"] for r in got] == jax_tokens[kv_quant]
    assert _quiesced(eng)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_paged_equals_dense_sampled_tokens_included(kv_quant):
    """Within the port: the same workload on the paged layout (2 slots,
    no elastic growth) gives the dense layout's tokens and logprobs,
    greedy and sampled, at depth 1 and 2."""
    eng = DecodeEngine(_model(kv_quant), slots=2, **ENGINE_KW)
    base = [(r["ids"], r.get("logprobs")) for r in _run(eng, JOBS)]
    for depth in (1, 2):
        eng = _paged(_model(kv_quant), max_slots=2, pipeline_depth=depth)
        got = [(r["ids"], r.get("logprobs")) for r in _run(eng, JOBS)]
        assert got == base, depth
        assert _quiesced(eng)


def test_paged_elastic_slots_grow_and_shrink():
    """A 1-slot floor with page headroom grows 1 -> 2 -> 4 under queued
    traffic (the same tokens as a 4-slot dense engine) and shrinks back to
    the floor at quiesce."""
    prompts = [np.random.RandomState(3).randint(1, 64, size=10).tolist() for _ in range(5)]
    jobs = [(p, 8, {"logprobs": True}) for p in prompts]
    dense = _run(DecodeEngine(_model(), slots=4, **ENGINE_KW), jobs)
    # one step per dispatch: the first rows still decode when the queue
    # waits behind two full slots
    eng = DecodeEngine(_model(), slots=1, kv_layout="paged", kv_page_tokens=4, max_slots=4,
                       kv_pages=2 + 64, steps_per_dispatch=1, **ENGINE_KW)
    try:
        got = [eng.submit(p, n, **kw) for p, n, kw in jobs]
        got = [f.result(timeout=120) for f in got]
        st = eng.stats()
        t0 = time.perf_counter()
        while len(eng._host) != 1 and time.perf_counter() - t0 < 10:
            time.sleep(0.02)
        assert len(eng._host) == 1 and eng.stats()["slots_scaled"] >= 3
    finally:
        eng.close()
    assert [(r["ids"], r["logprobs"]) for r in got] == [(r["ids"], r["logprobs"]) for r in dense]
    assert st["slots_scaled"] >= 2 and st["max_slots"] == 4 and st["live_slots"] == 4


def test_paged_admission_defers_while_pages_are_short():
    """The gate budgets a request's INITIAL pages: the second request,
    whose initial need exceeds what the first leaves free, waits (FIFO)
    and decodes after the first retires, with the dense layout's tokens."""
    ids_b = [7, 3, 44, 5, 6, 9, 2, 41, 8, 30, 31, 32, 33, 34, 35]
    probe = _paged(_model(), max_slots=2)
    need_a = probe._pages_worst({"ids": IDS_A, "n_new": 6})
    need_b = probe._pages_initial({"ids": ids_b, "n_new": 6})
    pool_pages = max(need_a, probe._layout.max_pages)
    probe.close()
    assert need_b > pool_pages - need_a          # the geometry makes B wait
    want = _run(DecodeEngine(_model(), slots=2, **ENGINE_KW), [(IDS_A, 6, {}), (ids_b, 6, {})])
    eng = _paged(_model(), max_slots=2, kv_pages=2 + pool_pages)
    try:
        qa, qb = queue.Queue(), queue.Queue()
        fa, fb = eng.submit(IDS_A, 6, stream=qa), eng.submit(ids_b, 6, stream=qb)
        ra, rb = fa.result(timeout=120), fb.result(timeout=120)
        steps = [[item["step"] for item in iter(q.get_nowait, None)] for q in (qa, qb)]
        assert max(steps[0]) < min(steps[1])     # B decoded only after A retired
        assert eng.stats()["kv_decode_page_failures"] == 0 and _quiesced(eng)
    finally:
        eng.close()
    assert [ra["ids"], rb["ids"]] == [r["ids"] for r in want]


def test_paged_request_larger_than_the_pool_fails_typed():
    """The gate's bound: a head request whose worst case exceeds the whole
    pool fails with NoFreePages instead of waiting forever (unreachable
    through a validated constructor, so driven on a parked loop)."""
    from concurrent.futures import Future

    from mlcomp_tpu_torch.engine import _POISON
    from mlcomp_tpu_torch.kvpool import NoFreePages

    eng = _paged(_model())
    try:
        eng._stop.set()
        eng._queue.put(_POISON)
        eng._thread.join(timeout=30)
        fut = Future()
        eng._pending.append({"ids": IDS_A, "n_new": 6, "future": fut, "stream": None,
                             "rid": 0})
        eng._pages_worst = lambda r: eng._pool.alloc.total_pages + 1
        assert eng._pop_admittable() is None and not eng._pending
        with pytest.raises(NoFreePages):
            fut.result(timeout=10)
    finally:
        eng.close()


def test_paged_lazy_crossing_on_a_dry_pool_fails_only_the_starved_row():
    """Both rows fit the gate at their initial need, but not both of their
    whole spans: at a page crossing with no page left the starved row fails
    with NoFreePages, its pages free, and the other finishes with the
    dense layout's tokens."""
    from mlcomp_tpu_torch.kvpool import NoFreePages

    want = _run(DecodeEngine(_model(), slots=2, **ENGINE_KW), [(IDS_A, 8, {}), (IDS_B, 8, {})])
    probe = _paged(_model(), steps_per_dispatch=1)
    total = probe._layout.max_pages
    assert 2 * probe._pages_initial({"ids": IDS_A, "n_new": 8}) <= total
    assert 2 * probe._pages_worst({"ids": IDS_A, "n_new": 8}) > total
    probe.close()
    # slow forwards: B is queued before A's first decode dispatch
    eng = DecodeEngine(_Slow(_model(), delay=0.02), slots=2, kv_layout="paged",
                       kv_page_tokens=4, kv_pages=2 + total, max_slots=2,
                       steps_per_dispatch=1, **ENGINE_KW)
    try:
        futs = [eng.submit(IDS_A, 8), eng.submit(IDS_B, 8)]
        outcomes = []
        for f in futs:
            try:
                outcomes.append(f.result(timeout=120)["ids"])
            except NoFreePages as e:
                outcomes.append(e)
        assert eng.stats()["kv_decode_page_failures"] == 1 and _quiesced(eng)
    finally:
        eng.close()
    failed = [i for i, o in enumerate(outcomes) if isinstance(o, NoFreePages)]
    assert len(failed) == 1
    ok = 1 - failed[0]
    assert outcomes[ok] == want[ok]["ids"]


def test_paged_churn_with_cancels_and_deadlines_leaks_no_page():
    gen = np.random.RandomState(7)
    eng = DecodeEngine(_Slow(_model(True), delay=0.01), slots=2, kv_layout="paged",
                       kv_page_tokens=8, max_slots=4, kv_pages=2 + 48, **ENGINE_KW)
    try:
        futs = [eng.submit(gen.randint(1, 64, size=int(gen.randint(1, 15))).tolist(),
                           int(gen.randint(1, 9)), deadline_s=(0.15 if i == 7 else None))
                for i in range(10)]
        eng.cancel(futs[5].rid)
        done = 0
        for f in futs:
            try:
                f.result(timeout=120)
                done += 1
            except (RequestCancelled, DeadlineExceeded):
                pass
        assert done >= 8
        assert _quiesced(eng)
        st = eng.stats()["kv_pool"]
        assert st["pages_free"] == st["pages_total"] and st["allocs"] == st["frees"] > 0
    finally:
        eng.close()


def test_paged_construction_validation():
    with pytest.raises(ValueError, match="kv_layout"):
        DecodeEngine(_model(), kv_layout="paged123", **ENGINE_KW)
    with pytest.raises(ValueError, match="max_slots"):
        DecodeEngine(_model(), slots=2, max_slots=8, **ENGINE_KW)
    with pytest.raises(ValueError, match="kv_page_tokens"):
        DecodeEngine(_model(), kv_pages=64, **ENGINE_KW)
    with pytest.raises(ValueError, match="divide"):
        _paged(_model(), t=3)
    with pytest.raises(ValueError, match="below slots"):
        _paged(_model(), slots=4, max_slots=2)
    with pytest.raises(ValueError, match="worst-case"):
        _paged(_model(), kv_pages=2 + 1)
    eng = DecodeEngine(_model(), slots=2, kv_layout="paged", **ENGINE_KW)
    try:
        # the default page is the gcd of the chunk widths; the default pool
        # the dense layout's bytes; max_slots 4 x slots
        st = eng.stats()
        assert st["kv_pool"]["page_tokens"] == 8 and st["max_slots"] == 8
        assert st["kv_pool"]["pages_total"] == 2 * eng._layout.max_pages
    finally:
        eng.close()
