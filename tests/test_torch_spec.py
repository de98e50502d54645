"""Speculative decoding in the port, on the CPU, against the JAX package:
``models/speculative.py`` (``ngram_propose``, ``speculative_generate``),
the continuous engine's speculative dispatch (``DecodeEngine(spec_k=)``)
on the dense and the paged layout, and the service's ``engine_spec_k``
and ``speculative`` batcher.

One weight set feeds both packages (``io.weights.init_params``, f32):
greedy ids and the (steps, emitted) of ``speculative_generate`` are equal
integers, the engines' logprobs agree within 1e-5 (both round to 5
decimals, so the rounded values may differ by one unit in the fifth).
"""

import functools
import queue
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlcomp_tpu.engine import DecodeEngine as JEngine
from mlcomp_tpu.models import create_model as j_create
from mlcomp_tpu.models.generation import generate as j_generate
from mlcomp_tpu.models.speculative import ngram_propose as j_ngram
from mlcomp_tpu.models.speculative import speculative_generate as j_spec
from mlcomp_tpu_torch.engine import DecodeEngine
from mlcomp_tpu_torch.io.weights import init_params
from mlcomp_tpu_torch.models import create_model
from mlcomp_tpu_torch.models.generation import generate, prep_decode_variables
from mlcomp_tpu_torch.models.speculative import ngram_propose, speculative_generate
from mlcomp_tpu_torch.ops.quant import quantize_params
from mlcomp_tpu_torch.serve import GenerationService

torch.set_num_threads(1)

# the fixture of tests/test_speculative.py
LM = {"name": "transformer_lm", "vocab_size": 96, "hidden": 128, "layers": 2, "heads": 2,
      "mlp_dim": 256, "dtype": "float32"}
LM_TREE = init_params(LM, seed=0)
# the int8-kernel fixture: widths the int8 kernel takes
LM_Q = {**LM, "vocab_size": 128, "hidden": 256, "mlp_dim": 512}
LM_Q_TREE = quantize_params(init_params(LM_Q, seed=0), min_size=1024)
# a greedy stream of random weights settles into a cycle: on these
# weights this repeated prompt's continuation cycles too (found by a seeded
# search), so the draft hits and verifies accept
REPEAT = [45, 48, 65] * 3


def _port_lm(cfg, tree, quant_kernel=False):
    return prep_decode_variables(create_model(cfg, device="cpu"), tree,
                                 quant_kernel=quant_kernel)


@functools.lru_cache(maxsize=None)
def _jax_spec_fn(cfg_items, n_new, spec_k, masked, eos, quant_kernel):
    model = j_create(dict(cfg_items))

    def run(v, prompt, mask):
        return j_spec(model, v, prompt, n_new, spec_k=spec_k, eos_id=eos,
                      prompt_mask=mask if masked else None, quant_kernel=quant_kernel,
                      with_stats=True)

    return jax.jit(run)


def _jax_spec(cfg, tree, prompt, n_new, spec_k, mask=None, eos=None, quant_kernel=False):
    fn = _jax_spec_fn(tuple(sorted(cfg.items())), n_new, spec_k, mask is not None, eos,
                      quant_kernel)
    v = {"params": jax.tree.map(jnp.asarray, tree)}
    out, st = fn(v, jnp.asarray(prompt), None if mask is None else jnp.asarray(mask))
    return np.asarray(out).tolist(), (int(st["steps"]), int(st["emitted"]))


# ------------------------------------------------------------ ngram_propose


def test_ngram_propose_equals_the_jax_proposer_row_by_row():
    """Seeded random histories over a 3-token vocabulary (bigrams recur
    often): the batched proposer gives, row by row, the JAX proposer's
    draft for every cursor and every first real slot."""
    rng = np.random.default_rng(0)
    b, t, k = 64, 24, 5
    ids = rng.integers(1, 4, (b, t))
    cur = rng.integers(1, t + 1, b)
    tok0 = rng.integers(1, 4, b)
    start = rng.integers(0, 8, b)
    got = ngram_propose(torch.from_numpy(ids), torch.from_numpy(cur), torch.from_numpy(tok0),
                        k, pad_id=0, start=torch.from_numpy(start)).numpy()
    jfn = jax.jit(jax.vmap(lambda i, c, t0, s: j_ngram(i, c, t0, k, 0, start=s)))
    want = np.asarray(jfn(jnp.asarray(ids, jnp.int32), jnp.asarray(cur, jnp.int32),
                          jnp.asarray(tok0, jnp.int32), jnp.asarray(start, jnp.int32)))
    np.testing.assert_array_equal(got, want)
    assert (got != 0).any() and (got == 0).all(axis=1).any()   # hits and misses both seen


def test_ngram_propose_hit_miss_clipped_window_and_pads():
    """The bigram (7, 9) at p = 1 proposes what followed it, clipped at
    the cursor; (7, 77) never occurs; a first real slot of 2 hides p = 1;
    (5, 7) at p = 0 under cursor 5.  Each row as the JAX proposer gives."""
    row = [5, 7, 9, 3, 5, 7, 2, 4, 0, 0]
    cases = ((6, 9, 0), (6, 77, 0), (6, 9, 2), (5, 7, 0))
    got = ngram_propose(torch.tensor([row] * 4), torch.tensor([c for c, _, _ in cases]),
                        torch.tensor([t for _, t, _ in cases]), 5,
                        start=torch.tensor([s for _, _, s in cases]))
    want = [np.asarray(j_ngram(jnp.asarray(row, jnp.int32), jnp.int32(c), jnp.int32(t), 5, 0,
                               start=jnp.int32(s))).tolist() for c, t, s in cases]
    assert got.tolist() == want
    assert want == [[3, 5, 7, 0, 0], [0] * 5, [0] * 5, [9, 3, 5, 0, 0]]


# ---------------------------------------------------- speculative_generate


SPEC_CASES = {
    # name: (cfg extras, prompt seed (None: REPEAT), n_new, spec_k, masked, eos at, kernel)
    "dense_kv": ({}, 2, 12, 4, False, None, False),
    "int8_kv": ({"kv_quant": True}, 2, 12, 4, False, None, False),
    "int8_weights_kernel": ({}, 3, 10, 3, False, None, True),
    "prompt_mask": ({"kv_quant": True}, 11, 10, 4, True, None, False),
    "eos": ({}, 7, 12, 4, False, 4, False),
    "budget_below_k": ({}, 5, 2, 6, False, None, False),
    "repetitive_prompt": ({}, None, 24, 4, False, None, False),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_speculative_generate_equals_the_jax_function(case):
    """Ids AND (steps, emitted) equal the JAX function's, and the ids
    equal the port's own greedy ``generate``.  The repetitive prompt must
    accept: fewer verifies than tokens."""
    extra, seed, n_new, k, masked, eos_at, kernel = SPEC_CASES[case]
    cfg = {**(LM_Q if kernel else LM), **extra}
    tree = LM_Q_TREE if kernel else LM_TREE
    model = _port_lm(cfg, tree, quant_kernel=kernel)
    mask = None
    if seed is None:
        prompt = np.asarray([REPEAT])
    elif masked:
        real = np.random.RandomState(seed).randint(1, cfg["vocab_size"], 5)
        prompt = np.zeros((1, 12), np.int64)
        prompt[0, -5:] = real
        mask = np.zeros((1, 12), bool)
        mask[0, -5:] = True
    else:
        prompt = np.random.RandomState(seed).randint(1, cfg["vocab_size"], (1, 8))
    eos = None
    if eos_at is not None:
        free = generate(model, torch.from_numpy(prompt), n_new)[0, prompt.shape[1]:]
        eos = int(free[eos_at])
    got, st = speculative_generate(model, torch.from_numpy(prompt), n_new, spec_k=k,
                                   prompt_mask=None if mask is None else torch.from_numpy(mask),
                                   eos_id=eos, with_stats=True)
    want, jst = _jax_spec(cfg, tree, prompt, n_new, k, mask=mask, eos=eos, quant_kernel=kernel)
    assert got.tolist() == want
    assert (st["steps"], st["emitted"]) == jst
    ref = generate(model, torch.from_numpy(prompt), n_new, eos_id=eos,
                   prompt_mask=None if mask is None else torch.from_numpy(mask))
    assert got.tolist() == ref.tolist()
    if case == "repetitive_prompt":
        assert st["emitted"] == n_new and st["steps"] < st["emitted"]


def test_speculative_generate_rejects_batches_and_bad_args():
    model = _port_lm(LM, LM_TREE)
    with pytest.raises(ValueError, match="single-sequence"):
        speculative_generate(model, torch.ones((2, 4), dtype=torch.long), 4)
    with pytest.raises(ValueError, match="spec_k"):
        speculative_generate(model, torch.ones((1, 4), dtype=torch.long), 4, spec_k=0)
    out = speculative_generate(model, torch.tensor([3, 4, 5]), 6, spec_k=3)
    assert out.shape == (1, 9)


# ------------------------------------------------------ the spec engine

ECFG = {"name": "transformer_lm", "vocab_size": 64, "hidden": 64, "layers": 2, "heads": 2,
        "mlp_dim": 128, "dtype": "float32"}
ETREE = init_params(ECFG, seed=0)
EKW = dict(prompt_buckets=(16,), max_new_cap=8, prefill_chunk=8)
# the engine fixture's cycling prompt: 8 tokens in 6 verifies at spec_k 3
CYCLE = [48, 5, 26] * 3
_RS = np.random.RandomState(1)
JOBS = [(_RS.randint(1, 64, n).tolist(), m) for n, m in ((5, 8), (9, 6), (13, 7))] + [
    (CYCLE, 8), ([3, 14, 15, 9, 2], 5)]


@functools.lru_cache(maxsize=None)
def _emodel(kv_quant):
    return _port_lm({**ECFG, "kv_quant": kv_quant}, ETREE)


def _jax_engine(kv_quant, **kw):
    jm = j_create({**ECFG, "kv_quant": kv_quant})
    return JEngine(jm, {"params": jax.tree.map(jnp.asarray, ETREE)}, **{**EKW, **kw})


def _run(eng, jobs, **req):
    try:
        futs = [eng.submit(p, n, **req) for p, n in jobs]
        res = [f.result(timeout=300) for f in futs]
        return res, eng.stats()
    finally:
        eng.close()


def test_a_verify_rows_attention_equals_the_row_decoded_alone():
    """§C7: row j of the chunk's plain version at the verify's width (S =
    4) is, bit for bit, the same query through the single-query plain
    version with its window ``[start, stop0 + j)``, at the engine fixture's
    widths (2 slots, 2 heads of 32, an int8 cache from ``quantize_kv``)."""
    from mlcomp_tpu_torch.ops.cuda import decode_attention as da
    rs = np.random.RandomState(0)
    b, s_q, h, dh, l_buf = 2, 4, 2, 32, 24
    for _ in range(10):
        q = torch.from_numpy(rs.randn(b, s_q, h, dh).astype(np.float32))
        k8, ks = da.quantize_kv(torch.from_numpy(rs.randn(b, h, l_buf, dh).astype(np.float32)))
        v8, vs = da.quantize_kv(torch.from_numpy(rs.randn(b, h, l_buf, dh).astype(np.float32)))
        ks, vs = ks[:, :, None], vs[:, :, None]
        start = torch.from_numpy(rs.randint(0, 4, b).astype(np.int32))
        stop0 = torch.from_numpy(rs.randint(8, l_buf - s_q + 2, b).astype(np.int32))
        chunk = da.decode_attention_chunk_plain(q, k8, ks, v8, vs, start, stop0, dh ** -0.5)
        for j in range(s_q):
            alone = da.decode_attention_plain(q[:, j], k8, ks, v8, vs, start, stop0 + j,
                                              dh ** -0.5)
            assert torch.equal(chunk[:, j], alone), j


def test_a_verify_rows_projections_equal_the_row_projected_alone():
    """§C7's second source: a projection's row inside the verify's 8 rows
    (2 slots x 4 tokens) is, bit for bit, the row a 2-row decode step
    gives, and the row alone; for the float ``Dense`` and the int8 plain
    version alike."""
    from mlcomp_tpu_torch.models.transformer import Dense
    from mlcomp_tpu_torch.ops.cuda import quant_matmul as qm
    rs = np.random.RandomState(0)
    dense = Dense((128,), 1, torch.float32)
    dense.kernel = torch.from_numpy(rs.randn(64, 128).astype(np.float32))
    x = torch.from_numpy(rs.randn(2, 4, 64).astype(np.float32))
    q8 = torch.from_numpy(rs.randint(-127, 128, (256, 128)).astype(np.int8))
    sc = torch.from_numpy(rs.rand(128).astype(np.float32))
    xq = torch.from_numpy(rs.randn(8, 256).astype(np.float32))
    with torch.inference_mode():
        verify = dense(x)
        step = dense(x[:, :1])
        assert torch.equal(verify[:, 0], step[:, 0])
        for j in range(4):
            assert torch.equal(verify[:, j], dense(x[:, j:j + 1])[:, 0]), j
            assert torch.equal(verify[1, j], dense(x[1:, j:j + 1])[0, 0]), j
        rows = qm.quant_matmul_plain(xq, q8, sc)
        for i in range(8):
            assert torch.equal(rows[i], qm.quant_matmul_plain(xq[i:i + 1], q8, sc)[0]), i
            assert torch.equal(rows[i & ~1:(i & ~1) + 2], qm.quant_matmul_plain(
                xq[i & ~1:(i & ~1) + 2], q8, sc))


@pytest.fixture(scope="module")
def jax_spec():
    """The JAX spec engine's results and spec stats on JOBS (2 slots, so
    admissions join running verifies), JAX ``generate``'s ids, and the JAX
    non-spec engine's results."""
    out = {}
    for kv_quant in (False, True):
        res, st = _run(_jax_engine(kv_quant, slots=2, spec_k=3), JOBS, logprobs=True)
        plain, _ = _run(_jax_engine(kv_quant, slots=2, steps_per_dispatch=1), JOBS,
                        logprobs=True)
        jm = j_create({**ECFG, "kv_quant": kv_quant})
        v = {"params": jax.tree.map(jnp.asarray, ETREE)}
        gen = jax.jit(lambda v, p, m, n: j_generate(jm, v, p, n, prompt_mask=m),
                      static_argnums=3)
        ref = []
        for p, n in JOBS:
            row = np.zeros((1, 16), np.int32)
            mask = np.zeros((1, 16), bool)
            row[0, 16 - len(p):] = p
            mask[0, 16 - len(p):] = True
            ref.append(np.asarray(gen(v, jnp.asarray(row), jnp.asarray(mask), n))[0, 16:].tolist())
        out[kv_quant] = (res, st["spec"], ref, plain)
    return out


@functools.lru_cache(maxsize=None)
def _port_plain_engine(kv_quant):
    """The port's non-spec engine on JOBS (K = 1)."""
    res, _ = _run(DecodeEngine(_emodel(kv_quant), slots=2, steps_per_dispatch=1, **EKW), JOBS,
                  logprobs=True)
    return res


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("fused", [True, False])
def test_spec_engine_equals_the_jax_spec_engine(jax_spec, kv_quant, layout, depth, fused):
    """Greedy ids equal the JAX spec engine's and JAX ``generate``'s,
    logprobs within 1e-5, and the acceptance block (``stats()["spec"]``)
    equals the JAX engine's: on both layouts, pipeline depths 1 and 2,
    fused admission (chunks riding verifies) on and off."""
    jres, jspec, ref, jplain = jax_spec[kv_quant]
    kw = dict(slots=2, spec_k=3, pipeline_depth=depth, fused_admission=fused)
    if layout == "paged":
        kw.update(kv_layout="paged", kv_page_tokens=4)
    res, st = _run(DecodeEngine(_emodel(kv_quant), **EKW, **kw), JOBS, logprobs=True)
    assert [r["ids"] for r in res] == [r["ids"] for r in jres] == ref
    lps = [np.asarray(r["logprobs"]) for r in res]
    cycle = JOBS.index((CYCLE, 8))
    for i, (r, j) in enumerate(zip(lps, jres)):
        if not (kv_quant and i == cycle):
            np.testing.assert_allclose(r, j["logprobs"], rtol=0, atol=1.1e-5, err_msg=str(i))
    if kv_quant:
        # int8 KV rounds each K/V value to a code, so an f32 value a few
        # ulps off can land on the other side of a rounding tie.  The JAX
        # spec engine equals its own non-spec engine; so must the port's, on
        # every job: a verify row gets the bits of the same token decoded
        # alone (ROADMAP §C7).  On the cycling prompt the two packages may
        # still round one code apart: the port's spec engine then differs
        # from the JAX one by what the non-spec engines differ by
        plain = [np.asarray(r["logprobs"]) for r in _port_plain_engine(kv_quant)]
        for i, (r, p) in enumerate(zip(lps, plain)):
            np.testing.assert_allclose(r, p, rtol=0, atol=1.1e-5, err_msg=str(i))
        d_spec = lps[cycle] - np.asarray(jres[cycle]["logprobs"])
        d_plain = plain[cycle] - np.asarray(jplain[cycle]["logprobs"])
        assert np.abs(d_plain).max() < 2e-4
        np.testing.assert_allclose(d_spec, d_plain, rtol=0, atol=1.1e-5)
    assert st["spec"] == jspec
    assert st["spec"]["acceptance_tokens_per_row"] > 1.0      # the repeat accepted
    assert st["steps"] == st["dispatches"]                    # one forward a verify
    if fused:
        assert st["fused_chunks"] > 0
    else:
        assert st["fused_chunks"] == 0


def _bucket_generate(ids, n_new, kv_quant=False, eos=None):
    row = np.zeros((1, 16), np.int64)
    mask = np.zeros((1, 16), bool)
    row[0, 16 - len(ids):] = ids
    mask[0, 16 - len(ids):] = True
    out = generate(_emodel(kv_quant), torch.from_numpy(row), n_new,
                   prompt_mask=torch.from_numpy(mask), eos_id=eos)
    return out[0, 16:].tolist()


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_spec_engine_mid_decode_join(layout):
    kw = {"kv_layout": "paged", "kv_page_tokens": 4} if layout == "paged" else {}
    eng = DecodeEngine(_emodel(True), slots=2, spec_k=3, **EKW, **kw)
    try:
        rs = np.random.RandomState(5)
        a = rs.randint(1, 64, 6).tolist()
        fa = eng.submit(a, 8)
        while eng.stats()["dispatches"] < 1:    # a is mid-decode
            pass
        b = rs.randint(1, 64, 10).tolist()
        fb = eng.submit(b, 8)
        assert fa.result(timeout=120)["ids"] == _bucket_generate(a, 8, True)
        assert fb.result(timeout=120)["ids"] == _bucket_generate(b, 8, True)
    finally:
        eng.close()


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_spec_engine_rows_at_the_buffer_edge_stay_exact(layout):
    """A max-bucket prompt running its whole budget writes a verify's
    K+1 positions up to the buffer's end: without the spec_k slots of
    slack its writes would clamp back onto its own K/V.  A second wave
    reuses the freed slots."""
    kw = {"kv_layout": "paged", "kv_page_tokens": 4} if layout == "paged" else {}
    rs = np.random.RandomState(11)
    full = rs.randint(1, 64, 16).tolist()
    short = rs.randint(1, 64, 5).tolist()
    eng = DecodeEngine(_emodel(True), slots=2, spec_k=3, **EKW, **kw)
    try:
        fa, fb = eng.submit(full, 8), eng.submit(short, 8)
        assert fa.result(timeout=120)["ids"] == _bucket_generate(full, 8, True)
        assert fb.result(timeout=120)["ids"] == _bucket_generate(short, 8, True)
        assert eng.submit(full, 8).result(timeout=120)["ids"] == _bucket_generate(full, 8, True)
    finally:
        eng.close()
    assert eng.l_buf == 16 + 8 + 3 + 1


def test_spec_engine_eos_and_budget_below_k():
    eng = DecodeEngine(_emodel(False), slots=2, spec_k=4, **EKW)
    try:
        p = [7, 3, 21, 9]
        free = eng.submit(p, 8).result(timeout=120)["ids"]
        assert free == _bucket_generate(p, 8)
        eos = free[3]
        got = eng.submit(p, 8, eos_id=eos).result(timeout=120)["ids"]
        want = _bucket_generate(p, 8, eos=eos)
        assert got == want[: want.index(eos) + 1]
        assert eng.submit(p, 2).result(timeout=120)["ids"] == free[:2]
    finally:
        eng.close()


@pytest.mark.parametrize("kv_quant", [False, True])
def test_an_imported_handoff_decodes_with_spec(jax_spec, kv_quant):
    """A prefill-only engine's handoff, imported by a paged spec engine
    (a decode replica may speculate): the JAX spec engine's ids, streamed
    as they land."""
    pre = DecodeEngine(_emodel(kv_quant), prefill_only=True, kv_page_tokens=4, **EKW)
    try:
        blobs = [pre.submit(p, n).result(timeout=120)["handoff"] for p, n in JOBS]
    finally:
        pre.close()
    dec = DecodeEngine(_emodel(kv_quant), slots=2, spec_k=3, kv_layout="paged",
                       kv_page_tokens=4, **EKW)
    try:
        q = queue.Queue()
        futs = [dec.import_pages(b, stream=q if i == 3 else None) for i, b in enumerate(blobs)]
        res = [f.result(timeout=120) for f in futs]
        streamed = []
        while (item := q.get(timeout=10)) is not None:
            streamed.append(item["token"])
        st = dec.stats()
    finally:
        dec.close()
    assert [r["ids"] for r in res] == [r["ids"] for r in jax_spec[kv_quant][0]]
    assert streamed == res[3]["ids"]
    assert st["handoffs_imported"] == len(JOBS) and st["spec"]["acceptance_tokens_per_row"] > 1


def test_spec_engine_rejections_match_the_jax_engine():
    m = _emodel(False)
    for eng in (DecodeEngine(m, slots=2, spec_k=3, **EKW), _jax_engine(False, slots=2, spec_k=3)):
        try:
            for bad in ({"temperature": 0.8}, {"repetition_penalty": 1.3}):
                with pytest.raises(ValueError, match="greedy-only"):
                    eng.submit([1, 2], 4, **bad)
        finally:
            eng.close()
    with pytest.raises(ValueError, match="spec_k"):
        DecodeEngine(m, spec_k=0, **EKW)
    with pytest.raises(ValueError, match="prefill_only"):
        DecodeEngine(m, prefill_only=True, spec_k=2, **EKW)


def test_spec_engine_warns_on_a_dead_steps_per_dispatch():
    m = _emodel(False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # the default must not warn
        eng = DecodeEngine(m, slots=2, spec_k=2, **EKW)
    assert eng.steps_per_dispatch == 1 and eng.k_ladder == (1,)
    eng.close()
    with pytest.warns(UserWarning, match="ignore steps_per_dispatch \\(got 4\\)"):
        DecodeEngine(m, slots=2, spec_k=2, steps_per_dispatch=4, **EKW).close()
    with pytest.warns(UserWarning, match="ignore steps_per_dispatch='adaptive'"):
        eng = DecodeEngine(m, slots=2, spec_k=2, steps_per_dispatch="adaptive", **EKW)
    assert not eng.adaptive_k and eng.steps_per_dispatch == 1
    eng.close()


def test_spec_engine_warns_past_the_64_row_decode_boundary():
    """slots*(spec_k+1) past GEMV_ROWS (64) takes the int8 verify off the
    decode kernel: warned at construction and at an elastic scale-up;
    8 x 8 = 64 and a float model stay silent."""
    q = _port_lm({**LM_Q, "kv_quant": True}, LM_Q_TREE, quant_kernel=True)
    with pytest.warns(UserWarning, match="fat-block"):
        DecodeEngine(q, slots=8, spec_k=8, **EKW).close()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        DecodeEngine(q, slots=8, spec_k=7, **EKW).close()
        DecodeEngine(_emodel(False), slots=8, spec_k=8, **EKW).close()
        eng = DecodeEngine(q, slots=8, max_slots=16, spec_k=7, kv_layout="paged",
                           kv_page_tokens=4, **EKW)
    eng.close()
    # the loop has exited: the resize runs on this thread
    with pytest.warns(UserWarning, match="elastic scale-up to 16 slots puts 128 rows"):
        eng._scale_slots(16)


def test_spec_net_gain_and_ineffective_as_the_jax_engine_reports():
    """``stats()["spec"]`` as the JAX engine's, the one-time net-LOSS
    warning at acceptance <= 1 past 64 row-forwards (sticky
    ``spec_ineffective``, gauge 1), no spec block off spec, and the service
    lifting the block to its top level for /healthz."""
    jobs = [([5, 6, 7, 8], 6), ([9, 2, 4], 6)]
    _, jst = _run(_jax_engine(False, slots=2, spec_k=3), jobs)
    eng = DecodeEngine(_emodel(False), slots=2, spec_k=3, **EKW)
    try:
        for f in [eng.submit(p, n) for p, n in jobs]:
            f.result(timeout=120)
        st = eng.stats()
        assert st["spec"] == jst["spec"]
        assert st["spec"]["spec_net_gain"] == pytest.approx(
            st["spec"]["acceptance_tokens_per_row"] - 1.0, abs=1e-3)
        eng._spec_warned = False
        eng._stats["spec_rows"] = 64
        eng._stats["emitted_tokens"] = 64
        with pytest.warns(UserWarning, match="net LOSS"):
            eng._maybe_warn_spec_loss()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            eng._maybe_warn_spec_loss()
        assert eng.stats()["spec"] == {"spec_k": 3, "acceptance_tokens_per_row": 1.0,
                                       "spec_net_gain": 0.0, "spec_ineffective": True}
        text = eng.metrics.render()
        assert "mlcomp_engine_spec_ineffective 1" in text
        assert "mlcomp_engine_spec_net_gain 0" in text
    finally:
        eng.close()
    eng = DecodeEngine(_emodel(False), slots=2, **EKW)
    try:
        assert "spec" not in eng.stats()
    finally:
        eng.close()
    svc = GenerationService(_emodel(False), ETREE, batch_sizes=(1, 2), prompt_buckets=(16,),
                            max_new_buckets=(8,), engine_spec_k=2)
    try:
        svc.generate([5, 6, 7], 4)
        st = svc.stats()
        assert st["spec"] is st["engine"]["spec"] and "spec_net_gain" in st["spec"]
    finally:
        svc.close()


def test_kv_bytes_moved_counts_one_forward_a_verify():
    spec = DecodeEngine(_emodel(True), slots=2, spec_k=3, **EKW)
    plain = DecodeEngine(_emodel(True), slots=2, steps_per_dispatch=4,
                         **{**EKW, "max_new_cap": 8 + 3})
    try:
        # the same buffer (the spec engine's l_buf carries K slots of
        # slack): one forward against four
        assert spec.l_buf == plain.l_buf
        assert 4 * spec._kv_bytes_moved_per_dispatch() == plain._kv_bytes_moved_per_dispatch()
    finally:
        spec.close()
        plain.close()


# ---------------------------------------------------------- the service


SVC = dict(batch_sizes=(1,), prompt_buckets=(16,), max_new_buckets=(8,))


def test_the_speculative_batcher_equals_the_jax_batcher():
    """``batcher="speculative"`` (B = 1, one ``speculative_generate`` a
    request): the JAX service's ids, trimmed at EOS, and its
    ``spec_tokens`` / ``spec_forwards``."""
    from mlcomp_tpu.serve import GenerationService as JService

    eos = _bucket_generate([7, 3, 21, 9], 8, True)[2]
    jobs = [(CYCLE, 8, None), ([7, 3, 21, 9], 8, None), ([7, 3, 21, 9], 8, eos)]
    svc = GenerationService(_emodel(True), ETREE, batcher="speculative", spec_k=4, **SVC)
    jsvc = JService(j_create({**ECFG, "kv_quant": True}),
                    {"params": jax.tree.map(jnp.asarray, ETREE)}, batcher="speculative",
                    spec_k=4, **SVC)
    try:
        got = [svc.generate(p, n, eos_id=e)["ids"] for p, n, e in jobs]
        want = [jsvc.generate(p, n, eos_id=e)["ids"] for p, n, e in jobs]
        assert got == want
        assert len(got[2]) == 3
        st, jst = svc.stats(), jsvc.stats()
        for key in ("spec_tokens", "spec_forwards", "batches", "batched_rows"):
            assert st[key] == jst[key], key
        assert st["spec_tokens"] > st["spec_forwards"] >= 3
        for bad, msg in (({"temperature": 0.5}, "greedy-only"),
                         ({"repetition_penalty": 1.2}, "repetition_penalty"),
                         ({"logprobs": True}, "logprobs")):
            with pytest.raises(ValueError, match=msg):
                svc.submit([1, 2], 4, **bad)
    finally:
        svc.close()
        jsvc.close()


def test_service_constraints_on_speculation():
    m = _emodel(False)
    for kw, msg in (({"batcher": "speculative", "spec_k": 0}, "spec_k"),
                    ({"batcher": "speculative", "temperature": 0.7}, "greedy-only"),
                    ({"batcher": "speculative", "repetition_penalty": 1.1},
                     "repetition_penalty"),
                    ({"batcher": "window", "engine_spec_k": 2}, "continuous"),
                    ({"engine_spec_k": 2, "temperature": 0.5}, "greedy-only"),
                    ({"phase": "prefill", "engine_spec_k": 2}, "prefill")):
        with pytest.raises(ValueError, match=msg):
            GenerationService(m, ETREE, **{**SVC, **kw})
    svc = GenerationService(m, ETREE, batcher="speculative", **SVC)
    try:
        assert svc.batch_sizes == (1,) and svc.spec_k == 8
        assert svc.warmup() == 1
        assert svc.stats()["spec_forwards"] == 0
    finally:
        svc.close()
