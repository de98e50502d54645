"""The decode side of disaggregated serving in the port, on the CPU: the
KV-page handoff wire format (``mlcomp_tpu_torch/kvpool/transfer.py``, a
copy of the JAX package's), the ``prefill_only`` engine's export, the
paged engine's ``import_pages``, the device prefix-page registry at
admission, and ``/prefill`` + ``/import`` over HTTP.

Held against the JAX package on one weight set (the tiny f32 fixture of
tests/test_disagg.py: vocab 64, hidden 64, 2 layers, prompt bucket 16,
prefill chunk 4, 4-token pages): the same bytes on the wire both ways, a
JAX prefill replica's blob decoded by the port's paged engine (and the
reverse) giving the JAX monolithic engine's greedy ids.  Within the port
it mirrors tests/test_disagg.py: an import equals a local admission (ids
and logprobs), imports interleave with local traffic and share their
pages copy-on-write, and every reject is typed and leaks nothing.
"""

import functools
import json
import queue
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mlcomp_tpu.engine import DecodeEngine as JEngine
from mlcomp_tpu.kvpool import transfer as jtransfer
from mlcomp_tpu.models import create_model as j_create
from mlcomp_tpu_torch.engine import DecodeEngine
from mlcomp_tpu_torch.io.weights import init_params
from mlcomp_tpu_torch.kvpool.transfer import (
    HandoffError,
    decode_handoff,
    encode_handoff,
    rows_to_page_tiles,
)
from mlcomp_tpu_torch.models import create_model
from mlcomp_tpu_torch.models.generation import prep_decode_variables
from mlcomp_tpu_torch.serve import BackpressureError, GenerationService, make_http_server

torch.set_num_threads(1)

CFG = {"name": "transformer_lm", "vocab_size": 64, "hidden": 64, "layers": 2, "heads": 2,
       "mlp_dim": 128, "dtype": "float32"}
TREE = init_params(CFG, seed=0)
KW = dict(prompt_buckets=(16,), max_new_cap=12, steps_per_dispatch=2, prefill_chunk=4)
IDS_A = [3, 14, 15, 9, 2, 6, 53, 58, 9, 7]
IDS_B = [7, 3, 44, 5, 6]


@functools.lru_cache(maxsize=None)
def _model(kv_quant=False, dtype="float32"):
    return prep_decode_variables(
        create_model({**CFG, "kv_quant": kv_quant, "dtype": dtype}, device="cpu"), TREE)


def _engine(kind, kv_quant=False, dtype="float32", **kw):
    kw = {**KW, **kw}
    if kind == "prefill":
        return DecodeEngine(_model(kv_quant, dtype), prefill_only=True, **kw)
    kw.setdefault("slots", 2)
    return DecodeEngine(_model(kv_quant, dtype), kv_layout="paged", **kw)


def _key(r):
    return r["ids"], r.get("logprobs")


def _export(kv_quant, ids, n_new, dtype="float32", **req):
    pre = _engine("prefill", kv_quant, dtype)
    try:
        res = pre.submit(ids, n_new, **req).result(timeout=120)
        st = pre.stats()
    finally:
        pre.close()
    assert st["handoffs_exported"] == 1
    assert st["kv_pages_exported"] == res["pages"] > 0
    assert st["handoff_bytes_exported"] == len(res["handoff"])
    return res["handoff"]


# ------------------------------------------------------------ wire format


def _wire_inputs():
    rng = np.random.default_rng(0)
    meta = {"s_bucket": 16, "start_pad": 6, "page_tokens": 4, "ids": [1, 2, 3], "n_new": 4,
            "leaves": [{"key": "a"}, {"key": "b"}, {"key": "c"}]}
    logits = rng.standard_normal((1, 8)).astype(np.float32)
    f32 = rng.standard_normal((3, 4, 2, 5)).astype(np.float32)
    i8 = rng.integers(-127, 128, (3, 2, 4, 8), dtype=np.int8)
    bf = np.asarray(rng.standard_normal((3, 2, 1, 4)), ml_dtypes.bfloat16)
    return meta, logits, f32, i8, bf


def _torch_bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)


def test_the_port_encodes_the_jax_packages_bytes():
    """Given the same inputs (f32 K/V, int8 codes, bf16 scales), the port's
    encoder writes the JAX package's bytes; a bf16 torch tensor goes out
    as its 2-byte words under the same "bfloat16" token."""
    meta, logits, f32, i8, bf = _wire_inputs()
    jblob = jtransfer.encode_handoff(meta, logits, [f32, i8, bf])
    assert encode_handoff(meta, logits, [f32, i8, _torch_bf16(bf)]) == jblob
    assert encode_handoff(meta, torch.from_numpy(logits),
                          [torch.from_numpy(f32), torch.from_numpy(i8), _torch_bf16(bf)]) == jblob
    # bf16 K/V leaves (a bf16 model's cache) alone
    kv = np.asarray(np.random.default_rng(3).standard_normal((2, 4, 2, 8)), ml_dtypes.bfloat16)
    assert (encode_handoff({"x": 1}, logits, [_torch_bf16(kv)])
            == jtransfer.encode_handoff({"x": 1}, logits, [kv]))


def test_a_jax_blob_decodes_to_equal_arrays():
    meta, logits, f32, i8, bf = _wire_inputs()
    m, lg, (a, b, c) = decode_handoff(jtransfer.encode_handoff(meta, logits, [f32, i8, bf]))
    assert m == {**meta, "version": 1}
    assert torch.equal(lg, torch.from_numpy(logits))
    assert a.dtype == torch.float32 and torch.equal(a, torch.from_numpy(f32))
    assert b.dtype == torch.int8 and torch.equal(b, torch.from_numpy(i8))
    assert c.dtype == torch.bfloat16 and c.shape == bf.shape
    assert torch.equal(c.view(torch.int16), torch.from_numpy(bf.view(np.int16)))
    # and the port's blob decodes in the JAX package to the same arrays
    jm, jlg, (ja, jb, jc) = jtransfer.decode_handoff(encode_handoff(meta, logits, [a, b, c]))
    np.testing.assert_array_equal(ja, f32)
    np.testing.assert_array_equal(jb, i8)
    assert jc.dtype == bf.dtype
    np.testing.assert_array_equal(jc.view(np.uint16), bf.view(np.uint16))


def test_wire_typed_rejects():
    """tests/test_disagg.py's rejects: every truncation point (inside the
    magic, the header length, the header, each array), trailing junk, a
    foreign magic, a foreign version and a non-bytes blob."""
    blob = encode_handoff({"s_bucket": 16}, np.zeros((1, 8), np.float32),
                          [np.zeros((2, 4, 2), np.float32)])
    for cut in (0, 4, 10, 30, len(blob) - 1):
        with pytest.raises(HandoffError):
            decode_handoff(blob[:cut])
        with pytest.raises(jtransfer.HandoffError):
            jtransfer.decode_handoff(blob[:cut])
    with pytest.raises(HandoffError):
        decode_handoff(blob + b"x")
    with pytest.raises(HandoffError):
        decode_handoff(b"NOTMAGIC" + blob[8:])
    with pytest.raises(HandoffError):
        decode_handoff(json.dumps({"version": 99}).encode())
    with pytest.raises(HandoffError):
        decode_handoff("not bytes")
    assert HandoffError.status == "bad_handoff" and issubclass(HandoffError, ValueError)


def test_rows_to_page_tiles_matches_the_jax_package():
    a = np.ascontiguousarray(np.arange(2 * 8 * 3, dtype=np.float32).reshape(1, 8, 6)[:, :, :3])
    tiles = rows_to_page_tiles(torch.from_numpy(a), 1, 4)
    assert tiles.shape == (2, 4, 3)
    np.testing.assert_array_equal(tiles.numpy(), jtransfer.rows_to_page_tiles(a, 1, 4))
    q = np.random.default_rng(1).integers(-127, 128, (1, 2, 12, 8), dtype=np.int8)
    np.testing.assert_array_equal(rows_to_page_tiles(torch.from_numpy(q), 2, 4).numpy(),
                                  jtransfer.rows_to_page_tiles(q, 2, 4))
    with pytest.raises(ValueError):
        rows_to_page_tiles(torch.from_numpy(a), 1, 3)


# ------------------------------------------------------ across the packages


_J_FNS: dict = {}


def _j_engine(kind, kv_quant, **kw):
    jm = j_create({**CFG, "kv_quant": kv_quant})
    kw = {**KW, **kw}
    if kind == "prefill":
        kw.update(prefill_only=True, slots=1)
    elif kind == "paged":
        kw.update(kv_layout="paged", slots=2)
    else:
        kw.update(slots=2)
    eng = JEngine(jm, {"params": jax.tree.map(jnp.asarray, TREE)}, **kw)
    pool = _J_FNS.setdefault((kind, kv_quant), {})
    eng._fns.update(pool)
    eng._fns_pool = pool
    return eng


def _j_close(eng):
    eng._fns_pool.update(eng._fns)
    eng.close()


@functools.lru_cache(maxsize=None)
def _jax_side(kv_quant):
    """The JAX monolithic engine's greedy ids of IDS_A and IDS_B, and a JAX
    prefill replica's blob of IDS_A."""
    mono = _j_engine("dense", kv_quant)
    try:
        want = [mono.submit(ids, 8).result(timeout=600)["ids"] for ids in (IDS_A, IDS_B)]
    finally:
        _j_close(mono)
    pre = _j_engine("prefill", kv_quant)
    try:
        blob = pre.submit(IDS_A, 8).result(timeout=600)["handoff"]
    finally:
        _j_close(pre)
    return want, blob


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_a_jax_prefill_blob_decodes_in_the_port(kv_quant, depth):
    """A JAX prefill_only engine's handoff, imported by the port's paged
    engine, gives the JAX monolithic engine's greedy ids (the JAX package's
    own two-hop test is load-sensitive, so the monolithic result is the
    reference), next to a local request of another prompt."""
    want, blob = _jax_side(kv_quant)
    dec = _engine("decode", kv_quant, pipeline_depth=depth)
    try:
        fa = dec.import_pages(blob)
        fb = dec.submit(IDS_B, 8)
        got = [fa.result(timeout=120)["ids"], fb.result(timeout=120)["ids"]]
        st = dec.stats()
    finally:
        dec.close()
    assert got == want
    assert st["handoffs_imported"] == 1 and st["kv_pages_imported"] == 3
    assert st["handoff_bytes_imported"] == len(blob) and st["handoff_rejects"] == 0


@pytest.mark.parametrize("kv_quant", [False, True])
def test_a_port_prefill_blob_decodes_in_the_jax_package(kv_quant):
    want, _ = _jax_side(kv_quant)
    blob = _export(kv_quant, IDS_A, 8)
    dec = _j_engine("paged", kv_quant)
    try:
        got = dec.import_pages(blob).result(timeout=600)["ids"]
        st = dec.stats()
    finally:
        _j_close(dec)
    assert got == want[0]
    assert st["handoffs_imported"] == 1 and st["handoff_rejects"] == 0


# ------------------------------------------------------------ within the port


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_import_equals_a_local_admission(kv_quant, depth):
    """Decode on imported pages gives a local admission's tokens AND
    logprobs bit for bit, for both cache families, at depth 1 and 2."""
    mono = _engine("decode", kv_quant, pipeline_depth=depth)
    try:
        r_mono = mono.submit(IDS_A, 8, logprobs=True).result(timeout=120)
    finally:
        mono.close()
    blob = _export(kv_quant, IDS_A, 8, logprobs=True)
    dec = _engine("decode", kv_quant, pipeline_depth=depth)
    try:
        r_imp = dec.import_pages(blob).result(timeout=120)
        st = dec.stats()
    finally:
        dec.close()
    assert _key(r_imp) == _key(r_mono)
    assert st["handoffs_imported"] == 1 and st["kv_pages_imported"] > 0
    assert st["handoff_rejects"] == 0


def test_import_streams_and_interleaves_with_local_traffic():
    mono = _engine("decode")
    try:
        r_a = mono.submit(IDS_A, 8).result(timeout=120)
        r_b = mono.submit(IDS_B, 6).result(timeout=120)
    finally:
        mono.close()
    blob = _export(False, IDS_A, 8)
    dec = _engine("decode")
    try:
        fb = dec.submit(IDS_B, 6)
        toks: "queue.Queue" = queue.Queue()
        fa = dec.import_pages(blob, stream=toks)
        r_imp, r_loc = fa.result(timeout=120), fb.result(timeout=120)
        streamed = []
        while (t := toks.get(timeout=30)) is not None:
            streamed.append(t)
    finally:
        dec.close()
    assert r_imp["ids"] == r_a["ids"] and r_loc["ids"] == r_b["ids"]
    assert [t["token"] for t in streamed] == r_a["ids"]


def test_import_registers_pages_for_cow_sharing():
    """Imported pages land in the device prefix-page registry as if this
    replica had prefilled them: a later local admission of the same prompt
    maps them copy-on-write (a registry hit) and decodes the same."""
    blob = _export(False, IDS_A, 8)
    dec = _engine("decode", kv_pages=48)
    try:
        r_imp = dec.import_pages(blob).result(timeout=120)
        r_loc = dec.submit(IDS_A, 8).result(timeout=120)
        st = dec.stats()
        pool = dec._pool.stats()
    finally:
        dec.close()
    assert r_loc["ids"] == r_imp["ids"]
    assert st["kv_registry_hit_tokens"] > 0 and pool["registry_hits"] == 1
    assert pool["shared_mappings"] > 0


@pytest.mark.parametrize("kv_quant,dtype", [(False, "float32"), (False, "bfloat16"),
                                            (True, "float32")])
def test_a_repeated_prompt_hits_the_registry_and_gives_the_cold_tokens(kv_quant, dtype):
    """On f32, bf16 and int8 (kv8) caches: the second admission of a
    prompt gathers its registered prefix pages into the admission cache,
    skips their chunks (counted in kv_registry_hit_tokens) and gives the
    cold run's tokens and logprobs; the pool's books stay balanced."""
    eng = _engine("decode", kv_quant, dtype)
    try:
        cold = eng.submit(IDS_A, 8, logprobs=True).result(timeout=120)
        assert eng.stats()["kv_registry_hit_tokens"] == 0
        warm = eng.submit(IDS_A, 8, logprobs=True).result(timeout=120)
        other = eng.submit(IDS_A[:-1] + [11], 8).result(timeout=120)
        st = eng.stats()
        eng._pool.check_invariants()
    finally:
        eng.close()
    # 10 tokens at pad 6 in chunks of 4: chunks 1 and 2 (slots 4-11) are
    # cached, the last token's chunk 3 runs: 12 - 6 = 6 tokens, twice
    assert _key(warm) == _key(cold)
    assert st["kv_registry_hit_tokens"] == 12
    assert len(other["ids"]) == 8
    assert st["kv_pool"]["outstanding_page_leases"] == 0


def test_import_into_near_full_pool_rejects_typed():
    """A service whose pool cannot hold the import's pages fast-fails the
    handoff with the typed no_free_pages verdict, before anything was
    allocated (the pool's free pages unchanged)."""
    svc = GenerationService(_model(), TREE, batch_sizes=(1, 2), prompt_buckets=(16,),
                            max_new_buckets=(8,), prefill_chunk=4, kv_layout="paged",
                            kv_page_tokens=4, max_slots=2, kv_pages=9, phase="decode")
    try:
        blob = _export(False, IDS_A, 8)
        # a live stream on ANOTHER prompt holds most of the tight pool
        other = [5, 8, 21, 33, 41, 17, 29, 60, 11, 13]
        q: "queue.Queue" = queue.Queue()
        fut = svc.submit(other, 8, stream=q)
        q.get(timeout=120)   # decoding: its pages are held
        free_before = svc.engine._pool.stats()["pages_free"]
        with pytest.raises(BackpressureError) as ei:
            svc.import_pages(blob)
        assert ei.value.reason == "no_free_pages"
        assert svc.engine._pool.stats()["pages_free"] == free_before
        fut.result(timeout=120)
    finally:
        svc.close()


def test_truncated_import_zero_leaks_then_recovers():
    """A blob cut at any point (the prefill replica died mid-transfer), one
    of a foreign page quantum and one past this engine's largest bucket
    are rejected typed and counted, with free pages, leases and slots
    unchanged; the intact blob then imports fine on the same engine."""
    blob = _export(False, IDS_A, 8)
    dec = _engine("decode")
    try:
        pool = dec._pool
        before = pool.stats()
        for cut in (6, len(blob) // 2, len(blob) - 1):
            with pytest.raises(HandoffError):
                dec.import_pages(blob[:cut])
        meta, lg, pl = decode_handoff(blob)
        bad = dict(meta, page_tokens=8)
        with pytest.raises(HandoffError):
            dec.import_pages(encode_handoff(bad, lg, pl))
        toolong = dict(meta, ids=list(range(1, 25)), s_bucket=32, start_pad=8)
        with pytest.raises(HandoffError):
            dec.import_pages(encode_handoff(toolong, lg, pl))
        after = pool.stats()
        for k in ("pages_free", "outstanding_page_leases", "registry_entries"):
            assert after[k] == before[k], k
        assert all(s is None for s in dec._host) and dec.stats()["requests"] == 0
        assert dec.stats()["handoff_rejects"] == 5
        r = dec.import_pages(blob).result(timeout=120)
        assert len(r["ids"]) == 8 and dec.stats()["handoffs_imported"] == 1
    finally:
        dec.close()


def test_prefill_only_constructor_contract():
    m = _model()
    for bad in ({"kv_layout": "paged"}, {"kv_pages": 8}, {"max_slots": 2}):
        with pytest.raises(ValueError):
            DecodeEngine(m, prefill_only=True, **KW, **bad)
    # export pages must tile the chunk geometry
    with pytest.raises(ValueError):
        DecodeEngine(m, prefill_only=True, kv_page_tokens=3, **KW)
    pre = _engine("prefill")
    try:
        assert (pre.slots, pre.pipeline_depth, pre.fused_admission) == (1, 1, False)
        with pytest.raises(ValueError):
            pre.submit(IDS_A, 4, stream=queue.Queue())
        res = pre.submit(IDS_B, 4).result(timeout=120)
        assert res["pages"] == 2 and res["prefill_tokens"] == len(IDS_B)
        # no decode dispatch ever issued
        assert pre.stats()["dispatches"] == 0 and pre.stats()["pipeline"]["issued"] == 0
    finally:
        pre.close()


def test_import_needs_paged_layout():
    eng = DecodeEngine(_model(), slots=2, **KW)
    try:
        with pytest.raises(ValueError, match="paged"):
            eng.import_pages(b"whatever")
    finally:
        eng.close()
    with pytest.raises(ValueError, match="paged"):
        GenerationService(_model(), TREE, prompt_buckets=(16,), phase="decode")


# ------------------------------------------------------------- HTTP layer


def _service(phase, **kw):
    if phase in ("decode", "both"):
        kw.setdefault("kv_layout", "paged")
        kw.setdefault("max_slots", 2)
        kw.setdefault("kv_pages", 24)
    svc = GenerationService(_model(), TREE, batch_sizes=(1, 2), prompt_buckets=(16,),
                            max_new_buckets=(8,), prefill_chunk=8, phase=phase, **kw)
    httpd = make_http_server(svc, "127.0.0.1", 0, "disagg")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return svc, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(url, body, ctype="application/json"):
    data = body if isinstance(body, (bytes, bytearray)) else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def test_serve_phase_split_http_end_to_end():
    """POST /prefill on a prefill daemon gives a blob; POST /import on a
    decode daemon gives the monolithic daemon's /generate tokens (and, with
    ?stream=1, streams them); a cut blob answers 400 bad_handoff; /generate
    at the prefill daemon and /prefill at the decode daemon answer 409
    wrong_phase; /stats carries the role."""
    prompt = [9, 10, 11, 12, 13, 14, 15, 16, 17, 3]
    mono = _service("both")
    try:
        code, body, _ = _post(mono[2] + "/generate",
                              {"prompt": prompt, "max_new_tokens": 4, "logprobs": True})
        assert code == 200, body
        r_mono = json.loads(body)
    finally:
        mono[1].shutdown()
        mono[1].server_close()
        mono[0].close()
    pre = _service("prefill")
    dec = _service("decode")
    try:
        code, body, _ = _post(pre[2] + "/generate", {"prompt": prompt, "max_new_tokens": 4})
        assert code == 409 and json.loads(body)["status"] == "wrong_phase"
        code, body, _ = _post(dec[2] + "/prefill", {"prompt": prompt, "max_new_tokens": 4})
        assert code == 409 and json.loads(body)["status"] == "wrong_phase"
        for svc, base, phase in ((pre[0], pre[2], "prefill"), (dec[0], dec[2], "decode")):
            with urllib.request.urlopen(base + "/stats", timeout=30) as r:
                assert json.loads(r.read())["phase"] == phase == svc.phase
        code, blob, hdrs = _post(pre[2] + "/prefill",
                                 {"prompt": prompt, "max_new_tokens": 4, "logprobs": True})
        assert code == 200, blob
        assert hdrs["Content-Type"] == "application/octet-stream"
        side = json.loads(hdrs["x-mlcomp-handoff"])
        assert side["pages"] > 0 and side["prefill_tokens"] == len(prompt)
        code, body, _ = _post(dec[2] + "/import", blob, ctype="application/octet-stream")
        assert code == 200, body
        r_imp = json.loads(body)
        assert _key(r_imp) == _key(r_mono)
        code, body, hdrs = _post(dec[2] + "/import?stream=1", blob,
                                 ctype="application/octet-stream")
        assert code == 200 and hdrs["Content-Type"] == "text/event-stream"
        events = [json.loads(ln[6:]) for ln in body.decode().splitlines()
                  if ln.startswith("data: ")]
        assert [e["token"] for e in events[:-1]] == r_mono["ids"] == events[-1]["ids"]
        code, body, _ = _post(dec[2] + "/import", blob[: len(blob) - 40],
                              ctype="application/octet-stream")
        assert code == 400 and json.loads(body)["status"] == "bad_handoff"
        assert dec[0].engine.stats()["handoff_rejects"] == 1
    finally:
        for svc, httpd, _ in (pre, dec):
            httpd.shutdown()
            httpd.server_close()
            svc.close()
