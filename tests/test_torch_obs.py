"""The port's daemon surface on the CPU, held against the JAX daemon on the
same weights: admission control (the paged layout's free-page gate on
``/generate``, ``--max-queue-depth`` and ``--max-concurrent-requests``,
429 with ``Retry-After``), ``/metrics`` family names, the flight recorder
behind ``/trace`` and the client's ``traceparent``, ``/slo`` and
``/metrics/history``, ``warmup()`` and ``ready``, and the engine's fault
points against tests/test_resilience.py's expectations.

The tiny f32 fixture of tests/test_disagg.py (vocab 64, hidden 64, 2
layers, prompt bucket 16, prefill chunk 4): greedy ids are compared
exactly.
"""

import contextlib
import functools
import json
import queue
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import pytest
import torch

from mlcomp_tpu.models import create_model as j_create
from mlcomp_tpu.serve import BackpressureError as JBackpressure
from mlcomp_tpu.serve import GenerationService as JService
from mlcomp_tpu.serve import make_http_server as j_http
from mlcomp_tpu.utils import faults as jfaults
from mlcomp_tpu_torch.engine import DecodeEngine
from mlcomp_tpu_torch.io.weights import init_params
from mlcomp_tpu_torch.models import create_model
from mlcomp_tpu_torch.models.generation import prep_decode_variables
from mlcomp_tpu_torch.serve import BackpressureError, load_service, make_http_server
from mlcomp_tpu_torch.utils import faults

torch.set_num_threads(1)

CFG = {"name": "transformer_lm", "vocab_size": 64, "hidden": 64, "layers": 2, "heads": 2,
       "mlp_dim": 128, "dtype": "float32"}
TREE = init_params(CFG, seed=0)
SVC_KW = dict(batch_sizes=(1,), prompt_buckets=(16,), max_new_buckets=(8,), prefill_chunk=4,
              steps_per_dispatch=2)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm_all()
    jfaults.disarm_all()


def _prompt(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(1, 64, (n,), generator=g).tolist()


def _jax_service(**kw):
    return JService(j_create(dict(CFG)), {"params": jax.tree.map(jnp.asarray, TREE)},
                    **{**SVC_KW, **kw})


def _port_service(**kw):
    return load_service(CFG, params=TREE, device="cpu", **{**SVC_KW, **kw})


@contextlib.contextmanager
def _paused(eng):
    """Hold an engine's drive loop at its next queue pump (both packages'
    loops pump their submit queue at every boundary), so that submits
    stay queued and an admission gate reads the same backlog in either
    package; released on exit."""
    gate = threading.Event()
    real = eng._pump_queue

    def pump(*a, **k):
        gate.wait()
        return real(*a, **k)

    eng._pump_queue = pump
    time.sleep(0.5)  # the loop leaves its current pump and parks in this one
    try:
        yield
    finally:
        gate.set()
        del eng._pump_queue


def _post(url, body, headers=None):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    return urllib.request.urlopen(req, timeout=120)


@contextlib.contextmanager
def _http(service, make=make_http_server):
    httpd = make(service, "127.0.0.1", 0, model_name="tiny")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)


def _reject_429(url, prompt):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/generate", {"prompt": prompt, "max_new_tokens": 8})
    return e.value.code, int(e.value.headers["Retry-After"]), json.loads(e.value.read())


# --------------------------------------------- step 0: the paged page gate


FLOOD = [16, 10, 12, 3, 16, 2, 9]


def _flood(svc, rejected_cls):
    """Submit FLOOD's prompts one after another into a paused loop; the
    accepted futures and the index of each rejected prompt (with its
    reason and Retry-After), then one more reject over HTTP."""
    accepted, rejected = {}, []
    with _paused(svc.engine):
        for i, n in enumerate(FLOOD):
            try:
                accepted[i] = svc.submit(_prompt(n, seed=i), 8)
            except rejected_cls as e:
                rejected.append((i, e.reason, e.retry_after_s))
        http = None
        if rejected:  # a gate that rejects nothing would queue this one behind the pause
            make = make_http_server if rejected_cls is BackpressureError else j_http
            with _http(svc, make) as url:
                http = _reject_429(url, _prompt(16, seed=99))
    ids = {i: f.result(timeout=600)["ids"] for i, f in accepted.items()}
    return ids, rejected, http, svc.stats().get("rejected")


@functools.lru_cache(maxsize=None)
def _jax_flood():
    svc = _jax_service(kv_layout="paged", kv_pages=17)
    try:
        return _flood(svc, JBackpressure)
    finally:
        svc.close()


def test_a_paged_flood_gets_the_jax_daemons_429s():
    """More concurrent /generate requests than a tiny page pool holds: the
    JAX daemon answers some with 429 ``no_free_pages`` at submit (its
    free-page gate counts the queued backlog), and the port must reject
    the same ones, in the same order, with ``Retry-After``; the accepted
    requests complete with the JAX daemon's greedy ids."""
    want_ids, want_rej, want_http, want_counts = _jax_flood()
    assert want_rej and len(want_ids) >= 2
    svc = _port_service(kv_layout="paged", kv_pages=17)
    try:
        got_ids, got_rej, got_http, got_counts = _flood(svc, BackpressureError)
    finally:
        svc.close()
    assert [(i, r) for i, r, _ in got_rej] == [(i, r) for i, r, _ in want_rej]
    assert all(r == "no_free_pages" and 1.0 <= s <= 60.0 for _, r, s in got_rej)
    assert got_ids == want_ids
    code, retry_after, body = got_http
    assert (code, body["status"], body["reason"]) == (429, "rejected", "no_free_pages")
    assert retry_after >= 1 and (want_http[0], want_http[2]["reason"]) == (429, "no_free_pages")
    assert got_counts == want_counts
    assert got_counts["no_free_pages"] == len(got_rej) + 1


# ------------------------------------------------ queue and concurrency caps


def _fill(svc, rejected_cls, n=8):
    """Submit up to n prompts into a paused loop until one is rejected;
    (accepted count, reason, Retry-After) and the HTTP reject."""
    futs, rej = [], None
    with _paused(svc.engine):
        for i in range(n):
            try:
                futs.append(svc.submit(_prompt(6, seed=i), 4))
            except rejected_cls as e:
                rej = (e.reason, e.retry_after_s)
                break
        make = make_http_server if rejected_cls is BackpressureError else j_http
        with _http(svc, make) as url:
            http = _reject_429(url, _prompt(6, seed=50))
    ids = [f.result(timeout=600)["ids"] for f in futs]
    return len(futs), rej, http, ids


@pytest.mark.parametrize("cap", [{"max_queue_depth": 2}, {"max_concurrent_requests": 3}])
def test_queue_and_concurrency_caps_answer_429_with_retry_after(cap):
    """--max-queue-depth and --max-concurrent-requests: past the bound a
    submit fails fast (``queue_full`` / ``concurrency``) with Retry-After,
    over HTTP too, after as many accepted requests as the JAX daemon
    accepts; every accepted request completes with the JAX daemon's ids and
    the reject counters (the ``mlcomp_serving_requests_rejected_total``
    family) agree."""
    jsvc = _jax_service(**cap)
    try:
        want = _fill(jsvc, JBackpressure)
        want_counts = jsvc.stats()["rejected"]
    finally:
        jsvc.close()
    svc = _port_service(**cap)
    try:
        got = _fill(svc, BackpressureError)
        got_counts = svc.stats()["rejected"]
        text = svc.metrics.render()
    finally:
        svc.close()
    reason = "queue_full" if "max_queue_depth" in cap else "concurrency"
    n, (r, retry_s), (code, retry_after, body), ids = got
    assert (n, r) == (want[0], want[1][0]) and r == reason and 1.0 <= retry_s <= 60.0
    assert (code, body["status"], body["reason"]) == (429, "rejected", reason)
    assert retry_after >= 1 and want[2][2]["reason"] == reason
    assert ids == want[3]
    assert got_counts == want_counts and got_counts[reason] == 2
    assert f'mlcomp_serving_requests_rejected_total{{reason="{reason}"}} 2' in text


# ------------------------------------------------------------- metrics


def _families(text):
    return {line.split()[2]: line.split()[3] for line in text.splitlines()
            if line.startswith("# TYPE ")}


# the JAX daemon's families the port does not carry here: the roofline
# share, which the JAX engine computes against a TPU's bandwidth everywhere
# and the port only against a card's (null on the CPU unless
# MLCOMP_TPU_HBM_GBPS is set).  The mesh gauges, which neither daemon
# carries unsharded, are checked on a sharded daemon
LATER = {
    "mlcomp_engine_roofline_utilization": "no memory bandwidth on the CPU",
}
# the JAX engine's families under a mesh (mlcomp_tpu/engine.py), by type
MESH_FAMILIES = {"mlcomp_engine_mesh_devices": "gauge", "mlcomp_engine_is_coordinator": "gauge"}


def _traffic(svc):
    ids = _prompt(12, seed=3)
    out = [svc.generate(ids, 6), svc.generate(_prompt(7, seed=4), 8)]
    if svc.engine.prefix_cache is not None:
        svc.engine.prefix_cache.flush()
    out.append(svc.generate(ids, 6))          # a repeat: a prefix hit
    svc.history.sample_now()
    svc.slo.evaluate()
    return [r["ids"] for r in out], svc.metrics.render()


@pytest.mark.parametrize("kw", [dict(prefix_cache=True),
                                dict(kv_layout="paged", kv_pages=40, prefix_cache=True,
                                     max_queue_depth=4),
                                dict(engine_spec_k=3, prefix_cache=True, steps_per_dispatch=None)])
def test_metric_families_equal_the_jax_daemons(kw):
    """Under the same traffic the port's /metrics families (names and
    types) are the JAX daemon's, less only the families named in LATER
    with their reasons; a speculating daemon carries the acceptance
    gauges."""
    jsvc = _jax_service(**kw)
    try:
        want_ids, want_text = _traffic(jsvc)
    finally:
        jsvc.close()
    svc = _port_service(**kw)
    try:
        got_ids, got_text = _traffic(svc)
        with _http(svc) as url, urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            assert r.headers["Content-Type"].startswith("text/plain; version=0.0.4")
            assert _families(r.read().decode()) == _families(got_text)
    finally:
        svc.close()
    want, got = _families(want_text), _families(got_text)
    assert got_ids == want_ids
    assert set(want) - set(got) <= set(LATER), sorted(set(want) - set(got) - set(LATER))
    assert set(got) == set(want) - set(LATER)
    assert all(got[k] == want[k] for k in got)
    assert "mlcomp_prefix_cache_used_hits_total" in got and "mlcomp_engine_ttft_ms" in got
    spec = {"mlcomp_engine_spec_net_gain", "mlcomp_engine_spec_ineffective"}
    assert spec <= set(got) if "engine_spec_k" in kw else not spec & set(got)


def test_a_sharded_daemon_carries_the_mesh_gauges():
    """A daemon serving under a mesh (here a mesh of one rank, which runs
    the one-card engine: the same ids) carries the JAX engine's two mesh
    gauges beside the unsharded daemon's families, with its device count and
    its coordinator flag."""
    import torch.distributed as tdist

    joined = not tdist.is_initialized()
    svc = _port_service(mesh_cfg={"tp": 1})
    try:
        ids, text = _traffic(svc)
    finally:
        svc.close()
        if joined and tdist.is_initialized():
            tdist.destroy_process_group()
    plain = _port_service()
    try:
        plain_ids, plain_text = _traffic(plain)
    finally:
        plain.close()
    fam, plain_fam = _families(text), _families(plain_text)
    assert ids == plain_ids
    assert {k: fam[k] for k in set(fam) - set(plain_fam)} == MESH_FAMILIES
    assert "mlcomp_engine_mesh_devices 1" in text.splitlines()
    assert "mlcomp_engine_is_coordinator 1" in text.splitlines()


# ------------------------------------------------ trace, slo, history


def test_traceparent_round_trip_and_the_trace_surface():
    """A client's W3C traceparent id is adopted and echoed; /trace?trace_id=
    returns that request's events, named as the JAX engine names them for
    the same request; /trace?rid= agrees; a malformed filter is a 400."""
    tid = "4bf92f3577b34da6a3ce929d0e0e4736"
    header = {"traceparent": f"00-{tid}-00f067aa0ba902b7-01"}

    def run(svc, make):
        with _http(svc, make) as url:
            with _post(url + "/generate", {"prompt": _prompt(9, seed=1), "max_new_tokens": 4},
                       header) as r:
                res = json.loads(r.read())
            with urllib.request.urlopen(f"{url}/trace?trace_id={tid}", timeout=60) as r:
                body = json.loads(r.read())
            bad = None
            try:
                urllib.request.urlopen(f"{url}/trace?trace_id=xyz", timeout=60)
            except urllib.error.HTTPError as e:
                bad = e.code
        evs = [e for e in body["traceEvents"] if e.get("ph") != "M"]
        return res, evs, bad

    jsvc = _jax_service(prefix_cache=True)
    try:
        jres, jevs, _ = run(jsvc, j_http)
    finally:
        jsvc.close()
    svc = _port_service(prefix_cache=True)
    try:
        res, evs, bad = run(svc, make_http_server)
        by_rid = svc.trace(rid=res_rid(evs))["traceEvents"]
    finally:
        svc.close()
    assert res["trace_id"] == jres["trace_id"] == tid and bad == 400
    names = {(e["name"], e["ph"]) for e in evs}
    assert names == {(e["name"], e["ph"]) for e in jevs}
    assert {("request", "b"), ("admit", "n"), ("prefix_cache.lookup", "X"), ("insert", "X"),
            ("first_token", "n"), ("request", "e")} <= names
    assert all((e.get("args") or {}).get("trace_id") == tid for e in evs
               if e["name"] in ("prefix_cache.lookup", "insert", "prefill_chunk"))
    assert {(e["name"], e["ph"]) for e in by_rid if e.get("ph") != "M"} == names


def res_rid(evs):
    """The rid of a request's lifecycle events."""
    return int(next(e["id"] for e in evs if e["name"] == "request"))


def test_slo_and_metrics_history_and_their_404s():
    svc = _port_service(metrics_history_interval=0.2)
    try:
        svc.generate(_prompt(5), 4)
        svc.history.sample_now()
        with _http(svc) as url:
            for route in ("/slo", "/metrics/history?window_s=60"):
                with urllib.request.urlopen(url + route, timeout=60) as r:
                    body = json.loads(r.read())
                assert body
            with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
                health = json.loads(r.read())
        assert "slos" in json.dumps(svc.slo_status()) and "slo" in health
        assert svc.metrics_history()["samples"]
    finally:
        svc.close()
    off = _port_service(metrics_history_interval=0)
    try:
        with _http(off) as url:
            for route in ("/slo", "/metrics/history"):
                with pytest.raises(urllib.error.HTTPError) as e:
                    urllib.request.urlopen(url + route, timeout=60)
                assert e.value.code == 404
    finally:
        off.close()
    window = _port_service(batcher="window", steps_per_dispatch=None)
    try:
        with _http(window) as url, pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url + "/trace", timeout=60)
        assert e.value.code == 404
    finally:
        window.close()
    with pytest.raises(ValueError, match="metrics-history"):
        _port_service(metrics_history_interval=0, slo_config={"slos": {}})


# ------------------------------------------------------------- warmup


def test_ready_is_false_during_warmup_and_true_after():
    """warmup() runs the configuration's paths (dummy requests kept out of
    the stats, one dispatch per K rung, a fused dispatch, the prefix
    cache's and the registry's copies) with ready false until it ends."""
    svc = _port_service(kv_layout="paged", prefix_cache=True, steps_per_dispatch="adaptive")
    eng = svc.engine
    gate, entered = threading.Event(), threading.Event()
    real = eng.warm_dispatch_fns

    def held():
        entered.set()
        gate.wait()
        return real()

    eng.warm_dispatch_fns = held
    out = []
    t = threading.Thread(target=lambda: out.append(svc.warmup()))
    try:
        assert svc.stats()["ready"]
        t.start()
        assert entered.wait(120)
        st = svc.stats()
        assert st["healthy"] and not st["ready"]
        gate.set()
        t.join(120)
        assert svc.stats()["ready"]
        # 1 dummy request, the 4-rung ladder, 1 fused width, the prefix
        # cache's copies (4 captures + 3 writes), 1 registry gather
        assert out == [1 + 4 + 1 + 7 + 1]
        st = svc.stats()
        assert st["requests"] == 0 and st["engine"]["latency"]["samples"] == 0
        assert svc.cache_stats()["inserted_tokens"] == 0
        assert st["engine"]["kv_pool"]["registry_entries"] == 0
    finally:
        gate.set()
        svc.close()


# --------------------------------------------------------- fault points


class _HeldAtFirstToken(queue.Queue):
    """A request's token stream whose first ``put`` (on the engine's loop
    thread) sets ``first`` and waits for ``release``: the loop stands still
    at that boundary meanwhile."""

    def __init__(self):
        super().__init__()
        self.first, self.release = threading.Event(), threading.Event()

    def put(self, item, *a, **k):
        super().put(item, *a, **k)
        if not self.first.is_set():
            self.first.set()
            self.release.wait(timeout=600)


def _scenario(point, engine_of, fmod, kind):
    """One fault point against one engine (``engine_of(**kw)``, ``fmod``
    its package's faults module): which requests fail, and with what."""

    def outcome(fut):
        try:
            r = fut.result(timeout=600)
            return ("ok", r.get("cache_hit_tokens"))
        except Exception as e:
            return (type(e).__name__,)

    a_ids, b_ids = [3, 14, 15, 9, 2, 6, 53, 58, 9, 7], [7, 3, 44, 5, 6]
    if kind == "export":
        eng = engine_of(prefill_only=True, slots=1)
    elif kind in ("cache", "capture"):
        eng = engine_of(prefix_cache=True)
    else:
        eng = engine_of()
    try:
        flush = eng.prefix_cache.flush if eng.prefix_cache is not None else (lambda: None)
        out = []
        if kind == "capture":
            # the capture of a cold prompt fails off the loop; its repeat
            # finds nothing stored
            fmod.arm(point, flavor="raise", times=1)
            out.append(outcome(eng.submit(a_ids, 6)))
            flush()
            fmod.disarm_all()
            out.append(outcome(eng.submit(a_ids, 6)))
            flush()
        elif kind == "decode":
            # A's first token holds the engine's loop (which puts it) until B
            # is queued and the fault armed: the fault then fires with A and
            # B waiting in either engine, however the threads are scheduled
            qa = _HeldAtFirstToken()
            fa = eng.submit(a_ids, 12, stream=qa)
            assert qa.first.wait(timeout=600)       # A is decoding
            try:
                fb = eng.submit(b_ids, 6)
                fmod.arm(point, flavor="raise", times=1)
            finally:
                qa.release.set()
            out += [outcome(fa), outcome(fb)]
        else:
            out.append(outcome(eng.submit(a_ids, 6)))
            flush()
            fmod.arm(point, flavor="raise", times=1)
            out.append(outcome(eng.submit(a_ids, 6)))
            flush()
        fmod.disarm_all()
        try:
            out.append(outcome(eng.submit(a_ids, 6)))
        except RuntimeError as e:
            out.append(("submit", type(e).__name__))
        flush()
        st = eng.stats()
        # an export resolves its future before the engine counts the prefill
        out.append((eng.healthy, st["cache_degraded"],
                    None if kind == "export" else st["prefills"],
                    (st.get("prefix_cache") or {}).get("insert_errors")))
        return out
    finally:
        fmod.disarm_all()
        eng.close()


@pytest.mark.parametrize("point,kind", [
    ("engine.dispatch", "decode"), ("engine.resolve", "decode"),
    ("engine.fused_prefill", "decode"), ("engine.export", "export"),
    ("cache.lookup", "cache"), ("cache.capture", "capture"),
])
def test_each_fault_point_fails_what_the_jax_engine_fails(point, kind):
    """tests/test_resilience.py's expectations, side by side: a raise at
    engine.dispatch or engine.resolve is engine-level (every waiter fails,
    the engine goes unhealthy, later submits fail); at engine.fused_prefill
    only the admitting request fails and the decoding one completes; at
    engine.export only that export fails; at cache.lookup the admission
    degrades to a cold prefill (counted) with the cold tokens; at
    cache.capture the insert fails off the loop (insert_errors).  The port
    fails exactly the requests the JAX engine fails."""
    from mlcomp_tpu.cache import PrefixKVCache as JPrefixKVCache
    from mlcomp_tpu.engine import DecodeEngine as JEngine

    from mlcomp_tpu_torch.cache import PrefixKVCache

    kw = dict(slots=2, prompt_buckets=(16,), max_new_cap=12, steps_per_dispatch=2,
              prefill_chunk=4)

    def jax_engine(prefix_cache=False, **over):
        return JEngine(j_create(dict(CFG)), {"params": jax.tree.map(jnp.asarray, TREE)},
                       prefix_cache=JPrefixKVCache(64 << 20) if prefix_cache else None,
                       **{**kw, **over})

    def port_engine(prefix_cache=False, **over):
        return DecodeEngine(_model(), prefix_cache=PrefixKVCache(64 << 20) if prefix_cache
                            else None, **{**kw, **over})

    want = _scenario(point, jax_engine, jfaults, kind)
    got = _scenario(point, port_engine, faults, kind)
    assert got == want
    if point in ("engine.dispatch", "engine.resolve"):
        assert got[0] == got[1] == ("FaultInjected",) and got[3][0] is False
    if point == "engine.fused_prefill":
        assert got[0][0] == "ok" and got[1] == ("FaultInjected",) and got[3][0]
    if point == "cache.lookup":
        assert got[1] == ("ok", 0) and got[2][1] > 0 and got[3][1] == 1
    if point == "cache.capture":
        assert got[:2] == [("ok", 0), ("ok", 0)] and got[2][1] > 0 and got[3][3] == 1


@functools.lru_cache(maxsize=None)
def _model():
    return prep_decode_variables(create_model(dict(CFG), device="cpu"), TREE)


def test_a_failed_warmup_fails_the_daemon():
    """serve --warmup: a warmup that raises (a CUDA build or launch on a
    card) stops the server and fails the daemon; it never serves on."""
    from mlcomp_tpu_torch.serve import serve_http

    svc = _port_service()

    def broken():
        raise RuntimeError("nvcc failed")

    svc.warmup = broken
    with pytest.raises(RuntimeError, match="warmup failed"):
        serve_http(svc, "127.0.0.1", 0, model_name="tiny", warmup=True)
    assert not svc.stats()["ready"]


def test_the_window_batcher_warms_up_each_max_new_bucket_at_both_batch_ends():
    svc = _port_service(batcher="window", batch_sizes=(1, 2), max_new_buckets=(4, 8))
    try:
        assert svc.warmup() == 4
        st = svc.stats()
        assert st["ready"] and st["requests"] == 0 and st["batches"] == 0
    finally:
        svc.close()
