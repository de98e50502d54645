"""The port's services and HTTP server, on the CPU: the window service
against the JAX package's window service fed the same weights, and the
default continuous service (its engine is held against the JAX engine in
test_torch_engine.py) through its HTTP surface."""

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlcomp_tpu.models import create_model as j_create
from mlcomp_tpu.models.transformer import fuse_decode_params as j_fuse
from mlcomp_tpu.serve import GenerationService as JService
from mlcomp_tpu.serve import _bucket as j_bucket
from mlcomp_tpu.serve import _trim_generated as j_trim
from mlcomp_tpu.serve import left_pad_row as j_left_pad_row
from mlcomp_tpu_torch.io.weights import init_params
from mlcomp_tpu_torch.ops.quant import Int8Linear, dequantize_params, quantize_params
from mlcomp_tpu_torch.serve import (
    _bucket,
    _trim_generated,
    left_pad_row,
    load_service,
    make_http_server,
)

torch.set_num_threads(1)

CFG = {"name": "transformer_lm", "vocab_size": 256, "hidden": 128, "layers": 2, "heads": 4,
       "kv_heads": 2, "dtype": "float32", "kv_quant": True, "decode_fused": True}
TREE = init_params(CFG, seed=1)
PORT_KW = dict(batch_sizes=(1, 2, 4), prompt_buckets=(8, 16), max_new_buckets=(4, 8),
               quantize="kernel", batch_window_ms=100.0, batcher="window")
KW = PORT_KW


@pytest.fixture(scope="module")
def service():
    svc = load_service(CFG, params=TREE, device="cpu", **PORT_KW)
    yield svc
    svc.close()


def test_one_request_matches_the_jax_window_service(service):
    cfg = {k: v for k, v in CFG.items() if k != "name"}
    jm = j_create({"name": "transformer_lm", **cfg})
    jsvc = JService(jm, {"params": j_fuse(jax.tree.map(jnp.asarray, TREE))}, **KW)
    try:
        prompt = [3, 14, 15, 92, 65, 35]
        ref = jsvc.submit(prompt, 5, logprobs=True).result(timeout=600)
    finally:
        jsvc.close()
    out = service.submit(prompt, 5, logprobs=True).result(timeout=600)
    assert set(out) == set(ref)
    assert out["ids"] == ref["ids"] and len(out["ids"]) == 5
    assert out["batched_with"] == ref["batched_with"] == 1
    # logprobs: f32 model, but every kernel input rounds to bf16 and every
    # new K/V row to int8 codes; f32 noise between the libraries can flip
    # one such rounding, which moves a logprob by up to ~1%
    np.testing.assert_allclose(out["logprobs"], ref["logprobs"], rtol=1e-2, atol=1e-3)


def test_concurrent_requests_batch_and_match_solo(service):
    prompts = [[5, 6, 7], [9] * 12, [1, 2, 3, 4, 5]]
    solo = [service.generate(p, 4)["ids"] for p in prompts]
    futs = [service.submit(p, 4) for p in prompts]
    res = [f.result(timeout=600) for f in futs]
    assert [r["ids"] for r in res] == solo
    assert max(r["batched_with"] for r in res) > 1


def test_sampled_and_eos_requests(service):
    out = service.generate([7, 8, 9], 8, temperature=0.9, top_k=20, top_p=0.9,
                           repetition_penalty=1.2, logprobs=True)
    assert len(out["ids"]) == 8 and all(0 <= t < 256 for t in out["ids"])
    assert all(lp <= 0 for lp in out["logprobs"])
    greedy = service.generate([7, 8, 9], 8)["ids"]
    stop = service.generate([7, 8, 9], 8, eos_id=greedy[1])["ids"]
    assert stop == greedy[: greedy.index(greedy[1]) + 1]


def test_submit_validates(service):
    with pytest.raises(ValueError, match="non-empty"):
        service.submit([], 4)
    with pytest.raises(ValueError, match="exceeds"):
        service.submit([1] * 17, 4)
    with pytest.raises(ValueError, match="vocabulary|prompt ids"):
        service.submit([1, 999], 4)
    with pytest.raises(ValueError, match="top_p"):
        service.submit([1], 4, top_p=0.0)


def test_http_round_trip(service):
    httpd = make_http_server(service, "127.0.0.1", 0, model_name="tiny")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        req = urllib.request.Request(
            url + "/generate", data=json.dumps({"prompt": [4, 5, 6], "max_new_tokens": 3,
                                                "logprobs": True}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            body = json.loads(r.read())
        assert r.status == 200 and len(body["ids"]) == 3 and len(body["logprobs"]) == 3
        assert body["ids"] == service.generate([4, 5, 6], 3)["ids"]
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["model"] == "tiny" and health["batcher"] == "window"
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            assert json.loads(r.read())["requests"] >= 1
        bad = urllib.request.Request(url + "/generate", data=b'{"max_new_tokens": 3}')
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=60)
        assert e.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)


def test_load_service_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is the default here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_service(CFG, params=TREE, **PORT_KW)


def test_int8_storage_service_serves_the_dequantized_weights():
    """``quantize="int8"``: the weights are quantized, then dequantized once
    at load; no projection runs the int8 kernel.  The answers equal those
    of a float service fed the same dequantized tree."""
    kw = {**PORT_KW, "quantize": False}
    stored = load_service(CFG, params=TREE, device="cpu", **{**kw, "quantize": "int8"})
    deq = load_service(CFG, params=dequantize_params(quantize_params(TREE)), device="cpu", **kw)
    try:
        assert not any(isinstance(m, Int8Linear) for m in stored.model.modules())
        assert stored.stats()["quantize"] == "int8"
        for prompt in ([3, 14, 15, 92], [7] * 11):
            a = stored.submit(prompt, 6, logprobs=True).result(timeout=600)
            b = deq.submit(prompt, 6, logprobs=True).result(timeout=600)
            assert a["ids"] == b["ids"]
            # the same bf16 weights on both sides: the same computation
            np.testing.assert_array_equal(a["logprobs"], b["logprobs"])
    finally:
        stored.close()
        deq.close()


def test_batching_helpers_match_jax():
    for v in (1, 4, 5, 8):
        assert _bucket(v, (4, 8), "x") == j_bucket(v, (4, 8), "x")
    row, mask = left_pad_row([7, 8, 9], 6, 0)
    jrow, jmask = j_left_pad_row([7, 8, 9], 6, 0)
    np.testing.assert_array_equal(row, jrow)
    np.testing.assert_array_equal(mask, jmask)
    full = np.array([0, 0, 7, 8, 3, 2, 5, 2, 0])
    item = {"n_new": 4, "eos_id": 2}
    assert _trim_generated(full, 4, item) == j_trim(full, 4, item) == [3, 2]


def test_cli_serve_needs_a_checkpoint(tmp_path, capsys):
    from mlcomp_tpu_torch.cli import main

    cfg = tmp_path / "m.yml"
    cfg.write_text("model:\n  name: transformer_lm\n  vocab_size: 256\n")
    assert main(["serve", "--model", str(cfg)]) == 2
    assert "--ckpt" in capsys.readouterr().err
    # the JAX command line's engine flags carry over
    for flags in (["--batcher", "window"], ["--batcher", "continuous"],
                  ["--batcher", "speculative", "--spec-k", "4"], ["--engine-spec-k", "3"],
                  ["--steps-per-dispatch", "adaptive", "--engine-pipeline-depth", "1",
                   "--engine-staged-admission", "--prefill-chunk", "64",
                   "--dispatch-stall-timeout", "0"], ["--steps-per-dispatch", "4"]):
        assert main(["serve", "--model", str(cfg), *flags]) == 2
    assert main(["serve", "--model", str(cfg), "--storage-task", "a/b"]) == 2
    assert "PROJECT/DAG/TASK" in capsys.readouterr().err
    for bad in (["--batcher", "beam"], ["--steps-per-dispatch", "0"],
                ["--steps-per-dispatch", "fast"]):
        with pytest.raises(SystemExit):
            main(["serve", "--model", str(cfg), *bad])


@pytest.fixture(scope="module")
def continuous():
    kw = {k: v for k, v in PORT_KW.items() if k not in ("batcher", "batch_window_ms")}
    svc = load_service(CFG, params=TREE, device="cpu", **kw)
    yield svc
    svc.close()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=600)


def test_default_service_is_continuous_and_matches_the_window_service(continuous, service):
    assert continuous.stats()["batcher"] == "continuous"
    assert continuous.stats()["engine"]["adaptive_k"]
    prompt = [3, 14, 15, 92, 65, 35]
    got = continuous.submit(prompt, 5, logprobs=True).result(timeout=600)
    ref = service.submit(prompt, 5, logprobs=True).result(timeout=600)
    assert got["ids"] == ref["ids"]
    # the same model code and kernels' plain versions, batched differently
    np.testing.assert_allclose(got["logprobs"], ref["logprobs"], rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="continuous batcher"):
        service.submit(prompt, 2, deadline_s=5.0)


def test_sse_stream_healthz_and_drain(continuous):
    httpd = make_http_server(continuous, "127.0.0.1", 0, model_name="tiny")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with _post(url + "/generate", {"prompt": [4, 5, 6], "max_new_tokens": 6,
                                       "logprobs": True, "stream": True}) as r:
            assert r.headers["Content-Type"] == "text/event-stream"
            events = [json.loads(line[len(b"data: "):]) for line in r.read().split(b"\n\n")
                      if line.startswith(b"data: ")]
        *tokens, done = events
        assert done["done"] and len(done["ids"]) == 6
        assert [e["token"] for e in tokens] == done["ids"]
        assert [e["logprob"] for e in tokens] == done["logprobs"]
        steps = [e["step"] for e in tokens]
        assert steps == sorted(steps)
        assert done["ids"] == continuous.generate([4, 5, 6], 6)["ids"]

        def health():
            with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
                return json.loads(r.read())

        h = health()
        assert h["ok"] and h["ready"] and h["batcher"] == "continuous" and not h["draining"]
        with _post(url + "/drain", {}) as r:
            assert json.loads(r.read()) == {"ok": True, "draining": True}
        h = health()
        assert h["ok"] and not h["ready"] and h["draining"]
        with _post(url + "/drain", {"draining": False}) as r:
            assert json.loads(r.read())["draining"] is False
        assert health()["ready"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url + "/drain", {"draining": "yes"})
        assert e.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)


def test_paged_service_serves_the_dense_tokens_and_reports_pages(continuous):
    kw = {k: v for k, v in PORT_KW.items() if k not in ("batcher", "batch_window_ms")}
    paged = load_service(CFG, params=TREE, device="cpu", kv_layout="paged", kv_page_tokens=4,
                         max_slots=4, **kw)
    httpd = make_http_server(paged, "127.0.0.1", 0, model_name="tiny")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        prompts = [[3, 14, 15, 92, 65, 35], [9] * 12, [1, 2, 3]]
        futs = [paged.submit(p, 6, logprobs=True) for p in prompts]
        got = [f.result(timeout=600) for f in futs]
        want = [continuous.submit(p, 6, logprobs=True).result(timeout=600) for p in prompts]
        assert [(g["ids"], g["logprobs"]) for g in got] == [(w["ids"], w["logprobs"])
                                                           for w in want]
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            st = json.loads(r.read())["engine"]
        assert st["kv_layout"] == "paged" and st["max_slots"] == 4
        pool = st["kv_pool"]
        assert pool["page_tokens"] == 4 and pool["allocs"] > 0
        assert pool["pages_total"] == pool["pages_free"] + pool["pages_used"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
        paged.close()


def test_paged_arguments_need_the_paged_continuous_engine():
    kw = {k: v for k, v in PORT_KW.items() if k not in ("batcher", "batch_window_ms")}
    # the dense engine rejects them, as the JAX engine does
    with pytest.raises(ValueError, match="kv_layout='paged'"):
        load_service(CFG, params=TREE, device="cpu", kv_pages=64, **kw)
    with pytest.raises(ValueError, match="max_slots"):
        load_service(CFG, params=TREE, device="cpu", max_slots=16, **kw)
    with pytest.raises(ValueError, match="continuous batcher"):
        load_service(CFG, params=TREE, device="cpu", kv_layout="paged", **PORT_KW)


def test_cli_paged_flags_reach_the_engine(tmp_path, monkeypatch, continuous):
    """``serve --kv-layout paged --kv-page-tokens --kv-pages --max-slots``
    builds the paged engine, which serves the dense engine's tokens;
    ``--max-slots`` defaults to 4 x the largest batch size."""
    import yaml

    import mlcomp_tpu_torch.serve as serve_mod
    from mlcomp_tpu_torch.cli import main

    built, served = [], []
    real = serve_mod.load_service

    def load(model_cfg, ckpt_path=None, **kw):
        assert kw["device"] == "cpu"           # the CLI's --device
        svc = real(model_cfg, params=TREE, **kw)
        built.append(svc)
        return svc

    def serve_once(svc, host, port, model_name):
        served.append(svc.generate([3, 14, 15, 92, 65, 35], 6)["ids"])
        svc.close()

    monkeypatch.setattr(serve_mod, "load_service", load)
    monkeypatch.setattr(serve_mod, "serve_http", serve_once)
    cfg = tmp_path / "m.yml"
    cfg.write_text(yaml.safe_dump({"model": {k: v for k, v in CFG.items() if k != "kv_quant"}}))
    base = ["serve", "--model", str(cfg), "--ckpt", "w.npz", "--kv-quant", "--quantize",
            "kernel", "--batch-sizes", "1,2,4", "--prompt-buckets", "8,16",
            "--max-new-buckets", "4,8", "--kv-layout", "paged", "--device", "cpu"]
    assert main(base + ["--kv-page-tokens", "4", "--kv-pages", "40", "--max-slots", "6"]) == 0
    assert main(base) == 0
    st = [svc.stats()["engine"] for svc in built]
    assert [s["kv_layout"] for s in st] == ["paged", "paged"]
    assert st[0]["max_slots"] == 6 and st[0]["kv_pool"]["page_tokens"] == 4
    assert st[0]["kv_pool"]["pages_total"] == 38
    assert st[1]["max_slots"] == 16 and st[1]["kv_pool"]["page_tokens"] == 8
    want = continuous.generate([3, 14, 15, 92, 65, 35], 6)["ids"]
    assert served == [want, want]
