"""The port's report server and report artifacts against the JAX package's.

One store, written by a port DAG run on the CPU (a noop task, a tiny LM
``train`` task with a metric series over three epochs and a ``report:
{layout: [...]}`` section, and a ``valid`` task with a layout-only
report), is served by both packages' report servers at once: every GET
route answers the same JSON, timestamps aside, ``/metrics`` the same
families and values, and the POST guards the same codes.  The same DAG run
through the JAX package stores the same layout rows.  Each function of
``report/artifacts.py`` equals the JAX one on seeded inputs.
"""

import json
import re
import shutil
import sqlite3
import textwrap
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from mlcomp_tpu.report import artifacts as jart
from mlcomp_tpu.report import server as jserver
from mlcomp_tpu_torch.report import artifacts as tart
from mlcomp_tpu_torch.report import server as tserver

torch.set_num_threads(1)

LAYOUT = [{"type": "series", "metrics": ["train/loss"], "title": "Loss"}, "summary"]
VALID_LAYOUT = ["summary", {"type": "series", "metrics": ["valid/loss"]}]
# keys that read the clock, at any depth of a route's JSON
CLOCK_KEYS = {"ts", "created", "updated", "started", "finished", "heartbeat", "age_s",
              "heartbeat_age_s", "load", "free_ram", "info"}
# /metrics families that read the clock
CLOCK_FAMILIES = ("heartbeat_age", "_seconds")


def _dag_yaml(tmp_path: Path) -> Path:
    storage = tmp_path / "storage"
    model = ("{name: transformer_lm, vocab_size: 64, hidden: 32, layers: 1, heads: 2, "
             "mlp_dim: 64, dtype: float32}")
    # batches of 8: the JAX Trainer shards them over the test run's 8 host
    # devices
    data = "{name: synthetic_tokens, n: 16, seq_len: 8, vocab_size: 64, batch_size: 8}"
    text = textwrap.dedent(f"""\
        info: {{name: report_dag, project: rp}}
        executors:
          prep: {{type: noop}}
          train:
            type: train
            depends: prep
            args:
              model: {model}
              optimizer: {{name: adamw, lr: 1.0e-3}}
              loss: lm_cross_entropy
              metrics: []
              epochs: 3
              data: {{train: {data}, valid: {data}}}
              storage_root: {storage}
              project: rp
              dag_name: report_dag
              report: {{layout: {json.dumps(LAYOUT)}}}
          valid:
            type: valid
            depends: train
            args:
              model: {model}
              loss: lm_cross_entropy
              metrics: []
              data: {{valid: {data}}}
              report: {{layout: {json.dumps(VALID_LAYOUT)}}}
        """)
    path = tmp_path / "report_dag.yml"
    path.write_text(text)
    return path


@pytest.fixture(scope="module")
def port_store(tmp_path_factory):
    from mlcomp_tpu_torch.db.store import Store
    from mlcomp_tpu_torch.scheduler.local import run_dag_local

    tmp = tmp_path_factory.mktemp("report")
    db = str(tmp / "port.sqlite")
    statuses = run_dag_local(_dag_yaml(tmp), db_path=db, workdir=str(tmp), device="cpu")
    assert {n: s.value for n, s in statuses.items()} == {
        "prep": "success", "train": "success", "valid": "success"}
    store = Store(db)
    try:
        store.heartbeat("gpu-worker-0", 8, busy_chips=1)
    finally:
        store.close()
    return tmp, db


def _reports(db):
    con = sqlite3.connect(db)
    try:
        return [(name, kind, json.loads(payload)) for name, kind, payload in con.execute(
            "SELECT t.name, r.kind, r.payload FROM reports r JOIN tasks t ON t.id = r.task_id"
            " ORDER BY r.id")]
    finally:
        con.close()


def test_train_and_valid_store_the_jax_executors_layout_rows(port_store, tmp_path):
    from mlcomp_tpu.scheduler.local import run_dag_local as j_run_dag_local

    tmp, db = port_store
    jdb = str(tmp_path / "jax.sqlite")
    statuses = j_run_dag_local(_dag_yaml(tmp_path), db_path=jdb, workdir=str(tmp_path))
    assert {n: s.value for n, s in statuses.items()} == {
        "prep": "success", "train": "success", "valid": "success"}
    got, want = _reports(db), _reports(jdb)
    assert got == want
    assert [(n, k) for n, k, _ in got] == [("train", "layout"), ("valid", "layout")]
    assert got[0][2] == jart.layout_payload(LAYOUT)


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in CLOCK_KEYS}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


@pytest.fixture(scope="module")
def both_servers(port_store):
    tmp, db = port_store
    js, jport = jserver.start_in_thread(db)
    ts, tport = tserver.start_in_thread(db)
    yield tmp, db, jport, tport
    for srv in (js, ts):
        srv.shutdown()
        srv.server_close()


def _get(port, path, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _routes(db):
    from mlcomp_tpu_torch.db.store import Store

    store = Store(db)
    try:
        tasks = {r["name"]: r["id"] for r in store.task_rows(1)}
        report_ids = [r["id"] for r in store.reports(tasks["train"]) + store.reports(
            tasks["valid"])]
    finally:
        store.close()
    t = tasks["train"]
    return ["/api/dags", "/api/dags/1/tasks", "/api/dags/1/metrics",
            "/api/dags/1/metrics/train/loss", "/api/dags/1/metrics/valid/loss",
            *(f"/api/tasks/{i}/logs" for i in tasks.values()),
            f"/api/tasks/{t}/metrics", f"/api/tasks/{t}/metrics/train/loss",
            f"/api/tasks/{t}/reports", f"/api/tasks/{tasks['valid']}/reports",
            *(f"/api/reports/{i}" for i in report_ids), "/api/reports/999",
            "/api/workers", "/api/models", "/api/serving", "/api/nothing", "/fleet/trace",
            "/fleet/metrics", "/"]


def test_every_get_route_answers_the_jax_servers_json(both_servers, monkeypatch):
    tmp, db, jport, tport = both_servers
    for var in ("MLCOMP_TPU_SERVE_URL", "MLCOMP_TPU_SERVE_URLS", "MLCOMP_TPU_SERVE_REGISTRY",
                "MLCOMP_TPU_REPORT_TOKEN"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MLCOMP_TPU_STORAGE", str(tmp / "storage"))
    for path in _routes(db):
        jcode, jtype, jbody = _get(jport, path)
        tcode, ttype, tbody = _get(tport, path)
        assert (tcode, ttype) == (jcode, jtype), path
        if ttype.startswith("application/json"):
            assert _strip(json.loads(tbody)) == _strip(json.loads(jbody)), path
        else:
            assert tbody == jbody, path
    # the store the routes read: the train task's loss over its 3 epochs,
    # the layout rows, the worker and the model's checkpoints
    series = json.loads(_get(tport, "/api/dags/1/metrics/train/loss")[2])
    assert [len(v) for v in series.values()] == [3]
    models = json.loads(_get(tport, "/api/models")[2])
    assert [(m["task"], len(m["checkpoints"]) > 0) for m in models] == [("train", True)]
    assert json.loads(_get(tport, "/api/workers")[2])[0]["name"]


def _families(text):
    fams = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name = re.match(r"[a-zA-Z_:][a-zA-Z0-9_:]*", line).group(0)
        fams.setdefault(name, []).append(line)
    return fams


def test_metrics_give_the_same_families_and_values(both_servers, monkeypatch):
    tmp, db, jport, tport = both_servers
    monkeypatch.delenv("MLCOMP_TPU_SERVE_URL", raising=False)
    monkeypatch.delenv("MLCOMP_TPU_REPORT_TOKEN", raising=False)
    (jcode, jtype, jbody), (tcode, ttype, tbody) = (_get(p, "/metrics") for p in (jport, tport))
    assert (tcode, ttype) == (jcode, jtype) == (200, jtype)
    jf, tf = _families(jbody.decode()), _families(tbody.decode())
    assert sorted(tf) == sorted(jf)
    for name in jf:
        if not any(c in name for c in CLOCK_FAMILIES):
            assert sorted(tf[name]) == sorted(jf[name]), name
    assert any('status="success"' in s for s in tf["mlcomp_report_tasks"])


def test_serving_and_fleet_routes_proxy_a_port_daemon(both_servers, monkeypatch, tmp_path):
    """``/api/serving``, ``/metrics`` and ``/fleet/metrics`` proxy a port
    serve daemon (named by the registry file) for both servers alike."""
    from mlcomp_tpu_torch.fleet.registry import update_entry
    from mlcomp_tpu_torch.io.weights import init_params
    from mlcomp_tpu_torch.models import create_model
    from mlcomp_tpu_torch.serve import GenerationService, make_http_server

    tmp, db, jport, tport = both_servers
    cfg = {"name": "transformer_lm", "vocab_size": 64, "hidden": 32, "layers": 1, "heads": 2,
           "mlp_dim": 64, "dtype": "float32"}
    svc = GenerationService(create_model(cfg, device="cpu"), init_params(cfg, 0),
                            batch_sizes=(1,), prompt_buckets=(16,), max_new_buckets=(8,),
                            prefix_cache=True, metrics_history_interval=0)
    httpd = make_http_server(svc, "127.0.0.1", 0, "tiny")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        svc.submit([5, 6, 7], 4).result(timeout=120)
        reg = str(tmp_path / "reg.json")
        update_entry(reg, "fleet-0", url=url, state="live")
        monkeypatch.setenv("MLCOMP_TPU_SERVE_URL", url)
        monkeypatch.setenv("MLCOMP_TPU_SERVE_REGISTRY", reg)
        monkeypatch.delenv("MLCOMP_TPU_REPORT_TOKEN", raising=False)
        jserving = json.loads(_get(jport, "/api/serving")[2])
        tserving = json.loads(_get(tport, "/api/serving")[2])
        assert tserving["configured"] and set(tserving) == set(jserving)
        assert tserving["url"] == jserving["url"] == url and tserving["reachable"]
        assert tserving["health"]["ok"] and jserving["health"]["ok"]
        assert set(tserving["health"]) == set(jserving["health"])
        assert tserving["prefix_cache"]["misses"] == jserving["prefix_cache"]["misses"] == 1
        for path in ("/metrics", "/fleet/metrics"):
            jf = _families(_get(jport, path)[2].decode())
            tf = _families(_get(tport, path)[2].decode())
            assert sorted(tf) == sorted(jf), path
        fleet = _families(_get(tport, "/fleet/metrics")[2].decode())
        assert fleet["mlcomp_fleet_daemon_up"] == [
            f'mlcomp_fleet_daemon_up{{daemon="{url[len("http://"):]}"}} 1']
        trace = json.loads(_get(tport, "/fleet/trace")[2])
        assert trace["traceEvents"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.close()


def _post(port, path, headers):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=b"", method="POST",
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_post_guards_answer_the_same_codes(port_store, tmp_path, monkeypatch):
    """Each server on its own copy of the store: the same POSTs, with and
    without the header and the token, answer the same codes and bodies and
    leave the same task rows."""
    _, db = port_store
    servers = {}
    for name, mod in (("jax", jserver), ("port", tserver)):
        copy = str(tmp_path / f"{name}.sqlite")
        shutil.copy(db, copy)
        servers[name] = (copy, *mod.start_in_thread(copy))
    hdr = {"X-Requested-With": "mlcomp-tpu"}
    cases = [(None, "/api/dags/1/stop", {}), (None, "/api/dags/1/stop", hdr),
             (None, "/api/tasks/2/restart", hdr), (None, "/api/dags/1/restart", hdr),
             (None, "/api/tasks/3/stop", hdr), (None, "/api/nothing", hdr),
             ("s3cret", "/api/dags/1/stop", hdr),
             ("s3cret", "/api/dags/1/stop", {**hdr, "Authorization": "Bearer wrong"}),
             ("s3cret", "/api/dags/1/stop", {**hdr, "Authorization": "Bearer s3cret"}),
             ("s3cret", "/api/dags/1/restart", {"Authorization": "Bearer s3cret"})]
    try:
        codes = []
        for token, path, headers in cases:
            if token:
                monkeypatch.setenv("MLCOMP_TPU_REPORT_TOKEN", token)
            else:
                monkeypatch.delenv("MLCOMP_TPU_REPORT_TOKEN", raising=False)
            want = _post(servers["jax"][2], path, headers)
            got = _post(servers["port"][2], path, headers)
            assert got == want, (token, path, headers)
            codes.append(got[0])
            rows = []
            for copy, *_ in servers.values():
                con = sqlite3.connect(copy)
                rows.append(list(con.execute("SELECT id, status, retries FROM tasks")))
                con.close()
            assert rows[0] == rows[1]
        assert codes == [403, 200, 200, 200, 200, 404, 403, 403, 200, 403]
        monkeypatch.setenv("MLCOMP_TPU_REPORT_TOKEN", "s3cret")
        assert _get(servers["port"][2], "/api/dags")[0] == _get(servers["jax"][2],
                                                               "/api/dags")[0] == 403
    finally:
        for _, srv, _ in servers.values():
            srv.shutdown()
            srv.server_close()


# -------------------------------------------------------------- artifacts


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_artifact_functions_equal_the_jax_ones(seed):
    rng = np.random.default_rng(seed)
    n, c = 200, 5
    y = rng.integers(0, c, n)
    probs = rng.random((n, c))
    probs[np.arange(n), y] += rng.random(n) * (seed + 1)      # better than chance
    pred = probs.argmax(-1)
    names = ["cat", "dog", "eel"]                               # shorter than c
    _same(tart.confusion_matrix(y, pred, c), jart.confusion_matrix(y, pred, c))
    for k in range(c):
        for mp in (8, 64, 500):
            _same(tart.pr_curve(y == k, probs[:, k], mp), jart.pr_curve(y == k, probs[:, k], mp))
        _same(tart.average_precision(y == k, probs[:, k]),
              jart.average_precision(y == k, probs[:, k]))
    _same(tart.pr_curve(np.zeros(n, bool), probs[:, 0]), jart.pr_curve(np.zeros(n, bool),
                                                                      probs[:, 0]))
    for kw in ({}, {"class_names": names, "top_worst": 4},
               {"sample_indices": rng.permutation(1000)[:n], "max_confusion": 3}):
        _same(tart.classification_report(y, probs, **kw), jart.classification_report(y, probs,
                                                                                    **kw))
    onehot = np.eye(c)[y]
    _same(tart.classification_report(onehot, probs), jart.classification_report(onehot, probs))
    masks = rng.integers(-1, 4, (2, 6, 7))
    masks[0, 0, :3] = 255
    logits = rng.random((2, 6, 7, 4))
    for kw in ({}, {"num_classes": 6, "class_names": names}, {"ignore_label": 255}):
        _same(tart.segmentation_report(masks, logits, **kw),
              jart.segmentation_report(masks, logits, **kw))
    _same(tart.segmentation_report(masks, logits.argmax(-1)),
          jart.segmentation_report(masks, logits.argmax(-1)))
    cm = rng.integers(0, 50, (70, 70))
    _same(tart.segmentation_report_from_confusion(cm), jart.segmentation_report_from_confusion(cm))


@pytest.mark.parametrize("layout", [
    LAYOUT, ["summary", "gallery", "confusion"], [], "summary", [{"type": "series"}],
    [{"type": "bogus"}], [{"type": "series", "metrics": ["a"], "title": 3}],
    [{"type": "summary", "extra": 1}], [None]])
def test_layout_payload_and_publish_equal_the_jax_ones(layout):
    def outcome(fn):
        try:
            return "ok", fn(layout)
        except ValueError as e:
            return "ValueError", str(e)

    assert outcome(tart.layout_payload) == outcome(jart.layout_payload)

    class Ctx:
        def __init__(self):
            self.calls = []

        def report(self, name, payload):
            self.calls.append(("report", name, payload))

        def log(self, message, level="info"):
            self.calls.append(("log", level, message))

    for cfg in ({"layout": layout}, {"other": 1}, None, layout):
        jc, tc = Ctx(), Ctx()
        assert tart.publish_layout(tc, cfg) == jart.publish_layout(jc, cfg)
        assert tc.calls == jc.calls
