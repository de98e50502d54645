"""The port's fleet against the JAX package's: the router's affinity key
and ranking, the autoscaler's decisions, the manager's reconcile, restart
and drain, the registry file, a router in front of one JAX and one port
replica, the phase-split two-hop path through ``cli fleet``, and the
``serve_replica`` executor.

Replicas serve the tiny f32 fixture of the other port tests (vocab 64,
hidden 64, 2 layers) on the CPU.  The JAX router's own two-hop test flakes
(ROADMAP §C), so the port's two-hop path is held against the JAX
monolithic engine's greedy ids, not against the JAX two-hop.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from dataclasses import asdict
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mlcomp_tpu.fleet import autoscale as jautoscale
from mlcomp_tpu.fleet import manager as jmanager
from mlcomp_tpu.fleet import registry as jregistry
from mlcomp_tpu.fleet import router as jrouter
from mlcomp_tpu.models import create_model as j_create
from mlcomp_tpu.serve import GenerationService as JService
from mlcomp_tpu.serve import make_http_server as j_make_http_server
from mlcomp_tpu_torch.fleet import autoscale, manager, registry, router
from mlcomp_tpu_torch.io.weights import init_params, save_npz
from mlcomp_tpu_torch.serve import load_service, make_http_server

REPO = Path(__file__).resolve().parents[1]

torch.set_num_threads(1)

CFG = {"name": "transformer_lm", "vocab_size": 64, "hidden": 64, "layers": 2, "heads": 2,
       "mlp_dim": 128, "dtype": "float32"}
TREE = init_params(CFG, seed=0)
SVC_KW = dict(batch_sizes=(1, 2), prompt_buckets=(16,), max_new_buckets=(8,), prefill_chunk=8,
              metrics_history_interval=0)
PACKAGES = {"jax": (jrouter, jautoscale, jmanager, jregistry),
            "port": (router, autoscale, manager, registry)}


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 64, int(rng.integers(3, 14))).tolist() for _ in range(n)]


# ------------------------------------------------------------ the router


def test_affinity_digest_and_ranking_equal_the_jax_routers():
    rng = np.random.default_rng(0)
    names = [f"10.0.0.{i}:{8900 + i}" for i in range(6)]
    prompts = _prompts(64) + [rng.integers(0, 1 << 20, 200).tolist(), [], [7] * 40]
    routers = {pkg: mods[0].Router(urls=[f"http://{n}" for n in names], affinity_tokens=16,
                                   fetch=lambda *a, **k: {"ok": True, "ready": True},
                                   clock=lambda: 0.0)
               for pkg, mods in PACKAGES.items()}
    for r in routers.values():
        r.poll_once()
    for p in prompts:
        keys = {pkg: r.affinity_key(p) for pkg, r in routers.items()}
        assert keys["port"] == keys["jax"]
        if keys["port"] is None:
            continue
        for k in (3, 6):
            assert (router.rendezvous_rank(keys["port"], names[:k])
                    == jrouter.rendezvous_rank(keys["jax"], names[:k]))
        picks = {pkg: r.choose(keys[pkg]) for pkg, r in routers.items()}
        assert picks["port"][0]["name"] == picks["jax"][0]["name"]
        assert picks["port"][1] == picks["jax"][1] == "affinity"


# ------------------------------------------------------------ autoscaler


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_autoscaler_decisions_equal_the_jax_autoscalers(seed):
    policy = dict(min_replicas=1, max_replicas=5, sustain_s=20.0, idle_s=120.0,
                  cooldown_s=40.0)
    runs = {}
    for pkg, (_, asc, _, _) in PACKAGES.items():
        now = [0.0]
        applied = []
        mgr = SimpleNamespace(target=2, set_target=applied.append, urls=lambda: [])
        sc = asc.Autoscaler(asc.AutoscalePolicy(**policy), manager=mgr, clock=lambda: now[0],
                            dry_run=bool(seed % 2))
        rng_run = np.random.default_rng(seed)
        out = []
        for _ in range(80):
            now[0] += float(rng_run.choice([1.0, 5.0, 15.0, 60.0]))
            sig = asc.FleetSignals(
                slo_breached=bool(rng_run.random() < 0.3),
                reject_ratio=float(rng_run.choice([0.0, 0.0, 0.05, 0.5])),
                requests_delta=int(rng_run.choice([0, 0, 3, 40])),
                live_replicas=int(rng_run.integers(1, 6)))
            # each decision stamps the wall clock
            out.append({k: v for k, v in sc.observe(sig).items() if k != "t_unix"})
        st = sc.stats()
        st["last_decisions"] = [{k: v for k, v in d.items() if k != "t_unix"}
                                for d in st["last_decisions"]]
        runs[pkg] = (out, applied, st)
    assert runs["port"] == runs["jax"]
    assert {d["direction"] for d in runs["port"][0]} >= {"hold", "up"}


def test_autoscaler_scrape_equals_the_jax_autoscalers():
    payloads = [{"http://a": {"ok": True, "requests": 100, "rejected": {"queue_full": 10},
                              "slo": {"breached": [], "burn_rate": {
                                  "ttft_p95": {"fast": 2.0, "slow": 1.5}}}},
                 "http://b": ConnectionRefusedError("down")},
                {"http://a": {"ok": True, "requests": 140, "rejected": {"queue_full": 30},
                              "slo": {"breached": ["ttft_p95"]}},
                 "http://b": {"ok": False, "requests": 5}}]
    got = {}
    for pkg, (_, asc, _, _) in PACKAGES.items():
        state = {"i": 0}

        def fetch(url, path, timeout=None, payload=None):
            v = payloads[state["i"]][url]
            if isinstance(v, Exception):
                raise v
            return v

        sc = asc.Autoscaler(asc.AutoscalePolicy(), fetch=fetch)
        out = []
        for i in range(len(payloads)):
            state["i"] = i
            out.append(asdict(sc.scrape(["http://a", "http://b"])))
        got[pkg] = out
    assert got["port"] == got["jax"]


# --------------------------------------------------------------- manager


class _FakeFleet:
    """A launcher and a fetch that stand in for replicas, without HTTP."""

    def __init__(self, mgr_mod):
        self.mgr_mod = mgr_mod
        self.spawned, self.stopped, self.health = [], [], {}

    def launcher(self):
        def spawn(name, port):
            self.spawned.append(name)
            self.health.setdefault(name, {"ok": True, "ready": True, "queue_depth": 0})
            return SimpleNamespace(url=f"http://fake/{name}",
                                   stop=lambda n=name: self.stopped.append(n))

        return self.mgr_mod.CallableLauncher(spawn)

    def fetch(self, url, path, timeout=None, payload=None):
        name = url.rsplit("/", 1)[-1]
        if path == "/drain":
            self.health[name]["ready"] = False
            return {"ok": True, "draining": True}
        v = self.health[name]
        if isinstance(v, Exception):
            raise v
        return v


def _scenario(pkg, tmp_path):
    """Reconcile to 2, scale to 3, a replica's restarts through its budget,
    then a drain before scale-down: the trace of everything observable."""
    _, _, mgr_mod, reg_mod = PACKAGES[pkg]
    fleet = _FakeFleet(mgr_mod)
    now = [0.0]
    path = str(tmp_path / f"{pkg}.json")
    mgr = mgr_mod.ReplicaManager(
        fleet.launcher(),
        mgr_mod.ReplicaSpec(target=2, unhealthy_after=2, restart_budget=2,
                            healthy_reset_s=50.0, startup_grace_s=0.0, drain_timeout_s=100.0),
        registry_path=path, clock=lambda: now[0], fetch=fleet.fetch)
    trace = []

    def tick(n=1):
        for _ in range(n):
            now[0] += 1.0
            mgr.tick()
        st = mgr.stats()
        reg = {k: {f: v for f, v in e.items() if f != "updated_unix"}
               for k, e in reg_mod.read_registry(path).items()}
        trace.append((list(fleet.spawned), list(fleet.stopped), st["live"], st["target"],
                      st["states"], st["restarts"], reg))

    tick()
    mgr.set_target(3)
    tick()
    fleet.health["fleet-2"] = {"ok": False, "ready": False, "queue_depth": 0}
    tick(2)
    tick(2)
    tick(4)                                     # the budget is spent: failed
    fleet.health["fleet-1"]["queue_depth"] = 3
    mgr.set_target(2)
    tick()
    fleet.health["fleet-2"] = {"ok": True, "ready": True, "queue_depth": 0}
    mgr.set_target(1)
    tick()                                      # fleet-1 drains, in-flight work
    fleet.health["fleet-1"]["queue_depth"] = 0
    fleet.health["fleet-1"]["engine"] = {"active_slots": 1}
    tick(2)
    fleet.health["fleet-1"]["engine"] = {"active_slots": 0}
    tick(2)
    return trace


def test_manager_reconciles_restarts_and_drains_as_the_jax_manager(tmp_path):
    port, jax_ = _scenario("port", tmp_path), _scenario("jax", tmp_path)
    assert port == jax_
    spawned, stopped, live, target, states, restarts, reg = port[-1]
    assert spawned.count("fleet-2") == 3                      # two restarts, then failed
    assert restarts["budget_exhausted"] >= 1
    assert "fleet-1" in stopped and target == 1 and "fleet-1" not in reg
    # fleet-1 was drained (ready false, still running) before its stop
    drained = next(t for t in port if t[6].get("fleet-1", {}).get("state") == "draining")
    assert "fleet-1" not in drained[1]


def test_manager_metrics_families_equal_the_jax_managers(tmp_path):
    from mlcomp_tpu.obs.metrics import Registry as JRegistry
    from mlcomp_tpu_torch.obs.metrics import Registry

    texts = {}
    for pkg, reg_cls in (("jax", JRegistry), ("port", Registry)):
        mgr_mod = PACKAGES[pkg][2]
        fleet = _FakeFleet(mgr_mod)
        reg = reg_cls()
        mgr = mgr_mod.ReplicaManager(fleet.launcher(), mgr_mod.ReplicaSpec(target=1),
                                     metrics=reg, registry_path=str(tmp_path / f"{pkg}.json"),
                                     clock=lambda: 0.0, fetch=fleet.fetch)
        mgr.tick()
        texts[pkg] = reg.render()
    assert texts["port"] == texts["jax"]
    assert "mlcomp_fleet_replicas_live 1" in texts["port"]


# -------------------------------------------------------------- registry


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_registry_written_by_either_package_reads_in_both(writer, tmp_path):
    w = PACKAGES[writer][3]
    path = str(tmp_path / "reg.json")
    w.update_entry(path, "fleet-0", url="http://h:1", state="starting")
    w.update_entry(path, "fleet-0", url=None, state="live")
    w.update_entry(path, "fleet-1", url="http://h:2", state="draining", phase="decode")
    w.update_entry(path, "fleet-2", url="http://h:3", state="live")
    w.remove_entry(path, "fleet-2")
    reads = [(m.read_registry(path), m.registry_urls(path), m.registry_urls(path, ["live"]))
             for _, _, _, m in PACKAGES.values()]
    assert reads[0] == reads[1]
    assert reads[0][1] == ["http://h:1", "http://h:2"] and reads[0][2] == ["http://h:1"]


# -------------------------------------------------- replicas over HTTP


def _serve(svc, make):
    httpd = make(svc, "127.0.0.1", 0, "tiny")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(url, body, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _jax_service(**kw):
    return JService(j_create(dict(CFG)), {"params": jax.tree.map(jnp.asarray, TREE)},
                    **{**SVC_KW, **kw})


def test_a_router_over_a_jax_and_a_port_replica_gives_either_ones_tokens():
    jsvc = _jax_service()
    tsvc = load_service(CFG, params=TREE, device="cpu", **SVC_KW)
    jh, jurl = _serve(jsvc, j_make_http_server)
    th, turl = _serve(tsvc, make_http_server)
    r = router.Router(urls=[jurl, turl], health_poll_s=0.2)
    r.poll_once()
    rh = router.make_router_http_server(r, "127.0.0.1", 0)
    threading.Thread(target=rh.serve_forever, daemon=True).start()
    rurl = f"http://127.0.0.1:{rh.server_address[1]}"
    names = {jurl[len("http://"):]: "jax", turl[len("http://"):]: "port"}
    served = {}
    try:
        for p in _prompts(12, seed=3):
            body = {"prompt": p, "max_new_tokens": 6}
            want = [_post(u + "/generate", body)[1]["ids"] for u in (jurl, turl)]
            assert want[0] == want[1]
            code, res, hdrs = _post(rurl + "/generate", body)
            assert code == 200 and res["ids"] == want[0]
            served.setdefault(names[hdrs["x-mlcomp-replica"]], []).append(p)
            # a repeated prompt keeps its replica
            assert _post(rurl + "/generate", body)[2]["x-mlcomp-replica"] == \
                hdrs["x-mlcomp-replica"]
        assert set(served) == {"jax", "port"}
        # the router records a request's outcome after it has written the
        # response: the last record may land just after the client reads it
        deadline = time.time() + 30
        while r.status()["counts"]["outcome"]["ok"] < 24 and time.time() < deadline:
            time.sleep(0.05)
        assert r.status()["counts"]["outcome"]["ok"] == 24
    finally:
        rh.shutdown()
        rh.server_close()
        r.close()
        for h, s in ((jh, jsvc), (th, tsvc)):
            h.shutdown()
            h.server_close()
            s.close()


def _free_ports(n):
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def test_cli_fleet_phase_split_gives_the_jax_monolithic_engines_ids(tmp_path):
    """``cli fleet --phase-split 1:1``: the port's router brokers each
    /generate as /prefill on a prefill daemon, then /import on a paged
    decode daemon, and returns the JAX monolithic engine's greedy ids."""
    prompts = _prompts(5, seed=7)
    jsvc = _jax_service()
    try:
        want = [jsvc.submit(p, 6).result(timeout=300)["ids"] for p in prompts]
    finally:
        jsvc.close()
    save_npz(str(tmp_path / "w.npz"), TREE)
    (tmp_path / "m.yml").write_text(yaml.safe_dump({"model": CFG}))
    rport, lo = _free_ports(2)
    reg = tmp_path / "reg.json"
    serve = ("--device cpu --batch-sizes 1,2 --prompt-buckets 16 --max-new-buckets 8"
             " --prefill-chunk 8 --kv-page-tokens 4 --metrics-history-interval 0"
             " --max-slots 4")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mlcomp_tpu_torch.cli", "fleet", "--model",
         str(tmp_path / "m.yml"), "--ckpt", str(tmp_path / "w.npz"), "--phase-split", "1:1",
         "--port", str(rport), "--port-range", f"{lo}:{lo + 40}", "--registry", str(reg),
         "--health-poll", "0.3", "--serve-arg", serve, "--log-dir", str(tmp_path / "logs")],
        env={**os.environ, "PYTHONPATH": str(REPO)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, start_new_session=True)
    rurl = f"http://127.0.0.1:{rport}"
    try:
        deadline = time.monotonic() + 90
        status = {}
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(rurl + "/healthz", timeout=5) as r:
                    status = json.loads(r.read())
                if status.get("live_by_phase", {}) == {"both": 0, "prefill": 1, "decode": 1}:
                    break
            except (urllib.error.URLError, OSError, ValueError):
                pass
            time.sleep(0.3)
        else:
            raise AssertionError(f"fleet not live: {status}")
        got = []
        for p in prompts:
            code, res, hdrs = _post(rurl + "/generate", {"prompt": p, "max_new_tokens": 6})
            assert code == 200, res
            assert hdrs["x-mlcomp-replica"].startswith("decode")
            got.append(res["ids"])
        assert got == want
        with urllib.request.urlopen(rurl + "/healthz", timeout=5) as r:
            counts = json.loads(r.read())["counts"]
        assert counts["handoffs"] == len(prompts) and counts["handoff_failures"] == 0
        assert counts["handoff_bytes"] > 0
        entries = registry.read_registry(str(reg))
        assert sorted(e["phase"] for e in entries.values()) == ["decode", "prefill"]
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out = proc.communicate(timeout=60)[0].decode()
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out = proc.communicate()[0].decode()
    assert '"phase_split": "1:1"' in out
    # SIGTERM stopped the replicas and emptied the registry
    assert registry.read_registry(str(reg)) == {}
    for log in (tmp_path / "logs").glob("*.log"):
        assert "Traceback" not in log.read_text(), log.read_text()[-2000:]


def test_serve_replica_publishes_serves_and_ends_on_stop(tmp_path):
    from mlcomp_tpu_torch.db.store import Store
    from mlcomp_tpu_torch.scheduler.supervisor import Supervisor
    from mlcomp_tpu_torch.scheduler.worker import Worker

    db = str(tmp_path / "store.sqlite")
    reg = str(tmp_path / "reg.json")
    save_npz(str(tmp_path / "w.npz"), TREE)
    store = Store(db)
    launcher = manager.SchedulerLauncher(
        store, CFG, reg,
        serve_args={"ckpt": str(tmp_path / "w.npz"), "batch_sizes": [1, 2],
                    "prompt_buckets": [16], "max_new_buckets": [8], "prefill_chunk": 8,
                    "metrics_history_interval": 0, "stop_poll_s": 0.2, "warmup": True})
    handle = launcher.spawn("fleet-0", 0)
    assert handle.url is None
    Supervisor(store).tick()
    done = threading.Event()

    def run_worker():
        w = Worker(Store(db), name="w0", workdir=str(tmp_path / "w"), isolate=False,
                   device="cpu")
        w.run_once()
        done.set()

    t = threading.Thread(target=run_worker, daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not handle.url:
            time.sleep(0.1)
        url = handle.url
        assert url and registry.read_registry(reg)["fleet-0"]["url"] == url
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
                hz = json.loads(r.read())
            if hz["ready"]:
                break
            time.sleep(0.1)
        assert hz["ok"] and hz["ready"] and hz["model"] == "transformer_lm"
        ref = load_service(CFG, ckpt_path=str(tmp_path / "w.npz"), device="cpu", **SVC_KW)
        try:
            for p in _prompts(3, seed=5):
                want = ref.submit(p, 6).result(timeout=120)["ids"]
                assert _post(url + "/generate", {"prompt": p, "max_new_tokens": 6})[1]["ids"] \
                    == want
        finally:
            ref.close()
        handle.stop()
        t.join(timeout=60)
        assert done.is_set(), "the worker did not release the replica"
        assert "fleet-0" not in registry.read_registry(reg)
        row = store.task_rows(handle.dag_id)[0]
        assert row["status"] == "stopped" and row["executor"] == "serve_replica"
    finally:
        if t.is_alive():
            store.stop_dag(handle.dag_id)
            t.join(timeout=60)
        store.close()


def test_the_scheduler_launcher_spawns_from_the_managers_thread(tmp_path):
    """The manager spawns from its reconcile thread.  The port's launcher,
    given the store's path, opens a connection on that thread; the
    reference's CLI hands it the main thread's Store, which sqlite refuses
    there (the JAX ``cli fleet --scheduler`` fails at its first spawn)."""
    import sqlite3

    from mlcomp_tpu.db.store import Store as JStore
    from mlcomp_tpu_torch.db.store import Store

    db = str(tmp_path / "db.sqlite")
    out = {}

    def on_thread(fn):
        t = threading.Thread(target=lambda: out.update(result=_catch(fn)))
        t.start()
        t.join()
        return out["result"]

    jstore = JStore(db)
    try:
        jl = jmanager.SchedulerLauncher(jstore, CFG, str(tmp_path / "jreg.json"))
        assert isinstance(on_thread(lambda: jl.spawn("fleet-0", 0)), sqlite3.ProgrammingError)
    finally:
        jstore.close()
    tl = manager.SchedulerLauncher(db, CFG, str(tmp_path / "reg.json"))
    handle = on_thread(lambda: tl.spawn("fleet-0", 0))
    on_thread(handle.stop)
    store = Store(db)
    try:
        rows = store.task_rows(handle.dag_id)
    finally:
        store.close()
    assert [(r["name"], r["executor"], r["status"]) for r in rows] == [
        ("fleet-0", "serve_replica", "stopped")]


def _catch(fn):
    try:
        return fn()
    except Exception as e:
        return e


def test_cli_fleet_scheduler_runs_replicas_on_the_daemons_and_stop_ends_them(tmp_path):
    """``cli fleet --scheduler --replicas 2`` over the port's supervisor and
    a CPU worker: two serve_replica tasks serve behind the router, a
    repeated prompt keeps its replica and gets ``load_service``'s ids, and
    once the manager is gone ``stop`` ends both tasks and empties the
    registry."""
    from mlcomp_tpu_torch import cli as tcli
    from mlcomp_tpu_torch.db.store import Store

    save_npz(str(tmp_path / "w.npz"), TREE)
    (tmp_path / "m.yml").write_text(yaml.safe_dump({"model": CFG}))
    db, reg = str(tmp_path / "db.sqlite"), str(tmp_path / "reg.json")
    env = {**os.environ, "PYTHONPATH": str(REPO), "MLCOMP_TPU_HOST_IP": "127.0.0.1"}
    (tmp_path / "work").mkdir()

    def spawn(*argv):
        return subprocess.Popen([sys.executable, "-m", "mlcomp_tpu_torch.cli", *argv],
                                cwd=str(tmp_path), env=env, stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL, start_new_session=True)

    rport = _free_ports(1)[0]
    procs = [spawn("supervisor", "--db", db, "--poll", "0.2"),
             spawn("worker", "--db", db, "--chips", "1", "--max-tasks", "2", "--workdir",
                   str(tmp_path / "work"), "--poll", "0.2", "--device", "cpu")]
    fleet = spawn("fleet", "--scheduler", "--replicas", "2", "--db", db, "--model",
                  str(tmp_path / "m.yml"), "--ckpt", str(tmp_path / "w.npz"), "--registry", reg,
                  "--port", str(rport), "--health-poll", "0.3")
    rurl = f"http://127.0.0.1:{rport}"
    try:
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(rurl + "/healthz", timeout=5) as r:
                    if json.loads(r.read())["live"] == 2:
                        break
            except (urllib.error.URLError, OSError, ValueError):
                pass
            time.sleep(0.3)
        else:
            raise AssertionError("the scheduler fleet never had 2 live replicas")
        prompt = _prompts(1, seed=11)[0]
        ref = load_service(CFG, ckpt_path=str(tmp_path / "w.npz"), device="cpu")
        try:
            want = ref.submit(prompt, 6).result(timeout=120)["ids"]
        finally:
            ref.close()
        replies = [_post(rurl + "/generate", {"prompt": prompt, "max_new_tokens": 6})
                   for _ in range(3)]
        assert [r[1]["ids"] for r in replies] == [want] * 3
        assert len({r[2]["x-mlcomp-replica"] for r in replies}) == 1
        fleet.kill()                  # the replicas are tasks: they outlive the manager
        fleet.wait()
        store = Store(db)
        try:
            dags = [d["id"] for d in store.list_dags() if d["status"] == "in_progress"]
        finally:
            store.close()
        assert len(dags) == 2 and len(registry.read_registry(reg)) == 2
        for d in dags:
            assert tcli.main(["stop", str(d), "--db", db]) == 0
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            store = Store(db)
            try:
                st = [store.task_rows(d)[0]["status"] for d in dags]
            finally:
                store.close()
            if st == ["stopped"] * 2 and not registry.read_registry(reg):
                break
            time.sleep(0.2)
        else:
            raise AssertionError(f"after stop: {st}, {registry.read_registry(reg)}")
    finally:
        if fleet.poll() is None:
            fleet.kill()
        store = Store(db)
        try:                          # the worker ends what still runs
            for d in store.list_dags():
                store.stop_dag(d["id"])
        finally:
            store.close()
        time.sleep(1.0)
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in [fleet] + procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()


def test_load_service_quantizes_file_weights_on_the_models_device(tmp_path, monkeypatch):
    """A replica loads its weights from a file: they reach the model's
    device before the int8 quantization, as a tree handed over in-process
    does (on the card, host and device round the scale differently, so a
    host-quantized file served other codes than the same tree on the
    card)."""
    from mlcomp_tpu_torch.ops import quant

    seen = []
    real = quant.quantize_leaf

    def spy(w, reduce_axes=None):
        seen.append((type(w).__name__, str(getattr(w, "device", None))))
        return real(w, reduce_axes)

    monkeypatch.setattr(quant, "quantize_leaf", spy)
    save_npz(str(tmp_path / "w.npz"), TREE)
    got = {}
    for src, kw in (("npz", {"ckpt_path": str(tmp_path / "w.npz")}), ("tree", {"params": TREE})):
        seen.clear()
        svc = load_service(CFG, device="cpu", quantize="kernel", **kw, **SVC_KW)
        try:
            got[src] = (sorted(set(seen)), svc.submit([5, 9, 2, 7], 6).result(timeout=120)["ids"])
        finally:
            svc.close()
    assert got["npz"][0] == [("Tensor", "cpu")]
    assert got["npz"][1] == got["tree"][1]
