"""ReplicaManager: serve daemons as managed long-lived tasks (the port's copy of
mlcomp_tpu/fleet/manager.py).

The Supervisor/Worker scheduler already knows how to run work on a
fleet of hosts and restart it when a worker dies; serving was the one
workload it couldn't express — a serve daemon never "finishes", so
nothing reconciled "I want N replicas of this model" against reality.
This module is that reconciler, deliberately shaped like the
Supervisor: stateless decisions recomputed from observed state every
tick, so it can crash and resume without extra coordination.

One :class:`ReplicaManager` owns one replica set:

- **reconcile**: spawn replicas (through a pluggable launcher) until
  the live count meets ``target``; drain-then-stop the highest-index
  replicas when the target drops (``POST /drain`` flips the replica's
  ``ready`` bit so the router stops sending new work, then the stop
  lands once in-flight requests finish or the drain window closes).
- **health**: poll every replica's ``/healthz``; ``ok: false`` (503)
  or no answer for ``unhealthy_after`` consecutive polls marks it
  unhealthy.  The watchdog's verdict is reused, not reinvented — a
  replica that reports ``ready: false`` but ``ok: true`` (warmup
  compiles, deliberate drain) is routed around, never restarted.
- **restart**: unhealthy replicas restart through the launcher with a
  BOUNDED budget (``restart_budget``), progress-gated like the
  engine's own watchdog restart: ``healthy_reset_s`` of continuous
  health refills the budget, so a replica that crash-loops stops
  burning spawns but one that recovers keeps its insurance.
- **registry**: every change lands in the JSON registry file
  (fleet/registry.py) the router and the report server's ``/fleet``
  surfaces read — ``MLCOMP_TPU_SERVE_URLS`` becomes a dynamic
  registry with the env var kept as the static fallback.

Launchers decouple "what a replica is" from the reconcile loop:

- :class:`CallableLauncher` — in-process factories (tests, chaos
  harnesses).
- :class:`SubprocessLauncher` — ``mlcomp-tpu serve`` children on this
  host (the single-host production shape, ``mlcomp-tpu fleet``).
- :class:`SchedulerLauncher` — one single-task DAG per replica through
  the Store; any Worker claims and runs it via the ``serve_replica``
  executor (executors/serve.py), the Supervisor requeues it if that
  worker dies, and the replica publishes its own URL into the registry
  from whatever host it landed on.  This is the multi-host path: the
  manager needs no SSH, only the shared store and registry.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.error
import urllib.request
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from mlcomp_tpu_torch.fleet.registry import (
    read_registry,
    remove_entry,
    update_entry,
)

RESTART_REASONS = ("unhealthy", "budget_exhausted")


def fetch_json(url: str, path: str, timeout: float = 3.0,
               payload: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """GET (or POST, when ``payload`` is given) a daemon endpoint and
    parse the JSON body — the serve daemons answer JSON on error codes
    too (a 503 /healthz still carries the full stats), so HTTP errors
    with a parsable body are returned, not raised."""
    headers = {}
    token = os.environ.get("MLCOMP_TPU_SERVE_TOKEN", "")
    if token:
        headers["Authorization"] = f"Bearer {token}"
    data = None
    if payload is not None:
        data = json.dumps(payload).encode()
        headers["Content-Type"] = "application/json"
    req = urllib.request.Request(url + path, data=data, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        body = e.read()
        try:
            return json.loads(body)
        except ValueError:
            raise e from None


@dataclass
class ReplicaSpec:
    """What the manager reconciles toward."""

    target: int = 1
    set_name: str = "fleet"
    # disaggregation role every replica in this set serves: "both" is
    # the monolithic daemon; a PHASE-SPLIT fleet runs one manager per
    # role (a "prefill" set and a "decode" set) discovered by one
    # router, which routes fresh prompts through the two-hop handoff
    # the moment both roles have a live replica
    phase: str = "both"
    # inclusive port window replicas are assigned from; None lets the
    # launcher (or the OS) pick — in-process/test launchers bind
    # ephemeral ports and report them back through the handle URL
    port_range: Optional[Tuple[int, int]] = None
    health_poll_s: float = 1.0
    health_timeout_s: float = 2.0
    # consecutive failed/503 polls before a restart fires: rides the
    # health-poll cadence, so the detection bound is
    # unhealthy_after * health_poll_s (+ one timeout)
    unhealthy_after: int = 3
    restart_budget: int = 3
    healthy_reset_s: float = 60.0
    drain_timeout_s: float = 10.0
    # how long a (re)spawned replica may stay silent before failed
    # polls count: a real serve child needs tens of seconds to load
    # weights and compile before it binds, and without this grace the
    # manager would kill-loop every starting replica through its whole
    # restart budget (a replica that HAS answered healthy since its
    # last (re)start gets no grace — its death is detected at the
    # normal unhealthy_after bound)
    startup_grace_s: float = 180.0

    def __post_init__(self):
        if self.target < 0:
            raise ValueError(f"target must be >= 0, got {self.target}")
        if self.phase not in ("both", "prefill", "decode"):
            raise ValueError(
                f"phase must be 'both', 'prefill', or 'decode'; got "
                f"{self.phase!r}"
            )
        if self.health_poll_s <= 0:
            raise ValueError("health_poll_s must be positive")
        if self.unhealthy_after < 1:
            raise ValueError("unhealthy_after must be >= 1")
        if self.restart_budget < 0:
            raise ValueError("restart_budget must be >= 0")
        if self.port_range is not None:
            lo, hi = self.port_range
            if not 0 < lo <= hi:
                raise ValueError(
                    f"port_range must be (lo, hi) with 0 < lo <= hi, "
                    f"got {self.port_range}"
                )


class _Replica:
    __slots__ = (
        "name", "handle", "port", "url", "state", "fails", "restarts",
        "last_restart_t", "last_healthy_t", "drain_deadline",
        "queue_depth", "active", "ready", "published",
    )

    def __init__(self, name: str, handle, port: int):
        self.name = name
        self.handle = handle
        self.port = port
        self.url: Optional[str] = getattr(handle, "url", None)
        self.state = "starting"
        self.fails = 0
        self.restarts = 0
        self.last_restart_t: Optional[float] = None
        self.last_healthy_t: Optional[float] = None
        self.drain_deadline: Optional[float] = None
        self.queue_depth = 0
        self.active = 0  # decoding slots — NOT included in queue_depth
        self.ready = False
        self.published: Optional[Tuple[Optional[str], str]] = None


class CallableLauncher:
    """Wrap a ``spawn(name, port) -> handle`` callable; the handle must
    expose ``url`` and ``stop()``.  The test/chaos launcher."""

    def __init__(self, spawn_fn: Callable[[str, int], Any]):
        self._spawn = spawn_fn

    def spawn(self, name: str, port: int):
        return self._spawn(name, port)


class _ProcHandle:
    def __init__(self, proc, url: str, log_path: Optional[str] = None):
        self.proc = proc
        self.url = url
        self.log_path = log_path

    def stop(self) -> None:
        import signal

        if self.proc.poll() is not None:
            return
        try:
            os.killpg(self.proc.pid, signal.SIGTERM)
        except OSError:
            self.proc.terminate()
        try:
            self.proc.wait(timeout=10.0)
        except Exception:
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except OSError:
                self.proc.kill()


class SubprocessLauncher:
    """Replicas as ``mlcomp-tpu serve`` children on this host — the
    ``mlcomp-tpu fleet`` single-host shape.  ``serve_argv`` is the flag
    tail after ``serve`` (model/ckpt/batcher flags); host/port are
    appended per replica, so the caller must not pass them."""

    def __init__(self, serve_argv: List[str], host: str = "127.0.0.1",
                 log_dir: Optional[str] = None):
        self.serve_argv = list(serve_argv)
        self.host = host
        self.log_dir = log_dir

    def spawn(self, name: str, port: int) -> _ProcHandle:
        import subprocess
        import sys

        if port <= 0:
            raise ValueError(
                "SubprocessLauncher needs an explicit port per replica "
                "(give the ReplicaSpec a port_range)"
            )
        argv = [
            sys.executable, "-m", "mlcomp_tpu_torch.cli", "serve",
            *self.serve_argv, "--host", self.host, "--port", str(port),
        ]
        log_path = None
        log_fh = subprocess.DEVNULL
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            log_path = os.path.join(self.log_dir, f"{name}.log")
            log_fh = open(log_path, "ab")
        try:
            proc = subprocess.Popen(
                argv, stdout=log_fh, stderr=subprocess.STDOUT,
                start_new_session=True,
            )
        finally:
            if log_fh is not subprocess.DEVNULL:
                log_fh.close()
        return _ProcHandle(
            proc, f"http://{self.host}:{port}", log_path
        )


@contextmanager
def _opened(store):
    """``store`` itself, or, given a path, a Store opened on it for this
    call alone: a sqlite connection serves only the thread that opened it,
    and the manager spawns and stops replicas from its own thread."""
    if not isinstance(store, (str, os.PathLike)):
        yield store
        return
    from mlcomp_tpu_torch.db.store import Store

    opened = Store(str(store))
    try:
        yield opened
    finally:
        opened.close()


class _SchedulerHandle:
    """A replica running somewhere on the worker fleet: the DAG id is
    the process handle, the registry file is where its URL appears."""

    def __init__(self, store, dag_id: int, name: str,
                 registry_path: str):
        self.store = store
        self.dag_id = dag_id
        self.name = name
        self.registry_path = registry_path

    @property
    def url(self) -> Optional[str]:
        entry = read_registry(self.registry_path).get(self.name, {})
        return entry.get("url") or None

    def stop(self) -> None:
        # stop_dag flips the task row; the executor's ownership poll
        # (in-process) or the worker's stop-watch (isolated child)
        # tears the daemon down within seconds
        with _opened(self.store) as store:
            store.stop_dag(self.dag_id)


class SchedulerLauncher:
    """Replicas as single-task DAGs through the Store: any Worker with
    the chips claims one, the ``serve_replica`` executor serves until
    stopped, and the Supervisor's dead-worker reaper requeues a replica
    whose host dies — the scheduler's whole failure machinery, reused
    for long-lived daemons.

    ``store`` is a Store used on one thread only, or the store's path: the
    ReplicaManager spawns from its reconcile thread and the fleet stops
    replicas from the main one, so ``cli fleet --scheduler`` passes the
    path and each call opens its own connection.  (The reference's CLI
    hands its main thread's Store to the manager thread, whose first spawn
    then fails in sqlite's thread check.)"""

    def __init__(self, store, model_cfg: Dict[str, Any],
                 registry_path: str,
                 serve_args: Optional[Dict[str, Any]] = None,
                 chips: int = 0, max_retries: int = 5,
                 project: str = "fleet"):
        self.store = store
        self.model_cfg = dict(model_cfg)
        self.registry_path = os.path.abspath(registry_path)
        self.serve_args = dict(serve_args or {})
        self.chips = int(chips)
        self.max_retries = int(max_retries)
        self.project = project

    def spawn(self, name: str, port: int) -> _SchedulerHandle:
        from mlcomp_tpu_torch.dag.schema import DagSpec, ResourceSpec, TaskSpec

        args = {
            "model": self.model_cfg,
            "replica": name,
            "registry": self.registry_path,
            "port": int(port),
            **self.serve_args,
        }
        dag = DagSpec(
            name=f"{self.project}-{name}",
            project=self.project,
            tasks=(TaskSpec(
                name=name,
                executor="serve_replica",
                args=args,
                stage="infer",
                resources=ResourceSpec(chips=self.chips),
                max_retries=self.max_retries,
            ),),
        )
        with _opened(self.store) as store:
            dag_id = store.submit_dag(dag)
        return _SchedulerHandle(
            self.store, dag_id, name, self.registry_path
        )


class ReplicaManager:
    """Reconcile a :class:`ReplicaSpec` against live serve daemons.

    Call :meth:`tick` from your own loop (tests), or :meth:`start` for
    the background thread.  All HTTP happens OUTSIDE the lock — a slow
    replica must not stall ``set_target``/``replicas()`` readers.
    """

    def __init__(self, launcher, spec: ReplicaSpec,
                 metrics=None, registry_path: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic,
                 fetch: Callable[..., Dict[str, Any]] = fetch_json):
        self.launcher = launcher
        self.spec = spec
        self.registry_path = registry_path
        self._clock = clock
        self._fetch = fetch
        self._lock = threading.Lock()
        self._replicas: Dict[str, _Replica] = {}  # guarded_by: _lock
        self._target = int(spec.target)  # guarded_by: _lock
        self._next_index = 0  # guarded_by: _lock
        self._restart_counts = {r: 0 for r in RESTART_REASONS}  # guarded_by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.metrics = metrics
        if metrics is not None:
            metrics.register_collector(self._collect_metrics)

    # ------------------------------------------------------------ control

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="fleet-manager", daemon=True
        )
        self._thread.start()

    def close(self, stop_replicas: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.spec.health_poll_s + 10.0)
            self._thread = None
        if stop_replicas:
            with self._lock:
                reps = list(self._replicas.values())
            for r in reps:
                try:
                    r.handle.stop()
                except Exception:
                    pass
                self._registry_remove(r.name)

    def set_target(self, n: int) -> int:
        """Set the desired replica count (the autoscaler's lever);
        takes effect at the next tick.  Returns the clamped value."""
        n = max(0, int(n))
        with self._lock:
            self._target = n
        return n

    @property
    def target(self) -> int:
        with self._lock:
            return self._target

    # ------------------------------------------------------------ reading

    def replicas(self) -> List[Dict[str, Any]]:
        """Point-in-time snapshot the router's discovery reads: name,
        url, state, readiness, queue depth, restart count."""
        with self._lock:
            return [
                {
                    "name": r.name, "url": r.url, "state": r.state,
                    "ready": r.ready, "queue_depth": r.queue_depth,
                    "restarts": r.restarts, "phase": self.spec.phase,
                }
                for r in self._replicas.values()
            ]

    def urls(self, live_only: bool = False) -> List[str]:
        with self._lock:
            return [
                r.url for r in self._replicas.values()
                if r.url and (not live_only or r.state == "live")
            ]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            states: Dict[str, int] = {}
            for r in self._replicas.values():
                states[r.state] = states.get(r.state, 0) + 1
            return {
                "target": self._target,
                "live": states.get("live", 0),
                "states": states,
                "restarts": dict(self._restart_counts),
                "replicas": sorted(self._replicas),
                "phase": self.spec.phase,
            }

    # ------------------------------------------------------------- ticking

    def _run(self) -> None:
        while not self._stop.wait(self.spec.health_poll_s):
            try:
                self.tick()
            except Exception:
                # a reconcile hiccup (launcher raise, fs error) must
                # not kill the manager loop: next tick retries
                import logging

                logging.getLogger("mlcomp_tpu_torch.fleet").exception(
                    "fleet manager tick failed"
                )

    def tick(self) -> None:
        """One reconcile + health pass (also the unit tests' lever)."""
        self._reconcile_count()
        self._poll_health()
        self._apply_drains()

    # ----------------------------------------------------------- internals

    def _alloc_port(self) -> int:  # graftcheck: holds(_lock)
        if self.spec.port_range is None:
            return 0
        lo, hi = self.spec.port_range
        used = {r.port for r in self._replicas.values()}
        for p in range(lo, hi + 1):
            if p not in used:
                return p
        raise RuntimeError(
            f"port_range {self.spec.port_range} exhausted by "
            f"{len(used)} replicas"
        )

    def _counts_toward_target(self, r: _Replica) -> bool:
        # "failed" (budget exhausted) still counts: the manager gave up
        # on restarting it, but spawning a REPLACEMENT would just
        # crash-loop through a fresh budget and burn the port range —
        # a budget-exhausted replica is an operator page, not a slot
        # to refill (set_target can still add capacity elsewhere)
        return r.state in (
            "starting", "live", "unready", "unhealthy", "failed",
        )

    def _reconcile_count(self) -> None:
        to_spawn: List[Tuple[str, int]] = []
        with self._lock:
            active = [
                r for r in self._replicas.values()
                if self._counts_toward_target(r)
            ]
            while len(active) + len(to_spawn) < self._target:
                name = f"{self.spec.set_name}-{self._next_index}"
                self._next_index += 1
                to_spawn.append((name, self._alloc_port_for(name)))
            # too many: drain the YOUNGEST first (their caches are the
            # coldest), never a replica already draining
            excess = len(active) - self._target - len(to_spawn)
            drain_now: List[_Replica] = []
            if excess > 0:
                for r in sorted(active, key=_replica_index,
                                reverse=True)[:excess]:
                    r.state = "draining"
                    r.drain_deadline = (
                        self._clock() + self.spec.drain_timeout_s
                    )
                    drain_now.append(r)
        for name, port in to_spawn:
            self._spawn(name, port)
        for r in drain_now:
            self._send_drain(r)
            self._registry_update(r)

    def _alloc_port_for(self, name: str) -> int:  # graftcheck: holds(_lock)
        # placeholder entry so two spawns in one tick don't share a
        # port; the real _Replica lands in _spawn
        port = self._alloc_port()
        self._replicas[name] = _Replica(name, _PendingHandle(), port)
        return port

    def _spawn(self, name: str, port: int) -> None:
        try:
            handle = self.launcher.spawn(name, port)
        except Exception:
            import logging

            logging.getLogger("mlcomp_tpu_torch.fleet").exception(
                "spawn of replica %s failed", name
            )
            with self._lock:
                self._replicas.pop(name, None)
            return
        with self._lock:
            r = self._replicas[name]
            r.handle = handle
            r.url = getattr(handle, "url", None)
            r.last_restart_t = self._clock()
        self._registry_update(r)

    def _send_drain(self, r: _Replica) -> None:
        if not r.url:
            return
        try:
            self._fetch(
                r.url, "/drain", timeout=self.spec.health_timeout_s,
                payload={"draining": True},
            )
        except Exception:
            pass  # a dead replica drains itself

    def _poll_health(self) -> None:
        with self._lock:
            targets = [
                r for r in self._replicas.values()
                if r.state not in ("stopped", "failed")
            ]
            for r in targets:
                if r.url is None:
                    # scheduler replicas publish their URL when the
                    # executor binds; check the registry lazily
                    r.url = getattr(r.handle, "url", None)
        # poll CONCURRENTLY: serial polling would let one dead replica
        # cost the whole fleet a health_timeout_s per round, stretching
        # every other replica's detection bound with it
        def poll_one(r: _Replica):
            if not r.url:
                return (r, None)
            try:
                return (r, self._fetch(
                    r.url, "/healthz",
                    timeout=self.spec.health_timeout_s,
                ))
            except Exception:
                return (r, None)

        verdicts = _fetch_all(targets, poll_one)
        restart: List[_Replica] = []
        now = self._clock()
        with self._lock:
            for r, hz in verdicts:
                if r.state in ("stopped", "failed"):
                    continue
                ok = bool(hz and hz.get("ok"))
                if ok:
                    r.fails = 0
                    r.last_healthy_t = now
                    r.ready = bool(hz.get("ready", True))
                    r.queue_depth = int(hz.get("queue_depth") or 0)
                    # queue_depth excludes requests already decoding
                    # in a slot; the drain gate needs both to be zero
                    # before a stop is safe for in-flight streams
                    eng = hz.get("engine") or {}
                    r.active = int(eng.get("active_slots") or 0)
                    if r.state != "draining":
                        r.state = "live" if r.ready else "unready"
                    # progress gate: sustained health refills the
                    # restart budget (the engine's progress-gated
                    # restart, one level up)
                    if r.restarts and r.last_restart_t is not None and (
                        now - r.last_restart_t
                        >= self.spec.healthy_reset_s
                    ):
                        r.restarts = 0
                    continue
                r.ready = False
                if r.state == "draining":
                    continue  # the drain path owns its teardown
                never_up = (
                    r.last_healthy_t is None
                    or (r.last_restart_t is not None
                        and r.last_healthy_t < r.last_restart_t)
                )
                if never_up and r.last_restart_t is not None and (
                    now - r.last_restart_t < self.spec.startup_grace_s
                ):
                    # still inside the startup grace of its latest
                    # (re)spawn: silence is expected, not a verdict
                    r.fails = 0
                    continue
                r.fails += 1
                if r.fails < self.spec.unhealthy_after:
                    if r.state == "live":
                        r.state = "unhealthy"
                    continue
                if r.restarts >= self.spec.restart_budget:
                    if r.state != "failed":
                        r.state = "failed"
                        self._restart_counts["budget_exhausted"] += 1
                    continue
                r.restarts += 1
                r.fails = 0
                r.state = "starting"
                r.last_restart_t = now
                self._restart_counts["unhealthy"] += 1
                restart.append(r)
        for r in restart:
            try:
                r.handle.stop()
            except Exception:
                pass
            self._respawn(r)
        for r, _ in verdicts:
            self._registry_update(r)

    def _respawn(self, r: _Replica) -> None:
        try:
            handle = self.launcher.spawn(r.name, r.port)
        except Exception:
            import logging

            logging.getLogger("mlcomp_tpu_torch.fleet").exception(
                "restart of replica %s failed", r.name
            )
            with self._lock:
                r.state = "unhealthy"
            return
        with self._lock:
            r.handle = handle
            r.url = getattr(handle, "url", None)

    def _apply_drains(self) -> None:
        now = self._clock()
        done: List[_Replica] = []
        with self._lock:
            for r in self._replicas.values():
                if r.state != "draining":
                    continue
                if r.drain_deadline is None or now >= r.drain_deadline:
                    done.append(r)
                elif r.queue_depth == 0 and r.active == 0:
                    done.append(r)
        for r in done:
            try:
                r.handle.stop()
            except Exception:
                pass
            with self._lock:
                self._replicas.pop(r.name, None)
            self._registry_remove(r.name)

    # ----------------------------------------------------------- registry

    def _registry_update(self, r: _Replica) -> None:
        """Publish (url, state) — only on change: the health poll calls
        this every tick for every replica, and steady state must not
        rewrite the file N times a second (each rewrite is a
        cross-process read-modify-write)."""
        if self.registry_path is None:
            return
        pub = (r.url, r.state)
        if r.published == pub:
            return
        try:
            update_entry(
                self.registry_path, r.name, url=r.url, state=r.state,
                phase=self.spec.phase,
            )
            r.published = pub
        except OSError:
            pass

    def _registry_remove(self, name: str) -> None:
        if self.registry_path is None:
            return
        try:
            remove_entry(self.registry_path, name)
        except OSError:
            pass

    # ------------------------------------------------------------ metrics

    def _collect_metrics(self) -> None:
        m = self.metrics
        st = self.stats()
        m.gauge(
            "mlcomp_fleet_replicas_target",
            "Desired replica count the manager reconciles toward",
        ).set(st["target"])
        m.gauge(
            "mlcomp_fleet_replicas_live",
            "Replicas currently healthy AND ready for traffic",
        ).set(st["live"])
        c = m.counter(
            "mlcomp_fleet_replica_restarts_total",
            "Replica restarts the manager performed (or declined: "
            "budget_exhausted)",
            labelnames=("reason",),
        )
        for reason in RESTART_REASONS:
            c.set_total(st["restarts"].get(reason, 0), reason=reason)


class _PendingHandle:
    """Placeholder before the launcher returns: no URL, nothing to
    stop."""

    url = None

    def stop(self) -> None:
        pass


def _fetch_all(items, fn):
    """Run ``fn(item)`` for every item concurrently (bounded stdlib
    pool), results in input order — the fleet-scrape idiom the report
    server already uses."""
    items = list(items)
    if len(items) <= 1:
        return [fn(i) for i in items]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=min(len(items), 8)) as pool:
        return list(pool.map(fn, items))


def _replica_index(r: _Replica) -> Tuple[int, str]:
    """Numeric spawn order for scale-down victim selection: the
    youngest (highest index — coldest cache) drains first, and
    'fleet-10' must rank above 'fleet-9' (a lexicographic name sort
    would not)."""
    try:
        idx = int(r.name.rsplit("-", 1)[-1])
    except ValueError:
        idx = -1
    return (idx, r.name)
