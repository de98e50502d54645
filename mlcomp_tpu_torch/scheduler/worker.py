"""Worker: claims tasks from the store and runs executors.

The port's copy of mlcomp_tpu/scheduler/worker.py: it spawns
``mlcomp_tpu_torch.scheduler.child``, pins ``CUDA_VISIBLE_DEVICES`` where
the reference pins ``TPU_VISIBLE_DEVICES``, and hands its ``device`` (the
torch device the executors run on; ``None`` means ``cuda``) to every
task, inline through the ``ExecutionContext`` and isolated through the
child's spec.  Gang tasks (``hosts > 1``) fail in the child until the
port has a distributed runtime.

The reference runs one Docker worker per GPU; here a worker represents a
TPU-VM host (or a CPU-only host) advertising some number of TPU chips
(reference behavior: BASELINE.json:5).  Claiming is an atomic conditional
UPDATE in the store, so any number of worker processes can share one queue
without a lock service.

Two execution modes:

- **isolated** (production, ``isolate=True`` / CLI default): each task
  runs in a child process (scheduler/child.py) with env-pinned chip
  visibility.  A segfault/OOM/hard-kill inside an executor kills only the
  child; the worker reaps it into the normal retry machinery.  With
  enough chips the worker runs several children concurrently, each pinned
  to its own chip subset, and a task stopped from the CLI/dashboard gets
  its child killed instead of computing to a discarded finish.
- **in-process** (``isolate=False``, unit-test default): the executor
  runs inline — fast, but an executor crash is a worker crash.

Multi-host (``hosts: n``) tasks gang-schedule: this worker claims one
gang slot (db/store.py ``claim_gang_slot``), slot 0 publishes a
coordinator address, and once all slots fill each holder spawns its child
with ``MLCOMP_TPU_COORDINATOR/_NUM_PROCESSES/_PROCESS_ID`` set — making
``parallel/distributed.py``'s ``init_distributed`` find a live rendezvous.
Requires ``isolate`` (each slot needs its own JAX runtime).

While an executor runs (minutes to hours for training tasks), heartbeats
keep flowing so the Supervisor's failure detector does not reap a
healthy-but-busy worker.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

from mlcomp_tpu_torch.dag.schema import TaskStatus
from mlcomp_tpu_torch.db.store import Store
from mlcomp_tpu_torch.executors.base import ExecutionContext, run_task
from mlcomp_tpu_torch.utils.faults import inject


def default_worker_name() -> str:
    return f"{socket.gethostname()}-{os.getpid()}"


def sync_code(
    args: Dict[str, Any], task_id: int, workdir: str, store: Optional[Store]
) -> None:
    """Mirror the master's code snapshot (``args["code_src"]``, written by
    ``io.sync.snapshot_code`` at submit time) into this worker's workdir
    and make it importable — the reference family's master→worker project
    sync, hash-incremental here.  Shared by the in-process path and the
    child runner (scheduler/child.py)."""
    code_src = args.get("code_src")
    if not code_src:
        return
    import fcntl

    from mlcomp_tpu_torch.io.sync import sync_dirs

    dest = os.path.join(workdir, "code")
    os.makedirs(workdir, exist_ok=True)
    # serialize concurrent syncs into a SHARED workdir (localhost-degraded
    # multi-host runs every gang slot against one dest; real multi-host
    # has per-host workdirs): without the lock one child can import a file
    # the other is mid-copying/removing.  Same-content syncs after the
    # first are hash-incremental no-ops, so waiting is cheap.
    with open(dest + ".lock", "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        try:
            copied, removed = sync_dirs(code_src, dest)
        finally:
            fcntl.flock(lf, fcntl.LOCK_UN)
    if (copied or removed) and store is not None:
        store.log(
            task_id,
            "info",
            f"code sync: {len(copied)} copied, {len(removed)} removed",
        )
    if dest not in sys.path:
        sys.path.insert(0, dest)
    # import user modules so their @EXECUTORS.register classes exist;
    # re-import after a changed sync would need a restart (same rule as
    # the reference's worker: code changes mid-task are not hot-swapped)
    import importlib

    for mod in args.get("code_import", []):
        importlib.import_module(mod)


def _kill_surviving_child(scratch_dir: str) -> None:
    """Kill a task child (and its process group) that outlived its dead
    worker, identified by the ``child.pid`` file its worker recorded at
    spawn.  Verifies the pid still runs this framework's child module
    before signalling — pids recycle, and killing an innocent process
    group would be far worse than leaking one orphan."""
    import signal

    try:
        pid = int(open(os.path.join(scratch_dir, "child.pid")).read().strip())
    except (OSError, ValueError):
        return
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            cmdline = f.read()
    except OSError:
        return  # already gone (or no procfs — then we cannot verify: skip)
    if b"mlcomp_tpu_torch.scheduler.child" not in cmdline:
        return  # pid was recycled by an unrelated process
    try:
        os.killpg(pid, signal.SIGKILL)  # children start their own session
    except OSError:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass


# the kernel's ephemeral (client source) port range floor — coordinator
# ports must live BELOW it, see _bind_coordinator_socket
_EPHEMERAL_LO = 32768
try:
    with open("/proc/sys/net/ipv4/ip_local_port_range") as _f:
        _EPHEMERAL_LO = int(_f.read().split()[0])
except (OSError, ValueError, IndexError):
    pass


def _bind_coordinator_socket() -> socket.socket:
    """A bound+listening socket on a port OUTSIDE the ephemeral range.

    ``bind(("", 0))`` hands out a port from the kernel's ephemeral pool
    — the same pool client connections draw SOURCE ports from.  A gang
    child retry-connecting to such a coordinator port on the same host
    can be assigned that very port as its source and complete the TCP
    handshake WITH ITSELF (the classic localhost self-connect): the
    child then waits forever on a "coordinator" that is its own socket,
    and the real coordinator can never bind (EADDRINUSE) — exactly the
    failure the stolen-port gang test caught under load.  Below the
    ephemeral floor, source-port collisions are impossible."""
    import random
    import warnings

    # derive the window from the ACTUAL floor: a host with a widened
    # ephemeral range (e.g. "1024 65535" in containers) must not get
    # ports that are secretly inside it
    hi = _EPHEMERAL_LO
    lo = max(1024, hi - 16384)
    if hi - lo < 128:
        warnings.warn(
            f"ip_local_port_range floor {_EPHEMERAL_LO} leaves no "
            "non-ephemeral room for coordinator ports; falling back to "
            "an ephemeral port — localhost gang peers risk the TCP "
            "self-connect hang this function exists to prevent"
        )
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("", 0))
        s.listen(1)
        return s
    last: Optional[OSError] = None
    for _ in range(128):
        port = random.randrange(lo, hi)
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("", port))
            s.listen(1)
            return s
        except OSError as e:
            last = e
            s.close()
    raise RuntimeError(
        f"no free coordinator port in [{lo}, {hi}) after 128 tries: {last!r}"
    )


def _free_port() -> int:
    s = _bind_coordinator_socket()
    port = s.getsockname()[1]
    s.close()
    return port


def host_address() -> str:
    """Address other hosts can reach this one at (coordinator
    rendezvous, and the URL a scheduler-launched serve replica
    publishes into the fleet registry).  Env override first (TPU-VM
    metadata scripts set it); localhost fallback covers single-host and
    CPU-test topologies."""
    addr = os.environ.get("MLCOMP_TPU_HOST_IP")
    if addr:
        return addr
    try:
        ip = socket.gethostbyname(socket.gethostname())
        if not ip.startswith("127."):
            return ip
    except OSError:
        pass
    return "127.0.0.1"


class Worker:
    def __init__(
        self,
        store: Store,
        name: Optional[str] = None,
        chips: int = 0,
        hosts: int = 1,  # deprecated: gangs replaced self-declared hosts
        workdir: str = ".",
        heartbeat_interval_s: float = 5.0,
        load_jax_executors: bool = True,
        isolate: bool = False,
        max_tasks: Optional[int] = None,
        gang_wait_s: float = 60.0,
        child_env: Optional[Dict[str, str]] = None,
        device: Optional[str] = None,
    ):
        self.store = store
        self.device = device
        self.name = name or default_worker_name()
        self.chips = chips
        # absolute, resolved ONCE here: children run with cwd=workdir,
        # so relative scratch paths (and the --db default) would resolve
        # against the wrong directory inside them; resolving at spawn
        # time instead would break under a later chdir
        self.workdir = os.path.abspath(workdir)
        self._db_path = os.path.abspath(store.path)
        self.heartbeat_interval_s = heartbeat_interval_s
        self.isolate = isolate
        # chips=0 workers (CPU hosts) still run one task at a time unless
        # told otherwise; chip-ful workers default to chip-packing
        self.max_tasks = max_tasks if max_tasks is not None else max(1, chips)
        self.gang_wait_s = gang_wait_s
        self.child_env = dict(child_env or {})
        self._free_chip_ids = set(range(chips))
        self._children: List[Dict[str, Any]] = []
        os.makedirs(self.workdir, exist_ok=True)
        self._adopt_orphaned_tasks()
        self._sweep_stale_scratch()
        if load_jax_executors:
            from mlcomp_tpu_torch import executors

            executors.load_all()

    def _sync_code(self, args: Dict[str, Any], task_id: int) -> None:
        sync_code(args, task_id, self.workdir, self.store)

    def _predecessor_running(self, task_id: int) -> bool:
        """True when a previous same-name incarnation is STILL EXECUTING
        this task: its scratch dir in the (shared, per-host) workdir
        records the owning worker pid, and that pid is alive.  Guards
        adoption against the double-daemon case — e.g. a restarted
        `cli pool` whose SIGKILLed predecessor left its worker daemons
        running — where requeueing would run the task twice concurrently
        on the same chips."""
        import glob

        for d in glob.glob(os.path.join(self.workdir, f".task-{task_id}-*")):
            try:
                pid = int(open(os.path.join(d, "owner.pid")).read().strip())
                os.kill(pid, 0)
            except ProcessLookupError:
                continue  # truly gone
            except (OSError, ValueError):
                return True  # unreadable/EPERM: err on the live side
            # alive — but pids recycle: only a process actually running
            # this framework counts as a live predecessor (same guard as
            # _kill_surviving_child)
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    if b"mlcomp_tpu" in f.read():
                        return True
            except OSError:
                return True  # no procfs: cannot disprove — err live
        return False

    def _adopt_orphaned_tasks(self) -> None:
        """Requeue tasks still assigned to this worker NAME by a previous
        incarnation (a daemon restarted under the same name — systemd or
        `cli pool` restarts).  The old children died with the old
        process, but the new daemon's heartbeats would mask the death
        from the supervisor's reaper, leaving those tasks IN_PROGRESS
        forever.  Worker names must be unique per live daemon — that is
        the claiming contract; if a task's previous owner process is
        demonstrably still alive (see _predecessor_running), the task is
        left alone rather than double-executed."""
        orphans = self.store.tasks_on_worker(self.name)
        live_predecessor = False
        for t in orphans:
            if self._predecessor_running(t["id"]):
                live_predecessor = True
                self.store.log(
                    t["id"], "warning",
                    f"worker {self.name}: previous incarnation still "
                    f"executing this task; not adopting (duplicate "
                    f"same-name daemons?)",
                )
                continue
            if self.store.requeue_task(t["id"], expect_worker=self.name):
                self.store.log(
                    t["id"], "warning",
                    f"worker {self.name}: requeued task orphaned by a "
                    f"previous incarnation of this worker",
                )
            else:
                self.store.finish_task(
                    t["id"],
                    TaskStatus.FAILED,
                    error=f"worker {self.name!r} restarted mid-task and "
                    f"retries were exhausted",
                    expect_worker=self.name,
                )
        # the old incarnation may also have died holding a gang slot of a
        # still-QUEUED task (mid-gather) — not in tasks_on_worker (slot 0
        # owns the row, and only after start), and the new daemon's fresh
        # heartbeats hide the death from the supervisor's reaper, so
        # nobody else would ever free the slot.  Skipped only when a live
        # predecessor was just detected (its gather must not be robbed).
        if not live_predecessor:
            self.store.release_worker_gang_slots(self.name)

    def _sweep_stale_scratch(self) -> None:
        """Remove ``.task-*`` child scratch dirs orphaned by a worker
        process that died mid-task (normal exits clean up inline), after
        killing any task child that OUTLIVED that worker — children are
        plain subprocesses in their own session, so a SIGKILL'd worker
        leaves them running, holding pinned chips, and racing whatever
        the replacement worker spawns for the requeued task.

        A dir is only swept when its recorded owner pid is gone —
        concurrent workers sharing a workdir must not delete each other's
        live scratch (a pid-less dir is a half-created orphan and also
        goes).  Skipped entirely under MLCOMP_TPU_KEEP_CHILD_SCRATCH so
        kept debug evidence survives restarts."""
        if os.environ.get("MLCOMP_TPU_KEEP_CHILD_SCRATCH"):
            return
        import glob
        import shutil

        for d in glob.glob(os.path.join(self.workdir, ".task-*")):
            try:
                pid = int(
                    open(os.path.join(d, "owner.pid")).read().strip()
                )
            except (OSError, ValueError):
                pid = None  # missing/garbled pid file: age-gate below
            if pid is not None:
                try:
                    os.kill(pid, 0)
                    continue  # live owner: leave it alone
                except ProcessLookupError:
                    pass  # owner gone: sweep
                except OSError:
                    # PermissionError et al.: the pid EXISTS (e.g. another
                    # user's worker sharing this workdir) — treat as live
                    continue
            else:
                try:
                    # pid-less dirs younger than a minute may be mid-creation
                    # by a concurrent worker (mkdtemp -> pid-file window)
                    if time.time() - os.path.getmtime(d) < 60.0:
                        continue
                except OSError:
                    pass
            _kill_surviving_child(d)
            shutil.rmtree(d, ignore_errors=True)

    # ------------------------------------------------------------ heartbeats

    def _host_info(self, extra_tasks: tuple = ()) -> Dict[str, Any]:
        """Host metrics riding the heartbeat — the TPU-VM analog of the
        reference's per-worker GPU utilization panel.  The worker daemon
        itself never initializes JAX (its children own the chips), so
        this reports host-side signals: load, free RAM, running tasks.
        ``extra_tasks``: ids running outside the poll() children pool
        (the blocking run_once path)."""
        info: Dict[str, Any] = {
            "tasks": sorted(
                {int(c["claim"]["id"]) for c in self._children}
                | set(extra_tasks)
            ),
            "pid": os.getpid(),
        }
        try:
            info["load1"] = round(os.getloadavg()[0], 2)
        except OSError:
            pass
        try:
            with open("/proc/meminfo") as f:
                mem = dict(
                    line.split(":", 1) for line in f.read().splitlines() if ":" in line
                )
            info["mem_free_gb"] = round(
                int(mem["MemAvailable"].strip().split()[0]) / 1e6, 2
            )
        except (OSError, KeyError, ValueError):
            pass
        self._publish_metrics(info)
        return info

    def _publish_metrics(self, info: Dict[str, Any]) -> None:
        """Mirror the heartbeat's host signals into the process-default
        metrics registry (mlcomp_tpu/obs): an embedding process renders
        them with ``default_registry().render()``, and the report
        server's /metrics aggregates the same signals fleet-wide from
        the store.  Best-effort — a metrics hiccup must never stall a
        heartbeat (the supervisor's reaper feeds on those)."""
        try:
            from mlcomp_tpu_torch.obs.metrics import default_registry

            m = default_registry()
            lbl = {"worker": self.name}
            m.counter(
                "mlcomp_worker_heartbeats_total",
                "Heartbeats this worker published",
                labelnames=("worker",),
            ).inc(**lbl)
            m.gauge(
                "mlcomp_worker_running_tasks",
                "Tasks currently executing on this worker",
                labelnames=("worker",),
            ).set(len(info.get("tasks", ())), **lbl)
            m.gauge(
                "mlcomp_worker_chips", "Chips this worker advertises",
                labelnames=("worker",),
            ).set(self.chips, **lbl)
            if "load1" in info:
                m.gauge(
                    "mlcomp_worker_load1", "Host 1-minute load average",
                    labelnames=("worker",),
                ).set(info["load1"], **lbl)
            if "mem_free_gb" in info:
                m.gauge(
                    "mlcomp_worker_mem_free_gb", "Host available RAM (GB)",
                    labelnames=("worker",),
                ).set(info["mem_free_gb"], **lbl)
        except Exception:
            pass

    def _heartbeat_pump(
        self, busy_chips: int, stop: threading.Event, task_id: int
    ) -> None:
        """Own-connection heartbeat loop (sqlite connections are per-thread)."""
        hb_store = Store(self._db_path)
        try:
            while not stop.wait(self.heartbeat_interval_s):
                hb_store.heartbeat(
                    self.name, self.chips, busy_chips=busy_chips,
                    info=self._host_info(extra_tasks=(task_id,)),
                )
        finally:
            hb_store.close()

    # --------------------------------------------------------- child plumbing

    def _spawn_child(
        self, claim: Dict[str, Any], gang: Optional[Dict[str, Any]] = None
    ) -> Dict[str, Any]:
        """Start the task's child process (non-blocking); returns a handle."""
        chips = int(claim["chips"])
        ids = sorted(self._free_chip_ids)[:chips]
        self._free_chip_ids -= set(ids)
        try:
            return self._spawn_child_inner(claim, gang, ids)
        except Exception:
            # spawn failures (ENOMEM fork, unwritable workdir) must fail
            # THE TASK, not kill the worker loop (callers catch and route
            # into _finalize) — same contract as the in-process setup guard
            self._free_chip_ids |= set(ids)
            if gang and gang.get("sock") is not None:
                gang["sock"].close()
                gang["sock"] = None
            raise

    def _spawn_child_inner(self, claim, gang, ids) -> Dict[str, Any]:
        chips = int(claim["chips"])
        scratch = tempfile.mkdtemp(
            prefix=f".task-{claim['id']}-", dir=self.workdir
        )
        spec_path = os.path.join(scratch, "spec.json")
        result_path = os.path.join(scratch, "result.json")
        log_path = os.path.join(scratch, "child.log")
        # ownership marker for the startup sweep (see _sweep_stale_scratch)
        with open(os.path.join(scratch, "owner.pid"), "w") as f:
            f.write(str(os.getpid()))
        spec = {
            # ABSOLUTE paths (normalized once in __init__): the child
            # starts with cwd=workdir, so a relative --db (the CLI
            # default) would silently open a fresh empty database there
            # — the task would still run (claim rides in this spec,
            # results ride the file below) but its logs and metrics
            # would land in the wrong store
            "db": self._db_path,
            "claim": claim,
            "workdir": self.workdir,
            "result": result_path,
            "process_id": gang["slot"] if gang else 0,
            "device": self.device,
        }
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        env = dict(os.environ)
        # the child starts a fresh interpreter with cwd=workdir: make this
        # very package importable there regardless of how the parent found it
        import mlcomp_tpu_torch as _pkg

        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(_pkg.__file__)))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (pkg_root, env.get("PYTHONPATH")) if p
        )
        env["MLCOMP_TPU_CHIP_IDS"] = ",".join(map(str, ids))
        if ids and chips < self.chips:
            # pin only when the task takes a strict subset — restricting a
            # full-host task buys nothing and some runtimes (forwarded
            # single-chip tunnels) reject visibility filters
            env["CUDA_VISIBLE_DEVICES"] = ",".join(map(str, ids))
        if gang:
            env["MLCOMP_TPU_COORDINATOR"] = gang["coordinator"]
            env["MLCOMP_TPU_NUM_PROCESSES"] = str(gang["hosts"])
            env["MLCOMP_TPU_PROCESS_ID"] = str(gang["slot"])
        env.update(self.child_env)
        if gang and gang.get("sock") is not None:
            # release the held coordinator port at the last instant — the
            # only remaining steal window is fork→bind inside the child,
            # and the child's preflight turns even that into a clean
            # no-retry-consumed requeue (see _finalize)
            gang["sock"].close()
            gang["sock"] = None
        log_fh = open(log_path, "wb")
        try:
            # own session/process group: (a) killing the child can take
            # its whole subtree (shell executors spawn grandchildren),
            # (b) a replacement worker can reap a child that outlived a
            # SIGKILL'd worker by pgid (see _sweep_stale_scratch)
            proc = subprocess.Popen(
                [sys.executable, "-m", "mlcomp_tpu_torch.scheduler.child", spec_path],
                env=env,
                stdout=log_fh,
                stderr=subprocess.STDOUT,
                cwd=self.workdir,
                start_new_session=True,
            )
        except Exception:
            log_fh.close()
            raise
        with open(os.path.join(scratch, "child.pid"), "w") as f:
            f.write(str(proc.pid))
        self.store.log(
            claim["id"], "info",
            f"worker {self.name}: spawned child pid {proc.pid}"
            + (f" (gang slot {gang['slot']}/{gang['hosts']})" if gang else ""),
        )
        return {
            "proc": proc,
            "claim": claim,
            "chip_ids": ids,
            "result": result_path,
            "log": log_path,
            "log_fh": log_fh,
            "scratch": scratch,
            "gang": gang,
            "last_status_check": 0.0,
        }

    def _collect_child(self, child: Dict[str, Any]):
        """Read the finished child's verdict; free its chips."""
        rc = child["proc"].wait()
        child["log_fh"].close()
        self._free_chip_ids |= set(child["chip_ids"])
        ok, result, err = False, None, None
        try:
            with open(child["result"]) as f:
                payload = json.load(f)
            ok, result, err = payload["ok"], payload["result"], payload["error"]
            if not ok and err is None:
                err = f"executor failed (child exit {rc})"
        except (OSError, ValueError):
            # no/garbled result file: the child died hard (segfault, OOM
            # kill, fault injection) before writing its verdict
            tail = b""
            try:
                with open(child["log"], "rb") as f:
                    tail = f.read()[-2000:]
            except OSError:
                pass
            err = (
                f"task child died (exit code {rc}) before reporting a "
                f"result; log tail:\n{tail.decode(errors='replace')}"
            )
        if not os.environ.get("MLCOMP_TPU_KEEP_CHILD_SCRATCH"):
            import shutil

            shutil.rmtree(child["scratch"], ignore_errors=True)
        return ok, result, err

    def _kill_child(self, child: Dict[str, Any], reason: str) -> None:
        self.store.log(child["claim"]["id"], "warning",
                       f"worker {self.name}: killing child ({reason})")
        import signal

        def signal_group(sig, fallback):
            # the child leads its own process group (start_new_session in
            # _spawn_child_inner): signal the whole group so executor
            # grandchildren (shell commands) die with it
            try:
                os.killpg(child["proc"].pid, sig)
            except OSError:
                fallback()

        signal_group(signal.SIGTERM, child["proc"].terminate)
        try:
            child["proc"].wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            signal_group(signal.SIGKILL, child["proc"].kill)

    def _task_still_mine(self, child: Dict[str, Any]) -> bool:
        """False once the task was stopped or reaped away from this gang/
        worker — the child should be killed, not raced against."""
        row = self.store.task_row(child["claim"]["id"])
        if row is None or row["status"] != TaskStatus.IN_PROGRESS.value:
            return False
        gang = child["gang"]
        owner = row["worker"]
        if gang is None or gang["slot"] == 0:
            return owner == self.name
        # slot>0: the row is owned by slot 0's worker, but a requeue +
        # re-gather can put the task back IN_PROGRESS under a NEW gang —
        # this child is stale unless its slot is still ours
        state = self.store.gang_state(child["claim"]["id"])
        return state["workers"].get(gang["slot"]) == self.name

    def _finalize(self, claim, ok, result, err, gang=None) -> None:
        """Route the outcome into the store (single-host and gang slot 0).

        Non-zero gang slots own nothing: their failures reach the log via
        the child, and the task row is settled by slot 0 (or the reaper
        if slot 0's worker died)."""
        if gang is not None and gang["slot"] != 0:
            return
        inject("worker.before_finish")  # executor done, result not yet stored
        # expect_worker guards against a reaped-and-requeued task being
        # clobbered by this (stale) worker finishing late.
        if ok:
            self.store.finish_task(
                claim["id"],
                TaskStatus.SUCCESS,
                result=result,
                expect_worker=self.name,
            )
        else:
            self.store.log(claim["id"], "error", err or "unknown error")
            infra = None
            if err and "CoordinatorBindError" in err:
                infra = "coordinator port stolen"
            elif err and "TaskPreempted" in err:
                infra = "task preempted (spot reclaim/drain)"
            if infra and self.store.infra_requeue_count(claim["id"]) < 3:
                # infrastructure failures, not the task's fault — requeue
                # WITHOUT consuming a retry: a stolen coordinator port
                # (the preflight's deliberate marker; a fresh gather holds
                # a fresh port) or a preemption notice (the train loop
                # checkpointed; the requeued attempt resumes).  Capped at
                # 3 per task (counted durably in the store) so a workload
                # that merely prints a marker cannot bypass max_retries
                # forever; preemption #4+ spends the normal budget.
                if self.store.requeue_task(
                    claim["id"], expect_worker=self.name, consume_retry=False
                ):
                    self.store.log(
                        claim["id"], "warning",
                        f"worker {self.name}: {infra}; requeued without "
                        f"consuming a retry",
                    )
                    # in-process attempts share this process's preemption
                    # flag: clear it so the requeued attempt doesn't
                    # instantly re-preempt off the stale signal (isolated
                    # children get a fresh process and don't need this)
                    from mlcomp_tpu_torch.utils.preempt import clear

                    clear()
                    return
            # expect_worker: if the task was stopped or reaped+re-claimed
            # while we ran, neither requeue nor fail must touch it
            if not self.store.requeue_task(claim["id"], expect_worker=self.name):
                self.store.finish_task(
                    claim["id"],
                    TaskStatus.FAILED,
                    error=err,
                    expect_worker=self.name,
                )

    def _wait_child(self, child: Dict[str, Any]):
        """Blocking wait with a stop-watch: a task stopped from the CLI or
        dashboard kills the child instead of letting it run to a discarded
        finish."""
        while child["proc"].poll() is None:
            time.sleep(0.25)
            now = time.time()
            if now - child["last_status_check"] >= 2.0:
                child["last_status_check"] = now
                if not self._task_still_mine(child):
                    self._kill_child(child, "task stopped or reassigned")
        return self._collect_child(child)

    # ------------------------------------------------------------- in-process

    def _run_inline(self, claim: Dict[str, Any]):
        # pre-execution setup failures (bad args JSON, code sync/import
        # errors) must fail THE TASK, not kill the worker loop
        try:
            args = json.loads(claim["args"])
            sync_code(args, claim["id"], self.workdir, self.store)
        except Exception:
            import traceback

            return False, None, traceback.format_exc()
        ctx = ExecutionContext(
            dag_id=claim["dag_id"],
            task_id=claim["id"],
            task_name=claim["name"],
            args=args,
            store=self.store,
            workdir=self.workdir,
            chips=claim["chips"],
            stage=claim["stage"],
            worker=self.name,
            device=self.device,
        )
        return run_task(claim["executor"], ctx)

    # ------------------------------------------------------------- gang claims

    def _gather_gang(self) -> Optional[Dict[str, Any]]:
        """Claim a slot of a multi-host task and wait for the gang to fill.

        Returns {"claim": task_row, "gang": {...}} ready to spawn, or None
        (nothing to gang / gather timed out / task went away — the slot is
        released in those cases)."""
        slot_claim = self.store.claim_gang_slot(self.name, free_chips=self.chips)
        if slot_claim is None:
            return None
        task, slot, hosts = (
            slot_claim["task"], slot_claim["slot"], slot_claim["hosts"]
        )
        tid = task["id"]
        sock = None
        if slot == 0:
            # bind and HOLD the coordinator port through the whole gather:
            # a port picked by bind-then-close can be stolen while the
            # gang fills.  The held socket rides the gang dict and is
            # released microseconds before the child binds it
            # (_spawn_child_inner); if even that window is lost, the
            # child fails fast (CoordinatorBindError preflight,
            # parallel/distributed.py) and _finalize requeues without
            # consuming a retry.  The port comes from OUTSIDE the
            # ephemeral range: a peer's retrying connect could otherwise
            # self-connect to an ephemeral coordinator port and hang
            # (see _bind_coordinator_socket).
            sock = _bind_coordinator_socket()
            self.store.publish_coordinator(
                tid, f"{host_address()}:{sock.getsockname()[1]}"
            )

        handed_off = []

        def ready(state, row):
            gang = {
                "slot": slot,
                "hosts": hosts,
                "coordinator": state["coordinator"],
                "sock": sock,
            }
            handed_off.append(True)
            return {"claim": row, "gang": gang}

        try:
            t_start = time.time()
            deadline = t_start + self.gang_wait_s
            while time.time() < deadline:
                row = self.store.task_row(tid)
                if row is None or row["status"] not in (
                    TaskStatus.QUEUED.value, TaskStatus.IN_PROGRESS.value
                ):
                    break  # stopped / reaped away mid-gather
                state = self.store.gang_state(tid)
                if state["workers"].get(slot) != self.name:
                    return None  # slot reaped from under us; nothing to release
                if state["filled"] and state["coordinator"]:
                    if slot == 0:
                        if row["status"] == TaskStatus.QUEUED.value and (
                            not self.store.start_gang_task(tid, self.name)
                        ):
                            break  # lost to a stop; release below
                    elif row["status"] != TaskStatus.IN_PROGRESS.value:
                        # wait for slot 0 to flip the task
                        self.store.heartbeat(self.name, self.chips)
                        time.sleep(0.2)
                        continue
                    return ready(state, self.store.task_row(tid))
                if (
                    time.time() - t_start > 10.0
                    and self.store.has_claimable_task(self.chips)
                ):
                    # the gang had a fair gather window and still isn't full
                    # while runnable single-host work waits — don't starve it
                    # behind a gang that may never fill; bail and come back
                    break
                self.store.heartbeat(self.name, self.chips)
                time.sleep(0.2)
            # deadline/bail: the gang may have completed in the race window
            # — a slot holder walking away from a live gang would strand
            # the other children in collectives against a process that
            # never comes.  The release is therefore CONDITIONAL (one store
            # tx, release_gang_slot_if_dormant): a refused release means
            # the gang went live between our last read and the release —
            # join it.
            patience = time.time() + max(10.0, self.gang_wait_s)
            while True:
                row = self.store.task_row(tid)
                state = self.store.gang_state(tid)
                if state["workers"].get(slot) != self.name:
                    return None  # reaped from under us; nothing to release
                live = (
                    row is not None and state["filled"] and state["coordinator"]
                )
                if live and row["status"] == TaskStatus.IN_PROGRESS.value:
                    return ready(state, self.store.task_row(tid))
                if (
                    live
                    and slot == 0
                    and row["status"] == TaskStatus.QUEUED.value
                    and self.store.start_gang_task(tid, self.name)
                ):
                    return ready(state, self.store.task_row(tid))
                if self.store.release_gang_slot_if_dormant(
                    tid, slot, self.name
                ):
                    return None
                if time.time() > patience:
                    # unreachable in normal operation (a live gang either
                    # starts or gets reaped); force the release rather than
                    # hang the worker on a wedged gang
                    self.store.log(
                        tid, "warning",
                        f"worker {self.name}: force-releasing gang slot "
                        f"{slot} after {self.gang_wait_s:.0f}s live-gang wait",
                    )
                    self.store.release_gang_slot(tid, slot, self.name)
                    return None
                self.store.heartbeat(self.name, self.chips)
                time.sleep(0.2)
        finally:
            if sock is not None and not handed_off:
                sock.close()

    # ------------------------------------------------------------- main loops

    def run_once(self) -> bool:
        """Claim and execute at most one task (blocking). True if one ran."""
        self.store.heartbeat(self.name, self.chips)
        claim = self.store.claim_task(self.name, free_chips=self.chips)
        gang = None
        if claim is None and self.isolate:
            gathered = self._gather_gang()
            if gathered is None:
                return False
            claim, gang = gathered["claim"], gathered["gang"]
        if claim is None:
            return False
        inject("worker.after_claim")  # no-op unless a recovery test armed it
        self.store.heartbeat(self.name, self.chips, busy_chips=claim["chips"])
        stop = threading.Event()
        pump = threading.Thread(
            target=self._heartbeat_pump,
            args=(claim["chips"], stop, claim["id"]),
            daemon=True,
        )
        pump.start()
        try:
            if self.isolate:
                try:
                    child = self._spawn_child(claim, gang=gang)
                except Exception:
                    import traceback

                    ok, result, err = False, None, traceback.format_exc()
                else:
                    ok, result, err = self._wait_child(child)
            else:
                ok, result, err = self._run_inline(claim)
        finally:
            stop.set()
            pump.join(timeout=self.heartbeat_interval_s + 1.0)
        self._finalize(claim, ok, result, err, gang=gang)
        self.store.heartbeat(self.name, self.chips, busy_chips=0)
        return True

    def _try_spawn(self, claim, gang) -> bool:
        """Spawn into the children pool; a spawn failure fails the task."""
        try:
            self._children.append(self._spawn_child(claim, gang=gang))
            return True
        except Exception:
            import traceback

            self._finalize(claim, False, None, traceback.format_exc(),
                           gang=gang)
            return False

    def poll(self, claim_new: bool = True) -> bool:
        """One non-blocking scheduling step (isolated mode): reap finished
        children, kill stopped ones, then claim/spawn up to capacity.
        ``claim_new=False`` drains: running children are still tended but
        no new work is taken.  Returns True if anything progressed."""
        progressed = False
        for child in list(self._children):
            if child["proc"].poll() is not None:
                self._children.remove(child)
                ok, result, err = self._collect_child(child)
                self._finalize(
                    child["claim"], ok, result, err, gang=child["gang"]
                )
                progressed = True
                continue
            now = time.time()
            if now - child["last_status_check"] >= 2.0:
                child["last_status_check"] = now
                if not self._task_still_mine(child):
                    self._kill_child(child, "task stopped or reassigned")
        busy = sum(int(c["claim"]["chips"]) for c in self._children)
        while claim_new and len(self._children) < self.max_tasks:
            claim = self.store.claim_task(
                self.name, free_chips=self.chips - busy
            )
            if claim is None:
                break
            progressed = True
            if self._try_spawn(claim, None):
                busy += int(claim["chips"])
        if claim_new and not self._children:
            # idle: offer this worker to a multi-host gang (the gather wait
            # blocks this loop for at most gang_wait_s)
            gathered = self._gather_gang()
            if gathered is not None:
                progressed = True
                if self._try_spawn(gathered["claim"], gathered["gang"]):
                    busy = int(gathered["claim"]["chips"])
        self.store.heartbeat(
            self.name, self.chips, busy_chips=busy, info=self._host_info()
        )
        return progressed

    def run_forever(self, poll_interval: float = 0.5, stop_event=None) -> None:
        """Main daemon loop.  ``stop_event`` (a threading.Event, set by the
        CLI's SIGTERM handler) drains gracefully: finish running tasks,
        claim nothing new, then return."""

        def stopping() -> bool:
            return stop_event is not None and stop_event.is_set()

        if not self.isolate:
            while not stopping():
                if not self.run_once() and not stopping():
                    time.sleep(poll_interval)
            return
        while True:
            if stopping() and not self._children:
                return
            if not self.poll(claim_new=not stopping()):
                time.sleep(poll_interval)
