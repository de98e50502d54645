"""Worker pool provisioner: launch, watch, restart worker daemons per host (the port's copy of
mlcomp_tpu/scheduler/pool.py).

The reference ran one Docker worker per GPU, provisioned implicitly by its
deploy layer; the north star asks this scheduler to "provision and pin
TPU-VM slices" (BASELINE.json:5).  Chip *pinning* lives in the worker
(env-pinned child visibility, gang slots); this module is the
*provisioning* half: a host inventory plus a launch template become one
worker daemon per host, heartbeat-watched through the store, restarted
with exponential backoff when the process dies or its heartbeats go
stale, and drained gracefully on stop (SIGTERM → workers finish their
running tasks, stop claiming, exit).

Inventory format (file via ``cli pool --inventory``, or inline
``--hosts h1,h2``): one host per line, optional ``key=value`` attrs::

    localhost  chips=4
    tpu-vm-0   chips=4  workdir=/mnt/disks/work
    # comments and blank lines ignored

Launch templates render with ``{host} {python} {db} {name} {chips}
{workdir}``.  The default local template execs the worker directly; the
default remote template prefixes ``ssh -o BatchMode=yes {host}``.  The
store is a single sqlite file, so remote hosts must see it at the same
path (shared filesystem — the TPU-VM-pod analog of the reference's
central Postgres); same for ``workdir`` when tasks sync code.
"""

from __future__ import annotations

import json
import os
import shlex
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from mlcomp_tpu_torch.db.store import Store

LOCAL_HOSTS = ("localhost", "127.0.0.1", "local")

LOCAL_TEMPLATE = (
    "{python} -m mlcomp_tpu_torch.cli worker --db {db} --name {name}"
    " --chips {chips} --workdir {workdir}"
)
REMOTE_TEMPLATE = "ssh -o BatchMode=yes {host} " + LOCAL_TEMPLATE

# For REMOTE hosts the local process handle is the ssh TRANSPORT, not
# the worker: terminating it orphans the remote daemon, which keeps
# claiming under the same name while its replacement starts (two live
# same-name claimers violate the store's naming contract).  The kill
# template runs after the transport dies and must reach the daemon
# itself.  {signal} is KILL on the wedge path, TERM on drain.
#
# Pattern details that matter:
# - ``( |$)`` anchors the name: pool names are unique, but one may be a
#   PREFIX of another (host-1 vs host-11) and an unanchored match would
#   SIGKILL the wrong, healthy daemon;
# - ``--name[ =]`` (a regex class: space or '=', the two separators
#   argparse accepts, so custom launch templates using ``--name={name}``
#   stay killable) keeps the pattern from matching the remote shell /
#   pkill's OWN command line, which contains the pattern text with a
#   literal '[' — without this, pkill signals its parent shell every
#   run and ssh reports a spurious failure;
# - the inner '...' quotes survive the local shlex.split (outer "...")
#   and reach the remote shell intact, so ( | $ ) are never shell-parsed.
REMOTE_KILL_TEMPLATE = (
    'ssh -o BatchMode=yes {host} pkill "-{signal}" -f --'
    ' "\'worker.*--name[ =]{name}( |$)\'"'
)


@dataclass
class HostSpec:
    host: str
    chips: int = 0
    workdir: Optional[str] = None
    attrs: Dict[str, str] = field(default_factory=dict)


def parse_inventory(text: str, default_chips: int = 0) -> List[HostSpec]:
    """Parse the inventory format above; raises ValueError on bad attrs."""
    hosts: List[HostSpec] = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        spec = HostSpec(host=parts[0], chips=default_chips)
        for attr in parts[1:]:
            if "=" not in attr:
                raise ValueError(
                    f"inventory line {lineno}: expected key=value, got {attr!r}"
                )
            k, v = attr.split("=", 1)
            if k == "chips":
                spec.chips = int(v)
            elif k == "workdir":
                spec.workdir = v
            else:
                spec.attrs[k] = v
        hosts.append(spec)
    return hosts


class WorkerPool:
    """Launches and babysits one worker daemon per inventory host.

    Liveness has two layers: the local process handle (a dead/exited
    daemon restarts immediately) and the store heartbeat (a *wedged*
    daemon — process alive, heartbeats stale — is killed and relaunched;
    the supervisor's reaper independently requeues whatever tasks it
    held).  Restarts back off exponentially per host (base
    ``restart_backoff_s``, doubling to 60 s) and the counter resets after
    a healthy stretch, so one flaky host cannot hot-loop the pool while
    a recovered one is not punished forever.
    """

    def __init__(
        self,
        store: Store,
        hosts: List[HostSpec],
        db_path: Optional[str] = None,
        base_workdir: str = "pool",
        launch_template: Optional[str] = None,
        python: str = sys.executable,
        heartbeat_timeout_s: float = 30.0,
        restart_backoff_s: float = 5.0,
        env: Optional[Dict[str, str]] = None,
        kill_template: Optional[str] = None,
    ):
        if not hosts:
            raise ValueError("pool needs at least one inventory host")
        self.store = store
        # absolute paths before any template renders: a relative --db
        # sent over ssh resolves against the REMOTE home dir, where
        # sqlite silently creates a fresh empty database and the worker
        # idles forever.  (Remote hosts must see these absolute paths on
        # a shared mount — the provisioning contract in the module doc.)
        self.db_path = os.path.abspath(db_path or store.path)
        self.base_workdir = os.path.abspath(base_workdir)
        self.launch_template = launch_template
        self.kill_template = kill_template
        self.python = python
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.restart_backoff_s = restart_backoff_s
        self.env = dict(env or {})
        self._members: List[Dict[str, Any]] = []
        for i, h in enumerate(hosts):
            # index-prefixed names keep duplicate hosts (localhost dev
            # pools) distinct while staying deterministic across pool
            # restarts, so heartbeat rows map 1:1 to inventory entries
            name = f"pool-{i}-{h.host}"
            self._members.append({
                "spec": h,
                "name": name,
                "proc": None,
                "log": None,
                "started": 0.0,
                "restarts": 0,
                "next_start": 0.0,
            })

    # ------------------------------------------------------------ launching

    def _template_vars(self, m: Dict[str, Any]) -> Dict[str, Any]:
        h: HostSpec = m["spec"]
        workdir = h.workdir or os.path.join(self.base_workdir, m["name"])
        return {
            "host": shlex.quote(h.host),
            "python": shlex.quote(self.python),
            "db": shlex.quote(self.db_path),
            "name": shlex.quote(m["name"]),
            "chips": h.chips,
            "workdir": shlex.quote(workdir),
        }

    def _render(self, m: Dict[str, Any]) -> List[str]:
        h: HostSpec = m["spec"]
        template = self.launch_template or (
            LOCAL_TEMPLATE if h.host in LOCAL_HOSTS else REMOTE_TEMPLATE
        )
        return shlex.split(template.format(**self._template_vars(m)))

    def _launch(self, m: Dict[str, Any]) -> None:
        os.makedirs(self.base_workdir, exist_ok=True)
        h: HostSpec = m["spec"]
        if h.host in LOCAL_HOSTS:
            workdir = h.workdir or os.path.join(self.base_workdir, m["name"])
            os.makedirs(workdir, exist_ok=True)
        log_path = os.path.join(self.base_workdir, f"{m['name']}.log")
        m["log"] = open(log_path, "ab")
        env = dict(os.environ)
        env.update(self.env)
        m["proc"] = subprocess.Popen(
            self._render(m), stdout=m["log"], stderr=subprocess.STDOUT,
            env=env,
        )
        m["started"] = time.time()
        print(json.dumps({
            "event": "pool_launch", "worker": m["name"],
            "host": h.host, "pid": m["proc"].pid,
            "restarts": m["restarts"],
        }), flush=True)

    def _kill(self, m: Dict[str, Any], grace_s: float = 5.0) -> None:
        proc = m["proc"]
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=grace_s)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        # the local handle may have been only the transport: reach the
        # actual daemon before any same-name replacement launches
        self._remote_kill(m, signal_name="KILL")

    def _remote_kill(self, m: Dict[str, Any], signal_name: str) -> None:
        """Run the kill template against the member's host (no-op for
        local hosts without an explicit template — their daemon IS the
        local process)."""
        h: HostSpec = m["spec"]
        template = self.kill_template or (
            None if h.host in LOCAL_HOSTS else REMOTE_KILL_TEMPLATE
        )
        if template is None:
            return
        cmd = shlex.split(template.format(
            signal=signal_name, **self._template_vars(m)
        ))
        try:
            res = subprocess.run(
                cmd, timeout=20.0, capture_output=True,
            )
            # pkill exits 1 for "no process matched" — normal when the
            # daemon already died with its transport
            if res.returncode not in (0, 1):
                print(json.dumps({
                    "event": "pool_remote_kill_failed", "worker": m["name"],
                    "rc": res.returncode,
                    "stderr": res.stderr.decode(errors="replace")[-500:],
                }), flush=True)
        except (subprocess.TimeoutExpired, OSError) as e:
            print(json.dumps({
                "event": "pool_remote_kill_failed", "worker": m["name"],
                "error": repr(e),
            }), flush=True)

    # ------------------------------------------------------------- watching

    def _heartbeat_ages(self) -> Dict[str, float]:
        now = time.time()
        return {
            w["name"]: now - (w["heartbeat"] or 0.0)
            for w in self.store.workers()
        }

    def poll_once(self) -> int:
        """One watch pass; returns how many daemons were (re)started."""
        started = 0
        ages = self._heartbeat_ages()
        now = time.time()
        for m in self._members:
            proc = m["proc"]
            if proc is not None and proc.poll() is None:
                # process alive: check for a wedge (stale heartbeats well
                # past the daemon's startup window — jax imports in task
                # children are slow, the daemon itself beats fast)
                age = ages.get(m["name"])
                uptime = now - m["started"]
                if (
                    uptime > self.heartbeat_timeout_s * 2
                    and (age is None or age > self.heartbeat_timeout_s)
                ):
                    print(json.dumps({
                        "event": "pool_wedged", "worker": m["name"],
                        "heartbeat_age_s": None if age is None else round(age, 1),
                    }), flush=True)
                    self._kill(m)
                else:
                    if uptime > self.heartbeat_timeout_s * 4:
                        m["restarts"] = 0  # healthy stretch: forgive history
                    continue
            if now < m["next_start"]:
                continue  # backing off
            if m["log"] is not None:
                m["log"].close()
            m["restarts"] += 1 if m["proc"] is not None else 0
            backoff = min(
                self.restart_backoff_s * (2 ** max(0, m["restarts"] - 1)),
                60.0,
            )
            m["next_start"] = now + backoff
            self._launch(m)
            started += 1
        return started

    def run_forever(self, poll_interval: float = 2.0) -> None:
        import signal
        import threading

        stop = threading.Event()
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *a: stop.set())
        while not stop.is_set():
            self.poll_once()
            stop.wait(poll_interval)
        self.drain()

    # ------------------------------------------------------------- draining

    def drain(self, timeout_s: float = 30.0) -> None:
        """Graceful stop: SIGTERM every daemon (workers finish their
        running tasks, stop claiming, exit — cli worker's handler), wait,
        then SIGKILL stragglers."""
        for m in self._members:
            if m["proc"] is not None and m["proc"].poll() is None:
                m["proc"].terminate()
            # ssh does not forward SIGTERM to the remote command: ask the
            # remote daemon to drain too (pkill's default TERM → the
            # worker's graceful handler)
            self._remote_kill(m, signal_name="TERM")
        deadline = time.time() + timeout_s
        for m in self._members:
            proc = m["proc"]
            if proc is None:
                continue
            try:
                proc.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            if m["log"] is not None:
                m["log"].close()
                m["log"] = None
        print(json.dumps({"event": "pool_drained"}), flush=True)

    def alive_count(self) -> int:
        return sum(
            1 for m in self._members
            if m["proc"] is not None and m["proc"].poll() is None
        )
