"""Multi-process runtime: process-group init, hybrid meshes, the boundary
channel, per-rank batches.

The counterpart of mlcomp_tpu/parallel/distributed.py.  A gang task
(``resources.hosts > 1``) runs one process per gang slot; the worker sets
``MLCOMP_TPU_COORDINATOR`` / ``_NUM_PROCESSES`` / ``_PROCESS_ID`` and
:func:`init_distributed` joins the process to a ``torch.distributed``
group whose store listens at the coordinator's address.  The backend is
NCCL for a process on a card and gloo for one on the CPU;
``MLCOMP_TPU_DIST_BACKEND=gloo`` puts processes that share one card on
gloo (NCCL refuses two ranks on one device), and the collectives of
``parallel/collectives.py`` then stage the card's tensors through host
memory where gloo takes only host tensors.  One rank is one process on
its first visible device.

Hybrid topology rule, as in the JAX package: only gradient-sync axes
(dp, fsdp, pp) may span slices (hosts); tp/sp/ep stay inside one.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from mlcomp_tpu_torch.parallel.mesh import AXES, MeshSpec, batch_rows

# Axes allowed to cross a slice boundary; tp/sp/ep collectives run every
# layer, so placing them across slices is refused loudly rather than slowly.
DCN_OK_AXES = ("dp", "fsdp", "pp")


class CoordinatorBindError(RuntimeError):
    """The coordinator process cannot bind its published rendezvous port
    (stolen between the gang gather and child start).  The worker treats
    this marker as an infrastructure failure: the task is requeued
    WITHOUT consuming a retry and the next gather publishes a fresh
    port (scheduler/worker.py ``_finalize``)."""


def _preflight_coordinator_bind(coordinator_address: str) -> None:
    """Fail fast (and cleanly) when the coordinator port is taken, before
    the process group's store tries to listen there.  A bind probe with
    SO_REUSEADDR passes on our own just-released held socket
    (scheduler/worker.py holds the port through the gather) but catches a
    live thief."""
    import socket

    port = int(coordinator_address.rsplit(":", 1)[1])
    probe = socket.socket()
    try:
        probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        probe.bind(("", port))
    except OSError as e:
        raise CoordinatorBindError(
            f"coordinator port {coordinator_address} is already taken: {e}"
        ) from e
    finally:
        probe.close()


def dist_backend(device=None) -> str:
    """``MLCOMP_TPU_DIST_BACKEND`` when set, else NCCL for a card and gloo
    for the CPU (``device`` None means the card)."""
    forced = os.environ.get("MLCOMP_TPU_DIST_BACKEND", "").strip().lower()
    if forced:
        return forced
    import torch

    return "gloo" if torch.device(device or "cuda").type == "cpu" else "nccl"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device=None,
                     timeout_s: float = 600.0) -> bool:
    """Join this process to the gang's ``torch.distributed`` group.

    Arguments fall back to ``MLCOMP_TPU_COORDINATOR`` / ``_NUM_PROCESSES``
    / ``_PROCESS_ID`` (the worker daemon sets these when a task spans
    hosts).  Returns True if multi-process mode was initialized, False for
    the single-process fallback (no gang environment), as in the JAX
    package.  ``device`` picks the backend (:func:`dist_backend`); a CUDA
    rank binds its first visible card."""
    import datetime

    import torch
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get("MLCOMP_TPU_COORDINATOR")
    env_np = os.environ.get("MLCOMP_TPU_NUM_PROCESSES")
    env_pid = os.environ.get("MLCOMP_TPU_PROCESS_ID")
    num_processes = num_processes if num_processes is not None else (
        int(env_np) if env_np else None)
    process_id = process_id if process_id is not None else (int(env_pid) if env_pid else None)
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "init_distributed needs the coordinator address, the process count and "
            "this process's id (MLCOMP_TPU_COORDINATOR/_NUM_PROCESSES/_PROCESS_ID)")
    if dist.is_initialized():
        return True
    if process_id == 0:
        # only the process that will host the store probes its port
        _preflight_coordinator_bind(coordinator_address)
    backend = dist_backend(device)
    kw = {}
    if torch.device(device or "cuda").type == "cuda":
        torch.cuda.set_device(0)
        if backend == "nccl":
            kw["device_id"] = torch.device("cuda", 0)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
        rank=int(process_id), timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return True


def make_hybrid_mesh(spec: Optional[MeshSpec] = None,
                     dcn_spec: Optional[Dict[str, int]] = None,
                     ranks_per_slice: Optional[int] = None, device_type: Optional[str] = None):
    """A DeviceMesh whose slice-crossing axes are exactly ``dcn_spec``.

    ``spec`` gives the TOTAL size of every logical axis (as in
    ``mesh.make_mesh``); ``dcn_spec`` names which of those axes span
    slices and by how much.  Only dp/fsdp/pp may appear in it.  A slice is
    ``ranks_per_slice`` consecutive ranks (default
    ``MLCOMP_TPU_RANKS_PER_SLICE``, else 1: one process a host, as a gang
    runs).  With one slice this is the plain mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from mlcomp_tpu_torch.parallel.mesh import make_mesh

    spec = spec or MeshSpec()
    dcn_spec = {a: int(s) for a, s in (dcn_spec or {}).items() if int(s) != 1}
    bad = set(dcn_spec) - set(DCN_OK_AXES)
    if bad:
        raise ValueError(
            f"axes {sorted(bad)} may not cross DCN (per-layer collectives); "
            f"only {DCN_OK_AXES} can span slices"
        )
    world = dist.get_world_size() if dist.is_initialized() else 1
    sizes = spec.resolve(world)
    per = int(ranks_per_slice or os.environ.get("MLCOMP_TPU_RANKS_PER_SLICE", 1))
    if world % per:
        raise ValueError(f"{world} ranks not divisible into slices of {per}")
    n_slices = world // per
    dcn_total = int(np.prod(list(dcn_spec.values()))) if dcn_spec else 1
    if dcn_total == 1:
        if n_slices > 1:
            raise ValueError(
                f"ranks span {n_slices} slices but dcn_spec names no "
                f"DCN-crossing axis; a plain mesh would lay per-layer "
                f"collectives across slices — pass e.g. dcn_spec={{'dp': "
                f"{n_slices}}}"
            )
        return make_mesh(spec, device_type=device_type)
    if dcn_total != n_slices:
        raise ValueError(
            f"dcn_spec {dcn_spec} implies {dcn_total} slices but ranks span {n_slices}")
    for a, s in dcn_spec.items():
        if sizes[a] % s:
            raise ValueError(f"axis {a}={sizes[a]} not divisible by dcn {s}")
    ici = [sizes[a] // dcn_spec.get(a, 1) for a in AXES]
    dcn = [dcn_spec.get(a, 1) for a in AXES]
    # ranks slice-major; each axis laid out dcn-major (its dcn factor outer)
    arr = np.arange(world).reshape(*dcn, *ici)
    n = len(AXES)
    arr = arr.transpose([j for i in range(n) for j in (i, n + i)])
    arr = arr.reshape([sizes[a] for a in AXES])
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, arr.tolist(), mesh_dim_names=AXES)


class ChannelClosed(RuntimeError):
    """The boundary channel's peer went away (coordinator shut down,
    or ``close()`` was called locally) — the follower loop treats it
    as the stop record."""


class BoundaryChannel:
    """Coordinator -> followers broadcast of per-boundary serve
    decisions (``serve --distributed``): length-prefixed JSON records
    over plain TCP.

    The channel carries HOST decisions with NO device collectives: the
    engine's loop thread broadcasts while other threads (HTTP handlers,
    the metrics sampler) run, and a collective-based broadcast would
    interleave device work nondeterministically across the gang.  TCP
    ordering gives the followers the coordinator's record sequence
    verbatim; socket backpressure bounds how far ahead the coordinator
    can run.

    Wire format: 4-byte big-endian length + UTF-8 JSON per record.
    The port defaults to ``MLCOMP_TPU_SYNC_PORT``, else the coordinator
    port + 1 (same host).  With one process the channel is inert (send is
    a no-op) so the same serve path runs single-host unchanged.
    """

    def __init__(
        self,
        num_processes: Optional[int] = None,
        process_id: Optional[int] = None,
        address: Optional[str] = None,
        port: Optional[int] = None,
        timeout_s: float = 120.0,
    ):
        import socket
        import struct
        import threading

        self._struct = struct
        self.num_processes = int(
            num_processes if num_processes is not None else process_count()
        )
        self.process_id = int(process_id if process_id is not None else process_index())
        self.is_coordinator = self.process_id == 0
        self._lock = threading.Lock()
        self._closed = False
        self._conns: list = []
        self._sock = None
        if self.num_processes <= 1:
            return
        coord = address or os.environ.get("MLCOMP_TPU_COORDINATOR", "")
        if coord:
            host = coord.rsplit(":", 1)[0] if ":" in coord else coord
        elif self.is_coordinator:
            host = ""  # the coordinator binds all interfaces, no dial
        else:
            raise ValueError(
                "BoundaryChannel follower needs the coordinator host: "
                "pass address= or set MLCOMP_TPU_COORDINATOR"
            )
        if port is None:
            env_port = os.environ.get("MLCOMP_TPU_SYNC_PORT")
            if env_port:
                port = int(env_port)
            elif ":" in coord:
                port = int(coord.rsplit(":", 1)[1]) + 1
            else:
                raise ValueError(
                    "BoundaryChannel needs a port: pass port=, set "
                    "MLCOMP_TPU_SYNC_PORT, or set MLCOMP_TPU_COORDINATOR "
                    "(its port + 1 is the default)"
                )
        if self.is_coordinator:
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind(("", int(port)))
            srv.listen(self.num_processes)
            srv.settimeout(timeout_s)
            try:
                for _ in range(self.num_processes - 1):
                    conn, _addr = srv.accept()
                    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    # a follower that stops reading (wedged loop) must
                    # not block the coordinator's sendall forever: a
                    # timed-out send drops the follower like a dead one
                    conn.settimeout(timeout_s)
                    self._conns.append(conn)
            finally:
                srv.close()
        else:
            import time as _time

            deadline = _time.monotonic() + timeout_s
            last_err: Optional[Exception] = None
            while _time.monotonic() < deadline:
                try:
                    s = socket.create_connection((host, int(port)), timeout=5.0)
                    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    s.settimeout(None)
                    self._sock = s
                    break
                except OSError as e:  # coordinator not listening yet
                    last_err = e
                    _time.sleep(0.2)
            if self._sock is None:
                raise ChannelClosed(
                    f"could not reach the boundary channel at "
                    f"{host}:{port} within {timeout_s}s: {last_err!r}"
                )

    def send(self, obj) -> None:
        """Broadcast one record (coordinator only; no-op single
        process).  A follower whose socket died is dropped."""
        assert self.is_coordinator, "only the coordinator sends"
        if not self._conns:
            return
        body = json.dumps(obj).encode()
        frame = self._struct.pack(">I", len(body)) + body
        with self._lock:
            dead = []
            for conn in self._conns:
                try:
                    conn.sendall(frame)
                except OSError:
                    dead.append(conn)
            for conn in dead:
                self._conns.remove(conn)
                try:
                    conn.close()
                except OSError:
                    pass

    def _recv_exact(self, n: int) -> bytes:
        # snapshot the socket once: a concurrent close() nulls self._sock
        # under the lock, and re-reading it mid-loop would surface that
        # clean shutdown as an AttributeError instead of ChannelClosed
        sock = self._sock
        if sock is None:
            raise ChannelClosed("boundary channel is closed")
        buf = b""
        while len(buf) < n:
            try:
                chunk = sock.recv(n - len(buf))
            except OSError as e:
                raise ChannelClosed(f"boundary channel lost: {e}")
            if not chunk:
                raise ChannelClosed("boundary channel closed by peer")
            buf += chunk
        return buf

    def recv(self):
        """Block for the next record (followers only).  Raises
        :class:`ChannelClosed` when the coordinator goes away or
        ``close()`` is called from another thread."""
        assert not self.is_coordinator, "the coordinator never recvs"
        if self._closed or self._sock is None:
            raise ChannelClosed("boundary channel is closed")
        (n,) = self._struct.unpack(">I", self._recv_exact(4))
        return json.loads(self._recv_exact(n).decode())

    def close(self) -> None:
        """Idempotent teardown; unblocks a follower's in-flight ``recv``
        with :class:`ChannelClosed`."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            socks = list(self._conns)
            self._conns = []
            if self._sock is not None:
                socks.append(self._sock)
                self._sock = None
        import socket as _socket

        for s in socks:
            try:
                s.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    return process_index() == 0


def global_batch_from_host(batch, mesh, device=None):
    """This rank's rows of a global host batch (every process assembles
    the same global batch from the seed-deterministic loader and keeps the
    rows its (dp, fsdp) coordinate owns), as tensors on ``device``."""
    import torch

    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
        t = t[batch_rows(mesh, t.shape[0])]
        out[k] = t.to(device) if device is not None else t
    return out


def sync_hosts(tag: str = "") -> None:
    """Barrier across all processes (no-op single-process)."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
