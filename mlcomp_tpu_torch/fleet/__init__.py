"""Fleet control plane: scheduler-managed serve replicas, a
prefix-affinity router, and SLO-driven autoscaling (the port's copy of
mlcomp_tpu/fleet/__init__.py).

PR 10 built the fleet's sight line (``/fleet/trace``, ``/fleet/metrics``,
SLO burn rates) before the fleet existed; this package is the fleet —
the Podracer split (decoupled control plane + homogeneous workers)
applied to inference serving:

- ``manager``  — :class:`ReplicaManager` reconciles a ``ReplicaSpec``
  (target count, port range, restart budget) against live serve
  daemons: spawn to target, poll ``/healthz``, restart replicas whose
  watchdog verdict goes 503/silent (bounded, progress-gated budget),
  drain before scale-down, and publish every replica's URL into the
  JSON registry the report server and router read.
- ``router``   — an HTTP front door load-balancing ``POST /generate``
  across live replicas with prefix-affinity routing (the shared
  ``cache/prefix_key.py`` key over rendezvous hashing), least-loaded
  fallback, SSE passthrough, ``traceparent`` propagation, and 429
  ``Retry-After`` passed back verbatim.
- ``autoscale`` — drives the manager's target count from the signals
  the daemons already publish (SLO fast+slow burn, ``no_free_pages``/
  ``queue_full`` reject ratios, idle windows) with hysteresis, bounds,
  and a dry-run mode that only logs decisions.
- ``registry`` — the atomic JSON file registry tying the pieces (and
  the report server's ``/fleet`` surfaces) together across processes.

See docs/serving.md "Running a fleet".
"""

from mlcomp_tpu_torch.fleet.autoscale import (  # noqa: F401
    Autoscaler,
    AutoscalePolicy,
    FleetSignals,
)
from mlcomp_tpu_torch.fleet.manager import (  # noqa: F401
    CallableLauncher,
    ReplicaManager,
    ReplicaSpec,
    SchedulerLauncher,
    SubprocessLauncher,
)
from mlcomp_tpu_torch.fleet.registry import (  # noqa: F401
    read_registry,
    registry_urls,
    remove_entry,
    update_entry,
)
from mlcomp_tpu_torch.fleet.router import Router, make_router_http_server  # noqa: F401,E501
