"""Observability of the port: copies of the JAX package's stdlib-only
modules.  ``metrics`` (mlcomp_tpu/obs/metrics.py) is a dependency-free
Prometheus registry; ``history`` (obs/history.py) samples it into the
bounded ring behind ``GET /metrics/history``; ``slo`` (obs/slo.py)
evaluates burn rates on that ring for ``GET /slo``.  ``history`` and
``slo`` are imported lazily by the service, never here."""
