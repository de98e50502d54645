"""Observability of the port: ``metrics`` is the copy of
mlcomp_tpu/obs/metrics.py (a dependency-free Prometheus registry)."""
