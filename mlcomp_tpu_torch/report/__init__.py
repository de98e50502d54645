"""Report server: HTTP JSON API + dashboard over the task store (the port's copy of
mlcomp_tpu/report/__init__.py).

The reference ships a report server and web UI (Vue frontend + API backend
visualizing DAGs, tasks, logs, metrics — BASELINE.json:5 "the report server
and model storage stay on the TPU-VM host disk"). The TPU build keeps the
capability with zero extra dependencies: a stdlib ThreadingHTTPServer on
the head host serving JSON endpoints over the sqlite store, plus a single
self-contained HTML dashboard (vanilla JS polling the API).
"""
