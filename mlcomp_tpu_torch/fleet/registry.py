"""The replica registry: one small JSON file, atomically replaced (the port's copy of
mlcomp_tpu/fleet/registry.py).

``MLCOMP_TPU_SERVE_URLS`` was the fleet's static wiring — an operator
hand-lists daemon URLs and the report server scrapes them.  Once the
ReplicaManager spawns/restarts/moves replicas at runtime, the set of
URLs is *state*, not configuration, and every consumer (the router, the
report server's ``/fleet`` surfaces, a human with ``jq``) needs the
live view.  This module is that view: a flat JSON object

    {"<replica name>": {"url": "http://host:port", "state": "live",
                        "updated_unix": 1721650000.0}, ...}

written with the write-to-temp + ``os.replace`` idiom so readers never
see a torn file.  Writers MERGE (read-modify-write) under an exclusive
``<path>.lock`` flock (the same serialization worker code-sync uses):
the manager owns ``state`` while a scheduler-launched replica
publishes its own ``url`` from whatever worker host it landed on —
without the lock, one writer's read-replace window could swallow the
other's update (a lost ``url`` would leave the manager restart-looping
a healthy replica).  Readers never take the lock — ``os.replace``
keeps reads torn-free.  The env var stays as the static fallback
(``report/server.py`` consults ``MLCOMP_TPU_SERVE_REGISTRY`` first,
then the URL env vars).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional


@contextmanager
def _locked(path: str):
    import fcntl

    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path + ".lock", "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lf, fcntl.LOCK_UN)


def read_registry(path: str) -> Dict[str, Dict[str, Any]]:
    """The registry's current contents; {} for a missing, empty, or
    garbled file (a torn write is impossible by construction, but a
    half-provisioned fleet must not crash its readers)."""
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(data, dict):
        return {}
    return {
        str(k): dict(v) for k, v in data.items() if isinstance(v, dict)
    }


def _write(path: str, data: Dict[str, Dict[str, Any]]) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".registry-", dir=d)
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=0, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def update_entry(path: str, name: str, **fields: Any) -> None:
    """Merge ``fields`` into ``name``'s entry (read-modify-write +
    atomic replace).  ``None`` values are skipped so a writer that
    doesn't know a field (the manager before a scheduler replica
    publishes its URL) can't erase it."""
    with _locked(path):
        data = read_registry(path)
        entry = data.get(name, {})
        for k, v in fields.items():
            if v is not None:
                entry[k] = v
        entry["updated_unix"] = time.time()
        data[name] = entry
        _write(path, data)


def remove_entry(path: str, name: str) -> None:
    with _locked(path):
        data = read_registry(path)
        if name in data:
            del data[name]
            _write(path, data)


def registry_urls(path: str,
                  states: Optional[List[str]] = None) -> List[str]:
    """Replica base URLs from the registry, name-sorted (deterministic
    scrape order).  ``states`` restricts to entries in those states;
    default is every entry that has published a URL — the report
    server's fleet surfaces mark dead daemons ``up 0`` themselves."""
    data = read_registry(path)
    out: List[str] = []
    for name in sorted(data):
        e = data[name]
        url = e.get("url")
        if not url:
            continue
        if states is not None and e.get("state") not in states:
            continue
        out.append(str(url).rstrip("/"))
    return out
