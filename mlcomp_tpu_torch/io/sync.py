"""Master ↔ worker file sync: content-hash incremental directory copy.

The reference family syncs project code from the master to every worker
before tasks run (workers must import the user's executor classes).  Here
the master snapshots the project into model storage at submit time, and
each worker mirrors that snapshot into its workdir before executing —
copying only files whose content hash changed, deleting files that
vanished, so repeated tasks on a warm worker sync in ~zero time.

No daemons, no rsync dependency: a manifest of sha256 hashes is computed
on both sides and diffed.  Safe under concurrent readers (files are
written to a temp name then renamed into place).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

DEFAULT_EXCLUDES = (
    ".git",
    "__pycache__",
    ".pytest_cache",
    "*.pyc",
    ".DS_Store",
    ".sync-*",  # our own in-flight temp files (concurrent syncers)
)


def _excluded(rel: str, patterns: Iterable[str]) -> bool:
    from fnmatch import fnmatch

    parts = Path(rel).parts
    for pat in patterns:
        if any(fnmatch(p, pat) for p in parts):
            return True
    return False


def file_hash(path: str | Path, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def dir_manifest(
    root: str | Path, excludes: Iterable[str] = DEFAULT_EXCLUDES
) -> Dict[str, str]:
    """{relative_path: sha256} for every regular file under ``root``."""
    root = Path(root)
    out: Dict[str, str] = {}
    for dirpath, dirnames, filenames in os.walk(root):
        rel_dir = os.path.relpath(dirpath, root)
        # prune excluded dirs in place so walk never descends
        dirnames[:] = [
            d
            for d in dirnames
            if not _excluded(os.path.normpath(os.path.join(rel_dir, d)), excludes)
        ]
        for fn in filenames:
            rel = os.path.normpath(os.path.join(rel_dir, fn))
            if _excluded(rel, excludes):
                continue
            out[rel] = file_hash(os.path.join(dirpath, fn))
    return out


def sync_dirs(
    src: str | Path,
    dst: str | Path,
    delete: bool = True,
    excludes: Iterable[str] = DEFAULT_EXCLUDES,
) -> Tuple[List[str], List[str]]:
    """Mirror ``src`` into ``dst`` incrementally.

    Returns (copied, removed) lists of relative paths.  ``delete=True``
    removes dst files absent from src (a true mirror — stale executor code
    on a worker is worse than missing code).
    """
    src, dst = Path(src), Path(dst)
    if not src.is_dir():
        # a missing source must never read as "mirror emptiness": that
        # would wipe a worker's warm copy on a storage-mount hiccup
        raise FileNotFoundError(f"sync source {str(src)!r} is not a directory")
    dst.mkdir(parents=True, exist_ok=True)
    want = dir_manifest(src, excludes)
    have = dir_manifest(dst, excludes)

    copied: List[str] = []
    for rel, digest in want.items():
        if have.get(rel) == digest:
            continue
        target = dst / rel
        target.parent.mkdir(parents=True, exist_ok=True)
        # temp-write + rename: concurrent readers see old or new, never half
        fd, tmp = tempfile.mkstemp(dir=str(target.parent), prefix=".sync-")
        os.close(fd)
        shutil.copy2(src / rel, tmp)
        os.replace(tmp, target)
        copied.append(rel)

    removed: List[str] = []
    if delete:
        for rel in set(have) - set(want):
            try:
                os.remove(dst / rel)
                removed.append(rel)
            except FileNotFoundError:
                pass
        # prune now-empty directories bottom-up
        for dirpath, dirnames, filenames in os.walk(dst, topdown=False):
            if dirpath != str(dst) and not dirnames and not filenames:
                try:
                    os.rmdir(dirpath)
                except OSError:
                    pass
    return sorted(copied), sorted(removed)


def snapshot_code(
    project_dir: str | Path,
    storage_root: str | Path,
    project: str,
    excludes: Iterable[str] = DEFAULT_EXCLUDES,
) -> str:
    """Master side: mirror the project tree into storage; returns the
    snapshot dir workers should sync from."""
    dest = Path(storage_root) / "code" / project
    sync_dirs(project_dir, dest, delete=True, excludes=excludes)
    return str(dest)


def inject_code_sync(dag, base_dir: str | Path = "."):
    """Submit-time hook: if the DAG's ``info.code_dir`` names a project
    tree, snapshot it into model storage and point every task's
    ``code_src`` arg at the snapshot (workers mirror + import it before
    executing — see ``scheduler.worker.Worker._sync_code``).

    Returns the (possibly rewritten) DagSpec; a DAG without ``code_dir``
    passes through untouched.
    """
    import dataclasses

    info = dag.config.get("info", {}) or {}
    code_dir = info.get("code_dir")
    if not code_dir:
        return dag
    from mlcomp_tpu_torch.io.storage import ModelStorage

    storage = ModelStorage(info.get("storage_root"))
    src = Path(base_dir) / code_dir
    if not src.is_dir():
        raise FileNotFoundError(f"info.code_dir {str(src)!r} is not a directory")
    snap = snapshot_code(src, storage.root, dag.project)
    extra = {"code_src": snap}
    # modules workers import after syncing (registers custom executors)
    imports = info.get("code_import")
    if imports:
        extra["code_import"] = (
            [imports] if isinstance(imports, str) else list(imports)
        )
    tasks = tuple(
        dataclasses.replace(t, args={**t.args, **extra}) for t in dag.tasks
    )
    return dataclasses.replace(dag, tasks=tasks)
