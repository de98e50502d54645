"""Model storage layout on the TPU-VM host disk.

The reference keeps a models directory served by the report server
(BASELINE.json:5 — "the report server and model storage stay on the
TPU-VM host disk").  Layout: ``{root}/{project}/{dag}/{task}/`` with
``checkpoints/``, ``artifacts/``, and a small ``meta.json``.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Dict, Optional

DEFAULT_ROOT = "~/.mlcomp_tpu_torch/models"


class ModelStorage:
    def __init__(self, root: Optional[str] = None):
        # env read per-construction, not at import: the report server and
        # tests may (re)point MLCOMP_TPU_STORAGE after this module loads
        root = root or os.environ.get("MLCOMP_TPU_STORAGE") or DEFAULT_ROOT
        self.root = Path(root).expanduser().absolute()

    def task_dir(self, project: str, dag: str, task: str) -> Path:
        d = self.root / project / dag / task
        d.mkdir(parents=True, exist_ok=True)
        return d

    def checkpoint_dir(self, project: str, dag: str, task: str) -> Path:
        d = self.task_dir(project, dag, task) / "checkpoints"
        d.mkdir(parents=True, exist_ok=True)
        return d

    def artifact_dir(self, project: str, dag: str, task: str) -> Path:
        d = self.task_dir(project, dag, task) / "artifacts"
        d.mkdir(parents=True, exist_ok=True)
        return d

    def write_meta(self, project: str, dag: str, task: str, meta: Dict[str, Any]):
        d = self.task_dir(project, dag, task)
        meta = {**meta, "updated": time.time()}
        (d / "meta.json").write_text(json.dumps(meta, indent=2, default=str))

    def read_meta(self, project: str, dag: str, task: str) -> Dict[str, Any]:
        p = self.task_dir(project, dag, task) / "meta.json"
        return json.loads(p.read_text()) if p.exists() else {}
