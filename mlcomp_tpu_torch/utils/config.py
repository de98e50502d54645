"""YAML config loading with merging and ``${...}`` interpolation.

mlcomp DAGs are YAML files (reference behavior: BASELINE.json:5 — "Existing
YAML DAGs (train/infer/valid stages)").  This module is the config substrate:
load YAML, deep-merge overrides, and resolve ``${a.b.c}`` references and
``${env:VAR}`` / ``${env:VAR,default}`` environment lookups so one DAG file
can parameterize many tasks.
"""

from __future__ import annotations

import copy
import os
import re
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Union

import yaml

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


class ConfigError(ValueError):
    pass


def load_config(
    path: Union[str, Path],
    overrides: Optional[Mapping[str, Any]] = None,
    resolve: bool = True,
) -> Dict[str, Any]:
    """Load a YAML file, apply ``overrides`` (deep merge), interpolate."""
    path = Path(path)
    with path.open("r") as f:
        cfg = yaml.safe_load(f) or {}
    if not isinstance(cfg, dict):
        raise ConfigError(f"{path}: top level must be a mapping, got {type(cfg).__name__}")
    # `_base_`: compose from another file, like upstream's config imports.
    base_ref = cfg.pop("_base_", None)
    if base_ref is not None:
        base = load_config(path.parent / base_ref, resolve=False)
        cfg = merge_config(base, cfg)
    if overrides:
        cfg = merge_config(cfg, dict(overrides))
    if resolve:
        cfg = interpolate(cfg)
    return cfg


def loads_config(
    text: str,
    overrides: Optional[Mapping[str, Any]] = None,
    resolve: bool = True,
) -> Dict[str, Any]:
    """Parse a YAML string (used by tests and inline DAG definitions)."""
    cfg = yaml.safe_load(text) or {}
    if not isinstance(cfg, dict):
        raise ConfigError("top level must be a mapping")
    if "_base_" in cfg:
        raise ConfigError(
            "_base_ composition requires a file path (relative bases cannot "
            "be resolved from inline YAML text); use load_config instead"
        )
    if overrides:
        cfg = merge_config(cfg, dict(overrides))
    return interpolate(cfg) if resolve else cfg


def merge_config(base: Mapping[str, Any], override: Mapping[str, Any]) -> Dict[str, Any]:
    """Deep merge: dicts merge recursively, everything else replaces."""
    out: Dict[str, Any] = copy.deepcopy(dict(base))
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, Mapping):
            out[k] = merge_config(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _lookup(root: Mapping[str, Any], dotted: str) -> Any:
    cur: Any = root
    for part in dotted.split("."):
        if isinstance(cur, Mapping) and part in cur:
            cur = cur[part]
        elif isinstance(cur, list) and part.lstrip("-").isdigit():
            cur = cur[int(part)]
        else:
            raise ConfigError(f"interpolation target not found: {dotted!r}")
    return cur


def _resolve_token(root: Mapping[str, Any], token: str) -> Any:
    if token.startswith("env:"):
        spec = token[4:]
        if "," in spec:
            var, default = spec.split(",", 1)
            return os.environ.get(var.strip(), default.strip())
        val = os.environ.get(spec.strip())
        if val is None:
            raise ConfigError(f"environment variable not set: {spec!r}")
        return val
    return _lookup(root, token)


def _interp_value(root: Mapping[str, Any], value: Any, depth: int = 0) -> Any:
    if depth > 16:
        raise ConfigError("interpolation recursion too deep (cycle?)")
    if isinstance(value, str):
        m = _INTERP_RE.fullmatch(value)
        if m:  # whole-string reference keeps the referenced type
            resolved = _resolve_token(root, m.group(1))
            return _interp_value(root, resolved, depth + 1)

        def sub(match: "re.Match[str]") -> str:
            # recurse so embedded references resolve the same as whole-string
            return str(_interp_value(root, _resolve_token(root, match.group(1)), depth + 1))

        return _INTERP_RE.sub(sub, value)
    if isinstance(value, dict):
        return {k: _interp_value(root, v, depth) for k, v in value.items()}
    if isinstance(value, list):
        return [_interp_value(root, v, depth) for v in value]
    return value


def interpolate(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Resolve ``${a.b}`` and ``${env:VAR[,default]}`` throughout ``cfg``."""
    return _interp_value(cfg, cfg)
