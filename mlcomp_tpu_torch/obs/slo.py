"""SLO engine: declarative objectives + multi-window burn rates (the port's
copy of mlcomp_tpu/obs/slo.py).

The serving metrics so far answer "what is the TTFT p95"; an operator
needs "is the service meeting its objective, and how fast is it eating
the error budget".  This module evaluates declarative SLOs against the
metrics-history ring (``obs/history.py``) — no external Prometheus,
no alerting stack — with the standard SRE multi-window burn-rate
shape: a FAST window (catches an acute incident in minutes) and a
SLOW window (confirms it is sustained, filters blips), breached only
when BOTH burn above the threshold.

``burn rate`` is budget consumption speed: the window's bad fraction
divided by the error budget.  1.0 means the service is spending its
budget exactly as fast as the objective allows; 10 means ten times
too fast.

Three objective kinds cover the serving surface:

- ``latency_quantile``: a histogram family's windowed quantile vs a
  threshold (TTFT p95, per-token p50).  An interval is "bad" when its
  materialized quantile exceeds the threshold; the window's bad
  fraction is bad intervals / intervals with traffic.
- ``ratio``: a bad-event counter over a total (admission-control
  reject rate).  The window's ratio IS the bad fraction.
- ``availability``: a 0/1 gauge that should be at its ok value
  (engine-healthy uptime).  Bad fraction = samples away from ok.

Surfaces: ``GET /slo`` (full status), an ``slo`` block in
``/healthz``, ``mlcomp_slo_burn_rate{slo,window}`` /
``mlcomp_slo_breached{slo}`` / ``mlcomp_slo_breaches_total{slo}``
in ``/metrics``, and a flight-recorder instant on every breach
transition so a trace shows exactly what the engine was doing when
the budget started burning.  Defaults are overridable with
``--slo-config`` (a JSON file; unknown keys and malformed values are
rejected at startup, not at the first evaluation).
"""

from __future__ import annotations

import threading
import warnings
from typing import Any, Dict, List, Optional

VALID_KINDS = ("latency_quantile", "ratio", "availability")

DEFAULT_WINDOWS = {"fast_s": 300.0, "slow_s": 3600.0}
DEFAULT_BURN_THRESHOLD = 1.0

# the serving objectives every daemon gets out of the box; each row is
# fully overridable (and extendable) via --slo-config
DEFAULT_SLOS: Dict[str, Dict[str, Any]] = {
    "ttft_p95": {
        "kind": "latency_quantile",
        "metric": "mlcomp_engine_ttft_ms",
        "q": 0.95, "threshold_ms": 2000.0, "budget": 0.05,
    },
    "per_token_p50": {
        "kind": "latency_quantile",
        "metric": "mlcomp_engine_per_token_ms",
        "q": 0.50, "threshold_ms": 250.0, "budget": 0.05,
    },
    "reject_rate": {
        "kind": "ratio",
        "bad": "mlcomp_serving_requests_rejected_total",
        # accepted requests live in the ENGINE counter on the
        # continuous batcher and the SERVICE counter on window/
        # speculative ones (each daemon publishes exactly one of the
        # two) — sum both so a lone 429 on a window daemon is a ratio,
        # not a guaranteed 1.0 breach
        "total": ["mlcomp_serving_requests_rejected_total",
                  "mlcomp_engine_requests_total",
                  "mlcomp_service_requests_total"],
        "budget": 0.01,
    },
    "engine_healthy": {
        "kind": "availability",
        "metric": "mlcomp_engine_healthy",
        "ok": 1.0, "budget": 0.001,
    },
}

_SLO_KEYS = {
    "kind", "metric", "q", "threshold_ms", "budget", "bad", "total",
    "ok", "enabled",
}


class SLOConfigError(ValueError):
    """--slo-config was malformed: fail at startup with a message that
    names the offending key, never at the first evaluation."""


def _require_number(cfg: Dict[str, Any], key: str, lo: float, hi: float,
                    where: str) -> None:
    v = cfg.get(key)
    if not isinstance(v, (int, float)) or isinstance(v, bool) or (
        not lo < float(v) <= hi
    ):
        raise SLOConfigError(
            f"{where}: {key!r} must be a number in ({lo}, {hi}], "
            f"got {v!r}"
        )


def validate_config(config: Optional[Dict[str, Any]]
                    ) -> Dict[str, Any]:
    """Merge a --slo-config override over the defaults and validate the
    result.  Returns ``{"windows", "burn_threshold", "slos"}`` with
    every SLO spec complete; raises :class:`SLOConfigError` otherwise."""
    if config is None:
        config = {}
    if not isinstance(config, dict):
        raise SLOConfigError(
            f"slo config must be a JSON object, got {type(config).__name__}"
        )
    unknown = set(config) - {"windows", "burn_threshold", "slos"}
    if unknown:
        raise SLOConfigError(
            f"unknown top-level slo-config keys: {sorted(unknown)} "
            "(expected 'windows', 'burn_threshold', 'slos')"
        )
    windows = {**DEFAULT_WINDOWS, **(config.get("windows") or {})}
    bad_w = set(windows) - set(DEFAULT_WINDOWS)
    if bad_w:
        raise SLOConfigError(
            f"unknown window keys: {sorted(bad_w)} "
            "(expected 'fast_s', 'slow_s')"
        )
    for k in ("fast_s", "slow_s"):
        _require_number(windows, k, 0.0, 7 * 86400.0, "windows")
    if windows["fast_s"] >= windows["slow_s"]:
        raise SLOConfigError(
            f"windows: fast_s ({windows['fast_s']}) must be shorter "
            f"than slow_s ({windows['slow_s']})"
        )
    burn = config.get("burn_threshold", DEFAULT_BURN_THRESHOLD)
    if not isinstance(burn, (int, float)) or isinstance(burn, bool) or (
        float(burn) <= 0
    ):
        raise SLOConfigError(
            f"burn_threshold must be a positive number, got {burn!r}"
        )
    overrides = config.get("slos") or {}
    if not isinstance(overrides, dict):
        raise SLOConfigError(
            f"'slos' must be an object, got {type(overrides).__name__}"
        )
    slos: Dict[str, Dict[str, Any]] = {}
    for name, base in DEFAULT_SLOS.items():
        slos[name] = dict(base)
    for name, ov in overrides.items():
        if not isinstance(ov, dict):
            raise SLOConfigError(
                f"slo {name!r}: override must be an object, got "
                f"{type(ov).__name__}"
            )
        unknown = set(ov) - _SLO_KEYS
        if unknown:
            raise SLOConfigError(
                f"slo {name!r}: unknown keys {sorted(unknown)}"
            )
        merged = {**slos.get(name, {}), **ov}
        if "kind" not in merged:
            raise SLOConfigError(
                f"slo {name!r}: a NEW objective needs a 'kind' "
                f"(one of {VALID_KINDS})"
            )
        slos[name] = merged
    for name, spec in list(slos.items()):
        if not spec.get("enabled", True):
            del slos[name]
            continue
        kind = spec.get("kind")
        if kind not in VALID_KINDS:
            raise SLOConfigError(
                f"slo {name!r}: kind must be one of {VALID_KINDS}, "
                f"got {kind!r}"
            )
        _require_number(spec, "budget", 0.0, 1.0, f"slo {name!r}")
        if kind == "latency_quantile":
            if not isinstance(spec.get("metric"), str):
                raise SLOConfigError(
                    f"slo {name!r}: 'metric' (histogram family) required"
                )
            _require_number(spec, "q", 0.0, 1.0, f"slo {name!r}")
            _require_number(spec, "threshold_ms", 0.0, 1e9,
                            f"slo {name!r}")
        elif kind == "ratio":
            if not isinstance(spec.get("bad"), str):
                raise SLOConfigError(
                    f"slo {name!r}: 'bad' (counter family) required"
                )
            tot = spec.get("total")
            if not (isinstance(tot, list) and tot
                    and all(isinstance(t, str) for t in tot)):
                raise SLOConfigError(
                    f"slo {name!r}: 'total' must be a non-empty list "
                    "of counter families"
                )
        elif kind == "availability":
            if not isinstance(spec.get("metric"), str):
                raise SLOConfigError(
                    f"slo {name!r}: 'metric' (gauge family) required"
                )
            spec.setdefault("ok", 1.0)
    return {
        "windows": {k: float(v) for k, v in windows.items()},
        "burn_threshold": float(burn),
        "slos": slos,
    }


class SLOEngine:
    """Evaluates the configured objectives against a
    :class:`~mlcomp_tpu_torch.obs.history.MetricsHistory` ring.  Wire it as a
    history callback (the serving service does) so burn rates update at
    every sample tick, traffic or not."""

    def __init__(self, history, config: Optional[Dict[str, Any]] = None,
                 registry=None, recorder=None):
        from mlcomp_tpu_torch.utils.trace import null_tracer

        cfg = validate_config(config)
        self.history = history
        self.windows = cfg["windows"]
        self.burn_threshold = cfg["burn_threshold"]
        self.slos = cfg["slos"]
        self.registry = registry
        self.recorder = recorder if recorder is not None else null_tracer()
        self._lock = threading.Lock()
        self._state: Dict[str, Dict[str, Any]] = {
            name: {"breached": False, "breaches": 0,
                   "burn": {"fast": 0.0, "slow": 0.0}, "value": None}
            for name in self.slos
        }
        self._evaluations = 0
        self._censor_warned: set = set()

    # ---------------------------------------------------------- evaluation

    def _bad_fraction(self, spec: Dict[str, Any], window_s: float
                      ) -> "tuple[float, Optional[float]]":
        """(bad fraction over the window, current windowed measurement)
        for one objective.  No traffic/samples -> (0, None): an idle
        service is not burning budget."""
        kind = spec["kind"]
        h = self.history
        if kind == "latency_quantile":
            metric, q = spec["metric"], float(spec["q"])
            thr = float(spec["threshold_ms"])
            bad = total = 0
            for e in h.entries(window_s):
                qs = e["quantiles"].get(metric)
                hist = e["hist"].get(metric)
                if not qs or not hist or hist["delta_n"] <= 0:
                    continue  # no observations this interval
                iq = bucket_quantile_entry(qs, hist, h, metric, q)
                if iq is None:
                    continue
                total += 1
                # CENSORED interval: the quantile rank fell in the
                # implicit +Inf bucket, so the materialized value is
                # clamped to the largest finite bound and the TRUE
                # quantile lies somewhere above it.  Count it bad
                # regardless of the threshold — with a threshold
                # above the bucket range the comparison could
                # otherwise NEVER fire and the SLO would report
                # healthy forever (a silent false-OK in the alerting
                # path); erring toward the alarm is the fail-safe.
                censored = q * hist["delta_n"] > sum(
                    hist["delta_counts"]
                )
                if iq > thr or censored:
                    bad += 1
            frac = bad / total if total else 0.0
            return frac, h.window_quantile(metric, q, window_s)
        if kind == "ratio":
            bad = h.window_delta(spec["bad"], window_s)
            # labeled bad counters (rejects carry a reason) sum across
            # their labelsets: window_delta keys on the exact sample
            # string, so also sweep prefixed variants
            bad += sum(
                h.window_delta(k, window_s)
                for k in _labeled_keys(h, spec["bad"], window_s)
            )
            total = 0.0
            for fam in spec["total"]:
                total += h.window_delta(fam, window_s)
                total += sum(
                    h.window_delta(k, window_s)
                    for k in _labeled_keys(h, fam, window_s)
                )
            if total <= 0:
                return 0.0, None
            ratio = bad / total
            return ratio, ratio
        # availability
        metric = spec["metric"]
        ok = float(spec.get("ok", 1.0))
        bad = total = 0
        last = None
        for e in self.history.entries(window_s):
            v = e["gauges"].get(metric)
            if v is None:
                continue
            total += 1
            last = v
            if v != ok:
                bad += 1
        frac = bad / total if total else 0.0
        return frac, last

    def evaluate(self) -> None:
        """One evaluation pass (runs as a history callback after every
        sample): recompute fast/slow burn rates, flip breach states,
        record transition instants, refresh the gauges."""
        for name, spec in self.slos.items():
            if (spec["kind"] == "latency_quantile"
                    and name not in self._censor_warned):
                # the bucket bounds are only known once history has
                # seen the family — warn the FIRST time a threshold
                # turns out to sit at/above the largest finite bound:
                # the materialized quantile clamps there, so every
                # interval whose rank lands past it counts as
                # breaching (see _bad_fraction) rather than silently
                # never firing
                bounds = self.history._buckets.get(spec["metric"])
                if bounds and float(spec["threshold_ms"]) >= bounds[-1]:
                    self._censor_warned.add(name)
                    warnings.warn(
                        f"SLO {name!r}: threshold_ms "
                        f"{spec['threshold_ms']} is at/above the "
                        f"{spec['metric']} histogram's largest finite "
                        f"bucket bound ({bounds[-1]}); quantiles are "
                        "censored there, so intervals past the bound "
                        "count as breaching.  Widen the histogram "
                        "buckets or lower the threshold.",
                        stacklevel=2,
                    )
            budget = float(spec["budget"])
            burns = {}
            value = None
            for wname, wkey in (("fast", "fast_s"), ("slow", "slow_s")):
                frac, val = self._bad_fraction(
                    spec, self.windows[wkey]
                )
                burns[wname] = frac / budget
                if wname == "fast":
                    value = val
            breached = (
                burns["fast"] > self.burn_threshold
                and burns["slow"] > self.burn_threshold
            )
            with self._lock:
                st = self._state[name]
                was = st["breached"]
                st["burn"] = {
                    k: round(v, 4) for k, v in burns.items()
                }
                st["value"] = value
                st["breached"] = breached
                if breached and not was:
                    st["breaches"] += 1
            if breached and not was:
                self.recorder.instant(
                    "slo_breach", track="slo", slo=name,
                    burn_fast=round(burns["fast"], 3),
                    burn_slow=round(burns["slow"], 3),
                )
            elif was and not breached:
                self.recorder.instant(
                    "slo_recover", track="slo", slo=name,
                    burn_fast=round(burns["fast"], 3),
                    burn_slow=round(burns["slow"], 3),
                )
        with self._lock:
            self._evaluations += 1
        self._publish_metrics()

    def _publish_metrics(self) -> None:
        if self.registry is None:
            return
        burn_g = self.registry.gauge(
            "mlcomp_slo_burn_rate",
            "Error-budget burn rate per SLO and window (1.0 = spending "
            "the budget exactly as fast as the objective allows)",
            labelnames=("slo", "window"),
        )
        breached_g = self.registry.gauge(
            "mlcomp_slo_breached",
            "1 while the SLO's fast AND slow windows both burn above "
            "the threshold",
            labelnames=("slo",),
        )
        breaches_c = self.registry.counter(
            "mlcomp_slo_breaches_total",
            "Breach transitions (ok -> breached) per SLO",
            labelnames=("slo",),
        )
        with self._lock:
            state = {k: dict(v) for k, v in self._state.items()}
        for name, st in state.items():
            for wname, burn in st["burn"].items():
                burn_g.set(burn, slo=name, window=wname)
            breached_g.set(1 if st["breached"] else 0, slo=name)
            breaches_c.set_total(st["breaches"], slo=name)

    # ------------------------------------------------------------- reading

    def status(self) -> Dict[str, Any]:
        """The ``GET /slo`` payload: config echo + live burn state."""
        with self._lock:
            state = {k: dict(v) for k, v in self._state.items()}
            evals = self._evaluations
        slos = {}
        for name, spec in self.slos.items():
            st = state[name]
            slos[name] = {
                "kind": spec["kind"],
                "objective": {
                    k: v for k, v in spec.items()
                    if k not in ("kind", "enabled")
                },
                "burn_rate": st["burn"],
                "breached": st["breached"],
                "breaches": st["breaches"],
                "value": st["value"],
            }
        return {
            "windows": self.windows,
            "burn_threshold": self.burn_threshold,
            "evaluations": evals,
            "breached": sorted(
                n for n, st in state.items() if st["breached"]
            ),
            "slos": slos,
        }

    def summary(self) -> Dict[str, Any]:
        """The compact ``slo`` block lifted into ``/healthz``."""
        with self._lock:
            state = {k: dict(v) for k, v in self._state.items()}
            evals = self._evaluations
        return {
            "evaluations": evals,
            "breached": sorted(
                n for n, st in state.items() if st["breached"]
            ),
            "burn_rate": {n: st["burn"] for n, st in state.items()},
        }


def _labeled_keys(history, family: str, window_s: float) -> List[str]:
    """Sample keys of a family's LABELED series inside the window
    (``family{reason="x"}``): ratio objectives sum across labelsets."""
    prefix = family + "{"
    seen = set()
    for e in history.entries(window_s):
        for k in e["counter_deltas"]:
            if k.startswith(prefix):
                seen.add(k)
    return sorted(seen)


def bucket_quantile_entry(qs: Dict[str, Optional[float]],
                          hist: Dict[str, Any], history, metric: str,
                          q: float) -> Optional[float]:
    """An interval's quantile: reuse the entry's materialized p50/p95/
    p99 when the requested q is one of them, else recompute from the
    interval's bucket deltas."""
    from mlcomp_tpu_torch.obs.history import QUANTILES, bucket_quantile

    if q in QUANTILES:
        return qs.get(f"p{int(q * 100)}")
    bounds = history._buckets.get(metric)
    if bounds is None:
        return None
    return bucket_quantile(
        bounds, hist["delta_counts"], q, total=hist["delta_n"]
    )
