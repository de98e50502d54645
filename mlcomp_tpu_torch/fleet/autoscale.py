"""SLO-driven autoscaling: the burn rates finally get a consumer (the port's copy of
mlcomp_tpu/fleet/autoscale.py).

PR 10's SLO engine computes multi-window burn rates and PR 7's
admission control emits ``no_free_pages``/``queue_full`` 429s — signals
designed for exactly one decision: "do we need more replicas?".  The
autoscaler closes that loop:

- **scale up** when the fleet is provably overloaded: any replica's
  SLO burns above threshold on BOTH windows (the standard fast+slow
  confirmation — acute AND sustained), or the fleet-wide reject ratio
  (admission-control 429s / submitted requests) exceeds the policy
  bound, sustained for ``sustain_s``.
- **scale down** only after a sustained idle window (``idle_s`` with no
  traffic and no burn) — serving capacity is cheap next to a cold
  replica's compile storm, so the bias is asymmetric by design.
- **hysteresis**: ``cooldown_s`` between actions, min/max bounds, one
  step per decision.  A flapping signal moves the fleet at most once
  per cooldown, never oscillates per tick.
- **dry run**: decisions are computed, logged, and counted but not
  applied — stage the policy against production traffic before handing
  it the lever.

The decision core is pure (injected clock, synthetic
:class:`FleetSignals`) so policy behavior pins down in table-driven
tests with no HTTP, no engine, no sleeping.  ``scrape()`` builds real
signals from the replicas' ``/healthz`` payloads (which carry the SLO
summary and reject counters) for the live loop.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from mlcomp_tpu_torch.fleet.manager import fetch_json

DIRECTIONS = ("up", "down", "hold")


@dataclass
class AutoscalePolicy:
    min_replicas: int = 1
    max_replicas: int = 4
    # fast AND slow burn above this on any SLO counts as overload
    # (matches the SLO engine's own breach threshold semantics)
    burn_threshold: float = 1.0
    # admission-control rejects / submitted requests over the
    # observation delta that flags overload
    reject_ratio: float = 0.05
    # how long the up-signal must persist before acting: filters a
    # single bad scrape without waiting out a real incident
    sustain_s: float = 30.0
    # how long the fleet must be idle (no traffic, no burn) before a
    # scale-down — asymmetric vs sustain_s on purpose
    idle_s: float = 300.0
    # minimum spacing between actions, either direction
    cooldown_s: float = 60.0
    step: int = 1

    def __post_init__(self):
        if not 0 < self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 0 < min_replicas <= max_replicas, got "
                f"{self.min_replicas}/{self.max_replicas}"
            )
        if self.step < 1:
            raise ValueError(f"step must be >= 1, got {self.step}")
        for k in ("sustain_s", "idle_s", "cooldown_s"):
            if getattr(self, k) < 0:
                raise ValueError(f"{k} must be >= 0")


@dataclass
class FleetSignals:
    """One observation of the fleet, however it was gathered."""

    # any replica's SLO with fast AND slow burn above the threshold
    slo_breached: bool = False
    # rejects / requests over the delta since the last observation
    reject_ratio: float = 0.0
    # new requests since the last observation (0 = idle interval)
    requests_delta: float = 0.0
    live_replicas: int = 0
    detail: Dict[str, Any] = field(default_factory=dict)


class Autoscaler:
    """Drives ``manager.set_target`` from observed signals.

    ``observe(signals)`` is the whole control loop for one tick; call
    it from :meth:`run_tick` (live scrape) or directly with synthetic
    signals (tests, obs_check's injected breach)."""

    def __init__(self, policy: AutoscalePolicy, manager=None,
                 metrics=None, dry_run: bool = False,
                 clock: Callable[[], float] = time.monotonic,
                 fetch: Callable[..., Dict[str, Any]] = fetch_json):
        self.policy = policy
        self.manager = manager
        self.dry_run = bool(dry_run)
        self._clock = clock
        self._fetch = fetch
        self._lock = threading.Lock()
        self._breach_since: Optional[float] = None  # guarded_by: _lock
        self._idle_since: Optional[float] = None  # guarded_by: _lock
        self._last_action_t: Optional[float] = None  # guarded_by: _lock
        self._decision_counts = {d: 0 for d in DIRECTIONS}  # guarded_by: _lock
        self._actions = {d: 0 for d in ("up", "down")}  # guarded_by: _lock
        self.decisions: deque = deque(maxlen=256)  # guarded_by: _lock
        # per-replica counter baselines for the live scrape's deltas
        self._last_totals: Dict[str, Dict[str, float]] = {}
        self.metrics = metrics
        if metrics is not None:
            metrics.register_collector(self._collect_metrics)

    # ----------------------------------------------------------- decision

    def observe(self, signals: FleetSignals) -> Dict[str, Any]:
        """Fold one observation into the hysteresis state and decide.

        Returns the decision record (also appended to ``decisions`` and,
        unless ``dry_run``, applied through the manager)."""
        p = self.policy
        now = self._clock()
        current = signals.live_replicas
        if self.manager is not None:
            current = self.manager.target
        with self._lock:
            overloaded = bool(
                signals.slo_breached
                or signals.reject_ratio > p.reject_ratio
            )
            if overloaded:
                self._idle_since = None
                if self._breach_since is None:
                    self._breach_since = now
            else:
                self._breach_since = None
                if signals.requests_delta > 0:
                    self._idle_since = None
                elif self._idle_since is None:
                    self._idle_since = now
            in_cooldown = (
                self._last_action_t is not None
                and now - self._last_action_t < p.cooldown_s
            )
            direction, reason = "hold", "steady"
            target = current
            if overloaded:
                sustained = (
                    now - self._breach_since >= p.sustain_s
                )
                reason = (
                    "slo_burn" if signals.slo_breached
                    else "reject_ratio"
                )
                if not sustained:
                    reason += "_unsustained"
                elif in_cooldown:
                    reason += "_cooldown"
                elif current >= p.max_replicas:
                    reason += "_at_max"
                else:
                    direction = "up"
                    target = min(current + p.step, p.max_replicas)
            elif self._idle_since is not None and (
                now - self._idle_since >= p.idle_s
            ):
                reason = "idle"
                if in_cooldown:
                    reason += "_cooldown"
                elif current <= p.min_replicas:
                    reason += "_at_min"
                else:
                    direction = "down"
                    target = max(current - p.step, p.min_replicas)
            applied = False
            if direction != "hold":
                self._last_action_t = now
                self._actions[direction] += 1
                if not self.dry_run and self.manager is not None:
                    applied = True
            self._decision_counts[direction] += 1
            decision = {
                "t_unix": time.time(),
                "direction": direction,
                "reason": reason,
                "current": current,
                "target": target,
                "dry_run": self.dry_run,
                "applied": applied,
                "signals": {
                    "slo_breached": signals.slo_breached,
                    "reject_ratio": round(signals.reject_ratio, 4),
                    "requests_delta": signals.requests_delta,
                    "live_replicas": signals.live_replicas,
                },
            }
            self.decisions.append(decision)
        if applied:
            self.manager.set_target(target)
        return decision

    # -------------------------------------------------------- live scrape

    def scrape(self, urls: List[str]) -> FleetSignals:
        """Build signals from the replicas' ``/healthz`` payloads: the
        SLO summary block (burn rates per objective) and the lifetime
        request/reject counters, differenced against the previous
        scrape for ratios."""
        p = self.policy
        breached = False
        req_delta = rej_delta = 0.0
        live = 0
        detail: Dict[str, Any] = {}
        for url in urls:
            try:
                hz = self._fetch(url, "/healthz", timeout=3.0)
            except Exception:
                detail[url] = "unreachable"
                continue
            if hz.get("ok"):
                live += 1
            slo = hz.get("slo") or {}
            if slo.get("breached"):
                breached = True
            else:
                for burns in (slo.get("burn_rate") or {}).values():
                    if (burns.get("fast", 0.0) > p.burn_threshold
                            and burns.get("slow", 0.0)
                            > p.burn_threshold):
                        breached = True
            requests = float(hz.get("requests") or 0)
            rejects = float(sum(
                (hz.get("rejected") or {}).values()
            ))
            last = self._last_totals.get(url, {})
            req_delta += max(0.0, requests - last.get("requests", 0.0))
            rej_delta += max(0.0, rejects - last.get("rejects", 0.0))
            self._last_totals[url] = {
                "requests": requests, "rejects": rejects,
            }
            detail[url] = {
                "requests": requests, "rejects": rejects,
                "breached": bool(slo.get("breached")),
            }
        total = req_delta + rej_delta
        return FleetSignals(
            slo_breached=breached,
            reject_ratio=(rej_delta / total) if total > 0 else 0.0,
            requests_delta=req_delta,
            live_replicas=live,
            detail=detail,
        )

    def run_tick(self, urls: Optional[List[str]] = None
                 ) -> Dict[str, Any]:
        """Scrape + observe: one live control-loop iteration."""
        if urls is None:
            if self.manager is None:
                raise ValueError(
                    "run_tick needs urls or an attached manager"
                )
            urls = self.manager.urls()
        return self.observe(self.scrape(urls))

    # ------------------------------------------------------------ reading

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "dry_run": self.dry_run,
                "decisions": dict(self._decision_counts),
                "actions": dict(self._actions),
                "last_decisions": list(self.decisions)[-8:],
            }

    def _collect_metrics(self) -> None:
        m = self.metrics
        with self._lock:
            counts = dict(self._decision_counts)
        c = m.counter(
            "mlcomp_fleet_autoscale_decisions_total",
            "Autoscaler decisions by direction (dry-run decisions "
            "count too — the dry_run label on actions is the "
            "decision log's job)",
            labelnames=("direction",),
        )
        for d in DIRECTIONS:
            c.set_total(counts[d], direction=d)
